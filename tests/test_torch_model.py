"""The port's model forward against the JAX package at flagship widths
(16 features on a 15^3 grid, db2, 2 Fourier frequencies, 4 x 32 SnakeAlt
MLP), with the parameters carried across by ``convert.py``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.ops.embedding import (
    fourier_embed as jax_fourier_embed)
from latent_feature_grid_compression_tpu.ops.mlp import (
    mlp_apply as jax_mlp_apply, snake_alt as jax_snake_alt)
from latent_feature_grid_compression_tpu_torch.convert import params_to_jax
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.ops.embedding import fourier_embed
from latent_feature_grid_compression_tpu_torch.ops.mlp import mlp_apply
from tests.torch_port_util import to_port

FLAGSHIP = dict(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=2,
                grid_features=16, grid_size=15, wavelet='db2')


def _models(seed, **overrides):
    kw = dict(FLAGSHIP, **overrides)
    jspec = jfg.make_spec(**kw)
    jparams, _ = jfg.init_model(jax.random.key(seed), jspec)
    tspec = tfg.make_spec(**kw)
    return jspec, jparams, tspec, to_port(jparams, tspec)


def _coords(n, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize('train', [False, True])
def test_apply_model_matches_jax_flagship(train):
    jspec, jparams, _, model = _models(3)
    x = _coords(3000, 0, -1.1, 1.1)
    ref = jfg.apply_model(jspec, jparams, jnp.asarray(x), train=train)
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(x), train=train)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    if not train:
        assert float(out.abs().max()) <= 1.0


def test_apply_model_frozen_masks_match_jax():
    jspec, jparams, _, model = _models(4)
    rng = np.random.default_rng(1)
    masks = [(rng.random(c.shape[1:]) < 0.4).astype(np.float32)
             for c in jparams.coeffs]
    x = _coords(2000, 2)
    ref = jfg.apply_model(jspec, jparams, jnp.asarray(x), train=False,
                          masks=tuple(jnp.asarray(m) for m in masks))
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(x), train=False,
                              masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_no_wavelet_mode_matches_jax():
    jspec, jparams, tspec, model = _models(5, wavelet='none')
    assert tspec.num_levels == 0 and len(model.coeffs) == 1
    x = _coords(2000, 3)
    ref = jfg.apply_model(jspec, jparams, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_volume_matches_jax():
    jspec, jparams, _, model = _models(6)
    ref = jfg.decode_volume(jspec, jparams)
    with torch.no_grad():
        out = tfg.decode_volume(model)
    assert tuple(out.shape) == (16, 15, 15, 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_fourier_embed_and_mlp_match_jax():
    x = _coords(500, 4, -1.3, 1.3)
    np.testing.assert_allclose(fourier_embed(torch.from_numpy(x), 2).numpy(),
                               np.asarray(jax_fourier_embed(jnp.asarray(x), 2)),
                               atol=1e-5)
    _, jparams, _, model = _models(7)
    h = np.random.default_rng(5).standard_normal((500, 31)).astype(np.float32)
    ref = jax_mlp_apply(list(jparams.mlp_w), list(jparams.mlp_b),
                        jnp.asarray(h), jax_snake_alt)
    with torch.no_grad():
        out = mlp_apply(list(model.mlp_w), list(model.mlp_b), torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('grid,wavelet', [(15, 'db2'), (8, 'haar'), (12, 'none')])
def test_init_model_shapes_and_counts_match_jax(grid, wavelet):
    jspec, jparams, tspec, _ = _models(0, grid_size=grid, wavelet=wavelet)
    model = tfg.init_model(tspec, torch.Generator().manual_seed(0), device='cpu')
    assert [tuple(c.shape) for c in model.coeffs] == [c.shape for c in jparams.coeffs]
    assert ([tuple(w.shape[::-1]) for w in model.mlp_w]
            == [w.shape for w in jparams.mlp_w])
    assert tfg.num_net_params(model) == jfg.num_net_params(jparams)
    assert tspec.mlp_in == jspec.mlp_in == 31


def test_init_model_is_seeded_and_bounded():
    spec = tfg.make_spec(**FLAGSHIP)
    a = tfg.init_model(spec, torch.Generator().manual_seed(11), device='cpu')
    b = tfg.init_model(spec, torch.Generator().manual_seed(11), device='cpu')
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    for w, bias in zip(a.mlp_w, a.mlp_b):
        w, bias = w.detach(), bias.detach()
        bound = 1.0 / np.sqrt(w.shape[1])
        assert float(w.abs().max()) <= bound and float(bias.abs().max()) <= bound
    # the U(0, 1) grid survives the encode -> decode round trip
    with torch.no_grad():
        grid = tfg.decode_volume(a)
    assert float(grid.min()) > -1e-4 and float(grid.max()) < 1.0 + 1e-4


def test_convert_round_trip_is_exact():
    _, jparams, _, model = _models(8)
    coeffs, mlp_w, mlp_b, gates = params_to_jax(model)
    assert gates is None
    for got, want in zip(coeffs + mlp_w + mlp_b,
                         list(jparams.coeffs) + list(jparams.mlp_w) + list(jparams.mlp_b)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize('backend', ['auto', 'xla', 'pallas'])
def test_interp_backends_all_select_the_trilinear_fetch(backend):
    assert (tfg.make_spec(interp_backend=backend, **FLAGSHIP)
            == tfg.make_spec(**FLAGSHIP))


@pytest.mark.parametrize('kwargs,backends', [
    pytest.param(dict(interp_backend='pallas_bf16'), None, id='kwargs0'),
    pytest.param(dict(interp_backend='fused'), ('fused', 'xla'), id='kwargs1'),
    pytest.param(dict(mlp_backend='pallas'), ('trilinear', 'pallas'), id='kwargs2'),
    pytest.param(dict(compute_dtype='bfloat16'), None, id='kwargs3'),
    pytest.param(dict(drop_type='straight_through'), None, id='kwargs4')])
def test_unported_options_raise(kwargs, backends):
    """Options not ported yet raise "not yet ported"; the fused forward and
    the fused MLP, ported since, build a spec that records them."""
    if backends is None:
        with pytest.raises(ValueError, match='not yet ported'):
            tfg.make_spec(**dict(FLAGSHIP, **kwargs))
    else:
        spec = tfg.make_spec(**dict(FLAGSHIP, **kwargs))
        assert (spec.interp_backend, spec.mlp_backend) == backends
        assert spec != tfg.make_spec(**FLAGSHIP)


@pytest.mark.parametrize('kwargs', [
    dict(interp_backend='fused', grid_size=23),       # 23^2 = 529 > 512
    dict(interp_backend='fused', hidden=129),
    dict(interp_backend='fused', grid_features=114),  # mlp_in 3 + 12 + 114 = 129
    dict(mlp_backend='pallas', hidden=129),
    dict(mlp_backend='pallas', d_out=129)])
def test_ineligible_kernel_backends_raise(kwargs):
    """An explicitly requested kernel backend that cannot take the widths or
    the grid raises; it is never swapped for another (as in the JAX
    package, whose make_spec raises for the same 'fused' requests)."""
    with pytest.raises(ValueError, match='requires'):
        tfg.make_spec(**dict(FLAGSHIP, **kwargs))
    if kwargs.get('interp_backend') == 'fused':
        with pytest.raises(ValueError, match='requires'):
            jfg.make_spec(**dict(FLAGSHIP, **kwargs))


def test_fused_eligibility_edge_matches_jax():
    """Grid 22 (484 <= 512) is the largest the one-kernel forward takes."""
    spec = tfg.make_spec(**dict(FLAGSHIP, interp_backend='fused', grid_size=22))
    assert spec.interp_backend == 'fused'
    assert jfg.make_spec(**dict(FLAGSHIP, interp_backend='fused',
                                grid_size=22)).interp_backend == 'fused'


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match='interp_backend'):
        tfg.make_spec(interp_backend='gather', **FLAGSHIP)
