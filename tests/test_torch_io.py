"""The port's checkpoint and container readers against the JAX package:
npz checkpoints both ways (every gate family's arrays), containers written by the JAX writer (8 and 5
bits; db2 and no-wavelet) restored exactly as the JAX reader restores them,
and the golden container written by the reference."""

import os

import numpy as np
import pytest
import torch
import jax

from latent_feature_grid_compression_tpu.io import checkpoint as jck
from latent_feature_grid_compression_tpu.io import container as jct
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu_torch.io import checkpoint as tck
from latent_feature_grid_compression_tpu_torch.io import container as tct
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models import gates as tG
from tests.torch_port_util import prune, to_port

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def _assert_same(model, jparams):
    for got, want in zip(model.coeffs, jparams.coeffs):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for got, want in zip(model.mlp_w, jparams.mlp_w):
        np.testing.assert_array_equal(got.detach().numpy().T, np.asarray(want))
    for got, want in zip(model.mlp_b, jparams.mlp_b):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize('drop_type', ['', 'smallify'])
def test_load_checkpoint_reads_jax_npz(tmp_path, drop_type):
    jspec = jfg.make_spec(grid_size=15, grid_features=8, hidden=16,
                          num_layers=3, drop_type=drop_type)
    jparams, aux = jfg.init_model(jax.random.key(1), jspec)
    path = str(tmp_path / 'model.npz')
    jck.save_checkpoint(path, jparams, aux, drop_type)
    spec = tfg.make_spec(grid_size=15, grid_features=8, hidden=16, num_layers=3)
    model = tck.load_checkpoint(path, spec, device='cpu')
    _assert_same(model, jparams)


FAMILIES = ['straight_through', 'masked_straight_through', 'static_variational',
            'dynamic_variational']


def _family_params(drop_type, seed):
    """JAX params of the family with gate values off their init."""
    jspec = jfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2,
                          drop_type=drop_type)
    jparams, aux = jfg.init_model(jax.random.key(seed), jspec)
    rng = np.random.default_rng(seed)
    gates = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32),
        jparams.gates)
    spec = tfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2,
                         drop_type=drop_type)
    return jparams.replace(gates=gates), aux, spec


def _same_gates(model, jgates, drop_type):
    for name in tG.trainable_fields(drop_type):
        for got, want in zip(getattr(model, name), getattr(jgates, name)):
            np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_family_checkpoint_from_jax(tmp_path, drop_type):
    """A JAX model.npz of each family loads with its gate arrays."""
    jparams, aux, spec = _family_params(drop_type, 11)
    path = str(tmp_path / 'model.npz')
    jck.save_checkpoint(path, jparams, aux, drop_type)
    model = tck.load_checkpoint(path, spec, device='cpu')
    _assert_same(model, jparams)
    _same_gates(model, jparams.gates, drop_type)


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_family_checkpoint_to_jax(tmp_path, drop_type):
    """The port's model.npz of each family names its family and loads in
    the JAX package (over a fresh init there) with the same arrays, and
    back in the port."""
    jparams, aux, spec = _family_params(drop_type, 12)
    model = to_port(jparams, spec)
    path = str(tmp_path / 'model.npz')
    tck.save_checkpoint(path, model)
    with np.load(path) as z:
        assert str(z['drop_type']) == drop_type
        assert not any(k.startswith(('gate_betas', 'gate_ema')) for k in z.files)
    jspec = jfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2,
                          drop_type=drop_type)
    fresh, faux = jfg.init_model(jax.random.key(99), jspec)
    loaded, _ = jck.load_checkpoint(path, fresh, faux)
    _assert_same(model, loaded)
    _same_gates(model, loaded.gates, drop_type)
    again = tck.load_checkpoint(path, spec, device='cpu')
    _same_gates(again, jparams.gates, drop_type)
    # a pruned model (no gates) writes drop_type '' and no gate arrays
    tck.save_checkpoint(path, tfg.remove_drop_layers(model, [
        torch.ones(c.shape[1:]) for c in model.coeffs]))
    with np.load(path) as z:
        assert str(z['drop_type']) == '' and not any(k.startswith('gate_') for k in z.files)


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_family_checkpoint_without_gates_warm_starts(tmp_path, drop_type):
    """A gate-free file under a gated spec keeps the given model's gates,
    and raises without a model, as for smallify."""
    jparams, _, spec = _family_params(drop_type, 13)
    path = str(tmp_path / 'model.npz')
    jck.save_checkpoint(path, jparams.replace(gates=None), None, '')
    init = to_port(jparams, spec)
    model = tck.load_checkpoint(path, spec, device='cpu', model=init)
    _same_gates(model, jparams.gates, drop_type)
    with pytest.raises(ValueError, match='holds no gates'):
        tck.load_checkpoint(path, spec, device='cpu')


def test_save_checkpoint_loads_in_jax(tmp_path):
    jspec = jfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2)
    jparams, _ = jfg.init_model(jax.random.key(2), jspec)
    spec = tfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2)
    model = tfg.init_model(spec, torch.Generator().manual_seed(2), device='cpu')
    path = str(tmp_path / 'model.npz')
    tck.save_checkpoint(path, model)
    loaded, _ = jck.load_checkpoint(path, jparams)
    _assert_same(model, loaded)


@pytest.mark.parametrize('bits', [8, 5])
@pytest.mark.parametrize('wavelet', ['db2', 'none'])
def test_restore_equals_jax_restore(tmp_path, bits, wavelet):
    jspec = jfg.make_spec(grid_size=15, grid_features=8, hidden=16,
                          num_layers=3, wavelet=wavelet)
    jparams, _ = jfg.init_model(jax.random.key(3), jspec)
    jparams = prune(jparams, 0.6, seed=bits)
    path = str(tmp_path / 'binary_model_file')
    jct.store_model_parameters(jspec, jparams, path, bit_precision=bits,
                               kmeans_seed=0)
    jspec2, jrestored = jct.restore_model(path, wavelet=wavelet)
    spec, model = tct.restore_model(path, wavelet=wavelet, device='cpu')
    assert (spec.grid_size, spec.grid_features, spec.hidden, spec.num_layers,
            spec.level_shapes) == (jspec2.grid_size, jspec2.grid_features,
                                   jspec2.hidden, jspec2.num_layers,
                                   jspec2.level_shapes)
    _assert_same(model, jrestored)


def test_golden_reference_container_restores():
    """tests/fixtures/README.md: header, raw layers and mask exact; the
    quantized sections within atol 0.05."""
    with np.load(os.path.join(FIXTURES, 'golden_ref_params.npz')) as z:
        coeffs = [z[k] for k in sorted(z.files) if k.startswith('coeff_')]
        w0, b_last = z['w0'], z['b_last']
    spec, model = tct.restore_model(os.path.join(FIXTURES, 'golden_ref_container'),
                                    device='cpu')
    assert spec.grid_size == 8 and spec.grid_features == 4
    for got, want in zip(model.coeffs, coeffs):
        got = got.detach().numpy()
        np.testing.assert_allclose(got, want, atol=0.05)
        np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(model.mlp_w[0].detach().numpy().T, w0)
    np.testing.assert_array_equal(model.mlp_b[-1].detach().numpy(), b_last)


@pytest.mark.parametrize('bits', [1, 3, 5, 8, 9, 12])
def test_unpack_bits_equals_string_reader(bits):
    """The JAX reader's pure-Python fallback: labels MSB first."""
    rng = np.random.default_rng(bits)
    n = 257
    raw = rng.integers(0, 256, (n * bits + 7) // 8, dtype=np.uint8).tobytes()
    s = ''.join(format(byte, '08b') for byte in raw)
    want = [int(s[bits * i: bits * (i + 1)], 2) for i in range(n)]
    np.testing.assert_array_equal(tct.unpack_bits(raw, n, bits), want)


def test_read_mask_bnr_equals_jax(tmp_path):
    bits = (np.random.default_rng(0).random(1001) < 0.3).astype(np.uint8)
    path = str(tmp_path / 'm.bnr')
    jct.write_mask_bnr(bits, path)
    np.testing.assert_array_equal(tct.read_mask_bnr(path, 1001),
                                  jct.read_mask_bnr(path, 1001))


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CUDA default does not raise')
    spec = tfg.make_spec(grid_size=8, grid_features=4, hidden=8, num_layers=2)
    path = str(tmp_path / 'model.npz')
    tck.save_checkpoint(path, tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu'))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tck.load_checkpoint(path, spec)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tct.restore_model(os.path.join(FIXTURES, 'golden_ref_container'))


def test_restore_reads_fully_pruned_section(tmp_path):
    """A coefficient tensor with no nonzeros leaves an empty quantized
    section (its centers and the trailing u32 only); the JAX reader fails
    on it, the port restores zeros."""
    jspec = jfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2)
    jparams, _ = jfg.init_model(jax.random.key(4), jspec)
    coeffs = list(jparams.coeffs)
    coeffs[1] = np.zeros_like(coeffs[1])
    jparams = jparams.replace(coeffs=tuple(coeffs))
    path = str(tmp_path / 'binary_model_file')
    jct.store_model_parameters(jspec, jparams, path, bit_precision=5, kmeans_seed=0)
    with pytest.raises(IndexError):
        jct.restore_model(path)
    _, model = tct.restore_model(path, device='cpu')
    assert not model.coeffs[1].detach().any()
    np.testing.assert_array_equal(model.mlp_w[0].detach().numpy().T,
                                  np.asarray(jparams.mlp_w[0]))


@pytest.mark.parametrize('bits', [8, 5])
@pytest.mark.parametrize('wavelet', ['db2', 'none'])
def test_port_container_restores_in_both_packages(tmp_path, bits, wavelet):
    """The port's writer: both readers restore the same arrays, with the
    zero pattern exact and the quantized values near the originals."""
    jspec = jfg.make_spec(grid_size=15, grid_features=8, hidden=16,
                          num_layers=3, wavelet=wavelet)
    jparams, _ = jfg.init_model(jax.random.key(5), jspec)
    jparams = prune(jparams, 0.6, seed=bits + 1)
    spec = tfg.make_spec(grid_size=15, grid_features=8, hidden=16, num_layers=3,
                         wavelet=wavelet)
    model = to_port(jparams, spec)
    path = str(tmp_path / 'binary_model_file')
    tct.store_model_parameters(model, path, bit_precision=bits)
    _, jrestored = jct.restore_model(path, wavelet=wavelet)
    _, restored = tct.restore_model(path, wavelet=wavelet, device='cpu')
    _assert_same(restored, jrestored)
    # k-means with 2^bits clusters of the nonzeros; raw first and last layers
    tol = {8: 0.02, 5: 0.2}[bits]
    for got, want in zip(restored.coeffs, model.coeffs):
        got, want = got.detach().numpy(), want.detach().numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, atol=tol)
    for i in (0, -1):
        np.testing.assert_array_equal(restored.mlp_w[i].detach().numpy(),
                                      model.mlp_w[i].detach().numpy())


def test_checkpoints_with_gates_round_trip_both_ways(tmp_path):
    kw = dict(grid_size=15, grid_features=4, hidden=8, num_layers=2,
              drop_type='smallify')
    jspec = jfg.make_spec(**kw)
    jparams, jaux = jfg.init_model(jax.random.key(6), jspec)
    rng = np.random.default_rng(6)
    jaux = jaux.replace(ema_var=tuple(rng.uniform(0, 1, v.shape).astype(np.float32)
                                      for v in jaux.ema_var))
    path = str(tmp_path / 'jax.npz')
    jck.save_checkpoint(path, jparams, jaux, 'smallify')
    spec = tfg.make_spec(**kw)
    model = tck.load_checkpoint(path, spec, device='cpu')
    _assert_same(model, jparams)
    for got, want in ((model.betas, jparams.gates.betas), (model.ema, jaux.ema),
                      (model.ema_var, jaux.ema_var)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))

    back = str(tmp_path / 'port.npz')
    tck.save_checkpoint(back, model)
    other, other_aux = jfg.init_model(jax.random.key(7), jspec)
    loaded, loaded_aux = jck.load_checkpoint(back, other, other_aux)
    _assert_same(model, loaded)
    for got, want in ((model.betas, loaded.gates.betas), (model.ema, loaded_aux.ema),
                      (model.ema_var, loaded_aux.ema_var)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    # a warm start from a file without gates keeps the fresh model's
    plain = str(tmp_path / 'plain.npz')
    jck.save_checkpoint(plain, jparams.replace(gates=None), None, '')
    fresh = tfg.init_model(spec, torch.Generator().manual_seed(1), device='cpu')
    warm = tck.load_checkpoint(plain, spec, device='cpu', model=fresh)
    _assert_same(warm, jparams)
    assert all(torch.equal(a, b) for a, b in zip(warm.betas, fresh.betas))
    with pytest.raises(ValueError, match='no gates'):
        tck.load_checkpoint(plain, spec, device='cpu')


def test_kmeans_quantization_is_as_good_as_jax():
    x = np.random.default_rng(8).standard_normal(20000).astype(np.float32)
    labels, centers = tct.kmeans_quantization(x, 256)
    assert labels.min() >= 0 and labels.max() < 256 and centers.dtype == np.float32
    assert np.all(np.diff(centers) > 0)
    jlabels, jcenters = jct.kmeans_quantization(x, 256, 0)
    err = np.mean((centers[labels] - x) ** 2)
    assert err <= 1.1 * np.mean((jcenters[jlabels] - x) ** 2)
    # fewer distinct values than clusters: each is a center, the rest zero
    labels, centers = tct.kmeans_quantization(np.array([2.0, -1.0, 2.0, 5.0]), 32)
    np.testing.assert_array_equal(centers[labels], [2.0, -1.0, 2.0, 5.0])
    assert len(centers) == 32 and not centers[3:].any()
    labels, centers = tct.kmeans_quantization(np.zeros(0), 16)
    assert labels.shape == (0,) and centers.shape == (16,) and not centers.any()


@pytest.mark.parametrize('bits', [1, 3, 5, 8, 9, 12])
def test_bit_packing_equals_jax(bits, tmp_path):
    ints = np.random.default_rng(bits).integers(0, 2 ** bits, 301)
    assert tct.ints_to_bits_to_bytes(ints, bits) == jct.ints_to_bits_to_bytes(ints, bits)
    mask = (np.random.default_rng(bits + 1).random(1003) < 0.4).astype(np.uint8)
    tct.write_mask_bnr(mask, str(tmp_path / 'a.bnr'))
    jct.write_mask_bnr(mask, str(tmp_path / 'b.bnr'))
    assert (tmp_path / 'a.bnr').read_bytes() == (tmp_path / 'b.bnr').read_bytes()
