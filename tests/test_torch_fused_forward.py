"""The port's one-kernel model forward (``ops/fused_forward.py``, the plain
versions of the kernels in ``csrc/fused_forward.cu``) against the JAX
package's Pallas ``fused_forward`` in interpret mode, forward and gradients,
and the model forward under ``interp_backend='fused'`` against the JAX
``apply_model``.  Inputs are made with numpy; JAX runs on the CPU.

Tolerances: 'f32' at the JAX fused test's 5e-5 (forward) and 2e-4 of
max |.| (gradients); its 'f32' is a 3-pass bf16 split (~1e-6 relative).
'mixed' forward at the JAX test's 2e-3 / 1e-2: the port fetches in exact
float32 and JAX in that split, so where the two x0 differ in the last bits,
the bf16 rounding of an operand can fall either way (measured up to 2e-4 on
the forward).  For the same reason the 'mixed' gradients are held to 1e-2
of max |.| (measured up to 2.8e-3 on the grid, whose cells get a few
samples each at these sizes)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.ops import fused_forward as jff
from latent_feature_grid_compression_tpu.ops.mlp import init_mlp
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as tff
from latent_feature_grid_compression_tpu_torch.ops.grid_sample import fetch
from latent_feature_grid_compression_tpu_torch.ops.interpolation import channel_minor
from latent_feature_grid_compression_tpu_torch.ops.mlp_fused import mlp_fused_plain
from tests.torch_port_util import to_port

# (C, grid, hidden, layers, n): the JAX fused test's shape and the flagship
SHAPES = [(8, 9, 16, 3, 200), (16, 15, 32, 4, 1024)]
FWD_TOL = {'f32': dict(atol=5e-5, rtol=1e-4), 'mixed': dict(atol=2e-3, rtol=1e-2)}
GRAD_TOL = {'f32': 2e-4, 'mixed': 1e-2}
N_FREQS = 2


def _inputs(C, G, hidden, layers, n, d_out=1, seed=0, coords=None):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, G, G, G)).astype(np.float32)
    if coords is None:
        coords = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    ws, bs = init_mlp(jax.random.key(seed), 3 + 6 * N_FREQS + C, hidden, d_out, layers)
    ct = rng.standard_normal((coords.shape[0], d_out)).astype(np.float32)
    return feats, coords, tuple(ws), tuple(bs), ct


def _jax(feats, coords, ws, bs, precision):
    return jff.fused_forward(feats, jnp.asarray(coords), ws, bs, N_FREQS,
                             precision=precision, interpret=True, block_n=128)


def _port(feats, ws, bs, grad=False):
    tf = torch.from_numpy(feats).requires_grad_(grad)
    tw = [torch.from_numpy(np.asarray(w).T.copy()).requires_grad_(grad) for w in ws]
    tb = [torch.from_numpy(np.array(b)).requires_grad_(grad) for b in bs]
    return tf, tw, tb


def _forward(feats, coords, ws, bs, precision):
    tf, tw, tb = _port(feats, ws, bs)
    with torch.no_grad():
        return tff.fused_forward(channel_minor(tf), torch.from_numpy(coords), tw, tb,
                                 N_FREQS, precision).numpy()


@pytest.mark.parametrize('precision', ['f32', 'mixed'])
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_forward_matches_jax_kernel(shape, precision):
    feats, coords, ws, bs, _ = _inputs(*shape)
    ref = np.asarray(_jax(jnp.asarray(feats), coords, ws, bs, precision))
    out = _forward(feats, coords, ws, bs, precision)
    assert out.shape == ref.shape == (shape[4], 1)
    np.testing.assert_allclose(out, ref, **FWD_TOL[precision])


@pytest.mark.parametrize('precision', ['f32', 'mixed'])
def test_out_of_range_coords_fetch_zero(precision):
    """Coordinates at 3.5 lie outside the grid: every corner weight is zero,
    the features are 0 (grid_sample's zero padding), as in the JAX kernel."""
    coords = np.full((64, 3), 3.5, np.float32)
    feats, coords, ws, bs, _ = _inputs(8, 9, 16, 3, 64, coords=coords)
    ref = np.asarray(_jax(jnp.asarray(feats), coords, ws, bs, precision))
    np.testing.assert_allclose(_forward(feats, coords, ws, bs, precision), ref,
                               **FWD_TOL[precision])
    x0 = tff.mlp_input(channel_minor(torch.from_numpy(feats)),
                       torch.from_numpy(coords), N_FREQS)
    assert float(x0[:, 3 + 6 * N_FREQS:].abs().max()) == 0.0


@pytest.mark.parametrize('precision', ['f32', 'mixed'])
def test_multi_output_head(precision):
    feats, coords, ws, bs, _ = _inputs(8, 9, 16, 3, 200, d_out=4, seed=1)
    ref = np.asarray(_jax(jnp.asarray(feats), coords, ws, bs, precision))
    out = _forward(feats, coords, ws, bs, precision)
    assert out.shape == (200, 4)
    np.testing.assert_allclose(out, ref, **FWD_TOL[precision])


@pytest.mark.parametrize('precision', ['f32', 'mixed'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('shape', SHAPES)
def test_gradients_match_jax_kernel(shape, seed, precision):
    """Gradients with respect to the (C, D, H, W) features (through the
    channel-minor copy) and every MLP parameter, each scaled by its max |.|."""
    feats, coords, ws, bs, ct = _inputs(*shape, seed=seed)

    def loss(args):
        return jnp.sum(_jax(args[0], coords, args[1], args[2], precision) * ct)

    g_f, g_ws, g_bs = jax.grad(loss)((jnp.asarray(feats), ws, bs))
    tf, tw, tb = _port(feats, ws, bs, grad=True)
    out = tff.fused_forward(channel_minor(tf), torch.from_numpy(coords), tw, tb,
                            N_FREQS, precision)
    (out * torch.from_numpy(ct)).sum().backward()
    pairs = ([(tf.grad, g_f)] + [(w.grad, np.asarray(g).T) for w, g in zip(tw, g_ws)]
             + [(b.grad, g) for b, g in zip(tb, g_bs)])
    for got, want in pairs:
        want = np.asarray(want)
        scale = np.abs(want).max() + 1e-8
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL[precision] * scale


def test_plain_forward_is_the_fetch_then_the_fused_mlp():
    """The plain version's x0 is the fetch's features behind [coords |
    fourier]: what the kernel computes with the fetch kernel's arithmetic."""
    feats, coords, ws, bs, _ = _inputs(16, 15, 32, 4, 300, seed=3)
    tf, tw, tb = _port(feats, ws, bs)
    grid, c = channel_minor(tf), torch.from_numpy(coords)
    x0 = tff.mlp_input(grid, c, N_FREQS)
    assert torch.equal(x0[:, 3 + 6 * N_FREQS:], fetch(grid, c))
    for precision, mlp_precision in (('mixed', 'bf16'), ('f32', 'f32')):
        assert torch.equal(tff.fused_forward_plain(grid, c, tw, tb, N_FREQS, precision),
                           mlp_fused_plain(tw, tb, x0, mlp_precision))


def test_unported_precision_and_bad_widths_raise():
    """'bf16', ported now, runs the plain bf16 one-kernel forward; an
    unknown precision and widths the kernels do not take raise."""
    feats, coords, ws, bs, _ = _inputs(8, 9, 16, 3, 32)
    tf, tw, tb = _port(feats, ws, bs)
    grid, c = channel_minor(tf), torch.from_numpy(coords)
    out = tff.fused_forward(grid, c, tw, tb, N_FREQS, precision='bf16')
    assert out.shape == (32, 1) and out.dtype == torch.float32
    assert torch.equal(out, tff.fused_forward_plain(grid, c, tw, tb, N_FREQS, 'bf16'))
    with pytest.raises(ValueError, match='precision'):
        tff.fused_forward(grid, c, tw, tb, N_FREQS, precision='f16')
    with pytest.raises(ValueError, match='take width'):
        tff.fused_forward(grid, c, tw, tb, N_FREQS + 1)
    wide = _inputs(8, 9, 129, 2, 32)
    _, tw, tb = _port(feats, wide[2], wide[3])
    with pytest.raises(ValueError, match='widths'):
        tff.fused_forward(grid, c, tw, tb, N_FREQS)


def test_cuda_wrappers_refuse_cpu_tensors():
    feats, coords, ws, bs, ct = _inputs(8, 9, 16, 3, 32)
    tf, tw, tb = _port(feats, ws, bs)
    grid, c = channel_minor(tf), torch.from_numpy(coords)
    before = (tff.launches, tff.bwd_launches)
    with pytest.raises(ValueError, match='CUDA tensor'):
        tff.fused_forward_cuda(grid, c, tw, tb, N_FREQS)
    with pytest.raises(ValueError, match='CUDA tensor'):
        tff.fused_forward_backward_cuda(grid, c, tw, tb, N_FREQS, torch.from_numpy(ct))
    assert (tff.launches, tff.bwd_launches) == before


@pytest.mark.parametrize('train', [True, False])
def test_apply_model_fused_matches_jax(train, monkeypatch):
    """The model forward under interp_backend='fused' (precision 'mixed')
    against the JAX apply_model with the same spec, its fused kernel in
    interpret mode (patched in as tests/test_fused_forward.py does)."""
    orig = jff.fused_forward
    monkeypatch.setattr(jff, 'fused_forward',
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    kw = dict(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=N_FREQS,
              grid_features=16, grid_size=15, wavelet='db2', interp_backend='fused')
    jspec = jfg.make_spec(**kw)
    jparams, _ = jfg.init_model(jax.random.key(5), jspec)
    model = to_port(jparams, tfg.make_spec(**kw))
    coords = np.random.default_rng(6).uniform(-1.1, 1.1, (1500, 3)).astype(np.float32)
    ref = np.asarray(jfg.apply_model(jspec, jparams, jnp.asarray(coords), train=train))
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(coords), train=train).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL['mixed'])
    if not train:
        assert float(np.abs(out).max()) <= 1.0
