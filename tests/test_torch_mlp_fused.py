"""The port's fused SnakeAlt MLP (``ops/mlp_fused.py``, the plain versions
of the kernels in ``csrc/mlp_fused.cu``) against the JAX package's Pallas
kernel ``mlp_apply_pallas`` in interpret mode, forward and gradients, and
the model forward under ``mlp_backend='pallas'`` against the JAX
``apply_model``.  Inputs are made with numpy; JAX runs on the CPU.

Tolerances: 'f32' at the JAX kernel test's bounds (forward 1e-5, gradients
2e-4: the TPU kernel's 'f32' is a 3-pass bf16 split, ~1e-6 relative).
'bf16' rounds the products' operands at the same places as the TPU kernel,
so the two differ only in float32 summation order (measured <= 3e-8 on the
forward, <= 1e-5 of max |.| on the gradients); the bound 1e-3 of max |.|
leaves room for an operand whose bf16 rounding that order flips (one flip
moves one output by ~2^-9 of a product)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.ops import mlp_pallas as jmp
from latent_feature_grid_compression_tpu.ops.mlp import init_mlp
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf
from tests.torch_port_util import to_port

# (n, d_in, hidden, d_out, layers): the flagship widths, and the JAX test's
# non-aligned case
SHAPES = [(512, 31, 32, 1, 4), (700, 19, 24, 3, 2)]
FWD_TOL = {'f32': 1e-5, 'bf16': 1e-3}
GRAD_TOL = {'f32': 2e-4, 'bf16': 1e-3}


def _inputs(n, d_in, hidden, d_out, layers, seed=0):
    ws, bs = init_mlp(jax.random.key(seed), d_in, hidden, d_out, layers)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    ct = rng.standard_normal((n, d_out)).astype(np.float32)
    return tuple(ws), tuple(bs), x, ct


def _port(ws, bs, x, grad=False):
    tw = [torch.from_numpy(np.asarray(w).T.copy()).requires_grad_(grad) for w in ws]
    tb = [torch.from_numpy(np.array(b)).requires_grad_(grad) for b in bs]
    return tw, tb, torch.from_numpy(x).requires_grad_(grad)


def _interpret(fn):
    def wrapped(*a, **k):
        return fn(*a, **dict(k, interpret=True))
    return wrapped


# the JAX kernel in interpret mode (the model test patches it in, as
# tests/test_fused_forward.py does for the fused forward)
_JAX_MLP = _interpret(jmp.mlp_apply_pallas)


def _jax(ws, bs, x, precision):
    return _JAX_MLP(ws, bs, x, precision=precision, block_n=256)


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_forward_matches_jax_kernel(shape, precision):
    ws, bs, x, _ = _inputs(*shape)
    ref = np.asarray(_jax(ws, bs, jnp.asarray(x), precision))
    tw, tb, tx = _port(ws, bs, x)
    out = mf.mlp_fused_plain(tw, tb, tx, precision).numpy()
    assert out.shape == ref.shape == (shape[0], shape[3])
    np.testing.assert_allclose(out, ref, atol=FWD_TOL[precision] * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES)
def test_gradients_match_jax_kernel(shape, precision):
    """dX, every dW and db through the autograd Function (the plain
    backward on the CPU) against jax.grad of the Pallas kernel."""
    ws, bs, x, ct = _inputs(*shape, seed=1)

    def loss(ws, bs, x):
        return jnp.sum(_jax(ws, bs, x, precision) * ct)

    g_ws, g_bs, g_x = jax.grad(loss, argnums=(0, 1, 2))(ws, bs, jnp.asarray(x))
    tw, tb, tx = _port(ws, bs, x, grad=True)
    (mf.mlp_fused(tw, tb, tx, precision) * torch.from_numpy(ct)).sum().backward()
    pairs = ([(tx.grad, g_x)] + [(w.grad, np.asarray(g).T) for w, g in zip(tw, g_ws)]
             + [(b.grad, g) for b, g in zip(tb, g_bs)])
    for got, want in pairs:
        want = np.asarray(want)
        if precision == 'f32':
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
        else:
            scale = np.abs(want).max()
            assert np.abs(got.numpy() - want).max() <= GRAD_TOL['bf16'] * scale


def test_bf16_backward_rounds_at_the_kernels_places():
    """The written-out backward rounds dz before its products; autograd of
    the rounded forward would not, and lands measurably elsewhere."""
    ws, bs, x, ct = _inputs(512, 31, 32, 1, 4, seed=2)
    tw, tb, tx = _port(ws, bs, x, grad=True)
    dx, dws, _ = mf.mlp_fused_plain_backward(tw, tb, tx, torch.from_numpy(ct), 'bf16')
    (mf.mlp_fused_plain(tw, tb, tx, 'bf16') * torch.from_numpy(ct)).sum().backward()
    assert not torch.equal(dws[0], tw[0].grad)

    def loss(ws, bs, x):
        return jnp.sum(_jax(ws, bs, x, 'bf16') * ct)

    g_w0 = np.asarray(jax.grad(loss)(ws, bs, jnp.asarray(x))[0]).T
    assert (np.abs(dws[0].detach().numpy() - g_w0).max()
            < np.abs(tw[0].grad.numpy() - g_w0).max())


def test_widths_over_128_raise():
    ws, bs, x, _ = _inputs(64, 31, 129, 1, 2)
    tw, tb, tx = _port(ws, bs, x)
    with pytest.raises(ValueError, match='widths'):
        mf.mlp_fused(tw, tb, tx)
    with pytest.raises(ValueError, match='widths'):
        mf.mlp_fused_cuda(tw, tb, tx)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch only on CUDA tensors; the CPU takes the
    plain versions through :func:`mf.mlp_fused` alone."""
    ws, bs, x, ct = _inputs(64, 31, 32, 1, 4)
    tw, tb, tx = _port(ws, bs, x)
    before = (mf.launches, mf.bwd_launches)
    with pytest.raises(ValueError, match='CUDA tensor'):
        mf.mlp_fused_cuda(tw, tb, tx)
    with pytest.raises(ValueError, match='CUDA tensor'):
        mf.mlp_fused_backward_cuda(tw, tb, tx, torch.from_numpy(ct))
    with pytest.raises(ValueError, match='precision'):
        mf.mlp_fused(tw, tb, tx, precision='mixed')
    out = mf.mlp_fused(tw, tb, tx)
    assert out.shape == (64, 1) and (mf.launches, mf.bwd_launches) == before


@pytest.mark.parametrize('train', [True, False])
def test_apply_model_mlp_pallas_matches_jax(train, monkeypatch):
    """The model forward under mlp_backend='pallas' (the fetch, then the
    fused MLP in 'bf16') against the JAX apply_model with the same spec, its
    Pallas MLP in interpret mode."""
    monkeypatch.setattr(jmp, 'mlp_apply_pallas', _JAX_MLP)
    kw = dict(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=2,
              grid_features=16, grid_size=15, wavelet='db2', mlp_backend='pallas')
    jspec = jfg.make_spec(interp_backend='xla', **kw)
    jparams, _ = jfg.init_model(jax.random.key(3), jspec)
    model = to_port(jparams, tfg.make_spec(**kw))
    coords = np.random.default_rng(4).uniform(-1.1, 1.1, (1500, 3)).astype(np.float32)
    ref = np.asarray(jfg.apply_model(jspec, jparams, jnp.asarray(coords), train=train))
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(coords), train=train).numpy()
    np.testing.assert_allclose(out, ref, atol=FWD_TOL['bf16'] * np.abs(ref).max())
