"""The port's plain fetch and gradient that split every product into bf16
halves as the TPU kernel's 'f32' mode does
(``split_fetch_train.py::grid_sample_channel_minor_split`` and
``grid_sample_channel_minor_backward_split``: the JAX kernel's ``_dot_f32``
three-pass products and ``_dot_f32_right_exact`` z sums), held against
``pallas_grid_sample_3d(..., interpret=True)`` and its backward on small
shapes, as tests/test_pallas.py runs the kernel on the CPU: the whole-grid
kernel, and the HW-blocked one (H * W > 512).  No path of the port runs
the split versions; that script swaps them in for a study."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_feature_grid_compression_tpu.ops.pallas_kernels import pallas_grid_sample_3d
import split_fetch_train as sft
from latent_feature_grid_compression_tpu_torch.ops import interpolation as interp

# (C, D, H, W, samples): a small grid, the flagship's (16 features on 15^3),
# and one the Pallas kernels block over H * W
SHAPES = [(4, 5, 6, 7, 300), (16, 15, 15, 15, 1000), (3, 3, 24, 25, 200)]
# of max |.|: the split's products are exact and the sums are a few terms
# each, so only their order differs from the kernel's
SPLIT_TOL = 1e-6


def _inputs(C, D, H, W, n, seed=0):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((C, D, H, W)).astype(np.float32)
    # some samples outside the grid: their corners count zero
    coords = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    g = rng.standard_normal((n, C)).astype(np.float32)
    return features, coords, g


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_split_fetch_matches_the_pallas_f32_kernel(shape):
    """The split forward within SPLIT_TOL of max |.| of the interpreted
    Pallas kernel, where the unsplit plain fetch (exact float32 products)
    is at least 5 times further from it."""
    C, D, H, W, n = shape
    features, coords, _ = _inputs(*shape)
    want = np.asarray(pallas_grid_sample_3d(jnp.asarray(features), jnp.asarray(coords),
                                            interpret=True, precision='f32'))
    grid = interp.channel_minor(torch.from_numpy(features))
    c = torch.from_numpy(coords)
    split = sft.grid_sample_channel_minor_split(grid, c).numpy()
    plain = interp.grid_sample_channel_minor(grid, c).numpy()
    assert split.shape == want.shape == (n, C)
    assert _rel(split, want) <= SPLIT_TOL
    assert _rel(split, want) * 5 < _rel(plain, want)


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_split_gradient_matches_the_pallas_f32_backward(shape):
    """The split gradient against the interpreted Pallas backward (its
    custom VJP) likewise: within SPLIT_TOL of max |dG|, the unsplit plain
    gradient at least 5 times further."""
    C, D, H, W, n = shape
    features, coords, g = _inputs(*shape)
    _, vjp = jax.vjp(lambda f: pallas_grid_sample_3d(f, jnp.asarray(coords), interpret=True,
                                                     precision='f32'),
                     jnp.asarray(features))
    want = np.asarray(vjp(jnp.asarray(g))[0]).transpose(1, 2, 3, 0)
    c, gt = torch.from_numpy(coords), torch.from_numpy(g)
    split = sft.grid_sample_channel_minor_backward_split(gt, c, D, H, W).numpy()
    plain = interp.grid_sample_channel_minor_backward(gt, c, D, H, W).numpy()
    assert split.shape == want.shape == (D, H, W, C)
    assert _rel(split, want) <= SPLIT_TOL
    assert _rel(split, want) * 5 < _rel(plain, want)


def test_bf16_split_halves():
    """hi is the bf16 rounding, lo the bf16 rounding of the rest: hi + lo
    within 2^-16 of t, and both exact in bf16."""
    t = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32))
    hi, lo = sft.bf16_split(t)
    for half in (hi, lo):
        assert torch.equal(half, half.to(torch.bfloat16).to(torch.float32))
    assert torch.all((hi + lo - t).abs() <= t.abs() * 2.0 ** -16)
