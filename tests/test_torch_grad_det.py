"""The deterministic grid gradient's formulation on the CPU.

``csrc/grid_sample_bwd.cu`` buckets the samples by their lower corner,
each bucket in ascending sample order, and sums every entry of dG in one
thread: over the 8 corners in the order z, y, x, then over the samples of
the bucket that corner maps to.  ``bucketed_backward`` below is that
formulation in plain PyTorch.  It is held bit for bit against the plain
versions the kernel must equal (``grid_sample_channel_minor_backward`` and
its 'bf16' mode, both ``index_add_`` once a corner), at the grids and
widths the paths draw, on a windowed grid and on coordinates outside
[-1, 1]; and against the JAX package's Pallas gradient in interpret mode at
``tests/test_torch_grad.py``'s and ``tests/test_torch_bf16.py``'s
tolerances.  The kernel itself is held against the plain version on the
card in ``tests/test_torch_cuda.py``."""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.ops import pallas_kernels as jpk
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as tff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops.embedding import fourier_out_dim
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    bf16_round, grid_sample_channel_minor_backward, grid_sample_channel_minor_backward_bf16)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    'latent_feature_grid_compression_tpu_torch')
# tests/test_torch_bf16.py's bounds for the 'bf16' gradient against the
# Pallas kernel (share of entries within BF16_TOL of max |.|, and the worst)
BF16_SHARE, BF16_TOL, BF16_MAX = 0.999, 1e-6, 4e-3


def bucketed_backward(g, coords, D, H, W, precision='f32'):
    """The gradient kernel's order in plain PyTorch: (D, H, W, C) float32."""
    n, C = g.shape
    pix = ((coords + 1.0) * torch.tensor([W, H, D], dtype=coords.dtype) - 1.0) * 0.5
    lo = torch.floor(pix)
    frac = pix - lo
    lo = lo.to(torch.int64)
    inside = ((lo >= -1) & (lo < torch.tensor([W, H, D]))).all(1)
    key = ((lo[:, 2] + 1) * (H + 1) + (lo[:, 1] + 1)) * (W + 1) + (lo[:, 0] + 1)
    key = torch.where(inside, key, torch.full_like(key, -1))
    order = torch.argsort(key, stable=True)
    order = order[key[order] >= 0]
    counts = torch.bincount(key[order], minlength=(D + 1) * (H + 1) * (W + 1))
    starts = torch.cumsum(counts, 0) - counts
    r = torch.arange(D * H * W)
    z, y, x = r // (H * W), (r // W) % H, r % W
    g16 = bf16_round(g)
    acc = torch.zeros((D * H * W, C), dtype=torch.float32)
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        b = ((z - dz + 1) * (H + 1) + (y - dy + 1)) * (W + 1) + (x - dx + 1)
        first, length = starts[b], counts[b]
        for j in range(int(length.max()) if len(length) else 0):
            live = length > j
            s = order[first[live] + j]
            fx, fy, fz = frac[s, 0], frac[s, 1], frac[s, 2]
            wx = fx if dx else 1.0 - fx
            wy = fy if dy else 1.0 - fy
            wz = fz if dz else 1.0 - fz
            wxy = wx * wy
            if precision == 'bf16':
                term = bf16_round(wz[:, None] * g16[s]) * bf16_round(wxy)[:, None]
            else:
                term = g[s] * (wxy * wz)[:, None]
            rows = r[live]
            acc[rows] = acc[rows] + term
    return acc.view(D, H, W, C)


def _inputs(C, shape, n, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32))
    return g, coords


def _plain(precision):
    return (grid_sample_channel_minor_backward_bf16 if precision == 'bf16'
            else grid_sample_channel_minor_backward)


# grids 4 (4,096 adds an entry at a train step), 8, the flagship 15 and 23
# (the blocked Pallas kernels'), C 5 and 16, then mhd_p_HyperparamSearch.txt's
# C 22 on 17^3, the mesh's windowed (15, 15, 8) grid, and an anisotropic one
CASES = ([(C, (G, G, G)) for G in (4, 8, 15, 23) for C in (5, 16)]
         + [(22, (17, 17, 17)), (16, (15, 15, 8)), (3, (5, 7, 9))])


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('C,shape', CASES)
def test_bucketed_order_is_the_plain_version_bit_for_bit(C, shape, precision):
    D, H, W = shape
    n = 6000 if D <= 8 else 2500
    g, coords = _inputs(C, shape, n, C * 100 + D + W)
    want = _plain(precision)(g, coords, D, H, W)
    assert torch.equal(bucketed_backward(g, coords, D, H, W, precision), want)


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('lo,hi', [(-1.3, 1.3), (-3.0, -0.9), (0.9, 2.5)])
def test_bucketed_order_outside_the_grid(lo, hi, precision):
    """Coordinates outside [-1, 1]: samples whose lower corner lies outside
    [-1, size-1] on an axis touch no row and are dropped; those at -1 or
    size-1 reach only their in-range corners."""
    g, coords = _inputs(16, (9, 10, 11), 3000, int(10 * hi) + 50, lo, hi)
    want = _plain(precision)(g, coords, 9, 10, 11)
    assert torch.equal(bucketed_backward(g, coords, 9, 10, 11, precision), want)


def test_bucketed_order_on_corners_and_repeated_points():
    """Exact pixel centres (a fraction of 0, so a zero-weight upper corner),
    the grid's edges, and many samples at one point, whose terms an entry
    sums in sample order."""
    D = H = W = 6
    centres = (2 * torch.arange(W, dtype=torch.float32) + 1) / W - 1
    pts = torch.cartesian_prod(centres, centres, centres)
    edges = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [-1.0, 1.0, 0.0]])
    same = torch.full((500, 3), 0.123)
    coords = torch.cat([pts, edges, same, pts.flip(0)]).contiguous()
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (coords.shape[0], 8)).astype(np.float32))
    for precision in ('f32', 'bf16'):
        want = _plain(precision)(g, coords, D, H, W)
        assert torch.equal(bucketed_backward(g, coords, D, H, W, precision), want)


def _jax_grad(features, coords, g, precision):
    _, vjp = jax.vjp(lambda f: jpk.pallas_grid_sample_3d(
        f, jnp.asarray(coords), interpret=True, precision=precision), jnp.asarray(features))
    return np.asarray(vjp(jnp.asarray(g))[0])


# tests/test_torch_grad.py's shapes and tolerances: the unblocked Pallas
# backward (grid 8) and the HW-blocked one (grid 32); 'f32' is a 3-pass
# bf16 split on the TPU
@pytest.mark.parametrize('shape,n,seed,tol', [((4, 8, 8, 8), 513, 1, 2e-4),
                                              ((8, 32, 32, 32), 400, 3, 3e-4)])
def test_bucketed_order_matches_pallas_interpret(shape, n, seed, tol):
    C, D, H, W = shape
    g, coords = _inputs(C, shape[1:], n, seed)
    features = np.zeros(shape, np.float32)
    ref = _jax_grad(features, coords.numpy(), g.numpy(), 'f32')
    got = bucketed_backward(g, coords, D, H, W).permute(3, 0, 1, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize('C,G', [(16, 8), (5, 15), (16, 23)])
def test_bucketed_bf16_order_matches_pallas_interpret(C, G):
    g, coords = _inputs(C, (G, G, G), 700, 3 * C + G, -1.2, 1.2)
    ref = _jax_grad(np.zeros((C, G, G, G), np.float32), coords.numpy(), g.numpy(), 'bf16')
    got = bucketed_backward(g, coords, G, G, G, 'bf16').permute(3, 0, 1, 2).numpy()
    scale = np.abs(ref).max()
    diff = np.abs(got.astype(np.float64) - ref)
    assert (diff <= BF16_TOL * scale).mean() >= BF16_SHARE
    assert diff.max() <= BF16_MAX * scale


@pytest.mark.parametrize('precision', ['mixed', 'bf16'])
def test_fused_plain_backward_routes_dx_in_the_bucketed_order(precision):
    """The one-kernel backward's dG is the fetch's gradient of dX's feature
    columns, which the card computes with the same kernel."""
    from latent_feature_grid_compression_tpu_torch.ops.mlp_fused import mlp_fused_plain_backward
    rng = np.random.default_rng(11)
    C, G, n, nf = 8, 9, 1500, 2
    grid = torch.from_numpy(rng.standard_normal((G, G, G, C)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32))
    dims = [3 + fourier_out_dim(nf, 3) + C, 16, 16, 1]
    ws = [torch.from_numpy((rng.uniform(-1, 1, (b, a)) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy((rng.uniform(-1, 1, b) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    g = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32))
    dgrid, _, _ = tff.fused_forward_plain_backward(grid, coords, ws, bs, nf, g, precision)
    mlp, interp = tff._split(precision)
    dx, _, _ = mlp_fused_plain_backward(ws, bs, tff.mlp_input(grid, coords, nf, interp), g, mlp)
    want = bucketed_backward(dx[:, dims[0] - C:].contiguous(), coords, G, G, G, interp)
    assert torch.equal(dgrid, want)


def test_gradient_wrappers_refuse_cpu_tensors():
    g, coords = _inputs(4, (5, 5, 5), 10, 7)
    for call in (gs.grid_sample_channel_minor_backward_cuda,
                 gs.grid_sample_channel_minor_backward_bf16_cuda):
        with pytest.raises(ValueError, match='CUDA tensor'):
            call(g, coords, 5, 5, 5)
        with pytest.raises(ValueError, match=r'g \(N, C\)'):
            call(g[:5], coords, 5, 5, 5)
    with pytest.raises(ValueError, match='precision'):
        gs.bwd_plan(10, 4, 5, 5, 5, 'f16')


def test_fused_backward_wrappers_refuse_cpu_tensors():
    grid = torch.zeros((5, 5, 5, 4))
    coords = torch.zeros((10, 3))
    dims = [3 + fourier_out_dim(2, 3) + 4, 8, 1]
    ws = [torch.zeros((b, a)) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(b) for b in dims[1:]]
    g = torch.zeros((10, 1))
    for call in (tff.fused_forward_backward_cuda, tff.fused_forward_backward_dx_cuda):
        with pytest.raises(ValueError, match='CUDA tensor'):
            call(grid, coords, ws, bs, 2, g)


def test_scratch_size_is_the_kernels():
    """The wrapper allocates the scratch the kernel checks for: the same
    count, with the kernel's most blocks."""
    with open(os.path.join(PORT, 'csrc', 'grid_sample_bwd.cu')) as f:
        src = f.read()
    assert f'constexpr int kMaxBlocks = {gs.BWD_SCRATCH_BLOCKS};' in src
    assert ('return (6 + int64_t(C)) * n + 3 * buckets_of(D, H, W) + 2 + kMaxBlocks;'
            in src)
    assert re.search(r'return int64_t\(D \+ 1\) \* \(H \+ 1\) \* \(W \+ 1\);', src)
    assert (gs.bwd_scratch_words(32768, 16, 15, 15, 15)
            == (6 + 16) * 32768 + 3 * 16 ** 3 + 2 + 1024)


def test_fetch_backward_on_the_cpu_is_the_bucketed_order():
    """Autograd through fetch on CPU tensors: the plain version, so the
    card's kernel and the CPU give one gradient bit for bit."""
    g, coords = _inputs(16, (15, 15, 15), 2000, 21, -1.1, 1.1)
    for precision in ('f32', 'bf16'):
        grid = torch.zeros((15, 15, 15, 16), requires_grad=True)
        (gs.fetch(grid, coords, precision) * g).sum().backward()
        assert torch.equal(grid.grad, bucketed_backward(g, coords, 15, 15, 15, precision))
