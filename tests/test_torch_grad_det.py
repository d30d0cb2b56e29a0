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
tolerances.

``box_backward`` models how the kernel gets there: boxes of dG's rows and
groups of channels, a block each; a block keeps its boxes' samples in index
order from the stream of keys (at most ``cap`` at a time), sorts them by
bucket stably through a table of (bucket, warp) counts and each sample's
rank among the equal buckets of its warp's step of 32, stages the factors
of each term, and sums its rows' entries from them; a box with more
samples than ``cap`` takes the corners one at a time, in windows of the
index order.  It is held bit for bit against both on crowded positions,
the windowed grid, coordinates outside [-1, 1] and tiny batches.  The
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``."""

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


# the kernel's block (kThreads) and its sort's (bucket, warp) table (kTableInts)
THREADS, TABLE_INTS = 512, 4096


def _lower_corner_buckets(coords, D, H, W):
    """Each sample's bucket coordinates (its lower corner + 1, (N, 3) as z,
    y, x) and whether the corner lies in [-1, size-1] on every axis."""
    pix = ((coords + 1.0) * torch.tensor([W, H, D], dtype=coords.dtype) - 1.0) * 0.5
    lo = torch.floor(pix).to(torch.int64)
    inside = ((lo >= -1) & (lo < torch.tensor([W, H, D]))).all(1)
    return (lo + 1).flip(1), inside


def _stable_slots(key, classes, nwp):
    """The kernels' stable counting sort of ``key`` (values < classes, in
    index order): nwp warps take contiguous shares, count their keys into a
    (key, warp) table, scan it key-major, and walk their shares 32 at a
    time, a sample's slot its (key, warp) slot plus its rank among the equal
    keys before it in its step (__match_any_sync, __popc) and in earlier
    steps.  Returns each sample's slot and each key's first slot."""
    m = len(key)
    bounds = [m * w // nwp for w in range(nwp + 1)]
    warp = torch.zeros(m, dtype=torch.int64)
    for w in range(nwp):
        warp[bounds[w]:bounds[w + 1]] = w
    cell = key * nwp + warp
    counts = torch.bincount(cell, minlength=classes * nwp)
    table = torch.cumsum(counts, 0) - counts   # (key, warp) first slots
    first = table.view(classes, nwp)[:, 0].clone()
    slot = torch.empty(m, dtype=torch.int64)
    lower = torch.tril(torch.ones(32, 32, dtype=torch.bool), -1)
    for w in range(nwp):
        for s0 in range(bounds[w], bounds[w + 1], 32):
            c = cell[s0:min(s0 + 32, bounds[w + 1])]
            peers = c[:, None] == c[None, :]
            rank = (peers & lower[:len(c), :len(c)]).sum(1)
            slot[s0:s0 + len(c)] = table[c] + rank
            table.index_add_(0, c, torch.ones_like(c))
    return slot, first


def _tiles(coords, D, H, W):
    """The tile kernel: for each tile of the sample order, its kept samples'
    (index, bucket) pairs sorted by bin (bucket rows) stably, and each bin's
    first item (the last: the tile's kept count).  Its warps walk their
    shares in turn, so the walk is one share's."""
    n = len(coords)
    T, tiles, f, nb = gs.bwd_tiling(n, D, H)
    bucket, inside = _lower_corner_buckets(coords, D, H, W)
    key = torch.where(inside, (bucket[:, 0] * (H + 1) + bucket[:, 1]) * (W + 1) + bucket[:, 2],
                      torch.full((n,), -1, dtype=torch.int64))
    items, starts = [], []
    for t in range(tiles):
        i = torch.arange(t * T, (t + 1) * T)
        k = torch.where(i < n, key[i.clamp(max=max(n - 1, 0))], torch.full_like(i, -1))
        bins = torch.where(k >= 0, k // (W + 1) // f, torch.full_like(k, nb))
        slot, first = _stable_slots(bins, nb + 1, 1)   # the warps in turn: one share
        order = torch.empty(T, dtype=torch.int64)
        order[slot] = torch.arange(T)
        kept = int(first[nb])
        items.append(torch.stack([i[order[:kept]], k[order[:kept]]], 1))
        starts.append(first)
    return items, starts, f


def _box_items(items, starts, f, rows):
    """A box's items: for each tile in order, the items of the bins of its
    bucket-row ranges (``rows``, inclusive), one segment a range."""
    ranges = [(lo // f, hi // f) for lo, hi in rows]
    if len(ranges) == 2 and ranges[1][0] <= ranges[0][1] + 1:
        ranges = [(ranges[0][0], ranges[1][1])]
    segs = [it[int(st[lo]):int(st[hi + 1])] for it, st in zip(items, starts)
            for lo, hi in ranges]
    return torch.cat(segs) if segs else torch.zeros((0, 2), dtype=torch.int64)


def _fill(lbs, take, start, cap):
    """The ordered compaction over a box's items: the first ``cap`` items
    from place ``start`` on whose local bucket is in the box (>= 0) and
    passes ``take``, and the place of the first passing item past them (the
    items' count if none)."""
    n = len(lbs)
    passing = (lbs >= 0) & take(lbs.clamp(min=0)) & (torch.arange(n) >= start)
    found = torch.nonzero(passing).flatten()
    nxt = int(found[cap]) if len(found) > cap else n
    return found[:cap], nxt


def _place(lb, nb):
    """The box kernel's stable counting sort of the kept samples' local
    buckets ``lb`` (in the items' order), with as many warps as its
    (bucket, warp) table leaves: each sample's slot, each bucket's first
    slot (nb + 1)."""
    nwp = max(1, min(THREADS // 32, TABLE_INTS // nb))
    slot, first = _stable_slots(lb, nb, nwp)
    return slot, torch.cat([first, torch.tensor([len(lb)])])


def _box_pass(g, coords, idx, slot, begin, box, c0, cw, k0, k1, out, first, precision):
    """Stage the kept samples' factors by slot and add corners k0..k1 of
    the box's rows, channels c0..c0+cw, into ``out`` (from +0 on the first
    pass)."""
    D, H, W, C = out.shape
    z0, y0, x0, Z, Y, X = box
    m = len(idx)
    frac = (((coords[idx] + 1.0) * torch.tensor([W, H, D], dtype=coords.dtype) - 1.0) * 0.5)
    frac = frac - torch.floor(frac)
    wx = torch.stack([1.0 - frac[:, 0], frac[:, 0]])
    wy = torch.stack([1.0 - frac[:, 1], frac[:, 1]])
    wz = torch.stack([1.0 - frac[:, 2], frac[:, 2]])
    gv = g[idx, c0:c0 + cw]
    weight = torch.empty((m, 8))
    scaled = torch.empty((m, 2, cw))
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        wxy = wx[dx] * wy[dy]
        weight[slot, k] = bf16_round(wxy) if precision == 'bf16' else wxy * wz[dz]
    for dz in range(2):
        scaled[slot, dz] = (bf16_round(wz[dz][:, None] * bf16_round(gv)) if precision == 'bf16'
                            else gv)
    zl, yl, xl = torch.meshgrid(torch.arange(Z), torch.arange(Y), torch.arange(X),
                                indexing='ij')
    zl, yl, xl = zl.flatten(), yl.flatten(), xl.flatten()
    rows = out[z0:z0 + Z, y0:y0 + Y, x0:x0 + X, c0:c0 + cw].reshape(-1, cw)
    acc = torch.zeros_like(rows) if first else rows.clone()
    for k in range(k0, k1 + 1):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        b = ((zl + 1 - dz) * (Y + 1) + (yl + 1 - dy)) * (X + 1) + (xl + 1 - dx)
        lo, length = begin[b], begin[b + 1] - begin[b]
        for j in range(int(length.max()) if len(length) else 0):
            live = length > j
            at = lo[live] + j
            acc[live] = acc[live] + weight[at, k][:, None] * scaled[at, dz]
    out[z0:z0 + Z, y0:y0 + Y, x0:x0 + X, c0:c0 + cw] = acc.view(Z, Y, X, cw)


def box_backward(g, coords, D, H, W, precision='f32', box=(1, 2, 15), cb=16, cap=2048,
                 per_corner=False):
    """The gradient kernel's blocks in plain PyTorch: (D, H, W, C) float32.

    Boxes of ``box`` = (zs, ys, xs) rows (below whole planes only in one
    plane, below whole lines only in one line), groups of ``cb`` channels; a
    block keeps at most ``cap`` samples at once and, when its box holds more
    (or with ``per_corner``), takes the corners one at a time in windows of
    the index order."""
    n, C = g.shape
    zs, ys, xs = min(box[0], D), min(box[1], H), min(box[2], W)
    ny, nx = -(-H // ys), -(-W // xs)
    assert not (ny > 1 and zs > 1) and not (nx > 1 and (zs > 1 or ys > 1))
    items, starts, f = _tiles(coords, D, H, W)
    out = torch.empty((D, H, W, C))
    for z0 in range(0, D, zs):
        for y0 in range(0, H, ys):
            for x0 in range(0, W, xs):
                Z, Y, X = min(zs, D - z0), min(ys, H - y0), min(xs, W - x0)
                nb = (Z + 1) * (Y + 1) * (X + 1)
                assert nb <= gs.BWD_MAX_LOCAL_BUCKETS
                rows = ([(z0 * (H + 1), (z0 + Z) * (H + 1) + H)] if nx == ny == 1 else
                        [((z0 + q) * (H + 1) + y0, (z0 + q) * (H + 1) + y0 + Y) for q in (0, 1)])
                its = _box_items(items, starts, f, rows)

                def lbs_of(key):
                    """Each item's local bucket in the box, -1 outside it."""
                    local = torch.stack([key // ((H + 1) * (W + 1)), key // (W + 1) % (H + 1),
                                         key % (W + 1)], 1) - torch.tensor([z0, y0, x0])
                    ok = ((local >= 0) & (local <= torch.tensor([Z, Y, X]))).all(1)
                    return torch.where(ok, (local[:, 0] * (Y + 1) + local[:, 1]) * (X + 1)
                                       + local[:, 2], torch.full_like(key, -1))
                lbs = lbs_of(its[:, 1])
                # the corners through which a local bucket feeds a row of the box
                l = torch.arange(nb)
                lz, ly, lx = l // ((Y + 1) * (X + 1)), (l // (X + 1)) % (Y + 1), l % (X + 1)
                feeds = []
                for k in range(8):
                    zl, yl, xl = lz - 1 + (k >> 2), ly - 1 + ((k >> 1) & 1), lx - 1 + (k & 1)
                    feeds.append((zl >= 0) & (zl < Z) & (yl >= 0) & (yl < Y)
                                 & (xl >= 0) & (xl < X))
                origin = (z0, y0, x0, Z, Y, X)
                total = len(lbs)
                for c0 in range(0, C, cb):
                    cw = min(cb, C - c0)
                    corner_at_a_time = per_corner
                    if not corner_at_a_time:
                        kept, nxt = _fill(lbs, lambda b: torch.ones_like(b, dtype=torch.bool),
                                          0, cap)
                        corner_at_a_time = nxt < total
                    if not corner_at_a_time:
                        slot, begin = _place(lbs[kept], nb)
                        _box_pass(g, coords, its[kept, 0], slot, begin, origin, c0, cw, 0, 7,
                                  out, True, precision)
                        continue
                    for k in range(8):
                        # the items of the bucket rows corner k reads
                        dz, dy = k >> 2, (k >> 1) & 1
                        row0 = (z0 + 1 - dz) * (H + 1) + y0 + 1 - dy
                        row1 = (z0 + Z - dz) * (H + 1) + y0 + Y - dy
                        kits = _box_items(items, starts, f, [(row0, row1)])
                        klbs = lbs_of(kits[:, 1])
                        start = 0
                        while True:
                            kept, nxt = _fill(klbs, lambda b: feeds[k][b], start, cap)
                            slot, begin = _place(klbs[kept], nb)
                            _box_pass(g, coords, kits[kept, 0], slot, begin, origin, c0, cw,
                                      k, k, out, k == 0 and start == 0, precision)
                            start = nxt
                            if start >= len(klbs):
                                break
    return out


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
    """The wrapper allocates the scratch the kernel checks for: the tiles'
    (index, bucket) items, two ints a sample of a whole tile, and each
    tile's bins' first items, tiles x (bins + 1) ints, the bins depending
    on the grid's bucket rows; and the model's tiling and box limit are the
    kernel's."""
    with open(os.path.join(PORT, 'csrc', 'grid_sample_bwd.cu')) as f:
        src = f.read()
    assert f'constexpr int kMaxLocalBuckets = {gs.BWD_MAX_LOCAL_BUCKETS};' in src
    assert f'constexpr int kThreads = {THREADS};' in src
    assert f'constexpr int kTableInts = {TABLE_INTS};' in src
    for name, value in (('kTileThreads', gs.BWD_TILE_THREADS), ('kMinTile', gs.BWD_MIN_TILE),
                        ('kMaxTiles', gs.BWD_MAX_TILES), ('kMaxBins', gs.BWD_MAX_BINS)):
        assert f'constexpr int {name} = {value};' in src
    assert ('return 2 * int64_t(t.tiles) * t.T + int64_t(t.tiles) * (t.nb + 1);' in src)
    assert 'scratch_len < scratch_words(n, D, H)' in src
    assert re.search(r'return int64_t\(D \+ 1\) \* \(H \+ 1\) \* \(W \+ 1\);', src)
    # the trainer's 256 tiles of 128 into 16 x 16 bucket rows; grid 62's
    # 63 x 63 rows two to a bin; 2^20 samples, 1,024 tiles
    assert gs.bwd_tiling(32768, 15, 15) == (128, 256, 1, 256)
    assert gs.bwd_scratch_words(32768, 16, 15, 15, 15) == 2 * 32768 + 256 * 257
    assert gs.bwd_tiling(33, 62, 62) == (128, 1, 2, 1985)
    assert gs.bwd_tiling(1 << 20, 4, 4) == (1024, 1024, 1, 25)
    assert gs.bwd_tiling((1 << 20) + 1, 4, 4) == (1152, 911, 1, 25)


def test_fetch_backward_on_the_cpu_is_the_bucketed_order():
    """Autograd through fetch on CPU tensors: the plain version, so the
    card's kernel and the CPU give one gradient bit for bit."""
    g, coords = _inputs(16, (15, 15, 15), 2000, 21, -1.1, 1.1)
    for precision in ('f32', 'bf16'):
        grid = torch.zeros((15, 15, 15, 16), requires_grad=True)
        (gs.fetch(grid, coords, precision) * g).sum().backward()
        assert torch.equal(grid.grad, bucketed_backward(g, coords, 15, 15, 15, precision))


def _box_coords(kind, n, shape, seed):
    """(n, 3) coordinates: uniform over [-1.3, 1.3] (some outside the grid),
    all in one cell, or clustered in the 8 cells of a 2 x 2 x 2 block at
    the middle of the grid."""
    rng = np.random.default_rng(seed)
    if kind == 'one_cell':
        return torch.from_numpy((rng.uniform(0, 0.05, (n, 3)) + 0.31).astype(np.float32))
    if kind == 'clustered':
        sizes = np.array(shape[::-1], np.float64)
        pix = sizes // 2 - 1 + 2 * rng.uniform(0, 1, (n, 3))
        return torch.from_numpy(((2 * pix + 1) / sizes - 1).astype(np.float32))
    return torch.from_numpy(rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32))


# (coords, C, (D, H, W), n, box rows (z, y, x), channels a group, samples
# staged at once): all in one cell (a box overflows and takes the corners
# one at a time, in windows); grid 4 at 65,536 samples (thousands of adds
# an entry, windows in every corner); 8 clustered cells; the mesh's windowed
# (15, 15, 8) grid at a rank's 16,384; coordinates outside [-1, 1] on x
# boxes of an anisotropic grid with two channel groups; n = 0, 1 and 33;
# boxes of 4,020 and 4,096 buckets (a long y range, a long x range: the
# plan's boxes on large grids and long lines)
BOX_CASES = [('one_cell', 16, (8, 8, 8), 3000, (1, 4, 8), 16, 512),
             ('uniform', 16, (4, 4, 4), 65536, (4, 4, 4), 16, 4096),
             ('clustered', 16, (15, 15, 15), 8000, (1, 5, 15), 16, 1024),
             ('uniform', 16, (15, 15, 8), 16384, (1, 2, 8), 16, 2048),
             ('uniform', 22, (9, 10, 11), 3000, (1, 1, 4), 11, 256),
             ('uniform', 16, (15, 15, 15), 0, (1, 2, 15), 16, 2048),
             ('uniform', 16, (15, 15, 15), 1, (1, 2, 15), 16, 2048),
             ('uniform', 16, (15, 15, 15), 33, (1, 2, 15), 16, 2048),
             ('uniform', 8, (3, 40, 200), 3000, (1, 9, 200), 8, 512),
             ('uniform', 8, (2, 2, 1500), 3000, (1, 1, 1023), 8, 512)]


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('kind,C,shape,n,box,cb,cap', BOX_CASES)
def test_box_blocks_are_the_plain_version_bit_for_bit(kind, C, shape, n, box, cb, cap,
                                                      precision):
    """The kernel's blocks (box_backward: ordered compaction, the stable
    (bucket, warp) sort, a corner at a time where a box overflows) give
    the plain version's dG and the bucketed order's, bit for bit."""
    coords = _box_coords(kind, n, shape, n + C)
    g = torch.from_numpy(np.random.default_rng(C).standard_normal((n, C)).astype(np.float32))
    got = box_backward(g, coords, *shape, precision, box, cb, cap)
    want = _plain(precision)(g, coords, *shape)
    assert torch.equal(got, want)
    assert torch.equal(got, bucketed_backward(g, coords, *shape, precision))


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
def test_box_blocks_a_corner_at_a_time_from_the_start(precision):
    """A box the plan expects to overflow (grid 4 under a large batch) takes
    the corners one at a time from its first pass: the same dG."""
    g, coords = _inputs(8, (4, 4, 4), 6000, 5, -1.2, 1.2)
    got = box_backward(g, coords, 4, 4, 4, precision, (1, 2, 4), 8, 700, per_corner=True)
    assert torch.equal(got, _plain(precision)(g, coords, 4, 4, 4))


@pytest.mark.parametrize('nb,m', [(96, 768), (8, 2500), (4032, 600), (1, 40)])
def test_box_sort_is_stable_in_one_pass(nb, m):
    """_place's slots order the kept samples by bucket and, within a bucket,
    by their order in the kept list (the index order), whatever the number
    of warps the table leaves; each bucket's first slot is its count's
    prefix."""
    lb = torch.from_numpy(np.random.default_rng(nb + m).integers(0, nb, m))
    slot, begin = _place(lb, nb)
    assert sorted(slot.tolist()) == list(range(m))
    order = torch.empty(m, dtype=torch.int64)
    order[slot] = torch.arange(m)
    assert [(int(lb[j]), int(j)) for j in order] == sorted((int(b), j) for j, b in enumerate(lb))
    counts = torch.bincount(lb, minlength=nb)
    assert torch.equal(begin, torch.cat([torch.zeros(1, dtype=torch.int64),
                                         torch.cumsum(counts, 0)]))


def test_box_windows_take_every_sample_once_in_order():
    """_fill's windows of at most cap samples, each from where the last one
    stopped, take every passing sample once, in index order."""
    lbs = torch.from_numpy(np.random.default_rng(4).integers(-1, 6, 10000))
    take = lambda b: b % 2 == 0
    start, seen = 0, []
    while start < len(lbs):
        idx, start = _fill(lbs, take, start, 333)
        assert len(idx) <= 333
        seen += idx.tolist()
    want = torch.nonzero((lbs >= 0) & (lbs % 2 == 0)).flatten().tolist()
    assert seen == want
