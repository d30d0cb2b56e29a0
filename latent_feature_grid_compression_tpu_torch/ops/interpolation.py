"""Trilinear interpolation, plain PyTorch versions.

Port of the JAX package's ``ops/interpolation.py``:

1. :func:`grid_sample_3d` — the feature-grid fetch, with the semantics of
   ``torch.nn.functional.grid_sample(mode='bilinear', align_corners=False,
   padding_mode='zeros')`` on a (C, D, H, W) grid, written as an 8-corner row
   gather over the channel-minor (D*H*W, C) layout.  Coordinate 0 indexes W
   (the last axis), 1 indexes H, 2 indexes D.  Its gradient with respect to
   the grid, :func:`grid_sample_channel_minor_backward`, scatters the same 8
   weighted rows back with ``index_add_``.
2. :func:`trilinear_interpolate` — the ground-truth volume fetch on raw index
   coordinates (floor/ceil corners with a degenerate-cell guard, so integer
   points return the voxel value), and its exact fast path for integer
   lattice points, :func:`gather_volume` / :func:`gather_rows`.

The fetch and its gradient are the plain versions of the CUDA kernels in
``csrc/grid_sample_fwd.cu`` and ``csrc/grid_sample_bwd.cu``: the CPU path
runs them, and ``chip_smoke.py`` holds the kernels against them on the card.
They repeat the kernels' arithmetic step for step (same pixel map, same
weight products), so the two differ only in summation rounding.

:func:`grid_sample_channel_minor_bf16` and its gradient
:func:`grid_sample_channel_minor_backward_bf16` are the plain versions of
the kernels' 'bf16' mode (the bf16 compute path), which rounds where the
JAX package's Pallas kernels round with ``precision='bf16'`` (one bf16 MXU
pass a product, ``ops/pallas_kernels.py`` ``_dot``): with wxy = wx * wy,

    out[n, c] = sum_z bf16(wz * sum_xy bf16(wxy) * bf16(G[z, y, x, c]))
    dG[z, y, x, c] += bf16(wxy) * bf16(wz * bf16(g[n, c]))

the xy sums and the sum over the two z planes in float32.  The forward sums
in the kernel's order, and each product of two bf16 values is exact, so the
forward kernel matches it bit for bit.
"""

from __future__ import annotations

import torch


def channel_minor(features: torch.Tensor) -> torch.Tensor:
    """(C, D, H, W) -> contiguous (D, H, W, C): each corner is one C-float row."""
    return features.permute(1, 2, 3, 0).contiguous()


def _planes(coords: torch.Tensor, D: int, H: int, W: int):
    """The corners of each of (N, 3) points, z plane by z plane (lower
    first): per plane, the (N,) z weight wz (zero where the plane is out of
    range) and its 4 corners in the order y, x, each the (N,) flat row index
    into the (D*H*W, C) grid (clamped into range) and the (N,) xy weight
    wxy = wx * wy (zero for an out-of-range corner)."""
    sizes = torch.tensor([W, H, D], dtype=coords.dtype, device=coords.device)
    # align_corners=False: pix = ((coord + 1) * size - 1) / 2
    pix = ((coords + 1.0) * sizes - 1.0) * 0.5
    lo = torch.floor(pix)
    frac = pix - lo
    lo = lo.to(torch.int64)
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    for dz in (0, 1):
        iz = lo[:, 2] + dz
        wz = (fz if dz else 1.0 - fz) * ((iz >= 0) & (iz < D))
        corners = []
        for dy in (0, 1):
            for dx in (0, 1):
                ix = lo[:, 0] + dx
                iy = lo[:, 1] + dy
                valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
                row = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
                       + ix.clamp(0, W - 1))
                wxy = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
                corners.append((row, wxy * valid))
        yield wz, corners


def _corners(coords: torch.Tensor, D: int, H: int, W: int):
    """The 8 corners of each of (N, 3) points, in the order z, y, x: per
    corner, the (N,) flat row index into the (D*H*W, C) grid (clamped into
    range) and the (N,) trilinear weight (wx * wy) * wz (zero for an
    out-of-range corner)."""
    for wz, corners in _planes(coords, D, H, W):
        for row, wxy in corners:
            yield row, wxy * wz


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def grid_sample_channel_minor(grid: torch.Tensor, coords: torch.Tensor
                              ) -> torch.Tensor:
    """Sample a channel-minor (D, H, W, C) grid at (N, 3) points -> (N, C).

    Out-of-range corners contribute zero."""
    D, H, W, C = grid.shape
    flat = grid.reshape(D * H * W, C)
    out = None
    for row, w in _corners(coords, D, H, W):
        term = flat[row] * w[:, None]
        out = term if out is None else out + term
    return out


def grid_sample_channel_minor_backward(g: torch.Tensor, coords: torch.Tensor,
                                       D: int, H: int, W: int) -> torch.Tensor:
    """Gradient of :func:`grid_sample_channel_minor` with respect to the
    grid, for the (N, C) output gradient ``g`` -> (D, H, W, C)."""
    C = g.shape[1]
    dflat = torch.zeros((D * H * W, C), dtype=g.dtype, device=g.device)
    for row, w in _corners(coords, D, H, W):
        dflat.index_add_(0, row, g * w[:, None])
    return dflat.view(D, H, W, C)


def grid_sample_channel_minor_bf16(grid: torch.Tensor, coords: torch.Tensor
                                   ) -> torch.Tensor:
    """The 'bf16' fetch from a channel-minor (D, H, W, C) grid (float32 or
    its bf16 copy) at (N, 3) points -> float32 (N, C)."""
    D, H, W, C = grid.shape
    flat = bf16_round(grid.reshape(D * H * W, C))
    out = None
    for wz, corners in _planes(coords, D, H, W):
        plane = None
        for row, wxy in corners:
            term = flat[row] * bf16_round(wxy)[:, None]
            plane = term if plane is None else plane + term
        term = bf16_round(wz[:, None] * plane)
        out = term if out is None else out + term
    return out


def grid_sample_channel_minor_backward_bf16(g: torch.Tensor, coords: torch.Tensor,
                                            D: int, H: int, W: int,
                                            accumulate: torch.dtype = torch.float32
                                            ) -> torch.Tensor:
    """Gradient of :func:`grid_sample_channel_minor_bf16` with respect to
    the grid as the TPU kernel's 'bf16' backward computes it, for the
    float32 (N, C) output gradient ``g`` -> (D, H, W, C) in ``accumulate``.

    Each term is float32 as the kernels compute it; ``accumulate`` is the
    type of the sums: float32 (the plain version), or float64, the sum of
    the same terms almost exactly, which the card's checks hold the kernel
    against (float32 sums of the 4,096 terms an entry of a grid-4 gradient
    takes differ by ~1e-6 of max |dG| from one order to another)."""
    C = g.shape[1]
    g16 = bf16_round(g)
    dflat = torch.zeros((D * H * W, C), dtype=accumulate, device=g.device)
    for wz, corners in _planes(coords, D, H, W):
        gz = bf16_round(wz[:, None] * g16)
        for row, wxy in corners:
            dflat.index_add_(0, row, (gz * bf16_round(wxy)[:, None]).to(accumulate))
    return dflat.view(D, H, W, C)


def grid_sample_3d(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample a (C, D, H, W) grid at (N, 3) points in [-1, 1] -> (N, C)."""
    return grid_sample_channel_minor(channel_minor(features), coords)


def trilinear_interpolate(volume: torch.Tensor, points: torch.Tensor,
                          min_bb: torch.Tensor, max_bb: torch.Tensor,
                          res: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of an (X, Y, Z) scalar volume at (N, 3) raw
    coordinates in the [min_bb, max_bb] box of resolution ``res`` (each
    (3,)).  Corners come from floor and ceil with a 1e-12 degenerate-cell
    guard, so an integer point returns its voxel's value exactly."""
    normalized = ((points - min_bb[None]) / (max_bb - min_bb)[None]
                  * (res[None] - 1.0))
    lo = torch.floor(normalized)
    hi = torch.ceil(normalized)
    diff = torch.clamp(hi - lo, min=1e-12)
    alpha = ((normalized - lo) / diff).to(volume.dtype)
    one_alpha = 1.0 - alpha
    x0, y0, z0 = lo.to(torch.int64).unbind(1)
    x1, y1, z1 = hi.to(torch.int64).unbind(1)
    ax, ay, az = alpha.unbind(1)
    bx, by, bz = one_alpha.unbind(1)

    x_y0z0 = bx * volume[x0, y0, z0] + ax * volume[x1, y0, z0]
    x_y1z0 = bx * volume[x0, y1, z0] + ax * volume[x1, y1, z0]
    x_y0z1 = bx * volume[x0, y0, z1] + ax * volume[x1, y0, z1]
    x_y1z1 = bx * volume[x0, y1, z1] + ax * volume[x1, y1, z1]
    y_z0 = by * x_y0z0 + ay * x_y1z0
    y_z1 = by * x_y0z1 + ay * x_y1z1
    return bz * y_z0 + az * y_z1


def gather_rows(vol2d: torch.Tensor, y_size: int,
                int_points: torch.Tensor) -> torch.Tensor:
    """Exact voxel fetch from an (X*Y, Z) volume at (N, 3) integer points:
    row x*Y + y, column z."""
    x, y, z = int_points.to(torch.int64).unbind(1)
    return vol2d[x * y_size + y, z]


def gather_volume(volume: torch.Tensor, int_points: torch.Tensor) -> torch.Tensor:
    """Exact voxel fetch of an (X, Y, Z) volume at (N, 3) integer lattice
    points: what :func:`trilinear_interpolate` returns there (the trainer's
    positions are integer, so its ground truth is a gather)."""
    X, Y, Z = volume.shape
    return gather_rows(volume.reshape(X * Y, Z), Y, int_points)
