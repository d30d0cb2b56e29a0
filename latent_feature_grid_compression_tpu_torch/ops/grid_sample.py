"""Trilinear feature-grid fetch: the CUDA kernels' wrappers and the
differentiable fetch.

The forward kernel (``csrc/grid_sample_fwd.cu``) is the port of both forward
Pallas kernels of the JAX package's ``ops/pallas_kernels.py``
(``_fwd_kernel`` and ``_fwd_kernel_blocked``); the gradient kernel
(``csrc/grid_sample_bwd.cu``) the port of both backward ones
(``_bwd_kernel`` and ``_bwd_kernel_blocked``).  Their plain versions are
``ops/interpolation.py::grid_sample_channel_minor`` and
``grid_sample_channel_minor_backward``.

Two modes, as the Pallas kernels' ``precision``: ``'f32'`` and ``'bf16'``
(the bf16 compute path: ``compute_dtype='bfloat16'`` or
``interp_backend='pallas_bf16'``), each its own C entries of the same
kernels.  Both take and give float32: the 'bf16' forward reads the float32
grid and rounds each value to bf16 as it loads it (where the TPU kernel
rounds the grid), so no bf16 copy is made, and the gradient rounds where
the TPU kernel rounds.  Their plain versions are
``grid_sample_channel_minor_bf16`` and its ``_backward_bf16``.

The gradient kernel is deterministic, as the TPU's sequential sums are: it
buckets the samples by cell and sums each entry of dG in one thread, in the
plain version's order, so on the card it equals the plain version run on
the CPU bit for bit, and two calls give the same dG.  It is two ordinary
launches on ``torch.empty`` buffers (dG, and an int32 scratch that holds
each tile of the sample order sorted by bucket row): nothing is zeroed
first.

:func:`fetch` is what the model, the trainer and the evaluation call: a
``torch.autograd.Function`` whose forward and backward take the plain
versions for CPU tensors and launch the kernels (or raise) for CUDA tensors.
Nothing falls back, and a mode never runs as the other.  The gradient
reaches the grid only: the trainer never differentiates with respect to the
sample positions (the JAX package stops their gradient), and it is float32
in both modes.  ``launches`` and ``bwd_launches`` count the fetch and
gradient kernels' launches in 'f32', ``bf16_launches`` and
``bf16_bwd_launches`` those in 'bf16' (and nothing else), so a run can show
which kernels its path went through.

:func:`fwd_plan` and :func:`bwd_plan` report how the kernels launch for a
shape on the current card: the forward's lanes (float4 or scalar), the
gradient's blocks, buckets and lanes a row, which the C code chooses from
the shape and the number of samples before the launch, in either mode.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .interpolation import (channel_minor, grid_sample_channel_minor,
                            grid_sample_channel_minor_backward,
                            grid_sample_channel_minor_backward_bf16,
                            grid_sample_channel_minor_bf16)

KERNEL = 'grid_sample_fwd'
BWD_KERNEL = 'grid_sample_bwd'
# the kernels in the 'bf16' mode, by the names of their counts
BF16_KERNEL = 'grid_sample_fwd_bf16'
BF16_BWD_KERNEL = 'grid_sample_bwd_bf16'
PRECISIONS = ('f32', 'bf16')

# kernel launches since the last reset: forward (grid_sample_channel_minor_cuda)
# and gradient (grid_sample_channel_minor_backward_cuda) in 'f32', and in
# 'bf16' (grid_sample_channel_minor_bf16_cuda, ..._backward_bf16_cuda)
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
# the forward's plan entries: n, C, D, H, W, vec4, out (7 ints)
PLAN_ARGTYPES = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
PLAN_FIELDS = ('route', 'threads', 'blocks_per_sm', 'blocks', 'samples_per_warp',
               'channels_per_lane', 'smem_bytes')
# the gradient kernel's entries: g, coords, dgrid, scratch, scratch ints, n,
# C, D, H, W, stream
BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
# its plan entry: n, C, D, H, W, bf16, out (7 ints)
BWD_PLAN_ARGTYPES = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
BWD_PLAN_FIELDS = ('threads', 'blocks', 'box_z', 'box_y', 'box_x', 'channel_groups',
                   'channels_per_block', 'box_buckets', 'capacity', 'expected_samples',
                   'per_corner', 'rows_per_warp', 'lanes_per_row', 'channels_per_lane',
                   'sort_warps', 'smem_bytes', 'buckets')
# most buckets a block of the gradient kernel reads (its kMaxLocalBuckets):
# a box of rows is at most this many lower corners
BWD_MAX_LOCAL_BUCKETS = 4096
# its tiles of the sample order (kTileThreads, kMinTile, kMaxTiles) and most
# bins of bucket rows (kMaxBins)
BWD_TILE_THREADS, BWD_MIN_TILE, BWD_MAX_TILES, BWD_MAX_BINS = 128, 128, 1024, 2048


def bwd_tiling(n: int, D: int, H: int):
    """The gradient kernel's tiles for n samples into a (D, H, W) grid
    (its tiling_of): samples a tile, tiles, bucket rows a bin, bins."""
    T = -(-n // BWD_MAX_TILES)
    T = max(BWD_MIN_TILE, -(-T // BWD_TILE_THREADS) * BWD_TILE_THREADS)
    rows = (D + 1) * (H + 1)
    f = -(-rows // BWD_MAX_BINS)
    return T, -(-n // T), f, -(-rows // f)


def bwd_scratch_words(n: int, C: int, D: int, H: int, W: int) -> int:
    """The int32 scratch the gradient kernel takes for n samples of C
    channels into a (D, H, W) grid: each tile's kept samples as (index,
    bucket) pairs, a whole tile each, and each tile's bins' first items."""
    T, tiles, _, nb = bwd_tiling(n, D, H)
    return 2 * tiles * T + tiles * (nb + 1)


def _launch(name: str, entry: str, a: torch.Tensor, coords: torch.Tensor,
            out: torch.Tensor, n: int, C: int, D: int, H: int, W: int,
            vec4: bool):
    lib, fn = _build.entry(name, entry, _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), coords.data_ptr(), out.data_ptr(), n, C, D, H, W,
                 int(vec4), stream)
    _build.raise_on_error(lib, name, err)


def _check(tensors, coords: torch.Tensor):
    """CUDA, float32, contiguous, on one card."""
    for name, t in list(tensors.items()) + [('coords', coords)]:
        if t.device.type != 'cuda':
            raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors.items():
        if t.device != coords.device:
            raise ValueError(f"{name} on {t.device}, coords on {coords.device}")


def _vec4(C: int, *tensors: torch.Tensor) -> bool:
    return C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}; got {precision!r}")


def _forward_cuda(grid: torch.Tensor, coords: torch.Tensor, precision: str
                  ) -> torch.Tensor:
    global launches, bf16_launches
    if grid.dim() != 4 or coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"expected grid (D, H, W, C) and coords (N, 3); got "
                         f"{tuple(grid.shape)} and {tuple(coords.shape)}")
    _check({'grid': grid}, coords)
    D, H, W, C = grid.shape
    n = coords.shape[0]
    out = torch.empty((n, C), device=grid.device, dtype=torch.float32)
    if n == 0:
        return out
    _launch(KERNEL, f'lfgc_grid_sample_fwd_{precision}', grid, coords, out, n, C,
            D, H, W, _vec4(C, grid, out))
    if precision == 'bf16':
        bf16_launches += 1
    else:
        launches += 1
    return out


def grid_sample_channel_minor_cuda(grid: torch.Tensor, coords: torch.Tensor
                                   ) -> torch.Tensor:
    """Launch the forward kernel on a channel-minor (D, H, W, C) float32 grid
    and (N, 3) coordinates, both contiguous on one card -> (N, C).  No
    autograd: :func:`fetch` is the differentiable entry."""
    return _forward_cuda(grid, coords, 'f32')


def grid_sample_channel_minor_bf16_cuda(grid: torch.Tensor, coords: torch.Tensor
                                        ) -> torch.Tensor:
    """Launch the forward kernel in 'bf16' on a channel-minor (D, H, W, C)
    float32 grid (rounded to bf16 in the kernel) and float32 (N, 3)
    coordinates, both contiguous on one card -> float32 (N, C).  No
    autograd: :func:`fetch` is the differentiable entry."""
    return _forward_cuda(grid, coords, 'bf16')


def _check_grad_args(g: torch.Tensor, coords: torch.Tensor):
    if g.dim() != 2 or coords.dim() != 2 or coords.shape != (g.shape[0], 3):
        raise ValueError(f"expected g (N, C) and coords (N, 3); got "
                         f"{tuple(g.shape)} and {tuple(coords.shape)}")
    _check({'g': g}, coords)


def _backward_cuda(g: torch.Tensor, coords: torch.Tensor, D: int, H: int, W: int,
                   precision: str) -> torch.Tensor:
    global bwd_launches, bf16_bwd_launches
    _check_grad_args(g, coords)
    n, C = g.shape
    if n == 0 or C == 0:
        return torch.zeros((D, H, W, C), device=g.device, dtype=torch.float32)
    dgrid = torch.empty((D, H, W, C), device=g.device, dtype=torch.float32)
    scratch = torch.empty(bwd_scratch_words(n, C, D, H, W), device=g.device,
                          dtype=torch.int32)
    lib, fn = _build.entry(BWD_KERNEL, f'lfgc_grid_sample_bwd_{precision}', BWD_ARGTYPES)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), coords.data_ptr(), dgrid.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), n, C, D, H, W, stream)
    _build.raise_on_error(lib, BWD_KERNEL, err)
    if precision == 'bf16':
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return dgrid


def grid_sample_channel_minor_backward_cuda(g: torch.Tensor, coords: torch.Tensor,
                                            D: int, H: int, W: int
                                            ) -> torch.Tensor:
    """Launch the gradient kernel: the (N, C) output gradient ``g`` at (N, 3)
    coordinates, both contiguous float32 on one card -> the gradient of the
    channel-minor (D, H, W, C) grid, each entry summed in the plain
    version's order (bit for bit the plain version on the CPU)."""
    return _backward_cuda(g, coords, D, H, W, 'f32')


def grid_sample_channel_minor_backward_bf16_cuda(g: torch.Tensor, coords: torch.Tensor,
                                                 D: int, H: int, W: int
                                                 ) -> torch.Tensor:
    """Launch the gradient kernel in 'bf16': as
    :func:`grid_sample_channel_minor_backward_cuda` (float32 in and out),
    each term rounded where the TPU kernel's 'bf16' backward rounds."""
    return _backward_cuda(g, coords, D, H, W, 'bf16')


def fwd_plan(n: int, C: int, D: int, H: int, W: int, vec4: bool = True,
             precision: str = 'f32') -> dict:
    """How the forward kernel of the mode ``precision`` launches for n
    samples from a (D, H, W, C) grid on the current card: route 'float4'
    (float4 loads; ``vec4``, which the wrapper takes where C % 4 == 0 and
    the pointers are aligned) or 'scalar' (guarded scalar loads), in either
    mode; threads a block, blocks an SM, blocks, samples a warp step,
    channels a lane, shared bytes a block (0), and the mode."""
    _check_precision(precision)
    entry = ('lfgc_grid_sample_fwd_bf16_plan' if precision == 'bf16'
             else 'lfgc_grid_sample_fwd_plan')
    lib, fn = _build.entry(KERNEL, entry, PLAN_ARGTYPES)
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    _build.raise_on_error(lib, KERNEL, fn(n, C, D, H, W, int(vec4), out))
    plan = dict(zip(PLAN_FIELDS, out))
    plan['route'] = ('scalar', 'float4')[plan['route']]
    plan['mode'] = precision
    return plan


def bwd_plan(n: int, C: int, D: int, H: int, W: int, precision: str = 'f32') -> dict:
    """How the gradient kernel of the mode ``precision`` launches for n
    samples into a (D, H, W, C) gradient on the current card (its second
    launch, the box kernel; the first sorts tiles of the sample order):
    threads a block, blocks,
    rows of a box along z, y and x, channel groups, channels a block,
    buckets a box reads, samples a block stages at once, samples a box
    holds on uniform positions, whether it takes the corners one at a time
    (1) or every corner in one pass (0), rows of dG a warp sums at once,
    lanes a row, channels a lane, warps that sort, shared bytes a block,
    buckets of the grid, and the mode."""
    _check_precision(precision)
    lib, fn = _build.entry(BWD_KERNEL, 'lfgc_grid_sample_bwd_plan', BWD_PLAN_ARGTYPES)
    out = (ctypes.c_int * len(BWD_PLAN_FIELDS))()
    _build.raise_on_error(lib, BWD_KERNEL, fn(n, C, D, H, W, int(precision == 'bf16'), out))
    return {**dict(zip(BWD_PLAN_FIELDS, out)), 'mode': precision}


class _Fetch(torch.autograd.Function):
    """Trilinear fetch from a channel-minor float32 grid, differentiable in
    the grid (a float32 gradient in both modes)."""

    @staticmethod
    def forward(ctx, grid, coords, precision):
        ctx.save_for_backward(coords)
        ctx.grid_shape = tuple(grid.shape[:3])
        ctx.precision = precision
        cpu = grid.device.type == 'cpu' and coords.device.type == 'cpu'
        if precision == 'f32':
            if cpu:
                return grid_sample_channel_minor(grid, coords)
            return grid_sample_channel_minor_cuda(grid, coords)
        if cpu:
            return grid_sample_channel_minor_bf16(grid, coords)
        return grid_sample_channel_minor_bf16_cuda(grid, coords)

    @staticmethod
    def backward(ctx, g):
        coords, = ctx.saved_tensors
        D, H, W = ctx.grid_shape
        g = g.contiguous()
        cpu = g.device.type == 'cpu' and coords.device.type == 'cpu'
        if ctx.precision == 'f32':
            backward = (grid_sample_channel_minor_backward if cpu
                        else grid_sample_channel_minor_backward_cuda)
        else:
            backward = (grid_sample_channel_minor_backward_bf16 if cpu
                        else grid_sample_channel_minor_backward_bf16_cuda)
        return backward(g, coords, D, H, W), None, None


def fetch(grid: torch.Tensor, coords: torch.Tensor, precision: str = 'f32'
          ) -> torch.Tensor:
    """Trilinear fetch from a channel-minor (D, H, W, C) float32 grid at
    (N, 3) coordinates -> float32 (N, C), in the mode ``precision`` ('f32'
    or 'bf16'); differentiable in the grid.  CPU tensors take the plain
    versions, CUDA tensors the kernels of that mode."""
    _check_precision(precision)
    return _Fetch.apply(grid, coords, precision)


def grid_sample_3d_cuda(features: torch.Tensor, coords: torch.Tensor
                        ) -> torch.Tensor:
    """(C, D, H, W) features, (N, 3) coords on the card -> (N, C) through the
    kernels; differentiable in the features."""
    if features.dim() != 4:
        raise ValueError(f"expected features (C, D, H, W); got "
                         f"{tuple(features.shape)}")
    if features.device.type != 'cuda':
        raise ValueError(f"features must be a CUDA tensor; got {features.device}")
    return fetch(channel_minor(features), coords)
