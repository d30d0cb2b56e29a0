"""Trilinear feature-grid fetch: the CUDA kernels' wrappers and the
differentiable fetch.

The forward kernel (``csrc/grid_sample_fwd.cu``) is the port of both forward
Pallas kernels of the JAX package's ``ops/pallas_kernels.py``
(``_fwd_kernel`` and ``_fwd_kernel_blocked``); the backward kernel
(``csrc/grid_sample_bwd.cu``) the port of both backward ones (``_bwd_kernel``
and ``_bwd_kernel_blocked``).  Their plain versions are
``ops/interpolation.py::grid_sample_channel_minor`` and
``grid_sample_channel_minor_backward``.

:func:`fetch` is what the model, the trainer and the evaluation call: a
``torch.autograd.Function`` whose forward and backward take the plain
versions for CPU tensors and launch the kernels (or raise) for CUDA tensors.
Nothing falls back.  The gradient reaches the grid only: the trainer never
differentiates with respect to the sample positions (the JAX package stops
their gradient).  ``launches`` and ``bwd_launches`` count kernel launches
(and nothing else), so a run can show that its path went through the
kernels.  The backward kernel adds with atomics, so on the card its result
is not bitwise reproducible from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .interpolation import (channel_minor, grid_sample_channel_minor,
                            grid_sample_channel_minor_backward)

KERNEL = 'grid_sample_fwd'
BWD_KERNEL = 'grid_sample_bwd'

# kernel launches since the last reset: forward (grid_sample_channel_minor_cuda)
# and backward (grid_sample_channel_minor_backward_cuda)
launches = 0
bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


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


def grid_sample_channel_minor_cuda(grid: torch.Tensor, coords: torch.Tensor
                                   ) -> torch.Tensor:
    """Launch the forward kernel on a channel-minor (D, H, W, C) float32 grid
    and (N, 3) coordinates, both contiguous on one card -> (N, C).  No
    autograd: :func:`fetch` is the differentiable entry."""
    global launches
    if grid.dim() != 4 or coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"expected grid (D, H, W, C) and coords (N, 3); got "
                         f"{tuple(grid.shape)} and {tuple(coords.shape)}")
    _check({'grid': grid}, coords)
    D, H, W, C = grid.shape
    n = coords.shape[0]
    out = torch.empty((n, C), device=grid.device, dtype=torch.float32)
    if n == 0:
        return out
    _launch(KERNEL, 'lfgc_grid_sample_fwd_f32', grid, coords, out, n, C, D, H, W,
            _vec4(C, grid, out))
    launches += 1
    return out


def grid_sample_channel_minor_backward_cuda(g: torch.Tensor, coords: torch.Tensor,
                                            D: int, H: int, W: int
                                            ) -> torch.Tensor:
    """Launch the backward kernel: the (N, C) output gradient ``g`` at (N, 3)
    coordinates, both contiguous float32 on one card -> the gradient of the
    channel-minor (D, H, W, C) grid, zeroed here and summed by atomics."""
    global bwd_launches
    if g.dim() != 2 or coords.dim() != 2 or coords.shape != (g.shape[0], 3):
        raise ValueError(f"expected g (N, C) and coords (N, 3); got "
                         f"{tuple(g.shape)} and {tuple(coords.shape)}")
    _check({'g': g}, coords)
    n, C = g.shape
    dgrid = torch.zeros((D, H, W, C), device=g.device, dtype=torch.float32)
    if n == 0 or C == 0:
        return dgrid
    _launch(BWD_KERNEL, 'lfgc_grid_sample_bwd_f32', g, coords, dgrid, n, C, D, H, W,
            _vec4(C, g, dgrid))
    bwd_launches += 1
    return dgrid


class _Fetch(torch.autograd.Function):
    """Trilinear fetch from a channel-minor grid, differentiable in the grid."""

    @staticmethod
    def forward(ctx, grid, coords):
        ctx.save_for_backward(coords)
        ctx.grid_shape = tuple(grid.shape[:3])
        if grid.device.type == 'cpu' and coords.device.type == 'cpu':
            return grid_sample_channel_minor(grid, coords)
        return grid_sample_channel_minor_cuda(grid, coords)

    @staticmethod
    def backward(ctx, g):
        coords, = ctx.saved_tensors
        D, H, W = ctx.grid_shape
        g = g.contiguous()
        if g.device.type == 'cpu' and coords.device.type == 'cpu':
            return grid_sample_channel_minor_backward(g, coords, D, H, W), None
        return grid_sample_channel_minor_backward_cuda(g, coords, D, H, W), None


def fetch(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear fetch from a channel-minor (D, H, W, C) grid at (N, 3)
    coordinates -> (N, C); differentiable in the grid.  CPU tensors take the
    plain versions, CUDA tensors the kernels."""
    return _Fetch.apply(grid, coords)


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
