"""The one-kernel model forward: trilinear fetch + ``[coords | fourier]`` +
the whole SnakeAlt MLP, its CUDA kernels' wrappers, their plain PyTorch
versions, and the differentiable entry :func:`fused_forward`.

The forward kernel (``csrc/fused_forward.cu``) is the port of the Pallas
``_fwd_kernel`` of the JAX package's ``ops/fused_forward.py`` (its
``interp_backend='fused'``), the backward kernel the port of its
``_bwd_kernel``.  Per sample: the 8-corner fetch from the channel-minor
(D, H, W, C) grid with the fetch kernel's own arithmetic (so the features
equal ``ops/grid_sample.py``'s), then x0 = [coords | sin/cos(2^k 2 pi
coords) | features], then the MLP of ``ops/mlp_fused.py``.  The backward
recomputes x0 and the chain, gives dW and db, and routes the feature columns
of dX into the grid's gradient through the same 8 corner weights.  There is
no coordinate gradient (the trainer never differentiates with respect to
positions; the JAX package stops it).

Precision: ``'mixed'`` (the fetch and the routing into dG in float32, the
MLP's products on bfloat16 operands, as ``ops/mlp_fused.py``'s ``'bf16'``;
what the JAX ``apply_model`` uses), ``'bf16'`` (the bf16 compute path: the
MLP as in 'mixed', the fetch and the routing as the 'bf16' fetch and
gradient of ``ops/grid_sample.py``, whose formulas the TPU kernel's single
bf16 passes give) or ``'f32'``.

:func:`fused_forward` is a ``torch.autograd.Function`` differentiable in the
grid and the MLP parameters: CPU tensors take the plain versions, CUDA
tensors the kernels or an error; nothing falls back.  ``launches`` and
``bwd_launches`` count the kernels' launches in 'mixed' and 'f32',
``bf16_launches`` and ``bf16_bwd_launches`` in 'bf16', and nothing else.
The grid's gradient is summed with atomics (not bitwise reproducible on the
card, as ``csrc/grid_sample_bwd.cu``); dW and db in a fixed order.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build
from .embedding import fourier_embed, fourier_out_dim
from .interpolation import (grid_sample_channel_minor,
                            grid_sample_channel_minor_backward,
                            grid_sample_channel_minor_backward_bf16,
                            grid_sample_channel_minor_bf16)
from .mlp_fused import (check_cuda, check_widths, grad_buffers, layer_pointers,
                        mlp_fused_plain, mlp_fused_plain_backward, on_cpu,
                        param_grads)

KERNEL = 'fused_forward'
PRECISIONS = ('mixed', 'f32', 'bf16')

# kernel launches since the last reset: forward and backward in 'mixed' and
# 'f32', and in 'bf16'
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int
# grid, coords, w[], b[], dims[], nw, out, n, C, D, H, W, n_freqs, bf16,
# interp_bf16, stream
FWD_ARGTYPES = [_P, _P, _PP, _PP, _PI, _I, _P, ctypes.c_int64, _I, _I, _I, _I, _I,
                _I, _I, _P]
# grid, coords, w[], b[], dims[], nw, g, dgrid, dparams, partial, n, C, D, H, W,
# n_freqs, bf16, interp_bf16, stream
BWD_ARGTYPES = [_P, _P, _PP, _PP, _PI, _I, _P, _P, _P, _P, ctypes.c_int64, _I, _I,
                _I, _I, _I, _I, _I, _P]
# n, dims[], nw, bf16
SLOTS_ARGTYPES = [ctypes.c_int64, _PI, _I, _I]


def _split(precision: str) -> Tuple[str, str]:
    """(the MLP's precision, the interpolation's), as the TPU kernel's
    ``_prec_split``: 'mixed' = ('bf16', 'f32')."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}; got {precision!r}")
    mlp = 'f32' if precision == 'f32' else 'bf16'
    return mlp, 'bf16' if precision == 'bf16' else 'f32'


def mlp_input(grid: torch.Tensor, coords: torch.Tensor, n_freqs: int,
              interp: str = 'f32') -> torch.Tensor:
    """x0 = [coords | fourier(coords) | features] -> (N, 3 + 6 n_freqs + C),
    the features fetched in the mode ``interp`` ('f32' or 'bf16')."""
    feats = (grid_sample_channel_minor_bf16 if interp == 'bf16'
             else grid_sample_channel_minor)(grid, coords)
    return torch.cat([coords, fourier_embed(coords, n_freqs), feats], dim=-1)


def fused_forward_plain(grid: torch.Tensor, coords: torch.Tensor,
                        weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                        n_freqs: int, precision: str = 'mixed') -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: channel-minor (D, H, W,
    C) grid, (N, 3) coords -> (N, d_out)."""
    mlp, interp = _split(precision)
    return mlp_fused_plain(weights, biases, mlp_input(grid, coords, n_freqs, interp), mlp)


def fused_forward_plain_backward(grid: torch.Tensor, coords: torch.Tensor,
                                 weights: Sequence[torch.Tensor],
                                 biases: Sequence[torch.Tensor], n_freqs: int,
                                 g: torch.Tensor, precision: str = 'mixed'
                                 ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                            List[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: for the (N, d_out)
    output gradient ``g``, (dgrid (D, H, W, C), [dW_i], [db_i])."""
    mlp, interp = _split(precision)
    dx, dws, dbs = mlp_fused_plain_backward(
        weights, biases, mlp_input(grid, coords, n_freqs, interp), g, mlp)
    D, H, W, _ = grid.shape
    emb = coords.shape[1] + fourier_out_dim(n_freqs, coords.shape[1])
    route = (grid_sample_channel_minor_backward_bf16 if interp == 'bf16'
             else grid_sample_channel_minor_backward)
    dgrid = route(dx[:, emb:].contiguous(), coords, D, H, W)
    return dgrid, dws, dbs


def _check(grid, coords, weights, biases, n_freqs, g=None) -> List[int]:
    if grid.dim() != 4 or coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"expected grid (D, H, W, C) and coords (N, 3); got "
                         f"{tuple(grid.shape)} and {tuple(coords.shape)}")
    C = grid.shape[3]
    dims = check_widths(weights, biases, 3 + fourier_out_dim(n_freqs, 3) + C)
    named = [('grid', grid), ('coords', coords)]
    if g is not None:
        if tuple(g.shape) != (coords.shape[0], dims[-1]):
            raise ValueError(f"expected g {(coords.shape[0], dims[-1])}; got "
                             f"{tuple(g.shape)}")
        named.append(('g', g))
    check_cuda(named + [(f'weights[{i}]', w) for i, w in enumerate(weights)]
                + [(f'biases[{i}]', b) for i, b in enumerate(biases)])
    return dims


def fused_forward_cuda(grid: torch.Tensor, coords: torch.Tensor,
                       weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                       n_freqs: int, precision: str = 'mixed') -> torch.Tensor:
    """Launch the forward kernel on contiguous float32 tensors on one card
    -> (N, d_out).  No autograd: :func:`fused_forward` is the
    differentiable entry."""
    global launches, bf16_launches
    mlp, interp = _split(precision)
    dims = _check(grid, coords, weights, biases, n_freqs)
    n = coords.shape[0]
    D, H, W, C = grid.shape
    out = torch.empty((n, dims[-1]), device=grid.device, dtype=torch.float32)
    if n == 0:
        return out
    lib, fn = _build.entry(KERNEL, 'lfgc_fused_forward_fwd', FWD_ARGTYPES)
    wp, bp, dp = layer_pointers(weights, biases, dims)
    with torch.cuda.device(grid.device):
        err = fn(grid.data_ptr(), coords.data_ptr(), wp, bp, dp, len(weights),
                 out.data_ptr(), n, C, D, H, W, n_freqs, int(mlp == 'bf16'),
                 int(interp == 'bf16'), torch.cuda.current_stream(grid.device).cuda_stream)
    _build.raise_on_error(lib, KERNEL, err)
    if precision == 'bf16':
        bf16_launches += 1
    else:
        launches += 1
    return out


def fused_forward_backward_cuda(grid: torch.Tensor, coords: torch.Tensor,
                                weights: Sequence[torch.Tensor],
                                biases: Sequence[torch.Tensor], n_freqs: int,
                                g: torch.Tensor, precision: str = 'mixed'):
    """Launch the backward kernel (and its fixed-order reduction of the
    per-block dW, db): (dgrid, [dW_i], [db_i]) for the output gradient
    ``g``; dgrid is zeroed here and summed by atomics."""
    global bwd_launches, bf16_bwd_launches
    mlp, interp = _split(precision)
    bf16 = mlp == 'bf16'
    dims = _check(grid, coords, weights, biases, n_freqs, g)
    n = coords.shape[0]
    D, H, W, C = grid.shape
    dgrid = torch.zeros_like(grid)
    wp, bp, dp = layer_pointers(weights, biases, dims)
    dparams, partial = grad_buffers(KERNEL, 'lfgc_fused_forward_bwd_slots', weights,
                                    biases, dp, n, grid.device, bf16)
    if n > 0:
        lib, fn = _build.entry(KERNEL, 'lfgc_fused_forward_bwd', BWD_ARGTYPES)
        with torch.cuda.device(grid.device):
            err = fn(grid.data_ptr(), coords.data_ptr(), wp, bp, dp, len(weights),
                     g.data_ptr(), dgrid.data_ptr(), dparams.data_ptr(),
                     partial.data_ptr(), n, C, D, H, W, n_freqs, int(bf16),
                     int(interp == 'bf16'), torch.cuda.current_stream(grid.device).cuda_stream)
        _build.raise_on_error(lib, KERNEL, err)
        if precision == 'bf16':
            bf16_bwd_launches += 1
        else:
            bwd_launches += 1
    dws, dbs = param_grads(dparams, weights, biases)
    return dgrid, dws, dbs


class _FusedForward(torch.autograd.Function):
    """The one-kernel forward, differentiable in the grid and the MLP
    parameters (not in the coordinates)."""

    @staticmethod
    def forward(ctx, grid, coords, n_freqs, precision, *params):
        nw = len(params) // 2
        ws, bs = params[:nw], params[nw:]
        ctx.save_for_backward(grid, coords, *params)
        ctx.n_freqs, ctx.precision = n_freqs, precision
        if on_cpu(grid, coords, *params):
            return fused_forward_plain(grid, coords, ws, bs, n_freqs, precision)
        return fused_forward_cuda(grid, coords, ws, bs, n_freqs, precision)

    @staticmethod
    def backward(ctx, g):
        grid, coords, *params = ctx.saved_tensors
        nw = len(params) // 2
        ws, bs = params[:nw], params[nw:]
        g = g.contiguous()
        args = (grid, coords, ws, bs, ctx.n_freqs, g, ctx.precision)
        if on_cpu(grid, coords, g, *params):
            dgrid, dws, dbs = fused_forward_plain_backward(*args)
        else:
            dgrid, dws, dbs = fused_forward_backward_cuda(*args)
        return (dgrid, None, None, None, *dws, *dbs)


def fused_forward(grid: torch.Tensor, coords: torch.Tensor,
                  weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                  n_freqs: int, precision: str = 'mixed') -> torch.Tensor:
    """One-kernel model forward from a channel-minor (D, H, W, C) grid at
    (N, 3) coords in [-1, 1] -> (N, d_out); every MLP width <= 128 (wider
    raises), in the precision 'mixed', 'bf16' or 'f32'.  Differentiable in
    the grid and the MLP parameters.  CPU tensors take the plain versions,
    CUDA tensors the kernels."""
    _split(precision)
    if grid.dim() != 4:
        raise ValueError(f"expected grid (D, H, W, C); got {tuple(grid.shape)}")
    check_widths(weights, biases, 3 + fourier_out_dim(n_freqs, 3) + grid.shape[3])
    return _FusedForward.apply(grid, coords, n_freqs, precision, *weights, *biases)
