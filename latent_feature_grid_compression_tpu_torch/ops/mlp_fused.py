"""The fused SnakeAlt MLP: the CUDA kernels' wrappers, their plain PyTorch
versions, and the differentiable entry :func:`mlp_fused`.

The forward kernel (``csrc/mlp_fused.cu``) is the port of the Pallas
``_fwd_kernel`` of the JAX package's ``ops/mlp_pallas.py`` (its
``mlp_backend='pallas'``), the backward kernel the port of its
``_bwd_kernel``: the hidden layers ``h = SnakeAlt(h W^T + b)`` with
SnakeAlt(z) = 0.5 z + sin(z)^2, then a linear head, every width <= 128.  The
backward recomputes the chain, then gives dX, dW and db.

Precision, as the TPU kernel's: ``'bf16'`` rounds both operands of every
matrix product to bfloat16 and sums in float32 (one MXU pass; what the JAX
``apply_model`` uses), ``'f32'`` multiplies in float32.  The bias, the
activation, its derivative ``dz = dh * (0.5 + sin 2z)`` and the bias
gradients stay float32 in both.  The plain versions round at exactly the
kernels' places; they are written out (the backward too), because autograd
of a rounded forward would not round ``dz``.

Weights keep the port's (out, in) layout.  :func:`mlp_fused` is a
``torch.autograd.Function`` whose forward and backward take the plain
versions for CPU tensors and launch the kernels (or raise) for CUDA tensors;
nothing falls back.  ``launches`` and ``bwd_launches`` count kernel launches
and nothing else.  The kernels' dW and db are reduced in a fixed order
(bitwise reproducible on one card).  The ``'bf16'`` kernels multiply on the
tensor cores (``csrc/snake_mlp_tc.cuh``), the ``'f32'`` ones on the CUDA
cores.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build
from .mlp import snake_alt

KERNEL = 'mlp_fused'
MAX_WIDTH = 128     # every layer width, as mlp_apply_pallas (one 128-lane tile)
MAX_LAYERS = 16     # weight matrices; csrc/snake_mlp.cuh kMaxLayers
PRECISIONS = ('bf16', 'f32')

# kernel launches since the last reset: forward and backward
launches = 0
bwd_launches = 0

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
# x, w[], b[], dims[], nw, out, n, bf16, stream
FWD_ARGTYPES = [_P, _PP, _PP, _PI, ctypes.c_int, _P, ctypes.c_int64, ctypes.c_int, _P]
# x, w[], b[], dims[], nw, g, dx, dparams, partial, n, bf16, stream
BWD_ARGTYPES = [_P, _PP, _PP, _PI, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64,
                ctypes.c_int, _P]
# n, dims[], nw, bf16
SLOTS_ARGTYPES = [ctypes.c_int64, _PI, ctypes.c_int, ctypes.c_int]
# dims[], nw, bf16, out[4]
PLAN_ARGTYPES = [_PI, ctypes.c_int, ctypes.c_int, _PI]


def _op(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A matrix product's operand as the kernels take it."""
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


def _is_bf16(precision: str) -> bool:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}; got {precision!r}")
    return precision == 'bf16'


def check_widths(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 d_in: int) -> List[int]:
    """The layer widths [d_in, h_1, ..., d_out] of (out, in) weights and
    their biases; raises where they do not chain or a width exceeds
    ``MAX_WIDTH``."""
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"expected 1..{MAX_LAYERS} weights and as many biases; "
                         f"got {len(weights)} and {len(biases)}")
    dims = [d_in]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[1] != dims[-1] or tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} and bias "
                             f"{tuple(b.shape)} do not take width {dims[-1]}")
        dims.append(int(w.shape[0]))
    if max(dims) > MAX_WIDTH or min(dims) < 1:
        raise ValueError(f"the fused MLP takes widths 1..{MAX_WIDTH}; got {dims}")
    return dims


def mlp_fused_plain(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                    x: torch.Tensor, precision: str = 'bf16') -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (N, d_in) -> (N, d_out)."""
    bf16 = _is_bf16(precision)
    h = x
    for w, b in zip(weights[:-1], biases[:-1]):
        h = snake_alt(_op(h, bf16) @ _op(w, bf16).t() + b)
    return _op(h, bf16) @ _op(weights[-1], bf16).t() + biases[-1]


def mlp_fused_plain_backward(weights: Sequence[torch.Tensor],
                             biases: Sequence[torch.Tensor], x: torch.Tensor,
                             g: torch.Tensor, precision: str = 'bf16'
                             ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                        List[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: for the (N, d_out)
    output gradient ``g``, (dX, [dW_i (out, in)], [db_i])."""
    bf16 = _is_bf16(precision)
    hs, sgs = [_op(x, bf16)], []
    for w, b in zip(weights[:-1], biases[:-1]):
        z = hs[-1] @ _op(w, bf16).t() + b
        sgs.append(0.5 + torch.sin(2.0 * z))
        hs.append(_op(snake_alt(z), bf16))
    nw = len(weights)
    dws: List[torch.Tensor] = [None] * nw
    dbs: List[torch.Tensor] = [None] * nw
    dz = g
    for i in reversed(range(nw)):
        dz_op = _op(dz, bf16)
        dws[i] = dz_op.t() @ hs[i]
        dbs[i] = dz.sum(0)
        dh = dz_op @ _op(weights[i], bf16)
        if i:
            dz = dh * sgs[i - 1]
    return dh, dws, dbs


def check_cuda(named: Sequence[Tuple[str, torch.Tensor]]):
    dev = named[0][1].device
    for name, t in named:
        if t.device.type != 'cuda':
            raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, {named[0][0]} on {dev}")


def layer_pointers(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                   dims: Sequence[int]):
    """The per-layer device pointers and widths as the C entries take them
    (the launcher copies them into the kernel's by-value parameters)."""
    nw = len(weights)
    return ((ctypes.c_void_p * nw)(*[w.data_ptr() for w in weights]),
            (ctypes.c_void_p * nw)(*[b.data_ptr() for b in biases]),
            (ctypes.c_int * (nw + 1))(*dims))


def grad_buffers(kernel: str, slots_symbol: str, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor], dims_arr, n: int,
                 device: torch.device, bf16: bool):
    """A backward kernel's flat [dW_0 .. dW_L, db_0 .. db_L] output and its
    per-block partial slots (None without samples: the output is zeros).
    The kernel says how many blocks it launches for n samples at these
    widths and precision on this card."""
    total = sum(w.numel() + b.numel() for w, b in zip(weights, biases))
    if n == 0:
        return torch.zeros(total, device=device, dtype=torch.float32), None
    _, slots_fn = _build.entry(kernel, slots_symbol, SLOTS_ARGTYPES)
    with torch.cuda.device(device):
        slots = slots_fn(n, dims_arr, len(weights), int(bf16))
    if slots <= 0:
        raise RuntimeError(f"{kernel}: no tile size fits widths {list(dims_arr)}")
    return (torch.empty(total, device=device, dtype=torch.float32),
            torch.empty((slots, total), device=device, dtype=torch.float32))


def _launch_plan(kernel: str, direction: str, dims: Sequence[int], precision: str) -> dict:
    """How the forward (``direction='fwd'``) or backward (``'bwd'``) kernel
    of ``csrc/<kernel>.cu`` launches at these widths and precision ('bf16',
    or for the one-kernel forward 'mixed' and 'bf16', whose MLP halves are
    alike) on this card: samples a tile,
    dynamic shared memory a block, blocks an SM, and whether all the weights
    (backward: and the dW/db sums) stay in shared memory.  Raises where the
    widths do not fit."""
    lib, fn = _build.entry(kernel, f'lfgc_{kernel}_{direction}_plan', PLAN_ARGTYPES)
    out = (ctypes.c_int * 4)()
    err = fn((ctypes.c_int * len(dims))(*dims), len(dims) - 1,
             int(precision in ('bf16', 'mixed')), out)
    _build.raise_on_error(lib, kernel, err)
    return dict(zip(('tile', 'smem_bytes', 'blocks_per_sm', 'resident'), out))


def fwd_plan(kernel: str, dims: Sequence[int], precision: str) -> dict:
    """:func:`_launch_plan` of the forward kernel."""
    return _launch_plan(kernel, 'fwd', dims, precision)


def bwd_plan(kernel: str, dims: Sequence[int], precision: str) -> dict:
    """:func:`_launch_plan` of the backward kernel."""
    return _launch_plan(kernel, 'bwd', dims, precision)


def param_grads(flat: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor]):
    """Split the kernels' flat [dW_0 .. dW_L, db_0 .. db_L] into tensors
    shaped like the weights and biases."""
    ts = list(weights) + list(biases)
    parts = torch.split(flat, [t.numel() for t in ts])
    grads = [p.view(t.shape) for p, t in zip(parts, ts)]
    return grads[:len(weights)], grads[len(weights):]


def mlp_fused_cuda(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                   x: torch.Tensor, precision: str = 'bf16') -> torch.Tensor:
    """Launch the forward kernel on contiguous float32 tensors on one card:
    (N, d_in) -> (N, d_out).  No autograd: :func:`mlp_fused` is the
    differentiable entry."""
    global launches
    bf16 = _is_bf16(precision)
    if x.dim() != 2:
        raise ValueError(f"expected x (N, d_in); got {tuple(x.shape)}")
    dims = check_widths(weights, biases, x.shape[1])
    check_cuda([('x', x)] + [(f'weights[{i}]', w) for i, w in enumerate(weights)]
                + [(f'biases[{i}]', b) for i, b in enumerate(biases)])
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), device=x.device, dtype=torch.float32)
    if n == 0:
        return out
    lib, fn = _build.entry(KERNEL, 'lfgc_mlp_fused_fwd', FWD_ARGTYPES)
    wp, bp, dp = layer_pointers(weights, biases, dims)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wp, bp, dp, len(weights), out.data_ptr(), n,
                 int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_error(lib, KERNEL, err)
    launches += 1
    return out


def mlp_fused_backward_cuda(weights: Sequence[torch.Tensor],
                            biases: Sequence[torch.Tensor], x: torch.Tensor,
                            g: torch.Tensor, precision: str = 'bf16'):
    """Launch the backward kernel (and its fixed-order reduction of the
    per-block dW, db): (dX, [dW_i], [db_i]) for the output gradient ``g``."""
    global bwd_launches
    bf16 = _is_bf16(precision)
    if x.dim() != 2 or g.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (N, d_in) and g (N, d_out); got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    dims = check_widths(weights, biases, x.shape[1])
    if g.shape[1] != dims[-1]:
        raise ValueError(f"g has {g.shape[1]} columns, the head {dims[-1]}")
    check_cuda([('x', x), ('g', g)]
                + [(f'weights[{i}]', w) for i, w in enumerate(weights)]
                + [(f'biases[{i}]', b) for i, b in enumerate(biases)])
    n = x.shape[0]
    dx = torch.empty_like(x)
    wp, bp, dp = layer_pointers(weights, biases, dims)
    dparams, partial = grad_buffers(KERNEL, 'lfgc_mlp_fused_bwd_slots', weights,
                                    biases, dp, n, x.device, bf16)
    if n > 0:
        lib, fn = _build.entry(KERNEL, 'lfgc_mlp_fused_bwd', BWD_ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), wp, bp, dp, len(weights), g.data_ptr(),
                     dx.data_ptr(), dparams.data_ptr(), partial.data_ptr(), n,
                     int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
        _build.raise_on_error(lib, KERNEL, err)
        bwd_launches += 1
    dws, dbs = param_grads(dparams, weights, biases)
    return dx, dws, dbs


def on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


class _MlpFused(torch.autograd.Function):
    """The fused MLP, differentiable in x, the weights and the biases."""

    @staticmethod
    def forward(ctx, x, precision, *params):
        nw = len(params) // 2
        ws, bs = params[:nw], params[nw:]
        ctx.save_for_backward(x, *params)
        ctx.precision = precision
        if on_cpu(x, *params):
            return mlp_fused_plain(ws, bs, x, precision)
        return mlp_fused_cuda(ws, bs, x, precision)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        nw = len(params) // 2
        ws, bs = params[:nw], params[nw:]
        g = g.contiguous()
        if on_cpu(x, g, *params):
            dx, dws, dbs = mlp_fused_plain_backward(ws, bs, x, g, ctx.precision)
        else:
            dx, dws, dbs = mlp_fused_backward_cuda(ws, bs, x, g, ctx.precision)
        return (dx, None, *dws, *dbs)


def mlp_fused(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
              x: torch.Tensor, precision: str = 'bf16') -> torch.Tensor:
    """SnakeAlt MLP at (N, d_in) -> (N, d_out), every width <= 128 (wider
    raises); differentiable in x, weights and biases.  CPU tensors take the
    plain versions, CUDA tensors the kernels."""
    check_widths(weights, biases, x.shape[-1])
    _is_bf16(precision)
    return _MlpFused.apply(x, precision, *weights, *biases)
