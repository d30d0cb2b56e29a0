"""The float32 inference head after the fetch in one CUDA kernel: the
wrapper of ``csrc/inference_head.cu``, its plain PyTorch version, and the
widths it takes.

The head takes (N, 3) coordinates and the (N, C) features the fetch gave
them, builds ``x0 = [coords | fourier_embed(coords) | feats]``, runs the
SnakeAlt MLP in float32 and clamps to [-1, 1]: the chain of
``models/feature_grid.py``'s ``_mlp_input`` after its fetch, ``mlp_apply``
and ``clamp``, which is :func:`inference_head_plain`.  The kernel replaces
no TPU kernel (the JAX package leaves this head to XLA); it is there
because the chain's ~30 launches are bound by the bytes of their (N, 32)
intermediates, which the kernel keeps in registers.

The kernel takes the published widths: d_in 3, two frequencies, hidden 32,
d_out 1, C 16 or 22, and 1 .. ``MAX_LAYERS`` - 1 hidden layers
(:func:`takes`).  ``models/feature_grid.py`` decides where it runs: the
clamped float32 head of the evaluation and of a query, on a card, at those
widths, with no gradient needed.

:func:`inference_head` takes the plain version for CPU tensors and launches
the kernel (or raises) for CUDA tensors; nothing falls back.  ``launches``
counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import _build
from .embedding import fourier_embed
from .mlp import mlp_apply, snake_alt

KERNEL = 'inference_head'
D_IN, N_FREQS, HIDDEN, D_OUT = 3, 2, 32, 1
CHANNELS = (16, 22)
MAX_LAYERS = 16     # weight matrices; csrc/snake_mlp.cuh kMaxLayers

# kernel launches since the last reset
launches = 0

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
# coords, feats, w[], b[], nw, C, out, n, stream
ARGTYPES = [_P, _P, _PP, _PP, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int64, _P]
# C, nw, n, out[4]
PLAN_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]


def takes(spec) -> bool:
    """Whether the kernel takes the head of a spec's widths."""
    return (spec.d_in == D_IN and spec.n_freqs == N_FREQS and spec.hidden == HIDDEN
            and spec.d_out == D_OUT and spec.grid_features in CHANNELS
            and 1 <= spec.num_layers <= MAX_LAYERS - 1)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a forward of these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def inference_head_plain(coords: torch.Tensor, feats: torch.Tensor,
                         weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                         n_freqs: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, d_in) coords and (N, C)
    features -> the clamped (N, d_out) output."""
    x = torch.cat([coords, fourier_embed(coords, n_freqs), feats], dim=-1)
    return mlp_apply(weights, biases, x, snake_alt).clamp(-1.0, 1.0)


def check_widths(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 C: int) -> List[int]:
    """The layer widths [15 + C, 32, ..., 32, 1] of (out, in) weights and
    their biases; raises where they are not the kernel's."""
    if C not in CHANNELS:
        raise ValueError(f"the inference head takes C in {CHANNELS}; got {C}")
    if not 2 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"expected 2..{MAX_LAYERS} weights and as many biases; "
                         f"got {len(weights)} and {len(biases)}")
    dims = [D_IN * (1 + 2 * N_FREQS) + C] + [HIDDEN] * (len(weights) - 1) + [D_OUT]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if tuple(w.shape) != (dims[i + 1], dims[i]) or tuple(b.shape) != (dims[i + 1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} and bias "
                             f"{tuple(b.shape)}; the kernel takes "
                             f"({dims[i + 1]}, {dims[i]}) and ({dims[i + 1]},)")
    return dims


def _check_cuda(named):
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


def inference_head_cuda(coords: torch.Tensor, feats: torch.Tensor,
                        weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on contiguous float32 tensors on one card: (N, 3)
    coords and (N, C) features -> the clamped (N, 1) output.  No autograd."""
    global launches
    if coords.dim() != 2 or coords.shape[1] != D_IN or feats.dim() != 2 \
            or feats.shape[0] != coords.shape[0]:
        raise ValueError(f"expected coords (N, {D_IN}) and feats (N, C); got "
                         f"{tuple(coords.shape)} and {tuple(feats.shape)}")
    C = feats.shape[1]
    check_widths(weights, biases, C)
    _check_cuda([('coords', coords), ('feats', feats)]
                + [(f'weights[{i}]', w) for i, w in enumerate(weights)]
                + [(f'biases[{i}]', b) for i, b in enumerate(biases)])
    align = 16 if C % 4 == 0 else 8
    if feats.data_ptr() % align:
        raise ValueError(f"feats must be {align}-byte aligned for C = {C}")
    n = coords.shape[0]
    out = torch.empty((n, D_OUT), device=coords.device, dtype=torch.float32)
    if n == 0:
        return out
    lib, fn = _build.entry(KERNEL, 'lfgc_inference_head', ARGTYPES)
    nw = len(weights)
    wp = (ctypes.c_void_p * nw)(*[w.data_ptr() for w in weights])
    bp = (ctypes.c_void_p * nw)(*[b.data_ptr() for b in biases])
    with torch.cuda.device(coords.device):
        err = fn(coords.data_ptr(), feats.data_ptr(), wp, bp, nw, C, out.data_ptr(), n,
                 torch.cuda.current_stream(coords.device).cuda_stream)
    _build.raise_on_error(lib, KERNEL, err)
    launches += 1
    return out


def inference_head(coords: torch.Tensor, feats: torch.Tensor,
                   weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                   n_freqs: int) -> torch.Tensor:
    """The clamped head at (N, 3) coords and their (N, C) features ->
    (N, 1).  CPU tensors take the plain version; CUDA tensors the kernel,
    which raises on widths or tensors it does not take.  No autograd."""
    if coords.device.type == 'cpu':
        return inference_head_plain(coords, feats, weights, biases, n_freqs)
    if n_freqs != N_FREQS:
        raise ValueError(f"the inference head takes {N_FREQS} frequencies; got {n_freqs}")
    return inference_head_cuda(coords, feats, weights, biases)


def plan(C: int, n_layers: int, n: int) -> dict:
    """How the kernel launches for n samples at C features and ``n_layers``
    hidden layers on the current card."""
    lib, fn = _build.entry(KERNEL, 'lfgc_inference_head_plan', PLAN_ARGTYPES)
    out = (ctypes.c_int * 4)()
    _build.raise_on_error(lib, KERNEL, fn(C, n_layers + 1, n, out))
    return dict(zip(('threads', 'blocks_per_sm', 'blocks', 'smem_bytes'), out))
