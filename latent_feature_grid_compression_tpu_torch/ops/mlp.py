"""SnakeAlt MLP head (port of the JAX package's ``ops/mlp.py``).

``num_layers`` hidden Linear layers, each followed by SnakeAlt, then a final
Linear.  Weights keep ``nn.Linear``'s (out, in) layout; the JAX package keeps
(in, out), and the transpose happens only in ``convert.py`` and
``io/checkpoint.py``.

:func:`mlp_apply_bf16` is the MLP of the bf16 compute path
(``compute_dtype='bfloat16'`` with ``mlp_backend='xla'``), as the JAX
``apply_model`` computes it outside any Pallas kernel: weights, biases and
x cast to bfloat16, each layer's product (cuBLAS on the card, float32 sums
rounded to bf16), bias add and SnakeAlt in bf16, the result cast to
float32.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def snake_alt(x: torch.Tensor) -> torch.Tensor:
    """SnakeAlt(x) = 0.5*x + sin(x)**2."""
    s = torch.sin(x)
    return 0.5 * x + s * s


def init_linear(generator: torch.Generator, d_in: int, d_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear``'s default init, U[-1/sqrt(d_in), 1/sqrt(d_in)] for weight
    (out, in) and bias, drawn from ``generator``."""
    bound = 1.0 / math.sqrt(d_in)
    w = torch.rand((d_out, d_in), generator=generator) * (2 * bound) - bound
    b = torch.rand((d_out,), generator=generator) * (2 * bound) - bound
    return w, b


def init_mlp(generator: torch.Generator, d_in: int, hidden: int, d_out: int,
             num_layers: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """[d_in->h] + (num_layers-1) x [h->h] + final [h->d_out]."""
    dims = [d_in] + [hidden] * num_layers + [d_out]
    weights, biases = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        w, bias = init_linear(generator, a, b)
        weights.append(w)
        biases.append(bias)
    return weights, biases


def mlp_apply(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
              x: torch.Tensor, activation=snake_alt) -> torch.Tensor:
    """Hidden layers (activation after each) + linear head."""
    for w, b in zip(weights[:-1], biases[:-1]):
        x = activation(F.linear(x, w, b))
    return F.linear(x, weights[-1], biases[-1])


def mlp_apply_bf16(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                   x: torch.Tensor, activation=snake_alt) -> torch.Tensor:
    """:func:`mlp_apply` in bfloat16 -> float32.  The casts are ``.to()`` of
    the float32 tensors, so gradients reach them in float32.  The product
    and the bias add round apart, as JAX's ``jnp.dot(x, w) + b`` on bf16
    arrays does."""
    bf = torch.bfloat16
    ws = [w.to(bf) for w in weights]
    bs = [b.to(bf) for b in biases]
    x = x.to(bf)
    for w, b in zip(ws[:-1], bs[:-1]):
        x = activation(F.linear(x, w) + b)
    return (F.linear(x, ws[-1]) + bs[-1]).to(torch.float32)
