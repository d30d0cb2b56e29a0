"""An MLP of Linear layers: 2 K M operations a sample and layer for the
product and M for the bias; an activation costs ``act_ops`` an entry
(SnakeAlt, x / 2 + sin(x)^2: 4; ReLU: 1)."""

from __future__ import annotations

from typing import Sequence


def forward_ops(n: int, dims: Sequence[int], act_ops: int) -> int:
    """``dims`` = [in, hidden..., out]; activations after every layer but
    the last."""
    products = sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return n * (products + act_ops * sum(dims[1:-1]))


def train_ops(n: int, dims: Sequence[int], act_ops: int) -> int:
    """Forward, then the backward's two products a layer (the input's
    gradient and the weights'), each as costly as the forward's."""
    return 3 * forward_ops(n, dims, act_ops)
