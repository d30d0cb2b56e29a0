"""The gated inverse DWT of the coefficient pyramid, once a step or request.

A level restores s^3 -> S^3 for every channel: three separable contractions
of the 8 subbands, each 2 x (reduced length 2 s) operations an output entry:
(4 s^2 S) + (2 s S^2) + S^3 outputs a channel.  The gate costs ``gate_ops``
a gate value (smallify's multiply: 1; dynamic variational's two exp, a
halving, a multiply and an add: 5) plus one multiply a coefficient."""

from __future__ import annotations

import math
from typing import List


def _sizes(grid_size: int, filter_length: int = 4) -> List[int]:
    levels = int(math.floor(math.log2(grid_size / (filter_length - 1.0))))
    pad = (2 * filter_length - 3) // 2
    sizes, s = [grid_size], grid_size
    for _ in range(levels):
        s = (s + 2 * pad + s % 2 - filter_length) // 2 + 1
        sizes.append(s)
    return sizes[::-1]          # coarsest first: [s_L, ..., grid_size]


def decode_ops(channels: int, grid_size: int) -> int:
    sizes = _sizes(grid_size)
    total = 0
    for s, S in zip(sizes[:-1], sizes[1:]):
        outputs = 4 * s * s * S + 2 * s * S * S + S ** 3
        total += channels * outputs * 2 * (2 * s)
    return total


def coefficient_count(channels: int, grid_size: int) -> int:
    sizes = _sizes(grid_size)
    return channels * (sizes[0] ** 3 + 7 * sum(s ** 3 for s in sizes[:-1]))


def gate_ops(channels: int, grid_size: int, per_gate: int) -> int:
    coeffs = coefficient_count(channels, grid_size)
    return coeffs + per_gate * coeffs // channels
