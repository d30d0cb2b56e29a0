"""The trilinear feature fetch and its grid gradient, and their least times
on the card (frozen copies of ``chip_smoke.py::fetch_bound_ms`` and
``grad_bound_ms``)."""

from __future__ import annotations

from ..peaks import Peaks


def ops(n: int, C: int) -> int:
    """Operations of one fetch of ``n`` samples of ``C`` channels: 8 corners
    x C multiply-adds, plus ~40 for the pixel map and the weights a sample.
    The gradient does the same work again."""
    return n * (2 * 8 * C + 40)


def bound_ms(n: int, C: int, D: int, H: int, W: int, peaks: Peaks) -> float:
    """Least time of one fetch: its bytes (coordinates read, output written,
    the float32 grid read once) or its float32 operations, whichever takes
    longer."""
    nbytes = 4 * n * (3 + C) + 4 * D * H * W * C
    return max(nbytes / peaks.bytes_s, ops(n, C) / peaks.f32_flops) * 1e3


def grad_bound_ms(n: int, C: int, D: int, H: int, W: int, peaks: Peaks) -> float:
    """Least time of one grid gradient: coordinates and the output gradient
    read, the grid's gradient written once, or its operations."""
    nbytes = n * (12 + 4 * C) + 4 * D * H * W * C
    return max(nbytes / peaks.bytes_s, ops(n, C) / peaks.f32_flops) * 1e3
