"""Arithmetic the per-layer readers share: a share of the card's peak over
the window, a kernel's share of its roofline from a profiled piece, the
host's launch calls and the device's idle share of a profile."""

from __future__ import annotations

from typing import Optional

from .peaks import for_device


def mfu(run, kind: str) -> Optional[float]:
    """The operations the algorithm needs, per second of the window's wall
    time outside its profiled pieces, over the float32 peak, in %."""
    peaks = for_device(run.device_kind)
    if run.kind != kind or peaks is None or run.untraced_s <= 0:
        return None
    return 100.0 * run.untraced_ops / run.untraced_s / peaks.f32_flops


def roofline(run, kind: str, bound_ms, kernels) -> Optional[float]:
    """``bound_ms(peaks)`` over the device time of one call of the kernels
    named (summed: a call may launch several), from a complete profile, in %."""
    s = run.trace
    peaks = for_device(run.device_kind)
    if run.kind != kind or s is None or peaks is None:
        return None
    calls = s.records(kernels[0])
    seconds = sum(s.seconds(k) for k in kernels)
    if not calls or seconds <= 0:
        return None
    return 100.0 * bound_ms(peaks) * 1e-3 / (seconds / calls)


def launch_calls(run, kind: str, per) -> Optional[float]:
    """Host calls that launched device work in a profile, per ``per(s)``
    units of it."""
    s = run.trace
    if run.kind != kind or s is None or not per(s):
        return None
    return s.launch_calls / per(s)


def idle_share(run, kind: str, spans: bool = False) -> Optional[float]:
    """The share of a profile (or, with ``spans``, of its requests' spans)
    in which no device operation ran, in %."""
    s = run.trace
    if run.kind != kind or s is None:
        return None
    if spans:
        return 100.0 * (1.0 - s.busy_in_spans_s / s.span_s) if s.span_s > 0 else None
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
