"""Reading the port's own spans (``utils/profiling.py``: host clock, kept
in memory, always on) for a cell's window.  A window's units are its last
training chunks (as many as ``run.chunk_s`` has), or its last
reconstructions or requests (``run.units``); a unit during which a
profiler recorded is left out, since the profiler's cost is in it.  A
program without the spans gives nothing to read, and every reader returns
None there."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

UNIT = {'train': 'train.chunk', 'decompress': 'eval.call', 'query': 'query.request'}


class Unit:
    """One unit span and its parts by name (the first of each name); ``prev``
    the unit before it in the ring."""

    def __init__(self, span, parts: Dict[str, object], prev: Optional['Unit']):
        self.span, self.parts, self.prev = span, parts, prev

    def ms(self, first: str, last: str) -> Optional[float]:
        """From ``first``'s start to ``last``'s end, in ms; None where either
        is missing."""
        a, b = self.parts.get(first), self.parts.get(last)
        return None if a is None or b is None else (b.end_ns - a.start_ns) * 1e-6


def window_units(run, kind: str) -> Optional[List[Unit]]:
    """The window's units of ``kind`` that no profiler recorded, oldest
    first; None where the run is of another kind or the program keeps no
    spans."""
    if run.kind != kind:
        return None
    from latent_feature_grid_compression_tpu_torch.utils import profiling
    try:
        kept = profiling.spans(UNIT[kind].split('.')[0])
    except AttributeError:   # a program without the spans
        return None
    parts: Dict[int, Dict[str, object]] = {}
    units = []
    for s in kept:
        if s.name == UNIT[kind]:
            units.append(s)
        elif s.unit:
            parts.setdefault(s.unit, {}).setdefault(s.name, s)
    out, prev = [], None
    for s in units:
        prev = Unit(s, parts.get(s.id, {}), prev)
        out.append(prev)
    count = len(run.chunk_s) if kind == 'train' else run.units
    window = out[max(0, len(out) - count):] if count else []
    return [u for u in window if not u.span.profiled] or None


def median(run, kind: str, value: Callable[[Unit], Optional[float]]) -> Optional[float]:
    """The median of ``value`` over the window's units where it is not None."""
    units = window_units(run, kind)
    got = [v for v in map(value, units or ()) if v is not None]
    return statistics.median(got) if got else None
