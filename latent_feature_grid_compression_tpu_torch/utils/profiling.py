"""Tracing of the port, in one module: the profiler trace (``trace``, the
counterpart of the JAX package's ``utils/profiling.py::trace``) and the
program's own spans and counters (``span``, ``count``), which are kept in
memory and always on.

A span is a named stretch of host time, ``time.perf_counter_ns`` read on
entry and on exit, named ``<layer>.<part>`` (``train.steps``,
``eval.capture``, ``query.decode``).  The spans named in ``UNITS`` (a
training chunk, an evaluation call, a query request) are units: every span
opened inside one shares its id as ``unit``.  A span's ``parent`` is the
innermost span open at its start, and ``profiled`` says whether a torch
profiler was recording then (its cost is then in the span).  The last
``RING`` spans are kept, in columns of fixed size (7 MB), and read by
``spans``; ``count`` keeps integer counters, read by ``counters``.  Spans
cost two clock reads and a few stores each; only while ``trace`` is active
is each also opened as ``torch.profiler.record_function('lfgc::' + name)``
(its unit id as its argument), so that it shows in the exported trace.

``to_trace_ns`` puts a span's times on the clock of an exported trace (an
event's ``ts`` in microseconds plus the trace's ``baseTimeNanoseconds``:
the Unix clock in ns), from one pair of clock readings refreshed whenever a
trace starts.  Spans are opened on one thread (the one that drives the
card)."""

from __future__ import annotations

import contextlib
import os
import time
from array import array
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# the spans kept (a power of two)
RING = 1 << 17
# the spans that are units: a training chunk, an evaluation call, a query
# request
UNITS = frozenset({'train.chunk', 'eval.call', 'query.request'})
# the prefix of a span's name in an exported trace
TRACE_PREFIX = 'lfgc::'


class Span(NamedTuple):
    id: int           # from 1, in the order the spans were opened
    name: str
    unit: int         # the id of the unit span it belongs to (its own for a unit); 0: none
    parent: int       # the id of the innermost span open at its start; 0: none
    start_ns: int     # time.perf_counter_ns()
    end_ns: int
    profiled: bool    # a torch profiler was recording at its start
    n: int            # the items it covers where its code sets them (steps, chunks); else 0


_names: List[str] = []                 # a name's code -> the name
_codes: Dict[str, int] = {}
_cols = [array('q', bytes(8 * RING)) for _ in range(7)]   # id, code, unit, parent, start, end, n
_profiled = bytearray(RING)
_written = 0                           # spans ended since the last clear
_last_id = 0
_open: List['span'] = []               # the spans open now, innermost last
_counters: Dict[str, int] = {}
_publishing = False                    # a trace() is active
_clock = (time.perf_counter_ns(), time.time_ns())


class span:
    """``with span(name[, n]) as s:`` times the enclosed work as one span;
    ``s.n`` may be set inside (the items it covered); ``s.start`` and, once
    it has ended, ``s.end`` are its clock readings."""
    __slots__ = ('name', 'n', 'id', 'unit', 'parent', 'start', 'end', 'profiled', '_rf')

    def __init__(self, name: str, n: int = 0):
        self.name, self.n = name, n

    def __enter__(self) -> 'span':
        global _last_id
        _last_id += 1
        self.id = _last_id
        top = _open[-1] if _open else None
        self.parent = top.id if top is not None else 0
        self.unit = self.id if self.name in UNITS else (top.unit if top is not None else 0)
        self.profiled = _autograd_profiler._is_profiler_enabled
        _open.append(self)
        self.start = time.perf_counter_ns()
        self._rf = None
        if _publishing:
            self._rf = torch.profiler.record_function(TRACE_PREFIX + self.name, str(self.unit))
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global _written
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = self.end = time.perf_counter_ns()
        _open.pop()
        code = _codes.get(self.name)
        if code is None:
            code = _codes[self.name] = len(_names)
            _names.append(self.name)
        i = _written & (RING - 1)
        _written += 1
        c = _cols
        c[0][i], c[1][i], c[2][i], c[3][i] = self.id, code, self.unit, self.parent
        c[4][i], c[5][i], c[6][i] = self.start, end, self.n
        _profiled[i] = self.profiled


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` (``<what>.<layer>``)."""
    _counters[name] = _counters.get(name, 0) + k


def spans(layer: Optional[str] = None) -> List[Span]:
    """The kept spans in the order they ended, oldest first; with ``layer``,
    only those named ``<layer>.*``."""
    first = max(0, _written - RING)
    out = []
    for j in range(first, _written):
        i = j & (RING - 1)
        name = _names[_cols[1][i]]
        if layer is None or name.split('.', 1)[0] == layer:
            out.append(Span(_cols[0][i], name, _cols[2][i], _cols[3][i], _cols[4][i],
                            _cols[5][i], bool(_profiled[i]), _cols[6][i]))
    return out


def counters() -> Dict[str, int]:
    return dict(_counters)


def clear() -> None:
    """Forget every kept span and counter (ids go on rising)."""
    global _written
    _written = 0
    _counters.clear()


def to_trace_ns(t: int) -> int:
    """A ``time.perf_counter_ns`` reading on the clock of an exported trace."""
    return t - _clock[0] + _clock[1]


def _sync_clock():
    global _clock
    _clock = (time.perf_counter_ns(), time.time_ns())


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str | torch.device = 'cuda'):
    """Trace the enclosed work with ``torch.profiler`` into ``log_dir`` (a
    Chrome trace, ``*.pt.trace.json``, which TensorBoard's profiler plugin
    and Perfetto read) if ``log_dir`` is set; a no-op otherwise.  Records
    the CPU always and the card's kernels when ``device`` is a CUDA device
    (the default, as every entry point of the port; CPU work passes
    ``'cpu'``); the enclosed work must end in a device read for the trace
    to span its execution.  The spans opened inside appear in the trace as
    ``lfgc::<name>`` ranges."""
    global _publishing
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = _publishing
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        # the first range of a trace pays its set-up (0.1-1 ms on a CPU):
        # one marks the trace's start, outside every span
        with torch.profiler.record_function(TRACE_PREFIX + 'trace', '0'):
            _sync_clock()
        _publishing = True
        try:
            yield
        finally:
            _publishing = was
