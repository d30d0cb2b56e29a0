"""Reading the card's work from ``torch.profiler`` (CUPTI).

A traced run profiles a few short pieces of the steady part of its window
(a training chunk, a reconstruction, a run of query requests), each apart,
and reads them after the window has closed.  A profile's summary gives the
device's busy seconds (the union of its kernels', copies' and sets'
intervals), each device operation's records and time by name, the host's
calls that launch device work, and the idle gaps between device operations
labelled by the host operation that was running when each began.

The profiler now and then loses kernel records of CUDA graph replays (seen
on an H100 under torch 2.11: a trace held the fetch kernel 0.87 times a
step).  So a profile is only read when each kernel the cell names has as
many records as the launches it must have made (``complete``); the first
complete profile is read, and with none a metric that needs kernel time
is left out.  (The check is ``chip_smoke.py::profile_modes``'s, held to the
program's own launch counters in place of the graph's nodes.)
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

# host calls that launch device work: a kernel (the CUDA runtime's entries
# and libcuda's) or a CUDA graph
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cudaLaunchKernelEx',
                'cuLaunchKernel', 'cuLaunchKernelEx', 'cudaGraphLaunch', 'cuGraphLaunch')
# the spans the generator wraps each unit of work in
SPAN = 'portbench::'
TOP = 10


@dataclasses.dataclass
class Summary:
    """One profiled piece of the window."""
    units: float                     # steps, reconstructions or requests
    window_s: float                  # host clock from its start to its end
    busy_s: float                    # the union of device operations' intervals
    span_s: float                    # the generator's spans' total length (0: none)
    busy_in_spans_s: float           # busy time inside those spans
    launch_calls: int
    device_ops: Dict[str, Tuple[int, float]]   # name -> (records, seconds)
    idle_gaps: Dict[str, float]      # host operation at a gap's start -> seconds
    expected: Dict[str, float]       # kernel name -> the records it must have

    def records(self, name: str) -> int:
        return sum(n for k, (n, _) in self.device_ops.items() if name in k)

    def seconds(self, name: str) -> float:
        return sum(s for k, (_, s) in self.device_ops.items() if name in k)

    def complete(self) -> bool:
        return all(self.records(k) == n for k, n in self.expected.items())

    def missing(self) -> Dict[str, float]:
        return {k: n - self.records(k) for k, n in self.expected.items()
                if self.records(k) != n}


class Profile:
    """``start`` and ``stop`` around a piece of the window; ``summary``
    reads it later."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0

    def start(self):
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self, units: float, expected: Dict[str, float]) -> Summary:
        return summarize(self.prof.events(), units, self.t1 - self.t0, expected)


def warm(device):
    """A profile of a single launch, before the window: the
    profiler's first start sets up CUPTI, which took ~9 s on an H100."""
    import torch
    s = Profile()
    s.start()
    torch.ones(1, device=device).add_(1.0)
    torch.cuda.synchronize(device)
    s.stop()
    s.prof.events()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def summarize(events, units: float, window_s: float, expected: Dict[str, float]) -> Summary:
    """A profile's ``FunctionEvent``s (times in microseconds on one clock)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in events:
        note = getattr(e, 'is_user_annotation', False) or e.name.startswith(SPAN)
        if e.device_type == DeviceType.CUDA:
            # an annotation's span on the device's timeline covers kernels
            if not note:
                device.append(e)
        elif not note or e.name.startswith(SPAN):
            host.append(e)
    ops: Dict[str, List[float]] = {}
    intervals = []
    for e in device:
        a, b = e.time_range.start, e.time_range.end
        intervals.append((a, b))
        rec = ops.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-6
    busy = _union(intervals)
    spans = _union([(e.time_range.start, e.time_range.end) for e in host
                    if e.name.startswith(SPAN)])
    launch_calls = sum(1 for e in host if e.name in LAUNCH_CALLS)
    # label each gap between device operations by the innermost host
    # operation running at its start
    cpu = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                  if not e.name.startswith(SPAN)))
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(busy[:-1], busy[1:]):
        label = 'no host operation'
        i = bisect.bisect_right(starts, end) - 1
        for k in range(i, max(-1, i - 256), -1):
            if cpu[k][1] > end:
                label = cpu[k][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (nxt - end) * 1e-6
    return Summary(units=units, window_s=window_s,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   span_s=sum(b - a for a, b in spans) * 1e-6,
                   busy_in_spans_s=_overlap(spans, busy) * 1e-6,
                   launch_calls=launch_calls,
                   device_ops={k: (int(n), s) for k, (n, s) in ops.items()},
                   idle_gaps=gaps, expected=expected)


def first_complete(summaries: List[Summary]) -> Optional[Summary]:
    for s in summaries:
        if s.complete():
            return s
    return None


def breakdown(s: Summary) -> dict:
    """The device operations that took most time and the idle gaps by what
    the host was doing, each at most TOP entries, as measured."""
    ops = sorted(((sec, name) for name, (_, sec) in s.device_ops.items()), reverse=True)
    gaps = sorted(((sec, name) for name, sec in s.idle_gaps.items()), reverse=True)
    return {'device_ops': [[name, sec] for sec, name in ops[:TOP]],
            'idle_gaps': [[name, sec] for sec, name in gaps[:TOP]]}
