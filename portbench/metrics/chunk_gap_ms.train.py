"""The card's idle time between two training chunks of one phase (the
program's spans): from the end of the chunk before's device read, where the
card has drained, to the start of this chunk's steps.  A chunk after a
profiled one is left out (the profiler's stop falls in that gap)."""
from portbench.spans import median


def gap(u):
    p = u.prev
    if p is None or p.span.profiled or p.span.parent != u.span.parent:
        return None
    read, steps = p.parts.get('train.read'), u.parts.get('train.steps')
    if read is None or steps is None:
        return None
    return (steps.start_ns - read.end_ns) * 1e-6


def read(run):
    return median(run, 'train', gap)
