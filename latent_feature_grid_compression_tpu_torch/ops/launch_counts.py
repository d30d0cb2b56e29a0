"""The kernel wrappers' launch counts, read and written as one tuple.

Each wrapper adds one to its module's count where it launches its kernel
(``grid_sample``, ``mlp_fused``, ``fused_forward``).  A CUDA graph's replay
launches the kernels its capture recorded without calling a wrapper, so the
trainer's chunk runner records what a capture added (``since``), takes it
back, and adds it once a replay (``add``).
"""

from __future__ import annotations

from typing import Tuple

from . import fused_forward as ff
from . import grid_sample as gs
from . import mlp_fused as mf

COUNTERS = ((gs, 'launches'), (gs, 'bwd_launches'), (gs, 'bf16_launches'),
            (gs, 'bf16_bwd_launches'), (mf, 'launches'), (mf, 'bwd_launches'),
            (ff, 'launches'), (ff, 'bwd_launches'), (ff, 'bf16_launches'),
            (ff, 'bf16_bwd_launches'))


def read() -> Tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def write(counts: Tuple[int, ...]):
    for (mod, name), value in zip(COUNTERS, counts):
        setattr(mod, name, value)


def since(mark: Tuple[int, ...]) -> Tuple[int, ...]:
    """The launches counted after ``read()`` gave ``mark``."""
    return tuple(a - b for a, b in zip(read(), mark))


def add(delta: Tuple[int, ...]):
    write(tuple(a + b for a, b in zip(read(), delta)))
