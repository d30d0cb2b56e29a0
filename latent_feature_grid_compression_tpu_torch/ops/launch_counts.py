"""The kernel wrappers' launch counts and the mesh's collective counts, read
and written as one tuple.

Each wrapper adds one to its module's count where it launches its kernel
(``grid_sample``, ``mlp_fused``, ``fused_forward``, ``inference_head``), and
each collective of ``parallel/mesh.py`` adds its call and the ring model's
bytes to that module's ``counts`` where its Python call is made.  A CUDA
graph's replay launches the kernels and the NCCL collectives its capture
recorded without calling any of that Python, so the trainer's chunk runner
records what a capture added (``since``), takes it back, and adds it once a
replay (``add``).
"""

from __future__ import annotations

from typing import Tuple

from ..parallel import mesh as pm
from . import fused_forward as ff
from . import grid_sample as gs
from . import inference_head as ih
from . import mlp_fused as mf

KERNEL_COUNTERS = ((gs, 'launches'), (gs, 'bwd_launches'), (gs, 'bf16_launches'),
                   (gs, 'bf16_bwd_launches'), (mf, 'launches'), (mf, 'bwd_launches'),
                   (ff, 'launches'), (ff, 'bwd_launches'), (ff, 'bf16_launches'),
                   (ff, 'bf16_bwd_launches'), (ih, 'launches'))
COUNTERS = KERNEL_COUNTERS + tuple((pm.counts, key) for key in pm.counts)


def _get(holder, key):
    return holder[key] if isinstance(holder, dict) else getattr(holder, key)


def _set(holder, key, value):
    if isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


def read() -> Tuple[float, ...]:
    return tuple(_get(holder, key) for holder, key in COUNTERS)


def write(counts: Tuple[float, ...]):
    for (holder, key), value in zip(COUNTERS, counts):
        _set(holder, key, value)


def since(mark: Tuple[float, ...]) -> Tuple[float, ...]:
    """What was counted after ``read()`` gave ``mark``."""
    return tuple(a - b for a, b in zip(read(), mark))


def add(delta: Tuple[float, ...]):
    write(tuple(a + b for a, b in zip(read(), delta)))
