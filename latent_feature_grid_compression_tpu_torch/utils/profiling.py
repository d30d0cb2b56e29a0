"""Profiler traces (the port's counterpart of the JAX package's
``utils/profiling.py::trace``)."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str | torch.device = 'cuda'):
    """Trace the enclosed work with ``torch.profiler`` into ``log_dir`` (a
    Chrome trace, ``*.pt.trace.json``, which TensorBoard's profiler plugin
    and Perfetto read) if ``log_dir`` is set; a no-op otherwise.  Records
    the CPU always and the card's kernels when ``device`` is a CUDA device
    (the default, as every entry point of the port; CPU work passes
    ``'cpu'``); the enclosed work must end in a device read for the trace
    to span its execution."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
