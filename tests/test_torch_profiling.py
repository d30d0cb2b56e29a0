"""The profiler trace of the port (``utils/profiling.py::trace``): on the
card by default, like every entry point; on the CPU when asked."""

import inspect
import json
import os

import torch

from latent_feature_grid_compression_tpu_torch.utils.profiling import trace


def test_trace_defaults_to_the_card():
    assert inspect.signature(trace).parameters['device'].default == 'cuda'


def test_trace_on_the_cpu_writes_a_trace(tmp_path):
    """trace(dir, 'cpu') records the CPU's operators into one Chrome
    trace under dir."""
    with trace(str(tmp_path), 'cpu'):
        x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        float((x @ x).sum())
    traces = [f for f in os.listdir(tmp_path) if f.endswith('.pt.trace.json')]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        events = json.load(f)['traceEvents']
    assert any('aten::mm' in e.get('name', '') for e in events)


def test_trace_without_a_dir_records_nothing(tmp_path):
    before = set(os.listdir(tmp_path))
    with trace('', 'cpu'):
        float(torch.ones(4).sum())
    with trace(None):
        pass
    assert set(os.listdir(tmp_path)) == before
