"""The benchmark's own tests.  A tiny copy of the benchmark (``tiny_bench``)
runs every cell on the CPU through the port's plain paths; tests that need
the card are marked ``cuda`` and skip here, deciding inside a fixture."""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU with CUDA; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('checks the refusal on a machine without a card')


def make_tiny_bench(tmp: Path):
    """(root, bench dir): BENCHMARK.json's cells with the configurations at a
    17^3 volume and a 128-sample batch, and mixes cut to match; the metric
    readers and the limits as they are."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for c in bench['configs']:
        cfg = json.loads((ROOT / c['file']).read_text())
        cfg.update(batch_size=32, sample_size=4,
                   volume={'generator': 'mhd_like', 'n': 17, 'octaves': 3})
        c['file'] = f"{c['name']}.json"
        (tmp / c['file']).write_text(json.dumps(cfg))
    (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
    bd = tmp / 'bench'
    for d in ('traffic', 'metrics', 'limits'):
        shutil.copytree(BENCH / d, bd / d)
    for t in (bd / 'traffic').glob('*.json'):
        mix = json.loads(t.read_text())
        if mix['kind'] == 'train':
            mix['steps_per_chunk'] = 5
        if mix['kind'] == 'query':
            mix.update(side=32, traced_requests=3, warmup=2)
        t.write_text(json.dumps(mix))
    return tmp, bd


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)


def run_tiny(tiny, workload, seed=2 ** 33 + 5, seconds=0.4, trace=False):
    import time

    import torch

    from portbench import run as R
    from portbench import spec as S
    root, bd = tiny
    cell = S.load_cell(workload, root, bd)
    return R.run_cell(cell, seed, seconds, trace, torch.device('cpu'), time.perf_counter(), bd)
