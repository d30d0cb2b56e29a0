"""The per-layer metrics read from the program's own spans
(``portbench/spans.py``): a tiny cell of each kind on the CPU reports each
of its span metrics, finite and positive, in a traced run (the captures'
only where a call or a phase captured, so not on the CPU) and none in an untraced one;
a program without spans gives nothing to read."""

import json
import math

import pytest

from portbench import spans as PS

from conftest import ROOT, run_tiny

SPAN_METRICS = {m['name']: m['workloads']
                for m in json.loads((ROOT / 'BENCHMARK.json').read_text())['per_layer']
                if m['source'] == 'program_span'}
CARD_ONLY = {'capture_ms.decompress', 'capture_ms.train'}


@pytest.mark.parametrize('workload', ['smallify-train', 'dynvar-train', 'smallify-decompress',
                                      'smallify-query'])
def test_a_traced_cell_reports_its_span_metrics(tiny_bench, workload):
    result, run = run_tiny(tiny_bench, workload, seconds=1.0, trace=True)
    mine = {name for name, cells in SPAN_METRICS.items() if workload in cells}
    assert mine
    for name in mine - CARD_ONLY:
        value = result['metrics'][name]['value']
        assert math.isfinite(value) and value > 0, (name, value)
    assert not mine & CARD_ONLY & set(result['metrics'])
    units = PS.window_units(run, run.kind)
    assert units and not any(u.span.profiled for u in units)
    result, _ = run_tiny(tiny_bench, workload, seconds=0.4, trace=False)
    assert not set(SPAN_METRICS) & set(result['metrics'])


def test_the_window_is_the_runs_last_units(tiny_bench):
    """The units read are the window's: as many chunks as the run timed,
    all of one phase's chunks after its first, each with its parts."""
    _, run = run_tiny(tiny_bench, 'smallify-train', seconds=0.6, trace=False)
    units = PS.window_units(run, 'train')
    assert len(units) == len(run.chunk_s)
    assert sum(u.parts['train.steps'].n for u in units) == run.units
    assert all({'train.draw', 'train.load', 'train.steps', 'train.read', 'train.after'}
               <= set(u.parts) for u in units)
    assert PS.window_units(run, 'query') is None


def test_a_program_without_spans_gives_nothing(tiny_bench, monkeypatch):
    from latent_feature_grid_compression_tpu_torch.utils import profiling
    _, run = run_tiny(tiny_bench, 'smallify-query', seconds=0.3, trace=False)
    monkeypatch.delattr(profiling, 'spans')
    assert PS.window_units(run, 'query') is None
    assert PS.median(run, 'query', lambda u: 1.0) is None
