"""A configuration, a traffic mix and a metric added as files and entries are
found by name, with no edit of the harness."""

import json

import pytest
import torch

from portbench import generator as gen
from portbench import spec as S

from conftest import run_tiny


def test_new_files_and_entries_are_found_by_name(tiny_bench):
    root, bd = tiny_bench
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cfg = json.loads((root / 'mhd_p_smallify.json').read_text())
    (root / 'wider.json').write_text(json.dumps(dict(cfg, grid_features=8)))
    bench['configs'].append({'name': 'wider', 'source': 'https://example.org/wider',
                             'file': 'wider.json', 'reduced': [], 'why': 'a throwaway'})
    mix = json.loads((bd / 'traffic' / 'query_slices.json').read_text())
    (bd / 'traffic' / 'small_slices.json').write_text(json.dumps(dict(mix, side=8)))
    (bd / 'metrics' / 'query_count.query.py').write_text(
        'def read(run):\n    return run.units if run.kind == "query" else None\n')
    bench['workloads'].append({'name': 'wider-small-query', 'config': 'wider',
                               'traffic': 'small_slices', 'chips': 1, 'why': 'a throwaway'})
    bench['per_layer'].append({'name': 'query_count.query', 'unit': 'requests',
                               'better': 'higher', 'source': 'program_counter',
                               'layer': 'query path', 'moves': 'query_p95_ms',
                               'workloads': ['wider-small-query']})
    bench['end_to_end'][2]['workloads'].append('wider-small-query')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    (bd / 'limits' / 'wider-small-query.json').write_text(json.dumps({'query_gap': 1e-6}))

    cell = S.load_cell('wider-small-query', root, bd)
    assert cell.config['grid_features'] == 8 and cell.traffic['side'] == 8
    assert [m.name for m in cell.per_layer] == ['query_count.query']
    assert {m.name for m in cell.end_to_end} == {'query_p95_ms', 'setup_s'}
    result, run = run_tiny(tiny_bench, 'wider-small-query', trace=True)
    assert result['correct'], result['checks']
    assert result['metrics']['query_count.query']['value'] == run.units > 0
    result, _ = run_tiny(tiny_bench, 'wider-small-query', trace=False)
    assert set(result['metrics']) == {'query_p95_ms', 'setup_s'}
    assert torch.get_default_dtype() == torch.float32


def test_a_configuration_reaches_the_spec_whole(tiny_bench):
    """Every key the CLI passes to make_spec reaches the spec (a backend
    named in a configuration is the one run), and a key that nothing reads,
    or a mesh the benchmark does not build, is refused."""
    root, _ = tiny_bench
    cfg = json.loads((root / 'mhd_p_smallify.json').read_text())
    assert gen.spec_of(cfg, gated=True).interp_backend == 'trilinear'
    spec = gen.spec_of(dict(cfg, interp_backend='fused', mlp_backend='pallas',
                            compute_dtype='bfloat16'), gated=True)
    assert (spec.interp_backend, spec.mlp_backend, spec.compute_dtype) == \
        ('fused', 'pallas', 'bfloat16')
    assert gen.spec_of(cfg, gated=False).drop_type == ''
    with pytest.raises(ValueError, match='nothing reads'):
        gen.spec_of(dict(cfg, interp_backnd='fused'), gated=True)
    with pytest.raises(ValueError, match='does not act on'):
        gen.spec_of(dict(cfg, mesh_data=2), gated=True)
