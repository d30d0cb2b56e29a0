"""``BENCHMARK.json`` against the benchmark's contract, and the shape of a
run's last line."""

import json
import re

import pytest

from portbench import spec as S

from conftest import BENCH, ROOT, run_tiny

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {'configs': {'name', 'source', 'file', 'reduced', 'why'},
        'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
        'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
        'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'}}


@pytest.fixture(scope='module')
def bench():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def test_keys_names_and_files(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', *KEYS}
    assert bench['paths'] == ['portbench'] and 1 <= bench['run_seconds'] <= 51
    for section, keys in KEYS.items():
        for entry in bench[section]:
            assert set(entry) - {'workloads'} == keys, entry
            assert NAME.match(entry['name']), entry['name']
            if 'unit' in entry:
                assert UNIT.match(entry['unit']) and entry['better'] in ('lower', 'higher')
    for c in bench['configs']:
        assert (ROOT / c['file']).is_file() and c['file'].startswith('portbench/')
    names = [m['name'] for s in ('end_to_end', 'per_layer') for m in bench[s]]
    assert len(names) == len(set(names))
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    for m in bench['per_layer']:
        assert m['moves'] in {e['name'] for e in bench['end_to_end']}
        assert (BENCH / 'metrics' / f"{m['name']}.py").is_file()
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench['workloads']:
        cell = S.load_cell(w['name'])
        e2e = {m.name for m in cell.end_to_end}
        assert 'setup_s' in e2e and len(e2e) >= 2 and cell.per_layer
        assert (BENCH / 'limits' / f"{w['name']}.json").is_file()
        assert w['chips'] == 1
        for m in bench['per_layer']:
            if w['name'] in m['workloads']:
                assert m['moves'] in e2e


@pytest.mark.parametrize('trace', [False, True])
def test_last_line(tiny_bench, trace):
    result, _ = run_tiny(tiny_bench, 'smallify-decompress', trace=trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(line)[-1] == 'checks'
    assert line['correct'] is True and line['attempted'] > 0 and line['failed'] == 0
    dev = line['device']
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(dev)
    for name, c in line['checks'].items():
        assert set(c) == {'value', 'limit'} and c['value'] <= c['limit']
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'}
    if trace:
        assert {'busy_s', 'window_s'} <= set(dev)
        for key in ('device_ops', 'idle_gaps'):
            assert len(line['breakdown'][key]) <= 10
    else:
        assert set(line['metrics']) == {'decompress_voxels_per_s', 'setup_s'}
