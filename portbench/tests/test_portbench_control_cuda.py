"""On the card, at each cell's own size: the program's numbers stay within
their limits while the control (the reference in TF32 put in the program's
place) fails one of them, and so does, for a training cell, the reference
with each step's loss over half its batch.  Run on the card:

    python3 -m pytest -q -p no:cacheprovider portbench/tests/test_portbench_control_cuda.py
"""

import json

import pytest

from portbench import calibrate
from portbench import spec as S

from conftest import BENCH, ROOT

CELLS = [w['name'] for w in json.loads((ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_the_control_fails_and_the_program_passes(card, workload):
    cell = S.load_cell(workload)
    limits = json.loads((BENCH / 'limits' / f'{workload}.json').read_text())
    got = calibrate.readings(cell, 2 ** 32 + 17, 0.5, card)
    assert all(v <= limits[k] for k, v in got['program'].items()), got
    for fault in ('control', 'half_batch'):
        if fault in got:
            assert any(v > limits[k] for k, v in got[fault].items()), (fault, got)
