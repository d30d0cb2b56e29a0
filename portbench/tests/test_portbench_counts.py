"""The operation counts and bounds at the flagship's shapes, against values
worked out by hand."""

import json

import pytest

from portbench.counts import dwt, fetch, model
from portbench.peaks import TABLE

from conftest import ROOT

H100 = TABLE['NVIDIA H100 80GB HBM3']


@pytest.fixture
def flagship():
    return json.loads((ROOT / 'portbench/configs/mhd_p_smallify.json').read_text())


def test_pyramid_sizes_and_coefficients():
    # db2 on 15: pad 2 (+1 odd) -> (15 + 5 - 4) // 2 + 1 = 9, then 6
    assert dwt._sizes(15) == [6, 9, 15]
    assert dwt.coefficient_count(16, 15) == 16 * (6 ** 3 + 7 * 6 ** 3 + 7 * 9 ** 3) == 109_296


def test_decode_ops_by_hand():
    # a level s -> S: 16 channels x (4 s^2 S + 2 s S^2 + S^3) outputs x 2 x 2s
    level1 = 16 * (4 * 36 * 9 + 2 * 6 * 81 + 729) * 2 * 12
    level2 = 16 * (4 * 81 * 15 + 2 * 9 * 225 + 3375) * 2 * 18
    assert (level1, level2) == (1_150_848, 7_076_160)
    assert dwt.decode_ops(16, 15) == level1 + level2
    assert dwt.gate_ops(16, 15, 1) == 109_296 + 6_831


def test_head_and_point(flagship):
    assert model.head_dims(flagship) == [31, 32, 32, 32, 32, 1]
    # products 2KM + M a layer: 2016 + 3 x 2080 + 65; SnakeAlt 4 x 128
    head = 2016 + 3 * 2080 + 65 + 4 * 128
    assert head == 8833
    # fetch 2 x 8 x 16 + 40, embedding 3 x 2 x 3, clamp 1
    assert model.point_ops(flagship) == 296 + 18 + head + 1 == 9148


def test_train_step_by_hand(flagship):
    n = 2048 * 16
    params = 109_296 + 4_225 + 6_831
    assert model.n_params(flagship) == params == 120_352
    want = (3 * (8_227_008 + 116_127) + 2 * n * 296 + n * 18 + 3 * n * 8833 + 3 * n
            + 14 * params)
    assert model.train_step_ops(flagship) == want == 915_120_349


def test_dynamic_variational_adds_the_variance_model(flagship):
    dyn = dict(flagship, drop_type='dynamic_variational')
    n = 2048 * 16
    # 3 -> 4 x 32 -> 1 ReLU: products 2 x 3 x 32 + 32 + 3 x 2080 + 65, ReLU 128
    variance = 3 * n * (224 + 3 * 2080 + 65 + 128) + 8 * n
    # a gate value: 5 operations against smallify's 1, three times a step
    gates = 3 * (5 - 1) * 6_831
    extra_params = 6_831 + (3 * 32 + 32 + 3 * (32 * 32 + 32) + 33)
    assert model.train_step_ops(dyn) - model.train_step_ops(flagship) == \
        variance + gates + 14 * extra_params


def test_fetch_bounds_at_the_step_and_the_chunk():
    # bytes bound: coordinates and output at 4 B, the 16 x 15^3 grid once
    step = (4 * 32768 * 19 + 4 * 3375 * 16) / 3.35e12 * 1e3
    assert fetch.bound_ms(32768, 16, 15, 15, 15, H100) == pytest.approx(step, rel=1e-12)
    assert step == pytest.approx(0.00080787, rel=1e-4)
    chunk = (4 * 2 ** 18 * 19 + 4 * 3375 * 16) / 3.35e12 * 1e3
    assert fetch.bound_ms(2 ** 18, 16, 15, 15, 15, H100) == pytest.approx(chunk, rel=1e-12)
    grad = (32768 * (12 + 64) + 4 * 3375 * 16) / 3.35e12 * 1e3
    assert fetch.grad_bound_ms(32768, 16, 15, 15, 15, H100) == pytest.approx(grad, rel=1e-12)
