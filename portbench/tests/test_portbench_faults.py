"""Each fault a cell can have, planted under the timed path of a whole run
(the look for a card skipped: on the CPU at a tiny size), must come out as
``correct`` false; the same run without it comes out true.  The exchange
between chips is no fault of these cells: each runs on one card."""

import pytest
import torch

from latent_feature_grid_compression_tpu_torch.eval import reconstruct
from latent_feature_grid_compression_tpu_torch.models import feature_grid
from latent_feature_grid_compression_tpu_torch.train import trainer

from conftest import run_tiny

TRAIN = ['smallify-train', 'dynvar-train']


def _unchanged(flat, g, m, v, lr, bc1, bc2, **kw):
    return flat, m, v


def _half_batch(real):
    def loss_and_grad(ph, layout, flat, norm, gt, *a, **kw):
        half = norm.shape[0] // 2
        return real(ph, layout, flat, norm[:half], gt[:half], *a, **kw)
    return loss_and_grad


def _altered(real):
    def fn(*a, **kw):
        out = real(*a, **kw).clone()
        out.view(-1)[0] += 0.1
        return out
    return fn


@pytest.mark.parametrize('workload', TRAIN + ['smallify-decompress', 'smallify-query'])
def test_sound_runs_are_correct(tiny_bench, workload):
    result, _ = run_tiny(tiny_bench, workload)
    assert result['correct'], result['checks']


@pytest.mark.parametrize('workload', TRAIN)
def test_a_step_that_leaves_its_state_unchanged(tiny_bench, monkeypatch, workload):
    monkeypatch.setattr(trainer, 'adam_update', _unchanged)
    result, _ = run_tiny(tiny_bench, workload)
    assert not result['correct']
    assert result['checks']['update_gap']['value'] == pytest.approx(1.0)


@pytest.mark.parametrize('workload', TRAIN)
def test_half_the_batch_left_out(tiny_bench, monkeypatch, workload):
    monkeypatch.setattr(trainer, 'loss_and_grad', _half_batch(trainer.loss_and_grad))
    result, _ = run_tiny(tiny_bench, workload)
    assert not result['correct'], result['checks']


def _row_stuck(real):
    def _step(runner, st):
        real(runner, st)
        runner.at[:1].sub_(1)
    return _step


@pytest.mark.parametrize('workload', TRAIN)
def test_a_chunk_row_counter_that_does_not_advance(tiny_bench, monkeypatch, workload):
    """Every step of a chunk reads the chunk's first row: a fault of the
    window's chunk runner alone, which a chunk of one step cannot show."""
    monkeypatch.setattr(trainer.ChunkRunner, '_step', _row_stuck(trainer.ChunkRunner._step))
    result, _ = run_tiny(tiny_bench, workload)
    assert not result['correct'], result['checks']
    assert result['checks']['loss_gap']['value'] > result['checks']['loss_gap']['limit']


@pytest.mark.parametrize('workload,module,name', [
    ('smallify-decompress', reconstruct, 'predict_trilinear'),
    ('smallify-query', feature_grid, 'predict')])
def test_an_answer_altered_where_it_is_produced(tiny_bench, monkeypatch, workload, module, name):
    monkeypatch.setattr(module, name, _altered(getattr(module, name)))
    result, _ = run_tiny(tiny_bench, workload)
    assert not result['correct']
    gap = next(iter(result['checks'].values()))['value']
    assert gap == pytest.approx(0.1, rel=1e-3) or gap > 0.05
    assert torch.get_default_dtype() == torch.float32
