"""Stream-matched A/B of the two training entry points: the JAX package's
``train.run.training`` and the port's, both phases, bake, prune and
evaluation, from the same initial parameters (a JAX checkpoint, through
``checkpoint_path``) and the same positions (the port replays the JAX
trainer's stream, ``tests/torch_ab.py::jax_pos_stream``).  At the
configuration of ``tests/test_ab_parity.py``: final PSNR within 0.05 dB,
equal zero counts, equal compression ratio."""

import os

import jax
import pytest

from latent_feature_grid_compression_tpu.config import TrainConfig as JaxConfig
from latent_feature_grid_compression_tpu.io.checkpoint import save_checkpoint
from latent_feature_grid_compression_tpu.models import init_model, make_spec
from latent_feature_grid_compression_tpu.train import training as jax_training
from latent_feature_grid_compression_tpu_torch.config import TrainConfig
from latent_feature_grid_compression_tpu_torch.train import training
from tests.test_ab_parity import synthetic_volume
from tests.torch_ab import jax_pos_stream


def run_ab(tmp_path, drop_type, max_pass):
    vol = synthetic_volume()
    kw = dict(data='', basedir=f'/{os.path.relpath(tmp_path)}/', drop_type=drop_type,
              max_pass=max_pass, batch_size=256, sample_size=8, grid_size=8,
              grid_features=8, n_hidden_size=16, n_layers=2, steps_per_chunk=64,
              lr=0.01, pass_decay=20, lr_decay=0.2, seed=0,
              rng_impl='threefry2x32', lambda_drop_loss=2e-5,
              lambda_weight_loss=1e-8)
    spec = make_spec(grid_size=8, grid_features=8, hidden=16, num_layers=2,
                     drop_type=drop_type)
    # the initial parameters training() derives from the seed, handed to both
    k_model, _, k_train = jax.random.split(
        jax.random.key(0, impl='threefry2x32'), 3)
    params, aux = init_model(k_model, spec)
    ckpt = str(tmp_path / 'init.npz')
    save_checkpoint(ckpt, params, aux, drop_type)
    info_jax = jax_training(JaxConfig(expname='jax', checkpoint_path=ckpt, **kw),
                            verbose=False, volume_np=vol, write_vols=False)
    N = 256 * 8
    streams = (jax_pos_stream(k_train, 64, N, vol.shape),
               jax_pos_stream(jax.random.fold_in(k_train, 1), 64, N, vol.shape))
    info = training(TrainConfig(expname='port', checkpoint_path=ckpt, **kw),
                    verbose=False, volume_np=vol, write_vols=False, device='cpu',
                    positions=streams)
    return info_jax, info


def _check(info_jax, info, drop_type, rel=0.0):
    assert abs(info['psnr'] - info_jax['psnr']) < 0.05, (info['psnr'], info_jax['psnr'])
    assert info['num_zeros'] == pytest.approx(info_jax['num_zeros'], rel=rel)
    assert info['compression_ratio'] == pytest.approx(info_jax['compression_ratio'],
                                                      rel=rel)
    assert info['num_parameters'] == info_jax['num_parameters']
    if drop_type:
        assert info['num_zeros'] > 0


@pytest.mark.parametrize('drop_type', ['smallify', ''])
def test_training_stream_matched_short(tmp_path, drop_type):
    """6 passes: 64 steps of phase 1, 32 of phase 2."""
    info_jax, info = run_ab(tmp_path, drop_type, 6)
    _check(info_jax, info, drop_type)
    assert info['train_phase1_steps'] == 64 and info['train_phase2_steps'] == 32


@pytest.mark.slow
@pytest.mark.parametrize('drop_type', ['smallify', ''])
def test_training_stream_matched_30_passes(tmp_path, drop_type):
    """Over 30 passes float32 rounding differences between the two
    trajectories flip borderline sign-variance masks: the zero counts agree
    to test_ab_parity.py's 2% (measured 6096.75 vs 6080.75, seed 0)."""
    info_jax, info = run_ab(tmp_path, drop_type, 30)
    _check(info_jax, info, drop_type, rel=0.02)
