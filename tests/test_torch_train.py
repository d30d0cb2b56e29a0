"""The port's trainer against the JAX package's ``train/trainer.py``: one
train step from identical parameters and positions (loss, every gradient,
the Adam-updated parameters, the tracker), the step at which each phase
stops under both lr strategies, the loss terms, the config precedence, and
``train_torch.py`` on the CPU."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import train_torch
from latent_feature_grid_compression_tpu import config as jconfig
from latent_feature_grid_compression_tpu.data.volume import VolumeMeta as JMeta
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.models import gates as jG
from latent_feature_grid_compression_tpu.train import losses as jL
from latent_feature_grid_compression_tpu.train import trainer as jtr
from latent_feature_grid_compression_tpu_torch import config as tconfig
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta as TMeta
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.ops import dwt as tdwt
from latent_feature_grid_compression_tpu_torch.train import losses as tL
from latent_feature_grid_compression_tpu_torch.train import run as trun
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr
from tests.torch_ab import jax_pos_stream
from tests.torch_port_util import to_port

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
            grid_features=8, grid_size=8, wavelet='db2', drop_type='smallify')


def _volume(shape, seed=0):
    vol = np.random.default_rng(seed).uniform(-1, 1, shape)
    return vol.astype(np.float32)


def _setup(seed, shape, phase, **cfg_kw):
    """JAX and port phase specs, states and masks from one init."""
    kw = dict(drop_type='smallify', batch_size=64, sample_size=8, lr=0.01,
              lambda_drop_loss=1e-3, lambda_weight_loss=1e-4, max_pass=30)
    kw.update(cfg_kw)
    jspec = jfg.make_spec(interp_backend='xla', **SPEC)
    tspec = tfg.make_spec(**SPEC)
    jparams, jaux = jfg.init_model(jax.random.key(seed), jspec)
    rng = np.random.default_rng(seed)
    # a tracker part-way through training, so that masks are mixed
    jaux = jG.SmallifyAux(tuple(jnp.asarray(rng.uniform(-1, 1, e.shape), jnp.float32)
                                for e in jaux.ema),
                          tuple(jnp.asarray(rng.uniform(0.5, 1.0, e.shape), jnp.float32)
                                for e in jaux.ema_var))
    model = to_port(jparams, tspec, gate_aux=jaux)
    jph = jtr.make_phase_spec(jconfig.TrainConfig(**kw), jspec, JMeta(shape), phase=phase)
    tph = ttr.make_phase_spec(tconfig.TrainConfig(**kw), tspec, TMeta(shape), phase=phase)
    jmasks = tmasks = None
    if phase == 2:
        _, jmasks, _ = jfg.save_dropvalues_on_grid(jspec, jparams, jaux)
        tmasks = [torch.from_numpy(np.array(m)) for m in jmasks]
    key = jax.random.key(seed + 100)
    jstate = jtr.init_train_state(jparams, None, jaux, lr=kw['lr'], shadow_lr=kw['lr'],
                                  key=key, weight_dkl=kw['lambda_drop_loss'])
    tstate = ttr.init_train_state(model, kw['lr'], kw['lr'], train_gates=phase == 1)
    return jph, tph, jstate, tstate, jmasks, tmasks, key


def _jax_tensors(jparams_like):
    """coeffs, mlp_w ((out, in) like the port), mlp_b, betas as numpy."""
    return ([np.asarray(c) for c in jparams_like.coeffs]
            + [np.asarray(w).T for w in jparams_like.mlp_w]
            + [np.asarray(b) for b in jparams_like.mlp_b]
            + ([np.asarray(b) for b in jparams_like.gates.betas]
               if jparams_like.gates is not None else []))


def _port_tensors(layout, flat):
    p = layout.views(flat)
    return [t.numpy() for t in list(p.coeffs) + list(p.mlp_w) + list(p.mlp_b)
            + list(p.betas or [])]


@pytest.mark.parametrize('phase', [1, 2])
def test_one_step_matches_jax(phase):
    """Loss, every gradient (as Adam's first moment, (1 - b1) * g), the
    Adam-updated parameters and the tracker after one step.  Tolerances:
    float32 with sums taken in another order."""
    shape = (12, 10, 9)
    vol = _volume(shape)
    jph, tph, jstate, tstate, jmasks, tmasks, key = _setup(0, shape, phase)
    _, k_pos, _ = jax.random.split(key, 3)
    pos = np.array(jax.random.randint(k_pos, (1, jph.batch_n, 3), 0,
                                        jnp.asarray(shape, jnp.int32)[None, None]))
    new, metrics = jax.jit(jtr.make_train_step(jph, jmasks))(jstate, jnp.asarray(vol))

    c = ttr.PhaseConstants(tph, torch.from_numpy(vol))
    norm, gt = ttr.chunk_inputs(c, torch.from_numpy(pos))
    loss, vol_loss = ttr.train_step(tph, tstate, c, norm[0], gt[0], tmasks)
    assert tstate.step == int(new.step) == 1
    np.testing.assert_allclose(float(loss), float(metrics['loss']), rtol=1e-5)
    np.testing.assert_allclose(float(vol_loss), float(metrics['volume_loss']), rtol=1e-5)

    _, unravel = ravel_pytree((jstate.params, None))
    n = len(tstate.layout.counts)
    m_jax = _jax_tensors(unravel(new.m)[0])[:n]
    for got, want in zip(_port_tensors(tstate.layout, tstate.m), m_jax):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12))
    # Adam's first step is lr * g / (|g| + eps): where |g| is near eps it
    # passes on the gradient's rounding; 1e-5 is 0.1% of lr
    for got, want in zip(_port_tensors(tstate.layout, tstate.flat),
                         _jax_tensors(new.params)[:n]):
        np.testing.assert_allclose(got, want, atol=1e-5)
    if phase == 1:
        sizes = [int(np.prod(e.shape)) for e in new.gate_aux.ema]
        for flat, want in ((tstate.ema, new.gate_aux.ema),
                           (tstate.ema_var, new.gate_aux.ema_var)):
            # XLA may fuse the multiply-add: one float32 rounding apart
            for got, w in zip(torch.split(flat, sizes), want):
                np.testing.assert_allclose(got.numpy(), np.asarray(w).ravel(),
                                           rtol=0, atol=1.2e-7)


@pytest.mark.parametrize('strategy,phase', [('neurcomp', 1), ('neurcomp', 2),
                                            ('smallify', 1)])
def test_phase_stops_where_jax_stops(strategy, phase):
    """Neurcomp: the budget rules (at 1,728 voxels and 512 samples a step,
    phase 1 ends by the loader-exhaustion rule, phase 2 by the per-step
    rule).  Smallify decay: the plateau stop, which depends on the losses,
    so positions replay the JAX stream."""
    shape = (12, 12, 12)
    vol = _volume(shape, 1)
    kw = dict(batch_size=32, sample_size=4, max_pass=7)
    if strategy == 'smallify':
        kw = dict(batch_size=32, sample_size=4, max_pass=60, smallify_decay=1,
                  lr_decay=0.01)
    jph, tph, jstate, tstate, jmasks, tmasks, key = _setup(1, shape, phase, **kw)
    jfinal = jtr.solve_phase(jph, jstate, jnp.asarray(vol), 32, masks=jmasks,
                             verbose=False)
    losses = []
    tfinal = ttr.solve_phase(tph, tstate, torch.from_numpy(vol), 32, tmasks,
                             positions=jax_pos_stream(key, 32, tph.batch_n, shape),
                             verbose=False, metric_cb=losses.append)
    assert tfinal.step == int(jfinal.step) < tph.t_max
    assert sum(len(x) for x in losses) == tfinal.step
    assert float(tfinal.shadow_lr) == pytest.approx(float(jfinal.shadow_lr), rel=1e-6)
    assert float(tfinal.lr) == pytest.approx(float(jfinal.lr), rel=1e-6)
    # the port's flag holds only the plateau stop; the host applies the
    # budget rules, which JAX also records in its flag
    assert bool(jfinal.stop) and bool(tfinal.stop) == (strategy == 'smallify')
    if strategy == 'neurcomp':
        assert tfinal.step == {1: 54, 2: 41}[phase]


def test_losses_match_jax():
    jspec = jfg.make_spec(**SPEC)
    jparams, _ = jfg.init_model(jax.random.key(3), jspec)
    model = to_port(jparams, tfg.make_spec(**SPEC))
    assert float(tL.grid_l2([c.detach() for c in model.coeffs])) == pytest.approx(
        float(jL.grid_l2(jparams)), rel=1e-6)
    got = tL.smallify_family_loss('smallify', list(model.coeffs), list(model.betas),
                                  1e-3, 1e-4)
    want = jL.smallify_family_loss('smallify', jparams, 1e-3, 1e-4)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    assert tL.smallify_family_loss('smallify', list(model.coeffs), None, 0.0, 0.0) == 0.0


@pytest.mark.parametrize('argv', [
    [], ['--lr', '0.5', '--grid_size', '9'],
    ['--config', 'experiment-config-files/mhd_p_smallify.txt'],
    ['--config', 'experiment-config-files/mhd_p_smallify.txt', '--max_pass', '3',
     '--pruning_threshold_list', '0.5', '0.6', '--drop_type', '']])
def test_config_from_args_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert tconfig.config_from_args(argv).to_dict() == \
        jconfig.config_from_args(argv).to_dict()


def test_decode_copies_its_operators_once():
    """The synthesis matrices are cached on the device: a second decode
    reuses the same tensors (no host-to-device copy on the step)."""
    spec = tfg.make_spec(**SPEC)
    model = tfg.init_model(spec, torch.Generator().manual_seed(0))
    tdwt._synthesis_matrix.cache_clear()
    tfg.decode_volume(model)
    misses = tdwt._synthesis_matrix.cache_info().misses
    tfg.decode_volume(model, train_gates=True)
    info = tdwt._synthesis_matrix.cache_info()
    assert info.misses == misses > 0 and info.hits >= misses


@pytest.mark.parametrize('field,value', [('resume', 'exp'), ('profile_dir', 'p'),
                                         ('mesh_data', 2), ('mesh_space', 2)])
def test_unported_training_options_raise(field, value):
    with pytest.raises(ValueError, match='not yet ported'):
        trun.training(tconfig.TrainConfig(**{field: value}), device='cpu')


def _cli_args(tmp_path, vol_path, *extra):
    return ['--data', vol_path, '--basedir', '/', '--expname', 'run',
            '--max_pass', '6', '--batch_size', '256', '--sample_size', '4',
            '--grid_size', '8', '--grid_features', '4', '--n_hidden_size', '8',
            '--n_layers', '2', '--steps_per_chunk', '16', *extra]


def test_train_torch_cli_on_cpu(tmp_path, monkeypatch, capsys):
    vol_path = str(tmp_path / 'vol.npy')
    np.save(vol_path, _volume((16, 16, 16), 2) * 3.0 + 1.0)
    monkeypatch.chdir(tmp_path)
    info = train_torch.main(_cli_args(tmp_path, vol_path, '--device', 'cpu'))
    exp = tmp_path / 'run'
    for name in ('info.txt', 'config.txt', 'model.npz', 'binary_model_file',
                 'binary_model_file_mask.bnr', 'vol.vti', 'gt.vti'):
        assert (exp / name).exists(), name
    assert np.isfinite(info['psnr']) and info['compression_ratio'] > 0
    # 4,096 voxels at 1,024 samples a step: 4 passes in 16 steps, then 2 in 8
    assert info['train_phase1_steps'] == 16 and info['train_phase2_steps'] == 8
    assert info['train_phase1_last_loss'] < info['train_phase1_first_loss']
    out = capsys.readouterr().out
    assert 'Trained Model:' in out and 'Pass [' in out
    # the experiment's config restores through the port's inference CLI
    cfg = tconfig.load_config(str(exp / 'config.txt'))
    assert cfg.binary_checkpoint_path == str(exp / 'binary_model_file')


def test_train_torch_raises_without_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CUDA default does not raise')
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train_torch.main(_cli_args(tmp_path, str(tmp_path / 'missing.npy')))
    assert not (tmp_path / 'run').exists()
