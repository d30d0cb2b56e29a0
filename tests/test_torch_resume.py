"""Mid-training resume, the profiler trace and the TensorBoard writer of the
port (``io/train_state_io.py``, ``utils/profiling.py``, ``train/trainer.py::
solve_phase``, ``train/run.py``), on the CPU at small widths, held against
the JAX package where it has a counterpart: the train state round-trips
bit for bit with its generators; a phase killed after a chunk and resumed
from its save ends bit for bit where the uninterrupted phase ends; a
resumed ``training()`` gives the uninterrupted run's info; a finished phase
takes no step; a JAX state carried across by ``convert.train_state_from_jax``
continues as JAX continues it; the writer's tags and steps are JAX's.

Every test runs in its own working directory (``tmp_path``), so that the
writer's ``runs/`` lands there."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import train_torch
from latent_feature_grid_compression_tpu import config as jconfig
from latent_feature_grid_compression_tpu import train as jtrain
from latent_feature_grid_compression_tpu.data.volume import VolumeMeta as JMeta
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.models import variance as jV
from latent_feature_grid_compression_tpu.train import trainer as jtr
from latent_feature_grid_compression_tpu_torch import config as tconfig
from latent_feature_grid_compression_tpu_torch.config import write_dict
from latent_feature_grid_compression_tpu_torch.convert import (tensors_from_jax,
                                                               train_state_from_jax,
                                                               variance_from_jax)
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta as TMeta
from latent_feature_grid_compression_tpu_torch.io.train_state_io import (
    TENSOR_FIELDS, load_train_state, save_train_state)
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models import gates as tG
from latent_feature_grid_compression_tpu_torch.models.variance import init_variance_model
from latent_feature_grid_compression_tpu_torch.train import run as trun
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr
from tests.torch_ab import jax_pos_stream
from tests.torch_port_util import to_port

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
            grid_features=8, grid_size=8, wavelet='db2')
SHAPE = (12, 10, 9)
# each family's loss settings (the published configs'; straight-through
# takes masked-ST's) and its gates' momentum and threshold
FAMILY = {
    '': ({}, {}),
    'smallify': (dict(lambda_drop_loss=1e-3, lambda_weight_loss=1e-4), {}),
    'straight_through': (dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8), {}),
    'masked_straight_through': (dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8), {}),
    'static_variational': (dict(lambda_drop_loss=1.0, lambda_weight_loss=2.0,
                                variational_sigma=-7.0, weight_dkl_multiplier=5e-5),
                           dict(drop_momentum=0.1, drop_threshold=0.9)),
    'dynamic_variational': (dict(lambda_drop_loss=0.1, lambda_weight_loss=2.0,
                                 variational_sigma=0.0, weight_dkl_multiplier=3e-5),
                            dict(drop_momentum=0.1, drop_threshold=0.9))}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the runs here are many steps of tiny shapes,
    which threads slow down, and most of all where the suite's workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volume(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _phase(drop_type, phase, **cfg_kw):
    """(phase spec, a function making the phase's fresh state, masks):
    the same init on every call."""
    loss_kw, gate_kw = FAMILY[drop_type]
    kw = dict(batch_size=64, sample_size=8, lr=0.01, max_pass=9, drop_type=drop_type,
              **loss_kw)
    kw.update(cfg_kw)
    cfg = tconfig.TrainConfig(**kw)
    spec = tfg.make_spec(**SPEC, drop_type=drop_type, **gate_kw)
    ph = ttr.make_phase_spec(cfg, spec, TMeta(SHAPE), phase=phase)
    masks = None
    if phase == 2 and drop_type:
        model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
        _, masks, _ = tfg.save_dropvalues_on_grid(model)

    def fresh():
        gen = torch.Generator().manual_seed(0)
        model = tfg.init_model(spec, gen, device='cpu')
        variance = None
        if phase == 1 and tG.is_dynamic(drop_type):
            variance = init_variance_model(gen)
        if phase == 2:
            model, _, _ = tfg.save_dropvalues_on_grid(model)
        return ttr.init_train_state(model, 0.01, 0.01,
                                    train_gates=phase == 1 and bool(drop_type),
                                    variance=variance, weight_dkl=cfg.lambda_drop_loss)
    return ph, fresh, masks


def _generators(seed):
    return (torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1))


def _solve(ph, state, masks, gens, **kw):
    return ttr.solve_phase(ph, state, torch.from_numpy(_volume()), 4, masks,
                           generator=gens[0], noise_generator=gens[1], verbose=False, **kw)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.layout.names == b.layout.names
    for name in TENSOR_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name


# ---------------------------------------------------------------------------
# The state file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('phase', [1, 2])
@pytest.mark.parametrize('drop_type', list(FAMILY))
def test_state_round_trip(drop_type, phase, tmp_path):
    """Every tensor and scalar of a state part-way through its phase, and
    both generators' states, back bit for bit into a fresh template and
    generators seeded otherwise."""
    ph, fresh, masks = _phase(drop_type, phase, max_pass=3)
    gens = _generators(5)
    state = fresh()
    c = ttr.PhaseConstants(ph, torch.from_numpy(_volume()))
    norm, gt = ttr.chunk_inputs(c, ttr.draw_positions(c, 2, ph.batch_n, gens[0]))
    noise = ttr.draw_noise(ph, 2, gens[1], torch.device('cpu'))
    for i in range(2):
        ttr.train_step(ph, state, c, norm[i], gt[i], masks,
                       noise=None if noise is None else [a[i] for a in noise])
    path = str(tmp_path / 'state.npz')
    save_train_state(path, state, gens)
    other = _generators(99)
    loaded = load_train_state(path, fresh(), other)
    _assert_states_equal(loaded, state)
    assert loaded.step == 2 and (loaded.ema is not None) == (drop_type == 'smallify'
                                                             and phase == 1)
    for g, want in zip(other, gens):
        assert torch.equal(g.get_state(), want.get_state())


def test_load_refuses_a_jax_file_and_another_layout(tmp_path):
    ph, fresh, _ = _phase('smallify', 1)
    path = str(tmp_path / 'jax.npz')
    np.savez(path, leaf_0=np.zeros(3))
    with pytest.raises(ValueError, match='JAX package'):
        load_train_state(path, fresh())
    path = str(tmp_path / 'state.npz')
    save_train_state(path, fresh())
    _, fresh2, _ = _phase('smallify', 2)
    with pytest.raises(ValueError, match='layout'):
        load_train_state(path, fresh2())
    with pytest.raises(ValueError, match='generator 0'):
        load_train_state(path, fresh(), _generators(0))


# ---------------------------------------------------------------------------
# A phase killed after a chunk, resumed from its save
# ---------------------------------------------------------------------------

class Killed(Exception):
    pass


def _kill_after(n_chunks, sink):
    def cb(losses):
        sink.append(losses)
        if len(sink) == n_chunks:
            raise Killed
    return cb


@pytest.mark.parametrize('drop_type,phase,cfg_kw', [
    pytest.param('smallify', 1, {}, id='smallify'),
    pytest.param('smallify', 1, dict(max_pass=60, smallify_decay=1, lr_decay=0.01),
                 id='smallify-plateau-stop'),
    pytest.param('straight_through', 1, {}, id='straight_through'),
    pytest.param('dynamic_variational', 1, {}, id='dynamic_variational'),
    pytest.param('smallify', 2, {}, id='phase2')])
@pytest.mark.parametrize('kill_after', [1, 3])
def test_mid_phase_resume_is_bit_exact(drop_type, phase, cfg_kw, kill_after, tmp_path):
    """A phase killed after chunk k (a metric callback that raises stands
    in for the kill; saves after every chunk) and resumed from its file
    with generators seeded otherwise: the final state and every loss equal
    the uninterrupted phase's bit for bit (straight-through draws uniform
    noise, the dynamic family normal noise and has the variance model in
    its layout)."""
    ph, fresh, masks = _phase(drop_type, phase, **dict(dict(max_pass=24), **cfg_kw))
    whole = []
    final = _solve(ph, fresh(), masks, _generators(7), metric_cb=whole.append)
    assert len(whole) > kill_after + 1
    assert bool(final.stop) == ('smallify_decay' in cfg_kw)

    path = str(tmp_path / 'state.npz')
    before = []
    with pytest.raises(Killed):
        _solve(ph, fresh(), masks, _generators(7), state_save_path=path, save_every_s=0.0,
               metric_cb=_kill_after(kill_after, before))
    gens = _generators(123)
    state = load_train_state(path, fresh(), gens)
    after = []
    resumed = _solve(ph, state, masks, gens, metric_cb=after.append)
    _assert_states_equal(resumed, final)
    np.testing.assert_array_equal(np.concatenate(before + after), np.concatenate(whole))


def test_finished_phase_takes_no_step(tmp_path):
    """A state saved at the end of its phase (budget or plateau stop), run
    again, takes no step and launches nothing."""
    for cfg_kw in ({}, dict(max_pass=60, smallify_decay=1, lr_decay=0.01)):
        ph, fresh, _ = _phase('smallify', 1, **cfg_kw)
        path = str(tmp_path / 'end.npz')
        final = _solve(ph, fresh(), None, _generators(3), state_save_path=path)
        assert ph.budget_stop(final.step, ph.passes(final.step)[0]) != bool(final.stop)
        assert ttr.phase_done(ph, final)
        state = load_train_state(path, fresh())
        called = []
        again = _solve(ph, state, None, _generators(3), metric_cb=called.append)
        assert again.step == final.step and called == []
        _assert_states_equal(again, final)
    assert not ttr.phase_done(ph, fresh())


# ---------------------------------------------------------------------------
# training() and the CLI
# ---------------------------------------------------------------------------

def _cfg(expname, **kw):
    d = dict(expname=expname, basedir='/', drop_type='smallify', max_pass=9,
             batch_size=128, sample_size=8, grid_size=8, grid_features=4,
             n_hidden_size=8, n_layers=2, steps_per_chunk=8, lambda_drop_loss=3e-5)
    d.update(kw)
    return tconfig.TrainConfig(**d)


def _train(cfg):
    return trun.training(cfg, verbose=False, volume_np=_volume((16, 16, 16), 2),
                         write_vols=False, device='cpu')


def _model_info(info):
    return {k: v for k, v in info.items() if not k.startswith('train_')}


def _phase_info(info, phase):
    return {k: v for k, v in info.items() if k.startswith(f'train_phase{phase}_')
            and not k.endswith(('_seconds', '_samples_per_sec'))}


@pytest.mark.parametrize('phase', [1, 2])
def test_training_resumes_a_finished_phase(phase):
    """``training()`` resumed at phase 1 or 2 of a finished run: that
    phase takes no step, phase 2 (rerun after phase 1, from the same
    generator state) ends where it ended, and the info (PSNR, zeros, ratio,
    ...) is the uninterrupted run's."""
    info = _train(_cfg('a'))
    exp = trun.experiment_dir(_cfg('a'))
    for name in ('train_state_phase1.npz', 'train_state_phase2.npz', 'bake.npz'):
        assert os.path.exists(os.path.join(exp, name))
    assert tconfig.dict_from_file(os.path.join(exp, 'resume_meta.txt')) == {'phase': 'done'}
    write_dict({'phase': phase}, 'resume_meta.txt', exp)
    again = _train(_cfg('b', resume=exp))
    assert again[f'train_phase{phase}_steps'] == 0
    assert _model_info(again) == _model_info(info)
    if phase == 1:
        assert _phase_info(again, 2) == _phase_info(info, 2)
    else:
        assert 'train_phase1_steps' not in again


@pytest.mark.parametrize('phase', [1, 2])
def test_training_killed_mid_phase_resumes_bit_exact(phase, monkeypatch):
    """A run killed after its second chunk of phase 1 or 2 (saves after
    every chunk) and resumed ends with the uninterrupted run's info."""
    info = _train(_cfg('a', max_pass=18))
    solve = ttr.solve_phase

    def killing(ph, *a, metric_cb=None, **kw):
        seen = []

        def cb(losses):
            metric_cb(losses)
            seen.append(losses)
            if ph.drop_type == ('smallify' if phase == 1 else '') and len(seen) == 2:
                raise Killed
        return solve(ph, *a, metric_cb=cb, **dict(kw, save_every_s=0.0))
    monkeypatch.setattr(trun, 'solve_phase', killing)
    with pytest.raises(Killed):
        _train(_cfg('b', max_pass=18))
    monkeypatch.setattr(trun, 'solve_phase', solve)
    exp = trun.experiment_dir(_cfg('b'))
    assert tconfig.dict_from_file(os.path.join(exp, 'resume_meta.txt')) == {'phase': phase}
    again = _train(_cfg('c', max_pass=18, resume=exp))
    assert again[f'train_phase{phase}_steps'] == info[f'train_phase{phase}_steps'] - 16
    assert _model_info(again) == _model_info(info)
    assert _phase_info(again, 2)['train_phase2_last_loss'] == info['train_phase2_last_loss']


def test_resume_of_a_finished_run_raises():
    _train(_cfg('a', max_pass=3))
    with pytest.raises(ValueError, match='finished training'):
        _train(_cfg('b', resume=trun.experiment_dir(_cfg('a'))))


def test_cli_passes_resume_profile_and_writer_options(tmp_path, monkeypatch):
    """``--resume``, ``--profile_dir`` and ``--Tensorboard_log_dir`` reach
    ``training()`` as given; a run with the last two writes the trace (of
    phase 1's second chunk) and the event file with the config beside it,
    and its resume at phase 2 takes no step and gives its PSNR."""
    vol_path = str(tmp_path / 'vol.npy')
    np.save(vol_path, _volume((16, 16, 16), 2))
    argv = ['--data', vol_path, '--basedir', '/', '--max_pass', '6', '--batch_size', '128',
            '--sample_size', '8', '--grid_size', '8', '--grid_features', '4',
            '--n_hidden_size', '8', '--n_layers', '2', '--steps_per_chunk', '8',
            '--device', 'cpu']
    seen = []
    monkeypatch.setattr(train_torch, 'training', lambda cfg, **kw: seen.append(cfg) or {})
    train_torch.main(argv + ['--resume', 'r/', '--profile_dir', 'p', '--Tensorboard_log_dir',
                             't'])
    assert (seen[0].resume, seen[0].profile_dir, seen[0].Tensorboard_log_dir) == ('r/', 'p', 't')
    monkeypatch.setattr(train_torch, 'training', trun.training)
    info = train_torch.main(argv + ['--expname', 'a', '--profile_dir', str(tmp_path / 'p'),
                                    '--Tensorboard_log_dir', str(tmp_path / 't')])
    traces = [f for f in os.listdir(tmp_path / 'p') if f.endswith('.pt.trace.json')]
    assert len(traces) == 1
    with open(tmp_path / 'p' / traces[0]) as f:
        assert json.load(f)['traceEvents']
    logged = os.listdir(tmp_path / 't')
    assert 'config.txt' in logged and any(f.startswith('events.out.tfevents') for f in logged)
    exp = str(tmp_path / 'a')
    write_dict({'phase': 2}, 'resume_meta.txt', exp)
    again = train_torch.main(argv + ['--expname', 'b', '--resume', exp])
    assert again['train_phase2_steps'] == 0 and again['psnr'] == info['psnr']


# ---------------------------------------------------------------------------
# A JAX state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('drop_type,phase', [('smallify', 1), ('smallify', 2),
                                             ('dynamic_variational', 1)])
def test_jax_state_continues_as_jax_continues(drop_type, phase):
    """A JAX state after one chunk of 4 steps, through
    ``train_state_from_jax``, takes the next step on JAX's positions (and
    gate noise) as JAX's own step from it does, within
    test_one_step_matches_jax's tolerances (float32 sums in another
    order): the loss, Adam's first moment, the parameters, the tracker."""
    loss_kw, gate_kw = FAMILY[drop_type]
    kw = dict(batch_size=64, sample_size=8, lr=0.01, max_pass=30, drop_type=drop_type,
              **loss_kw)
    spec_kw = dict(SPEC, drop_type=drop_type, **gate_kw)
    jspec = jfg.make_spec(**spec_kw, interp_backend='xla')
    tspec = tfg.make_spec(**spec_kw)
    jparams, jaux = jfg.init_model(jax.random.key(0), jspec)
    var = jV.init_variance_model(jax.random.key(1), 3, 1, 4, 32) \
        if tG.is_dynamic(drop_type) else None
    vol = _volume()
    jmasks = None
    if phase == 2:
        jparams, jmasks, _ = jfg.save_dropvalues_on_grid(jspec, jparams, jaux)
    jph = jtr.make_phase_spec(jconfig.TrainConfig(**kw), jspec, JMeta(SHAPE), phase=phase)
    tph = ttr.make_phase_spec(tconfig.TrainConfig(**kw), tspec, TMeta(SHAPE), phase=phase)
    jstate = jtr.init_train_state(jparams, var, jaux, lr=0.01, shadow_lr=0.01,
                                  key=jax.random.key(100),
                                  weight_dkl=kw['lambda_drop_loss'])
    jstate, _ = jtr.make_chunk_runner(jph, jmasks, 4)(jstate, jnp.asarray(vol))
    assert int(jstate.step) == 4
    new, metrics = jax.jit(jtr.make_train_step(jph, jmasks))(jstate, jnp.asarray(vol))

    def np_tuple(ts):
        return [np.asarray(t) for t in ts]
    gates = None
    if jstate.params.gates is not None:
        gates = {f: np_tuple(getattr(jstate.params.gates, f))
                 for f in tG.trainable_fields(drop_type)}
    jvar = None if jstate.var_params is None else {
        k: np_tuple(jstate.var_params[k]) for k in ('w', 'b')}
    model = to_port(jstate.params, tspec)
    tvar = None
    if phase == 1 and jvar is not None:
        tvar = variance_from_jax(jvar['w'], jvar['b'], device='cpu')
    template = ttr.init_train_state(model, 0.5, 0.5, train_gates=phase == 1,
                                    variance=tvar)
    aux = None if jstate.gate_aux is None else (np_tuple(jstate.gate_aux.ema),
                                                 np_tuple(jstate.gate_aux.ema_var))
    tstate = train_state_from_jax(
        template, params=(np_tuple(jstate.params.coeffs), np_tuple(jstate.params.mlp_w),
                          np_tuple(jstate.params.mlp_b), gates),
        var_params=jvar, m=np.asarray(jstate.m), v=np.asarray(jstate.v),
        step=jstate.step, lr=jstate.lr, shadow_lr=jstate.shadow_lr,
        last_loss=jstate.last_loss, no_gain=jstate.no_gain, stop=jstate.stop,
        weight_dkl=jstate.weight_dkl, gate_aux=aux)
    assert tstate.step == 4 and float(tstate.lr) == float(jstate.lr)

    pos = next(jax_pos_stream(jstate.key, 1, tph.batch_n, SHAPE))[None]
    noise = None
    if tG.noise_kind(drop_type):
        # a single step's gate key is the split's third, not a chunk's split
        _, _, k_gate = jax.random.split(jstate.key, 3)
        keys = jax.random.split(k_gate, len(jstate.params.coeffs))
        noise = [torch.from_numpy(np.array(jax.random.normal(k, c.shape[1:])))
                 for k, c in zip(keys, jstate.params.coeffs)]
    c = ttr.PhaseConstants(tph, torch.from_numpy(vol))
    norm, gt = ttr.chunk_inputs(c, torch.from_numpy(np.array(pos)))
    tmasks = None if jmasks is None else [torch.from_numpy(np.array(m)) for m in jmasks]
    loss, _ = ttr.train_step(tph, tstate, c, norm[0], gt[0], tmasks, noise=noise)
    np.testing.assert_allclose(float(loss), float(metrics['loss']), rtol=1e-5)
    assert tstate.step == int(new.step) == 5

    _, unravel = ravel_pytree((jstate.params, jstate.var_params))
    jm, jvm = unravel(new.m)
    names = tstate.layout.names
    trained = gates if phase == 1 else None

    def port_order(p, v, like_gates):
        g = None if like_gates is None else {
            f: np_tuple(getattr(p.gates, f)) for f in like_gates}
        return tensors_from_jax(names, np_tuple(p.coeffs), np_tuple(p.mlp_w),
                                np_tuple(p.mlp_b), g,
                                None if v is None else {k: np_tuple(v[k]) for k in ('w', 'b')})
    for got, want in zip(torch.split(tstate.m, tstate.layout.counts),
                         port_order(jm, jvm if 'var_w' in names else None, trained)):
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12))
    for got, want in zip(torch.split(tstate.flat, tstate.layout.counts),
                         port_order(new.params, new.var_params if 'var_w' in names else None,
                                    trained)):
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want, atol=1e-5)
    if tstate.ema is not None:
        np.testing.assert_allclose(
            tstate.ema.numpy(), np.concatenate([np.asarray(e).ravel()
                                                for e in new.gate_aux.ema]),
            rtol=0, atol=1.2e-7)


def test_jax_state_stopped_by_its_budget_takes_no_step():
    """JAX records its budget stop in the state's flag: carried across, the
    port's phase takes no step either."""
    kw = dict(batch_size=64, sample_size=8, lr=0.01, max_pass=3, drop_type='')
    jspec = jfg.make_spec(**SPEC, drop_type='', interp_backend='xla')
    tspec = tfg.make_spec(**SPEC, drop_type='')
    jparams, _ = jfg.init_model(jax.random.key(0), jspec)
    vol = _volume()
    jph = jtr.make_phase_spec(jconfig.TrainConfig(**kw), jspec, JMeta(SHAPE), phase=1)
    tph = ttr.make_phase_spec(tconfig.TrainConfig(**kw), tspec, TMeta(SHAPE), phase=1)
    jstate = jtr.init_train_state(jparams, None, None, lr=0.01, shadow_lr=0.01,
                                  key=jax.random.key(1), weight_dkl=0.0)
    jstate = jtr.solve_phase(jph, jstate, jnp.asarray(vol), 4, verbose=False)
    assert bool(jstate.stop)
    template = ttr.init_train_state(to_port(jstate.params, tspec), 0.01, 0.01,
                                    train_gates=False)
    p = jstate.params
    tstate = train_state_from_jax(
        template, params=(p.coeffs, p.mlp_w, p.mlp_b, None), m=np.asarray(jstate.m),
        v=np.asarray(jstate.v), step=jstate.step, lr=jstate.lr,
        shadow_lr=jstate.shadow_lr, last_loss=jstate.last_loss, no_gain=jstate.no_gain,
        stop=jstate.stop, weight_dkl=jstate.weight_dkl)
    assert bool(tstate.stop) and int(tstate.stop_step) == tstate.step == int(jstate.step)
    flat = tstate.flat.clone()
    called = []
    out = _solve(tph, tstate, None, _generators(0), metric_cb=called.append)
    assert out.step == int(jstate.step) and called == [] and torch.equal(out.flat, flat)


# ---------------------------------------------------------------------------
# The TensorBoard writer
# ---------------------------------------------------------------------------

def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(log_dir), size_guidance={'scalars': 0, 'histograms': 0},
                           purge_orphaned_data=False)
    acc.Reload()
    return acc


@pytest.mark.parametrize('drop_type', ['smallify', 'static_variational'])
def test_writer_tags_and_steps_match_jax(drop_type, tmp_path):
    """One config through the JAX trainer and the port: the same scalar
    tags (each step's losses, the evaluation's scalars) at the same steps,
    and the variational drop-rate histograms."""
    loss_kw, gate_kw = FAMILY[drop_type]
    kw = dict(expname='w', basedir='/', drop_type=drop_type, max_pass=6, batch_size=128,
              sample_size=8, grid_size=8, grid_features=4, n_hidden_size=8, n_layers=2,
              steps_per_chunk=8, lr=0.01, **loss_kw, **gate_kw)
    vol = _volume((16, 16, 16), 2)
    jtrain.training(jconfig.TrainConfig(**kw, Tensorboard_log_dir=str(tmp_path / 'jax')),
                    verbose=False, volume_np=vol, write_vols=False)
    trun.training(tconfig.TrainConfig(**kw, Tensorboard_log_dir=str(tmp_path / 'port')),
                  verbose=False, volume_np=vol, write_vols=False, device='cpu')
    want, got = _events(tmp_path / 'jax'), _events(tmp_path / 'port')
    tags = sorted(want.Tags()['scalars'])
    assert tags == sorted(got.Tags()['scalars'])
    assert ('DKL_loss' in tags) == ('variational' in drop_type) and 'loss' in tags
    for tag in tags:
        steps = sorted(e.step for e in got.Scalars(tag))
        assert steps == sorted(e.step for e in want.Scalars(tag)), tag
    assert sorted(got.Tags()['histograms']) == sorted(want.Tags()['histograms'])
    assert ('droprates_layer_0' in got.Tags()['histograms']) == ('variational' in drop_type)


@pytest.mark.parametrize('drop_type,phase', [('smallify', 1), ('dynamic_variational', 1),
                                             ('smallify', 2)])
def test_writer_values_are_the_steps_losses(drop_type, phase, tmp_path):
    """The written 'loss' and 'volume_loss' of each step are the losses
    the metric callbacks get, at steps 1..n; the other terms are written
    at the same steps (the variational ones, or the drop loss, 0 in phase
    2); a run with the writer takes the steps of a run without."""
    from tensorboardX import SummaryWriter
    ph, fresh, masks = _phase(drop_type, phase)
    losses, vol_losses = [], []
    writer = SummaryWriter(str(tmp_path / 'tb'))
    with_writer = _solve(ph, fresh(), masks, _generators(4), writer=writer,
                         metric_cb=losses.append, volume_cb=vol_losses.append)
    writer.close()
    without = _solve(ph, fresh(), masks, _generators(4))
    _assert_states_equal(with_writer, without)
    acc = _events(tmp_path / 'tb')
    n = with_writer.step
    for tag, values in (('loss', losses), ('volume_loss', vol_losses)):
        events = acc.Scalars(tag)
        assert [e.step for e in events] == list(range(1, n + 1))
        np.testing.assert_array_equal(np.array([e.value for e in events], np.float32),
                                      np.concatenate(values).astype(np.float32))
    others = (['Log_Likelyhood_loss', 'DKL_loss', 'Weight_loss']
              if ph.variational else ['drop_loss'])
    assert sorted(acc.Tags()['scalars']) == sorted(['loss', 'volume_loss'] + others)
    for tag in others:
        assert [e.step for e in acc.Scalars(tag)] == list(range(1, n + 1))
    if phase == 2:
        assert all(e.value == 0.0 for e in acc.Scalars('drop_loss'))
    assert ('droprates_layer_0' in acc.Tags()['histograms']) == ph.variational


def test_make_writer_logs_where_jax_logs(tmp_path):
    """Without a log dir, ``runs/<expname>`` under the working directory;
    with one, there, with the config beside it."""
    w = trun._make_writer(tconfig.TrainConfig(expname='x'))
    w.close()
    assert os.listdir(tmp_path / 'runs' / 'x')
    w = trun._make_writer(tconfig.TrainConfig(expname='x', Tensorboard_log_dir=str(tmp_path / 't')))
    w.close()
    assert 'config.txt' in os.listdir(tmp_path / 't')


def test_without_tensorboard_the_writer_is_none(monkeypatch):
    """Neither tensorboardX nor torch.utils.tensorboard importable: no
    writer, and the run is the run with one."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, 'tensorboardX', None)
        m.setitem(sys.modules, 'torch.utils.tensorboard', None)
        assert trun._make_writer(tconfig.TrainConfig(expname='x')) is None
        without = _train(_cfg('a', max_pass=3))
    with_writer = _train(_cfg('b', max_pass=3))
    assert not os.path.exists('runs/a') and os.listdir('runs/b')
    assert _model_info(without) == _model_info(with_writer)


def test_failed_writes_and_saves_raise(tmp_path):
    """A writer that fails, or a state file that cannot be written, raises
    out of the phase."""
    class Broken:
        def add_scalar(self, *a):
            raise OSError('disk full')
    ph, fresh, _ = _phase('smallify', 1)
    with pytest.raises(OSError, match='disk full'):
        _solve(ph, fresh(), None, _generators(0), writer=Broken())
    with pytest.raises(OSError):
        _solve(ph, fresh(), None, _generators(0),
               state_save_path=str(tmp_path / 'missing' / 'state.npz'))
