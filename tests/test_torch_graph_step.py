"""The port's chunk runner (``train/trainer.py::ChunkRunner``, the
counterpart of the JAX trainer's ``_scan_chunk`` and ``make_chunk_runner``)
on the CPU at small widths: its step (written in place, selected by a step
counter on the device, always guarded, inputs from static buffers) run
eagerly equals the host-rule loop ``solve_phase`` ran before it (each step's
inputs, bias corrections, guard and lr strategy decided on the host) bit for
bit, through pass boundaries and a plateau stop; ``solve_phase`` matches
the JAX package's ``solve_phase`` (its ``make_chunk_runner``) on JAX's
position and noise streams; and the launch counts of captured steps (the
capture stubbed at its one seam, ``capture_graph``) equal the eager ones."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu import config as jconfig
from latent_feature_grid_compression_tpu.data.volume import VolumeMeta as JMeta
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.models import variance as jV
from latent_feature_grid_compression_tpu.train import trainer as jtr
from latent_feature_grid_compression_tpu_torch import config as tconfig
from latent_feature_grid_compression_tpu_torch.convert import variance_from_jax
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta as TMeta
from latent_feature_grid_compression_tpu_torch.io.train_state_io import TENSOR_FIELDS
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models import gates as tG
from latent_feature_grid_compression_tpu_torch.models.variance import init_variance_model
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import launch_counts
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr
from tests.torch_ab import jax_gate_noise_stream, jax_pos_stream
from tests.torch_port_util import jax_gate_uniform_stream, to_port

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
            grid_features=8, grid_size=8, wavelet='db2')
SHAPE = (12, 10, 9)
FAMILIES = ('smallify', 'straight_through', 'masked_straight_through',
            'static_variational', 'dynamic_variational')
# each family's loss settings (the published configs'; straight-through
# takes masked-ST's) and its gates' momentum and threshold
FAMILY = {
    'smallify': (dict(lambda_drop_loss=1e-3, lambda_weight_loss=1e-4), {}),
    'straight_through': (dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8), {}),
    'masked_straight_through': (dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8), {}),
    'static_variational': (dict(lambda_drop_loss=1.0, lambda_weight_loss=2.0,
                                variational_sigma=-7.0, weight_dkl_multiplier=5e-5),
                           dict(drop_momentum=0.1, drop_threshold=0.9)),
    'dynamic_variational': (dict(lambda_drop_loss=0.1, lambda_weight_loss=2.0,
                                 variational_sigma=0.0, weight_dkl_multiplier=3e-5),
                            dict(drop_momentum=0.1, drop_threshold=0.9))}
# SmallifyDecayStrategy at every boundary without a new best loss, a
# hundredth of the lr each time: from 0.01 the shadow lr is at the stop's
# 1e-7 after 4 plateaus, so the phase stops at a data-dependent step
PLATEAU = dict(smallify_decay=1, lr_decay=0.01)
# NeurcompDecayStrategy: the lrs halved every 2 passes
NEURCOMP = dict(pass_decay=2, lr_decay=0.5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: many steps of tiny shapes, on cores the suite's
    workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volume(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _phase(drop_type, phase, **cfg_kw):
    """(phase spec, a function making the phase's fresh state, masks): the
    same init on every call."""
    loss_kw, gate_kw = FAMILY[drop_type]
    kw = dict(batch_size=32, sample_size=4, lr=0.01, max_pass=60, drop_type=drop_type,
              **loss_kw)
    kw.update(cfg_kw)
    cfg = tconfig.TrainConfig(**kw)
    spec = tfg.make_spec(**SPEC, drop_type=drop_type, **gate_kw)
    ph = ttr.make_phase_spec(cfg, spec, TMeta(SHAPE), phase=phase)
    masks = None
    if phase == 2:
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
        return ttr.init_train_state(model, cfg.lr, cfg.lr, train_gates=phase == 1,
                                    variance=variance, weight_dkl=cfg.lambda_drop_loss)
    return ph, fresh, masks


def _generators():
    return torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)


def _host_rule_phase(ph, st, vol, steps_per_chunk, masks, gens):
    """The loop ``solve_phase`` ran before the chunk runner: a chunk's draws
    indexed on the host a step at a time, ``train_step`` without ``at``
    (the bias corrections, the lr strategy and the Neurcomp decay by the
    host's pass accounting), the guard on after a smallify-decay boundary,
    the stop flag read once a chunk.  Returns the kept steps' (losses,
    volume losses)."""
    c = ttr.PhaseConstants(ph, vol)
    losses, vol_losses, stopped = [], [], False
    while st.step < ph.t_max and not stopped:
        n = min(steps_per_chunk, ph.t_max - st.step)
        norm, gt = ttr.chunk_inputs(c, ttr.draw_positions(c, n, ph.batch_n, gens[0]))
        noise = (ttr.draw_noise(ph, n, gens[1], vol.device)
                 if tG.noise_kind(ph.drop_type) else None)
        start, guard, got = st.step, False, []
        for i in range(n):
            got.append(ttr.train_step(ph, st, c, norm[i], gt[i], masks, guard,
                                      None if noise is None else [a[i] for a in noise]))
            cur, boundary = ph.passes(st.step)
            guard = guard or (boundary and ph.use_smallify_decay)
            if ph.budget_stop(st.step, cur):
                stopped = True
                break
        if bool(st.stop):
            stopped = True
            st.step = int(st.stop_step)
        k = st.step - start
        losses += [float(loss) for loss, _ in got[:k]]
        vol_losses += [float(v) for _, v in got[:k]]
    return losses, vol_losses


def _runner_phase(ph, st, vol, steps_per_chunk, masks, gens, **kw):
    losses, vol_losses = [], []
    st = ttr.solve_phase(ph, st, vol, steps_per_chunk, masks, generator=gens[0],
                         noise_generator=gens[1], verbose=False,
                         metric_cb=losses.append, volume_cb=vol_losses.append, **kw)
    return st, [float(x) for x in np.concatenate(losses)], \
        [float(x) for x in np.concatenate(vol_losses)]


def _assert_states_equal(a, b):
    assert a.step == b.step
    for name in TENSOR_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        assert x is None or (x.dtype == y.dtype and torch.equal(x, y)), name


@pytest.mark.parametrize('strategy', ['plateau', 'neurcomp'])
@pytest.mark.parametrize('phase', [1, 2])
@pytest.mark.parametrize('drop_type', FAMILIES)
def test_runner_step_equals_the_host_rule_loop_bit_for_bit(drop_type, phase, strategy):
    """The same phase through ``solve_phase`` (the chunk runner's step,
    eagerly) and through the host-rule loop, from the same state and
    generators, in chunks of 5 steps (a pass is 8.4 steps, so boundaries
    and the stop fall inside chunks): every loss and volume loss, the step,
    and every tensor of the final state (flat, m, v, lr, shadow lr, stop,
    stop step, the plateau state, the KL weight, the tracker) bit for bit.
    Under the plateau strategy the phase ends by its stop."""
    ph, fresh, masks = _phase(drop_type, phase, **(PLATEAU if strategy == 'plateau'
                                                    else dict(NEURCOMP, max_pass=9)))
    vol = torch.from_numpy(_volume())
    ref = fresh()
    want = _host_rule_phase(ph, ref, vol, 5, masks, _generators())
    got_state, *got = _runner_phase(ph, fresh(), vol, 5, masks, _generators())
    assert got == list(want)
    _assert_states_equal(got_state, ref)
    if strategy == 'plateau':
        assert bool(ref.stop) and ref.step == int(ref.stop_step) < ph.t_max
        assert float(ref.shadow_lr) <= ph.lr_stop
    else:
        assert not bool(ref.stop) and float(ref.shadow_lr) < 0.01


def test_step_flags_are_the_host_pass_accounting():
    """``PhaseSpec.step_flags`` (the table the runner's step reads on the
    device) against ``passes`` at every step, for both strategies and a
    batch that does not divide the volume."""
    for kw in (dict(smallify_decay=1), NEURCOMP, dict(pass_decay=3, batch_size=48)):
        ph, _, _ = _phase('smallify', 1, **kw)
        boundary, factor = ph.step_flags()
        assert len(boundary) == ph.t_max + 1 and factor.dtype == np.float32
        for t in range(1, ph.t_max + 2):
            cur, crossed = ph.passes(t)
            decays = crossed and not ph.use_smallify_decay and (cur + 1) % ph.pass_decay == 0
            assert boundary[t - 1] == crossed
            assert factor[t - 1] == (np.float32(ph.lr_decay) if decays else 1.0)
        assert boundary.sum() >= 5 and (factor != 1).any() == (not ph.use_smallify_decay)


def _jax_phase_1(drop_type, **cfg_kw):
    """JAX's and the port's phase-1 spec and state from one init (gates
    moved off their init, as part-way through training)."""
    loss_kw, gate_kw = FAMILY[drop_type]
    kw = dict(batch_size=32, sample_size=4, lr=0.01, max_pass=9, drop_type=drop_type,
              **loss_kw)
    kw.update(cfg_kw)
    jspec = jfg.make_spec(**SPEC, drop_type=drop_type, interp_backend='xla', **gate_kw)
    tspec = tfg.make_spec(**SPEC, drop_type=drop_type, **gate_kw)
    jparams, jaux = jfg.init_model(jax.random.key(0), jspec)
    if drop_type != 'straight_through':
        rng = np.random.default_rng(0)
        jparams = jparams.replace(gates=jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
            jparams.gates))
    var = tvar = None
    if tG.is_dynamic(drop_type):
        var = jV.init_variance_model(jax.random.key(1), 3, 1, 4, 32)
        tvar = variance_from_jax([np.asarray(w) for w in var['w']],
                                 [np.asarray(b) for b in var['b']], device='cpu')
    jph = jtr.make_phase_spec(jconfig.TrainConfig(**kw), jspec, JMeta(SHAPE), phase=1)
    tph = ttr.make_phase_spec(tconfig.TrainConfig(**kw), tspec, TMeta(SHAPE), phase=1)
    key = jax.random.key(100)
    w0 = kw['lambda_drop_loss']
    jstate = jtr.init_train_state(jparams, var, jaux, lr=0.01, shadow_lr=0.01, key=key,
                                  weight_dkl=w0)
    tstate = ttr.init_train_state(to_port(jparams, tspec, gate_aux=jaux), 0.01, 0.01,
                                  train_gates=True, variance=tvar, weight_dkl=w0)
    return jph, tph, jstate, tstate, key, jparams


@pytest.mark.parametrize('drop_type,strategy', [(d, 'neurcomp') for d in FAMILIES]
                         + [('smallify', 'plateau')])
def test_solve_phase_matches_jax_chunk_runner(drop_type, strategy):
    """Phase 1 of each family through the port's ``solve_phase`` and the
    JAX package's (``make_chunk_runner``: one jitted scan a chunk of 4
    steps), the port replaying JAX's position and gate-noise streams: the
    steps taken, the lr and shadow lr after the Neurcomp decays or the
    plateau stop (rel 1e-6), and every step's loss and volume loss (rtol
    1e-5: float32 sums in another order), as
    tests/test_torch_train.py holds one step and the stop."""
    cfg_kw = NEURCOMP if strategy == 'neurcomp' else dict(PLATEAU, max_pass=60)
    jph, tph, jstate, tstate, key, jparams = _jax_phase_1(drop_type, **cfg_kw)
    vol = _volume()
    jlosses, jvol = [], []

    def jcb(metrics):
        live = np.asarray(metrics['lr']) > 0
        jlosses.extend(np.asarray(metrics['loss'])[live])
        jvol.extend(np.asarray(metrics['volume_loss'])[live])
    jfinal = jtr.solve_phase(jph, jstate, jnp.asarray(vol), 4, metric_cb=jcb,
                             verbose=False)
    shapes = [c.shape[1:] for c in jparams.coeffs]
    noise = {'straight_through': jax_gate_uniform_stream,
             'static_variational': jax_gate_noise_stream,
             'dynamic_variational': jax_gate_noise_stream}.get(drop_type)
    losses, vol_losses = [], []
    tfinal = ttr.solve_phase(tph, tstate, torch.from_numpy(vol), 4,
                             positions=jax_pos_stream(key, 4, tph.batch_n, SHAPE),
                             gate_noise=None if noise is None else noise(key, 4, shapes),
                             verbose=False, metric_cb=losses.append,
                             volume_cb=vol_losses.append)
    assert tfinal.step == int(jfinal.step) < tph.t_max
    assert float(tfinal.lr) == pytest.approx(float(jfinal.lr), rel=1e-6)
    assert float(tfinal.shadow_lr) == pytest.approx(float(jfinal.shadow_lr), rel=1e-6)
    assert float(tfinal.shadow_lr) < 0.01
    np.testing.assert_allclose(np.concatenate(losses), jlosses, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate(vol_losses), jvol, rtol=1e-5)
    assert bool(tfinal.stop) == (strategy == 'plateau')


@pytest.mark.parametrize('drop_type', ['smallify', 'dynamic_variational'])
def test_replays_count_the_captured_launches(drop_type, monkeypatch):
    """Graphed steps with the capture stubbed at ``capture_graph``: the
    stub runs the warm-up (on the runner's scratch state), then the step
    once as the capture (whose effects on the state it takes back) and
    returns a replay that runs the step with the wrappers' counts held, as
    a graph's replay calls no wrapper.  A step stands in for two kernel
    launches (fetch and gradient).  The wrappers' counts after the phase
    equal an eager phase's (one each a step), the warm-up is counted apart,
    and the states and losses are bit for bit the eager ones."""
    ph, fresh, masks = _phase(drop_type, 1, **NEURCOMP, max_pass=6)
    vol = torch.from_numpy(_volume())
    step = ttr.train_step

    def counted_step(*a, **k):
        gs.launches += 1
        gs.bwd_launches += 1
        return step(*a, **k)
    monkeypatch.setattr(ttr, 'train_step', counted_step)

    def run(graphs, state):
        launch_counts.write((0,) * len(launch_counts.COUNTERS))
        got = _runner_phase(ph, state, vol, 7, masks, _generators(), graphs=graphs)
        return got, launch_counts.read()

    captures = []

    def fake_capture(warm, capture_step, error_mode, device):
        assert error_mode == 'global' and device == vol.device
        warm()
        held = {name: getattr(live, name).clone() for name in TENSOR_FIELDS
                if getattr(live, name) is not None}
        capture_step()
        for name, t in held.items():
            getattr(live, name).copy_(t)
        captures.append(launch_counts.read())

        def replay():
            mark = launch_counts.read()
            capture_step()
            launch_counts.write(mark)
        return replay
    monkeypatch.setattr(ttr, 'capture_graph', fake_capture)
    (eager_state, *eager), eager_counts = run(False, fresh())
    warm0 = ttr.warmup_steps
    live = fresh()
    (graph_state, *graphed), graph_counts = run(True, live)
    assert graph_state is live and len(captures) == 1
    # what the capture added, the warm-up's taken back before it
    assert captures[0][:2] == (1, 1)
    assert ttr.warmup_steps == warm0 + ttr.WARMUP_STEPS
    assert eager_state.step == graph_state.step > 7
    assert graph_counts == eager_counts
    assert eager_counts[:2] == (eager_state.step, eager_state.step)
    assert graphed == eager
    _assert_states_equal(graph_state, eager_state)


@pytest.mark.parametrize('backend,graphs', [('gloo', True), ('gloo', None), (None, None)])
def test_graphs_take_no_mesh(backend, graphs, tmp_path, monkeypatch):
    """The step's CUDA graph takes a mesh only under NCCL: on a gloo mesh
    (a world of one, the process group's own) ``graphs=True`` raises,
    naming gloo, before any step; ``graphs=None`` steps eagerly there and
    on the CPU without a mesh (no capture is made)."""
    import torch.distributed as dist
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm

    def no_capture(*a, **k):
        raise AssertionError('a capture was made')
    monkeypatch.setattr(ttr, 'capture_graph', no_capture)
    ph, fresh, _ = _phase('smallify', 1, max_pass=2)
    mesh = None
    if backend is not None:
        dist.init_process_group(backend, init_method='file://' + str(tmp_path / 'rendezvous'),
                                world_size=1, rank=0)
        mesh = pm.make_mesh(1, 1, 'cpu')

    def run():
        return ttr.solve_phase(ph, fresh(), torch.from_numpy(_volume()), 4,
                               generator=torch.Generator().manual_seed(0), verbose=False,
                               mesh=mesh, graphs=graphs)
    try:
        if graphs:
            with pytest.raises(ValueError, match='runs gloo, whose collectives cannot be '
                                                 'captured'):
                run()
        else:
            assert run().step > 4
    finally:
        if backend is not None:
            dist.destroy_process_group()


def test_launch_counts_read_write_add():
    mark = launch_counts.read()
    try:
        launch_counts.write((0,) * len(launch_counts.COUNTERS))
        launch_counts.add(tuple(range(len(launch_counts.COUNTERS))))
        assert launch_counts.read() == tuple(range(len(launch_counts.COUNTERS)))
        assert (gs.launches, gs.bwd_launches) == (0, 1)
        assert launch_counts.since((0,) * len(launch_counts.COUNTERS)) == \
            launch_counts.read()
    finally:
        launch_counts.write(mark)
