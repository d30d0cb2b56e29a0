"""The port's trainer against the JAX package's ``train/trainer.py``: one
train step from identical parameters and positions (loss, every gradient,
the Adam-updated parameters, the tracker), for every gate family with the
same gate noise (the KL weight's ramp, the variance model), the step at
which each phase stops under both lr strategies, the loss terms, the config
precedence, and ``train_torch.py`` on the CPU."""

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
from latent_feature_grid_compression_tpu.models import variance as jV
from latent_feature_grid_compression_tpu.ops import fused_forward as jff
from latent_feature_grid_compression_tpu.ops import mlp_pallas as jmp
from latent_feature_grid_compression_tpu.train import losses as jL
from latent_feature_grid_compression_tpu.train import trainer as jtr
from latent_feature_grid_compression_tpu_torch import config as tconfig
from latent_feature_grid_compression_tpu_torch.convert import variance_from_jax
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta as TMeta
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models import gates as tG
from latent_feature_grid_compression_tpu_torch.ops import dwt as tdwt
from latent_feature_grid_compression_tpu_torch.train import losses as tL
from latent_feature_grid_compression_tpu_torch.train import run as trun
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr
from tests.torch_ab import jax_pos_stream
from tests.torch_port_util import to_port

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
            grid_features=8, grid_size=8, wavelet='db2', drop_type='smallify')
# the backends of the port's paths, as (JAX make_spec, port make_spec) options
BACKENDS = {'xla': (dict(interp_backend='xla'), {}),
            'mlp_pallas': (dict(interp_backend='xla', mlp_backend='pallas'),
                           dict(mlp_backend='pallas')),
            'fused': (dict(interp_backend='fused'), dict(interp_backend='fused'))}
# one step's bound on the gradients, relative to each tensor's max |g|:
# float32 sums in another order; under 'fused' also the bf16 rounding of an
# x0 operand, which can fall either way where JAX's 3-pass fetch and the
# exact one differ in the last bits (tests/test_torch_fused_forward.py)
GRAD_TOL = {'xla': 1e-5, 'mlp_pallas': 1e-5, 'fused': 1e-3}


def _volume(shape, seed=0):
    vol = np.random.default_rng(seed).uniform(-1, 1, shape)
    return vol.astype(np.float32)


def _interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (on the CPU),
    as its own tests do."""
    for mod, name in ((jmp, 'mlp_apply_pallas'), (jff, 'fused_forward')):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **k: _f(*a, **dict(k, interpret=True)))


def _setup(seed, shape, phase, backend='xla', **cfg_kw):
    """JAX and port phase specs, states and masks from one init."""
    kw = dict(drop_type='smallify', batch_size=64, sample_size=8, lr=0.01,
              lambda_drop_loss=1e-3, lambda_weight_loss=1e-4, max_pass=30)
    kw.update(cfg_kw)
    jspec = jfg.make_spec(**SPEC, **BACKENDS[backend][0])
    tspec = tfg.make_spec(**SPEC, **BACKENDS[backend][1])
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


def _jax_tensors(jparams_like, drop_type='smallify', var_like=None):
    """coeffs, mlp_w ((out, in) like the port), mlp_b, the family's gate
    tensors and the variance model's weights (out, in) and biases, as
    numpy, in the port's flat order."""
    out = ([np.asarray(c) for c in jparams_like.coeffs]
           + [np.asarray(w).T for w in jparams_like.mlp_w]
           + [np.asarray(b) for b in jparams_like.mlp_b])
    if jparams_like.gates is not None:
        for name in tG.trainable_fields(drop_type):
            out += [np.asarray(a) for a in getattr(jparams_like.gates, name)]
    if var_like is not None:
        out += [np.asarray(w).T for w in var_like['w']] + [np.asarray(b) for b in var_like['b']]
    return out


def _port_tensors(layout, flat):
    p, variance = layout.views(flat)
    groups = {name: getattr(p, name) for name in layout.names if hasattr(p, name)}
    if variance is not None:
        groups['var_w'], groups['var_b'] = variance
    return [t.numpy() for name in layout.names for t in groups[name]]


@pytest.mark.parametrize('phase,backend', [
    pytest.param(1, 'xla', id='1'), pytest.param(2, 'xla', id='2'),
    pytest.param(1, 'mlp_pallas', id='1-mlp_pallas'),
    pytest.param(2, 'mlp_pallas', id='2-mlp_pallas'),
    pytest.param(1, 'fused', id='1-fused'), pytest.param(2, 'fused', id='2-fused')])
def test_one_step_matches_jax(phase, backend, monkeypatch):
    """Loss, every gradient (as Adam's first moment, (1 - b1) * g), the
    Adam-updated parameters and the tracker after one step, under each
    backend (JAX's Pallas kernels in interpret mode, the port's plain
    versions of its kernels).  Tolerances: float32 with sums taken in
    another order."""
    _interpret_pallas(monkeypatch)
    shape = (12, 10, 9)
    vol = _volume(shape)
    jph, tph, jstate, tstate, jmasks, tmasks, key = _setup(0, shape, phase, backend)
    assert (tph.spec.interp_backend, tph.spec.mlp_backend) == {
        'xla': ('trilinear', 'xla'), 'mlp_pallas': ('trilinear', 'pallas'),
        'fused': ('fused', 'xla')}[backend]
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
    g_tol = GRAD_TOL[backend]
    for got, want in zip(_port_tensors(tstate.layout, tstate.m), m_jax):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=g_tol * max(np.abs(want).max(), 1e-12))
    # Adam's first step is lr * g / (|g| + eps): where |g| is near eps it
    # passes on the gradient's rounding; 1e-5 is 0.1% of lr
    for got, want, m_want in zip(_port_tensors(tstate.layout, tstate.flat),
                                 _jax_tensors(new.params)[:n], m_jax):
        if backend == 'fused':
            # a gradient within its bound of 0 may step either way, by <= lr
            assert np.abs(got - want).max() <= 2 * 0.01 * 1.0001
            sure = np.abs(m_want) > g_tol * np.abs(m_want).max()
            got, want = got[sure], want[sure]
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
    got = tL.smallify_family_loss('smallify', list(model.coeffs), model, 1e-3, 1e-4)
    want = jL.smallify_family_loss('smallify', jparams, 1e-3, 1e-4)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    assert tL.smallify_family_loss('smallify', list(model.coeffs), None, 0.0, 0.0) == 0.0


@pytest.mark.parametrize('argv', [
    [], ['--lr', '0.5', '--grid_size', '9'],
    ['--config', 'experiment-config-files/mhd_p_smallify.txt'],
    ['--config', 'experiment-config-files/mhd_p_smallify.txt', '--max_pass', '3',
     '--pruning_threshold_list', '0.5', '0.6', '--drop_type', ''],
    ['--config', 'experiment-config-files/mhd_p_masked_st.txt', '--drop_type',
     'straight_through'],
    ['--config', 'experiment-config-files/mhd_p_dynamic_variational.txt',
     '--weight_dkl_multiplier', '1e-4', '--variational_sigma', '-3.5']])
def test_config_from_args_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert tconfig.config_from_args(argv).to_dict() == \
        jconfig.config_from_args(argv).to_dict()


FAMILIES = ['straight_through', 'masked_straight_through', 'static_variational',
            'dynamic_variational']
# the published configs' gate and loss settings of each family
# (experiment-config-files/mhd_p_masked_st.txt, mhd_p_static_variational.txt,
# mhd_p_dynamic_variational.txt; straight-through takes masked-ST's)
FAMILY_CFG = {
    'straight_through': dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8),
    'masked_straight_through': dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8),
    'static_variational': dict(lambda_drop_loss=1.0, lambda_weight_loss=2.0,
                               variational_sigma=-7.0, weight_dkl_multiplier=5e-5,
                               drop_momentum=0.1, drop_threshold=0.9),
    'dynamic_variational': dict(lambda_drop_loss=0.1, lambda_weight_loss=2.0,
                                variational_sigma=0.0, weight_dkl_multiplier=3e-5,
                                drop_momentum=0.1, drop_threshold=0.9)}


def _jax_step_noise(drop_type, k_gate, coeffs):
    """The per-level noise JAX's step draws from its gate key (None for the
    deterministic families)."""
    if not tG.noise_kind(drop_type):
        return None
    draw = jax.random.uniform if drop_type == 'straight_through' else jax.random.normal
    keys = jax.random.split(k_gate, len(coeffs))
    return [torch.from_numpy(np.array(draw(k, c.shape[1:]))) for k, c in zip(keys, coeffs)]


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_one_step_matches_jax_families(drop_type):
    """One phase-1 step of each family at its published loss settings,
    given JAX's positions and gate noise: the loss, the volume loss, the
    ramped KL weight (bit for bit), every gradient (as Adam's first moment;
    the variance model's too) and the updated parameters.  Straight-through
    starts at its init, mask values 1 on the clip's bound; the others from
    gates part-way through training.  Tolerances as test_one_step_matches_jax:
    float32 sums in another order, relative to each tensor's max |g| (the
    variational gradients are ~1e9)."""
    shape = (12, 10, 9)
    vol = _volume(shape)
    fam = FAMILY_CFG[drop_type]
    spec_kw = dict(SPEC, drop_type=drop_type, drop_momentum=fam.get('drop_momentum', 0.025),
                   drop_threshold=fam.get('drop_threshold', 0.75))
    kw = dict(batch_size=64, sample_size=8, lr=0.01, max_pass=30, drop_type=drop_type, **fam)
    jspec = jfg.make_spec(**spec_kw, interp_backend='xla')
    tspec = tfg.make_spec(**spec_kw)
    jparams, _ = jfg.init_model(jax.random.key(0), jspec)
    rng = np.random.default_rng(0)
    if drop_type != 'straight_through':
        jparams = jparams.replace(gates=jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
            jparams.gates))
    var = tvar = None
    if 'dynamic' in drop_type:
        var = jV.init_variance_model(jax.random.key(1), 3, 1, 4, 32)
        tvar = variance_from_jax([np.asarray(w) for w in var['w']],
                                 [np.asarray(b) for b in var['b']], device='cpu')
    jph = jtr.make_phase_spec(jconfig.TrainConfig(**kw), jspec, JMeta(shape), phase=1)
    tph = ttr.make_phase_spec(tconfig.TrainConfig(**kw), tspec, TMeta(shape), phase=1)
    assert (tph.variational, tph.dynamic_variational) == (jph.variational,
                                                          jph.dynamic_variational)
    key = jax.random.key(100)
    w0 = fam['lambda_drop_loss']
    jstate = jtr.init_train_state(jparams, var, None, lr=0.01, shadow_lr=0.01, key=key,
                                  weight_dkl=w0)
    tstate = ttr.init_train_state(to_port(jparams, tspec), 0.01, 0.01, train_gates=True,
                                  variance=tvar, weight_dkl=w0)
    _, k_pos, k_gate = jax.random.split(key, 3)
    pos = np.array(jax.random.randint(k_pos, (1, jph.batch_n, 3), 0,
                                      jnp.asarray(shape, jnp.int32)[None, None]))
    new, metrics = jax.jit(jtr.make_train_step(jph, None))(jstate, jnp.asarray(vol))

    c = ttr.PhaseConstants(tph, torch.from_numpy(vol))
    norm, gt = ttr.chunk_inputs(c, torch.from_numpy(pos))
    loss, vol_loss = ttr.train_step(tph, tstate, c, norm[0], gt[0],
                                    noise=_jax_step_noise(drop_type, k_gate, jparams.coeffs))
    np.testing.assert_allclose(float(loss), float(metrics['loss']), rtol=1e-5)
    np.testing.assert_allclose(float(vol_loss), float(metrics['volume_loss']), rtol=1e-5)
    assert float(tstate.weight_dkl) == float(new.weight_dkl)
    assert (float(new.weight_dkl) > w0) == ('variational' in drop_type)

    _, unravel = ravel_pytree((jstate.params, var))
    jm, jvm = unravel(new.m)
    m_jax = _jax_tensors(jm, drop_type, jvm)
    got_m = _port_tensors(tstate.layout, tstate.m)
    assert len(got_m) == len(m_jax) == len(tstate.layout.counts)
    for got, want in zip(got_m, m_jax):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12))
    for got, want in zip(_port_tensors(tstate.layout, tstate.flat),
                         _jax_tensors(new.params, drop_type, new.var_params)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_guarded_step_leaves_kl_weight_and_variance_model():
    """A step taken after the stop changes nothing: not the KL weight's
    ramp, not the variance model (as the JAX trainer's idle branch)."""
    drop_type = 'dynamic_variational'
    fam = FAMILY_CFG[drop_type]
    spec = tfg.make_spec(**dict(SPEC, drop_type=drop_type))
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
    from latent_feature_grid_compression_tpu_torch.models.variance import init_variance_model
    var = init_variance_model(torch.Generator().manual_seed(1))
    kw = dict(batch_size=64, sample_size=8, drop_type=drop_type, **fam)
    ph = ttr.make_phase_spec(tconfig.TrainConfig(**kw), spec, TMeta((8, 8, 8)), phase=1)
    st = ttr.init_train_state(model, 0.01, 0.01, train_gates=True, variance=var,
                              weight_dkl=fam['lambda_drop_loss'])
    c = ttr.PhaseConstants(ph, torch.from_numpy(_volume((8, 8, 8))))
    g = torch.Generator().manual_seed(2)
    norm, gt = ttr.chunk_inputs(c, ttr.draw_positions(c, 2, ph.batch_n, g))
    noise = ttr.draw_noise(ph, 2, g, torch.device('cpu'))
    ttr.train_step(ph, st, c, norm[0], gt[0], noise=[a[0] for a in noise])
    before = (st.flat.clone(), st.weight_dkl.clone())
    assert float(st.weight_dkl) == pytest.approx(0.1 * (1 + 3e-5))
    st.stop = torch.tensor(True)
    ttr.train_step(ph, st, c, norm[1], gt[1], guard=True, noise=[a[1] for a in noise])
    # the flat vector ends in the variance model
    assert st.layout.names[-2:] == ('var_w', 'var_b')
    assert st.layout.slices['var_b'].stop == st.flat.numel()
    assert torch.equal(st.flat, before[0]) and torch.equal(st.weight_dkl, before[1])


def test_ramp_weight_dkl_matches_jax_bit_for_bit():
    """2,000 ramps from 0.1 at 3e-3 a step (it crosses the cap of 30): the
    port's float32 sequence equals the JAX package's under jit."""
    def body(w, _):
        w = jL.ramp_weight_dkl(w, 3e-3)
        return w, w
    _, want = jax.jit(lambda w: jax.lax.scan(body, w, None, length=2000))(
        jnp.asarray(0.1, jnp.float32))
    w, got = torch.tensor(0.1), []
    for _ in range(2000):
        w = tL.ramp_weight_dkl(w, 3e-3)
        got.append(w)
    got, want = torch.stack(got).numpy(), np.asarray(want)
    assert want[-1] >= 30.0 > want[0]
    np.testing.assert_array_equal(got, want)


def test_variational_losses_match_jax():
    """log_likelihood_variance and variational_loss at the static family's
    sigma (e^-7) and a predicted one, relative to max |.| (the terms reach
    ~1e9)."""
    drop_type = 'static_variational'
    jspec = jfg.make_spec(**dict(SPEC, drop_type=drop_type))
    jparams, _ = jfg.init_model(jax.random.key(4), jspec)
    rng = np.random.default_rng(4)
    jparams = jparams.replace(gates=jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jparams.gates))
    model = to_port(jparams, tfg.make_spec(**dict(SPEC, drop_type=drop_type)))
    n = 4096
    pred, gt = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    for log_sigma in (np.full(n, -7.0, np.float32),
                      rng.uniform(-3, 1, n).astype(np.float32)):
        args = [pred, gt, log_sigma]
        want = jL.log_likelihood_variance(*map(jnp.asarray, args))
        got = tL.log_likelihood_variance(*map(torch.from_numpy, args))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(b)).max())
        want = jL.variational_loss(jparams, *map(jnp.asarray, args), jnp.asarray(0.7),
                                   2.0, 506.25, data_scale=4049.1)
        got = tL.variational_loss([c.detach() for c in model.coeffs], model,
                                  *map(torch.from_numpy, args), torch.tensor(0.7), 2.0,
                                  506.25, data_scale=4049.1)
        scale = max(abs(float(b)) for b in want)
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-5 * scale, (float(a), float(b))


def test_decode_copies_its_operators_once():
    """The synthesis matrices are cached on the device: a second decode
    reuses the same tensors (no host-to-device copy on the step)."""
    spec = tfg.make_spec(**SPEC)
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
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


def _cli_on_cpu(tmp_path, monkeypatch, *extra):
    vol_path = str(tmp_path / 'vol.npy')
    np.save(vol_path, _volume((16, 16, 16), 2) * 3.0 + 1.0)
    monkeypatch.chdir(tmp_path)
    return train_torch.main(_cli_args(tmp_path, vol_path, '--device', 'cpu', *extra))


def test_train_torch_cli_on_cpu(tmp_path, monkeypatch, capsys):
    info = _cli_on_cpu(tmp_path, monkeypatch)
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


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_train_torch_cli_families_on_cpu(tmp_path, monkeypatch, drop_type):
    """Each family through the CLI at its published settings: both phases,
    bake, prune, evaluation and export; the volume loss falls."""
    fam = FAMILY_CFG[drop_type]
    flags = ['--drop_type', drop_type]
    for k, v in fam.items():
        flags += [f'--{k}', str(v)]
    info = _cli_on_cpu(tmp_path, monkeypatch, *flags)
    assert info['train_phase1_steps'] == 16 and info['train_phase2_steps'] == 8
    assert info['train_phase1_last_volume_loss'] < info['train_phase1_first_volume_loss']
    assert np.isfinite(info['psnr']) and info['compression_ratio'] > 0
    exp = tmp_path / 'run'
    assert (exp / 'binary_model_file').exists()
    with np.load(exp / 'model.npz') as z:
        # the final model is pruned: no gates, drop_type ''
        assert str(z['drop_type']) == '' and not any(k.startswith('gate_') for k in z.files)


@pytest.mark.parametrize('flags', [['--mlp_backend', 'pallas'],
                                   ['--interp_backend', 'fused']])
def test_train_torch_cli_backends_on_cpu(tmp_path, monkeypatch, flags):
    """The kernel backends' paths through the CLI (their plain versions on
    the CPU): both phases, evaluation and export, the loss falling."""
    calls = []
    orig = tfg.predict
    monkeypatch.setattr(tfg, 'predict', lambda m, *a, **k: calls.append(
        (m.spec.interp_backend, m.spec.mlp_backend)) or orig(m, *a, **k))
    info = _cli_on_cpu(tmp_path, monkeypatch, *flags)
    assert set(calls) == {('fused', 'xla') if 'fused' in flags else ('trilinear', 'pallas')}
    assert len(calls) == info['train_phase1_steps'] + info['train_phase2_steps'] == 24
    assert info['train_phase1_last_loss'] < info['train_phase1_first_loss']
    assert np.isfinite(info['psnr']) and (tmp_path / 'run' / 'binary_model_file').exists()
    cfg = tconfig.load_config(str(tmp_path / 'run' / 'config.txt'))
    assert (cfg.interp_backend, cfg.mlp_backend) == (
        ('fused', 'xla') if 'fused' in flags else ('auto', 'pallas'))


def test_train_torch_raises_without_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CUDA default does not raise')
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train_torch.main(_cli_args(tmp_path, str(tmp_path / 'missing.npy')))
    assert not (tmp_path / 'run').exists()
