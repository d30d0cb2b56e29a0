"""The port's gates against the JAX package's ``models/gates.py``, every
family (smallify, straight-through, masked straight-through, static and
dynamic variational), the variance model against ``models/variance.py``,
and the model-level bake, hard prune and parameter count of
``models/feature_grid.py``, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.models import gates as jG
from latent_feature_grid_compression_tpu.models import variance as jV
from latent_feature_grid_compression_tpu_torch.convert import variance_from_jax, variance_to_jax
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models import gates as tG
from latent_feature_grid_compression_tpu_torch.models import variance as tV
from tests.torch_port_util import to_port

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
            grid_features=4, grid_size=15, wavelet='db2')
# the flagship grid's coefficient shapes, at 4 features
SHAPES = [(4, 6, 6, 6), (4, 7, 6, 6, 6), (4, 7, 9, 9, 9)]


def _gates(seed, scale=1.0):
    """betas, ema, ema_var per level (ema_var spread around the 0.75
    threshold so the masks are mixed)."""
    rng = np.random.default_rng(seed)
    sizes = [s[1:] for s in SHAPES]
    betas = [(scale * rng.standard_normal(s)).astype(np.float32) for s in sizes]
    ema = [rng.uniform(-1, 1, s).astype(np.float32) for s in sizes]
    ema_var = [rng.uniform(0.5, 1.0, s).astype(np.float32) for s in sizes]
    return betas, ema, ema_var


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def test_init_gates_shapes_and_tracker_start():
    g = tG.init_gates(torch.Generator().manual_seed(0), 'smallify', SHAPES)
    jp, jaux = jG.init_gates(jax.random.key(0), 'smallify', SHAPES, 0.025)
    assert [tuple(b.shape) for b in g.betas] == [b.shape for b in jp.betas]
    for b, e, v in zip(g.betas, g.ema, g.ema_var):
        assert torch.equal(e, torch.sign(b)) and not v.any()
    assert tG.init_gates(torch.Generator(), '', SHAPES) is None


def test_apply_gate_and_l1_match_jax():
    betas, _, _ = _gates(1)
    coeff = np.random.default_rng(2).standard_normal(SHAPES[2]).astype(np.float32)
    gates = tG.Gates(betas=_t(betas))
    got = tG.apply_gate('smallify', gates, 2, torch.from_numpy(coeff), None, 0.75)
    want = jG.apply_gate('smallify', jG.SmallifyParams(_j(betas)), 2,
                         jnp.asarray(coeff), None, 0.75)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(tG.l1_penalty('smallify', gates)),
                               float(jG.l1_penalty('smallify',
                                                   jG.SmallifyParams(_j(betas)))),
                               rtol=1e-6)
    assert tG.gate_size('smallify', gates) == jG.gate_size(
        'smallify', jG.SmallifyParams(_j(betas))) == 6831


def test_tracker_matches_jax_over_steps():
    betas, ema, ema_var = _gates(3)
    e, v = _t(ema), [torch.zeros_like(x) for x in _t(ema_var)]
    jaux = jG.SmallifyAux(_j(ema), tuple(jnp.zeros_like(x) for x in _j(ema_var)))
    rng = np.random.default_rng(4)
    for _ in range(5):
        b = [(x + 0.5 * rng.standard_normal(x.shape)).astype(np.float32) for x in betas]
        e, v = tG.smallify_update_tracker(e, v, _t(b), 0.025)
        jaux = jG.smallify_update_tracker(jaux, jG.SmallifyParams(_j(b)), 0.025)
    for got, want in zip(e + v, list(jaux.ema) + list(jaux.ema_var)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_masks_and_bake_match_jax():
    betas, ema, ema_var = _gates(5)
    coeffs = [np.random.default_rng(6 + i).standard_normal(s).astype(np.float32)
              for i, s in enumerate(SHAPES)]
    thresholds = (0.75, 0.6, 0.9)
    jp, jaux = jG.SmallifyParams(_j(betas)), jG.SmallifyAux(_j(ema), _j(ema_var))
    gates = tG.Gates(betas=_t(betas), ema=_t(ema), ema_var=_t(ema_var))
    masks = tG.pruning_masks('smallify', gates, thresholds)
    jmasks = jG.pruning_masks('smallify', jp, jaux, thresholds)
    for got, want in zip(masks, jmasks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < float(got.mean()) < 1
    baked = tG.bake_values('smallify', gates, _t(coeffs), thresholds)
    jbaked = jG.bake_values('smallify', jp, jaux, _j(coeffs), thresholds)
    for got, want in zip(baked, jbaked):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unknown_drop_type_raises():
    with pytest.raises(ValueError, match='unknown drop_type'):
        tfg.make_spec(**dict(SPEC, drop_type='dropconnect'))
    with pytest.raises(ValueError, match='unknown drop_type'):
        tG.apply_gate('dropconnect', tG.Gates(), 0, torch.zeros(1), None, 0.75)
    # the family is chosen by substring, as the JAX package does
    for name in ('variational_dynamic', 'static_variational', 'straight_through'):
        assert tfg.make_spec(**dict(SPEC, drop_type=name)).drop_type == name
    assert tG.is_dynamic('variational_dynamic') and not tG.is_dynamic('static_variational')


@pytest.mark.parametrize('plist', [None, [0.5], [0.5, 0.6, 0.7, 0.8]])
def test_spec_thresholds_match_jax(plist):
    kw = dict(SPEC, drop_type='smallify', drop_threshold=0.7,
              pruning_threshold_list=plist)
    assert tfg.make_spec(**kw).thresholds == jfg.make_spec(**kw).thresholds


def _models(seed):
    jspec = jfg.make_spec(**dict(SPEC, drop_type='smallify'))
    jparams, jaux = jfg.init_model(jax.random.key(seed), jspec)
    _, ema, ema_var = _gates(seed)
    jaux = jG.SmallifyAux(_j(ema), _j(ema_var))
    tspec = tfg.make_spec(**dict(SPEC, drop_type='smallify'))
    return jspec, jparams, jaux, to_port(jparams, tspec, gate_aux=jaux)


def test_bake_prune_and_count_match_jax():
    jspec, jparams, jaux, model = _models(7)
    assert tfg.num_net_params(model) == jfg.num_net_params(jparams) == \
        sum(p.numel() for p in list(model.coeffs) + list(model.mlp_w) + list(model.mlp_b))
    jbaked, jmasks, jzeros = jfg.save_dropvalues_on_grid(jspec, jparams, jaux)
    baked, masks, zeros = tfg.save_dropvalues_on_grid(model)
    assert zeros == jzeros and zeros > 0
    for got, want in zip(baked.coeffs, jbaked.coeffs):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for got, want in zip(masks, jmasks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert baked.betas is not None
    jpruned = jfg.remove_drop_layers(jspec, jbaked, jmasks)
    pruned = tfg.remove_drop_layers(baked, masks)
    assert pruned.betas is None and jpruned.gates is None
    for got, want in zip(pruned.coeffs, jpruned.coeffs):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_gated_forward_matches_jax():
    """decode_volume + apply_model under the training gates, and under the
    frozen masks of phase 2."""
    jspec, jparams, jaux, model = _models(8)
    coords = np.random.default_rng(9).uniform(-1, 1, (500, 3)).astype(np.float32)
    want = jfg.apply_model(jspec, jparams, jnp.asarray(coords), train=True,
                           train_gates=True)
    got = tfg.apply_model(model, torch.from_numpy(coords), train_gates=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    _, jmasks, _ = jfg.save_dropvalues_on_grid(jspec, jparams, jaux)
    want = jfg.apply_model(jspec, jparams, jnp.asarray(coords), masks=jmasks)
    got = tfg.apply_model(model, torch.from_numpy(coords),
                          masks=[torch.from_numpy(np.array(m)) for m in jmasks])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_model_without_gates_bakes_nothing():
    spec = tfg.make_spec(**SPEC)
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
    assert model.betas is None and model.ema is None
    assert tfg.save_dropvalues_on_grid(model) == (model, None, 0.0)
    assert tfg.remove_drop_layers(model, None) is model


# ---------------------------------------------------------------------------
# the other families: straight-through, masked straight-through, variational
# ---------------------------------------------------------------------------

FAMILIES = ['straight_through', 'masked_straight_through', 'static_variational',
            'dynamic_variational']
# forward and gradients of one gate against JAX's, relative to max |.|:
# float32, the same formula
GATE_TOL = 1e-6
# a variational bake multiplies by exp(log_theta), and torch's float32 exp and
# XLA's differ by one rounding on some inputs (measured: 65 of 864 entries of
# one level, by 1.6e-7 of the value at most): relative, with the zeros exact
EXP_RTOL = 2.5e-7


def _same_bake(got, want, drop_type):
    got, want = np.asarray(got), np.asarray(want)
    if 'variational' in drop_type:
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=EXP_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _family_gates(drop_type, seed):
    """The family's trainable gate arrays per level, spread around the 0.75
    threshold so that the masks are mixed: mask values around 0.75
    (straight-through) or logit(0.75) (masked), dropout rates around 0.75
    (variational: log alpha around log 3)."""
    rng = np.random.default_rng(seed)
    sizes = [s[1:] for s in SHAPES]
    if 'variational' in drop_type:
        lt = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in sizes]
        lv = [(2.0 * a + np.log(3.0) + rng.standard_normal(s)).astype(np.float32)
              for a, s in zip(lt, sizes)]
        return {'log_thetas': lt, 'log_var': lv}
    centre = 0.75 if drop_type == 'straight_through' else np.log(3.0)
    return {'mask_values': [(centre + rng.standard_normal(s)).astype(np.float32)
                            for s in sizes]}


def _jax_gates(drop_type, arrs):
    if 'variational' in drop_type:
        return jG.VariationalParams(_j(arrs['log_thetas']), _j(arrs['log_var']))
    return jG.STParams(_j(arrs['mask_values']))


def _jax_noise(drop_type, key, shape):
    """The noise JAX's apply_gate draws from ``key``, as a torch tensor
    (None for the deterministic families)."""
    if drop_type == 'straight_through':
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape))))
    if 'variational' in drop_type:
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape))))
    return None


def _close(got, want, tol=GATE_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_init_gates_match_jax(drop_type):
    """Shapes and values (deterministic for these families): mask values 1;
    log_thetas 0 and log_var log(p / (1 - p)) at p = drop_momentum."""
    g = tG.init_gates(torch.Generator().manual_seed(0), drop_type, SHAPES, 0.1)
    jp, jaux = jG.init_gates(jax.random.key(0), drop_type, SHAPES, 0.1)
    assert jaux is None and g.betas is None and g.ema is None
    names = tG.trainable_fields(drop_type)
    assert names == (('log_thetas', 'log_var') if 'variational' in drop_type
                     else ('mask_values',))
    for name in names:
        for got, want in zip(getattr(g, name), getattr(jp, name)):
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tG.gate_size(drop_type, g) == jG.gate_size(drop_type, jp) == 6831


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_apply_gate_and_its_gradient_match_jax(drop_type):
    """One level's gated coefficients and the gradient of a weighted sum of
    them into the coefficients and the gate tensors, given the noise JAX
    draws: the hardtanh STE (straight-through), the sigmoid STE (masked),
    theta + sigma xi (variational)."""
    arrs = _family_gates(drop_type, 11)
    rng = np.random.default_rng(12)
    lvl = 2
    coeff = rng.standard_normal(SHAPES[lvl]).astype(np.float32)
    w = rng.standard_normal(SHAPES[lvl]).astype(np.float32)
    key = jax.random.key(13)
    jgp = _jax_gates(drop_type, arrs)
    want = jG.apply_gate(drop_type, jgp, lvl, jnp.asarray(coeff), key, 0.75)
    jgc, jgg = jax.grad(lambda c, gp: jnp.sum(
        jG.apply_gate(drop_type, gp, lvl, c, key, 0.75) * w), argnums=(0, 1))(
            jnp.asarray(coeff), jgp)

    tc = torch.from_numpy(coeff).requires_grad_(True)
    tg = {k: [torch.from_numpy(a).requires_grad_(True) for a in v] for k, v in arrs.items()}
    got = tG.apply_gate(drop_type, tG.Gates(**tg), lvl, tc,
                        _jax_noise(drop_type, key, SHAPES[lvl][1:]), 0.75)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach().numpy(), want)
    _close(tc.grad.numpy(), jgc)
    for name, ts in tg.items():
        assert np.abs(np.asarray(getattr(jgg, name)[lvl])).max() > 0
        _close(ts[lvl].grad.numpy(), getattr(jgg, name)[lvl])
        assert all(t.grad is None for i, t in enumerate(ts) if i != lvl)


def test_straight_through_gradient_halves_at_the_clip_bound():
    """At mask value 1 (the init) the clip passes half the gradient, as the
    JAX package's jnp.clip does."""
    mv = np.array([1.0, -1.0, 0.5, 1.5, -2.0], np.float32)
    u = np.full(5, 0.25, np.float32)
    coeff = np.ones((2, 5), np.float32)
    t = torch.from_numpy(mv).requires_grad_(True)
    tG.apply_gate('straight_through', tG.Gates(mask_values=[t]), 0,
                  torch.from_numpy(coeff), torch.from_numpy(u), 0.75).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), [1.0, 1.0, 2.0, 0.0, 0.0])


def test_stochastic_gates_need_their_noise():
    g = tG.init_gates(torch.Generator(), 'static_variational', SHAPES, 0.1)
    with pytest.raises(ValueError, match='noise'):
        tG.apply_gate('static_variational', g, 0, torch.zeros(SHAPES[0]), None, 0.75)
    assert [tG.noise_kind(d) for d in FAMILIES + ['smallify', '']] == [
        'uniform', None, 'normal', 'normal', None, None]


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_masks_bake_and_size_match_jax(drop_type):
    """Exactly (the variational bake to EXP_RTOL), with per-level
    thresholds; a variational level whose every rate is above its threshold
    keeps its first element."""
    arrs = _family_gates(drop_type, 14)
    if 'variational' in drop_type:
        arrs['log_var'][1] = 2.0 * arrs['log_thetas'][1] + 10.0
    coeffs = [np.random.default_rng(15 + i).standard_normal(s).astype(np.float32)
              for i, s in enumerate(SHAPES)]
    thresholds = (0.75, 0.6, 0.9)
    gates, jgp = tG.Gates(**{k: _t(v) for k, v in arrs.items()}), _jax_gates(drop_type, arrs)
    masks = tG.pruning_masks(drop_type, gates, thresholds)
    jmasks = jG.pruning_masks(drop_type, jgp, None, thresholds)
    for lvl, (got, want) in enumerate(zip(masks, jmasks)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if 'variational' in drop_type and lvl == 1:
            assert float(got.sum()) == 1.0 and float(got.reshape(-1)[0]) == 1.0
        else:
            assert 0 < float(got.mean()) < 1
    baked = tG.bake_values(drop_type, gates, _t(coeffs), thresholds)
    jbaked = jG.bake_values(drop_type, jgp, None, _j(coeffs), thresholds)
    for got, want in zip(baked, jbaked):
        _same_bake(got.numpy(), want, drop_type)
    assert tG.gate_size(drop_type, gates) == jG.gate_size(drop_type, jgp) == 6831


def test_variational_dkl_and_rates_match_jax():
    arrs = _family_gates('static_variational', 16)
    gates = tG.Gates(**{k: _t(v) for k, v in arrs.items()})
    jgp = _jax_gates('static_variational', arrs)
    want = float(jG.variational_dkl(jgp))
    assert float(tG.variational_dkl(gates)) == pytest.approx(want, rel=1e-6)
    for lvl in range(len(SHAPES)):
        want = np.asarray(jG.variational_dropout_rates(jgp, lvl))
        np.testing.assert_allclose(tG.variational_dropout_rates(gates, lvl).numpy(),
                                   want, rtol=1e-6, atol=0)


def test_variance_model_matches_jax():
    """The JAX init's weights carried across (and back): the 4 x 32 ReLU
    MLP's log-sigma at the same coordinates; the port's own init has the
    same shapes."""
    jv = jV.init_variance_model(jax.random.key(17), 3, 1, 4, 32)
    ws, bs = variance_from_jax([np.asarray(w) for w in jv['w']],
                               [np.asarray(b) for b in jv['b']], device='cpu')
    x = np.random.default_rng(18).uniform(-1, 1, (500, 3)).astype(np.float32)
    want = jV.apply_variance_model(jv, jnp.asarray(x))
    got = tV.apply_variance_model(ws, bs, torch.from_numpy(x))
    assert got.shape == (500, 1)
    _close(got.numpy(), want)
    back = variance_to_jax((ws, bs))
    for a, b in zip(back['w'] + back['b'], jv['w'] + jv['b']):
        np.testing.assert_array_equal(a, np.asarray(b))
    own_w, own_b = tV.init_variance_model(torch.Generator().manual_seed(0))
    assert [tuple(w.shape[::-1]) for w in own_w] == [w.shape for w in jv['w']]
    assert [tuple(b.shape) for b in own_b] == [b.shape for b in jv['b']]


def _family_models(drop_type, seed):
    jspec = jfg.make_spec(**dict(SPEC, drop_type=drop_type))
    jparams, _ = jfg.init_model(jax.random.key(seed), jspec)
    jparams = jparams.replace(gates=_jax_gates(drop_type, _family_gates(drop_type, seed)))
    tspec = tfg.make_spec(**dict(SPEC, drop_type=drop_type))
    return jspec, jparams, to_port(jparams, tspec)


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_family_bake_prune_and_count_match_jax(drop_type):
    jspec, jparams, model = _family_models(drop_type, 19)
    jbaked, jmasks, jzeros = jfg.save_dropvalues_on_grid(jspec, jparams, None)
    baked, masks, zeros = tfg.save_dropvalues_on_grid(model)
    assert zeros == jzeros and zeros > 0
    for got, want in zip(baked.coeffs, jbaked.coeffs):
        _same_bake(got.detach().numpy(), want, drop_type)
    for got, want in zip(masks, jmasks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in tG.trainable_fields(drop_type):
        assert getattr(baked, name) is not None
    pruned = tfg.remove_drop_layers(baked, masks)
    jpruned = jfg.remove_drop_layers(jspec, jbaked, jmasks)
    assert all(getattr(pruned, f, None) is None for f in tG.FIELDS)
    for got, want in zip(pruned.coeffs, jpruned.coeffs):
        _same_bake(got.detach().numpy(), want, drop_type)
    assert tfg.num_net_params(pruned) == jfg.num_net_params(jpruned)


@pytest.mark.parametrize('drop_type', FAMILIES)
def test_family_gated_forward_matches_jax(drop_type):
    """apply_model under the training gates, with the per-level noise JAX's
    decode_volume draws from its split keys."""
    jspec, jparams, model = _family_models(drop_type, 20)
    coords = np.random.default_rng(21).uniform(-1, 1, (500, 3)).astype(np.float32)
    key = jax.random.key(22)
    keys = jax.random.split(key, len(jparams.coeffs))
    noise = [_jax_noise(drop_type, k, c.shape[1:]) for k, c in zip(keys, jparams.coeffs)]
    want = jfg.apply_model(jspec, jparams, jnp.asarray(coords), train=True,
                           train_gates=True, rng=key)
    got = tfg.apply_model(model, torch.from_numpy(coords), train_gates=True,
                          noise=None if noise[0] is None else noise)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
