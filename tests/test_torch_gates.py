"""The port's smallify gates against the JAX package's ``models/gates.py``,
and the model-level bake, hard prune and parameter count of
``models/feature_grid.py``, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.models import gates as jG
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models import gates as tG
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
    betas, ema, ema_var = tG.init_gates(torch.Generator().manual_seed(0),
                                        'smallify', SHAPES)
    jp, jaux = jG.init_gates(jax.random.key(0), 'smallify', SHAPES, 0.025)
    assert [tuple(b.shape) for b in betas] == [b.shape for b in jp.betas]
    for b, e, v in zip(betas, ema, ema_var):
        assert torch.equal(e, torch.sign(b)) and not v.any()
    assert tG.init_gates(torch.Generator(), '', SHAPES) == (None, None, None)


def test_apply_gate_and_l1_match_jax():
    betas, _, _ = _gates(1)
    coeff = np.random.default_rng(2).standard_normal(SHAPES[2]).astype(np.float32)
    got = tG.apply_gate('smallify', _t(betas), 2, torch.from_numpy(coeff))
    want = jG.apply_gate('smallify', jG.SmallifyParams(_j(betas)), 2,
                         jnp.asarray(coeff), None, 0.75)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(tG.l1_penalty('smallify', _t(betas))),
                               float(jG.l1_penalty('smallify',
                                                   jG.SmallifyParams(_j(betas)))),
                               rtol=1e-6)
    assert tG.gate_size('smallify', _t(betas)) == jG.gate_size(
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
    masks = tG.pruning_masks('smallify', _t(ema_var), thresholds)
    jmasks = jG.pruning_masks('smallify', jp, jaux, thresholds)
    for got, want in zip(masks, jmasks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < float(got.mean()) < 1
    baked = tG.bake_values('smallify', _t(betas), _t(ema_var), _t(coeffs), thresholds)
    jbaked = jG.bake_values('smallify', jp, jaux, _j(coeffs), thresholds)
    for got, want in zip(baked, jbaked):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('drop_type', ['straight_through', 'masked_straight_through',
                                       'static_variational', 'dynamic_variational'])
def test_other_gate_families_raise(drop_type):
    with pytest.raises(ValueError, match='not yet ported'):
        tfg.make_spec(**dict(SPEC, drop_type=drop_type))
    with pytest.raises(ValueError, match='not yet ported'):
        tG.apply_gate(drop_type, [], 0, torch.zeros(1))


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
    model = tfg.init_model(spec, torch.Generator().manual_seed(0))
    assert model.betas is None and model.ema is None
    assert tfg.save_dropvalues_on_grid(model) == (model, None, 0.0)
    assert tfg.remove_drop_layers(model, None) is model
