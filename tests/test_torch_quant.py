"""The port's quantization study (``ops/quantization.py``) against the JAX
package's: the affine round trip bit for bit, the quantized model, and the
study's counts, PSNRs and ratios on the same parameters."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.ops import quantization as jq
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models.gates import fields_of
from latent_feature_grid_compression_tpu_torch.ops import quantization as tq
from tests.torch_port_util import prune, to_port

# the sizes of the JAX package's own study test
SPEC = dict(grid_size=8, grid_features=4, hidden=16, num_layers=2)
PSNR_TOL_DB = 1e-3     # two float32 evaluations, sums in another order
RATIO_RTOL = 1e-6


def _values(scale, seed=0):
    """Random values, values past +-127 * scale (the int8 clip), and exact
    half-steps (k + 1/2) * scale where the scale is a power of two."""
    rng = np.random.default_rng(seed)
    rand = rng.standard_normal(257) * 60.0 * scale
    edges = np.array([0.0, scale, -scale, 126.5, 127.0, 127.49, 127.5, 128.0, 300.0,
                      -127.5, -128.0, -128.5, -129.0, -300.0, 0.5, -0.5, 1.5, -1.5,
                      2.5, -2.5]) * scale
    return np.concatenate([rand, edges]).astype(np.float32)


@pytest.mark.parametrize('scale', [0.02, 0.25, 1e-4, 2.0 ** -14])
@pytest.mark.parametrize('dtype', ['int8', 'int32'])
def test_affine_round_trip_matches_jax_bitwise(scale, dtype):
    x = _values(scale)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jqv = np.asarray(jq.quantize_affine(jnp.asarray(x), scale, dtype=jdt))
    tqv = tq.quantize_affine(torch.from_numpy(x), scale, dtype=tdt)
    assert tqv.dtype == tdt
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    jback = np.asarray(jq.dequantize_affine(jnp.asarray(jqv), scale))
    tback = tq.dequantize_affine(tqv, scale)
    assert tback.dtype == torch.float32
    np.testing.assert_array_equal(tback.numpy(), jback)


def test_affine_rounds_half_to_even_and_clips_int8():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, 300.0, -128.5, -300.0])
    np.testing.assert_array_equal(tq.quantize_affine(x, 1.0).numpy(),
                                  [0, 2, 2, 0, -2, 126, 127, 127, -128, -128])
    np.testing.assert_array_equal(tq.quantize_affine(x, 1.0, zero_point=3).numpy(),
                                  [3, 5, 5, 3, 1, 127, 127, 127, -125, -128])
    # the JAX package's own cases
    q = tq.quantize_affine(torch.tensor([0.0, 0.02, -0.02, 0.011, 10.0]), 0.02)
    np.testing.assert_array_equal(q.numpy(), [0, 1, -1, 1, 127])


def _models(drop_type, pruned, seed=0):
    jspec = jfg.make_spec(**SPEC, drop_type=drop_type)
    jparams, aux = jfg.init_model(jax.random.key(seed), jspec)
    if pruned:
        jparams = prune(jparams, 0.4, seed=seed)
    model = to_port(jparams, tfg.make_spec(**SPEC, drop_type=drop_type), gate_aux=aux)
    return jspec, jparams, model


@pytest.mark.parametrize('drop_type', ['', 'smallify', 'variational'])
def test_quantize_model_matches_jax_and_leaves_the_model(drop_type):
    jspec, jparams, model = _models(drop_type, pruned=True)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    jout = jq.quantize_model(jparams, 0.02, 1e-4)
    out = tq.quantize_model(model, 0.02, 1e-4)
    assert out is not model and out.spec == model.spec
    for name in ('coeffs', 'mlp_w', 'mlp_b'):
        for t, j in zip(getattr(out, name), getattr(jout, name)):
            assert t.grad_fn is None
            # the port's weights are (out, in), the JAX package's (in, out)
            t = t.T if name == 'mlp_w' else t
            np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    for c in out.coeffs:
        q = (c.detach() / 0.02).round()
        assert q.min() >= -128 and q.max() <= 127
    # the gates are copied, not shared, and unchanged
    for name, ts in fields_of(model).items():
        got = fields_of(out)[name]
        assert (ts is None) == (got is None), name
        for a, b in zip(ts or [], got or []):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize('pruned', [False, True])
@pytest.mark.parametrize('drop_type', ['', 'smallify'])
def test_mock_quantization_study_matches_jax(drop_type, pruned):
    n = 16
    xg, yg, zg = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing='ij')
    vol = (np.sin(3 * xg) * np.cos(2 * yg)).astype(np.float32)
    jspec, jparams, model = _models(drop_type, pruned)
    want = jq.mock_quantization_study(jspec, jparams, vol)
    got = tq.mock_quantization_study(model, vol, device='cpu')
    assert set(got) == set(want)
    for k in ('num_grid_params', 'num_mlp_params', 'num_zeros'):
        assert got[k] == want[k], k
    assert (got['num_zeros'] > 0) == pruned
    for k in ('psnr', 'psnr_quant'):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= PSNR_TOL_DB, k
    for k in ('compression_ratio', 'compression_ratio_quant'):
        assert got[k] == pytest.approx(want[k], rel=RATIO_RTOL), k
    assert got['compression_ratio_quant'] > got['compression_ratio']


def test_study_runs_on_the_card_unless_asked():
    _, _, model = _models('', False)
    vol = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tq.mock_quantization_study(model, vol)
