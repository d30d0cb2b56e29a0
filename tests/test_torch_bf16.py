"""The port's bf16 compute path (``compute_dtype='bfloat16'``,
``interp_backend='pallas_bf16'``) against the JAX package on the CPU: the
plain versions of the 'bf16' fetch and its grid gradient against the Pallas
kernels with ``precision='bf16'`` in interpret mode (and the fetch against
the XLA gather on a bf16 grid), the plain one-kernel 'bf16' forward and its
gradients against the Pallas ``fused_forward(precision='bf16')``, the bf16
MLP chain against ``mlp_apply`` on bf16 arrays, and ``apply_model`` under
every bf16 row of the dispatch table (JAX ``models/feature_grid.py``
``apply_model``) with the Pallas kernels in interpret mode.  Inputs are made
with numpy; JAX runs on the CPU.

Tolerances, each relative to the reference's max |.|:

- The 'bf16' fetch and gradient: at least 99.9% of entries within 1e-6, all
  within 4e-3.  The plain versions round where the Pallas kernel's single
  bf16 MXU passes round, and every product of two bf16 values is exact in
  float32, so they differ only where a float32 summation order (XLA's dot
  against the port's sum), or JAX's hat() weight against the port's
  1 - frac (one float32 rounding apart), straddles a bf16 rounding boundary:
  then one value moves by a bf16 ulp (2^-8 of itself).
- The XLA gather on a bf16 grid (JAX's 'auto' and 'xla' on the CPU) rounds
  only the grid, not the weights or the plane sums: 1e-2.
- The one-kernel 'bf16' pair: the 'mixed' tolerances of
  ``tests/test_torch_fused_forward.py`` (2e-3 absolute + 1e-2 relative on
  the forward, 1e-2 of max |.| on the gradients): its MLP half is 'mixed''s,
  whose bf16 operands a float32 sum in another order can round either way.
- The bf16 MLP chain and every ``apply_model`` row that runs it: 2e-2, the
  bf16 tolerance of JAX's own ``tests/test_mlp_pallas.py``.  XLA on the CPU
  may compute a fused chain of bf16 elementwise ops in float32 and round
  once, where torch rounds after each op.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.ops import fused_forward as jff
from latent_feature_grid_compression_tpu.ops import mlp_pallas as jmp
from latent_feature_grid_compression_tpu.ops import pallas_kernels as jpk
from latent_feature_grid_compression_tpu.ops.interpolation import (
    grid_sample_3d as jax_grid_sample_3d)
from latent_feature_grid_compression_tpu.ops.mlp import init_mlp, mlp_apply, snake_alt
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as tff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    bf16_round, channel_minor, grid_sample_channel_minor,
    grid_sample_channel_minor_backward_bf16, grid_sample_channel_minor_bf16)
from latent_feature_grid_compression_tpu_torch.ops.mlp import mlp_apply_bf16
from tests.torch_port_util import to_port

BF16_SHARE, BF16_TOL, BF16_MAX = 0.999, 1e-6, 4e-3
GATHER_TOL = 1e-2
FUSED_FWD_TOL = dict(atol=2e-3, rtol=1e-2)
FUSED_GRAD_TOL = 1e-2
CHAIN_TOL = 2e-2
N_FREQS = 2

# (C, grid): grids 4, 8 and the flagship 15 at C 16 (the unblocked Pallas
# kernels), C 5, and grid 23 (H * W = 529 > 512: the HW-blocked kernels)
FETCH_SHAPES = [(16, 4), (16, 8), (16, 15), (5, 15), (16, 23)]


def _close(got, want):
    """(share of entries within BF16_TOL, max |got - want|), both relative
    to max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    return float((diff <= BF16_TOL * scale).mean()), float(diff.max() / scale)


def _assert_bf16_close(got, want):
    share, worst = _close(got, want)
    assert share >= BF16_SHARE and worst <= BF16_MAX, (share, worst)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fetch_inputs(C, G, n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, G, G, G)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)   # incl. OOB
    g = rng.standard_normal((n, C)).astype(np.float32)
    return feats, coords, g


@pytest.mark.parametrize('C,G', FETCH_SHAPES)
def test_plain_bf16_fetch_matches_pallas_interpret(C, G):
    feats, coords, _ = _fetch_inputs(C, G, 700, C + G)
    ref = jpk.pallas_grid_sample_3d(jnp.asarray(feats), jnp.asarray(coords),
                                    interpret=True, precision='bf16')
    out = grid_sample_channel_minor_bf16(channel_minor(torch.from_numpy(feats)),
                                         torch.from_numpy(coords))
    assert out.dtype == torch.float32
    _assert_bf16_close(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('C,G', FETCH_SHAPES)
def test_plain_bf16_grad_matches_pallas_vjp(C, G):
    """The grid's gradient against the Pallas 'bf16' backward (its
    ``jax.vjp``), laid out (C, D, H, W) as the features are."""
    feats, coords, g = _fetch_inputs(C, G, 700, 3 * C + G)
    _, vjp = jax.vjp(lambda f: jpk.pallas_grid_sample_3d(
        f, jnp.asarray(coords), interpret=True, precision='bf16'), jnp.asarray(feats))
    ref, = vjp(jnp.asarray(g))
    out = grid_sample_channel_minor_backward_bf16(torch.from_numpy(g),
                                                  torch.from_numpy(coords), G, G, G)
    assert out.dtype == torch.float32
    _assert_bf16_close(out.permute(3, 0, 1, 2).numpy(), np.asarray(ref))


@pytest.mark.parametrize('C,G', [(16, 15), (5, 15), (16, 23)])
def test_plain_bf16_fetch_against_the_xla_gather_on_a_bf16_grid(C, G):
    """JAX's 'auto' and 'xla' on the CPU under bf16 gather from a bf16 grid
    with float32 weights: other rounding points than the TPU's Pallas path,
    which the port follows (ROADMAP Queue 3)."""
    feats, coords, _ = _fetch_inputs(C, G, 1500, 7 * C + G)
    ref = jax_grid_sample_3d(jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(coords))
    out = grid_sample_channel_minor_bf16(channel_minor(torch.from_numpy(feats)),
                                         torch.from_numpy(coords))
    assert _rel(out.numpy(), np.asarray(ref.astype(jnp.float32))) <= GATHER_TOL


def test_plain_bf16_fetch_takes_the_bf16_copy_alike():
    """The plain version gives the same bits from a bf16 copy of the grid
    as from the float32 grid, since it rounds the grid first; the kernel
    rounds each float32 value of the grid as it loads it."""
    feats, coords, _ = _fetch_inputs(16, 15, 500, 1)
    grid, c = channel_minor(torch.from_numpy(feats)), torch.from_numpy(coords)
    assert torch.equal(grid_sample_channel_minor_bf16(grid, c),
                       grid_sample_channel_minor_bf16(grid.to(torch.bfloat16), c))


def test_plain_bf16_fetch_rounds_at_the_pallas_points():
    """One point, written out: each z plane's bf16(wxy) * bf16(G) summed in
    float32, times wz rounded to bf16, the planes added in float32."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((3, 4, 4, 4)).astype(np.float32))
    pt = torch.tensor([[0.1234, -0.377, 0.61]])
    grid = channel_minor(feats)
    pix = ((pt[0] + 1.0) * 4 - 1.0) * 0.5
    lo = torch.floor(pix)
    f = pix - lo
    x0, y0, z0 = (int(v) for v in lo)
    want = torch.zeros(3)
    for dz in (0, 1):
        plane = torch.zeros(3)
        for dy in (0, 1):
            for dx in (0, 1):
                wxy = (f[0] if dx else 1 - f[0]) * (f[1] if dy else 1 - f[1])
                plane = plane + bf16_round(wxy) * bf16_round(grid[z0 + dz, y0 + dy, x0 + dx])
        want = want + bf16_round((f[2] if dz else 1 - f[2]) * plane)
    assert torch.equal(grid_sample_channel_minor_bf16(grid, pt)[0], want)


def test_fetch_bf16_on_the_cpu_takes_the_plain_versions():
    """``fetch(..., 'bf16')`` on CPU tensors: the plain 'bf16' forward and
    gradient (a float32 gradient of the float32 grid), no kernel launch."""
    feats, coords, g = _fetch_inputs(16, 8, 300, 2)
    grid = channel_minor(torch.from_numpy(feats)).requires_grad_(True)
    c, gt = torch.from_numpy(coords), torch.from_numpy(g)
    before = (gs.launches, gs.bwd_launches, gs.bf16_launches, gs.bf16_bwd_launches)
    out = gs.fetch(grid, c, 'bf16')
    out.backward(gt)
    assert (gs.launches, gs.bwd_launches, gs.bf16_launches, gs.bf16_bwd_launches) == before
    assert torch.equal(out.detach(), grid_sample_channel_minor_bf16(grid.detach(), c))
    assert grid.grad.dtype == torch.float32
    assert torch.equal(grid.grad, grid_sample_channel_minor_backward_bf16(gt, c, 8, 8, 8))
    assert not torch.equal(out.detach(), grid_sample_channel_minor(grid.detach(), c))
    with pytest.raises(ValueError, match='precision'):
        gs.fetch(grid, c, 'fp16')


def test_bf16_cuda_wrappers_refuse_cpu_tensors():
    feats, coords, g = _fetch_inputs(8, 6, 50, 3)
    grid, c = channel_minor(torch.from_numpy(feats)), torch.from_numpy(coords)
    before = (gs.bf16_launches, gs.bf16_bwd_launches)
    with pytest.raises(ValueError, match='CUDA tensor'):
        gs.grid_sample_channel_minor_bf16_cuda(grid, c)
    with pytest.raises(ValueError, match='CUDA tensor'):
        gs.grid_sample_channel_minor_backward_bf16_cuda(torch.from_numpy(g), c, 6, 6, 6)
    assert (gs.bf16_launches, gs.bf16_bwd_launches) == before


# ---------------------------------------------------------------------------
# the one-kernel forward in 'bf16'
# ---------------------------------------------------------------------------

def _fused_inputs(C, G, hidden, layers, n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, G, G, G)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    ws, bs = init_mlp(jax.random.key(seed), 3 + 6 * N_FREQS + C, hidden, 1, layers)
    ct = rng.standard_normal((n, 1)).astype(np.float32)
    return feats, coords, tuple(ws), tuple(bs), ct


def _jax_fused(feats, coords, ws, bs):
    return jff.fused_forward(feats, jnp.asarray(coords), ws, bs, N_FREQS,
                             precision='bf16', interpret=True, block_n=128)


# the JAX fused test's shape and the flagship's
@pytest.mark.parametrize('shape', [(8, 9, 16, 3, 200), (16, 15, 32, 4, 1024)])
def test_plain_fused_bf16_matches_jax_kernel(shape):
    """Forward, and the gradients of the (C, D, H, W) features (through the
    channel-minor copy) and of every MLP parameter, each relative to its
    max |.|."""
    feats, coords, ws, bs, ct = _fused_inputs(*shape, seed=shape[0])
    ref = np.asarray(_jax_fused(jnp.asarray(feats), coords, ws, bs))

    def loss(args):
        return jnp.sum(_jax_fused(args[0], coords, args[1], args[2]) * ct)
    g_f, g_ws, g_bs = jax.grad(loss)((jnp.asarray(feats), ws, bs))
    tf = torch.from_numpy(feats).requires_grad_(True)
    tw = [torch.from_numpy(np.asarray(w).T.copy()).requires_grad_(True) for w in ws]
    tb = [torch.from_numpy(np.array(b)).requires_grad_(True) for b in bs]
    out = tff.fused_forward(channel_minor(tf), torch.from_numpy(coords), tw, tb,
                            N_FREQS, 'bf16')
    np.testing.assert_allclose(out.detach().numpy(), ref, **FUSED_FWD_TOL)
    (out * torch.from_numpy(ct)).sum().backward()
    pairs = ([(tf.grad, g_f)] + [(w.grad, np.asarray(g).T) for w, g in zip(tw, g_ws)]
             + [(b.grad, g) for b, g in zip(tb, g_bs)])
    for got, want in pairs:
        assert _rel(got.numpy(), want) <= FUSED_GRAD_TOL


def test_plain_fused_bf16_features_are_the_bf16_fetch():
    """x0's feature columns in 'bf16' are the plain 'bf16' fetch's; the
    MLP half is 'mixed''s."""
    feats, coords, ws, bs, _ = _fused_inputs(16, 15, 32, 4, 300, seed=2)
    grid, c = channel_minor(torch.from_numpy(feats)), torch.from_numpy(coords)
    x0 = tff.mlp_input(grid, c, N_FREQS, 'bf16')
    assert torch.equal(x0[:, 3 + 6 * N_FREQS:], grid_sample_channel_minor_bf16(grid, c))
    tw = [torch.from_numpy(np.asarray(w).T.copy()) for w in ws]
    tb = [torch.from_numpy(np.array(b)) for b in bs]
    bf16 = tff.fused_forward_plain(grid, c, tw, tb, N_FREQS, 'bf16')
    mixed = tff.fused_forward_plain(grid, c, tw, tb, N_FREQS, 'mixed')
    assert not torch.equal(bf16, mixed)
    assert _rel(bf16.numpy(), mixed.numpy()) <= FUSED_GRAD_TOL


# ---------------------------------------------------------------------------
# the bf16 MLP chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dims', [(31, 32, 4), (19, 24, 2)])
def test_bf16_chain_matches_jax_mlp_apply(dims):
    """``mlp_apply_bf16`` against JAX ``mlp_apply`` on bf16 arrays (the JAX
    ``apply_model``'s bf16 branch), forward and the float32 gradients of
    the float32 parameters and input through the casts."""
    d_in, hidden, layers = dims
    rng = np.random.default_rng(d_in)
    ws, bs = init_mlp(jax.random.key(d_in), d_in, hidden, 1, layers)
    x = rng.uniform(-1, 1, (500, d_in)).astype(np.float32)
    ct = rng.standard_normal((500, 1)).astype(np.float32)

    def jax_chain(ws, bs, x):
        out = mlp_apply([w.astype(jnp.bfloat16) for w in ws],
                        [b.astype(jnp.bfloat16) for b in bs], x.astype(jnp.bfloat16),
                        snake_alt)
        return out.astype(jnp.float32)
    ref = np.asarray(jax_chain(ws, bs, jnp.asarray(x)))
    g_ws, g_bs, g_x = jax.grad(lambda a: jnp.sum(jax_chain(*a) * ct))(
        (list(ws), list(bs), jnp.asarray(x)))
    tw = [torch.from_numpy(np.asarray(w).T.copy()).requires_grad_(True) for w in ws]
    tb = [torch.from_numpy(np.array(b)).requires_grad_(True) for b in bs]
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mlp_apply_bf16(tw, tb, tx)
    assert out.dtype == torch.float32
    assert _rel(out.detach().numpy(), ref) <= CHAIN_TOL
    (out * torch.from_numpy(ct)).sum().backward()
    pairs = ([(w.grad, np.asarray(g).T) for w, g in zip(tw, g_ws)]
             + [(b.grad, g) for b, g in zip(tb, g_bs)] + [(tx.grad, g_x)])
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= CHAIN_TOL


# ---------------------------------------------------------------------------
# apply_model under every bf16 row of the dispatch table
# ---------------------------------------------------------------------------

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=N_FREQS,
            grid_features=8, grid_size=8, wavelet='db2')
# the rows, as (JAX make_spec options, the port's); JAX's 'pallas' is the
# TPU's 'auto' at these grids, which the port's 'auto' follows on the card
ROWS = {
    'auto-bf16-xla': (dict(interp_backend='pallas', compute_dtype='bfloat16'),
                      dict(compute_dtype='bfloat16')),
    'auto-bf16-pallas': (dict(interp_backend='pallas', compute_dtype='bfloat16',
                              mlp_backend='pallas'),
                         dict(compute_dtype='bfloat16', mlp_backend='pallas')),
    'pallas_bf16-f32-xla': (dict(interp_backend='pallas_bf16'),
                            dict(interp_backend='pallas_bf16')),
    'pallas_bf16-f32-pallas': (dict(interp_backend='pallas_bf16', mlp_backend='pallas'),
                               dict(interp_backend='pallas_bf16', mlp_backend='pallas')),
    'pallas_bf16-bf16-xla': (dict(interp_backend='pallas_bf16', compute_dtype='bfloat16'),
                             dict(interp_backend='pallas_bf16', compute_dtype='bfloat16')),
    'pallas_bf16-bf16-pallas': (dict(interp_backend='pallas_bf16', compute_dtype='bfloat16',
                                     mlp_backend='pallas'),
                                dict(interp_backend='pallas_bf16', compute_dtype='bfloat16',
                                     mlp_backend='pallas')),
    'fused-bf16': (dict(interp_backend='fused', compute_dtype='bfloat16'),
                   dict(interp_backend='fused', compute_dtype='bfloat16'))}
# the rows that run the bf16 chain (CHAIN_TOL); the others take the MLP
# kernels' bf16 operands, or float32 PyTorch ops behind the 'bf16' fetch
ROW_TOL = {'auto-bf16-xla': CHAIN_TOL, 'pallas_bf16-bf16-xla': CHAIN_TOL,
           'auto-bf16-pallas': FUSED_GRAD_TOL, 'pallas_bf16-f32-pallas': FUSED_GRAD_TOL,
           'pallas_bf16-bf16-pallas': FUSED_GRAD_TOL, 'fused-bf16': FUSED_GRAD_TOL,
           'pallas_bf16-f32-xla': FUSED_GRAD_TOL}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode (on the CPU), as
    its own tests run them."""
    for mod, name in ((jpk, 'pallas_grid_sample_3d'), (jmp, 'mlp_apply_pallas'),
                      (jff, 'fused_forward')):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _f=orig, **k: _f(*a, **dict(k, interpret=True)))


def _models(row, seed=5):
    jspec = jfg.make_spec(**SPEC, **ROWS[row][0])
    tspec = tfg.make_spec(**SPEC, **ROWS[row][1])
    jparams, _ = jfg.init_model(jax.random.key(seed), jspec)
    return jspec, jparams, to_port(jparams, tspec)


def test_rows_dispatch_as_the_table():
    """Each row's spec: the fetch in 'bf16', the compute dtype recorded, the
    backends the JAX spec names."""
    for row, (jkw, tkw) in ROWS.items():
        jspec, tspec = jfg.make_spec(**SPEC, **jkw), tfg.make_spec(**SPEC, **tkw)
        assert tspec.fetch_precision == 'bf16', row
        assert tspec.compute_dtype == jspec.compute_dtype, row
        assert tspec.mlp_backend == jspec.mlp_backend, row
        assert tspec.interp_backend == ('fused' if jspec.interp_backend == 'fused'
                                        else 'trilinear'), row


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('row', sorted(ROWS))
def test_apply_model_bf16_rows_match_jax(row, train, pallas_interpret):
    jspec, jparams, model = _models(row)
    coords = np.random.default_rng(6).uniform(-1.1, 1.1, (700, 3)).astype(np.float32)
    ref = np.asarray(jfg.apply_model(jspec, jparams, jnp.asarray(coords), train=train))
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(coords), train=train)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _rel(out.numpy(), ref) <= ROW_TOL[row]
    if not train:
        assert float(out.abs().max()) <= 1.0


@pytest.mark.parametrize('row', sorted(ROWS))
def test_apply_model_bf16_rows_gradients_match_jax(row, pallas_interpret):
    """The gradients of every coefficient and MLP tensor under each row
    (the decode stays float32), each relative to its max |.|."""
    jspec, jparams, model = _models(row, seed=7)
    rng = np.random.default_rng(8)
    coords = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    ct = rng.standard_normal((600, 1)).astype(np.float32)

    def loss(p):
        return jnp.sum(jfg.apply_model(jspec, p, jnp.asarray(coords)) * ct)
    g = jax.grad(loss)(jparams)
    (tfg.apply_model(model, torch.from_numpy(coords)) * torch.from_numpy(ct)).sum().backward()
    pairs = ([(t.grad, r) for t, r in zip(model.coeffs, g.coeffs)]
             + [(t.grad, np.asarray(r).T) for t, r in zip(model.mlp_w, g.mlp_w)]
             + [(t.grad, r) for t, r in zip(model.mlp_b, g.mlp_b)])
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= ROW_TOL[row]


@pytest.mark.parametrize('interp', ['auto', 'xla'])
def test_apply_model_bf16_against_the_xla_gather_path(interp):
    """JAX's 'auto' and 'xla' under bf16 on the CPU: the XLA gather on a
    bf16 grid, then the bf16 chain; the port keeps the TPU's Pallas
    rounding, so the two differ at the gather's rounding points."""
    jspec = jfg.make_spec(**SPEC, interp_backend=interp, compute_dtype='bfloat16')
    assert jspec.interp_backend == 'xla'
    jparams, _ = jfg.init_model(jax.random.key(9), jspec)
    model = to_port(jparams, tfg.make_spec(**SPEC, interp_backend=interp,
                                           compute_dtype='bfloat16'))
    coords = np.random.default_rng(10).uniform(-1, 1, (700, 3)).astype(np.float32)
    ref = np.asarray(jfg.apply_model(jspec, jparams, jnp.asarray(coords)))
    with torch.no_grad():
        out = tfg.apply_model(model, torch.from_numpy(coords))
    assert _rel(out.numpy(), ref) <= max(GATHER_TOL, CHAIN_TOL)


def test_compute_dtype_float16_raises_as_in_jax():
    with pytest.raises(ValueError, match='compute_dtype'):
        tfg.make_spec(**SPEC, compute_dtype='float16')
    with pytest.raises(ValueError, match='compute_dtype'):
        jfg.make_spec(**SPEC, compute_dtype='float16')


def test_evaluation_stays_float32_under_bf16():
    """The evaluation's head (``predict_trilinear``) is the float32 fetch
    and MLP whatever the spec, as the JAX evaluation's gather path."""
    _, _, model = _models('auto-bf16-xla')
    f32 = to_port(_models('auto-bf16-xla')[1], tfg.make_spec(**SPEC))
    coords = torch.rand((400, 3)) * 2 - 1
    with torch.no_grad():
        grid = channel_minor(tfg.decode_volume(model))
        assert torch.equal(tfg.predict_trilinear(model, grid, coords),
                           tfg.apply_model(f32, coords, train=False))
        assert not torch.equal(tfg.predict_trilinear(model, grid, coords),
                               tfg.apply_model(model, coords, train=False))
