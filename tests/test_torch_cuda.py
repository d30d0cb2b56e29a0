"""The port on the card: the CUDA kernels (the fetch and its grid
gradient, the fused MLP forward and backward, the one-kernel model forward
and backward) against their plain PyTorch versions, the wrappers' checks,
and the model, evaluation and training paths through them.

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so it also runs where JAX is not installed; the
repo's ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval import reconstruct as rec
from latent_feature_grid_compression_tpu_torch.models import feature_grid as fg
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as ff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf
from latent_feature_grid_compression_tpu_torch.ops.embedding import fourier_embed
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    channel_minor, grid_sample_3d, grid_sample_channel_minor_backward)

pytestmark = pytest.mark.cuda

# same formula in float32, another summation order
KERNEL_TOL = 1e-5
# the MLP kernels against their plain versions (cuBLAS on the card), relative
# to max |.|: float32 sums in another order (over 32,768 samples for dW,
# db), atomics for dG; with bf16 operands a float32 sum that lands on the
# other side of a bf16 rounding boundary moves one operand by 2^-8 of itself
MLP_TOL = {'f32': (1e-5, 1e-4), 'bf16': (1e-2, 1e-2)}   # (forward, gradients)
FLAGSHIP = dict(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=2,
                grid_features=16, grid_size=15, wavelet='db2')


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test when there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA')
    return torch.device('cuda')


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal(shape).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)  # incl. OOB
    return torch.from_numpy(features), torch.from_numpy(coords)


# C = 5: the scalar path; C = 40: two channel blocks; (3, 5, 7, 9): axis order
@pytest.mark.parametrize('shape', [(16, 15, 15, 15), (16, 62, 62, 62),
                                   (5, 15, 15, 15), (32, 15, 15, 15),
                                   (40, 9, 9, 9), (3, 5, 7, 9)])
def test_kernel_matches_plain(cuda_device, shape):
    f, c = _inputs(shape, 4096, 6)
    before = gs.launches
    with torch.no_grad():
        out = gs.grid_sample_3d_cuda(f.to(cuda_device), c.to(cuda_device))
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), grid_sample_3d(f, c).numpy(),
                               atol=KERNEL_TOL)


def test_kernel_unaligned_grid_takes_scalar_path(cuda_device):
    """A grid whose storage starts 4 bytes past a 16-byte boundary cannot
    take float4 loads; the wrapper picks the scalar path."""
    f, c = _inputs((8, 6, 6, 6), 1000, 7)
    grid = channel_minor(f).to(cuda_device)
    storage = torch.empty(grid.numel() + 1, device=cuda_device)
    shifted = storage[1:].view(grid.shape)
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 != 0
    with torch.no_grad():
        out = gs.grid_sample_channel_minor_cuda(shifted, c.to(cuda_device))
    np.testing.assert_allclose(out.cpu().numpy(), grid_sample_3d(f, c).numpy(),
                               atol=KERNEL_TOL)


def test_kernel_empty_batch(cuda_device):
    f, _ = _inputs((4, 5, 5, 5), 1, 8)
    before = gs.launches
    out = gs.grid_sample_3d_cuda(f.to(cuda_device),
                                 torch.empty((0, 3), device=cuda_device))
    assert tuple(out.shape) == (0, 4) and gs.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    f, c = _inputs((4, 5, 5, 5), 10, 9)
    f, c = f.to(cuda_device), c.to(cuda_device)
    grid = channel_minor(f)
    before = gs.launches
    with pytest.raises(ValueError, match='float32'):
        gs.grid_sample_channel_minor_cuda(grid.double(), c)
    with pytest.raises(ValueError, match='contiguous'):
        gs.grid_sample_channel_minor_cuda(f.permute(1, 2, 3, 0), c)
    with pytest.raises(ValueError, match='coords'):
        gs.grid_sample_channel_minor_cuda(grid, c[:, :2].contiguous())
    with pytest.raises(ValueError, match='CUDA tensor'):
        gs.grid_sample_channel_minor_cuda(grid, c.cpu())
    assert gs.launches == before


def test_kernel_raises_under_grad(cuda_device):
    """Under grad the fetch is differentiable: the backward kernel gives the
    gradient; only a wrong tensor raises."""
    f = torch.randn((4, 5, 5, 5), device=cuda_device, requires_grad=True)
    c = torch.rand((10, 3), device=cuda_device) * 2 - 1
    before = (gs.launches, gs.bwd_launches)
    gs.grid_sample_3d_cuda(f, c).sum().backward()
    assert (gs.launches, gs.bwd_launches) == (before[0] + 1, before[1] + 1)
    f_cpu = f.detach().cpu().requires_grad_(True)
    grid_sample_3d(f_cpu, c.cpu()).sum().backward()
    np.testing.assert_allclose(f.grad.cpu().numpy(), f_cpu.grad.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match='float32'):
        gs.grid_sample_channel_minor_backward_cuda(
            torch.ones((10, 4), device=cuda_device, dtype=torch.float64), c, 5, 5, 5)


def _lattice_positions(n, res, seed):
    """(n, 3) IID voxel indices of a res^3 volume, normalized and scaled as
    the trainer does (the flagship volume is isotropic: scale 1)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    pos = torch.randint(0, res, (n, 3), generator=g, device='cuda', dtype=torch.int32)
    return (pos.to(torch.float32) / (res - 1)) * 2.0 - 1.0


# the flagship's trainer positions, then the NAS range of grids (23..62 are
# the blocked Pallas variant's) on random coordinates; C = 5 the scalar path
@pytest.mark.parametrize('C,G,kind', [(16, 15, 'lattice'), (16, 4, 'uniform'),
                                      (16, 22, 'uniform'), (16, 23, 'uniform'),
                                      (16, 32, 'uniform'), (16, 62, 'uniform'),
                                      (5, 15, 'uniform')])
def test_bwd_kernel_matches_plain(cuda_device, C, G, kind):
    """Atomics add in a run-dependent order: the tolerance is relative to
    the gradient's size, not 0."""
    n = 32768
    if kind == 'lattice':
        coords = _lattice_positions(n, 255, 0)
    else:
        coords = torch.rand((n, 3), device=cuda_device) * 2.4 - 1.2
    g = torch.randn((n, C), device=cuda_device)
    before = gs.bwd_launches
    out = gs.grid_sample_channel_minor_backward_cuda(g, coords, G, G, G)
    torch.cuda.synchronize()
    assert gs.bwd_launches == before + 1
    ref = grid_sample_channel_minor_backward(g, coords, G, G, G)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale


def test_bwd_kernel_unaligned_takes_scalar_path(cuda_device):
    c = torch.rand((1000, 3), device=cuda_device) * 2 - 1
    storage = torch.empty(1000 * 8 + 1, device=cuda_device)
    g = storage[1:].view(1000, 8)
    g.copy_(torch.randn((1000, 8), device=cuda_device))
    assert g.data_ptr() % 16 != 0
    out = gs.grid_sample_channel_minor_backward_cuda(g, c, 6, 6, 6)
    ref = grid_sample_channel_minor_backward(g, c, 6, 6, 6)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)


def _train_setup(device, res=64, drop_type='smallify', max_pass=60, **backends):
    """A phase at the flagship's widths and batch on a smaller volume."""
    from latent_feature_grid_compression_tpu_torch.config import TrainConfig
    from latent_feature_grid_compression_tpu_torch.data.synthetic import synth_volume
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    cfg = TrainConfig(batch_size=2048, sample_size=16, grid_size=15,
                      grid_features=16, drop_type=drop_type, max_pass=max_pass)
    spec = fg.make_spec(**dict(FLAGSHIP, drop_type=drop_type), **backends)
    model = fg.init_model(spec, torch.Generator().manual_seed(3), device=device)
    vol = torch.from_numpy(synth_volume(res, seed=1)).to(device)
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta((res,) * 3), phase=1)
    return tr, ph, model, vol


def test_train_step_on_card_matches_cpu(cuda_device):
    """One full step (forward, both kernels, autograd, Adam, tracker) from
    the same state and positions on the card and on the CPU."""
    outs = []
    for dev in (torch.device('cpu'), cuda_device):
        tr, ph, model, vol = _train_setup(dev)
        st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
        c = tr.PhaseConstants(ph, vol)
        g = torch.Generator().manual_seed(5)
        pos = torch.stack([torch.randint(0, 64, (1, ph.batch_n), generator=g)
                           for _ in range(3)], -1).to(dev)
        norm, gt = tr.chunk_inputs(c, pos)
        loss, _ = tr.train_step(ph, st, c, norm[0], gt[0])
        outs.append((float(loss), st.flat.cpu(), st.ema_var.cpu()))
    (l0, f0, e0), (l1, f1, e1) = outs
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    # Adam's first step moves each entry by ~lr: a gradient that differs in
    # its last bits (atomics) moves the update far less than that
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=1e-5)
    np.testing.assert_array_equal(e1.numpy(), e0.numpy())


def test_train_steps_on_card_launch_both_kernels(cuda_device):
    tr, ph, model, vol = _train_setup(cuda_device)
    st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
    gs.launches = gs.bwd_launches = 0
    losses = []
    st = tr.solve_phase(ph, st, vol, 40, generator=torch.Generator(
        device=cuda_device).manual_seed(0), verbose=False, metric_cb=losses.append)
    # 64^3 voxels at 32,768 samples a step: 8 steps a pass, and the phase's
    # 2/3 * 60 = 40 passes end at step 320
    assert st.step == 320
    assert gs.launches == gs.bwd_launches == st.step
    losses = np.concatenate(losses)
    assert np.isfinite(losses).all() and losses[-20:].mean() < 0.5 * losses[:20].mean()


def test_apply_model_on_card_matches_cpu(cuda_device):
    spec = fg.make_spec(**FLAGSHIP)
    model = fg.init_model(spec, torch.Generator().manual_seed(1), device='cpu')
    _, c = _inputs((1, 1, 1, 1), 5000, 10)
    with torch.no_grad():
        ref = fg.apply_model(model, c, train=False)
        before = gs.launches
        out = fg.apply_model(model.to(cuda_device), c.to(cuda_device), train=False)
    assert gs.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=5e-5)


def test_field_and_stats_on_card_match_cpu(cuda_device):
    """Anisotropic volume, chunked so the last chunk is padded."""
    shape = (20, 24, 28)
    meta = VolumeMeta(shape)
    spec = fg.make_spec(**FLAGSHIP)
    model = fg.init_model(spec, torch.Generator().manual_seed(2), device='cpu')
    vol = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    ref = rec.field_from_net(model, meta, chunk=4096, device='cpu')
    ref_stats = rec.eval_stats_on_device(model, meta, torch.from_numpy(vol),
                                         chunk=4096, device='cpu')
    before = gs.launches
    out = rec.field_from_net(model, meta, chunk=4096, device=cuda_device)
    assert gs.launches == before + -(-meta.n_voxels // 4096)
    stats = rec.eval_stats_on_device(model, meta, torch.from_numpy(vol),
                                     chunk=4096, device=cuda_device)
    np.testing.assert_allclose(out, ref, atol=5e-5)
    assert abs(stats[0] - ref_stats[0]) <= 1e-3


def _mlp_params(dims, device, seed):
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.rand((b, a), generator=g) * 2 - 1) / a ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(torch.rand((b,), generator=g) * 2 - 1) / a ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    return [w.to(device) for w in ws], [b.to(device) for b in bs]


def _rel(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), floor)


# a gradient summed over 32,768 samples can cancel to far below its terms
# (of order one here): its error is held against at least 1
GRAD_FLOOR = 1.0


# the flagship's widths, a wide and a narrow one, a 1-wide input and a
# single layer (every width <= 128; the bf16 kernels pad each to a multiple
# of 16); a train step's batch with a ragged last tile, one sample, 17, one
# sample over the bf16 backward's tile and over the forward's, and a point
# query of 2^18 + 3
@pytest.mark.parametrize('size', ['batch', '1', '17', 'tile+1', 'fwd_tile+1', 'query'])
@pytest.mark.parametrize('dims', [[31, 32, 32, 32, 32, 1], [128, 128, 128, 128, 4],
                                  [19, 24, 24, 3], [1, 8, 1], [40, 3]])
@pytest.mark.parametrize('precision', ['bf16', 'f32'])
def test_mlp_kernels_match_plain(cuda_device, dims, precision, size):
    n = {'batch': 32768 + 5, '1': 1, '17': 17,
         'tile+1': mf.bwd_plan(mf.KERNEL, dims, 'bf16')['tile'] + 1,
         'fwd_tile+1': mf.fwd_plan(mf.KERNEL, dims, 'bf16')['tile'] + 1,
         'query': (1 << 18) + 3}[size]
    ws, bs = _mlp_params(dims, cuda_device, 1)
    x = torch.randn((n, dims[0]), device=cuda_device)
    g = torch.randn((n, dims[-1]), device=cuda_device)
    before = (mf.launches, mf.bwd_launches)
    out = mf.mlp_fused_cuda(ws, bs, x, precision)
    dx, dws, dbs = mf.mlp_fused_backward_cuda(ws, bs, x, g, precision)
    torch.cuda.synchronize()
    assert (mf.launches, mf.bwd_launches) == (before[0] + 1, before[1] + 1)
    fwd_tol, grad_tol = MLP_TOL[precision]
    assert _rel(out, mf.mlp_fused_plain(ws, bs, x, precision)) <= fwd_tol
    rdx, rdws, rdbs = mf.mlp_fused_plain_backward(ws, bs, x, g, precision)
    for got, want in zip([dx] + dws + dbs, [rdx] + rdws + rdbs):
        assert got.shape == want.shape and _rel(got, want, GRAD_FLOOR) <= grad_tol
    # dW and db are summed in a fixed order: a second call gives the same bits
    dx2, dws2, dbs2 = mf.mlp_fused_backward_cuda(ws, bs, x, g, precision)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


def test_mlp_forward_streams_weights_that_do_not_fit(cuda_device):
    """Nine layers of 128 do not fit in shared memory at once: the bf16
    forward stages one layer's weights at a time, and still agrees."""
    dims = [128] * 9 + [4]
    assert mf.fwd_plan(mf.KERNEL, dims, 'bf16')['resident'] == 0
    ws, bs = _mlp_params(dims, cuda_device, 6)
    x = torch.randn((32768 + 5, dims[0]), device=cuda_device)
    out = mf.mlp_fused_cuda(ws, bs, x, 'bf16')
    assert _rel(out, mf.mlp_fused_plain(ws, bs, x, 'bf16')) <= MLP_TOL['bf16'][0]


# one sample, 17, one over the forward's bf16 tile, a train step's batch
@pytest.mark.parametrize('size', ['1', '17', 'fwd_tile+1', 'batch'])
@pytest.mark.parametrize('precision', ['mixed', 'f32'])
@pytest.mark.parametrize('C,G', [(16, 15), (8, 9), (5, 22)])
def test_fused_forward_kernels_match_plain(cuda_device, C, G, precision, size):
    dims = [3 + 12 + C, 32, 32, 32, 32, 1]
    n = {'1': 1, '17': 17, 'batch': 32768 + 5,
         'fwd_tile+1': mf.fwd_plan(ff.KERNEL, dims, 'mixed')['tile'] + 1}[size]
    ws, bs = _mlp_params(dims, cuda_device, 2)
    grid = torch.randn((G, G, G, C), device=cuda_device)
    coords = torch.rand((n, 3), device=cuda_device) * 2.4 - 1.2   # incl. OOB
    g = torch.randn((n, 1), device=cuda_device)
    before = (ff.launches, ff.bwd_launches, gs.launches, gs.bwd_launches)
    out = ff.fused_forward_cuda(grid, coords, ws, bs, 2, precision)
    dgrid, dws, dbs = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, precision)
    torch.cuda.synchronize()
    assert (ff.launches, ff.bwd_launches, gs.launches, gs.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    fwd_tol, grad_tol = MLP_TOL['bf16' if precision == 'mixed' else 'f32']
    assert _rel(out, ff.fused_forward_plain(grid, coords, ws, bs, 2, precision)) <= fwd_tol
    rdg, rdws, rdbs = ff.fused_forward_plain_backward(grid, coords, ws, bs, 2, g, precision)
    for got, want in zip([dgrid] + dws + dbs, [rdg] + rdws + rdbs):
        assert got.shape == want.shape and _rel(got, want, GRAD_FLOOR) <= grad_tol
    # dW and db are summed in a fixed order (dG by atomics, not): a second
    # call gives the same bits
    _, dws2, dbs2 = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, precision)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


def test_fused_forward_features_are_the_fetch_kernels(cuda_device):
    """In 'f32' the one-kernel forward equals the fetch kernel + [coords |
    fourier] + the fused MLP kernel: the features come out of the same
    arithmetic, and so does the MLP; only torch's sin/cos may round
    differently from the kernel's."""
    dims = [31, 32, 32, 32, 32, 1]
    ws, bs = _mlp_params(dims, cuda_device, 3)
    grid = torch.randn((15, 15, 15, 16), device=cuda_device)
    coords = torch.rand((20000, 3), device=cuda_device) * 2 - 1
    x0 = torch.cat([coords, fourier_embed(coords, 2),
                    gs.grid_sample_channel_minor_cuda(grid, coords)], dim=-1)
    two = mf.mlp_fused_cuda(ws, bs, x0, 'f32')
    one = ff.fused_forward_cuda(grid, coords, ws, bs, 2, 'f32')
    assert _rel(one, two) <= 1e-6


def test_mlp_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    ws, bs = _mlp_params([31, 32, 1], cuda_device, 4)
    x = torch.randn((100, 31), device=cuda_device)
    grid = torch.randn((9, 9, 9, 16), device=cuda_device)
    coords = torch.rand((100, 3), device=cuda_device) * 2 - 1
    before = (mf.launches, mf.bwd_launches, ff.launches, ff.bwd_launches)
    with pytest.raises(ValueError, match='CUDA tensor'):
        mf.mlp_fused_cuda(ws, bs, x.cpu())
    with pytest.raises(ValueError, match='CUDA tensor'):
        mf.mlp_fused_cuda([ws[0].cpu(), ws[1]], bs, x)
    with pytest.raises(ValueError, match='contiguous'):
        mf.mlp_fused_cuda(ws, bs, torch.randn((31, 100), device=cuda_device).t())
    with pytest.raises(ValueError, match='contiguous'):
        mf.mlp_fused_cuda([ws[0].t().contiguous().t(), ws[1]], bs, x)
    with pytest.raises(ValueError, match='float32'):
        mf.mlp_fused_cuda(ws, bs, x.double())
    wide_w, wide_b = _mlp_params([31, 129, 1], cuda_device, 5)
    with pytest.raises(ValueError, match='widths'):
        mf.mlp_fused_cuda(wide_w, wide_b, x)
    with pytest.raises(ValueError, match='CUDA tensor'):
        ff.fused_forward_cuda(grid.cpu(), coords, ws, bs, 2)
    with pytest.raises(ValueError, match='contiguous'):
        ff.fused_forward_cuda(grid.permute(1, 0, 2, 3), coords, ws, bs, 2)
    with pytest.raises(ValueError, match='widths'):
        ff.fused_forward_cuda(grid, coords, wide_w, wide_b, 2)
    assert (mf.launches, mf.bwd_launches, ff.launches, ff.bwd_launches) == before


BACKENDS = {'mlp_pallas': dict(mlp_backend='pallas'), 'fused': dict(interp_backend='fused')}


@pytest.mark.parametrize('backend', sorted(BACKENDS))
def test_train_step_on_card_matches_cpu_backends(cuda_device, backend):
    """One full step under each kernel backend from the same state and
    positions on the card (the kernels) and on the CPU (their plain
    versions)."""
    outs = []
    for dev in (torch.device('cpu'), cuda_device):
        tr, ph, model, vol = _train_setup(dev, **BACKENDS[backend])
        st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
        c = tr.PhaseConstants(ph, vol)
        g = torch.Generator().manual_seed(5)
        pos = torch.stack([torch.randint(0, 64, (1, ph.batch_n), generator=g)
                           for _ in range(3)], -1).to(dev)
        norm, gt = tr.chunk_inputs(c, pos)
        counts = (mf.launches, mf.bwd_launches, ff.launches, ff.bwd_launches,
                  gs.launches, gs.bwd_launches)
        loss, _ = tr.train_step(ph, st, c, norm[0], gt[0])
        counts = tuple(b - a for a, b in zip(counts, (
            mf.launches, mf.bwd_launches, ff.launches, ff.bwd_launches,
            gs.launches, gs.bwd_launches)))
        outs.append((float(loss), st.flat.cpu(), st.m.cpu(), st.ema_var.cpu(), counts))
    (l0, f0, m0, e0, c0), (l1, f1, m1, e1, c1) = outs
    assert c0 == (0,) * 6
    assert c1 == ((1, 1, 0, 0, 1, 1) if backend == 'mlp_pallas' else (0, 0, 1, 1, 0, 0))
    assert abs(l0 - l1) <= 1e-4 * abs(l0)
    assert _rel(m1, m0) <= 1e-2
    # Adam's first step moves each entry by ~lr in the sign of its gradient;
    # where the gradient is within its bf16 bound of 0 the sign may differ
    sure = m0.abs() > 1e-2 * m0.abs().max()
    np.testing.assert_allclose(f1[sure].numpy(), f0[sure].numpy(), atol=1e-5)
    assert float((f1 - f0).abs().max()) <= 2 * 0.008 * 1.0001
    np.testing.assert_array_equal(e1.numpy(), e0.numpy())


@pytest.mark.parametrize('backend', sorted(BACKENDS))
def test_train_steps_on_card_launch_the_backends_kernels(cuda_device, backend):
    tr, ph, model, vol = _train_setup(cuda_device, max_pass=6, **BACKENDS[backend])
    st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
    mf.launches = mf.bwd_launches = ff.launches = ff.bwd_launches = 0
    gs.launches = gs.bwd_launches = 0
    losses = []
    st = tr.solve_phase(ph, st, vol, 16, generator=torch.Generator(
        device=cuda_device).manual_seed(0), verbose=False, metric_cb=losses.append)
    # 8 steps a pass; the phase's 2/3 * 6 = 4 passes end at step 32
    assert st.step == 32
    if backend == 'mlp_pallas':
        assert mf.launches == mf.bwd_launches == gs.launches == gs.bwd_launches == 32
        assert ff.launches == ff.bwd_launches == 0
    else:
        assert ff.launches == ff.bwd_launches == 32
        assert mf.launches == mf.bwd_launches == gs.launches == gs.bwd_launches == 0
    losses = np.concatenate(losses)
    assert np.isfinite(losses).all() and losses[-8:].mean() < losses[:8].mean()


@pytest.mark.parametrize('backend', sorted(BACKENDS))
def test_apply_model_on_card_matches_cpu_backends(cuda_device, backend):
    spec = fg.make_spec(**FLAGSHIP, **BACKENDS[backend])
    model = fg.init_model(spec, torch.Generator().manual_seed(1), device='cpu')
    _, c = _inputs((1, 1, 1, 1), 5000, 10)
    with torch.no_grad():
        ref = fg.apply_model(model, c, train=False)
        out = fg.apply_model(model.to(cuda_device), c.to(cuda_device), train=False)
    assert _rel(out.cpu(), ref) <= MLP_TOL['bf16'][0]
