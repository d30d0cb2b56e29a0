"""The port on the card: the CUDA kernels (the fetch and its grid
gradient, the fused MLP forward and backward, the one-kernel model forward
and backward, each mode of them: the 'bf16' ones of the bf16 compute path
too) against their plain PyTorch versions, the wrappers' checks, and the
model, evaluation and training paths through them (every gate family's
train step, and the bf16 compute path's).

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
    channel_minor, grid_sample_3d, grid_sample_channel_minor_backward,
    grid_sample_channel_minor_backward_bf16, grid_sample_channel_minor_bf16)

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


# C % 4 != 0 (1, 3, 5): scalar loads, 4 channels a lane; C = 40: 10 lanes a
# sample, 3 samples a warp; C = 64: 16 lanes, 2 samples; (3, 5, 7, 9): axis
# order; grids 4..62.  n: one sample, a partial warp step, one over a warp
# step of C = 16, a train step's batch + 5 and an evaluation chunk + 3
@pytest.mark.parametrize('n', [1, 7, 33, 32768 + 5, (1 << 18) + 3])
@pytest.mark.parametrize('shape', [(16, 15, 15, 15), (16, 62, 62, 62),
                                   (5, 15, 15, 15), (32, 15, 15, 15),
                                   (40, 9, 9, 9), (3, 5, 7, 9), (1, 4, 4, 4),
                                   (4, 23, 23, 23), (8, 32, 32, 32), (64, 6, 6, 6)])
def test_kernel_matches_plain(cuda_device, shape, n):
    f, c = _inputs(shape, n, 6)
    before = gs.launches
    with torch.no_grad():
        out = gs.grid_sample_3d_cuda(f.to(cuda_device), c.to(cuda_device))
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), grid_sample_3d(f, c).numpy(),
                               atol=KERNEL_TOL)
    C, D, H, W = shape
    plan = gs.fwd_plan(n, C, D, H, W, C % 4 == 0)
    lanes = min(-(-C // plan['channels_per_lane']), 32)
    assert plan['route'] == ('float4' if C % 4 == 0 else 'scalar')
    assert plan['samples_per_warp'] == 32 // lanes
    assert plan['blocks'] <= plan['blocks_per_sm'] * torch.cuda.get_device_properties(
        cuda_device).multi_processor_count


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


def _route_edge(C):
    """The largest cubic grid whose C-channel gradient takes the shared
    route and the smallest that takes the global one, from the plan."""
    routes = {G: gs.bwd_plan(32768, C, G, G, G)['route'] for G in range(4, 63)}
    shared = [G for G, r in routes.items() if r == 'shared']
    glob = [G for G, r in routes.items() if r == 'global']
    assert shared and glob and max(shared) < min(glob), routes
    return {'last_shared': max(shared), 'first_global': min(glob)}


# the flagship's trainer positions, then the NAS range of grids (23..62 are
# the blocked Pallas variant's) on random coordinates, the edge between the
# two routes, C = 5 (scalar adds), 8 and 32
@pytest.mark.parametrize('C,G,kind', [(16, 15, 'lattice'), (16, 4, 'uniform'),
                                      (16, 22, 'uniform'), (16, 23, 'uniform'),
                                      (16, 32, 'uniform'), (16, 62, 'uniform'),
                                      (5, 15, 'uniform'), (8, 15, 'uniform'),
                                      (32, 15, 'uniform'), (16, 'last_shared', 'uniform'),
                                      (16, 'first_global', 'uniform')])
def test_bwd_kernel_matches_plain(cuda_device, C, G, kind):
    """Atomics add in a run-dependent order: the tolerance is relative to
    the gradient's size, not 0."""
    n = 32768
    if isinstance(G, str):
        route, G = G.split('_')[1], _route_edge(C)[G]
        assert gs.bwd_plan(n, C, G, G, G)['route'] == route
    if kind == 'lattice':
        coords = _lattice_positions(n, 255, 0)
        assert gs.bwd_plan(n, C, G, G, G)['route'] == 'global'
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


def test_bwd_plan_follows_the_shape(cuda_device):
    """The route comes from the shape and n: the flagship's 78 adds an
    address of dG take the global route; grid 4's 4,096 take the blocks'
    shared memory, about one block an SM; with 4,096 samples grid 4 takes
    512 an address and the global route; grid 62's dG never fits."""
    assert gs.bwd_plan(32768, 16, 15, 15, 15)['route'] == 'global'
    small = gs.bwd_plan(32768, 16, 4, 4, 4)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert small['route'] == 'shared' and small['blocks'] == sms
    assert small['smem_bytes'] == 4 ** 3 * 16 * 4 and small['threads'] == 1024
    assert gs.bwd_plan(4096, 16, 4, 4, 4)['route'] == 'global'
    big = gs.bwd_plan(1 << 30, 16, 62, 62, 62)
    assert big['route'] == 'global' and big['smem_bytes'] == 0


@pytest.mark.parametrize('n', [0, 1])
def test_bwd_kernel_tiny_batches(cuda_device, n):
    c = torch.rand((n, 3), device=cuda_device) * 2 - 1
    g = torch.randn((n, 16), device=cuda_device)
    before = gs.bwd_launches
    out = gs.grid_sample_channel_minor_backward_cuda(g, c, 15, 15, 15)
    torch.cuda.synchronize()
    assert gs.bwd_launches == before + (n > 0)
    ref = grid_sample_channel_minor_backward(g, c, 15, 15, 15)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-6)


def test_bwd_kernel_unaligned_takes_scalar_path(cuda_device):
    c = torch.rand((1000, 3), device=cuda_device) * 2 - 1
    storage = torch.empty(1000 * 8 + 1, device=cuda_device)
    g = storage[1:].view(1000, 8)
    g.copy_(torch.randn((1000, 8), device=cuda_device))
    assert g.data_ptr() % 16 != 0
    out = gs.grid_sample_channel_minor_backward_cuda(g, c, 6, 6, 6)
    ref = grid_sample_channel_minor_backward(g, c, 6, 6, 6)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)


def test_bwd_kernel_unaligned_on_the_shared_route(cuda_device):
    """Scalar adds and a scalar flush on the shared route: 4,096 samples on
    grid 3 add 1,214 times into each address of dG (so the tolerance, as
    for every atomic sum, is relative to max |dG|)."""
    n = 4096
    c = torch.rand((n, 3), device=cuda_device) * 2 - 1
    storage = torch.empty(n * 8 + 1, device=cuda_device)
    g = storage[1:].view(n, 8)
    g.copy_(torch.randn((n, 8), device=cuda_device))
    assert g.data_ptr() % 16 != 0
    assert gs.bwd_plan(n, 8, 3, 3, 3, False)['route'] == 'shared'
    out = gs.grid_sample_channel_minor_backward_cuda(g, c, 3, 3, 3)
    ref = grid_sample_channel_minor_backward(g, c, 3, 3, 3)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _train_setup(device, res=64, drop_type='smallify', max_pass=60, cfg_kw=None,
                 **backends):
    """A phase at the flagship's widths and batch on a smaller volume."""
    from latent_feature_grid_compression_tpu_torch.config import TrainConfig
    from latent_feature_grid_compression_tpu_torch.data.synthetic import synth_volume
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    cfg = TrainConfig(batch_size=2048, sample_size=16, grid_size=15,
                      grid_features=16, drop_type=drop_type, max_pass=max_pass,
                      **(cfg_kw or {}))
    spec = fg.make_spec(**dict(FLAGSHIP, drop_type=drop_type), **backends)
    model = fg.init_model(spec, torch.Generator().manual_seed(3), device=device)
    vol = torch.from_numpy(synth_volume(res, seed=1)).to(device)
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta((res,) * 3), phase=1)
    return tr, ph, model, vol


def _train_step_pair(device):
    """One full float32 step (forward, both kernels, autograd, Adam,
    tracker) from the same state and positions on the CPU and on
    ``device``: (loss, flat parameters, Adam's first moment, tracker) of
    each."""
    outs = []
    for dev in (torch.device('cpu'), device):
        tr, ph, model, vol = _train_setup(dev)
        st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
        c = tr.PhaseConstants(ph, vol)
        g = torch.Generator().manual_seed(5)
        pos = torch.stack([torch.randint(0, 64, (1, ph.batch_n), generator=g)
                           for _ in range(3)], -1).to(dev)
        norm, gt = tr.chunk_inputs(c, pos)
        loss, _ = tr.train_step(ph, st, c, norm[0], gt[0])
        outs.append((float(loss), st.flat.cpu(), st.m.cpu(), st.ema_var.cpu()))
    return outs


# Adam's first step moves each entry by lr * g / (|g| + eps), eps = 1e-8:
# ~lr in the sign of g, but where |g| is within a few orders of eps the
# step depends on g's last bits, which the gradient kernel's atomics move.
# On an H100 the largest step differences sit at entries whose |m0| is
# below 3e-6 of max |m0| (python tests/test_torch_cuda.py --repeat N prints
# them); the step is held to 1e-5 above ADAM_SURE_SHARE of max |m0|
ADAM_SURE_SHARE = 1e-4


def test_train_step_on_card_matches_cpu(cuda_device):
    """One full step from the same state and positions on the card and on
    the CPU: the loss and the first moment to 1e-5 (the gradient kernel's
    atomics sum in another order), the Adam step to 1e-5 where the
    gradient is well clear of eps, every step within 2 lr."""
    (l0, f0, m0, e0), (l1, f1, m1, e1) = _train_step_pair(cuda_device)
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    assert _rel(m1, m0) <= 1e-5
    sure = m0.abs() > ADAM_SURE_SHARE * m0.abs().max()
    np.testing.assert_allclose(f1[sure].numpy(), f0[sure].numpy(), atol=1e-5)
    assert float((f1 - f0).abs().max()) <= 2 * 0.008 * 1.0001
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


# the published settings of the other gate families (mhd_p_masked_st.txt,
# mhd_p_static_variational.txt, mhd_p_dynamic_variational.txt)
FAMILY_CFG = {
    'straight_through': dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8),
    'masked_straight_through': dict(lambda_drop_loss=1e-6, lambda_weight_loss=1e-8),
    'static_variational': dict(lambda_drop_loss=1.0, lambda_weight_loss=2.0,
                               variational_sigma=-7.0, weight_dkl_multiplier=5e-5),
    'dynamic_variational': dict(lambda_drop_loss=0.1, lambda_weight_loss=2.0,
                                variational_sigma=0.0, weight_dkl_multiplier=3e-5)}


@pytest.mark.parametrize('drop_type', sorted(FAMILY_CFG))
def test_train_step_on_card_matches_cpu_families(cuda_device, drop_type):
    """One full step of each other gate family (both kernels, the gate
    noise, the family's loss at its published settings; the variance model
    for the dynamic one) from the same state, positions and noise on the
    card and on the CPU.  The variational gradients reach ~1e9: every
    comparison is relative."""
    from latent_feature_grid_compression_tpu_torch.models.variance import init_variance_model
    outs = []
    for dev in (torch.device('cpu'), cuda_device):
        tr, ph, model, vol = _train_setup(dev, drop_type=drop_type,
                                          cfg_kw=FAMILY_CFG[drop_type])
        variance = None
        if 'dynamic' in drop_type:
            variance = tuple([t.to(dev) for t in ts]
                             for ts in init_variance_model(torch.Generator().manual_seed(4)))
        st = tr.init_train_state(model, 0.008, 0.008, train_gates=True, variance=variance,
                                 weight_dkl=FAMILY_CFG[drop_type]['lambda_drop_loss'])
        c = tr.PhaseConstants(ph, vol)
        g = torch.Generator().manual_seed(5)
        pos = torch.stack([torch.randint(0, 64, (1, ph.batch_n), generator=g)
                           for _ in range(3)], -1).to(dev)
        noise = tr.draw_noise(ph, 1, g, torch.device('cpu'))
        norm, gt = tr.chunk_inputs(c, pos)
        counts = (gs.launches, gs.bwd_launches)
        loss, vol_loss = tr.train_step(ph, st, c, norm[0], gt[0], noise=None if noise is None
                                       else [a[0].to(dev) for a in noise])
        counts = (gs.launches - counts[0], gs.bwd_launches - counts[1])
        outs.append((float(loss), float(vol_loss), st.flat.cpu(), st.m.cpu(),
                     float(st.weight_dkl), counts))
    (l0, v0, f0, m0, w0, c0), (l1, v1, f1, m1, w1, c1) = outs
    assert c0 == (0, 0) and c1 == (1, 1)
    assert abs(l0 - l1) <= 1e-5 * abs(l0) and abs(v0 - v1) <= 1e-5 * abs(v0)
    assert w0 == w1
    assert _rel(m1, m0) <= 1e-4
    # Adam's first step moves each entry by ~lr in the sign of its gradient;
    # where the gradient is within its rounding of 0 the sign may differ
    sure = m0.abs() > 1e-4 * m0.abs().max()
    np.testing.assert_allclose(f1[sure].numpy(), f0[sure].numpy(), atol=1e-5)
    assert float((f1 - f0).abs().max()) <= 2 * 0.008 * 1.0001


@pytest.mark.parametrize('route', ['mlp', 'fused'])
def test_backward_kernels_at_the_variational_gradient_scale(cuda_device, route):
    """The bf16 backward kernels given an upstream gradient of ~1e9 (the
    static variational loss: squared error over sigma^2 = e^-14, times
    n_voxels / N): bf16 has float32's exponent range, so the gradients stay
    within the bf16 tolerance of the plain versions, relative to their own
    scale."""
    dims = [31, 32, 32, 32, 32, 1]
    n = 32768
    ws, bs = _mlp_params(dims, cuda_device, 7)
    scale = 1e9
    g = torch.randn((n, 1), device=cuda_device) * scale
    if route == 'mlp':
        x = torch.randn((n, dims[0]), device=cuda_device)
        got = mf.mlp_fused_backward_cuda(ws, bs, x, g, 'bf16')
        want = mf.mlp_fused_plain_backward(ws, bs, x, g, 'bf16')
    else:
        grid = torch.randn((15, 15, 15, 16), device=cuda_device)
        coords = torch.rand((n, 3), device=cuda_device) * 2 - 1
        got = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, 'mixed')
        want = ff.fused_forward_plain_backward(grid, coords, ws, bs, 2, g, 'mixed')
    got = [got[0]] + list(got[1]) + list(got[2])
    want = [want[0]] + list(want[1]) + list(want[2])
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b, GRAD_FLOOR * scale) <= MLP_TOL['bf16'][1]


# ---------------------------------------------------------------------------
# the bf16 compute path: the 'bf16' modes
# ---------------------------------------------------------------------------

# the 'bf16' fetch and gradient against their plain versions, relative to
# max |.|: at least BF16_SHARE of the entries within BF16_TOL, all within
# BF16_MAX (the plain versions round at the kernels' points and every
# product is exact: only a float32 summation order differs, by atomics in
# the gradient, and where that straddles a bf16 rounding boundary one value
# moves by a bf16 ulp); the gradient against its terms summed in float64
# (two float32 orders of a grid-4 entry's 4,096 adds differ by ~1e-6)
BF16_SHARE, BF16_TOL, BF16_MAX = 0.999, 1e-6, 4e-3


def _bf16_close(got, want):
    scale = float(want.abs().max())
    diff = (got.double() - want.double()).abs()
    return (float((diff <= BF16_TOL * scale).double().mean()) >= BF16_SHARE
            and float(diff.max()) <= BF16_MAX * scale)


# the flagship, grid 23 (the blocked Pallas kernels' counterpart), C 5 and C
# 22 (guarded scalar loads: C % 4 != 0), C 8 on grid 4, one channel, C = 40
# (10 float4 lanes a sample) and C = 264 (a sample's lanes loop); one
# sample, a partial warp step, a train step's batch + 5 and an evaluation
# chunk + 3
BF16_FETCH_SHAPES = [(16, 15, 15, 15), (16, 23, 23, 23), (5, 15, 15, 15), (22, 17, 17, 17),
                     (8, 4, 4, 4), (1, 4, 4, 4), (40, 9, 9, 9), (264, 3, 5, 7)]


@pytest.mark.parametrize('n', [1, 33, 32768 + 5, (1 << 18) + 3])
@pytest.mark.parametrize('shape', BF16_FETCH_SHAPES)
def test_bf16_fetch_kernel_matches_plain(cuda_device, shape, n):
    f, c = _inputs(shape, n, 11)
    grid = channel_minor(f).to(cuda_device)
    c = c.to(cuda_device)
    before = (gs.launches, gs.bf16_launches)
    with torch.no_grad():
        out = gs.grid_sample_channel_minor_bf16_cuda(grid, c)
    torch.cuda.synchronize()
    assert (gs.launches, gs.bf16_launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    assert _bf16_close(out, grid_sample_channel_minor_bf16(grid, c))
    C, D, H, W = shape
    plan = gs.fwd_plan(n, C, D, H, W, C % 4 == 0, 'bf16')
    assert plan['route'] == ('float4' if C % 4 == 0 else 'scalar')
    assert plan['mode'] == 'bf16'
    # 8 channels a lane where the samples fill the card several times over:
    # at the flagship, a lattice chunk's but not a train step's
    assert plan['channels_per_lane'] in (4, 8)
    if shape == (16, 15, 15, 15) and n > 33:
        assert plan['channels_per_lane'] == (8 if n > (1 << 18) else 4)
    assert plan['samples_per_warp'] == 32 // min(-(-C // plan['channels_per_lane']), 32)


@pytest.mark.parametrize('shape', BF16_FETCH_SHAPES)
def test_bf16_fetch_launches_one_kernel_bit_for_bit(cuda_device, shape):
    """fetch(..., 'bf16') from the float32 grid launches the fetch kernel
    and no other kernel (no copy of the grid), and equals the plain version
    bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f, c = _inputs(shape, 32768 + 5, 14)
    grid, c = channel_minor(f).to(cuda_device), c.to(cuda_device)
    with torch.no_grad():
        gs.fetch(grid, c, 'bf16')   # builds and loads the kernel
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = gs.fetch(grid, c, 'bf16')
            torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert 'grid_sample_fwd_kernel' in kernels[0][0]
    assert torch.equal(out, grid_sample_channel_minor_bf16(grid, c))


def test_bf16_fetch_unaligned_grid_takes_scalar_path(cuda_device):
    f, c = _inputs((8, 6, 6, 6), 1000, 12)
    grid = channel_minor(f).to(cuda_device)
    storage = torch.empty(grid.numel() + 1, device=cuda_device)
    shifted = storage[1:].view(grid.shape)
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 != 0
    with torch.no_grad():
        out = gs.grid_sample_channel_minor_bf16_cuda(shifted, c.to(cuda_device))
    assert _bf16_close(out, grid_sample_channel_minor_bf16(grid, c.to(cuda_device)))


@pytest.mark.parametrize('C,G,kind', [(16, 15, 'lattice'), (16, 4, 'uniform'),
                                      (16, 23, 'uniform'), (5, 15, 'uniform'),
                                      (22, 17, 'lattice'), (16, 'last_shared', 'uniform'),
                                      (16, 'first_global', 'uniform')])
def test_bf16_bwd_kernel_matches_plain(cuda_device, C, G, kind):
    """Both routes of the 'bf16' gradient (chosen as in 'f32')."""
    n = 32768
    if isinstance(G, str):
        route, G = G.split('_')[1], _route_edge(C)[G]
        assert gs.bwd_plan(n, C, G, G, G, precision='bf16')['route'] == route
    coords = (_lattice_positions(n, 255, 1) if kind == 'lattice'
              else torch.rand((n, 3), device=cuda_device) * 2.4 - 1.2)
    g = torch.randn((n, C), device=cuda_device)
    before = (gs.bwd_launches, gs.bf16_bwd_launches)
    out = gs.grid_sample_channel_minor_backward_bf16_cuda(g, coords, G, G, G)
    torch.cuda.synchronize()
    assert (gs.bwd_launches, gs.bf16_bwd_launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    want = grid_sample_channel_minor_backward_bf16(g, coords, G, G, G, torch.float64)
    assert _bf16_close(out, want)
    assert (gs.bwd_plan(n, C, G, G, G, precision='bf16')['route']
            == gs.bwd_plan(n, C, G, G, G)['route'])


def test_fetch_bf16_never_runs_the_float32_kernels(cuda_device):
    """fetch(..., 'bf16') forward and backward launch the 'bf16' kernels
    only, and the grid's gradient stays float32; 'f32' launches no 'bf16'
    kernel."""
    grid = torch.randn((15, 15, 15, 16), device=cuda_device, requires_grad=True)
    c = torch.rand((5000, 3), device=cuda_device) * 2 - 1
    counts = lambda: (gs.launches, gs.bwd_launches, gs.bf16_launches, gs.bf16_bwd_launches)
    before = counts()
    out = gs.fetch(grid, c, 'bf16')
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counts())) == (0, 0, 1, 1)
    assert out.dtype == grid.grad.dtype == torch.float32
    assert _bf16_close(out.detach(), grid_sample_channel_minor_bf16(grid.detach(), c))
    before = counts()
    gs.fetch(grid, c, 'f32').sum().backward()
    assert tuple(b - a for a, b in zip(before, counts())) == (1, 1, 0, 0)


def test_bf16_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    f, c = _inputs((4, 5, 5, 5), 10, 13)
    grid, c = channel_minor(f).to(cuda_device), c.to(cuda_device)
    before = (gs.bf16_launches, gs.bf16_bwd_launches)
    with pytest.raises(ValueError, match='float32'):
        gs.grid_sample_channel_minor_bf16_cuda(grid.to(torch.bfloat16), c)
    with pytest.raises(ValueError, match='float32'):
        gs.grid_sample_channel_minor_bf16_cuda(grid, c.double())
    with pytest.raises(ValueError, match='CUDA tensor'):
        gs.grid_sample_channel_minor_bf16_cuda(grid, c.cpu())
    with pytest.raises(ValueError, match='float32'):
        gs.grid_sample_channel_minor_backward_bf16_cuda(
            torch.ones((10, 4), device=cuda_device, dtype=torch.bfloat16), c, 5, 5, 5)
    with pytest.raises(ValueError, match='precision'):
        gs.fetch(grid, c, 'f16')
    assert (gs.bf16_launches, gs.bf16_bwd_launches) == before


@pytest.mark.parametrize('size', ['1', '17', 'batch'])
@pytest.mark.parametrize('C,G', [(16, 15), (8, 9), (5, 22)])
def test_fused_forward_bf16_kernels_match_plain(cuda_device, C, G, size):
    dims = [3 + 12 + C, 32, 32, 32, 32, 1]
    n = {'1': 1, '17': 17, 'batch': 32768 + 5}[size]
    ws, bs = _mlp_params(dims, cuda_device, 4)
    grid = torch.randn((G, G, G, C), device=cuda_device)
    coords = torch.rand((n, 3), device=cuda_device) * 2.4 - 1.2   # incl. OOB
    g = torch.randn((n, 1), device=cuda_device)
    counts = lambda: (ff.launches, ff.bwd_launches, ff.bf16_launches, ff.bf16_bwd_launches)
    before = counts()
    out = ff.fused_forward_cuda(grid, coords, ws, bs, 2, 'bf16')
    dgrid, dws, dbs = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, 'bf16')
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counts())) == (0, 0, 1, 1)
    fwd_tol, grad_tol = MLP_TOL['bf16']
    assert _rel(out, ff.fused_forward_plain(grid, coords, ws, bs, 2, 'bf16')) <= fwd_tol
    rdg, rdws, rdbs = ff.fused_forward_plain_backward(grid, coords, ws, bs, 2, g, 'bf16')
    for got, want in zip([dgrid] + dws + dbs, [rdg] + rdws + rdbs):
        assert got.shape == want.shape and _rel(got, want, GRAD_FLOOR) <= grad_tol
    _, dws2, dbs2 = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, 'bf16')
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


def test_fused_forward_bf16_features_are_the_bf16_fetch_kernels(cuda_device):
    """In 'bf16' the one-kernel forward's features are the 'bf16' fetch
    kernel's (the same code, lfgc::fetch_channels), and its MLP the fused
    MLP kernel's in 'bf16'."""
    dims = [31, 32, 32, 32, 32, 1]
    ws, bs = _mlp_params(dims, cuda_device, 5)
    grid = torch.randn((15, 15, 15, 16), device=cuda_device)
    coords = torch.rand((20000, 3), device=cuda_device) * 2 - 1
    x0 = torch.cat([coords, fourier_embed(coords, 2),
                    gs.grid_sample_channel_minor_bf16_cuda(grid, coords)],
                   dim=-1)
    two = mf.mlp_fused_cuda(ws, bs, x0, 'bf16')
    one = ff.fused_forward_cuda(grid, coords, ws, bs, 2, 'bf16')
    assert _rel(one, two) <= MLP_TOL['bf16'][0]


BF16_BACKENDS = {'bf16': dict(compute_dtype='bfloat16'),
                 'bf16_fused': dict(interp_backend='fused', compute_dtype='bfloat16'),
                 'pallas_bf16': dict(interp_backend='pallas_bf16')}


def _bf16_counts():
    return (gs.launches, gs.bwd_launches, gs.bf16_launches, gs.bf16_bwd_launches,
            ff.launches, ff.bwd_launches, ff.bf16_launches, ff.bf16_bwd_launches,
            mf.launches, mf.bwd_launches)


# what one train step launches: (f32 fetch, gradient, bf16 fetch, gradient,
# one-kernel 'mixed' fwd, bwd, 'bf16' fwd, bwd, MLP kernels fwd, bwd)
BF16_STEP = {'bf16': (0, 0, 1, 1, 0, 0, 0, 0, 0, 0),
             'bf16_fused': (0, 0, 0, 0, 0, 0, 1, 1, 0, 0),
             'pallas_bf16': (0, 0, 1, 1, 0, 0, 0, 0, 0, 0)}


@pytest.mark.parametrize('backend', sorted(BF16_BACKENDS))
def test_train_step_on_card_matches_cpu_bf16(cuda_device, backend):
    """One full step of the bf16 compute path on the card (the 'bf16'
    kernels, the bf16 chain on cuBLAS) and on the CPU (their plain
    versions, the chain on the CPU's bf16 products) from the same state and
    positions: the bf16 products sum in other orders, so a bf16 rounding
    may flip."""
    outs = []
    for dev in (torch.device('cpu'), cuda_device):
        tr, ph, model, vol = _train_setup(dev, **BF16_BACKENDS[backend])
        st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
        c = tr.PhaseConstants(ph, vol)
        g = torch.Generator().manual_seed(5)
        pos = torch.stack([torch.randint(0, 64, (1, ph.batch_n), generator=g)
                           for _ in range(3)], -1).to(dev)
        norm, gt = tr.chunk_inputs(c, pos)
        before = _bf16_counts()
        loss, _ = tr.train_step(ph, st, c, norm[0], gt[0])
        counts = tuple(b - a for a, b in zip(before, _bf16_counts()))
        outs.append((float(loss), st.flat.cpu(), st.m.cpu(), counts))
    (l0, f0, m0, c0), (l1, f1, m1, c1) = outs
    assert c0 == (0,) * 10 and c1 == BF16_STEP[backend]
    assert abs(l0 - l1) <= 1e-2 * abs(l0)
    assert _rel(m1, m0) <= 5e-2
    # Adam's first step moves each entry by ~lr in the sign of its gradient;
    # where the gradient is within its bf16 bound of 0 the sign may differ
    sure = m0.abs() > 5e-2 * m0.abs().max()
    np.testing.assert_allclose(f1[sure].numpy(), f0[sure].numpy(), atol=1e-5)
    assert float((f1 - f0).abs().max()) <= 2 * 0.008 * 1.0001


@pytest.mark.parametrize('backend', sorted(BF16_BACKENDS))
def test_train_steps_on_card_launch_the_bf16_kernels(cuda_device, backend):
    tr, ph, model, vol = _train_setup(cuda_device, max_pass=6, **BF16_BACKENDS[backend])
    st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
    before = _bf16_counts()
    losses = []
    st = tr.solve_phase(ph, st, vol, 16, generator=torch.Generator(
        device=cuda_device).manual_seed(0), verbose=False, metric_cb=losses.append)
    assert st.step == 32
    counts = tuple(b - a for a, b in zip(before, _bf16_counts()))
    assert counts == tuple(32 * k for k in BF16_STEP[backend])
    losses = np.concatenate(losses)
    assert np.isfinite(losses).all() and losses[-8:].mean() < losses[:8].mean()


@pytest.mark.parametrize('backend', sorted(BF16_BACKENDS))
def test_apply_model_on_card_matches_cpu_bf16(cuda_device, backend):
    spec = fg.make_spec(**FLAGSHIP, **BF16_BACKENDS[backend])
    model = fg.init_model(spec, torch.Generator().manual_seed(1), device='cpu')
    _, c = _inputs((1, 1, 1, 1), 5000, 10)
    with torch.no_grad():
        ref = fg.apply_model(model, c, train=False)
        out = fg.apply_model(model.to(cuda_device), c.to(cuda_device), train=False)
    assert out.dtype == torch.float32
    assert _rel(out.cpu(), ref) <= MLP_TOL['bf16'][0]


def _adam_step_report(repeat):
    """Repeat the float32 train step on the card and on the CPU and print,
    for each pair, one JSON line: the first moment's error relative to max
    |m0|; the entries whose Adam step is more than 1e-5 off, with their
    largest |m0| over max |m0|; the five largest step differences, each
    with its |m0| over max |m0|."""
    import json
    for k in range(repeat):
        (_, f0, m0, _), (_, f1, m1, _) = _train_step_pair(torch.device('cuda'))
        diff = (f1 - f0).abs()
        off = diff > 1e-5
        top = float(m0.abs().max())
        worst = diff.topk(5).indices
        print(json.dumps({'pair': k, 'entries': f0.numel(), 'm_rel_err': _rel(m1, m0),
                          'steps_off_1e-5': int(off.sum()),
                          'off_max_m0_share': (float(m0[off].abs().max()) / top
                                               if off.any() else None),
                          'largest_step_diffs': [[float(diff[i]), float(m0[i].abs()) / top]
                                                 for i in worst]}), flush=True)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser(description='Repeat the card-against-CPU train '
                                 'step and report where its Adam steps differ.')
    ap.add_argument('--repeat', type=int, default=10)
    _adam_step_report(ap.parse_args().repeat)
