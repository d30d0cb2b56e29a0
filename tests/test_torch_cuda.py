"""The port on the card: the CUDA kernels (the fetch and its grid
gradient, the fused MLP forward and backward, the one-kernel model forward
and backward, each mode of them: the 'bf16' ones of the bf16 compute path
too) against their plain PyTorch versions (the grid gradient, summed in the
plain version's order, bit for bit against the plain version on the CPU),
the wrappers' checks, and the model, evaluation, quantization-study and training paths through them
(every gate family's train step, and the bf16 compute path's); the kernels
on the windowed grid of tile-local decode, and the collectives of
multi-device training on CUDA tensors (NCCL in a world of one; two gloo
ranks sharing the card).

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so it also runs where JAX is not installed; the
repo's ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval import reconstruct as rec
from latent_feature_grid_compression_tpu_torch.models import feature_grid as fg
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as ff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf
from latent_feature_grid_compression_tpu_torch.ops import quantization as qz
from latent_feature_grid_compression_tpu_torch.ops.embedding import fourier_embed
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    channel_minor, grid_sample_3d, grid_sample_channel_minor,
    grid_sample_channel_minor_backward, grid_sample_channel_minor_backward_bf16,
    grid_sample_channel_minor_bf16)

pytestmark = pytest.mark.cuda

# same formula in float32, another summation order
KERNEL_TOL = 1e-5
# the MLP kernels against their plain versions (cuBLAS on the card), relative
# to max |.|: float32 sums in another order (over 32,768 samples for dW,
# db; dG of the MLP's own dX); with bf16 operands a float32 sum that lands on the
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


# the flagship's trainer positions, then the NAS range of grids (23..62 are
# the blocked Pallas variant's) on random coordinates, C = 5 (scalar loads),
# 8 and 32
@pytest.mark.parametrize('C,G,kind', [(16, 15, 'lattice'), (16, 4, 'uniform'),
                                      (16, 5, 'uniform'), (16, 6, 'uniform'),
                                      (16, 22, 'uniform'), (16, 23, 'uniform'),
                                      (16, 32, 'uniform'), (16, 62, 'uniform'),
                                      (5, 15, 'uniform'), (8, 15, 'uniform'),
                                      (32, 15, 'uniform')])
def test_bwd_kernel_matches_plain(cuda_device, C, G, kind):
    """The gradient kernel equals the plain version run on the CPU bit for
    bit, in a second call too, with one launch a call."""
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
    ref = grid_sample_channel_minor_backward(g.cpu(), coords.cpu(), G, G, G)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(gs.grid_sample_channel_minor_backward_cuda(g, coords, G, G, G), out)


def test_bwd_plan_follows_the_shape(cuda_device):
    """The box kernel's 512-thread blocks, one a box of rows and channel
    group: boxes of whole planes, of a y range in one plane or of an x range
    in one line, at most BWD_MAX_LOCAL_BUCKETS buckets a box, at most 32
    channels a block, 1, 2 or 4 a lane, within the card's shared memory;
    the flagship in one wave and one pass a box, grid 4 under 2^18 samples a
    corner at a time; grids from 121 to 255 (the container's largest) and
    lines longer than a box's buckets take y or x ranges."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, C, D, H, W in [(32768, 16, 15, 15, 15), (32768, 16, 62, 62, 62),
                          (32768, 22, 17, 17, 17), (1 << 18, 16, 4, 4, 4), (1, 5, 4, 4, 4),
                          (16384, 16, 15, 15, 8), (1 << 20, 64, 62, 62, 62),
                          (32768, 16, 121, 121, 121), (32768, 16, 128, 128, 128),
                          (32768, 16, 255, 255, 255), (4096, 8, 3, 5, 3000)]:
        for precision in ('f32', 'bf16'):
            p = gs.bwd_plan(n, C, D, H, W, precision)
            bz, by, bx = p['box_z'], p['box_y'], p['box_x']
            boxes = -(-D // bz) * -(-H // by) * -(-W // bx)
            assert p['threads'] == 512 and p['blocks'] == boxes * p['channel_groups']
            assert p['box_buckets'] == (bz + 1) * (by + 1) * (bx + 1) <= gs.BWD_MAX_LOCAL_BUCKETS
            assert (by == H or bz == 1) and (bx == W or bz == by == 1)
            assert p['channels_per_block'] == -(-C // p['channel_groups']) <= 32
            assert p['channels_per_lane'] in (1, 2, 4)
            assert p['lanes_per_row'] == -(-p['channels_per_block'] // p['channels_per_lane'])
            assert p['rows_per_warp'] == 32 // p['lanes_per_row']
            assert p['buckets'] == (D + 1) * (H + 1) * (W + 1)
            assert p['smem_bytes'] <= 232448 and p['capacity'] >= 256
    flagship = gs.bwd_plan(32768, 16, 15, 15, 15)
    assert flagship['per_corner'] == 0 and flagship['blocks'] <= sms
    assert gs.bwd_plan(1 << 18, 16, 4, 4, 4)['per_corner'] == 1


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


@pytest.mark.parametrize('n,G', [(1000, 6), (4096, 3)])
def test_bwd_kernel_unaligned_takes_scalar_path(cuda_device, n, G):
    """g's rows copied one float at a time where they are not 16-byte
    aligned; on grid 3, 4,096 samples add ~1,200 terms into each entry."""
    c = torch.rand((n, 3), device=cuda_device) * 2 - 1
    storage = torch.empty(n * 8 + 1, device=cuda_device)
    g = storage[1:].view(n, 8)
    g.copy_(torch.randn((n, 8), device=cuda_device))
    assert g.data_ptr() % 16 != 0
    out = gs.grid_sample_channel_minor_backward_cuda(g, c, G, G, G)
    ref = grid_sample_channel_minor_backward(g.cpu(), c.cpu(), G, G, G)
    assert torch.equal(out.cpu(), ref)


def _grad_coords(kind, n, device):
    """(n, 3) coordinates: uniform over the grid and past it, all in one
    cell, all at one point, or all outside the grid."""
    if kind == 'uniform':
        return torch.rand((n, 3), device=device) * 2.4 - 1.2
    if kind == 'one_cell':
        return torch.rand((n, 3), device=device) * 0.05 + 0.31
    if kind == 'one_point':
        return torch.full((n, 3), 0.123, device=device)
    return torch.rand((n, 3), device=device) + 1.5


# (C, (D, H, W), n, coordinates): the flagship, the NAS range (8..62, C 22 on
# 17^3, C 5), grid 4 (4,096 adds an entry), C 32 and 64 (more channels than a
# warp's lanes), the mesh's windowed grid, an anisotropic one, tiny batches,
# and batches whose buckets are one, or none; grids 128 and 255 (y-range
# boxes past 8 waves) and lines of 3,000 (x-range boxes)
BWD_CASES = [(16, (15, 15, 15), 32768, 'uniform'), (16, (4, 4, 4), 32768, 'uniform'),
             (16, (8, 8, 8), 32768, 'uniform'), (22, (17, 17, 17), 32768, 'uniform'),
             (16, (23, 23, 23), 32768, 'uniform'), (16, (62, 62, 62), 32768, 'uniform'),
             (5, (15, 15, 15), 32768, 'uniform'), (32, (15, 15, 15), 32768, 'uniform'),
             (64, (10, 10, 10), 32768, 'uniform'), (16, (15, 15, 8), 16384, 'uniform'),
             (3, (5, 7, 9), 4097, 'uniform'), (16, (15, 15, 15), 1, 'uniform'),
             (16, (15, 15, 15), 33, 'uniform'), (16, (15, 15, 15), 20000, 'one_cell'),
             (8, (6, 6, 6), 5000, 'one_point'), (16, (15, 15, 15), 1000, 'outside'),
             (16, (128, 128, 128), 32768, 'uniform'), (16, (255, 255, 255), 32768, 'uniform'),
             (8, (3, 5, 3000), 4096, 'uniform')]


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('C,shape,n,kind', BWD_CASES)
def test_gradient_kernel_is_the_cpu_plain_version_bit_for_bit(cuda_device, C, shape, n,
                                                               kind, precision):
    """The gradient kernel sums each entry of dG in the plain version's
    order: equal to the plain version on the CPU, and to itself in a second
    call, in both modes."""
    D, H, W = shape
    coords = _grad_coords(kind, n, cuda_device)
    g = torch.randn((n, C), device=cuda_device)
    call, plain = ((gs.grid_sample_channel_minor_backward_bf16_cuda,
                    grid_sample_channel_minor_backward_bf16) if precision == 'bf16' else
                   (gs.grid_sample_channel_minor_backward_cuda,
                    grid_sample_channel_minor_backward))
    out = call(g, coords, D, H, W)
    again = call(g, coords, D, H, W)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), plain(g.cpu(), coords.cpu(), D, H, W))
    if kind == 'outside':
        assert not out.any()


def _clustered(n, G, device):
    """(n, 3) coordinates in the 8 cells of a 2 x 2 x 2 block at the middle
    of a G^3 grid."""
    pix = G // 2 - 1 + 2.0 * torch.rand((n, 3), device=device)
    return (2.0 * pix + 1.0) / G - 1.0


# crowded positions: grid 4 under 2^18 and 2^16 uniform samples (the boxes
# take the corners one at a time from the start), 8 clustered cells and one
# cell of the flagship grid (boxes that overflow on the card and turn to a
# corner at a time there), 8 cells of grid 8 at 2^17 samples
CROWDED_CASES = [(16, 4, 1 << 18, 'uniform'), (16, 4, 1 << 16, 'uniform'),
                 (16, 15, 32768, 'clustered'), (16, 15, 32768, 'one_cell'),
                 (8, 8, 1 << 17, 'clustered')]


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('C,G,n,kind', CROWDED_CASES)
def test_gradient_kernel_on_crowded_positions_bit_for_bit(cuda_device, C, G, n, kind,
                                                          precision):
    """Crowded positions take the boxes' windowed passes: still the plain
    version on the CPU bit for bit and the same dG in a second call, in
    both modes."""
    coords = (_clustered(n, G, cuda_device) if kind == 'clustered'
              else _grad_coords(kind, n, cuda_device))
    g = torch.randn((n, C), device=cuda_device)
    call, plain = ((gs.grid_sample_channel_minor_backward_bf16_cuda,
                    grid_sample_channel_minor_backward_bf16) if precision == 'bf16' else
                   (gs.grid_sample_channel_minor_backward_cuda,
                    grid_sample_channel_minor_backward))
    out = call(g, coords, G, G, G)
    again = call(g, coords, G, G, G)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), plain(g.cpu(), coords.cpu(), G, G, G))


@pytest.mark.parametrize('precision', ['mixed', 'f32', 'bf16'])
def test_fused_backward_routes_dx_bit_for_bit(cuda_device, precision):
    """The one-kernel backward's dG is the gradient kernel on the backward
    kernel's own dX features: the plain version of that routing on the CPU
    bit for bit, and two calls equal, dW and db too."""
    C, G, n = 16, 15, 32768
    dims = [3 + 12 + C, 32, 32, 32, 32, 1]
    ws, bs = _mlp_params(dims, cuda_device, 6)
    grid = torch.randn((G, G, G, C), device=cuda_device)
    coords = torch.rand((n, 3), device=cuda_device) * 2.4 - 1.2
    g = torch.randn((n, 1), device=cuda_device)
    dfeat, _, _ = ff.fused_forward_backward_dx_cuda(grid, coords, ws, bs, 2, g, precision)
    dgrid, dws, dbs = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, precision)
    dgrid2, dws2, dbs2 = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, precision)
    torch.cuda.synchronize()
    route = (grid_sample_channel_minor_backward_bf16 if precision == 'bf16'
             else grid_sample_channel_minor_backward)
    assert torch.equal(dgrid.cpu(), route(dfeat.cpu(), coords.cpu(), G, G, G))
    assert torch.equal(dgrid, dgrid2)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


# the training paths a graphed phase is held against eager steps on: every
# backend under smallify, and each other gate family under the default one
GRAPH_CASES = {'default': ({}, 'smallify'), 'mlp_pallas': (dict(mlp_backend='pallas'), 'smallify'),
               'fused': (dict(interp_backend='fused'), 'smallify'),
               'bf16': (dict(compute_dtype='bfloat16'), 'smallify'),
               'bf16_fused': (dict(interp_backend='fused', compute_dtype='bfloat16'),
                              'smallify'),
               **{d: ({}, d) for d in ('straight_through', 'masked_straight_through',
                                       'static_variational', 'dynamic_variational')}}


def _phase_run(device, backend, graphs, phase, state_in=None):
    """A phase of GRAPH_CASES[backend] at the flagship's widths on the 64^3
    volume, in chunks of 8 steps from fixed generators: phase 1 from a
    fresh model (and variance model), phase 2 from ``state_in``, phase 1's
    final state, baked.  (losses, volume losses, the final state)."""
    from latent_feature_grid_compression_tpu_torch.models.variance import init_variance_model
    kw, drop_type = GRAPH_CASES[backend]
    cfg_kw = FAMILY_CFG.get(drop_type, {})
    tr, ph, model, vol = _train_setup(device, drop_type=drop_type, max_pass=6,
                                      cfg_kw=cfg_kw, phase=phase, **kw)
    masks = None
    if phase == 1:
        variance = None
        if 'dynamic' in drop_type:
            variance = tuple([t.to(device) for t in ts]
                             for ts in init_variance_model(torch.Generator().manual_seed(4)))
        st = tr.init_train_state(model, 0.008, 0.008, train_gates=True, variance=variance,
                                 weight_dkl=cfg_kw.get('lambda_drop_loss', 0.0))
    else:
        model, masks, _ = fg.save_dropvalues_on_grid(tr.state_to_model(state_in, model))
        st = tr.init_train_state(model, 0.0008, 0.008, train_gates=False)
    gens = [torch.Generator(device=device).manual_seed(2 + phase + i) for i in range(2)]
    losses, vol_losses = [], []
    st = tr.solve_phase(ph, st, vol, 8, masks, generator=gens[0], noise_generator=gens[1],
                        verbose=False, metric_cb=losses.append, volume_cb=vol_losses.append,
                        graphs=graphs)
    return np.concatenate(losses), np.concatenate(vol_losses), st


@pytest.mark.parametrize('backend', sorted(GRAPH_CASES))
def test_train_steps_on_card_are_bitwise_reproducible(cuda_device, backend):
    """Both phases of each training path through ``solve_phase`` with the
    step's CUDA graph and with eager steps, from the same state, positions
    and generators: every loss and volume loss, the steps and every tensor
    of the final states bit for bit, and each phase's launch counts equal
    (the replays count the capture's launches, a step each)."""
    from latent_feature_grid_compression_tpu_torch.io.train_state_io import TENSOR_FIELDS
    from latent_feature_grid_compression_tpu_torch.ops import launch_counts
    runs = {}
    for graphs in (False, True):
        state = None
        for phase in (1, 2):
            launch_counts.write((0,) * len(launch_counts.COUNTERS))
            losses, vol_losses, state = _phase_run(cuda_device, backend, graphs, phase,
                                                   state)
            torch.cuda.synchronize()
            runs[graphs, phase] = (losses, vol_losses, state, launch_counts.read())
    for phase in (1, 2):
        (l0, v0, s0, c0), (l1, v1, s1, c1) = runs[False, phase], runs[True, phase]
        assert s0.step == s1.step == {1: 32, 2: 16}[phase]
        np.testing.assert_array_equal(l1, l0)
        np.testing.assert_array_equal(v1, v0)
        for name in TENSOR_FIELDS:
            a, b = getattr(s0, name), getattr(s1, name)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
        assert c0 == c1 and max(c0) == s0.step, (c0, c1)
    assert np.isfinite(runs[True, 1][0]).all()


def _train_setup(device, res=64, drop_type='smallify', max_pass=60, cfg_kw=None,
                 phase=1, **backends):
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
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta((res,) * 3), phase=phase)
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
# step depends on g's last bits.  The grid's gradient is the CPU's order
# on the card (the gradient kernel), so only the MLP's cuBLAS sums differ:
# on an H100 no step is off by more than 6e-7 (python
# tests/test_torch_cuda.py --repeat N prints the largest differences)


def test_train_step_on_card_matches_cpu(cuda_device):
    """One full step from the same state and positions on the card and on
    the CPU: the loss and the first moment to 1e-5 (cuBLAS sums in another
    order), every Adam step to 1e-5 and within 2 lr."""
    (l0, f0, m0, e0), (l1, f1, m1, e1) = _train_step_pair(cuda_device)
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    assert _rel(m1, m0) <= 1e-5
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=1e-5)
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


class _Killed(Exception):
    pass


def _run_chunks(tr, ph, st, vol, gens, n_chunks, drawn, **kw):
    """Run ``n_chunks`` chunks of 8 steps of the phase on ``st`` in place
    (a metric callback that raises ends the phase there); returns their
    losses, and appends each chunk's drawn positions to ``drawn``."""
    losses = []

    def cb(x):
        losses.append(x)
        if len(losses) == n_chunks:
            raise _Killed
    draw = tr.draw_positions

    def recording(*a, **k):
        drawn.append(draw(*a, **k))
        return drawn[-1]
    tr.draw_positions = recording
    try:
        with pytest.raises(_Killed):
            tr.solve_phase(ph, st, vol, 8, generator=gens[0], noise_generator=gens[1],
                           verbose=False, metric_cb=cb, **kw)
    finally:
        tr.draw_positions = draw
    return np.concatenate(losses)


@pytest.mark.parametrize('drop_type', ['smallify', 'straight_through'])
def test_train_state_round_trip_on_card(cuda_device, drop_type, tmp_path):
    """A flagship-width phase-1 state on the card after 2 chunks of graphed
    steps, saved by solve_phase with both CUDA generators (Philox seed and
    offset): loaded back bit for bit.  One more chunk of graphed steps from
    the loaded state and generators and from the live ones, and one of
    eager steps from the file loaded again: the positions (and the gate
    noise's generator), the losses and the states they end in bit for bit
    (the gradient kernel sums in a fixed order)."""
    from latent_feature_grid_compression_tpu_torch.io.train_state_io import (
        TENSOR_FIELDS, load_train_state)
    tr, ph, model, vol = _train_setup(cuda_device, drop_type=drop_type, max_pass=6)

    def fresh():
        return tr.init_train_state(model, 0.008, 0.008, train_gates=True)

    def gens(seed):
        return tuple(torch.Generator(device=cuda_device).manual_seed(seed + i)
                     for i in range(2))
    live, live_gens = fresh(), gens(1)
    path = str(tmp_path / 'state.npz')
    _run_chunks(tr, ph, live, vol, live_gens, 2, [], state_save_path=path,
                save_every_s=0.0)
    assert live.step == 16
    loaded_gens = gens(7)
    loaded = load_train_state(path, fresh(), loaded_gens)
    assert loaded.step == live.step
    for name in TENSOR_FIELDS:
        a, b = getattr(loaded, name), getattr(live, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    for a, b in zip(loaded_gens, live_gens):
        assert torch.equal(a.get_state(), b.get_state())
    eager_gens = gens(11)
    eager = load_train_state(path, fresh(), eager_gens)
    drawn = ([], [], [])
    losses = []
    for st, g, d, kw in ((live, live_gens, drawn[0], {}), (loaded, loaded_gens, drawn[1], {}),
                         (eager, eager_gens, drawn[2], dict(graphs=False))):
        losses.append(_run_chunks(tr, ph, st, vol, g, 1, d, **kw))
    assert all(len(d) == 1 and torch.equal(d[0], drawn[0][0]) for d in drawn)
    for a, b, c in zip(loaded_gens, live_gens, eager_gens):
        assert torch.equal(a.get_state(), b.get_state())
        assert torch.equal(c.get_state(), b.get_state())
    assert losses[0][0] == losses[1][0]
    np.testing.assert_array_equal(losses[1], losses[0])
    np.testing.assert_array_equal(losses[2], losses[0])
    for other in (loaded, eager):
        for name in TENSOR_FIELDS:
            a, b = getattr(other, name), getattr(live, name)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name


def _capture_with_a_host_sync(_, out):
    """A phase whose step reads a value to the host, in a process of its
    own: a failed capture leaves PyTorch's CUDA generator registered with
    the dead capture, so the process's later draws on the default
    generator raise."""
    from latent_feature_grid_compression_tpu_torch.io.train_state_io import TENSOR_FIELDS
    from latent_feature_grid_compression_tpu_torch.ops import launch_counts
    tr, ph, model, vol = _train_setup(torch.device('cuda'), max_pass=6)
    st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
    before = {name: getattr(st, name).clone() for name in TENSOR_FIELDS
              if getattr(st, name) is not None}
    adam = tr.adam_update
    syncs = []

    def syncing(flat, g, *a, **k):
        syncs.append(float(g.abs().max()))
        return adam(flat, g, *a, **k)
    tr.adam_update = syncing
    launch_counts.write((0,) * len(launch_counts.COUNTERS))
    warm = tr.warmup_steps
    try:
        tr.solve_phase(ph, st, vol, 8, generator=torch.Generator(device='cuda').manual_seed(0),
                       verbose=False)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        tr.adam_update = adam
    x = torch.arange(4.0, device='cuda')
    torch.save({'raised': raised, 'syncs': len(syncs), 'warmup_steps': tr.warmup_steps - warm,
                'step': st.step, 'counts': launch_counts.read(),
                'unchanged': [name for name, t in before.items()
                              if torch.equal(getattr(st, name), t)],
                'fields': list(before), 'card_works': float((x * 2).sum())}, out)


def test_a_capture_that_meets_a_host_sync_raises(cuda_device, tmp_path):
    """A step that reads a value to the host (a synchronisation, which a
    CUDA graph cannot hold) makes the phase's capture raise, after the
    warm-up has run it on a scratch copy of the state: solve_phase raises,
    the state has taken no step and is unchanged, no launch was counted
    (no eager step ran after it), and the card goes on working.  Run in a
    spawned process (``_capture_with_a_host_sync``)."""
    import torch.multiprocessing as mp
    from latent_feature_grid_compression_tpu_torch.ops import launch_counts
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    mp.spawn(_capture_with_a_host_sync, args=(str(tmp_path / 'out.pt'),), nprocs=1)
    r = torch.load(tmp_path / 'out.pt')
    assert r['raised'] is not None
    assert r['syncs'] == tr.WARMUP_STEPS and r['warmup_steps'] == 0
    assert r['step'] == 0 and r['unchanged'] == r['fields']
    assert r['counts'] == (0,) * len(launch_counts.COUNTERS)
    assert r['card_works'] == 12.0


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


@pytest.mark.parametrize('shape,chunk', [((64, 64, 64), rec.CHUNK), ((20, 24, 28), 4096)])
def test_graphed_evaluation_equals_eager(cuda_device, monkeypatch, shape, chunk):
    """A graphed evaluation (``graphs=True``) captures its chunk body once
    an evaluation and replays it a chunk: the field, the per-chunk sums and
    the stats ``torch.equal`` to the eager body's (``graphs=False``), the
    fetch counted once a chunk in both modes, and no evaluation graph alive
    afterwards.  The default at these sizes (under ``GRAPH_MIN_CHUNKS``)
    captures nothing.  64^3 is one whole chunk; (20, 24, 28) at 4,096 ends
    in a partial chunk."""
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    meta = VolumeMeta(shape)
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(7),
                          device='cpu')
    vol = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, shape)
                           .astype(np.float32)).to(cuda_device)
    n_chunks = -(-meta.n_voxels // chunk)
    assert n_chunks < rec.GRAPH_MIN_CHUNKS
    captures = []
    capture = tr.capture_graph
    monkeypatch.setattr(tr, 'capture_graph',
                        lambda *a, **k: captures.append(1) or capture(*a, **k))
    live = set(tr._live_graphs)
    got = {}
    for graphs in (False, True, None):
        captures.clear()
        before = gs.launches
        got[graphs] = (rec.field_on_device(model, meta, chunk, cuda_device, graphs=graphs),
                       rec.chunk_sums(model, meta, vol, chunk, cuda_device, graphs=graphs),
                       rec.eval_stats_on_device(model, meta, vol, chunk, cuda_device,
                                                graphs=graphs))
        torch.cuda.synchronize()
        assert gs.launches == before + 3 * n_chunks
        assert len(captures) == (3 if graphs else 0)
    assert not set(tr._live_graphs) - live
    (field, sums, stats), (field_g, sums_g, stats_g) = got[False], got[True]
    assert field.shape == shape and sums.shape == (n_chunks, 2)
    assert torch.equal(field_g, field) and torch.equal(sums_g, sums)
    assert stats_g == stats


def test_graphed_evaluations_share_one_pool(cuda_device):
    """Every graphed evaluation captures anew into the memory pool that the
    process's captures on the card share (``trainer.capture_graph``),
    reusing the memory its destroyed predecessors left there: once two
    evaluations have run, four more reserve nothing more on the card."""
    meta = VolumeMeta((64, 64, 64))
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(9),
                          device='cpu').to(cuda_device)
    for _ in range(2):
        rec.field_on_device(model, meta, device=cuda_device, graphs=True)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for _ in range(4):
        rec.field_on_device(model, meta, device=cuda_device, graphs=True)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == reserved


def test_an_empty_capture_raises(cuda_device):
    """A capture that records no node (PyTorch only warns) raises, and no
    graph of it is left alive."""
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    live = set(tr._live_graphs)
    with pytest.raises(RuntimeError, match='recorded no node'):
        tr.capture_graph(lambda: None, lambda: None, device=cuda_device)
    assert not set(tr._live_graphs) - live


@pytest.fixture
def second_card():
    """The second CUDA device, with the first one current; skips the test
    on fewer than two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two NVIDIA GPUs with CUDA')
    torch.cuda.set_device(0)
    return torch.device('cuda', 1)


def test_graphs_on_the_second_card(second_card):
    """With card 0 current, a graphed evaluation and a graphed training
    phase on card 1 capture and replay there: the field and the stats equal
    the eager ones on card 1 and card 0's, and the phase's losses and state
    the eager phase's on card 1, bit for bit; no graph is left alive."""
    from latent_feature_grid_compression_tpu_torch.io.train_state_io import TENSOR_FIELDS
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    meta = VolumeMeta((20, 24, 28))
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(11),
                          device='cpu')
    vol = torch.from_numpy(np.random.default_rng(12).uniform(-1, 1, meta.resolution)
                           .astype(np.float32))
    live = set(tr._live_graphs)
    field = {}
    for card, graphs in ((second_card, True), (second_card, False),
                         (torch.device('cuda', 0), False)):
        field[card, graphs] = (
            rec.field_on_device(model, meta, 4096, card, graphs=graphs).cpu(),
            rec.eval_stats_on_device(model, meta, vol, 4096, card, graphs=graphs))
    assert torch.cuda.current_device() == 0
    (f1g, s1g), (f1, s1), (f0, s0) = field.values()
    assert torch.equal(f1g, f1) and torch.equal(f1, f0) and s1g == s1 == s0
    (l0, v0, st0), (l1, v1, st1) = (_phase_run(second_card, 'default', graphs, 1)
                                    for graphs in (False, True))
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_array_equal(v1, v0)
    for name in TENSOR_FIELDS:
        a, b = getattr(st0, name), getattr(st1, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    assert not set(tr._live_graphs) - live


def test_quantization_study_on_card_matches_the_plain_path(cuda_device):
    """The post-training quantization study on the card (two evaluations
    through the fetch kernel) against the same study on the CPU's plain
    path, on a flagship-width model with zeros in its coefficients."""
    shape = (20, 24, 28)
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(4),
                          device='cpu')
    with torch.no_grad():
        for c in model.coeffs:
            c[c.abs() < 0.05] = 0.0
    vol = np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32)
    ref = qz.mock_quantization_study(model, vol, device='cpu')
    before = gs.launches
    got = qz.mock_quantization_study(model, vol, device=cuda_device)
    assert gs.launches == before + 2 * -(-int(np.prod(shape)) // rec.CHUNK)
    assert ref['num_zeros'] > 0
    for k in ('num_grid_params', 'num_mlp_params', 'num_zeros', 'compression_ratio',
              'compression_ratio_quant'):
        assert got[k] == ref[k], k
    for k in ('psnr', 'psnr_quant'):
        assert abs(got[k] - ref[k]) <= 1e-3, k


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
    # the backward routes dX's features through the gradient kernel
    assert (ff.launches, ff.bwd_launches, gs.launches, gs.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3] + 1)
    fwd_tol, grad_tol = MLP_TOL['bf16' if precision == 'mixed' else 'f32']
    assert _rel(out, ff.fused_forward_plain(grid, coords, ws, bs, 2, precision)) <= fwd_tol
    rdg, rdws, rdbs = ff.fused_forward_plain_backward(grid, coords, ws, bs, 2, g, precision)
    for got, want in zip([dgrid] + dws + dbs, [rdg] + rdws + rdbs):
        assert got.shape == want.shape and _rel(got, want, GRAD_FLOOR) <= grad_tol
    # dW, db and dG are summed in a fixed order: a second call gives the
    # same bits
    dgrid2, dws2, dbs2 = ff.fused_forward_backward_cuda(grid, coords, ws, bs, 2, g, precision)
    assert all(torch.equal(a, b) for a, b in zip([dgrid] + dws + dbs, [dgrid2] + dws2 + dbs2))


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
    # the one-kernel backward routes dX's features through the gradient kernel
    assert c1 == ((1, 1, 0, 0, 1, 1) if backend == 'mlp_pallas' else (0, 0, 1, 1, 0, 1))
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
        assert ff.launches == ff.bwd_launches == gs.bwd_launches == 32
        assert mf.launches == mf.bwd_launches == gs.launches == 0
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

# the 'bf16' fetch and the gradient's atomics route against their plain
# versions, relative to max |.|: at least BF16_SHARE of the entries within
# BF16_TOL, all within BF16_MAX (the plain versions round at the kernels'
# points and every product is exact: only a float32 summation order
# differs, by atomics in the route, and where that straddles a bf16 rounding
# boundary one value moves by a bf16 ulp); the route against its terms
# summed in float64 (two float32 orders of a grid-4 entry's 4,096 adds
# differ by ~1e-6)
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
                                      (22, 17, 'lattice'), (16, 5, 'uniform'),
                                      (16, 6, 'uniform')])
def test_bf16_bwd_kernel_matches_plain(cuda_device, C, G, kind):
    """The 'bf16' gradient equals its plain version on the CPU bit for bit,
    with the launch counted in 'bf16' only; its plan is the 'f32' one's
    shape of launch (its staged factors take other room, so its boxes may
    differ)."""
    n = 32768
    coords = (_lattice_positions(n, 255, 1) if kind == 'lattice'
              else torch.rand((n, 3), device=cuda_device) * 2.4 - 1.2)
    g = torch.randn((n, C), device=cuda_device)
    before = (gs.bwd_launches, gs.bf16_bwd_launches)
    out = gs.grid_sample_channel_minor_backward_bf16_cuda(g, coords, G, G, G)
    torch.cuda.synchronize()
    assert (gs.bwd_launches, gs.bf16_bwd_launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    assert torch.equal(out.cpu(), grid_sample_channel_minor_backward_bf16(
        g.cpu(), coords.cpu(), G, G, G))
    plan, f32 = gs.bwd_plan(n, C, G, G, G, precision='bf16'), gs.bwd_plan(n, C, G, G, G)
    assert plan['mode'] == 'bf16' and f32['mode'] == 'f32'
    assert {k for k in plan} == {k for k in f32}
    assert plan['threads'] == f32['threads'] and plan['buckets'] == f32['buckets']


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
# one-kernel 'mixed' fwd, bwd, 'bf16' fwd, bwd, MLP kernels fwd, bwd); the
# one-kernel backward routes dX's features through the 'bf16' gradient
BF16_STEP = {'bf16': (0, 0, 1, 1, 0, 0, 0, 0, 0, 0),
             'bf16_fused': (0, 0, 0, 1, 0, 0, 1, 1, 0, 0),
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


# ---------------------------------------------------------------------------
# Multi-device training: the windowed grid of tile-local decode, and the
# process groups' collectives on CUDA tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('W', [5, 8, 9])
def test_kernels_on_a_windowed_grid_match_plain(cuda_device, W):
    """Tile-local decode fetches from (15, 15, W', 16), W' < 15: the fetch
    against its plain version within KERNEL_TOL, the gradient bit for bit
    the plain version on the CPU, on a train step's half batch whose x
    spans the window (and its padding)."""
    g = torch.Generator(device=cuda_device).manual_seed(W)
    grid = torch.randn((15, 15, W, 16), device=cuda_device, generator=g)
    coords = torch.rand((16384, 3), device=cuda_device, generator=g) * 2.2 - 1.1
    out = gs.grid_sample_channel_minor_cuda(grid, coords)
    plain = grid_sample_channel_minor(grid, coords)
    assert (out - plain).abs().max().item() <= KERNEL_TOL
    dout = torch.randn(out.shape, device=cuda_device, generator=g)
    dgrid = gs.grid_sample_channel_minor_backward_cuda(dout, coords, 15, 15, W)
    dplain = grid_sample_channel_minor_backward(dout.cpu(), coords.cpu(), 15, 15, W)
    assert torch.equal(dgrid.cpu(), dplain)


def test_windowed_forward_on_card_matches_full(cuda_device):
    """apply_model(x_window) at the flagship widths through the fetch kernel,
    at coordinates inside the window, against the full forward."""
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(0),
                          device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    coords = torch.rand((32768, 3), device=cuda_device, generator=g) * 2 - 1
    coords[:, 0] = coords[:, 0].abs() * -1.0    # x in [-1, 0]: cells 0..7
    before = gs.launches
    with torch.no_grad():
        win = fg.apply_model(model, coords, x_window=(0, 9))
        full = fg.apply_model(model, coords)
    assert gs.launches == before + 2
    assert (win - full).abs().max().item() <= 2e-5 * full.abs().max().item()


def test_nccl_world_of_one_runs_the_collectives_on_the_card(cuda_device, tmp_path):
    """A world-1 NCCL process group on the card: all_reduce,
    reduce_scatter_tensor and all_gather_into_tensor on CUDA tensors."""
    import torch.distributed as dist
    card = torch.device('cuda', torch.cuda.current_device())
    dist.init_process_group('nccl', init_method='file://' + str(tmp_path / 'rendezvous'),
                            world_size=1, rank=0, device_id=card)
    try:
        x = torch.arange(8, dtype=torch.float32, device=card)
        y = x.clone()
        dist.all_reduce(y)
        scattered = torch.empty(8, device=card)
        dist.reduce_scatter_tensor(scattered, x.clone())
        gathered = torch.empty(8, device=card)
        dist.all_gather_into_tensor(gathered, x)
        torch.cuda.synchronize()
        for t in (y, scattered, gathered):
            assert torch.equal(t, x)
    finally:
        dist.destroy_process_group()


def _nccl_rank_evaluates(rank, init_file, out):
    """Rank 0 of a world-1 NCCL group on the card, as rank 0 of a mesh
    evaluates after training: an eager all-reduce (the group's
    communicator and watchdog running), the evaluation eager and graphed
    (a graph captured while the group lives), then
    ``shutdown_distributed``."""
    import time
    import torch.distributed as dist
    from latent_feature_grid_compression_tpu_torch.parallel.distributed import (
        shutdown_distributed)
    card = torch.device('cuda', 0)
    dist.init_process_group('nccl', init_method='file://' + init_file, world_size=1,
                            rank=rank, device_id=card)
    x = torch.ones(4, device=card)
    dist.all_reduce(x)
    meta = VolumeMeta((20, 24, 28))
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(10),
                          device='cpu')
    eager = rec.field_on_device(model, meta, 4096, card, graphs=False)
    graphed = rec.field_on_device(model, meta, 4096, card, graphs=True)
    t0 = time.perf_counter()
    shutdown_distributed()
    torch.save({'equal': torch.equal(eager, graphed), 'ended': not dist.is_initialized(),
                'shutdown_s': time.perf_counter() - t0, 'sum': float(x.sum())},
               f'{out}/rank{rank}.pt')


def test_graphed_evaluation_under_an_nccl_group(cuda_device, tmp_path):
    """A graphed evaluation under a live NCCL group (its capture in
    thread-local mode beside the group's watchdog thread) equals the eager
    evaluation, and the group then ends through ``shutdown_distributed``
    within the test's limit; a rank that does not end fails the test."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(_nccl_rank_evaluates, args=(str(tmp_path / 'rendezvous'), str(tmp_path)),
                   nprocs=1, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail('the rank did not end within 180 s')
    r = torch.load(tmp_path / 'rank0.pt')
    assert r['equal'] and r['ended'] and r['sum'] == 4.0


def _nccl_rank_captures(rank, init_file, out, mode):
    """Rank 0 of a world-1 NCCL group on the card captures, through
    ``trainer.capture_graph`` in ``mode``, an all-reduce right after a
    warm-up of eager all-reduces whose work is still in flight (no card
    synchronisation between them), as the chunk runner's capture follows
    its warm-up; then replays it, and ends through
    ``shutdown_distributed``."""
    import torch.distributed as dist
    from latent_feature_grid_compression_tpu_torch.parallel.distributed import (
        shutdown_distributed)
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    card = torch.device('cuda', 0)
    dist.init_process_group('nccl', init_method='file://' + init_file, world_size=1,
                            rank=rank, device_id=card)
    x = torch.ones(1 << 20, device=card)

    def step():
        x.mul_(2.0)
        dist.all_reduce(x)

    def warm():
        for _ in range(8):
            step()
    replay = tr.capture_graph(warm, step, mode, device=card)
    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    value = float(x[0])
    shutdown_distributed()
    torch.save({'value': value, 'ended': not dist.is_initialized()}, f'{out}/rank{rank}.pt')


@pytest.mark.parametrize('mode', ['global', 'thread_local'])
def test_nccl_capture_right_after_eager_collectives(cuda_device, tmp_path, mode):
    """A capture of NCCL work made while the warm-up's eager NCCL work may
    still run (``capture_graph`` does not synchronise the card first) in
    either capture mode: the warm-up's 8 steps and 3 replays double the
    tensor 11 times, and the group ends through ``shutdown_distributed``
    within the test's limit."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(_nccl_rank_captures, args=(str(tmp_path / 'rendezvous'), str(tmp_path), mode),
                   nprocs=1, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail('the rank did not end within 180 s')
    r = torch.load(tmp_path / 'rank0.pt')
    assert r['value'] == 2.0 ** 11 and r['ended']


def _gloo_rank_on_the_card(rank, init_file, out):
    """One of two gloo ranks that share card 0: the mesh's collectives on
    CUDA tensors."""
    import torch.distributed as dist
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    dist.init_process_group('gloo', init_method='file://' + init_file, world_size=2,
                            rank=rank)
    try:
        mesh = pm.make_mesh(1, 2, device=torch.device('cuda', 0))
        x = torch.arange(6, dtype=torch.float32, device='cuda') + 10 * rank
        torch.save({'default_device': str(pm.make_mesh(1, 2).device),
                    'mean': pm.all_reduce_mean(mesh, x.clone()).cpu(),
                    'scatter': pm.reduce_scatter_mean(mesh, x.clone()).cpu(),
                    'gather': pm.all_gather_flat(mesh, x.clone()).cpu(),
                    'device': str(x.device)}, f'{out}/rank{rank}.pt')
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_sharing_the_card_run_the_mesh_collectives(cuda_device, tmp_path):
    """Two gloo ranks on card 0 (the mesh phase's set-up on one card): the
    mean, the reduce-scatter-mean and the all-gather on CUDA tensors give
    the exact values, with no staging through the host; a mesh built with
    no device is on the card under gloo too."""
    import torch.multiprocessing as mp
    mp.spawn(_gloo_rank_on_the_card, args=(str(tmp_path / 'rendezvous'), str(tmp_path)),
             nprocs=2)
    base = torch.arange(6, dtype=torch.float32)
    for rank in range(2):
        r = torch.load(tmp_path / f'rank{rank}.pt')
        assert r['device'].startswith('cuda')
        assert r['default_device'] == 'cuda:0'
        assert torch.equal(r['mean'], base + 5)
        assert torch.equal(r['scatter'], (base + 5)[3 * rank:3 * rank + 3])
        assert torch.equal(r['gather'], torch.cat([base, base + 10]))


# the inference head kernel (ops/inference_head.py) against its plain version,
# the ATen chain: float32 sums in another order than cuBLAS's
HEAD_TOL = 1e-6


@pytest.mark.parametrize('n', [1 << 18, (1 << 18) - 37])
@pytest.mark.parametrize('C', [16, 22])
def test_inference_head_kernel_matches_plain(cuda_device, C, n):
    from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
    spec = fg.make_spec(**dict(FLAGSHIP, grid_features=C))
    model = fg.init_model(spec, torch.Generator().manual_seed(C), device=cuda_device)
    ws, bs = [w.detach() for w in model.mlp_w], [b.detach() for b in model.mlp_b]
    _, c = _inputs((1, 1, 1, 1), n, 12)
    coords = c.to(cuda_device)
    with torch.no_grad():
        feats = gs.fetch(channel_minor(fg.decode_volume(model)), coords)
        before = ih.launches
        out = ih.inference_head(coords, feats, ws, bs, 2)
        ref = ih.inference_head_plain(coords, feats, ws, bs, 2)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    print(f'inference head C={C} n={n}: max |kernel - plain| = {err!r}')
    assert ih.launches == before + 1
    assert out.shape == (n, 1) and bool(torch.isfinite(out).all())
    assert err <= HEAD_TOL


def test_inference_head_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(4),
                          device=cuda_device)
    ws, bs = [w.detach() for w in model.mlp_w], [b.detach() for b in model.mlp_b]
    coords = torch.rand((64, 3), device=cuda_device)
    feats = torch.rand((64, 16), device=cuda_device)
    with pytest.raises(ValueError, match='CUDA'):
        ih.inference_head_cuda(coords.cpu(), feats, ws, bs)
    with pytest.raises(ValueError, match='float32'):
        ih.inference_head_cuda(coords.double(), feats, ws, bs)
    with pytest.raises(ValueError, match='contiguous'):
        ih.inference_head_cuda(coords, feats.t().contiguous().t(), ws, bs)
    with pytest.raises(ValueError, match='aligned'):
        ih.inference_head_cuda(coords, torch.rand((65 * 16 + 1,), device=cuda_device)
                               [1:].view(65, 16)[1:], ws, bs)
    with pytest.raises(ValueError, match='C in'):
        ih.inference_head_cuda(coords, feats[:, :8].contiguous(), ws, bs)
    with pytest.raises(ValueError, match='frequencies'):
        ih.inference_head(coords, feats, ws, bs, 3)


def test_graphed_evaluation_launches_the_inference_head_a_chunk(cuda_device):
    """A graphed 255^3 evaluation (64 chunks) equals the eager one bit for
    bit and launches the head once a chunk, the warm-up's launch taken
    back; so does the eager one."""
    from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
    meta = VolumeMeta((255, 255, 255))
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(13),
                          device=cuda_device)
    fields, launches = {}, {}
    for graphs in (True, False):
        before = ih.launches
        fields[graphs] = rec.field_on_device(model, meta, device=cuda_device, graphs=graphs)
        torch.cuda.synchronize()
        launches[graphs] = ih.launches - before
    assert launches == {True: 64, False: 64}
    assert torch.equal(fields[True], fields[False])
    assert float(fields[True].abs().max()) <= 1.0


def test_a_loaded_checkpoint_evaluates_through_the_inference_head(cuda_device):
    """A checkpoint's weights load as transposed views (``params_from_jax``);
    its graphed evaluation launches the head once a chunk and gives the
    freshly made model's field to the head's tolerance."""
    from latent_feature_grid_compression_tpu_torch.convert import (params_from_jax,
                                                                   params_to_jax)
    from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
    meta = VolumeMeta((128, 128, 128))
    model = fg.init_model(fg.make_spec(**FLAGSHIP), torch.Generator().manual_seed(17),
                          device=cuda_device)
    coeffs, mlp_w, mlp_b, _ = params_to_jax(model)
    loaded = params_from_jax(coeffs, mlp_w, mlp_b, model.spec, device=cuda_device)
    assert not all(w.is_contiguous() for w in loaded.mlp_w)
    want = rec.field_on_device(model, meta, device=cuda_device, graphs=False)
    before = ih.launches
    got = rec.field_on_device(loaded, meta, device=cuda_device, graphs=True)
    torch.cuda.synchronize()
    assert ih.launches - before == 8
    assert float((got - want).abs().max()) <= HEAD_TOL


def test_graphed_training_steps_launch_no_inference_head(cuda_device):
    from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
    tr, ph, model, vol = _train_setup(cuda_device)
    st = tr.init_train_state(model, 0.008, 0.008, train_gates=True)
    before, fetches = ih.launches, gs.launches
    tr.solve_phase(ph, st, vol, 16, generator=torch.Generator(device=cuda_device)
                   .manual_seed(0), verbose=False, metric_cb=lambda x: None, graphs=True)
    torch.cuda.synchronize()
    assert st.step > 0 and gs.launches - fetches >= st.step
    assert ih.launches == before


def test_decompress_trace_reads_the_head_roofline(cuda_device):
    """A traced run of the benchmark's smallify-decompress cell reports
    ``head_roofline.decompress`` in (0, 100] %."""
    import json
    import time
    from portbench import run as R
    from portbench import spec as S
    result, _ = R.run_cell(S.load_cell('smallify-decompress'), 2 ** 33 + 7, 3.0, True,
                           cuda_device, time.perf_counter())
    print(json.dumps(result['metrics']))
    assert result['correct'], result['checks']
    assert 0.0 < result['metrics']['head_roofline.decompress']['value'] <= 100.0


@pytest.mark.parametrize('layers', [1, 12, 15])
@pytest.mark.parametrize('C', [16, 22])
def test_inference_head_kernel_at_other_layer_counts(cuda_device, C, layers):
    """One hidden layer (no layer loop), and 12 and 15 (the most: the
    weights take more than 48 KB of shared memory)."""
    from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
    gen = torch.Generator().manual_seed(layers)
    dims = [15 + C] + [32] * layers + [1]
    ws = [((torch.rand((b, a), generator=gen) * 2 - 1) / a ** 0.5).to(cuda_device)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [((torch.rand((b,), generator=gen) * 2 - 1) / a ** 0.5).to(cuda_device)
          for a, b in zip(dims[:-1], dims[1:])]
    coords = (torch.rand((40_000, 3), generator=gen) * 2 - 1).to(cuda_device)
    feats = torch.randn((40_000, C), generator=gen).to(cuda_device)
    out = ih.inference_head_cuda(coords, feats, ws, bs)
    ref = ih.inference_head_plain(coords, feats, ws, bs, 2)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= HEAD_TOL
    assert ih.plan(C, layers, 40_000)['smem_bytes'] == 4 * (
        32 * (15 + C) + 32 + (layers - 1) * (32 * 32 + 32) + 32 + 4)
