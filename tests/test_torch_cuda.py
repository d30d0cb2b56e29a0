"""The port on the card: the CUDA fetch kernels (forward and grid gradient)
against their plain PyTorch versions, the wrappers' checks, and the model,
evaluation and training paths through them.

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
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    channel_minor, grid_sample_3d, grid_sample_channel_minor_backward)

pytestmark = pytest.mark.cuda

# same formula in float32, another summation order
KERNEL_TOL = 1e-5
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


def _train_setup(device, res=64, drop_type='smallify'):
    """A phase at the flagship's widths and batch on a smaller volume."""
    from latent_feature_grid_compression_tpu_torch.config import TrainConfig
    from latent_feature_grid_compression_tpu_torch.data.synthetic import synth_volume
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    cfg = TrainConfig(batch_size=2048, sample_size=16, grid_size=15,
                      grid_features=16, drop_type=drop_type, max_pass=60)
    spec = fg.make_spec(**dict(FLAGSHIP, drop_type=drop_type))
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
    model = fg.init_model(spec, torch.Generator().manual_seed(1))
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
    model = fg.init_model(spec, torch.Generator().manual_seed(2))
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
