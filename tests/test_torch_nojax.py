"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, and its CUDA kernels' C entries match what the wrappers declare."""

import ast
import os
import re
import subprocess
import sys

import pytest

from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as ff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'latent_feature_grid_compression_tpu_torch')
BANNED = ('jax', 'jaxlib', 'flax', 'latent_feature_grid_compression_tpu')

_SCRIPT = r'''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'latent_feature_grid_compression_tpu'):
    sys.modules[name] = None
import torch
import latent_feature_grid_compression_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):
    importlib.import_module(m.name)
import chip_smoke, infer_torch, train_torch
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval.reconstruct import tiled_net_out
from latent_feature_grid_compression_tpu_torch.models.feature_grid import (
    apply_model, init_model, make_spec)
spec = make_spec(grid_size=8, grid_features=4, hidden=8, num_layers=2)
model = init_model(spec, torch.Generator().manual_seed(0), device='cpu')
with torch.no_grad():
    out = apply_model(model, torch.rand(64, 3) * 2 - 1, train=False)
assert out.shape == (64, 1) and bool(torch.isfinite(out).all())
for kw in (dict(mlp_backend='pallas'), dict(interp_backend='fused'),
           dict(compute_dtype='bfloat16'), dict(interp_backend='pallas_bf16'),
           dict(interp_backend='fused', compute_dtype='bfloat16')):
    m = init_model(make_spec(grid_size=8, grid_features=4, hidden=8, num_layers=2, **kw),
                   torch.Generator().manual_seed(0), device='cpu')
    apply_model(m, torch.rand(64, 3) * 2 - 1).sum().backward()
vol = torch.rand(6, 7, 8).numpy() * 2 - 1
psnr = tiled_net_out(model, VolumeMeta((6, 7, 8)), gt_vol=vol, device='cpu')[0]
assert psnr == psnr
from latent_feature_grid_compression_tpu_torch.config import TrainConfig
from latent_feature_grid_compression_tpu_torch.train import training
import os, tempfile
os.chdir(tempfile.mkdtemp())
info = training(TrainConfig(basedir='/', expname='e', max_pass=3, batch_size=64,
                            sample_size=4, grid_size=8, grid_features=4,
                            n_hidden_size=8, n_layers=2),
                verbose=False, volume_np=vol, write_vols=False, device='cpu')
assert info['psnr'] == info['psnr'] and os.path.exists('e/binary_model_file')
from latent_feature_grid_compression_tpu_torch.ops.quantization import mock_quantization_study
from latent_feature_grid_compression_tpu_torch.data.cvol import read_cvol, write_cvol
from latent_feature_grid_compression_tpu_torch.data.volume import load_volume
from latent_feature_grid_compression_tpu_torch.nas import run_search
from latent_feature_grid_compression_tpu_torch.utils import analysis, plots, trigger_experiments
study = mock_quantization_study(model, vol, device='cpu')
assert study['psnr_quant'] == study['psnr_quant'] and study['num_grid_params'] > 0
from latent_feature_grid_compression_tpu_torch.native import lib as native
import numpy as np
labels, centers = native.kmeans_1d(np.linspace(-1, 1, 1000), 16)
assert labels.max() == 15 and (np.diff(centers) > 0).all()
assert native.lz4_decompress(bytes([0x30]) + b'abc', 3) == b'abc'
write_cvol('v.cvol', vol.astype('float32'))
assert (read_cvol('v.cvol') == vol.astype('float32')).all()
assert load_volume('v.cvol').shape == (6, 7, 8)
assert analysis.targets_from_frontier(
    [{'config': {'lambda_drop_loss': 1e-8}, 'info': {'compression_ratio': 100.0}},
     {'config': {'lambda_drop_loss': 1e-6}, 'info': {'compression_ratio': 400.0}}],
    target_ratios=(200,))[200] > 1e-8
assert plots.plot_weight_histograms(model, 'h.png') == 'h.png'
assert trigger_experiments.rerun_frontier_configs(['e'], dry_run=True)[0][1] == 'train_torch.py'
def fake(cmd, expdir):
    os.makedirs(expdir)
    open(expdir + 'info.txt', 'w').write('compression_ratio = 120.0\npsnr = 31.0\n')
trials = run_search('cfg.txt', total_trials=4, parallelism=2, basedir='/nas/',
                    dry_run_cmd=fake)
assert all(t.metrics['psnr'] == 31.0 for t in trials)
from latent_feature_grid_compression_tpu_torch.parallel import (
    comm_volume_per_step, initialize_distributed, make_mesh)
assert initialize_distributed(device='cpu') is False   # no launcher environment
assert comm_volume_per_step(4609, 2, 2, True)['total_per_device'] > 0
assert 'latent_feature_grid_compression_tpu_torch.parallel.mesh' in sys.modules
assert not any(k == 'jax' or k.startswith(('jax.', 'latent_feature_grid_compression_tpu.'))
               for k, v in sys.modules.items() if v is not None)
print('OK')
'''


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith('OK')


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)
    yield os.path.join(REPO, 'chip_smoke.py')
    yield os.path.join(REPO, 'ablate_mlp.py')
    yield os.path.join(REPO, 'ablate_fetch.py')
    yield os.path.join(REPO, 'resume_noise.py')
    yield os.path.join(REPO, 'split_fetch_train.py')
    yield os.path.join(REPO, 'infer_torch.py')
    yield os.path.join(REPO, 'train_torch.py')
    yield os.path.join(REPO, 'examples', 'nas_example_torch.py')
    # the card's tests run where JAX is not installed
    yield os.path.join(REPO, 'tests', 'test_torch_cuda.py')


def test_port_sources_cover_the_parallel_package():
    names = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join('parallel', f) for f in
            ('__init__.py', 'distributed.py', 'mesh.py')} <= names


def test_port_sources_cover_the_ported_tools():
    names = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join(*f.split('/')) for f in
            ('ops/quantization.py', 'data/cvol.py', 'data/volume.py', 'nas/__init__.py',
             'nas/search.py', 'nas/bayesopt.py', 'utils/analysis.py',
             'utils/trigger_experiments.py', 'utils/plots.py', 'native/__init__.py',
             'native/lib.py')} <= names
    assert os.path.join(REPO, 'examples', 'nas_example_torch.py') in set(_sources())


def test_no_jax_import_in_port_sources():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [f'{path}: {n}' for n in names
                    if n.split('.')[0] in BANNED]
    assert not bad, bad


def _check_entry(kernel, entry, argtypes):
    """No nvcc here: check statically that the C entry the wrapper binds
    exists with as many parameters as the wrapper declares."""
    with open(os.path.join(PORT, 'csrc', f'{kernel}.cu')) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', src)
    assert m, f'C entry {entry} missing'
    assert len(m.group(1).split(',')) == len(argtypes)
    assert 'extern "C" const char* lfgc_cuda_error_string' in src
    assert 'arch=compute_90a,code=sm_90a' in _build.ARCH_FLAGS
    assert kernel in _build.kernel_sources()


def test_kernel_entry_matches_wrapper_signature():
    assert len(gs._ARGTYPES) == 10
    _check_entry(gs.KERNEL, 'lfgc_grid_sample_fwd_f32', gs._ARGTYPES)


def test_bwd_kernel_entry_matches_wrapper_signature():
    assert len(gs.BWD_ARGTYPES) == 11
    _check_entry(gs.BWD_KERNEL, 'lfgc_grid_sample_bwd_f32', gs.BWD_ARGTYPES)


def test_gradient_kernel_plan_reads_the_entrys_report(monkeypatch):
    """No card here: a stand-in entry fills the report, and the wrapper
    names its fields and the mode."""
    report = [512, 120, 1, 2, 15, 1, 16, 96, 1744, 768, 0, 2, 16, 1, 16, 232368, 4096]
    calls = []

    def fn(*args):
        calls.append(args[:6])
        for k, v in enumerate(report):
            args[6][k] = v
        return 0
    monkeypatch.setattr(_build, 'entry', lambda name, symbol, argtypes: (None, fn))
    got = gs.bwd_plan(32768, 16, 15, 15, 15, precision='bf16')
    assert calls == [(32768, 16, 15, 15, 15, 1)]
    assert got == {**dict(zip(gs.BWD_PLAN_FIELDS, report)), 'mode': 'bf16'}


def test_gradient_kernel_adds_no_float_by_atomics():
    """The gradient kernel's float sums are each one thread's, in a fixed
    order: its only atomics are integer adds to the counts of its sorts
    (the tiles' bins, the boxes' (bucket, warp) table), it uses no library
    sort or scan, and it writes every entry of dG (the wrapper zeroes
    nothing)."""
    with open(os.path.join(PORT, 'csrc', 'grid_sample_bwd.cu')) as f:
        src = f.read()
    atomics = re.findall(r'(atomic\w+)\(([^,]*),', src)
    assert atomics and {a for a, _ in atomics} == {'atomicAdd'}, atomics
    assert {t for _, t in atomics} == {'tab + lbs[j] * nwp + warp', 'cursor + bin0',
                                       'cursor + bin_of(first + s'}, atomics
    assert not re.search(r'\bcub::|\bthrust::|cooperative_groups', src)
    assert 'if (on[e]) a.dgrid[at + e * Lw] = acc[e];' in src
    assert 'acc[e] = __fadd_rn(acc[e], pv[q][e]);' in src
    with open(os.path.join(PORT, 'ops', 'grid_sample.py')) as f:
        wrapper = f.read()
    body = wrapper[wrapper.index('def _backward_cuda('):wrapper.index(
        'def grid_sample_channel_minor_backward_cuda(')]
    assert 'torch.empty((D, H, W, C)' in body and 'zeros' not in body.split('dgrid =')[1]


@pytest.mark.parametrize('kernel,entry,argtypes', [
    (gs.KERNEL, 'lfgc_grid_sample_fwd_bf16', gs._ARGTYPES),
    (gs.BWD_KERNEL, 'lfgc_grid_sample_bwd_bf16', gs.BWD_ARGTYPES)])
def test_bf16_kernel_entries_match_wrapper_signature(kernel, entry, argtypes):
    """The 'bf16' modes' entries take the 'f32' entries' arguments."""
    _check_entry(kernel, entry, argtypes)


@pytest.mark.parametrize('kernel,entry,argtypes', [
    (gs.KERNEL, 'lfgc_grid_sample_fwd_plan', gs.PLAN_ARGTYPES),
    (gs.BWD_KERNEL, 'lfgc_grid_sample_bwd_plan', gs.BWD_PLAN_ARGTYPES),
    (gs.KERNEL, 'lfgc_grid_sample_fwd_bf16_plan', gs.PLAN_ARGTYPES)])
def test_grid_sample_plan_entries_match_wrapper_signature(kernel, entry, argtypes):
    assert len(argtypes) == 7
    _check_entry(kernel, entry, argtypes)


@pytest.mark.parametrize('plan,routes,report,precision,entry', [
    (gs.fwd_plan, ('scalar', 'float4'), [1, 256, 4, 512, 8, 4, 0], 'f32',
     'lfgc_grid_sample_fwd_plan'),
    (gs.fwd_plan, ('scalar', 'float4'), [0, 256, 8, 512, 8, 4, 0], 'f32',
     'lfgc_grid_sample_fwd_plan'),
    (gs.fwd_plan, ('scalar', 'float4'), [1, 256, 4, 528, 8, 4, 0], 'bf16',
     'lfgc_grid_sample_fwd_bf16_plan'),
    (gs.fwd_plan, ('scalar', 'float4'), [0, 256, 4, 528, 32, 8, 0], 'bf16',
     'lfgc_grid_sample_fwd_bf16_plan')])
def test_grid_sample_plan_reads_the_entrys_report(monkeypatch, plan, routes, report,
                                                   precision, entry):
    """No card here: a stand-in entry of the mode fills the report, and the
    wrapper names its fields, the route and the mode."""
    calls = []

    def fn(*args):
        calls.append(args[:6])
        for k, v in enumerate(report):
            args[6][k] = v
        return 0
    symbols = []

    def stand_in(name, symbol, argtypes):
        symbols.append(symbol)
        return None, fn
    monkeypatch.setattr(_build, 'entry', stand_in)
    got = plan(32768, 16, 15, 15, 15, precision=precision)
    assert calls == [(32768, 16, 15, 15, 15, 1)] and symbols == [entry]
    assert got == {**dict(zip(gs.PLAN_FIELDS, report)), 'route': routes[report[0]],
                   'mode': precision}


# what each source of a 'bf16' mode must show: the shared header's
# plane-by-plane routines (trilinear.cuh), through which the fetch, the
# gradient and the one-kernel forward round alike
BF16_SOURCE_MARKS = {
    'trilinear.cuh': ('for_each_plane(', 'fetch_channels(', 'grad_term(', 'grad_weight(',
                      'grad_scale(', '__float2bfloat16_rn'),
    'grid_sample_fwd.cu': ('template <bool VEC4, bool BF16, int K>\n__global__ void '
                           '__launch_bounds__(kThreads)\ngrid_sample_fwd_kernel(',
                           'lfgc::fetch_channels<BF16, K>(',
                           'launch(grid, coords, out, n, C, D, H, W, vec4 != 0, true, stream)'),
    'grid_sample_bwd.cu': ('grid_sample_bwd_kernel<true>', 'lfgc::grad_weight<BF16>(',
                           'lfgc::grad_scale<BF16>(', 'lfgc::cell_of('),
    'fused_forward.cu': ('fetch_channels<IBF16>(', 'if (g.bf16) {'),
}


@pytest.mark.parametrize('source', sorted(BF16_SOURCE_MARKS))
def test_bf16_modes_share_the_trilinear_routines(source):
    """No nvcc here: check statically that every 'bf16' mode computes its
    weights and sums through the routines of trilinear.cuh."""
    with open(os.path.join(PORT, 'csrc', source)) as f:
        src = f.read()
    for mark in BF16_SOURCE_MARKS[source]:
        assert mark in src, mark


def test_bf16_fetch_reads_the_float32_grid():
    """The 'bf16' fetch is a mode of the fetch kernel that rounds the
    float32 grid as it loads it: no bf16 grid in the source, no bf16 copy
    of the grid in the wrapper."""
    with open(os.path.join(PORT, 'csrc', 'grid_sample_fwd.cu')) as f:
        src = f.read()
    assert '__nv_bfloat16' not in src and 'grid_sample_fwd_bf16_kernel' not in src
    with open(os.path.join(PORT, 'ops', 'grid_sample.py')) as f:
        assert 'torch.bfloat16' not in f.read()


# what each kernel source must show: the fetch sized by occupancy and
# loading float4 lanes; the gradient's box kernel opted into its shared
# memory, its sorts ranking equal keys by __match_any_sync, its staging by
# asynchronous copies, its gather a group of lanes a row of dG
KERNEL_SOURCE_MARKS = {
    'grid_sample_fwd': ('#include "launch.cuh"',
                        'lfgc::occupancy(kernel_of(vec4, bf16, channels)',
                        'for (int c = K * sub; c < C; c += K * Lw)',
                        'const int64_t next = i + stride;'),
    'grid_sample_bwd': ('#include "launch.cuh"', 'lfgc::allow_smem(kernel_of(bf16 != 0)',
                        '__match_any_sync(', '__pipeline_memcpy_async(',
                        'const int Lw = (cb + K - 1) / K, P = 32 / Lw;'),
}


@pytest.mark.parametrize('kernel', sorted(KERNEL_SOURCE_MARKS))
def test_grid_sample_kernels_take_their_hopper_designs(kernel):
    """No nvcc here: check statically that each kernel source has its
    design, that every kernel it defines carries the name the profiler
    reports are read by, and that the gradient is two ordinary launches (the
    tiles, then the boxes, allowed to start early) with no grid barrier,
    sized in one place (plan_of) before them."""
    with open(os.path.join(PORT, 'csrc', f'{kernel}.cu')) as f:
        src = f.read()
    for mark in KERNEL_SOURCE_MARKS[kernel]:
        assert mark in src, mark
    names = re.findall(r'__global__ void __launch_bounds__\([^)]*\)\n(\w+)\(', src)
    assert names and all(kernel in name for name in names), names
    if kernel == gs.BWD_KERNEL:
        assert 'cudaLaunchCooperativeKernel(' not in src and 'grid.sync()' not in src
        assert src.count('<<<') == 1 and src.count('cudaLaunchKernelEx(') == 1
        assert src.count('plan_of(n, C, D, H, W, ') == 2   # the launch's and the report's


def _ablation_cases():
    import ablate_fetch
    import ablate_mlp
    for script in (ablate_mlp, ablate_fetch):
        for name, subs in script.VARIANTS.items():
            yield pytest.param(subs, id=f'{script.__name__}-{name}')


@pytest.mark.parametrize('subs', _ablation_cases())
def test_ablation_variants_apply_to_the_sources(subs):
    """Each variant of the ablation scripts replaces text that the kernel
    sources hold exactly once (the scripts raise on the card otherwise)."""
    for f, old, new in subs:
        with open(os.path.join(PORT, 'csrc', f)) as fh:
            assert fh.read().count(old) == 1, (f, old)
        assert new != old


def test_occupancy_query_lives_in_one_header():
    """The launch helpers are shared through csrc/launch.cuh, not copied."""
    csrc = os.path.join(PORT, 'csrc')
    holders = []
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        if 'cudaOccupancyMaxActiveBlocksPerMultiprocessor' in text:
            holders.append(name)
        if name != 'launch.cuh':
            assert 'cudaFuncAttributeMaxDynamicSharedMemorySize' not in text, name
    assert holders == ['launch.cuh']


@pytest.mark.parametrize('mod,entry,argtypes', [
    (mf, 'lfgc_mlp_fused_fwd', mf.FWD_ARGTYPES),
    (mf, 'lfgc_mlp_fused_bwd', mf.BWD_ARGTYPES),
    (mf, 'lfgc_mlp_fused_bwd_slots', mf.SLOTS_ARGTYPES),
    (mf, 'lfgc_mlp_fused_bwd_plan', mf.PLAN_ARGTYPES),
    (mf, 'lfgc_mlp_fused_fwd_plan', mf.PLAN_ARGTYPES),
    (ff, 'lfgc_fused_forward_fwd', ff.FWD_ARGTYPES),
    (ff, 'lfgc_fused_forward_bwd', ff.BWD_ARGTYPES),
    (ff, 'lfgc_fused_forward_bwd_slots', ff.SLOTS_ARGTYPES),
    (ff, 'lfgc_fused_forward_bwd_plan', mf.PLAN_ARGTYPES),
    (ff, 'lfgc_fused_forward_fwd_plan', mf.PLAN_ARGTYPES),
    (ih, 'lfgc_inference_head', ih.ARGTYPES),
    (ih, 'lfgc_inference_head_plan', ih.PLAN_ARGTYPES)])
def test_mlp_kernel_entries_match_wrapper_signatures(mod, entry, argtypes):
    _check_entry(mod.KERNEL, entry, argtypes)


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes every library's name, so the
    sources that include it are rebuilt."""
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('#include "h.cuh"\n')
    (csrc / 'h.cuh').write_text('// one\n')
    monkeypatch.setattr(_build, 'CSRC_DIR', csrc)
    before = _build.library_path('k')
    (csrc / 'h.cuh').write_text('// two\n')
    assert _build.library_path('k') != before
    assert _build.kernel_sources() == ['k']


def test_mlp_limits_match_the_kernels():
    with open(os.path.join(PORT, 'csrc', 'snake_mlp.cuh')) as f:
        src = f.read()
    assert f'kMaxLayers = {mf.MAX_LAYERS};' in src
    assert f'kMaxWidth = {mf.MAX_WIDTH};' in src


# each bf16 kernel, its launch bound and the routine its body runs
TC_KERNELS = {'fwd': ('kTcFwdThreads, kTcFwdMinBlocks', 'tile_forward_tc(', 'tile_forward<'),
              'bwd': ('kTcThreads, 2', 'tile_backward_tc(', 'tile_backward<')}


@pytest.mark.parametrize('direction', sorted(TC_KERNELS))
@pytest.mark.parametrize('kernel', ['mlp_fused', 'fused_forward'])
def test_bf16_kernels_run_on_the_tensor_cores(kernel, direction):
    """No nvcc here: check statically that the bf16 kernel goes through the
    shared tensor-core tile routine (mma.sync on bf16 fragments loaded by
    ldmatrix), which has no scalar FMA product loop, and that the forward
    and the backward's recompute share their per-layer code."""
    with open(os.path.join(PORT, 'csrc', 'snake_mlp_tc.cuh')) as f:
        tc = f.read()
    assert 'mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32' in tc
    assert 'ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16' in tc
    assert 'fmaf(' not in tc
    assert 'tc_chain<false>(' in tc and 'tc_chain<true>(' in tc
    with open(os.path.join(PORT, 'csrc', f'{kernel}.cu')) as f:
        src = f.read()
    assert '#include "snake_mlp_tc.cuh"' in src
    # the bf16 instantiation is a specialization with its own launch bound
    # whose body takes the new routine, and only it does
    bound, routine, cuda_cores = TC_KERNELS[direction]
    m = re.search(r'template <>\n__global__ void __launch_bounds__\(' + bound + r'\)\n'
                  rf'\w+_{direction}_kernel<true>\(', src)
    assert m, f'no bf16 {direction} specialization'
    body = src[m.end():src.index('\n}\n', m.end())]
    assert routine in body and cuda_cores not in body
    assert src.count(routine) == 1
