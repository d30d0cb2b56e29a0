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
for kw in (dict(mlp_backend='pallas'), dict(interp_backend='fused')):
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
    yield os.path.join(REPO, 'infer_torch.py')
    yield os.path.join(REPO, 'train_torch.py')
    # the card's tests run where JAX is not installed
    yield os.path.join(REPO, 'tests', 'test_torch_cuda.py')


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
    _check_entry(gs.BWD_KERNEL, 'lfgc_grid_sample_bwd_f32', gs._ARGTYPES)


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
    (ff, 'lfgc_fused_forward_fwd_plan', mf.PLAN_ARGTYPES)])
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
