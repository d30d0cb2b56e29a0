"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, and its CUDA kernels' C entries match what the wrappers declare."""

import ast
import os
import re
import subprocess
import sys

from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs

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
model = init_model(spec, torch.Generator().manual_seed(0))
with torch.no_grad():
    out = apply_model(model, torch.rand(64, 3) * 2 - 1, train=False)
assert out.shape == (64, 1) and bool(torch.isfinite(out).all())
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


def _check_entry(kernel, entry):
    """No nvcc here: check statically that the C entry the wrapper binds
    exists with as many parameters as the wrapper declares."""
    with open(os.path.join(PORT, 'csrc', f'{kernel}.cu')) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', src)
    assert m, f'C entry {entry} missing'
    assert len(m.group(1).split(',')) == len(gs._ARGTYPES) == 10
    assert 'extern "C" const char* lfgc_cuda_error_string' in src
    assert 'arch=compute_90a,code=sm_90a' in _build.ARCH_FLAGS
    assert kernel in _build.kernel_sources()


def test_kernel_entry_matches_wrapper_signature():
    _check_entry(gs.KERNEL, 'lfgc_grid_sample_fwd_f32')


def test_bwd_kernel_entry_matches_wrapper_signature():
    _check_entry(gs.BWD_KERNEL, 'lfgc_grid_sample_bwd_f32')
