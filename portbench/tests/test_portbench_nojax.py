"""Nothing the command imports is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the port, and the command refuses to run
without a card or outside a checkout that holds the port."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = ('jax', 'jaxlib', 'flax', 'latent_feature_grid_compression_tpu')


def _modules_after(code: str, cwd=ROOT):
    out = subprocess.run([sys.executable, '-c', code + '\nimport sys, json\n'
                          'print(json.dumps(sorted(sys.modules)))'],
                         cwd=cwd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(cwd)))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_command_loads_no_jax():
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    code = ('import portbench.run, portbench.generator, portbench.profile, portbench.calibrate, '
            'portbench.reference.check\n'
            'from portbench import spec\n'
            'from latent_feature_grid_compression_tpu_torch.train import trainer\n'
            'from latent_feature_grid_compression_tpu_torch.eval import reconstruct\n'
            'from latent_feature_grid_compression_tpu_torch.config import TrainConfig\n'
            + ''.join(f'spec.load_cell({w["name"]!r})\n' for w in bench['workloads']))
    mods = _modules_after(code)
    assert 'latent_feature_grid_compression_tpu_torch' in mods
    assert [m for m in mods if m.split('.')[0] in BANNED] == []


def test_the_reference_imports_nothing_of_the_port():
    mods = _modules_after('import portbench.reference.check, portbench.reference.model')
    assert [m for m in mods if m.startswith('latent_feature_grid_compression_tpu')] == []


def _command(cwd, *extra):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    return subprocess.run(bench['command'] + ['--workload', 'smallify-train', '--seed', '1',
                                              '--seconds', '1', '--trace', '0', *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result(no_card):
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ''
    assert 'CUDA card' in out.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(BENCH, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ''
