"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The build happens at first use, from the sources in the checkout only, into
the package's ``build/`` directory (listed in ``.gitignore``).  The library
name carries a hash of the source and of every header in ``csrc/`` (the
sources share ``*.cuh`` headers), so an edited source or header is rebuilt.
Nothing here is imported or compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get('CUDA_HOME')
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(ARCH_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def _nvcc_command(name: str, out: Path):
    return [nvcc_path(), *ARCH_FLAGS, '-std=c++17', '-O3', '-shared',
            '-Xcompiler', '-fPIC', '-Xptxas', '-v',
            '-o', str(out), str(CSRC_DIR / f'{name}.cu')]


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns, per name, whether
    it was built now and nvcc's ``-Xptxas -v`` report (registers, spills).
    Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            report[name] = {'built': False, 'ptxas': ''}
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            _nvcc_command(name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), Path(tmp), lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, lib)
        report[name] = {'built': True, 'ptxas': log}
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """The library of ``csrc/<name>.cu`` and its C entry ``symbol``, with
    ``argtypes`` declared on first use (every entry returns a CUDA error
    code, 0 for success)."""
    lib = load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.lfgc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lfgc_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def raise_on_error(lib: ctypes.CDLL, name: str, err: int):
    """Raise if a C entry of ``lib`` returned a CUDA error code."""
    if err != 0:
        msg = lib.lfgc_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def kernel_sources():
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC_DIR.glob('*.cu'))
