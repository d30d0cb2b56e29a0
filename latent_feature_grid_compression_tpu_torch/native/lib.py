"""ctypes bindings of the port's native I/O helper (``native/lfgc_io.cpp``):
the LZ4 block decoder and the 1-D k-means.

The helper is compiled at first use, from the source in the checkout, by

    g++ -O3 -shared -fPIC -std=c++17 -o build/liblfgc_io-<hash>.so native/lfgc_io.cpp

into the package's git-ignored ``build/`` directory, the library's name
keyed by a hash of the source and the flags (as ``ops/_build.py`` keys the
kernels'), so an edited source is rebuilt.  A failed build raises: nothing
falls back to Python.  The container (``io/container.py``) quantizes with
:func:`kmeans_1d`, as the JAX package's writer does with its own build of
the same algorithm, so the two write the same bytes; ``data/cvol.py``
decodes LZ4 with :func:`lz4_decompress` (its pure-Python decoder is the
plain version).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().with_name('lfgc_io.cpp')
FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    'lfgc_lz4_decompress': (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, _U8P,
                                             ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]),
    'lfgc_kmeans_1d': (None, [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                              ctypes.c_int32, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(ctypes.c_int32)]),
}


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(' '.join(FLAGS).encode())
    return _build.BUILD_DIR / f'liblfgc_io-{h.hexdigest()[:12]}.so'


def build() -> bool:
    """Compile the helper unless an up-to-date library exists; whether it
    was built now.  Raises if g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return False
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: the native I/O helper needs it')
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=lib.parent)
    os.close(fd)
    res = subprocess.run([gxx, *FLAGS, '-o', tmp, str(SOURCE)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'g++ exited {res.returncode} building {SOURCE.name}:\n'
                           f'{res.stdout}{res.stderr}')
    os.replace(tmp, lib)
    return True


def load() -> ctypes.CDLL:
    """The loaded helper, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def lz4_decompress(src: bytes, dst_size: int, history: bytes = b'') -> bytes:
    """One LZ4 block decoded into at most ``dst_size`` bytes, matches
    reaching back into ``history`` (the bytes decoded before it); raises
    ValueError on a malformed block."""
    out = np.empty(dst_size, dtype=np.uint8)
    n = load().lfgc_lz4_decompress(src, len(src), out.ctypes.data_as(_U8P), dst_size, history,
                                   len(history))
    if n < 0:
        raise ValueError('malformed LZ4 block')
    return out[:n].tobytes()


def kmeans_1d(data, k: int, max_iter: int = 100, seed: int = 0):
    """1-D k-means of ``data`` (float32) with k clusters: (int64 labels,
    float32 centers ascending).  No values, or k < 1: no labels and
    max(k, 0) zero centers."""
    x = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    if len(x) == 0 or k < 1:   # the C code takes n >= k >= 1
        return np.zeros(0, dtype=np.int64), np.zeros(max(k, 0), np.float32)
    centers = np.empty(k, dtype=np.float32)
    labels = np.empty(len(x), dtype=np.int32)
    load().lfgc_kmeans_1d(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), k,
                          max_iter, seed,
                          centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels.astype(np.int64), centers
