"""The port's volume readers and geometry against the JAX package's: the
``.cvol`` reader and writer (raw and per-slice LZ4 with its 64 KiB history),
the LZ4 block decoder, ``load_volume`` for ``.npy``, ``.h5`` and ``.cvol``,
``VolumeMeta``'s position map, ``lattice_coords``, and the finite-difference
gradient and scipy interpolator of ``ops/interpolation.py``."""

import struct
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from latent_feature_grid_compression_tpu.data import cvol as jcvol
from latent_feature_grid_compression_tpu.data import volume as jvolume
from latent_feature_grid_compression_tpu.ops import interpolation as jinterp
from latent_feature_grid_compression_tpu_torch.data import cvol as tcvol
from latent_feature_grid_compression_tpu_torch.data import volume as tvolume
from latent_feature_grid_compression_tpu_torch.ops import interpolation as tinterp

GEOMETRY_TOL = 1e-6


def _length_bytes(n):
    out = bytearray()
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)
    return out


def _lz4_block(seqs, tail):
    """An LZ4 block of sequences (literals, offset, match length) and the
    last literals."""
    out = bytearray()
    for lit, offset, match_len in seqs:
        m = match_len - 4
        out.append((min(len(lit), 15) << 4) | min(m, 15))
        if len(lit) >= 15:
            out += _length_bytes(len(lit) - 15)
        out += lit
        out += offset.to_bytes(2, 'little')
        if m >= 15:
            out += _length_bytes(m - 15)
    out.append(min(len(tail), 15) << 4)
    if len(tail) >= 15:
        out += _length_bytes(len(tail) - 15)
    out += tail
    return bytes(out)


def _expand(seqs, tail, history=b''):
    """What the block decodes to, byte by byte (the reference)."""
    dst = bytearray(history[-65536:])
    base = len(dst)
    for lit, offset, match_len in seqs:
        dst += lit
        for _ in range(match_len):
            dst.append(dst[len(dst) - offset])
    dst += tail
    return bytes(dst[base:])


_RNG = np.random.default_rng(7)
_HISTORY = _RNG.integers(0, 256, 70000, dtype=np.uint8).tobytes()
BLOCKS = {
    'literals_only': ([], bytes(range(40)), b''),
    'short_literals_only': ([], b'abc', b''),
    'matches': ([(b'abcdefgh', 8, 8), (b'xyz', 11, 20), (bytes(range(20)), 30, 4)],
                b'end!!', b''),
    'overlapping': ([(b'ab', 2, 30), (b'q', 1, 300), (b'0123456', 3, 19)], b'z', b''),
    'long_match_no_tail': ([(b'x' * 300, 300, 300)], b'', b''),
    'history': ([(b'', 1000, 50), (b'q', 65535, 19), (b'', 7, 7)], b'tail', _HISTORY),
}


@pytest.mark.parametrize('case', sorted(BLOCKS))
def test_lz4_decoder_matches_jax(case):
    seqs, tail, history = BLOCKS[case]
    block = _lz4_block(seqs, tail)
    want = _expand(seqs, tail, history)
    got = tcvol._lz4_decompress_block_py(block, len(want), history)
    assert got == want
    assert got == jcvol._lz4_decompress_block_py(block, len(want), history)


def _write_compressed_cvol(path, vol):
    """A cvol file with flags bit 0: one LZ4 chunk a z-slice, the first
    literals only, each later one copying the previous slice's first half
    (through the streaming history) and storing the rest as literals."""
    sx, sy, sz = vol.shape
    raw = np.ascontiguousarray(vol.transpose(2, 1, 0)).tobytes()
    chunk = sx * sy * vol.dtype.itemsize
    header = b'cvol' + struct.pack('<QQQ', sx, sy, sz) + struct.pack('<ddd', 1.0, 1.0, 1.0)
    header += struct.pack('<III', {np.uint8: 0, np.uint16: 1, np.float32: 2}[vol.dtype.type],
                          1, 0)
    header += b'\xff' * (64 - len(header))
    with open(path, 'wb') as f:
        f.write(header)
        for z in range(sz):
            part = raw[z * chunk:(z + 1) * chunk]
            half = chunk // 2
            if z == 0:
                block = _lz4_block([], part)
            else:
                block = _lz4_block([(b'', chunk, half)], part[half:])
            f.write(struct.pack('<I', len(block)) + block)


def _slices_repeat(vol):
    """Make each z-slice's first half (x-fastest bytes) the previous one's."""
    sx, sy, sz = vol.shape
    flat = vol.transpose(2, 1, 0).reshape(sz, -1).copy()
    half = flat.shape[1] // 2
    for z in range(1, sz):
        flat[z, :half] = flat[z - 1, :half]
    return np.ascontiguousarray(flat.reshape(sz, sy, sx).transpose(2, 1, 0))


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.float32])
def test_read_cvol_matches_jax_on_jax_files(dtype, tmp_path):
    rng = np.random.default_rng(2)
    vol = (rng.uniform(0, 250, (16, 12, 10))).astype(dtype)
    path = str(tmp_path / 'v.cvol')
    jcvol.write_cvol(path, vol)
    got = tcvol.read_cvol(path)
    assert got.dtype == dtype and got.shape == vol.shape
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, jcvol.read_cvol(path))


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.float32])
def test_jax_reads_the_ports_cvol(dtype, tmp_path):
    vol = np.random.default_rng(3).uniform(0, 250, (5, 6, 7)).astype(dtype)
    path = str(tmp_path / 'v.cvol')
    tcvol.write_cvol(path, vol, voxel_size=(0.5, 0.25, 0.125))
    jpath = str(tmp_path / 'j.cvol')
    jcvol.write_cvol(jpath, vol, voxel_size=(0.5, 0.25, 0.125))
    with open(path, 'rb') as a, open(jpath, 'rb') as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(jcvol.read_cvol(path), vol)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_compressed_cvol_matches_jax(dtype, tmp_path):
    # 24 * 16 * 4 bytes a float32 slice: 1,536; 6 slices cross no window
    vol = _slices_repeat(np.random.default_rng(4).uniform(0, 250, (24, 16, 6)).astype(dtype))
    path = str(tmp_path / 'c.cvol')
    _write_compressed_cvol(path, vol)
    got = tcvol.read_cvol(path)
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, jcvol.read_cvol(path))


def test_cvol_rejects_bad_files(tmp_path):
    bad = tmp_path / 'bad.cvol'
    bad.write_bytes(b'nope' + b'\0' * 60)
    with pytest.raises(ValueError, match='not a cvol file'):
        tcvol.read_cvol(str(bad))
    path = str(tmp_path / 't.cvol')
    tcvol.write_cvol(path, np.zeros((4, 4, 4), np.uint8))
    with open(path, 'r+b') as f:
        f.truncate(64 + 10)
    with pytest.raises(ValueError, match='truncated'):
        tcvol.read_cvol(path)
    with pytest.raises(ValueError, match='unsupported dtype'):
        tcvol.write_cvol(path, np.zeros((2, 2, 2), np.float64))


def _formats(tmp_path, vol):
    import h5py
    paths = {'npy': str(tmp_path / 'v.npy'), 'h5': str(tmp_path / 'v.h5'),
             'cvol': str(tmp_path / 'v.cvol')}
    np.save(paths['npy'], vol)
    with h5py.File(paths['h5'], 'w') as f:
        f.create_dataset('data', data=vol[None])   # squeezed on load
    tcvol.write_cvol(paths['cvol'], vol)
    return paths


def test_load_volume_formats_agree_bitwise_and_with_jax(tmp_path):
    vol = np.random.default_rng(5).uniform(3, 7, (9, 10, 11)).astype(np.float32)
    paths = _formats(tmp_path, vol)
    loaded = {k: tvolume.load_volume(p) for k, p in paths.items()}
    for k, got in loaded.items():
        assert got.dtype == np.float32 and got.shape == vol.shape, k
        np.testing.assert_array_equal(got, loaded['npy'], err_msg=k)
        np.testing.assert_array_equal(got, jvolume.load_volume(paths[k]), err_msg=k)
    assert loaded['npy'].min() == -1.0 and loaded['npy'].max() == 1.0


def test_load_volume_names_what_it_cannot_read(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match='unsupported volume format'):
        tvolume.load_volume(str(tmp_path / 'v.raw'))
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError):
        tvolume.load_volume(str(tmp_path / 'v.h5'))


@pytest.mark.parametrize('shape', [(4, 5, 6), (255, 255, 128), (17, 9, 33)])
def test_volume_meta_matches_jax(shape):
    tm, jm = tvolume.VolumeMeta(shape), jvolume.VolumeMeta(shape)
    for name in ('res', 'min_idx', 'max_idx', 'scales'):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert tm.n_voxels == jm.n_voxels
    raw = np.random.default_rng(6).integers(0, min(shape), (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.normalize_positions(raw), jm.normalize_positions(raw),
                               atol=GEOMETRY_TOL, rtol=0)
    got = tvolume.lattice_coords(tm) if np.prod(shape) < 100000 else None
    if got is not None:
        np.testing.assert_allclose(got, jvolume.lattice_coords(jm), atol=GEOMETRY_TOL, rtol=0)
        # row-major: the second point is index (0, 0, 1)
        np.testing.assert_allclose(got[1], tm.normalize_positions(
            np.array([[0, 0, 1]], np.float32))[0], atol=GEOMETRY_TOL)
        np.testing.assert_allclose(got[0], -tm.scales, atol=GEOMETRY_TOL)


@pytest.mark.parametrize('scale', [None, (1.0, 0.5, 2.0)])
def test_finite_difference_gradient_matches_jax(scale):
    rng = np.random.default_rng(8)
    vol = rng.standard_normal((9, 10, 11)).astype(np.float32)
    res = np.array(vol.shape, np.float32)
    min_bb = np.array([-1.0, -2.0, 0.0], np.float32)
    max_bb = np.array([1.0, 2.0, 3.0], np.float32)
    # inside, on the box's faces (the clamped steps) and on lattice points
    pts = rng.uniform(min_bb, max_bb, (200, 3)).astype(np.float32)
    pts[:20] = min_bb
    pts[20:40] = max_bb
    t = [torch.from_numpy(a) for a in (vol, pts, min_bb, max_bb, res)]
    j = [jnp.asarray(a) for a in (vol, pts, min_bb, max_bb, res)]
    s_t = None if scale is None else torch.tensor(scale)
    s_j = None if scale is None else jnp.asarray(scale)
    got = tinterp.finite_difference_gradient(*t, scale=s_t)
    want = np.asarray(jinterp.finite_difference_gradient(*j, scale=s_j))
    assert got.shape == (200, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=GEOMETRY_TOL * np.abs(want).max(),
                               rtol=0)
    # the points are not modified
    np.testing.assert_array_equal(t[1].numpy(), pts)


def test_regular_grid_interpolator_matches_jax():
    vol = np.random.default_rng(9).standard_normal((6, 7, 8)).astype(np.float32)
    q = np.random.default_rng(10).uniform(0, 5, (30, 3))
    got = tinterp.generate_regular_grid_interpolator(torch.from_numpy(vol))(q)
    np.testing.assert_array_equal(got, jinterp.generate_regular_grid_interpolator(vol)(q))
