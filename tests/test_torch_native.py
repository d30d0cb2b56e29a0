"""The port's native I/O helper (``native/lib.py``, ``native/lfgc_io.cpp``)
against the JAX package's build of its own helper and against the Python
decoder: the 1-D k-means bit for bit with JAX's, the container and its
``_mask.bnr`` byte for byte with the JAX writer's on the same parameters
(the container's numpy packers with the JAX writer's too), and the LZ4
decoder with the pure-Python one (and a malformed block refused)."""

import os

import numpy as np
import pytest
import jax

from latent_feature_grid_compression_tpu.io import container as jct
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.native import lib as jlib
from latent_feature_grid_compression_tpu_torch.data import cvol as tcvol
from latent_feature_grid_compression_tpu_torch.io import container as tct
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.native import lib
from tests.test_torch_readers import BLOCKS, _expand, _lz4_block, _write_compressed_cvol
from tests.torch_port_util import prune, to_port


@pytest.fixture(scope='module', autouse=True)
def jax_helper():
    """The JAX writer quantizes with its native helper only where it loads;
    these comparisons are against that path."""
    assert jlib.available()


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == 'normal':
        return rng.standard_normal(n).astype(np.float32)
    if kind == 'repeats':   # few distinct values, each many times
        return rng.integers(-20, 20, n).astype(np.float32) / 8
    return (rng.standard_normal(n) ** 3).astype(np.float32)   # heavy tails


@pytest.mark.parametrize('kind', ['normal', 'repeats', 'tails'])
@pytest.mark.parametrize('k', [1, 5, 32, 256])
def test_kmeans_is_jaxs_bit_for_bit(kind, k):
    x = _data(kind, 20000, k)
    k = min(k, len(np.unique(x)))
    labels, centers = lib.kmeans_1d(x, k)
    jlabels, jcenters = jlib.kmeans_1d(x, k)
    assert labels.dtype == np.int64 and centers.dtype == np.float32
    np.testing.assert_array_equal(labels, jlabels)
    assert centers.tobytes() == jcenters.tobytes()


@pytest.mark.parametrize('max_iter,seed', [(1, 0), (100, 3), (1000, 0)])
def test_kmeans_arguments_are_jaxs(max_iter, seed):
    x = _data('normal', 5000, seed + 40)
    got = lib.kmeans_1d(x, 64, max_iter=max_iter, seed=seed)
    want = jlib.kmeans_1d(x, 64, max_iter=max_iter, seed=seed)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_kmeans_of_nothing():
    labels, centers = lib.kmeans_1d(np.zeros(0, np.float32), 16)
    assert labels.shape == (0,) and centers.shape == (16,) and not centers.any()


def _jax_model(bits, pruned_section):
    """tests/test_torch_io.py's fully-pruned-section setup (grid 9, 4
    features, 2 x 8), its coefficient tensor ``pruned_section`` all zeros
    and the rest about half pruned."""
    jspec = jfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2)
    jparams, _ = jfg.init_model(jax.random.key(4), jspec)
    jparams = prune(jparams, 0.5, seed=bits)
    coeffs = list(jparams.coeffs)
    coeffs[pruned_section] = np.zeros_like(coeffs[pruned_section])
    return jspec, jparams.replace(coeffs=tuple(coeffs))


@pytest.mark.parametrize('bits', [5, 8])
@pytest.mark.parametrize('pruned_section', [0, 1])
def test_container_bytes_are_the_jax_writers(tmp_path, bits, pruned_section):
    jspec, jparams = _jax_model(bits, pruned_section)
    spec = tfg.make_spec(grid_size=9, grid_features=4, hidden=8, num_layers=2)
    model = to_port(jparams, spec)
    ours, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    tct.store_model_parameters(model, ours, bit_precision=bits)
    jct.store_model_parameters(jspec, jparams, theirs, bit_precision=bits)
    for suffix in ('', '_mask.bnr'):
        with open(ours + suffix, 'rb') as a, open(theirs + suffix, 'rb') as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize('bits', [3, 8])
@pytest.mark.parametrize('wavelet', ['db2', 'none'])
def test_flagship_width_container_bytes_are_the_jax_writers(tmp_path, bits, wavelet):
    """The flagship's widths (16 features on 15^3, 4 x 32), pruned."""
    kw = dict(grid_size=15, grid_features=16, hidden=32, num_layers=4, wavelet=wavelet)
    jspec = jfg.make_spec(**kw)
    jparams, _ = jfg.init_model(jax.random.key(bits), jspec)
    jparams = prune(jparams, 0.7, seed=bits)
    ours, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    tct.store_model_parameters(to_port(jparams, tfg.make_spec(**kw)), ours, bit_precision=bits)
    jct.store_model_parameters(jspec, jparams, theirs, bit_precision=bits)
    for suffix in ('', '_mask.bnr'):
        with open(ours + suffix, 'rb') as a, open(theirs + suffix, 'rb') as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize('case', sorted(BLOCKS))
def test_lz4_is_the_python_decoder(case):
    seqs, tail, history = BLOCKS[case]
    block = _lz4_block(seqs, tail)
    want = _expand(seqs, tail, history)
    assert lib.lz4_decompress(block, len(want), history[-65536:]) == want
    assert tcvol._lz4_decompress_block_py(block, len(want), history) == want


MALFORMED = {
    'offset_zero': _lz4_block([(b'abcd', 0, 8)], b'x'),
    'offset_before_history': _lz4_block([(b'abcd', 9, 8)], b'x'),
    'truncated_offset': _lz4_block([(b'abcd', 2, 8)], b'')[:6],
    'truncated_literals': _lz4_block([], bytes(range(40)))[:20],
    'literal_length_runs_out': bytes([0xF0, 255, 255]),
    'past_the_slice': _lz4_block([(b'ab', 2, 100)], b''),
}


@pytest.mark.parametrize('case', sorted(MALFORMED))
def test_lz4_refuses_a_malformed_block(case):
    with pytest.raises(ValueError, match='malformed LZ4 block'):
        lib.lz4_decompress(MALFORMED[case], 64, b'')


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_compressed_cvol_through_the_helper(dtype, tmp_path):
    """read_cvol decodes through the helper; the Python decoder gives the
    same volume; a slice that decodes short is refused."""
    from tests.test_torch_readers import _slices_repeat
    vol = _slices_repeat(np.random.default_rng(5).uniform(0, 250, (24, 16, 6)).astype(dtype))
    path = str(tmp_path / 'c.cvol')
    _write_compressed_cvol(path, vol)
    np.testing.assert_array_equal(tcvol.read_cvol(path), vol)
    data = bytearray(open(path, 'rb').read())
    first = int.from_bytes(data[64:68], 'little')
    short = _lz4_block([], bytes(first // 2))
    data[64:68 + first] = len(short).to_bytes(4, 'little') + short
    bad = tmp_path / 'short.cvol'
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='decoded to'):
        tcvol.read_cvol(str(bad))


@pytest.mark.parametrize('bits', [1, 2, 3, 5, 7, 8, 9, 12, 16])
@pytest.mark.parametrize('n', [0, 1, 7, 301])
def test_container_packers_are_the_jax_writers(tmp_path, bits, n):
    """The container's numpy packers give the JAX writer's bytes (its
    native packer, raw bytes at 8 bits), its native unpacker reads them as
    the port's does, and the masks round-trip."""
    ints = np.random.default_rng(bits * 1000 + n).integers(0, 2 ** bits, n)
    packed, leftover = tct.ints_to_bits_to_bytes(ints, bits)
    jpacked, jleftover = jct.ints_to_bits_to_bytes(ints, bits)
    assert bytes(packed) == bytes(jpacked) and leftover == jleftover
    np.testing.assert_array_equal(tct.unpack_bits(bytes(packed), n, bits),
                                  jlib.unpack_bits(bytes(packed), n, bits))
    mask = (np.random.default_rng(bits + n).random(8 * n + bits) < 0.4).astype(np.uint8)
    ours, theirs = str(tmp_path / 'port.bnr'), str(tmp_path / 'jax.bnr')
    tct.write_mask_bnr(mask, ours)
    jct.write_mask_bnr(mask, theirs)
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(tct.read_mask_bnr(ours, len(mask)), mask)


def test_the_helper_builds_into_the_build_directory():
    """Keyed by the source's hash, beside the kernels' libraries (both
    git-ignored), and rebuilt only when the source changes."""
    path = lib.library_path()
    assert path.parent == tct.native._build.BUILD_DIR and path.exists()
    assert path.name.startswith('liblfgc_io-') and path.suffix == '.so'
    assert lib.build() is False
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), '.gitignore')) as f:
        assert 'latent_feature_grid_compression_tpu_torch/build/' in f.read().split()
