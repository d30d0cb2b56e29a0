"""The decompression slice as a whole against the JAX package: full-volume
reconstruction and statistics on an anisotropic volume, and infer_torch.py
end to end on the CPU."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch
import jax

import infer_torch
from latent_feature_grid_compression_tpu import config as jconfig
from latent_feature_grid_compression_tpu.data.volume import VolumeMeta as JaxMeta
from latent_feature_grid_compression_tpu.data.volume import load_volume as jax_load_volume
from latent_feature_grid_compression_tpu.eval import reconstruct as jrec
from latent_feature_grid_compression_tpu.io import checkpoint as jck
from latent_feature_grid_compression_tpu.io import container as jct
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu_torch import config as tconfig
from latent_feature_grid_compression_tpu_torch.convert import params_from_jax
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval import reconstruct as trec
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models.gates import init_gates
from latent_feature_grid_compression_tpu_torch.ops.dwt import encode_pyramid
from latent_feature_grid_compression_tpu_torch.ops.mlp import init_mlp
from tests.torch_port_util import prune, to_port

# anisotropic: the lattice order (ix = lin // (Y*Z)) and the anisotropy
# scales both matter
SHAPE = (20, 24, 28)
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       'experiment-config-files')
SPEC = dict(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=2,
            grid_features=16, grid_size=15, wavelet='db2')


def _volume(seed=0):
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n) for n in SHAPE], indexing='ij')
    vol = np.sin(3 * x) * np.cos(2 * y) * np.sin(4 * z) + 0.1 * rng.standard_normal(SHAPE)
    vol = 2 * (vol - vol.min()) / (vol.max() - vol.min()) - 1
    return vol.astype(np.float32)


@pytest.fixture(scope='module')
def models():
    jspec = jfg.make_spec(**SPEC)
    jparams, _ = jfg.init_model(jax.random.key(5), jspec)
    jparams = prune(jparams, 0.66, seed=0)
    return jspec, jparams, to_port(jparams, tfg.make_spec(**SPEC))


@pytest.mark.parametrize('chunk', [trec.CHUNK, 4096])
def test_field_matches_jax(models, chunk):
    jspec, jparams, model = models
    ref = jrec.field_from_net(jspec, jparams, JaxMeta(SHAPE), chunk=chunk)
    out = trec.field_from_net(model, VolumeMeta(SHAPE), chunk=chunk, device='cpu')
    assert out.shape == SHAPE and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=5e-5)


def test_device_stats_match_jax(models):
    jspec, jparams, model = models
    vol = _volume()
    ref = jrec.tiled_net_out(jspec, jparams, JaxMeta(SHAPE), gt_vol=vol)
    out = trec.tiled_net_out(model, VolumeMeta(SHAPE), gt_vol=vol, device='cpu')
    assert abs(out[0] - ref[0]) <= 1e-3
    np.testing.assert_allclose(out[1:], ref[1:], rtol=1e-4)


def test_device_stats_from_gt_dev_alone_match_jax(models):
    """With the ground truth given only as a device tensor, tiled_net_out
    takes the device-stats path, as the JAX package's does."""
    jspec, jparams, model = models
    vol = _volume(4)
    ref = jrec.tiled_net_out(jspec, jparams, JaxMeta(SHAPE), gt_dev=jax.numpy.asarray(vol))
    out = trec.tiled_net_out(model, VolumeMeta(SHAPE), gt_dev=torch.from_numpy(vol),
                             device='cpu')
    assert out[0] != 0.0
    assert abs(out[0] - ref[0]) <= 1e-3
    np.testing.assert_allclose(out[1:], ref[1:], rtol=1e-4)


def test_gt_dev_alone_gives_the_gt_vol_stats(models):
    _, _, model = models
    vol = _volume(5)
    meta = VolumeMeta(SHAPE)
    from_dev = trec.tiled_net_out(model, meta, gt_dev=torch.from_numpy(vol), device='cpu')
    from_host = trec.tiled_net_out(model, meta, gt_vol=vol, device='cpu')
    assert from_dev == from_host and from_dev[0] > 0.0


def test_device_stats_equal_host_stats(models):
    _, _, model = models
    vol = _volume(1)
    meta = VolumeMeta(SHAPE)
    on_device = trec.eval_stats_on_device(model, meta, torch.from_numpy(vol),
                                          chunk=2048, device='cpu')
    field = trec.field_from_net(model, meta, device='cpu')
    host = trec.deviation_statistics(field, vol)
    assert abs(on_device[0] - host[0]) <= 1e-3
    np.testing.assert_allclose(on_device[1:], host[1:], rtol=1e-4)


def test_write_vols_matches_jax_host_stats(models, tmp_path):
    jspec, jparams, model = models
    vol = _volume(2)
    ref = jrec.tiled_net_out(jspec, jparams, JaxMeta(SHAPE), gt_vol=vol,
                             write_vols=True, filename=str(tmp_path / 'jax_vol'))
    out = trec.tiled_net_out(model, VolumeMeta(SHAPE), gt_vol=vol, write_vols=True,
                             filename=str(tmp_path / 'vol'), device='cpu')
    assert abs(out[0] - ref[0]) <= 1e-3
    assert os.path.getsize(tmp_path / 'vol.vti') == os.path.getsize(tmp_path / 'jax_vol.vti')
    assert os.path.exists(tmp_path / 'gt.vti')


def _experiment(tmp_path, jspec, jparams):
    vol_path = str(tmp_path / 'vol.npy')
    np.save(vol_path, _volume(3) * 7.0 + 2.0)  # load_volume renormalizes
    ckpt = str(tmp_path / 'model.npz')
    jck.save_checkpoint(ckpt, jparams, None, '')
    binary = str(tmp_path / 'binary_model_file')
    jct.store_model_parameters(jspec, jparams, binary, bit_precision=8,
                               kmeans_seed=0)
    cfg = str(tmp_path / 'config.txt')
    with open(cfg, 'w') as f:
        for k, v in {'data': vol_path, 'checkpoint_path': ckpt,
                     'binary_checkpoint_path': binary, 'n_layers': 4,
                     'n_hidden_size': 32, 'n_embedding_freq': 2,
                     'grid_features': 16, 'grid_size': 15,
                     'wavelet_filter': 'db2', 'drop_type': 'smallify',
                     'psnr': 12.5}.items():
            f.write(f'{k} = {v}\n')
    return cfg, vol_path


@pytest.mark.parametrize('mode', ['checkpoint', 'binary'])
def test_infer_torch_cpu_end_to_end(models, tmp_path, monkeypatch, capsys, mode):
    jspec, jparams, _ = models
    cfg, vol_path = _experiment(tmp_path, jspec, jparams)
    if mode == 'binary':
        jspec, jparams = jct.restore_model(str(tmp_path / 'binary_model_file'))
    want = jrec.tiled_net_out(jspec, jparams, JaxMeta(SHAPE),
                              gt_vol=jax_load_volume(vol_path))[0]
    monkeypatch.chdir(tmp_path)
    psnr = infer_torch.main(['--config_path', cfg, '--reconstruct', mode,
                             '--device', 'cpu'])[0]
    assert abs(psnr - want) <= 1e-3
    assert f'PSNR: {psnr:.3f}' in capsys.readouterr().out
    assert (tmp_path / 'vol.vti').exists() and (tmp_path / 'gt.vti').exists()


def test_entry_points_raise_without_cuda(models, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CUDA default does not raise')
    jspec, jparams, model = models
    cfg, _ = _experiment(tmp_path, jspec, jparams)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        infer_torch.main(['--config_path', cfg, '--reconstruct', 'checkpoint'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trec.field_from_net(model, VolumeMeta(SHAPE))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        trec.tiled_net_out(model, VolumeMeta(SHAPE), gt_vol=_volume())
    assert not (tmp_path / 'vol.vti').exists()
    spec = tfg.make_spec(**SPEC)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tfg.init_model(spec, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        params_from_jax([np.asarray(c) for c in jparams.coeffs],
                        [np.asarray(w) for w in jparams.mlp_w],
                        [np.asarray(b) for b in jparams.mlp_b], spec)


def test_init_model_on_cpu_keeps_its_draws():
    """init_model(..., device='cpu') draws the grid, the MLP and the gates
    from the caller's generator in that order, as before the CUDA default:
    the same tensors bit for bit as those draws made by hand, and the MLP
    and gate tensors of seed 7 have the digest they had then."""
    spec = tfg.make_spec(grid_size=8, grid_features=4, hidden=8, num_layers=2,
                         drop_type='smallify')
    model = tfg.init_model(spec, torch.Generator().manual_seed(7), device='cpu')
    gen = torch.Generator().manual_seed(7)
    grid = torch.rand((spec.grid_features,) + (spec.grid_size,) * 3, generator=gen)
    coeffs, _ = encode_pyramid(spec.filter(), grid, spec.num_levels)
    mlp_w, mlp_b = init_mlp(gen, spec.mlp_in, spec.hidden, spec.d_out, spec.num_layers)
    gates = init_gates(gen, spec.drop_type, [tuple(c.shape) for c in coeffs])
    for got, want in [(model.coeffs, coeffs), (model.mlp_w, mlp_w), (model.mlp_b, mlp_b),
                      (model.betas, gates.betas), (model.ema, gates.ema),
                      (model.ema_var, gates.ema_var)]:
        assert len(got) == len(want)
        assert all(g.device.type == 'cpu' and torch.equal(g.detach(), w)
                   for g, w in zip(got, want))
    digest = hashlib.sha256()
    for ts in (model.mlp_w, model.mlp_b, model.betas, model.ema, model.ema_var):
        for t in ts:
            digest.update(t.detach().numpy().tobytes())
    assert digest.hexdigest() == ('d9cd8205fba1cdce6025679f8b9ab8df'
                                  '5edf33545fa3027f475bb1f397f8d98a')


@pytest.mark.parametrize('name', sorted(os.listdir(CONFIGS)))
def test_load_config_matches_jax(name):
    path = os.path.join(CONFIGS, name)
    assert tconfig.dict_from_file(path) == jconfig.dict_from_file(path)
    ours, ref = tconfig.load_config(path), jconfig.load_config(path)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
