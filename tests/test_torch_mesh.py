"""The port's multi-device training (``parallel/``, the mesh paths of
``train/trainer.py`` and ``train/run.py``, tile-local decode) on the CPU
under gloo, held against the JAX package's single-device step and its own
replicated path, at the sizes of ``tests/test_sharding.py::setup`` (16^3
volume, grid 8, 4 features, 2 x 16 MLP, batch 64 x 8) with the tolerances
of the JAX tests each check mirrors.

The ranks run in spawned processes (``tests/torch_mesh_worker.py``): one
world of 2 and one of 4, each started once in a pytest run, however
pytest-xdist spreads the file's tests (``_spawn_once``), with a rendezvous
file of its own."""

import fcntl
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_feature_grid_compression_tpu import config as jconfig
from latent_feature_grid_compression_tpu.data.volume import VolumeMeta as JMeta
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu.ops import dwt as jdwt
from latent_feature_grid_compression_tpu.parallel import mesh as jmesh
from latent_feature_grid_compression_tpu.train import trainer as jtr
from latent_feature_grid_compression_tpu_torch.config import TrainConfig
from latent_feature_grid_compression_tpu_torch.convert import tensors_from_jax
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.io.train_state_io import (
    load_train_state, save_train_state)
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.ops import dwt as tdwt
from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
from latent_feature_grid_compression_tpu_torch.train import run as trun
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr
from tests import torch_mesh_worker as worker
from tests.torch_port_util import to_port

K = 40          # steps of the exactness checks, as the JAX tests
SIZES = dict(grid_size=8, grid_features=4, hidden=16, num_layers=2)
DROP_TYPES = ('', 'smallify')
# training()'s end-to-end run at the size of __graft_entry__.py::dryrun_multichip
# on 4 devices: state sharded over space and tile-local decode
TRAINING = dict(drop_type='smallify', max_pass=12, batch_size=32, sample_size=8,
                grid_size=8, grid_features=4, n_hidden_size=16, n_layers=2, lr=0.01,
                steps_per_chunk=4, basedir='/', expname='e')
MESH_TRAINING = dict(mesh_data=2, mesh_space=2, mesh_shard_params=1, mesh_local_decode=1,
                     interp_backend='xla')


def synthetic_volume(n=16):
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing='ij')
    return (np.sin(3 * x) * np.cos(2 * y) * np.sin(2 * z)).astype(np.float32)


def _cfg(drop_type):
    kw = dict(lambda_drop_loss=1e-5) if drop_type else {}
    return dict(drop_type=drop_type, max_pass=4, batch_size=64, sample_size=8, grid_size=8,
                grid_features=4, n_hidden_size=16, n_layers=2, lr=0.01, **kw)


def _jax_setup(drop_type, vol):
    """tests/test_sharding.py::setup: the JAX phase spec and state, and the
    same model carried across to the port."""
    cfg = jconfig.TrainConfig(**_cfg(drop_type))
    jspec = jfg.make_spec(drop_type=drop_type, **SIZES)
    params, aux = jfg.init_model(jax.random.key(0), jspec)
    ph = jtr.make_phase_spec(cfg, jspec, JMeta(vol.shape), phase=1)
    state = jtr.init_train_state(params, None, aux, cfg.lr, cfg.lr, jax.random.key(1),
                                 cfg.lambda_drop_loss)
    model = to_port(params, tfg.make_spec(drop_type=drop_type, **SIZES), gate_aux=aux)
    return ph, state, model


def _jax_run(ph, state, vol, pos_all):
    """JAX's single-device step scanned over the stream (as the JAX tests)."""
    _, step_fn, _ = jtr._make_step_parts(ph, None, None)
    gate_keys = jax.random.split(jax.random.key(8), len(pos_all))
    volume = jnp.asarray(vol)

    @jax.jit
    def run(s, pos, keys):
        return jax.lax.scan(lambda s, xs: step_fn(s, volume, *xs), s, (pos, keys))
    return run(state, jnp.asarray(pos_all), gate_keys)


def _jax_flat(state, drop_type):
    """The JAX state's trainables in the port's flat order."""
    p = state.params
    names = ['coeffs', 'mlp_w', 'mlp_b'] + (['betas'] if drop_type else [])
    gates = {'betas': [np.asarray(b) for b in p.gates.betas]} if drop_type else None
    return np.concatenate([t.ravel() for t in tensors_from_jax(
        names, [np.asarray(c) for c in p.coeffs], [np.asarray(w) for w in p.mlp_w],
        [np.asarray(b) for b in p.mlp_b], gates, None)])


def _jax_ema_var(state):
    return np.concatenate([np.asarray(e).ravel() for e in state.gate_aux.ema_var])


@pytest.fixture(scope='module')
def streams():
    vol = synthetic_volume()
    res = np.asarray(vol.shape, np.int32)
    pos_all = np.asarray(jax.random.randint(jax.random.key(7), (K, 512, 3), 0,
                                            res[None, None, :]))
    # stratified: the first half of each step in slab 0 (x < 8), the second
    # in slab 1
    pos_space = pos_all.copy()
    pos_space[..., 0] %= 8
    pos_space[:, 256:, 0] += 8
    return vol, pos_all, pos_space


@pytest.fixture(scope='module')
def jax_runs(streams):
    vol, pos_all, pos_space = streams
    out, models = {}, {}
    for drop_type in DROP_TYPES:
        ph, state, models[drop_type] = _jax_setup(drop_type, vol)
        out[drop_type] = _jax_run(ph, state, vol, pos_all)
    ph, state, _ = _jax_setup('', vol)
    out['space'] = _jax_run(ph, state, vol, pos_space)
    return out, models


def _job(streams, models, tasks):
    vol, pos_all, pos_space = streams
    return dict(tasks=tasks, volume=vol, pos_all=pos_all, pos_space=pos_space,
                models=models, cfg={d: _cfg(d) for d in DROP_TYPES},
                training_cfg=dict(TRAINING, **MESH_TRAINING))


def _spawn_once(tmp_path_factory, world, job):
    """``worker.spawn`` of ``job`` once in a pytest run, its results on
    every pytest-xdist worker that asks: the first to take the lock spawns
    into a directory of the run's common temporary root, the others wait
    and read what it left (a worker whose spawn failed leaves nothing, and
    the next one spawns again in a directory of its own)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent          # the run's root, above each worker's
    home = root / f'torch_mesh_world{world}'
    home.mkdir(exist_ok=True)
    done = home / 'done'
    with open(home / 'lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            out = Path(tempfile.mkdtemp(dir=home))
            worker.spawn(world, job, out)
            done.write_text(str(out))
    return worker.results(world, done.read_text())


@pytest.fixture(scope='module')
def world2(streams, jax_runs, tmp_path_factory):
    return _spawn_once(tmp_path_factory, 2, _job(streams, jax_runs[1],
                                                 ['dp', 'space', 'resume', 'launch_check']))


@pytest.fixture(scope='module')
def world4(streams, jax_runs, tmp_path_factory):
    return _spawn_once(tmp_path_factory, 4,
                       _job(streams, jax_runs[1], ['zero', 'local', 'training']))


# ---------------------------------------------------------------------------
# 1-2. Data-parallel and space-sharded steps against JAX's single device
# ---------------------------------------------------------------------------

def _assert_matches_jax(got, want, drop_type):
    s_jax, m_jax = want
    np.testing.assert_allclose(got['losses'][0], np.asarray(m_jax['loss'])[0],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got['flat'], _jax_flat(s_jax, drop_type),
                               rtol=2e-4, atol=2e-5)
    if drop_type == 'smallify':
        np.testing.assert_allclose(got['ema_var'], _jax_ema_var(s_jax),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('drop_type', DROP_TYPES)
def test_dp_step_matches_jax_single_device(world2, jax_runs, drop_type):
    """Mirrors test_dp_step_exactly_matches_single_device: the global stream
    through JAX's single-device step, each half through one of two ranks
    (data 2); the mean of the ranks' mean gradients is the global mean."""
    _assert_matches_jax(world2[0]['dp'][drop_type], jax_runs[0][drop_type], drop_type)


@pytest.mark.parametrize('drop_type', DROP_TYPES)
def test_dp_ranks_stay_bitwise_in_sync(world2, drop_type):
    a, b = (r['dp'][drop_type] for r in world2)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_space_offsets_restore_the_global_stream(world2, streams):
    """At space 2 each rank's positions lie in its slab; plus its offset
    they are its half of the global stream, and the coordinates and ground
    truth it computes from them equal those of the global positions."""
    vol, _, pos_space = streams
    c = ttr.PhaseConstants(ttr.make_phase_spec(
        TrainConfig(**_cfg('')), tfg.make_spec(**SIZES), VolumeMeta(vol.shape), phase=1),
        torch.from_numpy(vol))
    for rank, r in enumerate(world2):
        local = r['space']['local']
        assert local[..., 0].min() >= 0 and local[..., 0].max() < 8
        glob = local.copy()
        glob[..., 0] += 8 * rank
        np.testing.assert_array_equal(glob, pos_space[:, 256 * rank:256 * (rank + 1)])
        norm, gt = ttr.chunk_inputs(c, torch.from_numpy(glob[:1]))
        np.testing.assert_array_equal(r['space']['norm'], norm[0].numpy())
        np.testing.assert_array_equal(r['space']['gt'], gt[0].numpy())


def test_space_sharded_step_matches_jax_single_device(world2, jax_runs):
    _assert_matches_jax(world2[0]['space'], jax_runs[0]['space'], '')
    np.testing.assert_array_equal(world2[0]['space']['flat'], world2[1]['space']['flat'])


# ---------------------------------------------------------------------------
# 3. ZeRO-sharded state against the replicated state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('drop_type', DROP_TYPES)
def test_zero_matches_replicated_path(world4, drop_type):
    """Mirrors test_exactly_matches_replicated_path (data 2 x space 2): the
    all-gather and the reduce-scatter-then-data-mean give the replicated
    all-reduce's step; the tracker bit for bit; every rank the same."""
    for r in world4:
        rep, zero = r['zero'][(drop_type, False)], r['zero'][(drop_type, True)]
        np.testing.assert_allclose(zero['losses'], rep['losses'], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(zero['flat'], rep['flat'], rtol=2e-4, atol=2e-5)
        if drop_type == 'smallify':
            np.testing.assert_array_equal(zero['ema_var'], rep['ema_var'])
        np.testing.assert_array_equal(zero['flat'], world4[0]['zero'][(drop_type, True)]['flat'])


def test_zero_state_is_sharded_and_round_trips(world4, jax_runs):
    """Mirrors test_state_is_actually_sharded and test_roundtrip_is_identity:
    each rank holds its 1/space slice of the padded flat vector and both
    moments; the ranks of a data column hold the same slice, the two
    slices of a row the whole vector; unsharding gives the state back."""
    n = world4[0]['zero']['shards']['n_params']
    n_pad = -(-n // 2) * 2
    full = ttr.init_train_state(jax_runs[1]['smallify'], 0.01, 0.01, True).flat.numpy()
    for rank, r in enumerate(world4):
        sh = r['zero']['shards']
        assert sh['n_params'] == full.size
        assert sh['shapes'] == [(n_pad // 2,)] * 3
        assert sh['roundtrip']
        s = rank % 2
        want = np.pad(full, (0, n_pad - n))[s * n_pad // 2:(s + 1) * n_pad // 2]
        np.testing.assert_array_equal(sh['local'], want)


# ---------------------------------------------------------------------------
# 4. last_window and x_window against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('window', [(0, 9), (3, 8), (6, 9), (0, 15)])
def test_decode_pyramid_last_window_matches_jax(window):
    """The windowed decode against JAX's, and against the same columns of
    the full decode, at the flagship grid (16 features, 15^3, db2)."""
    rng = np.random.default_rng(3)
    vol = rng.uniform(-1, 1, (16, 15, 15, 15)).astype(np.float32)
    jf = jdwt.WaveletFilter3d('db2')
    jcoeffs, shapes = jdwt.encode_pyramid(jf, jnp.asarray(vol))
    want = np.asarray(jdwt.decode_pyramid(jf, jcoeffs, shapes, last_window=window))
    coeffs = [torch.from_numpy(np.asarray(c)) for c in jcoeffs]
    tf = tdwt.WaveletFilter3d('db2')
    got = tdwt.decode_pyramid(tf, coeffs, shapes, last_window=window).numpy()
    full = tdwt.decode_pyramid(tf, coeffs, shapes).numpy()
    start, length = window
    assert got.shape == (16, 15, 15, length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, full[..., start:start + length], rtol=0, atol=1e-5)


def test_decode_pyramid_window_outside_raises():
    tf = tdwt.WaveletFilter3d('db2')
    spec = tfg.make_spec(grid_size=15, grid_features=2, hidden=8, num_layers=1)
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
    with pytest.raises(ValueError, match='outside'):
        tdwt.decode_pyramid(tf, list(model.coeffs), spec.level_shapes, last_window=(8, 9))


@pytest.mark.parametrize('train', [True, False])
def test_apply_model_x_window_matches_jax(train):
    """Mirrors test_apply_model_window_matches_full: apply_model(x_window=
    (0, 9)) at coordinates whose support lies in the window, against JAX's
    windowed forward and the port's full forward, within 2e-5."""
    jspec = jfg.make_spec(grid_size=15, grid_features=8, hidden=16, num_layers=2,
                          interp_backend='xla')
    params, _ = jfg.init_model(jax.random.key(0), jspec)
    rng = np.random.default_rng(0)
    c = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    c[:, 0] = rng.uniform(-1.0, 0.0, 512)
    want = np.asarray(jfg.apply_model(jspec, params, jnp.asarray(c), train=train,
                                      x_window=(0, 9)))
    model = to_port(params, tfg.make_spec(grid_size=15, grid_features=8, hidden=16,
                                          num_layers=2, interp_backend='xla'))
    coords = torch.from_numpy(c)
    got = tfg.apply_model(model, coords, train=train, x_window=(0, 9)).detach().numpy()
    full = tfg.apply_model(model, coords, train=train).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, full, rtol=2e-5, atol=2e-5)


def test_x_windows_cover_each_slab():
    """The trainer's windows are the JAX trainer's (one length, starts
    clamped into the grid), and each slab's samples interpolate inside its
    window."""
    spec = tfg.make_spec(**SIZES)
    for n, space in ((16, 2), (16, 4), (256, 2)):
        ph = ttr.make_phase_spec(TrainConfig(**_cfg('')), spec, VolumeMeta((n, n, n)),
                                 phase=1)
        starts, length = ttr.x_windows(ph, space)
        W, lx = spec.grid_size, n // space
        for d, start in enumerate(starts):
            assert 0 <= start <= W - length
            x = np.arange(d * lx, (d + 1) * lx, dtype=np.float32)
            pix = (x / (n - 1)) * W - 0.5
            # the cells the samples interpolate from, padding left out
            assert start <= max(0, np.floor(pix).min())
            assert min(W - 1, np.floor(pix).max() + 1) <= start + length - 1


# ---------------------------------------------------------------------------
# 5. Tile-local decode on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shard_params', [False, True])
def test_local_decode_matches_full_decode(world4, shard_params):
    """Mirrors test_sharded_training_with_local_decode_matches: the same
    generators with local decode off and on give the same losses (rtol
    5e-4), with and without ZeRO; each rank decodes a window narrower than
    the grid."""
    for r in world4:
        off, on = r['local'][(shard_params, False)], r['local'][(shard_params, True)]
        assert len(on) == len(off) > 0
        np.testing.assert_allclose(on, off, rtol=5e-4, atol=1e-6)
        start, length = r['local']['window']
        assert length < SIZES['grid_size']


# ---------------------------------------------------------------------------
# 6. Communication volume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('data,space', [(1, 1), (2, 1), (1, 2), (4, 2), (2, 4), (1, 8), (8, 1)])
@pytest.mark.parametrize('shard_params', [False, True])
def test_comm_volume_matches_jax(data, space, shard_params):
    for P in (113521, 4609):
        assert pm.comm_volume_per_step(P, data, space, shard_params) == \
            jmesh.comm_volume_per_step(P, data, space, shard_params)


# ---------------------------------------------------------------------------
# 7. training() end to end
# ---------------------------------------------------------------------------

def test_training_on_mesh_end_to_end(world4, tmp_path, monkeypatch):
    """data 2 x space 2, smallify, the state sharded and tile-local decode,
    both phases through the export: finite PSNR within 3 dB of the
    single-device run (and above 20 dB, as dryrun_multichip asks); every
    rank's final flat vector of each phase bit for bit the same; only rank
    0 wrote files; every rank returns rank 0's evaluation."""
    monkeypatch.chdir(tmp_path)
    single = trun.training(TrainConfig(**TRAINING), verbose=False,
                           volume_np=synthetic_volume(), write_vols=False, device='cpu')
    infos = [r['training']['info'] for r in world4]
    psnr = infos[0]['psnr']
    assert np.isfinite(psnr) and psnr > 20.0, psnr
    assert abs(psnr - single['psnr']) < 3.0, (psnr, single['psnr'])
    assert all(i['psnr'] == psnr and i['num_zeros'] == infos[0]['num_zeros'] for i in infos)
    assert infos[0]['train_phase1_steps'] > 0 and infos[0]['train_phase2_steps'] > 0
    for r in world4[1:]:
        for a, b in zip(r['training']['flats'], world4[0]['training']['flats']):
            np.testing.assert_array_equal(a, b)
    assert len(world4[0]['training']['flats']) == 2
    files = world4[0]['training']['files']
    for name in ('e/info.txt', 'e/model.npz', 'e/binary_model_file', 'e/bake.npz',
                 'e/resume_meta.txt', 'e/train_state_phase1.npz'):
        assert name in files, files
    for r in world4[1:]:
        assert r['training']['files'] == [], r['training']['files']


# ---------------------------------------------------------------------------
# 8. What raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw', [dict(mesh_data=2), dict(mesh_space=2),
                                dict(mesh_data=2, mesh_space=2)])
def test_mesh_without_its_processes_raises(kw):
    with pytest.raises(ValueError, match='torchrun --nproc_per_node'):
        trun.training(TrainConfig(**kw), device='cpu', volume_np=synthetic_volume())


def test_mesh_without_a_device_is_on_the_card(tmp_path):
    """make_mesh with no device takes the current card whatever the
    backend, gloo too, and raises where there is none: only a caller that
    passes 'cpu' gets a mesh on the CPU."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='file://' + str(tmp_path / 'rendezvous'),
                            world_size=1, rank=0)
    try:
        assert pm.make_mesh(1, 1, 'cpu').device == torch.device('cpu')
        if torch.cuda.is_available():
            assert pm.make_mesh(1, 1).device == torch.device(
                'cuda', torch.cuda.current_device())
        else:
            with pytest.raises(RuntimeError, match='CUDA is not available'):
                pm.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_larger_than_the_world_raises(world2):
    for r in world2:
        assert 'torchrun --nproc_per_node 4' in r['launch_check']
        assert 'has 2' in r['launch_check']


@pytest.mark.parametrize('kw,match', [
    (dict(interp_backend='fused'), "interp_backend 'xla'"),
    (dict(interp_backend='auto'), "interp_backend 'xla'"),
    (dict(interp_backend='pallas'), "interp_backend 'xla'"),
    (dict(interp_backend='xla', mlp_backend='pallas'), 'float32 fetch and MLP'),
    (dict(interp_backend='xla', compute_dtype='bfloat16'), 'float32 fetch and MLP'),
    (dict(interp_backend='pallas_bf16'), "interp_backend 'xla'"),
    (dict(interp_backend='xla', mesh_space=1), 'mesh_space > 1')])
def test_local_decode_off_its_path_raises(kw, match):
    """The JAX package drops local decode or changes backend silently under
    these; the port raises before it starts a process group."""
    cfg = TrainConfig(**dict(dict(mesh_space=2, mesh_local_decode=1, grid_size=8), **kw))
    with pytest.raises(ValueError, match=match):
        trun.training(cfg, device='cpu', volume_np=synthetic_volume())


def test_local_decode_on_a_volume_the_axis_does_not_divide_raises():
    cfg = TrainConfig(mesh_space=2, mesh_local_decode=1, interp_backend='xla')
    with pytest.raises(ValueError, match='does not divide'):
        trun.training(cfg, device='cpu', volume_np=synthetic_volume(15))


def test_windowed_forward_off_its_path_raises():
    for kw in (dict(interp_backend='fused'), dict(mlp_backend='pallas'),
               dict(compute_dtype='bfloat16')):
        model = tfg.init_model(tfg.make_spec(**SIZES, **kw), torch.Generator().manual_seed(0),
                               device='cpu')
        with pytest.raises(ValueError, match='tile-local decode'):
            tfg.apply_model(model, torch.zeros(4, 3), x_window=(0, 6))


def _saved_state(tmp_path, mesh_shape):
    vol = synthetic_volume()
    spec = tfg.make_spec(drop_type='smallify', **SIZES)
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
    st = ttr.init_train_state(model, 0.01, 0.01, True)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    path = str(tmp_path / 'train_state_phase1.npz')
    save_train_state(path, st, (gens[0], gens[2]), mesh_shape=mesh_shape,
                     rank_states=None if mesh_shape is None else
                     [g.get_state() for g in gens[:2]])
    return path, st, vol


def test_resume_on_another_mesh_shape_raises(tmp_path):
    path, st, vol = _saved_state(tmp_path, (2, 1))
    for shape in (None, (1, 2), (4, 1)):
        with pytest.raises(ValueError, match='saved on the mesh'):
            load_train_state(path, st, mesh_shape=shape)
    # the rank's own position generator comes back
    g = torch.Generator()
    load_train_state(path, st, (g,), mesh_shape=(2, 1), rank=1)
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(1).get_state())
    # a single device's file on a mesh
    (tmp_path / 'single').mkdir()
    single, st, _ = _saved_state(tmp_path / 'single', None)
    with pytest.raises(ValueError, match='saved on the mesh'):
        load_train_state(single, st, mesh_shape=(2, 1))


def test_training_resume_on_another_mesh_shape_raises(tmp_path, monkeypatch):
    """A run saved on a data-2 mesh, resumed on one device, raises before
    it takes a step."""
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / 'run'
    exp.mkdir()
    cfg = TrainConfig(**dict(TRAINING, expname='again', drop_type='smallify',
                             resume=str(exp)))
    spec = tfg.make_spec(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
                         grid_features=4, grid_size=8, drop_type='smallify')
    model = tfg.init_model(spec, torch.Generator().manual_seed(0), device='cpu')
    st = ttr.init_train_state(model, 0.01, 0.01, True)
    save_train_state(str(exp / 'train_state_phase1.npz'), st, mesh_shape=(2, 1))
    (exp / 'resume_meta.txt').write_text('phase = 1\n')
    with pytest.raises(ValueError, match='saved on the mesh'):
        trun.training(cfg, verbose=False, volume_np=synthetic_volume(), device='cpu')


# ---------------------------------------------------------------------------
# 9. Resume on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['data2', 'space2_zero'])
def test_mesh_resume_is_bit_exact(world2, name):
    """Phase 1 killed after its second chunk and resumed from the file rank
    0 saved (the replicated state, every rank's position generator): the
    losses and the final state equal the uninterrupted run's bit for bit,
    on both ranks."""
    for r in world2:
        got = r['resume'][name]
        assert got['steps'][0] == got['steps'][1] > 8
        np.testing.assert_array_equal(got['pieces'], got['whole'])
        for field, value in got['final'].items():
            np.testing.assert_array_equal(got['resumed'][field], value, err_msg=field)
    np.testing.assert_array_equal(world2[0]['resume'][name]['final']['flat'],
                                  world2[1]['resume'][name]['final']['flat'])

