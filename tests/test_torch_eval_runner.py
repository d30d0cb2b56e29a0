"""The port's evaluation as the JAX evaluation's one-dispatch ``lax.map``
(``eval/reconstruct.py``: ``ChunkBody``, ``run_chunks``,
``use_eval_graphs``) on the CPU at small widths: the chunk body, stepped on
its device counter, against JAX's ``field_from_net`` and
``eval_stats_on_device`` with and without a partial last chunk; the eager
body against the per-chunk loop it replaced (kept here as the plain
reference) bit for bit; no tensor made from host data and none read back
inside the chunk loop; the rule for ``graphs``; and graphed evaluations with
the capture stubbed at its one seam, ``trainer.capture_graph``: one capture
an evaluation, a replay a chunk, each replay counting the capture's
launches, and the graph destroyed when the evaluation returns or raises."""

import contextlib
import math
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax

from latent_feature_grid_compression_tpu.data.volume import VolumeMeta as JaxMeta
from latent_feature_grid_compression_tpu.eval import reconstruct as jrec
from latent_feature_grid_compression_tpu.models import feature_grid as jfg
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval import reconstruct as trec
from latent_feature_grid_compression_tpu_torch.models import feature_grid as tfg
from latent_feature_grid_compression_tpu_torch.models.feature_grid import (
    decode_volume, predict_trilinear)
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import launch_counts
from latent_feature_grid_compression_tpu_torch.ops.interpolation import channel_minor
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr
from tests.torch_port_util import prune, to_port

SPEC = dict(d_in=3, hidden=16, d_out=1, num_layers=2, n_freqs=2,
            grid_features=8, grid_size=8, wavelet='db2')
CHUNK = 256
# 1,001 voxels: 4 chunks, the last 23 past the end; 1,024: 4 whole chunks
SHAPES = [(13, 11, 7), (16, 8, 8)]


def _volume(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope='module')
def models():
    jspec = jfg.make_spec(**SPEC)
    jparams, _ = jfg.init_model(jax.random.key(7), jspec)
    jparams = prune(jparams, 0.5, seed=1)
    return jspec, jparams, to_port(jparams, tfg.make_spec(**SPEC))


def _old_lattice_chunk(meta, start, chunk):
    """The per-chunk lattice the evaluation made before: its constants
    built from host data at every chunk."""
    X, Y, Z = meta.resolution
    n = meta.n_voxels
    lin = start + torch.arange(chunk, dtype=torch.int64)
    valid = lin < n
    lin = lin.clamp(max=n - 1)
    raw = torch.stack([lin // (Y * Z), (lin // Z) % Y, lin % Z], dim=1).to(torch.float32)
    c = (raw / torch.as_tensor(meta.max_idx)) * 2.0 - 1.0
    return c * torch.as_tensor(meta.scales), valid


@torch.no_grad()
def _old_loop(model, meta, chunk, vol=None):
    """The per-chunk loop of host integers the evaluation ran before: the
    padded field, or the (n_chunks, 2) per-chunk sums against ``vol``."""
    grid_cl = channel_minor(decode_volume(model))
    n = meta.n_voxels
    n_chunks = math.ceil(n / chunk)
    out = torch.empty(n_chunks * chunk) if vol is None else torch.empty((n_chunks, 2))
    flat = None if vol is None else F.pad(vol.reshape(-1), (0, n_chunks * chunk - n))
    for k in range(n_chunks):
        start = k * chunk
        c, valid = _old_lattice_chunk(meta, start, chunk)
        pred = predict_trilinear(model, grid_cl, c)[:, 0]
        if vol is None:
            out[start:start + chunk] = pred
        else:
            diff = torch.where(valid, flat[start:start + chunk] - pred, 0.0)
            out[k, 0] = torch.sum(diff * diff)
            out[k, 1] = torch.sum(diff.abs())
    return out


@pytest.mark.parametrize('shape', SHAPES)
def test_counter_body_matches_jax(models, shape):
    """The body stepped on its counter (eagerly, the CPU's default) against
    JAX's one-dispatch field and device stats, within test_torch_slice.py's
    tolerances."""
    jspec, jparams, model = models
    vol = _volume(shape, 2)
    ref = jrec.field_from_net(jspec, jparams, JaxMeta(shape), chunk=CHUNK)
    out = trec.field_from_net(model, VolumeMeta(shape), chunk=CHUNK, device='cpu')
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=5e-5)
    ref = jrec.eval_stats_on_device(jspec, jparams, JaxMeta(shape),
                                    jax.numpy.asarray(vol), chunk=CHUNK)
    got = trec.eval_stats_on_device(model, VolumeMeta(shape), torch.from_numpy(vol),
                                    chunk=CHUNK, device='cpu')
    assert abs(got[0] - ref[0]) <= 1e-3
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4)


@pytest.mark.parametrize('shape', SHAPES)
def test_eager_body_equals_the_old_loop(models, shape):
    """``graphs=False``: the field, each chunk's sums and the stats bit for
    bit those of the per-chunk loop of host integers."""
    _, _, model = models
    meta = VolumeMeta(shape)
    vol = torch.from_numpy(_volume(shape, 3))
    want_field = _old_loop(model, meta, CHUNK)[:meta.n_voxels].reshape(shape)
    want_sums = _old_loop(model, meta, CHUNK, vol)
    field = trec.field_on_device(model, meta, CHUNK, 'cpu', graphs=False)
    sums = trec.chunk_sums(model, meta, vol, CHUNK, 'cpu', graphs=False)
    assert torch.equal(field, want_field) and torch.equal(sums, want_sums)
    total = want_sums.sum(dim=0)
    sum_sq, sum_abs = float(total[0]), float(total[1])
    rng = float(vol.max() - vol.min())
    mse = sum_sq / meta.n_voxels
    want = (10.0 * math.log10(rng * rng / mse), sum_abs / meta.n_voxels, mse, math.sqrt(mse))
    assert trec.eval_stats_on_device(model, meta, vol, CHUNK, 'cpu', graphs=False) == want


def test_lattice_chunk_takes_an_int_or_a_device_counter():
    """A host start and the counter's tensor start give the per-chunk
    lattice of before, bit for bit, the last chunk clamped and masked."""
    meta = VolumeMeta((13, 11, 7))
    lat = trec.lattice_constants(meta, CHUNK, torch.device('cpu'))
    assert lat.n_chunks == 4
    for k in range(lat.n_chunks):
        want = _old_lattice_chunk(meta, k * CHUNK, CHUNK)
        for start in (k * CHUNK, torch.tensor([k], dtype=torch.int64) * CHUNK):
            got = trec.lattice_chunk(lat, start)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[1].sum()) == meta.n_voxels - 3 * CHUNK


def _refuse(what):
    def refuse(*a, **k):
        raise AssertionError(f'{what} inside the chunk loop')
    return refuse


@pytest.mark.parametrize('entry', ['field', 'stats'])
def test_no_host_tensor_inside_the_chunk_loop(models, monkeypatch, entry):
    """Once the body is made (its constants on the device), the chunks make
    no tensor from host data and read none back: every such call is made
    to raise for the length of the loop."""
    _, _, model = models
    meta = VolumeMeta((13, 11, 7))
    vol = torch.from_numpy(_volume(meta.resolution, 4))
    run = trec.run_chunks
    loops = []

    def guarded(body, graphs):
        with monkeypatch.context() as m:
            for name in ('tensor', 'as_tensor', 'from_numpy', 'asarray'):
                m.setattr(torch, name, _refuse(f'torch.{name}'))
            for name in ('item', 'tolist', 'cpu', 'numpy', '__bool__', '__float__',
                         '__int__', '__index__'):
                m.setattr(torch.Tensor, name, _refuse(f'Tensor.{name}'))
            out = run(body, graphs)
        loops.append(body.lat.n_chunks)
        return out
    monkeypatch.setattr(trec, 'run_chunks', guarded)
    if entry == 'field':
        got = trec.field_from_net(model, meta, CHUNK, 'cpu')
        assert got.shape == meta.resolution
    else:
        got = trec.eval_stats_on_device(model, meta, vol, CHUNK, 'cpu')
        assert np.isfinite(got).all()
    assert loops == [4]


@pytest.mark.parametrize('graphs,device,n_chunks,want', [
    (None, 'cpu', 64, False), (False, 'cpu', 64, False), (None, 'cuda', 64, True),
    (None, 'cuda:0', trec.GRAPH_MIN_CHUNKS, True),
    (None, 'cuda', trec.GRAPH_MIN_CHUNKS - 1, False), (None, 'cuda:1', 1, False),
    (False, 'cuda', 64, False), (True, 'cuda', 1, True)])
def test_graphs_rule(graphs, device, n_chunks, want):
    """``None``: graphed on a card (stub devices here) from
    ``GRAPH_MIN_CHUNKS`` chunks on, else eager, and eager on the CPU;
    ``False`` eager; ``True`` graphed on a card at any size."""
    assert trec.use_eval_graphs(graphs, torch.device(device), n_chunks) is want


def test_graphs_true_on_the_cpu_raises(models, monkeypatch):
    """``graphs=True`` on the CPU raises before any chunk or capture."""
    _, _, model = models
    meta = VolumeMeta((13, 11, 7))
    monkeypatch.setattr(ttr, 'capture_graph', _refuse('a capture'))
    monkeypatch.setattr(trec, 'ChunkBody', _refuse('a chunk body'))
    with pytest.raises(ValueError, match="the evaluation's CUDA graph needs a card"):
        trec.use_eval_graphs(True, 'cpu', 64)
    for call in (lambda: trec.field_from_net(model, meta, CHUNK, 'cpu', graphs=True),
                 lambda: trec.tiled_net_out(model, meta, gt_vol=_volume((13, 11, 7), 0),
                                            device='cpu', graphs=True)):
        with pytest.raises(ValueError, match='needs a card'):
            call()


class FakeGraph:
    """A captured graph's stand-in: its replay runs the captured body with
    the wrappers' counts held (a replay calls no wrapper); ``reset``
    destroys it."""

    def __init__(self, body, fail_at=None):
        self.body, self.fail_at = body, fail_at
        self.replays = self.resets = 0

    def replay(self):
        assert not self.resets, 'a destroyed graph replayed'
        self.replays += 1
        if self.replays == self.fail_at:
            raise RuntimeError('chunk failed')
        mark = launch_counts.read()
        self.body()
        launch_counts.write(mark)

    def reset(self):
        self.resets += 1


@pytest.fixture
def stub_card(monkeypatch):
    """The graphed path on the CPU: ``use_eval_graphs`` says graphed, the
    fetch counts a launch a call (as the kernel's wrapper does on a card),
    and ``trainer.capture_graph`` is stubbed: it runs the warm-up, counts
    what the body launches as the capture, and registers a ``FakeGraph``
    as the trainer registers a captured graph.  Returns the record of
    captures: (error mode, counts the capture left, graph)."""
    monkeypatch.setattr(trec, 'use_eval_graphs',
                        lambda graphs, device, n_chunks: graphs is not False)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    predict = trec.predict_trilinear

    def counted(*a, **k):
        gs.launches += 1
        return predict(*a, **k)
    monkeypatch.setattr(trec, 'predict_trilinear', counted)
    state = {'fail_at': None, 'fail_capture': False}
    captures = []

    def fake_capture(warm, body, error_mode='global', *, device):
        assert device == body.k.device
        warm()
        if state['fail_capture']:
            raise RuntimeError('operation not permitted when stream is capturing')
        body()
        graph = FakeGraph(body, state['fail_at'])
        ttr._live_graphs.add(graph)
        captures.append((error_mode, launch_counts.read(), graph))
        return graph.replay
    monkeypatch.setattr(ttr, 'capture_graph', fake_capture)
    launch_counts.write((0,) * len(launch_counts.COUNTERS))
    yield captures, state
    for *_, graph in captures:
        ttr._live_graphs.discard(graph)


ENTRIES = {
    'field': lambda model, meta, vol, graphs: trec.field_on_device(
        model, meta, CHUNK, 'cpu', graphs=graphs),
    'sums': lambda model, meta, vol, graphs: trec.chunk_sums(
        model, meta, torch.from_numpy(vol), CHUNK, 'cpu', graphs=graphs),
    'tiled_net_out': lambda model, meta, vol, graphs: trec.tiled_net_out(
        model, meta, gt_vol=vol, device='cpu', graphs=graphs)}


@pytest.mark.parametrize('entry', list(ENTRIES))
@pytest.mark.parametrize('shape', SHAPES)
def test_graphed_evaluation_replays_a_chunk(models, stub_card, entry, shape):
    """Graphed (the capture stubbed): one capture an evaluation, in global
    mode with no process group; the warm-up's launch taken back; one
    replay a chunk, so the fetch counts one launch a chunk; the results
    equal the eager evaluation's; the graph destroyed and forgotten by the
    trainer's registry when the evaluation returns."""
    captures, _ = stub_card
    _, _, model = models
    meta = VolumeMeta(shape)
    vol = _volume(shape, 6)
    # tiled_net_out evaluates in the default chunks: one here
    n_chunks = 1 if entry == 'tiled_net_out' else math.ceil(meta.n_voxels / CHUNK)
    eager = ENTRIES[entry](model, meta, vol, False)
    assert gs.launches == n_chunks and not captures
    launch_counts.write((0,) * len(launch_counts.COUNTERS))
    graphed = ENTRIES[entry](model, meta, vol, None)
    assert len(captures) == 1
    mode, counts, graph = captures[0]
    assert mode == 'global'
    # the stub's capture ran the body once after the warm-up's was taken back
    assert counts[:1] == (1,)
    assert graph.replays == n_chunks and graph.resets == 1
    assert graph not in ttr._live_graphs
    assert launch_counts.read() == (n_chunks,) + (0,) * (len(launch_counts.COUNTERS) - 1)
    if torch.is_tensor(eager):
        assert torch.equal(graphed, eager)
    else:
        assert graphed == eager


@pytest.mark.parametrize('fail', ['capture', 'first chunk', 'last chunk'])
def test_graph_destroyed_when_the_evaluation_raises(models, stub_card, fail):
    """A failed capture raises, with no eager chunk after it; a chunk that
    raises stops the evaluation.  Either way no graph outlives the call,
    and the capture's counts are taken back."""
    captures, state = stub_card
    _, _, model = models
    meta = VolumeMeta((13, 11, 7))
    state['fail_capture'] = fail == 'capture'
    state['fail_at'] = {'first chunk': 1, 'last chunk': 4}.get(fail)
    with pytest.raises(RuntimeError, match='capturing' if fail == 'capture' else 'chunk failed'):
        trec.field_from_net(model, meta, CHUNK, 'cpu')
    if fail == 'capture':
        assert not captures and gs.launches == 0
    else:
        graph = captures[0][2]
        assert graph.resets == 1 and graph not in ttr._live_graphs
        assert gs.launches == state['fail_at'] - 1
    assert ttr.release_step_graphs() == []


def test_graphed_evaluation_under_a_process_group(models, stub_card, tmp_path):
    """Under a process group (rank 0's evaluation after mesh training) the
    capture runs in thread-local mode: the group's watchdog thread may
    query events while this thread captures."""
    import torch.distributed as dist
    captures, _ = stub_card
    _, _, model = models
    meta = VolumeMeta((13, 11, 7))
    dist.init_process_group('gloo', init_method='file://' + str(tmp_path / 'rendezvous'),
                            world_size=1, rank=0)
    try:
        field = trec.field_from_net(model, meta, CHUNK, 'cpu')
    finally:
        dist.destroy_process_group()
    assert [c[0] for c in captures] == ['thread_local']
    np.testing.assert_array_equal(field, trec.field_from_net(model, meta, CHUNK, 'cpu',
                                                             graphs=False))


class FakeCuda:
    """``torch.cuda``'s calls that ``trainer.capture_graph`` makes, on the
    CPU: card 0 is current; ``device`` switches the current card for its
    block; streams and pool handles belong to the card current when they
    are made; a graph records, at ``capture_begin``, the current card, the
    card of the stream it captures on, the pool and the mode, and its
    ``capture_end`` warns as PyTorch does when the captured work recorded
    no node (``empty``)."""

    def __init__(self):
        self.card, self.stream_card, self.empty = 0, 0, False
        self.graphs, self.pools = [], []
        fake = self

        class Stream:
            def __init__(self):
                self.card = fake.card

            def wait_stream(self, other):
                pass

        class CUDAGraph:
            def __init__(self):
                self.begun, self.resets = None, 0
                fake.graphs.append(self)

            def capture_begin(self, pool, capture_error_mode):
                self.begun = (fake.card, fake.stream_card, pool, capture_error_mode)

            def capture_end(self):
                if fake.empty:
                    warnings.warn('The CUDA Graph is empty. This usually means that the '
                                  'graph was attempted to be captured on wrong device or '
                                  'stream.')

            def replay(self):
                pass

            def reset(self):
                self.resets += 1
        self.Stream, self.CUDAGraph = Stream, CUDAGraph

    def graph_pool_handle(self):
        self.pools.append((self.card, len(self.pools)))
        return self.pools[-1]

    @contextlib.contextmanager
    def device(self, d):
        prev, self.card = self.card, torch.device(d).index
        try:
            yield
        finally:
            self.card = prev

    @contextlib.contextmanager
    def stream(self, s):
        prev, self.stream_card = self.stream_card, s.card
        try:
            yield
        finally:
            self.stream_card = prev

    def current_device(self):
        return self.card

    def current_stream(self):
        s = self.Stream()
        s.card = self.card
        return s


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = FakeCuda()
    for name in ('device', 'stream', 'current_device', 'current_stream', 'Stream',
                 'graph_pool_handle', 'CUDAGraph'):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    zeros = torch.zeros
    monkeypatch.setattr(torch, 'zeros', lambda *a, device=None, **k: zeros(*a, **k))
    monkeypatch.setattr(ttr, '_capture_pools', {})
    yield fake
    for graph in fake.graphs:
        ttr._live_graphs.discard(graph)


@pytest.mark.parametrize('card', [0, 1])
@pytest.mark.parametrize('mode', ['global', 'thread_local'])
def test_capture_runs_on_the_given_card(fake_cuda, card, mode):
    """``capture_graph`` warms up, captures and keeps its pool, its anchor
    and its streams on the card it is given, whichever card is current
    (card 0 here): the warm-up and the captured work run with that card
    current, the anchor and each capture begin there, on a stream of that
    card, into a pool of that card, in the caller's mode, and the current
    card is card 0 again after it.  A second capture there shares the pool
    and the anchor; ``release_step_graphs`` destroys both graphs and the
    anchor and drops the pool."""
    seen = []
    dev = torch.device('cuda', card)
    replays = [ttr.capture_graph(lambda: seen.append(('warm', fake_cuda.card)),
                                 lambda: seen.append(('step', fake_cuda.card,
                                                      fake_cuda.stream_card)),
                                 mode, device=dev)
               for _ in range(2)]
    assert seen == [('warm', card), ('step', card, card)] * 2
    assert fake_cuda.card == 0 and fake_cuda.pools == [(card, 0)]
    anchor, g0, g1 = fake_cuda.graphs
    assert anchor.begun == g0.begun == g1.begun == (card, card, (card, 0), mode)
    assert [r.__self__ for r in replays] == [g0, g1]
    ttr.release_step_graphs()
    assert anchor.resets == g0.resets == g1.resets == 1 and not ttr._capture_pools


def test_an_empty_capture_raises(fake_cuda):
    """A capture that records no node (its work ran on another card's
    stream; PyTorch only warns) raises, and its graph is destroyed and
    forgotten; the pool's first capture, which made the anchor, is left
    alone."""
    dev = torch.device('cuda', 1)
    ttr.capture_graph(lambda: None, lambda: None, device=dev)
    fake_cuda.empty = True
    with pytest.raises(RuntimeError, match='recorded no node'):
        ttr.capture_graph(lambda: None, lambda: None, device=dev)
    anchor, first, graph = fake_cuda.graphs
    assert graph.resets == 1 and graph not in ttr._live_graphs
    assert anchor.resets == first.resets == 0 and first in ttr._live_graphs
