"""Which steps ``solve_phase`` replays as a CUDA graph by default
(``train/trainer.py::use_step_graphs``), held without a card on stub
meshes, and the end of a step graph: ``ChunkRunner.close`` and
``release_step_graphs`` destroy it whoever holds it, and
``parallel/distributed.py::shutdown_distributed`` destroys every step graph
still alive before it ends an NCCL process group (NCCL's destroy waits
while a graph holds work on its communicators).  A graph here is a stand-in
with ``reset``, registered as ``capture_graph`` registers the step's."""

import types

import pytest
import torch

from latent_feature_grid_compression_tpu_torch.parallel import distributed as tdist
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr

MESHES = {'none': None,
          'nccl': types.SimpleNamespace(backend='nccl'),
          'gloo': types.SimpleNamespace(backend='gloo')}
DEVICES = ('cuda:0', 'cpu')


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('device', DEVICES)
def test_default_graphs_a_card_alone_or_on_an_nccl_mesh(mesh, device):
    """``graphs=None``: graphed on a card with no mesh or on an NCCL mesh
    (the JAX mesh's sharded chunk runners run a chunk as one program);
    eager on a gloo mesh and on the CPU."""
    want = device != 'cpu' and mesh != 'gloo'
    assert ttr.use_step_graphs(None, MESHES[mesh], torch.device(device)) is want


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('device', DEVICES)
def test_false_is_eager_everywhere(mesh, device):
    assert ttr.use_step_graphs(False, MESHES[mesh], device) is False


@pytest.mark.parametrize('device', DEVICES)
def test_true_on_gloo_raises(device):
    """Gloo's collectives cannot be captured: ``graphs=True`` on a gloo
    mesh raises, naming gloo; on no mesh and on NCCL it is taken."""
    with pytest.raises(ValueError, match='runs gloo, whose collectives cannot be captured'):
        ttr.use_step_graphs(True, MESHES['gloo'], device)
    assert ttr.use_step_graphs(True, MESHES['nccl'], device) is True
    assert ttr.use_step_graphs(True, None, device) is True


class FakeGraph:
    """A step graph's stand-in: ``reset`` destroys it."""

    def __init__(self):
        self.resets = 0

    def replay(self):
        assert not self.resets, 'a destroyed graph replayed'

    def reset(self):
        self.resets += 1


@pytest.fixture
def graphs(monkeypatch):
    """Make stand-in graphs registered as captured ones (no card: the
    synchronisation before a destroy is a no-op here)."""
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    made = []

    def make():
        made.append(FakeGraph())
        ttr._live_graphs.add(made[-1])
        return made[-1]
    yield make
    for g in made:
        ttr._live_graphs.discard(g)


def test_close_destroys_the_runners_graph_a_caller_still_holds(graphs):
    """``ChunkRunner.close`` drops the replay and destroys its graph, which
    a caller (the smoke's inspection list) may still hold; the registry
    forgets it, so a later release leaves it alone."""
    runner = ttr.ChunkRunner.__new__(ttr.ChunkRunner)
    held = [graphs()]
    runner.replay = held[0].replay
    runner.close()
    assert runner.replay is None and held[0].resets == 1
    assert held[0] not in ttr._live_graphs
    assert ttr.release_step_graphs() == [] and held[0].resets == 1


def test_close_leaves_a_replay_that_is_no_captured_graph(graphs):
    """A replay that is not a registered graph's (the CPU tests' stubbed
    capture) is dropped and nothing is destroyed."""
    other = FakeGraph()
    runner = ttr.ChunkRunner.__new__(ttr.ChunkRunner)
    for replay in (other.replay, lambda: None, None):
        runner.replay = replay
        runner.close()
        assert runner.replay is None
    assert other.resets == 0


class Holder:
    def __init__(self, graph):
        self.graph = graph


def test_release_step_graphs_destroys_what_is_still_held(graphs):
    """Every registered graph still alive is destroyed once and reported
    with the types of what held it; one its runner destroyed already is
    left alone."""
    kept, loose = Holder(graphs()), graphs()
    done = graphs()
    ttr._live_graphs.discard(done)   # destroyed by its runner already
    holders = ttr.release_step_graphs()
    assert (kept.graph.resets, loose.resets, done.resets) == (1, 1, 0)
    assert len(holders) == 2 and any('Holder' in h for h in holders), holders
    assert ttr.release_step_graphs() == []


@pytest.mark.parametrize('backend', ['nccl', 'gloo'])
def test_shutdown_destroys_step_graphs_before_the_group(graphs, monkeypatch, backend):
    """Under NCCL ``shutdown_distributed`` destroys every step graph still
    alive before it destroys the process group; under gloo (no graph holds
    its collectives) it only destroys the group."""
    kept = Holder(graphs())
    order = []
    monkeypatch.setattr(tdist.dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(tdist.dist, 'get_backend', lambda *a: backend)
    monkeypatch.setattr(tdist.dist, 'destroy_process_group',
                        lambda *a: order.append(('destroy', kept.graph.resets)))
    tdist.shutdown_distributed()
    assert order == [('destroy', 1 if backend == 'nccl' else 0)]

