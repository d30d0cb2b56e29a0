"""The port's mesh chunk runner (``train/trainer.py::solve_phase`` on a
``parallel.mesh.Mesh``) on the CPU under gloo, held against the JAX
package's sharded chunk runners: ``parallel/mesh.py::
make_sharded_chunk_runner`` (replicated state; a data axis and a space
axis, for smallify and a variational family) and
``make_zero_sharded_chunk_runner`` (the state ZeRO-sharded over 'space',
with and without tile-local decode), each run by JAX's ``solve_phase(mesh=
...)`` on 2 or 4 of the 8 virtual CPU devices of ``tests/conftest.py``.
Each rank replays its JAX device's position stream
(``tests/torch_port_util.py::jax_mesh_pos_stream``) and the gate noise
that every JAX device draws alike.  Then the bookkeeping of graphed mesh
steps, with the capture stubbed at ``trainer.capture_graph``: collective
and launch counts, states and losses equal to eager steps'.

Widths and volume are ``tests/test_torch_graph_step.py``'s (grid 8, 8
features, 2 x 16 MLP, batch 32 x 4, a 12 x 10 x 9 volume); the ranks run in
spawned processes (``tests/torch_mesh_worker.py``), one world of 2 and one
of 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_feature_grid_compression_tpu.parallel import mesh as jmesh
from latent_feature_grid_compression_tpu.train import trainer as jtr
from latent_feature_grid_compression_tpu_torch.io.train_state_io import TENSOR_FIELDS
from tests import torch_mesh_worker as worker
from tests.test_torch_graph_step import NEURCOMP, _jax_phase_1, _volume
from tests.torch_ab import jax_gate_noise_stream
from tests.torch_port_util import jax_gate_uniform_stream, jax_mesh_pos_stream

CHUNK = 4
# name: (data, space, drop_type, shard_params, local_decode)
RUNNER_CASES = {
    'data2-smallify': (2, 1, 'smallify', False, False),
    'space2-smallify': (1, 2, 'smallify', False, False),
    'data2-dynamic_variational': (2, 1, 'dynamic_variational', False, False),
    'space2-static_variational': (1, 2, 'static_variational', False, False),
    'zero-smallify': (2, 2, 'smallify', True, False),
    'zero-local-smallify': (2, 2, 'smallify', True, True),
}
# name: (mesh shape, drop_type, shard_params): every collective of a step
STUB_CASES = {'data2': ((2, 1), 'smallify', False),
              'space2-zero': ((1, 2), 'dynamic_variational', True)}
NOISE = {'straight_through': jax_gate_uniform_stream,
         'static_variational': jax_gate_noise_stream,
         'dynamic_variational': jax_gate_noise_stream}


def _runner_case(name):
    """JAX's sharded solve_phase on the case's mesh, and the port's inputs:
    (the JAX results, the worker's case)."""
    data, space, drop_type, shard_params, local_decode = RUNNER_CASES[name]
    jph, tph, jstate, tstate, key, jparams = _jax_phase_1(drop_type, **NEURCOMP)
    vol = _volume()
    jlosses, jvol = [], []

    def jcb(metrics):
        live = np.asarray(metrics['lr']) > 0
        jlosses.extend(np.asarray(metrics['loss'])[live])
        jvol.extend(np.asarray(metrics['volume_loss'])[live])
    mesh = jmesh.make_mesh(data, space, devices=jax.devices()[:data * space])
    jfinal = jtr.solve_phase(jph, jstate, jnp.asarray(vol), CHUNK, metric_cb=jcb,
                             verbose=False, mesh=mesh, shard_params=shard_params,
                             local_decode=local_decode)
    n = data * space
    n_chunks = -(-tph.t_max // CHUNK) + 1
    local_res = (vol.shape[0] // space,) + vol.shape[1:]
    positions = [jax_mesh_pos_stream(key, CHUNK, tph.batch_n // n, local_res, d, n_chunks)
                 for d in range(n)]
    noise = None
    if drop_type in NOISE:
        stream = NOISE[drop_type](key, CHUNK, [c.shape[1:] for c in jparams.coeffs])
        noise = [[np.asarray(a) for a in next(stream)] for _ in range(n_chunks * CHUNK)]
    want = dict(step=int(jfinal.step), lr=float(jfinal.lr),
                shadow_lr=float(jfinal.shadow_lr),
                losses=np.asarray(jlosses), vol_losses=np.asarray(jvol), t_max=tph.t_max)
    return want, dict(data=data, space=space, ph=tph, state=tstate, chunk=CHUNK,
                      positions=positions, noise=noise, shard_params=shard_params,
                      local_decode=local_decode)


def _stub_case(name):
    shape, drop_type, shard_params = STUB_CASES[name]
    _, tph, _, tstate, _, _ = _jax_phase_1(drop_type, **dict(NEURCOMP, max_pass=6))
    return dict(shape=shape, ph=tph, state=tstate, shard_params=shard_params)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every runner case through JAX, then through the port on a world of
    2 (the replicated cases, the stubbed captures) and of 4 (ZeRO)."""
    want, cases = {}, {}
    for name in RUNNER_CASES:
        want[name], cases[name] = _runner_case(name)
    job = dict(volume=_volume(), runner_cases=cases,
               stub_cases={name: _stub_case(name) for name in STUB_CASES})
    worlds = {}
    for world, tasks in ((2, ['jax_runner', 'graph_stub']), (4, ['jax_runner'])):
        tmp = tmp_path_factory.mktemp(f'mesh_runner_world{world}')
        worker.spawn(world, dict(job, tasks=tasks), tmp)
        worlds[world] = worker.results(world, tmp)
    return want, worlds


@pytest.mark.parametrize('name', list(RUNNER_CASES))
def test_mesh_solve_phase_matches_jax_sharded_runner(runs, name):
    """The phase through the port's solve_phase on the mesh and JAX's
    (``make_sharded_chunk_runner``, or ``make_zero_sharded_chunk_runner``
    with ``shard_params``): the steps taken, the lr and shadow lr after the
    Neurcomp decays (rel 1e-6), and every step's loss and volume loss (rtol
    1e-5: float32 sums in another order), as
    tests/test_torch_graph_step.py holds one device; every rank the same."""
    want, worlds = runs
    w = want[name]
    data, space = RUNNER_CASES[name][:2]
    ranks = [r['jax_runner'][name] for r in worlds[data * space]]
    got = ranks[0]
    assert got['step'] == w['step'] < w['t_max']
    assert got['lr'] == pytest.approx(w['lr'], rel=1e-6)
    assert got['shadow_lr'] == pytest.approx(w['shadow_lr'], rel=1e-6)
    # (JAX's stop flag also takes the budget stop; the port's only the
    # plateau's, which the Neurcomp strategy never sets)
    assert got['shadow_lr'] < 0.01 and not got['stop']
    np.testing.assert_allclose(got['losses'], w['losses'], rtol=1e-5)
    np.testing.assert_allclose(got['vol_losses'], w['vol_losses'], rtol=1e-5)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r['losses'], got['losses'])
        assert (r['step'], r['lr'], r['shadow_lr']) == (got['step'], got['lr'],
                                                       got['shadow_lr'])


# the collective calls one step makes, by case, and those of the phase's
# end (the ZeRO state's unsharding: flat, m and v); in both modes
# solve_phase also broadcasts the save flags once a chunk
STEP_CALLS = {'data2': {'all_reduce': 1, 'reduce_scatter': 0, 'all_gather': 0},
              'space2-zero': {'all_reduce': 0, 'reduce_scatter': 1, 'all_gather': 1}}
END_CALLS = {'data2': {}, 'space2-zero': {'all_gather': 3}}


@pytest.mark.parametrize('name', list(STUB_CASES))
def test_mesh_replays_count_the_captured_collectives(runs, name):
    """Graphed mesh steps with the capture stubbed (``task_graph_stub``):
    one capture a phase (in the 'thread_local' error mode), which counted
    one step's kernel launches and collective calls with the warm-up's
    taken back; after the phase the
    launch counts (one fetch and gradient a step) and the collective counts
    (calls and the ring model's bytes) equal the eager phase's, and the
    losses and every tensor of the final state are bit for bit the eager
    ones, on both ranks."""
    _, worlds = runs
    for r in worlds[2]:
        got = r['graph_stub'][name]
        eager, graphed = got['eager'], got['graphed']
        assert eager['captures'] == [] and len(graphed['captures']) == 1
        launches, calls, mode = graphed['captures'][0]
        # (the NCCL watchdog's thread may query events while this one captures)
        assert mode == 'thread_local'
        assert launches[:2] == (1, 1) and not any(launches[2:])
        assert {k: calls[k] for k in STEP_CALLS[name]} == STEP_CALLS[name]
        assert calls['broadcast'] == 0 and calls['modelled_bytes'] > 0
        assert graphed['warmup_steps'] > 0 and eager['warmup_steps'] == 0
        steps = eager['step']
        assert graphed['step'] == steps > 7
        assert graphed['launches'] == eager['launches']
        assert eager['launches'][:2] == (steps, steps)
        assert graphed['collectives'] == eager['collectives']
        chunks = eager['collectives']['broadcast']
        assert chunks == -(-steps // 7)
        for op, n in STEP_CALLS[name].items():
            assert eager['collectives'][op] == n * steps + END_CALLS[name].get(op, 0), op
        np.testing.assert_array_equal(graphed['losses'], eager['losses'])
        assert graphed['state'].keys() == eager['state'].keys()
        for field in TENSOR_FIELDS:
            if field in eager['state']:
                assert torch.equal(graphed['state'][field], eager['state'][field]), field
    a, b = (r['graph_stub'][name]['graphed']['state']['flat'] for r in worlds[2])
    assert torch.equal(a, b)


@pytest.mark.parametrize('name', list(STUB_CASES))
def test_mesh_phase_that_raises_drops_its_graph(runs, name):
    """A graphed mesh phase (the capture stubbed, ``task_graph_stub``) whose
    ``metric_cb`` raises after its first chunk: the exception reaches the
    caller after one capture and one chunk's steps, and the runner has
    dropped its replay (a graph left alive would hold NCCL's communicators,
    and the end of the process group would wait on it), on both ranks."""
    _, worlds = runs
    for r in worlds[2]:
        raised = r['graph_stub'][name]['raised']
        assert raised == dict(captures=1, step=7, replay_dropped=True)


def test_mesh_counts_read_write_since_add():
    """The collective counts as the chunk runner keeps them across a
    capture, with the kernels' launches (``ops/launch_counts.py``): what
    came after a mark, written back, added back twice."""
    from latent_feature_grid_compression_tpu_torch.ops import launch_counts
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    saved = launch_counts.read()
    try:
        launch_counts.write((0,) * len(launch_counts.COUNTERS))
        assert pm.counts == dict.fromkeys(pm.counts, 0)
        mark = launch_counts.read()
        pm.counts['all_reduce'] += 2
        pm.counts['modelled_bytes'] += 8.0
        delta = launch_counts.since(mark)
        assert dict(zip((key for _, key in launch_counts.COUNTERS[-len(pm.counts):]),
                        delta[-len(pm.counts):])) == \
            dict.fromkeys(pm.counts, 0) | dict(all_reduce=2, modelled_bytes=8.0)
        launch_counts.write(mark)
        assert launch_counts.read() == mark and pm.counts['all_reduce'] == 0
        launch_counts.add(delta)
        launch_counts.add(delta)
        assert pm.counts['all_reduce'] == 4 and pm.counts['modelled_bytes'] == 16.0
    finally:
        launch_counts.write(saved)
