"""Worker processes of ``tests/test_torch_mesh.py``: the port's multi-device
trainer on the CPU under gloo, one process a rank
(``torch.multiprocessing.spawn``).  Imports torch and the port only, so a
spawned process starts quickly and without JAX.

``spawn(world, job, tmp)`` runs ``job['tasks']`` (names of TASKS) on every
rank of a world of ``world`` processes; ``results(world, tmp)`` reads each
rank's results.
The job carries the inputs the parent made with numpy (and the JAX
package): models, volumes, position streams.
"""

import copy
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from latent_feature_grid_compression_tpu_torch.config import TrainConfig
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.io.train_state_io import (
    TENSOR_FIELDS, load_train_state)
from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
from latent_feature_grid_compression_tpu_torch.train import run as trun
from latent_feature_grid_compression_tpu_torch.train import trainer as ttr


def phase_spec(job, drop_type):
    cfg = TrainConfig(**job['cfg'][drop_type])
    return ttr.make_phase_spec(cfg, job['models'][drop_type].spec,
                               VolumeMeta(job['volume'].shape), phase=1)


def fresh_state(job, drop_type):
    cfg = job['cfg'][drop_type]
    return ttr.init_train_state(job['models'][drop_type], cfg['lr'], cfg['lr'],
                                train_gates=bool(drop_type))


def run_steps(job, drop_type, mesh, pos_all, use_space=False, shard_params=False):
    """The trainer's step, ``len(pos_all)`` times, at this rank's (K, N, 3)
    positions (in its slab under a space axis), as the JAX tests scan
    ``step_fn``: (losses, the replicated final state)."""
    ph = phase_spec(job, drop_type)
    sc = pm.make_shard_ctx(mesh, use_space)
    lo, hi = pm.slab_bounds(mesh, ph.resolution[0], use_space)
    # (the bias corrections of K steps: the steps run past the phase's
    # budget, as JAX's scanned step_fn does)
    c = ttr.PhaseConstants(dataclasses.replace(ph, max_pass=len(pos_all)),
                           pm.shard_volume(mesh, job['volume'], use_space), lo)
    st, zc = fresh_state(job, drop_type), None
    if shard_params:
        st, zc = pm.shard_train_state(mesh, st)
    norm, gt = ttr.chunk_inputs(c, torch.from_numpy(pos_all))
    losses = [ttr.train_step(ph, st, c, norm[k], gt[k], terms={}, sc=sc, zc=zc)[0].item()
              for k in range(len(pos_all))]
    if zc is not None:
        st = pm.unshard_train_state(mesh, st, zc)
    return np.asarray(losses), st


def _state_arrays(st):
    return {name: getattr(st, name).numpy().copy()
            for name in ('flat', 'm', 'v', 'ema', 'ema_var') if getattr(st, name) is not None}


def task_dp(rank, job, tmp):
    """Data 2: each rank its contiguous half of the global stream."""
    mesh = pm.make_mesh(2, 1, 'cpu')
    out = {}
    for drop_type in ('', 'smallify'):
        pos = job['pos_all']
        half = pos.shape[1] // 2
        losses, st = run_steps(job, drop_type, mesh, pos[:, rank * half:(rank + 1) * half])
        out[drop_type] = dict(losses=losses, **_state_arrays(st))
    return out


def task_space(rank, job, tmp):
    """Space 2: the global stream is stratified (half 0 in slab 0, half 1
    in slab 1); each rank gets its half in slab coordinates."""
    mesh = pm.make_mesh(1, 2, 'cpu')
    pos = job['pos_space']
    half = pos.shape[1] // 2
    lo, _ = pm.slab_bounds(mesh, job['volume'].shape[0])
    local = pos[:, rank * half:(rank + 1) * half].copy()
    local[..., 0] -= lo
    ph = phase_spec(job, '')
    c = ttr.PhaseConstants(ph, pm.shard_volume(mesh, job['volume']), lo)
    norm, gt = ttr.chunk_inputs(c, torch.from_numpy(local[:1]))
    losses, st = run_steps(job, '', mesh, local, use_space=True)
    return dict(local=local, norm=norm[0].numpy(), gt=gt[0].numpy(), losses=losses,
                **_state_arrays(st))


def task_zero(rank, job, tmp):
    """Data 2 x space 2: ZeRO-sharded against replicated state on the same
    stream (cut in four contiguous quarters), the shards' shapes and the
    round trip."""
    mesh = pm.make_mesh(2, 2, 'cpu')
    pos = job['pos_all']
    q = pos.shape[1] // 4
    mine = pos[:, rank * q:(rank + 1) * q]
    out = {}
    for drop_type in ('', 'smallify'):
        for shard in (False, True):
            losses, st = run_steps(job, drop_type, mesh, mine, shard_params=shard)
            out[(drop_type, shard)] = dict(losses=losses, **_state_arrays(st))
    st = fresh_state(job, 'smallify')
    zst, zc = pm.shard_train_state(mesh, st)
    back = pm.unshard_train_state(mesh, zst, zc)
    out['shards'] = dict(n_params=zc.n_params, shapes=[tuple(getattr(zst, k).shape)
                                                       for k in ('flat', 'm', 'v')],
                         local=zst.flat.numpy().copy(),
                         roundtrip=all(torch.equal(getattr(back, k), getattr(st, k))
                                       for k in ('flat', 'm', 'v', 'ema', 'ema_var')))
    return out


def task_local(rank, job, tmp):
    """Data 2 x space 2, volume x-slab sharded: solve_phase with tile-local
    decode off and on, with and without ZeRO, from the same generators."""
    mesh = pm.make_mesh(2, 2, 'cpu')
    ph = phase_spec(job, '')
    vol = pm.shard_volume(mesh, job['volume'])
    out = {}
    for shard in (False, True):
        for local in (False, True):
            losses = []
            gen = trun._phase_generator(0, 1, torch.device('cpu'), (0, rank))
            ttr.solve_phase(ph, fresh_state(job, ''), vol, 30, generator=gen,
                            verbose=False, metric_cb=losses.append, mesh=mesh,
                            shard_params=shard, local_decode=local)
            out[(shard, local)] = np.concatenate(losses)
    starts, length = ttr.x_windows(ph, 2)
    out['window'] = (starts[mesh.space_index], length)
    return out


def task_resume(rank, job, tmp):
    """Phase 1 killed after chunk 2 (saves after every chunk) and resumed
    from its file, against the uninterrupted phase: replicated state at
    data 2, ZeRO at space 2."""
    class Killed(Exception):
        pass

    def kill_after(n, sink):
        def cb(losses):
            sink.append(losses)
            if len(sink) == n:
                raise Killed
        return cb

    out = {}
    for name, shape, shard in (('data2', (2, 1), False), ('space2_zero', (1, 2), True)):
        mesh = pm.make_mesh(*shape, 'cpu')
        ph = phase_spec(job, 'smallify')
        vol = pm.shard_volume(mesh, job['volume'])

        def gens(seed):
            return (trun._phase_generator(seed, 1, torch.device('cpu'), (0, rank)),
                    trun._phase_generator(seed, 1, torch.device('cpu'), (1,)))

        def solve(state, g, **kw):
            return ttr.solve_phase(ph, state, vol, 4, generator=g[0], noise_generator=g[1],
                                   verbose=False, mesh=mesh, shard_params=shard, **kw)
        whole = []
        final = solve(fresh_state(job, 'smallify'), gens(7), metric_cb=whole.append)
        path = os.path.join(tmp, f'{name}.npz')
        before = []
        try:
            solve(fresh_state(job, 'smallify'), gens(7), state_save_path=path,
                  save_every_s=0.0, metric_cb=kill_after(2, before))
        except Killed:
            pass
        pm.barrier(mesh)   # rank 0 has written the file
        g = gens(123)
        state = load_train_state(path, fresh_state(job, 'smallify'), g,
                                 mesh_shape=shape, rank=rank)
        after = []
        resumed = solve(state, g, metric_cb=after.append)
        out[name] = dict(whole=np.concatenate(whole),
                         pieces=np.concatenate(before + after),
                         final=_state_arrays(final), resumed=_state_arrays(resumed),
                         steps=(final.step, resumed.step))
        pm.barrier(mesh)
    return out


def task_launch_check(rank, job, tmp):
    """A 4-rank mesh in a world of 2 raises the launch error."""
    try:
        trun.training(TrainConfig(mesh_data=4), device='cpu', volume_np=job['volume'])
    except ValueError as e:
        return str(e)
    return None


def task_training(rank, job, tmp):
    """training() end to end, each rank in a directory of its own (so that
    what a rank writes shows); the final flat vector of each phase."""
    cwd = os.path.join(tmp, f'rank{rank}')
    os.makedirs(cwd)
    os.chdir(cwd)
    flats = []
    orig = trun.solve_phase

    def capture(*a, **kw):
        st = orig(*a, **kw)
        flats.append(st.flat.numpy().copy())
        return st
    trun.solve_phase = capture
    try:
        info = trun.training(TrainConfig(**job['training_cfg']), verbose=False,
                             volume_np=job['volume'], write_vols=False, device='cpu')
    finally:
        trun.solve_phase = orig
    files = sorted(os.path.relpath(os.path.join(r, f), cwd)
                   for r, _, fs in os.walk(cwd) for f in fs)
    return dict(info=info, flats=flats, files=files)


def task_jax_runner(rank, job, tmp):
    """Each of ``job['runner_cases']`` for this world's size: the port's
    ``solve_phase`` on the mesh from the JAX state carried across, this
    rank's positions those of its JAX device (``positions[rank]``) and the
    gate noise the same on every rank: (the steps taken, lr, shadow lr,
    stop flag, every step's loss and volume loss)."""
    out = {}
    for name, case in job['runner_cases'].items():
        if case['data'] * case['space'] != dist.get_world_size():
            continue
        mesh = pm.make_mesh(case['data'], case['space'], 'cpu')
        losses, vol_losses = [], []
        noise = case['noise']
        st = ttr.solve_phase(case['ph'], case['state'], pm.shard_volume(mesh, job['volume']),
                             case['chunk'], positions=iter(case['positions'][rank]),
                             gate_noise=None if noise is None else iter(noise),
                             verbose=False, metric_cb=losses.append,
                             volume_cb=vol_losses.append, mesh=mesh,
                             shard_params=case['shard_params'],
                             local_decode=case['local_decode'])
        out[name] = dict(step=st.step, lr=float(st.lr), shadow_lr=float(st.shadow_lr),
                         stop=bool(st.stop), losses=np.concatenate(losses),
                         vol_losses=np.concatenate(vol_losses))
    return out


def task_graph_stub(rank, job, tmp):
    """Each of ``job['stub_cases']``: a phase through ``solve_phase`` on the
    mesh with eager steps, and with graphed steps whose capture is stubbed
    at ``trainer.capture_graph``: the stub runs the warm-up, then the step
    once as the capture (its effects on the runner's state taken back) and
    returns a replay that runs the step with every count held, as a graph's
    replay calls no wrapper and no collective's Python.  The graphed run's
    mesh reads 'nccl' (the one change the stub needs to pass solve_phase's
    backend check; its groups are the gloo ones).  A step stands in for
    two kernel launches (fetch and gradient).  Returns, a mode each: the
    final state's tensors, the losses, the launch and collective counts and
    the warm-up steps; and what each capture added to the counts.  Then a
    graphed phase whose ``metric_cb`` raises after the first chunk
    ('raised'): its captures, the steps its runner took, and whether the
    runner dropped its replay."""
    from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
    from latent_feature_grid_compression_tpu_torch.ops import launch_counts
    step, capture, init = ttr.train_step, ttr.capture_graph, ttr.ChunkRunner.__init__
    kernels = len(launch_counts.KERNEL_COUNTERS)
    runners, captures = [], []

    def counted_step(*a, **k):
        gs.launches += 1
        gs.bwd_launches += 1
        return step(*a, **k)

    def recorded_init(self, *a, **k):
        init(self, *a, **k)
        runners.append(self)

    def fake_capture(warm, capture_step, error_mode, device):
        assert device == runners[-1].c.volume.device
        warm()
        live = runners[-1].st
        held = {f: t.clone() for f, t in _state_tensors(live).items()}
        capture_step()
        for f, t in held.items():
            getattr(live, f).copy_(t)
        captures[-1].append((launch_counts.read()[:kernels], dict(pm.counts), error_mode))

        def replay():
            mark = launch_counts.read()
            capture_step()
            launch_counts.write(mark)
        return replay

    class Raised(Exception):
        pass

    def raise_after_chunk(_):
        raise Raised

    out = {}
    ttr.train_step, ttr.capture_graph = counted_step, fake_capture
    ttr.ChunkRunner.__init__ = recorded_init
    try:
        for name, case in job['stub_cases'].items():
            mesh = pm.make_mesh(*case['shape'], 'cpu')
            got = {}
            for mode in ('eager', 'graphed'):
                graphed = mode == 'graphed'
                captures.append([])
                launch_counts.write((0,) * len(launch_counts.COUNTERS))
                pm.reset_counts()
                warm0 = ttr.warmup_steps
                losses = []
                final = ttr.solve_phase(
                    case['ph'], copy.deepcopy(case['state']),
                    pm.shard_volume(mesh, job['volume']), 7,
                    generator=torch.Generator().manual_seed(5 + rank),
                    noise_generator=torch.Generator().manual_seed(6), verbose=False,
                    metric_cb=losses.append,
                    mesh=dataclasses.replace(mesh, backend='nccl') if graphed else mesh,
                    shard_params=case['shard_params'], graphs=graphed)
                got[mode] = dict(step=final.step, state=_state_tensors(final),
                                 losses=np.concatenate(losses),
                                 launches=launch_counts.read()[:kernels],
                                 collectives=dict(pm.counts),
                                 warmup_steps=ttr.warmup_steps - warm0,
                                 captures=captures[-1])
            # a graphed phase whose first chunk's callback raises
            captures.append([])
            try:
                ttr.solve_phase(case['ph'], copy.deepcopy(case['state']),
                                pm.shard_volume(mesh, job['volume']), 7,
                                generator=torch.Generator().manual_seed(5 + rank),
                                noise_generator=torch.Generator().manual_seed(6),
                                verbose=False, metric_cb=raise_after_chunk,
                                mesh=dataclasses.replace(mesh, backend='nccl'),
                                shard_params=case['shard_params'], graphs=True)
            except Raised:
                runner = runners[-1]
                got['raised'] = dict(captures=len(captures[-1]), step=runner.st.step,
                                     replay_dropped=runner.replay is None)
            out[name] = got
    finally:
        ttr.train_step, ttr.capture_graph = step, capture
        ttr.ChunkRunner.__init__ = init
    return out


def _state_tensors(st):
    return {name: getattr(st, name).clone() for name in TENSOR_FIELDS
            if getattr(st, name) is not None}


TASKS = {name[5:]: fn for name, fn in globals().items() if name.startswith('task_')}


def _worker(rank, world, init_file, job_file, tmp):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method='file://' + init_file, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        job = torch.load(job_file, weights_only=False)
        results = {name: TASKS[name](rank, job, tmp) for name in job['tasks']}
        torch.save(results, os.path.join(tmp, f'result{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn(world, job, tmp):
    """Run ``job`` on ``world`` gloo ranks (a rendezvous file of its own
    under ``tmp``); each rank's results are left in ``tmp``
    (:func:`results`)."""
    tmp = str(tmp)
    job_file = os.path.join(tmp, 'job.pt')
    torch.save(job, job_file)
    mp.spawn(_worker, args=(world, os.path.join(tmp, 'rendezvous'), job_file, tmp),
             nprocs=world)


def results(world, tmp):
    """Each rank's results of a :func:`spawn` into ``tmp``, in rank order."""
    return [torch.load(os.path.join(str(tmp), f'result{r}.pt'), weights_only=False)
            for r in range(world)]
