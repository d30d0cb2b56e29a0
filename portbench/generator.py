"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and drives the port with them.  Its ``kind`` says
which user-facing call the mix drives; every other number of a mix is data:

* ``train``: phase-1 training through ``trainer.solve_phase`` in chunks of
  ``steps_per_chunk``, ``graphs`` as the CLI passes it (null: a graph replay
  a step on a card).  The window call's first chunk is set-up (its draws,
  its capture, its steps); the state is copied between that chunk's first
  ``checked_steps`` steps, on the chunk runner, buffers and graph that the
  window goes on to use, and those steps are held against the reference.
  The window starts after that chunk and ends at the chunk in which the
  deadline passes, through ``solve_phase``'s own ``metric_cb``.  A phase
  that ends first (its budget or its plateau stop) is followed by a fresh
  phase-1 state.
* ``decompress``: a closed loop with one client, back-to-back
  ``eval.reconstruct.field_on_device`` calls over the configuration's
  volume, each ended by a synchronize.
* ``query``: a closed loop with one client: each slice request is sent
  when the one before has its output on the device.  A request is a
  ``side`` x ``side`` plane of points (normal and centre drawn from the
  seed, the centre within ``center_extent`` of the origin, the plane
  spanning ``half_extent`` either way; made on the device before it is
  sent) through ``apply_model(train=False)`` under ``torch.no_grad()``,
  timed from its sending to its output on the device.

Of the reconstructions and requests, ``kept`` are drawn from the seed across
the whole window as they complete (``Keeper``), and the last is kept too:
what the reference judges.

Each kind's function returns a ``Run``: the work and time of the window, what the
reference needs to judge it, and the profiled pieces of a ``--trace 1`` run
(``profile.py``), taken at ``TRACE_AT`` of the window.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import profile as P
from .counts import model as counts

# where in the window the profiled pieces start, as shares of its length
TRACE_AT = (0.3, 0.5, 0.7)
# kernels whose records a profile must hold in full (profile.py)
FETCH, BWD_TILES, BWD_BOX = 'grid_sample_fwd_kernel', 'grid_sample_bwd_tiles_kernel', \
    'grid_sample_bwd_kernel'


class _Stop(Exception):
    """Raised from ``metric_cb`` to end a phase's run after a chunk."""


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seconds: float
    trace: bool
    device: torch.device
    volume: torch.Tensor
    params: Dict[str, list]
    seeds: Dict[str, int]
    process_start: float


@dataclasses.dataclass
class Run:
    kind: str
    config: dict
    traffic: dict
    device_kind: str = ''
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                  # steps, reconstructions or requests
    work: float = 0.0               # samples, voxels or points
    untraced_s: float = 0.0         # the window less its profiled pieces
    untraced_ops: float = 0.0       # the operations the algorithm needs for its work
    latencies_s: List[float] = dataclasses.field(default_factory=list)   # sent to output
    chunk_s: List[float] = dataclasses.field(default_factory=list)
    phases: int = 1
    profiles: List[P.Summary] = dataclasses.field(default_factory=list)
    evidence: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0

    @property
    def trace(self) -> Optional[P.Summary]:
        return P.first_complete(self.profiles)


def sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


# a configuration's keys that the harness reads itself, beside TrainConfig's
HARNESS_KEYS = ('source_file', 'volume', 'assumed')
# TrainConfig fields that the harness does not act on: a configuration that
# sets one away from its default is refused, not run as if it had not
UNHONOURED = ('mesh_data', 'mesh_space', 'mesh_shard_params', 'mesh_local_decode',
              'steps_per_chunk', 'seed', 'resume', 'profile_dir', 'checkpoint_path',
              'binary_checkpoint_path', 'Tensorboard_log_dir')


def train_config(config: dict):
    """The configuration as the CLI's ``TrainConfig``.  Raises on a key that
    nothing reads and on an unhonoured field away from its default."""
    from latent_feature_grid_compression_tpu_torch.config import TrainConfig
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    unknown = sorted(set(config) - set(fields) - set(HARNESS_KEYS))
    if unknown:
        raise ValueError(f'configuration keys that nothing reads: {unknown}')
    tcfg = TrainConfig(**{k: v for k, v in config.items() if k in fields})
    off = [k for k in UNHONOURED if getattr(tcfg, k) != fields[k].default]
    if off:
        raise ValueError(f'configuration keys the benchmark does not act on: {off}')
    return tcfg


def spec_of(config: dict, gated: bool):
    """The model's spec from every key of the configuration that the CLI
    passes to ``make_spec`` (``train/run.py``), backends and compute type
    included; without gates when ``gated`` is false."""
    from latent_feature_grid_compression_tpu_torch.models.feature_grid import make_spec
    c = train_config(config)
    return make_spec(d_in=c.d_in, hidden=c.n_hidden_size, d_out=c.d_out,
                     num_layers=c.n_layers, n_freqs=c.n_embedding_freq,
                     grid_features=c.grid_features, grid_size=c.grid_size,
                     wavelet=c.wavelet_filter, drop_type=c.drop_type if gated else '',
                     drop_momentum=c.drop_momentum, drop_threshold=c.drop_threshold,
                     pruning_threshold_list=c.pruning_threshold_list,
                     interp_backend=c.interp_backend, compute_dtype=c.compute_dtype,
                     mlp_backend=c.mlp_backend)


def _model(spec, p: Dict[str, list]):
    from latent_feature_grid_compression_tpu_torch.models.feature_grid import FeatureGridModel
    gates = {k: [t.clone() for t in p[k]] for k in ('betas', 'log_thetas', 'log_var')
             if k in p and spec.drop_type}
    return FeatureGridModel(spec, [t.clone() for t in p['coeffs']],
                            [t.clone() for t in p['mlp_w']], [t.clone() for t in p['mlp_b']],
                            **gates)


class _Profiles:
    """The profiled pieces of a window: ``due(elapsed)`` says whether the
    next one should start, ``begin``/``end`` bracket one, counting the
    program's fetch and gradient launches for the record check."""

    def __init__(self, trace: bool, seconds: float):
        self.todo = [f * seconds for f in TRACE_AT] if trace else []
        self.open: Optional[tuple] = None
        self.done: List[tuple] = []
        self.traced_s = 0.0
        self.traced_units = 0

    def due(self, elapsed: float) -> bool:
        return self.open is None and bool(self.todo) and elapsed >= self.todo[0]

    def begin(self):
        from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
        self.todo.pop(0)
        t = time.perf_counter()
        s = P.Profile()
        s.start()
        self.open = (s, t, gs.launches, gs.bwd_launches)

    def end(self, units: int, extra_fetch: int = 0):
        from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
        s, t, fwd, bwd = self.open
        s.stop()
        expected = {FETCH: gs.launches - fwd + extra_fetch}
        if gs.bwd_launches - bwd:
            expected.update({BWD_TILES: gs.bwd_launches - bwd, BWD_BOX: gs.bwd_launches - bwd})
        self.done.append((s, units, expected))
        self.open = None
        self.traced_s += time.perf_counter() - t
        self.traced_units += units

    def summaries(self) -> List[P.Summary]:
        return [s.summary(units, expected) for s, units, expected in self.done]


class _Watch:
    """Copies of the state between the first steps of the window call's
    first chunk: the first moment after step 1 and the parameters after
    ``checked`` steps.  It wraps ``ChunkRunner.step`` (the replay of the
    chunk's captured graph on a card) until ``close``."""

    def __init__(self, checked: int):
        from latent_feature_grid_compression_tpu_torch.train import trainer as tr
        self.cls, self.real, self.checked, self.got = tr.ChunkRunner, tr.ChunkRunner.step, \
            checked, {}
        watch = self

        def step(runner):
            watch.real(runner)
            st = runner.st
            if st.step == 1:
                watch.got['m1'] = st.m.detach().clone()
            if st.step == watch.checked:
                watch.got['flat'] = st.flat.detach().clone()
        self.cls.step = step

    def close(self):
        self.cls.step = self.real


def train(ctx: Context) -> Run:
    from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
    from latent_feature_grid_compression_tpu_torch.train import trainer as tr
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    spec = spec_of(cfg, gated=True)
    model = _model(spec, ctx.params)
    variance = None
    if 'var_w' in ctx.params:
        variance = ([t.clone() for t in ctx.params['var_w']],
                    [t.clone() for t in ctx.params['var_b']])
    ph = tr.make_phase_spec(train_config(cfg), spec, VolumeMeta(tuple(ctx.volume.shape)),
                            phase=1)

    def fresh():
        return tr.init_train_state(model, lr=cfg['lr'], shadow_lr=cfg['lr'], train_gates=True,
                                   variance=variance, weight_dkl=cfg['lambda_drop_loss'])
    state = fresh()
    kw = dict(generator=torch.Generator(device=dev).manual_seed(ctx.seeds['positions']),
              noise_generator=torch.Generator(device=dev).manual_seed(ctx.seeds['noise']),
              verbose=False, graphs=mix['graphs'])
    checked = mix['checked_steps']
    run = Run('train', cfg, mix, evidence={'flat0': state.flat.detach().clone()})
    profiles = _Profiles(ctx.trace, ctx.seconds)
    clock = {'t0': None, 'steps': 0}
    watch = _Watch(checked)

    def window(losses):
        now = time.perf_counter()
        if clock['t0'] is None:
            # the first chunk, set-up: its first steps are the checked ones
            watch.close()
            if len(losses) < checked or set(watch.got) != {'m1', 'flat'}:
                raise RuntimeError(f'the first chunk took {len(losses)} steps; '
                                   f'{checked} are checked')
            run.evidence.update(watch.got, losses=[float(x) for x in losses[:checked]])
            clock['t0'] = clock['last'] = now
            run.setup_s = now - ctx.process_start
            return
        clock['steps'] += len(losses)
        run.chunk_s.append(now - clock['last'])
        if profiles.open is not None:
            profiles.end(len(losses))
            now = time.perf_counter()
        elapsed = now - clock['t0']
        clock['last'] = now
        if elapsed >= ctx.seconds:
            clock['t1'] = now
            raise _Stop
        if profiles.due(elapsed):
            profiles.begin()
    try:
        while True:
            try:
                tr.solve_phase(ph, state, ctx.volume, mix['steps_per_chunk'],
                               metric_cb=window, **kw)
            except _Stop:
                break
            state = fresh()
            run.phases += 1
    finally:
        watch.close()
    run.window_s = clock['t1'] - clock['t0']
    run.units = run.attempted = clock['steps']
    run.work = clock['steps'] * ph.batch_n
    step_ops = counts.train_step_ops(cfg)
    run.untraced_s = run.window_s - profiles.traced_s
    run.untraced_ops = (run.units - profiles.traced_units) * step_ops
    run.profiles = profiles.summaries()
    return run


def _decompress_model(ctx: Context):
    return _model(spec_of(ctx.config, gated=False), ctx.params)


def decompress(ctx: Context) -> Run:
    from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
    from latent_feature_grid_compression_tpu_torch.eval import reconstruct as rc
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    model = _decompress_model(ctx)
    meta = VolumeMeta(tuple(ctx.volume.shape))
    n_chunks = math.ceil(meta.n_voxels / rc.CHUNK)
    # a graphed reconstruction runs one chunk more, uncounted: its warm-up
    warm_chunk = int(rc.use_eval_graphs(mix['graphs'], dev, n_chunks))
    for _ in range(mix['warmup']):
        rc.field_on_device(model, meta, device=dev, graphs=mix['graphs'])
        sync(dev)
    keeper, run = Keeper(ctx.seeds['sample'], mix['kept']), Run('decompress', cfg, mix)
    profiles = _Profiles(ctx.trace, ctx.seconds)
    run.setup_s = time.perf_counter() - ctx.process_start
    t0 = time.perf_counter()
    i = 0
    while True:
        traced = profiles.due(time.perf_counter() - t0)
        if traced:
            profiles.begin()
            with torch.profiler.record_function(P.SPAN + 'reconstruction'):
                out = rc.field_on_device(model, meta, device=dev, graphs=mix['graphs'])
                sync(dev)
            profiles.end(1, extra_fetch=warm_chunk)
        else:
            out = rc.field_on_device(model, meta, device=dev, graphs=mix['graphs'])
            sync(dev)
        keeper.offer(out)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.evidence = {'fields': keeper.items()}
    run.units = run.attempted = i
    run.work = i * meta.n_voxels
    voxel_ops = counts.point_ops(cfg) + counts.LATTICE_OPS
    per_call = meta.n_voxels * voxel_ops + counts.decode_ops(cfg, gated=False)
    run.untraced_s = run.window_s - profiles.traced_s
    run.untraced_ops = (i - profiles.traced_units) * per_call
    run.profiles = profiles.summaries()
    return run


class Keeper:
    """``k`` of a window's outputs drawn uniformly from ``seed`` as they come
    (reservoir sampling: the count need not be known), and the last."""

    def __init__(self, seed: int, k: int):
        self.rng, self.k = np.random.default_rng(seed), k
        self.kept: list = []
        self.seen = 0
        self.last = None

    def offer(self, item):
        if self.seen < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1
        self.last = item

    def items(self) -> list:
        tail = [] if any(x is self.last for x in self.kept) else [self.last]
        return self.kept + tail


class SliceParams:
    """Request ``i``'s plane: its centre and (unnormalized) normal, (6,),
    drawn from ``seed`` in blocks of ``BLOCK`` requests (block ``b`` from
    the seed and ``b``), so a closed loop draws as many as it sends."""
    BLOCK = 4096

    def __init__(self, seed: int, center_extent: float):
        self.seed, self.center_extent, self.blocks = seed, center_extent, {}

    def __getitem__(self, i: int) -> np.ndarray:
        b, r = divmod(int(i), self.BLOCK)
        if b not in self.blocks:
            rng = np.random.default_rng([self.seed, b])
            e = self.center_extent
            self.blocks[b] = np.concatenate([rng.uniform(-e, e, (self.BLOCK, 3)),
                                             rng.standard_normal((self.BLOCK, 3))], axis=1)
        return self.blocks[b][r]


def slice_points(params: np.ndarray, side: int, half_extent: float, device) -> torch.Tensor:
    """The (side * side, 3) points of one request's plane."""
    c, n = params[:3], params[3:] / np.linalg.norm(params[3:])
    a = np.eye(3)[int(np.argmin(np.abs(n)))]
    e1 = np.cross(n, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    u = torch.linspace(-half_extent, half_extent, side, device=device, dtype=torch.float32)
    basis = torch.tensor(np.stack([c, e1, e2]), device=device, dtype=torch.float32)
    pts = basis[0] + u[:, None, None] * basis[1] + u[None, :, None] * basis[2]
    return pts.reshape(-1, 3)


def query(ctx: Context) -> Run:
    from latent_feature_grid_compression_tpu_torch.models.feature_grid import apply_model
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    model = _decompress_model(ctx)
    side = int(mix['side'])
    params = SliceParams(ctx.seeds['queries'], mix['center_extent'])

    def points(i):
        pts = slice_points(params[i], side, mix['half_extent'], dev)
        sync(dev)
        return pts

    def request(pts):
        with torch.no_grad():
            out = apply_model(model, pts, train=False)
        sync(dev)
        return out
    for i in range(mix['warmup']):
        request(points(i))
    keeper, run = Keeper(ctx.seeds['sample'], mix['kept']), Run('query', cfg, mix)
    profiles = _Profiles(ctx.trace, ctx.seconds)
    run.setup_s = time.perf_counter() - ctx.process_start
    t0 = done = time.perf_counter()
    k, opened, traced = 0, 0, []
    while done - t0 < ctx.seconds:
        i = mix['warmup'] + k
        pts = points(i)
        if profiles.due(time.perf_counter() - t0):
            profiles.begin()
            opened = k
        start = time.perf_counter()
        if profiles.open is not None:
            with torch.profiler.record_function(P.SPAN + 'request'):
                out = request(pts)
        else:
            out = request(pts)
        done = time.perf_counter()
        run.latencies_s.append(done - start)
        traced.append(profiles.open is not None)
        if profiles.open is not None and k - opened + 1 >= mix['traced_requests']:
            profiles.end(k - opened + 1)
        keeper.offer((i, out))
        k += 1
    if profiles.open is not None:
        profiles.end(k - opened)
    run.window_s = done - t0
    run.evidence = {'outputs': keeper.items(), 'params': params}
    run.units = run.attempted = k
    run.work = k * side * side
    per_request = side * side * counts.point_ops(cfg) + counts.decode_ops(cfg, gated=False)
    # the model's share is taken over the requests' own time, not the
    # making of the next plane between them
    run.untraced_s = sum(s for s, t in zip(run.latencies_s, traced) if not t)
    run.untraced_ops = traced.count(False) * per_request
    run.profiles = profiles.summaries()
    return run


KINDS = {'train': train, 'decompress': decompress, 'query': query}
