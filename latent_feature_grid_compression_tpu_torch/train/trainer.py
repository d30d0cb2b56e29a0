"""Single-device two-phase trainer (port of the JAX package's
``train/trainer.py``, single-device paths of every gate family).

One step: IID integer voxel positions -> normalized, anisotropy-scaled
coordinates and the exact ground-truth voxels -> gated decode (the
stochastic families with this step's gate noise), feature fetch and MLP by
the spec's backends (the CUDA kernels on the card, through their
``torch.autograd.Function``s) -> the loss: MSE plus the smallify loss
(smallify, straight-through), or the variational loss at a constant or a
predicted (variance model) log-sigma with the ramped KL weight -> autograd ->
Adam with torch semantics
(bias-corrected moments, eps outside the sqrt, t as float32) -> the smallify
sign-variance tracker, fed with the pre-update betas -> volume-pass
accounting, the lr strategy and the stop rules.

Every trainable of a phase lives in ONE float32 vector (as the JAX trainer
differentiates with respect to its raveled parameters): the model's tensors
are views into it, autograd returns its gradient as one vector, and Adam is a
handful of elementwise launches on the vector.  The gates' tensors follow
the MLP (so the tracker works on one slice), then the variance model.

No per-step host synchronisation.  The pass accounting depends only on the
step index, so the host computes it (in float32, as the JAX step does on the
device): boundaries, the Neurcomp lr decay, and both budget stop rules are
known to the host before it launches a step, and it launches no step after
such a stop.  lr, shadow lr and the SmallifyDecayStrategy's plateau state
live on the device; that strategy's stop flag (the only stop that depends on
the data) is read once per ``steps_per_chunk`` steps, and a step launched
after it changes nothing, as the JAX trainer's idle branch.  Positions for a
chunk are drawn at once from an explicit ``torch.Generator`` on the device,
or taken from an iterator of (N, 3) integer arrays (the tests replay the JAX
trainer's stream that way); the gate noise likewise, one draw a level from a
generator of its own, or from an iterator of per-level lists.

The chunk runner (``ChunkRunner``, the counterpart of the JAX trainer's
``_scan_chunk`` and ``make_chunk_runner``): a chunk's draws go into static
buffers, and each step is the same launches on the same addresses: its row
of the buffers and its per-step constants (bias corrections, boundary flag,
Neurcomp factor: ``PhaseConstants.steps``) are selected by a step counter
on the device, every update of the state is written in place and guarded
by the stop flag (as JAX's ``lax.cond(state.stop, idle, step)``), the lr
strategy runs at every step where its boundary flag says (as JAX's
``where(boundary, ...)``), and the losses go into per-chunk buffers at the
step's row.  On a card the step is captured once a phase as a CUDA graph
and each step is one replay, with no mesh and on a mesh under NCCL (a card
a rank), where each rank's graph holds the step's collectives too, as the
JAX mesh's sharded chunk runners compile a chunk into one program
(``use_step_graphs``).  On the CPU the same step runs eagerly, and so does
a gloo mesh (gloo's collectives cannot be captured; ranks that share a
card run only under gloo).  A step graph that holds NCCL work keeps its
process group from ending: ``ChunkRunner.close`` destroys it when the
phase ends, and ``release_step_graphs`` destroys any still alive.

Reference quirk kept: in phase 2 the lr strategy's decays reach only the
shadow lr (the reference's strategy still points at the phase-1 optimizer),
so phase 2 trains at a constant lr/10 while the plateau logic runs on the
shadow lr.

Around the chunks, as the JAX trainer: throttled saves of the state and
its generators for a mid-training resume, a profiler trace of the second
chunk, and the TensorBoard scalars and histograms on a worker thread.

On a ('data', 'space') mesh (``parallel/mesh.py``, one process a device)
every rank runs the same step on its 1/n_devices of the batch: positions
from a generator of its own, inside its x-slab of the volume under a space
axis (offset to global coordinates before the model sees them), the gate
noise from a generator that is the same on every rank (every rank decodes
the same gated grid).  The gradient, the loss and its terms are averaged
over the mesh in one all-reduce; with the state ZeRO-sharded over 'space'
(``ZeroCtx``) the step all-gathers the parameters, reduce-scatters the
gradient over 'space' and then averages its 1/space shard over 'data', and
Adam updates the shard.  With tile-local decode (``train_step``'s
``x_window``) each rank decodes only the window of the grid's x axis its
slab's samples reach.  The pass accounting counts the global batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..data.volume import VolumeMeta
from ..io.train_state_io import TENSOR_FIELDS, atomic_save_train_state
from ..models import gates as G
from ..models.feature_grid import (FeatureGridModel, ModelSpec, Params, apply_model,
                                   check_local_decode, coeff_shapes)
from ..models.variance import apply_variance_model
from ..ops import launch_counts
from ..utils.profiling import count, span, trace
from . import losses as L
from ..parallel import mesh as pm
from ..parallel.mesh import ShardCtx, ZeroCtx

_F32 = np.float32
# the least seconds between two mid-phase saves of the state (a save copies
# the whole state to the host), as the JAX trainer
SAVE_EVERY_S = 60.0
# steps taken on a scratch copy of the state before a capture, so that
# PyTorch's lazy initialisation (autograd, cuBLAS, the kernels' libraries)
# happens outside it
WARMUP_STEPS = 3
# warm-up steps taken since the last reset; their launches are not counted
# (the wrappers' counts are set back after them): they are no step of a phase
warmup_steps = 0
# every step graph this process captured whose CUDA graph is not destroyed
# yet, and every evaluation graph (``eval/reconstruct.py::run_chunks``
# captures through ``capture_graph`` too; weakly: the registry keeps none
# alive)
_live_graphs: 'weakref.WeakSet' = weakref.WeakSet()
# by card index: the memory pool every capture there shares, the anchor
# graph that keeps it alive, and the warm-up and capture streams
# (``_capture_pool_and_streams``)
_capture_pools: Dict[int, tuple] = {}


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """Static per-phase configuration."""
    spec: ModelSpec
    drop_type: str                    # '' in the finetune phase
    batch_n: int                      # batch_size * sample_size
    n_voxels: int
    resolution: Tuple[int, int, int]
    max_pass: float                   # fractional phase budget
    # steps per DataLoader epoch in the reference (ceil(n_voxels/batch_size)):
    # its budget check `int(vp) + 1 < max_pass` runs only when the loader is
    # exhausted, every loader_len steps; the per-step check is
    # `int(vp) >= max_pass`
    loader_len: int
    lambda_drop_loss: float
    lambda_weight_loss: float
    weight_dkl_multiplier: float
    variational_sigma: float
    use_smallify_decay: bool
    pass_decay: int
    lr_decay: float
    lr_stop: float
    decay_applies_to_lr: bool         # False in phase 2 (reference quirk)
    use_masks: bool                   # phase-2 frozen-mask multiply

    @property
    def variational(self) -> bool:
        return G.is_variational(self.drop_type)

    @property
    def dynamic_variational(self) -> bool:
        return G.is_dynamic(self.drop_type)

    @property
    def t_max(self) -> int:
        """Steps after which floor(t * N / V) >= max_pass for certain."""
        return math.ceil((math.floor(self.max_pass) + 1) * self.n_voxels
                         / self.batch_n) + 1

    def passes(self, t: int) -> Tuple[float, bool]:
        """(floor of the volume passes after step t, whether step t crossed
        a pass boundary), in float32 as the JAX step computes them."""
        n, inv = _F32(self.batch_n), _F32(1.0 / float(self.n_voxels))
        prior = np.floor(_F32(t - 1) * n * inv)
        cur = np.floor(_F32(t) * n * inv)
        return float(cur), bool(prior != cur)

    def step_flags(self) -> Tuple[np.ndarray, np.ndarray]:
        """For t = 1 .. t_max + 1: whether step t crosses a pass boundary
        (``passes``), and the factor the Neurcomp strategy multiplies the
        lrs by after it (lr_decay in float32 where it decays, else 1)."""
        t = np.arange(1, self.t_max + 2)
        n, inv = _F32(self.batch_n), _F32(1.0 / float(self.n_voxels))
        prior = np.floor((t - 1).astype(_F32) * n * inv)
        cur = np.floor(t.astype(_F32) * n * inv)
        boundary = prior != cur
        decay = boundary & ((cur.astype(np.float64) + 1) % self.pass_decay == 0)
        if self.use_smallify_decay:
            decay[:] = False
        return boundary, np.where(decay, _F32(self.lr_decay), _F32(1.0)).astype(_F32)

    def budget_stop(self, t: int, cur: float) -> bool:
        """The two budget stop rules after step t: the per-step break once
        the phase budget is reached, and the loader-exhaustion check."""
        max_pass = _F32(self.max_pass)
        epoch_end = t % self.loader_len == 0
        return bool(_F32(cur) >= max_pass
                    or (epoch_end and _F32(cur) + _F32(1.0) >= max_pass))


def make_phase_spec(cfg: TrainConfig, spec: ModelSpec, meta: VolumeMeta, *,
                    phase: int) -> PhaseSpec:
    """Phase 1 trains 2/3 of max_pass with the gates and their loss; phase 2
    the last 1/3 at lr/10 under the frozen masks."""
    return PhaseSpec(
        spec=spec,
        drop_type=cfg.drop_type if phase == 1 else '',
        batch_n=cfg.batch_size * cfg.sample_size,
        n_voxels=meta.n_voxels,
        resolution=tuple(meta.resolution),
        max_pass=cfg.max_pass * (2.0 / 3.0 if phase == 1 else 1.0 / 3.0),
        loader_len=-(-meta.n_voxels // cfg.batch_size),
        lambda_drop_loss=cfg.lambda_drop_loss,
        lambda_weight_loss=cfg.lambda_weight_loss,
        weight_dkl_multiplier=cfg.weight_dkl_multiplier,
        variational_sigma=cfg.variational_sigma,
        use_smallify_decay=cfg.smallify_decay != 0,
        pass_decay=cfg.smallify_decay if cfg.smallify_decay != 0 else cfg.pass_decay,
        # both strategies take the config's lr_decay
        lr_decay=cfg.lr_decay,
        lr_stop=1e-7,
        decay_applies_to_lr=(phase == 1),
        use_masks=(phase == 2 and bool(cfg.drop_type)),
    )


class FlatLayout:
    """Where each trainable tensor of a phase lies in the flat vector:
    coefficients, MLP weights ((out, in) layout), MLP biases, then the
    family's gate tensors when the phase trains gates (``betas``,
    ``mask_values``, or ``log_thetas`` and ``log_var``), then the variance
    model's weights and biases when given (phase 1 of dynamic
    variational).  ``slices`` maps each group's name to its slice."""

    def __init__(self, model: FeatureGridModel, with_gates: bool, variance=None):
        self.spec = model.spec
        names, groups = self._groups(model, with_gates, variance)
        self.names = names
        self.group_sizes = [len(g) for g in groups]
        tensors = [t for g in groups for t in g]
        self.shapes = [tuple(t.shape) for t in tensors]
        self.counts = [t.numel() for t in tensors]
        self.slices, k, start = {}, 0, 0
        for name, size in zip(names, self.group_sizes):
            n = sum(self.counts[k:k + size])
            self.slices[name] = slice(start, start + n)
            k, start = k + size, start + n
        self.with_gates = with_gates

    @staticmethod
    def _groups(model, with_gates, variance):
        names = ['coeffs', 'mlp_w', 'mlp_b']
        groups = [list(model.coeffs), list(model.mlp_w), list(model.mlp_b)]
        if with_gates:
            for name in G.trainable_fields(model.spec.drop_type):
                if getattr(model, name) is None:
                    raise ValueError("the phase trains gates but the model has none")
                names.append(name)
                groups.append(list(getattr(model, name)))
        if variance is not None:
            names += ['var_w', 'var_b']
            groups += [list(variance[0]), list(variance[1])]
        return tuple(names), groups

    def flatten(self, model: FeatureGridModel, variance=None) -> torch.Tensor:
        _, groups = self._groups(model, self.with_gates, variance)
        return torch.cat([t.detach().reshape(-1) for g in groups for t in g]).float()

    def views(self, flat: torch.Tensor):
        """(the model's tensors, the variance model's (weights, biases) or
        None) as views into ``flat`` (one split: its backward is one
        concatenation)."""
        ts = [p.view(s) for p, s in zip(torch.split(flat, self.counts), self.shapes)]
        out, k = {}, 0
        for name, n in zip(self.names, self.group_sizes):
            out[name] = ts[k:k + n]
            k += n
        variance = (out.pop('var_w'), out.pop('var_b')) if 'var_w' in out else None
        return Params(self.spec, **out), variance


@dataclasses.dataclass
class TrainState:
    layout: FlatLayout
    flat: torch.Tensor                # all trainables of the phase
    m: torch.Tensor                   # Adam moments, like flat
    v: torch.Tensor
    step: int                         # Adam t of the last step taken
    lr: torch.Tensor                  # applied lr, 0-dim float32
    shadow_lr: torch.Tensor           # lr as the decay strategy sees it
    last_loss: torch.Tensor           # SmallifyDecayStrategy state
    no_gain: torch.Tensor             # 0-dim int32
    stop: torch.Tensor                # 0-dim bool: the data-dependent stop
    stop_step: torch.Tensor           # 0-dim int64: the step it came at
    weight_dkl: torch.Tensor          # 0-dim float32: the variational KL weight
    ema: Optional[torch.Tensor]       # smallify tracker over the betas slice
    ema_var: Optional[torch.Tensor]


def x_windows(ph: PhaseSpec, space_size: int) -> Tuple[List[int], int]:
    """(each space index's window start, the windows' common length) on the
    grid's x axis: the grid cells the slab's samples interpolate from, the
    1-cell halo included, as the JAX trainer derives them."""
    res = np.asarray(ph.resolution, dtype=np.int32)
    max_idx = (res - 1).astype(np.float32)
    sx = float((max_idx / max_idx.max())[0])
    W = ph.spec.grid_size
    local_x = ph.resolution[0] // space_size
    los, his = [], []
    for d in range(space_size):
        pix = [(((x / float(max_idx[0])) * 2.0 - 1.0) * sx + 1.0) * W / 2.0 - 0.5
               for x in (d * local_x, (d + 1) * local_x - 1)]
        los.append(max(0, math.floor(pix[0])))
        his.append(min(W - 1, math.floor(pix[1]) + 1))
    length = max(h - lo + 1 for lo, h in zip(los, his))
    return [min(lo, W - length) for lo in los], length


def init_train_state(model: FeatureGridModel, lr: float, shadow_lr: float,
                     train_gates: bool, variance=None,
                     weight_dkl: float = 0.0) -> TrainState:
    """Fresh optimizer and strategy state for the model's tensors (and its
    gates and smallify tracker when ``train_gates``; and the variance
    model's (weights, biases) when given), on the model's device;
    ``weight_dkl`` starts the KL weight's ramp."""
    layout = FlatLayout(model, with_gates=train_gates, variance=variance)
    flat = layout.flatten(model, variance)
    dev = flat.device

    def scalar(value, dtype=torch.float32):
        return torch.full((), value, dtype=dtype, device=dev)

    ema = ema_var = None
    if 'betas' in layout.slices:
        ema = torch.cat([e.reshape(-1) for e in model.ema]).float()
        ema_var = torch.cat([e.reshape(-1) for e in model.ema_var]).float()
    return TrainState(
        layout=layout, flat=flat, m=torch.zeros_like(flat),
        v=torch.zeros_like(flat), step=0, lr=scalar(lr),
        shadow_lr=scalar(shadow_lr),
        # inf == "no loss seen yet" (the reference's None)
        last_loss=scalar(math.inf), no_gain=scalar(0, torch.int32),
        stop=scalar(False, torch.bool), stop_step=scalar(0, torch.int64),
        weight_dkl=scalar(weight_dkl), ema=ema, ema_var=ema_var)


def _own(ts):
    return None if ts is None else [t.detach().clone() for t in ts]


def state_to_model(state: TrainState, model: FeatureGridModel) -> FeatureGridModel:
    """The model with the state's tensors (and tracker); tensors the phase
    did not train (the gates in phase 2) come from ``model``."""
    p, _ = state.layout.views(state.flat.detach())
    gates = G.fields_of(model)
    gates.update({name: getattr(p, name) for name in G.FIELDS[:4]
                  if getattr(p, name) is not None})
    if state.ema is not None:
        sizes = [b.numel() for b in p.betas]
        for name, flat in (('ema', state.ema), ('ema_var', state.ema_var)):
            gates[name] = [e.view(b.shape) for e, b in zip(torch.split(flat, sizes), p.betas)]
    return FeatureGridModel(model.spec, _own(p.coeffs), _own(p.mlp_w), _own(p.mlp_b),
                            **{k: _own(v) for k, v in gates.items()})


def adam_update(flat, g, m, v, lr, bc1, bc2, b1=0.9, b2=0.999, eps=1e-8):
    """torch.optim.Adam's step on flat vectors: bias-corrected moments
    (bc1 = 1 - b1**t, bc2 = 1 - b2**t) and eps outside the sqrt."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return flat - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), m, v


class PhaseConstants:
    """Per-phase constants on the device: sampling geometry, the flat
    volume (the rank's x-slab under a space axis: ``x_offset`` is its first
    slice, ``draw_res`` the extent positions are drawn in), and 1 - b**t
    for every step of the phase (so that step t's bias corrections are
    views, not launches).  ``steps``: row t - 1 holds step t's (1 - b1**t,
    1 - b2**t, boundary flag, Neurcomp factor) (``PhaseSpec.step_flags``),
    which the chunk runner's step selects on the device."""

    def __init__(self, ph: PhaseSpec, volume: torch.Tensor, x_offset: int = 0):
        dev = volume.device
        res = np.asarray(ph.resolution, dtype=np.int64)
        max_idx = (res - 1).astype(np.float32)
        self.res = res
        self.draw_res = (int(volume.shape[0]),) + tuple(int(r) for r in res[1:])
        self.offset = torch.as_tensor([x_offset, 0, 0], device=dev)
        self.x_offset = x_offset
        self.max_idx = torch.as_tensor(max_idx, device=dev)
        self.scales = torch.as_tensor(max_idx / max_idx.max(), device=dev)
        self.strides = torch.as_tensor([res[1] * res[2], res[2], 1], device=dev)
        self.volume = volume.reshape(-1)
        ts = torch.arange(1, ph.t_max + 2, dtype=torch.float32, device=dev)
        self.bc1 = 1.0 - 0.9 ** ts
        self.bc2 = 1.0 - 0.999 ** ts
        boundary, factor = ph.step_flags()
        self.steps = torch.stack([self.bc1, self.bc2,
                                  torch.from_numpy(boundary.astype(_F32)).to(dev),
                                  torch.from_numpy(factor).to(dev)], dim=1)


def chunk_inputs(c: PhaseConstants, pos: torch.Tensor):
    """(steps, N, 3) integer positions (in the slab) -> normalized, scaled
    global coordinates and the exact ground-truth voxel values of the whole
    chunk."""
    gpos = pos.to(torch.int64) + c.offset if c.x_offset else pos
    norm = (gpos.to(torch.float32) / c.max_idx) * 2.0 - 1.0
    norm = norm * c.scales
    gt = c.volume[(pos.to(torch.int64) * c.strides).sum(-1)]
    return norm, gt


def draw_noise(ph: PhaseSpec, n_steps: int, generator: torch.Generator,
               device: torch.device) -> Optional[List[torch.Tensor]]:
    """The gate noise of ``n_steps`` steps, (n_steps, *gate shape) a level
    in one call each: U[0, 1) for straight-through, N(0, 1) for the
    variational families; None for the others."""
    kind = G.noise_kind(ph.drop_type)
    if kind is None:
        return None
    draw = torch.rand if kind == 'uniform' else torch.randn
    return [draw((n_steps,) + tuple(s[1:]), generator=generator, device=device)
            for s in coeff_shapes(ph.spec)]


def draw_positions(c: PhaseConstants, n_steps: int, N: int,
                   generator: torch.Generator) -> torch.Tensor:
    """(n_steps, N, 3) IID uniform voxel indices (the reference's
    IndexDataset; in the rank's slab under a space axis), in one call per
    axis."""
    dev = c.volume.device
    return torch.stack([torch.randint(0, int(r), (n_steps, N), generator=generator,
                                      device=dev, dtype=torch.int32)
                        for r in c.draw_res], dim=-1)


def loss_and_grad(ph: PhaseSpec, layout: FlatLayout, flat: torch.Tensor,
                  norm: torch.Tensor, gt: torch.Tensor, masks=None, noise=None,
                  weight_dkl: Optional[torch.Tensor] = None,
                  terms: Optional[dict] = None,
                  x_window: Optional[Tuple[int, int]] = None):
    """(loss, volume loss, gradient of the loss with respect to ``flat``).
    ``noise``: this step's per-level gate noise (straight-through,
    variational); ``weight_dkl``: this step's KL weight (variational);
    ``x_window``: the tile-local decode's window (``apply_model``).
    ``terms``: a dict that receives the loss's other terms under the JAX
    trainer's metric names (``Log_Likelyhood_loss``, ``DKL_loss``,
    ``Weight_loss`` for the variational families in phase 1, else
    ``drop_loss``), as detached tensors (or 0.0 where the term is absent):
    no launch is added."""
    x = flat.detach().requires_grad_(True)
    p, variance = layout.views(x)
    train_gates = bool(ph.drop_type)
    pred = apply_model(p, norm, train=True, train_gates=train_gates,
                       masks=masks if ph.use_masks else None, noise=noise,
                       x_window=x_window)[:, 0]
    # the sums over the levels taken over the flat slices at once
    s = layout.slices
    coeffs = [x[s['coeffs']]]
    if train_gates and ph.variational:
        if ph.dynamic_variational:
            log_sigma = apply_variance_model(*variance, norm)[:, 0]
        else:
            log_sigma = torch.full_like(pred, ph.variational_sigma)
        gates = G.Gates(log_thetas=[x[s['log_thetas']]], log_var=[x[s['log_var']]])
        loss, ll, vol_loss, dkl, wsum = L.variational_loss(
            coeffs, gates, pred, gt, log_sigma, weight_dkl, ph.lambda_weight_loss,
            batch_scale=ph.n_voxels / ph.batch_n, data_scale=ph.n_voxels / pred.shape[0])
        named = {'Log_Likelyhood_loss': ll, 'DKL_loss': dkl, 'Weight_loss': wsum}
    else:
        vol_loss = torch.mean((pred - gt) ** 2)
        loss = vol_loss
        drop_loss = 0.0
        if train_gates:
            name = G.trainable_fields(ph.drop_type)[0]
            drop_loss = L.smallify_family_loss(
                ph.drop_type, coeffs, G.Gates(**{name: [x[s[name]]]}),
                ph.lambda_drop_loss, ph.lambda_weight_loss)
            loss = loss + drop_loss
        named = {'drop_loss': drop_loss}
    if terms is not None:
        terms.update({k: v.detach() if torch.is_tensor(v) else float(v)
                      for k, v in named.items()})
    g, = torch.autograd.grad(loss, x)
    return loss.detach(), vol_loss.detach(), g


def _mesh_mean(sc: ShardCtx, zc: Optional[ZeroCtx], g: torch.Tensor,
               scalars: torch.Tensor):
    """(this rank's gradient, the scalars), averaged over the mesh.
    Replicated state: one all-reduce of [gradient | scalars].  ZeRO: the
    padded gradient cut into the axis' slices, each followed by the
    scalars, reduce-scattered over the axis (so the scalars ride along with
    every slice), then this 1/axis slice averaged over the other axes: the
    order that moves the fewest bytes (``comm_volume_per_step``)."""
    mesh, k = sc.mesh, scalars.numel()
    if zc is None:
        buf = pm.all_reduce_mean(mesh, torch.cat([g, scalars]), sc.axis_names)
        return buf[:-k], buf[-k:]
    n = mesh.shape[zc.axis]
    size = -(-zc.n_params // n)
    rows = torch.nn.functional.pad(g, (0, n * size - g.numel())).view(n, size)
    buf = torch.cat([rows, scalars.expand(n, k)], dim=1).reshape(-1)
    local = pm.reduce_scatter_mean(mesh, buf, zc.axis)
    local = pm.all_reduce_mean(mesh, local, [a for a in sc.axis_names if a != zc.axis])
    return local[:size], local[size:]


def _put(old: torch.Tensor, new: torch.Tensor, hold: Optional[torch.Tensor]):
    """``new`` written into ``old`` in place, except where ``hold`` is set
    (None: everywhere)."""
    if new is old:
        return
    if hold is None:
        old.copy_(new)
    else:
        torch.where(hold, old, new, out=old)


def train_step(ph: PhaseSpec, st: TrainState, c: PhaseConstants,
               norm: torch.Tensor, gt: torch.Tensor, masks=None,
               guard: bool = False, noise=None, terms: Optional[dict] = None,
               sc: Optional[ShardCtx] = None, zc: Optional[ZeroCtx] = None,
               x_window: Optional[Tuple[int, int]] = None,
               at: Optional[torch.Tensor] = None):
    """One step in place on ``st`` (every state tensor is written in place);
    returns (loss, volume loss) on the device.  ``guard``: the stop flag may
    be set, so every update is taken only where it is not (a stopped step
    changes nothing).  ``noise``: the step's per-level gate noise.
    ``terms``: receives the loss's other terms (``loss_and_grad``).  ``sc``:
    the mesh (the gradient, the loss and its terms averaged over it); ``zc``:
    ``st`` holds this rank's slices of the ZeRO-sharded vectors;
    ``x_window``: the tile-local decode's window.

    ``at``: the chunk runner's form, which launches the same operators on
    the same addresses at every step: a 1-element int64 tensor on the
    device holding t - 1 for this step's t.  Step t's row of ``c.steps``
    (bias corrections, boundary flag, Neurcomp factor) is selected at it,
    every update is guarded, the lr strategy runs where the boundary flag
    says, and ``st.step`` is left to the caller.  Without it the host reads
    those from ``st.step``, runs the strategy at a boundary only, and
    advances ``st.step``."""
    t = st.step + 1
    if at is None:
        bc1, bc2 = c.bc1[t - 1], c.bc2[t - 1]
    else:
        bc1, bc2, boundary, factor = c.steps.index_select(0, at)[0].unbind()
    weight_dkl = None
    if ph.variational:
        # the KL weight is ramped before the loss that uses it
        weight_dkl = L.ramp_weight_dkl(st.weight_dkl, ph.weight_dkl_multiplier)
    # the whole parameter vector: one all-gather of the shards under ZeRO
    full = st.flat if zc is None else \
        pm.all_gather_flat(sc.mesh, st.flat, zc.axis)[:zc.n_params]
    loss, vol_loss, g = loss_and_grad(ph, st.layout, full, norm, gt, masks, noise,
                                      weight_dkl, terms, x_window)
    if sc is not None:
        named = [k for k, v in (terms or {}).items() if torch.is_tensor(v)]
        g, scalars = _mesh_mean(sc, zc, g, torch.stack(
            [loss, vol_loss] + [terms[k] for k in named]))
        loss, vol_loss = scalars[0], scalars[1]
        if named:
            terms.update(zip(named, scalars[2:]))
    flat, m, v = adam_update(st.flat, g, st.m, st.v, st.lr, bc1, bc2)
    ema = ema_var = None
    if ph.drop_type == 'smallify':
        # fed with the pre-update betas (of the gathered vector under ZeRO)
        mom = ph.spec.drop_momentum
        phi = torch.sign(full[st.layout.slices['betas']]) - st.ema
        ema = st.ema + mom * phi
        ema_var = (1.0 - mom) * (st.ema_var + mom * phi * phi)

    hold = st.stop if guard or at is not None else None
    for old, new in ((st.flat, flat), (st.m, m), (st.v, v), (st.ema, ema),
                     (st.ema_var, ema_var), (st.weight_dkl, weight_dkl)):
        if new is not None:
            _put(old, new, hold)

    if at is None:
        cur, crossed = ph.passes(t)
        if crossed:
            decays = not ph.use_smallify_decay and (cur + 1) % ph.pass_decay == 0
            _strategy(ph, st, loss, t, hold, ph.lr_decay if decays else None)
        st.step = t
    elif ph.use_smallify_decay:
        _strategy(ph, st, loss, at[0] + 1, hold | (boundary == 0.0), None)
    else:
        _strategy(ph, st, loss, None, None, factor)
    return loss, vol_loss


def _strategy(ph: PhaseSpec, st: TrainState, loss: torch.Tensor, t, hold, factor):
    """The lr strategy after step t (an int, or a 0-dim tensor on the
    device), its state written in place.  SmallifyDecayStrategy: taken
    except where ``hold`` (a 0-dim bool tensor, or None) is set.
    NeurcompDecayStrategy: the lrs multiplied by ``factor`` (None: no
    decay; it has no stop to hold for)."""
    if ph.use_smallify_decay:
        # decay after pass_decay boundaries without a new best loss; stop
        # once the shadow lr is at lr_stop
        improved = loss < st.last_loss
        new_last = torch.where(improved, loss, st.last_loss)
        new_no_gain = torch.where(improved, 0, st.no_gain + 1).to(torch.int32)
        plateau = new_no_gain == ph.pass_decay
        can_decay = st.shadow_lr > ph.lr_stop
        decay_now = plateau & can_decay
        stop_now = plateau & ~can_decay
        shadow = torch.where(decay_now, st.shadow_lr * ph.lr_decay, st.shadow_lr)
        lr = (torch.where(decay_now, st.lr * ph.lr_decay, st.lr)
              if ph.decay_applies_to_lr else st.lr)
        new_no_gain = torch.where(plateau, 0, new_no_gain).to(torch.int32)
        stop = st.stop | stop_now
        stop_step = torch.where(stop_now, t, st.stop_step)
        # the stop flag last: every other write is held by its old value
        for old, new in ((st.stop_step, stop_step), (st.last_loss, new_last),
                         (st.no_gain, new_no_gain), (st.lr, lr),
                         (st.shadow_lr, shadow), (st.stop, stop)):
            _put(old, new, hold)
    elif factor is not None:
        # NeurcompDecayStrategy: decay every pass_decay passes
        st.shadow_lr.mul_(factor)
        if ph.decay_applies_to_lr:
            st.lr.mul_(factor)


def use_step_graphs(graphs: Optional[bool], mesh, device) -> bool:
    """Whether ``solve_phase``'s steps are replays of a CUDA graph of the
    step.  ``graphs`` None: on a card, with no mesh or on a mesh whose
    backend is NCCL (a card a rank; the JAX mesh runs every chunk as one
    compiled program); eagerly on the CPU and on a gloo mesh, whose
    collectives cannot be captured.  True or False as given, except that
    True on a mesh whose backend is not NCCL raises."""
    capturable = mesh is None or mesh.backend == 'nccl'
    if graphs and not capturable:
        raise ValueError(f"the step's CUDA graph takes NCCL's collectives; this mesh "
                         f"runs {mesh.backend}, whose collectives cannot be captured "
                         f"(graphs=False, or one card a rank under NCCL)")
    if graphs is None:
        return capturable and torch.device(device).type == 'cuda'
    return graphs


def release_graph(graph):
    """Destroy a step graph captured here (its executable graph and its
    memory pool) once the card has finished its work, whoever still holds
    the Python object: under NCCL a process group ends only once no graph
    holds work on its communicators.  Anything else is left alone."""
    if graph in _live_graphs:
        _live_graphs.discard(graph)
        torch.cuda.synchronize()
        graph.reset()


def release_step_graphs() -> List[str]:
    """Destroy every step and evaluation graph of this process still alive
    (``release_graph``), after a collection, then destroy the capture
    pools' anchors and drop the pools, whose memory the allocator can then
    give back; returns, for each graph, the types of the objects that held
    it."""
    gc.collect()
    graphs = list(_live_graphs)
    holders = [sorted({type(o).__name__ for o in gc.get_referrers(g) if o is not graphs})
               for g in graphs]
    for g in graphs:
        release_graph(g)
    for _, anchor, _, _ in _capture_pools.values():
        anchor.reset()
    _capture_pools.clear()
    return [', '.join(h) for h in holders]


def _capture_pool_and_streams(error_mode: str) -> Tuple[tuple, torch.cuda.Stream,
                                                       torch.cuda.Stream]:
    """The memory pool this process's captures on the current card share,
    and the streams they warm up and capture on: made at the first capture
    there, dropped by ``release_step_graphs``.  A capture reuses what its
    destroyed predecessors left in the pool, on the same capture stream (the
    allocator reuses a block only on the stream that freed it).  A pool
    lives while a graph captured into it does, and PyTorch (2.11.0+cu128 on
    an H100) fails its assert ``use_count > 0`` in ``CachingHostAllocator``
    at a capture into a pool whose every graph was destroyed; so an anchor
    graph (one fill, never replayed) is captured into the pool first, in the
    mode of the capture it precedes, and destroyed with the pool.  Called
    inside ``torch.cuda.device``: a pool and a stream belong to the card
    that is current when they are made."""
    card = torch.cuda.current_device()
    if card not in _capture_pools:
        pool, capture_stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(capture_stream):
            anchor.capture_begin(pool, capture_error_mode=error_mode)
            try:
                torch.zeros(1, device=torch.device('cuda', card))
            finally:
                anchor.capture_end()
        _capture_pools[card] = (pool, anchor, torch.cuda.Stream(), capture_stream)
    pool, _, warm_stream, capture_stream = _capture_pools[card]
    return pool, warm_stream, capture_stream


def capture_graph(warm: Callable[[], None], step: Callable[[], None],
                  error_mode: str = 'global', *, device: torch.device
                  ) -> Callable[[], None]:
    """``warm`` run on a side stream, then ``step`` captured as one CUDA
    graph on ``device``, whose allocations come from the memory pool that
    every capture on that card shares (``_capture_pool_and_streams``);
    returns the graph's replay.  The one seam between the chunk runner,
    the evaluation and CUDA graphs: a capture that fails (a host
    synchronisation, an allocation outside the pool, a collective of a
    backend other than NCCL) raises, and so does one that records no node
    (its work ran on another card's stream), and nothing falls back to
    eager steps.  The warm-up, the capture and the pool belong to
    ``device`` whichever card is current.  Graphs that share the pool are
    only ever replayed one after another on one stream, and every tensor a
    capture leaves alive (the runner's state, the evaluation's output) was
    made before it.  On a mesh ``step`` holds NCCL collectives, which the
    capture records as nodes of the graph: their communicators must exist
    before it starts (``warm`` issues every collective of the step), and
    PyTorch waits there for the eager NCCL work its watchdog still tracks.
    ``error_mode``: the capture's ``capture_error_mode``; on a mesh (and
    for an evaluation under a process group) 'thread_local', so that the
    NCCL watchdog thread's event queries do not void the capture, while a
    call of this thread that a graph cannot hold still raises."""
    device = torch.device(device)
    with torch.cuda.device(device):
        pool, side, capture_stream = _capture_pool_and_streams(error_mode)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        _live_graphs.add(graph)
        with torch.cuda.stream(capture_stream), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            graph.capture_begin(pool, capture_error_mode=error_mode)
            try:
                step()
            finally:
                graph.capture_end()
    for w in caught:
        if 'CUDA Graph is empty' in str(w.message):
            release_graph(graph)
            raise RuntimeError(f'the capture on {device} recorded no node: its work ran '
                               f'on another card or stream')
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return graph.replay


class ChunkRunner:
    """The steps of a phase, a chunk at a time (the counterpart of the JAX
    trainer's ``_scan_chunk`` and ``make_chunk_runner``).  ``load`` writes
    a chunk's coordinates, ground truth and gate noise into static buffers
    of ``steps`` rows; ``step`` takes the next step through ``train_step``'s
    ``at`` form, whose row and t - 1 are one int64 pair on the device that
    the step advances, and writes its losses (and the loss's other terms
    with ``terms``) into a static (values, steps) buffer at its row;
    ``read`` is the chunk's one device read.  ``graphs``: ``capture``
    records the step as a CUDA graph (``capture_graph``, warmed up on a
    scratch copy of the state) and every step is then one replay, which
    adds the launches and the mesh's collective calls the capture counted
    to their counts (``ops/launch_counts.py``); else each step runs
    eagerly.  ``step_kw``: ``train_step``'s mesh arguments (every rank of
    the mesh makes its runner alike, so all capture at the same step)."""

    def __init__(self, ph: PhaseSpec, st: TrainState, c: PhaseConstants, N: int,
                 steps: int, masks=None, terms: bool = False, graphs: bool = False,
                 step_kw: Optional[dict] = None):
        dev = c.volume.device
        self.ph, self.st, self.c, self.masks = ph, st, c, masks
        self.step_kw = step_kw or {}
        self.norm = torch.zeros((steps, N, 3), device=dev)
        self.gt = torch.zeros((steps, N), device=dev)
        self.noise = None
        if G.noise_kind(ph.drop_type):
            self.noise = [torch.zeros((steps,) + tuple(s[1:]), device=dev)
                          for s in coeff_shapes(ph.spec)]
        self.at = torch.zeros(2, dtype=torch.int64, device=dev)   # (row, t - 1)
        self.terms = terms
        # the loss's other terms as the first step gives them: (tag, None
        # for a tensor read from `out`, else its constant)
        self.tags: Optional[List[Tuple[str, Optional[float]]]] = None
        self.out: Optional[torch.Tensor] = None
        self.graphs = graphs
        self.replay: Optional[Callable[[], None]] = None
        self.replay_launches: Optional[Tuple[float, ...]] = None
        self.chunks = 0   # the chunks run

    def _rewind(self):
        self.at[:1].zero_()
        self.at[1:].fill_(self.st.step)

    def load(self, pos: torch.Tensor, noise: Optional[List[torch.Tensor]]):
        """A chunk's (n, N, 3) positions and per-level (n, ...) gate noise."""
        norm, gt = chunk_inputs(self.c, pos)
        n = norm.shape[0]
        self.norm[:n].copy_(norm)
        self.gt[:n].copy_(gt)
        for buf, a in zip(self.noise or (), noise or ()):
            buf[:n].copy_(a)
        self._rewind()

    def _step(self, st: TrainState):
        row = self.at[:1]
        noise = None if self.noise is None else \
            [a.index_select(0, row)[0] for a in self.noise]
        named = {} if self.terms else None
        loss, vol_loss = train_step(self.ph, st, self.c, self.norm.index_select(0, row)[0],
                                    self.gt.index_select(0, row)[0], self.masks, noise=noise,
                                    terms=named, at=self.at[1:], **self.step_kw)
        if named is not None and self.tags is None:
            self.tags = [(k, None if torch.is_tensor(v) else v) for k, v in named.items()]
        values = [loss, vol_loss] + [named[k] for k, const in self.tags or ()
                                     if const is None]
        if self.out is None:
            self.out = torch.zeros((len(values), self.norm.shape[0]), device=loss.device)
        self.out.index_copy_(1, row, torch.stack(values)[:, None])
        self.at.add_(1)

    def capture(self):
        """Capture the step on the state as a CUDA graph, after
        ``WARMUP_STEPS`` steps on a scratch copy of it (not counted).  On a
        mesh the warm-up issues every collective of the step on every
        process group it uses, on every rank, so that each NCCL
        communicator exists before the capture starts."""
        global warmup_steps
        st = self.st
        scratch = dataclasses.replace(st, **{name: getattr(st, name).clone()
                                             for name in TENSOR_FIELDS
                                             if getattr(st, name) is not None})
        mark = launch_counts.read()

        def warm():
            for _ in range(WARMUP_STEPS):
                self._rewind()
                self._step(scratch)
            launch_counts.write(mark)
        mode = 'thread_local' if self.step_kw.get('sc') is not None else 'global'
        try:
            self.replay = capture_graph(warm, lambda: self._step(st), mode,
                                        device=self.c.volume.device)
            self.replay_launches = launch_counts.since(mark)
            count('graph_captures.train')
        finally:
            launch_counts.write(mark)
        warmup_steps += WARMUP_STEPS
        self._rewind()

    def close(self):
        """Drop the step's graph and destroy it (``release_graph``): under
        NCCL a process group ends only once no graph holds work on its
        communicators (``parallel/distributed.py::shutdown_distributed``),
        and a caller may still hold the graph."""
        replay, self.replay = self.replay, None
        release_graph(getattr(replay, '__self__', None))

    def step(self):
        if self.replay is None:
            self._step(self.st)
        else:
            self.replay()
            launch_counts.add(self.replay_launches)
        self.st.step += 1

    def chunk(self, pos: torch.Tensor, noise: Optional[List[torch.Tensor]]):
        """One chunk: ``load``, the capture where the step has no graph yet
        (``graphs``), its steps until the phase's budget stop, and the one
        device read: (whether the budget stopped the phase, then ``read``'s
        values).  Each part is a span (``train.load``, ``train.capture``,
        ``train.steps``, whose ``n`` is the steps launched, ``train.read``).
        The counters ``chunk_steps.train`` and ``chunk_ns.train`` add its
        steps and its time from the load to the read's end, a runner's first
        chunk (kernel builds, the capture) apart as ``first_chunk_*.train``:
        the CLI's training rates."""
        start = self.st.step
        with span('train.load') as load:
            self.load(pos, noise)
        if self.graphs and self.replay is None:
            with span('train.capture'):
                self.capture()
        budget = False
        with span('train.steps') as steps:
            for _ in range(pos.shape[0]):
                self.step()
                if self.ph.budget_stop(self.st.step, self.ph.passes(self.st.step)[0]):
                    budget = True
                    break
            steps.n = self.st.step - start
        with span('train.read') as read:
            got = self.read(self.st.step - start)
        part = 'chunk' if self.chunks else 'first_chunk'
        count(part + '_steps.train', self.st.step - start)
        count(part + '_ns.train', read.end - load.start)
        self.chunks += 1
        return (budget,) + got

    def read(self, k: int):
        """The one device read after ``k`` steps of a chunk: (the stop flag,
        the step it came at, the k losses, the k volume losses, each step's
        other terms as {tag: value})."""
        got = torch.cat([torch.stack([self.st.stop.to(torch.float32),
                                      self.st.stop_step.to(torch.float32)]),
                         self.out[:, :k].reshape(-1)]).tolist()
        rows = [got[2 + i * k:2 + (i + 1) * k] for i in range(self.out.shape[0])]
        terms = []
        if self.terms:
            tensors = iter(rows[2:])
            cols = [next(tensors) if const is None else [const] * k
                    for _, const in self.tags]
            terms = [{tag: col[i] for (tag, _), col in zip(self.tags, cols)}
                     for i in range(k)]
        return bool(got[0]), int(got[1]), rows[0], rows[1], terms


def phase_done(ph: PhaseSpec, state: TrainState) -> bool:
    """Whether ``state`` has finished its phase: the pass budget spent (known
    to the host from the step) or the plateau stop (one device read).  A
    fresh state has not."""
    if state.step == 0:
        return False
    if state.step >= ph.t_max or ph.budget_stop(state.step, ph.passes(state.step)[0]):
        return True
    return bool(state.stop)


def _emit_scalars(writer, start: int, losses, vol_losses, terms):
    """Each step's losses under the JAX trainer's tags, at its step number."""
    for i, (loss, vol_loss, named) in enumerate(zip(losses, vol_losses, terms)):
        it = start + i + 1
        writer.add_scalar('loss', loss, it)
        writer.add_scalar('volume_loss', vol_loss, it)
        for tag, value in named.items():
            writer.add_scalar(tag, value, it)


def _emit_histograms(writer, rates: List[torch.Tensor], step: int):
    """The variational drop rates of each level."""
    for lvl, r in enumerate(rates):
        writer.add_histogram(f'droprates_layer_{lvl}', r.cpu().numpy().ravel(), step)


def shard_phase(ph: PhaseSpec, state: TrainState, volume: torch.Tensor, mesh=None,
                use_space: bool = True, shard_params: bool = False,
                local_decode: bool = False):
    """A phase's set-up on this rank: (the state, ZeRO-sharded with
    ``shard_params``; the phase constants; the samples a step takes here;
    ``train_step``'s keyword arguments sc, zc and x_window).  Without a
    mesh: (state, the constants, the batch, {}).  ``solve_phase`` describes
    the arguments."""
    if mesh is None:
        return state, PhaseConstants(ph, volume), ph.batch_n, {}
    sc = pm.make_shard_ctx(mesh, use_space)
    if ph.batch_n % sc.n_devices:
        raise ValueError(f"batch_size * sample_size = {ph.batch_n} does not divide "
                         f"over {sc.n_devices} ranks")
    x_offset, x_stop = pm.slab_bounds(mesh, ph.resolution[0], use_space)
    if volume.shape[0] != x_stop - x_offset:
        raise ValueError(f"the volume has {volume.shape[0]} x slices; this rank's "
                         f"slab has {x_stop - x_offset} (parallel.mesh.shard_volume)")
    x_window = zc = None
    if local_decode:
        if sc.space_axis is None:
            raise ValueError("tile-local decode needs the volume cut over a space "
                             "axis (mesh_space > 1 dividing the volume's X)")
        check_local_decode(ph.spec)
        starts, length = x_windows(ph, sc.space_size)
        x_window = (starts[mesh.space_index], length)
    if shard_params:
        state, zc = pm.shard_train_state(mesh, state)
    return (state, PhaseConstants(ph, volume, x_offset), ph.batch_n // sc.n_devices,
            dict(sc=sc, zc=zc, x_window=x_window))


def _chunk_draws(ph: PhaseSpec, c: PhaseConstants, n: int, N: int,
                 generator: Optional[torch.Generator], positions: Optional[Iterator],
                 noise_generator: Optional[torch.Generator], gate_noise: Optional[Iterator],
                 device: torch.device):
    """A chunk's (n, N, 3) positions and per-level gate noise (None for the
    deterministic families), drawn from the generators or stacked from the
    iterators (``solve_phase`` describes them)."""
    if positions is None:
        pos = draw_positions(c, n, N, generator)
    else:
        pos = torch.from_numpy(np.stack([np.asarray(next(positions))
                                         for _ in range(n)])).to(device)
        if pos.shape[1:] != (N, 3):
            raise ValueError(f"positions of shape {tuple(pos.shape[1:])}; a step "
                             f"takes ({N}, 3) here")
    if not G.noise_kind(ph.drop_type):
        return pos, None
    if gate_noise is None:
        return pos, draw_noise(ph, n, noise_generator, device)
    steps = [next(gate_noise) for _ in range(n)]
    return pos, [torch.from_numpy(np.stack([np.asarray(s[lvl], dtype=np.float32)
                                            for s in steps])).to(device)
                 for lvl in range(len(steps[0]))]


def solve_phase(ph: PhaseSpec, state: TrainState, volume: torch.Tensor,
                steps_per_chunk: int, masks=None, *,
                generator: Optional[torch.Generator] = None,
                positions: Optional[Iterator] = None,
                noise_generator: Optional[torch.Generator] = None,
                gate_noise: Optional[Iterator] = None,
                verbose: bool = True,
                metric_cb: Optional[Callable[[np.ndarray], None]] = None,
                volume_cb: Optional[Callable[[np.ndarray], None]] = None,
                writer=None, state_save_path: str = '',
                save_every_s: float = SAVE_EVERY_S, profile_dir: str = '',
                mesh=None, use_space: bool = True, shard_params: bool = False,
                local_decode: bool = False, graphs: Optional[bool] = None) -> TrainState:
    """Run one phase until its pass budget is spent or the plateau stop; a
    state that has finished its phase (``phase_done``) takes no step.  The
    steps go through a ``ChunkRunner``: on a card, with no mesh or on an
    NCCL mesh, each is a replay of the step's CUDA graph (on a mesh with its
    collectives), captured before the phase's first step and destroyed when
    the phase ends or raises (``use_step_graphs``, ``ChunkRunner.close``).

    volume:           the (X, Y, Z) ground truth on the training device
                      (the rank's x-slab on a mesh with a space axis).
    generator:        draws the positions (a ``torch.Generator`` on that
                      device) unless ``positions`` yields (N, 3) integer
                      arrays, one per step.
    noise_generator:  draws the gate noise of the stochastic families
                      (another generator on that device) unless
                      ``gate_noise`` yields a list of per-level tensors, one
                      list per step.
    metric_cb:        called after every chunk with the losses of its steps;
    volume_cb:        likewise with their volume losses (MSE).
    writer:           a TensorBoard ``SummaryWriter``: each step's losses
                      (read in the chunk's one device read) and, for the
                      variational families, the drop-rate histograms (at
                      most every 30 s, and at the stop), written on a worker
                      thread.
    state_save_path:  the state and both generators saved there
                      (``io/train_state_io.py``, atomically) after a chunk
                      when ``save_every_s`` have passed since the last save,
                      and at the end of the phase; a chunk draws its
                      positions and noise before it runs, so a save holds
                      the generators where the next chunk starts.
    profile_dir:      a ``torch.profiler`` trace of the second chunk (the
                      first builds the kernels), its draws to its last
                      write, written there, the chunk's spans in it.
    mesh:             a ``parallel.mesh.Mesh``: every rank of it calls
                      solve_phase alike and takes its part of each step
                      (N / ranks samples; ``generator`` and ``positions``
                      are the rank's own, in its slab under a space axis;
                      ``noise_generator`` is the same on every rank).  The
                      volume is cut over 'space' when ``use_space`` (its X
                      divides the axis), else whole on every rank.
                      ``shard_params`` ZeRO-shards the state over 'space'
                      for the phase; ``local_decode`` decodes the rank's grid
                      window only (a space axis and the float32 fetch and
                      MLP, else it raises).  The state comes in and goes out
                      replicated.  A save gathers on every rank and rank 0
                      writes it, with every rank's position-generator state
                      and the mesh shape; a writer, a profile_dir and
                      verbose are rank 0's (the caller passes them there).
    graphs:           False: eager steps on the card too (the tests, the
                      smoke and step_rates_turns.py hold graphs against
                      them); True: graphs required (raises on a mesh whose
                      backend is not NCCL, and without a card at the
                      capture); None: graphs where the volume is on a card,
                      with no mesh or on an NCCL mesh; eager on the CPU and
                      on a gloo mesh (``use_step_graphs``).  A failed
                      capture raises; nothing falls back to eager steps.  A
                      resumed phase captures afresh.
    """
    if positions is None and generator is None:
        raise ValueError("solve_phase needs a generator or a positions iterator")
    if (G.noise_kind(ph.drop_type) and gate_noise is None
            and noise_generator is None):
        raise ValueError(f"drop_type {ph.drop_type!r} needs a noise generator "
                         f"or a gate-noise iterator")
    graphs = use_step_graphs(graphs, mesh, volume.device)
    state, c, N, step_kw = shard_phase(ph, state, volume, mesh, use_space, shard_params,
                                       local_decode)
    # on a mesh every rank averages the same terms
    runner = ChunkRunner(ph, state, c, N, max(1, min(steps_per_chunk, ph.t_max - state.step)),
                         masks, terms=writer is not None or mesh is not None, graphs=graphs,
                         step_kw=step_kw)
    zc = step_kw.get('zc')
    generators = (generator, noise_generator)
    stopped = phase_done(ph, state)
    last_save, last_hist = time.monotonic(), -math.inf

    def replicated(st):
        return st if zc is None else pm.unshard_train_state(mesh, st, zc)

    def save(full):
        if mesh is None:
            atomic_save_train_state(state_save_path, full, generators)
            return
        rank_states = pm.gather_objects(
            mesh, None if generator is None else generator.get_state())
        if mesh.rank == 0:
            atomic_save_train_state(state_save_path, full, generators,
                                    mesh_shape=(mesh.data, mesh.space),
                                    rank_states=rank_states)

    chunk = 0
    # the writer's worker (an executor starts its thread at the first
    # submit); the step's graph is closed however the phase ends: under NCCL
    # a process group ends only once no graph holds work on it
    with span('train.phase'), ThreadPoolExecutor(max_workers=1) as pool, \
            contextlib.closing(runner):
        futures = []
        while state.step < ph.t_max and not stopped:
            n = min(steps_per_chunk, ph.t_max - state.step)
            start = state.step
            with trace(profile_dir if chunk == 1 else '', volume.device), \
                    span('train.chunk') as unit:
                with span('train.draw'):
                    pos, noise = _chunk_draws(ph, c, n, N, generator, positions,
                                              noise_generator, gate_noise, volume.device)
                stopped, stop, stop_step, losses, vol_losses, terms = runner.chunk(pos, noise)
                unit.n = state.step - start
                chunk += 1
                if stop:
                    # the steps launched after the plateau stop were idle
                    stopped = True
                    state.step = stop_step
                k = state.step - start
                losses, vol_losses, terms = losses[:k], vol_losses[:k], terms[:k]
                with span('train.after'):
                    save_now = bool(state_save_path) and not stopped and \
                        time.monotonic() - last_save >= save_every_s
                    hist_now = writer is not None and ph.variational and \
                        (stopped or time.monotonic() - last_hist > 30.0)
                    if mesh is not None:
                        # rank 0's clock decides for every rank: a save and a
                        # sharded histogram gather over the mesh
                        save_now, hist_now = (bool(f) for f in pm.broadcast(mesh, torch.tensor(
                            [save_now, hist_now], dtype=torch.int32,
                            device=mesh.device)).tolist())
                    if save_now:
                        save(replicated(state))
                        last_save = time.monotonic()
                    rates = None
                    if hist_now and ph.variational:
                        p, _ = state.layout.views(replicated(state).flat.detach())
                        rates = [G.variational_dropout_rates(p, lvl)
                                 for lvl in range(len(p.log_thetas))]
                        last_hist = time.monotonic()
                    if writer is not None:
                        futures.append(pool.submit(_emit_scalars, writer, start, losses,
                                                   vol_losses, terms))
                        if rates is not None:
                            futures.append(pool.submit(_emit_histograms, writer, rates,
                                                       state.step))
                        # a failed write raises here, at the latest after the phase
                        while futures and futures[0].done():
                            futures.pop(0).result()
                    if verbose and k:
                        vp = _F32(state.step) * _F32(ph.batch_n) * _F32(1.0 / float(ph.n_voxels))
                        print(f"Pass [{vp:.4f} / {ph.max_pass:.1f}]: volume loss: "
                              f"{vol_losses[-1]:.4f}, complete_loss: {losses[-1]:.4f}")
            if metric_cb is not None:
                metric_cb(np.asarray(losses))
            if volume_cb is not None:
                volume_cb(np.asarray(vol_losses))
        for f in futures:
            f.result()
    state = replicated(state)
    if state_save_path:
        save(state)
    return state
