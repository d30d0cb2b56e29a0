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
the data) is read once per ``steps_per_chunk`` steps, and the steps launched
after a boundary step in the same chunk are guarded so that a stopped step
changes nothing, as the JAX trainer's idle branch.  Positions for a chunk
are drawn at once from an explicit ``torch.Generator`` on the device, or
taken from an iterator of (N, 3) integer arrays (the tests replay the JAX
trainer's stream that way); the gate noise likewise, one draw a level from a
generator of its own, or from an iterator of per-level lists.

Reference quirk kept: in phase 2 the lr strategy's decays reach only the
shadow lr (the reference's strategy still points at the phase-1 optimizer),
so phase 2 trains at a constant lr/10 while the plateau logic runs on the
shadow lr.  Not ported yet: resume and mid-phase state saves, the
profiler trace and the TensorBoard writer (ROADMAP Queue 1 item 6) and
multi-device (item 5).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..data.volume import VolumeMeta
from ..models import gates as G
from ..models.feature_grid import (FeatureGridModel, ModelSpec, Params, apply_model,
                                   coeff_shapes)
from ..models.variance import apply_variance_model
from . import losses as L

_F32 = np.float32


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
    volume, and 1 - b**t for every step of the phase (so that step t's bias
    corrections are views, not launches)."""

    def __init__(self, ph: PhaseSpec, volume: torch.Tensor):
        dev = volume.device
        res = np.asarray(ph.resolution, dtype=np.int64)
        max_idx = (res - 1).astype(np.float32)
        self.res = res
        self.max_idx = torch.as_tensor(max_idx, device=dev)
        self.scales = torch.as_tensor(max_idx / max_idx.max(), device=dev)
        self.strides = torch.as_tensor([res[1] * res[2], res[2], 1], device=dev)
        self.volume = volume.reshape(-1)
        ts = torch.arange(1, ph.t_max + 2, dtype=torch.float32, device=dev)
        self.bc1 = 1.0 - 0.9 ** ts
        self.bc2 = 1.0 - 0.999 ** ts


def chunk_inputs(c: PhaseConstants, pos: torch.Tensor):
    """(steps, N, 3) integer positions -> normalized, scaled coordinates and
    the exact ground-truth voxel values of the whole chunk."""
    norm = (pos.to(torch.float32) / c.max_idx) * 2.0 - 1.0
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
    IndexDataset), in one call per axis."""
    dev = c.volume.device
    return torch.stack([torch.randint(0, int(r), (n_steps, N), generator=generator,
                                      device=dev, dtype=torch.int32)
                        for r in c.res], dim=-1)


def loss_and_grad(ph: PhaseSpec, layout: FlatLayout, flat: torch.Tensor,
                  norm: torch.Tensor, gt: torch.Tensor, masks=None, noise=None,
                  weight_dkl: Optional[torch.Tensor] = None):
    """(loss, volume loss, gradient of the loss with respect to ``flat``).
    ``noise``: this step's per-level gate noise (straight-through,
    variational); ``weight_dkl``: this step's KL weight (variational)."""
    x = flat.detach().requires_grad_(True)
    p, variance = layout.views(x)
    train_gates = bool(ph.drop_type)
    pred = apply_model(p, norm, train=True, train_gates=train_gates,
                       masks=masks if ph.use_masks else None, noise=noise)[:, 0]
    # the sums over the levels taken over the flat slices at once
    s = layout.slices
    coeffs = [x[s['coeffs']]]
    if train_gates and ph.variational:
        if ph.dynamic_variational:
            log_sigma = apply_variance_model(*variance, norm)[:, 0]
        else:
            log_sigma = torch.full_like(pred, ph.variational_sigma)
        gates = G.Gates(log_thetas=[x[s['log_thetas']]], log_var=[x[s['log_var']]])
        loss, _, vol_loss, _, _ = L.variational_loss(
            coeffs, gates, pred, gt, log_sigma, weight_dkl, ph.lambda_weight_loss,
            batch_scale=ph.n_voxels / ph.batch_n, data_scale=ph.n_voxels / pred.shape[0])
    else:
        vol_loss = torch.mean((pred - gt) ** 2)
        loss = vol_loss
        if train_gates:
            name = G.trainable_fields(ph.drop_type)[0]
            loss = loss + L.smallify_family_loss(
                ph.drop_type, coeffs, G.Gates(**{name: [x[s[name]]]}),
                ph.lambda_drop_loss, ph.lambda_weight_loss)
    g, = torch.autograd.grad(loss, x)
    return loss.detach(), vol_loss.detach(), g


def train_step(ph: PhaseSpec, st: TrainState, c: PhaseConstants,
               norm: torch.Tensor, gt: torch.Tensor, masks=None,
               guard: bool = False, noise=None):
    """One step in place on ``st``; returns (loss, volume loss) on the
    device.  ``guard``: the stop flag may be set, so every update is taken
    only where it is not (a stopped step changes nothing).  ``noise``: the
    step's per-level gate noise."""
    t = st.step + 1
    weight_dkl = None
    if ph.variational:
        # the KL weight is ramped before the loss that uses it
        weight_dkl = L.ramp_weight_dkl(st.weight_dkl, ph.weight_dkl_multiplier)
    loss, vol_loss, g = loss_and_grad(ph, st.layout, st.flat, norm, gt, masks, noise,
                                      weight_dkl)
    flat, m, v = adam_update(st.flat, g, st.m, st.v, st.lr, c.bc1[t - 1],
                             c.bc2[t - 1])
    ema = ema_var = None
    if ph.drop_type == 'smallify':
        # fed with the pre-update betas
        mom = ph.spec.drop_momentum
        phi = torch.sign(st.flat[st.layout.slices['betas']]) - st.ema
        ema = st.ema + mom * phi
        ema_var = (1.0 - mom) * (st.ema_var + mom * phi * phi)

    def take(old, new):
        return torch.where(st.stop, old, new) if guard else new

    st.flat, st.m, st.v = take(st.flat, flat), take(st.m, m), take(st.v, v)
    if ema is not None:
        st.ema, st.ema_var = take(st.ema, ema), take(st.ema_var, ema_var)
    if weight_dkl is not None:
        st.weight_dkl = take(st.weight_dkl, weight_dkl)

    cur, boundary = ph.passes(t)
    if boundary:
        _strategy(ph, st, loss, cur, t, take)
    st.step = t
    return loss, vol_loss


def _strategy(ph: PhaseSpec, st: TrainState, loss: torch.Tensor, cur: float,
              t: int, take: Callable):
    """The lr strategy at a pass boundary."""
    if ph.use_smallify_decay:
        # SmallifyDecayStrategy: decay after pass_decay boundaries without a
        # new best loss; stop once the shadow lr is at lr_stop
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
        st.stop_step = take(st.stop_step, torch.where(stop_now, t, st.stop_step))
        st.last_loss, st.no_gain = take(st.last_loss, new_last), take(st.no_gain, new_no_gain)
        st.lr, st.shadow_lr = take(st.lr, lr), take(st.shadow_lr, shadow)
        st.stop = take(st.stop, stop)
    elif (cur + 1) % ph.pass_decay == 0:
        # NeurcompDecayStrategy: decay every pass_decay passes (host-known)
        st.shadow_lr = st.shadow_lr * ph.lr_decay
        if ph.decay_applies_to_lr:
            st.lr = st.lr * ph.lr_decay


class StepTimer:
    """Wall-clock timing of chunks (each ends in a device read) ->
    samples/s.  The first chunk of each phase (kernel build, library
    initialisation) is reported apart from the steady state."""

    def __init__(self, samples_per_step: int):
        self.samples_per_step = samples_per_step
        self._chunks: List[tuple] = []   # (n_steps, seconds, is_first)

    @contextlib.contextmanager
    def chunk(self, n_steps: int, first: bool = False):
        t0 = time.perf_counter()
        yield
        self._chunks.append((n_steps, time.perf_counter() - t0, first))

    @staticmethod
    def merge(timers: List['StepTimer']) -> 'StepTimer':
        """One timer over the chunks of several (with equal step sizes)."""
        out = StepTimer(timers[0].samples_per_step if timers else 0)
        for t in timers:
            out._chunks += t._chunks
        return out

    def stats(self) -> Dict[str, float]:
        if not self._chunks:
            return {}
        body = [c for c in self._chunks if not c[2]] or self._chunks
        steps = sum(n for n, _, _ in body)
        secs = sum(s for _, s, _ in body)
        return {
            'steps_per_sec': steps / secs if secs else 0.0,
            'samples_per_sec': steps * self.samples_per_step / secs if secs else 0.0,
            'ms_per_step': secs / steps * 1e3 if steps else 0.0,
            'first_chunks_sec': sum(s for _, s, f in self._chunks if f),
        }


def solve_phase(ph: PhaseSpec, state: TrainState, volume: torch.Tensor,
                steps_per_chunk: int, masks=None, *,
                generator: Optional[torch.Generator] = None,
                positions: Optional[Iterator] = None,
                noise_generator: Optional[torch.Generator] = None,
                gate_noise: Optional[Iterator] = None,
                verbose: bool = True, timer: Optional[StepTimer] = None,
                metric_cb: Optional[Callable[[np.ndarray], None]] = None,
                volume_cb: Optional[Callable[[np.ndarray], None]] = None
                ) -> TrainState:
    """Run one phase until its pass budget is spent or the plateau stop.

    volume:           the (X, Y, Z) ground truth on the training device.
    generator:        draws the positions (a ``torch.Generator`` on that
                      device) unless ``positions`` yields (N, 3) integer
                      arrays, one per step.
    noise_generator:  draws the gate noise of the stochastic families
                      (another generator on that device) unless
                      ``gate_noise`` yields a list of per-level tensors, one
                      list per step.
    metric_cb:        called after every chunk with the losses of its steps;
    volume_cb:        likewise with their volume losses (MSE)."""
    if positions is None and generator is None:
        raise ValueError("solve_phase needs a generator or a positions iterator")
    if (G.noise_kind(ph.drop_type) and gate_noise is None
            and noise_generator is None):
        raise ValueError(f"drop_type {ph.drop_type!r} needs a noise generator "
                         f"or a gate-noise iterator")
    c = PhaseConstants(ph, volume)
    N = ph.batch_n
    first = True
    stopped = False
    while state.step < ph.t_max and not stopped:
        n = min(steps_per_chunk, ph.t_max - state.step)
        if positions is None:
            pos = draw_positions(c, n, N, generator)
        else:
            pos = torch.from_numpy(np.stack([np.asarray(next(positions))
                                             for _ in range(n)])).to(volume.device)
        noise = None
        if G.noise_kind(ph.drop_type) and gate_noise is None:
            noise = draw_noise(ph, n, noise_generator, volume.device)
        elif G.noise_kind(ph.drop_type):
            steps = [next(gate_noise) for _ in range(n)]
            noise = [torch.from_numpy(np.stack([np.asarray(s[lvl], dtype=np.float32)
                                                for s in steps])).to(volume.device)
                     for lvl in range(len(steps[0]))]
        start = state.step
        tchunk = timer.chunk(n, first=first) if timer is not None \
            else contextlib.nullcontext()
        with tchunk:
            norm_all, gt_all = chunk_inputs(c, pos)
            losses, vol_losses = [], []
            guard = False
            for i in range(n):
                loss, vol_loss = train_step(ph, state, c, norm_all[i], gt_all[i],
                                            masks, guard,
                                            None if noise is None else [a[i] for a in noise])
                losses.append(loss)
                vol_losses.append(vol_loss)
                cur, boundary = ph.passes(state.step)
                # after a boundary the plateau stop may have come
                guard = guard or (boundary and ph.use_smallify_decay)
                if ph.budget_stop(state.step, cur):
                    stopped = True
                    break
            # the one device read of the chunk
            read = torch.stack([state.stop.to(torch.float32),
                                state.stop_step.to(torch.float32),
                                *losses, *vol_losses]).tolist()
        first = False
        if read[0]:
            # the steps launched after the plateau stop were idle
            stopped = True
            state.step = int(read[1])
        k = state.step - start
        losses, vol_losses = read[2:2 + k], read[2 + len(losses):][:k]
        if metric_cb is not None:
            metric_cb(np.asarray(losses))
        if volume_cb is not None:
            volume_cb(np.asarray(vol_losses))
        if verbose and k:
            vp = _F32(state.step) * _F32(N) * _F32(1.0 / float(ph.n_voxels))
            print(f"Pass [{vp:.4f} / {ph.max_pass:.1f}]: volume loss: "
                  f"{vol_losses[-1]:.4f}, complete_loss: {losses[-1]:.4f}")
    return state
