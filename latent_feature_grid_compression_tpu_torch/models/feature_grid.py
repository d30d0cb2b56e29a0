"""The latent-feature-grid model (port of the JAX package's
``models/feature_grid.py``).

Forward: decode the (gated) wavelet pyramid -> trilinear feature fetch at the
input coords (grid_sample align_corners=False semantics) -> concat
[coords, fourier(coords), features] -> num_layers x (Linear + SnakeAlt) ->
final Linear; ``train=False`` clamps the output to [-1, 1].  The spec's
backends and compute dtype choose how, as the JAX ``apply_model`` does:
``interp_backend='fused'`` runs all of it after the decode in one kernel
each way (``ops/fused_forward.py``, precision 'mixed', or 'bf16' under
``compute_dtype='bfloat16'``); otherwise the fetch kernels (in 'bf16' under
bfloat16 compute or ``interp_backend='pallas_bf16'``), then the MLP as
PyTorch ops (``mlp_backend='xla'``: float32, or the bf16 chain under
bfloat16 compute) or as the fused MLP kernels (``'pallas'``,
``ops/mlp_fused.py``, 'bf16' operands).  Parameters, decode and output stay
float32.  The evaluation keeps the float32 fetch and the plain float32 MLP
whatever the spec (:func:`predict_trilinear`).

The architecture lives in the frozen :class:`ModelSpec`; the parameters in a
:class:`FeatureGridModel` (``coeffs``: lowpass (F, g, g, g) then details
(F, 7, s, s, s), coarsest first; ``mlp_w`` in ``nn.Linear``'s (out, in)
layout; ``mlp_b``; with gates the family's gate tensors, as
``models/gates.py`` names them: ``betas`` and the smallify tracker buffers
``ema`` and ``ema_var``, ``mask_values`` (straight-through), or
``log_thetas`` and ``log_var`` (variational)).  The forward functions read
only those attributes, so they also take a :class:`Params` of plain tensors
(the trainer's views into its flat parameter vector).  The stochastic
families take their noise as an argument (``noise=``, one tensor a level).

Between the training phases, :func:`save_dropvalues_on_grid` bakes the gate
values into the grid and :func:`remove_drop_layers` hard-prunes it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops.dwt import WaveletFilter3d, decode_pyramid, encode_pyramid, encoded_size
from ..wavelets import dwt_max_level
from ..ops.embedding import fourier_embed, fourier_out_dim
from ..ops.fused_forward import fused_forward
from ..ops.grid_sample import fetch
from ..ops.interpolation import channel_minor
from ..ops.mlp import init_mlp, mlp_apply, mlp_apply_bf16, snake_alt
from ..ops.mlp_fused import MAX_WIDTH, mlp_fused
from . import gates as G

# every config value of interp_backend that means "the trilinear fetch": the
# CUDA kernels on the card, their plain versions on the CPU ('pallas_bf16':
# in 'bf16' whatever the compute dtype)
_TRILINEAR = ('auto', 'xla', 'pallas', 'pallas_bf16')
# the one-kernel forward keeps the JAX package's eligibility rule: the whole
# padded grid stack VMEM-resident there (grid_size^2 <= 512)
FUSED_MAX_HW = 512


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture description."""

    d_in: int = 3
    hidden: int = 32
    d_out: int = 1
    num_layers: int = 4
    n_freqs: int = 2
    grid_features: int = 16
    grid_size: int = 32
    wavelet: str = 'db2'
    drop_type: str = ''
    drop_momentum: float = 0.025
    # per-level pruning thresholds, lowpass first
    thresholds: Tuple[float, ...] = ()
    # spatial shapes to restore per decode level, coarsest first
    level_shapes: Tuple[Tuple[int, int, int], ...] = ()
    # 'trilinear' (the fetch kernels, then the MLP) or 'fused' (one kernel
    # for fetch, embedding and MLP, ops/fused_forward.py)
    interp_backend: str = 'trilinear'
    # after the trilinear fetch: 'xla' (the MLP as PyTorch ops) or 'pallas'
    # (the fused MLP kernels, ops/mlp_fused.py, bf16 operands)
    mlp_backend: str = 'xla'
    # 'float32' or 'bfloat16' (the bf16 compute path: the fetch in 'bf16',
    # the bf16 MLP chain under mlp_backend 'xla', the one-kernel forward in
    # 'bf16')
    compute_dtype: str = 'float32'
    # the mode of the trilinear fetch and of the one-kernel forward's
    # interpolation: 'f32' or 'bf16'
    fetch_precision: str = 'f32'

    @property
    def num_levels(self) -> int:
        return len(self.level_shapes)

    @property
    def mlp_in(self) -> int:
        return self.d_in + fourier_out_dim(self.n_freqs, self.d_in) + self.grid_features

    def filter(self) -> WaveletFilter3d:
        return WaveletFilter3d(self.wavelet)


def level_shapes_for(grid_size: int, wavelet: str) -> Tuple[Tuple[int, int, int], ...]:
    """Per-level restore shapes, coarsest first: the shape recursion of
    encode_pyramid run without data."""
    if wavelet == 'none':
        return ()
    L = WaveletFilter3d(wavelet).filter_length
    shapes, s = [], grid_size
    for _ in range(dwt_max_level(grid_size, L)):
        shapes.append((s,) * 3)
        s = encoded_size(s, L)
    return tuple(shapes[::-1])


def make_spec(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=2,
              grid_features=16, grid_size=32, wavelet='db2', drop_type='',
              drop_momentum=0.025, drop_threshold=0.75,
              pruning_threshold_list=None, interp_backend='auto',
              compute_dtype='float32', mlp_backend='xla') -> ModelSpec:
    """Build a ModelSpec, precomputing the wavelet pyramid level shapes and
    the per-level pruning thresholds (``pruning_threshold_list`` entries in
    coefficient order, ``drop_threshold`` for the rest).

    ``interp_backend`` 'auto', 'xla', 'pallas' and 'pallas_bf16' all
    resolve to 'trilinear', the fetch kernels ('pallas_bf16' in 'bf16');
    'fused' to the one-kernel forward, which needs grid_size^2 <= 512 and
    every MLP width <= 128 (the JAX package's rule) and raises otherwise,
    never swapped for another backend.  ``mlp_backend`` 'xla' runs the MLP
    as PyTorch ops, 'pallas' as the fused MLP kernels (every width <= 128,
    else it raises).  ``compute_dtype`` 'float32' ('f32') or 'bfloat16'
    ('bf16'), as the JAX package takes it; the spec records it and the
    fetch's mode, 'bf16' under bfloat16 compute or 'pallas_bf16'.  Any
    other value of these raises, and so does an unknown ``drop_type``."""
    G.check_drop_type(drop_type)
    if interp_backend not in _TRILINEAR + ('fused',):
        raise ValueError(f"interp_backend must be one of 'auto', 'xla', "
                         f"'pallas', 'pallas_bf16', 'fused'; got {interp_backend!r}")
    if mlp_backend not in ('xla', 'pallas'):
        raise ValueError(f"mlp_backend must be 'xla' or 'pallas'; got {mlp_backend!r}")
    if compute_dtype in ('bf16', 'bfloat16'):
        compute_dtype = 'bfloat16'
    elif compute_dtype in ('f32', 'float32'):
        compute_dtype = 'float32'
    else:
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16'; "
                         f"got {compute_dtype!r}")
    bf16_fetch = compute_dtype == 'bfloat16' or interp_backend == 'pallas_bf16'
    if wavelet in ('', 'none'):
        # no-wavelet mode: the single coefficient tensor is the spatial grid
        wavelet = 'none'
    level_shapes = level_shapes_for(grid_size, wavelet)
    n_tensors = len(level_shapes) + 1
    tl = list(pruning_threshold_list or [])
    thresholds = tuple(tl[i] if i < len(tl) else drop_threshold
                       for i in range(n_tensors))
    spec = ModelSpec(d_in=d_in, hidden=hidden, d_out=d_out,
                     num_layers=num_layers, n_freqs=n_freqs,
                     grid_features=grid_features, grid_size=grid_size,
                     wavelet=wavelet, drop_type=drop_type,
                     drop_momentum=drop_momentum, thresholds=thresholds,
                     level_shapes=level_shapes,
                     interp_backend='fused' if interp_backend == 'fused' else 'trilinear',
                     mlp_backend=mlp_backend, compute_dtype=compute_dtype,
                     fetch_precision='bf16' if bf16_fetch else 'f32')
    widths_fit = max(spec.mlp_in, hidden, d_out) <= MAX_WIDTH
    if interp_backend == 'fused' and not (grid_size ** 2 <= FUSED_MAX_HW and widths_fit):
        raise ValueError(
            f"interp_backend='fused' requires grid_size^2 <= {FUSED_MAX_HW} and all "
            f"MLP widths <= {MAX_WIDTH} (got grid_size={grid_size}, "
            f"mlp_in={spec.mlp_in}, hidden={hidden}, d_out={d_out})")
    if mlp_backend == 'pallas' and not widths_fit:
        raise ValueError(
            f"mlp_backend='pallas' requires all MLP widths <= {MAX_WIDTH} (got "
            f"mlp_in={spec.mlp_in}, hidden={hidden}, d_out={d_out})")
    return spec


def coeff_shapes(spec: ModelSpec) -> Tuple[Tuple[int, ...], ...]:
    """Shapes of the coefficient tensors: lowpass, then details coarsest
    first; a single (F, g, g, g) tensor in no-wavelet mode."""
    Fs = spec.grid_features
    if spec.num_levels == 0:
        return ((Fs,) + (spec.grid_size,) * 3,)
    L = spec.filter().filter_length
    # the subband shape produced by encoding each restore shape
    sub = [tuple(encoded_size(s, L) for s in shp) for shp in spec.level_shapes]
    return ((Fs,) + sub[0],) + tuple((Fs, 7) + s for s in sub)


@dataclasses.dataclass
class Params:
    """A model's tensors as the forward functions read them."""

    spec: ModelSpec
    coeffs: Sequence[torch.Tensor]
    mlp_w: Sequence[torch.Tensor]
    mlp_b: Sequence[torch.Tensor]
    betas: Optional[Sequence[torch.Tensor]] = None
    mask_values: Optional[Sequence[torch.Tensor]] = None
    log_thetas: Optional[Sequence[torch.Tensor]] = None
    log_var: Optional[Sequence[torch.Tensor]] = None


class FeatureGridModel(nn.Module):
    """Parameters of one model: wavelet coefficients, the MLP and the
    gates' trainable tensors (``betas``, ``mask_values``, ``log_thetas``,
    ``log_var``: None where the family lacks them) and, with smallify, the
    tracker state (buffers).  The forward pass is :func:`apply_model`."""

    def __init__(self, spec: ModelSpec, coeffs: Sequence[torch.Tensor],
                 mlp_w: Sequence[torch.Tensor], mlp_b: Sequence[torch.Tensor],
                 betas: Optional[Sequence[torch.Tensor]] = None,
                 ema: Optional[Sequence[torch.Tensor]] = None,
                 ema_var: Optional[Sequence[torch.Tensor]] = None,
                 mask_values: Optional[Sequence[torch.Tensor]] = None,
                 log_thetas: Optional[Sequence[torch.Tensor]] = None,
                 log_var: Optional[Sequence[torch.Tensor]] = None):
        super().__init__()
        want = coeff_shapes(spec)
        got = tuple(tuple(c.shape) for c in coeffs)
        if got != want:
            raise ValueError(f"coefficient shapes {got} do not match the spec's {want}")
        self.spec = spec
        self.coeffs = nn.ParameterList([nn.Parameter(c) for c in coeffs])
        self.mlp_w = nn.ParameterList([nn.Parameter(w) for w in mlp_w])
        self.mlp_b = nn.ParameterList([nn.Parameter(b) for b in mlp_b])
        sizes = tuple(s[1:] for s in want)
        for name, ts in (('betas', betas), ('mask_values', mask_values),
                         ('log_thetas', log_thetas), ('log_var', log_var)):
            if ts is not None and tuple(tuple(t.shape) for t in ts) != sizes:
                raise ValueError(f"{name} shapes {[tuple(t.shape) for t in ts]} "
                                 f"do not match the coefficients' {sizes}")
            setattr(self, name, None if ts is None else
                    nn.ParameterList([nn.Parameter(t) for t in ts]))
        if betas is not None:
            ema = [torch.sign(b.detach()) for b in betas] if ema is None else ema
            ema_var = ([torch.zeros_like(b) for b in betas] if ema_var is None
                       else ema_var)
            for i, (e, v) in enumerate(zip(ema, ema_var)):
                self.register_buffer(f'ema_{i}', torch.as_tensor(e))
                self.register_buffer(f'ema_var_{i}', torch.as_tensor(v))

    def _buffers_named(self, name: str) -> Optional[List[torch.Tensor]]:
        if self.betas is None:
            return None
        return [getattr(self, f'{name}_{i}') for i in range(len(self.betas))]

    @property
    def ema(self) -> Optional[List[torch.Tensor]]:
        return self._buffers_named('ema')

    @property
    def ema_var(self) -> Optional[List[torch.Tensor]]:
        return self._buffers_named('ema_var')


def _detached(ts):
    return None if ts is None else [t.detach().clone() for t in ts]


def init_model(spec: ModelSpec, generator: torch.Generator,
               device: str | torch.device = 'cuda') -> FeatureGridModel:
    """Grid: U(0, 1) volume -> multi-level DWT; MLP: nn.Linear's default
    init; gates: ``gates.init_gates`` (only smallify's betas ~ N(0, 1) are
    drawn).  Everything is drawn from ``generator`` on the CPU, in that
    order, then moved to ``device`` (the card by default; raises without one
    unless ``device='cpu'``)."""
    dev = resolve_device(device)
    grid = torch.rand((spec.grid_features,) + (spec.grid_size,) * 3,
                      generator=generator)
    if spec.num_levels == 0:
        coeffs = [grid]
    else:
        coeffs, shapes = encode_pyramid(spec.filter(), grid, spec.num_levels)
        assert tuple(tuple(int(v) for v in s) for s in shapes) == spec.level_shapes
    mlp_w, mlp_b = init_mlp(generator, spec.mlp_in, spec.hidden, spec.d_out,
                            spec.num_layers)
    gates = G.init_gates(generator, spec.drop_type, [tuple(c.shape) for c in coeffs],
                         spec.drop_momentum)
    return FeatureGridModel(spec, coeffs, mlp_w, mlp_b, **G.fields_of(gates)).to(dev)


def decode_volume(model, *, train_gates: bool = False,
                  masks: Optional[Sequence[torch.Tensor]] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """(Gated) inverse DWT -> (F, G, G, G) spatial feature grid.

    Gating: ``train_gates`` applies the spec's gates (phase 1), with
    ``noise`` the per-level noise of the stochastic families; otherwise
    ``masks``, frozen binary keep-masks (one per coefficient tensor, without
    the feature axis), are multiplied in (phase 2); with neither the
    coefficients are decoded as they are."""
    spec = model.spec
    coeffs = list(model.coeffs)
    if train_gates and spec.drop_type:
        coeffs = [G.apply_gate(spec.drop_type, model, i, c,
                               None if noise is None else noise[i], spec.thresholds[i])
                  for i, c in enumerate(coeffs)]
    elif masks is not None:
        coeffs = [c * m[None] for c, m in zip(coeffs, masks)]
    if spec.num_levels == 0:
        return coeffs[0]
    return decode_pyramid(spec.filter(), coeffs, spec.level_shapes)


def _mlp_input(model, grid_cl: torch.Tensor, coords: torch.Tensor,
               precision: str = 'f32') -> torch.Tensor:
    """[coords | fourier(coords) | features fetched in ``precision``]."""
    feats = fetch(grid_cl, coords, precision)
    return torch.cat([coords, fourier_embed(coords, model.spec.n_freqs), feats], dim=-1)


def predict(model, grid_cl: torch.Tensor, coords: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """Run the head on a decoded channel-minor (D, H, W, C) grid at (N, d_in)
    coords -> (N, d_out), by the spec's backends and compute dtype, as the
    JAX ``apply_model``; ``train=False`` clamps.  'fused' (precision 'mixed',
    or 'bf16' under bfloat16 compute) takes precedence; otherwise the fetch
    in the spec's ``fetch_precision``, then the fused MLP kernels (precision
    'bf16') under ``mlp_backend='pallas'``, or the MLP as PyTorch ops: the
    bf16 chain under bfloat16 compute, else float32."""
    spec = model.spec
    ws, bs = list(model.mlp_w), list(model.mlp_b)
    bf16 = spec.compute_dtype == 'bfloat16'
    if spec.interp_backend == 'fused':
        out = fused_forward(grid_cl, coords, ws, bs, spec.n_freqs,
                            precision='bf16' if bf16 else 'mixed')
    else:
        x = _mlp_input(model, grid_cl, coords, spec.fetch_precision)
        if spec.mlp_backend == 'pallas':
            out = mlp_fused(ws, bs, x, precision='bf16')
        elif bf16:
            out = mlp_apply_bf16(ws, bs, x, snake_alt)
        else:
            out = mlp_apply(ws, bs, x, snake_alt)
    return out if train else out.clamp(-1.0, 1.0)


def predict_trilinear(model, grid_cl: torch.Tensor, coords: torch.Tensor
                      ) -> torch.Tensor:
    """The evaluation's head whatever the spec, as the JAX evaluation's: the
    float32 fetch, then the float32 MLP as PyTorch ops, clamped to
    [-1, 1]."""
    out = mlp_apply(list(model.mlp_w), list(model.mlp_b),
                    _mlp_input(model, grid_cl, coords), snake_alt)
    return out.clamp(-1.0, 1.0)


def apply_model(model, coords: torch.Tensor, *, train: bool = True,
                train_gates: bool = False,
                masks: Optional[Sequence[torch.Tensor]] = None,
                noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Full forward pass at (N, d_in) normalized coordinates -> (N, d_out),
    differentiable in the model's tensors (on the card through the kernels'
    ``torch.autograd.Function``s); the spec's backends choose the kernels
    (:func:`predict`)."""
    grid = decode_volume(model, train_gates=train_gates, masks=masks, noise=noise)
    return predict(model, channel_minor(grid), coords, train=train)


@torch.no_grad()
def save_dropvalues_on_grid(model: FeatureGridModel):
    """Bake the gate values into the grid; returns (model', masks, zeros).

    Each coefficient tensor is multiplied by gate * mask; ``zeros`` counts
    the zeros of the result less the storage cost of the binary masks (one
    bit per gate value, i.e. gate_size / 32 floats), so it is a float and can
    be negative.  ``masks`` are the frozen keep-masks of the finetune phase.
    ``model'`` keeps the gates.  Without gates: (model, None, 0.0)."""
    spec = model.spec
    mask_bits = G.gate_size(spec.drop_type, model)
    if not mask_bits:
        return model, None, 0.0
    masks = G.pruning_masks(spec.drop_type, model, spec.thresholds)
    baked = G.bake_values(spec.drop_type, model, list(model.coeffs), spec.thresholds)
    counts = torch.stack([torch.count_nonzero(c) for c in baked]).tolist()
    zeros = sum(c.numel() - nz for c, nz in zip(baked, counts))
    out = FeatureGridModel(spec, baked, _detached(model.mlp_w), _detached(model.mlp_b),
                           **{k: _detached(v) for k, v in G.fields_of(model).items()})
    return out, masks, float(zeros) - mask_bits / 32.0


@torch.no_grad()
def remove_drop_layers(model: FeatureGridModel,
                       masks: Optional[Sequence[torch.Tensor]]) -> FeatureGridModel:
    """Hard-prune: coeffs *= mask, gates dropped."""
    if masks is None:
        return model
    coeffs = [c.detach() * m[None] for c, m in zip(model.coeffs, masks)]
    return FeatureGridModel(model.spec, coeffs, _detached(model.mlp_w),
                            _detached(model.mlp_b))


def num_net_params(model) -> int:
    """Parameter count of the coefficients and the MLP (the gates are left
    out: they are stored as mask bits, see :func:`save_dropvalues_on_grid`)."""
    return int(sum(t.numel() for group in (model.coeffs, model.mlp_w, model.mlp_b)
                   for t in group))
