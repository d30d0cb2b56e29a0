"""Carry a model's weights across from the JAX package.

The JAX package keeps its parameters in ``ModelParams(coeffs, mlp_w, mlp_b,
gates)`` with MLP weights in (in, out) layout, the gates in a family's
container (``SmallifyParams(betas)``, ``STParams(mask_values)``,
``VariationalParams(log_thetas, log_var)``) and the smallify tracker in a
separate ``SmallifyAux(ema, ema_var)``; the port keeps ``nn.Linear``'s
(out, in) and holds the gates and the tracker in the model.  The dynamic
family's variance model is a dict of (in, out) weights and biases there, a
(weights, biases) pair in (out, in) here.  This is one of the two places the
transpose happens (``io/checkpoint.py`` is the other).  A JAX ``TrainState``
crosses too (``train_state_from_jax``): its Adam moments are one vector in
``ravel_pytree``'s order of (params, variance model), the port's in its
``FlatLayout``'s.  The caller passes the JAX fields as numpy arrays, so this
module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models import gates as G
from .models.feature_grid import FeatureGridModel, ModelSpec


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ts(arrs):
    return None if arrs is None else [_t(a) for a in arrs]


def _np(ts):
    return None if ts is None else [t.detach().cpu().numpy() for t in ts]


def params_from_jax(coeffs: Sequence[np.ndarray], mlp_w: Sequence[np.ndarray],
                    mlp_b: Sequence[np.ndarray], spec: ModelSpec,
                    device: str | torch.device = 'cuda',
                    **gates: Optional[Sequence[np.ndarray]]) -> FeatureGridModel:
    """coeffs: lowpass (F, g, g, g) and details (F, 7, s, s, s), coarsest
    first; mlp_w: (in, out) per layer; mlp_b: (out,) per layer; ``gates``:
    the gate fields by their names (``betas``, ``ema``, ``ema_var``,
    ``mask_values``, ``log_thetas``, ``log_var``), one array per coefficient
    tensor (ema and ema_var default to sign(betas) and zeros).  The model
    goes to ``device``: the card by default, which raises without one unless
    ``device='cpu'``."""
    unknown = set(gates) - set(G.FIELDS)
    if unknown:
        raise TypeError(f"unknown gate fields {sorted(unknown)}")
    dev = resolve_device(device)
    return FeatureGridModel(
        spec, _ts(coeffs), [_t(np.asarray(w).T) for w in mlp_w], _ts(mlp_b),
        **{k: _ts(v) for k, v in gates.items()}).to(dev)


def params_to_jax(model: FeatureGridModel):
    """The inverse: (coeffs, mlp_w (in, out), mlp_b, gates) as numpy arrays,
    where gates is None (no gates) or a dict of the model's gate fields
    that are not None."""
    gates = {k: _np(v) for k, v in G.fields_of(model).items() if v is not None}
    return (_np(model.coeffs), [w.T.copy() for w in _np(model.mlp_w)],
            _np(model.mlp_b), gates or None)


def variance_from_jax(w: Sequence[np.ndarray], b: Sequence[np.ndarray],
                      device: str | torch.device = 'cuda'):
    """The JAX variance model's weights ((in, out) per layer) and biases as
    the port's (weights (out, in), biases) on ``device``."""
    dev = resolve_device(device)
    return ([_t(np.asarray(a).T).to(dev) for a in w], [_t(a).to(dev) for a in b])


def variance_to_jax(variance):
    """The inverse: {'w': (in, out) arrays, 'b': arrays}, as the JAX package
    keeps them."""
    ws, bs = variance
    return {'w': tuple(a.T.copy() for a in _np(ws)), 'b': tuple(_np(bs))}


def tensors_from_jax(names: Sequence[str], coeffs, mlp_w, mlp_b,
                     gates: Optional[Dict[str, Sequence[np.ndarray]]] = None,
                     variance: Optional[dict] = None) -> List[np.ndarray]:
    """The JAX arrays of the groups ``names`` (a ``FlatLayout``'s: coeffs,
    mlp_w, mlp_b, gate fields, var_w, var_b) in the port's flat order and
    layout: MLP and variance weights as (out, in)."""
    groups = {'coeffs': coeffs, 'mlp_w': [np.asarray(w).T for w in mlp_w],
              'mlp_b': mlp_b, **(gates or {})}
    if variance is not None:
        groups.update(var_w=[np.asarray(w).T for w in variance['w']], var_b=variance['b'])
    return [np.asarray(a, dtype=np.float32) for name in names for a in groups[name]]


def _unravel_jax(flat: np.ndarray, coeffs, mlp_w, mlp_b, gates, variance):
    """A vector in ``ravel_pytree``'s order of (ModelParams, variance dict)
    split into arrays shaped as the given ones: coeffs, mlp_w, mlp_b, the
    gate container's fields in their declared order, then the variance
    model's 'b' before its 'w' (a dict's keys are sorted)."""
    gate_fields = [f for f in G.FIELDS[:4] if gates and gates.get(f) is not None]
    like = {'coeffs': coeffs, 'mlp_w': mlp_w, 'mlp_b': mlp_b,
            **{f: gates[f] for f in gate_fields}}
    order = ['coeffs', 'mlp_w', 'mlp_b', *gate_fields]
    if variance is not None:
        like.update(var_b=variance['b'], var_w=variance['w'])
        order += ['var_b', 'var_w']
    out, k = {}, 0
    for name in order:
        out[name] = []
        for a in like[name]:
            n = int(np.prod(np.shape(a)))
            out[name].append(np.asarray(flat[k:k + n]).reshape(np.shape(a)))
            k += n
    if k != np.size(flat):
        raise ValueError(f"the moments hold {np.size(flat)} values, the parameters {k}")
    return (out['coeffs'], out['mlp_w'], out['mlp_b'], {f: out[f] for f in gate_fields},
            {'w': out['var_w'], 'b': out['var_b']} if variance is not None else None)


def train_state_from_jax(template, *, params, m, v, step, lr, shadow_lr, last_loss,
                         no_gain, stop, weight_dkl, var_params=None, gate_aux=None):
    """A JAX ``TrainState``'s fields, as numpy, as the port's ``TrainState``
    on ``template``'s layout and device (``template``: the port's state of
    the same phase, e.g. ``init_train_state`` of ``params_from_jax``).

    params: (coeffs, mlp_w, mlp_b, gates) with gates a dict of the gate
    container's fields or None; var_params: {'w': ..., 'b': ...} or None;
    m, v: the flat moments over (params, var_params); gate_aux: smallify's
    (ema, ema_var) or None.  The groups the port's phase does not train (the
    gates and the variance model in phase 2) are left out.  JAX's stop flag
    also holds the budget stop; set, it becomes the port's stop at the
    state's step, so the phase takes no step either way."""
    coeffs, mlp_w, mlp_b, gates = params
    names = template.layout.names
    dev = template.flat.device

    def flat_of(parts):
        return torch.from_numpy(np.concatenate(
            [a.ravel() for a in tensors_from_jax(names, *parts)])).to(dev)

    def scalar(value, like):
        return torch.as_tensor(np.array(value)).to(device=dev, dtype=like.dtype)

    fields = dict(
        flat=flat_of((coeffs, mlp_w, mlp_b, gates, var_params)),
        m=flat_of(_unravel_jax(m, coeffs, mlp_w, mlp_b, gates, var_params)),
        v=flat_of(_unravel_jax(v, coeffs, mlp_w, mlp_b, gates, var_params)),
        step=int(step), lr=scalar(lr, template.lr),
        shadow_lr=scalar(shadow_lr, template.shadow_lr),
        last_loss=scalar(last_loss, template.last_loss),
        no_gain=scalar(no_gain, template.no_gain), stop=scalar(stop, template.stop),
        stop_step=scalar(int(step) if bool(stop) else 0, template.stop_step),
        weight_dkl=scalar(weight_dkl, template.weight_dkl))
    if fields['flat'].shape != template.flat.shape:
        raise ValueError(f"the JAX state holds {fields['flat'].numel()} trainables, "
                         f"the port's layout {template.flat.numel()}")
    if template.ema is not None:
        ema, ema_var = gate_aux
        fields.update(ema=torch.from_numpy(np.concatenate(
                          [np.asarray(e, np.float32).ravel() for e in ema])).to(dev),
                      ema_var=torch.from_numpy(np.concatenate(
                          [np.asarray(e, np.float32).ravel() for e in ema_var])).to(dev))
    return dataclasses.replace(template, **fields)
