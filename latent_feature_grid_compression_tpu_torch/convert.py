"""Carry a model's weights across from the JAX package.

The JAX package keeps its parameters in ``ModelParams(coeffs, mlp_w, mlp_b,
gates)`` with MLP weights in (in, out) layout, the gates in a family's
container (``SmallifyParams(betas)``, ``STParams(mask_values)``,
``VariationalParams(log_thetas, log_var)``) and the smallify tracker in a
separate ``SmallifyAux(ema, ema_var)``; the port keeps ``nn.Linear``'s
(out, in) and holds the gates and the tracker in the model.  The dynamic
family's variance model is a dict of (in, out) weights and biases there, a
(weights, biases) pair in (out, in) here.  This is one of the two places the
transpose happens (``io/checkpoint.py`` is the other).  The caller passes
the JAX fields as numpy arrays, so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
