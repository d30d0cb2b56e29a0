"""Carry a model's weights across from the JAX package.

The JAX package keeps its parameters in ``ModelParams(coeffs, mlp_w, mlp_b,
gates)`` with MLP weights in (in, out) layout, and the smallify tracker in a
separate ``SmallifyAux(ema, ema_var)``; the port keeps ``nn.Linear``'s
(out, in) and holds the gates and the tracker in the model.  This is one of
the two places the transpose happens (``io/checkpoint.py`` is the other).
The caller passes the JAX fields as numpy arrays, so this module imports
nothing of JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .models.feature_grid import FeatureGridModel, ModelSpec


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(coeffs: Sequence[np.ndarray], mlp_w: Sequence[np.ndarray],
                    mlp_b: Sequence[np.ndarray], spec: ModelSpec,
                    device: str | torch.device = 'cpu',
                    betas: Optional[Sequence[np.ndarray]] = None,
                    ema: Optional[Sequence[np.ndarray]] = None,
                    ema_var: Optional[Sequence[np.ndarray]] = None
                    ) -> FeatureGridModel:
    """coeffs: lowpass (F, g, g, g) and details (F, 7, s, s, s), coarsest
    first; mlp_w: (in, out) per layer; mlp_b: (out,) per layer; betas, ema,
    ema_var: the smallify gates and tracker, one per coefficient tensor
    (ema and ema_var default to sign(betas) and zeros)."""
    def ts(arrs):
        return None if arrs is None else [_t(a) for a in arrs]
    return FeatureGridModel(
        spec, ts(coeffs), [_t(np.asarray(w).T) for w in mlp_w], ts(mlp_b),
        ts(betas), ts(ema), ts(ema_var)).to(device)


def params_to_jax(model: FeatureGridModel):
    """The inverse: (coeffs, mlp_w (in, out), mlp_b, gates) as numpy arrays,
    where gates is None or (betas, ema, ema_var)."""
    def a(ts):
        return [t.detach().cpu().numpy() for t in ts]
    gates = None if model.betas is None else (
        a(model.betas), a(model.ema), a(model.ema_var))
    return (a(model.coeffs), [w.T.copy() for w in a(model.mlp_w)],
            a(model.mlp_b), gates)
