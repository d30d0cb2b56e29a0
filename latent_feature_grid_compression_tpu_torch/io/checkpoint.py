"""npz checkpoints, with the JAX package's keys.

``coeffs_i``, ``mlp_w_i`` in (in, out) layout, ``mlp_b_i``, ``drop_type``
and, for a model with smallify gates, ``gate_betas_i``, ``gate_ema_i`` and
``gate_emavar_i``: a ``model.npz`` written by the JAX trainer loads here, and
one written here loads there.  The (in, out) <-> (out, in) transpose is done
by ``convert.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert import params_from_jax, params_to_jax
from ..device import resolve_device
from ..models.feature_grid import FeatureGridModel, ModelSpec


def save_checkpoint(path: str, model: FeatureGridModel):
    coeffs, mlp_w, mlp_b, gates = params_to_jax(model)
    out = {}
    out.update({f'coeffs_{i}': c for i, c in enumerate(coeffs)})
    out.update({f'mlp_w_{i}': w for i, w in enumerate(mlp_w)})
    out.update({f'mlp_b_{i}': b for i, b in enumerate(mlp_b)})
    drop_type = ''
    if gates is not None:
        drop_type = 'smallify'
        for key, arrs in zip(('gate_betas', 'gate_ema', 'gate_emavar'), gates):
            out.update({f'{key}_{i}': a for i, a in enumerate(arrs)})
    out['drop_type'] = np.asarray(drop_type)
    np.savez(path, **out)


def load_checkpoint(path: str, spec: ModelSpec,
                    device: str | torch.device = 'cuda',
                    model: Optional[FeatureGridModel] = None) -> FeatureGridModel:
    """Build the model of ``spec`` from an npz checkpoint on ``device``.

    With smallify in ``spec``, the gates and their tracker come from the
    file where it has them; where it does not, from ``model`` (a warm start
    over a fresh init keeps the init's gates, as the JAX trainer does)."""
    dev = resolve_device(device)
    n_coeffs = spec.num_levels + 1
    n_layers = spec.num_layers + 1
    with np.load(path, allow_pickle=False) as z:
        coeffs = [z[f'coeffs_{i}'] for i in range(n_coeffs)]
        mlp_w = [z[f'mlp_w_{i}'] for i in range(n_layers)]
        mlp_b = [z[f'mlp_b_{i}'] for i in range(n_layers)]
        betas = ema = ema_var = None
        if spec.drop_type == 'smallify' and model is not None and model.betas is not None:
            betas, ema, ema_var = ([t.detach().cpu().numpy() for t in ts]
                                   for ts in (model.betas, model.ema, model.ema_var))
        has_gates = ('gate_betas_0' in z.files and 'drop_type' in z.files
                     and str(z['drop_type']) == 'smallify')
        if spec.drop_type == 'smallify' and has_gates:
            betas = [z[f'gate_betas_{i}'] for i in range(n_coeffs)]
            # a file without the tracker keeps the model's (or a fresh one)
            if 'gate_ema_0' in z.files:
                ema = [z[f'gate_ema_{i}'] for i in range(n_coeffs)]
                ema_var = [z[f'gate_emavar_{i}'] for i in range(n_coeffs)]
            elif model is None:
                ema = ema_var = None
    if spec.drop_type and betas is None:
        raise ValueError(f"{path} holds no gates for drop_type "
                         f"{spec.drop_type!r}; pass the model to warm-start over")
    return params_from_jax(coeffs, mlp_w, mlp_b, spec, device=dev, betas=betas,
                           ema=ema, ema_var=ema_var)
