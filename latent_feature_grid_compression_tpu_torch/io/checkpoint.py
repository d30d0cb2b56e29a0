"""npz checkpoints, with the JAX package's keys.

``coeffs_i``, ``mlp_w_i`` in (in, out) layout, ``mlp_b_i``, ``drop_type``
and, for a model with gates, the family's: ``gate_betas_i``, ``gate_ema_i``
and ``gate_emavar_i`` (smallify), ``gate_mask_values_i`` (both
straight-through families), ``gate_log_thetas_i`` and ``gate_log_var_i``
(variational).  A ``model.npz`` written by the JAX trainer loads here, and
one written here loads there.  The (in, out) <-> (out, in) transpose is done
by ``convert.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert import params_from_jax, params_to_jax
from ..device import resolve_device
from ..models import gates as G
from ..models.feature_grid import FeatureGridModel, ModelSpec

# the npz key of each gate field (``_i`` appended per level)
KEYS = {'betas': 'gate_betas', 'ema': 'gate_ema', 'ema_var': 'gate_emavar',
        'mask_values': 'gate_mask_values', 'log_thetas': 'gate_log_thetas',
        'log_var': 'gate_log_var'}


def save_checkpoint(path: str, model: FeatureGridModel):
    """The model's arrays; ``drop_type`` is the spec's for a model with
    gates and '' for one without (a pruned model, as the JAX trainer writes
    its final checkpoint)."""
    coeffs, mlp_w, mlp_b, gates = params_to_jax(model)
    out = {}
    out.update({f'coeffs_{i}': c for i, c in enumerate(coeffs)})
    out.update({f'mlp_w_{i}': w for i, w in enumerate(mlp_w)})
    out.update({f'mlp_b_{i}': b for i, b in enumerate(mlp_b)})
    for name, arrs in (gates or {}).items():
        out.update({f'{KEYS[name]}_{i}': a for i, a in enumerate(arrs)})
    out['drop_type'] = np.asarray(model.spec.drop_type if gates else '')
    np.savez(path, **out)


def load_checkpoint(path: str, spec: ModelSpec,
                    device: str | torch.device = 'cuda',
                    model: Optional[FeatureGridModel] = None) -> FeatureGridModel:
    """Build the model of ``spec`` from an npz checkpoint on ``device``.

    With gates in ``spec``, the family's gate arrays (and smallify's
    tracker) come from the file where it has them (smallify's only when the
    file names 'smallify', as the JAX reader asks); where it does not, from
    ``model`` (a warm start over a fresh init keeps the init's gates, as the
    JAX trainer does)."""
    dev = resolve_device(device)
    n_coeffs = spec.num_levels + 1
    n_layers = spec.num_layers + 1
    fields = G.trainable_fields(spec.drop_type)
    with np.load(path, allow_pickle=False) as z:
        coeffs = [z[f'coeffs_{i}'] for i in range(n_coeffs)]
        mlp_w = [z[f'mlp_w_{i}'] for i in range(n_layers)]
        mlp_b = [z[f'mlp_b_{i}'] for i in range(n_layers)]

        def read(name):
            return [z[f'{KEYS[name]}_{i}'] for i in range(n_coeffs)]
        gates = {}
        if fields and model is not None and getattr(model, fields[0]) is not None:
            gates = {k: [t.detach().cpu().numpy() for t in v]
                     for k, v in G.fields_of(model).items() if v is not None}
        in_file = bool(fields) and all(f'{KEYS[f]}_0' in z.files for f in fields)
        if spec.drop_type == 'smallify':
            in_file = in_file and 'drop_type' in z.files and str(z['drop_type']) == 'smallify'
        if in_file:
            gates.update({f: read(f) for f in fields})
            # a file without the tracker keeps the model's (or a fresh one)
            if spec.drop_type == 'smallify' and 'gate_ema_0' in z.files:
                gates.update(ema=read('ema'), ema_var=read('ema_var'))
    if fields and not gates:
        raise ValueError(f"{path} holds no gates for drop_type "
                         f"{spec.drop_type!r}; pass the model to warm-start over")
    return params_from_jax(coeffs, mlp_w, mlp_b, spec, device=dev, **gates)
