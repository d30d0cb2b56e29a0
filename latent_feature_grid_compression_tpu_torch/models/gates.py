"""Pruning gates over the wavelet coefficient tensors (port of the JAX
package's ``models/gates.py``).

One gate tensor per coefficient tensor, shaped like it minus its leading
feature axis (the gates broadcast over the features).  The families:

  'smallify'                 learned ``betas`` multiply the coefficients; a
                             tracker (``ema``, ``ema_var``) follows the
                             moving variance of their signs, and entries
                             whose sign variance stays below the level's
                             threshold are kept
  'straight_through'         Bernoulli keep masks u < ``mask_values`` with a
                             working straight-through estimator (hardtanh)
  'masked_straight_through'  hard masks sigmoid(``mask_values``) >= threshold
                             with a sigmoid straight-through estimator
  any name with 'variational'  Molchanov sparse variational dropout: the
                             coefficients times exp(``log_thetas``) +
                             exp(``log_var`` / 2) * xi; entries whose dropout
                             rate stays below the threshold are kept

The functions read the gate tensors of a family from ``gates``: any object
with the per-level tensor lists ``betas``, ``ema``, ``ema_var``,
``mask_values``, ``log_thetas`` and ``log_var``, each None where the family
lacks it (a :class:`Gates`, a model, or the trainer's views into its flat
vector).  Noise is an argument, never drawn here: the level's u ~ U[0, 1)
(straight-through) or xi ~ N(0, 1) (variational), shaped like the gate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# Molchanov variational-dropout KL constants
_K1, _K2, _K3 = 0.63576, 1.87320, 1.48695

# every per-level gate field, trainable ones first
FIELDS = ('betas', 'mask_values', 'log_thetas', 'log_var', 'ema', 'ema_var')
_ST = ('straight_through', 'masked_straight_through')
# the straight-through clip's bounds: 0-dim tensors that the ops take on any
# device; min(max(x, -1), 1) passes half the gradient at a bound, as the JAX
# package's clip does (its mask_values start there, at 1)
_LO, _HI = torch.tensor(-1.0), torch.tensor(1.0)


@dataclasses.dataclass
class Gates:
    """The gate tensors of one model: one list per field, one tensor per
    level; None where the family lacks the field."""
    betas: Optional[List[torch.Tensor]] = None
    mask_values: Optional[List[torch.Tensor]] = None
    log_thetas: Optional[List[torch.Tensor]] = None
    log_var: Optional[List[torch.Tensor]] = None
    ema: Optional[List[torch.Tensor]] = None
    ema_var: Optional[List[torch.Tensor]] = None


def is_variational(drop_type: str) -> bool:
    return bool(drop_type) and 'variational' in drop_type


def is_dynamic(drop_type: str) -> bool:
    """Dynamic variational: log-sigma from the variance model."""
    return is_variational(drop_type) and 'dynamic' in drop_type


def check_drop_type(drop_type: str):
    """Raise unless ``drop_type`` is '' (no gates) or a known family."""
    if drop_type not in ('', 'smallify') + _ST and not is_variational(drop_type):
        raise ValueError(f"unknown drop_type {drop_type!r}")


def trainable_fields(drop_type: str) -> Tuple[str, ...]:
    """The fields the family trains, in the trainer's order."""
    check_drop_type(drop_type)
    if drop_type == 'smallify':
        return ('betas',)
    if drop_type in _ST:
        return ('mask_values',)
    if is_variational(drop_type):
        return ('log_thetas', 'log_var')
    return ()


def noise_kind(drop_type: str) -> Optional[str]:
    """'uniform', 'normal' or None: the noise ``apply_gate`` takes."""
    if drop_type == 'straight_through':
        return 'uniform'
    return 'normal' if is_variational(drop_type) else None


def fields_of(gates) -> Dict[str, Optional[List[torch.Tensor]]]:
    """Every gate field of ``gates`` as a list (or None)."""
    out = {}
    for name in FIELDS:
        ts = getattr(gates, name, None)
        out[name] = None if ts is None else list(ts)
    return out


def init_gates(generator: torch.Generator, drop_type: str,
               coeff_shapes: Sequence[Tuple[int, ...]],
               drop_momentum: float = 0.025) -> Optional[Gates]:
    """The family's gates for the given coefficient shapes (None without
    gates).  Smallify: betas ~ N(0, 1) from ``generator``, the tracker at
    ema = sign(betas), ema_var = 0.  Straight-through: mask_values = 1.
    Variational: log_thetas = 0, log_var = log(p / (1 - p)) with
    p = ``drop_momentum`` (the reference passes drop_momentum as the initial
    dropout rate)."""
    check_drop_type(drop_type)
    if not drop_type:
        return None
    sizes = [tuple(s[1:]) for s in coeff_shapes]
    if drop_type == 'smallify':
        betas = [torch.randn(s, generator=generator) for s in sizes]
        return Gates(betas=betas, ema=[torch.sign(b) for b in betas],
                     ema_var=[torch.zeros(s) for s in sizes])
    if drop_type in _ST:
        return Gates(mask_values=[torch.ones(s) for s in sizes])
    log_alpha0 = math.log(drop_momentum / (1.0 - drop_momentum))
    return Gates(log_thetas=[torch.zeros(s) for s in sizes],
                 log_var=[torch.full(s, log_alpha0) for s in sizes])


def _need(noise, drop_type):
    if noise is None:
        raise ValueError(f"drop_type {drop_type!r} needs the level's noise")
    return noise


def apply_gate(drop_type: str, gates, level: int, coeff: torch.Tensor,
               noise: Optional[torch.Tensor], threshold: float) -> torch.Tensor:
    """Gate one (F, *size) coefficient tensor during training.  ``noise``:
    the level's noise (None for the deterministic families); ``threshold``:
    the level's (masked straight-through's forward mask)."""
    if drop_type == 'smallify':
        # coeff * betas (no inverse scaling)
        return coeff * gates.betas[level][None]
    if drop_type == 'straight_through':
        # forward: the Bernoulli sample u < mask_values; backward: the
        # gradient into mask_values through hardtanh (a working STE)
        mv = gates.mask_values[level]
        hard = (_need(noise, drop_type) < mv).to(coeff.dtype)
        soft = torch.minimum(torch.maximum(mv, _LO), _HI)
        return coeff * (hard + soft - soft.detach())[None]
    if drop_type == 'masked_straight_through':
        # (x * (m >= t) - x * m).detach() + x * m, m = sigmoid(mask_values)
        m = torch.sigmoid(gates.mask_values[level])[None]
        hard = coeff * (m >= threshold).to(coeff.dtype)
        soft = coeff * m
        return (hard - soft).detach() + soft
    if is_variational(drop_type):
        # x * (theta + sigma * xi)
        thetas = torch.exp(gates.log_thetas[level])
        sigma = torch.exp(gates.log_var[level] / 2.0)
        return coeff * (thetas + sigma * _need(noise, drop_type))[None]
    raise ValueError(f"unknown drop_type {drop_type!r}")


def smallify_update_tracker(ema: Sequence[torch.Tensor],
                            ema_var: Sequence[torch.Tensor],
                            betas: Sequence[torch.Tensor], momentum: float
                            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One EMA sign-variance step over all levels:

        ema     <- ema + m * (sign(beta) - ema)
        ema_var <- (1 - m) * (ema_var + m * (sign(beta) - ema_old)^2)
    """
    new_ema, new_var = [], []
    for b, e, var in zip(betas, ema, ema_var):
        phi = torch.sign(b) - e
        new_ema.append(e + momentum * phi)
        new_var.append((1.0 - momentum) * (var + momentum * phi * phi))
    return new_ema, new_var


def l1_penalty(drop_type: str, gates) -> torch.Tensor:
    """Sum of |gate| over all levels (smallify and straight-through)."""
    if drop_type == 'smallify':
        arrs = gates.betas
    elif drop_type in _ST:
        arrs = gates.mask_values
    else:
        raise ValueError(f"drop_type {drop_type!r} has no L1 penalty")
    return sum(torch.sum(torch.abs(a)) for a in arrs)


def variational_dkl(gates) -> torch.Tensor:
    """The Molchanov KL approximation summed over all levels."""
    total = 0.0
    for lt, lv in zip(gates.log_thetas, gates.log_var):
        log_alpha = lv - 2.0 * lt
        t1 = _K1 * torch.sigmoid(_K2 + _K3 * log_alpha)
        t2 = 0.5 * F.softplus(-log_alpha)
        total = total + torch.sum(-t1 + t2 + _K1)
    return total


def variational_dropout_rates(gates, level: int) -> torch.Tensor:
    """alpha / (1 + alpha), alpha = exp(log_var - 2 log_theta)."""
    alphas = torch.exp(gates.log_var[level] - 2.0 * gates.log_thetas[level])
    return alphas / (1.0 + alphas)


def _keep_one(m: torch.Tensor) -> torch.Tensor:
    """m with its first entry set to 1 where m is all 0 (no host read)."""
    flat = m.reshape(-1).clone()
    flat[0] = torch.where(flat.any(), flat[0], torch.ones_like(flat[0]))
    return flat.view(m.shape)


def pruning_masks(drop_type: str, gates,
                  thresholds: Sequence[float]) -> List[torch.Tensor]:
    """Binary keep-masks per level (float32)."""
    masks = []
    for lvl, t in enumerate(thresholds):
        if drop_type == 'smallify':
            v = gates.ema_var[lvl]
            m = torch.where(v < t, 1.0, 0.0).to(v.dtype)
        elif drop_type == 'straight_through':
            m = (gates.mask_values[lvl] > t).float()
        elif drop_type == 'masked_straight_through':
            m = (torch.sigmoid(gates.mask_values[lvl]) >= t).float()
        elif is_variational(drop_type):
            rates = variational_dropout_rates(gates, lvl)
            # each level keeps at least one element
            m = _keep_one(torch.where(rates < t, 1.0, 0.0).to(rates.dtype))
        else:
            raise ValueError(f"unknown drop_type {drop_type!r}")
        masks.append(m)
    return masks


def bake_values(drop_type: str, gates, coeffs: Sequence[torch.Tensor],
                thresholds: Sequence[float]) -> List[torch.Tensor]:
    """coeff * (mask * gate value) for every level:

    smallify      coeff * (mask * betas)
    straight      coeff * mask
    masked ST     (hard - soft) + soft at the threshold, as the STE forward
    variational   coeff * (mask * exp(log_thetas))
    """
    masks = pruning_masks(drop_type, gates, thresholds)
    out = []
    for lvl, (c, m) in enumerate(zip(coeffs, masks)):
        if drop_type == 'smallify':
            out.append(c * (m * gates.betas[lvl])[None])
        elif drop_type == 'straight_through':
            out.append(c * m[None])
        elif drop_type == 'masked_straight_through':
            s = torch.sigmoid(gates.mask_values[lvl])[None]
            hard = c * (s >= thresholds[lvl]).to(c.dtype)
            soft = c * s
            # == hard up to a rounding, which is kept as the JAX package has it
            out.append((hard - soft) + soft)
        else:
            out.append(c * (m * torch.exp(gates.log_thetas[lvl]))[None])
    return out


def gate_size(drop_type: str, gates) -> int:
    """Number of gate values, i.e. of stored mask bits (0 without gates)."""
    fields = trainable_fields(drop_type)
    if not fields or gates is None or getattr(gates, fields[0], None) is None:
        return 0
    return int(sum(a.numel() for a in getattr(gates, fields[0])))
