"""Pruning gates over the wavelet coefficient tensors: the smallify family.

Port of the smallify parts of the JAX package's ``models/gates.py``.  One
gate tensor per coefficient tensor, shaped like it minus its leading feature
axis (the gates broadcast over the features).  Smallify learns betas that
multiply the coefficients, and tracks an exponential moving average of their
signs and its variance; after phase 1, entries whose sign variance stayed
below the level's threshold are kept and baked into the grid.

The functions take lists of tensors, one per level: ``betas`` (trainable),
``ema`` and ``ema_var`` (the tracker's state, not trained).  The other drop
types (straight-through, masked straight-through, variational) raise "not yet
ported" (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

_OTHERS = ('straight_through', 'masked_straight_through')


def _not_ported(drop_type: str) -> Exception:
    if drop_type in _OTHERS or 'variational' in drop_type:
        return ValueError(f"drop_type={drop_type!r} is not yet ported (the "
                          f"other gate families, ROADMAP Queue 1 item 2)")
    return ValueError(f"unknown drop_type {drop_type!r}")


def check_drop_type(drop_type: str):
    """Raise unless ``drop_type`` is '' (no gates) or 'smallify'."""
    if drop_type not in ('', 'smallify'):
        raise _not_ported(drop_type)


def init_gates(generator: torch.Generator, drop_type: str,
               coeff_shapes: Sequence[Tuple[int, ...]]
               ) -> Tuple[Optional[List[torch.Tensor]], ...]:
    """(betas, ema, ema_var) for the given coefficient shapes, or three
    Nones without gates.  Betas ~ N(0, 1) drawn from ``generator``; the
    tracker starts at ema = sign(betas), ema_var = 0."""
    check_drop_type(drop_type)
    if not drop_type:
        return None, None, None
    sizes = [tuple(s[1:]) for s in coeff_shapes]
    betas = [torch.randn(s, generator=generator) for s in sizes]
    ema = [torch.sign(b) for b in betas]
    ema_var = [torch.zeros(s) for s in sizes]
    return betas, ema, ema_var


def apply_gate(drop_type: str, betas: Sequence[torch.Tensor], level: int,
               coeff: torch.Tensor) -> torch.Tensor:
    """Gate one (F, *size) coefficient tensor during training: coeff * betas
    (no inverse scaling)."""
    if drop_type != 'smallify':
        raise _not_ported(drop_type)
    return coeff * betas[level][None]


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


def l1_penalty(drop_type: str, betas: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of |gate| over all levels."""
    if drop_type != 'smallify':
        raise _not_ported(drop_type)
    return sum(torch.sum(torch.abs(b)) for b in betas)


def pruning_masks(drop_type: str, ema_var: Sequence[torch.Tensor],
                  thresholds: Sequence[float]) -> List[torch.Tensor]:
    """Binary keep-masks per level: 1 where the sign variance is below the
    level's threshold."""
    if drop_type != 'smallify':
        raise _not_ported(drop_type)
    return [torch.where(v < t, 1.0, 0.0).to(v.dtype)
            for v, t in zip(ema_var, thresholds)]


def bake_values(drop_type: str, betas: Sequence[torch.Tensor],
                ema_var: Sequence[torch.Tensor], coeffs: Sequence[torch.Tensor],
                thresholds: Sequence[float]) -> List[torch.Tensor]:
    """coeff * (mask * beta) for every level."""
    masks = pruning_masks(drop_type, ema_var, thresholds)
    return [c * (m * b)[None] for c, m, b in zip(coeffs, masks, betas)]


def gate_size(drop_type: str, betas: Optional[Sequence[torch.Tensor]]) -> int:
    """Number of gate values, i.e. of stored mask bits (0 without gates)."""
    check_drop_type(drop_type)
    if not drop_type or betas is None:
        return 0
    return int(sum(b.numel() for b in betas))
