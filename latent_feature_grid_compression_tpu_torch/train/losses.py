"""Loss terms of the smallify family (port of the JAX package's
``train/losses.py``, smallify parts).

The smallify loss is weight_l1 * sum |beta| over the gates plus
weight_l2 * sum ||coeff||^2 over the (ungated) wavelet coefficients; the
trainer adds it to the volume MSE in phase 1.  The variational losses come
with the other gate families (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models import gates as G


def grid_l2(coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of squared wavelet coefficients."""
    return sum(torch.sum(torch.abs(c) ** 2) for c in coeffs)


def smallify_family_loss(drop_type: str, coeffs: Sequence[torch.Tensor],
                         betas: Optional[Sequence[torch.Tensor]],
                         weight_l1: float, weight_l2: float):
    """The smallify loss (0.0 when both weights are 0)."""
    loss = 0.0
    if weight_l1 > 0.0 and betas is not None:
        loss = loss + weight_l1 * G.l1_penalty(drop_type, betas)
    if weight_l2 > 0.0:
        loss = loss + weight_l2 * grid_l2(coeffs)
    return loss
