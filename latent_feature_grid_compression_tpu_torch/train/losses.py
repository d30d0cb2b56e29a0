"""Loss terms of the gate families (port of the JAX package's
``train/losses.py``).

The smallify loss (smallify and both straight-through families) is
weight_l1 * sum |gate| plus weight_l2 * sum ||coeff||^2 over the (ungated)
wavelet coefficients; the trainer adds it to the volume MSE in phase 1.  The
variational loss is -(LL - w_dkl * sum DKL * scale - w_w * sum ||coeff||^2 *
scale), with a per-sample Gaussian log-likelihood at a predicted (dynamic)
or constant (static) log-sigma, and w_dkl ramped every step up to 30.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..models import gates as G


def grid_l2(coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of squared wavelet coefficients."""
    return sum(torch.sum(torch.abs(c) ** 2) for c in coeffs)


def smallify_family_loss(drop_type: str, coeffs: Sequence[torch.Tensor], gates,
                         weight_l1: float, weight_l2: float):
    """The smallify loss (0.0 when both weights are 0); ``gates`` holds the
    family's ``betas`` or ``mask_values`` (or is None)."""
    loss = 0.0
    if weight_l1 > 0.0 and gates is not None:
        loss = loss + weight_l1 * G.l1_penalty(drop_type, gates)
    if weight_l2 > 0.0:
        loss = loss + weight_l2 * grid_l2(coeffs)
    return loss


def log_likelihood_variance(predicted: torch.Tensor, ground_truth: torch.Tensor,
                            log_sigma: torch.Tensor):
    """Per-sample Gaussian log-likelihood: (LL per sample, squared error
    per sample)."""
    sq = (ground_truth - predicted) ** 2
    sigma = torch.exp(log_sigma)
    a = 1.0 / (2.0 * sigma * sigma)
    b = -(math.log(2.0 * math.pi) + 2.0 * log_sigma) / 2.0
    return a * (-sq) + b, sq


def variational_loss(coeffs: Sequence[torch.Tensor], gates, predicted: torch.Tensor,
                     ground_truth: torch.Tensor, log_sigma: torch.Tensor,
                     weight_dkl: torch.Tensor, weight_weights: float,
                     batch_scale: float, data_scale: Optional[float] = None):
    """The variational loss (the caller ramps ``weight_dkl``).

    ``batch_scale`` = n_voxels / global batch scales the KL and weight
    penalties; ``data_scale`` (default ``batch_scale``) the log-likelihood
    sum, n_voxels / the batch of this device.  ``gates`` holds
    ``log_thetas`` and ``log_var``.  Returns (loss, LL, mse, dkl term,
    weight term)."""
    if data_scale is None:
        data_scale = batch_scale
    ll, sq = log_likelihood_variance(predicted, ground_truth, log_sigma)
    mse = torch.sum(sq) / predicted.shape[0]
    ll_sum = torch.sum(ll) * data_scale
    dkl = weight_dkl * G.variational_dkl(gates) * batch_scale
    wsum = weight_weights * grid_l2(coeffs) * batch_scale
    loss = -(ll_sum - dkl - wsum)
    return loss, ll_sum, mse, dkl, wsum


def ramp_weight_dkl(weight_dkl: torch.Tensor, multiplier: float,
                    cap: float = 30.0) -> torch.Tensor:
    """w <- w * (1 + multiplier) while below ``cap``."""
    return torch.where(weight_dkl < cap, weight_dkl * (1.0 + multiplier), weight_dkl)
