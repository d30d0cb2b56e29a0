"""Affine quantization and the post-training quantization study (port of
the JAX package's ``ops/quantization.py``).

The study affine-quantizes the grid coefficients to int8 (scale 0.02) and
the MLP weights and biases to int32 (scale 1e-4), dequantizes them, measures
the PSNR again, and recomputes the compression ratio as if the grid took one
byte a value and the MLP two.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.volume import VolumeMeta
from ..device import resolve_device
from ..eval.reconstruct import tiled_net_out
from ..models import gates as G
from ..models.feature_grid import FeatureGridModel, num_net_params


def quantize_affine(x: torch.Tensor, scale: float, zero_point: int = 0,
                    dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """q = clip(round(x / scale) + zero_point) in ``dtype``'s range: the
    rounding is half to even, the clip in float32, then the cast."""
    info = torch.iinfo(dtype)
    q = torch.round(x / scale) + zero_point
    return torch.clamp(q, info.min, info.max).to(dtype)


def dequantize_affine(q: torch.Tensor, scale: float, zero_point: int = 0
                      ) -> torch.Tensor:
    return (q.to(torch.float32) - zero_point) * scale


def _round_trip(ts, scale: float, dtype: torch.dtype):
    return [dequantize_affine(quantize_affine(t.detach(), scale, dtype=dtype), scale)
            for t in ts]


@torch.no_grad()
def quantize_model(model: FeatureGridModel, grid_scale: float = 0.02,
                   mlp_scale: float = 1e-4) -> FeatureGridModel:
    """A new model whose coefficients went through int8 and whose MLP
    weights and biases went through int32 at these scales and back; the
    spec and the gates are copied unchanged, and ``model`` is left alone."""
    gates = {k: None if v is None else [t.detach().clone() for t in v]
             for k, v in G.fields_of(model).items()}
    return FeatureGridModel(model.spec, _round_trip(model.coeffs, grid_scale, torch.int8),
                            _round_trip(model.mlp_w, mlp_scale, torch.int32),
                            _round_trip(model.mlp_b, mlp_scale, torch.int32), **gates)


def mock_quantization_study(model: FeatureGridModel, volume_np: np.ndarray,
                            grid_scale: float = 0.02, mlp_scale: float = 1e-4,
                            device: str | torch.device = 'cuda') -> Dict[str, float]:
    """PSNR before and after quantization, and the compression ratios with
    four bytes a value (float) and with one byte a grid value and two an
    MLP value (quantized); zeros are those of ``model``'s coefficients.

    Both evaluations run on ``device`` against the ground truth uploaded
    once."""
    dev = resolve_device(device)
    meta = VolumeMeta(tuple(volume_np.shape))
    gt_dev = torch.from_numpy(np.ascontiguousarray(volume_np, dtype=np.float32)).to(dev)
    psnr = tiled_net_out(model, meta, gt_dev=gt_dev, device=dev)[0]
    psnr_q = tiled_net_out(quantize_model(model, grid_scale, mlp_scale), meta,
                           gt_dev=gt_dev, device=dev)[0]

    n_grid = sum(c.numel() for c in model.coeffs)
    zeros = int(sum(torch.count_nonzero(c == 0) for c in model.coeffs))
    n_mlp = num_net_params(model) - n_grid
    ratio_float = meta.n_voxels / (n_grid - zeros + n_mlp)
    ratio_quant = meta.n_voxels * 4.0 / ((n_grid - zeros) * 1.0 + n_mlp * 2.0)
    return {
        'psnr': psnr, 'psnr_quant': psnr_q,
        'compression_ratio': ratio_float,
        'compression_ratio_quant': ratio_quant,
        'num_grid_params': n_grid, 'num_mlp_params': n_mlp,
        'num_zeros': zeros,
    }
