"""Full-volume reconstruction and deviation statistics (port of the JAX
package's ``eval/reconstruct.py``).

The volume is evaluated in flat row-major chunks of 2^18 voxels: the feature
grid is decoded once, made channel-minor once, and every chunk's lattice
coordinates are made on the device (``ix = lin // (Y*Z)``, then normalized to
[-1, 1] and scaled by the anisotropy scales), fetched through the trilinear
kernel, embedded and run through the MLP, and clamped to [-1, 1].  On the card
the fetch is the CUDA kernel; nothing is copied to the host but the result.
As in the JAX evaluation, this path keeps the fetch and the plain MLP
whatever the spec's ``interp_backend`` and ``mlp_backend``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..data.volume import VolumeMeta
from ..device import resolve_device
from ..models.feature_grid import FeatureGridModel, decode_volume, predict_trilinear
from ..ops.interpolation import channel_minor

CHUNK = 1 << 18


def lattice_chunk(meta: VolumeMeta, start: int, chunk: int,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized, scaled lattice coordinates (chunk, 3) of the flat voxels
    start .. start+chunk-1, and their validity mask: voxels past the end are
    clamped to the last one and marked invalid."""
    X, Y, Z = meta.resolution
    n = meta.n_voxels
    lin = start + torch.arange(chunk, device=device, dtype=torch.int64)
    valid = lin < n
    lin = lin.clamp(max=n - 1)
    iz = lin % Z
    iy = (lin // Z) % Y
    ix = lin // (Y * Z)
    raw = torch.stack([ix, iy, iz], dim=1).to(torch.float32)
    max_idx = torch.as_tensor(meta.max_idx, device=device)
    scales = torch.as_tensor(meta.scales, device=device)
    c = (raw / max_idx) * 2.0 - 1.0
    return c * scales, valid


@torch.no_grad()
def field_from_net(model: FeatureGridModel, meta: VolumeMeta,
                   chunk: int = CHUNK,
                   device: str | torch.device = 'cuda') -> np.ndarray:
    """Reconstruct the full volume on ``device``; returns (X, Y, Z) float32."""
    dev = resolve_device(device)
    model = model.to(dev)
    grid_cl = channel_minor(decode_volume(model))
    n = meta.n_voxels
    out = torch.empty(math.ceil(n / chunk) * chunk, device=dev)
    for start in range(0, n, chunk):
        c, _ = lattice_chunk(meta, start, chunk, dev)
        out[start:start + chunk] = predict_trilinear(model, grid_cl, c)[:, 0]
    return out[:n].cpu().numpy().reshape(meta.resolution)


@torch.no_grad()
def eval_stats_on_device(model: FeatureGridModel, meta: VolumeMeta,
                         volume_dev: torch.Tensor, chunk: int = CHUNK,
                         device: str | torch.device = 'cuda'):
    """PSNR/L1/MSE/RMSE with the sums taken on the device: only four scalars
    come back.  Two-level float32 accumulation (per chunk, then over chunks);
    the PSNR range is that of the whole ground-truth volume."""
    dev = resolve_device(device)
    model = model.to(dev)
    vol = volume_dev.to(dev, torch.float32)
    grid_cl = channel_minor(decode_volume(model))
    n = meta.n_voxels
    n_chunks = math.ceil(n / chunk)
    flat = torch.nn.functional.pad(vol.reshape(-1), (0, n_chunks * chunk - n))
    sums = torch.empty((n_chunks, 2), device=dev)
    for k in range(n_chunks):
        start = k * chunk
        c, valid = lattice_chunk(meta, start, chunk, dev)
        pred = predict_trilinear(model, grid_cl, c)[:, 0]
        diff = torch.where(valid, flat[start:start + chunk] - pred, 0.0)
        sums[k, 0] = torch.sum(diff * diff)
        sums[k, 1] = torch.sum(diff.abs())
    total = sums.sum(dim=0)
    stats = torch.stack([total[0], total[1], vol.max() - vol.min()])
    sum_sq, sum_abs, rng = (float(v) for v in stats.cpu())
    mse = sum_sq / n
    l1 = sum_abs / n
    psnr = 10.0 * math.log10((rng * rng) / mse) if mse > 0 else float('inf')
    return psnr, l1, mse, math.sqrt(mse)


def deviation_statistics(prediction: np.ndarray, ground_truth: np.ndarray):
    """PSNR/L1/MSE/RMSE in float64 on the host; PSNR over the GT range."""
    diff = ground_truth.astype(np.float64) - prediction.astype(np.float64)
    sqd_max_diff = float((ground_truth.max() - ground_truth.min()) ** 2)
    l1 = float(np.abs(diff).mean())
    mse = float((diff ** 2).mean())
    psnr = float(10.0 * np.log10(sqd_max_diff / mse))
    return psnr, l1, mse, math.sqrt(mse)


def tiled_net_out(model: FeatureGridModel, meta: VolumeMeta,
                  gt_vol: Optional[np.ndarray] = None, evaluate: bool = True,
                  write_vols: bool = False, filename: str = 'vol',
                  device: str | torch.device = 'cuda',
                  gt_dev: Optional[torch.Tensor] = None):
    """Reconstruct, optionally compute stats and write .vti volumes.

    Without volume files the stats come from :func:`eval_stats_on_device`
    on ``gt_dev`` (the ground truth already on the device) when given, else
    on ``gt_vol``; with them, the field comes to the host and the stats are
    taken there in float64 against ``gt_vol``."""
    dev = resolve_device(device)
    if evaluate and not write_vols and (gt_dev is not None or gt_vol is not None):
        vol = gt_dev if gt_dev is not None else torch.from_numpy(
            np.ascontiguousarray(gt_vol, dtype=np.float32))
        return eval_stats_on_device(model, meta, vol, device=dev)
    full_vol = field_from_net(model, meta, device=dev)
    psnr, l1, mse, rmse = 0.0, 0.0, 0.0, 0.0
    if evaluate and gt_vol is not None:
        psnr, l1, mse, rmse = deviation_statistics(full_vol, gt_vol)
    if write_vols:
        from .vtk import write_vti
        write_vti(filename, full_vol, name='sf')
        if gt_vol is not None:
            gt_path = os.path.join(os.path.dirname(filename) or '.', 'gt')
            write_vti(gt_path, np.asarray(gt_vol), name='sf')
    return psnr, l1, mse, rmse
