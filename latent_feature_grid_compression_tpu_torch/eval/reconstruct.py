"""Full-volume reconstruction and deviation statistics (port of the JAX
package's ``eval/reconstruct.py``).

The volume is evaluated in flat row-major chunks of 2^18 voxels: the feature
grid is decoded once and made channel-minor once, and the lattice's constants
(the chunk's offsets, ``max_idx``, ``scales``) are put on the device once,
before the chunks, as the JAX evaluation builds them outside its
``lax.map``.  One chunk body (``ChunkBody``, the counterpart of JAX's
``eval_chunk``) then computes chunk ``k`` from an int64 counter on the
device and advances it: the chunk's lattice coordinates (``ix = lin //
(Y*Z)``, normalized to [-1, 1], scaled by the anisotropy scales), the
trilinear fetch, the embedding and the MLP, clamped to [-1, 1], written at
row ``k`` of a static buffer.  Nothing in the chunk loop makes a tensor from
host data or reads one back.

On a card an evaluation of ``GRAPH_MIN_CHUNKS`` chunks or more (a 255^3
volume has 64) captures that body once as a CUDA graph (the trainer's
``capture_graph``) and each chunk is one replay, the counterpart of the JAX
evaluation's single dispatch; the graph is destroyed before the evaluation
returns or raises.  Smaller volumes, ``graphs=False`` and the CPU step the
same body eagerly (``use_eval_graphs``).  As in the JAX
evaluation, this path keeps the float32 fetch and the float32 MLP whatever
the spec's ``interp_backend`` and ``mlp_backend``: on a card, at the
published widths, the head after the fetch is one kernel a chunk
(``ops/inference_head.py``), one node of the chunk's graph.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data.volume import VolumeMeta
from ..device import resolve_device
from ..models.feature_grid import FeatureGridModel, decode_volume, predict_trilinear
from ..ops import launch_counts
from ..ops.interpolation import channel_minor
from ..utils.profiling import count, span

CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A volume's chunked lattice: its shape, and its constants on the
    device (the offsets 0 .. chunk-1 of a chunk's voxels, ``max_idx`` and
    ``scales``), made once an evaluation by :func:`lattice_constants`."""
    resolution: tuple
    n: int
    chunk: int
    offsets: torch.Tensor
    max_idx: torch.Tensor
    scales: torch.Tensor

    @property
    def n_chunks(self) -> int:
        return math.ceil(self.n / self.chunk)


def lattice_constants(meta: VolumeMeta, chunk: int, device: torch.device) -> Lattice:
    return Lattice(tuple(meta.resolution), meta.n_voxels, chunk,
                   torch.arange(chunk, device=device, dtype=torch.int64),
                   torch.as_tensor(meta.max_idx, device=device),
                   torch.as_tensor(meta.scales, device=device))


def lattice_chunk(lat: Lattice, start) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized, scaled lattice coordinates (chunk, 3) of the flat voxels
    start .. start+chunk-1, and their validity mask: voxels past the end are
    clamped to the last one and marked invalid.  ``start``: an int, or a
    one-element int64 tensor on the lattice's device."""
    X, Y, Z = lat.resolution
    lin = start + lat.offsets
    valid = lin < lat.n
    lin = lin.clamp(max=lat.n - 1)
    iz = lin % Z
    iy = (lin // Z) % Y
    ix = lin // (Y * Z)
    raw = torch.stack([ix, iy, iz], dim=1).to(torch.float32)
    c = (raw / lat.max_idx) * 2.0 - 1.0
    return c * lat.scales, valid


class ChunkBody:
    """One chunk of the evaluation (the counterpart of ``eval_chunk`` under
    the JAX evaluation's ``lax.map``): each call computes chunk ``k``, the
    int64 counter ``self.k`` on the device, and advances it, with the same
    launches on the same addresses every time.  Without ``volume`` it
    writes the chunk's field at row ``k`` of ``out`` (n_chunks, chunk);
    with the ground truth ``volume`` on the device, the chunk's
    [sum d^2, sum |d|] over its valid voxels at row ``k`` of ``out``
    (n_chunks, 2), the first level of the JAX evaluation's two-level
    float32 sums.  The grid is decoded, and the lattice's constants made,
    once, when the body is made."""

    def __init__(self, model: FeatureGridModel, meta: VolumeMeta, chunk: int,
                 device: torch.device, volume: Optional[torch.Tensor] = None):
        self.model = model
        self.lat = lattice_constants(meta, chunk, device)
        self.grid_cl = channel_minor(decode_volume(model))
        n_chunks = self.lat.n_chunks
        self.k = torch.zeros(1, dtype=torch.int64, device=device)
        self.gt = None
        if volume is None:
            self.out = torch.empty((n_chunks, chunk), device=device)
        else:
            flat = F.pad(volume.reshape(-1), (0, n_chunks * chunk - self.lat.n))
            self.gt = flat.view(n_chunks, chunk)
            self.out = torch.empty((n_chunks, 2), device=device)

    def __call__(self):
        c, valid = lattice_chunk(self.lat, self.k * self.lat.chunk)
        pred = predict_trilinear(self.model, self.grid_cl, c)[:, 0]
        if self.gt is None:
            row = pred
        else:
            diff = torch.where(valid, self.gt.index_select(0, self.k)[0] - pred, 0.0)
            row = torch.stack([torch.sum(diff * diff), torch.sum(diff.abs())])
        self.out.index_copy_(0, self.k, row[None])
        self.k.add_(1)


# the fewest chunks an evaluation replays as a graph by default: a graphed
# evaluation pays a warm-up chunk, the capture and its instantiation once,
# and saves the host's launches at every chunk.  On an H100 (700 W;
# chip_smoke.py's eval_mode_pairs, 9 rounds of pairs) the median graphed /
# eager time was 1.97, 1.51, 1.29 and 1.19 at 1, 2, 4 and 8 chunks, 0.94 at
# 16 and 0.96 at 64 (255^3)
GRAPH_MIN_CHUNKS = 16


def use_eval_graphs(graphs: Optional[bool], device, n_chunks: int) -> bool:
    """Whether an evaluation's ``n_chunks`` chunks are replays of a CUDA
    graph of its chunk body.  ``graphs`` None: on a card (on a mesh too:
    the evaluation holds no collective) from ``GRAPH_MIN_CHUNKS`` chunks
    on, else eagerly, and eagerly on the CPU; False: eagerly; True: on a
    card, and on the CPU it raises."""
    on_card = torch.device(device).type == 'cuda'
    if graphs and not on_card:
        raise ValueError(f"the evaluation's CUDA graph needs a card; got device "
                         f"{str(device)!r} (graphs=None or False on the CPU)")
    if graphs is None:
        return on_card and n_chunks >= GRAPH_MIN_CHUNKS
    return bool(graphs)


def run_chunks(body: ChunkBody, graphs: bool) -> torch.Tensor:
    """Every chunk of ``body`` from chunk 0, eagerly or (``graphs``) as
    replays of one CUDA graph of it.  The graph is captured on the body's
    card by the trainer's ``capture_graph``, into the memory pool its
    captures share (an evaluation captures at every call), after chunk 0
    run on a side stream to warm it (its launches not counted); the counter
    is rewound after the warm-up and after the capture, and each replay
    adds the launches the capture counted (``ops/launch_counts.py``).  A
    failed capture raises.  The graph is destroyed
    (``trainer.release_graph``) before this returns or raises.  Spans:
    ``eval.capture`` (the warm-up, the capture, its instantiation),
    ``eval.chunks`` (the chunks' launches; ``n`` the chunks) and
    ``eval.release`` (the wait for the card, the graph destroyed).
    Returns ``body.out``."""
    n_chunks = body.lat.n_chunks
    if not graphs:
        with span('eval.chunks', n_chunks):
            for _ in range(n_chunks):
                body()
        return body.out
    from ..train import trainer   # train/run.py imports this module
    mark = launch_counts.read()

    def warm():
        body.k.zero_()
        body()
        launch_counts.write(mark)
        body.k.zero_()
    # a process group's watchdog thread queries events while the capture
    # runs: only this thread's calls may void it then
    mode = 'thread_local' if dist.is_available() and dist.is_initialized() else 'global'
    replay = None
    try:
        with span('eval.capture'):
            try:
                replay = trainer.capture_graph(warm, body, mode, device=body.k.device)
                launches = launch_counts.since(mark)
                count('graph_captures.eval')
            finally:
                launch_counts.write(mark)
            body.k.zero_()
        with span('eval.chunks', n_chunks):
            for _ in range(n_chunks):
                replay()
                launch_counts.add(launches)
    finally:
        with span('eval.release'):
            trainer.release_graph(getattr(replay, '__self__', None))
    return body.out


@torch.no_grad()
def field_on_device(model: FeatureGridModel, meta: VolumeMeta, chunk: int = CHUNK,
                    device: str | torch.device = 'cuda',
                    graphs: Optional[bool] = None) -> torch.Tensor:
    """The full volume (X, Y, Z) float32 on ``device``; ``graphs`` as
    :func:`use_eval_graphs`.  One ``eval.call`` span, its set-up
    ``eval.setup``."""
    with span('eval.call'):
        dev = resolve_device(device)
        graphed = use_eval_graphs(graphs, dev, math.ceil(meta.n_voxels / chunk))
        with span('eval.setup'):
            body = ChunkBody(model.to(dev), meta, chunk, dev)
        out = run_chunks(body, graphed)
    return out.view(-1)[:meta.n_voxels].view(meta.resolution)


def field_from_net(model: FeatureGridModel, meta: VolumeMeta,
                   chunk: int = CHUNK,
                   device: str | torch.device = 'cuda',
                   graphs: Optional[bool] = None) -> np.ndarray:
    """Reconstruct the full volume on ``device``; returns (X, Y, Z) float32."""
    return field_on_device(model, meta, chunk, device, graphs).cpu().numpy()


@torch.no_grad()
def chunk_sums(model: FeatureGridModel, meta: VolumeMeta, volume_dev: torch.Tensor,
               chunk: int = CHUNK, device: str | torch.device = 'cuda',
               graphs: Optional[bool] = None) -> torch.Tensor:
    """Each chunk's [sum d^2, sum |d|] against the ground truth, (n_chunks,
    2) float32 on ``device``; ``graphs`` as :func:`use_eval_graphs`.  Spans
    as :func:`field_on_device`'s."""
    with span('eval.call'):
        dev = resolve_device(device)
        graphed = use_eval_graphs(graphs, dev, math.ceil(meta.n_voxels / chunk))
        with span('eval.setup'):
            body = ChunkBody(model.to(dev), meta, chunk, dev,
                             volume=volume_dev.to(dev, torch.float32))
        return run_chunks(body, graphed)


@torch.no_grad()
def eval_stats_on_device(model: FeatureGridModel, meta: VolumeMeta,
                         volume_dev: torch.Tensor, chunk: int = CHUNK,
                         device: str | torch.device = 'cuda',
                         graphs: Optional[bool] = None):
    """PSNR/L1/MSE/RMSE with the sums taken on the device: only four scalars
    come back.  Two-level float32 accumulation (per chunk, then over chunks);
    the PSNR range is that of the whole ground-truth volume."""
    dev = resolve_device(device)
    vol = volume_dev.to(dev, torch.float32)
    total = chunk_sums(model, meta, vol, chunk, dev, graphs).sum(dim=0)
    stats = torch.stack([total[0], total[1], vol.max() - vol.min()])
    sum_sq, sum_abs, rng = (float(v) for v in stats.cpu())
    n = meta.n_voxels
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
                  gt_dev: Optional[torch.Tensor] = None,
                  graphs: Optional[bool] = None):
    """Reconstruct, optionally compute stats and write .vti volumes.

    Without volume files the stats come from :func:`eval_stats_on_device`
    on ``gt_dev`` (the ground truth already on the device) when given, else
    on ``gt_vol``; with them, the field comes to the host and the stats are
    taken there in float64 against ``gt_vol``.  ``graphs`` as
    :func:`use_eval_graphs`."""
    dev = resolve_device(device)
    if evaluate and not write_vols and (gt_dev is not None or gt_vol is not None):
        vol = gt_dev if gt_dev is not None else torch.from_numpy(
            np.ascontiguousarray(gt_vol, dtype=np.float32))
        return eval_stats_on_device(model, meta, vol, device=dev, graphs=graphs)
    full_vol = field_from_net(model, meta, device=dev, graphs=graphs)
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
