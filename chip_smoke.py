#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --only build,kernel_mlp,kernel_fused

Builds the CUDA kernels from the sources in this checkout and drives the
port's paths at the full width of the flagship model
(experiment-config-files/mhd_p_smallify.txt: 16 features on a 15^3 grid,
db2, 2 Fourier frequencies, 4 x 32 SnakeAlt MLP, batch 2048 x 16): the
decompression path with random weights from a seed, point queries, and the
training path through train_torch.py under each backend (the fetch kernels
with the MLP as PyTorch ops; --mlp_backend pallas, the fused MLP kernels;
--interp_backend fused, the one-kernel forward).  Phases, each printing one
JSON line, in order:

  1. device      card name, and its name and power limit from nvidia-smi
  2. build       nvcc of every csrc/*.cu (started together), seconds, ptxas
  3. kernel      the trilinear fetch kernel against its plain PyTorch version
                 (max |diff| <= 1e-5) and F.grid_sample (<= 1e-4) at grids
                 4..62 on random coordinates, and at the flagship shape on a
                 chunk of the 255^3 lattice; kernel, plain, library and
                 bound times
  4. kernel_bwd  the grid-gradient kernel against its plain version
                 (max |diff| <= 1e-5 * max |dG|: atomics add in a
                 run-dependent order) at the flagship shape on the trainer's
                 positions and at grids 4..62; kernel, plain, library
                 (aten grid_sampler_3d_backward) and bound times
  5. kernel_mlp  the fused MLP kernels (forward, backward) against their
                 plain versions in 'bf16' and 'f32': at the flagship widths
                 (31 -> 4 x 32 -> 1) on one train step's batch through a real
                 fetch, and at widths 128 -> 3 x 128 -> 4 and 19 -> 2 x 24 -> 3;
                 dW and db bitwise equal in a second call; kernel, plain,
                 library (the default route's mlp_apply on cuBLAS, forward
                 and forward + autograd backward) and bound times; the
                 forward's and the backward's tile, shared memory and blocks
  6. kernel_fused  the one-kernel forward and backward likewise, in 'mixed'
                 and 'f32', on the flagship grid (trainer and uniform
                 coordinates) and a C = 8, 9^3, 3 x 16 model; also against
                 the fetch kernel + embedding + MLP kernel route ('f32' to
                 1e-6, 'mixed' to the bf16 tolerance);
                 library = the default route (fetch kernel, fourier_embed,
                 torch.cat, mlp_apply), forward and forward + backward
  7. checkpoint  infer_torch.py --reconstruct checkpoint over the 255^3
                 mhd_like volume: 64 kernel launches, field in [-1, 1],
                 on-device PSNR = float64 host PSNR to 1e-3 dB, kernel field
                 = plain field to 5e-5; voxels/s and the time split
  8. binary      restore of tests/fixtures/golden_ref_container against its
                 recorded parameters, and a 64^3 reconstruction
  9. queries     4 requests of 2^18 points through apply_model(train=False),
                 under each backend (queries, queries_mlp_pallas,
                 queries_fused), against the plain versions of that path
 10. train       train_torch.py on mhd_p_smallify.txt over the same volume,
                 cut to max_pass = 3 (widths, batch and volume as published):
                 both phases, bake, prune, evaluation and export; each
                 kernel of the path launched once a step (the fetch also
                 once an evaluation chunk), the loss falls, PSNR finite, the
                 exported container restores; the device idle share of 50
                 steps under torch.profiler.  Then train_mlp_pallas and
                 train_fused: the same under each kernel backend, PSNR
                 within 1 dB of train's, samples/s beside train's
 11. step_rates  the flagship step time of each backend without the
                 profiler, 5 rounds of 100 steps, the backends in turns
 12. kernels     one line {"kernels": [...]} for every ported kernel

Every count of launches is set to 0 just before a path is driven and read
just after it.  Every failure raises, so the script exits non-zero and
prints no result.  It exits non-zero at once when CUDA is not available.
The last line is {"ok": true, "device": {...}}.

``--only`` takes a comma-separated list of phases 2-11 (build, kernel,
kernel_bwd, kernel_mlp, kernel_fused, checkpoint, binary, queries, train,
step_rates) and runs the device phase and those, in the order above, with
the same checks; the kernels line and the ok line need every phase, so a
partial run prints neither (a quick loop on one kernel, never the smoke).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from latent_feature_grid_compression_tpu_torch.data.synthetic import synth_volume
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta, load_volume
from latent_feature_grid_compression_tpu_torch.device import disable_tf32
from latent_feature_grid_compression_tpu_torch.eval.reconstruct import (
    CHUNK, eval_stats_on_device, field_from_net, lattice_chunk)
from latent_feature_grid_compression_tpu_torch.config import load_config
from latent_feature_grid_compression_tpu_torch.io.checkpoint import save_checkpoint
from latent_feature_grid_compression_tpu_torch.io.container import restore_model
from latent_feature_grid_compression_tpu_torch.models.feature_grid import (
    FeatureGridModel, apply_model, decode_volume, init_model, make_spec)
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as ff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf
from latent_feature_grid_compression_tpu_torch.ops.embedding import fourier_embed
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    channel_minor, grid_sample_channel_minor, grid_sample_channel_minor_backward)
from latent_feature_grid_compression_tpu_torch.ops.mlp import mlp_apply
from latent_feature_grid_compression_tpu_torch.train import trainer as tr

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures')

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # dense, tensor cores

FLAGSHIP = dict(d_in=3, hidden=32, d_out=1, num_layers=4, n_freqs=2,
                grid_features=16, grid_size=15, wavelet='db2')
FLAGSHIP_CONFIG = os.path.join(REPO, 'experiment-config-files', 'mhd_p_smallify.txt')
VOLUME_N = 255
SEED = 0
TRAIN_MAX_PASS = 3    # the published 60 passes cut to 3: 1013 + 507 steps
TRAIN_BATCH = 2048 * 16
KERNEL_TOL = 1e-5     # same formula in f32, another summation order
# relative to max |dG|: the atomics add in an order that changes per run
BWD_KERNEL_TOL = 1e-5
LIBRARY_TOL = 1e-4    # F.grid_sample rounds its own pixel map and weights
FIELD_TOL = 5e-5      # kernel vs plain through the MLP
PSNR_TOL_DB = 1e-3
# the MLP kernels against their plain versions, relative to max |.|
# (forward, gradients): float32 sums in another order (dW, db over 32,768
# samples; dG by atomics); with bf16 operands a float32 sum that lands on the
# other side of a bf16 rounding boundary moves one operand by 2^-8 of itself
MLP_TOL = {'f32': (1e-5, 1e-4), 'bf16': (1e-2, 1e-2)}
# a gradient summed over the batch can cancel to far below its terms (of
# order one): its error is held against at least 1
GRAD_FLOOR = 1.0
# the one-kernel forward in 'f32' against the fetch kernel + embedding + MLP
# kernel route: the same arithmetic but torch's sin/cos for the embedding
ROUTE_TOL = 1e-6
PSNR_BACKEND_DB = 1.0  # a kernel backend's train-3 PSNR against the default's
MLP_WIDTHS = ([128, 128, 128, 128, 4], [19, 24, 24, 3])
# backends of the paths: make_spec options and train_torch.py flags
BACKENDS = {'': ({}, []),
            '_mlp_pallas': (dict(mlp_backend='pallas'), ['--mlp_backend', 'pallas']),
            '_fused': (dict(interp_backend='fused'), ['--interp_backend', 'fused'])}
# at least ~10 ms of spinning at the H100's clock, and at least twice the
# host's time to enqueue the calls of one timed run (measured in time_ms)
SPIN_CYCLES = 20_000_000
SPIN_CYCLES_PER_MS = 2_000_000   # the SM clock is below 2 GHz


def emit(obj):
    print(json.dumps(obj), flush=True)


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    gs.launches = gs.bwd_launches = 0
    mf.launches = mf.bwd_launches = 0
    ff.launches = ff.bwd_launches = 0


def read_counts():
    return {gs.KERNEL: gs.launches, gs.BWD_KERNEL: gs.bwd_launches,
            'mlp_fused_fwd': mf.launches, 'mlp_fused_bwd': mf.bwd_launches,
            'fused_forward_fwd': ff.launches, 'fused_forward_bwd': ff.bwd_launches}


def only(launches):
    """The counts a path should leave: these, every other kernel 0."""
    return {**dict.fromkeys(read_counts(), 0), **launches}


def rel(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), floor)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def time_ms(fn, reps=25, inner=10, warmup=3):
    """Device time of one call: the median over ``reps`` runs of CUDA events
    around ``inner`` back-to-back calls, divided by ``inner``.  Each run is
    queued behind a spin kernel that lasts at least twice as long as the
    host takes to enqueue the run (measured once), so the card starts it
    only once the host has launched every call: the host's launch time does
    not show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    spin = max(SPIN_CYCLES, int(2 * host_ms * SPIN_CYCLES_PER_MS))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def fetch_bound_ms(n, C, D, H, W):
    """Least time for one fetch: the bytes it must move (coords read, output
    written, grid read once) and its float32 operations (8 corners x C
    FMAs, plus the pixel map and weights), whichever takes longer."""
    nbytes = 4 * (n * (3 + C) + D * H * W * C)
    ops = n * (2 * 8 * C + 40)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def grad_bound_ms(n, C, D, H, W):
    """Least time for one grid gradient: the bytes it must move (coords and
    g read, the gradient written once) and its float32 operations (8
    corners x C multiply-adds, plus the pixel map and weights)."""
    nbytes = n * (12 + 4 * C) + 4 * D * H * W * C
    ops = n * (2 * 8 * C + 40)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def mlp_bound_ms(n, dims, precision, backward=False, fetch=None):
    """Least time for one call of the fused MLP (fetch None) or of the
    one-kernel forward (fetch = (C, D, H, W)), forward or backward: the
    larger of its bytes over the memory rate and its operations over the
    peak rate of their type.  Bytes: each input read once, each output
    written once (x and the output, or the coordinates, the grid and the
    output; the parameters; backward also g and dX or dG, and the parameter
    gradients).  Operations: the products, 2 n K M a layer and three times
    that backward (recompute, dW, dX), at the bf16 tensor-core rate for bf16
    operands and the float32 rate otherwise; in float32 the activation (4 an
    entry), the fetch (16 C + 40 a sample) and the 12 sin/cos of the
    embedding, twice each backward."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = macs + sum(dims[1:])
    twice = 2 if backward else 1
    f32_ops = n * sum(dims[1:-1]) * 4
    if fetch is None:
        nbytes = 4 * (n * dims[0] * twice + n * dims[-1] + params * twice)
    else:
        C, D, H, W = fetch
        nbytes = 4 * (n * 3 + n * dims[-1] + (D * H * W * C + params) * twice)
        f32_ops += n * (16 * C + 40 + 12)
    peak = PEAK_BF16_FLOPS if precision in ('bf16', 'mixed') else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = (3 if backward else 1) * 2 * n * macs / peak + twice * f32_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def autograd_ms(fn, leaves, grad):
    """Device time of fn(*leaves) and its autograd backward for the output
    gradient ``grad``."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]

    def run():
        torch.autograd.grad(fn(*leaves), leaves, grad)
    return time_ms(run)


# ---------------------------------------------------------------------------
# plain versions of the paths, on the card (the kernel's plain twin in place
# of the kernel)
# ---------------------------------------------------------------------------

def plain_predict(model, grid_cl, coords):
    feats = grid_sample_channel_minor(grid_cl, coords)
    x = torch.cat([coords, fourier_embed(coords, model.spec.n_freqs), feats], dim=-1)
    return mlp_apply(list(model.mlp_w), list(model.mlp_b), x).clamp(-1.0, 1.0)


@torch.no_grad()
def plain_field(model, meta):
    grid_cl = channel_minor(decode_volume(model))
    n = meta.n_voxels
    out = torch.empty(math.ceil(n / CHUNK) * CHUNK, device='cuda')
    for start in range(0, n, CHUNK):
        c, _ = lattice_chunk(meta, start, CHUNK, torch.device('cuda'))
        out[start:start + CHUNK] = plain_predict(model, grid_cl, c)[:, 0]
    return out[:n].reshape(meta.resolution)


@torch.no_grad()
def time_split(model, meta, vol_dev):
    """Per-stage device time of one full-volume evaluation, with CUDA events
    between the stages of the same loop eval_stats_on_device runs."""
    dev = torch.device('cuda')
    n = meta.n_voxels
    n_chunks = math.ceil(n / CHUNK)
    stages = ('decode', 'lattice', 'fetch', 'mlp', 'stats')
    ms = dict.fromkeys(stages, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(1 + 4 * n_chunks + 1)]
    flat = F.pad(vol_dev.reshape(-1), (0, n_chunks * CHUNK - n))
    k = 0
    ev[k].record()
    grid_cl = channel_minor(decode_volume(model))
    k += 1
    ev[k].record()
    marks = [('decode', 0, 1)]
    for j in range(n_chunks):
        start = j * CHUNK
        c, valid = lattice_chunk(meta, start, CHUNK, dev)
        ev[k + 1].record()
        feats = gs.fetch(grid_cl, c)
        ev[k + 2].record()
        x = torch.cat([c, fourier_embed(c, model.spec.n_freqs), feats], dim=-1)
        pred = mlp_apply(list(model.mlp_w), list(model.mlp_b), x).clamp(-1.0, 1.0)
        ev[k + 3].record()
        diff = torch.where(valid, flat[start:start + CHUNK] - pred[:, 0], 0.0)
        torch.stack([torch.sum(diff * diff), torch.sum(diff.abs())])
        ev[k + 4].record()
        marks += [('lattice', k, k + 1), ('fetch', k + 1, k + 2),
                  ('mlp', k + 2, k + 3), ('stats', k + 3, k + 4)]
        k += 4
    torch.cuda.synchronize()
    for name, a, b in marks:
        ms[name] += ev[a].elapsed_time(ev[b])
    return ms


def profile_eval(model, meta, vol_dev):
    """Device busy share of one full-volume evaluation and its heaviest
    device kernels, from torch.profiler (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_stats_on_device(model, meta, vol_dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'device_idle_share': 1.0 - busy_ms / wall_ms if busy_ms else None,
            'fetch_kernel_ms': sum(r[0] for r in rows if 'grid_sample_fwd' in r[1]),
            'top_kernels': [{'ms': ms, 'name': k[:80], 'calls': n}
                            for ms, k, n in rows[:8]]}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({'phase': 'device', 'name': name, 'count': torch.cuda.device_count(),
          'nvidia_smi': smi, 'torch': torch.__version__,
          'cuda': torch.version.cuda})
    return name, smi


def ptxas_summary(log):
    """Registers and spill stores of each compiled entry, from ``-Xptxas -v``."""
    entries, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {'entry': m.group(1)}
            entries.append(cur)
        elif cur is not None:
            m = re.search(r'Used (\d+) registers', ln)
            if m:
                cur['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes spill stores', ln)
            if m:
                cur['spill_store_bytes'] = int(m.group(1))
    return entries


def phase_build():
    t0 = time.perf_counter()
    report = _build.build(_build.kernel_sources())
    seconds = time.perf_counter() - t0
    emit({'phase': 'build', 'seconds': seconds,
          'built': {k: v['built'] for k, v in report.items()},
          'ptxas': {k: ptxas_summary(v['ptxas']) for k, v in report.items()}})


@torch.no_grad()
def phase_kernel():
    """Kernel vs plain vs F.grid_sample at the NAS range of grids, on
    uniform random coordinates (out-of-range ones included), and at the
    flagship shape on the coordinates the main path gives it: one chunk of
    the 255^3 lattice, whose neighbouring samples share grid corners."""
    g = torch.Generator(device='cuda').manual_seed(SEED)
    n = CHUNK
    rows = []
    cases = [(16, 4), (16, 15), (16, 22), (16, 23), (16, 32), (16, 62),
             (5, 15), (32, 15)]
    for C, G, kind in [(C, G, 'uniform') for C, G in cases] + [(16, 15, 'lattice')]:
        feats = torch.randn((C, G, G, G), device='cuda', generator=g)
        if kind == 'uniform':
            coords = torch.rand((n, 3), device='cuda', generator=g) * 2.4 - 1.2
        else:
            coords, _ = lattice_chunk(VolumeMeta((VOLUME_N,) * 3), 32 * n, n,
                                      torch.device('cuda'))
        grid_cl = channel_minor(feats)
        out = gs.grid_sample_channel_minor_cuda(grid_cl, coords)
        plain = grid_sample_channel_minor(grid_cl, coords)
        lib = F.grid_sample(feats[None], coords.view(1, n, 1, 1, 3),
                            mode='bilinear', padding_mode='zeros',
                            align_corners=False).view(C, n).t()
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        err_lib = (out - lib).abs().max().item()
        case = f'C={C}, G={G}, {kind} coords'
        check(bool(torch.isfinite(out).all()), f'non-finite kernel output ({case})')
        check(err <= KERNEL_TOL, f'kernel vs plain {err} > {KERNEL_TOL} ({case})')
        check(err_lib <= LIBRARY_TOL,
              f'kernel vs F.grid_sample {err_lib} > {LIBRARY_TOL} ({case})')
        bound, bound_by = fetch_bound_ms(n, C, G, G, G)
        row = {'phase': 'kernel', 'name': gs.KERNEL, 'C': C, 'grid': G, 'n': n,
               'coords': kind, 'max_abs_err': err, 'max_abs_err_library': err_lib,
               'kernel_ms': time_ms(lambda: gs.grid_sample_channel_minor_cuda(grid_cl, coords)),
               'plain_ms': time_ms(lambda: grid_sample_channel_minor(grid_cl, coords)),
               'library_ms': time_ms(lambda: F.grid_sample(
                   feats[None], coords.view(1, n, 1, 1, 3), mode='bilinear',
                   padding_mode='zeros', align_corners=False)),
               'bound_ms': bound, 'bound_by': bound_by}
        emit(row)
        rows.append(row)
    return rows


def trainer_positions(n, generator):
    """(n, 3) coordinates drawn as the trainer draws them on the 255^3
    volume: IID voxel indices, normalized (isotropic: scale 1)."""
    pos = torch.randint(0, VOLUME_N, (n, 3), generator=generator, device='cuda',
                        dtype=torch.int32)
    return (pos.to(torch.float32) / (VOLUME_N - 1)) * 2.0 - 1.0


def phase_kernel_bwd():
    """Gradient kernel vs plain vs aten's grid_sampler_3d_backward, at one
    train step's batch: the flagship shape on the trainer's positions, then
    the NAS range of grids on uniform random coordinates."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 2)
    n = TRAIN_BATCH
    rows = []
    cases = [(16, 15, 'trainer')] + [(16, G, 'uniform') for G in (4, 22, 23, 32, 62)]
    for C, G, kind in cases:
        if kind == 'trainer':
            coords = trainer_positions(n, g)
        else:
            coords = torch.rand((n, 3), device='cuda', generator=g) * 2.4 - 1.2
        grad = torch.randn((n, C), device='cuda', generator=g)
        out = gs.grid_sample_channel_minor_backward_cuda(grad, coords, G, G, G)
        plain = grid_sample_channel_minor_backward(grad, coords, G, G, G)
        # aten's backward of F.grid_sample, asking for the input's gradient
        # only; its (N, C) -> (1, C, N, 1, 1) layouts are made once here
        feats = torch.empty((1, C, G, G, G), device='cuda')
        grad_out = grad.t().reshape(1, C, n, 1, 1).contiguous()
        grid5 = coords.view(1, n, 1, 1, 3)

        def library():
            return torch.ops.aten.grid_sampler_3d_backward(
                grad_out, feats, grid5, 0, 0, False, [True, False])

        lib_in, lib_grid = library()
        torch.cuda.synchronize()
        scale = plain.abs().max().item()
        err = (out - plain).abs().max().item()
        err_lib = (out - lib_in[0].permute(1, 2, 3, 0)).abs().max().item()
        case = f'C={C}, G={G}, {kind} coords'
        check(bool(torch.isfinite(out).all()), f'non-finite gradient ({case})')
        check(err <= BWD_KERNEL_TOL * scale,
              f'gradient kernel vs plain {err} > {BWD_KERNEL_TOL} * {scale} ({case})')
        check(err_lib <= 1e-4 * scale, f'gradient kernel vs aten {err_lib} ({case})')
        bound, bound_by = grad_bound_ms(n, C, G, G, G)
        row = {'phase': 'kernel_bwd', 'name': gs.BWD_KERNEL, 'C': C, 'grid': G,
               'n': n, 'coords': kind, 'max_abs_err': err, 'max_abs_dG': scale,
               'max_abs_err_library': err_lib,
               'library_skipped_grid_grad': lib_grid is None or lib_grid.numel() == 0,
               'atomics': n * 8 * C,
               'kernel_ms': time_ms(lambda: gs.grid_sample_channel_minor_backward_cuda(
                   grad, coords, G, G, G)),
               'plain_ms': time_ms(lambda: grid_sample_channel_minor_backward(
                   grad, coords, G, G, G)),
               'library_ms': time_ms(library),
               'bound_ms': bound, 'bound_by': bound_by}
        emit(row)
        rows.append(row)
    return rows


def random_mlp(dims, gen):
    """(out, in) weights and biases, U(-1, 1) / sqrt(in), on the card."""
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        ws.append((torch.rand((b, a), device='cuda', generator=gen) * 2 - 1) / math.sqrt(a))
        bs.append((torch.rand((b,), device='cuda', generator=gen) * 2 - 1) / math.sqrt(a))
    return ws, bs


@torch.no_grad()
def compare_grads(got, want):
    """(max |diff|, max |diff| over max(max |want|, GRAD_FLOOR)) over pairs."""
    pairs = list(zip(got, want))
    return (max((a - b).abs().max().item() for a, b in pairs),
            max(rel(a, b, GRAD_FLOOR) for a, b in pairs))


def phase_kernel_mlp(model, grid_cl):
    """The fused MLP kernels against their plain versions and the default
    route's MLP: at the flagship widths on one train step's batch of trainer
    positions through a real fetch (the main path's input), and at two
    other widths on random inputs."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    n = TRAIN_BATCH
    with torch.no_grad():
        coords = trainer_positions(n, gen)
        x = torch.cat([coords, fourier_embed(coords, model.spec.n_freqs),
                       gs.grid_sample_channel_minor_cuda(grid_cl, coords)], dim=-1)
    cases = [('flagship', [w.detach() for w in model.mlp_w],
              [b.detach() for b in model.mlp_b], x)]
    for dims in MLP_WIDTHS:
        ws, bs = random_mlp(dims, gen)
        cases.append((f'widths {dims}', ws, bs,
                      torch.randn((n, dims[0]), device='cuda', generator=gen)))
    rows = []
    for case, ws, bs, x in cases:
        dims = [x.shape[1]] + [w.shape[0] for w in ws]
        g = torch.randn((n, dims[-1]), device='cuda', generator=gen)
        for precision in ('bf16', 'f32'):
            with torch.no_grad():
                out = mf.mlp_fused_cuda(ws, bs, x, precision)
                dx, dws, dbs = mf.mlp_fused_backward_cuda(ws, bs, x, g, precision)
                ref = mf.mlp_fused_plain(ws, bs, x, precision)
                rdx, rdws, rdbs = mf.mlp_fused_plain_backward(ws, bs, x, g, precision)
                _, dws2, dbs2 = mf.mlp_fused_backward_cuda(ws, bs, x, g, precision)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                grad_err, grad_rel = compare_grads([dx] + dws + dbs, [rdx] + rdws + rdbs)
            where = f'{case}, {precision}'
            fwd_tol, grad_tol = MLP_TOL[precision]
            check(all(bool(torch.isfinite(t).all()) for t in [out, dx] + dws + dbs),
                  f'non-finite fused-MLP output or gradient ({where})')
            check(err <= fwd_tol * ref.abs().max().item(),
                  f'fused MLP forward vs plain {err} ({where})')
            check(grad_rel <= grad_tol, f'fused MLP backward vs plain {grad_rel} ({where})')
            check(all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2)),
                  f'fused MLP dW, db differ in a second call ({where})')
            bound, bound_by = mlp_bound_ms(n, dims, precision)
            bwd_bound, bwd_bound_by = mlp_bound_ms(n, dims, precision, backward=True)
            with torch.no_grad():
                times = {
                    'kernel_ms': time_ms(lambda: mf.mlp_fused_cuda(ws, bs, x, precision)),
                    'plain_ms': time_ms(lambda: mf.mlp_fused_plain(ws, bs, x, precision)),
                    'library_ms': time_ms(lambda: mlp_apply(ws, bs, x)),
                    'bwd_kernel_ms': time_ms(lambda: mf.mlp_fused_backward_cuda(
                        ws, bs, x, g, precision)),
                    'bwd_plain_ms': time_ms(lambda: mf.mlp_fused_plain_backward(
                        ws, bs, x, g, precision))}
            times['bwd_library_ms'] = autograd_ms(
                lambda x, *p: mlp_apply(p[:len(ws)], p[len(ws):], x), [x] + ws + bs, g)
            row = {'phase': 'kernel_mlp', 'case': case, 'dims': dims, 'n': n,
                   'precision': precision, 'max_abs_err': err,
                   'max_abs_output': ref.abs().max().item(),
                   'bwd_max_abs_err': grad_err, 'bwd_max_rel_err': grad_rel,
                   **times, 'bound_ms': bound, 'bound_by': bound_by,
                   'bwd_bound_ms': bwd_bound, 'bwd_bound_by': bwd_bound_by,
                   'fwd_launch': mf.fwd_plan(mf.KERNEL, dims, precision),
                   'bwd_launch': mf.bwd_plan(mf.KERNEL, dims, precision)}
            emit(row)
            rows.append(row)
    return rows


def phase_kernel_fused(model, grid_cl):
    """The one-kernel forward and backward against their plain versions
    and the default route, on the flagship grid and weights at one train
    step's batch (trainer positions, the main path's input, and uniform
    coordinates with some out of range), and on a C = 8, 9^3 grid with a
    3 x 16 MLP."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 4)
    n = TRAIN_BATCH
    nf = model.spec.n_freqs
    ws, bs = [w.detach() for w in model.mlp_w], [b.detach() for b in model.mlp_b]
    grid = grid_cl.detach()
    small_ws, small_bs = random_mlp([3 + 6 * nf + 8, 16, 16, 16, 1], gen)
    cases = [('flagship, trainer coords', grid, trainer_positions(n, gen), ws, bs),
             ('flagship, uniform coords', grid,
              torch.rand((n, 3), device='cuda', generator=gen) * 2.4 - 1.2, ws, bs),
             ('C=8, grid 9, 3 x 16', torch.randn((9, 9, 9, 8), device='cuda', generator=gen),
              torch.rand((n, 3), device='cuda', generator=gen) * 2.4 - 1.2,
              small_ws, small_bs)]
    rows = []
    for case, grid, coords, ws, bs in cases:
        D, H, W, C = grid.shape
        dims = [3 + 6 * nf + C] + [w.shape[0] for w in ws]
        g = torch.randn((n, dims[-1]), device='cuda', generator=gen)
        for precision in ('mixed', 'f32'):
            with torch.no_grad():
                out = ff.fused_forward_cuda(grid, coords, ws, bs, nf, precision)
                dgrid, dws, dbs = ff.fused_forward_backward_cuda(
                    grid, coords, ws, bs, nf, g, precision)
                ref = ff.fused_forward_plain(grid, coords, ws, bs, nf, precision)
                rdg, rdws, rdbs = ff.fused_forward_plain_backward(
                    grid, coords, ws, bs, nf, g, precision)
                _, dws2, dbs2 = ff.fused_forward_backward_cuda(
                    grid, coords, ws, bs, nf, g, precision)
                route = mf.mlp_fused_cuda(ws, bs, torch.cat(
                    [coords, fourier_embed(coords, nf),
                     gs.grid_sample_channel_minor_cuda(grid, coords)], dim=-1),
                    'bf16' if precision == 'mixed' else 'f32')
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                grad_err, grad_rel = compare_grads([dgrid] + dws + dbs, [rdg] + rdws + rdbs)
                route_err = rel(out, route)
            where = f'{case}, {precision}'
            fwd_tol, grad_tol = MLP_TOL['bf16' if precision == 'mixed' else 'f32']
            check(all(bool(torch.isfinite(t).all()) for t in [out, dgrid] + dws + dbs),
                  f'non-finite fused output or gradient ({where})')
            check(err <= fwd_tol * ref.abs().max().item(),
                  f'fused forward vs plain {err} ({where})')
            check(grad_rel <= grad_tol, f'fused backward vs plain {grad_rel} ({where})')
            check(all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2)),
                  f'fused dW, db differ in a second call ({where})')
            route_tol = ROUTE_TOL if precision == 'f32' else fwd_tol
            check(route_err <= route_tol,
                  f'fused forward vs fetch + MLP kernels {route_err} ({where})')
            bound, bound_by = mlp_bound_ms(n, dims, precision, fetch=(C, D, H, W))
            bwd_bound, bwd_bound_by = mlp_bound_ms(n, dims, precision, backward=True,
                                                   fetch=(C, D, H, W))

            def library(grid, *p):
                x = torch.cat([coords, fourier_embed(coords, nf), gs.fetch(grid, coords)],
                              dim=-1)
                return mlp_apply(p[:len(ws)], p[len(ws):], x)
            with torch.no_grad():
                times = {
                    'kernel_ms': time_ms(lambda: ff.fused_forward_cuda(
                        grid, coords, ws, bs, nf, precision)),
                    'plain_ms': time_ms(lambda: ff.fused_forward_plain(
                        grid, coords, ws, bs, nf, precision)),
                    'library_ms': time_ms(lambda: library(grid, *ws, *bs)),
                    'bwd_kernel_ms': time_ms(lambda: ff.fused_forward_backward_cuda(
                        grid, coords, ws, bs, nf, g, precision)),
                    'bwd_plain_ms': time_ms(lambda: ff.fused_forward_plain_backward(
                        grid, coords, ws, bs, nf, g, precision))}
            times['bwd_library_ms'] = autograd_ms(library, [grid] + ws + bs, g)
            row = {'phase': 'kernel_fused', 'case': case, 'grid': [D, H, W, C],
                   'dims': dims, 'n': n, 'precision': precision, 'max_abs_err': err,
                   'max_abs_output': ref.abs().max().item(),
                   'bwd_max_abs_err': grad_err, 'bwd_max_rel_err': grad_rel,
                   'vs_fetch_and_mlp_kernels_rel': route_err,
                   **times, 'bound_ms': bound, 'bound_by': bound_by,
                   'bwd_bound_ms': bwd_bound, 'bwd_bound_by': bwd_bound_by,
                   'fwd_launch': mf.fwd_plan(ff.KERNEL, dims, precision),
                   'bwd_launch': mf.bwd_plan(ff.KERNEL, dims, precision)}
            emit(row)
            rows.append(row)
    return rows


def make_flagship_model():
    """Flagship widths, random weights from a seed, about two-thirds of
    each coefficient tensor zeroed to stand in for a pruned model."""
    spec = make_spec(**FLAGSHIP)
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(spec, gen, device='cuda')
    with torch.no_grad():
        for c in model.coeffs:
            keep = torch.rand(c.shape, generator=gen) < (1.0 / 3.0)
            c.mul_(keep.to(c.device))
    return spec, model


def phase_checkpoint(tmp, vol_path):
    import infer_torch
    spec, model = make_flagship_model()
    ckpt = os.path.join(tmp, 'model.npz')
    save_checkpoint(ckpt, model)
    cfg = os.path.join(tmp, 'config.txt')
    with open(cfg, 'w') as f:
        for k, v in {'data': vol_path, 'checkpoint_path': ckpt, 'd_in': 3,
                     'd_out': 1, 'n_layers': 4, 'n_hidden_size': 32,
                     'n_embedding_freq': 2, 'grid_features': 16,
                     'grid_size': 15, 'wavelet_filter': 'db2',
                     'drop_type': 'smallify'}.items():
            f.write(f'{k} = {v}\n')

    meta = VolumeMeta((VOLUME_N,) * 3)
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psnr_host, l1, mse, rmse = infer_torch.main(
            ['--config_path', cfg, '--reconstruct', 'checkpoint'])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        os.chdir(cwd)
    launches = counts[gs.KERNEL]
    check(counts == only({gs.KERNEL: n_chunks}),
          f'decompression launched {counts}, expected the fetch {n_chunks} times')

    volume = load_volume(vol_path)
    vol_dev = torch.from_numpy(volume).cuda()
    field = torch.from_numpy(field_from_net(model, meta)).cuda()
    check(bool(torch.isfinite(field).all()), 'non-finite field')
    check(float(field.min()) >= -1.0 and float(field.max()) <= 1.0,
          'field outside [-1, 1]')
    psnr_dev = eval_stats_on_device(model, meta, vol_dev)[0]
    check(abs(psnr_dev - psnr_host) <= PSNR_TOL_DB,
          f'device PSNR {psnr_dev} vs host PSNR {psnr_host}')
    field_err = (field - plain_field(model, meta)).abs().max().item()
    check(field_err <= FIELD_TOL, f'kernel field vs plain field {field_err}')

    # steady-state end-to-end rates, decode included (best of 3 after the
    # runs above): on-device stats, and the field brought to the host
    eval_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_stats_on_device(model, meta, vol_dev)
        eval_s.append(time.perf_counter() - t0)
    field_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        field_from_net(model, meta)
        field_s.append(time.perf_counter() - t0)
    time_split(model, meta, vol_dev)
    split = time_split(model, meta, vol_dev)
    prof = profile_eval(model, meta, vol_dev)
    emit({'phase': 'checkpoint', 'voxels': meta.n_voxels, 'chunks': n_chunks,
          'launches': launches, 'psnr_host_f64': psnr_host,
          'psnr_device': psnr_dev, 'l1': l1, 'mse': mse, 'rmse': rmse,
          'field_vs_plain_max_abs': field_err,
          'infer_s': infer_s,
          'eval_stats_s': min(eval_s),
          'voxels_per_s_device_stats': meta.n_voxels / min(eval_s),
          'field_to_host_s': min(field_s),
          'voxels_per_s_field_to_host': meta.n_voxels / min(field_s),
          'split_ms': split, 'profile': prof})
    return spec, model, counts


def phase_binary():
    path = os.path.join(FIXTURES, 'golden_ref_container')
    with np.load(os.path.join(FIXTURES, 'golden_ref_params.npz')) as z:
        want = [z[k] for k in sorted(z.files) if k.startswith('coeff_')]
        w0, b_last = z['w0'], z['b_last']
    spec, model = restore_model(path, wavelet='db2', device='cuda')
    check(spec.grid_size == 8 and spec.grid_features == 4, f'golden spec {spec}')
    coeff_err = 0.0
    for got, ref in zip(model.coeffs, want):
        got = got.detach().cpu().numpy()
        coeff_err = max(coeff_err, float(np.abs(got - ref).max()))
        check(np.array_equal(got == 0, ref == 0), 'golden zero pattern differs')
    check(coeff_err <= 0.05, f'golden quantized coefficients off by {coeff_err}')
    check(np.array_equal(model.mlp_w[0].detach().cpu().numpy(), w0.T),
          'golden raw first layer differs')
    check(np.array_equal(model.mlp_b[-1].detach().cpu().numpy(), b_last),
          'golden raw last bias differs')
    meta = VolumeMeta((64, 64, 64))
    reset_counts()
    field = torch.from_numpy(field_from_net(model, meta)).cuda()
    counts = read_counts()
    launches = counts[gs.KERNEL]
    check(counts == only({gs.KERNEL: 1}), f'binary path launched {counts}')
    check(bool(torch.isfinite(field).all()), 'non-finite binary-path field')
    field_err = (field - plain_field(model, meta)).abs().max().item()
    check(field_err <= FIELD_TOL, f'binary field vs plain field {field_err}')
    emit({'phase': 'binary', 'grid': spec.grid_size, 'features': spec.grid_features,
          'coeff_max_abs_err': coeff_err, 'launches': launches,
          'field_shape': list(meta.resolution), 'field_vs_plain_max_abs': field_err})
    return counts


def with_backends(model, suffix):
    """The model's tensors under the spec of a backend of BACKENDS."""
    spec = make_spec(**FLAGSHIP, **BACKENDS[suffix][0])
    return FeatureGridModel(spec, [c.detach() for c in model.coeffs],
                            [w.detach() for w in model.mlp_w],
                            [b.detach() for b in model.mlp_b])


def plain_predict_backend(model, grid_cl, coords):
    """The plain versions of the kernels of the model's backends."""
    spec = model.spec
    ws, bs = list(model.mlp_w), list(model.mlp_b)
    if spec.interp_backend == 'fused':
        out = ff.fused_forward_plain(grid_cl, coords, ws, bs, spec.n_freqs, 'mixed')
    elif spec.mlp_backend == 'pallas':
        x = torch.cat([coords, fourier_embed(coords, spec.n_freqs),
                       grid_sample_channel_minor(grid_cl, coords)], dim=-1)
        out = mf.mlp_fused_plain(ws, bs, x, 'bf16')
    else:
        return plain_predict(model, grid_cl, coords)
    return out.clamp(-1.0, 1.0)


@torch.no_grad()
def phase_queries(model, suffix=''):
    """4 requests of 2^18 points through apply_model(train=False) under the
    backend ``suffix`` of BACKENDS, against the plain versions of that path
    (and, for a kernel backend, against the default path)."""
    path = 'queries' + suffix
    qmodel = with_backends(model, suffix)
    g = torch.Generator(device='cuda').manual_seed(SEED + 1)
    n = 1 << 18
    reqs = [torch.rand((n, 3), device='cuda', generator=g) * 2.0 - 1.0
            for _ in range(4)]
    reset_counts()
    outs, ms = [], []
    for pts in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(apply_model(qmodel, pts, train=False))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    k = len(reqs)
    want = only({'': {gs.KERNEL: k},
                 '_mlp_pallas': {gs.KERNEL: k, 'mlp_fused_fwd': k},
                 '_fused': {'fused_forward_fwd': k}}[suffix])
    check(counts == want, f'{path} launched {counts}, expected {want}')
    grid_cl = channel_minor(decode_volume(qmodel))
    err = max((o - plain_predict_backend(qmodel, grid_cl, p)).abs().max().item()
              for o, p in zip(outs, reqs))
    tol = FIELD_TOL if not suffix else MLP_TOL['bf16'][0]
    check(err <= tol, f'{path} vs plain {err} > {tol}')
    check(all(bool(torch.isfinite(o).all()) and o.shape == (n, 1) for o in outs),
          f'{path} outputs not finite or wrong shape')
    row = {'phase': path, 'requests': k, 'points': n, 'launches': counts,
           'max_abs_err_vs_plain': err, 'request_ms': ms}
    if suffix:
        row['max_abs_diff_vs_default_path'] = max(
            (o - plain_predict(model, grid_cl, p)).abs().max().item()
            for o, p in zip(outs, reqs))
    emit(row)
    return counts


# kernels by the names the profiler gives them
PROFILED_KERNELS = ('grid_sample_fwd', 'grid_sample_bwd', 'mlp_fwd_kernel',
                    'mlp_bwd_kernel', 'fused_fwd_kernel', 'fused_bwd_kernel',
                    'reduce_slots_kernel')


def flagship_steps(suffix, steps, warmup=5):
    """A flagship phase-1 state under the backend ``suffix`` of BACKENDS
    (a fresh model; the step's work does not depend on the values) after
    ``warmup`` steps, and a function that takes the next step."""
    cfg = load_config(FLAGSHIP_CONFIG)
    spec = make_spec(**dict(FLAGSHIP, drop_type='smallify'), **BACKENDS[suffix][0])
    model = init_model(spec, torch.Generator().manual_seed(SEED), device='cuda')
    vol = torch.rand((VOLUME_N,) * 3, device='cuda') * 2 - 1
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta((VOLUME_N,) * 3), phase=1)
    st = tr.init_train_state(model, cfg.lr, cfg.lr, train_gates=True)
    c = tr.PhaseConstants(ph, vol)
    norm, gt = tr.chunk_inputs(c, tr.draw_positions(
        c, steps + warmup, ph.batch_n, torch.Generator(device='cuda').manual_seed(SEED)))
    taken = iter(range(steps + warmup))

    def step():
        i = next(taken)
        tr.train_step(ph, st, c, norm[i], gt[i])
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    return step


def profile_train_steps(suffix='', steps=50):
    """Device busy and idle share of ``steps`` flagship phase-1 steps under
    the backend ``suffix`` of BACKENDS, host clock around work that ends in
    a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = flagship_steps(suffix, steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in events if e.device_type == DeviceType.CUDA), reverse=True)
    # host side: time inside PyTorch's operators (exclusive), by operator;
    # the rest of the wall time is Python between them
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events if e.device_type == DeviceType.CPU), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {'steps': steps, 'wall_ms': wall_ms, 'ms_per_step': wall_ms / steps,
            'device_busy_ms': busy_ms,
            'device_idle_share': 1.0 - busy_ms / wall_ms if busy_ms else None,
            'host_op_ms': sum(r[0] for r in host),
            'top_host_ops': [{'ms': ms, 'name': k[:60], 'calls': n}
                             for ms, k, n in host[:10]],
            'kernel_launches_per_step': sum(r[2] for r in rows) / steps,
            'kernel_ms': {name: sum(r[0] for r in rows if name in r[1])
                          for name in PROFILED_KERNELS},
            'top_kernels': [{'ms': ms, 'name': k[:80], 'calls': n}
                            for ms, k, n in rows[:10]]}


def phase_step_rates(rounds=5, steps=100):
    """Steady flagship phase-1 step time of each backend, without the
    profiler: host clock around ``steps`` steps that end in a synchronise,
    the backends in turns and the order reversed every other round, so that
    a drift of the shared host falls on all of them alike."""
    order = list(BACKENDS)
    runs = {suffix: flagship_steps(suffix, rounds * steps) for suffix in order}
    ms = {suffix: [] for suffix in order}
    for r in range(rounds):
        for suffix in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                runs[suffix]()
            torch.cuda.synchronize()
            ms[suffix].append((time.perf_counter() - t0) * 1e3 / steps)
    row = {'phase': 'step_rates', 'rounds': rounds, 'steps': steps,
           'batch': TRAIN_BATCH, 'ms_per_step': {}, 'median_samples_per_sec': {}}
    for suffix in order:
        name = 'train' + suffix
        row['ms_per_step'][name] = ms[suffix]
        row['median_samples_per_sec'][name] = TRAIN_BATCH / (statistics.median(ms[suffix]) / 1e3)
    emit(row)
    return row


def phase_train(tmp, vol_path, suffix='', default=None):
    """The training path under the backend ``suffix`` of BACKENDS through its
    CLI, from counts at 0 to the export; ``default``: the info of the
    default backend's run, whose PSNR a kernel backend's must be within
    PSNR_BACKEND_DB of."""
    import train_torch
    path = 'train' + suffix
    meta = VolumeMeta((VOLUME_N,) * 3)
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = train_torch.main(['--config', FLAGSHIP_CONFIG, '--data', vol_path,
                                 '--max_pass', str(TRAIN_MAX_PASS), '--basedir', '/',
                                 '--expname', path, *BACKENDS[suffix][1]])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        os.chdir(cwd)
    exp = os.path.join(tmp, path)
    steps = info['train_phase1_steps'] + info['train_phase2_steps']
    # each kernel of the path once a step; the final evaluation (the fetch
    # and the plain MLP whatever the backend) fetches once a chunk
    want = only({'': {gs.KERNEL: steps + n_chunks, gs.BWD_KERNEL: steps},
                 '_mlp_pallas': {gs.KERNEL: steps + n_chunks, gs.BWD_KERNEL: steps,
                                 'mlp_fused_fwd': steps, 'mlp_fused_bwd': steps},
                 '_fused': {gs.KERNEL: n_chunks, 'fused_forward_fwd': steps,
                            'fused_forward_bwd': steps}}[suffix])
    check(steps > 0 and counts == want,
          f'{path} took {steps} steps and launched {counts}, expected {want}')
    for ph in (1, 2):
        check(info[f'train_phase{ph}_steps'] > 0, f'phase {ph} took no step')
    check(info['train_phase1_last_loss'] < info['train_phase1_first_loss'],
          'phase 1 loss did not fall')
    check(info['train_phase2_last_loss'] < info['train_phase1_first_loss'],
          'phase 2 ended above the first loss')
    check(math.isfinite(info['psnr']), f"non-finite PSNR {info['psnr']}")
    if default is not None:
        check(abs(info['psnr'] - default['psnr']) <= PSNR_BACKEND_DB,
              f"{path} PSNR {info['psnr']} vs train {default['psnr']}")

    spec, restored = restore_model(os.path.join(exp, 'binary_model_file'),
                                   wavelet='db2', device='cuda')
    vol_dev = torch.from_numpy(load_volume(vol_path)).cuda()
    psnr_binary = eval_stats_on_device(restored, meta, vol_dev)[0]
    check(math.isfinite(psnr_binary), 'non-finite PSNR of the exported container')
    files = sorted(os.listdir(exp))
    for name in ('info.txt', 'config.txt', 'model.npz', 'binary_model_file',
                 'binary_model_file_mask.bnr', 'vol.vti', 'gt.vti'):
        check(name in files, f'{path} did not write {name}')
    shutil.rmtree(exp)
    prof = profile_train_steps(suffix)

    def rates(i):
        return {ph: i[f'train_phase{ph}_samples_per_sec'] for ph in (1, 2)}
    emit({'phase': path, 'config': os.path.relpath(FLAGSHIP_CONFIG, REPO),
          'flags': BACKENDS[suffix][1],
          'max_pass': TRAIN_MAX_PASS, 'batch': TRAIN_BATCH,
          'volume': list(meta.resolution),
          'phases': {ph: {k: info[f'train_phase{ph}_{k}'] for k in
                          ('steps', 'seconds', 'samples_per_sec', 'first_loss',
                           'last_loss')} for ph in (1, 2)},
          'steady_samples_per_sec': info.get('train_samples_per_sec'),
          'default_samples_per_sec': None if default is None else rates(default),
          'default_steady_samples_per_sec': (None if default is None
                                             else default.get('train_samples_per_sec')),
          'train_cli_s': train_s, 'launches': counts,
          'psnr': info['psnr'], 'default_psnr': None if default is None else default['psnr'],
          'compression_ratio': info['compression_ratio'],
          'num_zeros': info['num_zeros'], 'num_parameters': info['num_parameters'],
          'psnr_binary_restored': psnr_binary, 'files': files,
          'profile_50_steps': prof})
    return info, counts


def kernel_entry(name, source, replaces, also, path_counts, main_path, **extra):
    """One entry of the kernels line: launches on the main path of the
    kernel and on every path, the numbers at the main path's inputs."""
    out = {'name': name, 'route': 'cuda',
           'source': f'latent_feature_grid_compression_tpu_torch/csrc/{source}',
           'replaces': f'latent_feature_grid_compression_tpu/ops/{replaces}'}
    if also:
        out['also_replaces'] = f'latent_feature_grid_compression_tpu/ops/{also}'
    out['launches'] = path_counts[main_path][name]
    out['launches_by_path'] = {p: c[name] for p, c in path_counts.items()}
    out.update(extra)
    return out


PHASES = ('build', 'kernel', 'kernel_bwd', 'kernel_mlp', 'kernel_fused', 'checkpoint',
          'binary', 'queries', 'train', 'step_rates')


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='comma-separated phases to run after the device phase '
                         f'({", ".join(PHASES)}); prints no kernels or ok line')
    args = ap.parse_args(argv)
    if args.only is not None:
        args.only = set(args.only.split(','))
        unknown = args.only - set(PHASES)
        if unknown:
            ap.error(f'unknown phases {sorted(unknown)}; choose from {", ".join(PHASES)}')
    return args


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1

    def want(phase):
        return args.only is None or phase in args.only
    disable_tf32()
    name, _ = phase_device()
    if want('build'):
        phase_build()
    rows = phase_kernel() if want('kernel') else None
    bwd_rows = phase_kernel_bwd() if want('kernel_bwd') else None
    _, flagship_model = make_flagship_model()
    with torch.no_grad():
        flagship_grid = channel_minor(decode_volume(flagship_model))
    mlp_rows = phase_kernel_mlp(flagship_model, flagship_grid) if want('kernel_mlp') else None
    fused_rows = (phase_kernel_fused(flagship_model, flagship_grid)
                  if want('kernel_fused') else None)
    path_counts = {}
    model = flagship_model   # the checkpoint phase's model: the same seed
    tmp = tempfile.mkdtemp(prefix='lfgc_chip_smoke_')
    try:
        vol_path = os.path.join(tmp, 'mhd_like.npy')
        if want('checkpoint') or want('train'):
            np.save(vol_path, synth_volume(VOLUME_N, seed=1, octaves=6))
        if want('checkpoint'):
            _, model, path_counts['decompress'] = phase_checkpoint(tmp, vol_path)
        if want('binary'):
            path_counts['binary'] = phase_binary()
        if want('queries'):
            for suffix in BACKENDS:
                path_counts['queries' + suffix] = phase_queries(model, suffix)
        if want('train'):
            default, path_counts['train'] = phase_train(tmp, vol_path)
            for suffix in ('_mlp_pallas', '_fused'):
                _, path_counts['train' + suffix] = phase_train(tmp, vol_path, suffix,
                                                               default)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if want('step_rates'):
        phase_step_rates()
    if args.only is not None:
        return 0   # a partial run: no kernels line, no result

    # each kernel's numbers at the main path's own inputs (the flagship,
    # and the precision the model uses: bf16 MLP, 'mixed' fused forward)
    flagship = next(r for r in rows if r['coords'] == 'lattice')
    flagship_bwd = next(r for r in bwd_rows if r['coords'] == 'trainer')
    mlp = next(r for r in mlp_rows if r['case'] == 'flagship' and r['precision'] == 'bf16')
    fused = next(r for r in fused_rows if r['case'] == 'flagship, trainer coords'
                 and r['precision'] == 'mixed')

    def numbers(row, prefix=''):
        return {'ms': row[prefix + 'kernel_ms'], 'plain_ms': row[prefix + 'plain_ms'],
                'bound_ms': row[prefix + 'bound_ms'], 'bound_by': row[prefix + 'bound_by'],
                'library_ms': row[prefix + 'library_ms']}
    emit({'kernels': [
        kernel_entry(gs.KERNEL, 'grid_sample_fwd.cu', 'pallas_kernels.py:135',
                     'pallas_kernels.py:158', path_counts, 'train',
                     max_abs_err=max(r['max_abs_err'] for r in rows),
                     **numbers(flagship),
                     shape={'n': flagship['n'], 'C': 16, 'grid': 15, 'coords': 'lattice'}),
        kernel_entry(gs.BWD_KERNEL, 'grid_sample_bwd.cu', 'pallas_kernels.py:142',
                     'pallas_kernels.py:182', path_counts, 'train',
                     max_abs_err=max(r['max_abs_err'] for r in bwd_rows),
                     max_abs_err_relative=max(r['max_abs_err'] / r['max_abs_dG']
                                              for r in bwd_rows),
                     **numbers(flagship_bwd), atomics=flagship_bwd['atomics'],
                     shape={'n': flagship_bwd['n'], 'C': 16, 'grid': 15,
                            'coords': 'trainer'}),
        kernel_entry('mlp_fused_fwd', 'mlp_fused.cu', 'mlp_pallas.py:103', None,
                     path_counts, 'train_mlp_pallas',
                     max_abs_err=max(r['max_abs_err'] for r in mlp_rows),
                     **numbers(mlp), library='ops/mlp.py::mlp_apply (cuBLAS)',
                     shape={'n': mlp['n'], 'dims': mlp['dims'], 'precision': 'bf16'},
                     launch=mlp['fwd_launch']),
        kernel_entry('mlp_fused_bwd', 'mlp_fused.cu', 'mlp_pallas.py:111', None,
                     path_counts, 'train_mlp_pallas',
                     max_abs_err=max(r['bwd_max_abs_err'] for r in mlp_rows),
                     max_abs_err_relative=max(r['bwd_max_rel_err'] for r in mlp_rows),
                     **numbers(mlp, 'bwd_'),
                     library='ops/mlp.py::mlp_apply forward + autograd backward',
                     shape={'n': mlp['n'], 'dims': mlp['dims'], 'precision': 'bf16'},
                     launch=mlp['bwd_launch']),
        kernel_entry('fused_forward_fwd', 'fused_forward.cu', 'fused_forward.py:113', None,
                     path_counts, 'train_fused',
                     max_abs_err=max(r['max_abs_err'] for r in fused_rows),
                     **numbers(fused),
                     library='fetch kernel + fourier_embed + torch.cat + mlp_apply',
                     shape={'n': fused['n'], 'dims': fused['dims'], 'grid': fused['grid'],
                            'precision': 'mixed'}, launch=fused['fwd_launch']),
        kernel_entry('fused_forward_bwd', 'fused_forward.cu', 'fused_forward.py:129', None,
                     path_counts, 'train_fused',
                     max_abs_err=max(r['bwd_max_abs_err'] for r in fused_rows),
                     max_abs_err_relative=max(r['bwd_max_rel_err'] for r in fused_rows),
                     **numbers(fused, 'bwd_'),
                     library='the default route forward + autograd backward '
                             '(fetch and gradient kernels, cuBLAS)',
                     shape={'n': fused['n'], 'dims': fused['dims'], 'grid': fused['grid'],
                            'precision': 'mixed'}, launch=fused['bwd_launch'])]})
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
