#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and drives the
port's two paths at the full width of the flagship model
(experiment-config-files/mhd_p_smallify.txt: 16 features on a 15^3 grid,
db2, 2 Fourier frequencies, 4 x 32 SnakeAlt MLP, batch 2048 x 16): the
decompression path with random weights from a seed, and the training path
through train_torch.py.  Phases, each printing one JSON line, in order:

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
  5. checkpoint  infer_torch.py --reconstruct checkpoint over the 255^3
                 mhd_like volume: 64 kernel launches, field in [-1, 1],
                 on-device PSNR = float64 host PSNR to 1e-3 dB, kernel field
                 = plain field to 5e-5; voxels/s and the time split
  6. binary      restore of tests/fixtures/golden_ref_container against its
                 recorded parameters, and a 64^3 reconstruction
  7. queries     4 requests of 2^18 points through apply_model(train=False)
  8. train       train_torch.py on mhd_p_smallify.txt over the same volume,
                 cut to max_pass = 3 (widths, batch and volume as published):
                 both phases, bake, prune, evaluation and export; both
                 kernels launched once a step, the loss falls, PSNR finite,
                 the exported container restores; the device idle share of
                 50 steps under torch.profiler
  9. kernels     one line {"kernels": [...]} for every ported kernel

Every failure raises, so the script exits non-zero and prints no result.  It
exits non-zero at once when CUDA is not available.  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    apply_model, decode_volume, init_model, make_spec)
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
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
# ~10 ms of spinning at the H100's clock: longer than the host takes to
# launch the calls of one timed run (the plain version launches ~30 kernels)
SPIN_CYCLES = 20_000_000


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def time_ms(fn, reps=25, inner=10, warmup=3):
    """Device time of one call: the median over ``reps`` runs of CUDA events
    around ``inner`` back-to-back calls, divided by ``inner``.  Each run is
    queued behind a spin kernel, so the card starts it only once the host
    has launched every call: the host's launch time does not show."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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
        gs.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psnr_host, l1, mse, rmse = infer_torch.main(
            ['--config_path', cfg, '--reconstruct', 'checkpoint'])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        launches = gs.launches
    finally:
        os.chdir(cwd)
    check(launches == n_chunks,
          f'main path launched the kernel {launches} times, expected {n_chunks}')

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
    return spec, model, launches


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
    gs.launches = 0
    field = torch.from_numpy(field_from_net(model, meta)).cuda()
    launches = gs.launches
    check(launches == 1, f'binary path launched the kernel {launches} times')
    check(bool(torch.isfinite(field).all()), 'non-finite binary-path field')
    field_err = (field - plain_field(model, meta)).abs().max().item()
    check(field_err <= FIELD_TOL, f'binary field vs plain field {field_err}')
    emit({'phase': 'binary', 'grid': spec.grid_size, 'features': spec.grid_features,
          'coeff_max_abs_err': coeff_err, 'launches': launches,
          'field_shape': list(meta.resolution), 'field_vs_plain_max_abs': field_err})
    return launches


@torch.no_grad()
def phase_queries(model):
    g = torch.Generator(device='cuda').manual_seed(SEED + 1)
    n = 1 << 18
    reqs = [torch.rand((n, 3), device='cuda', generator=g) * 2.0 - 1.0
            for _ in range(4)]
    gs.launches = 0
    outs, ms = [], []
    for pts in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(apply_model(model, pts, train=False))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = gs.launches
    check(launches == len(reqs), f'queries launched the kernel {launches} times')
    grid_cl = channel_minor(decode_volume(model))
    err = max((o - plain_predict(model, grid_cl, p)).abs().max().item()
              for o, p in zip(outs, reqs))
    check(err <= FIELD_TOL, f'queries vs plain {err}')
    check(all(bool(torch.isfinite(o).all()) and o.shape == (n, 1) for o in outs),
          'query outputs not finite or wrong shape')
    emit({'phase': 'queries', 'requests': len(reqs), 'points': n,
          'launches': launches, 'max_abs_err_vs_plain': err, 'request_ms': ms})
    return launches


def profile_train_steps(steps=50):
    """Device busy and idle share of ``steps`` flagship phase-1 steps (a
    fresh model; the step's work does not depend on the values), host clock
    around work that ends in a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = load_config(FLAGSHIP_CONFIG)
    spec = make_spec(**dict(FLAGSHIP, drop_type='smallify'))
    model = init_model(spec, torch.Generator().manual_seed(SEED), device='cuda')
    vol = torch.rand((VOLUME_N,) * 3, device='cuda') * 2 - 1
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta((VOLUME_N,) * 3), phase=1)
    st = tr.init_train_state(model, cfg.lr, cfg.lr, train_gates=True)
    c = tr.PhaseConstants(ph, vol)
    norm, gt = tr.chunk_inputs(c, tr.draw_positions(
        c, steps + 5, ph.batch_n, torch.Generator(device='cuda').manual_seed(SEED)))
    for i in range(5):
        tr.train_step(ph, st, c, norm[i], gt[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5, 5 + steps):
            tr.train_step(ph, st, c, norm[i], gt[i])
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
            'fwd_kernel_ms': sum(r[0] for r in rows if 'grid_sample_fwd' in r[1]),
            'bwd_kernel_ms': sum(r[0] for r in rows if 'grid_sample_bwd' in r[1]),
            'top_kernels': [{'ms': ms, 'name': k[:80], 'calls': n}
                            for ms, k, n in rows[:10]]}


def phase_train(tmp, vol_path):
    """The training path through its CLI, from counts at 0 to the export."""
    import train_torch
    meta = VolumeMeta((VOLUME_N,) * 3)
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        gs.launches = gs.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = train_torch.main(['--config', FLAGSHIP_CONFIG, '--data', vol_path,
                                 '--max_pass', str(TRAIN_MAX_PASS), '--basedir', '/',
                                 '--expname', 'train'])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches, bwd_launches = gs.launches, gs.bwd_launches
    finally:
        os.chdir(cwd)
    exp = os.path.join(tmp, 'train')
    steps = info['train_phase1_steps'] + info['train_phase2_steps']
    check(steps > 0 and bwd_launches == steps,
          f'training took {steps} steps but launched the gradient kernel '
          f'{bwd_launches} times')
    # every step fetches once; the final evaluation fetches once a chunk
    check(launches == steps + n_chunks,
          f'training launched the fetch kernel {launches} times, expected '
          f'{steps} steps + {n_chunks} evaluation chunks')
    for ph in (1, 2):
        check(info[f'train_phase{ph}_steps'] > 0, f'phase {ph} took no step')
    check(info['train_phase1_last_loss'] < info['train_phase1_first_loss'],
          'phase 1 loss did not fall')
    check(info['train_phase2_last_loss'] < info['train_phase1_first_loss'],
          'phase 2 ended above the first loss')
    check(math.isfinite(info['psnr']), f"non-finite PSNR {info['psnr']}")

    spec, restored = restore_model(os.path.join(exp, 'binary_model_file'),
                                   wavelet='db2', device='cuda')
    vol_dev = torch.from_numpy(load_volume(vol_path)).cuda()
    psnr_binary = eval_stats_on_device(restored, meta, vol_dev)[0]
    check(math.isfinite(psnr_binary), 'non-finite PSNR of the exported container')
    files = sorted(os.listdir(exp))
    for name in ('info.txt', 'config.txt', 'model.npz', 'binary_model_file',
                 'binary_model_file_mask.bnr', 'vol.vti', 'gt.vti'):
        check(name in files, f'training did not write {name}')
    prof = profile_train_steps()
    emit({'phase': 'train', 'config': os.path.relpath(FLAGSHIP_CONFIG, REPO),
          'max_pass': TRAIN_MAX_PASS, 'batch': TRAIN_BATCH,
          'volume': list(meta.resolution),
          'phases': {ph: {k: info[f'train_phase{ph}_{k}'] for k in
                          ('steps', 'seconds', 'samples_per_sec', 'first_loss',
                           'last_loss')} for ph in (1, 2)},
          'steady_samples_per_sec': info.get('train_samples_per_sec'),
          'train_cli_s': train_s, 'launches': launches, 'bwd_launches': bwd_launches,
          'psnr': info['psnr'], 'compression_ratio': info['compression_ratio'],
          'num_zeros': info['num_zeros'], 'num_parameters': info['num_parameters'],
          'psnr_binary_restored': psnr_binary, 'files': files,
          'profile_50_steps': prof})
    return launches, bwd_launches


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    disable_tf32()
    name, _ = phase_device()
    phase_build()
    rows = phase_kernel()
    bwd_rows = phase_kernel_bwd()
    tmp = tempfile.mkdtemp(prefix='lfgc_chip_smoke_')
    try:
        vol_path = os.path.join(tmp, 'mhd_like.npy')
        np.save(vol_path, synth_volume(VOLUME_N, seed=1, octaves=6))
        _, model, decompress_launches = phase_checkpoint(tmp, vol_path)
        phase_binary()
        phase_queries(model)
        train_launches, train_bwd_launches = phase_train(tmp, vol_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # each kernel's numbers at the main path's own inputs; launches on the
    # training path (this slice's), and per path
    flagship = next(r for r in rows if r['coords'] == 'lattice')
    flagship_bwd = next(r for r in bwd_rows if r['coords'] == 'trainer')
    emit({'kernels': [{
        'name': gs.KERNEL, 'route': 'cuda',
        'source': 'latent_feature_grid_compression_tpu_torch/csrc/grid_sample_fwd.cu',
        'replaces': 'latent_feature_grid_compression_tpu/ops/pallas_kernels.py:135',
        'also_replaces': 'latent_feature_grid_compression_tpu/ops/pallas_kernels.py:158',
        'launches': train_launches,
        'launches_by_path': {'decompress': decompress_launches,
                             'train': train_launches},
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': flagship['kernel_ms'], 'plain_ms': flagship['plain_ms'],
        'bound_ms': flagship['bound_ms'], 'bound_by': flagship['bound_by'],
        'library_ms': flagship['library_ms'],
        'shape': {'n': flagship['n'], 'C': 16, 'grid': 15, 'coords': 'lattice'}}, {
        'name': gs.BWD_KERNEL, 'route': 'cuda',
        'source': 'latent_feature_grid_compression_tpu_torch/csrc/grid_sample_bwd.cu',
        'replaces': 'latent_feature_grid_compression_tpu/ops/pallas_kernels.py:142',
        'also_replaces': 'latent_feature_grid_compression_tpu/ops/pallas_kernels.py:182',
        'launches': train_bwd_launches,
        'launches_by_path': {'decompress': 0, 'train': train_bwd_launches},
        'max_abs_err': max(r['max_abs_err'] for r in bwd_rows),
        'max_abs_err_relative': max(r['max_abs_err'] / r['max_abs_dG'] for r in bwd_rows),
        'ms': flagship_bwd['kernel_ms'], 'plain_ms': flagship_bwd['plain_ms'],
        'bound_ms': flagship_bwd['bound_ms'], 'bound_by': flagship_bwd['bound_by'],
        'library_ms': flagship_bwd['library_ms'],
        'atomics': flagship_bwd['atomics'],
        'shape': {'n': flagship_bwd['n'], 'C': 16, 'grid': 15, 'coords': 'trainer'}}]})
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
