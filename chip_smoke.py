#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --only build,kernel_mlp,kernel_fused

Builds the CUDA kernels from the sources in this checkout and drives the
port's paths at the full width of the flagship model
(experiment-config-files/mhd_p_smallify.txt: 16 features on a 15^3 grid,
db2, 2 Fourier frequencies, 4 x 32 SnakeAlt MLP, batch 2048 x 16): the
decompression path with random weights from a seed, point queries, the
training path through train_torch.py under each backend (the fetch kernels
with the MLP as PyTorch ops; --mlp_backend pallas, the fused MLP kernels;
--interp_backend fused, the one-kernel forward), the training path of each
other gate family under the default backend, and the bf16 compute path
(--compute_dtype bfloat16, alone and with --interp_backend fused: the
'bf16' modes of the fetch, its gradient and the one-kernel forward and
backward); then the quantization study on the trained model, the volume
readers, and a NAS search with its quality-control re-runs at
mhd_p_HyperparamSearch.txt's widths.  Phases, each printing one JSON line,
in order:

  1. device      card name, and its name and power limit from nvidia-smi
  2. build       nvcc of every csrc/*.cu (started together), seconds, ptxas;
                 g++ of the native I/O helper (native/lfgc_io.cpp)
  3. kernel      the trilinear fetch kernel against its plain PyTorch version
                 (max |diff| <= 1e-5) and F.grid_sample (<= 1e-4) at grids
                 4..62 on random coordinates, and at the flagship shape on a
                 chunk of the 255^3 lattice and on one train step's trainer
                 positions (also at C 22 on 17^3, mhd_p_HyperparamSearch.txt's
                 shape); kernel, plain, library and bound times, and the
                 kernel's launch plan (gs.fwd_plan)
  4. kernel_bwd  the grid-gradient kernel (csrc/grid_sample_bwd.cu, each
                 entry summed in the plain version's order) bit for bit
                 equal to its plain version run on the CPU and to itself in
                 a second call, at the flagship shape and at C 22 on 17^3
                 on the trainer's positions, at grids 4..62 and C 5, 32 on
                 uniform coordinates, and on crowded positions (grid 4 under
                 262,144 samples; 32,768 in the 8 cells of a 2^3 block of
                 the flagship grid); kernel, plain, library (aten
                 grid_sampler_3d_backward), bound and latency-floor times
                 (the longest chain of adds at 4 cycles), and the plan
                 (gs.bwd_plan)
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
  7. kernel_bf16  the 'bf16' modes against their plain versions: the fetch
                 (from the float32 grid, which it rounds itself) and its
                 gradient at the flagship on a chunk of the 255^3 lattice
                 and on one train step's trainer positions, at grid 23 (the
                 blocked Pallas kernels' counterpart), C 5, C 22 on 17^3,
                 and the gradient on kernel_bwd's crowded positions too;
                 the fetch and the gradient bit for bit (the gradient
                 against the plain version on the CPU, and in a second
                 call); the one-kernel 'bf16'
                 forward and backward at the flagship within 1e-2 of max
                 |.| (its dG bit for bit the gradient kernel's on its own
                 dX, in two calls); kernel,
                 plain, library (F.grid_sample on a bf16 input and grid, and
                 its autograd backward; the default bf16 route for the
                 one-kernel pair) and bound times, and the launch plans
  7b. kernel_head  the inference-head kernel (csrc/inference_head.cu: the
                 embedding, the float32 SnakeAlt MLP and the clamp after
                 the fetch) against its plain version (the ATen chain it
                 replaces) to 1e-6, at C 16 (the flagship's weights, a
                 lattice chunk's features) and C 22 (random weights at
                 mhd_p_HyperparamSearch.txt's widths), at 2^18, 2^18 - 37
                 and 2^20 samples; kernel, plain (= library: the chain) and
                 bound times, and the launch plan; its launches on the
                 255^3 evaluation (one a chunk, graphed and eager equal),
                 a query request (one; none with a gradient needed) and
                 graphed training steps (none)
  8. checkpoint  infer_torch.py --reconstruct checkpoint over the 255^3
                 mhd_like volume: 64 kernel launches, field in [-1, 1],
                 on-device PSNR = float64 host PSNR to 1e-3 dB, kernel field
                 = plain field to 5e-5; the field, per-chunk sums and stats
                 eager (graphs=False) and by the default (one capture of the
                 chunk body an evaluation, a replay a chunk) torch.equal, the
                 fetch 64 times in each, no evaluation graph left alive;
                 voxels/s of both modes in turns, the eager time split, and
                 each mode profiled (idle share, host launch calls a chunk)
  9. binary      restore of tests/fixtures/golden_ref_container against its
                 recorded parameters, and a 64^3 reconstruction (one chunk,
                 one replay)
 10. queries     4 requests of 2^18 points through apply_model(train=False),
                 under each backend (queries, queries_mlp_pallas,
                 queries_fused), against the plain versions of that path;
                 queries_bf16 (phase queries_bf16) likewise under
                 compute_dtype='bfloat16', and queries_bf16_fused with
                 interp_backend='fused'
 11. train       train_torch.py on mhd_p_smallify.txt over the same volume,
                 cut to max_pass = 3 (widths, batch and volume as published):
                 both phases, bake, prune, evaluation and export; each
                 kernel of the path launched once a step (the fetch also
                 once an evaluation chunk), the loss falls, PSNR finite, the
                 exported container restores.  The phases' steps are
                 replays of the step's CUDA graph (solve_phase on a card),
                 the launches counted a replay as the capture counted them.
                 A chunk (draws, loads, steps, the one device read) under
                 torch.profiler, graphed (200 steps) and then eager (50):
                 ms and samples/s, the device idle share, device kernels a
                 step (each kernel of the path as often as the step's
                 graph has nodes of it; a trace that lost kernel records
                 is set aside and the next chunk traced, up to 4 times)
                 and host launch calls a step (graphed: at most 1.5).
                 Then train_mlp_pallas and train_fused: the same under
                 each kernel backend, PSNR within 1 dB of train's,
                 samples/s beside train's; and (phase train_bf16) train_bf16 and train_bf16_fused, the
                 same under --compute_dtype bfloat16 (the 'bf16' fetch and
                 gradient, the bf16 MLP chain on cuBLAS), and with
                 --interp_backend fused (the one-kernel 'bf16' pair): each
                 bf16 kernel once a step and the float32 fetch once an
                 evaluation chunk, PSNR within 1 dB of train's
 12. resume      mid-training resume on the flagship: the phase-1 state and
                 both generators of 2 chunks of 50 steps saved by
                 solve_phase and loaded back bit for bit (also for
                 mhd_p_dynamic_variational.txt, whose noise has a generator
                 of its own), one more chunk from the loaded and the live
                 state drawing the same positions and noise, giving the
                 same losses and ending in the same state, all bit for bit;
                 save and load ms; train's
                 experiment resumed at phase 2 (no step: the fetch once an
                 evaluation chunk, no gradient; PSNR, zeros and ratio equal
                 train's) and at phase 1 (no phase-1 step, phase 2 rerun from
                 the same generators: PSNR within 0.05 dB, zeros equal);
                 train_torch.py --max_pass 1 --profile_dir (the trace of
                 phase 1's second chunk names the fetch and gradient
                 kernels); the TensorBoard writer the machine has, and with
                 one, train-3 phase-1 samples/s without and with it
12b. graphs      each backend and each other gate family at the flagship's
                 widths: 2 chunks of 50 phase-1 steps through solve_phase
                 with the step's CUDA graph and with eager steps from the
                 same state and generators, the losses and states bit for
                 bit, the launch counts equal (each kernel once a step);
                 the gradient kernel's two launches captured alone in a
                 graph kept for inspection: its nodes and its edges' types
                 through libcuda (a programmatic edge: the capture kept
                 the box kernel's early launch), the replay bit for bit
 13. train_families  train_torch.py on each other gate family's published
                 config, cut to max_pass = 3, default backend: train_
                 straight_through (mhd_p_masked_st.txt with --drop_type
                 straight_through), train_masked_straight_through,
                 train_static_variational, train_dynamic_variational; the
                 fetch kernel once a step and an evaluation chunk, the
                 gradient once a step, the volume loss (MSE; the variational
                 loss carries the rising KL weight) falls in both phases,
                 PSNR finite, the container restores; PSNR, ratio, zeros and
                 samples/s a phase; the dynamic family also the profiles of
                 a chunk, eager and graphed
 14. quant       the post-training quantization study (mock_quantization_study:
                 coefficients through int8 at scale 0.02, the MLP through
                 int32 at 1e-4) on train's model.npz over the 255^3 volume:
                 the fetch kernel once an evaluation chunk, twice (128);
                 the float PSNR equal to train's within 1e-3 dB, the zeros
                 and ratio train's less the masks' storage; the quantized
                 PSNR within 1e-3 dB of a float64 host PSNR of the quantized
                 model's field through the plain versions; both PSNRs,
                 both ratios, seconds
 15. readers     load_volume of the 255^3 volume written as .cvol (and .h5
                 where h5py is installed) bitwise equal to the .npy's; the
                 read times
15b. native      the native I/O helper: a compressed .cvol of the volume
                 (uint8, LZ4 slices with run matches and the streaming
                 history) made in the run, read through the helper and
                 through the pure-Python decoder, both bitwise the volume;
                 the helper's k-means (256 clusters) on the model's largest
                 coefficient tensor; train-3's model.npz exported to the
                 container twice (its k-means the helper's), the bytes equal
                 to each other and to train-3's own export; the times
 16. nas         nas.run_search on mhd_p_HyperparamSearch.txt at its
                 published widths (22 features on 17^3, dynamic
                 variational, 4 x 32, batch 2048 x 16) over the .cvol copy,
                 cut to max_pass = 1: 4 trials of train_torch.py, 2 at a
                 time on the card (GP-EHVI, seed 0); then
                 utils/trigger_experiments.py: runs_at_target_ratios at the
                 trials' geometric-mean ratio (lambda_drop_loss), and
                 rerun_frontier_configs of the front's first trial with
                 wavelet_filter '' (and no warm start).  Each process runs
                 train_torch.py through a wrapper that counts its launches.
                 Every process exits 0 (a failed trial is run again in the
                 foreground, then the phase raises), PSNR finite, ratio > 1,
                 the fetch kernel once a step and an evaluation chunk and the
                 gradient kernel once a step (the paths nas and qc of the
                 kernels line), each trial's TensorBoard metrics equal to its
                 info.txt where tensorboard is installed; then the fetch and
                 gradient kernels against their plain versions (the kernel
                 phases' checks) at each run's grid and features on the
                 trainer's positions; each trial's parameters, grid size,
                 PSNR, ratio and seconds, the QC runs' ratios against their
                 targets
 17. mesh        multi-device training, 2 ranks (--mesh-ranks N: N) through
                 python -m torch.distributed.run (this script as each
                 rank's worker, driving train_torch.py): NCCL with a card
                 a rank, each rank's steps replays of its CUDA graph (the
                 step's collectives captured with it), else gloo with the
                 ranks on the one card, asked for by name, eager (the
                 port's refusal without gloo, recorded; what NCCL does
                 with both ranks on card 0, --only nccl_probe, is not run
                 by default).
                 mesh_dp: 20 flagship steps of one global position stream
                 on one rank and on N ranks (each its contiguous part):
                 losses within 1e-5, parameters within 1e-5 where the
                 gradient is clear of Adam's eps, the ranks bit for bit
                 equal.  mesh_dp2: train-3 at --mesh_data N: the fetch and
                 gradient kernels once a step on each rank (rank 0 the
                 fetch also once an evaluation chunk), one all-reduce a
                 step, PSNR within 1 dB of train's, the container
                 restores.  mesh_windows: on the 256^3 synth_volume (255
                 does not divide 2), each rank's window of the grid (15,
                 15, W', 16): fetch and gradient kernels against their
                 plain versions, the windowed forward against the full
                 one.  mesh_graphs: graphs=True on a gloo mesh raises;
                 with a card a rank, every run's phase-1 state through
                 solve_phase for 3 chunks of 50 steps graphed and eager,
                 saving after every chunk, then the graphed run resumed
                 after its second chunk: on every rank the losses, the
                 states, the launches and the collective counts equal,
                 the step graph's kernel nodes (NCCL's among them); on
                 fewer cards a row saying that it did not run.
                 train_torch.py's mesh steps are replays of each phase's
                 graph under NCCL and eager under gloo (the trainer's
                 default; each rank's captures are checked), and every
                 rank ends its process group through
                 shutdown_distributed with no step graph left alive.
                 mesh_space2_zero_local: train-3 at --mesh_space N
                 --mesh_shard_params 1 --mesh_local_decode 1
                 --interp_backend xla on that volume (an all-gather and a
                 reduce-scatter a step); at 4 ranks also
                 mesh_dp2_space2_zero_local, the same at --mesh_data 2
                 --mesh_space 2 (and an all-reduce over 'data'), with its
                 windows.  Under NCCL, mesh_cli: train_torch.py itself
                 under torch.distributed.run and a time limit at
                 --mesh_data 2, and at 4 ranks the 2 x 2 mesh: exit 0,
                 one step graph a phase, PSNR within 1 dB of train's.
                 Each run: samples/s per rank and
                 summed (and over train's), ms a step, a profiled chunk of
                 50 steps eager and, under NCCL, graphed (ms a step, host
                 launch calls, idle share, NCCL's kernels and device ms, the
                 collectives' host share; the fetch, gradient and NCCL
                 kernels of the eager trace a step those of the step's
                 graph), the collective calls a step and the bytes the ring
                 model gives them, equal in both modes, against those
                 comm_volume_per_step predicts; mesh_windows also the
                 library's times (F.grid_sample, its aten backward)
 18. step_rates  the flagship step time of each backend (the bf16 paths
                 too) and of dynamic variational, eager and graphed, without
                 the profiler: 2 rounds of a 200-step chunk each (50
                 eager), the paths and modes in turns; then each of those paths through
                 train_torch.py at --max_pass 1, graphed and eager
                 (solve_phase's graphs=False), the PSNRs equal
 19. kernels     one line {"kernels": [...]} for every ported kernel

Every count of launches is set to 0 just before a path is driven and read
just after it.  The inference head (7b) is counted on every path with the
others: once an evaluation chunk wherever the evaluation runs on a card at
widths it takes (checkpoint, each training run's, resume, quant, NAS and QC
by their configs' widths, the mesh's rank 0; not binary's golden container,
of 4 features), once a request of
the default backend's queries, and never in a training step.  Each phase row carries ``at_s``, the seconds since the
script started.  Every failure raises, so the script exits non-zero and
prints no result.  It exits non-zero at once when CUDA is not available.
The last line is {"ok": true, "device": {...}}.

``--mesh-ranks`` sets the mesh phase's ranks (2; 4 on a machine of 4
cards).  ``--only`` takes a comma-separated list of phases 2-18 (build, kernel,
kernel_bwd, kernel_mlp, kernel_fused, kernel_bf16, kernel_head, checkpoint, binary,
queries, queries_bf16, train, train_bf16, resume, graphs, train_families,
quant, readers, native, nas, mesh, step_rates) and runs the device phase and
those, in the order above, with the same checks (train_bf16 and mesh
without train compare no PSNR; resume, quant and native run train's default
run first, whose experiment they read); the
kernels line and the ok line need every phase, so a partial run prints
neither (a quick loop on one kernel, never the smoke).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import types
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from latent_feature_grid_compression_tpu_torch.data.cvol import read_cvol, write_cvol
from latent_feature_grid_compression_tpu_torch.data.synthetic import synth_volume
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta, load_volume
from latent_feature_grid_compression_tpu_torch.device import disable_tf32
from latent_feature_grid_compression_tpu_torch.eval.reconstruct import (
    CHUNK, ChunkBody, chunk_sums, deviation_statistics, eval_stats_on_device, field_from_net,
    field_on_device, lattice_chunk, lattice_constants)
from latent_feature_grid_compression_tpu_torch.config import (
    dict_from_file, load_config, write_dict)
from latent_feature_grid_compression_tpu_torch.io.checkpoint import (
    load_checkpoint, save_checkpoint)
from latent_feature_grid_compression_tpu_torch.io.container import (
    restore_model, store_model_parameters)
from latent_feature_grid_compression_tpu_torch.io.train_state_io import (
    TENSOR_FIELDS, atomic_save_train_state, load_train_state)
from latent_feature_grid_compression_tpu_torch.models.gates import is_dynamic
from latent_feature_grid_compression_tpu_torch.models.feature_grid import (
    FeatureGridModel, apply_model, decode_volume, head_after_fetch, init_model, make_spec)
from latent_feature_grid_compression_tpu_torch.models.variance import init_variance_model
from latent_feature_grid_compression_tpu_torch.native import lib as native
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as ff
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops import inference_head as ih
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf
from latent_feature_grid_compression_tpu_torch.ops.embedding import fourier_embed
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    channel_minor, grid_sample_channel_minor, grid_sample_channel_minor_backward,
    grid_sample_channel_minor_backward_bf16, grid_sample_channel_minor_bf16)
from latent_feature_grid_compression_tpu_torch.ops.mlp import mlp_apply, mlp_apply_bf16
from latent_feature_grid_compression_tpu_torch.ops.quantization import (
    mock_quantization_study, quantize_model)
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
CONFIGS = os.path.join(REPO, 'experiment-config-files')
FLAGSHIP_CONFIG = os.path.join(CONFIGS, 'mhd_p_smallify.txt')
# the other gate families' published configs (flagship widths) and flags;
# straight-through has no config of its own and takes masked-ST's
FAMILIES = {
    'straight_through': ('mhd_p_masked_st.txt', ['--drop_type', 'straight_through']),
    'masked_straight_through': ('mhd_p_masked_st.txt', []),
    'static_variational': ('mhd_p_static_variational.txt', []),
    'dynamic_variational': ('mhd_p_dynamic_variational.txt', [])}
VOLUME_N = 255
SEED = 0
TRAIN_MAX_PASS = 3    # the published 60 passes cut to 3: 1013 + 507 steps
TRAIN_BATCH = 2048 * 16
KERNEL_TOL = 1e-5     # same formula in f32, another summation order
LIBRARY_TOL = 1e-4    # F.grid_sample rounds its own pixel map and weights
FIELD_TOL = 5e-5      # kernel vs plain through the MLP
PSNR_TOL_DB = 1e-3
# the MLP kernels against their plain versions, relative to max |.|
# (forward, gradients): float32 sums in another order (dW, db over 32,768
# samples; dG of the MLP's own dX); with bf16 operands a float32 sum that lands on the
# other side of a bf16 rounding boundary moves one operand by 2^-8 of itself
MLP_TOL = {'f32': (1e-5, 1e-4), 'bf16': (1e-2, 1e-2)}
# a gradient summed over the batch can cancel to far below its terms (of
# order one): its error is held against at least 1
GRAD_FLOOR = 1.0
# the one-kernel forward in 'f32' against the fetch kernel + embedding + MLP
# kernel route: the same arithmetic but torch's sin/cos for the embedding
ROUTE_TOL = 1e-6
PSNR_BACKEND_DB = 1.0  # a kernel backend's train-3 PSNR against the default's
# the resume phase: steps a chunk of the state round trip, whose continued
# losses and final states are held bit for bit; train-3 resumed at phase 1
# against train's own PSNR (phase 2 rerun from the bake saved at phase 1's
# end)
RESUME_CHUNK = 50
PSNR_RESUME_DB = 0.05
# the mesh phase: 20 steps of one global stream on one rank against two,
# relative (losses; parameters clear of Adam's eps): the two ranks sum the
# batch's gradient in halves and add them in the all-reduce, another float
# order than one rank's
ATOMICS_TOL = 1e-5
MLP_WIDTHS = ([128, 128, 128, 128, 4], [19, 24, 24, 3])
# backends of the paths: make_spec options and train_torch.py flags
BACKENDS = {'': ({}, []),
            '_mlp_pallas': (dict(mlp_backend='pallas'), ['--mlp_backend', 'pallas']),
            '_fused': (dict(interp_backend='fused'), ['--interp_backend', 'fused']),
            '_bf16': (dict(compute_dtype='bfloat16'), ['--compute_dtype', 'bfloat16']),
            '_bf16_fused': (dict(interp_backend='fused', compute_dtype='bfloat16'),
                            ['--interp_backend', 'fused', '--compute_dtype', 'bfloat16'])}
# the bf16 compute path's backends (phases queries_bf16, train_bf16)
BF16_BACKENDS = ('_bf16', '_bf16_fused')
# at least ~10 ms of spinning at the H100's clock, and at least twice the
# host's time to enqueue the calls of one timed run (measured in time_ms)
SPIN_CYCLES = 20_000_000
SPIN_CYCLES_PER_MS = 2_000_000   # the SM clock is below 2 GHz
# time_ms: the host milliseconds after which a measurement stops taking
# runs, and the fewest runs whose median it takes
TIME_MS_BUDGET = 500.0
MIN_REPS = 7
FADD_CYCLES = 4                  # a dependent float add's latency on Hopper


# the smoke's start on the host clock: each phase row carries its seconds
# since (``at_s``), so a run's time can be split by phase
STARTED = time.perf_counter()


def emit(obj):
    if 'phase' in obj:
        obj = {**obj, 'at_s': time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def reset_counts():
    """Every kernel wrapper's launch count to 0, and the trainer's count of
    warm-up steps (taken on scratch states before a capture; their
    launches are not counted)."""
    gs.launches = gs.bwd_launches = gs.bf16_launches = gs.bf16_bwd_launches = 0
    mf.launches = mf.bwd_launches = 0
    ff.launches = ff.bwd_launches = ff.bf16_launches = ff.bf16_bwd_launches = 0
    ih.launches = 0
    tr.warmup_steps = 0


def read_counts():
    return {gs.KERNEL: gs.launches, gs.BWD_KERNEL: gs.bwd_launches,
            'mlp_fused_fwd': mf.launches, 'mlp_fused_bwd': mf.bwd_launches,
            'fused_forward_fwd': ff.launches, 'fused_forward_bwd': ff.bwd_launches,
            gs.BF16_KERNEL: gs.bf16_launches, gs.BF16_BWD_KERNEL: gs.bf16_bwd_launches,
            'fused_forward_fwd_bf16': ff.bf16_launches,
            'fused_forward_bwd_bf16': ff.bf16_bwd_launches, ih.KERNEL: ih.launches}


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
    not show.  The runs stop early, after at least MIN_REPS, once they have
    taken TIME_MS_BUDGET of the host's clock (a plain version's take
    milliseconds a call; a kernel's 25 runs take ~0.3 s)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    spin = max(SPIN_CYCLES, int(2 * host_ms * SPIN_CYCLES_PER_MS))
    times = []
    t0 = time.perf_counter()
    while len(times) < reps and (len(times) < MIN_REPS or
                                 (time.perf_counter() - t0) * 1e3 < TIME_MS_BUDGET):
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
    """Least time for one fetch, in either mode: the bytes it must move
    (coords read, output written, the float32 grid read once) and its
    float32 operations (8 corners x C FMAs, plus the pixel map and
    weights), whichever takes longer."""
    nbytes = 4 * n * (3 + C) + 4 * D * H * W * C
    ops = n * (2 * 8 * C + 40)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def grad_bound_ms(n, C, D, H, W):
    """Least time for one grid gradient: the bytes it must move (coords and
    g read, the gradient written once; float32 in both modes) and its
    float32 operations (8 corners x C multiply-adds, plus the pixel map and
    weights)."""
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
    lat = lattice_constants(meta, CHUNK, torch.device('cuda'))
    out = torch.empty(lat.n_chunks * CHUNK, device='cuda')
    for start in range(0, lat.n, CHUNK):
        c, _ = lattice_chunk(lat, start)
        out[start:start + CHUNK] = plain_predict(model, grid_cl, c)[:, 0]
    return out[:lat.n].reshape(meta.resolution)


@torch.no_grad()
@torch.no_grad()
def time_split(model, meta, vol_dev):
    """Per-stage device time of one full-volume evaluation, eager, with CUDA
    events between the stages of the chunk body eval_stats_on_device runs
    (``ChunkBody`` with the ground truth): 'decode' (with the lattice's
    constants and the padded ground truth, made once), then each chunk's
    'lattice' from the device counter (the constants are on the device, so
    no host wait sits in it), 'fetch', 'mlp' (the head after the fetch:
    embedding, MLP and clamp, one kernel at the published widths) and
    'stats' (its sums written
    at its row, the counter advanced).  Returns (ms by stage, the per-chunk
    sums, for a check that the split ran the evaluation's work)."""
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    stages = ('decode', 'lattice', 'fetch', 'mlp', 'stats')
    ms = dict.fromkeys(stages, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(1 + 4 * n_chunks + 1)]
    k = 0
    ev[k].record()
    body = ChunkBody(model, meta, CHUNK, torch.device('cuda'), volume=vol_dev)
    k += 1
    ev[k].record()
    marks = [('decode', 0, 1)]
    for _ in range(n_chunks):
        c, valid = lattice_chunk(body.lat, body.k * CHUNK)
        ev[k + 1].record()
        feats = gs.fetch(body.grid_cl, c)
        ev[k + 2].record()
        pred = head_after_fetch(model, c, feats)
        ev[k + 3].record()
        diff = torch.where(valid, body.gt.index_select(0, body.k)[0] - pred[:, 0], 0.0)
        body.out.index_copy_(0, body.k, torch.stack([torch.sum(diff * diff),
                                                     torch.sum(diff.abs())])[None])
        body.k.add_(1)
        ev[k + 4].record()
        marks += [('lattice', k, k + 1), ('fetch', k + 1, k + 2),
                  ('mlp', k + 2, k + 3), ('stats', k + 3, k + 4)]
        k += 4
    torch.cuda.synchronize()
    for name, a, b in marks:
        ms[name] += ev[a].elapsed_time(ev[b])
    return ms, body.out


def profile_eval(model, meta, vol_dev, graphs):
    """One full-volume evaluation (``eval_stats_on_device``, eager or by
    the default's graph replays, its capture included) under torch.profiler
    (CUPTI): the host clock around it, the device's busy and idle share,
    device kernels and host calls that launch device work (LAUNCH_CALLS), in
    all and a chunk, and the heaviest device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_stats_on_device(model, meta, vol_dev, graphs=graphs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False)), reverse=True)
    launch_calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
    busy_ms = sum(r[0] for r in rows)
    return {'graphs': graphs, 'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'device_idle_share': 1.0 - busy_ms / wall_ms if busy_ms else None,
            'host_launch_calls': launch_calls,
            'host_launch_calls_per_chunk': sum(launch_calls.values()) / n_chunks,
            'device_kernels_per_chunk': sum(r[2] for r in rows) / n_chunks,
            'fetch_kernel_ms': sum(r[0] for r in rows if 'grid_sample_fwd' in r[1]),
            'fetch_kernel_calls': sum(r[2] for r in rows if 'grid_sample_fwd' in r[1]),
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
    t0 = time.perf_counter()
    native_built = native.build()
    native_s = time.perf_counter() - t0
    emit({'phase': 'build', 'seconds': seconds,
          'built': {k: v['built'] for k, v in report.items()},
          'ptxas': {k: ptxas_summary(v['ptxas']) for k, v in report.items()},
          'native': {'built': native_built, 'seconds': native_s,
                     'library': os.path.basename(native.library_path())}})


@torch.no_grad()
def fetch_case(C, G, kind, g, timed=True):
    """The fetch kernel against its plain version and F.grid_sample on a
    random (C, G^3) grid at ``kind`` coordinates: 'uniform' (out-of-range
    ones included), 'trainer' (one train step's positions) or 'lattice' (a
    chunk of the 255^3 lattice); with ``timed`` the kernel's, plain,
    library and bound times."""
    n = TRAIN_BATCH if kind == 'trainer' else CHUNK
    feats = torch.randn((C, G, G, G), device='cuda', generator=g)
    if kind == 'uniform':
        coords = torch.rand((n, 3), device='cuda', generator=g) * 2.4 - 1.2
    elif kind == 'trainer':
        coords = trainer_positions(n, g)
    else:
        coords, _ = lattice_chunk(
            lattice_constants(VolumeMeta((VOLUME_N,) * 3), n, torch.device('cuda')), 32 * n)
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
    row = {'phase': 'kernel', 'name': gs.KERNEL, 'C': C, 'grid': G, 'n': n,
           'coords': kind, 'max_abs_err': err, 'max_abs_err_library': err_lib,
           'plan': gs.fwd_plan(n, C, G, G, G, gs._vec4(C, grid_cl, out))}
    if timed:
        bound, bound_by = fetch_bound_ms(n, C, G, G, G)
        row.update(
            kernel_ms=time_ms(lambda: gs.grid_sample_channel_minor_cuda(grid_cl, coords)),
            plain_ms=time_ms(lambda: grid_sample_channel_minor(grid_cl, coords)),
            library_ms=time_ms(lambda: F.grid_sample(
                feats[None], coords.view(1, n, 1, 1, 3), mode='bilinear',
                padding_mode='zeros', align_corners=False)),
            bound_ms=bound, bound_by=bound_by)
    return row


def phase_kernel():
    """Kernel vs plain vs F.grid_sample at the NAS range of grids, on
    uniform random coordinates (out-of-range ones included), and at the
    flagship shape on the coordinates the main path gives it: one chunk of
    the 255^3 lattice (evaluation), whose neighbouring samples share grid
    corners, and one train step's trainer positions (1,520 of the 1,584
    launches of a train-3 run)."""
    g = torch.Generator(device='cuda').manual_seed(SEED)
    rows = []
    cases = [(16, 4), (16, 15), (16, 22), (16, 23), (16, 32), (16, 62),
             (5, 15), (32, 15)]
    # the trainer cases: the flagship, and mhd_p_HyperparamSearch.txt's C 22
    # on 17^3
    for C, G, kind in ([(C, G, 'uniform') for C, G in cases]
                       + [(16, 15, 'lattice'), (16, 15, 'trainer'), (22, 17, 'trainer')]):
        row = fetch_case(C, G, kind, g)
        emit(row)
        rows.append(row)
    return rows


def trainer_positions(n, generator):
    """(n, 3) coordinates drawn as the trainer draws them on the 255^3
    volume: IID voxel indices, normalized (isotropic: scale 1)."""
    pos = torch.randint(0, VOLUME_N, (n, 3), generator=generator, device='cuda',
                        dtype=torch.int32)
    return (pos.to(torch.float32) / (VOLUME_N - 1)) * 2.0 - 1.0


def clustered_positions(n, G, generator):
    """(n, 3) coordinates all in the 8 cells of a 2 x 2 x 2 block at the
    middle of a G^3 grid: uniform pixel positions in [G/2 - 1, G/2 + 1)."""
    lo = G // 2 - 1
    pix = lo + 2.0 * torch.rand((n, 3), device='cuda', generator=generator)
    return (2.0 * pix + 1.0) / G - 1.0


def grad_coords(kind, n, G, generator):
    """(n, 3) coordinates of a gradient case: 'trainer' (one train step's
    positions), 'clustered' (clustered_positions) or 'uniform' (over the
    grid and past it)."""
    if kind == 'trainer':
        return trainer_positions(n, generator)
    if kind == 'clustered':
        return clustered_positions(n, G, generator)
    return torch.rand((n, 3), device='cuda', generator=generator) * 2.4 - 1.2


def longest_chain(coords, D, H, W):
    """The most float adds one entry of the gradient sums in a row (its
    samples over all 8 corners) at these coordinates: each sample's lower
    corner counted on the host, then each row's 8 neighbouring corners."""
    sizes = torch.tensor([W, H, D], dtype=torch.float32)
    lo = torch.floor(((coords.cpu() + 1.0) * sizes - 1.0) * 0.5).to(torch.int64) + 1
    inside = ((lo >= 0) & (lo <= torch.tensor([W, H, D]))).all(1)
    lo = lo[inside]
    count = torch.zeros((D + 1, H + 1, W + 1), dtype=torch.int64)
    count.index_put_((lo[:, 2], lo[:, 1], lo[:, 0]), torch.ones(len(lo), dtype=torch.int64),
                     accumulate=True)
    chain = sum(count[1 - dz:D + 1 - dz, 1 - dy:H + 1 - dy, 1 - dx:W + 1 - dx]
                for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))
    return int(chain.max())


def grad_latency_ms(coords, D, H, W):
    """The latency floor of one gradient: its longest chain of dependent
    float adds (longest_chain) at FADD_CYCLES each and the SM clock of
    SPIN_CYCLES_PER_MS."""
    return longest_chain(coords, D, H, W) * FADD_CYCLES / SPIN_CYCLES_PER_MS


def grad_case(C, G, kind, g, timed=True, n=TRAIN_BATCH):
    """The gradient kernel at n samples (one train step's batch unless
    named), on 'trainer', 'uniform' or 'clustered' coordinates
    (grad_coords): bit for bit its plain version run on the CPU and itself
    in a second call, and aten's grid_sampler_3d_backward within 1e-4 of
    max |dG|; with ``timed`` the kernel's, plain, library and bound times,
    and the longest chain's latency floor."""
    coords = grad_coords(kind, n, G, g)
    grad = torch.randn((n, C), device='cuda', generator=g)
    out = gs.grid_sample_channel_minor_backward_cuda(grad, coords, G, G, G)
    again = gs.grid_sample_channel_minor_backward_cuda(grad, coords, G, G, G)
    plain = grid_sample_channel_minor_backward(grad.cpu(), coords.cpu(), G, G, G)
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
    out_cpu = out.cpu()
    scale = plain.abs().max().item()
    err = (out_cpu - plain).abs().max().item()
    err_lib = (out - lib_in[0].permute(1, 2, 3, 0)).abs().max().item()
    case = f'C={C}, G={G}, {kind} coords'
    check(bool(torch.isfinite(out).all()), f'non-finite gradient ({case})')
    check(torch.equal(out_cpu, plain),
          f'gradient kernel differs from its plain version on the CPU by {err} ({case})')
    check(torch.equal(out, again), f'the gradient kernel gave another dG in a second call ({case})')
    check(err_lib <= 1e-4 * scale, f'gradient kernel vs aten {err_lib} ({case})')
    row = {'phase': 'kernel_bwd', 'name': gs.BWD_KERNEL, 'C': C, 'grid': G,
           'n': n, 'coords': kind, 'max_abs_err': err, 'equal_to_cpu_plain': True,
           'equal_in_a_second_call': True, 'max_abs_dG': scale,
           'max_abs_err_library': err_lib,
           'library_skipped_grid_grad': lib_grid is None or lib_grid.numel() == 0,
           'adds': n * 8 * C, 'plan': gs.bwd_plan(n, C, G, G, G)}
    if timed:
        bound, bound_by = grad_bound_ms(n, C, G, G, G)
        row.update(
            kernel_ms=time_ms(lambda: gs.grid_sample_channel_minor_backward_cuda(
                grad, coords, G, G, G)),
            plain_ms=time_ms(lambda: grid_sample_channel_minor_backward(
                grad, coords, G, G, G)),
            library_ms=time_ms(library), bound_ms=bound, bound_by=bound_by,
            latency_floor_ms=grad_latency_ms(coords, G, G, G))
    return row


# the crowded gradient cases of both modes: a small grid under a large
# batch, and positions in few cells
CROWDED = [(16, 4, 'uniform', 8 * TRAIN_BATCH), (16, 15, 'clustered', TRAIN_BATCH)]


def phase_kernel_bwd():
    """Gradient kernel vs its plain version on the CPU, itself and aten's
    grid_sampler_3d_backward, at one train step's batch: the flagship shape
    on the trainer's positions, then the NAS range of grids and C 5 and 32
    on uniform random coordinates; then the crowded cases (CROWDED)."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 2)
    rows = []
    cases = ([(16, 15, 'trainer', TRAIN_BATCH), (22, 17, 'trainer', TRAIN_BATCH)]
             + [(16, G, 'uniform', TRAIN_BATCH) for G in (4, 8, 22, 23, 32, 62)]
             + [(5, 15, 'uniform', TRAIN_BATCH), (32, 15, 'uniform', TRAIN_BATCH)] + CROWDED)
    for C, G, kind, n in cases:
        row = grad_case(C, G, kind, g, n=n)
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


def fused_row(phase, case, grid, coords, ws, bs, nf, g, precision):
    """The one-kernel forward and backward in ``precision`` against their
    plain versions (dW, db and dG also bitwise in a second call; dG bit for
    bit the plain routing, on the CPU, of the backward kernel's own dX
    features, which the gradient kernel routes) and against the fetch kernel
    + embedding + MLP kernel route of that precision; times of kernel, plain
    version and library (the default route of that precision: the fetch,
    ``fourier_embed``, ``torch.cat`` and the MLP as PyTorch ops, the bf16
    chain for 'bf16'), forward and forward + autograd backward."""
    n = coords.shape[0]
    D, H, W, C = grid.shape
    dims = [3 + 6 * nf + C] + [w.shape[0] for w in ws]
    fetch_precision = 'bf16' if precision == 'bf16' else 'f32'
    with torch.no_grad():
        out = ff.fused_forward_cuda(grid, coords, ws, bs, nf, precision)
        dgrid, dws, dbs = ff.fused_forward_backward_cuda(grid, coords, ws, bs, nf, g, precision)
        ref = ff.fused_forward_plain(grid, coords, ws, bs, nf, precision)
        rdg, rdws, rdbs = ff.fused_forward_plain_backward(grid, coords, ws, bs, nf, g, precision)
        dgrid2, dws2, dbs2 = ff.fused_forward_backward_cuda(grid, coords, ws, bs, nf, g,
                                                            precision)
        dfeat, _, _ = ff.fused_forward_backward_dx_cuda(grid, coords, ws, bs, nf, g, precision)
        routed = (grid_sample_channel_minor_backward_bf16 if precision == 'bf16'
                  else grid_sample_channel_minor_backward)(dfeat.cpu(), coords.cpu(), D, H, W)
        feats = (gs.grid_sample_channel_minor_bf16_cuda(grid, coords)
                 if precision == 'bf16' else gs.grid_sample_channel_minor_cuda(grid, coords))
        route = mf.mlp_fused_cuda(ws, bs, torch.cat(
            [coords, fourier_embed(coords, nf), feats], dim=-1),
            'f32' if precision == 'f32' else 'bf16')
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        grad_err, grad_rel = compare_grads([dgrid] + dws + dbs, [rdg] + rdws + rdbs)
        route_err = rel(out, route)
    where = f'{case}, {precision}'
    fwd_tol, grad_tol = MLP_TOL['f32' if precision == 'f32' else 'bf16']
    check(all(bool(torch.isfinite(t).all()) for t in [out, dgrid] + dws + dbs),
          f'non-finite fused output or gradient ({where})')
    check(err <= fwd_tol * ref.abs().max().item(), f'fused forward vs plain {err} ({where})')
    check(grad_rel <= grad_tol, f'fused backward vs plain {grad_rel} ({where})')
    check(all(torch.equal(a, b) for a, b in zip([dgrid] + dws + dbs, [dgrid2] + dws2 + dbs2)),
          f'fused dG, dW, db differ in a second call ({where})')
    check(torch.equal(dgrid.cpu(), routed),
          f"fused dG is not the plain routing of the kernel's dX on the CPU ({where})")
    route_tol = ROUTE_TOL if precision == 'f32' else fwd_tol
    check(route_err <= route_tol, f'fused forward vs fetch + MLP kernels {route_err} ({where})')
    bound, bound_by = mlp_bound_ms(n, dims, precision, fetch=(C, D, H, W))
    bwd_bound, bwd_bound_by = mlp_bound_ms(n, dims, precision, backward=True,
                                           fetch=(C, D, H, W))
    chain = mlp_apply_bf16 if precision == 'bf16' else mlp_apply

    def library(grid, *p):
        x = torch.cat([coords, fourier_embed(coords, nf),
                       gs.fetch(grid, coords, fetch_precision)], dim=-1)
        return chain(p[:len(ws)], p[len(ws):], x)
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
    row = {'phase': phase, 'case': case, 'grid': [D, H, W, C],
           'dims': dims, 'n': n, 'precision': precision, 'max_abs_err': err,
           'max_abs_output': ref.abs().max().item(),
           'bwd_max_abs_err': grad_err, 'bwd_max_rel_err': grad_rel,
           'bwd_dG_equal_to_cpu_routing_of_its_dx': True,
           'vs_fetch_and_mlp_kernels_rel': route_err,
           **times, 'bound_ms': bound, 'bound_by': bound_by,
           'bwd_bound_ms': bwd_bound, 'bwd_bound_by': bwd_bound_by,
           'fwd_launch': mf.fwd_plan(ff.KERNEL, dims, precision),
           'bwd_launch': mf.bwd_plan(ff.KERNEL, dims, precision)}
    emit(row)
    return row


def phase_kernel_fused(model, grid_cl):
    """The one-kernel forward and backward ('mixed' and 'f32') against
    their plain versions and the default route, on the flagship grid and
    weights at one train step's batch (trainer positions, the main path's
    input, and uniform coordinates with some out of range), and on a C = 8,
    9^3 grid with a 3 x 16 MLP."""
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
        g = torch.randn((n, bs[-1].shape[0]), device='cuda', generator=gen)
        for precision in ('mixed', 'f32'):
            rows.append(fused_row('kernel_fused', case, grid, coords, ws, bs, nf, g,
                                  precision))
    return rows


def phase_kernel_bf16(model, grid_cl):
    """The 'bf16' fetch and gradient kernels against their plain versions at
    the shapes of the bf16 compute path (the flagship on a lattice chunk
    and on one train step's trainer positions) and at grid 23, C 5 and C 22
    on 17^3; then the one-kernel 'bf16' forward and backward at the flagship (trainer
    positions)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    rows = []
    lattice = lattice_chunk(lattice_constants(VolumeMeta((VOLUME_N,) * 3), CHUNK,
                                              torch.device('cuda')), 32 * CHUNK)[0]
    fwd_cases = [(16, 15, 'lattice', CHUNK), (16, 15, 'trainer', TRAIN_BATCH),
                 (16, 23, 'uniform', CHUNK), (5, 15, 'uniform', CHUNK),
                 (22, 17, 'trainer', TRAIN_BATCH)]
    bwd_cases = [(16, 15, 'trainer', TRAIN_BATCH), (16, 4, 'uniform', TRAIN_BATCH),
                 (16, 23, 'uniform', TRAIN_BATCH), (5, 15, 'uniform', TRAIN_BATCH),
                 (22, 17, 'trainer', TRAIN_BATCH)] + CROWDED

    def coords_of(kind, n, G):
        if kind == 'lattice':
            return lattice
        return grad_coords(kind, n, G, gen)
    with torch.no_grad():
        for C, G, kind, n in fwd_cases:
            feats = torch.randn((C, G, G, G), device='cuda', generator=gen)
            coords = coords_of(kind, n, G)
            grid = channel_minor(feats)
            out = gs.grid_sample_channel_minor_bf16_cuda(grid, coords)
            plain = grid_sample_channel_minor_bf16(grid, coords)
            feats16, coords16 = feats.to(torch.bfloat16)[None], coords.to(torch.bfloat16)

            def library():
                return F.grid_sample(feats16, coords16.view(1, n, 1, 1, 3), mode='bilinear',
                                     padding_mode='zeros', align_corners=False)
            torch.cuda.synchronize()
            case = f'bf16 fetch C={C}, G={G}, {kind} coords'
            check(torch.equal(out, plain), f'{case}: not its plain version bit for bit')
            bound, bound_by = fetch_bound_ms(n, C, G, G, G)
            row = {'phase': 'kernel_bf16', 'name': gs.BF16_KERNEL, 'C': C, 'grid': G,
                   'n': n, 'coords': kind, 'max_abs_err': (out - plain).abs().max().item(),
                   'max_rel_err': 0.0,
                   'kernel_ms': time_ms(
                       lambda: gs.grid_sample_channel_minor_bf16_cuda(grid, coords)),
                   'plain_ms': time_ms(lambda: grid_sample_channel_minor_bf16(grid, coords)),
                   'library_ms': time_ms(library),
                   'bound_ms': bound, 'bound_by': bound_by,
                   'plan': gs.fwd_plan(n, C, G, G, G, gs._vec4(C, grid, out), 'bf16')}
            emit(row)
            rows.append(row)
    for C, G, kind, n in bwd_cases:
        coords = coords_of(kind, n, G)
        grad = torch.randn((n, C), device='cuda', generator=gen)
        with torch.no_grad():
            out = gs.grid_sample_channel_minor_backward_bf16_cuda(grad, coords, G, G, G)
            again = gs.grid_sample_channel_minor_backward_bf16_cuda(grad, coords, G, G, G)
            plain = grid_sample_channel_minor_backward_bf16(grad.cpu(), coords.cpu(), G, G, G)
        torch.cuda.synchronize()
        case = f'bf16 gradient C={C}, G={G}, {kind} coords'
        check(bool(torch.isfinite(out).all()), f'non-finite output ({case})')
        check(torch.equal(out.cpu(), plain), f'{case}: not its plain version on the CPU bit '
                                             f'for bit')
        check(torch.equal(out, again), f'{case}: another dG in a second call')
        # the library: F.grid_sample's autograd backward on a bf16 input and grid
        feats16 = torch.zeros((1, C, G, G, G), device='cuda', dtype=torch.bfloat16,
                              requires_grad=True)
        coords16 = coords.to(torch.bfloat16).view(1, n, 1, 1, 3)
        grad16 = grad.t().reshape(1, C, n, 1, 1).to(torch.bfloat16)

        def library():
            torch.autograd.grad(F.grid_sample(feats16, coords16, mode='bilinear',
                                              padding_mode='zeros', align_corners=False),
                                feats16, grad16)
        bound, bound_by = grad_bound_ms(n, C, G, G, G)
        with torch.no_grad():
            row = {'phase': 'kernel_bf16', 'name': gs.BF16_BWD_KERNEL, 'C': C, 'grid': G,
                   'n': n, 'coords': kind,
                   'max_abs_err': (out.cpu() - plain).abs().max().item(),
                   'max_rel_err': 0.0, 'equal_to_cpu_plain': True,
                   'equal_in_a_second_call': True, 'max_abs_dG': plain.abs().max().item(),
                   'kernel_ms': time_ms(lambda: gs.grid_sample_channel_minor_backward_bf16_cuda(
                       grad, coords, G, G, G)),
                   'plain_ms': time_ms(lambda: grid_sample_channel_minor_backward_bf16(
                       grad, coords, G, G, G))}
        row.update({'library_ms': time_ms(library), 'bound_ms': bound, 'bound_by': bound_by,
                    'latency_floor_ms': grad_latency_ms(coords, G, G, G),
                    'plan': gs.bwd_plan(n, C, G, G, G, 'bf16')})
        emit(row)
        rows.append(row)
    ws, bs = [w.detach() for w in model.mlp_w], [b.detach() for b in model.mlp_b]
    g = torch.randn((TRAIN_BATCH, bs[-1].shape[0]), device='cuda', generator=gen)
    rows.append(fused_row('kernel_bf16', 'flagship, trainer coords', grid_cl.detach(),
                          trainer_positions(TRAIN_BATCH, gen), ws, bs, model.spec.n_freqs,
                          g, 'bf16'))
    return rows


# the inference head's cases: (C, samples); a chunk, a ragged chunk, a
# query request of 2^20 points
HEAD_CASES = [(C, n) for C in ih.CHANNELS for n in (CHUNK, CHUNK - 37, 1 << 20)]
HEAD_TOL = 1e-6       # float32 sums in another order than cuBLAS's
HEAD_STEPS = 20       # graphed training steps whose head launches are counted


def head_bound_ms(n, C, dims):
    """Least time for the inference head: its operations (the embedding's
    multiply, sine and cosine a coordinate and frequency, the MLP's
    products, biases and SnakeAlt at 4 an entry, the clamp) over the
    float32 peak, or its bytes (coordinates and features read, output
    written, the parameters read once), whichever takes longer."""
    emb = 3 * FLAGSHIP['n_freqs'] * FLAGSHIP['d_in']
    mlp = sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:])) + 4 * sum(dims[1:-1])
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (n * (FLAGSHIP['d_in'] + C + dims[-1]) + params)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, n * (emb + mlp + 1) / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


@torch.no_grad()
def phase_kernel_head(model, grid_cl):
    """The inference-head kernel against its plain version (the ATen chain:
    ``torch.cat`` of [coords | fourier_embed | feats], ``mlp_apply`` on
    cuBLAS, ``clamp``) and their times, at C 16 on the flagship's weights
    and grid (lattice coordinates for a chunk, uniform ones for 2^20) and
    at C 22 on random weights and a random 17^3 grid; then the kernel's
    launches on the paths that reach it: a 255^3 evaluation graphed (the
    default) and eager, a query request with no gradient and with one, and
    a chunk of graphed training steps."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    nf = model.spec.n_freqs
    flagship = ([w.detach() for w in model.mlp_w], [b.detach() for b in model.mlp_b])
    grid22 = torch.randn((17, 17, 17, 22), device='cuda', generator=gen)
    lattice = lattice_constants(VolumeMeta((VOLUME_N,) * 3), CHUNK, torch.device('cuda'))
    rows = []
    for C, n in HEAD_CASES:
        if C == 16:
            ws, bs = flagship
            grid = grid_cl
        else:
            ws, bs = random_mlp([3 + 6 * nf + C] + [32] * 4 + [1], gen)
            grid = grid22
        if C == 16 and n <= CHUNK:
            coords = lattice_chunk(lattice, 32 * CHUNK)[0][:n].contiguous()
        else:
            coords = torch.rand((n, 3), device='cuda', generator=gen) * 2 - 1
        feats = gs.fetch(grid, coords)
        out = ih.inference_head_cuda(coords, feats, ws, bs)
        ref = ih.inference_head_plain(coords, feats, ws, bs, nf)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        case = f'C={C}, n={n}'
        check(bool(torch.isfinite(out).all()), f'non-finite inference head output ({case})')
        check(err <= HEAD_TOL, f'inference head vs plain {err} > {HEAD_TOL} ({case})')
        dims = ih.check_widths(ws, bs, C)
        bound, bound_by = head_bound_ms(n, C, dims)
        row = {'phase': 'kernel_head', 'name': ih.KERNEL, 'C': C, 'n': n, 'dims': dims,
               'max_abs_err': err, 'max_abs_output': ref.abs().max().item(),
               'kernel_ms': time_ms(lambda: ih.inference_head_cuda(coords, feats, ws, bs)),
               'plain_ms': time_ms(lambda: ih.inference_head_plain(coords, feats, ws, bs,
                                                                   nf)),
               'bound_ms': bound, 'bound_by': bound_by,
               'plan': ih.plan(C, len(ws) - 1, n)}
        emit(row)
        rows.append(row)
    launches = {}
    meta = VolumeMeta((VOLUME_N,) * 3)
    fields = {}
    for graphs in (None, False):
        before = ih.launches
        fields[graphs] = field_on_device(model, meta, graphs=graphs)
        launches['decompress' if graphs is None else 'decompress_eager'] = \
            ih.launches - before
    check(torch.equal(fields[None], fields[False]), 'graphed field differs from eager')
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    check(launches['decompress'] == launches['decompress_eager'] == n_chunks,
          f'evaluation launched the inference head {launches}, expected {n_chunks}')
    coords = torch.rand((1 << 20, 3), device='cuda', generator=gen) * 2 - 1
    before = ih.launches
    out = apply_model(model, coords, train=False)
    launches['query'] = ih.launches - before
    with torch.enable_grad():
        before = ih.launches
        out_grad = apply_model(model, coords, train=False)
        launches['query_grad'] = ih.launches - before
    err = (out - out_grad.detach()).abs().max().item()
    check(launches['query'] == 1 and launches['query_grad'] == 0 and err <= HEAD_TOL,
          f'query launched the inference head {launches}, kernel vs chain {err}')
    before = ih.launches
    with torch.enable_grad():
        flagship_chunks('', True, steps=HEAD_STEPS)()
    launches['train'] = ih.launches - before
    check(launches['train'] == 0, f'training launched the inference head {launches}')
    emit({'phase': 'kernel_head', 'launches': launches, 'query_max_abs_err': err})
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


# what each evaluation mode gives (``eval_modes``)
EVAL_OUTPUTS = ('field', 'sums', 'stats')


def eval_modes(model, meta, vol_dev):
    """The 255^3 evaluation's field (``field_on_device``), per-chunk sums
    (``chunk_sums``) and four stats (``eval_stats_on_device``) eagerly
    (``graphs=False``) and by the default, which on a card, at 64 chunks
    (``GRAPH_MIN_CHUNKS`` or more), captures the chunk body once an
    evaluation (``trainer.capture_graph``, counted here) and replays it a
    chunk.  Each evaluation launches the fetch once a
    chunk, counted through the replays; the default captures once an
    evaluation and eager never; graphed equals eager ``torch.equal``; no
    evaluation graph is left in the trainer's registry of live graphs."""
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    calls = {
        'field': lambda graphs: field_on_device(model, meta, graphs=graphs),
        'sums': lambda graphs: chunk_sums(model, meta, vol_dev, graphs=graphs),
        'stats': lambda graphs: eval_stats_on_device(model, meta, vol_dev, graphs=graphs)}
    captures = []
    capture = tr.capture_graph

    def counted_capture(*a, **k):
        captures.append(1)
        return capture(*a, **k)
    live = set(tr._live_graphs)
    out = {}
    with mock.patch.object(tr, 'capture_graph', counted_capture):
        for mode in MODES:
            graphs = None if mode == 'graphed' else False
            out[mode] = {}
            captures.clear()
            for name in EVAL_OUTPUTS:
                reset_counts()
                out[mode][name] = calls[name](graphs)
                counts = read_counts()
                check(counts == only({gs.KERNEL: n_chunks, ih.KERNEL: n_chunks}),
                      f'{mode} {name} evaluation launched {counts}, expected the fetch '
                      f'and the inference head {n_chunks} times')
            want = len(EVAL_OUTPUTS) if mode == 'graphed' else 0
            check(len(captures) == want, f'{mode}: {len(captures)} captures, expected {want}')
    left = set(tr._live_graphs) - live
    check(not left, f'{len(left)} evaluation graphs outlived their calls')
    for name in EVAL_OUTPUTS:
        a, b = out['eager'][name], out['graphed'][name]
        same = torch.equal(a, b) if torch.is_tensor(a) else a == b
        check(same, f'graphed {name} differs from eager')
    return out


# volumes of (64 k, 64, 64), k whole chunks each, for eval_mode_pairs
EVAL_PAIR_CHUNKS = (1, 2, 4, 8, 16, 64)
EVAL_PAIR_ROUNDS = 9


@torch.no_grad()
def eval_mode_pairs(model):
    """Eager against graphed evaluations (``field_on_device``, the field
    left on the card, decode and the graphed mode's warm-up, capture and
    destruction included) in repeated pairs on volumes of k whole chunks:
    each round times one of each mode, in turns (eager first in even
    rounds, graphed first in odd ones), on the host's clock with the card
    synchronised before and after.  By k: each mode's median, least and
    most ms, and the median over rounds of graphed / eager within a round."""
    out = {}
    for k in EVAL_PAIR_CHUNKS:
        meta = VolumeMeta((64 * k, 64, 64))
        ms = {mode: [] for mode in MODES}
        for r in range(EVAL_PAIR_ROUNDS + 1):
            for mode in (MODES if r % 2 == 0 else MODES[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                field_on_device(model, meta, graphs=mode == 'graphed')
                torch.cuda.synchronize()
                if r:   # round 0 warms both modes at this size
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
        out[k] = {**{mode: {'median_ms': statistics.median(v), 'min_ms': min(v),
                            'max_ms': max(v)} for mode, v in ms.items()},
                  'graphed_over_eager_median': statistics.median(
                      g / e for g, e in zip(ms['graphed'], ms['eager']))}
    return out


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
    check(counts == only({gs.KERNEL: n_chunks, ih.KERNEL: n_chunks}),
          f'decompression launched {counts}, expected the fetch and the inference head '
          f'{n_chunks} times')

    volume = load_volume(vol_path)
    vol_dev = torch.from_numpy(volume).cuda()
    modes = eval_modes(model, meta, vol_dev)
    field = torch.from_numpy(field_from_net(model, meta)).cuda()
    check(torch.equal(field, modes['graphed']['field']),
          'field_from_net differs from the graphed field on the card')
    check(bool(torch.isfinite(field).all()), 'non-finite field')
    check(float(field.min()) >= -1.0 and float(field.max()) <= 1.0,
          'field outside [-1, 1]')
    psnr_dev = modes['graphed']['stats'][0]
    check(abs(psnr_dev - psnr_host) <= PSNR_TOL_DB,
          f'device PSNR {psnr_dev} vs host PSNR {psnr_host}')
    field_err = (field - plain_field(model, meta)).abs().max().item()
    check(field_err <= FIELD_TOL, f'kernel field vs plain field {field_err}')

    # steady-state end-to-end rates, decode (and the graphed mode's capture)
    # included: best of 3 rounds, eager and graphed in turns, after the runs
    # above; on-device stats, and the field brought to the host
    eval_s = {mode: [] for mode in MODES}
    field_s = {mode: [] for mode in MODES}
    for _ in range(3):
        for mode in MODES:
            graphs = None if mode == 'graphed' else False
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_stats_on_device(model, meta, vol_dev, graphs=graphs)
            eval_s[mode].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            field_from_net(model, meta, graphs=graphs)
            field_s[mode].append(time.perf_counter() - t0)
    rates = {mode: {'eval_stats_s': min(eval_s[mode]),
                    'voxels_per_s_device_stats': meta.n_voxels / min(eval_s[mode]),
                    'field_to_host_s': min(field_s[mode]),
                    'voxels_per_s_field_to_host': meta.n_voxels / min(field_s[mode])}
             for mode in MODES}
    time_split(model, meta, vol_dev)
    split, split_sums = time_split(model, meta, vol_dev)
    check(torch.equal(split_sums, modes['eager']['sums']),
          "time_split's per-chunk sums differ from the evaluation's")
    prof = {mode: profile_eval(model, meta, vol_dev, None if mode == 'graphed' else False)
            for mode in MODES}
    pairs = eval_mode_pairs(model)
    emit({'phase': 'checkpoint', 'voxels': meta.n_voxels, 'chunks': n_chunks,
          'launches': launches, 'psnr_host_f64': psnr_host,
          'psnr_device': psnr_dev, 'l1': l1, 'mse': mse, 'rmse': rmse,
          'field_vs_plain_max_abs': field_err,
          'infer_s': infer_s, **rates['graphed'], 'eager': rates['eager'],
          'split_ms': split, 'profile': prof, 'mode_pairs': pairs})
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
    live = set(tr._live_graphs)
    captures = []
    capture = tr.capture_graph

    def counted_capture(*a, **k):
        captures.append(1)
        return capture(*a, **k)
    reset_counts()
    with mock.patch.object(tr, 'capture_graph', counted_capture):
        field = torch.from_numpy(field_from_net(model, meta)).cuda()
    counts = read_counts()
    launches = counts[gs.KERNEL]
    # the golden container's 4 features: widths the inference head does not take
    check(counts == only({gs.KERNEL: 1, ih.KERNEL: int(ih.takes(spec))}),
          f'binary path launched {counts}')
    # one chunk, under GRAPH_MIN_CHUNKS: the default steps it eagerly
    check(not captures, f'the one-chunk evaluation captured {len(captures)} graphs')
    check(not set(tr._live_graphs) - live, "the binary path's evaluation graph outlived it")
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
    bf16 = spec.compute_dtype == 'bfloat16'
    if spec.interp_backend == 'fused':
        out = ff.fused_forward_plain(grid_cl, coords, ws, bs, spec.n_freqs,
                                     'bf16' if bf16 else 'mixed')
    elif bf16:
        x = torch.cat([coords, fourier_embed(coords, spec.n_freqs),
                       grid_sample_channel_minor_bf16(grid_cl, coords)], dim=-1)
        out = mlp_apply_bf16(ws, bs, x)
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
    want = only({'': {gs.KERNEL: k, ih.KERNEL: k},
                 '_mlp_pallas': {gs.KERNEL: k, 'mlp_fused_fwd': k},
                 '_fused': {'fused_forward_fwd': k},
                 '_bf16': {gs.BF16_KERNEL: k},
                 '_bf16_fused': {'fused_forward_fwd_bf16': k}}[suffix])
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


# kernels by the names the profiler gives them (the fetch's and the
# gradient's two modes are instantiations of their kernels, under
# 'grid_sample_fwd_kernel' and 'grid_sample_bwd'; the one-kernel pair's
# 'mixed' and 'bf16' run the same kernels)
PROFILED_KERNELS = ('grid_sample_fwd_kernel',
                    'grid_sample_bwd', 'mlp_fwd_kernel', 'mlp_bwd_kernel',
                    'fused_fwd_kernel', 'fused_bwd_kernel', 'reduce_slots_kernel')


# the steps of a chunk of the chunk runner's timings and profiles: the
# flagship config's steps_per_chunk
GRAPH_CHUNK = 200
# host calls that launch device work: a kernel (the CUDA runtime's entries
# and libcuda's) or a CUDA graph
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cudaLaunchKernelEx',
                'cuLaunchKernel', 'cuLaunchKernelEx', 'cudaGraphLaunch', 'cuGraphLaunch')
# at most this many host launch calls a graphed step, over a whole chunk
# (its draws, loads and device read included)
MAX_GRAPHED_LAUNCH_CALLS = 1.5
# the steps of an eager profiled chunk: the profiler's events of an eager
# step (its operators and their launches) take the host seconds to collect
EAGER_PROFILE_STEPS = 50
# traces of a mode's profiled chunk before a trace that lacks kernel
# records of the step's graph fails the phase (``profile_modes``)
PROFILE_ATTEMPTS = 4
# the training paths timed with and without the step's CUDA graph: each
# backend under smallify, and dynamic variational (the most launches)
STEP_PATHS = {**{'train' + suffix: (suffix, FLAGSHIP_CONFIG) for suffix in BACKENDS},
              'train_dynamic_variational': (
                  '', os.path.join(CONFIGS, FAMILIES['dynamic_variational'][0]))}
MODES = ('eager', 'graphed')


def flagship_state(suffix, config=FLAGSHIP_CONFIG, vol=None, drop_type=None):
    """A fresh flagship phase-1 state of the gate family of ``config``
    (smallify by default; ``drop_type`` in its place where given, as
    FAMILIES' straight-through) under the backend ``suffix`` of BACKENDS (a fresh
    model, and variance model for the dynamic family; the step's work does
    not depend on the values), at the config's published max_pass: (phase
    spec, state, volume on the card: ``vol`` or a random 255^3 one)."""
    cfg = load_config(config)
    if drop_type is not None:
        cfg = dataclasses.replace(cfg, drop_type=drop_type)
    spec = make_spec(**dict(FLAGSHIP, drop_type=cfg.drop_type,
                            drop_momentum=cfg.drop_momentum,
                            drop_threshold=cfg.drop_threshold), **BACKENDS[suffix][0])
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(spec, gen, device='cuda')
    variance = None
    if is_dynamic(spec.drop_type):
        variance = tuple([t.cuda() for t in ts] for ts in init_variance_model(gen))
    if vol is None:
        vol = torch.rand((VOLUME_N,) * 3, device='cuda') * 2 - 1
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta(tuple(vol.shape)), phase=1)
    st = tr.init_train_state(model, cfg.lr, cfg.lr, train_gates=True, variance=variance,
                             weight_dkl=cfg.lambda_drop_loss)
    return ph, st, vol


def flagship_chunks(suffix, graphs, config=FLAGSHIP_CONFIG, steps=GRAPH_CHUNK):
    """solve_phase's chunk machinery (``trainer.ChunkRunner``) over a fresh
    flagship phase-1 state (``flagship_state``), with the step's CUDA graph
    or eager steps: a function that runs the next chunk of ``steps`` steps
    (its positions and noise drawn from the phase's generators, then
    ``ChunkRunner.chunk``: the loads, the steps, the one device read) and
    returns its host seconds.  One chunk (kernel builds, warm-up and
    capture) runs before it is returned."""
    ph, st, vol = flagship_state(suffix, config)
    c = tr.PhaseConstants(ph, vol)
    runner = tr.ChunkRunner(ph, st, c, ph.batch_n, steps, graphs=graphs)
    gens = [torch.Generator(device='cuda').manual_seed(SEED + i) for i in range(2)]

    def chunk():
        t0 = time.perf_counter()
        pos = tr.draw_positions(c, steps, ph.batch_n, gens[0])
        runner.chunk(pos, tr.draw_noise(ph, steps, gens[1], vol.device))
        return time.perf_counter() - t0
    chunk()
    return chunk


def is_nccl_kernel(name):
    """Whether a kernel's name is one of NCCL's (``ncclDevKernel_*``, and
    ``ncclKernel_*`` in NCCL before 2.19), not an annotation such as
    'nccl:all_reduce'."""
    return 'ncclDevKernel' in name or 'ncclKernel' in name


def profile_train_steps(chunk, steps, graphs):
    """One chunk of ``steps`` flagship phase-1 steps (``chunk``, from
    ``flagship_chunks``: its draws, the steps, its device read) under
    torch.profiler, with the step's CUDA graph or eager steps: the host
    clock around the chunk (it ends in a device read), the device's busy
    and idle share, device kernels a step, host calls that launch device
    work (LAUNCH_CALLS) a step, and each of PROFILED_KERNELS' device time,
    records and records a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = chunk() * 1e3
    events = prof.key_averages()
    # the card's kernels, memcpys and memsets; not the spans of host
    # annotations the trace also puts on the card's timeline (NCCL's
    # 'nccl:all_reduce', the mesh's 'mesh::all_reduce'), which cover them
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False)), reverse=True)
    # host side: time inside PyTorch's operators (exclusive), by operator;
    # the rest of the wall time is Python between them
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events if e.device_type == DeviceType.CPU), reverse=True)
    launch_calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
    busy_ms = sum(r[0] for r in rows)
    calls = {name: sum(r[2] for r in rows if name in r[1]) for name in PROFILED_KERNELS}
    nccl = [r for r in rows if is_nccl_kernel(r[1])]
    return {'steps': steps, 'graphs': graphs, 'wall_ms': wall_ms,
            'ms_per_step': wall_ms / steps,
            'samples_per_sec': steps * TRAIN_BATCH / (wall_ms / 1e3),
            'device_busy_ms': busy_ms,
            'device_idle_share': 1.0 - busy_ms / wall_ms if busy_ms else None,
            'host_launch_calls_per_step': sum(launch_calls.values()) / steps,
            'host_launch_calls': launch_calls,
            'host_op_ms': sum(r[0] for r in host),
            'top_host_ops': [{'ms': ms, 'name': k[:60], 'calls': n}
                             for ms, k, n in host[:10]],
            'kernel_launches_per_step': sum(r[2] for r in rows) / steps,
            'kernel_ms': {name: sum(r[0] for r in rows if name in r[1])
                          for name in PROFILED_KERNELS},
            'kernel_calls': calls,
            'kernel_calls_per_step': {name: n / steps for name, n in calls.items()},
            # the mesh's: NCCL's kernels, and the host's time inside the
            # collectives' calls (mesh::*, their record_function spans)
            'nccl_kernels_per_step': sum(r[2] for r in nccl) / steps,
            'nccl_device_ms_per_step': sum(r[0] for r in nccl) / steps,
            'collective_host_ms_per_step': sum(
                e.cpu_time_total for e in events if e.key.startswith('mesh::')) / 1e3 / steps,
            'top_kernels': [{'ms': ms, 'name': k[:80], 'calls': n}
                            for ms, k, n in rows[:10]]}


def profile_modes(suffix='', config=FLAGSHIP_CONFIG):
    """The flagship phase-1 step of the family of ``config`` under the
    backend ``suffix`` of BACKENDS, profiled (``profile_train_steps``)
    graphed (a whole chunk, GRAPH_CHUNK), then eager (a chunk of
    EAGER_PROFILE_STEPS).  The step's graph, captured for the graphed
    chunks by trainer.capture_graph and kept for inspection
    (``CUDAGraph(keep_graph=True)``), gives each of PROFILED_KERNELS'
    launches a step: its kernel nodes (``graph_kernel_names``; a replay
    runs each node once).  The profiler now and then loses kernel records
    of a graphed chunk (on an H100 under torch 2.11, a smoke run's trace
    once held the fetch kernel 0.87 times a step): a trace whose records of PROFILED_KERNELS are not the step's nodes
    times its steps is set aside, with each kernel's records missing under
    'incomplete_traces', and the next chunk is profiled in its place, up to
    PROFILE_ATTEMPTS traces a mode.  The kept trace of each mode has each
    of PROFILED_KERNELS a step as often as the graph has nodes of it, and
    the graphed one at most MAX_GRAPHED_LAUNCH_CALLS host launch calls a
    step."""
    graphs, kept = kept_graphs()
    with mock.patch.object(torch.cuda, 'CUDAGraph', kept):
        chunks = {'graphed': flagship_chunks(suffix, True, config, GRAPH_CHUNK)}
    graphs = step_graphs(graphs)
    check(len(graphs) == 1, f'{len(graphs)} graphs captured for one phase')
    nodes = graph_kernel_names(graphs[0])
    per_step = {name: sum(n for k, n in nodes.items() if name in k)
                for name in PROFILED_KERNELS}
    chunks['eager'] = flagship_chunks(suffix, False, config, EAGER_PROFILE_STEPS)
    out = {}
    for mode, steps in (('graphed', GRAPH_CHUNK), ('eager', EAGER_PROFILE_STEPS)):
        lost = []
        for _ in range(PROFILE_ATTEMPTS):
            prof = profile_train_steps(chunks[mode], steps, mode == 'graphed')
            missing = {name: per_step[name] * steps - prof['kernel_calls'][name]
                       for name in PROFILED_KERNELS}
            if not any(missing.values()):
                break
            lost.append({name: n for name, n in missing.items() if n})
        prof['incomplete_traces'] = lost
        out[mode] = prof
        check(not any(missing.values()),
              f'{mode}: every one of {PROFILE_ATTEMPTS} traces lacked kernels of the '
              f"step's graph {per_step}: {lost}")
    out['graph_nodes'] = {'kernel': sum(n for k, n in nodes.items() if not k.startswith('<')),
                          **{k: n for k, n in nodes.items() if k.startswith('<')},
                          'profiled_kernels': per_step}
    calls = out['graphed']['host_launch_calls_per_step']
    check(calls <= MAX_GRAPHED_LAUNCH_CALLS,
          f'{calls} host launch calls a graphed step ({out["graphed"]["host_launch_calls"]})')
    for name in PROFILED_KERNELS:
        got = [out[mode]['kernel_calls_per_step'][name] for mode in MODES]
        check(got[0] == got[1] == per_step[name],
              f"{name} a step eager and graphed: {got}, the step's graph {per_step[name]}")
    return out


def run_train(tmp, vol_path, path, graphs, max_pass):
    """train_torch.py at ``max_pass`` on ``path`` of STEP_PATHS, its phases
    with or without the step's CUDA graph (solve_phase's keyword, which the
    CLI does not take): (info, seconds of the call)."""
    import functools
    import train_torch
    from latent_feature_grid_compression_tpu_torch.train import run as run_mod
    suffix, config = STEP_PATHS[path]
    flags = BACKENDS[suffix][1] + (FAMILIES['dynamic_variational'][1]
                                   if config != FLAGSHIP_CONFIG else [])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with mock.patch.object(run_mod, 'solve_phase',
                               functools.partial(tr.solve_phase, graphs=graphs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = train_torch.main(['--config', config, '--data', vol_path,
                                     '--max_pass', str(max_pass), '--basedir', '/',
                                     '--expname', path + '_turns', *flags])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    shutil.rmtree(os.path.join(tmp, path + '_turns'))
    return info, seconds


# the depth of step_rates' train_torch.py runs, graphed against eager: the
# published 60 passes cut to 1 (the eager runs are the smoke's slowest
# training; the train phases run every path graphed at TRAIN_MAX_PASS)
STEP_RATES_MAX_PASS = 1


def phase_step_rates(rounds=2, steps=GRAPH_CHUNK, modes=MODES, tmp=None, vol_path=None,
                     eager_steps=None):
    """Steady flagship phase-1 step time of every path of STEP_PATHS with
    the step's CUDA graph and with eager steps, without the profiler: host
    clock around chunks of ``steps`` steps (``eager_steps`` eager, where
    given: an eager step is host-bound, the same each step;
    ``flagship_chunks``: the draws, the loads, the steps, the one device
    read), the paths and modes in turns and the order reversed every other
    round, so that a drift of the shared host falls on all of them alike.  With ``tmp``: each path
    through train_torch.py at STEP_RATES_MAX_PASS, graphed then eager: the
    PSNR equal to every digit (the steps are bit for bit), and both calls'
    seconds."""
    order = [(path, mode) for path in STEP_PATHS for mode in modes]
    n = {'graphed': steps, 'eager': eager_steps or steps}
    runs = {(path, mode): flagship_chunks(STEP_PATHS[path][0], mode == 'graphed',
                                          STEP_PATHS[path][1], n[mode])
            for path, mode in order}
    ms = {key: [] for key in order}
    for r in range(rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            ms[key].append(runs[key]() * 1e3 / n[key[1]])
    del runs
    row = {'phase': 'step_rates', 'rounds': rounds, 'steps': n, 'batch': TRAIN_BATCH,
           'ms_per_step': {}, 'median_samples_per_sec': {}}
    for (path, mode), v in ms.items():
        row['ms_per_step'][f'{path}_{mode}'] = v
        row['median_samples_per_sec'][f'{path}_{mode}'] = \
            TRAIN_BATCH / (statistics.median(v) / 1e3)
    if tmp is not None:
        row['train_cli'] = {'max_pass': STEP_RATES_MAX_PASS}
        for path in STEP_PATHS:
            runs = {mode: run_train(tmp, vol_path, path, mode == 'graphed',
                                    STEP_RATES_MAX_PASS) for mode in ('graphed', 'eager')}
            (graphed, graphed_s), (info, seconds) = runs['graphed'], runs['eager']
            check(info['psnr'] == graphed['psnr'],
                  f"{path}: train-{STEP_RATES_MAX_PASS} PSNR eager {info['psnr']}, graphed "
                  f"{graphed['psnr']}")
            row['train_cli'][path] = {
                'eager_cli_s': seconds, 'eager_psnr': info['psnr'],
                'eager_phase_s': [info[f'train_phase{p}_seconds'] for p in (1, 2)],
                'graphed_cli_s': graphed_s, 'graphed_psnr': graphed['psnr'],
                'graphed_phase_s': [graphed[f'train_phase{p}_seconds'] for p in (1, 2)]}
    emit(row)
    return row


def phase_train(tmp, vol_path, suffix='', default=None, family=None, keep=False):
    """The training path under the backend ``suffix`` of BACKENDS through its
    CLI, from counts at 0 to the export; ``default``: the info of the
    default backend's run, whose PSNR a kernel backend's must be within
    PSNR_BACKEND_DB of.  ``family``: a gate family of FAMILIES, trained from
    its config under the default backend in place of the flagship.
    ``keep``: leave the experiment directory for the resume phase."""
    import train_torch
    path = 'train' + suffix if family is None else 'train_' + family
    config, flags = ((FLAGSHIP_CONFIG, BACKENDS[suffix][1]) if family is None else
                     (os.path.join(CONFIGS, FAMILIES[family][0]), FAMILIES[family][1]))
    meta = VolumeMeta((VOLUME_N,) * 3)
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = train_torch.main(['--config', config, '--data', vol_path,
                                 '--max_pass', str(TRAIN_MAX_PASS), '--basedir', '/',
                                 '--expname', path, *flags])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        warmup_steps = tr.warmup_steps
    finally:
        os.chdir(cwd)
    exp = os.path.join(tmp, path)
    steps = info['train_phase1_steps'] + info['train_phase2_steps']
    # each kernel of the path once a step (the one-kernel backward routes
    # dX's features through the gradient kernel); the final evaluation (the
    # float32 fetch and the plain MLP whatever the backend) fetches once a
    # chunk
    want = only({ih.KERNEL: n_chunks,
                 **{'': {gs.KERNEL: steps + n_chunks, gs.BWD_KERNEL: steps},
                    '_mlp_pallas': {gs.KERNEL: steps + n_chunks, gs.BWD_KERNEL: steps,
                                    'mlp_fused_fwd': steps, 'mlp_fused_bwd': steps},
                    '_fused': {gs.KERNEL: n_chunks, 'fused_forward_fwd': steps,
                               'fused_forward_bwd': steps, gs.BWD_KERNEL: steps},
                    '_bf16': {gs.KERNEL: n_chunks, gs.BF16_KERNEL: steps,
                              gs.BF16_BWD_KERNEL: steps},
                    '_bf16_fused': {gs.KERNEL: n_chunks, 'fused_forward_fwd_bf16': steps,
                                    'fused_forward_bwd_bf16': steps,
                                    gs.BF16_BWD_KERNEL: steps}}[suffix]})
    check(steps > 0 and counts == want,
          f'{path} took {steps} steps and launched {counts}, expected {want}')
    for ph in (1, 2):
        check(info[f'train_phase{ph}_steps'] > 0, f'phase {ph} took no step')
    if family is None:
        check(info['train_phase1_last_loss'] < info['train_phase1_first_loss'],
              'phase 1 loss did not fall')
        check(info['train_phase2_last_loss'] < info['train_phase1_first_loss'],
              'phase 2 ended above the first loss')
    else:
        # the volume loss (MSE): a variational family's loss also carries
        # the KL term, whose weight rises every step
        for ph in (1, 2):
            check(info[f'train_phase{ph}_last_volume_loss']
                  < info[f'train_phase{ph}_first_volume_loss'],
                  f'{path} phase {ph} volume loss did not fall')
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
    if not keep:
        shutil.rmtree(exp)
    info['train_cli_s'] = train_s
    prof = None
    if family is None or family == 'dynamic_variational':
        prof = profile_modes(suffix, config)
    if suffix == '_bf16':
        # the 'bf16' fetch reads the float32 grid: one kernel a step, no cast
        for mode in MODES:
            calls = prof[mode]['kernel_calls_per_step']['grid_sample_fwd_kernel']
            check(calls == 1.0,
                  f'{path}: the fetch kernel ran {calls} times a profiled {mode} step')

    def rates(i):
        return {ph: i[f'train_phase{ph}_samples_per_sec'] for ph in (1, 2)}
    emit({'phase': path, 'config': os.path.relpath(config, REPO),
          'flags': flags,
          'max_pass': TRAIN_MAX_PASS, 'batch': TRAIN_BATCH,
          'volume': list(meta.resolution),
          'phases': {ph: {k: info[f'train_phase{ph}_{k}'] for k in
                          ('steps', 'seconds', 'samples_per_sec', 'first_loss',
                           'last_loss', 'first_volume_loss', 'last_volume_loss')}
                     for ph in (1, 2)},
          'steady_samples_per_sec': info.get('train_samples_per_sec'),
          'default_samples_per_sec': None if default is None else rates(default),
          'default_steady_samples_per_sec': (None if default is None
                                             else default.get('train_samples_per_sec')),
          'train_cli_s': train_s, 'launches': counts,
          'warmup_steps_not_counted': warmup_steps,
          'psnr': info['psnr'], 'default_psnr': None if default is None else default['psnr'],
          'compression_ratio': info['compression_ratio'],
          'num_zeros': info['num_zeros'], 'num_parameters': info['num_parameters'],
          'psnr_binary_restored': psnr_binary, 'files': files,
          'profile_chunk': prof})
    return info, counts


class _Killed(Exception):
    """Ends a solve_phase run after a chosen chunk (a stand-in for a kill)."""


def run_chunks(ph, st, vol, gens, n_chunks, **kw):
    """``n_chunks`` chunks of RESUME_CHUNK steps of ``solve_phase`` on ``st``
    in place, its metric callback ending the phase there: (their losses,
    the positions and the noise each chunk drew)."""
    losses, drawn_pos, drawn_noise = [], [], []
    draw_pos, draw_noise = tr.draw_positions, tr.draw_noise

    def cb(x):
        losses.append(x)
        if len(losses) == n_chunks:
            raise _Killed

    def recording(draw, sink):
        def call(*a, **k):
            sink.append(draw(*a, **k))
            return sink[-1]
        return call
    tr.draw_positions = recording(draw_pos, drawn_pos)
    tr.draw_noise = recording(draw_noise, drawn_noise)
    try:
        tr.solve_phase(ph, st, vol, RESUME_CHUNK, generator=gens[0], noise_generator=gens[1],
                       verbose=False, metric_cb=cb, **kw)
    except _Killed:
        pass
    else:
        raise RuntimeError('chip_smoke check failed: the phase ended before the chunks ran')
    finally:
        tr.draw_positions, tr.draw_noise = draw_pos, draw_noise
    return np.concatenate(losses), drawn_pos, drawn_noise


def same_draws(a, b):
    """Two lists of draws (tensors, lists of tensors or None) bit for bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None or b is None:
        return a is b
    return len(a) == len(b) and all(same_draws(x, y) for x, y in zip(a, b))


def state_round_trip(config, vol_dev, tmp):
    """A flagship-width phase-1 state of ``config``'s family after 2 chunks,
    saved by solve_phase with both CUDA generators, loaded back; then one
    chunk from the loaded and from the live state and generators: the same
    draws, the same losses and the same final states, bit for bit."""
    cfg = load_config(config)
    spec = make_spec(**dict(FLAGSHIP, drop_type=cfg.drop_type,
                            drop_momentum=cfg.drop_momentum,
                            drop_threshold=cfg.drop_threshold))
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(spec, gen, device='cuda')
    variance = None
    if is_dynamic(spec.drop_type):
        variance = tuple([t.cuda() for t in ts] for ts in init_variance_model(gen))
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta(tuple(vol_dev.shape)), phase=1)

    def fresh():
        return tr.init_train_state(model, cfg.lr, cfg.lr, train_gates=True,
                                   variance=variance, weight_dkl=cfg.lambda_drop_loss)

    def generators(seed):
        return tuple(torch.Generator(device='cuda').manual_seed(seed + i) for i in range(2))
    live, live_gens = fresh(), generators(SEED)
    path = os.path.join(tmp, 'train_state.npz')
    run_chunks(ph, live, vol_dev, live_gens, 2, state_save_path=path, save_every_s=0.0)
    check(live.step == 2 * RESUME_CHUNK, f'{live.step} steps in 2 chunks')
    # one more save of the same state, timed alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    atomic_save_train_state(os.path.join(tmp, 'timed.npz'), live, live_gens)
    save_ms = (time.perf_counter() - t0) * 1e3
    loaded_gens = generators(SEED + 100)
    template = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_train_state(path, template, loaded_gens)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(loaded.step == live.step, 'loaded step')
    for name in TENSOR_FIELDS:
        a, b = getattr(loaded, name), getattr(live, name)
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f'{name} did not load bit for bit')
    for a, b in zip(loaded_gens, live_gens):
        check(torch.equal(a.get_state(), b.get_state()), 'a generator did not load')
    runs = [run_chunks(ph, st, vol_dev, g, 1)
            for st, g in ((live, live_gens), (loaded, loaded_gens))]
    (l_live, p_live, n_live), (l_loaded, p_loaded, n_loaded) = runs
    check(same_draws(p_live, p_loaded) and same_draws(n_live, n_loaded),
          'the loaded state drew other positions or noise')
    rel_diff = np.abs(l_loaded - l_live) / np.abs(l_live)
    check(np.array_equal(l_loaded, l_live),
          f'{os.path.basename(config)}: continued losses differ by '
          f'{float(rel_diff.max())} of themselves')
    unequal = [name for name in TENSOR_FIELDS
               if not same_draws(getattr(loaded, name), getattr(live, name))]
    check(not unequal, f'{os.path.basename(config)}: the continued states differ in {unequal}')
    return {'config': os.path.relpath(config, REPO), 'chunk': RESUME_CHUNK,
            'saved_at_step': 2 * RESUME_CHUNK, 'save_ms': save_ms, 'load_ms': load_ms,
            'file_bytes': os.path.getsize(path), 'trainables': live.flat.numel(),
            'noise_drawn': bool(n_live),
            'continued_first_loss_equal': bool(l_live[0] == l_loaded[0]),
            'continued_losses_equal': True, 'continued_states_equal': True,
            'continued_max_rel_loss_diff': float(rel_diff.max())}


# the paths the graphs phase runs with and without the step's CUDA graph:
# every backend under smallify, and every other gate family (backend,
# config, drop_type in the config's place)
GRAPH_PATHS = {**{'train' + suffix: (suffix, FLAGSHIP_CONFIG, None) for suffix in BACKENDS},
               **{'train_' + family: ('', os.path.join(CONFIGS, config),
                                      flags[1] if flags else None)
                  for family, (config, flags) in FAMILIES.items()}}
# CUgraphNodeType and CUgraphDependencyType (cuda.h)
NODE_TYPES = {0: 'kernel', 1: 'memcpy', 2: 'memset', 3: 'host', 4: 'graph', 5: 'empty'}
EDGE_TYPES = {0: 'default', 1: 'programmatic'}


def graph_nodes(graph):
    """libcuda, and the nodes of a CUDA graph kept for inspection
    (``CUDAGraph(keep_graph=True)``) with their types (cuGraphGetNodes,
    cuGraphNodeGetType): (libcuda, graph handle, [(node, type)])."""
    import ctypes
    cu = ctypes.CDLL('libcuda.so.1')
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, 'cuGraphGetNodes')
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, 'cuGraphGetNodes')
    typed = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              'cuGraphNodeGetType')
        typed.append((ctypes.c_void_p(node), kind.value))
    return cu, handle, typed


def graph_kernel_names(graph):
    """The nodes of a CUDA graph kept for inspection, counted by name: each
    kernel node by its function's (mangled) name (cuGraphKernelNodeGetParams,
    then cuFuncGetName, or cuKernelGetName where the node holds a library
    kernel), each other node as '<type>' (NODE_TYPES)."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [('func', ctypes.c_void_p),
                    *[(f, ctypes.c_uint) for f in ('gx', 'gy', 'gz', 'bx', 'by', 'bz',
                                                   'shared_bytes')],
                    ('params', ctypes.c_void_p), ('extra', ctypes.c_void_p),
                    ('kern', ctypes.c_void_p), ('ctx', ctypes.c_void_p)]
    cu, _, nodes = graph_nodes(graph)
    names = {}
    for node, kind in nodes:
        key = f'<{NODE_TYPES.get(kind, kind)}>'
        if kind == 0:
            p = KernelNodeParams()
            check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)) == 0,
                  'cuGraphKernelNodeGetParams')
            name = ctypes.c_char_p()
            got = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)) if p.func
                   else cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)))
            check(got == 0 and bool(name.value), 'a kernel node without a name')
            key = name.value.decode()
        names[key] = names.get(key, 0) + 1
    return names


def gradient_graph_edges():
    """The gradient kernel's call at one train step's shape (flagship grid,
    trainer positions) captured alone in a CUDA graph kept for inspection
    (``CUDAGraph(keep_graph=True)``), its nodes and edges read through
    libcuda (``graph_nodes``, cuGraphGetEdges_v2): each edge's type
    (programmatic: the capture kept the box kernel's early launch,
    ``cudaLaunchAttributeProgrammaticStreamSerialization``; default: it
    made an ordinary dependency of it) and ports; the replay's dG bit for
    bit the eager call's."""
    import ctypes
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    coords = trainer_positions(TRAIN_BATCH, g)
    grad = torch.randn((TRAIN_BATCH, 16), device='cuda', generator=g)
    want = gs.grid_sample_channel_minor_backward_cuda(grad, coords, 15, 15, 15)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        got = gs.grid_sample_channel_minor_backward_cuda(grad, coords, 15, 15, 15)
    cu, handle, nodes = graph_nodes(graph)
    kinds = [NODE_TYPES.get(kind, kind) for _, kind in nodes]

    class EdgeData(ctypes.Structure):
        _fields_ = [('from_port', ctypes.c_ubyte), ('to_port', ctypes.c_ubyte),
                    ('type', ctypes.c_ubyte), ('reserved', ctypes.c_ubyte * 5)]
    edges = ctypes.c_size_t(0)
    check(cu.cuGraphGetEdges_v2(handle, None, None, None, ctypes.byref(edges)) == 0,
          'cuGraphGetEdges_v2')
    src, dst = (ctypes.c_void_p * edges.value)(), (ctypes.c_void_p * edges.value)()
    data = (EdgeData * edges.value)()
    check(cu.cuGraphGetEdges_v2(handle, src, dst, data, ctypes.byref(edges)) == 0,
          'cuGraphGetEdges_v2')
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "the captured gradient's replay differs from the eager call")
    return {'nodes': kinds,
            'edges': [{'type': EDGE_TYPES.get(d.type, d.type), 'from_port': d.from_port,
                       'to_port': d.to_port} for d in data],
            'replay_equal_to_eager': True}


def phase_graphs(vol_path):
    """Each path of GRAPH_PATHS at the flagship's widths on the 255^3
    volume: 2 chunks of RESUME_CHUNK phase-1 steps through solve_phase with
    the step's CUDA graph and with eager steps, from the same state and
    generators: the losses, the steps and every tensor of the states bit
    for bit, the launch counts equal and each kernel of the path once a
    step (a replay counts the launches its capture counted); each mode's
    seconds (the graphed ones with the warm-up and the capture).  Then the
    gradient kernel captured alone (``gradient_graph_edges``)."""
    vol_dev = torch.from_numpy(load_volume(vol_path)).cuda()
    paths = {}
    for path, (suffix, config, drop_type) in GRAPH_PATHS.items():
        got = {}
        for mode in MODES:
            ph, st, vol = flagship_state(suffix, config, vol_dev, drop_type)
            gens = tuple(torch.Generator(device='cuda').manual_seed(SEED + i)
                         for i in range(2))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _, _ = run_chunks(ph, st, vol, gens, 2, graphs=mode == 'graphed')
            torch.cuda.synchronize()
            got[mode] = (losses, st, read_counts(), time.perf_counter() - t0)
        (l0, s0, c0, sec0), (l1, s1, c1, sec1) = got['eager'], got['graphed']
        check(s0.step == s1.step == 2 * RESUME_CHUNK and np.array_equal(l0, l1),
              f'{path}: graphed losses differ from eager ones '
              f'(steps {s0.step}, {s1.step}; {np.abs(l1 - l0).max()})')
        unequal = [name for name in TENSOR_FIELDS
                   if not same_draws(getattr(s0, name), getattr(s1, name))]
        check(not unequal, f'{path}: the graphed state differs from the eager one in {unequal}')
        check(c0 == c1 and {v for v in c1.values() if v} == {s1.step},
              f'{path}: launches eager {c0}, graphed {c1}, {s1.step} steps')
        paths[path] = {'steps': s1.step, 'launches': c1, 'eager_s': sec0, 'graphed_s': sec1,
                       'losses_equal': True, 'states_equal': True}
    row = {'phase': 'graphs', 'chunk': RESUME_CHUNK, 'paths': paths,
           'gradient_graph': gradient_graph_edges()}
    emit(row)
    return row


def writer_kind():
    """The TensorBoard writer train/run.py::_make_writer finds, or None."""
    try:
        import tensorboardX  # noqa: F401
        return 'tensorboardX'
    except ImportError:
        pass
    try:
        import torch.utils.tensorboard  # noqa: F401
        return 'torch'
    except ImportError:
        return None


def train_cli(tmp, vol_path, expname, *flags, max_pass=TRAIN_MAX_PASS):
    """train_torch.py on the flagship config from the smoke's directory:
    (info, launch counts, seconds)."""
    import train_torch
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = train_torch.main(['--config', FLAGSHIP_CONFIG, '--data', vol_path,
                                 '--max_pass', str(max_pass), '--basedir', '/',
                                 '--expname', expname, *flags])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        os.chdir(cwd)
    shutil.rmtree(os.path.join(tmp, expname))
    return info, counts, seconds


def phase_resume(tmp, vol_path, default):
    """Mid-training resume, the profiler trace and the writer (the train
    phase's default run, ``default``, left its experiment in ``tmp``)."""
    from latent_feature_grid_compression_tpu_torch.train import run as run_mod
    n_chunks = math.ceil(VolumeMeta((VOLUME_N,) * 3).n_voxels / CHUNK)
    row = {'phase': 'resume'}
    vol_dev = torch.from_numpy(load_volume(vol_path)).cuda()
    row['state_round_trip'] = [state_round_trip(config, vol_dev, tmp) for config in
                               (FLAGSHIP_CONFIG, os.path.join(CONFIGS, FAMILIES[
                                   'dynamic_variational'][0]))]
    del vol_dev

    exp = os.path.join(tmp, 'train')
    keys = ('psnr', 'num_zeros', 'compression_ratio')
    write_dict({'phase': 2}, 'resume_meta.txt', exp)
    info, counts, seconds = train_cli(tmp, vol_path, 'resume_phase2', '--resume', exp)
    check(counts == only({gs.KERNEL: n_chunks, ih.KERNEL: n_chunks})
          and info['train_phase2_steps'] == 0,
          f'the resume at phase 2 took {info["train_phase2_steps"]} steps, launched {counts}')
    check(all(info[k] == default[k] for k in keys),
          f'resumed at phase 2: {[info[k] for k in keys]}, train: '
          f'{[default[k] for k in keys]}')
    row['phase2'] = {'seconds': seconds, 'launches': counts,
                     **{k: info[k] for k in keys}}

    write_dict({'phase': 1}, 'resume_meta.txt', exp)
    info, counts, seconds = train_cli(tmp, vol_path, 'resume_phase1', '--resume', exp)
    steps2 = default['train_phase2_steps']
    check(info['train_phase1_steps'] == 0 and info['train_phase2_steps'] == steps2
          and counts == only({gs.KERNEL: steps2 + n_chunks, gs.BWD_KERNEL: steps2,
                              ih.KERNEL: n_chunks}),
          f'the resume at phase 1 took {info["train_phase1_steps"]} + '
          f'{info["train_phase2_steps"]} steps, launched {counts}')
    check(abs(info['psnr'] - default['psnr']) <= PSNR_RESUME_DB
          and info['num_zeros'] == default['num_zeros'],
          f"resumed at phase 1: PSNR {info['psnr']}, zeros {info['num_zeros']}; train: "
          f"{default['psnr']}, {default['num_zeros']}")
    row['phase1'] = {'seconds': seconds, 'launches': counts,
                     **{k: info[k] for k in keys},
                     'psnr_minus_train': info['psnr'] - default['psnr'],
                     **{f'phase2_{k}_minus_train': info[f'train_phase2_{k}'] -
                        default[f'train_phase2_{k}']
                        for k in ('first_loss', 'last_loss', 'last_volume_loss')}}

    prof_dir = os.path.join(tmp, 'profile_trace')
    run_chunk = load_config(FLAGSHIP_CONFIG).steps_per_chunk
    info, _, seconds = train_cli(tmp, vol_path, 'profile', '--profile_dir', prof_dir,
                                 max_pass=1)
    traces = [f for f in os.listdir(prof_dir) if f.endswith('.pt.trace.json')]
    check(len(traces) == 1 and info['train_phase1_steps'] > run_chunk,
          f'{traces} traces of {info["train_phase1_steps"]} phase-1 steps')
    trace_path = os.path.join(prof_dir, traces[0])
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    named = {k: sum(k in n for n in kernels)
             for k in ('grid_sample_fwd_kernel', 'grid_sample_bwd')}
    check(all(named.values()), f'the trace names {named} of {len(kernels)} kernels')
    row['profile'] = {'phase1_steps': info['train_phase1_steps'],
                      'traced_steps': min(run_chunk, info['train_phase1_steps'] - run_chunk),
                      'trace_bytes': os.path.getsize(trace_path), 'events': len(events),
                      'kernel_events': len(kernels), 'named_kernel_events': named,
                      'train_cli_s': seconds}
    shutil.rmtree(prof_dir)

    row['writer'] = writer_kind()
    if row['writer'] is not None:
        rates = {}
        make_writer = run_mod._make_writer
        for label in ('without', 'with'):
            if label == 'without':
                run_mod._make_writer = lambda cfg: None
            try:
                info, _, _ = train_cli(tmp, vol_path, 'writer_' + label)
            finally:
                run_mod._make_writer = make_writer
            rates[label] = info['train_phase1_samples_per_sec']
        row['writer_phase1_samples_per_sec'] = rates
        row['writer_train_default_phase1_samples_per_sec'] = \
            default['train_phase1_samples_per_sec']
    emit(row)
    return row


# ---------------------------------------------------------------------------
# quant, readers, nas: the quantization study, the volume readers, the NAS
# search and the quality-control re-runs
# ---------------------------------------------------------------------------

NAS_CONFIG = os.path.join(CONFIGS, 'mhd_p_HyperparamSearch.txt')
NAS_TRIALS = 4
NAS_PARALLELISM = 2   # both trials' processes on the one card
NAS_MAX_PASS = 1      # the published 60 passes cut to 1
TRIAL_TIMEOUT_S = 600


def bitwise_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def phase_quant(tmp, vol_path, default):
    """The post-training quantization study on train-3's model.npz (the
    train phase's default run, ``default``, left its experiment in ``tmp``)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    spec = make_spec(d_in=cfg.d_in, hidden=cfg.n_hidden_size, d_out=cfg.d_out,
                     num_layers=cfg.n_layers, n_freqs=cfg.n_embedding_freq,
                     grid_features=cfg.grid_features, grid_size=cfg.grid_size,
                     wavelet=cfg.wavelet_filter)
    model = load_checkpoint(os.path.join(tmp, 'train', 'model.npz'), spec, device='cuda')
    vol = load_volume(vol_path)
    meta = VolumeMeta(vol.shape)
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    study = mock_quantization_study(model, vol)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check(counts == only({gs.KERNEL: 2 * n_chunks, ih.KERNEL: 2 * n_chunks}),
          f'the study launched {counts}, expected the fetch and the inference head '
          f'{2 * n_chunks} times')
    check(abs(study['psnr'] - default['psnr']) <= PSNR_TOL_DB,
          f"the study's PSNR {study['psnr']} against train-3's {default['psnr']}")
    # train-3's zeros are the bake's less the masks' storage (a bit a gate
    # value: gate values / 32 floats, see save_dropvalues_on_grid); the study
    # counts the pruned coefficients' zeros alone, so its float ratio leaves
    # the masks out
    mask_floats = sum(c[0].numel() for c in model.coeffs) / 32.0
    n_params = study['num_grid_params'] + study['num_mlp_params']
    check(n_params == default['num_parameters']
          and study['num_zeros'] - mask_floats == default['num_zeros'],
          f"the study counts {n_params} parameters and {study['num_zeros']} zeros; "
          f"train-3 {default['num_parameters']} and {default['num_zeros']} "
          f"(masks {mask_floats} floats)")
    ratio_with_masks = meta.n_voxels / (n_params - (study['num_zeros'] - mask_floats))
    check(ratio_with_masks == default['compression_ratio'],
          f"{ratio_with_masks} against train-3's ratio {default['compression_ratio']}")
    # the quantized model's field through the plain versions, PSNR in
    # float64 on the host
    qmodel = quantize_model(model)
    psnr_plain = deviation_statistics(plain_field(qmodel, meta).cpu().numpy(), vol)[0]
    check(abs(study['psnr_quant'] - psnr_plain) <= PSNR_TOL_DB,
          f"the study's quantized PSNR {study['psnr_quant']} against the plain "
          f"field's {psnr_plain}")
    # the int8 grid clips at +-127.5 steps of 0.02
    clipped = [int((c.abs() > 127.5 * 0.02).sum()) for c in model.coeffs]
    emit({'phase': 'quant', 'model': 'train-3 model.npz (mhd_p_smallify.txt)',
          'volume': list(meta.resolution), 'grid_scale': 0.02, 'mlp_scale': 1e-4,
          **study, 'psnr_drop': study['psnr'] - study['psnr_quant'],
          'psnr_quant_plain_host': psnr_plain, 'train3_psnr': default['psnr'],
          'train3_compression_ratio': default['compression_ratio'],
          'train3_num_zeros': default['num_zeros'], 'mask_floats': mask_floats,
          'clipped_by_level': clipped,
          'max_abs_by_level': [c.abs().max().item() for c in model.coeffs],
          'seconds': seconds, 'launches': counts})
    return counts


def cvol_copy(vol_path):
    """The .npy volume as an uncompressed float32 .cvol beside it."""
    path = os.path.splitext(vol_path)[0] + '.cvol'
    if not os.path.exists(path):
        write_cvol(path, np.load(vol_path).astype(np.float32))
    return path


def phase_readers(tmp, vol_path):
    """load_volume of the same volume as .npy, .cvol and .h5 (where h5py is
    installed): bitwise the .npy's, and the read times."""
    raw = np.load(vol_path)
    row = {'phase': 'readers', 'volume': list(raw.shape), 'dtype': str(raw.dtype)}
    t0 = time.perf_counter()
    paths = {'npy': vol_path, 'cvol': cvol_copy(vol_path)}
    row['cvol_write_s'] = time.perf_counter() - t0
    try:
        import h5py
    except ImportError:
        row['h5'] = 'h5py is not installed: no .h5 case'
    else:
        paths['h5'] = os.path.splitext(vol_path)[0] + '.h5'
        with h5py.File(paths['h5'], 'w') as f:
            f.create_dataset('data', data=raw[None])   # load_volume squeezes
    want = load_volume(vol_path)
    reads = {}
    for fmt, path in paths.items():
        t0 = time.perf_counter()
        got = load_volume(path)
        seconds = time.perf_counter() - t0
        check(bitwise_equal(got, want), f'load_volume of the .{fmt} differs from the .npy')
        reads[fmt] = {'load_volume_s': seconds, 'file_bytes': os.path.getsize(path)}
    t0 = time.perf_counter()
    check(bitwise_equal(read_cvol(paths['cvol']), raw.astype(np.float32)),
          'read_cvol differs from the volume written')
    reads['cvol']['read_cvol_s'] = time.perf_counter() - t0
    row['reads'] = reads
    emit(row)


# the native phase's compressed .cvol: the volume in NATIVE_LEVELS levels of
# uint8, so that runs of equal bytes occur (LZ4's matches)
NATIVE_LEVELS = 64


def _lz4_length(n):
    out = bytearray()
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)
    return out


def lz4_runs_block(a, prev_last):
    """An LZ4 block of the uint8 slice ``a``: every run of at least 5 equal
    bytes as its first byte (a literal) and a match of offset 1 for the
    rest, and a run at the slice's start that continues the previous slice's
    last byte ``prev_last`` (or None) as a match into the streaming history;
    the other bytes literals, the last 12 always."""
    n = len(a)
    cut = np.flatnonzero(a[1:] != a[:-1]) + 1
    starts, ends = np.concatenate([[0], cut]), np.concatenate([cut, [n]])
    keep = (ends - starts >= 5) & (ends <= n - 12)
    cont = prev_last is not None and int(a[0]) == prev_last
    if cont:
        keep[0] = ends[0] >= 4 and ends[0] <= n - 12
    data = a.tobytes()
    out, pos = bytearray(), 0
    for s, e in zip(starts[keep].tolist(), ends[keep].tolist()):
        lit_end = 0 if s == 0 and cont else s + 1
        m = e - lit_end - 4
        lit = lit_end - pos
        out.append((min(lit, 15) << 4) | min(m, 15))
        if lit >= 15:
            out += _lz4_length(lit - 15)
        out += data[pos:lit_end]
        out += b'\x01\x00'
        if m >= 15:
            out += _lz4_length(m - 15)
        pos = e
    lit = n - pos
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        out += _lz4_length(lit - 15)
    out += data[pos:]
    return bytes(out)


def write_lz4_cvol(path, vol):
    """A .cvol of the uint8 (X, Y, Z) volume ``vol`` with LZ4-compressed
    slices (flags bit 0), one block a z-slice: its sequences."""
    sx, sy, sz = vol.shape
    header = b'cvol' + struct.pack('<QQQ', sx, sy, sz) + struct.pack('<ddd', 1.0, 1.0, 1.0)
    header += struct.pack('<III', 0, 1, 0)
    header += b'\xff' * (64 - len(header))
    slices = np.ascontiguousarray(vol.transpose(2, 1, 0)).reshape(sz, sx * sy)
    with open(path, 'wb') as f:
        f.write(header)
        prev = None
        for z in range(sz):
            block = lz4_runs_block(slices[z], prev)
            f.write(struct.pack('<I', len(block)) + block)
            prev = int(slices[z][-1])


def file_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def phase_native(tmp, vol_path):
    """The native I/O helper on the run's data: the volume as an
    LZ4-compressed .cvol read through the helper and through the
    pure-Python decoder; the helper's k-means on the model's largest
    coefficient tensor; train-3's model.npz exported to the container (its
    k-means the helper's) twice, both the bytes of train-3's own export."""
    from latent_feature_grid_compression_tpu_torch.data import cvol as cvol_mod
    raw = load_volume(vol_path)
    lo, hi = float(raw.min()), float(raw.max())
    vol8 = np.round((raw - lo) / (hi - lo) * (NATIVE_LEVELS - 1)).astype(np.uint8)
    path = os.path.join(tmp, 'mhd_like_lz4.cvol')
    t0 = time.perf_counter()
    write_lz4_cvol(path, vol8)
    row = {'phase': 'native', 'volume': list(vol8.shape), 'levels': NATIVE_LEVELS,
           'cvol_bytes': os.path.getsize(path), 'raw_bytes': vol8.nbytes,
           'cvol_write_s': time.perf_counter() - t0}
    t0 = time.perf_counter()
    got = read_cvol(path)
    row['read_cvol_native_s'] = time.perf_counter() - t0
    with mock.patch.object(native, 'lz4_decompress', cvol_mod._lz4_decompress_block_py):
        t0 = time.perf_counter()
        got_py = read_cvol(path)
        row['read_cvol_python_s'] = time.perf_counter() - t0
    check(bitwise_equal(got, vol8), 'the native LZ4 read differs from the volume')
    check(bitwise_equal(got_py, vol8), 'the Python LZ4 read differs from the volume')

    cfg = load_config(FLAGSHIP_CONFIG)
    spec = make_spec(d_in=cfg.d_in, hidden=cfg.n_hidden_size, d_out=cfg.d_out,
                     num_layers=cfg.n_layers, n_freqs=cfg.n_embedding_freq,
                     grid_features=cfg.grid_features, grid_size=cfg.grid_size,
                     wavelet=cfg.wavelet_filter)
    exp = os.path.join(tmp, 'train')
    model = load_checkpoint(os.path.join(exp, 'model.npz'), spec, device='cuda')
    values = max((c.detach().cpu().numpy().reshape(-1) for c in model.coeffs), key=len)
    values = values[values != 0]
    t0 = time.perf_counter()
    labels, centers = native.kmeans_1d(values, min(2 ** 8, len(np.unique(values))),
                                       max_iter=100, seed=0)
    row['kmeans_native_s'] = time.perf_counter() - t0
    row['kmeans_values'] = int(len(values))
    check(len(labels) == len(values) and bool(np.all(np.diff(centers) >= 0)),
          'the native k-means gave no labels or unsorted centers')
    outs = [os.path.join(tmp, f'container_{k}') for k in range(2)]
    for k, out in enumerate(outs):
        t0 = time.perf_counter()
        store_model_parameters(model, out)
        row[f'export_{k}_s'] = time.perf_counter() - t0
    for suffix in ('', '_mask.bnr'):
        mine = file_bytes(outs[0] + suffix)
        check(mine == file_bytes(outs[1] + suffix),
              f'container{suffix}: a second export wrote other bytes')
        check(mine == file_bytes(os.path.join(exp, 'binary_model_file' + suffix)),
              f"container{suffix}: the export differs from train-3's own")
    row['container_bytes'] = os.path.getsize(outs[0])
    row['mask_bytes'] = os.path.getsize(outs[0] + '_mask.bnr')
    row['containers_equal'] = True
    emit(row)


# train_torch.py as a NAS trial or QC run: the kernels' launch counts of
# the run, from 0 at its start, written to launches.json in its experiment
# directory (cwd + --basedir + --expname, as the trainer places it)
TRIAL_SCRIPT = """\
import json, os, sys
sys.path.insert(0, {repo!r})
import chip_smoke
import train_torch
argv = sys.argv[1:]
chip_smoke.reset_counts()
train_torch.main(argv)
exp = os.getcwd() + argv[argv.index('--basedir') + 1] + argv[argv.index('--expname') + 1]
with open(os.path.join(exp, 'launches.json'), 'w') as f:
    json.dump(chip_smoke.read_counts(), f)
"""


def trial_script(work):
    """TRIAL_SCRIPT written into ``work``: its path."""
    path = os.path.join(work, 'trial_train_torch.py')
    with open(path, 'w') as f:
        f.write(TRIAL_SCRIPT.format(repo=REPO))
    return path


def experiment_row(exp, n_chunks):
    """An experiment's info.txt (PSNR, ratio, zeros, steps, training
    seconds) and its launches.json, which must show the fetch kernel once a
    step and an evaluation chunk and the gradient kernel once a step:
    (info, row, launch counts)."""
    info = dict_from_file(os.path.join(exp, 'info.txt'))
    check(math.isfinite(info['psnr']) and info['compression_ratio'] > 1,
          f"{exp}: PSNR {info['psnr']}, ratio {info['compression_ratio']}")
    steps = info['train_phase1_steps'] + info['train_phase2_steps']
    with open(os.path.join(exp, 'launches.json')) as f:
        counts = json.load(f)
    cfg = dict_from_file(os.path.join(exp, 'config.txt'))
    widths = types.SimpleNamespace(
        d_in=cfg['d_in'], n_freqs=cfg['n_embedding_freq'], hidden=cfg['n_hidden_size'],
        d_out=cfg['d_out'], grid_features=cfg['grid_features'], num_layers=cfg['n_layers'])
    want = only({gs.KERNEL: steps + n_chunks, gs.BWD_KERNEL: steps,
                 ih.KERNEL: n_chunks if ih.takes(widths) else 0})
    check(steps > 0 and counts == want,
          f'{exp} took {steps} steps and launched {counts}, expected {want}')
    return info, {'psnr': info['psnr'], 'compression_ratio': info['compression_ratio'],
                  'num_zeros': info['num_zeros'], 'num_parameters': info['num_parameters'],
                  'grid_size': cfg['grid_size'], 'grid_features': cfg['grid_features'],
                  'wavelet_filter': cfg['wavelet_filter'], 'steps': steps,
                  'train_seconds': info['train_phase1_seconds'] + info['train_phase2_seconds'],
                  'launches': counts}, counts


def add_counts(total, counts):
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def phase_nas(tmp, vol_path):
    """run_search on mhd_p_HyperparamSearch.txt at its published widths, cut
    to NAS_MAX_PASS on the .cvol copy of the volume, NAS_TRIALS trials two
    at a time; then a quality-control run at the trials' geometric-mean
    ratio and the front's first trial again without the wavelet.  Each
    process runs train_torch.py through TRIAL_SCRIPT, which counts its
    kernel launches; then the fetch and gradient kernels against their
    plain versions at each run's grid and features.  Returns the launches
    of the search's trials and of the QC runs, summed."""
    from latent_feature_grid_compression_tpu_torch.nas import search as nas
    from latent_feature_grid_compression_tpu_torch.utils import trigger_experiments as qc
    work = os.path.join(tmp, 'nas_run')
    os.makedirs(work)
    script = trial_script(work)
    cfg = dict_from_file(NAS_CONFIG)
    cfg.update(data=cvol_copy(vol_path), max_pass=NAS_MAX_PASS)
    write_dict(cfg, 'search.txt', work)
    cfg_path = os.path.join(work, 'search.txt')
    n_chunks = math.ceil(VolumeMeta((VOLUME_N,) * 3).n_voxels / CHUNK)
    has_tb = importlib.util.find_spec('tensorboard') is not None
    row = {'phase': 'nas', 'config': os.path.relpath(NAS_CONFIG, REPO),
           'data': '.cvol', 'max_pass': NAS_MAX_PASS, 'drop_type': 'variational_dynamic',
           'trials': NAS_TRIALS, 'parallelism': NAS_PARALLELISM, 'seed': SEED,
           'metrics_from': 'tensorboard' if has_tb else 'info.txt (no tensorboard)'}
    launches = {'nas': {}, 'qc': {}}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        trials = nas.run_search(cfg_path, drop_type='variational_dynamic',
                                total_trials=NAS_TRIALS, parallelism=NAS_PARALLELISM,
                                basedir='/nas/', seed=SEED, train_script=script,
                                poll_interval=0.5)
        row['search_s'] = time.perf_counter() - t0
        row['trial_rows'] = []
        for t in trials:
            if t.proc.returncode != 0 or not t.metrics:
                # the search discards a trial's output: run it again in the
                # foreground to show the error
                subprocess.run(t.proc.args, timeout=TRIAL_TIMEOUT_S)
                check(False, f'NAS trial {t.expname} exited {t.proc.returncode}, '
                             f'metrics {t.metrics}')
            info, trial_row, counts = experiment_row(os.path.join(work, 'nas', t.expname),
                                                     n_chunks)
            launches['nas'] = add_counts(launches['nas'], counts)
            if has_tb:
                tb = nas.read_trial_metrics_tb(os.path.join('runs', t.expname))
                check(tb == t.metrics and all(
                    v == float(np.float32(info['num_zeros' if k == 'zeroes' else k]))
                    for k, v in tb.items()),
                    f'{t.expname}: TensorBoard {tb}, metrics {t.metrics}, info {info}')
            row['trial_rows'].append({'expname': t.expname, 'params': t.params,
                                      'returncode': t.proc.returncode, **trial_row})

        ratios = [t.metrics['compression_ratio'] for t in trials]
        target = math.exp(sum(map(math.log, ratios)) / len(ratios))
        front = [trials[i] for i in nas.pareto_front([t.objective for t in trials])]
        cmds = qc.runs_at_target_ratios(os.path.join(work, 'nas'), cfg_path,
                                        param_key='lambda_drop_loss', target_ratios=(target,),
                                        basedir='/qc/', train_script=script, dry_run=True)
        check(len(cmds) == 1, f'{len(cmds)} runs for one target ratio: {cmds}')
        # the trial's config.txt names its model.npz as checkpoint_path (a
        # warm start); the coefficients of another wavelet have other
        # shapes, so the re-run without one starts afresh
        cmds += qc.rerun_frontier_configs([os.path.join(work, 'nas', front[0].expname)],
                                          {'wavelet_filter': '', 'checkpoint_path': ''},
                                          basedir='/qc/', train_script=script, dry_run=True)
        qc_rows = {}
        for name, cmd in zip((f'qc_target_{int(target)}', 'qc_rerun_0'), cmds):
            check(cmd[cmd.index('--expname') + 1] == name, f'{cmd} is not the run {name}')
            t0 = time.perf_counter()
            res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True, timeout=TRIAL_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            if res.returncode != 0:
                print(res.stdout[-4000:], flush=True)
            check(res.returncode == 0, f'{cmd} exited {res.returncode}')
            _, qc_rows[name], counts = experiment_row(os.path.join(work, 'qc', name),
                                                      n_chunks)
            launches['qc'] = add_counts(launches['qc'], counts)
            qc_rows[name]['seconds'] = seconds
            qc_rows[name]['lambda_drop_loss'] = dict_from_file(
                os.path.join(work, 'qc', name, 'config.txt'))['lambda_drop_loss']
        qc_rows[f'qc_target_{int(target)}']['target_ratio'] = target
        qc_rows['qc_rerun_0'].update(rerun_of=front[0].expname,
                                     trial_ratio=front[0].metrics['compression_ratio'],
                                     trial_psnr=front[0].metrics['psnr'])
        row['qc'] = qc_rows
    finally:
        os.chdir(cwd)
    row['launches'] = launches
    # the kernels at the shapes the runs drew: each run's decoded (or, with
    # no wavelet, raw) grid of grid_size^3 x grid_features, at the config's
    # batch on the trainer's positions
    runs = row['trial_rows'] + list(row['qc'].values())
    shapes = sorted({(r['grid_features'], r['grid_size']) for r in runs})
    g = torch.Generator(device='cuda').manual_seed(SEED + 4)
    check(cfg['batch_size'] * cfg['sample_size'] == TRAIN_BATCH,
          f"the config's batch is not {TRAIN_BATCH}")
    row['kernel_cases'] = []
    for C, G in shapes:
        fwd, bwd = fetch_case(C, G, 'trainer', g, timed=False), \
            grad_case(C, G, 'trainer', g, timed=False)
        row['kernel_cases'].append(
            {'C': C, 'grid': G, 'n': fwd['n'], 'fetch_max_abs_err': fwd['max_abs_err'],
             'fetch_max_abs_err_library': fwd['max_abs_err_library'],
             'fetch_route': fwd['plan']['route'],
             'grad_equal_to_cpu_plain': bwd['equal_to_cpu_plain'],
             'grad_equal_in_a_second_call': bwd['equal_in_a_second_call'],
             'grad_plan': bwd['plan']})
    emit(row)
    return launches


# ---------------------------------------------------------------------------
# mesh: multi-device training, MESH_RANKS ranks through torch.distributed.run
# ---------------------------------------------------------------------------

# ranks of the mesh phase's runs (--mesh-ranks: 4 on a machine of 4 cards)
MESH_RANKS = 2
MESH_DP_STEPS = 20
# the space axis' runs' volume: 255 does not divide 2 or 4, and the batch
# 32,768 divides only powers of two
MESH_SPACE_N = 256
PSNR_MESH_DB = 1.0     # the data axis' train-3 PSNR against train's
WINDOW_TOL = 2e-5      # the windowed forward against the full one (the JAX test's)
MESH_PROFILE_STEPS = 50
# where Adam's step depends on a gradient's last bits (|g| within a few
# orders of eps), the two ranks' split sum moves it: the data-parallel run's
# parameters are held to ATOMICS_TOL where the first moment is above this
# share of its max
ADAM_SURE_SHARE = 1e-4
# chunks of RESUME_CHUNK steps of the mesh_graphs runs: the eager and the
# graphed run, each saving after every chunk; the graphed run resumed after
# the second
MESH_GRAPH_CHUNKS = 3


def mesh_backend():
    """NCCL with a card a rank; on fewer cards gloo, asked for by name, with
    the ranks sharing the card (NCCL refuses two ranks on one card)."""
    return 'nccl' if torch.cuda.device_count() >= MESH_RANKS else 'gloo'


def cli_steps_graphed(backend):
    """Whether train_torch.py's mesh steps under ``backend`` are replays of
    the step's CUDA graph: the trainer's default on a card
    (``trainer.use_step_graphs``)."""
    return tr.use_step_graphs(None, types.SimpleNamespace(backend=backend), 'cuda')


ZERO_LOCAL = ['--mesh_shard_params', '1', '--mesh_local_decode', '1', '--interp_backend', 'xla']


def mesh_runs():
    """The mesh phase's train-3 runs at MESH_RANKS ranks: (name,
    train_torch.py's flags, whether on the 256^3 volume, the collective
    calls a step).  The data axis on the flagship (its replicated state
    all-reduces); the space axis with the state sharded and tile-local
    decode (all-gather and reduce-scatter, no data axis to average over);
    at 4 ranks also the JAX README's layout (--mesh_data 4 --mesh_space 2,
    8 chips) cut to 2 x 2, whose step all-gathers and reduce-scatters over
    'space' and all-reduces over 'data'."""
    r = MESH_RANKS
    runs = [(f'mesh_dp{r}', ['--mesh_data', str(r)], False,
             {'all_reduce': 1, 'reduce_scatter': 0, 'all_gather': 0}),
            (f'mesh_space{r}_zero_local', ['--mesh_space', str(r), *ZERO_LOCAL], True,
             {'all_reduce': 0, 'reduce_scatter': 1, 'all_gather': 1})]
    if r == 4:
        runs.append(('mesh_dp2_space2_zero_local',
                     ['--mesh_data', '2', '--mesh_space', '2', *ZERO_LOCAL], True,
                     {'all_reduce': 1, 'reduce_scatter': 1, 'all_gather': 1}))
    return runs


# a mesh worker prints every thread's stack and exits this many seconds
# before its launch's time limit (faulthandler), so that a hang shows where
DUMP_BEFORE_S = 30


def run_launcher(cmd, cwd, log, timeout, what):
    """``cmd`` (a torch.distributed.run) from ``cwd`` in a session of its
    own, with this checkout on the path and the mesh workers' stack dump
    DUMP_BEFORE_S before ``timeout``, its output into the file ``log`` (a
    rank left running cannot hold a pipe open): (exit code, the output,
    seconds).  Past ``timeout`` the launcher is sent SIGTERM, which it
    passes to its ranks (each in a session of its own), then SIGKILL, and
    this raises: a hang fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]),
        CHIP_SMOKE_DUMP_AFTER_S=str(max(timeout - DUMP_BEFORE_S, 10)))
    t0 = time.perf_counter()
    timed_out = False
    with open(log, 'w') as sink:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=sink, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    seconds = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    if timed_out:
        print(text[-16000:], file=sys.stderr)
        raise RuntimeError(f'chip_smoke check failed: {what} ran past {timeout} s')
    return proc.returncode, text, seconds


def mesh_launch(tmp, kind, *argv, backend=None, timeout=300, may_fail=False):
    """This script's mesh worker ``kind`` on MESH_RANKS ranks through
    torch.distributed.run, from ``tmp`` (``run_launcher``): (each rank's
    result, None for a rank that wrote none, seconds).  ``backend`` None:
    :func:`mesh_backend`; a failed launch raises unless ``may_fail``,
    printing the end of its output.  Every rank of a training kind must
    have ended its process group through shutdown_distributed (its
    seconds: ``shutdown_s``)."""
    out = os.path.join(tmp, 'mesh_' + kind)
    os.makedirs(out, exist_ok=True)
    for r in range(MESH_RANKS):   # an earlier launch's
        for stale in (f'rank{r}.pt', f'rank{r}.end.json'):
            if os.path.exists(os.path.join(out, stale)):
                os.remove(os.path.join(out, stale))
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', str(MESH_RANKS), os.path.abspath(__file__),
           '--mesh-worker', kind, '--mesh-out', out, '--mesh-ranks', str(MESH_RANKS),
           '--mesh-backend', backend or mesh_backend(), *argv]
    code, text, seconds = run_launcher(cmd, tmp, os.path.join(out, 'launch.log'), timeout,
                                       f'mesh worker {kind}')
    if code and not may_fail:
        print(text[-16000:], file=sys.stderr)
        raise RuntimeError(f'chip_smoke check failed: mesh worker {kind} exited {code}')
    results = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
               if os.path.exists(os.path.join(out, f'rank{r}.pt')) else None
               for r in range(MESH_RANKS)]
    if kind != 'nccl_probe':
        for r, result in enumerate(results):
            end = os.path.join(out, f'rank{r}.end.json')
            check(os.path.exists(end), f'mesh worker {kind}: rank {r} did not end its process '
                                       f'group through shutdown_distributed')
            with open(end) as f:
                result['shutdown_s'] = json.load(f)['shutdown_s']
    return results, seconds


def dp_inputs(vol_path):
    """The flagship phase-1 state (smallify, seeded model), the volume on the
    card and MESH_DP_STEPS steps of one global position stream (on the
    host, from a seed)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    spec = make_spec(**dict(FLAGSHIP, drop_type=cfg.drop_type, drop_momentum=cfg.drop_momentum,
                            drop_threshold=cfg.drop_threshold))
    model = init_model(spec, torch.Generator().manual_seed(SEED), device='cuda')
    vol = torch.from_numpy(load_volume(vol_path)).cuda()
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta(tuple(vol.shape)), phase=1)
    st = tr.init_train_state(model, cfg.lr, cfg.lr, train_gates=True,
                             weight_dkl=cfg.lambda_drop_loss)
    g = torch.Generator().manual_seed(SEED + 9)
    pos = torch.stack([torch.randint(0, VOLUME_N, (MESH_DP_STEPS, TRAIN_BATCH), generator=g,
                                     dtype=torch.int32) for _ in range(3)], -1)
    return ph, st, vol, pos


def dp_steps(ph, st, vol, pos, sc=None):
    """The trainer's step over the stream (a rank's share of it under
    ``sc``): the losses and the final flat vector and first moment."""
    c = tr.PhaseConstants(ph, vol)
    norm, gt = tr.chunk_inputs(c, pos.cuda())
    losses = torch.stack([tr.train_step(ph, st, c, norm[k], gt[k], terms={}, sc=sc)[0]
                          for k in range(len(pos))])
    return {'losses': losses.cpu(), 'flat': st.flat.cpu(), 'm': st.m.cpu()}


def mesh_inputs(cfg, dev):
    """``cfg``'s mesh run on this rank at the flagship's widths (a model
    from the seed): (phase-1 spec, a function making a fresh state, the
    rank's slab of the volume on its card, solve_phase's mesh keywords)."""
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    spec = make_spec(**dict(FLAGSHIP, drop_type=cfg.drop_type, drop_momentum=cfg.drop_momentum,
                            drop_threshold=cfg.drop_threshold),
                     interp_backend=cfg.interp_backend)
    mesh = pm.make_mesh(cfg.mesh_data, cfg.mesh_space, device=dev)
    vol_np = load_volume(cfg.data)
    use_space = cfg.mesh_space > 1 and vol_np.shape[0] % cfg.mesh_space == 0
    ph = tr.make_phase_spec(cfg, spec, VolumeMeta(vol_np.shape), phase=1)
    model = init_model(spec, torch.Generator().manual_seed(SEED), device=dev)

    def fresh():
        return tr.init_train_state(model, cfg.lr, cfg.lr, train_gates=True,
                                   weight_dkl=cfg.lambda_drop_loss)
    return ph, fresh, pm.shard_volume(mesh, vol_np, use_space), dict(
        mesh=mesh, use_space=use_space, shard_params=bool(cfg.mesh_shard_params),
        local_decode=bool(cfg.mesh_local_decode))


def mesh_generators(dev, rank, seed=SEED):
    """A rank's position generator (its own) and gate-noise generator (the
    same on every rank), on its card."""
    return (torch.Generator(device=dev).manual_seed(seed + 1 + rank),
            torch.Generator(device=dev).manual_seed(seed + 100))


def mesh_chunks(ph, fresh, vol, kw, graphs, steps):
    """solve_phase's chunk machinery on the mesh (``trainer.shard_phase``,
    then ``trainer.ChunkRunner`` with the mesh's step arguments), as
    ``flagship_chunks`` on one card: (a function that runs the next chunk
    of ``steps`` steps and returns its host seconds, the samples a rank
    takes a step, the runner, which the caller closes).  One chunk (warm-up
    and capture) runs before it is returned."""
    mesh = kw['mesh']
    st, c, N, step_kw = tr.shard_phase(ph, fresh(), vol, mesh, kw['use_space'],
                                       kw['shard_params'], kw['local_decode'])
    runner = tr.ChunkRunner(ph, st, c, N, steps, terms=True, graphs=graphs, step_kw=step_kw)
    gens = mesh_generators(vol.device, mesh.rank)

    def chunk():
        t0 = time.perf_counter()
        pos = tr.draw_positions(c, steps, N, gens[0])
        runner.chunk(pos, tr.draw_noise(ph, steps, gens[1], vol.device))
        return time.perf_counter() - t0
    chunk()
    return chunk, N, runner


def kept_graphs():
    """(a list that receives every CUDA graph made, a stand-in for
    torch.cuda.CUDAGraph that keeps each for inspection).  The list holds
    the anchor of a capture pool made meanwhile too (``step_graphs``)."""
    graphs, real = [], torch.cuda.CUDAGraph

    def kept():
        graphs.append(real(keep_graph=True))
        return graphs[-1]
    return graphs, kept


def step_graphs(graphs):
    """The graphs of a ``kept_graphs`` list that captured a step or an
    evaluation: not the anchor (one fill, never replayed) that a card's
    first capture makes for the pool its captures share
    (``trainer._capture_pools``)."""
    anchors = [entry[1] for entry in tr._capture_pools.values()]
    return [g for g in graphs if all(g is not a for a in anchors)]


def step_graph_nodes(graph):
    """The kernel nodes of a mesh step's graph: in all, the fetch's and the
    gradient's (PROFILED_KERNELS' names), NCCL's (with their names), and
    the other nodes by type."""
    nodes = graph_kernel_names(graph)
    kernels = {k: n for k, n in nodes.items() if not k.startswith('<')}
    return {'kernel': sum(kernels.values()),
            'profiled_kernels': {name: sum(n for k, n in kernels.items() if name in k)
                                 for name in PROFILED_KERNELS},
            'nccl': {k: n for k, n in kernels.items() if is_nccl_kernel(k)},
            **{k: n for k, n in nodes.items() if k.startswith('<')}}


def mesh_profile(cfg, dev, steps=MESH_PROFILE_STEPS):
    """A chunk of ``steps`` phase-1 steps of ``cfg``'s mesh run on this rank
    (``mesh_chunks``: a fresh model, the work does not depend on the
    values) under torch.profiler (``profile_train_steps``), eager and, under
    NCCL, graphed: ms a step, host launch calls a step, the device's idle
    share, NCCL's kernels and device ms a step, the host's time inside the
    collectives' calls; and the collective calls a step and the bytes the
    ring model gives them (their count and sizes, not a measurement of what
    the backend moves) against comm_volume_per_step's prediction, which
    must read the same in both modes (a replay counts what its capture
    counted).  The step's graph, kept for inspection, gives the kernels a
    step (``step_graph_nodes``, NCCL's included; the profiler loses records
    of replays): the eager trace's fetch, gradient and NCCL kernels a step
    must be its nodes."""
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    ph, fresh, vol, kw = mesh_inputs(cfg, dev)
    mesh = kw['mesh']
    n_params = fresh().flat.numel()
    modes = ('eager', 'graphed') if mesh.backend == 'nccl' else ('eager',)
    out = {'steps': steps, 'n_params': n_params,
           'bytes_predicted_per_step': pm.comm_volume_per_step(
               n_params, cfg.mesh_data, cfg.mesh_space, bool(cfg.mesh_shard_params))}
    for mode in modes:
        graphs, kept = kept_graphs()
        with mock.patch.object(torch.cuda, 'CUDAGraph', kept):
            chunk, N, runner = mesh_chunks(ph, fresh, vol, kw, mode == 'graphed', steps)
        torch.cuda.synchronize()
        pm.reset_counts()
        prof = profile_train_steps(chunk, steps, mode == 'graphed')
        called = dict(pm.counts)
        prof.update({
            'samples_per_rank_step': N,
            'collective_host_share': prof['collective_host_ms_per_step'] / prof['ms_per_step'],
            'collective_calls_per_step': {k: v / steps for k, v in called.items()
                                          if k != 'modelled_bytes'},
            'bytes_modelled_from_calls_per_step': called['modelled_bytes'] / steps})
        graphs = step_graphs(graphs)
        if graphs:
            check(len(graphs) == 1, f'{len(graphs)} graphs captured for one chunk runner')
            prof['graph_nodes'] = step_graph_nodes(graphs[0])
        # the step's graph destroyed (under NCCL it holds the communicators)
        runner.close()
        out[mode] = prof
    if 'graphed' in out:
        nodes = out['graphed']['graph_nodes']
        eager = out['eager']
        for key in ('collective_calls_per_step', 'bytes_modelled_from_calls_per_step'):
            check(out['graphed'][key] == eager[key],
                  f"{key} graphed {out['graphed'][key]}, eager {eager[key]}")
        for name in PROFILED_KERNELS[:2]:   # the fetch and the gradient
            check(eager['kernel_calls_per_step'][name] == nodes['profiled_kernels'][name],
                  f"{name} a step eager {eager['kernel_calls_per_step'][name]}, the "
                  f"step's graph {nodes['profiled_kernels'][name]}")
        step_calls = sum(eager['collective_calls_per_step'].values())
        check(sum(nodes['nccl'].values()) == eager['nccl_kernels_per_step'] == step_calls,
              f"NCCL kernels a step: the graph's {nodes['nccl']}, eager "
              f"{eager['nccl_kernels_per_step']}, collective calls {step_calls}")
    return out


def mesh_graph_check(cfg, dev, out):
    """``cfg``'s mesh run on this rank (``mesh_inputs``), a fresh phase-1
    state through solve_phase for MESH_GRAPH_CHUNKS chunks of RESUME_CHUNK
    steps with eager steps and with the step's CUDA graph, from the same
    generators, each saving the state after every chunk (the eager
    collectives of a save between the replays); then the graphed run's
    file of its second chunk loaded on every rank and one more chunk
    graphed.  The losses, every tensor of the runner's state (this rank's
    shard under ZeRO), the kernel launches and the collective counts of the
    graphed run equal the eager run's; the resumed run's losses and state
    equal the third chunk's.  Returns the step graph's nodes (NCCL's among
    them; read after the first chunk, while the phase holds the graph: its
    runner destroys it when the phase ends), the counts and each run's
    seconds."""
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    ph, fresh, vol, kw = mesh_inputs(cfg, dev)
    mesh = kw['mesh']
    runners = []

    class Recording(tr.ChunkRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runners.append(self)

    def run(mode, n_chunks, state, gens, save='', keep_after=None):
        losses, nodes = [], []
        graphs, kept = kept_graphs()

        def cb(x):
            losses.append(x)
            if step_graphs(graphs) and not nodes:
                nodes.append(step_graph_nodes(step_graphs(graphs)[0]))
            if len(losses) == keep_after and mesh.rank == 0:
                shutil.copy(save, f'{save}.{keep_after}.npz')
            if len(losses) == n_chunks:
                raise _Killed
        reset_counts()
        pm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(tr, 'ChunkRunner', Recording), \
                mock.patch.object(torch.cuda, 'CUDAGraph', kept):
            try:
                tr.solve_phase(ph, state, vol, RESUME_CHUNK, generator=gens[0],
                               noise_generator=gens[1], verbose=False, metric_cb=cb,
                               state_save_path=save, save_every_s=0.0,
                               graphs=mode == 'graphed', **kw)
            except _Killed:
                pass
            else:
                raise RuntimeError('chip_smoke check failed: the phase ended before '
                                   'its chunks ran')
        torch.cuda.synchronize()
        graphs = step_graphs(graphs)
        check(len(graphs) == (mode == 'graphed'), f'{mode}: {len(graphs)} graphs captured')
        check(runners[-1].replay is None, f'{mode}: the phase left its step graph alive')
        return {'losses': np.concatenate(losses), 'state': runners[-1].st,
                'launches': read_counts(), 'collectives': dict(pm.counts),
                'seconds': time.perf_counter() - t0, 'nodes': nodes}

    def equal_states(a, b):
        return [name for name in TENSOR_FIELDS if not same_draws(getattr(a, name),
                                                                 getattr(b, name))]
    runs = {mode: run(mode, MESH_GRAPH_CHUNKS, fresh(), mesh_generators(dev, mesh.rank),
                      os.path.join(out, f'{mode}.npz'), keep_after=2)
            for mode in MODES}
    eager, graphed = runs['eager'], runs['graphed']
    steps = MESH_GRAPH_CHUNKS * RESUME_CHUNK
    check(np.array_equal(eager['losses'], graphed['losses']) and len(eager['losses']) == steps,
          f'rank {mesh.rank}: graphed losses differ from eager ones by '
          f"{np.abs(eager['losses'] - graphed['losses']).max()}")
    unequal = equal_states(eager['state'], graphed['state'])
    check(not unequal, f'rank {mesh.rank}: the graphed state differs in {unequal}')
    for key in ('launches', 'collectives'):
        check(eager[key] == graphed[key],
              f'rank {mesh.rank}: {key} eager {eager[key]}, graphed {graphed[key]}')
    check({v for v in graphed['launches'].values() if v} == {steps},
          f"rank {mesh.rank}: launches {graphed['launches']} in {steps} steps")
    # resume: the file rank 0 kept after the graphed run's second chunk
    pm.barrier(mesh)
    gens = mesh_generators(dev, mesh.rank, seed=SEED + 1000)
    state = load_train_state(os.path.join(out, 'graphed.npz.2.npz'), fresh(), gens,
                             mesh_shape=(mesh.data, mesh.space), rank=mesh.rank)
    resumed = run('graphed', 1, state, gens)
    check(np.array_equal(resumed['losses'], graphed['losses'][2 * RESUME_CHUNK:]),
          f'rank {mesh.rank}: the resumed losses differ from the third chunk')
    unequal = equal_states(resumed['state'], graphed['state'])
    check(not unequal, f'rank {mesh.rank}: the resumed state differs in {unequal}')
    pm.barrier(mesh)
    return {'steps': steps, 'losses_equal': True, 'states_equal': True,
            'resumed_equal': True, 'launches': graphed['launches'],
            'collectives': graphed['collectives'],
            'graph_nodes': graphed['nodes'][0],
            'eager_s': eager['seconds'], 'graphed_s': graphed['seconds'],
            'resumed_s': resumed['seconds']}


def mesh_worker(kind, out, backend, argv):
    """One rank of a mesh run (under torch.distributed.run): 'train'
    (train_torch.py with ``argv``, then the profile), 'dp_train' (the
    data-parallel exactness steps on ``argv``'s --data volume first),
    'graphs' (``mesh_graph_check`` of ``argv``'s run, NCCL only) or
    'nccl_probe' (NCCL with every rank on card 0); writes the rank's result
    into ``out``."""
    import faulthandler
    import torch.distributed as dist
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    from latent_feature_grid_compression_tpu_torch.parallel.distributed import (
        initialize_distributed, rank_device, shutdown_distributed)
    disable_tf32()
    faulthandler.dump_traceback_later(float(os.environ.get('CHIP_SMOKE_DUMP_AFTER_S', 270)),
                                      exit=True)
    if kind == 'nccl_probe':
        torch.cuda.set_device(0)
        result = {}
        try:
            dist.init_process_group('nccl', device_id=torch.device('cuda', 0))
            t = torch.ones(4, device='cuda')
            dist.all_reduce(t)
            torch.cuda.synchronize()
            result['all_reduce'] = t.tolist()
        except Exception as e:   # what NCCL does is what this kind records
            result['error'] = repr(e)[:600]
        torch.save(result, os.path.join(out, f"rank{os.environ['RANK']}.pt"))
        return 0
    initialize_distributed(backend=backend, device='cuda')
    dev = rank_device('cuda', backend)
    rank = dist.get_rank()
    status = 1
    try:
        from latent_feature_grid_compression_tpu_torch.config import config_from_args
        cfg = config_from_args(argv)
        result = {'device': str(dev), 'backend': backend}
        if kind == 'graphs':
            result['graphs'] = mesh_graph_check(cfg, dev, out)
        else:
            import train_torch
            if kind == 'dp_train':
                ph, st, vol, pos = dp_inputs(cfg.data)
                mesh = pm.make_mesh(MESH_RANKS, 1, device=dev)
                part = pos.shape[1] // MESH_RANKS
                result['dp'] = dp_steps(ph, st, vol, pos[:, rank * part:(rank + 1) * part],
                                        pm.make_shard_ctx(mesh, use_space=False))
                del st, vol
            reset_counts()
            pm.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = train_torch.main(argv + ['--dist_backend', backend])
            torch.cuda.synchronize()
            result.update({'info': info, 'seconds': time.perf_counter() - t0,
                           'launches': read_counts(), 'collectives': dict(pm.counts)})
            result['profile'] = mesh_profile(cfg, dev)
        # step graphs still alive here (every runner destroys its own when
        # its phase ends), with what held them; shutdown_distributed would
        # destroy them before it ends the group
        result['graphs_alive_at_end'] = tr.release_step_graphs()
        torch.save(result, os.path.join(out, f'rank{rank}.pt'))
        status = 0
    except BaseException:
        traceback.print_exc()
    # the group ends as train_torch.py ends it; the file says it returned
    t0 = time.perf_counter()
    shutdown_distributed()
    with open(os.path.join(out, f'rank{rank}.end.json'), 'w') as f:
        json.dump({'shutdown_s': time.perf_counter() - t0}, f)
    return status


@torch.no_grad()
def mesh_windows(space, ranks):
    """A space axis' run's tile-local decode on the card before it runs
    (``space`` slabs, ``ranks`` ranks in all): each slab's window of the
    flagship grid over the 256^3 volume, the fetch and gradient kernels
    against their plain versions on the windowed (15, 15, W', 16) grid at
    a rank's trainer positions (fetch within KERNEL_TOL, gradient bit for
    bit the plain version on the CPU), and the windowed forward against
    the full forward at those positions (WINDOW_TOL of max |.|)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    spec = make_spec(**dict(FLAGSHIP, drop_type=cfg.drop_type), interp_backend='xla')
    meta = VolumeMeta((MESH_SPACE_N,) * 3)
    ph = tr.make_phase_spec(cfg, spec, meta, phase=1)
    starts, length = tr.x_windows(ph, space)
    model = init_model(spec, torch.Generator().manual_seed(SEED), device='cuda')
    slab = MESH_SPACE_N // space
    vol = torch.zeros((slab, MESH_SPACE_N, MESH_SPACE_N), device='cuda')
    g = torch.Generator(device='cuda').manual_seed(SEED + 3)
    rows = []
    for s, start in enumerate(starts):
        c = tr.PhaseConstants(ph, vol, s * slab)
        norm, _ = tr.chunk_inputs(c, tr.draw_positions(c, 1, TRAIN_BATCH // ranks, g))
        norm = norm[0]
        grid = channel_minor(decode_volume(model, x_window=(start, length)))
        D, H, W, C = grid.shape
        c0 = ((norm[:, 0] + 1.0) * spec.grid_size - 2.0 * start) / length - 1.0
        coords = torch.cat([c0[:, None], norm[:, 1:]], dim=1).contiguous()
        out = gs.grid_sample_channel_minor_cuda(grid, coords)
        plain = grid_sample_channel_minor(grid, coords)
        fetch_err = (out - plain).abs().max().item()
        check(fetch_err <= KERNEL_TOL, f'windowed fetch off by {fetch_err}')
        dout = torch.randn(out.shape, device='cuda', generator=g)
        dgrid = gs.grid_sample_channel_minor_backward_cuda(dout, coords, D, H, W).cpu()
        dplain = grid_sample_channel_minor_backward(dout.cpu(), coords.cpu(), D, H, W)
        grad_err = rel(dgrid, dplain)
        check(torch.equal(dgrid, dplain),
              f'windowed gradient off its plain version on the CPU by {grad_err} of max |dG|')
        win = apply_model(model, norm, x_window=(start, length))
        full = apply_model(model, norm)
        win_err = rel(win, full)
        check(win_err <= WINDOW_TOL, f'windowed forward off the full one by {win_err}')
        n = coords.shape[0]
        row = {'space_index': s, 'window': [start, length], 'grid': [D, H, W, C], 'n': n,
               'fetch_max_abs_err': fetch_err, 'grad_max_abs_err_relative': grad_err,
               'windowed_vs_full_forward_relative': win_err,
               'fetch_ms': time_ms(lambda: gs.grid_sample_channel_minor_cuda(grid, coords)),
               'fetch_plain_ms': time_ms(lambda: grid_sample_channel_minor(grid, coords)),
               'grad_ms': time_ms(lambda: gs.grid_sample_channel_minor_backward_cuda(
                   dout, coords, D, H, W)),
               'grad_plain_ms': time_ms(lambda: grid_sample_channel_minor_backward(
                   dout, coords, D, H, W))}
        # the library calls on the same inputs: F.grid_sample on the
        # channel-major grid, and aten's backward of it (the input's
        # gradient only)
        feats = grid.permute(3, 0, 1, 2).contiguous()[None]
        grid5 = coords.view(1, n, 1, 1, 3)
        grad_out = dout.t().reshape(1, C, n, 1, 1).contiguous()
        row['fetch_library_ms'] = time_ms(lambda: F.grid_sample(
            feats, grid5, mode='bilinear', padding_mode='zeros', align_corners=False))
        row['grad_library_ms'] = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
            grad_out, feats, grid5, 0, 0, False, [True, False]))
        row['fetch_bound_ms'], row['fetch_bound_by'] = fetch_bound_ms(n, C, D, H, W)
        row['grad_bound_ms'], row['grad_bound_by'] = grad_bound_ms(n, C, D, H, W)
        rows.append(row)
    emit({'phase': 'mesh_windows', 'space': space, 'ranks': ranks,
          'volume': list(meta.resolution),
          'volume_note': f'synth_volume(256, seed=1, octaves=6): 255 does not divide {space}',
          'rows': rows})
    return rows


def mesh_train_row(name, tmp, vol_path, results, seconds, flags, step_calls, default=None,
                   hold_psnr=False):
    """Checks of a train-3 mesh run's ranks and its row: each rank launched
    the fetch and gradient kernels once a step (rank 0 the fetch also once
    an evaluation chunk, and nothing else), every rank made ``step_calls``
    collective calls a step (at least: a phase's end and a save gather the
    ZeRO state), whether replayed or eager, each phase's steps replays of
    one captured graph on every rank where the backend's default says so
    (``cli_steps_graphed``) and eager elsewhere, no step graph alive at a
    rank's end, every rank returns the same evaluation, the loss fell, PSNR
    finite (within PSNR_MESH_DB of train's, ``default``, with
    ``hold_psnr``), the exported container restores."""
    info0 = results[0]['info']
    meta = VolumeMeta(tuple(info0['volume_size']))
    n_chunks = math.ceil(meta.n_voxels / CHUNK)
    steps = info0['train_phase1_steps'] + info0['train_phase2_steps']
    check(steps > 0, f'{name} took no step')
    graphed = cli_steps_graphed(results[0]['backend'])
    for rank, r in enumerate(results):
        info = r['info']
        check(info['train_phase1_steps'] + info['train_phase2_steps'] == steps,
              f'{name}: rank {rank} took another number of steps')
        captures = [info[f'train_phase{ph}_graph_captures'] for ph in (1, 2)]
        check(captures == [int(graphed)] * 2,
              f'{name}: rank {rank} captured {captures} step graphs in its two phases '
              f'(graphed steps: {graphed})')
        check(r['graphs_alive_at_end'] == [],
              f"{name}: rank {rank} ended with step graphs alive, held by "
              f"{r['graphs_alive_at_end']}")
        check(info['psnr'] == info0['psnr'], f'{name}: rank {rank} returned another PSNR')
        want = only({gs.KERNEL: steps + (n_chunks if rank == 0 else 0),
                     gs.BWD_KERNEL: steps, ih.KERNEL: n_chunks if rank == 0 else 0})
        check(r['launches'] == want, f"{name}: rank {rank} launched {r['launches']}, "
                                     f'expected {want}')
        for op, n in step_calls.items():
            got = r['collectives'][op]
            check(got == n * steps if op != 'all_gather' else got >= n * steps,
                  f'{name}: rank {rank} made {got} {op} calls in {steps} steps')
    check(info0['train_phase1_last_loss'] < info0['train_phase1_first_loss'],
          f'{name}: phase 1 loss did not fall')
    check(math.isfinite(info0['psnr']), f"{name}: non-finite PSNR {info0['psnr']}")
    gap = None if default is None else info0['psnr'] - default['psnr']
    if gap is not None and hold_psnr:
        check(abs(gap) <= PSNR_MESH_DB, f"{name} PSNR {info0['psnr']} vs train "
                                        f"{default['psnr']}")
    exp = os.path.join(tmp, name)
    _, restored = restore_model(os.path.join(exp, 'binary_model_file'), wavelet='db2',
                                device='cuda')
    psnr_binary = eval_stats_on_device(restored, meta,
                                       torch.from_numpy(load_volume(vol_path)).cuda())[0]
    check(math.isfinite(psnr_binary), f'{name}: non-finite PSNR of the exported container')
    shutil.rmtree(exp)
    per_rank = [r['info']['train_steps_per_sec'] * r['profile']['eager']['samples_per_rank_step']
                for r in results]
    row = {'phase': name, 'flags': flags, 'ranks': MESH_RANKS,
           'backend': results[0]['backend'], 'devices': [r['device'] for r in results],
           'ranks_share_a_card': len({r['device'] for r in results}) < MESH_RANKS,
           # train_torch.py's steps: graphed on an NCCL mesh, eager under gloo
           'steps_graphed': graphed, 'shutdown_s_by_rank': [r['shutdown_s'] for r in results],
           'collectives': 'torch.distributed on CUDA tensors (no host staging)',
           'volume': list(meta.resolution), 'max_pass': TRAIN_MAX_PASS, 'batch': TRAIN_BATCH,
           'steps': steps, 'launches_by_rank': [r['launches'] for r in results],
           'collective_calls': [r['collectives'] for r in results],
           'torchrun_s': seconds, 'train_cli_s_by_rank': [r['seconds'] for r in results],
           'samples_per_sec_by_rank': per_rank, 'samples_per_sec_summed': sum(per_rank),
           'ms_per_step_by_rank': [r['info']['train_ms_per_step'] for r in results],
           'phases': {ph: {k: info0[f'train_phase{ph}_{k}'] for k in
                           ('steps', 'seconds', 'samples_per_sec', 'first_loss', 'last_loss')}
                      for ph in (1, 2)},
           'psnr': info0['psnr'], 'default_psnr': None if default is None else default['psnr'],
           'psnr_gap_db': gap, 'psnr_gap_held': hold_psnr and gap is not None,
           'psnr_binary_restored': psnr_binary,
           'compression_ratio': info0['compression_ratio'], 'num_zeros': info0['num_zeros'],
           'profile_by_rank': [r['profile'] for r in results]}
    if default is not None and default.get('train_samples_per_sec'):
        row['summed_over_train'] = sum(per_rank) / default['train_samples_per_sec']
    emit(row)
    return row


def gloo_graphs_raise():
    """``solve_phase(graphs=True)`` on a gloo mesh (a world of one on the
    card, this process's own group) raises before any step, naming gloo:
    the message."""
    import torch.distributed as dist
    from latent_feature_grid_compression_tpu_torch.parallel import mesh as pm
    ph, st, vol = flagship_state('')
    with tempfile.TemporaryDirectory() as rendezvous:
        dist.init_process_group('gloo', init_method=f'file://{rendezvous}/file',
                                world_size=1, rank=0)
        try:
            mesh = pm.make_mesh(1, 1)
            tr.solve_phase(ph, st, vol, RESUME_CHUNK, generator=torch.Generator(
                device='cuda'), verbose=False, mesh=mesh, graphs=True)
        except ValueError as e:
            message = str(e)
        else:
            message = None
        finally:
            dist.destroy_process_group()
    check(message is not None and 'gloo' in message and st.step == 0,
          f'graphs=True on a gloo mesh gave {message!r} after {st.step} steps')
    return message


def phase_mesh_graphs(tmp, vol_path, vol256):
    """The step's CUDA graph on the mesh: where every rank has a card
    (NCCL), ``mesh_graph_check`` on every rank of each of ``mesh_runs`` (the
    data axis on the flagship volume; the space axis with ZeRO and
    tile-local decode, and at 4 ranks the 2 x 2 mesh, on the 256^3 one),
    every rank ending its group through shutdown_distributed; on fewer
    cards (NCCL refuses two ranks on one card) a row saying so.  Both:
    graphs=True on a gloo mesh raises."""
    refusal = gloo_graphs_raise()
    cards = torch.cuda.device_count()
    row = {'phase': 'mesh_graphs', 'cards': cards, 'ranks': MESH_RANKS,
           'gloo_graphs_true_raises': refusal}
    if cards < MESH_RANKS:
        row.update(ran=False, reason=f'NCCL graphs need a card a rank: {MESH_RANKS} ranks, '
                                     f'{cards} card(s) (NCCL refuses two ranks on one card; '
                                     f'the mesh runs eagerly under gloo)')
        emit(row)
        return row
    common = ['--config', FLAGSHIP_CONFIG, '--basedir', '/']
    row.update(ran=True, chunks=MESH_GRAPH_CHUNKS, chunk=RESUME_CHUNK, runs={})
    for name, flags, on256, _ in mesh_runs():
        ranks, seconds = mesh_launch(tmp, 'graphs', *common, '--data',
                                     vol256 if on256 else vol_path, *flags, timeout=180)
        check(all(r is not None for r in ranks), f'{name}: a rank wrote no result')
        for rank, r in enumerate(ranks):
            check(r['graphs_alive_at_end'] == [],
                  f"{name}: rank {rank} ended with step graphs alive, held by "
                  f"{r['graphs_alive_at_end']}")
        row['runs'][name] = {'flags': flags, 'torchrun_s': seconds,
                             'shutdown_s_by_rank': [r['shutdown_s'] for r in ranks],
                             'by_rank': [r['graphs'] for r in ranks]}
    emit(row)
    return row


def phase_mesh(tmp, vol_path, default=None):
    """Multi-device training on this machine's cards: MESH_RANKS ranks
    through torch.distributed.run (NCCL with a card a rank, where
    train_torch.py's steps are replays of each phase's step graph; else
    gloo with the ranks on one card, which the port refuses without gloo by
    name, and eager steps).  The data-parallel step against one rank on the
    same global stream, and train-3 on the data axis on the flagship, in
    one launch; the windowed kernels and forward; the graphed steps against
    eager ones (``phase_mesh_graphs``); then train-3 of each other run of
    ``mesh_runs`` (the space axis with the state sharded and tile-local
    decode, and at 4 ranks the 2 x 2 mesh) on a 256^3 volume; under NCCL
    train_torch.py itself under torch.distributed.run (``phase_mesh_cli``).
    Returns rank 0's launch counts of the data axis' run (the mesh path)
    and the windows' rows."""
    from latent_feature_grid_compression_tpu_torch.parallel.distributed import rank_device
    cards, backend = torch.cuda.device_count(), mesh_backend()
    refused = None
    if cards < MESH_RANKS:
        # the port refuses more ranks than cards unless gloo is named ...
        env = {k: os.environ.get(k) for k in ('LOCAL_RANK', 'LOCAL_WORLD_SIZE')}
        os.environ.update(LOCAL_RANK=str(MESH_RANKS - 1), LOCAL_WORLD_SIZE=str(MESH_RANKS))
        try:
            rank_device('cuda', None, verbose=False)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
            torch.cuda.set_device(0)
        check(refused is not None, 'two ranks on one card were not refused without gloo')
    emit({'phase': 'mesh_backend', 'cards': cards, 'ranks': MESH_RANKS, 'backend': backend,
          'ranks_share_a_card': cards < MESH_RANKS,
          'cli_steps_graphed': cli_steps_graphed(backend),
          'port_refuses_without_gloo': refused})

    # 1. data-parallel exactness, then 2. train-3 on the data axis on the
    # flagship, in one launch
    ph, st, vol, pos = dp_inputs(vol_path)
    single = dp_steps(ph, st, vol, pos)
    del st, vol
    common = ['--config', FLAGSHIP_CONFIG, '--max_pass', str(TRAIN_MAX_PASS), '--basedir', '/']
    (dp_name, dp_flags, _, dp_calls), *others = mesh_runs()
    train_ranks, seconds = mesh_launch(tmp, 'dp_train', *common, '--data', vol_path,
                                       '--expname', dp_name, *dp_flags)
    ranks = [r['dp'] for r in train_ranks]
    loss_err = max(rel(r['losses'], single['losses']) for r in ranks)
    check(loss_err <= ATOMICS_TOL, f'data-parallel losses off one rank by {loss_err}')
    m0 = single['m'].abs()
    sure = m0 > ADAM_SURE_SHARE * m0.max()
    flat_err = max((r['flat'] - single['flat'])[sure].abs().max().item() for r in ranks)
    flat_max = max((r['flat'] - single['flat']).abs().max().item() for r in ranks)
    lr = load_config(FLAGSHIP_CONFIG).lr
    check(flat_err <= ATOMICS_TOL, f'data-parallel parameters off by {flat_err}')
    check(flat_max <= 2 * lr * MESH_DP_STEPS, f'a data-parallel parameter off by {flat_max}')
    check(all(torch.equal(r['flat'], ranks[0]['flat']) and torch.equal(r['m'], ranks[0]['m'])
              for r in ranks), 'the ranks ended with different parameters')
    emit({'phase': 'mesh_dp', 'steps': MESH_DP_STEPS, 'batch': TRAIN_BATCH,
          'ranks': MESH_RANKS, 'backend': backend,
          'loss_max_rel_err': loss_err, 'flat_max_abs_err_where_sure': flat_err,
          'flat_max_abs_err': flat_max, 'ranks_bitwise_equal': True,
          'losses_single': single['losses'].tolist(),
          'losses_ranks': ranks[0]['losses'].tolist()})

    mesh_train_row(dp_name, tmp, vol_path, train_ranks, seconds, dp_flags, dp_calls, default,
                   hold_psnr=True)
    counts = {k: train_ranks[0]['launches'][k] for k in (gs.KERNEL, gs.BWD_KERNEL)}

    # 3. the windows, 4. graphed steps against eager ones, then 5. train-3
    # on the space axis, ZeRO and tile-local decode (and 2 x 2)
    windows = mesh_windows(MESH_RANKS, MESH_RANKS)
    if MESH_RANKS == 4:
        mesh_windows(2, MESH_RANKS)   # the 2 x 2 mesh's two slabs
    vol256 = os.path.join(tmp, 'synth256.npy')
    np.save(vol256, synth_volume(MESH_SPACE_N, seed=1, octaves=6))
    phase_mesh_graphs(tmp, vol_path, vol256)
    for name, flags, _, calls in others:
        ranks, seconds = mesh_launch(tmp, 'train', *common, '--data', vol256,
                                     '--expname', name, *flags)
        mesh_train_row(name, tmp, vol256, ranks, seconds, flags, calls, default)
    if backend == 'nccl':
        phase_mesh_cli(tmp, vol_path, vol256, default)
    os.remove(vol256)
    return counts, windows


# train_torch.py's mesh runs under torch.distributed.run, as a user starts
# them: (name, ranks, flags, whether on the 256^3 volume); the 2 x 2 mesh
# only at 4 ranks
CLI_RUNS = (('mesh_cli_dp2', 2, ['--mesh_data', '2'], False),
            ('mesh_cli_dp2_space2_zero_local', 4,
             ['--mesh_data', '2', '--mesh_space', '2', *ZERO_LOCAL], True))
CLI_TIMEOUT_S = 180


def phase_mesh_cli(tmp, vol_path, vol256, default=None):
    """train_torch.py itself, a card a rank (NCCL), under
    torch.distributed.run and a time limit (``run_launcher``): train-3 of
    each of CLI_RUNS that fits MESH_RANKS.  Each exits 0 (every rank left
    through train_torch.py's shutdown_distributed, after graphed steps:
    NCCL's end waits while a graph lives), captured one step graph a phase
    (its info.txt, rank 0's), and its PSNR is within PSNR_MESH_DB of
    train's (``default``, where this run has it)."""
    rows = {}
    for name, ranks, flags, on256 in CLI_RUNS:
        if ranks > MESH_RANKS:
            continue
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', str(ranks), os.path.join(REPO, 'train_torch.py'),
               '--config', FLAGSHIP_CONFIG, '--data', vol256 if on256 else vol_path,
               '--max_pass', str(TRAIN_MAX_PASS), '--basedir', '/', '--expname', name, *flags]
        code, text, seconds = run_launcher(cmd, tmp, os.path.join(tmp, name + '.log'),
                                           CLI_TIMEOUT_S, name)
        if code:
            print(text[-16000:], file=sys.stderr)
        check(code == 0, f'{name}: torch.distributed.run of train_torch.py exited {code}')
        exp = os.path.join(tmp, name)
        info = dict_from_file(os.path.join(exp, 'info.txt'))
        captures = [info[f'train_phase{ph}_graph_captures'] for ph in (1, 2)]
        check(captures == [1, 1], f'{name}: {captures} step graphs captured in the two phases')
        gap = None if default is None else info['psnr'] - default['psnr']
        check(math.isfinite(info['psnr']) and (gap is None or abs(gap) <= PSNR_MESH_DB),
              f"{name}: PSNR {info['psnr']}, train's {None if default is None else default['psnr']}")
        rows[name] = {'ranks': ranks, 'flags': flags, 'exit_code': code, 'torchrun_s': seconds,
                      'graph_captures': captures, 'psnr': info['psnr'], 'psnr_gap_db': gap,
                      'compression_ratio': info['compression_ratio'],
                      'train_ms_per_step': info['train_ms_per_step'],
                      'phase_seconds': [info[f'train_phase{ph}_seconds'] for ph in (1, 2)]}
        shutil.rmtree(exp)
    emit({'phase': 'mesh_cli', 'backend': 'nccl', 'time_limit_s': CLI_TIMEOUT_S,
          'default_psnr': None if default is None else default['psnr'], 'runs': rows})
    return rows


def phase_nccl_probe(tmp):
    """On request only (``--only nccl_probe``): what NCCL does with
    MESH_RANKS ranks on card 0, the reason ranks that share a card run
    gloo."""
    probe, seconds = mesh_launch(tmp, 'nccl_probe', backend='nccl', timeout=120,
                                 may_fail=True)
    emit({'phase': 'nccl_probe', 'ranks': MESH_RANKS, 'card': 0, 'seconds': seconds,
          'results': probe})




def kernel_entry(name, source, replaces, also, path_counts, main_path, **extra):
    """One entry of the kernels line: launches on the main path of the
    kernel and on every path, the numbers at the main path's inputs.
    ``replaces`` None: a kernel with no TPU counterpart."""
    out = {'name': name, 'route': 'cuda',
           'source': f'latent_feature_grid_compression_tpu_torch/csrc/{source}',
           'replaces': (f'latent_feature_grid_compression_tpu/ops/{replaces}' if replaces
                        else None)}
    if also:
        out['also_replaces'] = f'latent_feature_grid_compression_tpu/ops/{also}'
    out['launches'] = path_counts[main_path][name]
    out['launches_by_path'] = {p: c[name] for p, c in path_counts.items() if name in c}
    out.update(extra)
    return out


PHASES = ('build', 'kernel', 'kernel_bwd', 'kernel_mlp', 'kernel_fused', 'kernel_bf16',
          'kernel_head', 'checkpoint', 'binary', 'queries', 'queries_bf16', 'train', 'train_bf16',
          'resume', 'graphs', 'train_families', 'quant', 'readers', 'native', 'nas', 'mesh',
          'step_rates')
# run only when --only names them
ON_REQUEST = ('nccl_probe',)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='comma-separated phases to run after the device phase '
                         f'({", ".join(PHASES)}; also {", ".join(ON_REQUEST)}, run only '
                         f'when named); prints no kernels or ok line')
    # a rank of the mesh phase (torch.distributed.run starts this script
    # with these; the arguments after them are train_torch.py's)
    ap.add_argument('--mesh-worker', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--mesh-out', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--mesh-backend', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--mesh-ranks', type=int, default=MESH_RANKS,
                    help='ranks of the mesh phase (default %(default)s; a card a rank '
                         'runs them under NCCL)')
    args, rest = ap.parse_known_args(argv)
    if rest and args.mesh_worker is None:
        ap.error(f'unrecognized arguments: {" ".join(rest)}')
    args.rest = rest
    if args.only is not None:
        args.only = set(args.only.split(','))
        unknown = args.only - set(PHASES + ON_REQUEST)
        if unknown:
            ap.error(f'unknown phases {sorted(unknown)}; choose from '
                     f'{", ".join(PHASES + ON_REQUEST)}')
    return args


def main(argv=None):
    global MESH_RANKS
    args = parse_args(argv)
    MESH_RANKS = args.mesh_ranks
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    if args.mesh_worker is not None:
        return mesh_worker(args.mesh_worker, args.mesh_out, args.mesh_backend, args.rest)

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
    bf16_rows = (phase_kernel_bf16(flagship_model, flagship_grid)
                 if want('kernel_bf16') else None)
    head_rows = phase_kernel_head(flagship_model, flagship_grid) if want('kernel_head') else None
    path_counts = {}
    model = flagship_model   # the checkpoint phase's model: the same seed
    tmp = tempfile.mkdtemp(prefix='lfgc_chip_smoke_')
    try:
        vol_path = os.path.join(tmp, 'mhd_like.npy')
        if want('checkpoint') or want('train') or want('train_bf16') or \
                want('resume') or want('graphs') or want('train_families') or \
                want('quant') or want('readers') or want('native') or want('nas') or \
                want('mesh') or want('step_rates'):
            np.save(vol_path, synth_volume(VOLUME_N, seed=1, octaves=6))
        if want('checkpoint'):
            _, model, path_counts['decompress'] = phase_checkpoint(tmp, vol_path)
        if want('binary'):
            path_counts['binary'] = phase_binary()
        for phase, suffixes in (('queries', ('', '_mlp_pallas', '_fused')),
                                ('queries_bf16', BF16_BACKENDS)):
            if want(phase):
                for suffix in suffixes:
                    path_counts['queries' + suffix] = phase_queries(model, suffix)
        default = None
        if want('train') or want('resume') or want('quant') or want('native'):
            default, path_counts['train'] = phase_train(
                tmp, vol_path, keep=want('resume') or want('quant') or want('native'))
        if want('train'):
            for suffix in ('_mlp_pallas', '_fused'):
                _, path_counts['train' + suffix] = phase_train(
                    tmp, vol_path, suffix, default)
        if want('train_bf16'):
            for suffix in BF16_BACKENDS:
                _, path_counts['train' + suffix] = phase_train(
                    tmp, vol_path, suffix, default)
        if want('resume'):
            phase_resume(tmp, vol_path, default)
        if want('graphs'):
            phase_graphs(vol_path)
        if want('train_families'):
            for family in FAMILIES:
                _, path_counts['train_' + family] = phase_train(
                    tmp, vol_path, family=family)
        if want('quant'):
            path_counts['quant'] = phase_quant(tmp, vol_path, default)
        if want('readers'):
            phase_readers(tmp, vol_path)
        if want('native'):
            phase_native(tmp, vol_path)
        if want('nas'):
            path_counts.update(phase_nas(tmp, vol_path))
        if want('mesh'):
            path_counts['mesh'], windows = phase_mesh(tmp, vol_path, default)
        if args.only is not None and 'nccl_probe' in args.only:
            phase_nccl_probe(tmp)
        if want('step_rates'):
            phase_step_rates(tmp=tmp, vol_path=vol_path, eager_steps=EAGER_PROFILE_STEPS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.only is not None:
        return 0   # a partial run: no kernels line, no result

    # each kernel's numbers at the main path's own inputs (the flagship,
    # and the precision the model uses: bf16 MLP, 'mixed' fused forward)
    flagship = next(r for r in rows if r['coords'] == 'lattice')
    trainer = next(r for r in rows if r['coords'] == 'trainer' and r['C'] == 16)
    trainer_c22 = next(r for r in rows if r['coords'] == 'trainer' and r['C'] == 22)
    flagship_bwd = next(r for r in bwd_rows if r['coords'] == 'trainer' and r['C'] == 16)
    bwd_c22 = next(r for r in bwd_rows if r['coords'] == 'trainer' and r['C'] == 22)
    mlp = next(r for r in mlp_rows if r['case'] == 'flagship' and r['precision'] == 'bf16')
    fused = next(r for r in fused_rows if r['case'] == 'flagship, trainer coords'
                 and r['precision'] == 'mixed')
    bf16_fetch = [r for r in bf16_rows if r.get('name') == gs.BF16_KERNEL]
    bf16_grad = [r for r in bf16_rows if r.get('name') == gs.BF16_BWD_KERNEL]
    bf16_fused = next(r for r in bf16_rows if r.get('precision') == 'bf16')

    def flagship_bf16(rows, kind):
        return next(r for r in rows if r['C'] == 16 and r['grid'] == 15 and r['coords'] == kind)
    bf16_trainer = flagship_bf16(bf16_fetch, 'trainer')
    bf16_lattice = flagship_bf16(bf16_fetch, 'lattice')
    bf16_grad_trainer = flagship_bf16(bf16_grad, 'trainer')

    def case_name(r):
        return (f"C{r['C']} G{r['grid']} {r['coords']}"
                + (f" n{r['n']}" if r['n'] != TRAIN_BATCH else ''))

    def crowd_ratio(rows):
        """The gradient's time at grid 4 with 262,144 uniform samples over
        its time with 32,768 (linear: about 8)."""
        at = {r['n']: r['kernel_ms'] for r in rows
              if r['grid'] == 4 and r['coords'] == 'uniform' and r['C'] == 16}
        return at[8 * TRAIN_BATCH] / at[TRAIN_BATCH]

    def numbers(row, prefix=''):
        return {'ms': row[prefix + 'kernel_ms'], 'plain_ms': row[prefix + 'plain_ms'],
                'bound_ms': row[prefix + 'bound_ms'], 'bound_by': row[prefix + 'bound_by'],
                'library_ms': row[prefix + 'library_ms']}
    emit({'kernels': [
        kernel_entry(gs.KERNEL, 'grid_sample_fwd.cu', 'pallas_kernels.py:135',
                     'pallas_kernels.py:158', path_counts, 'train',
                     max_abs_err=max(r['max_abs_err'] for r in rows),
                     **numbers(flagship),
                     shape={'n': flagship['n'], 'C': 16, 'grid': 15, 'coords': 'lattice'},
                     plan=flagship['plan'],
                     trainer={**numbers(trainer), 'n': trainer['n'], 'plan': trainer['plan']},
                     trainer_c22_grid17={**numbers(trainer_c22), 'n': trainer_c22['n']},
                     mesh_window=[{k: w[k] for k in ('space_index', 'window', 'grid', 'n',
                                                     'fetch_ms', 'fetch_plain_ms',
                                                     'fetch_library_ms',
                                                     'fetch_bound_ms', 'fetch_max_abs_err')}
                                  for w in windows]),
        kernel_entry(gs.BWD_KERNEL, 'grid_sample_bwd.cu', 'pallas_kernels.py:142',
                     'pallas_kernels.py:182', path_counts, 'train',
                     max_abs_err=max(r['max_abs_err'] for r in bwd_rows),
                     max_abs_err_relative=max(r['max_abs_err'] / r['max_abs_dG']
                                              for r in bwd_rows),
                     tolerance='bit for bit the plain version on the CPU, and a second call',
                     **numbers(flagship_bwd),
                     shape={'n': flagship_bwd['n'], 'C': 16, 'grid': 15,
                            'coords': 'trainer'}, plan=flagship_bwd['plan'],
                     cases={case_name(r): {**numbers(r), 'blocks': r['plan']['blocks']}
                            for r in bwd_rows},
                     grid4_262144_over_32768=crowd_ratio(bwd_rows),
                     trainer_c22_grid17={**numbers(bwd_c22), 'n': bwd_c22['n'],
                                         'plan': bwd_c22['plan']},
                     mesh_window=[{k: w[k] for k in ('space_index', 'window', 'grid', 'n',
                                                     'grad_ms', 'grad_plain_ms',
                                                     'grad_library_ms', 'grad_bound_ms',
                                                     'grad_max_abs_err_relative')}
                                  for w in windows]),
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
                            'precision': 'mixed'}, launch=fused['bwd_launch']),
        kernel_entry(gs.BF16_KERNEL, 'grid_sample_fwd.cu', 'pallas_kernels.py:135',
                     'pallas_kernels.py:158', path_counts, 'train_bf16',
                     max_abs_err=max(r['max_abs_err'] for r in bf16_fetch),
                     max_abs_err_relative=max(r['max_rel_err'] for r in bf16_fetch),
                     **numbers(bf16_trainer),
                     library='F.grid_sample on a bf16 input and grid',
                     shape={'n': bf16_trainer['n'], 'C': 16, 'grid': 15, 'coords': 'trainer',
                            'precision': 'bf16'}, plan=bf16_trainer['plan'],
                     lattice={**numbers(bf16_lattice), 'n': bf16_lattice['n'],
                              'plan': bf16_lattice['plan']},
                     cases={f"C{r['C']} G{r['grid']} {r['coords']}": numbers(r)
                            for r in bf16_fetch}),
        kernel_entry(gs.BF16_BWD_KERNEL, 'grid_sample_bwd.cu', 'pallas_kernels.py:142',
                     'pallas_kernels.py:182', path_counts, 'train_bf16',
                     max_abs_err=max(r['max_abs_err'] for r in bf16_grad),
                     max_abs_err_relative=max(r['max_rel_err'] for r in bf16_grad),
                     tolerance='bit for bit the plain version on the CPU, and a second call',
                     **numbers(bf16_grad_trainer),
                     library='F.grid_sample autograd backward on a bf16 input and grid',
                     shape={'n': bf16_grad_trainer['n'], 'C': 16, 'grid': 15,
                            'coords': 'trainer', 'precision': 'bf16'},
                     plan=bf16_grad_trainer['plan'],
                     cases={case_name(r): numbers(r) for r in bf16_grad},
                     grid4_262144_over_32768=crowd_ratio(bf16_grad)),
        kernel_entry('fused_forward_fwd_bf16', 'fused_forward.cu', 'fused_forward.py:113',
                     None, path_counts, 'train_bf16_fused',
                     max_abs_err=bf16_fused['max_abs_err'], **numbers(bf16_fused),
                     library="the default bf16 route: fetch ('bf16' kernel) + fourier_embed "
                             "+ torch.cat + mlp_apply_bf16 (cuBLAS)",
                     shape={'n': bf16_fused['n'], 'dims': bf16_fused['dims'],
                            'grid': bf16_fused['grid'], 'precision': 'bf16'},
                     launch=bf16_fused['fwd_launch']),
        kernel_entry('fused_forward_bwd_bf16', 'fused_forward.cu', 'fused_forward.py:129',
                     None, path_counts, 'train_bf16_fused',
                     max_abs_err=bf16_fused['bwd_max_abs_err'],
                     max_abs_err_relative=bf16_fused['bwd_max_rel_err'],
                     **numbers(bf16_fused, 'bwd_'),
                     library='the default bf16 route forward + autograd backward',
                     shape={'n': bf16_fused['n'], 'dims': bf16_fused['dims'],
                            'grid': bf16_fused['grid'], 'precision': 'bf16'},
                     launch=bf16_fused['bwd_launch']),
        kernel_entry(ih.KERNEL, 'inference_head.cu', None, None, path_counts, 'decompress',
                     no_tpu_counterpart='the JAX package leaves this head to XLA',
                     max_abs_err=max(r['max_abs_err'] for r in head_rows),
                     library='its plain version: torch.cat + fourier_embed + mlp_apply '
                             '(cuBLAS) + clamp',
                     cases={f"C{r['C']} n{r['n']}": {
                         'ms': r['kernel_ms'], 'plain_ms': r['plain_ms'],
                         'library_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                         'bound_by': r['bound_by'], 'plan': r['plan']}
                         for r in head_rows})]})
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
