#!/usr/bin/env python
"""Variants of the trilinear fetch and grid-gradient kernels, timed in turns
on one NVIDIA card.

    python3 ablate_fetch.py [--parent DIR] [--variants whole,bwd_unroll_4,...]
                            [--cases 'bwd trainer,bwd uniform C16 G4',...]

Builds csrc/grid_sample_fwd.cu and csrc/grid_sample_bwd.cu (the gradient
kernel) as they are ('whole') and once for each variant below, a copy of
csrc/ with one piece replaced, and with ``--parent`` the two sources of
another tree's csrc/ (for example the parent commit's, unpacked with ``git
archive``) as the variant 'parent'; every nvcc started together, into a
temporary directory.  Then times the wrappers with chip_smoke.time_ms at
the main path's shapes and a few others, every variant in turns over three
rounds (the order reversed every other round): the fetch at C = 16, grid 15
on one 2^18 chunk of the 255^3 lattice (evaluation) and on one train step's
32,768 trainer positions, and on 2^18 uniform coordinates at grid 4, grid
23, grid 62, C = 32, C = 5, and C = 22 on grid 17 (two configs of the
repo), the last two with scalar loads; the fetch in 'bf16' as the bf16
compute path runs it (``gs.fetch(grid, coords, 'bf16')`` under no_grad,
from the float32 grid) at the lattice and trainer cases, grid 23, C = 5 and
C = 22 on grid 17 on the trainer positions (a parent whose 'bf16' entry
reads a bf16 copy of the grid, as PR 9's does, is timed with the copy made
before its launch, as its fetch made it); the gradient at one train step's
batch on the trainer positions (C = 16, grid 15; C 22 on grid 17) and on
uniform coordinates at grids 4, 5, 6, 8, 10, 12, 22, 23, 32 and 62, C 5, C
32 on grid 13 and C 64 on grid 10, at grid 4 with 4,096 and 262,144
samples and on 32,768 samples clustered in 8 cells of grid 15, and in
'bf16' at the flagship, C 22 on grid 17, grids 4 and 23, C 5 and both
crowded cases (a parent whose gradient is one cooperative launch with grid
barriers, as the previous design's, is timed through its own entries with
the torch.empty of its own, larger scratch).  A fetch variant
('fwd_*') is timed on the fetch cases of both modes, a gradient variant
('bwd_*') on the gradient cases, 'whole' and 'parent' on all.  Each
variant is held against the plain versions first (max |diff|; the 'bf16'
fetch and the gradient kernel must equal their plain versions, the
gradient's run on the CPU, bit for bit, or the script raises; a cut
variant's gradient is reported relative to max |dG|), reports whether each
fetch's output is bit for bit the first variant's, its ptxas registers and
spill stores, its launch plan at each case, and the host's time to
enqueue a call of the trainer cases behind a busy card (``enqueue_ms``).
Prints the card, one JSON line a variant and round, and a last line of
medians.  Exits non-zero without a card.

Fetch variants: fwd_cell_shfl (the first lane of a sample finds its cell
and shuffles it to the others), fwd_no_prefetch (each step loads its own
coordinates, none ahead), fwd_threads_128 and fwd_threads_512 (blocks of
that many threads), fwd_min_blocks_6 and fwd_min_blocks_8 (a launch bound
asking for that many blocks an SM, which caps the registers),
and, in the 'bf16' mode, which samples' lanes take 8 channels (two float4s
a corner, or 8 scalar loads) in place of 4: those of every fetch
(fwd_8_a_lane), of every fetch on the scalar route and of the large ones
on the float4 route (fwd_8_a_lane_scalar), of none (fwd_4_a_lane); and its
roundings one value at a time, by a conversion (fwd_bf16_round_each) or by
integer operations (fwd_bf16_round_int), in place of a packed conversion a
pair.  Gradient variants: bwd_per_corner (every box takes the corners one
at a time, the route of crowded boxes), bwd_unroll_4 and bwd_unroll_16
(a lane's terms loaded 4 or 16 together in place of 8), bwd_table_1k (a
quarter of the sort's (bucket, warp) table: fewer warps sort),
bwd_tile_256 and bwd_tile_512 (tiles of at least 256 or 512 samples in
place of 128: fewer tiles, longer shares), bwd_lane_1 and bwd_lane_2 (at
most 1 or 2 channels a lane in the gather), and four
cuts that time the phases by difference, their dG wrong and reported, not
raised: bwd_cut_gather (no gather), bwd_cut_stage (no staging or gather),
bwd_cut_sort (no sort, staging or gather: the tiles' segments and the
compaction), bwd_cut_box (no box kernel: the tile kernel alone); and
bwd_no_early_launch (the box kernel launched only once the tile kernel
has ended).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs
from ablate_mlp import build_all, use
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval.reconstruct import (
    CHUNK, lattice_chunk, lattice_constants)
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    grid_sample_channel_minor, grid_sample_channel_minor_backward,
    grid_sample_channel_minor_backward_bf16, grid_sample_channel_minor_bf16)

FWD = 'grid_sample_fwd.cu'
BWD = 'grid_sample_bwd.cu'
CELL = '    const lfgc::Cell cell = lfgc::cell_of(cx, cy, cz, D, H, W);\n'
CELL_SHFL = '''    lfgc::Cell cell, own;
    if (sub == 0) own = lfgc::cell_of(cx, cy, cz, D, H, W);
    {
      const unsigned mask = Lw == 32 ? 0xffffffffu : ((1u << Lw) - 1u) << (slot * Lw);
      const int src = slot * Lw;
      cell.x0 = __shfl_sync(mask, own.x0, src);
      cell.y0 = __shfl_sync(mask, own.y0, src);
      cell.z0 = __shfl_sync(mask, own.z0, src);
      cell.fx = __shfl_sync(mask, own.fx, src);
      cell.fy = __shfl_sync(mask, own.fy, src);
      cell.fz = __shfl_sync(mask, own.fz, src);
    }
'''
CELL_OWN_LOADS = ('    const lfgc::Cell cell = lfgc::cell_of(__ldg(coords + 3 * i), '
                  '__ldg(coords + 3 * i + 1),\n'
                  '                                          __ldg(coords + 3 * i + 2), '
                  'D, H, W);\n')
FWD_THREADS = 'constexpr int kThreads = 256;\n'
FWD_BOUND = '__global__ void __launch_bounds__(kThreads)\ngrid_sample_fwd_kernel('
# where the 'bf16' mode's lanes take 8 channels (two float4s a corner, or 8
# scalar loads) in place of 4
WIDE_STEPS = 'constexpr int kWideSteps = 4;\n'
WIDE = 'const bool wide = bf16 && steps >= kWideSteps * warps;'
# how the 'bf16' mode rounds the grid values and plane sums: packed pairs,
# or one value at a time by a conversion or by integer operations (to
# nearest even on the float's bits)
TRI = 'trilinear.cuh'
ROUND_PAIRS = '''  for (int k = 0; k + 1 < K; k += 2) {
    const float2 r = __bfloat1622float2(__floats2bfloat162_rn(v[k], v[k + 1]));
    v[k] = r.x;
    v[k + 1] = r.y;
  }
  if (K % 2) v[K - 1] = bf16_round(v[K - 1]);
'''
ROUND_EACH = '  for (int k = 0; k < K; ++k) v[k] = bf16_round(v[k]);\n'
ROUND_INT = '''  for (int k = 0; k < K; ++k) {
    const unsigned u = __float_as_uint(v[k]);
    if (v[k] == v[k]) v[k] = __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  }
'''
BWD_CUT_GATHER = (BWD, 'for (int u = threadIdx.x >> 5; u < units; u += kWarps) {',
                  'for (int u = units; u < units; u += kWarps) {')
BWD_CUT_STAGE = (BWD, '  const int ws = weight_stride(BF16), gw = scale_words(cb);\n',
                 '  m = 0;\n  const int ws = weight_stride(BF16), gw = scale_words(cb);\n')
BWD_CUT_SORT = (BWD, '  const int lo = warp < nwp ? int(int64_t(m) * warp / nwp) : 0;\n'
                     '  const int hi = warp < nwp ? int(int64_t(m) * (warp + 1) / nwp) : 0;',
                '  const int lo = 0, hi = 0;')
VARIANTS = {
    'whole': [],
    'fwd_cell_shfl': [(FWD, CELL, CELL_SHFL)],
    'fwd_no_prefetch': [(FWD, '    if (next < n) {\n', '    if (false) {\n'),
                        (FWD, CELL, CELL_OWN_LOADS)],
    'fwd_threads_128': [(FWD, FWD_THREADS, FWD_THREADS.replace('256', '128'))],
    'fwd_threads_512': [(FWD, FWD_THREADS, FWD_THREADS.replace('256', '512'))],
    'fwd_min_blocks_6': [(FWD, FWD_BOUND, FWD_BOUND.replace('(kThreads)', '(kThreads, 6)'))],
    'fwd_min_blocks_8': [(FWD, FWD_BOUND, FWD_BOUND.replace('(kThreads)', '(kThreads, 8)'))],
    'fwd_8_a_lane': [(FWD, WIDE_STEPS, WIDE_STEPS.replace('4;', '0;'))],
    'fwd_8_a_lane_scalar': [(FWD, WIDE, WIDE.replace('steps >=', '(!vec4 || steps >=')
                             .replace('warps;', 'warps);'))],
    'fwd_4_a_lane': [(FWD, WIDE_STEPS, WIDE_STEPS.replace('4;', '(1 << 30);'))],
    'fwd_bf16_round_each': [(TRI, ROUND_PAIRS, ROUND_EACH)],
    'fwd_bf16_round_int': [(TRI, ROUND_PAIRS, ROUND_INT)],
    # the gradient: every box a corner at a time (the crowded route);
    # 2 or 8 terms of a chain loaded together; a quarter of the sort's
    # (bucket, warp) table, so fewer warps sort
    'bwd_per_corner': [(BWD, 'bool per_corner = b.per_corner != 0;',
                        'bool per_corner = true;')],
    'bwd_unroll_4': [(BWD, 'constexpr int kUnroll = 8;', 'constexpr int kUnroll = 4;')],
    'bwd_unroll_16': [(BWD, 'constexpr int kUnroll = 8;', 'constexpr int kUnroll = 16;')],
    'bwd_table_1k': [(BWD, 'constexpr int kTableInts = 4096;', 'constexpr int kTableInts = 1024;')],
    'bwd_tile_256': [(BWD, 'constexpr int kMinTile = 128;', 'constexpr int kMinTile = 256;')],
    'bwd_tile_512': [(BWD, 'constexpr int kMinTile = 128;', 'constexpr int kMinTile = 512;')],
    'bwd_lane_1': [(BWD, 'for (int k = 4; k > 1; k /= 2) {', 'for (int k = 1; k > 1; k /= 2) {')],
    'bwd_lane_2': [(BWD, 'for (int k = 4; k > 1; k /= 2) {', 'for (int k = 2; k > 1; k /= 2) {')],
    # cuts, to time the phases (their dG is not the gradient): no gather; no
    # staging or gather; no sort, staging or gather; no box kernel (the tile
    # kernel alone)
    'bwd_cut_gather': [BWD_CUT_GATHER],
    'bwd_cut_stage': [BWD_CUT_STAGE, BWD_CUT_GATHER],
    'bwd_cut_sort': [BWD_CUT_SORT, BWD_CUT_STAGE, BWD_CUT_GATHER],
    'bwd_cut_box': [(BWD, 'err = cudaLaunchKernelEx(&cfg, kernel_of(BF16), args, p.b);', '')],
    # the box kernel launched only once the tile kernel has ended
    'bwd_no_early_launch': [(BWD, 'early.val.programmaticStreamSerializationAllowed = 1;',
                             'early.val.programmaticStreamSerializationAllowed = 0;')],
}
SOURCES = ('grid_sample_fwd', 'grid_sample_bwd')


def ptxas_of(log):
    """Registers and spill stores of the two kernels' entries."""
    return [e for e in cs.ptxas_summary(log) if 'grid_sample' in e['entry']]


def make_cases(gen):
    """name -> (direction, C, grid, n, coords, input): the fetch's input
    ('fwd', 'bf16') is the channel-minor grid, the gradient's ('bwd', 'bwd
    bf16' in that mode) the output gradient g."""
    n_eval, n_step = CHUNK, cs.TRAIN_BATCH
    lattice, _ = lattice_chunk(lattice_constants(VolumeMeta((cs.VOLUME_N,) * 3), n_eval,
                                                 torch.device('cuda')), 32 * n_eval)

    def uniform(n):
        return torch.rand((n, 3), device='cuda', generator=gen) * 2.4 - 1.2

    def grid(C, G):
        return torch.randn((G, G, G, C), device='cuda', generator=gen)

    def grad(n, C):
        return torch.randn((n, C), device='cuda', generator=gen)
    trainer = cs.trainer_positions(n_step, gen)
    clustered = cs.clustered_positions(n_step, 15, gen)
    return {
        'fwd lattice C16 G15': ('fwd', 16, 15, n_eval, lattice, grid(16, 15)),
        'fwd trainer C16 G15': ('fwd', 16, 15, n_step, trainer, grid(16, 15)),
        'fwd uniform C16 G4': ('fwd', 16, 4, n_eval, uniform(n_eval), grid(16, 4)),
        'fwd uniform C16 G23': ('fwd', 16, 23, n_eval, uniform(n_eval), grid(16, 23)),
        'fwd uniform C16 G62': ('fwd', 16, 62, n_eval, uniform(n_eval), grid(16, 62)),
        'fwd uniform C32 G15': ('fwd', 32, 15, n_eval, uniform(n_eval), grid(32, 15)),
        'fwd uniform C5 G15': ('fwd', 5, 15, n_eval, uniform(n_eval), grid(5, 15)),
        'fwd uniform C22 G17': ('fwd', 22, 17, n_eval, uniform(n_eval), grid(22, 17)),
        'fwd bf16 lattice C16 G15': ('bf16', 16, 15, n_eval, lattice, grid(16, 15)),
        'fwd bf16 trainer C16 G15': ('bf16', 16, 15, n_step, trainer, grid(16, 15)),
        'fwd bf16 uniform C16 G23': ('bf16', 16, 23, n_eval, uniform(n_eval), grid(16, 23)),
        'fwd bf16 uniform C5 G15': ('bf16', 5, 15, n_eval, uniform(n_eval), grid(5, 15)),
        'fwd bf16 trainer C22 G17': ('bf16', 22, 17, n_step, trainer, grid(22, 17)),
        'bwd trainer C16 G15': ('bwd', 16, 15, n_step, trainer, grad(n_step, 16)),
        'bwd trainer C22 G17': ('bwd', 22, 17, n_step, trainer, grad(n_step, 22)),
        **{f'bwd uniform C16 G{G}': ('bwd', 16, G, n_step, uniform(n_step), grad(n_step, 16))
           for G in (4, 5, 6, 8, 10, 12, 22, 23, 32, 62)},
        'bwd uniform C5 G15': ('bwd', 5, 15, n_step, uniform(n_step), grad(n_step, 5)),
        'bwd uniform C32 G13': ('bwd', 32, 13, n_step, uniform(n_step), grad(n_step, 32)),
        'bwd uniform C64 G10': ('bwd', 64, 10, n_step, uniform(n_step), grad(n_step, 64)),
        **{f'bwd uniform C16 G4 n{n}': ('bwd', 16, 4, n, uniform(n), grad(n, 16))
           for n in (4096, 8 * n_step)},
        'bwd clustered C16 G15': ('bwd', 16, 15, n_step, clustered, grad(n_step, 16)),
        'bwd bf16 trainer C16 G15': ('bwd bf16', 16, 15, n_step, trainer, grad(n_step, 16)),
        'bwd bf16 trainer C22 G17': ('bwd bf16', 22, 17, n_step, trainer, grad(n_step, 22)),
        **{f'bwd bf16 uniform C16 G{G}': ('bwd bf16', 16, G, n_step, uniform(n_step),
                                          grad(n_step, 16)) for G in (4, 23)},
        'bwd bf16 uniform C5 G15': ('bwd bf16', 5, 15, n_step, uniform(n_step), grad(n_step, 5)),
        'bwd bf16 uniform C16 G4 n262144': ('bwd bf16', 16, 4, 8 * n_step, uniform(8 * n_step),
                                            grad(8 * n_step, 16)),
        'bwd bf16 clustered C16 G15': ('bwd bf16', 16, 15, n_step, clustered, grad(n_step, 16)),
    }


def takes_bf16_copy(csrc):
    """Whether the 'bf16' fetch entry of the sources in ``csrc`` reads a
    bf16 copy of the grid (PR 9's kernel), not the float32 grid."""
    return 'const __nv_bfloat16* __restrict__ grid' in (csrc / FWD).read_text()


def fetch_bf16_from_copy(grid, coords):
    """The 'bf16' fetch of an entry that reads a bf16 copy of the grid: the
    copy, the output and the launch, as that entry's fetch made them."""
    grid16 = grid.to(torch.bfloat16)
    D, H, W, C = grid.shape
    n = coords.shape[0]
    out = torch.empty((n, C), device=grid.device)
    vec8 = C % 8 == 0 and grid16.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    gs._launch(gs.KERNEL, 'lfgc_grid_sample_fwd_bf16', grid16, coords, out, n, C, D, H, W,
               vec8)
    return out


def grad_route(csrc):
    """How the gradient of the sources in ``csrc`` runs: 'cooperative' (one
    cooperative launch with grid barriers, whose scratch holds sorted copies
    of the samples) or 'boxes' (the tile and box kernels, whose scratch
    holds the tiles' items and their bins' first items)."""
    text = (csrc / BWD).read_text()
    return 'cooperative' if 'cudaLaunchCooperativeKernel(' in text else 'boxes'


def grad_cooperative(g, coords, G, precision):
    """The gradient of a cooperative entry: its wrapper's torch.empty of dG
    and of its scratch ((6 + C) n + 3 (G+1)^3 + 2 + 1024 ints), then the
    launch."""
    n, C = g.shape
    dgrid = torch.empty((G, G, G, C), device=g.device)
    scratch = torch.empty((6 + C) * n + 3 * (G + 1) ** 3 + 2 + 1024, device=g.device,
                          dtype=torch.int32)
    lib, fn = _build.entry(gs.BWD_KERNEL, f'lfgc_grid_sample_bwd_{precision}', gs.BWD_ARGTYPES)
    err = fn(g.data_ptr(), coords.data_ptr(), dgrid.data_ptr(), scratch.data_ptr(),
             scratch.numel(), n, C, G, G, G, torch.cuda.current_stream(g.device).cuda_stream)
    _build.raise_on_error(lib, gs.BWD_KERNEL, err)
    return dgrid


def call(case, bf16_copy=False, route='boxes'):
    """The wrapper's call for a case (the 'bf16' fetch as the bf16 compute
    path calls it; ``bf16_copy``: through a bf16 copy of the grid;
    ``route``: the gradient through the entries of another tree's kernel,
    grad_route's 'cooperative')."""
    direction, C, G, _, coords, a = case
    if direction == 'fwd':
        return lambda: gs.grid_sample_channel_minor_cuda(a, coords)
    if direction == 'bf16':
        if bf16_copy:
            return lambda: fetch_bf16_from_copy(a, coords)
        return lambda: gs.fetch(a, coords, 'bf16')
    precision = 'bf16' if direction == 'bwd bf16' else 'f32'
    if route == 'cooperative':
        return lambda: grad_cooperative(a, coords, G, precision)
    if precision == 'bf16':
        return lambda: gs.grid_sample_channel_minor_backward_bf16_cuda(a, coords, G, G, G)
    return lambda: gs.grid_sample_channel_minor_backward_cuda(a, coords, G, G, G)


def error(case, bf16_copy=False, route='boxes', strict=True):
    """max |kernel - plain|; raises where the 'bf16' fetch, or the gradient
    kernel, is not its plain version (the gradient's run on the CPU) bit for
    bit; with ``strict`` False (a cut variant) its error over max |dG|
    instead."""
    direction, _, G, _, coords, a = case
    got = call(case, bf16_copy, route)()
    if direction == 'fwd':
        return (got - grid_sample_channel_minor(a, coords)).abs().max().item()
    if direction == 'bf16':
        want = grid_sample_channel_minor_bf16(a, coords)
        if not torch.equal(got, want):
            raise RuntimeError(f"'bf16' fetch differs from its plain version by "
                               f"{(got - want).abs().max().item()} (C {a.shape[3]}, "
                               f"grid {G})")
        return 0.0
    plain = (grid_sample_channel_minor_backward_bf16 if direction == 'bwd bf16'
             else grid_sample_channel_minor_backward)
    want = plain(a.cpu(), coords.cpu(), G, G, G)
    if not strict:
        return cs.rel(got.cpu(), want)
    if not torch.equal(got.cpu(), want):
        raise RuntimeError(f'the gradient kernel differs from its plain version on the '
                           f'CPU by {(got.cpu() - want).abs().max().item()} ({direction}, '
                           f'C {a.shape[1]}, grid {G})')
    return 0.0


def plan(case):
    direction, C, G, n, _, a = case
    if direction in ('fwd', 'bf16'):
        return gs.fwd_plan(n, C, G, G, G, gs._vec4(C, a), 'bf16' if direction == 'bf16'
                           else 'f32')
    return gs.bwd_plan(n, C, G, G, G, 'bf16' if direction == 'bwd bf16' else 'f32')


# cases whose host enqueue time is read, behind a busy card
ENQUEUE_CASES = ('fwd trainer C16 G15', 'bwd trainer C16 G15', 'bwd bf16 trainer C16 G15')


def enqueue_ms(fn, calls=20, reps=5):
    """Host time to enqueue one call while the card is busy: ``calls`` calls
    issued behind a spin kernel that outlasts them, the median of ``reps``.
    A launch that waits for the card (rather than queueing behind it) shows
    as about the spin's length over ``calls``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cs.SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def timed(variant, case_name):
    """Whether ``variant`` is timed on the case: 'whole' and 'parent' on
    every case, a variant on the cases of its kernel."""
    return variant in ('whole', 'parent') or variant[:3] == case_name[:3]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', type=Path, default=None,
                    help="another tree's csrc/ directory, built and timed as 'parent'")
    ap.add_argument('--variants', default=None,
                    help='comma-separated variants to build and time (default: all)')
    ap.add_argument('--cases', default=None,
                    help='comma-separated prefixes of the cases to time (default: all)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('ablate_fetch: CUDA is not available', file=sys.stderr)
        return 1
    cs.disable_tf32()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    variants = dict(VARIANTS)
    if args.parent is not None:
        variants['parent'] = args.parent.resolve()
    if args.variants is not None:
        variants = {k: variants[k] for k in args.variants.split(',')}
    cases = make_cases(torch.Generator(device='cuda').manual_seed(cs.SEED))
    if args.cases is not None:
        prefixes = tuple(args.cases.split(','))
        cases = {c: case for c, case in cases.items() if c.startswith(prefixes)}
    root = Path(tempfile.mkdtemp(prefix='lfgc_ablate_fetch_'))
    csrc, build_dir = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        logs = build_all(csrc, root, variants, SOURCES)
        ms = {name: {c: [] for c in cases if timed(name, c)} for name in variants}
        copy = {name: takes_bf16_copy(root / name / 'csrc') for name in variants}
        routes = {name: grad_route(root / name / 'csrc') for name in variants}
        first = {}   # the first variant's fetch outputs
        for name in variants:
            use(root / name / 'csrc')
            with torch.no_grad():
                errs = {c: error(case, copy[name], routes[name], '_cut_' not in name)
                        for c, case in cases.items() if timed(name, c)}
                equal = {}
                for c, case in cases.items():
                    if timed(name, c) and case[0] in ('fwd', 'bf16'):
                        out = call(case, copy[name])()
                        equal[c] = torch.equal(out, first.setdefault(c, out))
                enqueue = {c: enqueue_ms(call(cases[c], copy[name], routes[name]))
                           for c in ENQUEUE_CASES if c in cases and timed(name, c)}
            plans = ({c: plan(case) for c, case in cases.items() if timed(name, c)}
                     if name != 'parent' else None)
            print(json.dumps({'variant': name, 'ptxas': ptxas_of(logs[name]),
                              'bf16_grid_copy': copy[name], 'grad_route': routes[name],
                              'max_err': errs, 'enqueue_ms': enqueue,
                              'equal_to_first': equal, 'plans': plans}), flush=True)
        order = list(variants)
        for rnd in range(3):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                use(root / name / 'csrc')
                row = {'variant': name, 'round': rnd}
                with torch.no_grad():
                    for c in ms[name]:
                        row[c] = cs.time_ms(call(cases[c], copy[name], routes[name]))
                        ms[name][c].append(row[c])
                print(json.dumps(row), flush=True)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = csrc, build_dir
        _build._loaded.clear()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({'median_ms': {name: {c: statistics.median(v) for c, v in d.items()}
                                    for name, d in ms.items()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
