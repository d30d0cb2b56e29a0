#!/usr/bin/env python
"""Variants of the trilinear fetch and grid-gradient kernels, timed in turns
on one NVIDIA card.

    python3 ablate_fetch.py [--parent DIR] [--variants whole,bwd_shared,...]

Builds csrc/grid_sample_fwd.cu and csrc/grid_sample_bwd.cu as they are
('whole') and once for each variant below, a copy of csrc/ with one piece
replaced, and with ``--parent`` the two sources of another tree's csrc/ (for
example the parent commit's, unpacked with ``git archive``) as the variant
'parent'; every nvcc started together, into a temporary directory.  Then
times the wrappers with chip_smoke.time_ms at the main path's shapes and a
few others, every variant in turns over three rounds (the order reversed
every other round): the fetch at C = 16, grid 15 on one 2^18 chunk of the
255^3 lattice (evaluation) and on one train step's 32,768 trainer positions,
and on 2^18 uniform coordinates at grid 4, grid 62, C = 32, C = 5, and
C = 22 on grid 17 (two configs of the repo), the last two with scalar
loads; the gradient at one train step's batch on the trainer positions
(C = 16, grid 15) and on
uniform coordinates at grids 4, 5, 6, 8, 10, 12, 22 and 32, at C 32 on grid
13 and C 64 on grid 10 (their dG does not fit one block's shared memory),
and at grid 4 with 4,096 and 262,144 samples; and torch.zeros of the
flagship's dG alone, which the gradient's wrapper runs before the kernel.
A fetch variant ('fwd_*') is timed on the fetch cases, a gradient variant
('bwd_*') on the gradient cases, 'whole' and 'parent' on both.  Each
variant is held against the plain versions first (max |diff|; the
gradient relative to max |dG|), and reports its ptxas registers and spill
stores and its launch plan at each case.  Prints the card, one JSON line a
variant and round, and a last line of medians.  Exits non-zero without a
card.

Fetch variants: fwd_cell_shfl (the first lane of a sample finds its cell
and shuffles it to the others), fwd_no_prefetch (each step loads its own
coordinates, none ahead), fwd_threads_128 and fwd_threads_512 (blocks of
that many threads), fwd_min_blocks_6 and fwd_min_blocks_8 (a launch bound
asking for that many blocks an SM, which caps the registers),
fwd_8_a_lane (8 channels a lane: two float4s a corner, or 8 scalar loads)
and fwd_8_a_lane_scalar (8 a lane on the scalar route only).  Gradient
variants: bwd_shared (the shared route wherever dG fits one block, however
few adds an address), bwd_global (the global route at every shape),
bwd_pad4 (the shared copy's rows 4 floats longer than C), bwd_threads_512
(shared-route blocks of 512 threads).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from ablate_mlp import build_all, use
from latent_feature_grid_compression_tpu_torch.data.volume import VolumeMeta
from latent_feature_grid_compression_tpu_torch.eval.reconstruct import CHUNK, lattice_chunk
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import grid_sample as gs
from latent_feature_grid_compression_tpu_torch.ops.interpolation import (
    grid_sample_channel_minor, grid_sample_channel_minor_backward)

FWD = 'grid_sample_fwd.cu'
BWD = 'grid_sample_bwd.cu'
ROUTE = 'p->shared = bytes <= optin && 8 * n >= kSharedMinAdds * rows;'
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
FWD_THREADS = 'constexpr int kThreads = 256;\n\ntemplate <bool VEC4>'
FWD_BOUND = '__global__ void __launch_bounds__(kThreads)\ngrid_sample_fwd_kernel('
# 8 channels a lane instead of 4: the float4 route loads two float4s a corner
FWD_LANES = '  const int L = (C + 3) / 4;            // lanes a sample needs'
FWD_LOOP = '    for (int c = 4 * sub; c < C; c += 4 * Lw) {'
PLAN_LANES = '  const int L = (C + 3) / 4;\n  p->vec4 = vec4;'
FLOAT4_CORNERS = '''        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        lfgc::for_each_corner(cell, D, H, W, [&](int64_t r, float w) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(grid + r * C + c));
          acc.x = fmaf(w, g.x, acc.x);
          acc.y = fmaf(w, g.y, acc.y);
          acc.z = fmaf(w, g.z, acc.z);
          acc.w = fmaf(w, g.w, acc.w);
        });
        *reinterpret_cast<float4*>(dst + c) = acc;'''
TWO_FLOAT4_CORNERS = '''        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 acc2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const bool two = c + 4 < C;
        lfgc::for_each_corner(cell, D, H, W, [&](int64_t r, float w) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(grid + r * C + c));
          acc.x = fmaf(w, g.x, acc.x);
          acc.y = fmaf(w, g.y, acc.y);
          acc.z = fmaf(w, g.z, acc.z);
          acc.w = fmaf(w, g.w, acc.w);
          if (two) {
            const float4 h = __ldg(reinterpret_cast<const float4*>(grid + r * C + c + 4));
            acc2.x = fmaf(w, h.x, acc2.x);
            acc2.y = fmaf(w, h.y, acc2.y);
            acc2.z = fmaf(w, h.z, acc2.z);
            acc2.w = fmaf(w, h.w, acc2.w);
          }
        });
        *reinterpret_cast<float4*>(dst + c) = acc;
        if (two) *reinterpret_cast<float4*>(dst + c + 4) = acc2;'''
SCALAR_8 = [(FWD, '        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};',
             '        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};'),
            (FWD, '          for (int k = 0; k < 4; ++k) {\n            if (c + k < C) acc[k] = fmaf',
             '          for (int k = 0; k < 8; ++k) {\n            if (c + k < C) acc[k] = fmaf'),
            (FWD, '        for (int k = 0; k < 4; ++k) {\n          if (c + k < C) dst[c + k] = acc[k];',
             '        for (int k = 0; k < 8; ++k) {\n          if (c + k < C) dst[c + k] = acc[k];')]
VARIANTS = {
    'whole': [],
    'fwd_cell_shfl': [(FWD, CELL, CELL_SHFL)],
    'fwd_no_prefetch': [(FWD, '    if (next < n) {\n', '    if (false) {\n'),
                        (FWD, CELL, CELL_OWN_LOADS)],
    'fwd_threads_128': [(FWD, FWD_THREADS, FWD_THREADS.replace('256', '128'))],
    'fwd_threads_512': [(FWD, FWD_THREADS, FWD_THREADS.replace('256', '512'))],
    'fwd_min_blocks_6': [(FWD, FWD_BOUND, FWD_BOUND.replace('(kThreads)', '(kThreads, 6)'))],
    'fwd_min_blocks_8': [(FWD, FWD_BOUND, FWD_BOUND.replace('(kThreads)', '(kThreads, 8)'))],
    'fwd_8_a_lane': [(FWD, FWD_LANES, FWD_LANES.replace('(C + 3) / 4', '(C + 7) / 8')),
                     (FWD, FWD_LOOP, FWD_LOOP.replace('4 *', '8 *')),
                     (FWD, PLAN_LANES, PLAN_LANES.replace('(C + 3) / 4', '(C + 7) / 8')),
                     (FWD, FLOAT4_CORNERS, TWO_FLOAT4_CORNERS)] + SCALAR_8,
    'fwd_8_a_lane_scalar': [
        (FWD, FWD_LANES, FWD_LANES.replace('(C + 3) / 4', '(VEC4 ? (C + 3) / 4 : (C + 7) / 8)')),
        (FWD, FWD_LOOP, FWD_LOOP.replace('4 *', '(VEC4 ? 4 : 8) *')),
        (FWD, PLAN_LANES, PLAN_LANES.replace('(C + 3) / 4', '(vec4 ? (C + 3) / 4 : (C + 7) / 8)'))]
        + SCALAR_8,
    'bwd_shared': [(BWD, ROUTE, 'p->shared = bytes <= optin;')],
    'bwd_global': [(BWD, ROUTE, 'p->shared = false;')],
    'bwd_pad4': [(BWD, 'p->pitch = C;', 'p->pitch = C + 4;')],
    'bwd_threads_512': [(BWD, 'kSharedThreads = 1024;', 'kSharedThreads = 512;')],
}
SOURCES = ('grid_sample_fwd', 'grid_sample_bwd')


def ptxas_of(log):
    """Registers and spill stores of the two kernels' entries."""
    return [e for e in cs.ptxas_summary(log) if 'grid_sample' in e['entry']]


def make_cases(gen):
    """name -> (direction, C, grid, n, coords, input): the fetch's input is
    the channel-minor grid, the gradient's the output gradient g."""
    n_eval, n_step = CHUNK, cs.TRAIN_BATCH
    lattice, _ = lattice_chunk(VolumeMeta((cs.VOLUME_N,) * 3), 32 * n_eval, n_eval,
                               torch.device('cuda'))

    def uniform(n):
        return torch.rand((n, 3), device='cuda', generator=gen) * 2.4 - 1.2

    def grid(C, G):
        return torch.randn((G, G, G, C), device='cuda', generator=gen)

    def grad(n, C):
        return torch.randn((n, C), device='cuda', generator=gen)
    trainer = cs.trainer_positions(n_step, gen)
    return {
        'fwd lattice C16 G15': ('fwd', 16, 15, n_eval, lattice, grid(16, 15)),
        'fwd trainer C16 G15': ('fwd', 16, 15, n_step, trainer, grid(16, 15)),
        'fwd uniform C16 G4': ('fwd', 16, 4, n_eval, uniform(n_eval), grid(16, 4)),
        'fwd uniform C16 G62': ('fwd', 16, 62, n_eval, uniform(n_eval), grid(16, 62)),
        'fwd uniform C32 G15': ('fwd', 32, 15, n_eval, uniform(n_eval), grid(32, 15)),
        'fwd uniform C5 G15': ('fwd', 5, 15, n_eval, uniform(n_eval), grid(5, 15)),
        'fwd uniform C22 G17': ('fwd', 22, 17, n_eval, uniform(n_eval), grid(22, 17)),
        'bwd trainer C16 G15': ('bwd', 16, 15, n_step, trainer, grad(n_step, 16)),
        'bwd uniform C16 G4': ('bwd', 16, 4, n_step, uniform(n_step), grad(n_step, 16)),
        'bwd uniform C16 G22': ('bwd', 16, 22, n_step, uniform(n_step), grad(n_step, 16)),
        'bwd uniform C16 G32': ('bwd', 16, 32, n_step, uniform(n_step), grad(n_step, 16)),
        **{f'bwd uniform C16 G{G}': ('bwd', 16, G, n_step, uniform(n_step), grad(n_step, 16))
           for G in (5, 6, 8, 10, 12)},
        'bwd uniform C32 G13': ('bwd', 32, 13, n_step, uniform(n_step), grad(n_step, 32)),
        'bwd uniform C64 G10': ('bwd', 64, 10, n_step, uniform(n_step), grad(n_step, 64)),
        **{f'bwd uniform C16 G4 n{n}': ('bwd', 16, 4, n, uniform(n), grad(n, 16))
           for n in (4096, 8 * n_step)},
        'zeros C16 G15': ('zeros', 16, 15, 0, None, None),
    }


def call(case):
    """The wrapper's call for a case."""
    direction, C, G, _, coords, a = case
    if direction == 'fwd':
        return lambda: gs.grid_sample_channel_minor_cuda(a, coords)
    if direction == 'zeros':   # the wrapper's zeroing of dG alone
        return lambda: torch.zeros((G, G, G, C), device='cuda')
    return lambda: gs.grid_sample_channel_minor_backward_cuda(a, coords, G, G, G)


def error(case):
    """max |kernel - plain| (the gradient's over max |dG|)."""
    direction, _, G, _, coords, a = case
    if direction == 'zeros':
        return 0.0
    got = call(case)()
    if direction == 'fwd':
        return (got - grid_sample_channel_minor(a, coords)).abs().max().item()
    return cs.rel(got, grid_sample_channel_minor_backward(a, coords, G, G, G))


def plan(case):
    direction, C, G, n, _, a = case
    if direction == 'zeros':
        return None
    return (gs.fwd_plan if direction == 'fwd' else gs.bwd_plan)(n, C, G, G, G,
                                                                 gs._vec4(C, a))


def timed(variant, case_name):
    return variant in ('whole', 'parent') or variant[:3] == case_name[:3]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', type=Path, default=None,
                    help="another tree's csrc/ directory, built and timed as 'parent'")
    ap.add_argument('--variants', default=None,
                    help='comma-separated variants to build and time (default: all)')
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
    root = Path(tempfile.mkdtemp(prefix='lfgc_ablate_fetch_'))
    csrc, build_dir = _build.CSRC_DIR, _build.BUILD_DIR
    ms = {name: {c: [] for c in cases if timed(name, c)} for name in variants}
    try:
        logs = build_all(csrc, root, variants, SOURCES)
        for name in variants:
            use(root / name / 'csrc')
            with torch.no_grad():
                errs = {c: error(case) for c, case in cases.items() if timed(name, c)}
            plans = ({c: plan(case) for c, case in cases.items() if timed(name, c)}
                     if name != 'parent' else None)
            print(json.dumps({'variant': name, 'ptxas': ptxas_of(logs[name]),
                              'max_err': errs, 'plans': plans}), flush=True)
        order = list(variants)
        for rnd in range(3):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                use(root / name / 'csrc')
                row = {'variant': name, 'round': rnd}
                with torch.no_grad():
                    for c in ms[name]:
                        row[c] = cs.time_ms(call(cases[c]))
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
