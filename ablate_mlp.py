#!/usr/bin/env python
"""Where the time of the bf16 MLP kernels goes, on one NVIDIA card.

    python3 ablate_mlp.py

Builds csrc/mlp_fused.cu and csrc/fused_forward.cu as they are, and once for
each variant below: a copy of csrc/ with one piece of the tensor-core tile
routines (csrc/snake_mlp_tc.cuh) or of the one-kernel forward taken out, or
one constant of the forward's launch changed, every nvcc started together,
into a temporary directory.  Then times the wrappers, every variant in turns
over three rounds, with chip_smoke.time_ms, at one train step's 32,768
samples, 'bf16' / 'mixed': the fused MLP backward and forward at the
flagship widths (31 -> 4 x 32 -> 1) and at 128 -> 3 x 128 -> 4, and the
one-kernel backward and forward on the flagship's 15^3 x 16 grid.  A cut
variant computes wrong results: its time less the whole kernel's is what the
piece costs, up to the overlap of the pieces.  Prints the card, one JSON
line a variant and round, and a last line of medians.  Exits non-zero
without a card.

Cuts: no_sin (the activation and its derivative without sinf), no_chain
(the hidden chain: the forward's layers before the head, the backward's
recompute), no_dw, no_db, no_dh (those jobs of the backward skipped),
no_loads (x and the output gradient not read), no_route (the one-kernel
backward's dX not written out for the gradient kernel), no_fetch (the
one-kernel kernels' x0 feature columns not fetched).  x0_per_entry: the bf16 kernels' x0 built one
entry a thread (build_x0, as the 'f32' kernels do) instead of one sample
and 4 channels a thread.  Launch variants of the forward: fwd_tile_128
(tiles of up to 128 samples), fwd_threads_128 and fwd_threads_512 (blocks of
that many threads, as many an SM at 64 registers a thread).
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from latent_feature_grid_compression_tpu_torch.ops import _build
from latent_feature_grid_compression_tpu_torch.ops import fused_forward as ff
from latent_feature_grid_compression_tpu_torch.ops import mlp_fused as mf

TC = 'snake_mlp_tc.cuh'
FF = 'fused_forward.cu'
# the bf16 kernels' x0 built by build_x0, one thread an entry
X0_START = ('  bf16* x0 = tc_x0(p, smem);\n'
            '  const int S = p.S, P0 = tc_x0_pitch(p)')
X0_PER_ENTRY = ('  bf16* x0 = tc_x0(p, smem);\n'
                '  build_x0([&](int s, int col, float v) {\n'
                '    x0[s * tc_x0_pitch(p) + col] = __float2bfloat16_rn(v); },\n'
                '    coords, g, n_freqs, p.S, row0, n);\n'
                '  return;\n'
                '  const int S = p.S, P0 = tc_x0_pitch(p)')
VARIANTS = {
    'whole': [],
    'no_sin': [(TC, 'h0 = snake(z0);', 'h0 = z0;'), (TC, 's0 = snake_grad(z0);', 's0 = z0;'),
               (TC, 'h1 = snake(z1);', 'h1 = z1;'), (TC, 's1 = snake_grad(z1);', 's1 = z1;')],
    'no_chain': [(TC, 'for (int i = 0; i + 1 < m.nw; ++i) {', 'for (int i = 0; i < 0; ++i) {')],
    'no_dw': [(TC, 'n_dw = (MP / 16) * cw', 'n_dw = 0 * cw')],
    'no_db': [(TC, 'n_db = MP / 8', 'n_db = 0 * MP')],
    'no_dh': [(TC, 'n_dh = (S / 16) * ch', 'n_dh = 0 * ch')],
    'no_loads': [(TC, 'return row0 + e / K0 < n ? x[row0 * K0 + e] : 0.0f;', 'return 0.0f;'),
                 (TC, 'return o < D && row0 + s < n ? g[(row0 + s) * D + o] : 0.0f;',
                  'return 0.0f;')],
    'no_route': [(FF, 'for (int e = threadIdx.x; e < S * C; e += blockDim.x) {',
                  'for (int e = threadIdx.x; e < 0; e += blockDim.x) {')],
    'no_fetch': [(FF, 'for (int e = threadIdx.x; e < S * Q; e += blockDim.x) {',
                  'for (int e = threadIdx.x; e < 0; e += blockDim.x) {')],
    'x0_per_entry': [(FF, X0_START, X0_PER_ENTRY)],
    'fwd_tile_128': [(TC, 'kTcFwdMaxTile = 64;', 'kTcFwdMaxTile = 128;')],
    'fwd_threads_128': [(TC, 'kTcFwdThreads = 256;', 'kTcFwdThreads = 128;')],
    'fwd_threads_512': [(TC, 'kTcFwdThreads = 256;', 'kTcFwdThreads = 512;')],
}
SOURCES = ('mlp_fused', 'fused_forward')


def use(csrc: Path):
    """Point the build at a copy of csrc/ and its own build directory."""
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, csrc.parent / 'build'
    _build._loaded.clear()


def build_all(src: Path, root: Path, variants=VARIANTS, sources=SOURCES):
    """Each variant's sources, every nvcc started together: a copy of `src`
    with the variant's substitutions, or of the directory a variant names
    in their place (another tree's csrc/).  Returns nvcc's output (ptxas
    reports) by variant."""
    procs = []
    for name, subs in variants.items():
        csrc = root / name / 'csrc'
        if isinstance(subs, Path):
            shutil.copytree(subs, csrc)
            subs = []
        else:
            shutil.copytree(src, csrc)
        for f, old, new in subs:
            text = (csrc / f).read_text()
            if old not in text:
                raise RuntimeError(f'{name}: {old!r} not in {f}')
            (csrc / f).write_text(text.replace(old, new))
        use(csrc)
        _build.BUILD_DIR.mkdir(parents=True)
        for kernel in sources:
            procs.append((name, subprocess.Popen(
                _build._nvcc_command(kernel, _build.library_path(kernel)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = dict.fromkeys(variants, '')
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed ({name}):\n{log}')
        logs[name] += log
    return logs


def main():
    if not torch.cuda.is_available():
        print('ablate_mlp: CUDA is not available', file=sys.stderr)
        return 1
    cs.disable_tf32()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    n = cs.TRAIN_BATCH
    cases = {}
    for dims in ([31, 32, 32, 32, 32, 1], [128, 128, 128, 128, 4]):
        ws, bs = cs.random_mlp(dims, gen)
        x = torch.randn((n, dims[0]), device='cuda', generator=gen)
        g = torch.randn((n, dims[-1]), device='cuda', generator=gen)
        cases[f'mlp bwd {dims}'] = (lambda ws=ws, bs=bs, x=x, g=g:
                                    mf.mlp_fused_backward_cuda(ws, bs, x, g, 'bf16'))
        cases[f'mlp fwd {dims}'] = (lambda ws=ws, bs=bs, x=x:
                                    mf.mlp_fused_cuda(ws, bs, x, 'bf16'))
    grid = torch.randn((15, 15, 15, 16), device='cuda', generator=gen)
    coords = cs.trainer_positions(n, gen)
    fws, fbs = cs.random_mlp([31, 32, 32, 32, 32, 1], gen)
    fg = torch.randn((n, 1), device='cuda', generator=gen)
    cases['fused bwd [31, 32, 32, 32, 32, 1]'] = (
        lambda: ff.fused_forward_backward_cuda(grid, coords, fws, fbs, 2, fg, 'mixed'))
    cases['fused fwd [31, 32, 32, 32, 32, 1]'] = (
        lambda: ff.fused_forward_cuda(grid, coords, fws, fbs, 2, 'mixed'))

    root = Path(tempfile.mkdtemp(prefix='lfgc_ablate_'))
    csrc, build_dir = _build.CSRC_DIR, _build.BUILD_DIR
    ms = {name: {case: [] for case in cases} for name in VARIANTS}
    try:
        build_all(csrc, root)
        for rnd in range(3):
            for name in VARIANTS:
                use(root / name / 'csrc')
                row = {'variant': name, 'round': rnd}
                for case, fn in cases.items():
                    row[case] = cs.time_ms(fn)
                    ms[name][case].append(row[case])
                print(json.dumps(row), flush=True)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = csrc, build_dir
        _build._loaded.clear()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({'median_ms': {name: {case: statistics.median(v) for case, v in c.items()}
                                    for name, c in ms.items()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
