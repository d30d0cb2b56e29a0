#!/usr/bin/env python
"""Train a config through train_torch.py with the trilinear fetch of the
float32 path swapped, for a study of what the fetch's rounding does to a
trained model (masked straight-through's train-60 compression ratio above
all).  ``--fetch``:

* ``kernel``: nothing swapped, the port as users run it (the fetch and
  gradient kernels, each step a replay of the step's CUDA graph);
* ``split``: the plain fetch and gradient that split every product into
  bf16 halves as the TPU kernel's 'f32' mode does
  (``grid_sample_channel_minor_split`` and its backward, here: no path of
  the port runs them);
* ``plain``: the plain float32 fetch and gradient
  (``grid_sample_channel_minor`` and its backward), the control for the
  swap itself.

The swapped versions run as PyTorch operators on the card, in the training
steps (each a replay of the step's CUDA graph, as the kernels' steps) and in
the evaluation.

    python3 split_fetch_train.py --fetch split -- \\
        --config experiment-config-files/mhd_p_masked_st.txt --expname split_

The arguments after ``--`` are train_torch.py's.  Prints the card's name
and power limit, then the run's info with the mode and the seconds as one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from unittest import mock

import torch

import train_torch
from latent_feature_grid_compression_tpu_torch.models import feature_grid
from latent_feature_grid_compression_tpu_torch.ops import interpolation as interp


def bf16_split(t: torch.Tensor):
    """(hi, lo): t rounded to bfloat16, and what is left rounded to
    bfloat16, both as float32 (the TPU kernels' ``_split_bf16``)."""
    hi = interp.bf16_round(t)
    return hi, interp.bf16_round(t - hi)


def grid_sample_channel_minor_split(grid: torch.Tensor, coords: torch.Tensor
                                    ) -> torch.Tensor:
    """The fetch as the TPU kernel's 'f32' mode computes it from a
    channel-minor (D, H, W, C) float32 grid at (N, 3) points -> (N, C):
    every product of a weight and a grid value taken in three exact bf16
    passes of split factors (w_hi g_hi, then w_lo g_hi, then w_hi g_lo: the
    JAX kernel's ``_dot_f32``), each pass summed over a z plane's xy
    corners and the passes added; then each plane's z-weighted sum split
    in two and the halves summed over the planes (``_dot_f32_right_exact``
    against the 0/1 z-sum matrix).  The lo x lo product is dropped, so the
    result differs from ``grid_sample_channel_minor`` by up to ~2^-16
    of a term: the reference for what the TPU's 'f32' fetch rounds."""
    D, H, W, C = grid.shape
    g_hi, g_lo = bf16_split(grid.reshape(D * H * W, C))
    hi = lo = None
    for wz, corners in interp._planes(coords, D, H, W):
        passes = [None, None, None]
        for row, wxy in corners:
            w_hi, w_lo = bf16_split(wxy)
            for k, (w, g) in enumerate(((w_hi, g_hi), (w_lo, g_hi), (w_hi, g_lo))):
                term = g[row] * w[:, None]
                passes[k] = term if passes[k] is None else passes[k] + term
        z_hi, z_lo = bf16_split(wz[:, None] * (passes[0] + passes[1] + passes[2]))
        hi = z_hi if hi is None else hi + z_hi
        lo = z_lo if lo is None else lo + z_lo
    return hi + lo


def grid_sample_channel_minor_backward_split(g: torch.Tensor, coords: torch.Tensor,
                                             D: int, H: int, W: int) -> torch.Tensor:
    """Gradient of :func:`grid_sample_channel_minor_split` with respect to
    the grid as the TPU kernel's 'f32' backward computes it, for the (N, C)
    output gradient ``g`` -> (D, H, W, C): g spread over the z planes in two
    exact passes (g_hi + g_lo), weighted by each plane's wz and split, then
    the three passes of split products with each corner's xy weight, each
    pass summed over the samples and the passes added."""
    C = g.shape[1]
    g_hi, g_lo = bf16_split(g)
    g_exp = g_hi + g_lo
    passes = [torch.zeros((D * H * W, C), dtype=g.dtype, device=g.device) for _ in range(3)]
    for wz, corners in interp._planes(coords, D, H, W):
        b_hi, b_lo = bf16_split(wz[:, None] * g_exp)
        for row, wxy in corners:
            w_hi, w_lo = bf16_split(wxy)
            for out, w, b in zip(passes, (w_hi, w_lo, w_hi), (b_hi, b_hi, b_lo)):
                out.index_add_(0, row, b * w[:, None])
    return (passes[0] + passes[1] + passes[2]).view(D, H, W, C)


VERSIONS = {
    'split': (grid_sample_channel_minor_split, grid_sample_channel_minor_backward_split),
    'plain': (interp.grid_sample_channel_minor, interp.grid_sample_channel_minor_backward),
}


class _Swapped(torch.autograd.Function):
    """A fetch (forward, backward) pair as the model's differentiable fetch."""

    @staticmethod
    def forward(ctx, grid, coords, forward, backward):
        ctx.save_for_backward(coords)
        ctx.grid_shape = tuple(grid.shape[:3])
        ctx.backward_fn = backward
        return forward(grid, coords)

    @staticmethod
    def backward(ctx, g):
        coords, = ctx.saved_tensors
        return ctx.backward_fn(g.contiguous(), coords, *ctx.grid_shape), None, None, None


def swapped_fetch(version, original):
    """``feature_grid.fetch`` with its float32 mode through ``version``."""
    forward, backward = VERSIONS[version]

    def fetch(grid, coords, precision='f32'):
        if precision != 'f32':
            return original(grid, coords, precision)
        return _Swapped.apply(grid, coords, forward, backward)
    return fetch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--fetch', choices=('kernel',) + tuple(VERSIONS), default='kernel')
    ap.add_argument('train_args', nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    train_args = args.train_args[1:] if args.train_args[:1] == ['--'] else args.train_args
    if shutil.which('nvidia-smi'):
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout, end='', flush=True)
    patches = []
    if args.fetch != 'kernel':
        patches = [mock.patch.object(feature_grid, 'fetch',
                                     swapped_fetch(args.fetch, feature_grid.fetch))]
    for p in patches:
        p.start()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    try:
        sync()
        t0 = time.perf_counter()
        info = train_torch.main(train_args)
        sync()
        seconds = time.perf_counter() - t0
    finally:
        for p in patches:
            p.stop()
    print(json.dumps({'fetch': args.fetch, 'seconds': seconds, 'train_args': train_args,
                      **{k: v for k, v in info.items()
                         if isinstance(v, (int, float, str, bool, type(None)))}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
