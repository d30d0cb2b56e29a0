"""The benchmark's volume: the repository's ``mhd_like`` field
(``examples/make_test_volume.py::synth_volume``) rewritten in torch and made
on the device, so set-up spends no seconds in numpy.

``octaves`` multi-scale products of sines and cosines with random phases and
wave numbers, plus a localized vortex-like blob, on an n^3 lattice over
[-1, 1]^3, then normalized to [-1, 1] over its min and max as the port's
``load_volume`` normalizes a file.  The phases and wave numbers are drawn
from ``seed``; the work of every cell is the same for every seed.  Computed
in float32 (the original in float64, then cast).
"""

from __future__ import annotations

import math

import torch


def mhd_like(n: int, octaves: int, seed: int, device) -> torch.Tensor:
    """(n, n, n) float32 on ``device``, in [-1, 1]."""
    gen = torch.Generator(device='cpu').manual_seed(seed)
    # per octave: 3 phases in [0, 2 pi), 3 wave numbers in [1, 3)
    draws = torch.rand((octaves, 6), generator=gen, dtype=torch.float64)
    phase = (draws[:, :3] * 2.0 * math.pi).tolist()
    wave = (1.0 + 2.0 * draws[:, 3:]).tolist()
    ax = torch.linspace(-1.0, 1.0, n, device=device, dtype=torch.float32)
    x, y, z = ax.view(n, 1, 1), ax.view(1, n, 1), ax.view(1, 1, n)
    vol = torch.zeros((n, n, n), device=device, dtype=torch.float32)
    for o in range(octaves):
        f, amp = 2.0 ** o, 0.5 ** o
        vol += amp * (torch.sin(wave[o][0] * f * math.pi * x + phase[o][0])
                      * torch.cos(wave[o][1] * f * math.pi * y + phase[o][1])
                      * torch.sin(wave[o][2] * f * math.pi * z + phase[o][2]))
    r2 = x * x + y * y + z * z
    vol += 1.5 * torch.exp(-8.0 * r2) * torch.sin(12.0 * torch.atan2(y, x + 1e-9))
    lo, hi = vol.min(), vol.max()
    return (2.0 * (vol - lo) / (hi - lo) - 1.0).contiguous()
