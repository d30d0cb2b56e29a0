"""Separable 3-D discrete wavelet transform in PyTorch.

Port of the JAX package's ``ops/dwt.py``:

* encode: one stride-2 ``conv3d`` with the 2^3 separable analysis filters,
  channels folded into the batch; constant(0) pad of (2L-3)//2 on each side,
  +1 on the trailing side for odd sizes.
* decode: the synthesis as three per-axis matmuls with (2, s_in, s_out)
  operators built in numpy by pushing unit coefficients through the
  transposed-conv algebra (upsample, full convolution with the
  reconstruction filter, centred crop).  Subband bits have the first spatial
  axis as the most significant bit.

Both run in float32.  On the card, call :func:`~..device.disable_tf32` first:
cuDNN would otherwise run the float32 ``conv3d`` in TF32.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..wavelets import get_filter_bank, dwt_max_level


def _outer_filters(bank_lo: np.ndarray, bank_hi: np.ndarray) -> np.ndarray:
    """(8, k, k, k) separable 3-D filters; subband index bits have the first
    spatial axis as the most significant bit, 0 = lowpass."""
    filters_1d = [np.asarray(bank_lo), np.asarray(bank_hi)]
    out = list(filters_1d)
    for _ in range(2):
        out = [np.multiply.outer(f1, fn) for f1 in filters_1d for fn in out]
    return np.stack(out, axis=0)


@functools.lru_cache(maxsize=None)
def _analysis_filters(wavelet: str) -> np.ndarray:
    bank = get_filter_bank(wavelet)
    if bank.filter_length % 2 != 0:
        raise ValueError("uneven filter length not supported")
    # flipped so the correlation of conv3d is a true convolution
    return _outer_filters(bank.dec_lo[::-1], bank.dec_hi[::-1]).astype(np.float32)


def _pad_widths(shape: Sequence[int], filter_length: int):
    """Per-dim (lo, hi) constant-pad widths."""
    base = (2 * filter_length - 3) // 2
    return [(base, base + (s % 2)) for s in shape]


def encoded_size(size: int, filter_length: int) -> int:
    """Length of one subband axis after encoding an axis of ``size``: the
    stride-2 valid convolution over the padded axis."""
    (lo, hi), = _pad_widths([size], filter_length)
    return (size + lo + hi - filter_length) // 2 + 1


@functools.lru_cache(maxsize=None)
def _synthesis_matrix_cached(wavelet: str, s_in: int, s_out: int) -> np.ndarray:
    """(2, s_in, s_out) [T_lo, T_hi]: column j of T is the full convolution of
    the upsampled unit coefficient e_j with the reconstruction filter,
    centre-cropped to s_out (floor of the excess on the leading side)."""
    bank = get_filter_bank(wavelet)
    out = []
    for rec in (bank.rec_lo, bank.rec_hi):
        T = np.zeros((s_in, s_out))
        for j in range(s_in):
            up = np.zeros(2 * s_in - 1)
            up[2 * j] = 1.0
            full = np.convolve(up, rec)
            diff = len(full) - s_out
            lo = int(np.floor(diff / 2))
            hi = len(full) - int(np.ceil(diff / 2))
            T[j] = full[lo:hi]
        out.append(T)
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _synthesis_matrix(wavelet: str, s_in: int, s_out: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """:func:`_synthesis_matrix_cached` as a tensor, kept on ``device``.

    The trainer decodes on every step: a copy from (non-pinned) host memory
    would synchronise the stream each time, so each operator is copied to the
    device once and reused.  The cached tensors must not be written to."""
    return torch.as_tensor(_synthesis_matrix_cached(wavelet, s_in, s_out),
                           device=device, dtype=dtype)


class WaveletFilter3d:
    """3-D DWT with the encode/decode contract of the JAX package.

    encode: (B, C, D, H, W) -> (coeffs (B, C, 8, D', H', W'), input shape)
    decode: coeffs (B, C, 8, D', H', W'), target shape -> (B, C, D, H, W)
    """

    def __init__(self, wavelet: str):
        self.wavelet = wavelet
        self.filter_length = get_filter_bank(wavelet).filter_length

    def encode(self, data: torch.Tensor):
        if data.dim() != 5:
            raise ValueError(f"encode expects rank 5, got {data.dim()}")
        B, C = data.shape[:2]
        spatial = tuple(data.shape[2:])
        pads = _pad_widths(spatial, self.filter_length)
        # F.pad takes (lo, hi) pairs from the last axis backwards
        x = F.pad(data, [w for p in pads[::-1] for w in p])
        x = x.reshape(B * C, 1, *x.shape[2:])
        k = torch.as_tensor(_analysis_filters(self.wavelet), device=data.device,
                            dtype=data.dtype)[:, None]          # (8, 1, k, k, k)
        y = F.conv3d(x, k, stride=2)
        y = y.reshape(B, C, 8, *y.shape[2:])
        return y, np.asarray(spatial, dtype=int)

    def decode(self, coeffs: torch.Tensor, shape, last_window=None) -> torch.Tensor:
        """``last_window`` (start, length): only that window of the last
        axis' output, by a column slice of its operator before the first
        contraction (the same dot products as the full decode's columns)."""
        if coeffs.dim() != 6:
            raise ValueError(f"decode expects rank 6, got {coeffs.dim()}")
        B, C = coeffs.shape[:2]
        spatial = tuple(coeffs.shape[3:])
        shape = tuple(int(v) for v in np.asarray(shape, dtype=int))
        x = coeffs.reshape((B * C, 2, 2, 2) + spatial)
        Ts = [_synthesis_matrix(self.wavelet, s_in, s_out, coeffs.device,
                                coeffs.dtype)
              for s_in, s_out in zip(spatial, shape)]
        if last_window is not None:
            start, length = (int(v) for v in last_window)
            if not 0 <= start <= shape[2] - length:
                raise ValueError(f"window {last_window} outside an axis of {shape[2]}")
            Ts[2] = Ts[2][:, :, start:start + length]
            shape = shape[:2] + (length,)
        y = torch.einsum('nabwxyz,wzZ->nabxyZ', x, Ts[2])
        y = torch.einsum('nabxyZ,byY->naxYZ', y, Ts[1])
        y = torch.einsum('naxYZ,axX->nXYZ', y, Ts[0])
        return y.reshape((B, C) + shape)


def encode_pyramid(filt: WaveletFilter3d, volume: torch.Tensor,
                   num_levels: int | None = None
                   ) -> Tuple[List[torch.Tensor], np.ndarray]:
    """Multi-level forward DWT of a (C, D, H, W) feature volume.

    Returns (coeffs, shapes): coeffs = [lowpass (C, *s_L)] + details from
    coarsest to finest [(C, 7, *s_i), ...]; shapes[i] is the spatial shape to
    restore when decoding level i (coarsest first)."""
    if num_levels is None:
        num_levels = min(dwt_max_level(int(s), filt.filter_length)
                         for s in volume.shape[-3:])
    details, shapes = [], []
    data = volume[None]
    for _ in range(num_levels):
        filtered, shape = filt.encode(data)
        details.append(filtered[0, :, 1:])
        shapes.append(shape)
        data = filtered[:, :, 0]
    coeffs = [data[0]] + details[::-1]
    return coeffs, np.asarray(shapes[::-1], dtype=int)


def decode_pyramid(filt: WaveletFilter3d, coeffs: Sequence[torch.Tensor],
                   shapes, last_window=None) -> torch.Tensor:
    """Inverse of :func:`encode_pyramid`; returns (C, D, H, W).

    last_window: (start, length), or None: decode only that window of the
    final level's last axis (the tile-local decode of the space-sharded
    trainer; the coarser levels are small and decoded whole)."""
    restored = coeffs[0][None]
    n = len(shapes)
    for i, (high, shape) in enumerate(zip(coeffs[1:], shapes)):
        data = torch.cat([restored[:, :, None], high[None]], dim=2)
        restored = filt.decode(data, shape, last_window if i == n - 1 else None)
    return restored[0]
