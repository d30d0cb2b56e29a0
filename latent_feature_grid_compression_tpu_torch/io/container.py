"""The packed binary model container and its ``_mask.bnr``: writer and
reader.

The byte layout is the JAX package's ``io/container.py`` (itself the
reference's model_utils.py format):

  header:  9 x u8 (n_layers, layer_width, input_dim, d_in, output_dim,
           bit_precision, grid_size, n_grids, feature_size)
           + n_grids x u32 nonzero counts + n_grids x u32 zero counts
  MLP:     first layer weight + bias raw f32, (out, in) row-major; middle
           layers' weights k-means quantized (2^bits f32 centers + bit-packed
           labels) with raw f32 biases; last layer raw f32
  grids:   per-tensor nonzero mask bits in ``<file>_mask.bnr``; the nonzero
           values quantized like the middle layers

Labels are packed big-endian, most significant bit first.  When a section is
not byte aligned, a trailing u32 holds the section's last label (the writer
right-aligns the last partial byte, so that label is re-read from the u32).
The 1-D k-means (seed 0, at most 100 Lloyd iterations) goes through the
port's native helper (``native/lib.py``, the JAX package's
``native/lfgc_io.cpp`` algorithm), as the JAX writer quantizes through its
own build of that helper; bit packing is numpy's and gives the bytes the
JAX writer's packer does: for the same parameters the two packages write
the same container and ``_mask.bnr`` byte for byte.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..native import lib as native
from ..models.feature_grid import FeatureGridModel, ModelSpec, coeff_shapes, make_spec


def kmeans_quantization(values: np.ndarray, n_clusters: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """1-D k-means -> (labels, n_clusters float32 centers), by the native
    helper with the JAX writer's arguments (seed 0, max_iter 100).

    An empty input (a fully pruned tensor) gives no labels and zero centers;
    fewer distinct values than clusters are fitted with one cluster each and
    the centers zero-padded, so the byte layout stays fixed."""
    x = np.asarray(values, dtype=np.float32).reshape(-1)
    if len(x) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(n_clusters, dtype=np.float32)
    k = min(n_clusters, len(np.unique(x)))
    labels, centers = native.kmeans_1d(x, k, max_iter=100, seed=0)
    return labels, np.pad(centers, (0, n_clusters - k))


def ints_to_bits_to_bytes(all_ints, n_bits: int) -> Tuple[bytearray, bool]:
    """Big-endian fixed-width bit packing, most significant bit first.  A
    trailing partial byte holds the remaining bits right-aligned; returns
    (bytes, whether there was one)."""
    ints = np.asarray(all_ints, dtype=np.int64).reshape(-1)
    leftover = (len(ints) * n_bits) % 8 > 0
    if n_bits == 8:
        return bytearray(ints.astype(np.uint8).tobytes()), False
    shifts = np.arange(n_bits - 1, -1, -1, dtype=np.int64)
    bits = ((ints[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
    n_full = len(bits) // 8
    out = bytearray(np.packbits(bits[:8 * n_full]).tobytes())
    if leftover:
        tail = bits[8 * n_full:].astype(np.int64)
        out.append(int(tail @ (1 << np.arange(len(tail) - 1, -1, -1))))
    return out, leftover


def write_mask_bnr(mask_bits: np.ndarray, filename: str):
    """Bit-pack a 0/1 array -> .bnr (zero-padded to a whole byte)."""
    with open(filename, 'wb') as f:
        f.write(np.packbits(np.asarray(mask_bits).astype(np.uint8)).tobytes())


def store_model_parameters(model: FeatureGridModel, filename: str,
                           bit_precision: int = 8):
    """Write the model to the packed container ``filename`` and its
    ``filename + '_mask.bnr'`` (gates are not stored: a pruned model has
    them baked into its zeros)."""
    spec = model.spec
    n_clusters = 2 ** bit_precision

    def a(ts):
        return [t.detach().cpu().numpy().astype(np.float32) for t in ts]

    coeffs, weights, biases = a(model.coeffs), a(model.mlp_w), a(model.mlp_b)
    with open(filename, 'wb') as f:
        f.write(struct.pack('9B', spec.num_layers, spec.hidden, spec.mlp_in,
                            spec.d_in, spec.d_out, bit_precision, spec.grid_size,
                            len(coeffs), spec.grid_features))
        for c in coeffs:
            f.write(struct.pack('I', int(np.count_nonzero(c))))
        for c in coeffs:
            f.write(struct.pack('I', int(c.size - np.count_nonzero(c))))

        def write_raw(arr):
            f.write(np.asarray(arr, dtype='<f4').reshape(-1).tobytes())

        def write_quantized(arr):
            labels, centers = kmeans_quantization(arr, n_clusters)
            f.write(centers.astype('<f4').tobytes())
            packed, _ = ints_to_bits_to_bytes(labels, bit_precision)
            f.write(bytes(packed))
            if bit_precision % 8 != 0:
                # not byte aligned: the last label again, as a u32
                f.write(struct.pack('I', int(labels[-1]) if len(labels) else 0))

        # MLP ((out, in) layout): first raw, middle quantized, last raw
        write_raw(weights[0])
        write_raw(biases[0])
        for w, b in zip(weights[1:-1], biases[1:-1]):
            write_quantized(w)
            write_raw(b)
        write_raw(weights[-1])
        write_raw(biases[-1])

        # grids: mask bits, quantized nonzeros
        mask_bits = []
        for c in coeffs:
            flat = c.reshape(-1)
            mask_bits.append((flat != 0.0).astype(np.uint8))
            write_quantized(flat[flat != 0.0])
    write_mask_bnr(np.concatenate(mask_bits), filename + '_mask.bnr')


def read_mask_bnr(filename: str, num_bits: int) -> np.ndarray:
    """Read a .bnr -> 0/1 uint8 array of length num_bits."""
    n_bytes = (num_bits + 7) // 8
    with open(filename, 'rb') as f:
        raw = np.frombuffer(f.read(n_bytes), dtype=np.uint8)
    return np.unpackbits(raw)[:num_bits]


def unpack_bits(raw: bytes, n: int, n_bits: int) -> np.ndarray:
    """n big-endian labels of n_bits each, MSB first -> int64 array."""
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))[:n * n_bits]
    weights = np.left_shift(1, np.arange(n_bits - 1, -1, -1, dtype=np.int64))
    return bits.reshape(n, n_bits).astype(np.int64) @ weights


def restore_model(filename: str, wavelet: str = 'db2',
                  device: str | torch.device = 'cuda'
                  ) -> tuple[ModelSpec, FeatureGridModel]:
    """Rebuild (spec, model) from a packed container on ``device``.

    The architecture not in the header is fixed to the reference's defaults
    (2 Fourier frequencies, no gates); ``wavelet`` comes from the experiment
    config so haar/bior/none containers restore with the right shapes."""
    dev = resolve_device(device)
    with open(filename, 'rb') as f:
        def rd(fmt):
            return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]

        n_layers = rd('B')
        layer_width = rd('B')
        input_dim = rd('B')
        input_channel = rd('B')
        output_dim = rd('B')
        bit_precision = rd('B')
        n_clusters = 2 ** bit_precision
        grid_size = rd('B')
        n_grids = rd('B')
        feature_size = rd('B')
        nonzeros = [rd('I') for _ in range(n_grids)]
        zeros = [rd('I') for _ in range(n_grids)]

        def read_raw(n):
            return np.frombuffer(f.read(4 * n), dtype='<f4').copy()

        def read_quantized(n):
            centers = read_raw(n_clusters)
            raw = f.read((n * bit_precision + 7) // 8)
            idx = unpack_bits(raw, n, bit_precision)
            if bit_precision % 8 != 0:
                last = rd('I')
                if n:
                    idx[-1] = last
            return centers[idx]

        weights = [read_raw(input_dim * layer_width)]
        biases = [read_raw(layer_width)]
        for _ in range(n_layers - 1):
            weights.append(read_quantized(layer_width * layer_width))
            biases.append(read_raw(layer_width))
        weights.append(read_raw(output_dim * layer_width))
        biases.append(read_raw(output_dim))
        grid_values = [read_quantized(n) for n in nonzeros]

    mask = read_mask_bnr(filename + '_mask.bnr', sum(nonzeros) + sum(zeros))

    # re-insert the zeros positionally
    grids, ptr = [], 0
    for nz, z, vals in zip(nonzeros, zeros, grid_values):
        m = mask[ptr:ptr + nz + z].astype(bool)
        full = np.zeros(nz + z, dtype=np.float32)
        full[m] = vals[:int(m.sum())]
        grids.append(full)
        ptr += nz + z

    spec = make_spec(d_in=input_channel, hidden=layer_width, d_out=output_dim,
                     num_layers=n_layers, n_freqs=2, grid_features=feature_size,
                     grid_size=grid_size, wavelet=wavelet)
    shapes = coeff_shapes(spec)
    if len(shapes) != n_grids:
        raise ValueError(f"container holds {n_grids} grids; wavelet "
                         f"{wavelet!r} at grid {grid_size} needs {len(shapes)}")
    if spec.mlp_in != input_dim:
        raise ValueError(f"container MLP input {input_dim} != spec's {spec.mlp_in}")
    coeffs = [torch.from_numpy(g.reshape(s)) for g, s in zip(grids, shapes)]
    # the container's (out, in) layout is the port's own
    mlp_w = [torch.from_numpy(w.reshape(-1, d_in)) for w, d_in in zip(
        weights, [input_dim] + [layer_width] * n_layers)]
    mlp_b = [torch.from_numpy(b) for b in biases]
    return spec, FeatureGridModel(spec, coeffs, mlp_w, mlp_b).to(dev)
