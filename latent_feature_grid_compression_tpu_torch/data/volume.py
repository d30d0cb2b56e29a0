"""Volume loading and sampling geometry (port of the JAX package's
``data/volume.py``).

Loads ``.npy``, ``.h5`` and ``.cvol`` scalar volumes normalized to [-1, 1]
over their global min/max, and describes the sampling geometry
(:class:`VolumeMeta`: resolution, anisotropy scales, the index to
normalized-coordinate map, :func:`lattice_coords`).  Host-side numpy only:
the trainer draws its positions on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def normalize_volume(volume, min_v, max_v, min_n, max_n):
    """Map [min_v, max_v] -> [min_n, max_n]."""
    return (max_n - min_n) * ((volume - min_v) / (max_v - min_v)) + min_n


def load_volume(filepath: str) -> np.ndarray:
    """Load a ``.npy``, ``.h5`` (its first dataset, squeezed) or ``.cvol``
    volume as float32 normalized to [-1, 1].  ``.h5`` needs ``h5py``."""
    if filepath.endswith('.npy'):
        vol = np.load(filepath).astype(np.float32)
    elif filepath.endswith('.h5'):
        import h5py
        with h5py.File(filepath, 'r') as f:
            key = list(f.keys())[0]
            vol = np.squeeze(f[key][()]).astype(np.float32)
    elif filepath.endswith('.cvol'):
        from .cvol import read_cvol
        vol = read_cvol(filepath).astype(np.float32)
    else:
        raise ValueError(f"unsupported volume format: {filepath}")
    return normalize_volume(vol, vol.min(), vol.max(), -1.0, 1.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class VolumeMeta:
    """Sampling geometry of a volume."""

    resolution: tuple  # (X, Y, Z)

    @property
    def res(self) -> np.ndarray:
        return np.asarray(self.resolution, dtype=np.float32)

    @property
    def n_voxels(self) -> int:
        return int(np.prod(self.resolution))

    @property
    def min_idx(self) -> np.ndarray:
        return np.zeros(3, dtype=np.float32)

    @property
    def max_idx(self) -> np.ndarray:
        return self.res - 1.0

    @property
    def scales(self) -> np.ndarray:
        """Anisotropy scales: max_idx / max(max_idx)."""
        return self.max_idx / self.max_idx.max()

    def normalize_positions(self, raw: np.ndarray) -> np.ndarray:
        """(N, 3) integer lattice positions -> scaled [-1, 1] coordinates."""
        norm = normalize_volume(raw, self.min_idx[None], self.max_idx[None],
                                -1.0, 1.0)
        return self.scales[None] * norm


def lattice_coords(meta: VolumeMeta) -> np.ndarray:
    """All (X*Y*Z, 3) normalized and scaled lattice coordinates, row-major."""
    X, Y, Z = meta.resolution
    axes = [np.linspace(0.0, 1.0, n, dtype=np.float32) * 2.0 - 1.0
            for n in (X, Y, Z)]
    gx, gy, gz = np.meshgrid(*axes, indexing='ij')
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return pts * meta.scales[None]
