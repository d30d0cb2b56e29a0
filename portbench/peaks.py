"""The card's published peaks (NVIDIA's H100 SXM data sheet, dense, at its
700 W limit), by the name ``torch.cuda.get_device_name`` gives.  The port
computes in float32 outside the tensor cores (TF32 off), so its model's
share is taken against the float32 rate."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Peaks:
    bytes_s: float
    f32_flops: float
    bf16_flops: float


TABLE = {'NVIDIA H100 80GB HBM3': Peaks(bytes_s=3.35e12, f32_flops=67e12, bf16_flops=989e12)}


def for_device(kind: str) -> Optional[Peaks]:
    """The peaks of a card by its name, None for a card not in the table
    (a share of its peak is then not reported)."""
    return TABLE.get(kind)
