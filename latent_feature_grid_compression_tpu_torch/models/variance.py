"""The variance model of dynamic variational dropout (port of the JAX
package's ``models/variance.py``).

A ReLU MLP, 4 hidden layers of 32 and a linear head, mapping the normalized
coordinates (N, 3) to a per-sample log-sigma (N, 1).  It trains with the
model in phase 1 (its tensors join the trainer's flat vector).  Weights in
``nn.Linear``'s (out, in) layout, as ``ops/mlp.py`` keeps them; its products
are plain ``torch`` matmuls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..ops.mlp import init_mlp, mlp_apply


def init_variance_model(generator: torch.Generator, input_ch: int = 3,
                        output_ch: int = 1, n_layers: int = 4,
                        size_layers: int = 32
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(weights, biases), ``nn.Linear``'s default init drawn from
    ``generator`` on the CPU."""
    return init_mlp(generator, input_ch, size_layers, output_ch, n_layers)


def apply_variance_model(weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(weights, biases, x, activation=torch.relu)
