"""What decides ``correct``: the numbers compared between what the timed path
produced and the plain reference (``model.py``), worked out again from the
same inputs.  Each number has a limit of its own (``limits/<cell>.json``).

* train: the first ``checked_steps`` steps of the window call's first chunk
  (the window's own chunk runner, buffers and graph).  Each checked step's
  loss, as a gap relative to the reference's
  (``loss_gap``); the first step's gradient as Adam got it, worked out from
  the first moment after one step (m = 0.1 g), and the parameters' change
  after the checked steps, each by the worst leaf: the gap between the two
  sides' norms of the leaf over the reference's norm of that leaf or of the
  median leaf, whichever is larger (``grad_gap``, ``update_gap``).  Leaves
  whose reference gradient is under a thousandth of the median leaf's are
  left out of the change (they move under Adam by round-off alone).
* decompress: the widest gap between a kept field and the reference's
  (``field_gap``).
* query: the widest gap between a kept request's outputs and the
  reference's at its points (``query_gap``).

``control`` puts the reference in the program's place computed in TF32 (the
precision below the configuration's float32 with TF32 off), ``half_batch``
takes each step's loss over half its batch: both must fail one number.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import model as R


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in full float32, or (the control) in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _norms(ts: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def leaf_gap(got: List[torch.Tensor], want: List[torch.Tensor],
             counted: Optional[List[bool]] = None) -> float:
    """max over leaves of |‖got‖ - ‖want‖| / max(‖want‖, median ‖want‖)."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w)
    keep = counted or [True] * len(w)
    return max(abs(a - b) / max(b, med) for a, b, k in zip(g, w, keep) if k)


def split(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    """A trainer's flat vector as leaves shaped and ordered like ``like``."""
    sizes = [t.numel() for t in like]
    if flat.numel() != sum(sizes):
        raise ValueError(f'the flat vector holds {flat.numel()} values; the leaves {sum(sizes)}')
    return [p.view(t.shape) for p, t in zip(torch.split(flat, sizes), like)]


def draws_like_trainer(cfg: dict, volume: torch.Tensor, seeds: Dict[str, int],
                       gate_shapes, rows: int) -> Callable:
    """Each checked step's positions and gate noise, drawn as the trainer
    draws the first chunk of ``rows`` steps: the voxel indices one
    ``randint`` an axis of (rows, N) from the positions' generator, the
    noise one ``randn`` a level of (rows, *gate shape) from the noise's;
    step t takes row t - 1."""
    dev = volume.device
    N = cfg['batch_size'] * cfg['sample_size']
    pos_gen = torch.Generator(device=dev).manual_seed(seeds['positions'])
    noise_gen = torch.Generator(device=dev).manual_seed(seeds['noise'])
    pos = torch.stack([torch.randint(0, int(r), (rows, N), generator=pos_gen, device=dev,
                                     dtype=torch.int32) for r in volume.shape], dim=-1)
    noise = None
    if cfg['drop_type'] == 'dynamic_variational':
        noise = [torch.randn((rows,) + tuple(s), generator=noise_gen, device=dev)
                 for s in gate_shapes]

    def draw(t):
        return pos[t - 1], None if noise is None else [a[t - 1] for a in noise]
    return draw


def train_reference(p0, cfg, volume, seeds, steps, rows, tf32=False, half_batch=False):
    """The reference's first ``steps`` steps of a chunk of ``rows``."""
    gate_shapes = [tuple(c.shape[1:]) for c in p0['coeffs']]
    with precision(tf32):
        return R.train_steps(p0, cfg, draws_like_trainer(cfg, volume, seeds, gate_shapes, rows),
                             volume, steps, half_batch=half_batch)


def train_numbers(side: Tuple[List[float], List[torch.Tensor], List[torch.Tensor]],
                  ref, p0_leaves: List[torch.Tensor]) -> Dict[str, float]:
    """``side`` and ``ref``: (each step's loss, the first gradient's
    leaves, the leaves after the checked steps)."""
    losses, grad, after = side
    r_losses, r_grad, r_after = ref
    gnorm = _norms(r_grad)
    med = statistics.median(gnorm)
    counted = [n >= 1e-3 * med for n in gnorm]
    return {
        'loss_gap': max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
        'grad_gap': leaf_gap(grad, r_grad),
        'update_gap': leaf_gap([a - b for a, b in zip(after, p0_leaves)],
                               [a - b for a, b in zip(r_after, p0_leaves)], counted)}


def program_train_side(evidence: dict, p0_leaves: List[torch.Tensor]):
    """The trainer's own readings: its losses, its first moment after step 1
    (m = (1 - 0.9) g, so g = m / 0.1) and its parameters after the checked
    steps, as leaves."""
    grad = [m.double() / float(torch.tensor(0.1, dtype=torch.float32))
            for m in split(evidence['m1'], p0_leaves)]
    return evidence['losses'], grad, split(evidence['flat'], p0_leaves)


def field_gap(fields: List[torch.Tensor], want: torch.Tensor) -> float:
    return max(float((f.reshape(want.shape) - want).abs().max()) for f in fields)


def reference_field(p, cfg, resolution, tf32=False) -> torch.Tensor:
    with precision(tf32), torch.no_grad():
        return R.field(p, tuple(resolution), cfg['grid_size'], cfg['n_embedding_freq'])


def reference_points(p, cfg, pts, tf32=False) -> torch.Tensor:
    with precision(tf32), torch.no_grad():
        return R.predict(p, pts, cfg['grid_size'], cfg['n_embedding_freq'])
