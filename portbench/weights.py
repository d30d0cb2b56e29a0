"""The model's starting tensors, made on the device from the seed in a few
large draws, as the reference trainer initialises them: the grid U(0, 1)
encoded into its db2 pyramid (``reference/model.py::encode``), the head and
the variance model at ``nn.Linear``'s default init, smallify's betas
N(0, 1), dynamic variational's log_theta 0 and log_var log(p / (1 - p)) at
p = drop_momentum.  ``pruned`` keeps about a third of each coefficient
tensor, standing in for a compressed model that is decompressed.  Both the
program and the reference are handed these tensors."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .counts.model import head_dims, variance_dims
from .reference.model import encode, level_shapes


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    sizes = [math.prod(s) for s in shapes]
    return [t.view(s).clone() for t, s in zip(torch.split(flat, sizes), shapes)]


def _linear_stack(gen, dims, device) -> Dict[str, List[torch.Tensor]]:
    """U[-1/sqrt(in), 1/sqrt(in)] for every weight (out, in) and bias."""
    shapes = [(b, a) for a, b in zip(dims[:-1], dims[1:])] + [(b,) for b in dims[1:]]
    bounds = [1.0 / math.sqrt(a) for a in dims[:-1]] * 2
    u = torch.rand(sum(math.prod(s) for s in shapes), generator=gen, device=device)
    ts = _split(u, shapes)
    ts = [t * (2.0 * bnd) - bnd for t, bnd in zip(ts, bounds)]
    n = len(dims) - 1
    return {'w': ts[:n], 'b': ts[n:]}


def make_params(cfg: dict, seed: int, device, pruned: bool = False) -> Dict[str, list]:
    gen = torch.Generator(device=device).manual_seed(seed)
    F_, G = cfg['grid_features'], cfg['grid_size']
    grid = torch.rand((F_, G, G, G), generator=gen, device=device)
    coeffs = encode(grid, len(level_shapes(G)))
    if pruned:
        keep = torch.rand(sum(c.numel() for c in coeffs), generator=gen, device=device)
        masks = _split((keep < 1.0 / 3.0).to(torch.float32), [c.shape for c in coeffs])
        coeffs = [c * m for c, m in zip(coeffs, masks)]
    head = _linear_stack(gen, head_dims(cfg), device)
    p = {'coeffs': [c.contiguous() for c in coeffs], 'mlp_w': head['w'], 'mlp_b': head['b']}
    gate_shapes = [tuple(c.shape[1:]) for c in coeffs]
    family = cfg['drop_type']
    if family == 'smallify':
        p['betas'] = _split(torch.randn(sum(math.prod(s) for s in gate_shapes),
                                        generator=gen, device=device), gate_shapes)
    elif family == 'dynamic_variational':
        p_drop = cfg['drop_momentum']
        p['log_thetas'] = [torch.zeros(s, device=device) for s in gate_shapes]
        p['log_var'] = [torch.full(s, math.log(p_drop / (1.0 - p_drop)), device=device)
                        for s in gate_shapes]
        var = _linear_stack(gen, variance_dims(cfg), device)
        p['var_w'], p['var_b'] = var['w'], var['b']
    return p


def clone(p: Dict[str, list]) -> Dict[str, list]:
    return {k: [t.detach().clone() for t in v] for k, v in p.items()}
