"""Operations of the whole model, from a configuration's keys: a phase-1
training step, one voxel of the evaluation, one query point, and the decode
that a reconstruction or a query request does once."""

from __future__ import annotations

from . import adam, dwt, embedding, fetch, mlp

SNAKE_OPS, RELU_OPS = 4, 1
# a gate value's operations (dwt.gate_ops)
GATE_OPS = {'smallify': 1, 'dynamic_variational': 5, '': 0}


def head_dims(cfg: dict):
    d_in = cfg['d_in']
    mlp_in = d_in + 2 * cfg['n_embedding_freq'] * d_in + cfg['grid_features']
    return [mlp_in] + [cfg['n_hidden_size']] * cfg['n_layers'] + [cfg['d_out']]


def variance_dims(cfg: dict):
    return [cfg['d_in']] + [32] * 4 + [1]


def decode_ops(cfg: dict, gated: bool) -> int:
    ops = dwt.decode_ops(cfg['grid_features'], cfg['grid_size'])
    if gated and cfg['drop_type']:
        ops += dwt.gate_ops(cfg['grid_features'], cfg['grid_size'], GATE_OPS[cfg['drop_type']])
    return ops


def n_params(cfg: dict) -> int:
    """The trained parameters of phase 1: coefficients, the head, the
    gates, and the variance model of the dynamic family."""
    dims = head_dims(cfg)
    count = dwt.coefficient_count(cfg['grid_features'], cfg['grid_size'])
    gates = count // cfg['grid_features']
    total = count + sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    if cfg['drop_type'] == 'smallify':
        total += gates
    elif cfg['drop_type'] == 'dynamic_variational':
        v = variance_dims(cfg)
        total += 2 * gates + sum(a * b + b for a, b in zip(v[:-1], v[1:]))
    return total


def train_step_ops(cfg: dict) -> int:
    """One phase-1 step of batch_size x sample_size samples: the gated decode
    forward and its two backward contractions (3x), the fetch and the grid
    gradient, the embedding, the head (3x), the variance model (3x, dynamic
    variational), a loss term a sample, and Adam."""
    n = cfg['batch_size'] * cfg['sample_size']
    C = cfg['grid_features']
    ops = 3 * decode_ops(cfg, gated=True)
    ops += 2 * fetch.ops(n, C) + embedding.ops(n, cfg['n_embedding_freq'], cfg['d_in'])
    ops += mlp.train_ops(n, head_dims(cfg), SNAKE_OPS) + 3 * n
    if cfg['drop_type'] == 'dynamic_variational':
        ops += mlp.train_ops(n, variance_dims(cfg), RELU_OPS) + 8 * n
    return ops + adam.ops(n_params(cfg))


def point_ops(cfg: dict) -> int:
    """One decompressed point: the fetch, the embedding, the head and the
    clamp (the lattice's coordinates, ~10 a voxel, are counted by the
    evaluation's caller)."""
    return (fetch.ops(1, cfg['grid_features'])
            + embedding.ops(1, cfg['n_embedding_freq'], cfg['d_in'])
            + mlp.forward_ops(1, head_dims(cfg), SNAKE_OPS) + 1)


LATTICE_OPS = 10
