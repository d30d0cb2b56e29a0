"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py).  Inputs are made with numpy and handed to
both packages; JAX runs on the CPU."""

import numpy as np

from latent_feature_grid_compression_tpu_torch.convert import params_from_jax


def to_port(jax_params, spec, device='cpu', gate_aux=None):
    """A JAX ``ModelParams`` (and its smallify ``gate_aux``) carried across
    to the port's model."""
    def a(ts):
        return None if ts is None else [np.asarray(t) for t in ts]
    gates = jax_params.gates
    return params_from_jax(a(jax_params.coeffs), a(jax_params.mlp_w),
                           a(jax_params.mlp_b), spec, device=device,
                           betas=None if gates is None else a(gates.betas),
                           ema=None if gate_aux is None else a(gate_aux.ema),
                           ema_var=None if gate_aux is None else a(gate_aux.ema_var))


def prune(jax_params, fraction, seed):
    """Zero about ``fraction`` of every coefficient tensor (a stand-in for a
    pruned model, so the container's mask path is exercised)."""
    rng = np.random.default_rng(seed)
    coeffs = tuple(np.where(rng.random(c.shape) < fraction, 0.0,
                            np.asarray(c)).astype(np.float32)
                   for c in jax_params.coeffs)
    return jax_params.replace(coeffs=coeffs)
