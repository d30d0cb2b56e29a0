"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py).  Inputs are made with numpy and handed to
both packages; JAX runs on the CPU."""

import numpy as np
import torch

from latent_feature_grid_compression_tpu_torch.convert import params_from_jax

# the JAX gate containers' fields (SmallifyParams, STParams,
# VariationalParams) and the smallify tracker's (SmallifyAux)
GATE_FIELDS = ('betas', 'mask_values', 'log_thetas', 'log_var')


def to_port(jax_params, spec, device='cpu', gate_aux=None):
    """A JAX ``ModelParams`` (and its smallify ``gate_aux``) carried across
    to the port's model."""
    def a(ts):
        return None if ts is None else [np.asarray(t) for t in ts]
    gates = {f: a(getattr(jax_params.gates, f, None)) for f in GATE_FIELDS}
    if gate_aux is not None:
        gates.update(ema=a(gate_aux.ema), ema_var=a(gate_aux.ema_var))
    return params_from_jax(a(jax_params.coeffs), a(jax_params.mlp_w),
                           a(jax_params.mlp_b), spec, device=device, **gates)


def jax_gate_uniform_stream(k_train_phase, steps_per_chunk, shapes, n_chunks=10000):
    """The straight-through twin of ``tests/torch_ab.py::jax_gate_noise_stream``:
    replays the JAX trainer's per-step gate draws u = uniform(keys[i],
    shapes[i]) (``gates.apply_gate``) through the same key chain (per chunk
    ``key, k_pos, k_gate = split(key, 3)``, ``gate_keys = split(k_gate,
    steps)``; per step ``keys = split(gate_keys[s], n_levels)``).  Yields a
    list of per-level arrays per step."""
    import jax
    key = k_train_phase
    for _ in range(n_chunks):
        key, _k_pos, k_gate = jax.random.split(key, 3)
        for skey in jax.random.split(k_gate, steps_per_chunk):
            keys = jax.random.split(skey, len(shapes))
            yield [torch.from_numpy(np.array(jax.random.uniform(k, tuple(sh))))
                   for k, sh in zip(keys, shapes)]


def jax_mesh_pos_stream(k_train_phase, steps_per_chunk, N, local_res, device_index,
                        n_chunks):
    """One device's positions under the JAX package's sharded chunk
    runners (``parallel/mesh.py::make_sharded_chunk_runner``,
    ``make_zero_sharded_chunk_runner``): per chunk ``key, k_pos, k_gate =
    split(key, 3)``, then ``fold_in(k_pos, device_index)`` (the device's
    row-major index on the ('data', 'space') mesh, the port's rank) and one
    (steps, N, 3) randint below ``local_res``, the device's slab
    (JAX ``train/trainer.py::_make_step_parts``' ``sample_chunk``).  Returns
    the ``n_chunks`` chunks' steps as one (n_chunks * steps, N, 3) int32
    array, local to the slab."""
    import jax
    import jax.numpy as jnp
    key = k_train_phase
    res = jnp.asarray(local_res, jnp.int32)
    chunks = []
    for _ in range(n_chunks):
        key, k_pos, _k_gate = jax.random.split(key, 3)
        k_pos = jax.random.fold_in(k_pos, device_index)
        chunks.append(np.asarray(jax.random.randint(k_pos, (steps_per_chunk, N, 3), 0,
                                                    res[None, None, :])))
    return np.concatenate(chunks).astype(np.int32)


def prune(jax_params, fraction, seed):
    """Zero about ``fraction`` of every coefficient tensor (a stand-in for a
    pruned model, so the container's mask path is exercised)."""
    rng = np.random.default_rng(seed)
    coeffs = tuple(np.where(rng.random(c.shape) < fraction, 0.0,
                            np.asarray(c)).astype(np.float32)
                   for c in jax_params.coeffs)
    return jax_params.replace(coeffs=coeffs)
