"""Mid-training checkpoints of a phase's full ``TrainState`` (the port's
counterpart of the JAX package's ``io/train_state_io.py``).

One npz file holds every tensor and scalar of the state (the flat
trainables, Adam's moments, the step, the lr strategy's state, the stop
flag and its step, the KL weight, the smallify tracker), a signature of its
flat layout (``layout_names``, ``layout_shapes``) and the states of the
phase's generators (``generator_0`` the positions', ``generator_1`` the
gate noise's; ``torch.Generator.get_state``), so that a resumed run draws
the positions and noise the uninterrupted run would have drawn.  A run on
a (data, space) mesh saves the replicated state, every rank's position
generator (``generator_0``, one row a rank) and ``mesh_shape``; it resumes
only on a mesh of the same shape.  Keys are
the fields' names; a file of the JAX package (``leaf_0``, ...) is refused
(``convert.train_state_from_jax`` carries a JAX state across).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# the TrainState fields held as tensors (ema and ema_var may be None)
TENSOR_FIELDS = ('flat', 'm', 'v', 'lr', 'shadow_lr', 'last_loss', 'no_gain', 'stop',
                 'stop_step', 'weight_dkl', 'ema', 'ema_var')


def _signature(layout):
    return list(layout.names), json.dumps([list(s) for s in layout.shapes])


def save_train_state(path: str, state, generators: Sequence[Optional[torch.Generator]] = (),
                     mesh_shape: Optional[Tuple[int, int]] = None,
                     rank_states: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """Write ``state`` and the states of ``generators`` (None entries are
    skipped) to the npz file ``path``.  On a mesh: ``mesh_shape`` (data,
    space) and ``rank_states``, every rank's position-generator state in
    rank order, saved as ``generator_0`` in place of ``generators[0]``'s."""
    names, shapes = _signature(state.layout)
    out = {'step': np.asarray(state.step, np.int64), 'layout_names': np.asarray(names),
           'layout_shapes': np.asarray(shapes)}
    if mesh_shape is not None:
        out['mesh_shape'] = np.asarray(mesh_shape, np.int64)
    for name in TENSOR_FIELDS:
        t = getattr(state, name)
        if t is not None:
            out[name] = t.detach().cpu().numpy()
    for i, g in enumerate(generators):
        if g is not None:
            out[f'generator_{i}'] = g.get_state().numpy()
    if rank_states is not None:
        out.pop('generator_0', None)
        if rank_states[0] is not None:
            out['generator_0'] = np.stack([r.numpy() for r in rank_states])
    np.savez(path, **out)


def atomic_save_train_state(path: str, state,
                            generators: Sequence[Optional[torch.Generator]] = (), **mesh):
    """``save_train_state`` (``mesh``: its mesh_shape and rank_states) to
    ``path + '.tmp.npz'``, then renamed over ``path``: a run killed while
    saving leaves the previous file whole."""
    tmp = path + '.tmp.npz'
    save_train_state(tmp, state, generators, **mesh)
    os.replace(tmp, path)


def load_train_state(path: str, template,
                     generators: Sequence[Optional[torch.Generator]] = (),
                     mesh_shape: Optional[Tuple[int, int]] = None, rank: int = 0):
    """The state saved in ``path``, on the device and in the dtypes of
    ``template`` (a state of the same phase and config); sets each of
    ``generators`` (None entries skipped) to its saved state (on a mesh of
    ``mesh_shape``, generator 0 to rank ``rank``'s).  Raises ValueError
    when the file is the JAX package's, when it was saved on another mesh
    shape (a single device has none), or when its layout or a tensor's
    shape differs from the template's."""
    with np.load(path, allow_pickle=False) as z:
        if 'leaf_0' in z.files or 'leaf_0__key' in z.files:
            raise ValueError(f"{path} is a train state of the JAX package; carry it "
                             f"across with convert.train_state_from_jax")
        saved = tuple(z['mesh_shape'].tolist()) if 'mesh_shape' in z.files else None
        if saved != (None if mesh_shape is None else tuple(mesh_shape)):
            raise ValueError(f"{path} was saved on the mesh (data, space) = {saved}; "
                             f"this run's is {mesh_shape} (None: one device)")
        names, shapes = _signature(template.layout)
        got = (z['layout_names'].tolist(), str(z['layout_shapes']))
        if got != (names, shapes):
            raise ValueError(f"{path} holds the layout {got}, the template {(names, shapes)}")
        fields = {'step': int(z['step'])}
        for name in TENSOR_FIELDS:
            t = getattr(template, name)
            if (t is None) != (name not in z.files):
                raise ValueError(f"{path}: {name} is {'missing' if t is not None else 'extra'}")
            if t is None:
                continue
            a = z[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{path}: {name} has shape {a.shape}, the template "
                                 f"{tuple(t.shape)}")
            fields[name] = torch.from_numpy(a).to(device=t.device, dtype=t.dtype)
        for i, g in enumerate(generators):
            if g is None:
                continue
            if f'generator_{i}' not in z.files:
                raise ValueError(f"{path} holds no state of generator {i}")
            a = z[f'generator_{i}']
            g.set_state(torch.from_numpy(a[rank] if i == 0 and saved else a))
    return dataclasses.replace(template, **fields)
