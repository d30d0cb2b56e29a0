"""Multi-device training on ``torch.distributed``: the ('data', 'space')
mesh, its collectives, and the placement of the volume and of the state
(the port's counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package runs one program over all devices under ``shard_map``; the
port runs one process per device (``torchrun``) with the same step on every
rank and explicit collectives where JAX reduces over a mesh axis:

* 'data':  pure data parallelism over the sampled positions.
* 'space': the ground-truth volume is cut into x-slabs; each rank samples
  inside its own (stratified sampling: the same marginal distribution as
  global IID sampling when the slabs are equal).
* State: replicated (one all-reduce of the gradient a step), or with
  ``shard_params`` ZeRO-sharded over 'space' (:func:`shard_train_state`:
  the flat trainables and both Adam moments cut into 1/space slices; the
  step all-gathers the parameters and reduce-scatters the gradient).

Ranks sit in the mesh row-major, as JAX's ``reshape(data, space)``: rank
``d * space + s``.  Every rank creates every process group, in the same
order.

The collectives are plain functions on tensors, each one call of
``torch.distributed`` on the tensors as they are: NCCL on the card, gloo on
the CPU, and gloo on the card where ranks share one (NCCL refuses two ranks
on one card: "Duplicate GPU detected").  Gloo of torch 2.11 runs all four
(``all_reduce``, ``broadcast``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``) on CUDA tensors and gives the exact results
(checked on an H100 by ``chip_smoke.py``'s mesh phase and
``tests/test_torch_cuda.py``), so no collective is staged through the host.
Every collective counts its calls and the bytes that the ring model of
:func:`comm_volume_per_step` gives its tensor (``counts``): a check that the
step makes the calls the model assumes, at the sizes it assumes, not a
measurement of what the backend moves.

Under NCCL, where every rank has a card of its own, the trainer's chunk
runner captures each rank's step with its collectives as one CUDA graph a
phase (``train/trainer.py::ChunkRunner``, by default, as the JAX mesh's
sharded chunk runners compile a chunk; ``solve_phase(graphs=False)``
steps eagerly): the step's all-reduce of
[gradient | scalars], and under ZeRO its all-gather of the parameters, its
reduce-scatter of the gradient and its all-reduce over 'data', become
nodes of the graph and run at every replay.  A count is taken where the
Python call is made, so a replay counts nothing by itself: the runner
records what the capture counted and adds it at each replay, with the
kernels' launches (``ops/launch_counts.py``).  Everything around the
steps stays eager on the same communicators, in the same order on every
rank: the broadcast of the save and histogram flags after a chunk, the
gathers of a save, ``unshard_train_state``, ``gather_objects``, the
barrier and rank 0's evaluation.  Gloo's collectives cannot be captured,
so a gloo mesh (and ranks that share a card run only under gloo) steps
eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..device import resolve_device

AXES = ('data', 'space')

# collective calls, and the bytes the ring model of comm_volume_per_step
# gives the tensors they were called on, since the last reset_counts()
counts: Dict[str, float] = {}


def reset_counts():
    counts.clear()
    counts.update({'all_reduce': 0, 'reduce_scatter': 0, 'all_gather': 0,
                   'broadcast': 0, 'modelled_bytes': 0.0})


reset_counts()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, space) grid of ranks and the process
    groups of its axes (None where the axis has size 1, or for the whole
    world: the default group)."""
    data: int
    space: int
    rank: int
    device: torch.device
    backend: str
    space_group: Optional[object] = None   # this rank's 'space' row
    data_group: Optional[object] = None    # this rank's 'data' column

    @property
    def shape(self) -> Dict[str, int]:
        return {'data': self.data, 'space': self.space}

    @property
    def size(self) -> int:
        return self.data * self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (both: the default group)."""
        axes = tuple(a for a in AXES if a in axes)
        if axes == AXES:
            return None
        return self.space_group if axes == ('space',) else self.data_group


def make_mesh(data: int, space: int,
              device: Optional[str | torch.device] = None) -> Mesh:
    """The (data, space) mesh over the default process group, which must be
    running (``distributed.initialize_distributed``), on ``device``: None
    is the current card, whatever the backend (it raises without one; the
    CPU only when the caller passes 'cpu').  Raises unless data * space is
    the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running process group "
                           "(parallel.distributed.initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * space != world:
        raise ValueError(f"a {data} x {space} mesh needs {data * space} ranks; the "
                         f"process group has {world}")
    device = resolve_device('cuda' if device is None else device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    grid = np.arange(world).reshape(data, space)
    space_group = data_group = None
    # every rank creates every group, in the same order
    if space > 1 and data > 1:
        for d in range(data):
            g = dist.new_group(grid[d].tolist())
            if d == rank // space:
                space_group = g
        for s in range(space):
            g = dist.new_group(grid[:, s].tolist())
            if s == rank % space:
                data_group = g
    return Mesh(data=data, space=space, rank=rank, device=device,
                backend=dist.get_backend(), space_group=space_group,
                data_group=data_group)


def _count(op: str, nbytes: float, n: int):
    counts[op] += 1
    counts['modelled_bytes'] += nbytes * (n - 1) / n


def all_reduce_mean(mesh: Mesh, t: torch.Tensor, axes: Sequence[str] = AXES
                    ) -> torch.Tensor:
    """JAX's ``pmean`` over ``axes``: the mean over those ranks (in place)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    with record_function('mesh::all_reduce'):
        dist.all_reduce(t, group=mesh.group(axes))
        _count('all_reduce', 2.0 * t.numel() * t.element_size(), n)
        return t.div_(n)


def reduce_scatter_mean(mesh: Mesh, flat: torch.Tensor, axis: str = 'space'
                        ) -> torch.Tensor:
    """JAX's ``psum_scatter(tiled=True) / axis_size``: ``flat`` (a length
    divisible by the axis) summed over the axis, this rank's slice of it,
    divided by the axis size."""
    n = mesh.shape[axis]
    if n == 1:
        return flat
    out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
    with record_function('mesh::reduce_scatter'):
        dist.reduce_scatter_tensor(out, flat, group=mesh.group((axis,)))
        _count('reduce_scatter', flat.numel() * flat.element_size(), n)
        return out.div_(n)


def all_gather_flat(mesh: Mesh, shard: torch.Tensor, axis: str = 'space'
                    ) -> torch.Tensor:
    """JAX's ``all_gather(tiled=True)``: the axis' shards concatenated in
    rank order."""
    n = mesh.shape[axis]
    if n == 1:
        return shard
    out = torch.empty(shard.numel() * n, dtype=shard.dtype, device=shard.device)
    with record_function('mesh::all_gather'):
        dist.all_gather_into_tensor(out, shard.contiguous(), group=mesh.group((axis,)))
        _count('all_gather', out.numel() * out.element_size(), n)
    return out


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (in place)."""
    if mesh.size == 1:
        return t
    with record_function('mesh::broadcast'):
        dist.broadcast(t, src)
        _count('broadcast', t.numel() * t.element_size(), mesh.size)
    return t


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Optional[Mesh]):
    if mesh is not None and mesh.size > 1:
        if mesh.backend == 'nccl':
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def slab_bounds(mesh: Mesh, n_x: int, use_space: bool = True) -> Tuple[int, int]:
    """[start, stop) of this rank's x-slab of a volume of ``n_x`` slices
    (the whole axis without a space axis)."""
    if not (use_space and mesh.space > 1):
        return 0, n_x
    if n_x % mesh.space:
        raise ValueError(f"volume X {n_x} does not divide the space axis {mesh.space}")
    lx = n_x // mesh.space
    return mesh.space_index * lx, (mesh.space_index + 1) * lx


def shard_volume(mesh: Mesh, volume, use_space: bool = True) -> torch.Tensor:
    """This rank's x-slab ``volume[s*lx:(s+1)*lx]`` (float32, on the mesh's
    device) under a space axis, else the whole volume; ``volume`` is a
    host array or tensor, of which only the slab is copied."""
    lo, hi = slab_bounds(mesh, int(volume.shape[0]), use_space)
    slab = volume[lo:hi]
    if not torch.is_tensor(slab):
        slab = torch.from_numpy(np.ascontiguousarray(slab, dtype=np.float32))
    return slab.to(device=mesh.device, dtype=torch.float32).contiguous()


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh a step runs on, and whether the volume's x slices are cut
    over its 'space' axis (each rank then samples only inside its slab).
    The JAX package's fields are derived from the two."""
    mesh: Mesh
    use_space: bool = True

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The axes the batch is split over."""
        return AXES

    @property
    def space_axis(self) -> Optional[str]:
        """'space' where the volume is cut over it, else None."""
        return 'space' if (self.use_space and self.mesh.space > 1) else None

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def space_size(self) -> int:
        """The slabs the volume is cut into (1 without a space axis)."""
        return self.mesh.space if self.space_axis else 1


@dataclasses.dataclass(frozen=True)
class ZeroCtx:
    """Model-state sharding (ZeRO over the mesh axis ``axis``): the state's
    ``flat``, ``m`` and ``v`` are this rank's 1/axis slices of the vectors
    zero-padded to a multiple of the axis size; ``layout`` (the trainer's
    ``FlatLayout``) and ``n_params`` (the unpadded length) describe the
    whole vector.  The step all-gathers the parameters once (the decode
    couples every coefficient to its neighbours), reduce-scatters the
    gradient, and Adam updates the local slice; the padding's gradient and
    moments stay 0."""
    axis: str
    layout: object
    n_params: int


def make_shard_ctx(mesh: Mesh, use_space: bool = True) -> ShardCtx:
    return ShardCtx(mesh, use_space)


# ---------------------------------------------------------------------------
# ZeRO-style sharding of the model state over 'space'
# ---------------------------------------------------------------------------

def _slice(mesh: Mesh, vec: torch.Tensor, axis: str, padded: int) -> torch.Tensor:
    n = mesh.shape[axis]
    size = padded // n
    i = mesh.space_index if axis == 'space' else mesh.data_index
    out = torch.zeros(size, dtype=vec.dtype, device=vec.device)
    part = vec[i * size:(i + 1) * size]
    out[:part.numel()] = part
    return out


def shard_train_state(mesh: Mesh, state, axis: str = 'space'):
    """(the state with ``flat``, ``m`` and ``v`` zero-padded to a multiple
    of the axis size and cut to this rank's 1/axis slice, a ``ZeroCtx``).
    Every other field stays replicated; the padding's gradients and moments
    stay exactly 0."""
    n = state.flat.numel()
    padded = -(-n // mesh.shape[axis]) * mesh.shape[axis]
    zstate = dataclasses.replace(state, **{name: _slice(mesh, getattr(state, name),
                                                        axis, padded)
                                           for name in ('flat', 'm', 'v')})
    return zstate, ZeroCtx(axis=axis, layout=state.layout, n_params=n)


def unshard_train_state(mesh: Mesh, zstate, zc):
    """Inverse of :func:`shard_train_state`: a collective (every rank of the
    axis calls it) that gives every rank the replicated state."""
    return dataclasses.replace(zstate, **{
        name: all_gather_flat(mesh, getattr(zstate, name), zc.axis)[:zc.n_params]
        for name in ('flat', 'm', 'v')})


def comm_volume_per_step(n_params: int, data: int, space: int,
                         shard_params: bool = False, bytes_per_el: int = 4) -> dict:
    """Bytes a device sends a step under the ring model: an all-reduce of B
    bytes over n devices moves 2B(n-1)/n, an all-gather or a reduce-scatter
    B(n-1)/n.  Replicated state: one all-reduce of the gradient over every
    device.  ZeRO: the parameters' all-gather and the gradient's
    reduce-scatter over 'space', then the all-reduce over 'data' of the
    1/space shard (the trainer's order: equal to the replicated volume at
    data 1, below it otherwise).  The same numbers as the JAX package's."""
    n = data * space
    P = n_params * bytes_per_el
    if not shard_params:
        per_dev = 2.0 * P * (n - 1) / n if n > 1 else 0.0
        return {'allreduce_grad': per_dev, 'total_per_device': per_dev}
    ag = P * (space - 1) / space if space > 1 else 0.0
    rs = P * (space - 1) / space if space > 1 else 0.0
    ar_data = (2.0 * (P / space) * (data - 1) / data) if data > 1 else 0.0
    return {'allgather_params': ag, 'reduce_scatter_grad': rs,
            'allreduce_local_grad_data': ar_data, 'total_per_device': ag + rs + ar_data}


def solve_phase_sharded(mesh: Mesh, ph, state, volume: torch.Tensor,
                        steps_per_chunk: int, masks=None, use_space: bool = True,
                        shard_params: bool = False, local_decode: bool = False, **kw):
    """``trainer.solve_phase`` on the mesh (a thin delegate, as in JAX)."""
    from ..train.trainer import solve_phase   # the trainer imports this module
    return solve_phase(ph, state, volume, steps_per_chunk, masks, mesh=mesh,
                       use_space=use_space, shard_params=shard_params,
                       local_decode=local_decode, **kw)
