"""Process-group start-up and the rank's device (the port's counterpart of
the JAX package's ``parallel/distributed.py``).

One process per device, as ``torchrun`` (``python -m torch.distributed.run``)
launches them.  :func:`initialize_distributed` reads the launcher's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), or the JAX package's names (``JAX_COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``), so one launcher serves both packages.
Nothing falls back: a rank without a card raises, and so does a host with
more ranks than cards unless the caller asked for the ``gloo`` backend by
name, the only case in which ranks share a card (and the run says so).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def default_backend(device: str | torch.device) -> str:
    """'nccl' on the card, 'gloo' on the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def initialize_distributed(backend: Optional[str] = None,
                           device: str | torch.device = 'cuda') -> bool:
    """Start the default process group when the environment names more
    than one process; return whether one is running.  An existing group is
    kept.  ``backend`` None takes :func:`default_backend` of ``device``.
    The rendezvous is ``env://`` (``MASTER_ADDR``/``MASTER_PORT``), else
    ``tcp://JAX_COORDINATOR_ADDRESS``."""
    if dist.is_initialized():
        return True
    world_size = _env_int('WORLD_SIZE', 'NUM_PROCESSES')
    rank = _env_int('RANK', 'PROCESS_ID')
    if world_size in (None, 1):
        return False
    if rank is None:
        raise ValueError(f"a world of {world_size} processes needs RANK (or PROCESS_ID)")
    if 'MASTER_ADDR' in os.environ:
        init_method = 'env://'
    elif 'JAX_COORDINATOR_ADDRESS' in os.environ:
        init_method = 'tcp://' + os.environ['JAX_COORDINATOR_ADDRESS']
    else:
        raise ValueError("a multi-process run needs MASTER_ADDR and MASTER_PORT "
                         "(or JAX_COORDINATOR_ADDRESS)")
    backend = backend or default_backend(device)
    kw = {}
    local_rank = _env_int('LOCAL_RANK') or 0
    if backend == 'nccl' and local_rank < torch.cuda.device_count():
        # Every rank's training step is captured with its collectives as
        # one CUDA graph (train/trainer.py::ChunkRunner), and a capture can
        # record NCCL work only on a communicator that already exists.  The
        # process group bound to the rank's card makes the default group's
        # communicator here, and each later group's when the group is made,
        # not at a first collective (the capture's warm-up issues every
        # collective of the step besides).  Bound so, torch 2.11 on an H100
        # machine captured all_reduce, all_gather_into_tensor and
        # reduce_scatter_tensor in the 'thread_local' capture mode and
        # replayed them bit for bit between eager collectives; what it
        # needed at the end is that no graph be left (shutdown_distributed)
        kw['device_id'] = torch.device('cuda', local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return True


def shutdown_distributed():
    """Destroy the default process group, if one is running, once no CUDA
    graph holds NCCL work on it.  NCCL ends a communicator only when no
    graph holds work on it: on an H100 machine (torch 2.11, NCCL 2.28.9)
    both the destroy and an abort waited without end while a step's graph
    was alive, and returned at once after it was released.  The chunk
    runner destroys its graph when a phase ends or raises
    (``ChunkRunner.close``); here every step graph still alive, whoever
    holds it, is destroyed first (``trainer.release_step_graphs``): no
    graph can run NCCL work once the group is gone."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == 'nccl':
        from ..train.trainer import release_step_graphs   # the trainer imports this package
        release_step_graphs()
        torch.cuda.synchronize()
    dist.destroy_process_group()


def rank_device(device: str | torch.device = 'cuda', backend: Optional[str] = None,
                verbose: bool = True) -> torch.device:
    """This rank's device: the CPU when ``device`` is the CPU, else
    ``cuda:LOCAL_RANK``.  A host with more ranks than cards raises unless
    ``backend`` is 'gloo', asked for by name: then ranks share the cards
    (rank ``LOCAL_RANK`` on card ``LOCAL_RANK % cards``) and this is
    printed."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return dev
    local_rank = _env_int('LOCAL_RANK') or 0
    local_world = _env_int('LOCAL_WORLD_SIZE') or local_rank + 1
    cards = torch.cuda.device_count()
    if max(local_world, local_rank + 1) > cards:
        if backend != 'gloo':
            raise RuntimeError(
                f"{local_world} ranks on this host but {cards} card(s); ranks may share "
                f"a card only under the gloo backend, asked for by name "
                f"(--dist_backend gloo)")
        if verbose:
            print(f"rank {local_rank}: {local_world} ranks share {cards} card(s) "
                  f"under gloo", flush=True)
    dev = torch.device('cuda', local_rank % cards)
    torch.cuda.set_device(dev)
    return dev


def host_local_batch(global_batch: int) -> int:
    """This process's share of the global batch (it must divide evenly)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert global_batch % n == 0, (global_batch, n)
    return global_batch // n
