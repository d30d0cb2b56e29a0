"""Multi-device training on ``torch.distributed`` (the port's counterpart of
the JAX package's ``parallel/``)."""

from .distributed import (host_local_batch, initialize_distributed, rank_device,
                          shutdown_distributed)
from .mesh import (Mesh, ShardCtx, ZeroCtx, all_gather_flat, all_reduce_mean, comm_volume_per_step,
                   make_mesh, make_shard_ctx, reduce_scatter_mean, shard_train_state,
                   shard_volume, solve_phase_sharded, unshard_train_state)
