"""Data and model parallelism: one process per device, N processes
computing what one computes at the global batch (JAX's semantics on a
(data, model) mesh), a cost volume optionally split along D over the
model axis."""

from .collectives import (all_reduce_grads, broadcast_module,
                          collective_bytes, collective_counts, d_axis_counts,
                          gather_d, global_count, global_sum, halo_exchange,
                          reset_collective_counts, shard_d)
from .distributed import (add_distributed_args, init_distributed,
                          rank_device, resolve_launcher, shutdown_distributed)
from .mesh import (batch_only_volume_sharding, batch_sharding,
                   cost_volume_sharding, make_mesh, replicated, shard_batch)

__all__ = ["all_reduce_grads", "broadcast_module", "collective_bytes",
           "collective_counts", "d_axis_counts", "gather_d", "global_count",
           "global_sum", "halo_exchange", "reset_collective_counts",
           "shard_d", "add_distributed_args", "init_distributed",
           "rank_device", "resolve_launcher", "shutdown_distributed",
           "batch_only_volume_sharding", "batch_sharding",
           "cost_volume_sharding", "make_mesh", "replicated", "shard_batch"]
