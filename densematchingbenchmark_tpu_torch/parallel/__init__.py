"""Data parallelism: one process per device, N processes computing what one
computes at the global batch (JAX's semantics on a data mesh)."""

from .collectives import (all_reduce_grads, broadcast_module,
                          collective_counts, global_count, global_sum,
                          reset_collective_counts)
from .distributed import (add_distributed_args, init_distributed,
                          rank_device, resolve_launcher, shutdown_distributed)

__all__ = ["all_reduce_grads", "broadcast_module", "collective_counts",
           "global_count", "global_sum", "reset_collective_counts",
           "add_distributed_args", "init_distributed", "rank_device",
           "resolve_launcher", "shutdown_distributed"]
