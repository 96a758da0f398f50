"""Data parallelism across processes (the JAX package's `parallel/`)."""

from .mesh import (active, all_reduce_grads, all_reduce_sum, any_rank,
                   barrier, broadcast_module, broadcast_tensors,
                   init_from_env, rank, rank_device,
                   shard_rows, shutdown, sum_if_sync, world)

__all__ = ["active", "all_reduce_grads", "all_reduce_sum", "any_rank",
           "barrier", "broadcast_module", "broadcast_tensors",
           "init_from_env", "rank", "rank_device",
           "shard_rows", "shutdown", "sum_if_sync", "world"]
