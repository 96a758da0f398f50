"""Data and proposal parallelism across processes (the JAX package's
`parallel/`)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, active, all_reduce_grads,
                   all_reduce_sum, any_rank, barrier, broadcast_module,
                   broadcast_tensors, data_group, data_index, data_size,
                   gather_proposal_axis, init_from_env, make_mesh_2d,
                   proposal_offsets, proposal_sharding, rank, rank_device,
                   shard_proposal_axis, shard_rows, sharding, shards,
                   shutdown, sum_if_sync, world)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "active", "all_reduce_grads",
           "all_reduce_sum", "any_rank", "barrier", "broadcast_module",
           "broadcast_tensors", "data_group", "data_index", "data_size",
           "gather_proposal_axis", "init_from_env", "make_mesh_2d",
           "proposal_offsets", "proposal_sharding", "rank", "rank_device",
           "shard_proposal_axis", "shard_rows", "sharding", "shards",
           "shutdown", "sum_if_sync", "world"]
