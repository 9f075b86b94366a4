"""Data and tensor parallelism over torch.distributed (port of
gbnerf_tpu/parallel/)."""
from .mesh import (average_grads, constrain_data, data_sharding, gather,
                   init_distributed, make_mesh, make_mesh_2d,
                   pad_to_multiple, replicate, shard_batch)

__all__ = [
    "average_grads", "constrain_data", "data_sharding", "gather",
    "init_distributed", "make_mesh", "make_mesh_2d", "pad_to_multiple",
    "replicate", "shard_batch",
]
