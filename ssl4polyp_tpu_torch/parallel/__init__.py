"""Data parallelism on ``torch.distributed``: the mesh, its collectives and
the process group (counterpart of ``ssl4polyp_tpu/parallel``)."""

from .mesh import Mesh, build_mesh, cross_replica_mean, cross_replica_sum, replicate, shard_batch
from .multihost import (
    any_rank,
    barrier,
    initialize_multihost,
    is_distributed,
    is_primary,
    local_device,
    process_count,
    process_index,
    process_info,
)

__all__ = [
    "Mesh",
    "any_rank",
    "barrier",
    "build_mesh",
    "cross_replica_mean",
    "cross_replica_sum",
    "initialize_multihost",
    "is_distributed",
    "is_primary",
    "local_device",
    "process_count",
    "process_index",
    "process_info",
    "replicate",
    "shard_batch",
]
