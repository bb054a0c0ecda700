"""The data-parallel layout and its collectives on ``torch.distributed``.

Counterpart of ``ssl4polyp_tpu/parallel/mesh.py``, with its names.  Where
the JAX package shards a global batch over a ``("data", "model")`` mesh and
lets XLA insert the gradient reduction into the ``pjit``-ed step, each rank
here holds its own rows of the global batch (the loaders' stripes), and the
engines call the collectives below themselves, as the reference's DDP does
(``train_classification.py:6017-6027``):

* :func:`build_mesh`: the ``(data, model)`` shape over the world, ``model``
  fixed at 1 (tensor parallelism is not ported);
* :func:`shard_batch`: this rank's rows of a global batch;
* :func:`replicate`: rank 0's tensors broadcast to every rank, in place;
* :func:`cross_replica_mean` / :func:`cross_replica_sum`: one all-reduce of
  the tensors flattened into one buffer, in place.

Without a process group every function is the identity on one rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from .multihost import is_distributed, process_count, process_index

__all__ = [
    "Mesh",
    "build_mesh",
    "cross_replica_mean",
    "cross_replica_sum",
    "replicate",
    "shard_batch",
]


@dataclass(frozen=True)
class Mesh:
    """The world as a ``(data, model)`` grid of ranks."""

    data: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def build_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the process group: ``data`` is the
    world size; any other ``data``, or a ``model`` degree but 1, raises."""
    world = process_count()
    if model != 1:
        raise ValueError(f"build_mesh(model={model}): only data parallelism is ported (model=1)")
    if data is not None and data != world:
        raise ValueError(f"build_mesh(data={data}) over a world of {world} ranks")
    return Mesh(data=world)


def shard_batch(batch: Mapping[str, np.ndarray | torch.Tensor],
                mesh: Optional[Mesh] = None) -> Dict[str, np.ndarray | torch.Tensor]:
    """This rank's contiguous rows of each array of a global batch; a batch
    that the data degree does not divide raises."""
    ranks = (mesh or build_mesh()).data
    rank = process_index()
    out = {}
    for key, value in batch.items():
        rows = len(value)
        if rows % ranks:
            raise ValueError(f"shard_batch: {key!r} has {rows} rows, not divisible over "
                             f"{ranks} ranks")
        per = rows // ranks
        out[key] = value[rank * per:(rank + 1) * per]
    return out


def _flat_collective(tensors: Iterable[torch.Tensor],
                     collective: Callable[[torch.Tensor], None]) -> None:
    """Run ``collective`` on one fp32 buffer holding every tensor, then copy
    the result back into each tensor in place."""
    tensors = list(tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"expected fp32 tensors, got {sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def replicate(tensors: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    """Broadcast rank 0's fp32 tensors to every rank, in place."""
    if is_distributed():
        _flat_collective(tensors.values(), lambda flat: dist.broadcast(flat, 0))
    return tensors


def cross_replica_sum(tensors: Iterable[torch.Tensor]) -> None:
    """All-reduce fp32 tensors by their sum over the ranks, in place."""
    if is_distributed():
        _flat_collective(tensors, dist.all_reduce)


def cross_replica_mean(tensors: Iterable[torch.Tensor]) -> None:
    """All-reduce fp32 tensors by their mean over the ranks (summed, then
    divided by the world size), in place."""
    if is_distributed():
        world = process_count()

        def mean(flat: torch.Tensor) -> None:
            dist.all_reduce(flat)
            flat.div_(world)

        _flat_collective(tensors, mean)
