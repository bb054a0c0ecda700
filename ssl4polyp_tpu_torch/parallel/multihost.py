"""Process-group initialisation and rank-0 gating on ``torch.distributed``.

Counterpart of ``ssl4polyp_tpu/parallel/multihost.py``, which initialises
``jax.distributed``; here the reference's own machinery returns
(``mae/util/misc.py:217-249``: an ``env://`` rendezvous, one process a GPU):

* a rank's coordinates come from the variables ``torchrun`` sets (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``); explicit arguments win over them;
* the backend is the argument, else ``SSL4POLYP_DIST_BACKEND``, else
  ``nccl`` where CUDA is available and ``gloo`` on the CPU.  NCCL needs a
  device of its own for each rank; ranks that share a device run under
  gloo, which reduces CUDA tensors through the host;
* :func:`is_primary` replaces the reference's rank-0 guards, and is True
  when no group is initialised, as the JAX fallback is.
"""

from __future__ import annotations

import atexit
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

__all__ = [
    "BACKEND_ENV",
    "any_rank",
    "barrier",
    "initialize_multihost",
    "is_distributed",
    "is_primary",
    "local_device",
    "process_count",
    "process_index",
    "process_info",
]

BACKEND_ENV = "SSL4POLYP_DIST_BACKEND"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group when running as several processes.

    Safe to call unconditionally: a second call does nothing, and so does a
    single process (no ``init_method`` and a world size of 1 or none).  An
    explicit ``init_method`` initialises a group even of one rank.  Under
    ``nccl`` every rank of this host needs a CUDA device of its own; more
    ranks than devices raise, naming gloo, instead of falling back.  The
    process leaves the group when its interpreter exits.
    """
    if is_distributed():
        return
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and world_size in (None, 1):
        return
    backend = backend or os.environ.get(BACKEND_ENV) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local_ranks = _env_int("LOCAL_WORLD_SIZE") or world_size or 1
        devices = torch.cuda.device_count()
        if local_ranks > devices:
            raise ValueError(
                f"nccl needs a CUDA device for each rank: {local_ranks} ranks on this host, "
                f"{devices} devices; ranks that share a device run under gloo "
                f"({BACKEND_ENV}=gloo or backend='gloo')")
        torch.cuda.set_device(local_device())
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    atexit.register(_leave_group)


def _leave_group() -> None:
    """Destroy the group, if it is still there, before the interpreter
    exits: a group left to the process's teardown can abort the process
    ("terminate called without an active exception") while gloo's threads
    still run."""
    if is_distributed():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """True once this process has joined a process group (even of one rank)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_primary() -> bool:
    """True on the process that owns artifact writes (the reference's
    rank-0 guards); True when no group is initialised."""
    return process_index() == 0


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    request without an index; the request itself otherwise, so the CPU only
    when the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % count) if count else device


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if is_distributed():
        dist.barrier()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any rank (a decision the
    ranks must take together, such as stopping on a signal)."""
    if not is_distributed():
        return bool(flag)
    where = (torch.device("cuda", torch.cuda.current_device())
             if dist.get_backend() == "nccl" else torch.device("cpu"))
    value = torch.tensor([int(bool(flag))], dtype=torch.int32, device=where)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return bool(value.item())


def process_info() -> Dict[str, Any]:
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_rank": _env_int("LOCAL_RANK") or 0,
        "backend": dist.get_backend() if is_distributed() else None,
        "local_devices": torch.cuda.device_count(),
    }
