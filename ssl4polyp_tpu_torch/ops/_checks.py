"""Checks the kernel wrappers share."""

from __future__ import annotations

import torch


def check_gradient(name: str, grad: torch.Tensor, shape, dtype: torch.dtype,
                   device: torch.device) -> None:
    """Refuses an incoming gradient that a backward kernel cannot read.

    The backward kernels copy their incoming gradient in 16-byte ``cp.async``
    pieces from their own device, so it must have the expected shape and
    dtype, lie on ``device``, be contiguous and start 16-byte aligned.  A
    misaligned address would fault on the card and lose the CUDA context;
    this raises ``ValueError`` first, before anything is allocated.
    """
    if tuple(grad.shape) != tuple(shape) or grad.dtype != dtype:
        raise ValueError(f"{name} {tuple(grad.shape)} {grad.dtype} does not fit "
                         f"{tuple(shape)} {dtype}")
    if grad.device != device or not grad.is_contiguous() or grad.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {device}")
