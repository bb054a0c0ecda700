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


def saved_or_scratch(out, lse, out_shape, lse_shape, device: torch.device):
    """The fp32 forward's output and each row's log-sum-exp that an fp32
    backward reads, checked as :func:`check_gradient` checks a gradient; or,
    without them (both None), fp32 scratch that the backward's launch fills
    by running the forward first.  Returns ``(out, lse, forward_first)``."""
    if (out is None) != (lse is None):
        raise ValueError("out and lse go together")
    if out is None:
        return (torch.empty(out_shape, dtype=torch.float32, device=device),
                torch.empty(lse_shape, dtype=torch.float32, device=device), True)
    check_gradient("out", out, out_shape, torch.float32, device)
    check_gradient("lse", lse, lse_shape, torch.float32, device)
    return out, lse, False


def check_one_dtype(tensors) -> None:
    """Refuses with ``TypeError`` operands that are not all bfloat16 or all
    float32: a kernel of each dtype takes them."""
    dtypes = [t.dtype for t in tensors]
    if dtypes[0] not in (torch.bfloat16, torch.float32) or any(d != dtypes[0] for d in dtypes):
        raise TypeError(f"the kernels take bfloat16 or float32 operands of one dtype, got "
                        f"{dtypes}")
