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


# Where ROADMAP.md lists the fp32 kernels still to port: the fusion knobs'
# kernels (mlp_fused, mlp_ln_fused, ln_linear, fused_attention_proj), then
# the two public functions no model route calls (fused_qkvproj_attention,
# fused_attention).
FP32_FUSION_KNOBS = "ROADMAP.md §2a, item 1"
FP32_PUBLIC_FUNCTIONS = "ROADMAP.md §2a, item 2"


def check_bf16(name: str, dtype: torch.dtype, roadmap_item: str) -> None:
    """Refuses a tensor that a bfloat16-only kernel cannot take with
    ``TypeError``; for fp32, the message says that this kernel's fp32 version
    is not yet ported and names the ROADMAP.md item that lists it."""
    if dtype == torch.bfloat16:
        return
    if dtype == torch.float32:
        raise TypeError(f"{name} is float32, and this kernel's fp32 version is not yet ported "
                        f"({roadmap_item}): the kernel takes bfloat16")
    raise TypeError(f"the kernel takes bfloat16, got {name} {dtype}")
