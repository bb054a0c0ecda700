"""The MLP's first linear with its exact-erf GELU (forward only).

Counterpart of ``ssl4polyp_tpu/ops/mlp.py::fc1_gelu``; the CUDA kernel is
``csrc/mlp.cu``.  Weights are in torch's (out, in) layout.

A tensor on the CPU goes through :func:`fc1_gelu_reference`, the plain torch
version; a CUDA tensor goes through the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fc1_gelu", "fc1_gelu_reference", "launches"]

# Kernel launches since the last ops.reset_launch_counts().
launches = 0


def fc1_gelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w.T + b)`` with the exact erf, in plain torch."""
    return F.gelu(torch.matmul(x, w.t()) + b, approximate="none")


def _check(x, w, b) -> None:
    tensors = (x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fc1_gelu is forward-only on CUDA; run it under torch.no_grad() "
            "or torch.inference_mode()"
        )
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(
            f"fc1_gelu takes x (M, K), w (NF, K), b (NF,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}"
        )
    (m, k), (nf, k_w) = x.shape, w.shape
    if k_w != k or b.shape[0] != nf:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if k % 8 or nf % 8 or m < 1:
        raise ValueError(f"the kernel takes K and NF that are multiples of 8, got {k}, {nf}")
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fc1_gelu's operands must be contiguous and 16-byte aligned")


def fc1_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(x . w^T + b)`` for 2-D ``x``: fp32 accumulation, bias and GELU in
    fp32, one rounding to the compute dtype."""
    if x.device.type == "cpu":
        return fc1_gelu_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w, b)
    from ._build import library

    global launches
    m, k = x.shape
    nf = w.shape[0]
    y = torch.empty((m, nf), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().ssl4polyp_fc1_gelu_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, nf, stream
        )
    if err:
        raise RuntimeError(f"fc1_gelu kernel launch failed: CUDA error {err}")
    launches += 1
    return y
