"""Attention straight from the fused QKV projection (forward only).

Counterpart of ``ssl4polyp_tpu/ops/qkv_attention.py``: one CUDA kernel
(``csrc/qkv_attention.cu``) covers both ``fused_qkv_attention`` and, through
its ``bias`` argument, the forward of ``fused_qkv_bias_attention``.

A tensor on the CPU goes through :func:`fused_qkv_attention_reference`, the
plain torch version; a CUDA tensor goes through the kernel, or the wrapper
raises.  The backward kernel comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "fused_qkv_attention",
    "fused_qkv_attention_reference",
    "launches",
]

# Kernel launches since the last ops.reset_launch_counts().
launches = 0

_HEAD_DIMS = (16, 32, 64)
_MAX_TOKENS = 256


def _scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(hd) as the compute dtype holds it (the TPU kernel's fold)."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=dtype))


def fused_qkv_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    softmax_f32: bool = True,
    valid_len: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of the kernel, same roundings, no SDPA.

    ``qkv`` (B, N, 3D) is laid out ``[q heads | k heads | v heads]``;
    ``bias`` (3D,) is added in the compute dtype.  The 1/sqrt(hd) scale folds
    into q in the compute dtype; scores and softmax are fp32, the scores
    rounded to the compute dtype first when ``softmax_f32`` is False; keys at
    or past ``valid_len`` are masked; the weights are rounded to the compute
    dtype before the product with v.  Returns (B, N, D).
    """
    dtype = qkv.dtype
    if bias is not None:
        qkv = qkv + bias
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(_scale(head_dim, dtype), dtype=dtype, device=qkv.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if valid_len is not None and valid_len < N:
        masked = torch.arange(N, device=qkv.device) >= valid_len
        scores = scores.masked_fill(masked, float("-inf"))
    if not softmax_f32:
        scores = scores.to(dtype).float()
    weights = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.matmul(weights.float(), v.float()).to(dtype)
    return out.permute(0, 2, 1, 3).reshape(B, N, D)


def _check(qkv, num_heads, valid_len, bias) -> None:
    if torch.is_grad_enabled() and (
        qkv.requires_grad or (bias is not None and bias.requires_grad)
    ):
        raise NotImplementedError(
            "fused_qkv_attention is forward-only on CUDA; run it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(qkv.shape)}")
    B, N, three_d = qkv.shape
    D = three_d // 3
    if D % num_heads or D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D / num_heads} not in {_HEAD_DIMS}")
    if not 1 <= N <= _MAX_TOKENS:
        raise ValueError(f"the kernel takes 1..{_MAX_TOKENS} tokens, got {N}")
    if valid_len is not None and not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside 1..{N}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if bias is not None and (
        bias.shape != (three_d,) or bias.dtype != qkv.dtype
        or bias.device != qkv.device or not bias.is_contiguous()
    ):
        raise ValueError(
            f"bias must be a contiguous ({three_d},) {qkv.dtype} tensor on "
            f"{qkv.device}, got {tuple(bias.shape)} {bias.dtype} on {bias.device}"
        )


def fused_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    softmax_f32: bool = True,
    valid_len: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q.k^T/sqrt(hd), keys >= valid_len masked).v per head -> (B, N, D).

    The contract of :func:`fused_qkv_attention_reference`; with ``bias`` it is
    the forward of the JAX ``fused_qkv_bias_attention``.  Rows at or past
    ``valid_len`` are computed but meaningless, as in the JAX kernel.
    """
    if qkv.device.type == "cpu":
        return fused_qkv_attention_reference(qkv, num_heads, softmax_f32, valid_len, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    _check(qkv, num_heads, valid_len, bias)
    from ._build import library

    global launches
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().ssl4polyp_qkv_attention_fwd(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, N, num_heads, head_dim, N if valid_len is None else int(valid_len),
            _scale(head_dim, qkv.dtype), int(bool(softmax_f32)), stream,
        )
    if err:
        raise RuntimeError(f"qkv_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
