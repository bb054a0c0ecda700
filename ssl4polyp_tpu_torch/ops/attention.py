"""Attention over separate q, k and v, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attention.py``::

    fused_attention(q, k, v) = softmax(q @ k.T / sqrt(hd)) @ v

per (batch, head), with q, k, v and the output (B, H, N, hd).  Its roundings
are that kernel's, not the QKV kernels': q and k enter the scores as they
are and the scale multiplies the fp32 scores; the backward recomputes the
weights and keeps them, and dS, unrounded.  On the card both directions are
CUDA kernels (``csrc/attention.cu``); no model route calls this function (as
in the JAX package, it is a public function of ``ops``).

A tensor on the CPU goes through the plain torch versions
(:func:`fused_attention_plain`); a CUDA tensor through the kernels, or the
wrapper raises.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "backward_launches",
    "fused_attention",
    "fused_attention_backward_reference",
    "fused_attention_plain",
    "fused_attention_reference",
    "launches",
]

# Kernel launches since the last ops.reset_launch_counts().
launches = 0
backward_launches = 0

# What the kernels take: bf16, these head sizes, 1..256 tokens.
_HEAD_DIMS = (16, 32, 64)
_MAX_TOKENS = 256


def _weights(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The fp32 softmax weights: q and k cast to fp32, the scale on the scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(scores, dim=-1)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the forward kernel, same roundings, no SDPA:
    fp32 scores and softmax, the weights rounded to ``v``'s dtype, their
    product with v accumulated in fp32 and rounded to ``q``'s dtype."""
    weights = _weights(q, k).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def fused_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward kernel, with the JAX kernel's steps
    (``_attention_bwd_kernel``): everything in fp32 from the recomputed,
    unrounded weights W; dV = W^T dO; dW = dO V^T; dS = W * (dW - rowsum(dW *
    W)) * scale; dQ = dS K; dK = dS^T Q; each rounded once to the inputs' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    weights = _weights(q, k)
    do = dout.float()
    dv = torch.matmul(weights.transpose(-1, -2), do)
    dw = torch.matmul(do, v.float().transpose(-1, -2))
    tmp = (dw * weights).sum(dim=-1, keepdim=True)
    ds = weights * (dw - tmp) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _, _, N, head_dim = q.shape
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {_HEAD_DIMS}")
    if not 1 <= N <= _MAX_TOKENS:
        raise ValueError(f"the kernel takes 1..{_MAX_TOKENS} tokens, got {N}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16, got {name} {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {q.device}")


def _forward_kernel(q, k, v):
    from ._build import library

    global launches
    B, H, N, head_dim = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().ssl4polyp_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, head_dim,
            1.0 / math.sqrt(head_dim), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _backward_kernel(q, k, v, dout):
    from ._build import library

    global backward_launches
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not fit q "
                         f"{tuple(q.shape)} {q.dtype}")
    B, H, N, head_dim = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = library().ssl4polyp_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, N, head_dim, 1.0 / math.sqrt(head_dim),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA error {err}")
    backward_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True)."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return (fused_attention_reference if plain else _forward_kernel)(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        run = fused_attention_backward_reference if ctx.plain else _backward_kernel
        return (*run(*ctx.saved_tensors, dout.contiguous()), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q.k^T/sqrt(hd)).v per (batch, head) -> (B, H, N, hd),
    differentiable in q, k and v; the backward recomputes the weights.

    On the card the kernels take contiguous bfloat16 tensors with a head dim
    of 16, 32 or 64 and 1..256 tokens, and raise on anything else.
    """
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v)
    return _Attention.apply(q, k, v, False)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`fused_attention` through the plain versions, on any device."""
    return _Attention.apply(q, k, v, True)
