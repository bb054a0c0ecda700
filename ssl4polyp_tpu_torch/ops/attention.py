"""Attention over separate q, k and v, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attention.py``::

    fused_attention(q, k, v) = softmax(q @ k.T / sqrt(hd)) @ v

per (batch, head), with q, k, v and the output (B, H, N, hd).  Its roundings
are that kernel's, not the QKV kernels': q and k enter the scores as they
are and the scale multiplies the fp32 scores; the backward recomputes the
weights and keeps them, and dS, unrounded.  On the card both directions are
CUDA kernels (``csrc/attention.cu``; both on wgmma with TMA loads, their
first designs kept behind :data:`PROBE_FIRST_DESIGN` and
:data:`BACKWARD_PROBE_FIRST_DESIGN`); no model route calls this function (as
in the JAX package, it is a public function of ``ops``).

A tensor on the CPU goes through the plain torch versions
(:func:`fused_attention_plain`); a CUDA tensor through the kernels, or the
wrapper raises.
"""

from __future__ import annotations

import math

import torch

from ._checks import FP32_PUBLIC_FUNCTIONS, check_bf16, check_gradient

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
# `probe` bits of the forward kernel, a measurement aid (0 on every path;
# chip_smoke.py times the kernel with parts left out, whose results are
# wrong): no softmax arithmetic (the scores rounded straight into the
# weights), no product with v (the first hd columns of the weights written
# instead), no prefetch of the next head, no exponential in the softmax;
# and the first design (right results).
PROBE_NO_SOFTMAX = 1
PROBE_NO_VALUES = 2
PROBE_NO_PREFETCH = 4
PROBE_FIRST_DESIGN = 8
PROBE_NO_EXP = 16
# `probe` bits of the backward kernel, a measurement aid (0 on every path;
# chip_smoke.py times the kernel with parts left out, whose results are
# wrong): phase B left out (dk, dv unwritten), phase A stopped after the
# softmax and its statistics (dq unwritten), the fp32 operands as their bf16
# rounding alone (no second term's products); and, with right results, one
# buffer (no prefetch of the next head) and the first design.
BACKWARD_PROBE_NO_PHASE_B = 1
BACKWARD_PROBE_SOFTMAX_ONLY = 2
BACKWARD_PROBE_NO_PREFETCH = 4
BACKWARD_PROBE_FIRST_DESIGN = 8
BACKWARD_PROBE_ONE_TERM = 16
_BACKWARD_PROBE_BITS = 31


def _weights(q: torch.Tensor, k: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The softmax weights in ``compute_dtype`` (fp32 as the kernels): q and
    k cast to it, the scale on the scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.to(compute_dtype), k.to(compute_dtype).transpose(-1, -2)) * scale
    return torch.softmax(scores, dim=-1)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the forward kernel, same roundings, no SDPA:
    fp32 scores and softmax, the weights rounded to ``v``'s dtype, their
    product with v accumulated in fp32 and rounded to ``q``'s dtype."""
    weights = _weights(q, k).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def fused_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward kernel, with the JAX kernel's steps
    (``_attention_bwd_kernel``): everything in fp32 from the recomputed,
    unrounded weights W; dV = W^T dO; dW = dO V^T; dS = W * (dW - rowsum(dW *
    W)) * scale; dQ = dS K; dK = dS^T Q; each rounded once to the inputs' dtype.
    ``compute_dtype=torch.float64`` gives the same steps in fp64, a reference
    that the kernel's fp32 sums and its W and dS carried in two bf16 terms
    are held to."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    weights = _weights(q, k, compute_dtype)
    do = dout.to(compute_dtype)
    dv = torch.matmul(weights.transpose(-1, -2), do)
    dw = torch.matmul(do, v.to(compute_dtype).transpose(-1, -2))
    tmp = (dw * weights).sum(dim=-1, keepdim=True)
    ds = weights * (dw - tmp) * scale
    dq = torch.matmul(ds, k.to(compute_dtype))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(compute_dtype))
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
        check_bf16(name, t.dtype, FP32_PUBLIC_FUNCTIONS)
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {q.device}")


def _forward_kernel(q, k, v, probe: int = 0):
    """The forward kernel; ``probe`` (0 on every path) is a measurement aid:
    the ``PROBE_*`` bits above."""
    from ._build import library

    global launches
    B, H, N, head_dim = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().ssl4polyp_attention_fwd_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, head_dim,
            1.0 / math.sqrt(head_dim), probe, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _backward_kernel(q, k, v, dout, probe: int = 0):
    """The backward kernel; ``probe`` (0 on every path) is a measurement
    aid: the ``BACKWARD_PROBE_*`` bits above."""
    if probe & ~_BACKWARD_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe & ~_BACKWARD_PROBE_BITS:#x}")
    from ._build import library

    global backward_launches
    check_gradient("dout", dout, q.shape, q.dtype, q.device)
    B, H, N, head_dim = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = library().ssl4polyp_attention_bwd_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, N, head_dim, 1.0 / math.sqrt(head_dim), probe,
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
