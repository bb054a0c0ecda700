"""Attention over separate q, k and v, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attention.py``::

    fused_attention(q, k, v) = softmax(q @ k.T / sqrt(hd)) @ v

per (batch, head), with q, k, v and the output (B, H, N, hd).  Its roundings
are that kernel's, not the QKV kernels': q and k enter the scores as they
are and the scale multiplies the fp32 scores; the backward recomputes the
weights and keeps them, and dS, unrounded.  No model route calls this
function (as in the JAX package, it is a public function of ``ops``).  On
the card each direction is a CUDA kernel, chosen by dtype and token count,
each with launch counts of its own:

* bf16 up to 256 tokens: ``csrc/attention.cu`` (both directions on wgmma
  with TMA loads, their first designs kept behind
  :data:`PROBE_FIRST_DESIGN` and :data:`BACKWARD_PROBE_FIRST_DESIGN`);
* bf16 past 256 tokens: the key tiles of ``csrc/qkv_attention_tiles.cu`` in
  this layout and with these roundings (W and dS as two bf16 terms);
* fp32 at any token count: the fp32 kernels of ``csrc/qkv_attention_f32.cu``
  in this layout (the scale inside dS); the forward writes each row's
  log-sum-exp when a backward will follow, and the backward reads it with
  the output.

A tensor on the CPU goes through the plain torch versions
(:func:`fused_attention_plain`); a CUDA tensor through the kernels, or the
wrapper raises.
"""

from __future__ import annotations

import math

import torch

from . import qkv_attention
from ._checks import check_gradient, check_one_dtype, saved_or_scratch
from .qkv_attention import _TILES_PAST, tiles_backward_scratch

__all__ = [
    "backward_launches",
    "backward_launches_f32",
    "fused_attention",
    "fused_attention_backward_reference",
    "fused_attention_plain",
    "fused_attention_reference",
    "launches",
    "launches_f32",
    "tiles_backward_launches",
    "tiles_backward_plan",
    "tiles_launches",
]

# Kernel launches since the last ops.reset_launch_counts(): bf16 up to
# _TILES_PAST tokens, bf16 past them (the key tiles), fp32.
launches = 0
backward_launches = 0
tiles_launches = 0
tiles_backward_launches = 0
launches_f32 = 0
backward_launches_f32 = 0

# The head dims the kernels take, any N >= 1: bf16 (attention.cu and the key
# tiles) and fp32 (qkv_attention_f32.cu's instantiations).  Others are not
# yet ported (_HEAD_DIMS_ITEM).
_HEAD_DIMS = (16, 32, 64)
_HEAD_DIMS_F32 = (32, 64)
_HEAD_DIMS_ITEM = "ROADMAP.md §2a, item 4"
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
    check_one_dtype((q, k, v))
    _, _, N, head_dim = q.shape
    head_dims = _HEAD_DIMS_F32 if q.dtype == torch.float32 else _HEAD_DIMS
    if head_dim not in head_dims:
        raise ValueError(f"fused_attention's {q.dtype} kernels take head dims {head_dims}, got "
                         f"{head_dim} (other head dims are not yet ported: {_HEAD_DIMS_ITEM})")
    if N < 1:
        raise ValueError(f"the kernels take 1 or more tokens, got {N}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {q.device}")


def _route(q: torch.Tensor) -> str:
    """Which kernels take q's dtype and token count: "f32", "tiles" (bf16
    past _TILES_PAST tokens) or "bf16"."""
    if q.dtype == torch.float32:
        return "f32"
    return "tiles" if q.shape[2] > _TILES_PAST else "bf16"


def _forward_kernel(q, k, v, probe: int = 0, lse: bool = False):
    """The forward kernel of q's dtype and token count.  ``probe`` (0 on
    every path) is a measurement aid of the bf16 kernel up to _TILES_PAST
    tokens: the ``PROBE_*`` bits above; the others have none
    (``ValueError``).  With ``lse`` (fp32 only) it returns ``(out, lse)``:
    lse (B, H, N) fp32 holds each row's log-sum-exp, which the fp32 backward
    reads."""
    from ._build import library

    global launches, launches_f32, tiles_launches
    route = _route(q)
    if probe and route != "bf16":
        raise ValueError(f"the {route} forward kernel has no probe bits")
    if lse and route != "f32":
        raise ValueError("only the fp32 forward kernel writes the log-sum-exp")
    B, H, N, head_dim = q.shape
    out = torch.empty_like(q)
    stats = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if lse else None
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    scale = 1.0 / math.sqrt(head_dim)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "f32":
            err = library().ssl4polyp_attention_fwd_f32(
                *pointers, None if stats is None else stats.data_ptr(), B, H, N, head_dim, scale,
                stream)
        elif route == "tiles":
            err = library().ssl4polyp_attention_tiles_fwd(*pointers, B, H, N, head_dim, scale,
                                                          stream)
        else:
            err = library().ssl4polyp_attention_fwd_probe(*pointers, B * H, N, head_dim, scale,
                                                          probe, stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    if route == "f32":
        launches_f32 += 1
    elif route == "tiles":
        tiles_launches += 1
    else:
        launches += 1
    return (out, stats) if lse else out


def _backward_kernel(q, k, v, dout, probe: int = 0, out=None, lse=None):
    """The backward kernel of q's dtype and token count.  ``probe`` (0 on
    every path) is a measurement aid of the bf16 kernel up to _TILES_PAST
    tokens: the ``BACKWARD_PROBE_*`` bits above; the others have none
    (``ValueError``).  ``out`` and ``lse``: the fp32 forward's output and
    log-sum-exp (``_forward_kernel`` with ``lse``), as the autograd path
    hands them over; without them the fp32 backward's launch runs the forward
    kernel into scratch first.  The bf16 kernels take neither."""
    if probe & ~_BACKWARD_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe & ~_BACKWARD_PROBE_BITS:#x}")
    from ._build import library

    global backward_launches, backward_launches_f32, tiles_backward_launches
    check_gradient("dout", dout, q.shape, q.dtype, q.device)
    route = _route(q)
    if probe and route != "bf16":
        raise ValueError(f"the {route} backward kernel has no probe bits")
    if route != "f32" and (out is not None or lse is not None):
        raise ValueError("out and lse go to the fp32 backward kernel only")
    B, H, N, head_dim = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr())
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    scale = 1.0 / math.sqrt(head_dim)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "f32":  # the scale inside dS, as the JAX kernel puts it
            out, lse, forward_first = saved_or_scratch(out, lse, q.shape, (B, H, N), q.device)
            delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
            err = library().ssl4polyp_attention_bwd_f32(
                *pointers, out.data_ptr(), lse.data_ptr(), delta.data_ptr(), *grads, B, H, N,
                head_dim, scale, int(forward_first), stream)
        elif route == "tiles":
            stats, dq_acc = tiles_backward_scratch(B, H, N, head_dim, q.device)
            err = library().ssl4polyp_attention_tiles_bwd(
                *pointers, *grads, stats.data_ptr(), dq_acc.data_ptr(), B, H, N, head_dim, scale,
                stream)
        else:
            err = library().ssl4polyp_attention_bwd_probe(*pointers, *grads, B * H, N, head_dim,
                                                          scale, probe, stream)
    if err:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA error {err}")
    if route == "f32":
        backward_launches_f32 += 1
    elif route == "tiles":
        tiles_backward_launches += 1
        qkv_attention.tiles_statistics_launches += 1
    else:
        backward_launches += 1
    return dq, dk, dv


def tiles_backward_plan(head_dim: int) -> dict:
    """The key tiles' gradient pass in this function's mode at a head dim:
    ``{"warps": ..., "smem_bytes": ..., "blocks_per_sm": ...}`` (a block's
    warps and dynamic shared memory, and the blocks an SM holds by the
    occupancy API).  Builds the library if it is not built."""
    import ctypes

    from ._build import library

    warps, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = library().ssl4polyp_attention_tiles_bwd_plan(head_dim, ctypes.byref(warps),
                                                       ctypes.byref(smem), ctypes.byref(blocks))
    if err:
        raise ValueError(f"no key-tile backward for head dim {head_dim} (error {err})")
    return {"warps": warps.value, "smem_bytes": smem.value, "blocks_per_sm": blocks.value}


class _Attention(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True).
    The fp32 kernels' backward also takes the forward's output (saved
    without a copy) and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        ctx.plain = plain
        saved = ()
        if plain:
            out = fused_attention_reference(q, k, v)
        elif q.dtype == torch.float32 and any(ctx.needs_input_grad[:3]):
            out, lse = _forward_kernel(q, k, v, lse=True)
            saved = (out, lse)
        else:
            out = _forward_kernel(q, k, v)
        ctx.save_for_backward(q, k, v, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *saved = ctx.saved_tensors
        if ctx.plain:
            grads = fused_attention_backward_reference(q, k, v, dout.contiguous())
        else:
            out, lse = saved or (None, None)
            grads = _backward_kernel(q, k, v, dout.contiguous(), out=out, lse=lse)
        return (*grads, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q.k^T/sqrt(hd)).v per (batch, head) -> (B, H, N, hd),
    differentiable in q, k and v.

    On the card the kernels take contiguous tensors of any N >= 1: bfloat16
    with a head dim of 16, 32 or 64, float32 with one of 32 or 64.  Another
    head dim raises ``ValueError``, another dtype ``TypeError``.
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
