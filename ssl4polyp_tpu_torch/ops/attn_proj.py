"""Attention with the output projection folded in, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attn_proj.py``::

    fused_attention_proj(qkv, w, b) = attention_core(qkv) @ w.T + b

with ``w`` in torch's (out, in) layout.  On the card the forward is one CUDA
kernel (``csrc/attn_proj.cu``) in which the (B, N, D) core output never
leaves the SM; the backward recomputes it and returns dqkv, dw and db from
hand-written kernels alone (the projection's three products included).  The
knob is the JAX package's: ``BENCH_ATTN_PROJ=1``
(:func:`attn_proj_fold_enabled`), read where a model is built.

A tensor on the CPU goes through the plain torch versions
(:func:`fused_attention_proj_plain`); a CUDA tensor through the kernels, or
the wrapper raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ._checks import FP32_FUSION_KNOBS, check_bf16, check_gradient
from .qkv_attention import (
    _MAX_TOKENS,
    _scale,
    fused_qkv_attention_backward_reference,
    fused_qkv_attention_reference,
)

__all__ = [
    "BACKWARD_PHASES",
    "attn_proj_fold_enabled",
    "backward_launches",
    "fused_attention_proj",
    "fused_attention_proj_backward_reference",
    "fused_attention_proj_plain",
    "fused_attention_proj_reference",
    "launches",
]

# Kernel launches since the last ops.reset_launch_counts(): forward calls,
# and backward calls (each a fixed sequence of kernels, see csrc/attn_proj.cu).
launches = 0
backward_launches = 0

_HEAD_DIMS = (32, 64)
# Row slices of the backward's dW on its first design (csrc/attn_proj.cu).
_FIRST_DESIGN_DW_SLICES = 4
_DB_ROWS = 64


def attn_proj_fold_enabled() -> bool:
    """The JAX package's A/B knob: ``BENCH_ATTN_PROJ=1`` folds the output
    projection into the attention kernel on the stacks that run its
    flattened stream (``models/layers.py::block_route``)."""
    return os.environ.get("BENCH_ATTN_PROJ", "0") == "1"


def fused_attention_proj_reference(
    qkv: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain torch version of the forward kernel, same roundings: the core
    output rounded to the compute dtype, its product with ``w`` (out, in)
    accumulated in fp32 and rounded, then the bias added in the compute
    dtype.  Returns (B, N, D)."""
    dtype = qkv.dtype
    out = fused_qkv_attention_reference(qkv, num_heads, softmax_f32, valid_len)
    return torch.matmul(out.float(), w.float().t()).to(dtype) + b.to(dtype)


def fused_attention_proj_backward_reference(
    qkv: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward, with the JAX kernel's steps and
    roundings (``_bwd_kernel``): the core output O recomputed and rounded;
    dO = dy . w rounded to the compute dtype; dw = dy^T O and db = sum of dy
    in fp32 over every row of the batch; then the attention backward on dO.
    Returns dqkv, dw (out, in) in ``w``'s dtype and db in ``b``'s."""
    dtype = qkv.dtype
    D = w.shape[0]
    out = fused_qkv_attention_reference(qkv, num_heads, softmax_f32, valid_len)
    dy2 = dy.reshape(-1, D).float()
    d_out = torch.matmul(dy2, w.float()).to(dtype).reshape(dy.shape)
    dw = torch.matmul(dy2.t(), out.reshape(-1, D).float())
    db = dy2.sum(dim=0)
    dqkv, _ = fused_qkv_attention_backward_reference(qkv, d_out, num_heads, softmax_f32,
                                                     valid_len)
    return dqkv, dw.to(w.dtype), db.to(b.dtype)


def _check(qkv, w, b, num_heads, valid_len) -> None:
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, N, 3D), got {tuple(qkv.shape)}")
    B, N, three_d = qkv.shape
    D = three_d // 3
    if D % num_heads or D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D / num_heads} not in {_HEAD_DIMS}")
    if D % 128:
        raise ValueError(f"the kernel takes a width that is a multiple of 128, got {D}")
    if not 1 <= N <= _MAX_TOKENS:
        raise ValueError(f"the kernel takes 1..{_MAX_TOKENS} tokens, got {N}")
    if valid_len is not None and not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside 1..{N}")
    if w.shape != (D, D) or b.shape != (D,):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} do not fit width {D}")
    for name, t in (("qkv", qkv), ("w", w), ("b", b)):
        check_bf16(name, t.dtype, FP32_FUSION_KNOBS)
        if t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {qkv.device}")


def _forward_kernel(qkv, w, b, num_heads, softmax_f32, valid_len, ablate: int = 0):
    """The forward kernel.  ``ablate`` is a measurement aid (csrc/attn_proj.cu:
    1 leaves out the attention arithmetic, 2 the projection's products): the
    result is then wrong and only its time is of use."""
    from ._build import library

    global launches
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = library().ssl4polyp_attn_proj_fwd(
            qkv.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, num_heads,
            head_dim, N if valid_len is None else int(valid_len), _scale(head_dim, qkv.dtype),
            int(bool(softmax_f32)), ablate, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"attn_proj kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# The backward's phases (csrc/attn_proj.cu), a bit each in its ``phases``
# argument: W^T and the recompute of O with dO, dw, db, the attention backward.
BACKWARD_PHASES = {"prep": 1, "dw": 2, "db": 4, "attention": 8}
_ALL_PHASES = 15
# A phase bit for timing alone: dw on its first design (mma.sync), in dw's place.
DW_FIRST_DESIGN_PHASE = 16


def _backward_kernel(qkv, w, b, dy, num_heads, softmax_f32, valid_len):
    """(dqkv, dw, db) from the backward's four phases."""
    global backward_launches
    run, results = _backward_plan(qkv, w, b, dy, num_heads, softmax_f32, valid_len)
    run(_ALL_PHASES)
    backward_launches += 1
    return results()


def _backward_plan(qkv, w, b, dy, num_heads, softmax_f32, valid_len):
    """Allocates the backward's scratch and results once and returns
    ``(run, results)``: ``run(phases)`` launches the phases of the mask
    (:data:`BACKWARD_PHASES`, and :data:`DW_FIRST_DESIGN_PHASE`; a later
    phase reads what the earlier ones left in the scratch), and
    ``results()`` returns (dqkv, dw, db).  No launch is counted here."""
    from ._build import library

    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    check_gradient("dy", dy, (B, N, D), qkv.dtype, qkv.device)
    dev = qkv.device
    w_t = torch.empty_like(w)                                    # scratch: W^T
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=dev)    # scratch: the core output
    d_out = torch.empty_like(out)                                # scratch: dO
    dqkv = torch.empty_like(qkv)
    lib = library()
    with torch.cuda.device(dev):
        slices = lib.ssl4polyp_dw_product_slices(B * N, D, D)
    if slices < 1:
        raise RuntimeError(f"attn_proj backward: CUDA error {-slices}")
    dw_part = torch.empty((max(slices, _FIRST_DESIGN_DW_SLICES), D, D), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((D, D), dtype=torch.float32, device=dev)
    db_part = torch.empty((-(-B * N // _DB_ROWS), D), dtype=torch.float32, device=dev)
    db = torch.empty((D,), dtype=torch.float32, device=dev)

    def run(phases: int) -> None:
        with torch.cuda.device(dev):
            err = lib.ssl4polyp_attn_proj_bwd(
                qkv.data_ptr(), w.data_ptr(), dy.data_ptr(), w_t.data_ptr(), out.data_ptr(),
                d_out.data_ptr(), dqkv.data_ptr(), dw_part.data_ptr(), dw.data_ptr(),
                db_part.data_ptr(), db.data_ptr(), B, N, num_heads, head_dim,
                N if valid_len is None else int(valid_len), _scale(head_dim, qkv.dtype),
                1.0 / math.sqrt(head_dim), int(bool(softmax_f32)), slices, phases,
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"attn_proj backward kernel launch failed: CUDA error {err}")

    return run, lambda: (dqkv, dw.to(w.dtype), db.to(b.dtype))


class _AttentionProj(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True)."""

    @staticmethod
    def forward(ctx, qkv, w, b, num_heads, softmax_f32, valid_len, plain):
        ctx.save_for_backward(qkv, w, b)
        ctx.args = (num_heads, softmax_f32, valid_len)
        ctx.plain = plain
        run = fused_attention_proj_reference if plain else _forward_kernel
        return run(qkv, w, b, num_heads, softmax_f32, valid_len)

    @staticmethod
    def backward(ctx, dy):
        qkv, w, b = ctx.saved_tensors
        run = fused_attention_proj_backward_reference if ctx.plain else _backward_kernel
        dqkv, dw, db = run(qkv, w, b, dy.contiguous(), *ctx.args)
        return dqkv, dw, db, None, None, None, None


def fused_attention_proj(
    qkv: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """``attention_core(qkv) @ w.T + b`` -> (B, N, D), differentiable in
    ``qkv``, ``w`` and ``b``.

    ``qkv`` (B, N, 3D) is the fused QKV projection with its bias added (see
    ``fused_qkv_attention_reference`` for the head layout and the masking of
    keys at or past ``valid_len``); ``w`` (D, D) is (out, in) and ``b`` (D,),
    both in the compute dtype.  Rows at or past ``valid_len`` are computed
    but meaningless; their upstream gradient is zero, so they add exact
    zeros to dw and db.
    """
    if qkv.device.type == "cpu":
        return fused_attention_proj_plain(qkv, w, b, num_heads, softmax_f32, valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    _check(qkv, w, b, num_heads, valid_len)
    return _AttentionProj.apply(qkv, w, b, num_heads, softmax_f32, valid_len, False)


def fused_attention_proj_plain(
    qkv: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """:func:`fused_attention_proj` through the plain versions, on any device."""
    return _AttentionProj.apply(qkv, w, b, num_heads, softmax_f32, valid_len, True)
