"""Attention with the output projection folded in, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attn_proj.py``::

    fused_attention_proj(qkv, w, b) = attention_core(qkv) @ w.T + b

with ``w`` in torch's (out, in) layout.  On the card, in bf16, the forward is
one CUDA kernel (``csrc/attn_proj.cu``) in which the (B, N, D) core output
never leaves the SM; the backward recomputes it and returns dqkv, dw and db
from hand-written kernels alone (the projection's three products included).
Past 256 tokens (a ViT-B/16 at 384 px has 577) bf16 takes the same file's
compositions, with launch counts of their own: the key tiles' attention
forward (``csrc/qkv_attention_tiles.cu``) writes the core output to a
(B, N, D) scratch, then the wgmma GEMM of ``csrc/mlp.cu`` forms y with the
bias in its epilogue; the backward recomputes the core output the same way,
forms dO on the GEMM, and runs the key tiles' backward.  fp32 tensors (the
runs that compute in fp32) take ``csrc/attn_proj_f32.cu``, with launch
counts of their own: the fp32 attention forward, whose output O
and log-sum-exp autograd saves when a backward follows, then the fp32 SGEMM
for the projection; the backward's dO, dW (split over the rows) and db, then
the fp32 attention backward from the saved O, all hand-written kernels.  The
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

from . import qkv_attention
from ._checks import check_gradient, check_one_dtype, saved_or_scratch
from .qkv_attention import (
    _TILES_PAST,
    _scale,
    fused_qkv_attention_backward_reference,
    fused_qkv_attention_reference,
    tiles_backward_scratch,
)

__all__ = [
    "BACKWARD_PHASES",
    "attn_proj_fold_enabled",
    "backward_launches",
    "backward_launches_f32",
    "fused_attention_proj",
    "fused_attention_proj_backward_reference",
    "fused_attention_proj_plain",
    "fused_attention_proj_reference",
    "launches",
    "launches_f32",
    "tiles_backward_launches",
    "tiles_launches",
]

# Kernel launches since the last ops.reset_launch_counts(): forward calls,
# and backward calls (each a fixed sequence of kernels, see csrc/attn_proj.cu
# and csrc/attn_proj_f32.cu); bf16 up to _TILES_PAST tokens, bf16 past them
# (the compositions on the key tiles), fp32.
launches = 0
backward_launches = 0
tiles_launches = 0
tiles_backward_launches = 0
launches_f32 = 0
backward_launches_f32 = 0

_HEAD_DIMS = (32, 64)
# Row slices of the backward's dW on its first design (csrc/attn_proj.cu).
_FIRST_DESIGN_DW_SLICES = 4
_DB_ROWS = 64  # rows of dy a partial column sum of db takes (both dtypes' kernels)


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
    check_one_dtype((qkv, w, b))
    if qkv.dtype == torch.bfloat16 and D % 128:
        raise ValueError(f"the bf16 kernel takes a width that is a multiple of 128, got {D}")
    if N < 1:
        raise ValueError(f"the kernels take at least one token, got {N}")
    if valid_len is not None and not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside 1..{N}")
    if w.shape != (D, D) or b.shape != (D,):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} do not fit width {D}")
    for name, t in (("qkv", qkv), ("w", w), ("b", b)):
        if t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {qkv.device}")


def _forward_kernel(qkv, w, b, num_heads, softmax_f32, valid_len, ablate: int = 0,
                    keep: bool = False):
    """The forward kernel of qkv's dtype (in bf16 past ``_TILES_PAST``
    tokens the composition on the key tiles, with its core-output scratch).
    ``ablate`` is a measurement aid of the bf16 kernel (csrc/attn_proj.cu: 1
    leaves out the attention arithmetic, 2 the projection's products): the
    result is then wrong and only its time is of use; the fp32 kernel and the
    composition past 256 tokens have none (``ValueError``).  In
    fp32 ``softmax_f32`` changes nothing, and with ``keep`` it returns ``(y,
    out, lse)``: the core output (B, N, D) and each row's log-sum-exp (B, H,
    N), which the fp32 backward reads."""
    from ._build import library

    global launches, launches_f32, tiles_launches
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    if qkv.dtype == torch.float32:
        if ablate:
            raise ValueError("the fp32 kernel has no ablate bits")
        core = torch.empty((B, N, D), dtype=torch.float32, device=qkv.device)
        lse = (torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device) if keep
               else None)
        y = torch.empty_like(core)
        with torch.cuda.device(qkv.device):
            err = library().ssl4polyp_attn_proj_fwd_f32(
                qkv.data_ptr(), w.data_ptr(), b.data_ptr(), core.data_ptr(),
                None if lse is None else lse.data_ptr(), y.data_ptr(), B, N, num_heads,
                head_dim, N if valid_len is None else int(valid_len),
                _scale(head_dim, torch.float32), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fp32 attn_proj kernel launch failed: CUDA error {err}")
        launches_f32 += 1
        return (y, core, lse) if keep else y
    if keep:
        raise ValueError("only the fp32 kernel keeps the core output")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    tiles = N > _TILES_PAST
    if tiles and ablate:
        raise ValueError(f"the forward past {_TILES_PAST} tokens has no ablate bits")
    core = torch.empty_like(out) if tiles else None  # scratch: the key tiles' core output
    with torch.cuda.device(qkv.device):
        err = library().ssl4polyp_attn_proj_fwd(
            qkv.data_ptr(), w.data_ptr(), b.data_ptr(), None if core is None else core.data_ptr(),
            out.data_ptr(), B, N, num_heads, head_dim, N if valid_len is None else int(valid_len),
            _scale(head_dim, qkv.dtype), int(bool(softmax_f32)), ablate,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"attn_proj kernel launch failed: CUDA error {err}")
    if tiles:
        tiles_launches += 1
    else:
        launches += 1
    return out


# The backward's phases (csrc/attn_proj.cu), a bit each in its ``phases``
# argument: W^T and the recompute of O with dO, dw, db, the attention backward
# (past 256 tokens O from the key tiles' forward and dO on the GEMM, and the
# key tiles' backward).
BACKWARD_PHASES = {"prep": 1, "dw": 2, "db": 4, "attention": 8}
_ALL_PHASES = 15
# A phase bit for timing alone: dw on its first design (mma.sync), in dw's place.
DW_FIRST_DESIGN_PHASE = 16


def _backward_kernel(qkv, w, b, dy, num_heads, softmax_f32, valid_len, out=None, lse=None):
    """(dqkv, dw, db) from the backward kernels of qkv's dtype: the bf16
    backward's four phases (counted apart past ``_TILES_PAST`` tokens), or
    the fp32 backward (:func:`_backward_f32`), which also takes the forward's
    core output and log-sum-exp (``out`` and ``lse``, from
    ``_forward_kernel`` with ``keep``)."""
    global backward_launches, tiles_backward_launches
    if qkv.dtype == torch.float32:
        return _backward_f32(qkv, w, b, dy, num_heads, valid_len, out, lse)
    if out is not None or lse is not None:
        raise ValueError("out and lse go to the fp32 backward kernel only")
    run, results = _backward_plan(qkv, w, b, dy, num_heads, softmax_f32, valid_len)
    run(_ALL_PHASES)
    if qkv.shape[1] > _TILES_PAST:
        tiles_backward_launches += 1
        qkv_attention.tiles_statistics_launches += 1
    else:
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
    stats, dq_acc = (tiles_backward_scratch(B, num_heads, N, head_dim, dev) if N > _TILES_PAST
                     else (None, None))

    def run(phases: int) -> None:
        with torch.cuda.device(dev):
            err = lib.ssl4polyp_attn_proj_bwd(
                qkv.data_ptr(), w.data_ptr(), dy.data_ptr(), w_t.data_ptr(), out.data_ptr(),
                d_out.data_ptr(), dqkv.data_ptr(), dw_part.data_ptr(), dw.data_ptr(),
                db_part.data_ptr(), db.data_ptr(), None if stats is None else stats.data_ptr(),
                None if dq_acc is None else dq_acc.data_ptr(), B, N, num_heads, head_dim,
                N if valid_len is None else int(valid_len), _scale(head_dim, qkv.dtype),
                1.0 / math.sqrt(head_dim), int(bool(softmax_f32)), slices, phases,
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"attn_proj backward kernel launch failed: CUDA error {err}")

    return run, lambda: (dqkv, dw.to(w.dtype), db.to(b.dtype))


def _backward_f32(qkv, w, b, dy, num_heads, valid_len, out, lse):
    """The fp32 backward's one counted launch (csrc/attn_proj_f32.cu): dO =
    dy . w, dw split over the rows, db, then the fp32 attention backward on
    dO from the forward's core output and log-sum-exp; without them (``out``
    and ``lse`` None) the attention forward runs first into scratch."""
    from ._build import library

    global backward_launches_f32
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    dev = qkv.device
    check_gradient("dy", dy, (B, N, D), torch.float32, dev)
    out, lse, forward_first = saved_or_scratch(out, lse, (B, N, D), (B, num_heads, N), dev)
    lib = library()
    with torch.cuda.device(dev):
        slices = lib.ssl4polyp_sgemm_f32_slices(D, D, B * N)
    if slices < 1:
        raise RuntimeError(f"fp32 attn_proj backward: CUDA error {-slices}")
    delta = torch.empty((B, num_heads, N), dtype=torch.float32, device=dev)  # scratch
    d_out = torch.empty((B, N, D), dtype=torch.float32, device=dev)          # scratch: dO
    dqkv = torch.empty_like(qkv)
    dw_part = (torch.empty((slices, D, D), dtype=torch.float32, device=dev) if slices > 1
               else None)
    dw = torch.empty((D, D), dtype=torch.float32, device=dev)
    db_part = torch.empty((-(-B * N // _DB_ROWS), D), dtype=torch.float32, device=dev)
    db = torch.empty((D,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssl4polyp_attn_proj_bwd_f32(
            qkv.data_ptr(), w.data_ptr(), dy.data_ptr(), out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), d_out.data_ptr(), dqkv.data_ptr(),
            None if dw_part is None else dw_part.data_ptr(), dw.data_ptr(), db_part.data_ptr(),
            db.data_ptr(), B, N, num_heads, head_dim, N if valid_len is None else int(valid_len),
            _scale(head_dim, torch.float32), slices, int(forward_first),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fp32 attn_proj backward kernel launch failed: CUDA error {err}")
    backward_launches_f32 += 1
    return dqkv, dw.to(w.dtype), db.to(b.dtype)


class _AttentionProj(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True).
    The fp32 kernels' backward also takes the forward's core output and
    log-sum-exp, saved when a backward will follow."""

    @staticmethod
    def forward(ctx, qkv, w, b, num_heads, softmax_f32, valid_len, plain):
        ctx.args = (num_heads, softmax_f32, valid_len)
        ctx.plain = plain
        saved = ()
        if plain:
            y = fused_attention_proj_reference(qkv, w, b, num_heads, softmax_f32, valid_len)
        elif qkv.dtype == torch.float32 and any(ctx.needs_input_grad[:3]):
            y, *saved = _forward_kernel(qkv, w, b, num_heads, softmax_f32, valid_len, keep=True)
        else:
            y = _forward_kernel(qkv, w, b, num_heads, softmax_f32, valid_len)
        ctx.save_for_backward(qkv, w, b, *saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        qkv, w, b, *saved = ctx.saved_tensors
        if ctx.plain:
            dqkv, dw, db = fused_attention_proj_backward_reference(qkv, w, b, dy.contiguous(),
                                                                   *ctx.args)
        else:
            out, lse = saved or (None, None)
            dqkv, dw, db = _backward_kernel(qkv, w, b, dy.contiguous(), *ctx.args, out=out,
                                            lse=lse)
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
    zeros to dw and db.  On the card the kernels take contiguous tensors of
    one dtype, bfloat16 (D a multiple of 128) or float32 (any number of
    heads), any number of tokens and a head dim of 32 or 64, and raise on
    anything else.
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
