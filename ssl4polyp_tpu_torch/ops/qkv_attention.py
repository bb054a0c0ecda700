"""Attention straight from the fused QKV projection, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/qkv_attention.py``: one CUDA kernel per
direction (``csrc/qkv_attention.cu``) covers both ``fused_qkv_attention``
and, through its ``bias`` argument, ``fused_qkv_bias_attention``, in bf16;
fp32 tensors (the runs that compute in fp32) take the fp32 kernels of
``csrc/qkv_attention_f32.cu``, with launch counts of their own.  The
backward recomputes the weights: nothing but qkv (and the bias) is saved.

A tensor on the CPU goes through the plain torch versions,
:func:`fused_qkv_attention_reference` and
:func:`fused_qkv_attention_backward_reference`; a CUDA tensor goes through the
kernels, or the wrapper raises.  :func:`fused_qkv_attention_plain` runs the
plain versions on any device, to compare the kernels with.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ._checks import check_gradient

__all__ = [
    "backward_launches",
    "backward_launches_f32",
    "backward_plan",
    "fused_qkv_attention",
    "fused_qkv_attention_backward_reference",
    "fused_qkv_attention_plain",
    "fused_qkv_attention_reference",
    "launches",
    "launches_f32",
]

# Kernel launches since the last ops.reset_launch_counts(): bf16, fp32.
launches = 0
backward_launches = 0
launches_f32 = 0
backward_launches_f32 = 0

_HEAD_DIMS = (16, 32, 64)
_HEAD_DIMS_F32 = (32, 64)  # the fp32 kernels' instantiations
_MAX_TOKENS = 256


@functools.lru_cache(maxsize=None)
def _scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(hd) as the compute dtype holds it (the TPU kernel's fold).
    Cached: every launch asks, and the tensor round trip costs microseconds."""
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


def fused_qkv_attention_backward_reference(
    qkv: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    softmax_f32: bool = True,
    valid_len: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
    scaled_ds: bool = False,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of the backward kernel, with the JAX kernel's
    steps and roundings (``_bwd_kernel``, ``_bwd_bias_kernel``).

    The weights W are recomputed as in the forward (fp32, from the
    compute-dtype scale fold in q); dV = round(W)^T dO; dW = dO V^T; tmp =
    rowsum(dW * W) with the unrounded W; dS = round(W * (dW - tmp)); dQ = dS K
    and dK = dS^T Q with the unscaled k and q, times the fp32 1/sqrt(hd).
    With ``scaled_ds`` the scale sits where ``attention_block.py``'s kernel
    puts it (the kernel's mode 1): dS = round(W * (dW - tmp) * scale), dQ and
    dK unscaled.  Returns dqkv (B, N, 3D) in the compute dtype and, with
    ``bias``, dbias: the fp32 sum over every row of the rounded dqkv, in
    ``bias``'s dtype.
    """
    dtype = qkv.dtype
    x = qkv if bias is None else qkv + bias
    B, N, three_d = x.shape
    D = three_d // 3
    head_dim = D // num_heads
    q, k, v = x.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    q_s = q * torch.tensor(_scale(head_dim, dtype), dtype=dtype, device=qkv.device)
    scores = torch.matmul(q_s.float(), k.float().transpose(-1, -2))
    if valid_len is not None and valid_len < N:
        masked = torch.arange(N, device=qkv.device) >= valid_len
        scores = scores.masked_fill(masked, float("-inf"))
    if not softmax_f32:
        scores = scores.to(dtype).float()
    weights = torch.softmax(scores, dim=-1)
    do = dout.reshape(B, N, num_heads, head_dim).permute(0, 2, 1, 3).float()
    dv = torch.matmul(weights.to(dtype).float().transpose(-1, -2), do)
    dw = torch.matmul(do, v.float().transpose(-1, -2))
    tmp = (dw * weights).sum(dim=-1, keepdim=True)
    if scaled_ds:
        ds = (weights * (dw - tmp) * (1.0 / math.sqrt(head_dim))).to(dtype).float()
        dq = torch.matmul(ds, k.float())
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
    else:
        ds = (weights * (dw - tmp)).to(dtype).float()
        scale = torch.tensor(1.0 / math.sqrt(head_dim), dtype=torch.float32)
        dq = torch.matmul(ds, k.float()) * scale
        dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dqkv = torch.stack([dq, dk, dv]).to(dtype)  # (3, B, H, N, hd)
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(B, N, three_d)
    dbias = None if bias is None else dqkv.float().sum(dim=(0, 1)).to(bias.dtype)
    return dqkv, dbias


def _check(qkv, num_heads, valid_len, bias) -> None:
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
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernels take bfloat16 or float32, got {qkv.dtype}")
    if qkv.dtype == torch.float32 and D // num_heads not in _HEAD_DIMS_F32:
        raise ValueError(f"the fp32 kernels take head dims {_HEAD_DIMS_F32}, got "
                         f"{D // num_heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if bias is not None and (
        bias.shape != (three_d,) or bias.dtype != qkv.dtype
        or bias.device != qkv.device or not bias.is_contiguous() or bias.data_ptr() % 16
    ):
        raise ValueError(
            f"bias must be a contiguous, 16-byte aligned ({three_d},) {qkv.dtype} tensor on "
            f"{qkv.device}, got {tuple(bias.shape)} {bias.dtype} on {bias.device}"
        )


def _forward_kernel(qkv, num_heads, softmax_f32, valid_len, bias):
    """The forward kernel of qkv's dtype.  In fp32 ``softmax_f32`` changes
    nothing: the scores are fp32 either way, as in the plain version."""
    from ._build import library

    global launches, launches_f32
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    args = (qkv.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, N, num_heads, head_dim, N if valid_len is None else int(valid_len),
            _scale(head_dim, qkv.dtype))
    f32 = qkv.dtype == torch.float32
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f32:
            err = library().ssl4polyp_qkv_attention_fwd_f32(*args, stream)
        else:
            err = library().ssl4polyp_qkv_attention_fwd(*args, int(bool(softmax_f32)), stream)
    if err:
        raise RuntimeError(f"qkv_attention kernel launch failed: CUDA error {err}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out


# The backward kernel's paths (csrc/qkv_attention.cu): "stored dS" up to 208
# tokens, "first design" past them.
BACKWARD_PATHS = {1: "stored dS", 0: "first design"}
# `probe` bits of the backward kernel, a measurement aid whose results are
# wrong (all but PROBE_FIRST_DESIGN): phase B left out, phase A stopped after
# the softmax, phase B's weights without the exponential, the first design at
# any length.
PROBE_NO_PHASE_B = 1
PROBE_NO_PHASE_A_BACKWARD = 2
PROBE_NO_EXP_B = 4
PROBE_FIRST_DESIGN = 8


def backward_plan(num_tokens: int, head_dim: int) -> dict:
    """The backward kernel's path for a shape, as the library dispatches it:
    ``{"path": ..., "warps": ..., "smem_bytes": ...}`` (a block's warps and
    dynamic shared memory).  Builds the library if it is not built."""
    import ctypes

    from ._build import library

    warps, smem = ctypes.c_int(), ctypes.c_int()
    path = library().ssl4polyp_qkv_attention_bwd_plan(num_tokens, head_dim, ctypes.byref(warps),
                                                       ctypes.byref(smem))
    if path not in BACKWARD_PATHS:
        raise ValueError(f"no backward kernel for {num_tokens} tokens of head dim {head_dim}")
    return {"path": BACKWARD_PATHS[path], "warps": warps.value, "smem_bytes": smem.value}


def _backward_kernel(qkv, dout, num_heads, softmax_f32, valid_len, bias, probe: int = 0,
                     scaled_ds: bool = False):
    """The backward kernel of qkv's dtype.  ``probe`` (0 on every path) is a
    measurement aid: the ``PROBE_*`` bits above.  ``scaled_ds``: the scale
    where ``attention_block.py`` puts it (as the plain version's argument;
    head dims 32 and 64), the mode ``fused_qkvproj_attention``'s backward
    runs.  The fp32 kernel has neither (``ValueError``)."""
    from ._build import library

    global backward_launches, backward_launches_f32
    check_gradient("dout", dout, (*qkv.shape[:2], qkv.shape[2] // 3), qkv.dtype, qkv.device)
    f32 = qkv.dtype == torch.float32
    if f32 and (probe or scaled_ds):
        raise ValueError("the fp32 backward kernel has no probe bits and no scaled_ds mode")
    B, N, three_d = qkv.shape
    head_dim = three_d // 3 // num_heads
    dqkv = torch.empty_like(qkv)
    part = dbias = None
    if bias is not None:
        part = torch.empty((B, three_d), dtype=torch.float32, device=qkv.device)
        dbias = torch.empty((three_d,), dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), None if bias is None else bias.data_ptr(), dout.data_ptr(),
            dqkv.data_ptr(), None if part is None else part.data_ptr(),
            None if dbias is None else dbias.data_ptr(), B, N, num_heads, head_dim,
            N if valid_len is None else int(valid_len), _scale(head_dim, qkv.dtype))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f32:  # one scale, the fp32 1/sqrt(hd), folds into q and scales dQ and dK
            err = library().ssl4polyp_qkv_attention_bwd_f32(*args, stream)
        else:
            err = library().ssl4polyp_qkv_attention_bwd_mode(
                *args, 1.0 / math.sqrt(head_dim), int(bool(softmax_f32)), int(bool(scaled_ds)),
                probe, stream)
    if err:
        raise RuntimeError(f"qkv_attention backward kernel launch failed: CUDA error {err}")
    if f32:
        backward_launches_f32 += 1
    else:
        backward_launches += 1
    return dqkv, None if dbias is None else dbias.to(bias.dtype)


class _QKVAttention(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True)."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, softmax_f32, valid_len, plain):
        ctx.save_for_backward(qkv, bias)
        ctx.args = (num_heads, softmax_f32, valid_len)
        ctx.plain = plain
        run = fused_qkv_attention_reference if plain else _forward_kernel
        return run(qkv, num_heads, softmax_f32, valid_len, bias)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        run = fused_qkv_attention_backward_reference if ctx.plain else _backward_kernel
        dqkv, dbias = run(qkv, dout.contiguous(), *ctx.args, bias)
        return dqkv, dbias, None, None, None, None


def fused_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    softmax_f32: bool = True,
    valid_len: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q.k^T/sqrt(hd), keys >= valid_len masked).v per head -> (B, N, D).

    The contract of :func:`fused_qkv_attention_reference`, differentiable in
    ``qkv`` and ``bias``; with ``bias`` it is the JAX
    ``fused_qkv_bias_attention``.  Rows at or past ``valid_len`` are computed
    but meaningless, as in the JAX kernel.
    """
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, softmax_f32, valid_len, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    _check(qkv, num_heads, valid_len, bias)
    return _QKVAttention.apply(qkv, bias, num_heads, softmax_f32, valid_len, False)


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    softmax_f32: bool = True,
    valid_len: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`fused_qkv_attention` through the plain versions, on any device."""
    return _QKVAttention.apply(qkv, bias, num_heads, softmax_f32, valid_len, True)
