"""The QKV projection and the attention core in one kernel, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attention_block.py``::

    fused_qkvproj_attention(x, w, b) = attention_core(x @ w + b)

with ``w`` (Din, 3D) in the JAX package's (in, out) layout, its columns
``[q heads | k heads | v heads]``.  On the card the (B, N, 3D) QKV tensor
never reaches device memory in either direction (``csrc/attention_block.cu``);
the backward recomputes it and returns dx, dw and db from hand-written
kernels alone (``dx = dqkv @ w.T`` and ``dw = x.T @ dqkv`` included).  No
model route calls this function: as in the JAX package, where it measured
slower than the bare projection followed by the attention kernel, it is a
public function of ``ops``.

A tensor on the CPU goes through the plain torch versions
(:func:`fused_qkvproj_attention_plain`); a CUDA tensor through the kernels,
or the wrapper raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .qkv_attention import _MAX_TOKENS, _scale, fused_qkv_attention_reference

__all__ = [
    "backward_launches",
    "fused_qkvproj_attention",
    "fused_qkvproj_attention_backward_reference",
    "fused_qkvproj_attention_plain",
    "fused_qkvproj_attention_reference",
    "launches",
]

# Kernel launches since the last ops.reset_launch_counts(): forward calls,
# and backward calls (each a fixed sequence of kernels, see
# csrc/attention_block.cu).
launches = 0
backward_launches = 0

# What the kernels take: bf16, these head sizes, 1..256 tokens, an input
# width that is a multiple of 64.
_HEAD_DIMS = (32, 64)
# Row slices of the backward's dW sum: 64 x 64 tiles of dW times this many
# slices are the blocks that fill the card (864 at 768 x 2304).
_DW_SLICES = 2


def _project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """qkv as the kernel forms it: the fp32 product rounded to the compute
    dtype, then the bias added in the compute dtype (two roundings)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype) + b.to(x.dtype)


def fused_qkvproj_attention_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain torch version of the forward kernel, same roundings: the
    projection of :func:`_project`, then the attention core of
    ``fused_qkv_attention_reference``.  Returns (B, N, D)."""
    return fused_qkv_attention_reference(_project(x, w, b), num_heads, softmax_f32, valid_len)


def fused_qkvproj_attention_backward_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dout: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward, with the JAX kernel's steps and
    roundings (``_bwd_kernel``): qkv recomputed; the weights W in fp32 from
    the compute-dtype scale fold in q; dV = round(W)^T dO; dS = round(W *
    (dW - tmp) * scale), the fp32 scale inside the rounding; dQ = dS K and
    dK = dS^T Q with the unscaled k and q; dqkv rounded to the compute dtype;
    dx = round(dqkv . w^T); dw = x^T dqkv and db = sum of dqkv in fp32 over
    every row of the batch.  Returns dx, dw in ``w``'s dtype, db in ``b``'s."""
    dtype = x.dtype
    B, N, d_in = x.shape
    three_d = w.shape[1]
    D = three_d // 3
    head_dim = D // num_heads
    qkv = _project(x, w, b)
    q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    q_s = q * torch.tensor(_scale(head_dim, dtype), dtype=dtype, device=x.device)
    scores = torch.matmul(q_s.float(), k.float().transpose(-1, -2))
    if valid_len is not None and valid_len < N:
        scores = scores.masked_fill(torch.arange(N, device=x.device) >= valid_len, float("-inf"))
    if not softmax_f32:
        scores = scores.to(dtype).float()
    weights = torch.softmax(scores, dim=-1)
    do = dout.reshape(B, N, num_heads, head_dim).permute(0, 2, 1, 3).float()
    dv = torch.matmul(weights.to(dtype).float().transpose(-1, -2), do)
    dw_scores = torch.matmul(do, v.float().transpose(-1, -2))
    tmp = (dw_scores * weights).sum(dim=-1, keepdim=True)
    ds = (weights * (dw_scores - tmp) * (1.0 / math.sqrt(head_dim))).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dqkv = torch.stack([dq, dk, dv]).to(dtype)  # (3, B, H, N, hd)
    dqkv2 = dqkv.permute(1, 3, 0, 2, 4).reshape(B * N, three_d).float()
    dx = torch.matmul(dqkv2, w.float().t()).to(dtype).reshape(x.shape)
    dw = torch.matmul(x.reshape(B * N, d_in).float().t(), dqkv2)
    return dx, dw.to(w.dtype), dqkv2.sum(dim=0).to(b.dtype)


def _check(x, w, b, num_heads, valid_len) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2] or w.shape[1] % 3:
        raise ValueError(f"x must be (B, N, Din) and w (Din, 3D), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    _, N, d_in = x.shape
    D = w.shape[1] // 3
    if D % num_heads or D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D / num_heads} not in {_HEAD_DIMS}")
    if d_in % 64:
        raise ValueError(f"the kernel takes an input width that is a multiple of 64, got {d_in}")
    if not 1 <= N <= _MAX_TOKENS:
        raise ValueError(f"the kernel takes 1..{_MAX_TOKENS} tokens, got {N}")
    if valid_len is not None and not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside 1..{N}")
    if b.shape != (3 * D,):
        raise ValueError(f"b {tuple(b.shape)} does not fit w {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16, got {name} {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {x.device}")


def _forward_kernel(x, w, b, num_heads, softmax_f32, valid_len):
    from ._build import library

    global launches
    B, N, d_in = x.shape
    D = w.shape[1] // 3
    head_dim = D // num_heads
    out = torch.empty((B, N, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = library().ssl4polyp_qkvproj_attention_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, d_in, num_heads,
            head_dim, N if valid_len is None else int(valid_len), _scale(head_dim, x.dtype),
            int(bool(softmax_f32)), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"qkvproj_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _backward_kernel(x, w, b, dout, num_heads, softmax_f32, valid_len):
    from ._build import library

    global backward_launches
    B, N, d_in = x.shape
    three_d = w.shape[1]
    D = three_d // 3
    head_dim = D // num_heads
    if dout.shape != (B, N, D) or dout.dtype != x.dtype or not dout.is_contiguous():
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not fit x "
                         f"{tuple(x.shape)} {x.dtype} and w {tuple(w.shape)}")
    dev = x.device
    dqkv = torch.empty((B, N, three_d), dtype=x.dtype, device=dev)  # scratch: round(dqkv)
    db_part = torch.empty((B, three_d), dtype=torch.float32, device=dev)
    db = torch.empty((three_d,), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dw_part = torch.empty((_DW_SLICES, d_in, three_d), dtype=torch.float32, device=dev)
    dw = torch.empty((d_in, three_d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().ssl4polyp_qkvproj_attention_bwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            db_part.data_ptr(), db.data_ptr(), dx.data_ptr(), dw_part.data_ptr(), dw.data_ptr(),
            B, N, d_in, num_heads, head_dim, N if valid_len is None else int(valid_len),
            _scale(head_dim, x.dtype), 1.0 / math.sqrt(head_dim), int(bool(softmax_f32)),
            _DW_SLICES, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"qkvproj_attention backward kernel launch failed: CUDA error {err}")
    backward_launches += 1
    return dx, dw.to(w.dtype), db.to(b.dtype)


class _QKVProjAttention(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True)."""

    @staticmethod
    def forward(ctx, x, w, b, num_heads, softmax_f32, valid_len, plain):
        ctx.save_for_backward(x, w, b)
        ctx.args = (num_heads, softmax_f32, valid_len)
        ctx.plain = plain
        run = fused_qkvproj_attention_reference if plain else _forward_kernel
        return run(x, w, b, num_heads, softmax_f32, valid_len)

    @staticmethod
    def backward(ctx, dout):
        x, w, b = ctx.saved_tensors
        run = fused_qkvproj_attention_backward_reference if ctx.plain else _backward_kernel
        dx, dw, db = run(x, w, b, dout.contiguous(), *ctx.args)
        return dx, dw, db, None, None, None, None


def fused_qkvproj_attention(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """``attention_core(x @ w + b)`` -> (B, N, D), differentiable in ``x``,
    ``w`` and ``b``.

    ``x`` (B, N, Din) is the post-LayerNorm activation, ``w`` (Din, 3D) and
    ``b`` (3D,) the fused QKV projection in the compute dtype; keys at or past
    ``valid_len`` are masked out of the softmax.  Rows at or past
    ``valid_len`` are computed but meaningless; their upstream gradient is
    zero.  On the card the kernels take contiguous bfloat16 tensors, a head
    dim of 32 or 64, 1..256 tokens and a Din that is a multiple of 64, and
    raise on anything else.
    """
    if x.device.type == "cpu":
        return fused_qkvproj_attention_plain(x, w, b, num_heads, softmax_f32, valid_len)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w, b, num_heads, valid_len)
    return _QKVProjAttention.apply(x, w, b, num_heads, softmax_f32, valid_len, False)


def fused_qkvproj_attention_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
    softmax_f32: bool = True, valid_len: Optional[int] = None,
) -> torch.Tensor:
    """:func:`fused_qkvproj_attention` through the plain versions, on any device."""
    return _QKVProjAttention.apply(x, w, b, num_heads, softmax_f32, valid_len, True)
