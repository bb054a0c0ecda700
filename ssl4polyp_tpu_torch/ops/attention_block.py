"""The QKV projection and the attention core in one kernel, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/attention_block.py``::

    fused_qkvproj_attention(x, w, b) = attention_core(x @ w + b)

with ``w`` (Din, 3D) in the JAX package's (in, out) layout, its columns
``[q heads | k heads | v heads]``.  On the card (``csrc/attention_block.cu``)
the forward never writes the (B, N, 3D) QKV tensor to device memory: it
runs the projection and the attention core in one kernel, on wgmma from TMA
loads.  The backward recomputes the projection, without its bias, into a
(B, N, 3D) scratch of device memory, and runs four hand-written steps on
kernels designed for the card: that product and ``dx = dqkv @ w.T`` on the
wgmma GEMM, the attention backward (``qkv_attention.py``'s kernel, with the
bias and the scale where this function's TPU kernel puts them), and ``dw =
x.T @ dqkv`` on a wgmma product with both operands transposed.  The first
designs of both directions stay behind :data:`PROBE_FIRST_DESIGN` and
:data:`BACKWARD_PROBE_FIRST_DESIGN`.  No model route calls this function:
as in the JAX package, where it measured slower than the bare projection
followed by the attention kernel, it is a public function of ``ops``.

A tensor on the CPU goes through the plain torch versions
(:func:`fused_qkvproj_attention_plain`); a CUDA tensor through the kernels,
or the wrapper raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ._checks import FP32_PUBLIC_FUNCTIONS, check_bf16, check_gradient
from .qkv_attention import _MAX_TOKENS, _scale, fused_qkv_attention_reference

__all__ = [
    "BACKWARD_STEPS",
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
# `probe` bits of the forward kernel, a measurement aid (0 on every path;
# chip_smoke.py times the kernel with parts left out, whose results are
# wrong): no softmax arithmetic (the scores rounded straight into the
# weights), no projection products (q, k and v the bias alone), no prefetch
# of the next unit's loads; and two with right results: the first design,
# and the projection alone (each head's q, before the scale fold, written
# into its columns of the output).
PROBE_NO_SOFTMAX = 1
PROBE_NO_PROJECTION = 2
PROBE_NO_PREFETCH = 4
PROBE_FIRST_DESIGN = 8
PROBE_PROJECTION_ONLY = 16
_PROBE_BITS = 31
# `probe` bits of the backward, a measurement aid (0 on every path): the
# first design (its dW on 2 row slices, 3D a multiple of 64); and the
# launches to run alone (none set: all), each reading what the earlier ones
# left in one plan's buffers (:func:`_backward_plan`).  The first design has
# no transpose or projection launch.
BACKWARD_PROBE_FIRST_DESIGN = 1
BACKWARD_STEPS = {"transpose": 2, "projection": 4, "attention": 8, "db sum": 16, "dx": 32,
                  "dw": 64, "dw sum": 128}
_BACKWARD_PROBE_BITS = 255
_FIRST_DESIGN_DW_SLICES = 2


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
        check_bf16(name, t.dtype, FP32_PUBLIC_FUNCTIONS)
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {x.device}")


def _forward_kernel(x, w, b, num_heads, softmax_f32, valid_len, probe: int = 0):
    """The forward kernel; ``probe`` (0 on every path) is a measurement aid:
    the ``PROBE_*`` bits above."""
    if probe & ~_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe & ~_PROBE_BITS:#x}")
    from ._build import library

    global launches
    B, N, d_in = x.shape
    D = w.shape[1] // 3
    head_dim = D // num_heads
    out = torch.empty((B, N, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = library().ssl4polyp_qkvproj_attention_fwd_probe(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, d_in, num_heads,
            head_dim, N if valid_len is None else int(valid_len), _scale(head_dim, x.dtype),
            int(bool(softmax_f32)), probe, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"qkvproj_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _backward_kernel(x, w, b, dout, num_heads, softmax_f32, valid_len, probe: int = 0):
    """(dx, dw, db) from the backward's launches.  ``probe`` (0 on every
    path) is a measurement aid: the ``BACKWARD_*`` bits above."""
    global backward_launches
    if probe & ~_BACKWARD_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe & ~_BACKWARD_PROBE_BITS:#x}")
    first_design = bool(probe & BACKWARD_PROBE_FIRST_DESIGN)
    run, results = _backward_plan(x, w, b, dout, num_heads, softmax_f32, valid_len, first_design)
    run(probe & ~BACKWARD_PROBE_FIRST_DESIGN)
    backward_launches += 1
    return results()


def _backward_plan(x, w, b, dout, num_heads, softmax_f32, valid_len, first_design=False):
    """Allocates the backward's scratch and results once and returns
    ``(run, results)``: ``run(steps)`` launches the steps of the mask
    (:data:`BACKWARD_STEPS`; 0 all of them) of the first design or the
    second, a later launch reading what the earlier ones left in the
    scratch, and ``results()`` returns (dx, dw, db).  No launch is counted
    here."""
    B, N, d_in = x.shape
    three_d = w.shape[1]
    D = three_d // 3
    head_dim = D // num_heads
    check_gradient("dout", dout, (B, N, D), x.dtype, x.device)
    from ._build import library

    lib = library()
    dev = x.device
    if first_design:
        slices = _FIRST_DESIGN_DW_SLICES
    else:
        with torch.cuda.device(dev):
            slices = lib.ssl4polyp_dw_product_slices(B * N, d_in, three_d)
        if slices < 1:
            raise RuntimeError(f"qkvproj_attention backward: CUDA error {-slices}")
    w_t = torch.empty((three_d, d_in), dtype=x.dtype, device=dev)      # scratch: W^T
    qkv = torch.empty((B, N, three_d), dtype=x.dtype, device=dev)      # scratch: round(x . W)
    dqkv = torch.empty_like(qkv)                                       # scratch: round(dqkv)
    db_part = torch.empty((B, three_d), dtype=torch.float32, device=dev)
    db = torch.empty((three_d,), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dw_part = torch.empty((slices, d_in, three_d), dtype=torch.float32, device=dev)
    dw = torch.empty((d_in, three_d), dtype=torch.float32, device=dev)

    design = BACKWARD_PROBE_FIRST_DESIGN if first_design else 0

    def run(steps: int) -> None:
        if steps & ~sum(BACKWARD_STEPS.values()):
            raise ValueError(f"unknown steps {steps:#x}")
        with torch.cuda.device(dev):
            err = lib.ssl4polyp_qkvproj_attention_bwd_probe(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), dout.data_ptr(), w_t.data_ptr(),
                qkv.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), db.data_ptr(), dx.data_ptr(),
                dw_part.data_ptr(), dw.data_ptr(), B, N, d_in, num_heads, head_dim,
                N if valid_len is None else int(valid_len), _scale(head_dim, x.dtype),
                1.0 / math.sqrt(head_dim), int(bool(softmax_f32)), slices, steps | design,
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"qkvproj_attention backward kernel launch failed: CUDA error {err}")

    return run, lambda: (dx, dw.to(w.dtype), db.to(b.dtype))


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
