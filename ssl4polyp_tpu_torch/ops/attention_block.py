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
:data:`BACKWARD_PROBE_FIRST_DESIGN`.  Past 256 tokens (a ViT-B/16 at 384 px
has 577) the bf16 forward writes qkv to a (B, N, 3D) scratch as the
backward's first step does, then runs the key tiles' attention forward
(``csrc/qkv_attention_tiles.cu``) with the bias; the backward's steps are
the same, its attention step on the key tiles' backward; both counted apart.
fp32 tensors (the runs that compute in fp32) take
``csrc/attention_block_f32.cu``, with launch counts of their own:
the projection on the fp32 SGEMM into a (B, N, 3D) scratch, then the fp32
attention forward with the bias, whose output and log-sum-exp autograd
saves when a backward follows; the backward recomputes the projection, runs
the fp32 attention backward with the scale inside dS (its dbias is db),
then dx and dw (split over the rows) on the SGEMM.  No model route calls
this function: as in the JAX package, where it measured slower than the
bare projection followed by the attention kernel, it is a public function
of ``ops``.

A tensor on the CPU goes through the plain torch versions
(:func:`fused_qkvproj_attention_plain`); a CUDA tensor through the kernels,
or the wrapper raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import qkv_attention
from ._checks import check_gradient, check_one_dtype, saved_or_scratch
from .qkv_attention import (
    _F32_TILE,
    _TILES_PAST,
    _scale,
    fused_qkv_attention_reference,
    tiles_backward_scratch,
)

__all__ = [
    "BACKWARD_STEPS",
    "backward_launches",
    "backward_launches_f32",
    "fused_qkvproj_attention",
    "fused_qkvproj_attention_backward_reference",
    "fused_qkvproj_attention_plain",
    "fused_qkvproj_attention_reference",
    "launches",
    "launches_f32",
    "tiles_backward_launches",
    "tiles_launches",
]

# Kernel launches since the last ops.reset_launch_counts(): forward calls,
# and backward calls (each a fixed sequence of kernels, see
# csrc/attention_block.cu and csrc/attention_block_f32.cu); bf16 up to
# _TILES_PAST tokens, bf16 past them (on the key tiles), fp32.
launches = 0
backward_launches = 0
tiles_launches = 0
tiles_backward_launches = 0
launches_f32 = 0
backward_launches_f32 = 0

# What the kernels take: bf16 or fp32, these head sizes, any number of
# tokens, an input width that is a multiple of 64.  Past _TILES_PAST tokens
# in bf16 neither direction has probe bits.
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
    check_one_dtype((x, w, b))
    if N < 1:
        raise ValueError(f"the kernels take at least one token, got {N}")
    if valid_len is not None and not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside 1..{N}")
    if b.shape != (3 * D,):
        raise ValueError(f"b {tuple(b.shape)} does not fit w {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {x.device}")


def _forward_kernel(x, w, b, num_heads, softmax_f32, valid_len, probe: int = 0,
                    keep: bool = False):
    """The forward kernel of x's dtype (in bf16 past ``_TILES_PAST`` tokens
    the projection into scratch, then the key tiles); ``probe`` (0 on every
    path) is a measurement aid of the bf16 kernel: the ``PROBE_*`` bits above
    (the fp32 kernel and the path past 256 tokens have none).  In fp32
    ``softmax_f32`` changes nothing, and with ``keep`` it returns ``(out,
    lse)``: lse (B, H, N) holds each row's log-sum-exp, which the fp32
    backward reads."""
    if probe & ~_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe & ~_PROBE_BITS:#x}")
    from ._build import library

    global launches, launches_f32, tiles_launches
    B, N, d_in = x.shape
    D = w.shape[1] // 3
    head_dim = D // num_heads
    if x.dtype == torch.float32:
        if probe:
            raise ValueError("the fp32 kernel has no probe bits")
        qkv = torch.empty((B, N, 3 * D), dtype=torch.float32, device=x.device)  # scratch
        out = torch.empty((B, N, D), dtype=torch.float32, device=x.device)
        lse = (torch.empty((B, num_heads, N), dtype=torch.float32, device=x.device) if keep
               else None)
        with torch.cuda.device(x.device):
            err = library().ssl4polyp_qkvproj_attention_fwd_f32(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), qkv.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, N, d_in, num_heads, head_dim,
                N if valid_len is None else int(valid_len), _scale(head_dim, torch.float32),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fp32 qkvproj_attention kernel launch failed: CUDA error {err}")
        launches_f32 += 1
        return (out, lse) if keep else out
    if keep:
        raise ValueError("only the fp32 kernel keeps the log-sum-exp")
    out = torch.empty((B, N, D), dtype=x.dtype, device=x.device)
    tiles = N > _TILES_PAST
    if tiles and probe:
        raise ValueError(f"the forward past {_TILES_PAST} tokens has no probe bits")
    # Scratch past _TILES_PAST tokens: W^T and round(x . W).
    w_t = torch.empty((3 * D, d_in), dtype=x.dtype, device=x.device) if tiles else None
    qkv = torch.empty((B, N, 3 * D), dtype=x.dtype, device=x.device) if tiles else None
    with torch.cuda.device(x.device):
        err = library().ssl4polyp_qkvproj_attention_fwd_probe(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None if w_t is None else w_t.data_ptr(),
            None if qkv is None else qkv.data_ptr(), out.data_ptr(), B, N, d_in, num_heads,
            head_dim, N if valid_len is None else int(valid_len), _scale(head_dim, x.dtype),
            int(bool(softmax_f32)), probe, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"qkvproj_attention kernel launch failed: CUDA error {err}")
    if tiles:
        tiles_launches += 1
    else:
        launches += 1
    return out


def _backward_kernel(x, w, b, dout, num_heads, softmax_f32, valid_len, probe: int = 0,
                     out=None, lse=None):
    """(dx, dw, db) from the backward's launches of x's dtype.  ``probe`` (0
    on every path) is a measurement aid of the bf16 kernels: the
    ``BACKWARD_*`` bits above; past ``_TILES_PAST`` tokens the steps alone
    (the first design takes at most 256, ``ValueError``), counted apart.  The
    fp32 backward (:func:`_backward_f32`) also takes the forward's output and
    log-sum-exp (``out`` and ``lse``, from ``_forward_kernel`` with
    ``keep``)."""
    global backward_launches, tiles_backward_launches
    if x.dtype == torch.float32:
        if probe:
            raise ValueError("the fp32 backward kernel has no probe bits")
        return _backward_f32(x, w, b, dout, num_heads, valid_len, out, lse)
    if out is not None or lse is not None:
        raise ValueError("out and lse go to the fp32 backward kernel only")
    if probe & ~_BACKWARD_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe & ~_BACKWARD_PROBE_BITS:#x}")
    first_design = bool(probe & BACKWARD_PROBE_FIRST_DESIGN)
    tiles = x.shape[1] > _TILES_PAST
    if tiles and first_design:
        raise ValueError(f"the backward's first design takes at most {_TILES_PAST} tokens")
    run, results = _backward_plan(x, w, b, dout, num_heads, softmax_f32, valid_len, first_design)
    steps = probe & ~BACKWARD_PROBE_FIRST_DESIGN
    run(steps)
    if tiles:
        tiles_backward_launches += 1
        if not steps or steps & BACKWARD_STEPS["attention"]:
            qkv_attention.tiles_statistics_launches += 1
    else:
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
    stats, dq_acc = (tiles_backward_scratch(B, num_heads, N, head_dim, dev) if N > _TILES_PAST
                     else (None, None))

    design = BACKWARD_PROBE_FIRST_DESIGN if first_design else 0

    def run(steps: int) -> None:
        if steps & ~sum(BACKWARD_STEPS.values()):
            raise ValueError(f"unknown steps {steps:#x}")
        with torch.cuda.device(dev):
            err = lib.ssl4polyp_qkvproj_attention_bwd_probe(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), dout.data_ptr(), w_t.data_ptr(),
                qkv.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), db.data_ptr(), dx.data_ptr(),
                dw_part.data_ptr(), dw.data_ptr(), None if stats is None else stats.data_ptr(),
                None if dq_acc is None else dq_acc.data_ptr(), B, N, d_in, num_heads, head_dim,
                N if valid_len is None else int(valid_len), _scale(head_dim, x.dtype),
                1.0 / math.sqrt(head_dim), int(bool(softmax_f32)), slices, steps | design,
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"qkvproj_attention backward kernel launch failed: CUDA error {err}")

    return run, lambda: (dx, dw.to(w.dtype), db.to(b.dtype))


def _backward_f32(x, w, b, dout, num_heads, valid_len, out, lse):
    """The fp32 backward's one counted launch (csrc/attention_block_f32.cu):
    qkv = x . w again, the fp32 attention backward with the scale inside dS
    and b as its bias (its dbias is db) from the forward's output and
    log-sum-exp, dx, then dw split over the rows; without ``out`` and ``lse``
    the attention forward runs first into scratch."""
    from ._build import library

    global backward_launches_f32
    B, N, d_in = x.shape
    three_d = w.shape[1]
    D = three_d // 3
    head_dim = D // num_heads
    dev = x.device
    check_gradient("dout", dout, (B, N, D), torch.float32, dev)
    out, lse, forward_first = saved_or_scratch(out, lse, (B, N, D), (B, num_heads, N), dev)
    lib = library()
    with torch.cuda.device(dev):
        slices = lib.ssl4polyp_sgemm_f32_slices(d_in, three_d, B * N)
    if slices < 1:
        raise RuntimeError(f"fp32 qkvproj_attention backward: CUDA error {-slices}")
    f32 = dict(dtype=torch.float32, device=dev)
    qkv = torch.empty((B, N, three_d), **f32)                  # scratch: x . w
    delta = torch.empty((B, num_heads, N), **f32)              # scratch
    dqkv = torch.empty_like(qkv)                               # scratch
    db_part = torch.empty((B * -(-N // _F32_TILE), three_d), **f32)
    db = torch.empty((three_d,), **f32)
    dx = torch.empty_like(x)
    dw_part = torch.empty((slices, d_in, three_d), **f32) if slices > 1 else None
    dw = torch.empty((d_in, three_d), **f32)
    with torch.cuda.device(dev):
        err = lib.ssl4polyp_qkvproj_attention_bwd_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), dout.data_ptr(), out.data_ptr(),
            lse.data_ptr(), qkv.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
            db_part.data_ptr(), db.data_ptr(), dx.data_ptr(),
            None if dw_part is None else dw_part.data_ptr(), dw.data_ptr(), B, N, d_in,
            num_heads, head_dim, N if valid_len is None else int(valid_len),
            _scale(head_dim, torch.float32), slices, int(forward_first),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fp32 qkvproj_attention backward kernel launch failed: CUDA error "
                           f"{err}")
    backward_launches_f32 += 1
    return dx, dw.to(w.dtype), db.to(b.dtype)


class _QKVProjAttention(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True).
    The fp32 kernels' backward also takes the forward's output (saved without
    a copy) and log-sum-exp, saved when a backward will follow."""

    @staticmethod
    def forward(ctx, x, w, b, num_heads, softmax_f32, valid_len, plain):
        ctx.args = (num_heads, softmax_f32, valid_len)
        ctx.plain = plain
        saved = ()
        if plain:
            out = fused_qkvproj_attention_reference(x, w, b, num_heads, softmax_f32, valid_len)
        elif x.dtype == torch.float32 and any(ctx.needs_input_grad[:3]):
            out, lse = _forward_kernel(x, w, b, num_heads, softmax_f32, valid_len, keep=True)
            saved = (out, lse)
        else:
            out = _forward_kernel(x, w, b, num_heads, softmax_f32, valid_len)
        ctx.save_for_backward(x, w, b, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, b, *saved = ctx.saved_tensors
        if ctx.plain:
            dx, dw, db = fused_qkvproj_attention_backward_reference(x, w, b, dout.contiguous(),
                                                                    *ctx.args)
        else:
            out, lse = saved or (None, None)
            dx, dw, db = _backward_kernel(x, w, b, dout.contiguous(), *ctx.args, out=out,
                                          lse=lse)
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
    zero.  On the card the kernels take contiguous bfloat16 or float32
    tensors of one dtype, any number of tokens, a head dim of 32 or 64 and
    a Din that is a multiple of 64, and raise on anything else.
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
