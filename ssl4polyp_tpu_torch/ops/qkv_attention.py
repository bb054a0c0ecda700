"""Attention straight from the fused QKV projection, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/qkv_attention.py``: one CUDA kernel per
direction (``csrc/qkv_attention.cu``) covers both ``fused_qkv_attention``
and, through its ``bias`` argument, ``fused_qkv_bias_attention``, in bf16 up
to 256 tokens; past 256 tokens bf16 takes the key-tile kernels of
``csrc/qkv_attention_tiles.cu`` (a ViT-B/16 at 384 px has 577 tokens), and
fp32 tensors (the runs that compute in fp32) the fp32 kernels of
``csrc/qkv_attention_f32.cu``, each with launch counts of their own.  Both
take any number of tokens.  The bf16 backward recomputes the weights from
qkv (and the bias) alone; the fp32 backward also reads the forward's output
and each row's log-sum-exp, which the fp32 forward writes when a backward
will follow.

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

from ._checks import check_gradient, saved_or_scratch

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
    "tiles_backward_launches",
    "tiles_launches",
    "tiles_probe",
    "tiles_statistics_launches",
    "tiles_statistics_reference",
]

# Kernel launches since the last ops.reset_launch_counts(): bf16 up to
# _TILES_PAST tokens, bf16 past them (the key tiles), fp32.
launches = 0
backward_launches = 0
tiles_launches = 0
tiles_backward_launches = 0
launches_f32 = 0
backward_launches_f32 = 0
# The key tiles' statistics pass, which every key-tile backward entry point
# (this module's, attn_proj's, attention_block's and attention's) launches
# before its gradient pass: each of their wrappers counts it here.
tiles_statistics_launches = 0

_HEAD_DIMS = (16, 32, 64)
_HEAD_DIMS_F32 = (32, 64)  # the fp32 kernels' instantiations
# bf16 calls with more tokens than this take csrc/qkv_attention_tiles.cu, as
# the library's entry points route them (kTilesPast, qkv_attention_tiles.cuh).
_TILES_PAST = 256
_F32_TILE = 64  # csrc/qkv_attention_f32.cu's kTile: rows of the dbias scratch


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
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernels take bfloat16 or float32, got {qkv.dtype}")
    if N < 1:
        raise ValueError(f"the kernels take 1 or more tokens, got {N}")
    if valid_len is not None and not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside 1..{N}")
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


def _forward_kernel(qkv, num_heads, softmax_f32, valid_len, bias, lse: bool = False):
    """The forward kernel of qkv's dtype (in bf16 past ``_TILES_PAST``
    tokens the key tiles, through the same entry point).  In fp32
    ``softmax_f32`` changes nothing: the scores are fp32 either way, as in
    the plain version.  With ``lse`` (fp32 only) it returns ``(out, lse)``:
    lse (B, H, N) fp32 holds each row's log-sum-exp, which the fp32 backward
    reads."""
    from ._build import library

    global launches, launches_f32, tiles_launches
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    f32 = qkv.dtype == torch.float32
    if lse and not f32:
        raise ValueError("only the fp32 forward kernel writes the log-sum-exp")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device) if lse else None
    pointers = (qkv.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr())
    shape = (B, N, num_heads, head_dim, N if valid_len is None else int(valid_len),
             _scale(head_dim, qkv.dtype))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f32:
            err = library().ssl4polyp_qkv_attention_fwd_f32(
                *pointers, None if stats is None else stats.data_ptr(), *shape, stream)
        else:
            err = library().ssl4polyp_qkv_attention_fwd(*pointers, *shape,
                                                        int(bool(softmax_f32)), stream)
    if err:
        raise RuntimeError(f"qkv_attention kernel launch failed: CUDA error {err}")
    if f32:
        launches_f32 += 1
    elif N > _TILES_PAST:
        tiles_launches += 1
    else:
        launches += 1
    return (out, stats) if lse else out


# The bf16 backward kernel's paths (csrc/qkv_attention.cu): "stored dS" up
# to 208 tokens, "first design" from 209 to 256, "key tiles"
# (csrc/qkv_attention_tiles.cu) past 256.
BACKWARD_PATHS = {1: "stored dS", 0: "first design", 2: "key tiles"}
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


def tiles_backward_scratch(B: int, num_heads: int, N: int, head_dim: int, device):
    """The key tiles' backward's fp32 scratch (csrc/qkv_attention_tiles.cu):
    each row's (max, 1/sum, tmp), and dQ's sums in key-tile order."""
    return (torch.empty((B, num_heads, N, 4), dtype=torch.float32, device=device),
            torch.empty((B, num_heads, N, head_dim), dtype=torch.float32, device=device))


def _backward_kernel(qkv, dout, num_heads, softmax_f32, valid_len, bias, probe: int = 0,
                     scaled_ds: bool = False, out=None, lse=None):
    """The backward kernel of qkv's dtype (in bf16 past ``_TILES_PAST``
    tokens the key tiles, with their scratch).  ``probe`` (0 on every path)
    is a measurement aid: the ``PROBE_*`` bits above; neither the fp32
    kernel nor the key tiles have any (``ValueError``).  ``scaled_ds``: the
    scale where ``attention_block.py`` puts it (as the plain version's
    argument; head dims 32 and 64), the mode
    ``fused_qkvproj_attention``'s backward runs, in either dtype.  ``out`` and
    ``lse``: the fp32 forward's output and log-sum-exp (``_forward_kernel``
    with ``lse``), as the autograd path hands them over; without them the
    fp32 backward's launch runs the forward kernel into scratch first.  The
    bf16 kernel takes neither."""
    from ._build import library

    global backward_launches, backward_launches_f32, tiles_backward_launches
    global tiles_statistics_launches
    check_gradient("dout", dout, (*qkv.shape[:2], qkv.shape[2] // 3), qkv.dtype, qkv.device)
    f32 = qkv.dtype == torch.float32
    tiles = not f32 and qkv.shape[1] > _TILES_PAST
    if f32 and probe:
        raise ValueError("the fp32 backward kernel has no probe bits")
    if tiles and probe:
        raise ValueError(f"the backward past {_TILES_PAST} tokens (the key tiles) has no probe "
                         f"bits")
    if not f32 and (out is not None or lse is not None):
        raise ValueError("out and lse go to the fp32 backward kernel only")
    B, N, three_d = qkv.shape
    head_dim = three_d // 3 // num_heads
    if f32:
        out, lse, forward_first = saved_or_scratch(out, lse, (B, N, three_d // 3),
                                                   (B, num_heads, N), qkv.device)
    dqkv = torch.empty_like(qkv)
    part = dbias = None
    if bias is not None:
        rows = B * -(-N // _F32_TILE) if f32 else B
        part = torch.empty((rows, three_d), dtype=torch.float32, device=qkv.device)
        dbias = torch.empty((three_d,), dtype=torch.float32, device=qkv.device)
    bias_ptr = None if bias is None else bias.data_ptr()
    part_ptr = None if part is None else part.data_ptr()
    dbias_ptr = None if dbias is None else dbias.data_ptr()
    shape = (B, N, num_heads, head_dim, N if valid_len is None else int(valid_len),
             _scale(head_dim, qkv.dtype))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f32:  # one scale, the fp32 1/sqrt(hd), folds into q and scales dQ and dK (or dS)
            delta = torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device)
            err = library().ssl4polyp_qkv_attention_bwd_f32(
                qkv.data_ptr(), bias_ptr, dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dqkv.data_ptr(), part_ptr, dbias_ptr,
                0 if part is None else part.shape[0], *shape, int(bool(scaled_ds)),
                int(forward_first), stream)
        elif tiles:
            stats, dq_acc = tiles_backward_scratch(B, num_heads, N, head_dim, qkv.device)
            err = library().ssl4polyp_qkv_attention_tiles_bwd(
                qkv.data_ptr(), bias_ptr, dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                dq_acc.data_ptr(), part_ptr, dbias_ptr, *shape, 1.0 / math.sqrt(head_dim),
                int(bool(softmax_f32)), int(bool(scaled_ds)), stream)
        else:
            err = library().ssl4polyp_qkv_attention_bwd_mode(
                qkv.data_ptr(), bias_ptr, dout.data_ptr(), dqkv.data_ptr(), part_ptr, dbias_ptr,
                *shape, 1.0 / math.sqrt(head_dim), int(bool(softmax_f32)), int(bool(scaled_ds)),
                probe, stream)
    if err:
        raise RuntimeError(f"qkv_attention backward kernel launch failed: CUDA error {err}")
    if f32:
        backward_launches_f32 += 1
    elif tiles:
        tiles_backward_launches += 1
        tiles_statistics_launches += 1
    else:
        backward_launches += 1
    return dqkv, None if dbias is None else dbias.to(bias.dtype)


# `probe` bits of csrc/qkv_attention_tiles.cu's
# ssl4polyp_qkv_attention_tiles_fwd_probe, a measurement aid that no route
# passes: the key tiles' first design (right results), the statistics pass
# alone in place of the forward, the separate (B, H, N, hd) layout of
# ops/attention.py's fused_attention.
TILES_PROBE_FIRST_DESIGN = 1
TILES_PROBE_STATISTICS = 2
TILES_PROBE_SEPARATE = 4
_TILES_PROBE_BITS = 7


def tiles_probe(q: torch.Tensor, num_heads: int, softmax_f32: bool = True,
                valid_len: Optional[int] = None, bias: Optional[torch.Tensor] = None,
                probe: int = 0, k: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None,
                dout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The key tiles' forward or statistics pass at any N through their
    probe entry point, for timing and the card's tests; counts no launch.
    Without ``TILES_PROBE_SEPARATE`` in ``probe`` ``q`` is the fused (B, N,
    3D) bf16 qkv, with the arguments of :func:`fused_qkv_attention`; with it
    ``q``, ``k``, ``v`` are (B, H, N, hd) bf16 and the scores are fp32, times
    the fp32 1/sqrt(hd), every key weighted, no bias (``fused_attention``'s
    roundings).  Returns the output in the layout of ``q`` (of one of its
    sections), or with ``TILES_PROBE_STATISTICS`` the statistics pass's (B,
    H, N, 4) fp32 rows (max * log2(e), 1/sum, tmp, 0) for ``dout``."""
    from ._build import library

    separate = bool(probe & TILES_PROBE_SEPARATE)
    statistics = bool(probe & TILES_PROBE_STATISTICS)
    if probe & ~_TILES_PROBE_BITS:
        raise ValueError(f"unknown probe bits {probe:#x} of the key tiles' forward")
    if separate:
        if bias is not None or valid_len is not None or not softmax_f32 or k is None or v is None:
            raise ValueError("the separate layout takes q, k, v, fp32 scores, every key and no "
                             "bias")
        B, H, N, head_dim = q.shape
        out_shape, scale = q.shape, 1.0 / math.sqrt(head_dim)
    else:
        _check(q, num_heads, valid_len, bias)
        B, N, three_d = q.shape
        H, head_dim = num_heads, three_d // 3 // num_heads
        out_shape, scale = (B, N, three_d // 3), _scale(head_dim, q.dtype)
    if q.dtype != torch.bfloat16 or head_dim not in _HEAD_DIMS:
        raise ValueError(f"the key tiles take bf16 at head dims {_HEAD_DIMS}")
    if statistics:
        if dout is None:
            raise ValueError("the statistics pass reads dout")
        check_gradient("dout", dout, out_shape, q.dtype, q.device)
    out = None if statistics else torch.empty(out_shape, dtype=q.dtype, device=q.device)
    stats = torch.empty((B, H, N, 4), dtype=torch.float32, device=q.device) if statistics else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = library().ssl4polyp_qkv_attention_tiles_fwd_probe(
            q.data_ptr(), ptr(k), ptr(v), ptr(bias), ptr(dout), ptr(out), ptr(stats), B, N, H,
            head_dim, N if valid_len is None else int(valid_len), scale,
            int(bool(softmax_f32)), probe, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"key tiles' probe launch failed: CUDA error {err}")
    return stats if statistics else out


def tiles_statistics_reference(q: torch.Tensor, dout: torch.Tensor, num_heads: int,
                               softmax_f32: bool = True, valid_len: Optional[int] = None,
                               bias: Optional[torch.Tensor] = None,
                               k: Optional[torch.Tensor] = None,
                               v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the key tiles' statistics pass, in fp32: each
    query row's (max * log2(e), 1/sum, tmp, 0), (B, H, N, 4), with max the
    row's largest score, sum that of exp(score - max) and tmp = rowsum(dW *
    W), dW = dO V^T.  The scores as :func:`fused_qkv_attention_backward_reference`
    makes them for a fused qkv; with ``k`` and ``v`` (then ``q``, ``k``,
    ``v`` and ``dout`` are (B, H, N, hd)), fused_attention's: fp32 q k^T
    times the fp32 1/sqrt(hd), every key weighted."""
    if k is None:
        x = q if bias is None else q + bias
        B, N, three_d = x.shape
        head_dim = three_d // 3 // num_heads
        qh, kh, vh = x.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
        qs = qh * torch.tensor(_scale(head_dim, x.dtype), dtype=x.dtype, device=x.device)
        scores = torch.matmul(qs.float(), kh.float().transpose(-1, -2))
        do = dout.reshape(B, N, num_heads, head_dim).permute(0, 2, 1, 3).float()
    else:
        N, head_dim, vh = q.shape[2], q.shape[3], v
        scale = torch.tensor(1.0 / math.sqrt(head_dim), dtype=torch.float32)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        do = dout.float()
    if valid_len is not None and valid_len < N:
        masked = torch.arange(N, device=q.device) >= valid_len
        scores = scores.masked_fill(masked, float("-inf"))
    if not softmax_f32:
        scores = scores.to(q.dtype).float()
    top = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - top)
    total = e.sum(dim=-1, keepdim=True)
    dw = torch.matmul(do, vh.float().transpose(-1, -2))
    tmp = (dw * (e / total)).sum(dim=-1, keepdim=True)
    return torch.cat([top * math.log2(math.e), 1.0 / total, tmp, torch.zeros_like(tmp)], dim=-1)


class _QKVAttention(torch.autograd.Function):
    """The kernels (``plain`` False) or the plain versions (``plain`` True).
    The fp32 kernels' backward also takes the forward's output (the tensor
    the projection keeps anyway, saved without a copy) and log-sum-exp."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, softmax_f32, valid_len, plain):
        ctx.args = (num_heads, softmax_f32, valid_len)
        ctx.plain = plain
        saved = ()
        if plain:
            out = fused_qkv_attention_reference(qkv, num_heads, softmax_f32, valid_len, bias)
        elif qkv.dtype == torch.float32 and any(ctx.needs_input_grad[:2]):
            out, lse = _forward_kernel(qkv, num_heads, softmax_f32, valid_len, bias, lse=True)
            saved = (out, lse)
        else:
            out = _forward_kernel(qkv, num_heads, softmax_f32, valid_len, bias)
        ctx.save_for_backward(qkv, bias, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, *saved = ctx.saved_tensors
        if ctx.plain:
            dqkv, dbias = fused_qkv_attention_backward_reference(qkv, dout.contiguous(),
                                                                 *ctx.args, bias)
        else:
            out, lse = saved or (None, None)
            dqkv, dbias = _backward_kernel(qkv, dout.contiguous(), *ctx.args, bias, out=out,
                                           lse=lse)
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
    ``fused_qkv_bias_attention``.  Any number of tokens, in bf16 and in fp32
    (in bf16 past 256 on the key-tile kernels).  Rows at or past
    ``valid_len`` are computed but meaningless, as in the JAX kernel.
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
