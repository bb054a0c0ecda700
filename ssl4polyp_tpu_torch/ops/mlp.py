"""The transformer MLP's kernels, differentiable.

Counterparts of ``ssl4polyp_tpu/ops/mlp.py``: ``fc1_gelu`` (the first
linear with its exact-erf GELU), ``mlp_fused`` (fc1 + GELU + fc2 in one
kernel, gelu(h) never in HBM) and ``mlp_ln_fused`` (the pre-norm block's
second half, ``x + mlp(LN(x))``, in one kernel).  The CUDA kernels are in
``csrc/mlp.cu``, and fc1+GELU's fp32 kernel, for the runs that compute in
fp32, in ``csrc/fc1_gelu_f32.cu``; the fused kernels take bf16 only.
Weights are in torch's (out, in) layout.  When a gradient
is needed, each forward also writes the pre-activation h (the JAX kernels'
residual), and the backwards (:func:`fc1_gelu_backward`,
:func:`mlp_fused_backward`, :func:`mlp_ln_fused_backward`) take the JAX
VJPs' steps, which the JAX package leaves to XLA: cuBLAS products and torch
elementwise ops, and on the kernel path :func:`mlp_ln_fused_backward`'s two
LayerNorm steps run on the LayerNorm kernels (``ln_linear.py``).

A tensor on the CPU goes through the plain torch versions
(:func:`fc1_gelu_reference`, :func:`mlp_fused_reference`,
:func:`mlp_ln_fused_reference`); a CUDA tensor goes through the kernels, or
the wrapper raises.  The ``*_plain`` functions run the plain versions on any
device, to compare the kernels with.  The fused plain versions compute their
products in fp32 from the rounded operands, which keeps the kernels'
roundings exactly; the plain fc1 rounds its product before the bias add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._checks import FP32_FUSION_KNOBS, check_bf16
from .ln_linear import layernorm_backward, normalised_row

__all__ = [
    "fc1_gelu",
    "fc1_gelu_backward",
    "fc1_gelu_plain",
    "fc1_gelu_reference",
    "fused_launches",
    "launches",
    "launches_f32",
    "ln_fused_launches",
    "mlp_fused",
    "mlp_fused_backward",
    "mlp_fused_plain",
    "mlp_fused_reference",
    "mlp_ln_fused",
    "mlp_ln_fused_backward",
    "mlp_ln_fused_plain",
    "mlp_ln_fused_reference",
]

# Kernel launches since the last ops.reset_launch_counts(): fc1+GELU in bf16
# and in fp32, the fused MLP and the fused LN+MLP.
launches = 0
launches_f32 = 0
fused_launches = 0
ln_fused_launches = 0

_FUSED_K = (512, 768)  # the fused kernel's instantiations: the MAE decoder's and ViT-B's widths
_FUSED_TILE = 32  # NF is a multiple of this (the kernel walks NF in chunks of 64, the last may be half)
# `probe` bits of the fused kernel, a measurement aid (0 on every path;
# chip_smoke.py times the kernel with parts left out, whose results are
# wrong): no fc2 products, no fc1 epilogue (bias, GELU, h and g), no fc1
# products, no W loads; clusters of 4 blocks or of 1 (no multicast of W;
# right results); the first design (right results).
FUSED_PROBE_NO_FC2 = 1
FUSED_PROBE_NO_EPILOGUE = 2
FUSED_PROBE_NO_FC1 = 4
FUSED_PROBE_NO_LOADS = 8
FUSED_PROBE_CLUSTER_4 = 16
FUSED_PROBE_CLUSTER_1 = 32
FUSED_PROBE_FIRST_DESIGN = 64


def _pre_activation(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.t()) + b


def fc1_gelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w.T + b)`` with the exact erf, in plain torch."""
    return F.gelu(_pre_activation(x, w, b), approximate="none")


def fc1_gelu_backward(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                      dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``fc1_gelu`` VJP (``mlp.py::_bwd``) from the saved h.

    dh = dy * (Phi(h) + h phi(h)) in fp32, rounded once to the compute
    dtype; dx = dh.w and dw = dh^T.x with fp32 accumulation, in the compute
    dtype; db the fp32 sum of dh, then the compute dtype.  torch's
    ``gelu_backward`` (the exact-erf GELU's derivative, in fp32 for bf16
    inputs) takes dh in one pass where XLA fuses the same chain.
    """
    dh = torch.ops.aten.gelu_backward(dy, h, approximate="none")
    dx = torch.matmul(dh, w.to(dh.dtype))
    dw = torch.matmul(dh.t(), x).to(w.dtype)
    db = dh.sum(dim=0, dtype=torch.float32).to(dh.dtype)
    return dx, dw, db


def _check(x, w, b) -> None:
    tensors = (x, w, b)
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(
            f"fc1_gelu takes x (M, K), w (NF, K), b (NF,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}"
        )
    (m, k), (nf, k_w) = x.shape, w.shape
    if k_w != k or b.shape[0] != nf:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if k % 8 or nf % 8 or m < 1:
        raise ValueError(f"the kernel takes K and NF that are multiples of 8, got {k}, {nf}")
    for t in tensors:
        # One kernel a dtype: x, w and b all bf16, or all fp32.
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != x.dtype:
            raise TypeError(f"the kernels take bfloat16 or float32 operands of one dtype, got "
                            f"{[u.dtype for u in tensors]}")
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fc1_gelu's operands must be contiguous and 16-byte aligned")


def _kernel(x, w, b, write_h: bool):
    """(h or None, y) from the CUDA kernel of x's dtype: bf16 (``mlp.cu``) or
    fp32 (``fc1_gelu_f32.cu``)."""
    from ._build import library

    global launches, launches_f32
    m, k = x.shape
    nf = w.shape[0]
    y = torch.empty((m, nf), dtype=x.dtype, device=x.device)
    h = torch.empty_like(y) if write_h else None
    f32 = x.dtype == torch.float32
    lib = library()
    run = lib.ssl4polyp_fc1_gelu_fwd_f32 if f32 else lib.ssl4polyp_fc1_gelu_fwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = run(x.data_ptr(), w.data_ptr(), b.data_ptr(), None if h is None else h.data_ptr(),
                  y.data_ptr(), m, k, nf, stream)
    if err:
        raise RuntimeError(f"fc1_gelu kernel launch failed: CUDA error {err}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return h, y


class _Fc1Gelu(torch.autograd.Function):
    """The kernel (``plain`` False) or the plain version (``plain`` True),
    saving h for :func:`fc1_gelu_backward`."""

    @staticmethod
    def forward(ctx, x, w, b, plain):
        if plain:
            h = _pre_activation(x, w, b)
            y = F.gelu(h, approximate="none")
        else:
            h, y = _kernel(x, w, b, write_h=True)
        ctx.save_for_backward(x, w, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, h = ctx.saved_tensors
        return (*fc1_gelu_backward(x, w, h, dy), None)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fc1_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(x . w^T + b)`` for 2-D ``x``: fp32 accumulation, bias and GELU in
    fp32, one rounding to the compute dtype; differentiable in x, w and b.
    On the card x, w and b are all bfloat16 or all float32, each dtype with
    its own kernel."""
    if x.device.type == "cpu":
        return fc1_gelu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w, b)
    if _needs_grad(x, w, b):
        return _Fc1Gelu.apply(x, w, b, False)
    return _kernel(x, w, b, write_h=False)[1]


def fc1_gelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`fc1_gelu` through the plain version, on any device."""
    if _needs_grad(x, w, b):
        return _Fc1Gelu.apply(x, w, b, True)
    return fc1_gelu_reference(x, w, b)


# ---------------------------------------------------------------------------
# The whole MLP in one kernel, optionally behind a LayerNorm prologue.
# ---------------------------------------------------------------------------


def _mlp_forward_plain(x, s, t, w1, b1, w2, b2, eps):
    """(h, out) of the fused kernels in plain torch: h = x.w1^T + b1 in fp32
    (rounded for the backward), g = gelu(h) rounded, out = g.w2^T + b2 in
    fp32, rounded once; with ``s`` (the LN variant) x is first replaced by
    its normalised row m and the residual is added: out = (x + acc) + b2."""
    dtype = x.dtype
    a = x if s is None else normalised_row(x, s, t, eps)
    h = torch.matmul(a.float(), w1.float().t()) + b1.float()
    g = F.gelu(h, approximate="none").to(dtype)
    acc = torch.matmul(g.float(), w2.float().t())
    if s is not None:
        acc = x.float() + acc
    return h.to(dtype), (acc + b2.float()).to(dtype)


def mlp_fused_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """``gelu(x.w1^T + b1).w2^T + b2`` in plain torch, the kernel's roundings."""
    return _mlp_forward_plain(x, None, None, w1, b1, w2, b2, 0.0)[1]


def mlp_ln_fused_reference(x, s, t, w1, b1, w2, b2, eps: float = 1e-6) -> torch.Tensor:
    """``x + gelu(LN(x).w1^T + b1).w2^T + b2`` in plain torch, the kernel's roundings."""
    return _mlp_forward_plain(x, s, t, w1, b1, w2, b2, eps)[1]


def _fc2_backward(w2, h, dy):
    """(dg, dw2, db2) of ``g.w2^T + b2`` with g recomputed from the saved h
    (the JAX ``_mlp_bwd``): g = gelu(h) in fp32, rounded; dw2 = dy^T g with
    fp32 accumulation; db2 the fp32 sum of dy; dg = dy.w2 in the compute dtype."""
    g = F.gelu(h.float(), approximate="none").to(dy.dtype)
    dw2 = torch.matmul(dy.t(), g).to(w2.dtype)
    db2 = dy.sum(dim=0, dtype=torch.float32).to(dy.dtype)
    return torch.matmul(dy, w2.to(dy.dtype)), dw2, db2


def mlp_fused_backward(x, w1, w2, h, dy):
    """The JAX ``mlp_fused`` VJP (``mlp.py::_mlp_bwd``) from the saved h:
    (dx, dw1, db1, dw2, db2)."""
    dg, dw2, db2 = _fc2_backward(w2, h, dy)
    return (*fc1_gelu_backward(x, w1, h, dg), dw2, db2)


def mlp_ln_fused_backward(x, s, t, w1, w2, h, dy, eps: float, plain: bool = True):
    """The JAX ``mlp_ln_fused`` VJP (``mlp.py::_mlp_ln_bwd``): m recomputed in
    the compute dtype, the MLP's backward onto it, the LayerNorm backward in
    fp32, and + dy, the residual's identity path, before dx's one rounding.
    Returns (dx, dscale, dbias, dw1, db1, dw2, db2)."""
    m = normalised_row(x, s, t, eps, plain)
    dg, dw2, db2 = _fc2_backward(w2, h, dy)
    dm, dw1, db1 = fc1_gelu_backward(m, w1, h, dg)
    return (*layernorm_backward(x, s, dm, eps, plain, dres=dy), dw1, db1, dw2, db2)


def _check_fused(x, s, t, w1, b1, w2, b2) -> None:
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 or b1.dim() != 1 or b2.dim() != 1:
        raise ValueError(
            f"the fused MLP takes x (M, K), w1 (NF, K), b1 (NF,), w2 (K, NF), b2 (K,); got "
            f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}, "
            f"{tuple(b2.shape)}")
    (m, k), (nf, k_w) = x.shape, w1.shape
    if k_w != k or w2.shape != (k, nf) or b1.shape[0] != nf or b2.shape[0] != k:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if k not in _FUSED_K or nf % _FUSED_TILE or m < 1:
        raise ValueError(f"the fused kernel takes K in {_FUSED_K} and NF a multiple of "
                         f"{_FUSED_TILE}, got K {k}, NF {nf}")
    named = [("x", x, torch.bfloat16), ("w1", w1, torch.bfloat16), ("b1", b1, torch.bfloat16),
             ("w2", w2, torch.bfloat16), ("b2", b2, torch.bfloat16)]
    if s is not None:
        if s.shape != (k,) or t.shape != (k,):
            raise ValueError(f"the LayerNorm affine must be ({k},), got {tuple(s.shape)}, "
                             f"{tuple(t.shape)}")
        named += [("s", s, torch.float32), ("t", t, torch.float32)]
    for name, tensor, dtype in named:
        if dtype == torch.bfloat16:
            check_bf16(name, tensor.dtype, FP32_FUSION_KNOBS)
        elif tensor.dtype != dtype:
            raise TypeError(f"the kernel takes a {dtype} {name}, got {tensor.dtype}")
        if tensor.device != x.device:
            raise ValueError(f"tensors on {x.device} and {tensor.device}")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"the fused MLP's {name} must be contiguous and 16-byte aligned")


def _fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h: bool, probe: int = 0):
    """(h or None, out) from the CUDA kernel; the LN variant when ``s`` is
    given.  ``probe`` (0 on every path) is a measurement aid: the
    ``FUSED_PROBE_*`` bits above."""
    from ._build import library

    global fused_launches, ln_fused_launches
    m, k = x.shape
    nf = w1.shape[0]
    out = torch.empty_like(x)
    h = torch.empty((m, nf), dtype=x.dtype, device=x.device) if write_h else None
    with torch.cuda.device(x.device):
        err = library().ssl4polyp_mlp_fused_probe(
            x.data_ptr(), None if s is None else s.data_ptr(), None if t is None else t.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if h is None else h.data_ptr(), out.data_ptr(), m, k, nf, eps, probe,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {err}")
    if s is None:
        fused_launches += 1
    else:
        ln_fused_launches += 1
    return h, out


class _MlpFused(torch.autograd.Function):
    """The fused kernel (``plain`` False) or its plain version, saving h."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, plain):
        if plain:
            h, out = _mlp_forward_plain(x, None, None, w1, b1, w2, b2, 0.0)
        else:
            h, out = _fused_kernel(x, None, None, w1, b1, w2, b2, 0.0, write_h=True)
        ctx.save_for_backward(x, w1, w2, h)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, h = ctx.saved_tensors
        return (*mlp_fused_backward(x, w1, w2, h, dy.contiguous()), None)


class _MlpLnFused(torch.autograd.Function):
    """The fused LN+MLP kernel (``plain`` False) or its plain version, saving h."""

    @staticmethod
    def forward(ctx, x, s, t, w1, b1, w2, b2, eps, plain):
        if plain:
            h, out = _mlp_forward_plain(x, s, t, w1, b1, w2, b2, eps)
        else:
            h, out = _fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h=True)
        ctx.save_for_backward(x, s, t, w1, w2, h)
        ctx.eps, ctx.plain = eps, plain
        return out

    @staticmethod
    def backward(ctx, dy):
        x, s, t, w1, w2, h = ctx.saved_tensors
        grads = mlp_ln_fused_backward(x, s, t, w1, w2, h, dy.contiguous(), ctx.eps, ctx.plain)
        return (*grads, None, None)


def _device_check(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type == "cuda"


def mlp_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``gelu(x.w1^T + b1).w2^T + b2`` for 2-D ``x`` in one kernel: fp32
    accumulation, gelu(h) rounded to the compute dtype on chip, one rounding
    of the output; differentiable in every tensor."""
    if not _device_check(x):
        return mlp_fused_plain(x, w1, b1, w2, b2)
    _check_fused(x, None, None, w1, b1, w2, b2)
    if _needs_grad(x, w1, b1, w2, b2):
        return _MlpFused.apply(x, w1, b1, w2, b2, False)
    return _fused_kernel(x, None, None, w1, b1, w2, b2, 0.0, write_h=False)[1]


def mlp_fused_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """:func:`mlp_fused` through the plain version, on any device."""
    if _needs_grad(x, w1, b1, w2, b2):
        return _MlpFused.apply(x, w1, b1, w2, b2, True)
    return mlp_fused_reference(x, w1, b1, w2, b2)


def mlp_ln_fused(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x + gelu(LN(x; s, t).w1^T + b1).w2^T + b2`` for 2-D ``x`` in one
    kernel, the block's residual included; differentiable in every tensor.
    ``s`` and ``t`` are fp32."""
    if not _device_check(x):
        return mlp_ln_fused_plain(x, s, t, w1, b1, w2, b2, eps)
    _check_fused(x, s, t, w1, b1, w2, b2)
    if _needs_grad(x, s, t, w1, b1, w2, b2):
        return _MlpLnFused.apply(x, s, t, w1, b1, w2, b2, eps, False)
    return _fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h=False)[1]


def mlp_ln_fused_plain(x, s, t, w1, b1, w2, b2, eps: float = 1e-6) -> torch.Tensor:
    """:func:`mlp_ln_fused` through the plain version, on any device."""
    if _needs_grad(x, s, t, w1, b1, w2, b2):
        return _MlpLnFused.apply(x, s, t, w1, b1, w2, b2, eps, True)
    return mlp_ln_fused_reference(x, s, t, w1, b1, w2, b2, eps)
