"""LayerNorm folded into the linear that follows it, differentiable.

Counterpart of ``ssl4polyp_tpu/ops/ln_linear.py::ln_linear``; the CUDA
kernels are ``csrc/ln_linear.cu`` (bf16) and ``csrc/ln_linear_f32.cu``
(fp32, for the runs that compute in fp32).  ``LN(x) . w^T + b`` on (M, K)
rows: fp32 statistics, the normalised row rounded once to the compute dtype,
the product accumulated in fp32, the bias added in fp32, one rounding.  Weights
are in torch's (out, in) layout; the LayerNorm affine is fp32.  The backward,
:func:`ln_linear_backward`, takes the JAX ``_bwd``'s steps, which the JAX
package leaves to XLA: its products are cuBLAS's, and on the kernel path its
two LayerNorm steps (the recompute of the normalised row and the backward
from its gradient) run on the LayerNorm kernels, which compute the same
fp32 formulas with the same roundings.

A tensor on the CPU goes through :func:`ln_linear_reference`, the plain
torch version; a CUDA tensor goes through the kernel, or the wrapper raises.
:func:`ln_linear_plain` runs the plain version on any device, to compare the
kernel with.  The plain version computes its product in fp32 from the
rounded operands, which keeps the kernel's roundings exactly.
"""

from __future__ import annotations

import torch

from . import layernorm
from ._checks import check_one_dtype

__all__ = [
    "launches",
    "launches_f32",
    "layernorm_backward",
    "ln_linear",
    "ln_linear_backward",
    "ln_linear_plain",
    "ln_linear_reference",
    "normalised_row",
]

# Kernel launches since the last ops.reset_launch_counts(), in bf16 and in fp32.
launches = 0
launches_f32 = 0

_MAX_K = 768  # s and t, and the first design's rows, live in shared memory (csrc/ln_linear.cu)
# `probe` bits of the bf16 kernel, a measurement aid (0 on every path;
# chip_smoke.py times the kernel with parts left out, whose results are
# wrong): no normalisation (x straight into the products), no statistics
# launch, the bare epilogue (no bias); the tile width the shape rule did not
# pick, and the first design (both right results).
PROBE_NO_NORMALISE = 1
PROBE_NO_STATS = 2
PROBE_BARE_EPILOGUE = 4
PROBE_OTHER_WIDTH = 8
PROBE_FIRST_DESIGN = 16


def _normalised(x: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(xhat, rstd) of x's rows in fp32: two-pass statistics, as the TPU kernels take them."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * rstd, rstd


def normalised_row(x, s, t, eps: float, plain: bool = True) -> torch.Tensor:
    """m = LN(x) * s + t in fp32, rounded once to x's dtype; from the
    LayerNorm kernel unless ``plain``."""
    if not plain:
        return layernorm._forward_kernel(x, s, t, eps)
    return (_normalised(x, eps)[0] * s.float() + t.float()).to(x.dtype)


def layernorm_backward(x, s, dm, eps: float, plain: bool, dres=None):
    """The fused kernels' LayerNorm backward (JAX ``ln_linear.py:123-129``,
    ``mlp.py:466-473``) from the gradient ``dm`` of the normalised row: dx in
    fp32 plus ``dres`` (or nothing), rounded once to x's dtype, and dscale
    and dbias, fp32 sums over the rows.  The LayerNorm backward kernel
    unless ``plain``."""
    if not plain:
        return layernorm._backward_kernel(x, dm, s, eps, dres)
    xhat, rstd = _normalised(x, eps)
    dm32 = dm.float()
    dscale = (dm32 * xhat).sum(dim=0).to(s.dtype)
    dbias = dm32.sum(dim=0).to(s.dtype)
    dxhat = dm32 * s.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    if dres is not None:
        dx = dx + dres.float()
    return dx.to(x.dtype), dscale, dbias


def ln_linear_reference(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain torch version of the kernel, same roundings."""
    m = normalised_row(x, s, t, eps)
    return (torch.matmul(m.float(), w.float().t()) + b.float()).to(x.dtype)


def ln_linear_backward(x, s, t, w, dy, eps: float, plain: bool = True):
    """The JAX ``ln_linear`` VJP (``ln_linear.py::_bwd``): m recomputed in the
    compute dtype; dw = dy^T m with fp32 accumulation; db the fp32 sum of dy,
    then the compute dtype; dm = dy . w in the compute dtype; then the
    LayerNorm backward in fp32.  Returns (dx, dscale, dbias, dw, db)."""
    m = normalised_row(x, s, t, eps, plain)
    dw = torch.matmul(dy.t(), m).to(w.dtype)
    db = dy.sum(dim=0, dtype=torch.float32).to(dy.dtype)
    dm = torch.matmul(dy, w.to(dy.dtype))
    return (*layernorm_backward(x, s, dm, eps, plain), dw, db)


def _check(x, s, t, w, b) -> None:
    if x.dim() != 2 or w.dim() != 2 or s.dim() != 1 or t.dim() != 1 or b.dim() != 1:
        raise ValueError(f"ln_linear takes x (M, K), s and t (K,), w (N, K), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(s.shape)}, {tuple(t.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    (m, k), (n, k_w) = x.shape, w.shape
    if k_w != k or s.shape[0] != k or t.shape[0] != k or b.shape[0] != n:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, s {tuple(s.shape)}")
    if k % 64 or k > _MAX_K or n % 8 or m < 1:
        raise ValueError(f"the kernel takes K a multiple of 64 up to {_MAX_K} and N a multiple "
                         f"of 8, got K {k}, N {n}")
    check_one_dtype((x, w, b))
    for name, tensor in (("s", s), ("t", t)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"the kernel takes a {torch.float32} {name}, got {tensor.dtype}")
    for name, tensor in (("x", x), ("w", w), ("b", b), ("s", s), ("t", t)):
        if tensor.device != x.device:
            raise ValueError(f"tensors on {x.device} and {tensor.device}")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"ln_linear's {name} must be contiguous and 16-byte aligned")


def _kernel(x, s, t, w, b, eps, probe: int = 0):
    """The CUDA kernel of x's dtype, bf16 (``ln_linear.cu``) or fp32
    (``ln_linear_f32.cu``): a statistics launch into a (M, 2) fp32 scratch,
    then the GEMM that normalises its x stages with them.  ``probe`` (0 on
    every path) is a measurement aid of the bf16 kernel: the ``PROBE_*``
    bits above."""
    from ._build import library

    global launches, launches_f32
    f32 = x.dtype == torch.float32
    if f32 and probe:
        raise ValueError("the fp32 ln_linear kernel takes no probe bits")
    m, k = x.shape
    n = w.shape[0]
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = library()
    args = [x.data_ptr(), s.data_ptr(), t.data_ptr(), w.data_ptr(), b.data_ptr(),
            stats.data_ptr(), out.data_ptr(), m, k, n, eps]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f32:
            err = lib.ssl4polyp_ln_linear_fwd_f32(*args, stream)
        else:
            err = lib.ssl4polyp_ln_linear_probe(*args, probe, stream)
    if err:
        raise RuntimeError(f"ln_linear kernel launch failed: CUDA error {err}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out


class _LnLinear(torch.autograd.Function):
    """The kernel (``plain`` False) or the plain version (``plain`` True)."""

    @staticmethod
    def forward(ctx, x, s, t, w, b, eps, plain):
        ctx.save_for_backward(x, s, t, w)
        ctx.eps, ctx.plain = eps, plain
        return (ln_linear_reference if plain else _kernel)(x, s, t, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, s, t, w = ctx.saved_tensors
        grads = ln_linear_backward(x, s, t, w, dy.contiguous(), ctx.eps, ctx.plain)
        return (*grads, None, None)


def ln_linear(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``layernorm(x; s, t) . w^T + b`` for 2-D ``x``, differentiable in every
    tensor.  On the card x, w and b are all bfloat16 or all float32, each
    dtype with its own kernel, and s and t are fp32."""
    if x.device.type == "cpu":
        return ln_linear_plain(x, s, t, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, s, t, w, b)
    return _LnLinear.apply(x, s, t, w, b, eps, False)


def ln_linear_plain(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """:func:`ln_linear` through the plain version, on any device."""
    return _LnLinear.apply(x, s, t, w, b, eps, True)
