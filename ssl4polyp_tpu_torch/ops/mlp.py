"""The MLP's first linear with its exact-erf GELU, differentiable.

Counterpart of ``ssl4polyp_tpu/ops/mlp.py::fc1_gelu``; the CUDA kernel is
``csrc/mlp.cu``.  Weights are in torch's (out, in) layout.  When a gradient
is needed, the forward also writes the pre-activation h (the JAX kernel's
residual), and the backward is :func:`fc1_gelu_backward`, plain torch, as
the JAX package leaves its backward to XLA.

A tensor on the CPU goes through :func:`fc1_gelu_reference`, the plain torch
version; a CUDA tensor goes through the kernel, or the wrapper raises.
:func:`fc1_gelu_plain` runs the plain version on any device, to compare the
kernel with.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fc1_gelu", "fc1_gelu_backward", "fc1_gelu_plain", "fc1_gelu_reference", "launches"]

# Kernel launches since the last ops.reset_launch_counts().
launches = 0


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
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fc1_gelu's operands must be contiguous and 16-byte aligned")


def _kernel(x, w, b, write_h: bool):
    """(h or None, y) from the CUDA kernel."""
    from ._build import library

    global launches
    m, k = x.shape
    nf = w.shape[0]
    y = torch.empty((m, nf), dtype=x.dtype, device=x.device)
    h = torch.empty_like(y) if write_h else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().ssl4polyp_fc1_gelu_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None if h is None else h.data_ptr(),
            y.data_ptr(), m, k, nf, stream,
        )
    if err:
        raise RuntimeError(f"fc1_gelu kernel launch failed: CUDA error {err}")
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
    fp32, one rounding to the compute dtype; differentiable in x, w and b."""
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
