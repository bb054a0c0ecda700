"""LayerNorm with fp32 statistics, forward and backward.

Counterpart of ``ssl4polyp_tpu/ops/layernorm.py`` (``layernorm_fused_bwd``
in 3-D and 2-D, and ``layernorm_fused_view``): one CUDA kernel per
direction (``csrc/layernorm.cu``) over the rows of any (..., D) bf16 tensor,
since LayerNorm does not depend on the order of the rows.  The backward
recomputes the statistics from x and sums the fp32 weight and bias
gradients over every row in an order fixed by the shape.

A tensor on the CPU goes through :func:`layernorm_reference`, the plain
torch version (its backward is autograd's); a CUDA tensor goes through the
kernels, or the wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._checks import check_gradient

__all__ = ["BACKWARD_PARTS", "backward_launches", "launches", "layernorm", "layernorm_reference"]

# Kernel launches since the last ops.reset_launch_counts().
launches = 0
backward_launches = 0

_MAX_DIM = 2048


def layernorm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain torch version: fp32 statistics and affine, returned in ``x``'s dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def _check(x, weight, bias) -> None:
    D = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes a bfloat16 x, got {x.dtype}")
    if D % 8 or not 8 <= D <= _MAX_DIM or x.numel() == 0:
        raise ValueError(f"the kernel takes D a multiple of 8 in 8..{_MAX_DIM}, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.shape != (D,) or p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(
                f"{name} must be a contiguous, aligned ({D},) float32 tensor on {x.device}, "
                f"got {tuple(p.shape)} {p.dtype} on {p.device}"
            )


def _forward_kernel(x, weight, bias, eps):
    from ._build import library

    global launches
    D = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().ssl4polyp_layernorm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // D, D, eps, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"layernorm kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _backward_kernel(x, dy, weight, eps, dres=None):
    """(dx, dweight, dbias); ``dres`` (or None), a gradient of ``x``'s shape,
    is added to dx in fp32 before its one rounding."""
    global backward_launches
    run, results = _backward_plan(x, dy, weight, eps, dres)
    run(_BOTH_PARTS)
    backward_launches += 1
    return results()


# The backward's two launches (csrc/layernorm.cu), a bit each in its ``parts``
# argument: the row kernel (dx and each block's partial sums) and the sum of
# the partials into dweight and dbias.
BACKWARD_PARTS = {"rows": 1, "sum": 2}
_BOTH_PARTS = 3


def _backward_plan(x, dy, weight, eps, dres=None):
    """Allocates the backward's results and scratch once and returns ``(run,
    results)``: ``run(parts)`` launches the parts of the mask, ``results()``
    returns (dx, dweight, dbias).  No launch is counted here."""
    from ._build import library

    check_gradient("dy", dy, x.shape, x.dtype, x.device)
    if dres is not None:
        check_gradient("dres", dres, x.shape, x.dtype, x.device)
    D = x.shape[-1]
    M = x.numel() // D
    dx = torch.empty_like(x)
    dparams = torch.empty((2, D), dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        # The kernel's grid is the library's to choose (persistent: it follows
        # the device's SMs); each of its blocks writes one row of `part`.
        blocks = lib.ssl4polyp_layernorm_bwd_blocks(M, D)
    if blocks < 1:
        raise RuntimeError(f"layernorm backward: no grid for ({M}, {D}) on {x.device}")
    part = torch.empty((blocks, 2, D), dtype=torch.float32, device=x.device)

    def run(parts: int) -> None:
        with torch.cuda.device(x.device):
            err = lib.ssl4polyp_layernorm_bwd(
                x.data_ptr(), dy.data_ptr(), None if dres is None else dres.data_ptr(),
                weight.data_ptr(), dx.data_ptr(), part.data_ptr(), dparams.data_ptr(), M, D,
                eps, parts, torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"layernorm backward kernel launch failed: CUDA error {err}")

    return run, lambda: (dx, dparams[0], dparams[1])


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward_kernel(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        if dy.dtype != x.dtype:
            raise TypeError(f"layernorm backward takes a {x.dtype} gradient, got {dy.dtype}")
        dx, dweight, dbias = _backward_kernel(x, dy, weight, ctx.eps)
        return dx, dweight, dbias, None


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics, ``weight`` and ``bias``
    applied in fp32, one rounding to ``x``'s dtype; differentiable.

    ``x`` is any (..., D) tensor; the kernels take bfloat16 ``x`` with
    float32 ``weight`` and ``bias`` (the JAX recipe's fp32 vectors).
    """
    if x.device.type == "cpu":
        return layernorm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, weight, bias)
    return _LayerNorm.apply(x, weight, bias, eps)
