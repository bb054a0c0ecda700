"""Transformer layers: layernorm, linear, MLP, attention, pre-norm block.

Counterpart of ``ssl4polyp_tpu/models/layers.py`` with the same
mixed-precision recipe:

* parameters are fp32; matrices run in the compute dtype and vectors are
  cast at use.  For eval, :func:`cast_params_for_compute` casts a module's
  matrices once, in place; for training, :func:`compute_copy` makes the
  compute-dtype copy that the forward reads while the fp32 masters stay with
  the optimizer, as the JAX pretrain step does;
* ``linear`` rounds the product to the compute dtype, then adds the bias in
  the compute dtype;
* layernorm takes its statistics in fp32 and returns the compute dtype.

Every kernel dispatches on the tensor's device alone: a CUDA tensor goes
through the hand-written kernels (forward and backward), a CPU tensor
through the kernels' plain torch versions.  The JAX package's fusion knobs
(``mlp_fusion``, ``qkv_ln_fusion`` and the ``BENCH_ATTN_PROJ=1`` environment
knob) choose which kernels compute a block, with their roundings, on the
stacks where the JAX package runs its flattened stream (:func:`block_route`).  Its other layout devices (token padding,
scan, remat) are TPU tiling choices, not semantics, and have no counterpart
here: padding with ``valid_len`` masking is exact, so the port never pads.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..ops.attn_proj import attn_proj_fold_enabled, fused_attention_proj
from ..ops.layernorm import layernorm
from ..ops.ln_linear import ln_linear
from ..ops.mlp import fc1_gelu, mlp_fused, mlp_ln_fused
from ..ops.qkv_attention import fused_qkv_attention

__all__ = [
    "MLP_FUSIONS",
    "Attention",
    "Block",
    "LayerNorm",
    "Linear",
    "Mlp",
    "block_route",
    "cast_params_for_compute",
    "check_mlp_fusion",
    "compute_copy",
    "layernorm",
    "linear",
    "trunc_normal",
    "xavier_uniform",
]


MLP_FUSIONS = ("off", "fc1", "full", "full_ln")


def check_mlp_fusion(mlp_fusion: Optional[str]) -> None:
    """``ValueError`` for a value the JAX ``run_blocks`` refuses (layers.py:413-419)."""
    if mlp_fusion is not None and mlp_fusion not in MLP_FUSIONS:
        raise ValueError(f"mlp_fusion must be one of {'/'.join(MLP_FUSIONS)} (or None), "
                         f"got {mlp_fusion!r}")


def block_route(tokens: int, pad_to: Optional[int], dim: int, mlp_fusion: Optional[str],
                qkv_ln_fusion: bool) -> tuple[str, bool, bool]:
    """(MLP kernels, whether norm1 folds into the QKV product, whether the
    output projection folds into the attention kernel) of a stack of blocks
    over ``tokens`` tokens of width ``dim``, as the JAX package picks them
    (``models/layers.py:251-287, 386-393, 411-422``).

    The JAX stack runs its flattened stream, where alone the fusion knobs
    apply, when the token count after its padding (``pad_to``, when it is
    larger) is a multiple of 8 and ``dim`` and ``3 * dim`` are multiples of
    128.  Elsewhere it runs its default kernels, which are the port's
    ``"fc1"``.  ``mlp_fusion`` None means ``"fc1"``; the port runs ``"off"``
    (the JAX package's plain XLA MLP) through the same fc1+GELU kernel.  The
    projection fold is the environment knob ``BENCH_ATTN_PROJ=1``, read here,
    where a model is built (the counterpart of the JAX package's trace time).
    """
    check_mlp_fusion(mlp_fusion)
    padded = pad_to if pad_to and pad_to > tokens else tokens
    if not (padded % 8 == 0 and dim % 128 == 0 and (3 * dim) % 128 == 0):
        return "fc1", False, False
    mlp = "fc1" if mlp_fusion in (None, "off") else mlp_fusion
    return mlp, bool(qkv_ln_fusion), attn_proj_fold_enabled()


# Initialisers (the reference scheme: xavier-uniform linears, zero biases,
# unit layernorm — models_mae.py:85-93), drawn from an explicit generator.

def xavier_uniform(shape, fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def trunc_normal(shape, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations."""
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def cast_params_for_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the module's fp32 matrices (every parameter of rank >= 2) to
    ``dtype`` in place; vectors (biases, norm affines) stay fp32."""
    for param in module.parameters():
        if param.dim() >= 2 and param.dtype == torch.float32:
            param.data = param.data.to(dtype)
    return module


def compute_copy(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The compute copy of fp32 master parameters: every tensor of rank >= 2
    cast to ``dtype`` (a new tensor unless ``dtype`` is float32), every vector
    the master itself."""
    return {name: p.detach().to(dtype) if p.dim() >= 2 else p.detach()
            for name, p in params.items()}


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``x``'s dtype; ``weight`` is (out, in)."""
    return torch.matmul(x, weight.to(x.dtype).t()) + bias.to(x.dtype)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(xavier_uniform((d_out, d_in), d_in, d_out, generator))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 + exact-erf GELU (one kernel), then fc2."""

    def __init__(self, dim: int, hidden: int, generator: torch.Generator):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator)
        self.fc2 = Linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        h = fc1_gelu(x.reshape(-1, x.shape[-1]), self.fc1.weight.to(dtype),
                     self.fc1.bias.to(dtype))
        return self.fc2(h).reshape(*x.shape[:-1], -1)


class Attention(nn.Module):
    """Multi-head self-attention: a bias-free QKV product, then the
    attention kernel, which adds the QKV bias itself, then the projection.
    With ``norm`` (``qkv_ln_fusion``) the pre-norm folds into the QKV
    product (``ln_linear``), which adds the bias, and the attention kernel
    runs without one, as the JAX flattened stream does (layers.py:254-267).
    With ``proj_fold`` the QKV product adds its bias itself (``linear``, or
    ``ln_linear`` under ``norm``) and one kernel computes attention and the
    projection (``fused_attention_proj``, layers.py:272-285)."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 softmax_f32: bool = True, proj_fold: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.softmax_f32 = softmax_f32
        self.proj_fold = proj_fold
        self.qkv = Linear(dim, 3 * dim, generator)
        self.proj = Linear(dim, dim, generator)

    def forward(self, x: torch.Tensor, norm: Optional[LayerNorm] = None) -> torch.Tensor:
        dtype = x.dtype
        if norm is None and self.proj_fold:
            qkv, bias = self.qkv(x), None
        elif norm is None:
            qkv = torch.matmul(x, self.qkv.weight.to(dtype).t())
            bias = self.qkv.bias.to(dtype)
        else:
            qkv = ln_linear(x.reshape(-1, x.shape[-1]), norm.weight, norm.bias,
                            self.qkv.weight.to(dtype), self.qkv.bias.to(dtype),
                            norm.eps).reshape(*x.shape[:-1], -1)
            bias = None
        if self.proj_fold:
            return fused_attention_proj(qkv, self.proj.weight.to(dtype),
                                        self.proj.bias.to(dtype), self.num_heads,
                                        self.softmax_f32)
        out = fused_qkv_attention(qkv, self.num_heads, self.softmax_f32, bias=bias)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm transformer block (timm ``Block`` names).

    ``mlp_route`` and ``qkv_ln`` are :func:`block_route`'s choice for the
    stack: ``"fc1"`` runs norm2, the fc1+GELU kernel, fc2 and the residual
    add; ``"full"`` norm2 and ``mlp_fused`` (fc1+GELU+fc2 in one kernel);
    ``"full_ln"`` ``mlp_ln_fused``, which returns ``x + mlp(norm2(x))``
    (layers.py:436-441).  ``proj_fold`` is passed on to :class:`Attention`.
    The parameters are the same in every route: the matrices go in as the
    compute copy, the biases cast to the compute dtype and the LayerNorm
    affine in fp32, as at the JAX call sites.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, generator: torch.Generator,
                 ln_eps: float = 1e-6, softmax_f32: bool = True, mlp_route: str = "fc1",
                 qkv_ln: bool = False, proj_fold: bool = False):
        super().__init__()
        if mlp_route not in ("fc1", "full", "full_ln"):
            raise ValueError(f"unknown MLP route {mlp_route!r}")
        self.mlp_route = mlp_route
        self.qkv_ln = qkv_ln
        self.norm1 = LayerNorm(dim, ln_eps)
        self.attn = Attention(dim, num_heads, generator, softmax_f32, proj_fold)
        self.norm2 = LayerNorm(dim, ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qkv_ln:
            x = x + self.attn(x, self.norm1)
        else:
            x = x + self.attn(self.norm1(x))
        if self.mlp_route == "fc1":
            return x + self.mlp(self.norm2(x))
        dtype = x.dtype
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        weights = (fc1.weight.to(dtype), fc1.bias.to(dtype), fc2.weight.to(dtype),
                   fc2.bias.to(dtype))
        if self.mlp_route == "full":
            h = self.norm2(x)
            return x + mlp_fused(h.reshape(-1, h.shape[-1]), *weights).reshape(x.shape)
        norm = self.norm2
        return mlp_ln_fused(x.reshape(-1, x.shape[-1]), norm.weight, norm.bias, *weights,
                            norm.eps).reshape(x.shape)
