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

LayerNorm, fc1+GELU and attention dispatch on the tensor's device alone: a
CUDA tensor goes through the hand-written kernels (forward and backward), a
CPU tensor through the kernels' plain torch versions.  There is no other
switch.  The JAX package's
layout devices (token padding, the flattened stream, scan, remat and the
fusion knobs) are TPU tiling choices, not semantics, and have no
counterpart here.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from ..ops.layernorm import layernorm
from ..ops.mlp import fc1_gelu
from ..ops.qkv_attention import fused_qkv_attention

__all__ = [
    "Attention",
    "Block",
    "LayerNorm",
    "Linear",
    "Mlp",
    "cast_params_for_compute",
    "compute_copy",
    "layernorm",
    "linear",
    "trunc_normal",
    "xavier_uniform",
]


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
    attention kernel, which adds the QKV bias itself, then the projection."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 softmax_f32: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.softmax_f32 = softmax_f32
        self.qkv = Linear(dim, 3 * dim, generator)
        self.proj = Linear(dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = torch.matmul(x, self.qkv.weight.to(x.dtype).t())
        out = fused_qkv_attention(qkv, self.num_heads, self.softmax_f32,
                                  bias=self.qkv.bias.to(x.dtype))
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm transformer block (timm ``Block`` names)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, generator: torch.Generator,
                 ln_eps: float = 1e-6, softmax_f32: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_eps)
        self.attn = Attention(dim, num_heads, generator, softmax_f32)
        self.norm2 = LayerNorm(dim, ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))
