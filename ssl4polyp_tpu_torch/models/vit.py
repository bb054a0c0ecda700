"""ViT encoder and classifier head as a torch module.

Counterpart of ``ssl4polyp_tpu/models/vit.py``:

* images are NHWC, as at the JAX package's public functions;
* the patch embedding is a reshape into (p, q, c)-ordered rows plus one
  GEMM, with the weight kept in timm's (D, C, P, P) conv layout;
* positional embeddings are fixed sin-cos (MAE lineage) or learned (timm
  lineage);
* logits come out in fp32;
* ``mlp_fusion``, ``qkv_ln_fusion`` and the environment knob
  ``BENCH_ATTN_PROJ=1`` (read when the model is built) choose the blocks'
  kernels where the JAX package honours them
  (:func:`.layers.block_route`); ``pad_tokens_to`` is read for that rule
  alone, since the port never pads.

Parameter names are timm's, so a timm or MAE state dict loads as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from . import layers
from .pos_embed import sincos_2d

__all__ = ["PatchEmbed", "ViT", "ViTConfig", "pool_tokens"]


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    pos_embed: str = "sincos"  # "sincos" (fixed, MAE lineage) | "learned" (timm lineage)
    num_classes: Optional[int] = None  # None → no classification head
    out_token: str = "cls"  # "cls" | "spatial" (mean of patch tokens)
    compute_dtype: torch.dtype = torch.bfloat16
    attention_softmax_f32: bool = True
    # The JAX package's token padding (None: none; the classifier factory
    # pads to the next multiple of 8) and fusion knobs (None -> "fc1";
    # "full", "full_ln"; "off"), with the JAX defaults.
    pad_tokens_to: Optional[int] = None
    mlp_fusion: Optional[str] = None
    qkv_ln_fusion: bool = False

    def __post_init__(self):
        layers.check_mlp_fusion(self.mlp_fusion)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_chans


class PatchEmbed(nn.Module):
    """Non-overlapping patches of NHWC images through one GEMM."""

    def __init__(self, cfg: ViTConfig, generator: torch.Generator):
        super().__init__()
        self.patch_size = cfg.patch_size
        p, c, d = cfg.patch_size, cfg.in_chans, cfg.embed_dim
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(
            layers.xavier_uniform((d, c, p, p), cfg.patch_dim, d, generator)
        )
        self.proj.bias = nn.Parameter(torch.zeros(d))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch_size
        x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // p) * (W // p), p * p * C)
        weight = self.proj.weight
        kernel = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)  # (D, (p, q, c))
        return layers.linear(x, kernel, self.proj.bias)


def pool_tokens(tokens: torch.Tensor, out_token: str) -> torch.Tensor:
    """cls-token or spatial-mean pooling (reference ``models.py:134-137``)."""
    if out_token == "cls":
        return tokens[:, 0]
    if out_token == "spatial":
        return tokens[:, 1:].mean(dim=1)
    raise ValueError(f"Unknown out_token {out_token!r}")


class ViT(nn.Module):
    """ViT encoder plus an optional linear head, random-initialised from
    ``generator`` (the reference scheme; load a state dict for weights)."""

    def __init__(self, cfg: ViTConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg, generator)
        self.cls_token = nn.Parameter(layers.trunc_normal((1, 1, D), generator))
        if cfg.pos_embed == "sincos":
            table = torch.from_numpy(sincos_2d(D, cfg.grid_size, cls_token=True))[None]
            self.pos_embed = nn.Parameter(table, requires_grad=False)
        elif cfg.pos_embed == "learned":
            self.pos_embed = nn.Parameter(
                layers.trunc_normal((1, cfg.num_patches + 1, D), generator)
            )
        else:
            raise ValueError(f"Unknown pos_embed mode {cfg.pos_embed!r}")
        route = layers.block_route(cfg.num_patches + 1, cfg.pad_tokens_to, D, cfg.mlp_fusion,
                                   cfg.qkv_ln_fusion)
        self.blocks = nn.ModuleList(
            layers.Block(D, cfg.num_heads, cfg.mlp_ratio, generator, cfg.ln_eps,
                         cfg.attention_softmax_f32, *route)
            for _ in range(cfg.depth)
        )
        self.norm = layers.LayerNorm(D, cfg.ln_eps)
        self.head = (
            None if cfg.num_classes is None
            else layers.Linear(D, cfg.num_classes, generator)
        )

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised NHWC images -> the tokens (B, N+1, D) the blocks take:
        patches plus positions, the cls token first."""
        dtype = self.cfg.compute_dtype
        x = self.patch_embed(images.to(dtype))
        pos = self.pos_embed.to(dtype)
        x = x + pos[:, 1:, :]
        cls = (self.cls_token.to(dtype) + pos[:, :1, :]).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1)

    def vit_features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised NHWC images -> normalised tokens (B, N+1, D)."""
        x = self.embed(images)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)

    def vit_tap_features(self, images: torch.Tensor,
                         taps: tuple[int, ...] = (2, 5, 8, 11)) -> list[torch.Tensor]:
        """The pre-norm outputs (B, N+1, D) of blocks ``taps``, shallowest
        first (JAX ``vit_tap_features``, ``vit.py:158-183``; reference
        ``models.py:117-127``): dense mode skips the final norm.  The blocks
        run on the default kernels, as the JAX tap path runs them
        (:func:`.layers.run_blocks_collect`)."""
        _, collected = layers.run_blocks_collect(self.embed(images), self.blocks)
        return [collected[i] for i in taps]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """fp32 logits when the model has a head, pooled features otherwise."""
        pooled = pool_tokens(self.vit_features(images), self.cfg.out_token)
        if self.head is not None:
            return self.head(pooled).float()
        return pooled.float()
