"""Masked autoencoder (MAE) pretraining model over the port's ViT layers.

Counterpart of ``ssl4polyp_tpu/models/mae.py`` (reference
``src/ssl4polyp/models/mae/models_mae.py``):

* per-sample random masking by a stable argsort of uniform noise, the noise
  given by the caller (tests hand in the JAX key's noise);
* the encoder sees the kept patches and the cls token, with fixed sin-cos
  positions added before masking;
* the decoder embeds to its own width, splices mask tokens back through the
  restore permutation, runs its blocks and predicts each patch's pixels;
* the loss is the mean squared error over the masked patches, in fp32.

Parameter names are timm's MAE names (``decoder_embed``, ``mask_token``,
``decoder_pos_embed``, ``decoder_blocks.{i}``, ``decoder_norm``,
``decoder_pred``); both sin-cos tables are frozen (``requires_grad=False``).
The encoder config's fusion knobs and the ``BENCH_ATTN_PROJ=1`` projection
fold apply to both stacks, each where the JAX package runs its flattened
stream (:func:`.layers.block_route`), which ``encoder_pad_to`` and
``decoder_pad_to`` decide; the port never pads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from . import layers
from .pos_embed import sincos_2d
from .vit import PatchEmbed, ViTConfig

__all__ = [
    "MAE",
    "MAEConfig",
    "MAE_VIT_B16",
    "MaskingResult",
    "encoder_only",
    "mae_decode",
    "mae_encode",
    "mae_forward",
    "mae_loss",
    "patchify",
    "random_masking",
    "unpatchify",
]


@dataclass(frozen=True)
class MAEConfig:
    encoder: ViTConfig = field(default_factory=ViTConfig)
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mask_ratio: float = 0.75
    norm_pix_loss: bool = False
    # The JAX package's padding of each stack's tokens (None: none), read
    # only to decide where the fusion knobs apply.
    decoder_pad_to: Optional[int] = None
    encoder_pad_to: Optional[int] = None

    @property
    def len_keep(self) -> int:
        return int(self.encoder.num_patches * (1.0 - self.mask_ratio))


MAE_VIT_B16 = MAEConfig()


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, P*P*C), each patch's rows in (p, q, c) order."""
    B, H, W, C = images.shape
    p = patch_size
    x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(patches: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Inverse of :func:`patchify`: (B, L, P*P*C) -> (B, H, W, C)."""
    B, L, F = patches.shape
    p = patch_size
    g = int(round(L ** 0.5))
    C = F // (p * p)
    x = patches.reshape(B, g, g, p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * p, g * p, C)


class MaskingResult(NamedTuple):
    kept: torch.Tensor         # (B, len_keep, D) kept patch embeddings
    mask: torch.Tensor         # (B, L), 1 = masked (removed)
    ids_restore: torch.Tensor  # (B, L), the permutation back to patch order


def random_masking(x: torch.Tensor, noise: torch.Tensor, len_keep: int) -> MaskingResult:
    """Keep the ``len_keep`` patches with the smallest ``noise`` (B, L).

    Stable argsorts, as ``jnp.argsort``, so ties resolve as in the JAX
    package.
    """
    B, L, D = x.shape
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    kept = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, D))
    mask = torch.ones((B, L), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return MaskingResult(kept, torch.gather(mask, 1, ids_restore), ids_restore)


class MAE(nn.Module):
    """The MAE encoder and decoder, random-initialised from ``generator``
    (the reference scheme; load a state dict for weights)."""

    def __init__(self, cfg: MAEConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        enc = cfg.encoder
        D, Dd = enc.embed_dim, cfg.decoder_embed_dim
        self.patch_embed = PatchEmbed(enc, generator)
        self.cls_token = nn.Parameter(layers.trunc_normal((1, 1, D), generator))
        self.pos_embed = nn.Parameter(
            torch.from_numpy(sincos_2d(D, enc.grid_size, cls_token=True))[None],
            requires_grad=False,
        )
        route = layers.block_route(1 + cfg.len_keep, cfg.encoder_pad_to, D, enc.mlp_fusion,
                                   enc.qkv_ln_fusion)
        self.blocks = nn.ModuleList(
            layers.Block(D, enc.num_heads, enc.mlp_ratio, generator, enc.ln_eps,
                         enc.attention_softmax_f32, *route)
            for _ in range(enc.depth)
        )
        self.norm = layers.LayerNorm(D, enc.ln_eps)
        self.decoder_embed = layers.Linear(D, Dd, generator)
        self.mask_token = nn.Parameter(layers.trunc_normal((1, 1, Dd), generator))
        self.decoder_pos_embed = nn.Parameter(
            torch.from_numpy(sincos_2d(Dd, enc.grid_size, cls_token=True))[None],
            requires_grad=False,
        )
        route = layers.block_route(1 + enc.num_patches, cfg.decoder_pad_to, Dd, enc.mlp_fusion,
                                   enc.qkv_ln_fusion)
        self.decoder_blocks = nn.ModuleList(
            layers.Block(Dd, cfg.decoder_num_heads, enc.mlp_ratio, generator, enc.ln_eps,
                         enc.attention_softmax_f32, *route)
            for _ in range(cfg.decoder_depth)
        )
        self.decoder_norm = layers.LayerNorm(Dd, enc.ln_eps)
        self.decoder_pred = layers.Linear(Dd, enc.patch_dim, generator)

    def forward(self, images: torch.Tensor, noise: torch.Tensor):
        """:func:`mae_forward`: (loss, pred, mask)."""
        return mae_forward(self, images, noise)


def mae_encode(model: MAE, images: torch.Tensor, noise: torch.Tensor):
    """Normalised NHWC images -> (latent (B, 1+len_keep, D), mask, ids_restore)."""
    cfg = model.cfg
    dtype = cfg.encoder.compute_dtype
    x = model.patch_embed(images.to(dtype))
    pos = model.pos_embed.to(dtype)
    x = x + pos[:, 1:, :]
    kept, mask, ids_restore = random_masking(x, noise, cfg.len_keep)
    cls = (model.cls_token.to(dtype) + pos[:, :1, :]).expand(x.shape[0], -1, -1)
    h = torch.cat([cls, kept], dim=1)
    for block in model.blocks:
        h = block(h)
    return model.norm(h), mask, ids_restore


def mae_decode(model: MAE, latent: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
    """Splice mask tokens, unshuffle, decoder blocks, per-patch pixels (B, L, P*P*C)."""
    x = model.decoder_embed(latent)  # (B, 1+len_keep, Dd)
    B, _, Dd = x.shape
    L = ids_restore.shape[1]
    mask_tokens = model.mask_token.to(x.dtype).expand(B, L + 1 - x.shape[1], -1)
    body = torch.cat([x[:, 1:, :], mask_tokens], dim=1)
    body = torch.gather(body, 1, ids_restore[:, :, None].expand(-1, -1, Dd))
    x = torch.cat([x[:, :1, :], body], dim=1) + model.decoder_pos_embed.to(x.dtype)
    for block in model.decoder_blocks:
        x = block(x)
    x = model.decoder_pred(model.decoder_norm(x))
    return x[:, 1:, :]


def mae_loss(images: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
             cfg: MAEConfig) -> torch.Tensor:
    """Mean squared error over the masked patches, in fp32.  The target is
    ``images`` (the normalised batch in the compute dtype) cast to fp32."""
    target = patchify(images.float(), cfg.encoder.patch_size)
    pred = pred.float()
    if cfg.norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = torch.mean(torch.square(pred - target), dim=-1)  # (B, L)
    mask = mask.float()
    return torch.sum(per_patch * mask) / torch.clamp(torch.sum(mask), min=1.0)


def mae_forward(model: MAE, images: torch.Tensor, noise: torch.Tensor):
    """Normalised NHWC images and masking noise (B, L) -> (loss, pred, mask)."""
    latent, mask, ids_restore = mae_encode(model, images, noise)
    pred = mae_decode(model, latent, ids_restore)
    return mae_loss(images, pred, mask, model.cfg), pred, mask


def encoder_only(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the decoder from a JAX-layout MAE tree, as a ``.ckpt`` holds it
    (reference deletes it when building classifiers — ``models.py:171-175``);
    keeps the encoder pytree for fine-tuning."""
    return {k: v for k, v in params.items() if k != "decoder"}
