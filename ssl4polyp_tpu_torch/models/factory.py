"""Backbone and classifier factories.

Counterpart of ``ssl4polyp_tpu/models/factory.py``.  Weights come from a
seeded ``torch.Generator`` (random init), from a JAX parameter pytree given
as numpy (``jax_params``: a tree built in memory, or the ``params`` of a
``.ckpt`` read by :mod:`..utils.checkpoint`), or, for the MAE lineage, from
the ``.ckpt`` that either package's pretraining wrote (``weight_path``; the
decoder dropped), through :func:`.weights.state_dict_from_jax`.  These
functions place the model on the card unless the caller names another
device; without a CUDA device that raises.  Reading torch ``.pth`` or
AugReg ``.npz`` weight files (ROADMAP.md §1 item 5, the weight-file readers)
and the dense (DPT) head come with later slices and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from ..utils.checkpoint import load_checkpoint
from .mae import encoder_only
from .vit import ViT, ViTConfig
from .weights import state_dict_from_jax

__all__ = [
    "LAYOUT_KEYS",
    "Classifier",
    "build_classifier",
    "get_imagenet_or_random_vit",
    "get_mae_backbone",
]

# Config keys of the JAX package that choose a TPU layout, not the model's
# arithmetic nor its kernels: the MAE's padding keys (which do not apply to a
# classifier), scan unrolling, rematerialisation, the LayerNorm kernel switch
# and the kernels switch.  The port accepts them (checkpoint meta and run
# configs carry them) and discards them.  ``pad_tokens_to``, ``mlp_fusion``
# and ``qkv_ln_fusion`` are ViTConfig fields (see layers.block_route).
LAYOUT_KEYS = frozenset({
    "encoder_pad_to",
    "decoder_pad_to",
    "unroll_blocks",
    "remat",
    "fused_layernorm",
    "use_pallas_attention",
})


@dataclass(frozen=True)
class Classifier:
    model: ViT
    cfg: ViTConfig
    scheme: str  # "sup_imnet" | "ssl_imnet" | "ssl_colon" | "random"


def _vit_b(num_classes: Optional[int], out_token: str, pos_embed: str, **overrides) -> ViTConfig:
    kwargs: Dict[str, Any] = dict(
        embed_dim=768, depth=12, num_heads=12,
        pos_embed=pos_embed, num_classes=num_classes, out_token=out_token,
    )
    # Overrides (tests, rebuilds from checkpoint meta) win over the defaults.
    kwargs.update({k: v for k, v in overrides.items() if k not in LAYOUT_KEYS})
    cfg = ViTConfig(**kwargs)
    if cfg.pad_tokens_to is None:
        # The JAX factory pads the tokens to the next multiple of 8 when its
        # kernels are on (factory.py:113-116), as the port's always are;
        # pad_tokens_to=0 opts out.  It decides where the fusion knobs apply.
        cfg = replace(cfg, pad_tokens_to=-(-(cfg.num_patches + 1) // 8) * 8)
    return cfg


def _build(generator: torch.Generator, cfg: ViTConfig,
           jax_params: Optional[Mapping[str, Any]], device) -> ViT:
    model = ViT(cfg, generator)
    if jax_params is not None:
        state = state_dict_from_jax(jax_params, cfg)
        if model.head is not None and "head" not in jax_params:
            # A backbone without a head keeps the fresh one, as in the JAX factory.
            state.update({f"head.{k}": v for k, v in model.head.state_dict().items()})
        model.load_state_dict(state)
    return model.to(device)


_WEIGHT_FILE_READERS = ("the weight-file readers (ROADMAP.md §1 item 5) are not ported yet; "
                        "pass jax_params")


def get_mae_backbone(
    generator: torch.Generator,
    jax_params: Optional[Mapping[str, Any]] = None,
    num_classes: Optional[int] = 2,
    out_token: str = "cls",
    scheme: str = "ssl_colon",
    device: str | torch.device = "cuda",
    weight_path: Optional[str | Path] = None,
    **overrides,
) -> Classifier:
    """ViT-B with MAE lineage (fixed sin-cos positions) and a fresh head.

    The encoder comes from ``jax_params`` or from the MAE checkpoint at
    ``weight_path`` (decoder discarded), else from the generator; the head
    is always fresh from the generator."""
    if jax_params is not None and weight_path is not None:
        raise ValueError("pass jax_params or weight_path, not both")
    pos_embed = overrides.pop("pos_embed", "sincos")
    out_token = overrides.pop("out_token", out_token)
    cfg = _vit_b(num_classes, out_token, pos_embed, **overrides)
    if weight_path is not None:
        jax_params = _load_mae_encoder(weight_path)
    return Classifier(_build(generator, cfg, jax_params, device), cfg, scheme)


def _load_mae_encoder(weight_path: str | Path) -> Dict[str, Any]:
    """The JAX-layout encoder tree of an MAE checkpoint: a ``.ckpt`` (or its
    ``.ckpt.json`` sidecar's path, or a path without that suffix that holds
    msgpack) as either package's pretraining writes it.  A torch pickle
    (``.pth``) raises ``NotImplementedError``."""
    path = Path(weight_path)
    if path.name.endswith(".ckpt.json"):
        path = path.with_suffix("")  # the checkpoint beside its sidecar
    if path.suffix == ".ckpt":
        restored = load_checkpoint(path)
    elif path.suffix == ".pth":
        raise NotImplementedError(f"{path} is a torch pickle: {_WEIGHT_FILE_READERS}")
    else:
        try:
            restored = load_checkpoint(path)
        except Exception as exc:  # not msgpack: a torch pickle or another format
            raise NotImplementedError(
                f"{path} is not a .ckpt checkpoint: {_WEIGHT_FILE_READERS}") from exc
    mae_params = restored.get("payload", {}).get("params") if isinstance(restored, dict) else None
    if mae_params is None:
        raise ValueError(f"Native checkpoint {path} lacks a 'params' payload")
    return encoder_only(mae_params)


def get_imagenet_or_random_vit(
    generator: torch.Generator,
    jax_params: Optional[Mapping[str, Any]] = None,
    num_classes: Optional[int] = 2,
    out_token: str = "cls",
    device: str | torch.device = "cuda",
    **overrides,
) -> Classifier:
    """timm-lineage ViT-B (learned positions): ``jax_params`` or random.

    The scheme is ``"random"`` either way, as in the JAX factory, which names
    it ``"sup_imnet"`` only where it read an AugReg file (not ported yet)."""
    pos_embed = overrides.pop("pos_embed", "learned")
    out_token = overrides.pop("out_token", out_token)
    cfg = _vit_b(num_classes, out_token, pos_embed, **overrides)
    return Classifier(_build(generator, cfg, jax_params, device), cfg, "random")


def build_classifier(
    generator: torch.Generator,
    model_cfg: Mapping[str, Any],
    num_classes: int = 2,
    checkpoint_root: Optional[Path] = None,
    jax_params: Optional[Mapping[str, Any]] = None,
    device: str | torch.device = "cuda",
    **overrides,
) -> Classifier:
    """Build a classifier from a ``model:`` config section.

    Dispatch follows the JAX factory: ``ss_framework: mae`` (or MAE
    pretraining) -> MAE backbone, whose encoder comes from an existing
    ``checkpoint`` (a ``.ckpt``); ``pretraining: ImageNet_class`` -> timm
    lineage; otherwise random init.  ``jax_params``, when given, are the
    weights in every case.  An existing ``checkpoint`` outside the MAE
    lineage raises ``NotImplementedError``: its readers are not ported yet.
    """
    if overrides.pop("dense", model_cfg.get("dense", False)):
        raise NotImplementedError("the dense (DPT) classifier is not ported yet")
    pretraining = str(model_cfg.get("pretraining", "random")).lower()
    ss_framework = str(model_cfg.get("ss_framework", "")).lower()
    mae_lineage = ss_framework == "mae" or pretraining in {"hyperkvasir", "imagenet_self"}
    weight_path = None
    checkpoint = model_cfg.get("checkpoint")
    if checkpoint is not None and jax_params is None:
        path = Path(checkpoint)
        if checkpoint_root is not None and not path.is_absolute():
            path = checkpoint_root / path
        if path.exists():
            if not mae_lineage:
                raise NotImplementedError(f"reading {path}: {_WEIGHT_FILE_READERS}")
            weight_path = path
    if mae_lineage:
        return get_mae_backbone(
            generator, jax_params, num_classes=num_classes,
            scheme=str(model_cfg.get("key", "ssl")), device=device, weight_path=weight_path,
            **overrides,
        )
    return get_imagenet_or_random_vit(
        generator, jax_params, num_classes=num_classes, device=device, **overrides
    )
