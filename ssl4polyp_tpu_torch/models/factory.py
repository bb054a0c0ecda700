"""Backbone and classifier factories.

Counterpart of ``ssl4polyp_tpu/models/factory.py``.  Weights come from a
seeded ``torch.Generator`` (random init), from a JAX parameter pytree given
as numpy (``jax_params``: a tree built in memory, or the ``params`` of a
``.ckpt`` read by :mod:`..utils.checkpoint`), or from a weight file: for the
MAE lineage the ``.ckpt`` that either package's pretraining wrote or an
upstream MAE ``.pth`` (``weight_path``; the decoder dropped), for the timm
lineage a big_vision AugReg ``.npz`` (``pretrained_npz``).  Every file is
read into the JAX layout (:mod:`.import_torch`, :mod:`.pth_reader`), its
leaves cast to fp32 as the JAX ``_as_jax`` casts them, and carried into the
modules by :func:`.weights.state_dict_from_jax`.  ``dense`` wraps the encoder
with the DPT decoder (:class:`DenseClassifier`).  These functions place the
model on the card unless the caller names another device; without a CUDA
device that raises.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..utils.checkpoint import load_checkpoint
from .dpt import DPT, DPTConfig, TAP_BLOCKS, dpt_forward
from .import_torch import load_torch_state_dict, mae_params_from_torch, vit_params_from_augreg_npz
from .mae import encoder_only
from .vit import ViT, ViTConfig
from .weights import state_dict_from_jax

__all__ = [
    "LAYOUT_KEYS",
    "Classifier",
    "DenseClassifier",
    "DenseModel",
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


class DenseModel(nn.Module):
    """ViT encoder taps {2, 5, 8, 11} -> DPT decoder -> fp32 dense logits
    (B, H/2, W/2, num_classes): the JAX ``DenseClassifier.apply``
    (``factory.py:49-66``).  The encoder has no head."""

    def __init__(self, encoder: ViT, dpt: DPT):
        super().__init__()
        self.encoder = encoder
        self.dpt = dpt

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        taps = self.encoder.vit_tap_features(images, TAP_BLOCKS)
        return dpt_forward(self.dpt, taps).float()


@dataclass(frozen=True)
class DenseClassifier:
    """The reference's ``dense=True`` composition (``models.py:117-130``).
    ``model``'s parameters are ``encoder.*`` and ``dpt.*``, the JAX
    ``{"encoder": ..., "dpt": ...}``, so freeze regimes can scale the two
    apart."""

    model: DenseModel
    cfg: ViTConfig
    dpt_cfg: DPTConfig
    scheme: str


def _as_dense(classifier: Classifier, generator: torch.Generator, num_classes: int,
              readout: str = "ignore") -> DenseClassifier:
    """Wrap a pooled classifier's encoder (its head dropped) with a fresh DPT
    decoder drawn from ``generator`` on the encoder's device.  ``readout``
    selects the cls-token readout operator — ignore/add/project, the
    reference's ``get_readout_oper`` (``DPT_decoder.py:52-60``)."""
    encoder = classifier.model
    encoder.head = None
    dpt_cfg = DPTConfig(
        embed_dim=classifier.cfg.embed_dim,
        num_classes=num_classes,
        grid_size=classifier.cfg.grid_size,
        readout=readout,
    )
    dpt = DPT(dpt_cfg, generator).to(next(encoder.parameters()).device)
    return DenseClassifier(DenseModel(encoder, dpt), classifier.cfg, dpt_cfg, classifier.scheme)


def _as_float32(tree):
    """Every leaf of a nested dict as fp32 numpy (a bfloat16 tensor of a
    ``.pth`` included), as the JAX ``_as_jax`` casts an imported tree."""
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree, dtype=np.float32)


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
    ``weight_path`` (decoder discarded; the fixed sin-cos position table is
    the file's), else from the generator; the head is always fresh from the
    generator.  ``weight_path`` is a ``.ckpt`` as either package's
    pretraining writes it or a reference-format torch ``.pth``
    (``ckpt["model"]`` state dicts)."""
    if jax_params is not None and weight_path is not None:
        raise ValueError("pass jax_params or weight_path, not both")
    pos_embed = overrides.pop("pos_embed", "sincos")
    out_token = overrides.pop("out_token", out_token)
    cfg = _vit_b(num_classes, out_token, pos_embed, **overrides)
    if weight_path is not None:
        jax_params = _load_mae_encoder(weight_path, cfg)
    return Classifier(_build(generator, cfg, jax_params, device), cfg, scheme)


def _load_mae_encoder(weight_path: str | Path, cfg: ViTConfig) -> Dict[str, Any]:
    """The JAX-layout fp32 encoder tree of an MAE checkpoint: a ``.ckpt`` (or
    its ``.ckpt.json`` sidecar's path), then, in the JAX order, any other
    path as msgpack first and as a torch ``.pth`` after."""
    path = Path(weight_path)
    if path.name.endswith(".ckpt.json"):
        path = path.with_suffix("")  # the checkpoint beside its sidecar
    if path.suffix == ".ckpt":
        mae_params = load_checkpoint(path)["payload"].get("params")
        if mae_params is None:
            raise ValueError(f"Native checkpoint {path} lacks a 'params' payload")
        return _as_float32(encoder_only(mae_params))
    try:
        restored = load_checkpoint(path)
        mae_params = restored.get("payload", {}).get("params")
        if mae_params is not None:
            return _as_float32(encoder_only(mae_params))
    except Exception:  # not msgpack: read it as a torch pickle
        pass
    state = _as_float32(load_torch_state_dict(path, key="model"))
    return mae_params_from_torch(state, cfg, include_decoder=False)


def get_imagenet_or_random_vit(
    generator: torch.Generator,
    jax_params: Optional[Mapping[str, Any]] = None,
    num_classes: Optional[int] = 2,
    out_token: str = "cls",
    device: str | torch.device = "cuda",
    pretrained_npz: Optional[str | Path] = None,
    **overrides,
) -> Classifier:
    """timm-lineage ViT-B (learned positions): AugReg weights when a local
    ``.npz`` is given (``"auto"``: the cache's conventional path,
    :func:`.augreg_cache.default_path`), else ``jax_params``, else random;
    the head is always fresh.  The scheme is ``"sup_imnet"`` only where a
    file was read, as in the JAX factory."""
    if jax_params is not None and pretrained_npz is not None:
        raise ValueError("pass jax_params or pretrained_npz, not both")
    pos_embed = overrides.pop("pos_embed", "learned")
    out_token = overrides.pop("out_token", out_token)
    cfg = _vit_b(num_classes, out_token, pos_embed, **overrides)
    scheme = "random"
    if pretrained_npz == "auto":
        # Conventional cache location filled by scripts/fetch_augreg.py on
        # an internet-connected host (the offline half of the reference's
        # fetch-and-cache flow, models.py:52-55,225).
        from .augreg_cache import default_path

        pretrained_npz = default_path()
    if pretrained_npz is not None:
        npz = Path(pretrained_npz)
        if not npz.exists():
            raise FileNotFoundError(
                f"AugReg checkpoint not found at {npz}. This environment has no "
                "network egress; run scripts/fetch_augreg.py on an internet "
                "host, ship the npz, and point the model config checkpoint "
                "field (or SSL4POLYP_TPU_CACHE) at it."
            )
        jax_params = _as_float32(vit_params_from_augreg_npz(npz, cfg))
        scheme = "sup_imnet"
    return Classifier(_build(generator, cfg, jax_params, device), cfg, scheme)


def build_classifier(
    generator: torch.Generator,
    model_cfg: Mapping[str, Any],
    num_classes: int = 2,
    checkpoint_root: Optional[Path] = None,
    jax_params: Optional[Mapping[str, Any]] = None,
    device: str | torch.device = "cuda",
    **overrides,
) -> Classifier | DenseClassifier:
    """Build a classifier from a ``model:`` config section.

    Dispatch follows the JAX factory: ``ss_framework: mae`` (or MAE
    pretraining) -> MAE backbone, whose encoder comes from the
    ``checkpoint`` (a ``.ckpt`` or a ``.pth``) when that file exists;
    ``pretraining: ImageNet_class`` -> timm lineage, from the ``checkpoint``
    (an AugReg ``.npz``) when that file exists; otherwise random init.  A
    ``checkpoint`` that does not exist means random init, with no error, as
    in the JAX factory.  ``jax_params``, when given, are the encoder's
    weights in every case.  ``dense: true`` (config key or kwarg) wires the
    encoder taps {2, 5, 8, 11} into the DPT decoder, whose readout is
    ``dense_readout`` (``ignore``, ``add`` or ``project``), and returns a
    :class:`DenseClassifier`; its decoder is drawn from ``generator`` after
    the encoder.
    """
    dense = bool(overrides.pop("dense", model_cfg.get("dense", False)))
    dense_readout = str(
        overrides.pop("dense_readout", model_cfg.get("dense_readout", "ignore"))
    )
    pretraining = str(model_cfg.get("pretraining", "random")).lower()
    ss_framework = str(model_cfg.get("ss_framework", "")).lower()
    weight = None
    checkpoint = model_cfg.get("checkpoint")
    if checkpoint is not None and jax_params is None:
        path = Path(checkpoint)
        if checkpoint_root is not None and not path.is_absolute():
            path = checkpoint_root / path
        weight = path if path.exists() else None

    if ss_framework == "mae" or pretraining in {"hyperkvasir", "imagenet_self"}:
        classifier = get_mae_backbone(
            generator, jax_params, num_classes=num_classes,
            scheme=str(model_cfg.get("key", "ssl")), device=device, weight_path=weight,
            **overrides,
        )
    elif pretraining == "imagenet_class":
        classifier = get_imagenet_or_random_vit(
            generator, jax_params, num_classes=num_classes, device=device,
            pretrained_npz=weight, **overrides,
        )
    else:
        classifier = get_imagenet_or_random_vit(
            generator, jax_params, num_classes=num_classes, device=device, **overrides
        )
    if dense:
        return _as_dense(classifier, generator, num_classes, readout=dense_readout)
    return classifier
