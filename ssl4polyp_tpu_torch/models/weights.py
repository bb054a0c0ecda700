"""Map parameters between the JAX package's pytree and the port's state dict.

Counterpart of ``ssl4polyp_tpu/models/import_torch.py``.  The state dict
uses timm's names, so the JAX package's own ``mae_params_from_torch`` reads
it back.  The layouts differ in three ways:

* a JAX linear kernel is (in, out), a torch weight (out, in);
* the JAX patch-embed kernel is (P*P*C, D) with rows in (p, q, c) order,
  the torch one a (D, C, P, P) conv weight;
* JAX stacks the blocks along a leading depth axis, torch names each
  ``blocks.{i}`` (``decoder_blocks.{i}`` in the MAE decoder).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .vit import ViTConfig

__all__ = [
    "jax_from_mae_state_dict",
    "jax_from_state_dict",
    "mae_state_dict_from_jax",
    "state_dict_from_jax",
]

# (torch sub-name, JAX path inside a block, kind) for each block tensor pair.
_BLOCK_PARTS = (
    ("norm1", ("ln1",), "norm"),
    ("attn.qkv", ("attn", "qkv"), "linear"),
    ("attn.proj", ("attn", "proj"), "linear"),
    ("norm2", ("ln2",), "norm"),
    ("mlp.fc1", ("mlp", "fc1"), "linear"),
    ("mlp.fc2", ("mlp", "fc2"), "linear"),
)


def _get(tree: Mapping[str, Any], path) -> Mapping[str, Any]:
    for key in path:
        tree = tree[key]
    return tree


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32))


def _linear_to_state(leaf: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _tensor(np.asarray(leaf["kernel"]).T),
            f"{prefix}.bias": _tensor(leaf["bias"])}


def _norm_to_state(leaf: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _tensor(leaf["scale"]), f"{prefix}.bias": _tensor(leaf["bias"])}


def _blocks_to_state(blocks: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """Stacked JAX blocks -> ``{prefix}.{i}.*`` tensors."""
    state = {}
    depth = np.asarray(blocks["ln1"]["scale"]).shape[0]
    for i in range(depth):
        for name, path, kind in _BLOCK_PARTS:
            leaf = {k: np.asarray(v)[i] for k, v in _get(blocks, path).items()}
            to_state = _norm_to_state if kind == "norm" else _linear_to_state
            state.update(to_state(leaf, f"{prefix}.{i}.{name}"))
    return state


def _encoder_to_state(params: Mapping[str, Any], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    p, c, d = cfg.patch_size, cfg.in_chans, cfg.embed_dim
    patch = np.asarray(params["patch_embed"]["kernel"]).reshape(p, p, c, d)
    return {
        "patch_embed.proj.weight": _tensor(patch.transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _tensor(params["patch_embed"]["bias"]),
        "cls_token": _tensor(params["cls_token"]),
        "pos_embed": _tensor(params["pos_embed"]),
        **_blocks_to_state(params["blocks"], "blocks"),
        **_norm_to_state(params["norm"], "norm"),
    }


def state_dict_from_jax(params: Mapping[str, Any], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """JAX ViT pytree (numpy leaves) -> fp32 state dict under timm's names."""
    state = _encoder_to_state(params, cfg)
    if "head" in params:
        state.update(_linear_to_state(params["head"], "head"))
    return state


def mae_state_dict_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX MAE pytree (encoder and ``decoder``, numpy leaves) -> fp32 state
    dict under timm's MAE names; ``cfg`` is the port's ``MAEConfig``."""
    dec = params["decoder"]
    return {
        **_encoder_to_state(params, cfg.encoder),
        **_linear_to_state(dec["embed"], "decoder_embed"),
        "mask_token": _tensor(dec["mask_token"]),
        "decoder_pos_embed": _tensor(dec["pos_embed"]),
        **_blocks_to_state(dec["blocks"], "decoder_blocks"),
        **_norm_to_state(dec["norm"], "decoder_norm"),
        **_linear_to_state(dec["pred"], "decoder_pred"),
    }


def _array(state: Mapping[str, torch.Tensor], name: str) -> np.ndarray:
    return state[name].detach().cpu().float().numpy()


def _linear_from_state(state, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(_array(state, f"{prefix}.weight").T),
            "bias": _array(state, f"{prefix}.bias")}


def _norm_from_state(state, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _array(state, f"{prefix}.weight"), "bias": _array(state, f"{prefix}.bias")}


def _blocks_from_state(state, prefix: str) -> Dict[str, Any]:
    """``{prefix}.{i}.*`` tensors -> stacked JAX blocks."""
    depth = 1 + max(int(k.split(".")[1]) for k in state if k.startswith(f"{prefix}."))
    blocks: Dict[str, Any] = {}
    for name, path, kind in _BLOCK_PARTS:
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        from_state = _norm_from_state if kind == "norm" else _linear_from_state
        leaves = [from_state(state, f"{prefix}.{i}.{name}") for i in range(depth)]
        node[path[-1]] = {k: np.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    return blocks


def _encoder_from_state(state, cfg: ViTConfig) -> Dict[str, Any]:
    weight = _array(state, "patch_embed.proj.weight")  # (D, C, P, P)
    return {
        "patch_embed": {
            "kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0).reshape(-1, cfg.embed_dim)),
            "bias": _array(state, "patch_embed.proj.bias"),
        },
        "cls_token": _array(state, "cls_token"),
        "pos_embed": _array(state, "pos_embed"),
        "blocks": _blocks_from_state(state, "blocks"),
        "norm": _norm_from_state(state, "norm"),
    }


def jax_from_state_dict(state: Mapping[str, torch.Tensor], cfg: ViTConfig) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: numpy fp32 leaves."""
    params = _encoder_from_state(state, cfg)
    if "head.weight" in state:
        params["head"] = _linear_from_state(state, "head")
    return params


def jax_from_mae_state_dict(state: Mapping[str, torch.Tensor], cfg) -> Dict[str, Any]:
    """The inverse of :func:`mae_state_dict_from_jax`: numpy fp32 leaves."""
    params = _encoder_from_state(state, cfg.encoder)
    params["decoder"] = {
        "embed": _linear_from_state(state, "decoder_embed"),
        "mask_token": _array(state, "mask_token"),
        "pos_embed": _array(state, "decoder_pos_embed"),
        "blocks": _blocks_from_state(state, "decoder_blocks"),
        "norm": _norm_from_state(state, "decoder_norm"),
        "pred": _linear_from_state(state, "decoder_pred"),
    }
    return params
