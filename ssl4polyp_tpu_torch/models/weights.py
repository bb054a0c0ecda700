"""Map parameters between the JAX package's pytree and the port's state dict.

Counterpart of ``ssl4polyp_tpu/models/import_torch.py``.  The state dict
uses timm's names, so the JAX package's own ``mae_params_from_torch`` reads
it back.  The layouts differ in three ways:

* a JAX linear kernel is (in, out), a torch weight (out, in);
* the JAX patch-embed kernel is (P*P*C, D) with rows in (p, q, c) order,
  the torch one a (D, C, P, P) conv weight;
* JAX stacks the blocks along a leading depth axis, torch names each
  ``blocks.{i}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .vit import ViTConfig

__all__ = ["jax_from_state_dict", "state_dict_from_jax"]

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


def state_dict_from_jax(params: Mapping[str, Any], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """JAX ViT pytree (numpy leaves) -> fp32 state dict under timm's names."""
    p, c, d = cfg.patch_size, cfg.in_chans, cfg.embed_dim
    patch = np.asarray(params["patch_embed"]["kernel"]).reshape(p, p, c, d)
    state = {
        "patch_embed.proj.weight": _tensor(patch.transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _tensor(params["patch_embed"]["bias"]),
        "cls_token": _tensor(params["cls_token"]),
        "pos_embed": _tensor(params["pos_embed"]),
    }
    blocks = params["blocks"]
    depth = np.asarray(blocks["ln1"]["scale"]).shape[0]
    for i in range(depth):
        for name, path, kind in _BLOCK_PARTS:
            leaf = _get(blocks, path)
            prefix = f"blocks.{i}.{name}"
            if kind == "norm":
                state[f"{prefix}.weight"] = _tensor(leaf["scale"][i])
            else:
                state[f"{prefix}.weight"] = _tensor(np.asarray(leaf["kernel"][i]).T)
            state[f"{prefix}.bias"] = _tensor(leaf["bias"][i])
    state["norm.weight"] = _tensor(params["norm"]["scale"])
    state["norm.bias"] = _tensor(params["norm"]["bias"])
    if "head" in params:
        state["head.weight"] = _tensor(np.asarray(params["head"]["kernel"]).T)
        state["head.bias"] = _tensor(params["head"]["bias"])
    return state


def jax_from_state_dict(state: Mapping[str, torch.Tensor], cfg: ViTConfig) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: numpy fp32 leaves."""
    def arr(name):
        return state[name].detach().cpu().float().numpy()

    weight = arr("patch_embed.proj.weight")  # (D, C, P, P)
    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0).reshape(-1, cfg.embed_dim)),
            "bias": arr("patch_embed.proj.bias"),
        },
        "cls_token": arr("cls_token"),
        "pos_embed": arr("pos_embed"),
        "blocks": {},
        "norm": {"scale": arr("norm.weight"), "bias": arr("norm.bias")},
    }
    depth = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
    for name, path, kind in _BLOCK_PARTS:
        node = params["blocks"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        weights = [arr(f"blocks.{i}.{name}.weight") for i in range(depth)]
        biases = np.stack([arr(f"blocks.{i}.{name}.bias") for i in range(depth)])
        if kind == "norm":
            node[path[-1]] = {"scale": np.stack(weights), "bias": biases}
        else:
            kernels = np.stack([np.ascontiguousarray(w.T) for w in weights])
            node[path[-1]] = {"kernel": kernels, "bias": biases}
    if "head.weight" in state:
        params["head"] = {
            "kernel": np.ascontiguousarray(arr("head.weight").T),
            "bias": arr("head.bias"),
        }
    return params
