"""Import pretrained weights from reference-format checkpoints.

Counterpart of ``ssl4polyp_tpu/models/import_torch.py``, copied: the mapping
code is numpy-only and returns the JAX package's pytree layout, which
:func:`.weights.state_dict_from_jax` then carries into the port's modules
(the one carry-across function).  Three initialisation schemes must be
importable for study parity (reference
``src/ssl4polyp/models/models.py:52-55,168-170``):

* **MAE torch checkpoints** (``ckpt["model"]``) for SSL-imnet / SSL-colon —
  read by :mod:`.pth_reader` (``torch.load`` with ``weights_only=True``) and
  mapped onto the functional pytree layout;
* **AugReg ``.npz``** (big_vision export) for SUP-imnet — read with numpy;
* random init (no import).

Layout conversions:

* torch ``nn.Linear`` stores ``(out, in)`` → transposed to ``(in, out)``;
* the torch conv patch-embed ``(D, C, P, P)`` becomes the JAX matmul kernel
  ``(P²·C, D)`` with row order ``(p, q, c)``;
* per-block tensors are stacked along a leading depth axis.

The JAX loader falls back to torch's unrestricted unpickler for a graph
outside its reader's subset, which runs arbitrary callables from a weight
file.  The port does not: such a file raises
:class:`.pth_reader.TorchUnpickleError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np

from .pth_reader import read_pth_state_dict
from .vit import ViTConfig

Params = Dict[str, Any]

__all__ = [
    "load_torch_state_dict",
    "mae_params_from_torch",
    "vit_params_from_augreg_npz",
]


def load_torch_state_dict(path: str | Path, key: Optional[str] = "model") -> Dict[str, Any]:
    """Read a torch ``.pth`` checkpoint into a flat state dict of numpy
    arrays (bfloat16 tensors stay CPU tensors; see :mod:`.pth_reader`).
    ``key`` and the fallback keys (``state_dict``, ``model``,
    ``model_state``, ``weights``, ``params``) choose the state dict inside
    the checkpoint, as in the JAX loader."""
    return read_pth_state_dict(path, key=key)


def _linear(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": np.ascontiguousarray(state[f"{prefix}.weight"].T),
        "bias": np.ascontiguousarray(state[f"{prefix}.bias"]),
    }


def _layernorm(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": np.ascontiguousarray(state[f"{prefix}.weight"]),
        "bias": np.ascontiguousarray(state[f"{prefix}.bias"]),
    }


def _stack_blocks(state: Mapping[str, np.ndarray], prefix: str, depth: int) -> Dict[str, Any]:
    """Stack per-block torch tensors into the scanned layout."""
    def gather(maker, sub):
        items = [maker(state, f"{prefix}.{i}.{sub}") for i in range(depth)]
        return {
            key: np.stack([item[key] for item in items]) for key in items[0]
        }

    return {
        "ln1": gather(_layernorm, "norm1"),
        "attn": {
            "qkv": gather(_linear, "attn.qkv"),
            "proj": gather(_linear, "attn.proj"),
        },
        "ln2": gather(_layernorm, "norm2"),
        "mlp": {
            "fc1": gather(_linear, "mlp.fc1"),
            "fc2": gather(_linear, "mlp.fc2"),
        },
    }


def _patch_embed(state: Mapping[str, np.ndarray], prefix: str = "patch_embed.proj") -> Dict[str, np.ndarray]:
    weight = state[f"{prefix}.weight"]  # (D, C, P, P)
    kernel = np.ascontiguousarray(weight.transpose(2, 3, 1, 0).reshape(-1, weight.shape[0]))
    return {"kernel": kernel, "bias": np.ascontiguousarray(state[f"{prefix}.bias"])}


def mae_params_from_torch(
    state: Mapping[str, np.ndarray],
    cfg_encoder: ViTConfig,
    include_decoder: bool = False,
    decoder_depth: int = 8,
) -> Params:
    """Map an MAE torch state dict onto the functional pytree.

    Works for both the full MAE (pretraining resume) and encoder-only use
    (classifier init, where the reference deletes the decoder —
    ``models.py:171-175``).
    """
    params: Params = {
        "patch_embed": _patch_embed(state),
        "cls_token": np.ascontiguousarray(state["cls_token"]),
        "pos_embed": np.ascontiguousarray(state["pos_embed"]),
        "blocks": _stack_blocks(state, "blocks", cfg_encoder.depth),
        "norm": _layernorm(state, "norm"),
    }
    if include_decoder and "decoder_embed.weight" in state:
        params["decoder"] = {
            "embed": _linear(state, "decoder_embed"),
            "mask_token": np.ascontiguousarray(state["mask_token"]),
            "pos_embed": np.ascontiguousarray(state["decoder_pos_embed"]),
            "blocks": _stack_blocks(state, "decoder_blocks", decoder_depth),
            "norm": _layernorm(state, "decoder_norm"),
            "pred": _linear(state, "decoder_pred"),
        }
    return params


def vit_params_from_augreg_npz(path: str | Path, cfg: ViTConfig) -> Params:
    """Load a big_vision AugReg ``.npz`` (the SUP-imnet initialisation).

    The npz patch-embed kernel is (P, P, C, D) in HWIO order whose flatten
    order (p, q, c) matches :func:`embed_patches` directly.  Q/K/V kernels
    are (D, H, hd) and are fused into a single (D, 3D) QKV kernel.
    """
    archive = np.load(str(path))

    def get(name: str) -> np.ndarray:
        return np.asarray(archive[name])

    D = cfg.embed_dim
    depth = cfg.depth

    def block(i: int) -> Dict[str, Any]:
        base = f"Transformer/encoderblock_{i}"
        attn = f"{base}/MultiHeadDotProductAttention_1"
        q_k = get(f"{attn}/query/kernel").reshape(D, D)
        k_k = get(f"{attn}/key/kernel").reshape(D, D)
        v_k = get(f"{attn}/value/kernel").reshape(D, D)
        q_b = get(f"{attn}/query/bias").reshape(D)
        k_b = get(f"{attn}/key/bias").reshape(D)
        v_b = get(f"{attn}/value/bias").reshape(D)
        return {
            "ln1": {
                "scale": get(f"{base}/LayerNorm_0/scale"),
                "bias": get(f"{base}/LayerNorm_0/bias"),
            },
            "attn": {
                "qkv": {
                    "kernel": np.concatenate([q_k, k_k, v_k], axis=1),
                    "bias": np.concatenate([q_b, k_b, v_b]),
                },
                "proj": {
                    "kernel": get(f"{attn}/out/kernel").reshape(D, D),
                    "bias": get(f"{attn}/out/bias"),
                },
            },
            "ln2": {
                "scale": get(f"{base}/LayerNorm_2/scale"),
                "bias": get(f"{base}/LayerNorm_2/bias"),
            },
            "mlp": {
                "fc1": {
                    "kernel": get(f"{base}/MlpBlock_3/Dense_0/kernel"),
                    "bias": get(f"{base}/MlpBlock_3/Dense_0/bias"),
                },
                "fc2": {
                    "kernel": get(f"{base}/MlpBlock_3/Dense_1/kernel"),
                    "bias": get(f"{base}/MlpBlock_3/Dense_1/bias"),
                },
            },
        }

    blocks = [block(i) for i in range(depth)]

    def stack(path_fn):
        first = path_fn(blocks[0])
        return {k: np.stack([path_fn(b)[k] for b in blocks]) for k in first}

    params: Params = {
        "patch_embed": {
            "kernel": get("embedding/kernel").reshape(-1, D),
            "bias": get("embedding/bias"),
        },
        "cls_token": get("cls").reshape(1, 1, D),
        "pos_embed": get("Transformer/posembed_input/pos_embedding"),
        "blocks": {
            "ln1": stack(lambda b: b["ln1"]),
            "attn": {
                "qkv": stack(lambda b: b["attn"]["qkv"]),
                "proj": stack(lambda b: b["attn"]["proj"]),
            },
            "ln2": stack(lambda b: b["ln2"]),
            "mlp": {
                "fc1": stack(lambda b: b["mlp"]["fc1"]),
                "fc2": stack(lambda b: b["mlp"]["fc2"]),
            },
        },
        "norm": {
            "scale": get("Transformer/encoder_norm/scale"),
            "bias": get("Transformer/encoder_norm/bias"),
        },
    }
    return params
