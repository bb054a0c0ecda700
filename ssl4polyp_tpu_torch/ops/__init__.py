"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

The kernels build at first use (:mod:`._build`); importing this package
needs neither nvcc nor a GPU.
"""

from __future__ import annotations

from . import (adamw, attention, attention_block, attn_proj, layernorm, ln_linear, mlp,
               qkv_attention)

__all__ = ["launch_counts", "reset_launch_counts"]

# Launch counter of each kernel: (module, name of its count).
_COUNTERS = {
    "fused_qkv_attention": (qkv_attention, "launches"),
    "fused_qkv_attention_backward": (qkv_attention, "backward_launches"),
    "layernorm": (layernorm, "launches"),
    "layernorm_backward": (layernorm, "backward_launches"),
    "fc1_gelu": (mlp, "launches"),
    "mlp_fused": (mlp, "fused_launches"),
    "mlp_ln_fused": (mlp, "ln_fused_launches"),
    "ln_linear": (ln_linear, "launches"),
    "attn_proj": (attn_proj, "launches"),
    "attn_proj_backward": (attn_proj, "backward_launches"),
    "adamw": (adamw, "launches"),
    "fused_attention": (attention, "launches"),
    "fused_attention_backward": (attention, "backward_launches"),
    "fused_qkvproj_attention": (attention_block, "launches"),
    "fused_qkvproj_attention_backward": (attention_block, "backward_launches"),
    # The fp32 kernels of the default route (the runs that compute in fp32).
    "fused_qkv_attention_f32": (qkv_attention, "launches_f32"),
    "fused_qkv_attention_backward_f32": (qkv_attention, "backward_launches_f32"),
    "layernorm_f32": (layernorm, "launches_f32"),
    "layernorm_backward_f32": (layernorm, "backward_launches_f32"),
    "fc1_gelu_f32": (mlp, "launches_f32"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(module, attr) for name, (module, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for module, attr in _COUNTERS.values():
        setattr(module, attr, 0)
