"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

The kernels build at first use (:mod:`._build`); importing this package
needs neither nvcc nor a GPU.
"""

from __future__ import annotations

from . import mlp, qkv_attention

__all__ = ["launch_counts", "reset_launch_counts"]

_KERNEL_MODULES = {"fused_qkv_attention": qkv_attention, "fc1_gelu": mlp}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: module.launches for name, module in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for module in _KERNEL_MODULES.values():
        module.launches = 0
