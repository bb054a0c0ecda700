"""On-device normalisation of uint8 image batches.

Counterpart of ``normalize_batch`` in ``ssl4polyp_tpu/data/augment.py``.
The ImageNet statistics are copies of ``ssl4polyp_tpu/data/transforms.py``'s,
whose package imports PyYAML at import time.  The train-time augmentations
come with the fine-tune slice.
"""

from __future__ import annotations

import torch

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_batch"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_batch(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalised NHWC in ``dtype``, every step in ``dtype``."""
    x = images_u8.to(dtype) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=images_u8.device)
    return (x - mean) / std
