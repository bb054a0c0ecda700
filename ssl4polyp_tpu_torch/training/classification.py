"""The classifier's uint8 -> logits eval forward.

Counterpart of ``make_forward_fn`` in ``ssl4polyp_tpu/training/classification.py``;
the fine-tune engine comes with the training slice.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.augment import normalize_batch
from ..models.factory import Classifier
from ..models.layers import cast_params_for_compute

__all__ = ["make_forward_fn"]


def make_forward_fn(
    classifier: Classifier, device: str | torch.device
) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 NHWC numpy batch -> fp32 logits as numpy, run on ``device``.

    Moves the classifier's model to ``device`` and casts its matrices to the
    compute dtype once, in place (vectors stay fp32, as in the JAX recipe).
    The JAX version pads the batch to its data mesh; one device needs no
    padding, and several devices come with the multi-GPU slice.
    """
    device = torch.device(device)
    dtype = classifier.cfg.compute_dtype
    model = cast_params_for_compute(classifier.model.to(device), dtype).eval()

    def forward(images_u8: np.ndarray) -> np.ndarray:
        host = np.asarray(images_u8)
        if host.dtype != np.uint8 or host.ndim != 4:
            raise TypeError(f"expected a uint8 NHWC batch, got {host.dtype} {host.shape}")
        host = np.require(host, requirements=("C", "W"))
        with torch.inference_mode():
            images = normalize_batch(torch.from_numpy(host).to(device), dtype)
            return model(images).float().cpu().numpy()

    return forward
