"""Split evaluation over the port's forward.

Counterpart of ``ssl4polyp_tpu/evaluation/evaluate.py::evaluate_split``.  The
forward pass and the multi-process gather are the port's; the metric half
(losses, the metric suite, case, morphology and perturbation breakdowns) is
the JAX package's own host-side numpy code, imported inside the function so
that importing this module needs neither jax nor the metric stack.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

if TYPE_CHECKING:
    from ssl4polyp_tpu.data.loader import HostDataLoader
    from ssl4polyp_tpu.data.packs import PackIndex

__all__ = ["evaluate_split"]


def _all_gather(array: np.ndarray) -> np.ndarray:
    """Concatenate every rank's array in rank order (the loader stripes are
    fixed-shape and lockstep, as the JAX package's all-gather assumes)."""
    parts: List[Optional[np.ndarray]] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, array)
    return np.concatenate(parts)


def evaluate_split(
    forward: Callable[[Any], np.ndarray],
    loader: "HostDataLoader",
    index: "PackIndex",
    *,
    split_name: str,
    num_classes: int = 2,
    tau: Optional[float] = None,
    loss_mode: str = "binary_bce",
    pos_weight: float = 1.0,
    class_weights: Optional[Sequence[float]] = None,
    limit_batches: Optional[int] = None,
    morphology_eval: Optional[Sequence[str]] = None,
    perturbation_eval: bool = False,
) -> Dict[str, Any]:
    """Run ``forward`` (uint8 batch -> fp32 logits) over a split and compute
    the JAX package's full metric set on the result.

    Under an initialised ``torch.distributed`` group every rank evaluates a
    disjoint loader stripe; the arrays are all-gathered so that every rank
    computes the same metrics and thresholds.
    """
    columns: Dict[str, List[np.ndarray]] = {"image": [], "label": [], "index": [], "valid": []}
    for batch_number, batch in enumerate(loader):
        if limit_batches is not None and batch_number >= limit_batches:
            break
        columns["image"].append(np.asarray(forward(batch["image"])))
        for key in ("label", "index", "valid"):
            columns[key].append(batch[key])
    if not columns["image"]:
        raise ValueError(f"Evaluation over split {split_name!r} saw no batches")
    gathered = {key: np.concatenate(parts) for key, parts in columns.items()}
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        gathered = {key: _all_gather(value) for key, value in gathered.items()}

    from ssl4polyp_tpu.evaluation import evaluate as reference

    # The gathered logits replay through the JAX package's evaluate_split as
    # one batch whose "image" is already the logits: its metric code runs
    # unchanged, and its own gather sees a single jax process.
    return reference.evaluate_split(
        lambda logits: logits, [gathered], index,
        split_name=split_name, num_classes=num_classes, tau=tau,
        loss_mode=loss_mode, pos_weight=pos_weight, class_weights=class_weights,
        morphology_eval=morphology_eval, perturbation_eval=perturbation_eval,
    )
