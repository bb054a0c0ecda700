"""Split evaluation with strata and perturbation breakdowns.

Counterpart of ``ssl4polyp_tpu/evaluation/evaluate.py`` (reference
``train_classification.py:4653-5495``): ``forward`` maps fixed-shape uint8
batches (padded tails masked by ``valid``) to logits; the logits gather to
the host, across the ranks of an initialised ``torch.distributed`` group,
and the metric suite, morphology strata and per-perturbation-tag / per-case
breakdowns run in numpy (:mod:`..metrics.performance`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Protocol, Sequence

import numpy as np
import torch.distributed as dist

from ..metrics import performance as perf

__all__ = [
    "binary_logit",
    "per_sample_losses",
    "canonical_perturbation_tag",
    "evaluate_split",
]


class SplitIndex(Protocol):
    """What :func:`evaluate_split` reads of a split's index: one metadata
    row per sample, addressed by the batches' ``index`` column."""

    meta: Sequence[Mapping[str, Any]]


_PLACEHOLDERS = {None, "", "-1", "-1.0", -1, -1.0}


def _is_placeholder(value: Any) -> bool:
    if value in _PLACEHOLDERS:
        return True
    try:
        return float(value) == -1.0
    except (TypeError, ValueError):
        return False


def _format_numeric(value: Any) -> str:
    try:
        number = float(value)
    except (TypeError, ValueError):
        return str(value)
    if number.is_integer():
        return str(int(number))
    return f"{number:g}"


def canonical_perturbation_tag(row: Mapping[str, Any]) -> Optional[str]:
    """Canonical tag for a row (reference ``train_classification.py:635-667``):
    explicit ``perturbation_id``, else composed ``field=value`` pairs, else
    the raw ``variant`` token."""
    if not isinstance(row, Mapping):
        return None
    candidate = row.get("perturbation_id")
    if not _is_placeholder(candidate):
        text = str(candidate).strip()
        if text:
            return text
    parts = []
    for field in ("blur_sigma", "jpeg_q", "brightness", "contrast", "bbox_area_frac"):
        value = row.get(field)
        if not _is_placeholder(value):
            parts.append(f"{field}={_format_numeric(value)}")
    if parts:
        return "|".join(parts)
    variant = row.get("variant")
    if not _is_placeholder(variant):
        text = str(variant).strip()
        if text:
            return text
    return None


def binary_logit(logits: np.ndarray) -> np.ndarray:
    """Collapse (N,2) logits to the positive-class logit margin z1−z0."""
    logits = np.asarray(logits, dtype=np.float64)
    if logits.ndim == 2 and logits.shape[1] == 2:
        return logits[:, 1] - logits[:, 0]
    if logits.ndim == 2 and logits.shape[1] == 1:
        return logits[:, 0]
    return logits.ravel()


def per_sample_losses(
    logits: np.ndarray,
    targets: np.ndarray,
    *,
    mode: str,
    pos_weight: float = 1.0,
    class_weights: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Per-sample loss (binary BCE-with-pos-weight or weighted CE).

    Downstream ``mean_loss`` blocks average these per FRAME.  For the
    binary path that matches the reference's per-batch mean exactly; for
    weighted CE the TRAINING loss divides by the sum of target weights
    (torch semantics, see ``training/classification.py::loss_from_logits``), so the eval
    diagnostic differs from the train loss by sum(w)/count on class-
    imbalanced subsets — fine for a monitoring value, noted for parity
    audits.
    """
    targets = np.asarray(targets).astype(np.int64)
    if mode == "binary_bce":
        z = binary_logit(logits)
        y = targets.astype(np.float64)
        # log-sigmoid stable forms
        log_sig = -np.logaddexp(0.0, -z)
        log_one_minus = -np.logaddexp(0.0, z)
        return -(pos_weight * y * log_sig + (1.0 - y) * log_one_minus)
    logits = np.asarray(logits, dtype=np.float64)
    shifted = logits - logits.max(axis=1, keepdims=True)
    log_probs = shifted - np.log(np.exp(shifted).sum(axis=1, keepdims=True))
    picked = log_probs[np.arange(len(targets)), targets]
    if class_weights is not None:
        weights = np.asarray(class_weights, dtype=np.float64)[targets]
        return -picked * weights
    return -picked


def _tag_sort_key(tag: str):
    if tag == "clean":
        return (0,)
    components = []
    for segment in str(tag).split("|"):
        name, _, value = segment.partition("=")
        name, value = name.strip(), value.strip()
        if not name and not value:
            continue
        try:
            components.append((name, 0, float(value)))
        except (TypeError, ValueError):
            components.append((name, 1, value))
    return (1, tuple(components))


def _subset_block(
    probs: np.ndarray,
    targets: np.ndarray,
    losses: np.ndarray,
    tau: Optional[float],
) -> Dict[str, float]:
    block = {
        "count": int(len(targets)),
        "recall": perf.mean_recall(probs, targets, 2, tau),
        "precision": perf.mean_precision(probs, targets, 2, tau),
        "f1": perf.mean_f1(probs, targets, 2, tau),
        "balanced_accuracy": perf.balanced_accuracy(probs, targets, 2, tau),
    }
    try:
        block["auroc"] = perf.mean_auroc(probs, targets, 2)
    except Exception:
        block["auroc"] = float("nan")
    try:
        block["auprc"] = perf.mean_auprc(probs, targets, 2)
    except Exception:
        block["auprc"] = float("nan")
    block["mean_loss"] = float(losses.mean()) if len(losses) else float("nan")
    return block


def _all_gather(array: np.ndarray) -> np.ndarray:
    """Concatenate every rank's array in rank order."""
    parts: List[Optional[np.ndarray]] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, array)
    return np.concatenate(parts)


def _case_block(targets: np.ndarray, preds: np.ndarray, average: str) -> Dict[str, float]:
    recall, f1 = perf.recall_f1(targets, preds, average)
    return {"recall": recall, "f1": f1, "count": float(len(targets))}


def evaluate_split(
    forward: Callable[[Any], np.ndarray],
    loader: Iterable[Mapping[str, Any]],
    index: SplitIndex,
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
    """Run the forward pass over a split and compute the full metric set.

    ``forward`` maps a uint8 image batch to fp32 logits; ``loader`` yields
    batches with ``image``, ``label``, ``index`` and ``valid`` columns.
    """
    all_logits: List[np.ndarray] = []
    all_targets: List[np.ndarray] = []
    all_positions: List[np.ndarray] = []
    all_valid: List[np.ndarray] = []
    for batch_number, batch in enumerate(loader):
        if limit_batches is not None and batch_number >= limit_batches:
            break
        all_logits.append(np.asarray(forward(batch["image"])))
        all_targets.append(batch["label"])
        all_positions.append(batch["index"])
        all_valid.append(batch["valid"])

    if not all_logits:
        raise ValueError(f"Evaluation over split {split_name!r} saw no batches")

    logits = np.concatenate(all_logits)
    targets = np.concatenate(all_targets)
    positions = np.concatenate(all_positions)
    valid = np.concatenate(all_valid)

    # Every rank evaluated a disjoint loader stripe (lockstep batch counts,
    # padding masked valid=False).  All-gather the fixed-shape per-rank
    # arrays so that EVERY rank computes identical metrics and thresholds:
    # divergent host-side decisions (early stop, best checkpoint, tau) would
    # desynchronise the ranks.  The gathered rows are rank 0's, then rank
    # 1's, ...: for an unshuffled split the stripes are contiguous and only
    # the last is padded, so after the valid filter the frames keep the
    # one-process order (unless ``limit_batches`` cut the stripes short).
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        logits, targets, positions, valid = (
            _all_gather(arr) for arr in (logits, targets, positions, valid)
        )

    logits = logits[valid]
    targets = targets[valid]
    positions = positions[valid]

    losses = per_sample_losses(
        logits, targets, mode=loss_mode, pos_weight=pos_weight, class_weights=class_weights
    )
    if num_classes == 2:
        probs = perf.as_binary_scores(logits)
    else:
        probs = perf.as_class_probabilities(logits, num_classes)

    results: Dict[str, Any] = perf.binary_metrics_block(
        probs, targets, tau=tau, loss=float(losses.mean())
    ) if num_classes == 2 else {"loss": float(losses.mean())}
    if num_classes != 2:
        results.update({
            "recall": perf.mean_recall(logits, targets, num_classes),
            "precision": perf.mean_precision(logits, targets, num_classes),
            "f1": perf.mean_f1(logits, targets, num_classes),
            "balanced_accuracy": perf.balanced_accuracy(logits, targets, num_classes),
            "auroc": perf.mean_auroc(logits, targets, num_classes),
            "auprc": perf.mean_auprc(logits, targets, num_classes),
        })

    threshold = 0.5 if tau is None else float(tau)
    preds = (
        (probs >= threshold).astype(np.int64)
        if num_classes == 2
        else np.argmax(probs, axis=1)
    )

    meta_rows = [index.meta[int(p)] if 0 <= int(p) < len(index.meta) else {} for p in positions]

    # ---- per-case breakdown (all splits) ---------------------------------
    # The reference's test() emits per-case metrics on every eval split
    # (train_classification.py:4653-5495), not only under perturbation runs.
    all_case_ids = np.asarray(
        [str(row.get("case_id", "") or "") for row in meta_rows], dtype=object
    )
    if any(all_case_ids != ""):
        # The positive class's recall and F1 for two classes, the macro
        # mean otherwise (the metric module's multiclass convention).
        _avg = "binary" if num_classes == 2 else "macro"
        case_metrics: Dict[str, Dict[str, float]] = {}
        for case in sorted({c for c in all_case_ids.tolist() if c}):
            mask = all_case_ids == case
            case_metrics[case] = _case_block(targets[mask], preds[mask], _avg)
        if case_metrics:
            results["case_metrics"] = case_metrics

    # ---- morphology strata (exp3) ---------------------------------------
    if morphology_eval:
        strata: Dict[str, Dict[str, float]] = {}
        morph_values = np.asarray(
            [str(row.get("morphology", "")).strip().lower() for row in meta_rows]
        )
        for stratum in morphology_eval:
            mask = morph_values == str(stratum).lower()
            if not mask.any():
                continue
            strata[str(stratum)] = _subset_block(
                probs[mask], targets[mask], losses[mask], tau
            )
        if strata:
            results["morphology_metrics"] = strata

    # ---- perturbation breakdowns (exp5b) ---------------------------------
    if perturbation_eval:
        tags = np.asarray(
            [canonical_perturbation_tag(row) or "clean" for row in meta_rows], dtype=object
        )
        case_ids = np.asarray(
            [str(row.get("case_id", "")) for row in meta_rows], dtype=object
        )
        per_tag: Dict[str, Dict[str, float]] = {}
        per_case: Dict[str, Dict[str, Dict[str, float]]] = {}

        def case_blocks(mask: np.ndarray) -> Dict[str, Dict[str, float]]:
            avg = "binary" if num_classes == 2 else "macro"
            blocks: Dict[str, Dict[str, float]] = {}
            for case in sorted(set(case_ids[mask].tolist())):
                case_mask = mask & (case_ids == case)
                if not case_mask.any():
                    continue
                blocks[case] = _case_block(targets[case_mask], preds[case_mask], avg)
            return blocks

        unique_tags = sorted(set(tags.tolist()), key=_tag_sort_key)
        for tag in unique_tags:
            mask = tags == tag
            if not mask.any():
                continue
            per_tag[tag] = _subset_block(probs[mask], targets[mask], losses[mask], tau)
            blocks = case_blocks(mask)
            if blocks:
                per_case[tag] = blocks
        non_clean = tags != "clean"
        if non_clean.any():
            per_tag["ALL-perturbed"] = _subset_block(
                probs[non_clean], targets[non_clean], losses[non_clean], tau
            )
            blocks = case_blocks(non_clean)
            if blocks:
                per_case["ALL-perturbed"] = blocks
        results["perturbation_metrics"] = per_tag
        if per_case:
            results["perturbation_case_metrics"] = per_case

    results["probabilities"] = probs
    results["targets"] = targets
    results["logits"] = logits
    results["positions"] = positions
    results["metadata_rows"] = meta_rows
    results["preds"] = preds
    return results
