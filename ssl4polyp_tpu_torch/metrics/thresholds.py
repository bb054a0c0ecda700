"""Decision-threshold policies with deterministic tie-breaking.

The port's copy of ``ssl4polyp_tpu/metrics/thresholds.py``, on numpy alone
(the ROC curve behind the Youden optimum is written out here, where the JAX
package calls scikit-learn).  Behavioural parity with the reference threshold module
(``src/ssl4polyp/classification/metrics/thresholds.py``):

* candidate grid = unique scores ∪ {0, 1}, subsampled to ≤200 points;
* policies: ``f1_opt_on_val`` (maximise F1), ``youden_on_val`` /
  ``val_opt_youden`` (maximise J = TPR − FPR);
* ties break toward higher recall then lower τ;
* degenerate validation splits (single class) carry the previous τ forward
  or default to 0.5, recorded as ``degenerate_val``;
* frozen-SUN reuse validates the source split and annotates provenance;
* persistence as a small JSON ``{"thresholds": {key: value}}`` document with
  ``{dataset}_{split}_{policy}`` keys.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .performance import _binary_clf_curve, _check_scores

_EPS = 1e-12
MAX_CANDIDATES = 200
SUPPORTED_POLICIES = ("f1_opt_on_val", "youden_on_val", "val_opt_youden")

__all__ = [
    "ThresholdResult",
    "compute_policy_threshold",
    "compute_youden_threshold",
    "format_threshold_key",
    "save_thresholds",
    "load_thresholds",
    "resolve_threshold",
    "resolve_frozen_sun_threshold",
]


@dataclass(frozen=True)
class ThresholdResult:
    tau: float
    record: Dict[str, Any]
    metrics: Dict[str, float]
    candidates: Sequence[float] = field(default_factory=list)


def format_threshold_key(dataset: str, split: str, policy: str) -> str:
    return f"{dataset.lower()}_{split.lower()}_{policy.lower()}"


def save_thresholds(
    path: str | Path,
    thresholds: Mapping[str, float],
    *,
    primary: bool = True,
) -> None:
    """Write a threshold store; only the primary process writes (a caller
    that runs one process per GPU passes ``rank == 0``)."""
    if not primary:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    document = {"thresholds": {k: float(v) for k, v in thresholds.items()}}
    path.write_text(json.dumps(document, indent=2), encoding="utf-8")


def load_thresholds(path: str | Path) -> Dict[str, float]:
    payload = json.loads(Path(path).read_text(encoding="utf-8")) or {}
    raw = payload.get("thresholds", payload)
    out: Dict[str, float] = {}
    for key, value in raw.items():
        out[key] = float(value)
    return out


def resolve_threshold(thresholds: Mapping[str, float], key: Optional[str]) -> Optional[float]:
    if key is None or key not in thresholds:
        return None
    return float(thresholds[key])


def _candidate_grid(scores: np.ndarray) -> np.ndarray:
    """Unique scores ∪ {0,1}, clipped, evenly subsampled to the budget."""
    grid = np.unique(np.concatenate(([0.0], np.unique(scores), [1.0])))
    grid = np.unique(np.clip(grid, 0.0, 1.0))
    if grid.size <= MAX_CANDIDATES:
        return grid.astype(float)
    picks = np.linspace(0, grid.size - 1, num=MAX_CANDIDATES).astype(int)
    picks[0], picks[-1] = 0, grid.size - 1
    return grid[picks].astype(float)


def _confusion_at(scores: np.ndarray, labels: np.ndarray, taus: np.ndarray):
    preds = scores[:, None] >= taus[None, :]
    pos = labels[:, None] == 1
    tp = (preds & pos).sum(axis=0).astype(np.int64)
    fp = (preds & ~pos).sum(axis=0).astype(np.int64)
    fn = (~preds & pos).sum(axis=0).astype(np.int64)
    tn = (~preds & ~pos).sum(axis=0).astype(np.int64)
    return tp, fp, tn, fn


def _div(num, denom):
    out = np.zeros_like(num, dtype=float)
    good = denom > 0
    out[good] = num[good] / denom[good]
    return out


def _metrics_at(tp: int, fp: int, tn: int, fn: int) -> Dict[str, float]:
    recall = tp / (tp + fn) if tp + fn else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    f1 = (2 * tp) / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    fpr = fp / (fp + tn) if fp + tn else 0.0
    return {
        "tp": float(tp), "fp": float(fp), "tn": float(tn), "fn": float(fn),
        "recall": recall, "precision": precision, "f1": f1,
        "tpr": recall, "fpr": fpr, "youden_j": recall - fpr,
    }


def compute_policy_threshold(
    scores: Sequence[float],
    labels: Sequence[int],
    *,
    policy: str,
    split_name: str,
    epoch: int,
    previous_tau: Optional[float] = None,
) -> ThresholdResult:
    policy = policy.strip().lower()
    if policy not in SUPPORTED_POLICIES:
        raise ValueError(f"Unsupported threshold policy {policy!r}")

    scores_np = np.asarray(scores, dtype=float).ravel()
    labels_np = np.asarray(labels, dtype=int).ravel()
    if scores_np.size == 0:
        raise ValueError("Cannot derive a threshold from empty scores")
    if scores_np.size != labels_np.size:
        raise ValueError("scores and labels length mismatch")

    tiebreakers = ["higher_recall", "lower_tau"]
    degenerate = np.unique(labels_np).size < 2
    notes: Dict[str, Any] = {}
    if degenerate:
        if previous_tau is not None and math.isfinite(previous_tau):
            tau = float(previous_tau)
            notes["carried_forward"] = True
        else:
            tau = 0.5
            notes["default_tau"] = 0.5
        tp, fp, tn, fn = _confusion_at(scores_np, labels_np, np.asarray([tau]))
        record = {
            "policy": policy, "tau": tau, "split": split_name,
            "n_candidates": 0, "tiebreakers": tiebreakers, "epoch": int(epoch),
            "degenerate_val": True, "notes": notes,
        }
        return ThresholdResult(
            tau=tau, record=record,
            metrics=_metrics_at(int(tp[0]), int(fp[0]), int(tn[0]), int(fn[0])),
            candidates=[tau],
        )

    taus = _candidate_grid(scores_np)
    tp, fp, tn, fn = _confusion_at(scores_np, labels_np, taus)
    recalls = _div(tp, tp + fn)
    f1s = _div(2 * tp, 2 * tp + fp + fn)
    fprs = _div(fp, fp + tn)
    objective = f1s if policy == "f1_opt_on_val" else recalls - fprs

    best = objective.max()
    survivors = np.where(objective >= best - _EPS)[0]
    # tie-break 1: higher recall
    if survivors.size > 1:
        top_recall = recalls[survivors].max()
        survivors = survivors[recalls[survivors] >= top_recall - _EPS]
    # tie-break 2: lower tau (grid is sorted ascending)
    chosen = int(survivors[0])

    tau = float(taus[chosen])
    metrics = _metrics_at(int(tp[chosen]), int(fp[chosen]), int(tn[chosen]), int(fn[chosen]))
    record = {
        "policy": policy, "tau": tau, "split": split_name,
        "n_candidates": int(taus.size), "tiebreakers": tiebreakers,
        "epoch": int(epoch), "degenerate_val": False, "notes": notes,
        "metrics": dict(metrics),
    }
    return ThresholdResult(tau=tau, record=record, metrics=metrics, candidates=taus.tolist())


def _roc_curve(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve`` returns them
    for labels in {0, 1} or {-1, 1} (1 is the positive class): one point per
    distinct score, scores descending, collinear interior points dropped, and
    the (0, 0) point with an infinite threshold in front."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores, dtype=float).ravel()
    _check_scores(labels, scores)
    present = set(np.unique(labels).tolist())
    if not (present <= {0, 1} or present <= {-1, 1}):
        raise ValueError(f"labels {sorted(present)} are not binary in {{0, 1}} or {{-1, 1}}")
    fps, tps = _binary_clf_curve(labels == 1, scores)
    thresholds = np.unique(scores)[::-1]
    if fps.size > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    thresholds = np.r_[np.inf, thresholds]
    with np.errstate(divide="ignore", invalid="ignore"):
        return fps / fps[-1], tps / tps[-1], thresholds


def compute_youden_threshold(logits_or_scores, targets, *,
                             inputs: str = "probs") -> float:
    """Youden-J optimum on the ROC curve (scikit-learn's ``roc_curve``
    semantics incl. the inf-threshold guard: reference
    ``thresholds.py:68-110``).

    ``inputs`` makes the score space EXPLICIT instead of range-sniffed:
    ``"probs"`` (this pipeline's convention — every caller passes
    positive-class probabilities) uses the values as-is; ``"logits"``
    applies sigmoid/softmax unconditionally like the reference's
    ``_prepare_binary_scores`` (``thresholds.py:50-62``).  Range-sniffing
    was unsound: raw logits that incidentally lie in [0, 1] on the
    threshold split would silently produce a logit-space τ later applied
    to probabilities.
    """
    array = np.asarray(logits_or_scores, dtype=float)
    if inputs == "probs":
        if array.ndim == 2:
            array = array[:, -1]
        if array.size and (array.min() < -1e-6 or array.max() > 1.0 + 1e-6):
            raise ValueError(
                "compute_youden_threshold(inputs='probs') received values "
                "outside [0, 1]; pass inputs='logits' for raw logits"
            )
        scores = array
    elif inputs == "logits":
        if array.ndim == 1:
            scores = 1.0 / (1.0 + np.exp(-array))
        else:
            shifted = array - array.max(axis=1, keepdims=True)
            exp = np.exp(shifted)
            scores = (exp / exp.sum(axis=1, keepdims=True))[:, -1]
    else:
        raise ValueError(f"inputs must be 'probs' or 'logits', got {inputs!r}")
    labels = np.asarray(targets).astype(int)
    if scores.size == 0:
        raise ValueError("Cannot compute threshold on empty scores")
    if np.unique(labels).size < 2:
        raise ValueError("Youden-J needs both classes present")
    fpr, tpr, taus = _roc_curve(labels, scores)
    best = int(np.argmax(tpr - fpr))
    tau = float(taus[best])
    if np.isinf(tau):
        tau = float(np.nextafter(scores.max(), 1.0))
    return tau


def resolve_frozen_sun_threshold(
    thresholds_block: Mapping[str, Any],
    *,
    source_key: str = "primary",
    expected_split_substring: str = "sun_full/val",
    checkpoint_path: Optional[Path] = None,
    checkpoint_sha256: Optional[str] = None,
) -> Tuple[float, Dict[str, Any]]:
    """Reuse a τ derived on SUN validation (policy ``sun_val_frozen``)."""
    if not isinstance(thresholds_block, Mapping):
        raise ValueError("thresholds block must be a mapping")
    entry = thresholds_block.get(source_key)
    if entry is None and source_key != "primary":
        entry = thresholds_block.get("primary")
    if not isinstance(entry, Mapping):
        available = ", ".join(sorted(str(k) for k in thresholds_block))
        raise KeyError(f"No threshold entry {source_key!r} (available: {available})")
    tau = entry.get("tau")
    if not isinstance(tau, (int, float)) or not math.isfinite(float(tau)):
        raise ValueError(f"Frozen threshold entry {source_key!r} lacks a finite tau")

    source_policy = entry.get("policy")
    raw_split = entry.get("split")
    source_split = str(raw_split).strip() if isinstance(raw_split, str) and raw_split.strip() else None
    notes: Dict[str, Any] = {}
    entry_notes = entry.get("notes")
    if isinstance(entry_notes, Mapping):
        notes.update({str(k): v for k, v in entry_notes.items()})
    if expected_split_substring:
        if source_split is None or expected_split_substring not in source_split:
            notes["unexpected_source_split"] = source_split
    notes["source_policy"] = source_policy
    notes["source_key"] = source_key
    if checkpoint_path is not None:
        notes["source_checkpoint"] = str(checkpoint_path)
    if checkpoint_sha256:
        notes["source_checkpoint_sha256"] = str(checkpoint_sha256)
    if source_split:
        notes.setdefault("source_split_path", source_split)

    epoch_value = entry.get("epoch")
    epoch = int(epoch_value) if isinstance(epoch_value, (int, float)) and math.isfinite(float(epoch_value)) else -1

    record = {
        "policy": "sun_val_frozen",
        "tau": float(tau),
        "split": source_split or expected_split_substring or None,
        "n_candidates": 0,
        "tiebreakers": [],
        "epoch": epoch,
        "degenerate_val": bool(entry.get("degenerate_val", False)),
        "notes": notes,
        "source_policy": source_policy,
        "source_split": expected_split_substring or source_split or None,
        "source_key": source_key,
    }
    return float(tau), record
