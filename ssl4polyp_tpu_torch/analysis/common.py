"""Shared run/frame loading and frame-level metric recomputation.

Mirrors ``analysis/common_loader.py`` + ``analysis/common_metrics.py`` of
the reference: a *run* is a metrics.json plus its sibling per-frame outputs
CSV; reporters recompute binary metrics from frames so aggregate numbers are
auditable against the exported artifacts.

The port's copy of ``ssl4polyp_tpu/analysis/common.py``: scikit-learn's
metrics come from the port's own :mod:`..metrics.performance`, bit for bit.
"""

from __future__ import annotations

import csv
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..metrics.performance import (
    average_precision_binary,
    balanced_accuracy_score,
    matthews_corrcoef,
    precision_recall_f1,
    roc_auc_binary,
)

__all__ = [
    "FrameRecord",
    "CommonRun",
    "read_outputs_csv",
    "load_common_run",
    "compute_binary_metrics",
    "bce_loss_from_probs",
    "bce_loss_from_frames",
    "build_cluster_map",
    "infer_seed",
]


@dataclass(frozen=True)
class FrameRecord:
    frame_id: str
    prob: float
    label: int
    pred: Optional[int] = None
    case_id: Optional[str] = None
    center_id: Optional[str] = None
    sequence_id: Optional[str] = None
    morphology: Optional[str] = None
    origin: Optional[str] = None
    perturbation_tag: Optional[str] = None


@dataclass
class CommonRun:
    metrics_path: Path
    payload: Dict[str, Any]
    outputs_path: Optional[Path]
    frames: List[FrameRecord] = field(default_factory=list)
    seed: Optional[int] = None

    @property
    def primary_tau(self) -> Optional[float]:
        block = self.payload.get("thresholds") or {}
        primary = block.get("primary") or {}
        tau = primary.get("tau")
        return float(tau) if isinstance(tau, (int, float)) else None

    @property
    def model(self) -> Optional[str]:
        for source in (self.payload.get("provenance"), self.payload.get("run")):
            if isinstance(source, Mapping) and source.get("model"):
                return str(source["model"])
        return None


def infer_seed(payload: Mapping[str, Any], metrics_path: Path) -> Optional[int]:
    for getter in (
        lambda: payload.get("seed"),
        lambda: (payload.get("provenance") or {}).get("train_seed"),
        lambda: (payload.get("run") or {}).get("seed"),
    ):
        value = getter()
        if isinstance(value, (int, float)):
            return int(value)
    match = re.search(r"_s(\d+)", metrics_path.stem)
    return int(match.group(1)) if match else None


def _outputs_candidates(metrics_path: Path) -> Tuple[Path, ...]:
    stem = metrics_path.name
    for suffix in ("_last.metrics.json", ".metrics.json"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    parent = metrics_path.parent
    return (
        parent / f"{stem}_test_outputs.csv",
        parent / f"{stem}_outputs.csv",
    )


def read_outputs_csv(path: Path) -> List[FrameRecord]:
    frames: List[FrameRecord] = []
    with open(path, newline="", encoding="utf-8") as handle:
        reader = csv.DictReader(handle)
        for i, row in enumerate(reader):
            label_raw = row.get("label")
            pred_raw = row.get("pred")
            prob_raw = row.get("prob")
            # Missing prob/label cells mean a truncated or schema-drifted
            # export: fail loudly — coercing to 0/0.0 would silently flip
            # positives and poison every downstream recomputation.
            if prob_raw in (None, "") or label_raw in (None, ""):
                raise ValueError(
                    f"{path}: row {i + 1} lacks prob/label "
                    f"(prob={prob_raw!r}, label={label_raw!r}) — "
                    f"corrupt or truncated outputs CSV"
                )
            frames.append(
                FrameRecord(
                    frame_id=str(row.get("frame_id") or f"frame_{i}"),
                    prob=float(prob_raw),
                    label=int(float(label_raw)),
                    pred=int(float(pred_raw)) if pred_raw not in (None, "") else None,
                    case_id=row.get("case_id") or None,
                    center_id=row.get("center_id") or None,
                    sequence_id=row.get("sequence_id") or None,
                    morphology=row.get("morphology") or None,
                    origin=row.get("origin") or None,
                    perturbation_tag=row.get("perturbation_tag") or None,
                )
            )
    return frames


def load_common_run(metrics_path: str | Path, *, require_outputs: bool = False) -> CommonRun:
    metrics_path = Path(metrics_path)
    payload = json.loads(metrics_path.read_text(encoding="utf-8"))
    outputs_path = next((c for c in _outputs_candidates(metrics_path) if c.exists()), None)
    if outputs_path is None and require_outputs:
        raise FileNotFoundError(
            f"No outputs CSV found next to {metrics_path} "
            f"(tried {[str(c) for c in _outputs_candidates(metrics_path)]})"
        )
    frames = read_outputs_csv(outputs_path) if outputs_path else []
    return CommonRun(
        metrics_path=metrics_path,
        payload=payload,
        outputs_path=outputs_path,
        frames=frames,
        seed=infer_seed(payload, metrics_path),
    )


def compute_binary_metrics(
    probs: Sequence[float],
    labels: Sequence[int],
    tau: float = 0.5,
) -> Dict[str, float]:
    """Frame-level binary metric suite (reference ``common_metrics.py:100``),
    scikit-learn's values computed by :mod:`..metrics.performance`."""
    probs_np = np.asarray(probs, dtype=float)
    labels_np = np.asarray(labels, dtype=int)
    preds = (probs_np >= tau).astype(int)
    tp = int(((preds == 1) & (labels_np == 1)).sum())
    fp = int(((preds == 1) & (labels_np == 0)).sum())
    tn = int(((preds == 0) & (labels_np == 0)).sum())
    fn = int(((preds == 0) & (labels_np == 1)).sum())
    precision, recall, f1 = precision_recall_f1(labels_np, preds)
    out: Dict[str, float] = {
        "recall": recall,
        "precision": precision,
        "f1": f1,
        "balanced_accuracy": float(balanced_accuracy_score(labels_np, preds)),
        "mcc": float(matthews_corrcoef(labels_np, preds)) if len(set(preds)) > 1 or len(set(labels_np)) > 1 else 0.0,
        "tp": tp, "fp": fp, "tn": tn, "fn": fn,
        "n_pos": int((labels_np == 1).sum()),
        "n_neg": int((labels_np == 0).sum()),
        "count": int(labels_np.size),
        "prevalence": float((labels_np == 1).mean()) if labels_np.size else float("nan"),
        "tau": float(tau),
    }
    if np.unique(labels_np).size >= 2:
        out["auroc"] = roc_auc_binary(labels_np, probs_np)
        out["auprc"] = average_precision_binary(labels_np, probs_np)
    else:
        out["auroc"] = float("nan")
        out["auprc"] = float("nan")
    return out


def bce_loss_from_probs(probs: np.ndarray, labels: np.ndarray,
                        eps: float = 1e-7) -> float:
    """Clipped mean binary cross-entropy on raw arrays — the single
    implementation every recomputation site shares (exp5a's suites call
    this too, so the eps/clip formula cannot drift between copies)."""
    probs = np.clip(np.asarray(probs, dtype=float), eps, 1 - eps)
    labels = np.asarray(labels, dtype=float)
    return float(-np.mean(labels * np.log(probs) + (1 - labels) * np.log(1 - probs)))


def bce_loss_from_frames(frames: Sequence[FrameRecord], eps: float = 1e-7) -> float:
    """Recompute the mean binary cross-entropy from exported probabilities
    (reference ``reporting/metrics.py:56`` recomputes it from outputs CSVs
    so reported losses are auditable)."""
    return bce_loss_from_probs(
        np.asarray([f.prob for f in frames], dtype=float),
        np.asarray([f.label for f in frames], dtype=float),
        eps,
    )


def build_cluster_map(frames: Sequence[FrameRecord], key: str = "case_id") -> Dict[str, List[int]]:
    """Group frame indices by cluster id (case/sequence) for bootstrap."""
    clusters: Dict[str, List[int]] = {}
    for i, frame in enumerate(frames):
        value = getattr(frame, key, None) or f"__frame_{i}"
        clusters.setdefault(str(value), []).append(i)
    return clusters
