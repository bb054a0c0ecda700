"""Artifact exporters: per-frame CSVs, ROC/PR grids, metrics.json blocks.

The port's copy of ``ssl4polyp_tpu/evaluation/exports.py``: the files it
writes are byte-equal to that module's.  Where that module asks its
multi-host runtime ``is_primary()``, the writers here take ``primary: bool =
True``.

Schema-compatible with the reference exports so its reporters (and our port
of them) can consume either framework's runs:

* ``*_test_outputs.csv`` — frame_id, prob, label, pred + case/center/
  sequence/morphology columns, with the PolypGen column variant
  (``train_classification.py:2789-2951``);
* ``*_{split}_roc_curve.csv`` / ``*_{split}_pr_curve.csv`` — 200-point
  threshold grids with confusion counts (``:3129-3287``);
* metrics.json blocks: ``run``, ``provenance``, ``data`` (path+sha256 per
  split), ``thresholds`` (primary/sensitivity records + values + sources)
  matching the ResultLoader guardrails (``analysis/result_loader.py``).

All exporters build their artifact bytes in memory on EVERY host (so
digests entering metrics.json are identical across processes) and write to
disk only on the primary process (reference rank-0 guards,
``util/misc.py:171``).
"""

from __future__ import annotations

import csv
import hashlib
import io
import math
import re
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np

from .evaluate import canonical_perturbation_tag

__all__ = [
    "FrameOutputsResult",
    "export_frame_outputs",
    "export_curve_sets",
    "sha256_file",
    "build_data_block",
    "build_run_block",
    "build_provenance_block",
    "build_thresholds_block",
    "metric_block_for_export",
    "normalise_manifest_path",
]

INTEGER_METRIC_KEYS = {"tp", "fp", "tn", "fn", "n_pos", "n_neg", "n_total", "count"}


def sha256_file(path: str | Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as handle:
        for chunk in iter(lambda: handle.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def normalise_manifest_path(candidate: str) -> str:
    """data_packs-relative, extension-less form (ResultLoader semantics)."""
    text = str(candidate).strip().replace("\\", "/")
    while text.startswith("./"):
        text = text[2:]
    text = text.lstrip("/")
    if "/data_packs/" in text:
        text = text.split("/data_packs/", 1)[1]
    if text.startswith("data_packs/"):
        text = text[len("data_packs/"):]
    if text.endswith(".csv"):
        text = text[:-4]
    return text


def _meta_value(row: Mapping[str, Any], keys: Sequence[str]) -> Optional[str]:
    for key in keys:
        value = row.get(key)
        if value not in (None, ""):
            return str(value).strip()
    return None


_POLYPGEN_CENTER_RE = re.compile(r"(?:^|[_\-/])(?:c|center|centre)(\d+)", re.IGNORECASE)


def _polypgen_center(value: Optional[str]) -> Optional[str]:
    if not value:
        return None
    match = _POLYPGEN_CENTER_RE.search(value)
    if match:
        return f"C{int(match.group(1))}"
    return None


_POLYPGEN_SEQ_RE = re.compile(r"(seq\d+)", re.IGNORECASE)


def _polypgen_sequence(frame_id: str, declared: Optional[str]) -> Optional[str]:
    if declared:
        return declared
    match = _POLYPGEN_SEQ_RE.search(frame_id or "")
    return match.group(1) if match else None


class FrameOutputsResult(NamedTuple):
    path: Path
    sha256: str


def export_frame_outputs(
    path: str | Path,
    *,
    metadata_rows: Sequence[Mapping[str, Any]],
    probabilities: Sequence[float],
    targets: Sequence[int],
    preds: Sequence[int],
    dataset_name: Optional[str] = None,
    primary: bool = True,
) -> FrameOutputsResult:
    """Write the per-frame outputs CSV (primary process only); returns
    ``(path, sha256)`` — the digest is computed from the in-memory bytes on
    every process."""
    path = Path(path)
    name = str(dataset_name or "").strip().lower()
    polypgen_layout = name.startswith("polypgen_fewshot") or name.startswith("polypgen_clean")

    if polypgen_layout:
        fieldnames = ["frame_id", "prob", "label", "pred", "origin", "center_id", "sequence_id"]
    else:
        fieldnames = [
            "frame_id", "prob", "label", "pred", "case_id",
            "origin", "center_id", "sequence_id", "morphology",
        ]
    # Perturbation packs (exp5b corruptions) get their canonical tag as an
    # extra column so reporters can recompute per-tag/per-case retention
    # from the artifact alone; clean packs keep the reference's exact
    # 7/9-column schema (reference ``train_classification.py:2808-2828``).
    row_tags = [
        canonical_perturbation_tag(row) if isinstance(row, Mapping) else None
        for row in metadata_rows
    ]
    has_tags = any(tag for tag in row_tags)
    if has_tags and not polypgen_layout:
        fieldnames = fieldnames + ["perturbation_tag"]

    buffer = io.StringIO(newline="")
    writer = csv.DictWriter(buffer, fieldnames=fieldnames)
    writer.writeheader()
    for idx in range(len(probabilities)):
        row = metadata_rows[idx] if idx < len(metadata_rows) else {}
        frame_id = _meta_value(
            row, ("frame_id", "orig_frame_id", "frame", "frame_path", "image_id")
        ) or f"idx_{idx}"
        origin = _meta_value(row, ("origin", "store_id", "dataset", "source_dataset"))
        if idx >= len(targets):
            # A probs/targets length mismatch is a pipeline bug; an empty
            # label cell would poison the analysis layer (the reader
            # hard-fails on it), so fail at export time with context.
            raise ValueError(
                f"outputs export: {len(probabilities)} probabilities but "
                f"only {len(targets)} targets (row {idx})"
            )
        payload: Dict[str, Any] = {
            "frame_id": frame_id,
            "prob": float(probabilities[idx]),
            "label": int(targets[idx]),
            "pred": int(preds[idx]) if idx < len(preds) else None,
            "origin": origin,
        }
        if polypgen_layout:
            case_id = _meta_value(row, ("case_id", "case", "study_id"))
            center = _meta_value(
                row, ("center_id", "centre_id", "center", "centre", "hospital_id", "hospital")
            )
            payload["center_id"] = _polypgen_center(center) or _polypgen_center(case_id)
            payload["sequence_id"] = _polypgen_sequence(
                frame_id, _meta_value(row, ("sequence_id", "sequence"))
            )
        else:
            payload["case_id"] = _meta_value(row, ("case_id", "sequence_id", "case", "study_id"))
            payload["center_id"] = _meta_value(
                row,
                ("center_id", "centre_id", "center", "centre",
                 "hospital_id", "hospital", "origin", "store_id"),
            )
            payload["sequence_id"] = _meta_value(
                row, ("sequence_id", "sequence", "case_id", "case", "study_id")
            )
            morphology = row.get("morphology") if isinstance(row, Mapping) else None
            payload["morphology"] = str(morphology).strip() if morphology not in (None, "") else None
            if has_tags:
                payload["perturbation_tag"] = (
                    row_tags[idx] if idx < len(row_tags) and row_tags[idx] else "clean"
                )
        writer.writerow({key: payload.get(key) for key in fieldnames})

    content = buffer.getvalue()
    digest = hashlib.sha256(content.encode("utf-8")).hexdigest()
    if primary:
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w", newline="") as handle:
            handle.write(content)
    return FrameOutputsResult(path, digest)


def export_curve_sets(
    stem_path: Path,
    split_name: str,
    *,
    probabilities: np.ndarray,
    targets: np.ndarray,
    grid_points: int = 200,
    primary: bool = True,
) -> Dict[str, Any]:
    """Write ROC and PR threshold-grid CSVs next to the checkpoint stem
    (primary process only; the digests on every process)."""
    if grid_points < 2:
        raise ValueError("Curve export requires at least two grid points")
    scores = np.asarray(probabilities, dtype=np.float64).ravel()
    labels = np.asarray(targets).astype(np.int64).ravel()
    if scores.size == 0 or scores.size != labels.size:
        raise ValueError("Curve export needs matching, non-empty probs/targets")

    taus = np.linspace(0.0, 1.0, num=int(grid_points), endpoint=True)
    pos = labels == 1
    neg = labels == 0

    def frac(num: int, den: int) -> Optional[float]:
        if den <= 0:
            return None
        value = num / den
        return float(value) if math.isfinite(value) else None

    roc_rows, pr_rows = [], []
    for tau in taus:
        pred = scores >= tau
        tp = int(np.count_nonzero(pred & pos))
        fp = int(np.count_nonzero(pred & neg))
        tn = int(np.count_nonzero(~pred & neg))
        fn = int(np.count_nonzero(~pred & pos))
        tpr = frac(tp, tp + fn)
        fpr = frac(fp, fp + tn)
        precision = frac(tp, tp + fp)
        f1 = None
        if precision is not None and tpr is not None and precision + tpr > 0:
            f1 = 2 * precision * tpr / (precision + tpr)
        base = {"threshold": round(float(tau), 10), "tp": tp, "fp": fp, "tn": tn, "fn": fn}
        roc_rows.append({**base, "tpr": tpr, "fpr": fpr})
        pr_rows.append({**base, "precision": precision, "recall": tpr, "f1": f1})

    segment = re.sub(r"[^0-9A-Za-z._-]+", "_", str(split_name)).strip("._-").lower() or "split"
    base_name = f"{stem_path.name}_{segment}"
    roc_path = stem_path.with_name(f"{base_name}_roc_curve.csv")
    pr_path = stem_path.with_name(f"{base_name}_pr_curve.csv")

    def render(fieldnames, rows) -> str:
        buffer = io.StringIO(newline="")
        writer = csv.DictWriter(buffer, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
        return buffer.getvalue()

    roc_content = render(["threshold", "tpr", "fpr", "tp", "fp", "tn", "fn"], roc_rows)
    pr_content = render(
        ["threshold", "precision", "recall", "f1", "tp", "fp", "tn", "fn"], pr_rows
    )
    if primary:
        roc_path.parent.mkdir(parents=True, exist_ok=True)
        with roc_path.open("w", newline="") as handle:
            handle.write(roc_content)
        with pr_path.open("w", newline="") as handle:
            handle.write(pr_content)

    return {
        "points": int(grid_points),
        "roc_csv": roc_path.name,
        "pr_csv": pr_path.name,
        "path": roc_path.name,
        "sha256": hashlib.sha256(roc_content.encode("utf-8")).hexdigest(),
        "pr_sha256": hashlib.sha256(pr_content.encode("utf-8")).hexdigest(),
    }


def build_data_block(dataset_summary: Mapping[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """``data`` block: per-split path + sha256 (+ extra summary)."""
    block: "OrderedDict[str, Any]" = OrderedDict()
    for split in ("train", "val", "test"):
        summary = dataset_summary.get(split)
        if summary is None:
            continue
        csv_path = summary.get("csv_path") or summary.get("path")
        sha = summary.get("csv_sha256") or summary.get("sha256")
        if not csv_path or not sha:
            raise RuntimeError(f"Dataset summary for {split!r} missing path/sha256")
        entry: Dict[str, Any] = {
            "path": normalise_manifest_path(str(csv_path)),
            "sha256": str(sha),
        }
        extra = {
            k: v for k, v in summary.items()
            if k not in {"csv_path", "csv_sha256", "path", "sha256"}
        }
        if extra:
            entry["summary"] = {str(k): str(v) for k, v in extra.items()}
        block[split] = entry
    if not block:
        raise RuntimeError("Dataset summary provided no recognised splits")
    return dict(block)


def build_run_block(
    *,
    experiment: Optional[str] = None,
    experiment_config: Optional[str] = None,
    stem: Optional[str] = None,
    model: Optional[str] = None,
    arch: Optional[str] = None,
    pretraining: Optional[str] = None,
    finetune_mode: Optional[str] = None,
    selection: Optional[str] = None,
    seed: Optional[int] = None,
    mode: str = "train",
    world_size: Optional[int] = None,
) -> Dict[str, Any]:
    block: "OrderedDict[str, Any]" = OrderedDict()
    if experiment_config:
        block["experiment_config"] = str(experiment_config)
        block["experiment"] = Path(str(experiment_config)).stem
    if experiment:
        block.setdefault("experiment", str(experiment))
    if stem:
        block["stem"] = stem
    if model:
        block["model"] = model
    if arch:
        block["arch"] = arch
    if pretraining:
        block["pretraining"] = pretraining
    if finetune_mode:
        block["finetune_mode"] = finetune_mode
    if selection:
        block["selection"] = selection
    if seed is not None:
        block["seed"] = int(seed)
    block["mode"] = mode
    if world_size:
        block["world_size"] = int(world_size)
    return dict(block)


def build_provenance_block(
    *,
    model: Optional[str],
    arch: Optional[str],
    train_seed: int,
    dataset_summary: Mapping[str, Mapping[str, Any]],
    test_outputs_csv: Optional[str] = None,
    test_outputs_sha256: Optional[str] = None,
    zero_shot_outputs_csv: Optional[str] = None,
    zero_shot_outputs_sha256: Optional[str] = None,
    subset_percent: Optional[float] = None,
    pack_seed: Optional[int] = None,
    fewshot_budget: Optional[int] = None,
    test_split: Optional[str] = None,
    parent_run: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    block: "OrderedDict[str, Any]" = OrderedDict()
    if model:
        block["model"] = str(model)
    if arch:
        block["arch"] = str(arch)
    block["train_seed"] = int(train_seed)
    train_summary = dataset_summary.get("train")
    if isinstance(train_summary, Mapping):
        pack_spec = train_summary.get("pack_spec")
        if pack_spec:
            block["train_pack"] = str(pack_spec)
            block["train_pack_name"] = Path(str(pack_spec)).name
        if train_summary.get("csv_sha256"):
            block["train_csv_sha256"] = str(train_summary["csv_sha256"])
        if train_summary.get("manifest_path"):
            block["train_manifest"] = str(train_summary["manifest_path"])
    for split in ("val", "test"):
        summary = dataset_summary.get(split)
        if isinstance(summary, Mapping) and summary.get("csv_sha256"):
            block[f"{split}_csv_sha256"] = str(summary["csv_sha256"])
    if test_outputs_csv:
        block["test_outputs_csv"] = str(test_outputs_csv)
    if test_outputs_sha256:
        block["test_outputs_csv_sha256"] = str(test_outputs_sha256)
    if zero_shot_outputs_csv:
        block["test_zero_shot_outputs_csv"] = str(zero_shot_outputs_csv)
    if zero_shot_outputs_sha256:
        block["test_zero_shot_outputs_csv_sha256"] = str(zero_shot_outputs_sha256)
    if fewshot_budget is not None:
        block["fewshot_budget"] = int(fewshot_budget)
    block["subset_percent"] = float(subset_percent if subset_percent is not None else 100.0)
    if pack_seed is not None:
        block["pack_seed"] = int(pack_seed)
    if test_split:
        block["split"] = str(test_split)
    if parent_run:
        block["parent_run"] = dict(parent_run)
    return dict(block)


def build_thresholds_block(
    thresholds_map: Optional[Mapping[str, float]] = None,
    *,
    policy: Optional[str] = None,
    primary: Optional[Mapping[str, Any]] = None,
    sensitivity: Optional[Mapping[str, Any]] = None,
    sources: Optional[Mapping[str, str]] = None,
) -> Dict[str, Any]:
    block: "OrderedDict[str, Any]" = OrderedDict()
    if primary:
        block["primary"] = dict(primary)
    if sensitivity:
        block["sensitivity"] = dict(sensitivity)
    if policy:
        block["policy"] = policy
    if thresholds_map:
        values = {
            key: float(value)
            for key, value in sorted(thresholds_map.items())
            if isinstance(value, (int, float)) and math.isfinite(float(value))
        }
        if values:
            block["values"] = values
    if sources:
        filtered = {k: v for k, v in sources.items() if isinstance(v, str) and v}
        if filtered:
            block["sources"] = filtered
    return dict(block)


def metric_block_for_export(metrics: Mapping[str, Any]) -> Dict[str, Any]:
    """Copy a metric block coercing integer metrics and dropping internals."""
    out: Dict[str, Any] = {}
    for key, value in metrics.items():
        if key.startswith("_") or key in {"probabilities", "targets"}:
            continue
        if isinstance(value, (Mapping, list, tuple)):
            continue
        if value is None:
            out[key] = None
            continue
        try:
            numeric = float(value)
        except (TypeError, ValueError):
            out[key] = value
            continue
        if key in INTEGER_METRIC_KEYS or key.startswith("n_"):
            out[key] = int(round(numeric))
        else:
            out[key] = numeric
    return out
