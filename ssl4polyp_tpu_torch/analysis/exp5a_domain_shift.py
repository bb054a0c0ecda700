"""exp5a domain-shift analysis: SUN-test → PolypGen-test transfer.

The transfer experiment's scientific payload: each exp5a run evaluates a
SUN-trained checkpoint zero-shot on PolypGen with the frozen SUN τ; this
module loads every run's **parent SUN run** through the provenance block,
reports the paired SUN→PolypGen domain-shift delta per model with
cluster-bootstrap CIs (PolypGen resampled by centre, SUN by case), breaks
performance down per centre, runs pairwise model contrasts under a shared
centre bootstrap, and exports ``performance`` / ``domain_shift`` /
``composition`` CSVs.

Reference: ``classification/analysis/exp5a_report.py`` (1,432 LoC) —
parent-run loading (:437-496), composition stats (:343-412), centre
alignment (:809-864), domain-shift bootstrap (:712-808), pairwise centre
bootstrap (:864-930), CSV exports (:1208-1290).

The port's copy of ``ssl4polyp_tpu/analysis/exp5a_domain_shift.py``.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .bootstrapper import DEFAULT_BOOTSTRAP_SEED
from .common import CommonRun, bce_loss_from_probs, load_common_run
from .display import format_delta, format_value
from .guardrails import GuardrailViolation
from .frame_bootstrap import metric_from_frames
from .report_core import RunSet

__all__ = [
    "PRIMARY_METRICS",
    "Exp5aView",
    "resolve_parent_run",
    "center_alignment",
    "domain_shift_section",
]

PRIMARY_METRICS: Tuple[str, ...] = (
    "auprc", "auroc", "recall", "precision", "f1",
    "balanced_accuracy", "mcc", "loss",
)
PAIRWISE_METRICS: Tuple[str, ...] = ("auroc", "f1")
# ssl_colon vs each baseline, matched case-insensitively against the models
# present (reference ``PAIRWISE_BASELINES``, ``exp5a_report.py:46``).
PAIRWISE_BASELINES: Tuple[str, ...] = ("sup_imnet", "ssl_imnet")
PAIRWISE_CONTENDER = "ssl_colon"

_CENTERLESS_WARNING = (
    "Uncertainty not reported: PolypGen lacks centre identifiers for some "
    "frames; frame-level bootstrap would overstate precision."
)


def _suite(probs: np.ndarray, labels: np.ndarray, tau: float) -> Dict[str, float]:
    """All PRIMARY_METRICS from raw frames (vectorised, no sklearn)."""
    out = {
        m: metric_from_frames(m, probs, labels, tau)
        for m in PRIMARY_METRICS
        if m != "loss"
    }
    out["loss"] = bce_loss_from_probs(probs, labels)
    return out


def _one_metric(metric: str, probs: np.ndarray, labels: np.ndarray,
                tau: float) -> float:
    """Single metric from frames (the bootstrap hot loops need one value,
    not the full 8-metric suite per replicate)."""
    if metric == "loss":
        return bce_loss_from_probs(probs, labels)
    return metric_from_frames(metric, probs, labels, tau)


def _resolve_relative_all(metrics_path: Path, entry: str) -> List[Path]:
    """All existing ancestor resolutions of a provenance-relative path,
    closest first (the engine writes parent paths relative to the run
    layout's base dir, which is some ancestor of the metrics file —
    reference ``_resolve_relative_path``, ``exp5a_report.py:496-520``).
    Callers digest-verify the candidates rather than trusting the first."""
    candidate = Path(entry)
    if candidate.is_absolute():
        return [candidate] if candidate.exists() else []
    found: List[Path] = []
    parent = metrics_path.parent
    for _ in range(6):
        resolved = parent / candidate
        if resolved.exists():
            found.append(resolved)
        if parent.parent == parent:
            break
        parent = parent.parent
    return found


def resolve_parent_run(run: CommonRun) -> Optional[CommonRun]:
    """Load the parent SUN run named by ``provenance.parent_run.metrics.path``
    (reference ``_load_parent_payload``, ``exp5a_report.py:437-462``)."""
    provenance = run.payload.get("provenance") or {}
    parent_block = provenance.get("parent_run")
    if not isinstance(parent_block, Mapping):
        return None
    metrics_info = parent_block.get("metrics")
    if not isinstance(metrics_info, Mapping):
        return None
    entry = metrics_info.get("path")
    if not isinstance(entry, str) or not entry:
        return None
    candidates = _resolve_relative_all(run.metrics_path, entry)
    if not candidates:
        return None
    # The engine records the parent metrics digest precisely so ancestor
    # probing cannot silently pick up a DIFFERENT training's file from a
    # nested/copied runs tree — accept only a digest-matching candidate
    # when a digest is recorded.
    recorded_sha = metrics_info.get("sha256")
    if isinstance(recorded_sha, str) and recorded_sha:
        import hashlib

        digests = []
        for candidate in candidates:
            actual = hashlib.sha256(candidate.read_bytes()).hexdigest()
            if actual == recorded_sha:
                return load_common_run(candidate)
            digests.append(f"{candidate}={actual[:12]}…")
        raise GuardrailViolation(
            f"{run.metrics_path}: no resolution of parent path {entry!r} "
            f"matches the recorded sha256 {recorded_sha[:12]}… "
            f"(candidates: {'; '.join(digests)}) — wrong parent tree?"
        )
    return load_common_run(candidates[0])


class Exp5aView:
    """One exp5a run pre-indexed for centre-clustered recomputation, with
    its parent SUN run's frames when resolvable."""

    def __init__(self, run: CommonRun, *, model: str, seed: int):
        # GuardrailViolation, not a bare ValueError: missing inputs are a
        # validation failure and must surface through the same posture as
        # the rest of the analysis layer (report_core / guardrails).
        if not run.frames:
            raise GuardrailViolation(
                f"exp5a analysis needs outputs-CSV frames: {run.metrics_path}"
            )
        if run.primary_tau is None:
            raise GuardrailViolation(
                f"exp5a run lacks a primary τ: {run.metrics_path}"
            )
        self.run = run
        self.model = model
        self.seed = seed
        self.tau = float(run.primary_tau)
        self.probs = np.asarray([f.prob for f in run.frames], dtype=float)
        self.labels = np.asarray([f.label for f in run.frames], dtype=int)
        centers: Dict[str, List[int]] = {}
        centerless: List[str] = []
        for i, frame in enumerate(run.frames):
            cid = (frame.center_id or "").strip()
            if cid:
                centers.setdefault(cid, []).append(i)
            else:
                centerless.append(frame.frame_id)
        self.centers = {c: np.asarray(ix, dtype=int) for c, ix in sorted(centers.items())}
        self.centerless = tuple(centerless)

        # Parent SUN run (frozen-τ source) for the domain-shift delta.
        self.sun_probs: Optional[np.ndarray] = None
        self.sun_labels: Optional[np.ndarray] = None
        self.sun_tau: Optional[float] = None
        self.sun_cases: Dict[str, np.ndarray] = {}
        parent = resolve_parent_run(run)
        if parent is not None and parent.frames and parent.primary_tau is not None:
            self.sun_probs = np.asarray([f.prob for f in parent.frames], dtype=float)
            self.sun_labels = np.asarray([f.label for f in parent.frames], dtype=int)
            self.sun_tau = float(parent.primary_tau)
            cases: Dict[str, List[int]] = {}
            for i, frame in enumerate(parent.frames):
                key = str(frame.case_id or frame.sequence_id or frame.frame_id)
                cases.setdefault(key, []).append(i)
            self.sun_cases = {c: np.asarray(ix, dtype=int) for c, ix in sorted(cases.items())}

    @property
    def has_parent(self) -> bool:
        return self.sun_probs is not None

    def composition(self) -> Dict[str, Any]:
        """Overall + per-centre composition recomputed from frames
        (reference ``_compute_composition``, ``exp5a_report.py:343-412``)."""
        n_pos = int((self.labels == 1).sum())
        n_neg = int((self.labels == 0).sum())
        total = n_pos + n_neg
        per_center: Dict[str, Dict[str, float]] = {}
        for center, idx in self.centers.items():
            labels = self.labels[idx]
            c_pos = int((labels == 1).sum())
            c_total = int(labels.size)
            per_center[center] = {
                "n_pos": c_pos,
                "n_neg": c_total - c_pos,
                "total": c_total,
                "prevalence": c_pos / c_total if c_total else float("nan"),
            }
        return {
            "n_pos": n_pos,
            "n_neg": n_neg,
            "total": total,
            "prevalence": n_pos / total if total else float("nan"),
            "per_center": per_center,
        }

    def polyp_suite(self, idx: Optional[np.ndarray] = None) -> Dict[str, float]:
        if idx is None:
            return _suite(self.probs, self.labels, self.tau)
        return _suite(self.probs[idx], self.labels[idx], self.tau)

    def polyp_metric(self, metric: str,
                     idx: Optional[np.ndarray] = None) -> float:
        if idx is None:
            return _one_metric(metric, self.probs, self.labels, self.tau)
        return _one_metric(metric, self.probs[idx], self.labels[idx], self.tau)

    def sun_suite(self, idx: Optional[np.ndarray] = None) -> Dict[str, float]:
        assert self.sun_probs is not None and self.sun_labels is not None
        assert self.sun_tau is not None
        if idx is None:
            return _suite(self.sun_probs, self.sun_labels, self.sun_tau)
        return _suite(self.sun_probs[idx], self.sun_labels[idx], self.sun_tau)

    def resample_centers(
        self, rng: np.random.Generator, centers: Sequence[str]
    ) -> Optional[np.ndarray]:
        usable = [c for c in centers if c in self.centers]
        if not usable:
            return None
        draw = rng.integers(0, len(usable), size=len(usable))
        return np.concatenate([self.centers[usable[int(d)]] for d in draw])

    def indices_for_centers(self, center_ids: Sequence[str]) -> np.ndarray:
        """Frame indices for an already-drawn centre-id multiset (paired
        bootstrap: the SAME drawn centres map into each run's own index
        arrays — order-independent and paired even under coverage skew)."""
        return np.concatenate([self.centers[cid] for cid in center_ids])

    def resample_sun_cases(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        if not self.sun_cases:
            return None
        ids = list(self.sun_cases)
        draw = rng.integers(0, len(ids), size=len(ids))
        return np.concatenate([self.sun_cases[ids[int(d)]] for d in draw])


def center_alignment(views: Sequence[Exp5aView]) -> Tuple[Tuple[str, ...], List[str]]:
    """Centres usable for cross-run bootstrap: the intersection across runs,
    minus centres whose frame counts differ between runs (reference
    ``_resolve_center_alignment``, ``exp5a_report.py:809-864``)."""
    warnings: List[str] = []
    if not views:
        return (), warnings
    if any(view.centerless for view in views):
        warnings.append(_CENTERLESS_WARNING)
        return (), warnings
    center_sets = [set(view.centers) for view in views]
    if any(not s for s in center_sets):
        warnings.append(_CENTERLESS_WARNING)
        return (), warnings
    common = set.intersection(*center_sets)
    if not common:
        warnings.append(
            "Uncertainty not reported: PolypGen centre overlap across runs "
            "is empty; bootstrap disabled."
        )
        return (), warnings
    mismatched = sorted(
        center
        for center in common
        if len({view.centers[center].size for view in views}) > 1
    )
    if mismatched:
        warnings.append(
            "PolypGen per-centre frame counts differ across runs for: "
            + ", ".join(mismatched)
            + "; excluding from bootstrap."
        )
        common -= set(mismatched)
    if not common:
        warnings.append(
            "Uncertainty not reported: no PolypGen centres remain after "
            "alignment; bootstrap disabled."
        )
        return (), warnings
    if any(s != center_sets[0] for s in center_sets[1:]):
        warnings.append(
            "PolypGen centre coverage differs across runs; restricting "
            "bootstrap to the shared centres."
        )
    return tuple(sorted(common)), warnings


def _ci(values: Sequence[float]) -> Tuple[float, float]:
    arr = np.asarray([v for v in values if math.isfinite(v)], dtype=float)
    if arr.size == 0:
        return float("nan"), float("nan")
    return float(np.quantile(arr, 0.025)), float(np.quantile(arr, 0.975))


def _write_csv(path: Path, rows: List[Dict[str, Any]]) -> None:
    if not rows:
        return
    fieldnames = sorted({key for row in rows for key in row})
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8", newline="") as handle:
        writer = csv.DictWriter(handle, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)


def _prepare_views(run_set: RunSet) -> Dict[str, Dict[int, Exp5aView]]:
    views: Dict[str, Dict[int, Exp5aView]] = {}
    for condition in run_set.conditions():
        for seed, run in sorted(run_set.runs[condition].items()):
            if not run.frames:
                # No silent drops: losing a seed would skew every delta
                # and per-centre table without a trace (layer posture:
                # reports never silently skip bad runs).
                raise GuardrailViolation(
                    f"exp5a needs the outputs CSV for {condition} seed "
                    f"{seed}: none found next to {run.metrics_path}"
                )
            views.setdefault(condition, {})[seed] = Exp5aView(
                run, model=condition, seed=seed
            )
    return views


def domain_shift_section(run_set: RunSet, output_dir: Path) -> List[str]:
    """The exp5a report body: domain-shift deltas with centre/case cluster
    bootstrap CIs, per-centre breakdown, pairwise contrasts, composition —
    plus the three CSV artifacts the reference emits."""
    views = _prepare_views(run_set)
    if not views:
        return []
    n_resamples = run_set.n_resamples
    all_views = [v for per_seed in views.values() for v in per_seed.values()]
    centers, warnings = center_alignment(all_views)

    lines: List[str] = []
    performance_rows: List[Dict[str, Any]] = []
    shift_rows: List[Dict[str, Any]] = []

    # -- Domain shift: PolypGen(τ_frozen) − SUN-test(τ_sun) per model -------
    lines += ["## Domain shift (SUN-test → PolypGen-test)", ""]
    lines.append("| model | metric | SUN | PolypGen | Δ (mean ± std) | 95% CI |")
    lines.append("|---|---|---|---|---|---|")
    for mi, model in enumerate(sorted(views)):
        per_seed = views[model]
        with_parent = {s: v for s, v in per_seed.items() if v.has_parent}
        polyp_points = {s: v.polyp_suite() for s, v in per_seed.items()}
        sun_points = {s: v.sun_suite() for s, v in with_parent.items()}

        # Summary bootstrap: each replicate redraws centres (PolypGen) and
        # cases (SUN) for every seed, averaging the per-seed deltas
        # (reference ``_bootstrap_domain_shift_summary``,
        # ``exp5a_report.py:760-808``).
        replicates: Dict[str, List[float]] = {m: [] for m in PRIMARY_METRICS}
        if with_parent and centers and n_resamples > 0:
            rng = np.random.default_rng(DEFAULT_BOOTSTRAP_SEED + 17 * mi)
            for _ in range(n_resamples):
                draw: Dict[str, List[float]] = {m: [] for m in PRIMARY_METRICS}
                for view in with_parent.values():
                    polyp_idx = view.resample_centers(rng, centers)
                    sun_idx = view.resample_sun_cases(rng)
                    if polyp_idx is None or sun_idx is None:
                        continue
                    polyp_vals = view.polyp_suite(polyp_idx)
                    sun_vals = view.sun_suite(sun_idx)
                    for metric in PRIMARY_METRICS:
                        p, s = polyp_vals.get(metric), sun_vals.get(metric)
                        if (
                            p is not None and s is not None
                            and math.isfinite(p) and math.isfinite(s)
                        ):
                            draw[metric].append(p - s)
                for metric, vals in draw.items():
                    if vals:
                        replicates[metric].append(float(np.mean(vals)))

        for metric in PRIMARY_METRICS:
            polyp_vals = [
                polyp_points[s][metric]
                for s in sorted(polyp_points)
                if math.isfinite(polyp_points[s][metric])
            ]
            polyp_mean = float(np.mean(polyp_vals)) if polyp_vals else float("nan")
            deltas = [
                polyp_points[s][metric] - sun_points[s][metric]
                for s in sorted(with_parent)
                if math.isfinite(polyp_points[s][metric])
                and math.isfinite(sun_points[s][metric])
            ]
            sun_vals = [
                sun_points[s][metric]
                for s in sorted(sun_points)
                if math.isfinite(sun_points[s][metric])
            ]
            sun_mean = float(np.mean(sun_vals)) if sun_vals else float("nan")
            delta_mean = float(np.mean(deltas)) if deltas else float("nan")
            delta_std = (
                float(np.std(deltas, ddof=1)) if len(deltas) > 1 else 0.0
            )
            lo, hi = _ci(replicates[metric])
            ci_cell = (
                f"[{format_value(lo)}, {format_value(hi)}]"
                if math.isfinite(lo)
                else "—"
            )
            delta_cell = (
                f"{format_delta(delta_mean)} ± {format_value(delta_std)}"
                if deltas
                else "—"
            )
            lines.append(
                f"| {model} | {metric} | {format_value(sun_mean)} | "
                f"{format_value(polyp_mean)} | {delta_cell} | {ci_cell} |"
            )
            performance_rows.append({
                "model": model, "metric": metric,
                "mean": polyp_mean,
                "std": float(np.std(polyp_vals, ddof=1)) if len(polyp_vals) > 1 else 0.0,
                "n": len(polyp_vals),
            })
            row: Dict[str, Any] = {
                "model": model, "metric": metric,
                "mean": delta_mean, "std": delta_std, "n": len(deltas),
            }
            if math.isfinite(lo):
                row["ci_lower"], row["ci_upper"] = lo, hi
            for s in sorted(with_parent):
                p, v = polyp_points[s].get(metric), sun_points[s].get(metric)
                if p is not None and v is not None and math.isfinite(p) and math.isfinite(v):
                    row[f"delta_seed{s}"] = p - v
            shift_rows.append(row)
        if not with_parent:
            warnings.append(
                f"Model {model}: no parent SUN run resolvable from provenance; "
                "domain-shift deltas unavailable."
            )
    lines.append("")

    # -- Per-centre performance --------------------------------------------
    center_rows: List[str] = []
    for model in sorted(views):
        per_seed = views[model]
        all_centers = sorted({c for v in per_seed.values() for c in v.centers})
        for center in all_centers:
            acc: Dict[str, List[float]] = {"auroc": [], "f1": []}
            frame_counts: List[int] = []
            prevalences: List[float] = []
            for view in per_seed.values():
                idx = view.centers.get(center)
                if idx is None:
                    continue
                frame_counts.append(int(idx.size))
                labels = view.labels[idx]
                prevalences.append(float((labels == 1).mean()))
                vals = view.polyp_suite(idx)
                for metric in acc:
                    if math.isfinite(vals[metric]):
                        acc[metric].append(vals[metric])
            cells = []
            for metric in ("auroc", "f1"):
                vals = acc[metric]
                cells.append(format_value(float(np.mean(vals))) if vals else "—")
            prevalence = float(np.mean(prevalences)) if prevalences else float("nan")
            # Seeds run the SAME pack, so counts normally agree; when they
            # don't (the center_alignment warning case) show the range
            # instead of whichever seed iterated last.
            if not frame_counts:
                frames_cell = "0"
            elif min(frame_counts) == max(frame_counts):
                frames_cell = str(frame_counts[0])
            else:
                frames_cell = f"{min(frame_counts)}–{max(frame_counts)}"
            center_rows.append(
                f"| {model} | {center} | {frames_cell} | {format_value(prevalence)} | "
                + " | ".join(cells) + " |"
            )
    if center_rows:
        lines += ["### Per-centre performance (seed means)", ""]
        lines.append("| model | centre | frames | prevalence | auroc | f1 |")
        lines.append("|---|---|---|---|---|---|")
        lines.extend(center_rows)
        lines.append("")

    # -- Pairwise model contrasts on PolypGen (shared centre bootstrap) -----
    pair_lines: List[str] = []
    normalized = {model.strip().lower().replace("_", ""): model for model in views}
    for baseline_key in PAIRWISE_BASELINES:
        baseline = normalized.get(baseline_key.replace("_", ""))
        contender = normalized.get(PAIRWISE_CONTENDER.replace("_", ""))
        if baseline is None or contender is None or baseline == contender:
            continue
        base_runs, cont_runs = views[baseline], views[contender]
        seeds = sorted(set(base_runs) & set(cont_runs))
        if not seeds:
            continue
        for metric in PAIRWISE_METRICS:
            points = [
                cont_runs[s].polyp_suite()[metric] - base_runs[s].polyp_suite()[metric]
                for s in seeds
            ]
            point = float(np.nanmean(points))
            draws: List[float] = []
            if centers and n_resamples > 0:
                rng = np.random.default_rng(
                    DEFAULT_BOOTSTRAP_SEED
                    + 29 * PAIRWISE_METRICS.index(metric)
                    + 31 * sorted(views).index(baseline)
                )
                # Centre pairing per seed (invariant across replicates —
                # hoisted out of the resample loop).  Shared centres are
                # drawn ONCE and mapped into each run's own index arrays;
                # centres exclusive to one run are resampled independently,
                # so each replicate covers each run's FULL centre population
                # and the CI describes the same statistic as the full-sample
                # point delta above, even under coverage skew.
                pairing_by_seed = {}
                for s in seeds:
                    base_ids = set(base_runs[s].centers)
                    cont_ids = set(cont_runs[s].centers)
                    pairing_by_seed[s] = (
                        sorted(base_ids & cont_ids),
                        sorted(base_ids - cont_ids),
                        sorted(cont_ids - base_ids),
                    )
                for _ in range(n_resamples):
                    vals = []
                    for s in seeds:
                        shared, excl_b, excl_c = pairing_by_seed[s]
                        ids_b: List[str] = []
                        ids_c: List[str] = []
                        if shared:
                            draw = rng.integers(0, len(shared), size=len(shared))
                            drawn = [shared[int(d)] for d in draw]
                            ids_b += drawn
                            ids_c += drawn
                        if excl_b:
                            draw = rng.integers(0, len(excl_b), size=len(excl_b))
                            ids_b += [excl_b[int(d)] for d in draw]
                        if excl_c:
                            draw = rng.integers(0, len(excl_c), size=len(excl_c))
                            ids_c += [excl_c[int(d)] for d in draw]
                        if not ids_b or not ids_c:
                            continue
                        idx = base_runs[s].indices_for_centers(ids_b)
                        idx_c = cont_runs[s].indices_for_centers(ids_c)
                        delta = (
                            cont_runs[s].polyp_metric(metric, idx_c)
                            - base_runs[s].polyp_metric(metric, idx)
                        )
                        if math.isfinite(delta):
                            vals.append(delta)
                    if vals:
                        draws.append(float(np.mean(vals)))
            lo, hi = _ci(draws)
            ci_cell = (
                f"[{format_value(lo)}, {format_value(hi)}]"
                if math.isfinite(lo)
                else "—"
            )
            pair_lines.append(
                f"| {baseline} | {contender} | {metric} | "
                f"{format_delta(point)} | {ci_cell} |"
            )
    if pair_lines:
        lines += ["### Pairwise deltas on PolypGen (centre bootstrap, 95% CI)", ""]
        lines.append("| baseline | contender | metric | Δ | 95% CI |")
        lines.append("|---|---|---|---|---|")
        lines.extend(pair_lines)
        lines.append("")

    # -- Composition (validated identical across runs by report_core) ------
    composition_rows: List[Dict[str, Any]] = []
    reference_comp = all_views[0].composition()
    composition_rows.append({
        "scope": "overall",
        "n_pos": reference_comp["n_pos"],
        "n_neg": reference_comp["n_neg"],
        "total": reference_comp["total"],
        "prevalence": reference_comp["prevalence"],
    })
    lines += ["### Test-set composition", ""]
    lines.append("| scope | centre | n_pos | n_neg | total | prevalence |")
    lines.append("|---|---|---|---|---|---|")
    lines.append(
        f"| overall | — | {reference_comp['n_pos']} | {reference_comp['n_neg']} | "
        f"{reference_comp['total']} | {format_value(reference_comp['prevalence'])} |"
    )
    for center, stats in sorted(reference_comp["per_center"].items()):
        composition_rows.append({
            "scope": "center", "center_id": center,
            "n_pos": stats["n_pos"], "n_neg": stats["n_neg"],
            "total": stats["total"], "prevalence": stats["prevalence"],
        })
        lines.append(
            f"| center | {center} | {stats['n_pos']} | {stats['n_neg']} | "
            f"{stats['total']} | {format_value(stats['prevalence'])} |"
        )
    lines.append("")

    if warnings:
        lines += ["### Warnings", ""]
        lines.extend(f"- {message}" for message in dict.fromkeys(warnings))
        lines.append("")

    _write_csv(output_dir / "exp5a_performance.csv", performance_rows)
    _write_csv(output_dir / "exp5a_domain_shift.csv", shift_rows)
    _write_csv(output_dir / "exp5a_composition.csv", composition_rows)
    return lines
