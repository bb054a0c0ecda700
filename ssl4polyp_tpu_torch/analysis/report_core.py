"""Shared reporter machinery: discovery, aggregation, deltas, rendering.

The reference ships ~9.4k lines across seven near-copy reporters
(``analysis/exp{1..5c}_report.py``); here the common 90% lives once and the
per-experiment modules declare only their deviations (strata, learning
curves, retention, zero-shot anchors).

The port's copy of ``ssl4polyp_tpu/analysis/report_core.py``.
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .common import CommonRun, compute_binary_metrics, load_common_run
from .display import format_delta, format_value
from .frame_bootstrap import FrameBootstrapper, FrameSample
from .guardrails import GuardrailViolation, ResultLoader, build_report_manifest
from .seed_checks import EXPECTED_SEEDS, ensure_expected_seeds

__all__ = [
    "ReportConfig",
    "RunSet",
    "discover_runs",
    "composition_of",
    "validate_composition",
    "aggregate_conditions",
    "paired_deltas",
    "render_markdown_tables",
    "write_metric_csv",
    "generate_report",
]

HEADLINE_METRICS = ("auroc", "auprc", "f1", "recall", "precision", "balanced_accuracy", "mcc")


@dataclass
class ReportConfig:
    exp_id: str
    title: str
    metrics: Sequence[str] = HEADLINE_METRICS
    primary_metric: str = "auroc"
    expected_seeds: Sequence[int] = EXPECTED_SEEDS
    required_curve_keys: Sequence[str] = ()
    enforce_curve_exports: bool = False
    comparisons: Sequence[Tuple[str, str]] = ()  # (baseline, contender) model pairs
    strict: bool = True
    check_composition: bool = True
    # also render Student-t CIs over the per-seed deltas next to the
    # bootstrap CIs (reference exp2 table format, ``exp2_report.py:250-324``)
    include_t_ci: bool = False
    # condition = how runs are grouped beyond model (e.g. subset percent)
    condition_fn: Optional[Callable[[CommonRun], Optional[str]]] = None
    extra_sections: Sequence[Callable[["RunSet"], List[str]]] = ()
    # artifact sections additionally receive the report output dir and may
    # write CSVs there (exp5a performance/domain_shift/composition exports)
    artifact_sections: Sequence[Callable[["RunSet", Path], List[str]]] = ()


@dataclass
class RunSet:
    config: ReportConfig
    runs: Dict[str, Dict[int, CommonRun]] = field(default_factory=dict)  # condition → seed → run
    n_resamples: int = 2000  # bootstrap budget shared by the extra sections

    def conditions(self) -> List[str]:
        return sorted(self.runs)

    def add(self, condition: str, run: CommonRun) -> None:
        if run.seed is None:
            raise GuardrailViolation(f"Run {run.metrics_path} has no resolvable seed")
        bucket = self.runs.setdefault(condition, {})
        if run.seed in bucket:
            raise GuardrailViolation(
                f"Duplicate seed {run.seed} for condition {condition!r}: "
                f"{run.metrics_path} vs {bucket[run.seed].metrics_path}"
            )
        bucket[run.seed] = run


def _default_condition(run: CommonRun) -> Optional[str]:
    return run.model


def discover_runs(
    runs_root: str | Path,
    config: ReportConfig,
    *,
    pattern: str = "**/*.metrics.json",
    validate: bool = True,
) -> RunSet:
    """Find and guardrail-validate every run under ``runs_root``.

    ``*_last.metrics.json`` files are preferred over plain ``.metrics.json``
    siblings for the same stem (reference ``reporting_inputs.py:59-98``).
    """
    runs_root = Path(runs_root)
    loader = ResultLoader(
        config.exp_id,
        required_curve_keys=config.required_curve_keys,
        strict=config.strict,
        enforce_curve_exports=config.enforce_curve_exports,
    )
    candidates = sorted(runs_root.glob(pattern))
    chosen: Dict[str, Path] = {}
    for path in candidates:
        name = path.name
        if name.endswith("_last.metrics.json"):
            stem = name[: -len("_last.metrics.json")]
            chosen[str(path.parent / stem)] = path
        elif name.endswith(".metrics.json"):
            stem = name[: -len(".metrics.json")]
            chosen.setdefault(str(path.parent / stem), path)

    run_set = RunSet(config=config)
    condition_fn = config.condition_fn or _default_condition
    for path in sorted(chosen.values()):
        run = load_common_run(path)
        if validate:
            loader.validate(path, run.payload)
        condition = condition_fn(run)
        if condition is None:
            raise GuardrailViolation(f"Cannot derive a condition for {path}")
        run_set.add(condition, run)
    if validate and config.check_composition:
        validate_composition(run_set)
    return run_set


def check_seeds(run_set: RunSet) -> None:
    ensure_expected_seeds(
        {cond: seeds for cond, seeds in run_set.runs.items()},
        run_set.config.expected_seeds,
    )


# ---------------------------------------------------------------------------
# Composition validation
# ---------------------------------------------------------------------------

def composition_of(run: CommonRun) -> Optional[Dict[str, float]]:
    """Test-set composition (n_pos, n_neg, prevalence) for one run.

    Recomputed from the exported frames when available and cross-checked
    against the declared ``test_primary`` counts; runs without frames fall
    back to the declared block.  Returns ``None`` when neither source
    provides counts.
    """
    declared = run.payload.get("test_primary") or {}
    declared_pos = declared.get("n_pos")
    declared_neg = declared.get("n_neg")
    if run.frames:
        labels = np.asarray([f.label for f in run.frames], dtype=int)
        n_pos = int((labels == 1).sum())
        n_neg = int((labels == 0).sum())
        for name, stated, actual in (("n_pos", declared_pos, n_pos), ("n_neg", declared_neg, n_neg)):
            if isinstance(stated, (int, float)) and int(stated) != actual:
                raise GuardrailViolation(
                    f"{run.metrics_path}: test_primary.{name}={int(stated)} disagrees "
                    f"with the outputs CSV composition {actual}"
                )
    elif isinstance(declared_pos, (int, float)) and isinstance(declared_neg, (int, float)):
        n_pos, n_neg = int(declared_pos), int(declared_neg)
    else:
        return None
    total = n_pos + n_neg
    return {
        "n_pos": n_pos,
        "n_neg": n_neg,
        "total": total,
        "prevalence": n_pos / total if total else float("nan"),
    }


def validate_composition(run_set: RunSet) -> Optional[Dict[str, float]]:
    """Assert every run in the comparison was evaluated on an identically
    composed test set (reference ``exp1_report.py:392-410``,
    ``exp5a_report.py:343-412``); silently averaging runs evaluated on
    different packs would corrupt every delta table downstream."""
    reference: Optional[Dict[str, float]] = None
    reference_run: Optional[CommonRun] = None
    for condition in run_set.conditions():
        for _seed, run in sorted(run_set.runs[condition].items()):
            comp = composition_of(run)
            if comp is None:
                continue
            if reference is None:
                reference, reference_run = comp, run
            elif (
                comp["n_pos"] != reference["n_pos"]
                or comp["n_neg"] != reference["n_neg"]
            ):
                raise GuardrailViolation(
                    "Test-set composition mismatch across compared runs: "
                    f"{reference_run.metrics_path} has n_pos={reference['n_pos']} "
                    f"n_neg={reference['n_neg']} but {run.metrics_path} has "
                    f"n_pos={comp['n_pos']} n_neg={comp['n_neg']}"
                )
    return reference


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

AUDIT_TOLERANCE = 5e-3


def recompute_primary_metrics(run: CommonRun) -> Optional[Dict[str, float]]:
    """Headline metrics recomputed from the run's exported outputs CSV.

    The reference reporters rebuild their tables from ``*_test_outputs.csv``
    (``exp4_report.py:376-403``) so every number is auditable against the
    artifacts; the declared ``test_primary`` block is only trusted after it
    agrees with the frames within :data:`AUDIT_TOLERANCE`.
    """
    if not run.frames:
        return None
    probs = np.asarray([f.prob for f in run.frames], dtype=float)
    labels = np.asarray([f.label for f in run.frames], dtype=int)
    tau = run.primary_tau if run.primary_tau is not None else 0.5
    recomputed = compute_binary_metrics(probs, labels, tau)
    declared = run.payload.get("test_primary") or {}
    for key, value in recomputed.items():
        stated = declared.get(key)
        if (
            isinstance(stated, (int, float))
            and math.isfinite(float(stated))
            and math.isfinite(float(value))
            and abs(float(stated) - float(value)) > AUDIT_TOLERANCE
        ):
            raise GuardrailViolation(
                f"{run.metrics_path}: test_primary.{key}={float(stated):.6f} disagrees "
                f"with the outputs CSV recomputation {float(value):.6f}"
            )
    return recomputed


def aggregate_conditions(run_set: RunSet) -> Dict[str, Dict[str, Dict[str, float]]]:
    """{condition: {metric: {mean, std, min, max, n}}} over seeds.

    Values are recomputed from each run's outputs CSV when frames are
    available (and cross-checked against the declared block); runs without
    exported frames fall back to the validated ``test_primary`` numbers.
    """
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for condition, seed_map in run_set.runs.items():
        metric_values: Dict[str, List[float]] = {}
        for run in seed_map.values():
            block = recompute_primary_metrics(run) or run.payload.get("test_primary") or {}
            for metric in run_set.config.metrics:
                value = block.get(metric)
                if isinstance(value, (int, float)) and math.isfinite(float(value)):
                    metric_values.setdefault(metric, []).append(float(value))
        out[condition] = {
            metric: {
                "mean": float(np.mean(vals)),
                "std": float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0,
                "min": float(np.min(vals)),
                "max": float(np.max(vals)),
                "n": len(vals),
            }
            for metric, vals in metric_values.items()
        }
    return out


def frame_sample_of(run: CommonRun) -> FrameSample:
    """Build a cluster-aware bootstrap sample from a run's exported frames."""
    if not run.frames:
        raise GuardrailViolation(f"Run {run.metrics_path} has no outputs CSV frames")
    probs = [f.prob for f in run.frames]
    labels = [f.label for f in run.frames]
    cases = [f.case_id or f.sequence_id or f.frame_id for f in run.frames]
    tau = run.primary_tau if run.primary_tau is not None else 0.5
    return FrameSample.build(probs, labels, cases, tau)


def paired_deltas(
    run_set: RunSet,
    *,
    metrics: Sequence[str] = ("auroc", "f1"),
    n_resamples: int = 2000,
) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """True-metric cluster-bootstrap paired deltas per configured comparison.

    Each replicate resamples case clusters and recomputes the actual metric
    (AUROC via ranks, threshold metrics at the run's τ) — not a per-frame
    proxy — matching the reference's delta machinery
    (``exp4_report.py:913-1007``).
    """
    comparisons = run_set.config.comparisons
    if not comparisons:
        return {}

    results: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for baseline, contender in comparisons:
        if baseline not in run_set.runs or contender not in run_set.runs:
            continue
        samples: Dict[str, Dict[int, FrameSample]] = {}
        for condition in (baseline, contender):
            samples[condition] = {
                seed: frame_sample_of(run)
                for seed, run in run_set.runs[condition].items()
            }
        boot = FrameBootstrapper(samples, n_resamples=n_resamples)
        results[(baseline, contender)] = {
            "metrics": {
                metric: boot.paired_delta(baseline, contender, metric=metric).as_dict()
                for metric in metrics
            },
        }
    return results


def t_confidence_interval(
    values: Sequence[float], *, level: float = 0.95
) -> Optional[Tuple[float, float]]:
    """Two-sided Student-t CI for the mean of ``values`` (reference
    ``exp2_report.py:272-295``).  Needs ≥2 finite values."""
    finite = [float(v) for v in values if math.isfinite(float(v))]
    if len(finite) < 2:
        return None
    arr = np.asarray(finite, dtype=float)
    mean = float(arr.mean())
    std = float(arr.std(ddof=1))
    if std <= 0.0:
        return mean, mean
    from scipy.stats import t as student_t

    margin = float(student_t.ppf(0.5 + level / 2.0, arr.size - 1)) * std / math.sqrt(arr.size)
    return mean - margin, mean + margin


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def render_markdown_tables(
    run_set: RunSet,
    aggregates: Mapping[str, Mapping[str, Mapping[str, float]]],
    deltas: Mapping[Tuple[str, str], Mapping[str, Any]],
) -> str:
    config = run_set.config
    lines: List[str] = [f"# {config.title}", ""]
    lines.append(f"Experiment: `{config.exp_id}` — {len(run_set.runs)} conditions, "
                 f"seeds {list(config.expected_seeds)}")
    lines.append("")

    metrics = list(config.metrics)
    lines.append("## Test metrics (mean ± std over seeds)")
    lines.append("")
    lines.append("| condition | " + " | ".join(metrics) + " |")
    lines.append("|" + "---|" * (len(metrics) + 1))
    for condition in run_set.conditions():
        cells = []
        for metric in metrics:
            stats = aggregates.get(condition, {}).get(metric)
            if not stats:
                cells.append("—")
            else:
                cells.append(f"{format_value(stats['mean'])} ± {format_value(stats['std'])}")
        lines.append(f"| {condition} | " + " | ".join(cells) + " |")
    lines.append("")

    if deltas:
        lines.append("## Paired deltas (true-metric cluster bootstrap, 95% CI)")
        lines.append("")
        t_col = " t 95% CI |" if config.include_t_ci else ""
        lines.append("| baseline | contender | metric | Δ | 95% CI |" + t_col)
        lines.append("|---|---|---|---|---|" + ("---|" if t_col else ""))
        for (baseline, contender), info in deltas.items():
            for metric, delta in info["metrics"].items():
                row = (
                    f"| {baseline} | {contender} | {metric} | "
                    f"{format_delta(delta['mean'])} | "
                    f"[{format_value(delta['ci_lower'])}, {format_value(delta['ci_upper'])}] |"
                )
                if config.include_t_ci:
                    interval = t_confidence_interval(list((delta.get("per_seed") or {}).values()))
                    cell = (
                        f"[{format_value(interval[0])}, {format_value(interval[1])}]"
                        if interval else "—"
                    )
                    row += f" {cell} |"
                lines.append(row)
        lines.append("")

    for section in config.extra_sections:
        lines.extend(section(run_set))
    return "\n".join(lines) + "\n"


def write_metric_csv(
    path: Path,
    aggregates: Mapping[str, Mapping[str, Mapping[str, float]]],
    metrics: Sequence[str],
) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as handle:
        writer = csv.writer(handle)
        writer.writerow(["condition", "metric", "mean", "std", "min", "max", "n"])
        for condition in sorted(aggregates):
            for metric in metrics:
                stats = aggregates[condition].get(metric)
                if not stats:
                    continue
                writer.writerow([
                    condition, metric,
                    stats["mean"], stats["std"], stats["min"], stats["max"], stats["n"],
                ])
    return path


def generate_report(
    runs_root: str | Path,
    config: ReportConfig,
    output_dir: str | Path,
    *,
    check_seed_protocol: bool = True,
    delta_metrics: Sequence[str] = ("auroc", "f1"),
    n_resamples: int = 2000,
) -> Dict[str, Any]:
    """Full pipeline: discover → validate → aggregate → render → manifest."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    run_set = discover_runs(runs_root, config)
    run_set.n_resamples = int(n_resamples)
    if check_seed_protocol:
        check_seeds(run_set)
    aggregates = aggregate_conditions(run_set)
    deltas = paired_deltas(run_set, metrics=delta_metrics, n_resamples=n_resamples)

    markdown = render_markdown_tables(run_set, aggregates, deltas)
    if config.artifact_sections:
        artifact_lines: List[str] = []
        for section in config.artifact_sections:
            artifact_lines.extend(section(run_set, output_dir))
        if artifact_lines:
            markdown = markdown + "\n".join(artifact_lines) + "\n"
    md_path = output_dir / f"{config.exp_id}_report.md"
    md_path.write_text(markdown, encoding="utf-8")
    csv_path = write_metric_csv(
        output_dir / f"{config.exp_id}_metrics.csv", aggregates, config.metrics
    )

    runs_flat = [
        {
            "condition": condition,
            "seed": seed,
            "metrics_path": str(run.metrics_path),
        }
        for condition, seeds in run_set.runs.items()
        for seed, run in seeds.items()
    ]
    manifest = build_report_manifest(
        config.exp_id,
        runs=runs_flat,
        outputs=[md_path, csv_path],
        extra={
            "deltas": {
                f"{a}->{b}": info["metrics"] for (a, b), info in deltas.items()
            },
        },
    )
    manifest_path = output_dir / f"{config.exp_id}_manifest.json"
    manifest_path.write_text(json.dumps(manifest, indent=2, default=str), encoding="utf-8")
    return {
        "markdown": md_path,
        "csv": csv_path,
        "manifest": manifest_path,
        "aggregates": aggregates,
        "deltas": deltas,
        "run_set": run_set,
    }
