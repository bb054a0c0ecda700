"""Per-experiment report definitions (exp1–exp5c) over the shared core.

Each experiment contributes its grouping rule, comparison pairs and extra
sections; everything else (discovery, guardrails, seed checks, bootstrap,
rendering) comes from :mod:`.report_core`.  Reference counterparts:
``analysis/exp{1,2,3,4,5a,5b,5c}_report.py``.

The port's copy of ``ssl4polyp_tpu/analysis/exp_reports.py``, run as
``python -m ssl4polyp_tpu_torch.analysis.exp_reports`` with the same arguments.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .common import CommonRun, read_outputs_csv
from .display import format_delta, format_value
from .frame_bootstrap import FrameSample, bootstrap_curves
from .report_core import ReportConfig, RunSet, frame_sample_of, generate_report

__all__ = ["REPORTS", "build_report_config", "run_report", "main"]


def _model_of(run: CommonRun) -> Optional[str]:
    return run.model


def _x_token(value: float) -> str:
    """Compact x-axis token: integral values keep the p10/p25 form, while
    fractional ones stay distinct (int() would collapse 12.5 → 12 and
    0.5 → 0, corrupting condition identity and curve labels)."""
    value = float(value)
    return str(int(value)) if value == int(value) else repr(value)


def _subset_condition(run: CommonRun) -> Optional[str]:
    provenance = run.payload.get("provenance") or {}
    percent = provenance.get("subset_percent", 100)
    model = run.model or "model"
    return f"{model}@p{_x_token(percent)}"


def _fewshot_condition(run: CommonRun) -> Optional[str]:
    provenance = run.payload.get("provenance") or {}
    budget = provenance.get("fewshot_budget")
    model = run.model or "model"
    return f"{model}@s{budget}" if budget is not None else model


# ---------------------------------------------------------------------------
# Extra sections
# ---------------------------------------------------------------------------

# -- exp3: multi-policy morphology strata (frame-recomputed) ----------------
#
# Reference depth (``exp3_report.py:115-216,383-515,696-760``): each stratum
# (overall / flat+negs / polypoid+negs, negatives shared) is evaluated under
# EVERY threshold policy the runs carry, recomputed from the exported
# outputs-CSV frames at that policy's τ, with paired case-cluster bootstrap
# CIs on the model deltas and within-model flat−polypoid contrasts.

EXP3_STRATA = ("overall", "flat_plus_negs", "polypoid_plus_negs")
EXP3_METRICS = ("auroc", "f1", "recall", "precision", "balanced_accuracy")
_KNOWN_POLICIES = ("f1_opt_on_val", "youden_on_val", "val_opt_youden", "sun_val_frozen")


def run_policy_taus(run: CommonRun) -> Dict[str, float]:
    """Every threshold policy the run declares, mapped to its τ (reference
    ``exp3_report.py:295-343`` gathers primary + sensitivity + the
    ``thresholds.values`` map, matching known policy names by suffix)."""
    block = run.payload.get("thresholds") or {}
    taus: Dict[str, float] = {}

    def register(policy, tau) -> None:
        if not isinstance(policy, str):
            return
        name = policy.strip().lower()
        if name and isinstance(tau, (int, float)) and math.isfinite(float(tau)):
            taus.setdefault(name, float(tau))

    for key in ("primary", "sensitivity"):
        record = block.get(key)
        if isinstance(record, dict):
            register(record.get("policy"), record.get("tau"))
    values = block.get("values")
    if isinstance(values, dict):
        for key, tau in values.items():
            text = str(key).strip().lower()
            for candidate in _KNOWN_POLICIES:
                if text.endswith(candidate):
                    register(candidate, tau)
                    break
    return taus


def strata_masks(run: CommonRun) -> Dict[str, np.ndarray]:
    """Boolean frame masks per stratum; negatives belong to every stratum
    (reference ``compute_strata_metrics``, ``exp3_report.py:198-214``)."""
    labels = np.asarray([f.label for f in run.frames], dtype=int)
    morph = np.asarray(
        [str(f.morphology or "unknown").strip().lower() for f in run.frames]
    )
    neg = labels == 0
    pos = labels == 1
    return {
        "overall": np.ones(labels.size, dtype=bool),
        "flat_plus_negs": neg | (pos & (morph == "flat")),
        "polypoid_plus_negs": neg | (pos & (morph == "polypoid")),
    }


class _Exp3Run:
    """One run's frames pre-indexed for strata × policy recomputation."""

    def __init__(self, run: CommonRun):
        if not run.frames:
            raise ValueError(f"exp3 strata need outputs-CSV frames: {run.metrics_path}")
        self.probs = np.asarray([f.prob for f in run.frames], dtype=float)
        self.labels = np.asarray([f.label for f in run.frames], dtype=int)
        self.masks = strata_masks(run)
        self.taus = run_policy_taus(run)
        cases: Dict[str, List[int]] = {}
        for i, frame in enumerate(run.frames):
            cid = str(frame.case_id or frame.sequence_id or frame.frame_id)
            cases.setdefault(cid, []).append(i)
        self.cases = {cid: np.asarray(ix, dtype=int) for cid, ix in sorted(cases.items())}

    def metric(self, metric: str, stratum: str, policy: str,
               idx: Optional[np.ndarray] = None) -> float:
        from .frame_bootstrap import metric_from_frames

        tau = self.taus[policy]
        if idx is None:
            sel = self.masks[stratum]
            return metric_from_frames(metric, self.probs[sel], self.labels[sel], tau)
        sel = idx[self.masks[stratum][idx]]
        if sel.size == 0:
            return float("nan")
        return metric_from_frames(metric, self.probs[sel], self.labels[sel], tau)

    def resample(self, rng: np.random.Generator,
                 case_ids: Optional[Sequence[str]] = None) -> np.ndarray:
        ids = list(case_ids) if case_ids is not None else list(self.cases)
        draw = rng.integers(0, len(ids), size=len(ids))
        return np.concatenate([self.cases[ids[int(d)]] for d in draw])

    def indices_for(self, case_ids: Sequence[str]) -> np.ndarray:
        """Frame indices for an already-drawn case-id multiset (paired
        bootstrap: the SAME drawn ids map into each run's own index
        arrays, so pairing holds regardless of CSV row order or
        coverage differences between the two runs)."""
        return np.concatenate([self.cases[cid] for cid in case_ids])


def _quantile_ci(samples: Sequence[float]) -> tuple:
    arr = np.asarray([s for s in samples if math.isfinite(s)])
    if arr.size == 0:
        return float("nan"), float("nan")
    return float(np.quantile(arr, 0.025)), float(np.quantile(arr, 0.975))


def _strata_policy_section(run_set: RunSet) -> List[str]:
    """exp3: strata × policy tables recomputed from frames, with pairwise
    model deltas and flat−polypoid contrasts under paired case bootstrap."""
    from .seed_checks import SeedCheckError  # noqa: F401 (documentation import)

    prepared: Dict[str, Dict[int, _Exp3Run]] = {}
    missing: List[str] = []
    for condition in run_set.conditions():
        for seed, run in run_set.runs[condition].items():
            if run.frames:
                prepared.setdefault(condition, {})[seed] = _Exp3Run(run)
            else:
                missing.append(f"{condition} seed {seed} ({run.metrics_path})")
    if missing and prepared:
        # Partial coverage would silently skew the strata tables and the
        # paired deltas — fail loudly (reports never silently skip runs).
        from .guardrails import GuardrailViolation

        raise GuardrailViolation(
            "exp3 strata need outputs CSVs for every run; missing: "
            + "; ".join(missing)
        )
    if not prepared:
        return []

    # Only policies every run carries are comparable across the board.
    policies: Optional[set] = None
    for per_seed in prepared.values():
        for erun in per_seed.values():
            policies = set(erun.taus) if policies is None else policies & set(erun.taus)
    policy_order = [p for p in _KNOWN_POLICIES if policies and p in policies]
    if not policy_order:
        return []

    n_resamples = run_set.n_resamples
    lines: List[str] = ["## Morphology strata × threshold policy (frame-recomputed)", ""]
    lines.append("| policy | condition | stratum | " + " | ".join(EXP3_METRICS) + " |")
    lines.append("|" + "---|" * (len(EXP3_METRICS) + 3))
    for policy in policy_order:
        for condition in sorted(prepared):
            per_seed = prepared[condition]
            for stratum in EXP3_STRATA:
                cells = []
                for metric in EXP3_METRICS:
                    vals = [
                        per_seed[s].metric(metric, stratum, policy)
                        for s in sorted(per_seed)
                    ]
                    finite = [v for v in vals if math.isfinite(v)]
                    if not finite:
                        cells.append("—")
                        continue
                    mean = float(np.mean(finite))
                    std = float(np.std(finite, ddof=1)) if len(finite) > 1 else 0.0
                    cells.append(f"{format_value(mean)} ± {format_value(std)}")
                lines.append(f"| {policy} | {condition} | {stratum} | " + " | ".join(cells) + " |")
    lines.append("")

    # Pairwise model deltas per policy × stratum (paired case bootstrap:
    # the same sampled case ids drive both runs of a pair each replicate).
    rng_root = np.random.default_rng(1337)
    delta_lines: List[str] = []
    for baseline, contender in run_set.config.comparisons:
        if baseline not in prepared or contender not in prepared:
            continue
        base_runs, cont_runs = prepared[baseline], prepared[contender]
        seeds = sorted(set(base_runs) & set(cont_runs))
        if not seeds:
            continue
        # Shared cases are drawn ONCE per replicate and mapped into each
        # run's own index arrays (paired); cases exclusive to one run are
        # resampled independently so each replicate covers each run's FULL
        # case population — the bootstrap then estimates the same statistic
        # as the full-sample point delta even under coverage skew.
        case_pairing = {}
        for s in seeds:
            base_ids = set(base_runs[s].cases)
            cont_ids = set(cont_runs[s].cases)
            case_pairing[s] = (
                sorted(base_ids & cont_ids),
                sorted(base_ids - cont_ids),
                sorted(cont_ids - base_ids),
            )
        for policy in policy_order:
            for stratum in EXP3_STRATA:
                for metric in ("auroc", "f1"):
                    points = [
                        cont_runs[s].metric(metric, stratum, policy)
                        - base_runs[s].metric(metric, stratum, policy)
                        for s in seeds
                    ]
                    point = float(np.nanmean(points))
                    draws: List[float] = []
                    for _ in range(n_resamples):
                        vals = []
                        for s in seeds:
                            shared, excl_b, excl_c = case_pairing[s]
                            ids_b: List[str] = []
                            ids_c: List[str] = []
                            if shared:
                                draw = rng_root.integers(
                                    0, len(shared), size=len(shared))
                                drawn = [shared[int(d)] for d in draw]
                                ids_b += drawn
                                ids_c += drawn
                            if excl_b:
                                draw = rng_root.integers(
                                    0, len(excl_b), size=len(excl_b))
                                ids_b += [excl_b[int(d)] for d in draw]
                            if excl_c:
                                draw = rng_root.integers(
                                    0, len(excl_c), size=len(excl_c))
                                ids_c += [excl_c[int(d)] for d in draw]
                            idx_b = base_runs[s].indices_for(ids_b)
                            idx_c = cont_runs[s].indices_for(ids_c)
                            vals.append(
                                cont_runs[s].metric(metric, stratum, policy, idx_c)
                                - base_runs[s].metric(metric, stratum, policy, idx_b)
                            )
                        if vals:
                            draws.append(float(np.nanmean(vals)))
                    lo, hi = _quantile_ci(draws)
                    delta_lines.append(
                        f"| {baseline} | {contender} | {policy} | {stratum} | {metric} | "
                        f"{format_delta(point)} | [{format_value(lo)}, {format_value(hi)}] |"
                    )
    if delta_lines:
        lines.append("### Pairwise deltas by policy and stratum (paired case bootstrap, 95% CI)")
        lines.append("")
        lines.append("| baseline | contender | policy | stratum | metric | Δ | 95% CI |")
        lines.append("|---|---|---|---|---|---|---|")
        lines.extend(delta_lines)
        lines.append("")

    # Within-model flat − polypoid contrast (same case resample, two strata).
    contrast_lines: List[str] = []
    for condition in sorted(prepared):
        per_seed = prepared[condition]
        seeds = sorted(per_seed)
        for policy in policy_order:
            for metric in ("auroc", "f1"):
                points = [
                    per_seed[s].metric(metric, "flat_plus_negs", policy)
                    - per_seed[s].metric(metric, "polypoid_plus_negs", policy)
                    for s in seeds
                ]
                point = float(np.nanmean(points))
                draws = []
                for _ in range(n_resamples):
                    vals = []
                    for s in seeds:
                        idx = per_seed[s].resample(rng_root)
                        vals.append(
                            per_seed[s].metric(metric, "flat_plus_negs", policy, idx)
                            - per_seed[s].metric(metric, "polypoid_plus_negs", policy, idx)
                        )
                    draws.append(float(np.nanmean(vals)))
                lo, hi = _quantile_ci(draws)
                contrast_lines.append(
                    f"| {condition} | {policy} | {metric} | {format_delta(point)} | "
                    f"[{format_value(lo)}, {format_value(hi)}] |"
                )
    if contrast_lines:
        lines.append("### Flat − polypoid contrast (paired case bootstrap, 95% CI)")
        lines.append("")
        lines.append("| condition | policy | metric | Δ(flat−polypoid) | 95% CI |")
        lines.append("|---|---|---|---|---|")
        lines.extend(contrast_lines)
        lines.append("")
    return lines


def _curve_data_from_conditions(
    run_set: RunSet, separator: str
) -> Dict[str, Dict[float, Dict[int, FrameSample]]]:
    """``model → x → seed → FrameSample`` from ``model@<sep>X`` conditions."""
    data: Dict[str, Dict[float, Dict[int, FrameSample]]] = {}
    for condition, seeds in run_set.runs.items():
        if separator not in condition:
            continue
        model, token = condition.rsplit(separator, 1)
        try:
            x = float(token)
        except ValueError:
            continue
        for seed, run in seeds.items():
            if not run.frames:
                continue
            data.setdefault(model, {}).setdefault(x, {})[seed] = frame_sample_of(run)
    return data


def _format_point_ci(point: float, lo: float, hi: float) -> str:
    if not math.isfinite(point):
        return "—"
    if math.isfinite(lo) and math.isfinite(hi):
        return f"{format_value(point)} [{format_value(lo)}, {format_value(hi)}]"
    return format_value(point)


def _render_curve_tables(
    result,
    *,
    title: str,
    x_label: str,
    x_format,
) -> List[str]:
    """Shared rendering for exp4/exp5c curve bootstraps: per-x points with
    CIs, AULC with CIs, pairwise per-x deltas and AULC deltas."""
    lines = [f"## {title}", ""]
    xs = result.xs
    lines.append(f"| model | " + " | ".join(x_format(x) for x in xs) + " | AULC [95% CI] |")
    lines.append("|" + "---|" * (len(xs) + 2))
    for model in sorted(result.points):
        cells = []
        for x in xs:
            entry = result.points[model].get(x)
            cells.append(_format_point_ci(*entry) if entry else "—")
        aulc, lo, hi = result.aulc[model]
        lines.append(
            f"| {model} | " + " | ".join(cells) + f" | {_format_point_ci(aulc, lo, hi)} |"
        )
    lines.append("")

    if result.per_x_deltas:
        lines.append(f"### Pairwise deltas by {x_label} (AUROC, paired bootstrap 95% CI)")
        lines.append("")
        lines.append(f"| baseline | contender | {x_label} | Δ | 95% CI |")
        lines.append("|---|---|---|---|---|")
        for (a, b), per_x in sorted(result.per_x_deltas.items()):
            for x in xs:
                delta = per_x.get(x)
                if delta is None:
                    continue
                lines.append(
                    f"| {a} | {b} | {x_format(x)} | {format_delta(delta.mean)} | "
                    f"[{format_value(delta.ci_lower)}, {format_value(delta.ci_upper)}] |"
                )
        lines.append("")
        lines.append("### AULC deltas (paired bootstrap 95% CI)")
        lines.append("")
        lines.append("| baseline | contender | ΔAULC | 95% CI |")
        lines.append("|---|---|---|---|")
        for (a, b), (delta, lo, hi) in sorted(result.aulc_deltas.items()):
            lines.append(
                f"| {a} | {b} | {format_delta(delta)} | "
                f"[{format_value(lo)}, {format_value(hi)}] |"
            )
        lines.append("")
    return lines


def _learning_curve_section(run_set: RunSet) -> List[str]:
    """exp4: frame-recomputed AUROC learning curves with bootstrap CIs,
    per-percent pairwise deltas and paired AULC deltas (reference
    ``exp4_report.py:537-1116``)."""
    data = _curve_data_from_conditions(run_set, "@p")
    if not data:
        return []
    models = sorted(data)
    pairs = [(a, b) for i, a in enumerate(models) for b in models[i + 1:]]
    result = bootstrap_curves(
        data, metric="auroc", n_resamples=run_set.n_resamples, pairs=pairs
    )
    return _render_curve_tables(
        result,
        title="Learning curves (test AUROC by train-subset percent)",
        x_label="percent",
        x_format=lambda x: f"p{_x_token(x)}",
    )


def _parse_perturbation_tag(tag: str) -> tuple:
    """``"blur_sigma=1.5"`` → ("blur_sigma", 1.5); unparameterised tags get
    severity NaN (reference ``exp5b_report.py:214-268`` tag grammar)."""
    first = str(tag).split("|", 1)[0]
    if "=" in first:
        family, _, value = first.partition("=")
        try:
            return family, float(value)
        except ValueError:
            return family, float("nan")
    return first, float("nan")


def _case_delta_bootstrap(
    per_seed_deltas: Dict[int, np.ndarray],
    n_resamples: int,
) -> tuple:
    """(mean, lo, hi) of the seed-averaged mean per-case delta, resampling
    cases with replacement per seed (rng 1337, reference
    ``exp5b_report.py:755-838``)."""
    seeds = sorted(per_seed_deltas)
    point = float(np.mean([np.mean(per_seed_deltas[s]) for s in seeds]))
    rng = np.random.default_rng(1337)
    draws = []
    for _ in range(n_resamples):
        vals = []
        for s in seeds:
            deltas = per_seed_deltas[s]
            idx = rng.integers(0, deltas.size, size=deltas.size)
            vals.append(float(np.mean(deltas[idx])))
        draws.append(float(np.mean(vals)))
    arr = np.asarray(draws)
    return point, float(np.quantile(arr, 0.025)), float(np.quantile(arr, 0.975))


def _retention_from_frames(run: CommonRun) -> Optional[tuple]:
    """(tag→f1, tag→{case→f1}) recomputed from tagged outputs-CSV rows.

    Returns ``None`` when the run's CSV predates the ``perturbation_tag``
    column; the declared ``test_perturbations`` blocks are the fallback.
    Recomputed per-tag F1 is cross-checked against the declared block so
    the engine-declared numbers stay auditable (report_core's
    ``recompute_primary_metrics`` posture extended to exp5b)."""
    if not run.frames or not any(f.perturbation_tag for f in run.frames):
        return None
    from .frame_bootstrap import metric_from_frames
    from .guardrails import GuardrailViolation

    tau = run.primary_tau if run.primary_tau is not None else 0.5
    by_tag: Dict[str, Dict[str, List[int]]] = {}
    probs = np.asarray([f.prob for f in run.frames], dtype=float)
    labels = np.asarray([f.label for f in run.frames], dtype=int)
    for i, frame in enumerate(run.frames):
        tag = frame.perturbation_tag or "clean"
        case = str(frame.case_id or frame.sequence_id or frame.frame_id)
        by_tag.setdefault(tag, {}).setdefault(case, []).append(i)
    tag_f1: Dict[str, float] = {}
    tag_case_f1: Dict[str, Dict[str, float]] = {}
    declared = (run.payload.get("test_perturbations") or {}).get("per_tag") or {}
    for tag, cases in by_tag.items():
        idx = np.concatenate([np.asarray(ix) for ix in cases.values()])
        tag_f1[tag] = metric_from_frames("f1", probs[idx], labels[idx], tau)
        stated = (declared.get(tag) or {}).get("f1")
        if isinstance(stated, (int, float)) and math.isfinite(float(stated)):
            if abs(float(stated) - tag_f1[tag]) > 1e-6:
                raise GuardrailViolation(
                    f"{run.metrics_path}: test_perturbations.per_tag[{tag!r}].f1="
                    f"{float(stated):.8f} disagrees with the outputs-CSV "
                    f"recomputation {tag_f1[tag]:.8f}"
                )
        tag_case_f1[tag] = {
            case: metric_from_frames(
                "f1", probs[np.asarray(ix)], labels[np.asarray(ix)], tau
            )
            for case, ix in cases.items()
        }
    return tag_f1, tag_case_f1


def _retention_section(run_set: RunSet) -> List[str]:
    """exp5b: per-family/per-severity F1 retention vs clean with paired
    case-level bootstrap CIs, recomputed from the exported outputs-CSV
    frames when the ``perturbation_tag`` column is present (reference
    ``exp5b_report.py`` T2/T3 tables + its outputs-CSV requirement)."""
    lines = ["## Perturbation retention (F1 vs clean)", ""]
    any_rows = False
    for condition in run_set.conditions():
        tag_acc: Dict[str, List[float]] = {}
        clean_acc: List[float] = []
        # tag → seed → per-case (tag_f1 − clean_f1) over shared cases
        case_deltas: Dict[str, Dict[int, np.ndarray]] = {}
        for seed, run in run_set.runs[condition].items():
            recomputed = _retention_from_frames(run)
            if recomputed is not None:
                tag_f1, tag_case_f1 = recomputed
                per_tag: Dict[str, Dict[str, float]] = {
                    tag: {"f1": value} for tag, value in tag_f1.items()
                }
                per_case: Dict[str, Dict[str, Dict[str, float]]] = {
                    tag: {case: {"f1": value} for case, value in cases.items()}
                    for tag, cases in tag_case_f1.items()
                }
            else:
                block = run.payload.get("test_perturbations") or {}
                per_tag = block.get("per_tag") or {}
                per_case = block.get("per_case") or {}
            clean = per_tag.get("clean") or {}
            clean_f1 = clean.get("f1")
            if isinstance(clean_f1, (int, float)) and math.isfinite(float(clean_f1)):
                clean_acc.append(float(clean_f1))
            clean_cases = per_case.get("clean") or {}
            for tag, stats in per_tag.items():
                value = stats.get("f1")
                if isinstance(value, (int, float)) and math.isfinite(float(value)):
                    tag_acc.setdefault(tag, []).append(float(value))
                tag_cases = per_case.get(tag) or {}
                shared = sorted(set(tag_cases) & set(clean_cases))
                if tag != "clean" and shared:
                    deltas = np.asarray([
                        float(tag_cases[c].get("f1", 0.0)) - float(clean_cases[c].get("f1", 0.0))
                        for c in shared
                    ])
                    case_deltas.setdefault(tag, {})[seed] = deltas
        if not tag_acc or not clean_acc:
            continue
        if not any_rows:
            lines.append(
                "| condition | family | severity | tag | f1 | retention | "
                "Δf1 vs clean [95% CI] |"
            )
            lines.append("|---|---|---|---|---|---|---|")
            any_rows = True
        clean_mean = float(np.mean(clean_acc))

        def sort_key(tag: str):
            family, severity = _parse_perturbation_tag(tag)
            return (family, severity if math.isfinite(severity) else float("inf"), tag)

        for tag in sorted(tag_acc, key=sort_key):
            mean = float(np.mean(tag_acc[tag]))
            retention = mean / clean_mean if clean_mean else float("nan")
            family, severity = _parse_perturbation_tag(tag)
            if tag in case_deltas:
                point, lo, hi = _case_delta_bootstrap(
                    case_deltas[tag], run_set.n_resamples
                )
                delta_cell = (
                    f"{format_delta(point)} [{format_value(lo)}, {format_value(hi)}]"
                )
            else:
                delta_cell = "—" if tag == "clean" else format_delta(mean - clean_mean)
            severity_cell = format_value(severity) if math.isfinite(severity) else "—"
            lines.append(
                f"| {condition} | {family} | {severity_cell} | {tag} | "
                f"{format_value(mean)} | {format_value(retention)} | {delta_cell} |"
            )
    lines.append("")
    return lines if any_rows else []


def _zero_shot_frame_sample(run: CommonRun) -> Optional[FrameSample]:
    """Load the zero-shot outputs CSV exported by the engine
    (``training/classification.py`` zero-shot anchor block) as a bootstrap
    sample, falling back to None when absent."""
    zero_shot = run.payload.get("zero_shot") or {}
    csv_name = zero_shot.get("outputs_csv")
    if not isinstance(csv_name, str) or not csv_name.strip():
        return None
    csv_path = Path(csv_name)
    if not csv_path.is_absolute():
        csv_path = run.metrics_path.parent / csv_path
    if not csv_path.exists():
        return None
    frames = read_outputs_csv(csv_path)
    if not frames:
        return None
    tau = zero_shot.get("tau")
    return FrameSample.build(
        [f.prob for f in frames],
        [f.label for f in frames],
        [f.case_id or f.sequence_id or f.frame_id for f in frames],
        float(tau) if isinstance(tau, (int, float)) else 0.5,
    )


def _zero_shot_section(run_set: RunSet) -> List[str]:
    """exp5c: few-shot curves over budgets with the zero-shot anchor as the
    budget-0 curve point, per-budget pairwise deltas and AULC deltas
    (reference ``exp5c_report.py`` curve + delta tables)."""
    data = _curve_data_from_conditions(run_set, "@s")
    # Zero-shot anchors enter the curve at budget 0 when their frames exist.
    for condition, seeds in run_set.runs.items():
        if "@s" not in condition:
            continue
        model = condition.rsplit("@s", 1)[0]
        for seed, run in seeds.items():
            anchor = _zero_shot_frame_sample(run)
            if anchor is not None:
                data.setdefault(model, {}).setdefault(0.0, {}).setdefault(seed, anchor)
    lines: List[str] = []
    if data:
        models = sorted(data)
        pairs = [(a, b) for i, a in enumerate(models) for b in models[i + 1:]]
        result = bootstrap_curves(
            data, metric="auroc", n_resamples=run_set.n_resamples, pairs=pairs
        )
        lines += _render_curve_tables(
            result,
            title="Few-shot curves (test AUROC by budget; s0 = zero-shot anchor)",
            x_label="budget",
            x_format=lambda x: f"s{_x_token(x)}",
        )

    # Declared-anchor summary (kept for runs without zero-shot frames).
    rows = []
    for condition in run_set.conditions():
        zs_acc, ft_acc = [], []
        for run in run_set.runs[condition].values():
            zero_shot = run.payload.get("zero_shot") or {}
            zs_value = (zero_shot.get("metrics") or {}).get("auroc")
            ft_value = (run.payload.get("test_primary") or {}).get("auroc")
            if isinstance(zs_value, (int, float)) and math.isfinite(float(zs_value)):
                zs_acc.append(float(zs_value))
            if isinstance(ft_value, (int, float)) and math.isfinite(float(ft_value)):
                ft_acc.append(float(ft_value))
        if not ft_acc:
            continue
        zs_mean = float(np.mean(zs_acc)) if zs_acc else float("nan")
        ft_mean = float(np.mean(ft_acc))
        rows.append((condition, zs_mean, ft_mean))
    if rows:
        lines += ["## Zero-shot anchor vs fine-tuned", ""]
        lines.append("| condition | zero-shot AUROC | fine-tuned AUROC | Δ |")
        lines.append("|---|---|---|---|")
        for condition, zs_mean, ft_mean in rows:
            delta = ft_mean - zs_mean if math.isfinite(zs_mean) else float("nan")
            lines.append(
                f"| {condition} | {format_value(zs_mean)} | {format_value(ft_mean)} | "
                f"{format_delta(delta)} |"
            )
        lines.append("")
    return lines


# ---------------------------------------------------------------------------
# Experiment registry
# ---------------------------------------------------------------------------

def build_report_config(exp: str) -> ReportConfig:
    exp = exp.lower()
    if exp == "exp1":
        return ReportConfig(
            exp_id="exp1",
            title="Exp1 — SUP-imnet vs SSL-imnet on SUN-full",
            comparisons=(("SupImnet", "SslImnet"), ("sup_imnet", "ssl_imnet")),
            required_curve_keys=("test",),
            # exp1's guardrails demand the ROC/PR grids with verified digests
            # (reference ``exp1_report.py:230-263``)
            enforce_curve_exports=True,
        )
    if exp == "exp2":
        return ReportConfig(
            exp_id="exp2",
            title="Exp2 — SSL-colon vs SSL-imnet on SUN-full",
            comparisons=(("SslImnet", "SslColon"), ("ssl_imnet", "ssl_colon")),
            include_t_ci=True,
        )
    if exp in {"exp3", "exp3b"}:
        return ReportConfig(
            exp_id="exp3b",
            title="Exp3 — morphology-stratified evaluation",
            comparisons=(
                ("SupImnet", "SslColon"), ("SslImnet", "SslColon"),
                ("sup_imnet", "ssl_colon"), ("ssl_imnet", "ssl_colon"),
            ),
            extra_sections=(_strata_policy_section,),
        )
    if exp == "exp4":
        return ReportConfig(
            exp_id="exp4",
            title="Exp4 — data-efficiency learning curves",
            condition_fn=_subset_condition,
            extra_sections=(_learning_curve_section,),
        )
    if exp == "exp5a":
        from .exp5a_domain_shift import domain_shift_section

        return ReportConfig(
            exp_id="exp5a",
            title="Exp5a — zero-shot PolypGen transfer",
            # Pairwise CIs come from the centre-clustered bootstrap inside
            # the domain-shift section, not the core's case-clustered one
            # (PolypGen has no case ids — reference exp5a warns and uses
            # centre clusters only, ``exp5a_report.py:809-864``), so
            # ``comparisons`` stays empty here.
            artifact_sections=(domain_shift_section,),
        )
    if exp == "exp5b":
        return ReportConfig(
            exp_id="exp5b",
            title="Exp5b — perturbation robustness",
            extra_sections=(_retention_section,),
        )
    if exp == "exp5c":
        return ReportConfig(
            exp_id="exp5c",
            title="Exp5c — few-shot PolypGen adaptation",
            condition_fn=_fewshot_condition,
            extra_sections=(_zero_shot_section,),
        )
    raise ValueError(f"Unknown experiment {exp!r}")


REPORTS = ("exp1", "exp2", "exp3", "exp4", "exp5a", "exp5b", "exp5c")


def run_report(
    exp: str,
    runs_root: str | Path,
    output_dir: str | Path,
    *,
    check_seed_protocol: bool = True,
    n_resamples: int = 2000,
) -> Dict[str, Any]:
    config = build_report_config(exp)
    return generate_report(
        runs_root, config, output_dir,
        check_seed_protocol=check_seed_protocol,
        n_resamples=n_resamples,
    )


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Generate an experiment report")
    parser.add_argument("experiment", choices=REPORTS)
    parser.add_argument("--runs-root", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--no-seed-check", action="store_true")
    parser.add_argument("--resamples", type=int, default=2000)
    args = parser.parse_args(argv)
    result = run_report(
        args.experiment, args.runs_root, args.output_dir,
        check_seed_protocol=not args.no_seed_check,
        n_resamples=args.resamples,
    )
    print(f"wrote {result['markdown']}")


if __name__ == "__main__":
    main()
