"""True-metric cluster bootstrap over exported per-frame artifacts.

Where :mod:`.bootstrapper` resamples pre-computed per-frame *values*, this
module resamples (prob, label) pairs and recomputes the actual metric —
AUROC via the Mann–Whitney rank statistic, threshold metrics at the run's
τ — per replicate, matching the reference's frame-level delta machinery
(``analysis/exp4_report.py:913-1114``, ``exp5c_report.py:508-575``) instead
of a per-frame proxy.  Draws are deterministic (rng 1337) and shared across
paired comparisons so deltas are honestly paired.

The port's copy of ``ssl4polyp_tpu/analysis/frame_bootstrap.py``: AUPRC
comes from the port's :func:`..metrics.performance.average_precision_binary`
in place of scikit-learn's, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..metrics.performance import average_precision_binary
from .bootstrapper import DEFAULT_BOOTSTRAP_SEED, BootstrapDeltaResult

__all__ = [
    "FrameSample",
    "FrameBootstrapper",
    "metric_from_frames",
    "CurveBootstrapResult",
    "bootstrap_curves",
]


# ---------------------------------------------------------------------------
# Vectorised metric implementations
# ---------------------------------------------------------------------------

def _auroc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mann–Whitney AUROC with average-rank tie handling."""
    pos = labels == 1
    n_pos = int(pos.sum())
    n_neg = int(labels.size - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    from scipy.stats import rankdata

    ranks = rankdata(probs)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _confusion(probs: np.ndarray, labels: np.ndarray, tau: float):
    preds = probs >= tau
    tp = float(np.sum(preds & (labels == 1)))
    fp = float(np.sum(preds & (labels == 0)))
    fn = float(np.sum(~preds & (labels == 1)))
    tn = float(np.sum(~preds & (labels == 0)))
    return tp, fp, tn, fn


def metric_from_frames(
    metric: str, probs: np.ndarray, labels: np.ndarray, tau: float
) -> float:
    """One scalar metric recomputed from raw frames (possibly resampled)."""
    if metric == "auroc":
        return _auroc(probs, labels)
    if metric == "auprc":
        if np.unique(labels).size < 2:
            return float("nan")
        return average_precision_binary(labels, probs)
    tp, fp, tn, fn = _confusion(probs, labels, tau)
    if metric == "f1":
        denom = 2 * tp + fp + fn
        return float(2 * tp / denom) if denom else 0.0
    if metric == "recall":
        return float(tp / (tp + fn)) if (tp + fn) else 0.0
    if metric == "precision":
        return float(tp / (tp + fp)) if (tp + fp) else 0.0
    if metric == "balanced_accuracy":
        tpr = tp / (tp + fn) if (tp + fn) else 0.0
        tnr = tn / (tn + fp) if (tn + fp) else 0.0
        return float((tpr + tnr) / 2.0)
    if metric == "mcc":
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0
    if metric == "accuracy":
        total = tp + fp + tn + fn
        return float((tp + tn) / total) if total else 0.0
    raise ValueError(f"Unsupported frame metric {metric!r}")


# ---------------------------------------------------------------------------
# Samples and cluster resampling
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrameSample:
    """One run's frames: probabilities, labels, cluster ids, decision τ."""

    probs: np.ndarray
    labels: np.ndarray
    clusters: Tuple[Tuple[int, ...], ...]  # frame indices grouped by cluster
    tau: float
    # Cluster identity per group, aligned with ``clusters``.  Paired deltas
    # draw cluster KEYS once and map them into each run's own index groups —
    # pairing then survives row-order and coverage differences between runs.
    cluster_keys: Tuple[str, ...] = ()

    @classmethod
    def build(
        cls,
        probs: Sequence[float],
        labels: Sequence[int],
        cluster_ids: Optional[Sequence[object]] = None,
        tau: float = 0.5,
    ) -> "FrameSample":
        probs_arr = np.asarray(probs, dtype=float)
        labels_arr = np.asarray(labels, dtype=int)
        if probs_arr.size == 0:
            raise ValueError("FrameSample needs at least one frame")
        if cluster_ids is None:
            groups: Tuple[Tuple[int, ...], ...] = tuple(
                (i,) for i in range(probs_arr.size)
            )
            keys = tuple(str(i) for i in range(probs_arr.size))
        else:
            by_id: Dict[object, List[int]] = {}
            for i, cid in enumerate(cluster_ids):
                by_id.setdefault(cid, []).append(i)
            items = sorted(by_id.items(), key=lambda kv: str(kv[0]))
            groups = tuple(tuple(v) for _, v in items)
            keys = tuple(str(k) for k, _ in items)
        return cls(probs=probs_arr, labels=labels_arr, clusters=groups,
                   tau=float(tau), cluster_keys=keys)

    def resample(self, rng: np.random.Generator) -> np.ndarray:
        """Indices for one cluster-bootstrap replicate."""
        n = len(self.clusters)
        chosen = rng.integers(0, n, size=n)
        return np.concatenate([np.asarray(self.clusters[c], dtype=int) for c in chosen])

    def metric(self, metric: str, idx: Optional[np.ndarray] = None) -> float:
        if idx is None:
            return metric_from_frames(metric, self.probs, self.labels, self.tau)
        return metric_from_frames(metric, self.probs[idx], self.labels[idx], self.tau)


class FrameBootstrapper:
    """Paired cluster bootstrap recomputing true metrics per replicate.

    ``samples[condition][seed]`` is a :class:`FrameSample`.  Deltas are paired
    per seed; when two conditions share identical clustering the same draw is
    applied to both (the reference's paired design, ``bootstrapper.py``).
    """

    def __init__(
        self,
        samples: Mapping[Hashable, Mapping[int, FrameSample]],
        *,
        n_resamples: int = 2000,
        seed: int = DEFAULT_BOOTSTRAP_SEED,
    ) -> None:
        self.samples: Dict[Hashable, Dict[int, FrameSample]] = {
            cond: {int(s): fs for s, fs in per_seed.items()}
            for cond, per_seed in samples.items()
        }
        self.n_resamples = int(n_resamples)
        self._seed = int(seed)

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(self._seed)

    def condition_ci(
        self, condition: Hashable, *, metric: str = "auroc", ci: float = 0.95
    ) -> Tuple[float, float, float]:
        """(point, lo, hi): seed-mean metric with a cluster-bootstrap CI."""
        per_seed = self.samples[condition]
        seeds = sorted(per_seed)
        point = float(np.nanmean([per_seed[s].metric(metric) for s in seeds]))
        rng = self._rng()
        draws: List[float] = []
        for _ in range(self.n_resamples):
            vals = [per_seed[s].metric(metric, per_seed[s].resample(rng)) for s in seeds]
            draws.append(float(np.nanmean(vals)))
        arr = np.asarray([d for d in draws if np.isfinite(d)])
        if arr.size == 0:
            return point, float("nan"), float("nan")
        alpha = (1.0 - ci) / 2.0
        return point, float(np.quantile(arr, alpha)), float(np.quantile(arr, 1.0 - alpha))

    def paired_delta(
        self,
        condition_a: Hashable,
        condition_b: Hashable,
        *,
        metric: str = "auroc",
        ci: float = 0.95,
    ) -> BootstrapDeltaResult:
        """Bootstrap distribution of metric(B) − metric(A), paired per seed."""
        sample_a = self.samples[condition_a]
        sample_b = self.samples[condition_b]
        seeds = sorted(set(sample_a) & set(sample_b))
        if not seeds:
            raise ValueError(
                f"conditions {condition_a!r} and {condition_b!r} share no seeds"
            )
        per_seed = {
            s: float(sample_b[s].metric(metric) - sample_a[s].metric(metric))
            for s in seeds
        }
        rng = self._rng()
        # Per-seed pairing tables, hoisted out of the replicate loop.  Each
        # replicate resamples each run's FULL cluster population — so the
        # bootstrap distribution estimates the same statistic as the
        # full-sample point delta above — while maximising pairing: shared
        # cluster keys are drawn ONCE and mapped into each run's own index
        # groups; clusters exclusive to one run are resampled independently
        # (their count per run), degrading gracefully to an independent draw
        # when the key sets are disjoint.  No seed is ever dropped.
        pairing = {}
        for s in seeds:
            fa, fb = sample_a[s], sample_b[s]
            keys_b = set(fb.cluster_keys)
            keys_a = set(fa.cluster_keys)
            shared = [k for k in fa.cluster_keys if k in keys_b]
            lookup_a = dict(zip(fa.cluster_keys, fa.clusters))
            lookup_b = dict(zip(fb.cluster_keys, fb.clusters))
            groups_a = [np.asarray(lookup_a[k], dtype=int) for k in shared]
            groups_b = [np.asarray(lookup_b[k], dtype=int) for k in shared]
            excl_a = [np.asarray(lookup_a[k], dtype=int)
                      for k in fa.cluster_keys if k not in keys_b]
            excl_b = [np.asarray(lookup_b[k], dtype=int)
                      for k in fb.cluster_keys if k not in keys_a]
            pairing[s] = (shared, groups_a, groups_b, excl_a, excl_b)
        draws: List[float] = []
        for _ in range(self.n_resamples):
            deltas = []
            for s in seeds:
                fa, fb = sample_a[s], sample_b[s]
                shared, groups_a, groups_b, excl_a, excl_b = pairing[s]
                parts_a: List[np.ndarray] = []
                parts_b: List[np.ndarray] = []
                if shared:
                    draw = rng.integers(0, len(shared), size=len(shared))
                    parts_a += [groups_a[int(d)] for d in draw]
                    parts_b += [groups_b[int(d)] for d in draw]
                if excl_a:
                    draw_a = rng.integers(0, len(excl_a), size=len(excl_a))
                    parts_a += [excl_a[int(d)] for d in draw_a]
                if excl_b:
                    draw_b = rng.integers(0, len(excl_b), size=len(excl_b))
                    parts_b += [excl_b[int(d)] for d in draw_b]
                idx_a = np.concatenate(parts_a)
                idx_b = np.concatenate(parts_b)
                deltas.append(fb.metric(metric, idx_b) - fa.metric(metric, idx_a))
            if deltas:
                draws.append(float(np.nanmean(deltas)))
        arr = np.asarray([d for d in draws if np.isfinite(d)])
        alpha = (1.0 - ci) / 2.0
        return BootstrapDeltaResult(
            mean=float(np.nanmean(list(per_seed.values()))),
            per_seed=per_seed,
            samples=tuple(float(d) for d in draws),
            ci_lower=float(np.quantile(arr, alpha)) if arr.size else None,
            ci_upper=float(np.quantile(arr, 1.0 - alpha)) if arr.size else None,
        )


# ---------------------------------------------------------------------------
# Curve (learning-curve / few-shot) bootstrap with shared draws
# ---------------------------------------------------------------------------

@dataclass
class CurveBootstrapResult:
    """Curves over an ordered x-axis plus AULC point estimates, CIs and
    paired per-x / AULC deltas (reference ``exp4_report.py:537-1116``)."""

    xs: List[float]
    # series → x → (point, lo, hi)
    points: Dict[str, Dict[float, Tuple[float, float, float]]]
    # series → (aulc, lo, hi)
    aulc: Dict[str, Tuple[float, float, float]]
    # (series_a, series_b) → x → BootstrapDeltaResult
    per_x_deltas: Dict[Tuple[str, str], Dict[float, BootstrapDeltaResult]]
    # (series_a, series_b) → (delta, lo, hi)
    aulc_deltas: Dict[Tuple[str, str], Tuple[float, float, float]]


def _aulc(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Normalised area under the curve over log10(x) (reference
    ``exp4_report.py:667-691``).  Nonpositive x (e.g. a zero-shot anchor at
    budget 0) are excluded from the integral."""
    pairs = [(x, y) for x, y in zip(xs, ys) if np.isfinite(y) and x > 0]
    if len(pairs) < 2:
        return float("nan")
    log_x = np.log10([p[0] for p in pairs])
    values = [p[1] for p in pairs]
    span = log_x[-1] - log_x[0]
    return float(np.trapezoid(values, log_x) / span) if span else float("nan")


def bootstrap_curves(
    data: Mapping[str, Mapping[float, Mapping[int, FrameSample]]],
    *,
    metric: str = "auroc",
    n_resamples: int = 2000,
    ci: float = 0.95,
    pairs: Sequence[Tuple[str, str]] = (),
    seed: int = DEFAULT_BOOTSTRAP_SEED,
) -> CurveBootstrapResult:
    """``data[series][x][seed]`` → curves, AULCs and paired deltas.

    All statistics come from ONE set of draws, so the AULC delta between two
    series pairs each replicate's curves (the reference's
    ``bootstrap_aulc_delta`` semantics) rather than differencing independent
    CIs.
    """
    xs = sorted({x for per_x in data.values() for x in per_x})
    series_names = sorted(data)
    alpha = (1.0 - ci) / 2.0

    # Point estimates (seed means of full-sample metrics)
    points: Dict[str, Dict[float, Tuple[float, float, float]]] = {}
    curves_point: Dict[str, List[float]] = {}
    for name in series_names:
        curves_point[name] = []
        points[name] = {}
        for x in xs:
            per_seed = data[name].get(x)
            if not per_seed:
                curves_point[name].append(float("nan"))
                continue
            value = float(np.nanmean([fs.metric(metric) for fs in per_seed.values()]))
            curves_point[name].append(value)
            points[name][x] = (value, float("nan"), float("nan"))

    # Shared, genuinely PAIRED draws: at each (x, seed) the SAME drawn
    # cluster-key multiset maps into every series' own index groups, so a
    # replicate's delta differences correlated resamples (variance
    # Var(a)+Var(b)-2Cov) — the tables below advertise "paired bootstrap"
    # and must mean it.  Series at one x share the test pack (composition
    # is guardrail-validated identical), so the shared-key intersection is
    # normally every cluster; a series with disjoint clusters falls back
    # to an independent draw for that (x, seed).
    rng = np.random.default_rng(seed)
    pair_tables: Dict[Tuple[float, int], Tuple[int, Dict[str, list]]] = {}
    for x in xs:
        seeds_at_x = sorted(
            {s for name in series_names for s in (data[name].get(x) or {})}
        )
        for s in seeds_at_x:
            present = [n for n in series_names if s in (data[n].get(x) or {})]
            if len(present) < 2:
                continue
            key_lists = [data[n][x][s].cluster_keys for n in present]
            rest = [set(ks) for ks in key_lists[1:]]
            shared = [k for k in key_lists[0] if all(k in r for r in rest)]
            if not shared:
                continue
            shared_set = set(shared)
            groups = {}
            excl: Dict[str, list] = {}
            for n in present:
                fs = data[n][x][s]
                lookup = dict(zip(fs.cluster_keys, fs.clusters))
                groups[n] = [np.asarray(lookup[k], dtype=int) for k in shared]
                # Clusters exclusive to this series are resampled
                # independently each replicate so the replicate metric is
                # over the series' FULL population (matching the point
                # estimate) even under coverage skew.
                excl[n] = [
                    np.asarray(lookup[k], dtype=int)
                    for k in fs.cluster_keys if k not in shared_set
                ]
            pair_tables[(x, s)] = (len(shared), groups, excl)

    draw_values: Dict[str, Dict[float, List[float]]] = {
        name: {x: [] for x in xs} for name in series_names
    }
    draw_aulc: Dict[str, List[float]] = {name: [] for name in series_names}
    for _ in range(n_resamples):
        shared_draws: Dict[Tuple[float, int], np.ndarray] = {
            key: rng.integers(0, n_keys, size=n_keys)
            for key, (n_keys, _, _) in pair_tables.items()
        }
        for name in series_names:
            curve = []
            for x in xs:
                per_seed = data[name].get(x)
                if not per_seed:
                    curve.append(float("nan"))
                    continue
                vals = []
                for s, fs in sorted(per_seed.items()):
                    table = pair_tables.get((x, s))
                    if table is not None and name in table[1]:
                        draw = shared_draws[(x, s)]
                        groups = table[1][name]
                        parts = [groups[int(d)] for d in draw]
                        excl = table[2][name]
                        if excl:
                            draw_e = rng.integers(0, len(excl), size=len(excl))
                            parts += [excl[int(d)] for d in draw_e]
                        vals.append(fs.metric(metric, np.concatenate(parts)))
                    else:
                        vals.append(fs.metric(metric, fs.resample(rng)))
                value = float(np.nanmean(vals))
                draw_values[name][x].append(value)
                curve.append(value)
            draw_aulc[name].append(_aulc(xs, curve))

    def _ci_of(samples: Sequence[float]) -> Tuple[float, float]:
        arr = np.asarray([s for s in samples if np.isfinite(s)])
        if arr.size == 0:
            return float("nan"), float("nan")
        return float(np.quantile(arr, alpha)), float(np.quantile(arr, 1.0 - alpha))

    for name in series_names:
        for x in xs:
            if x in points[name]:
                lo, hi = _ci_of(draw_values[name][x])
                points[name][x] = (points[name][x][0], lo, hi)

    aulc: Dict[str, Tuple[float, float, float]] = {}
    for name in series_names:
        lo, hi = _ci_of(draw_aulc[name])
        aulc[name] = (_aulc(xs, curves_point[name]), lo, hi)

    per_x_deltas: Dict[Tuple[str, str], Dict[float, BootstrapDeltaResult]] = {}
    aulc_deltas: Dict[Tuple[str, str], Tuple[float, float, float]] = {}
    for a, b in pairs:
        if a not in data or b not in data:
            continue
        per_x: Dict[float, BootstrapDeltaResult] = {}
        for i, x in enumerate(xs):
            if x not in points.get(a, {}) or x not in points.get(b, {}):
                continue
            deltas = [
                vb - va
                for va, vb in zip(draw_values[a][x], draw_values[b][x])
                if np.isfinite(va) and np.isfinite(vb)
            ]
            lo, hi = _ci_of(deltas)
            per_x[x] = BootstrapDeltaResult(
                mean=float(curves_point[b][i] - curves_point[a][i]),
                per_seed={},
                samples=tuple(deltas),
                ci_lower=lo,
                ci_upper=hi,
            )
        per_x_deltas[(a, b)] = per_x
        paired = [
            db - da
            for da, db in zip(draw_aulc[a], draw_aulc[b])
            if np.isfinite(da) and np.isfinite(db)
        ]
        lo, hi = _ci_of(paired)
        aulc_deltas[(a, b)] = (float(aulc[b][0] - aulc[a][0]), lo, hi)

    return CurveBootstrapResult(
        xs=list(xs),
        points=points,
        aulc=aulc,
        per_x_deltas=per_x_deltas,
        aulc_deltas=aulc_deltas,
    )
