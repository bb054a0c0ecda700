"""Seeded cluster bootstrap for paired metric deltas.

Reference contract (``analysis/bootstrapper.py``): deterministic rng seed
1337; resampling happens at the *cluster* (case) level so correlated frames
from one case move together; paired deltas resample the same clusters for
both conditions; percentile CIs.

The port's copy of ``ssl4polyp_tpu/analysis/bootstrapper.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BootstrapDeltaResult", "Bootstrapper", "DEFAULT_BOOTSTRAP_SEED"]

DEFAULT_BOOTSTRAP_SEED = 1337


@dataclass(frozen=True)
class BootstrapDeltaResult:
    mean: float
    per_seed: Dict[int, float]
    samples: Tuple[float, ...]
    ci_lower: Optional[float]
    ci_upper: Optional[float]

    def as_dict(self) -> Dict[str, object]:
        return {
            "mean": float(self.mean),
            "per_seed": {int(k): float(v) for k, v in self.per_seed.items()},
            "ci_lower": None if self.ci_lower is None else float(self.ci_lower),
            "ci_upper": None if self.ci_upper is None else float(self.ci_upper),
            "n_samples": len(self.samples),
        }


class Bootstrapper:
    """Cluster bootstrap over per-seed frame-level values.

    ``metrics[condition][seed]`` is a sequence of per-frame values;
    ``clusters[condition][seed]`` (optional) assigns each frame a cluster id.
    """

    def __init__(
        self,
        metrics: Mapping[Hashable, Mapping[int, Sequence[float]]],
        *,
        clusters: Optional[Mapping[Hashable, Mapping[int, Sequence[Hashable]]]] = None,
        rng: Optional[np.random.Generator] = None,
        n_resamples: int = 2000,
    ) -> None:
        self._rng = rng or np.random.default_rng(DEFAULT_BOOTSTRAP_SEED)
        self.n_resamples = int(n_resamples)
        self._values: Dict[Hashable, Dict[int, np.ndarray]] = {}
        self._clusters: Dict[Hashable, Dict[int, np.ndarray]] = {}
        for condition, seed_map in metrics.items():
            self._values[condition] = {}
            self._clusters[condition] = {}
            for seed, values in seed_map.items():
                array = np.asarray(list(values), dtype=float)
                if array.size == 0:
                    raise ValueError(f"condition {condition!r} seed {seed} has no values")
                if not np.all(np.isfinite(array)):
                    raise ValueError(f"non-finite values for condition {condition!r} seed {seed}")
                self._values[condition][int(seed)] = array
                if clusters and condition in clusters and seed in clusters[condition]:
                    ids = np.asarray(list(clusters[condition][seed]), dtype=object)
                    if ids.size != array.size:
                        raise ValueError("cluster ids and values length mismatch")
                else:
                    ids = np.arange(array.size, dtype=object)
                self._clusters[condition][int(seed)] = ids

    # ------------------------------------------------------------------

    def _resample_indices(self, ids: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        unique = np.unique(ids)
        chosen = rng.choice(unique, size=unique.size, replace=True)
        pieces = [np.flatnonzero(ids == cluster) for cluster in chosen]
        return np.concatenate(pieces) if pieces else np.arange(0)

    def paired_delta(
        self,
        condition_a: Hashable,
        condition_b: Hashable,
        *,
        aggregate: Callable[[np.ndarray], float] = np.mean,
        ci: float = 0.95,
    ) -> BootstrapDeltaResult:
        """Bootstrap distribution of agg(B) − agg(A), paired per seed.

        Clusters are resampled once per draw and applied to BOTH conditions
        (paired design); each seed contributes an equally weighted delta.
        """
        seeds = sorted(set(self._values[condition_a]) & set(self._values[condition_b]))
        if not seeds:
            raise ValueError("conditions share no seeds")

        per_seed: Dict[int, float] = {}
        for seed in seeds:
            per_seed[seed] = float(
                aggregate(self._values[condition_b][seed])
                - aggregate(self._values[condition_a][seed])
            )

        samples: List[float] = []
        for _ in range(self.n_resamples):
            deltas = []
            for seed in seeds:
                ids_a = self._clusters[condition_a][seed]
                ids_b = self._clusters[condition_b][seed]
                idx_a = self._resample_indices(ids_a, self._rng)
                if np.array_equal(ids_a, ids_b):
                    idx_b = idx_a
                else:
                    idx_b = self._resample_indices(ids_b, self._rng)
                deltas.append(
                    aggregate(self._values[condition_b][seed][idx_b])
                    - aggregate(self._values[condition_a][seed][idx_a])
                )
            samples.append(float(np.mean(deltas)))

        samples_arr = np.asarray(samples)
        alpha = (1.0 - ci) / 2.0
        return BootstrapDeltaResult(
            mean=float(np.mean(list(per_seed.values()))),
            per_seed=per_seed,
            samples=tuple(samples),
            ci_lower=float(np.quantile(samples_arr, alpha)),
            ci_upper=float(np.quantile(samples_arr, 1.0 - alpha)),
        )

    def condition_ci(
        self,
        condition: Hashable,
        *,
        aggregate: Callable[[np.ndarray], float] = np.mean,
        ci: float = 0.95,
    ) -> Tuple[float, float, float]:
        """(mean, lo, hi) bootstrap CI for a single condition across seeds."""
        seeds = sorted(self._values[condition])
        point = float(np.mean([aggregate(self._values[condition][s]) for s in seeds]))
        samples = []
        for _ in range(self.n_resamples):
            vals = []
            for seed in seeds:
                idx = self._resample_indices(self._clusters[condition][seed], self._rng)
                vals.append(aggregate(self._values[condition][seed][idx]))
            samples.append(float(np.mean(vals)))
        alpha = (1.0 - ci) / 2.0
        arr = np.asarray(samples)
        return point, float(np.quantile(arr, alpha)), float(np.quantile(arr, 1.0 - alpha))
