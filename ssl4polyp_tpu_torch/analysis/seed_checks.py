"""Expected-seed enforcement (reference ``analysis/seed_checks.py``).

The port's copy of ``ssl4polyp_tpu/analysis/seed_checks.py``.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Set

__all__ = ["EXPECTED_SEEDS", "SeedCheckError", "ensure_expected_seeds"]

EXPECTED_SEEDS: tuple[int, ...] = (13, 29, 47)


class SeedCheckError(RuntimeError):
    """Raised when a condition is missing seeds or has unexpected extras."""


def ensure_expected_seeds(
    runs_by_condition: Mapping[str, Mapping[int, object]],
    expected: Sequence[int] = EXPECTED_SEEDS,
    *,
    allow_extra: bool = False,
) -> None:
    expected_set: Set[int] = {int(s) for s in expected}
    problems = []
    for condition, seed_map in sorted(runs_by_condition.items()):
        seen = {int(s) for s in seed_map}
        missing = sorted(expected_set - seen)
        extra = sorted(seen - expected_set)
        if missing:
            problems.append(f"{condition}: missing seeds {missing}")
        if extra and not allow_extra:
            problems.append(f"{condition}: unexpected seeds {extra}")
    if problems:
        raise SeedCheckError(
            "Seed composition violates the protocol (expected "
            f"{sorted(expected_set)}): " + "; ".join(problems)
        )
