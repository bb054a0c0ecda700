"""Learning-rate schedules.

A copy of ``warmup_cosine`` from ``ssl4polyp_tpu/training/schedules.py``
(reference ``mae/util/lr_sched.py:9-21``, applied per iteration): that
package's ``__init__`` reaches jax, so the port cannot import it.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["warmup_cosine"]


def warmup_cosine(
    base_lr: float,
    total_steps: int,
    warmup_steps: int,
    min_lr: float = 0.0,
) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` then half-cycle cosine decay to ``min_lr``."""

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        span = max(1, total_steps - warmup_steps)
        progress = min(1.0, (step - warmup_steps) / span)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
