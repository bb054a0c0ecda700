"""Learning-rate schedules: warmup + half-cycle cosine, plateau reduction.

The port's copy of ``ssl4polyp_tpu/training/schedules.py`` (that package's
``__init__`` reaches jax, so the port cannot import it):

* :func:`warmup_cosine` is the per-step schedule used for both MAE
  pretraining (reference ``mae/util/lr_sched.py:9-21``, applied per
  iteration) and cosine fine-tuning (reference uses timm's per-epoch cosine;
  here the same curve is sampled per step — smoother, identical envelope).
* :class:`PlateauScheduler` is the host-side replacement for
  ``ReduceLROnPlateau`` (reference broadcasts the plateau metric from rank 0
  — ``train_classification.py:6824-6837`` — which one process doesn't need).
* :class:`EarlyStopper` decides when a fine-tune stops and remembers the
  best epoch for checkpoint selection.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["warmup_cosine", "constant", "PlateauScheduler", "EarlyStopper"]


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


def constant(base_lr: float) -> Callable[[int], float]:
    return lambda step: base_lr


@dataclass
class PlateauScheduler:
    """Multiply LR by ``factor`` after ``patience`` epochs without improvement."""

    factor: float = 0.1
    patience: int = 10
    mode: str = "min"
    min_lr: float = 0.0
    threshold: float = 1e-4

    _scale: float = 1.0
    _best: Optional[float] = None
    _bad_epochs: int = 0

    def step(self, metric: float) -> float:
        improved = False
        if self._best is None:
            improved = True
        elif self.mode == "min":
            improved = metric < self._best - self.threshold
        else:
            improved = metric > self._best + self.threshold
        if improved:
            self._best = metric
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._scale *= self.factor
                self._bad_epochs = 0
        return self._scale

    def scale(self, base_lr: float) -> float:
        return max(self.min_lr, base_lr * self._scale)

    def state_dict(self) -> dict:
        return {"scale": self._scale, "best": self._best, "bad_epochs": self._bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self._scale = state.get("scale", 1.0)
        self._best = state.get("best")
        self._bad_epochs = state.get("bad_epochs", 0)


@dataclass
class EarlyStopper:
    """Early stopping on a monitored metric (reference ``config/base.yaml``:
    monitor val_loss, patience 8, min_delta 1e-4, min_epochs 3)."""

    patience: int = 8
    min_delta: float = 1e-4
    min_epochs: int = 3
    mode: str = "min"

    _best: Optional[float] = None
    _best_epoch: int = -1
    _bad_epochs: int = 0

    def update(self, epoch: int, metric: float) -> bool:
        """Record this epoch's metric; returns True when training should stop.

        ``patience <= 0`` disables early stopping entirely (matching the
        reference's ``_should_trigger_early_stop``, which treats a
        non-positive patience as "never stop") while still tracking the
        best metric/epoch for checkpoint selection.
        """
        improved = False
        if self._best is None:
            improved = True
        elif self.mode == "min":
            improved = metric < self._best - self.min_delta
        else:
            improved = metric > self._best + self.min_delta
        if improved:
            self._best = metric
            self._best_epoch = epoch
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
        if self.patience <= 0:
            return False
        if epoch + 1 < self.min_epochs:
            return False
        return self._bad_epochs >= self.patience

    @property
    def best(self) -> Optional[float]:
        return self._best

    @property
    def best_epoch(self) -> int:
        return self._best_epoch

    def state_dict(self) -> dict:
        return {
            "best": self._best,
            "best_epoch": self._best_epoch,
            "bad_epochs": self._bad_epochs,
        }

    def load_state_dict(self, state: dict) -> None:
        self._best = state.get("best")
        self._best_epoch = state.get("best_epoch", -1)
        self._bad_epochs = state.get("bad_epochs", 0)
