"""Determinism controls.

The port's copy of ``ssl4polyp_tpu/utils/determinism.py``.  The reference
needs a stack of flags to tame CUDA nondeterminism
(``train_classification.py:1615-1630``: cudnn.deterministic, CUBLAS
workspace config, torch.use_deterministic_algorithms).  The port seeds the
host-side RNGs that the data path uses and derives every device draw from
an explicit ``torch.Generator`` seeded from ``(seed, epoch, step)``.

The card needs nothing more for run-to-run bit equality of either
engine: ``chip_smoke.py::check_run_to_run_bits`` runs 3 full-width MAE steps
twice from one seed and one state, and ``phase_finetune_engine`` two
fine-tune runs of 12 steps, and every master, both moments and the compute
copy agree bit for bit with cuDNN, cuBLAS and torch's deterministic mode left
as they are.  The port's kernels use no float atomics, its matrix products
go to cuBLAS on one stream, the masking's ``torch.gather`` backward scatters
a permutation, one value a destination, and the augmentation's blur builds
its matrices as a segmented sum, each segment added in order
(``data/augment.py::_blur_matrices``).  So :func:`set_determinism` sets no
CUDA flag.
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_determinism", "step_seed", "worker_seed"]


def set_determinism(seed: int) -> "np.random.Generator":
    """Seed host RNGs; returns a numpy Generator for run-scoped use.

    Device-side randomness must come from generators seeded by the caller
    from the same seed (resume needs only ``(seed, epoch, step)``).
    """
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def worker_seed(seed: int, rank: int = 0, epoch: int = 0) -> int:
    """Per-process/per-epoch derived seed (reference offsets seed by rank —
    ``train_classification.py:6033`` — and by epoch for the sampler)."""
    return (seed + 1_000_003 * rank + 7_919 * epoch) % (2 ** 63)


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one train step's device draws (the pretrain step's
    masking noise, the fine-tune step's augmentation): a hash of the whole
    (seed, epoch, step), as the JAX engines fold the epoch and then the step
    into their keys, so that no two steps of a run share draws however long
    an epoch is, and a resumed run draws what an uninterrupted one draws.
    ``SeedSequence``'s first 64-bit word, reduced below 2**63 for
    ``torch.Generator.manual_seed``."""
    word = np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0]
    return int(word) % (2 ** 63)
