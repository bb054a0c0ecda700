"""Canonical filesystem layout for persisted threshold artifacts.

The port's copy of ``ssl4polyp_tpu/metrics/threshold_store.py``.

Same path contract as the reference store
(``src/ssl4polyp/classification/threshold_store.py``)::

    <root>/<val_pack>/<model>/arch-<a>/pretrain-<p>/trainpack-<t>/
        subset-<s>/seed-<n>/policy-<policy>.json

so thresholds written by one experiment (e.g. exp1 on SUN) are discoverable
by later ones (exp5a/b/c frozen-τ reuse) purely from run facts.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Optional

__all__ = [
    "sanitize_segment",
    "canonical_threshold_directory",
    "canonical_threshold_filename",
    "canonical_threshold_path",
]


def sanitize_segment(raw: Any, *, default: str = "default") -> str:
    if raw is None:
        return default
    text = str(raw).strip().strip("/ ")
    if "/" in text:
        text = text.rsplit("/", 1)[-1]
    cleaned = re.sub(r"[^0-9A-Za-z._-]+", "_", text).strip("._-")
    return cleaned.lower() if cleaned else default


def canonical_threshold_directory(
    root: str | Path,
    *,
    val_pack: Optional[str],
    model_tag: Optional[str],
    arch: Optional[str],
    pretraining: Optional[str],
    train_pack: Optional[str] = None,
    subset: Optional[str] = None,
    seed: Optional[int] = None,
) -> Path:
    try:
        seed_value = int(seed) if seed is not None else 0
    except (TypeError, ValueError):
        seed_value = 0
    return Path(root).expanduser().joinpath(
        sanitize_segment(val_pack, default="dataset"),
        sanitize_segment(model_tag, default="model"),
        f"arch-{sanitize_segment(arch, default='unknown')}",
        f"pretrain-{sanitize_segment(pretraining, default='unknown')}",
        f"trainpack-{sanitize_segment(train_pack, default='full')}",
        f"subset-{sanitize_segment(subset, default='full')}",
        f"seed-{seed_value}",
    )


def canonical_threshold_filename(policy: Optional[str]) -> str:
    return f"policy-{sanitize_segment(policy, default='policy')}.json"


def canonical_threshold_path(
    root: str | Path,
    *,
    val_pack: Optional[str],
    model_tag: Optional[str],
    arch: Optional[str],
    pretraining: Optional[str],
    train_pack: Optional[str] = None,
    subset: Optional[str] = None,
    seed: Optional[int] = None,
    policy: Optional[str] = None,
) -> Path:
    directory = canonical_threshold_directory(
        root,
        val_pack=val_pack,
        model_tag=model_tag,
        arch=arch,
        pretraining=pretraining,
        train_pack=train_pack,
        subset=subset,
        seed=seed,
    )
    return directory / canonical_threshold_filename(policy)
