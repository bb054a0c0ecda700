"""Run layout: dataset segments, tags, stems, canonical parent checkpoints.

The port's copy of ``ssl4polyp_tpu/training/layout.py``.

Re-creates the reference's naming scheme
(``train_classification.py:3609-3941``) so artifacts from different
experiments interoperate (frozen-τ reuse, canonical SUN parents, reporters):

* output tree ``<output_dir>/<dataset segments>/<stem>.*``;
* stem = ``<ModelTag>_<DataTag>[_fromPARENT_sN]_s<seed>``;
* checkpoints named ``<stem>_e{epoch:02d}_{selection_tag}.ckpt`` with a
  ``<stem>.ckpt`` pointer;
* canonical SUN parents live under
  ``<classification_root>/exp{1,2}_<model>_seed{seed}/sun_baselines/``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Tuple

__all__ = [
    "DatasetLayout",
    "RunLayout",
    "resolve_dataset_layout",
    "resolve_run_layout",
    "compose_stem",
    "canonicalize_tag",
    "format_selection_tag",
    "recommend_fewshot_batch_size",
    "canonical_sun_parent_checkpoint",
    "extract_parent_metadata",
]


def canonicalize_tag(raw: str) -> str:
    """CamelCase-ish tag from arbitrary identifiers (e.g. sup_imnet → SupImnet)."""
    tokens = [t for t in re.split(r"[^0-9A-Za-z]+", str(raw)) if t]
    if not tokens:
        return "model"
    pieces = []
    for token in tokens:
        if token.isupper() or any(ch.isdigit() for ch in token):
            pieces.append(token)
        else:
            pieces.append(token.capitalize())
    return "".join(pieces)


def _as_int(value: Any) -> Optional[int]:
    try:
        return int(value) if value is not None else None
    except (TypeError, ValueError):
        return None


def _pattern_int(pattern: str, text: Optional[str]) -> Optional[int]:
    if not text:
        return None
    match = re.search(pattern, text)
    return int(match.group(1)) if match else None


@dataclass(frozen=True)
class DatasetLayout:
    name: str
    segments: Tuple[str, ...]
    data_tag: str
    dataset_seed: Optional[int] = None
    percent: Optional[int] = None
    size: Optional[int] = None
    default_parent_tag: Optional[str] = None
    default_parent_seed: Optional[int] = None


def resolve_dataset_layout(
    dataset_cfg: Mapping[str, Any],
    dataset_resolved: Optional[Mapping[str, Any]] = None,
    active_seed: Optional[int] = None,
) -> DatasetLayout:
    dataset_resolved = dataset_resolved or {}
    name = str(dataset_cfg.get("name") or "dataset").lower()
    percent = _as_int(dataset_cfg.get("percent")) or _as_int(dataset_resolved.get("percent"))
    dataset_seed = _as_int(dataset_cfg.get("seed"))
    if dataset_seed is None:
        dataset_seed = _as_int(dataset_resolved.get("seed"))
    size = _as_int(dataset_cfg.get("size")) or _as_int(dataset_resolved.get("size"))
    train_pack = dataset_resolved.get("train_pack")
    train_pack = str(train_pack) if train_pack else None

    if name == "sun_subsets":
        percent = percent if percent is not None else _pattern_int(r"p(\d+)", train_pack)
        if dataset_seed is None:
            dataset_seed = _pattern_int(r"seed(\d+)", train_pack)
    elif name == "polypgen_fewshot":
        size = size if size is not None else _pattern_int(r"_s(\d+)", train_pack)
        if dataset_seed is None:
            dataset_seed = _pattern_int(r"seed(\d+)", train_pack)

    default_parent_tag: Optional[str] = None
    default_parent_seed: Optional[int] = None

    if name == "sun_full":
        segments, data_tag = ("sun_baselines",), "SUNFull"
    elif name == "sun_morphology":
        segments, data_tag = ("sun_morphology",), "SUNMorph"
    elif name == "sun_subsets":
        segs = ["sun_subsets"]
        if percent is not None:
            segs.append(f"p{percent}")
            data_tag = f"SUNP{percent}"
        else:
            data_tag = "SUNSubset"
        if active_seed:
            segs.append(f"seed{int(active_seed)}")
        elif dataset_seed is not None:
            segs.append(f"seed{dataset_seed}")
        segments = tuple(segs)
    elif name == "polypgen_fewshot":
        segs = ["polypgen_fewshot"]
        if size is not None:
            segs.append(f"s{size}")
            data_tag = f"PolypGenFew{size}"
        else:
            data_tag = "PolypGenFewShot"
        if active_seed:
            segs.append(f"seed{int(active_seed)}")
        elif dataset_seed is not None:
            segs.append(f"seed{dataset_seed}")
        segments = tuple(segs)
        default_parent_tag = "SUN"
        default_parent_seed = dataset_seed
    elif name == "polypgen_clean_test":
        segments, data_tag = ("polypgen_clean_test",), "PolypGenClean"
    elif name == "sun_test_perturbations":
        segments, data_tag = ("sun_test_perturbations",), "SUNPerturb"
    else:
        sanitized = re.sub(r"[^0-9A-Za-z]+", "_", name).strip("_") or "dataset"
        segments, data_tag = (sanitized,), canonicalize_tag(name)

    return DatasetLayout(
        name=name,
        segments=segments,
        data_tag=data_tag,
        dataset_seed=dataset_seed,
        percent=percent,
        size=size,
        default_parent_tag=default_parent_tag,
        default_parent_seed=default_parent_seed,
    )


def recommend_fewshot_batch_size(layout: DatasetLayout) -> Optional[int]:
    """Per-rank batch tuned to the few-shot budget
    (reference ``train_classification.py:3704-3723``)."""
    if layout.name != "polypgen_fewshot" or layout.size is None:
        return None
    size = layout.size
    if size <= 50:
        return 4
    if size <= 100:
        return 8
    if size <= 200:
        return 16
    return 32


def compose_stem(model_tag: str, data_tag: str, qualifiers: Iterable[str], seed: int) -> str:
    parts = [q for q in qualifiers if q]
    qualifier_segment = f"_{'_'.join(parts)}" if parts else ""
    return f"{model_tag}_{data_tag}{qualifier_segment}_s{int(seed)}"


def extract_parent_metadata(reference: str) -> Tuple[Optional[str], Optional[int]]:
    """Parse (data_tag, seed) from a canonical parent checkpoint stem.

    Stems follow ``<ModelTag>_<DataTag>[_qualifiers]_s<seed>`` (see
    :func:`compose_stem`); the data tag is the second ``_`` token.
    """
    stem = Path(reference).stem
    seed_match = re.search(r"_s(\d+)$", stem)
    seed = int(seed_match.group(1)) if seed_match else None
    body = stem[: seed_match.start()] if seed_match else stem
    tokens = body.split("_")
    if len(tokens) >= 2 and tokens[1]:
        return tokens[1], seed
    return None, seed


def _compose_lineage(tag: Optional[str], seed: Optional[int]) -> Optional[str]:
    if not tag:
        return None
    canonical = canonicalize_tag(tag)
    if canonical.lower() == "sunfull":
        canonical = "SUN"
    qualifier = f"from{canonical}"
    if seed is not None:
        qualifier += f"_s{int(seed)}"
    return qualifier


CANONICAL_SUN_PARENT_EXPERIMENTS: Mapping[str, str] = {
    "sup_imnet": "exp1_sup_imnet_seed{seed}",
    "ssl_imnet": "exp1_ssl_imnet_seed{seed}",
    "ssl_colon": "exp2_ssl_colon_seed{seed}",
}


def infer_classification_root(output_dir: Optional[str]) -> Path:
    if not output_dir:
        return Path("checkpoints") / "classification"
    candidate = Path(str(output_dir)).expanduser()
    for current in (candidate, *candidate.parents):
        if current.name == "classification":
            return current
    return Path("checkpoints") / "classification"


def canonical_sun_parent_checkpoint(
    model_key: str,
    model_tag: str,
    seed: int,
    output_dir: Optional[str] = None,
    suffix: str = ".ckpt",
) -> Path:
    template = CANONICAL_SUN_PARENT_EXPERIMENTS[str(model_key).lower()]
    experiment_dir = template.format(seed=int(seed))
    stem = compose_stem(model_tag, "SUNFull", (), int(seed))
    root = infer_classification_root(output_dir)
    return root / experiment_dir / "sun_baselines" / f"{stem}{suffix}"


def format_selection_tag(monitor: Optional[str]) -> str:
    """Checkpoint tag for the monitored metric (val_loss → valLoss etc.)."""
    if not monitor:
        return "best"
    tokens = [t for t in re.split(r"[^0-9A-Za-z]+", monitor) if t]
    if not tokens:
        return "best"
    formatted = []
    for i, token in enumerate(tokens):
        lower = token.lower()
        if lower == "auroc":
            formatted.append("AUROC")
        elif lower == "auc":
            formatted.append("AUC")
        elif lower == "auprc":
            formatted.append("AUPRC")
        elif lower == "loss":
            formatted.append("loss" if i == 0 else "Loss")
        elif i == 0:
            formatted.append(token.lower())
        else:
            formatted.append(token.capitalize())
    return "".join(formatted)


@dataclass(frozen=True)
class RunLayout:
    base_dir: Path
    output_dir: Path
    stem: str
    checkpoint_path: Path
    log_path: Path
    metrics_path: Path
    tb_dir: Path
    dataset_layout: DatasetLayout
    model_tag: str


def resolve_run_layout(
    *,
    output_dir: str | Path,
    model_tag: str,
    dataset_cfg: Mapping[str, Any],
    dataset_resolved: Optional[Mapping[str, Any]] = None,
    seed: int = 0,
    parent_checkpoint: Optional[str] = None,
    init_from: Optional[str] = None,
) -> RunLayout:
    dataset_layout = resolve_dataset_layout(dataset_cfg, dataset_resolved, active_seed=seed)
    base_dir = Path(output_dir).expanduser()
    run_dir = base_dir.joinpath(*dataset_layout.segments)

    qualifiers = []
    if parent_checkpoint:
        parent_tag, parent_seed = extract_parent_metadata(parent_checkpoint)
        qualifier = _compose_lineage(parent_tag, parent_seed)
        if qualifier:
            qualifiers.append(qualifier)
    elif init_from and dataset_layout.default_parent_tag:
        qualifier = _compose_lineage(
            dataset_layout.default_parent_tag, dataset_layout.default_parent_seed
        )
        if qualifier:
            qualifiers.append(qualifier)

    stem = compose_stem(model_tag, dataset_layout.data_tag, qualifiers, seed)
    return RunLayout(
        base_dir=base_dir,
        output_dir=run_dir,
        stem=stem,
        checkpoint_path=run_dir / f"{stem}.ckpt",
        log_path=run_dir / f"{stem}.log",
        metrics_path=run_dir / f"{stem}.metrics.json",
        tb_dir=run_dir / "tb" / stem,
        dataset_layout=dataset_layout,
        model_tag=model_tag,
    )
