"""Pack indices and dataset assembly for classification experiments.

The port's copy of ``ssl4polyp_tpu/data/packs.py``: capability parity with
the reference dataloader assembly
(``src/ssl4polyp/classification/data/packs.py:109-396``) on numpy alone:

* a pack *spec* may be a directory (containing ``manifest.yaml`` and
  ``<split>.csv``), a manifest YAML file, or a single CSV;
* per-split :class:`PackIndex` objects carry resolved paths, integer labels,
  full metadata rows and provenance (CSV SHA256, spec, manifest path);
* perturbation rendering is enabled per split (``perturbation_splits``);
* the provenance snapshot is written once per run.

Batching/sharding concerns live in :mod:`.loader` (the host data loader),
not here.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..configs import data_packs_root
from ..configs.manifests import load_pack
from .transforms import DEFAULT_HMAC_KEY

logger = logging.getLogger(__name__)

__all__ = ["PackIndex", "resolve_pack_spec", "create_classification_datasets"]


@dataclass
class PackIndex:
    """Immutable index over one split of a data pack."""

    paths: List[str]
    labels: Optional[np.ndarray]  # int32, or None for unlabeled packs
    meta: List[Dict[str, Any]]
    split: str
    stage: str  # train | val | test (controls augmentation downstream)
    image_size: int = 224
    perturbations_enabled: bool = False
    hmac_key: bytes = DEFAULT_HMAC_KEY
    provenance: Dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def labels_list(self) -> Optional[List[int]]:
        return None if self.labels is None else [int(v) for v in self.labels]

    def class_counts(self, num_classes: int) -> np.ndarray:
        counts = np.zeros(num_classes, dtype=np.int64)
        if self.labels is not None:
            for value in self.labels:
                counts[int(value)] += 1
        return counts


def _prepare_labels(raw: Sequence[object]) -> np.ndarray:
    values = []
    for label in raw:
        if label in (None, ""):
            raise ValueError("Encountered an empty label while indexing a pack")
        values.append(int(float(str(label))))
    return np.asarray(values, dtype=np.int32)


def _normalise_stage(split: str) -> str:
    lowered = split.lower()
    if lowered in {"train", "training"}:
        return "train"
    if lowered in {"val", "valid", "validation"}:
        return "val"
    return "test"


def resolve_pack_spec(
    spec: str | Path,
    splits: Iterable[str],
    pack_root: Optional[Path] = None,
) -> Tuple[Optional[Path], Dict[str, Path]]:
    """Resolve a pack spec to (manifest_path | None, {split: csv_path})."""
    splits = list(splits)
    candidate = Path(spec)
    base: Optional[Path] = None
    if candidate.is_absolute() and candidate.exists():
        base = candidate
    else:
        roots = []
        if pack_root is not None:
            roots.append(Path(pack_root))
        roots.append(data_packs_root())
        for root in roots:
            probe = root / candidate
            if probe.exists():
                base = probe
                break
        if base is None and candidate.exists():
            base = candidate
    if base is None:
        raise FileNotFoundError(f"Could not resolve data pack spec {spec!r}")

    csv_map: Dict[str, Path] = {}
    if base.is_file():
        suffix = base.suffix.lower()
        if suffix in {".yaml", ".yml"}:
            manifest = base
            for split in splits:
                probe = base.parent / f"{split}.csv"
                if not probe.exists():
                    raise FileNotFoundError(f"Missing {split}.csv next to {base}")
                csv_map[split] = probe
            return manifest, csv_map
        if suffix == ".csv":
            if len(splits) != 1:
                raise ValueError("A bare CSV spec supports exactly one split")
            return None, {splits[0]: base}
        raise ValueError(f"Unsupported pack spec {spec!r}")

    manifest = base / "manifest.yaml"
    if not manifest.exists():
        manifest = None
    for split in splits:
        probe = base / f"{split}.csv"
        if not probe.exists():
            raise FileNotFoundError(f"Missing {split}.csv under {base}")
        csv_map[split] = probe
    return manifest, csv_map


def _sha256_file(path: Path) -> str:
    hasher = hashlib.sha256()
    with open(path, "rb") as handle:
        for chunk in iter(lambda: handle.read(1 << 20), b""):
            hasher.update(chunk)
    return hasher.hexdigest()


def create_classification_datasets(
    *,
    train_spec: Optional[str | Path] = None,
    val_spec: Optional[str | Path] = None,
    test_spec: Optional[str | Path] = None,
    train_split: str = "train",
    val_split: str = "val",
    test_split: str = "test",
    pack_root: Optional[Path] = None,
    roots_map: Optional[Mapping[str, str]] = None,
    image_size: int = 224,
    perturbation_splits: Optional[Sequence[str]] = None,
    hmac_key: bytes = DEFAULT_HMAC_KEY,
    snapshot_dir: Optional[Path] = None,
    check_exists: bool = True,
) -> Dict[str, PackIndex]:
    """Build {alias: PackIndex} for the requested splits.

    Aliases are "train"/"val"/"test"; ``*_split`` lets a pack use custom
    split names (e.g. fewshot packs reusing a reference test pack).
    """
    wanted: List[Tuple[str, str, str | Path]] = []
    if train_spec is not None:
        wanted.append(("train", train_split, train_spec))
    if val_spec is not None:
        wanted.append(("val", val_split, val_spec))
    if test_spec is not None:
        wanted.append(("test", test_split, test_spec))

    perturbation_set = {s.lower() for s in (perturbation_splits or [])}

    # Group by spec so shared packs load (and snapshot) once.
    grouped: Dict[str, List[Tuple[str, str]]] = {}
    spec_of: Dict[str, str | Path] = {}
    for alias, split_name, spec in wanted:
        key = str(spec)
        grouped.setdefault(key, []).append((alias, split_name))
        spec_of[key] = spec

    datasets: Dict[str, PackIndex] = {}
    snapshot_pending = snapshot_dir
    for spec_key, members in grouped.items():
        split_names = [name for _, name in members]
        manifest, csv_map = resolve_pack_spec(spec_of[spec_key], split_names, pack_root)
        load_kwargs: Dict[str, Path] = {}
        for name in split_names:
            if name not in {"train", "val", "test"}:
                raise ValueError(
                    f"Split name {name!r} is not canonical; packs must use train/val/test"
                )
            load_kwargs[name] = csv_map[name]
        pack = load_pack(
            manifest_yaml=manifest,
            roots_map=roots_map,
            pack_root=pack_root or data_packs_root(),
            snapshot_dir=snapshot_pending,
            check_exists=check_exists,
            **load_kwargs,
        )
        snapshot_pending = None
        for alias, split_name in members:
            if split_name not in pack:
                raise KeyError(f"Pack {spec_key!r} did not provide split {split_name!r}")
            paths, labels, rows = pack[split_name]
            csv_path = csv_map[split_name]
            provenance = {
                "split": split_name,
                "csv_path": str(csv_path),
                "csv_sha256": _sha256_file(csv_path),
                "pack_spec": spec_key,
            }
            if manifest is not None:
                provenance["manifest_path"] = str(manifest)
            stage = _normalise_stage(alias)
            # Unlabeled only when EVERY label cell is empty; a mix means a
            # corrupt CSV and fails loudly in _prepare_labels (sniffing on
            # labels[0] alone would silently zero a labeled split whose
            # first row happened to lack a label).
            any_labeled = bool(labels) and any(
                value not in (None, "") for value in labels
            )
            datasets[alias] = PackIndex(
                paths=[str(p) for p in paths],
                labels=_prepare_labels(labels) if any_labeled else None,
                meta=[dict(r) for r in rows],
                split=split_name,
                stage=stage,
                image_size=image_size,
                perturbations_enabled=split_name.lower() in perturbation_set,
                hmac_key=hmac_key,
                provenance=provenance,
            )
    return datasets
