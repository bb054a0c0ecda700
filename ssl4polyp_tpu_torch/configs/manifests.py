"""Data-pack manifest loading with integrity verification.

The port's copy of ``ssl4polyp_tpu/configs/manifests.py``.  A *data pack* is
a directory holding a ``manifest.yaml`` plus one CSV file per split.  This
module re-creates the reference's contract
(``src/ssl4polyp/configs/manifests.py``):

* split CSVs must contain at least ``frame_path`` and ``label`` columns;
* the manifest may pin SHA256 hashes per split CSV which are verified;
* the manifest may declare expected frame counts and per-label counts which
  are asserted after parsing;
* ``frame_path`` values are resolved through a *roots map* (first path
  component, or the row's ``store_id``/``dataset`` column, names a root);
* a sampled existence check guards against stale manifests;
* the legacy ``eval`` split name is rejected (renamed to ``test``);
* an optional provenance snapshot copies the CSVs/manifest and records
  roots, git commit, installed packages and accelerator topology.

The implementation is accelerator-free: ``yaml`` is imported where a
manifest is opened, and the provenance snapshot asks torch for the device
topology only when it is written.
"""

from __future__ import annotations

import csv
import hashlib
import json
import random
import shutil
import subprocess
import sys
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

from . import data_packs_root, resolve_config_path, resolve_data_pack_path

__all__ = [
    "REQUIRED_COLUMNS",
    "Split",
    "PackManifest",
    "load_split",
    "verify_hash",
    "resolve_paths",
    "load_pack",
    "resolve_manifest_path",
    "resolve_pack_asset",
    "snapshot_provenance",
]

Row = Dict[str, str]

REQUIRED_COLUMNS = ("frame_path", "label")
_SPLIT_NAMES = ("train", "val", "test")

# Keys inside manifest count blocks that describe aggregates rather than labels.
_AGGREGATE_TOKENS = ("frame", "case", "seq", "total")

_LABEL_SYNONYMS = {
    "pos": "1",
    "positive": "1",
    "neg": "0",
    "negative": "0",
}


class Split(NamedTuple):
    """One loaded split: resolved paths, raw label strings, full CSV rows.

    NamedTuple so that callers may destructure it like the reference's
    ``(paths, labels, meta)`` triple.
    """

    paths: List[Path]
    labels: List[str]
    rows: List[Row]


def resolve_manifest_path(manifest: Optional[str | Path]) -> Optional[Path]:
    if manifest is None:
        return None
    return resolve_config_path(manifest)


def resolve_pack_asset(path: Optional[str | Path]) -> Optional[Path]:
    if path is None:
        return None
    return resolve_data_pack_path(path)


def canonical_label(label: object) -> str:
    """Map label spellings (pos/neg/1/0/1.0) to a canonical comparison key."""
    text = str(label).strip()
    lowered = text.lower()
    if lowered in _LABEL_SYNONYMS:
        return _LABEL_SYNONYMS[lowered]
    try:
        number = float(text)
    except ValueError:
        return text
    if number.is_integer():
        return str(int(number))
    return text


def _as_int(value: object) -> Optional[int]:
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return int(value) if value.is_integer() else None
    if isinstance(value, str):
        try:
            number = float(value)
        except ValueError:
            return None
        return int(number) if number.is_integer() else None
    return None


@dataclass
class PackManifest:
    """Parsed view of a pack ``manifest.yaml``."""

    path: Optional[Path] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, manifest_yaml: Optional[Path]) -> "PackManifest":
        if manifest_yaml is None:
            return cls()
        import yaml

        manifest_yaml = Path(manifest_yaml)
        with open(manifest_yaml, "r", encoding="utf-8") as handle:
            raw = yaml.safe_load(handle) or {}
        if not isinstance(raw, Mapping):
            raw = {}
        if "eval" in raw:
            raise ValueError(
                "Manifest declares an 'eval' split, which is unsupported; "
                "rename it to 'test'."
            )
        return cls(path=manifest_yaml, raw=dict(raw))

    # -- split CSV discovery -------------------------------------------------

    def split_csv(self, name: str) -> Optional[Path]:
        entry = self.raw.get(name)
        if entry is None:
            return None
        if isinstance(entry, Mapping):
            entry = entry.get("csv")
        if entry is None:
            return None
        csv_path = Path(str(entry))
        if not csv_path.is_absolute() and self.path is not None:
            csv_path = self.path.parent / csv_path
        return csv_path

    # -- row schema ----------------------------------------------------------

    def schema_columns(self) -> Optional[List[str]]:
        """Extra required columns declared under ``row_schema.fields``."""
        schema = self.raw.get("row_schema")
        if not isinstance(schema, Mapping):
            return None
        fields = schema.get("fields")
        if not isinstance(fields, Sequence):
            return None
        names: List[str] = []
        for entry in fields:
            if isinstance(entry, Mapping):
                name = entry.get("name")
            else:
                name = entry
            if isinstance(name, str):
                names.append(name)
        extra = [n for n in names if n not in REQUIRED_COLUMNS]
        return extra or None

    def split_column(self) -> Optional[str]:
        override = self.raw.get("split_column")
        if isinstance(override, str):
            return override
        schema = self.raw.get("row_schema")
        if isinstance(schema, Mapping):
            fields = schema.get("fields")
            if isinstance(fields, Sequence):
                names = []
                for entry in fields:
                    if isinstance(entry, Mapping):
                        if str(entry.get("role", "")).lower() == "split":
                            name = entry.get("name")
                            if isinstance(name, str):
                                return name
                        name = entry.get("name")
                    else:
                        name = entry
                    if isinstance(name, str):
                        names.append(name)
                if "split" in names:
                    return "split"
        return None

    # -- expectations ----------------------------------------------------------

    def roots(self) -> Optional[Mapping[str, str]]:
        roots = self.raw.get("roots")
        return roots if isinstance(roots, Mapping) else None

    def expected_counts(self, split: str) -> tuple[Optional[int], Dict[str, int]]:
        """Expected (frames, {label: count}) for ``split`` from the ``counts`` block."""
        counts = self.raw.get("counts")
        if not isinstance(counts, Mapping):
            return None, {}
        entry = counts.get(split)
        if not isinstance(entry, Mapping):
            return None, {}
        frames = _as_int(entry.get("frames"))
        labels: Dict[str, int] = {}
        declared = entry.get("label_counts")
        if isinstance(declared, Mapping):
            for key, value in declared.items():
                coerced = _as_int(value)
                if coerced is not None:
                    labels[canonical_label(key)] = coerced
        for key, value in entry.items():
            if key in ("frames", "label_counts"):
                continue
            if isinstance(key, str):
                lowered = key.lower()
                if key.endswith("_cases") or any(t in lowered for t in _AGGREGATE_TOKENS):
                    continue
            coerced = _as_int(value)
            if coerced is not None:
                labels[canonical_label(key)] = coerced
        return frames, labels

    def expected_hash(self, split: str, csv_path: Path) -> Optional[str]:
        """Look up a pinned SHA256 for ``split``/``csv_path`` across layouts.

        Supported layouts (reference ``manifests.py:204-299``):
        ``{split: {csv: ..., sha256: ...}}``, ``{hashes: {name: sha}}``,
        and a flat ``{name: sha}`` mapping keyed by file name or stem.
        """
        keys = [split, csv_path.name, csv_path.stem]

        def sha_of(entry: object) -> Optional[str]:
            if isinstance(entry, str):
                return entry
            if isinstance(entry, Mapping):
                declared_csv = entry.get("csv")
                if declared_csv is not None:
                    declared = Path(str(declared_csv))
                    if declared.name not in keys and declared.stem not in keys:
                        return None
                sha = entry.get("sha256")
                return sha if isinstance(sha, str) else None
            return None

        entry = self.raw.get(split)
        sha = sha_of(entry)
        if sha:
            return sha
        for value in self.raw.values():
            if isinstance(value, Mapping) and "csv" in value:
                sha = sha_of(value)
                if sha:
                    return sha
        hashes = self.raw.get("hashes")
        if isinstance(hashes, Mapping):
            for key in keys:
                sha = sha_of(hashes.get(key))
                if sha:
                    return sha
        for key in keys:
            value = self.raw.get(key)
            if isinstance(value, str) and len(value) == 64:
                return value
        return None


def load_split(
    csv_path: Path,
    required_columns: Optional[Sequence[str]] = None,
    split_column: Optional[str] = None,
    expected_split_value: Optional[str] = None,
) -> List[Row]:
    """Parse a split CSV, asserting required columns and split-column values."""
    csv_path = Path(csv_path)
    with open(csv_path, newline="", encoding="utf-8") as handle:
        reader = csv.DictReader(handle)
        header = set(reader.fieldnames or [])
        needed = set(REQUIRED_COLUMNS)
        if required_columns:
            needed.update(required_columns)
        missing = sorted(needed - header)
        if missing:
            raise ValueError(f"Missing required columns {missing} in {csv_path}")
        rows = [dict(row) for row in reader]
    if split_column and expected_split_value is not None:
        for index, row in enumerate(rows, start=1):
            actual = row.get(split_column)
            if actual != expected_split_value:
                raise ValueError(
                    f"Split mismatch in {csv_path} row {index}: column "
                    f"{split_column!r} is {actual!r}, expected {expected_split_value!r}"
                )
    return rows


def verify_hash(
    csv_path: Path,
    manifest_yaml: Optional[Path],
    *,
    split_name: Optional[str] = None,
) -> None:
    """Check ``csv_path`` against a SHA256 pinned in the manifest (if any)."""
    if manifest_yaml is None:
        return
    manifest = PackManifest.load(Path(manifest_yaml))
    expected = manifest.expected_hash(split_name or Path(csv_path).stem, Path(csv_path))
    if not expected:
        return
    actual = hashlib.sha256(Path(csv_path).read_bytes()).hexdigest()
    if actual.lower() != expected.lower():
        raise ValueError(
            f"SHA256 mismatch for {csv_path}: manifest pins {expected}, file is {actual}"
        )


def resolve_paths(
    rows: Sequence[Mapping[str, str]],
    roots_map: Optional[Mapping[str, str]] = None,
    sample: int = 10,
    check_exists: bool = True,
) -> List[Path]:
    """Resolve each row's ``frame_path`` through ``roots_map``.

    The first path component is looked up in the roots map; if absent, the
    row's ``store_id`` then ``dataset`` columns are tried as root keys with
    the full relative path appended.  A random sample of ``sample`` resolved
    paths is checked for existence.
    """
    paths: List[Path] = []
    for row in rows:
        raw = row.get("frame_path")
        if raw is None:
            raise ValueError("Row is missing its 'frame_path' value")
        path = Path(raw)
        if roots_map and path.parts:
            head = path.parts[0]
            if head in roots_map:
                path = Path(roots_map[head]).joinpath(*path.parts[1:])
            else:
                for column in ("store_id", "dataset"):
                    key = row.get(column)
                    if key and key in roots_map:
                        path = Path(roots_map[key]) / path
                        break
        paths.append(path)

    if check_exists and paths:
        for probe in random.sample(paths, min(sample, len(paths))):
            if not probe.exists():
                raise FileNotFoundError(f"Manifest references a missing file: {probe}")
    return paths


def snapshot_provenance(
    snapshot_dir: Path,
    csv_paths: Sequence[Path],
    manifest_yaml: Optional[Path],
    roots_map: Optional[Mapping[str, str]],
    *,
    primary: bool = True,
) -> None:
    """Record a reproducibility snapshot next to run outputs.

    Copies every consumed CSV plus the manifest into
    ``snapshot_dir/manifest_snapshot`` and writes ``roots.json``,
    ``git-commit.txt``, ``pip-freeze.txt`` and ``accelerator.json`` (the
    torch backend and its CUDA devices).  Primary process only.
    """
    if not primary:
        return
    snapshot_dir = Path(snapshot_dir)
    mirror = snapshot_dir / "manifest_snapshot"
    mirror.mkdir(parents=True, exist_ok=True)
    for path in csv_paths:
        shutil.copy2(path, mirror / Path(path).name)
    if manifest_yaml is not None:
        shutil.copy2(manifest_yaml, mirror / Path(manifest_yaml).name)
    if roots_map is not None:
        (snapshot_dir / "roots.json").write_text(
            json.dumps(dict(roots_map), indent=2), encoding="utf-8"
        )
    try:
        commit = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], text=True, stderr=subprocess.DEVNULL
        ).strip()
    except Exception:
        commit = "unknown"
    (snapshot_dir / "git-commit.txt").write_text(commit + "\n", encoding="utf-8")
    try:
        freeze = subprocess.check_output(
            [sys.executable, "-m", "pip", "freeze"], text=True, stderr=subprocess.DEVNULL
        )
    except Exception:
        freeze = ""
    (snapshot_dir / "pip-freeze.txt").write_text(freeze, encoding="utf-8")

    accel: Dict[str, Any] = {"backend": None, "device_count": 0, "devices": []}
    try:  # Optional: the config layer must not require an accelerator.
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        accel = {
            "backend": "cuda" if count else "cpu",
            "device_count": count,
            "devices": [torch.cuda.get_device_name(i) for i in range(count)],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    except Exception as exc:  # pragma: no cover - depends on runtime
        accel["error"] = str(exc)
    (snapshot_dir / "accelerator.json").write_text(
        json.dumps(accel, indent=2), encoding="utf-8"
    )


def load_pack(
    train: Optional[Path] = None,
    val: Optional[Path] = None,
    test: Optional[Path] = None,
    manifest_yaml: Optional[Path] = None,
    roots_map: Optional[Mapping[str, str]] = None,
    pack_root: Optional[Path] = None,
    snapshot_dir: Optional[Path] = None,
    check_exists: bool = True,
) -> Dict[str, Split]:
    """Load the splits of a data pack, verifying integrity along the way.

    Returns ``{split_name: Split(paths, labels, rows)}``.  Split CSVs not
    given explicitly are discovered through the manifest; relative CSV paths
    resolve against the manifest directory, then ``pack_root``, then the
    current directory (reference ``manifests.py:350-539``).
    """
    manifest = PackManifest.load(Path(manifest_yaml) if manifest_yaml else None)
    pack_root = pack_root or data_packs_root()

    requested: Dict[str, Optional[Path]] = {"train": train, "val": val, "test": test}
    for name in _SPLIT_NAMES:
        if requested[name] is None:
            requested[name] = manifest.split_csv(name)
    if roots_map is None:
        roots_map = manifest.roots()

    schema_columns = manifest.schema_columns()
    split_column = manifest.split_column()

    def locate(path: Path) -> Path:
        if path.is_absolute():
            return path
        candidates = []
        if manifest.path is not None:
            candidates.append(manifest.path.parent / path)
        candidates.append(pack_root / path)
        candidates.append(Path.cwd() / path)
        for candidate in candidates:
            if candidate.exists():
                return candidate
        return candidates[0]

    result: Dict[str, Split] = {}
    consumed: List[Path] = []
    for name, declared in requested.items():
        if declared is None:
            continue
        csv_path = locate(Path(declared))
        verify_hash(csv_path, manifest.path, split_name=name)
        expected_value = name if (split_column and name in _SPLIT_NAMES) else None
        rows = load_split(
            csv_path,
            required_columns=schema_columns,
            split_column=split_column,
            expected_split_value=expected_value,
        )
        expected_frames, expected_labels = manifest.expected_counts(name)
        if expected_frames is not None and len(rows) != expected_frames:
            raise ValueError(
                f"Split {name!r}: expected {expected_frames} rows, "
                f"found {len(rows)} in {csv_path}"
            )
        if expected_labels:
            tally = Counter(canonical_label(row.get("label", "")) for row in rows)
            for label, expected_count in expected_labels.items():
                if tally.get(label, 0) != expected_count:
                    raise ValueError(
                        f"Split {name!r}: label {label!r} expected "
                        f"{expected_count} rows, found {tally.get(label, 0)} in {csv_path}"
                    )
        paths = resolve_paths(rows, roots_map, check_exists=check_exists)
        labels = [row.get("label", "") for row in rows]
        result[name] = Split(paths=paths, labels=labels, rows=rows)
        consumed.append(csv_path)

    if snapshot_dir is not None:
        snapshot_provenance(Path(snapshot_dir), consumed, manifest.path, roots_map)
    return result
