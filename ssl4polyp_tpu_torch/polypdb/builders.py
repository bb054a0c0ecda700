"""Data-pack builders: schema-exact regeneration of the reference pack assets.

The port's copy of ``ssl4polyp_tpu/polypdb/builders.py``: from the same
dataset root, seed and clock, both packages write the same bytes (CSVs and
manifests, whose ``generator.repo`` and ``command`` are the JAX package's).
PyYAML and PIL are imported where a manifest is written or read and where
an image header is read.

The reference ships seven pack families as CSV+manifest assets generated by an
external ``polyp-db-analysis`` tool (see the ``generator:`` blocks in the
reference's ``data_packs/*/manifest.yaml``).  The assets themselves embed
licensed imagery paths, so we cannot ship them; instead this module rebuilds
each family from a dataset root with the *same row schema* (the 28-column
header of ``data_packs/sun_full/train.csv:1``), the same sampling policies,
and the same manifest contract (hashes, counts, assertions, per-split case
lists), so a user who mounts the real SUN / PolypGen datasets regenerates
byte-compatible packs locally and every ``run_exp*.sh`` sweep becomes
runnable with hash verification on.

Pack families (reference manifest the policy is transcribed from):

* ``sun build``               — data_packs/sun_full/manifest.yaml
* ``sun morph``               — data_packs/sun_morphology/manifest.yaml
* ``sun subsets-canonical``   — data_packs/sun_subsets/sun_p05/manifest.yaml
* ``sun perturbations``       — data_packs/sun_test_perturbations/manifest.yaml
* ``polypgen build``          — data_packs/polypgen_clean_test{,_extended}/manifest.yaml
* ``polypgen fewshot``        — data_packs/polypgen_fewshot/*/manifest.yaml

Selection primitives follow the manifests' declared rules:
``hmac_sha256(case_id, seed)`` ranks cases, ``hmac_sha256(frame_path, salt)``
ranks frames within a case (salt_id ``seed-<seed>``, tie-break frame_path),
and the perturbation grid seeds rows with
``HMAC_SHA256(master_seed, f"{orig_frame_id}:{perturbation_id}") -> uint32``.

Expected dataset-root layouts (documented, and produced by the synthetic-root
generators in :mod:`.synth` for smoke tests):

SUN root::

    <root>/SUN_0001/images/SUN_0001.000001.jpg   # positive case frames
    <root>/NEG_SUN_case1/images/NEG_SUN_case1.000001.jpg  # negative videos
    <root>/morphology.csv                        # case_id,morphology (optional)

PolypGen root::

    <root>/C1/positive/*.jpg     # per-centre positive frames
    <root>/C1/negative/*.jpg     # per-centre negative pool frames
    <root>/seq10_neg/*.jpg       # negative-only sequences
"""

from __future__ import annotations

import csv
import hashlib
import hmac as hmac_mod
import math
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "FULL_COLUMNS",
    "PERTURBATION_GRID",
    "build_sun_pack",
    "build_sun_morphology_pack",
    "build_sun_subsets",
    "build_sun_perturbations",
    "build_polypgen_pack",
    "build_polypgen_fewshot",
    "hmac_rank_key",
]

# The 28-column reference row schema (data_packs/sun_full/train.csv:1).
FULL_COLUMNS = [
    "dataset", "split", "case_id", "frame_id", "frame_path", "label",
    "store_id", "morphology", "source_video", "frame_index", "width",
    "height", "variant", "synthetic_case_id", "source_case_id",
    "chunk_start", "chunk_end", "split_unit", "synthetic_case",
    "orig_frame_id", "perturbation_id", "rng_seed", "render_in_pipeline",
    "blur_sigma", "jpeg_q", "brightness", "contrast", "bbox_area_frac",
]

# The 16-variant robustness grid (sun_test_perturbations/manifest.yaml
# ``perturbations:`` block): clean + 4 blur sigmas + 4 JPEG qualities +
# 4 brightness/contrast pairs + 3 occlusion areas = 16 rows per clean frame.
PERTURBATION_GRID: List[Dict[str, object]] = [
    {"id": "clean", "kind": "clean"},
    {"id": "blur_sigma_0p5", "kind": "gaussian_blur", "blur_sigma": 0.5},
    {"id": "blur_sigma_1p0", "kind": "gaussian_blur", "blur_sigma": 1.0},
    {"id": "blur_sigma_1p5", "kind": "gaussian_blur", "blur_sigma": 1.5},
    {"id": "blur_sigma_2p0", "kind": "gaussian_blur", "blur_sigma": 2.0},
    {"id": "jpeg_q_95", "kind": "jpeg", "jpeg_q": 95},
    {"id": "jpeg_q_75", "kind": "jpeg", "jpeg_q": 75},
    {"id": "jpeg_q_50", "kind": "jpeg", "jpeg_q": 50},
    {"id": "jpeg_q_30", "kind": "jpeg", "jpeg_q": 30},
    {"id": "bc_b0p8_c0p8", "kind": "brightness_contrast", "brightness": 0.8, "contrast": 0.8},
    {"id": "bc_b0p8_c0p6", "kind": "brightness_contrast", "brightness": 0.8, "contrast": 0.6},
    {"id": "bc_b0p6_c0p8", "kind": "brightness_contrast", "brightness": 0.6, "contrast": 0.8},
    {"id": "bc_b0p6_c0p6", "kind": "brightness_contrast", "brightness": 0.6, "contrast": 0.6},
    {"id": "occ_a0p05", "kind": "occlusion", "bbox_area_frac": 0.05},
    {"id": "occ_a0p10", "kind": "occlusion", "bbox_area_frac": 0.10},
    {"id": "occ_a0p20", "kind": "occlusion", "bbox_area_frac": 0.20},
]

_SENTINELS = {
    "source_video": "", "variant": "", "synthetic_case_id": "",
    "source_case_id": "", "chunk_start": "-1", "chunk_end": "-1",
    "split_unit": "case", "synthetic_case": "False", "orig_frame_id": "",
    "perturbation_id": "", "rng_seed": "-1", "render_in_pipeline": "False",
    "blur_sigma": "-1.0", "jpeg_q": "-1", "brightness": "-1.0",
    "contrast": "-1.0", "bbox_area_frac": "-1.0",
}

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp"}


def hmac_rank_key(item: str, seed: object) -> str:
    """Deterministic HMAC-SHA256 ranking key (``hmac_sha256(item, seed)``)."""
    return hmac_mod.new(
        str(seed).encode("utf-8"), str(item).encode("utf-8"), hashlib.sha256
    ).hexdigest()


def _hmac_uint32(key: object, message: str) -> int:
    digest = hmac_mod.new(
        str(key).encode("utf-8"), message.encode("utf-8"), hashlib.sha256
    ).digest()
    return int.from_bytes(digest[:4], "big")


def _sha256(path: Path) -> str:
    hasher = hashlib.sha256()
    with open(path, "rb") as handle:
        for chunk in iter(lambda: handle.read(1 << 20), b""):
            hasher.update(chunk)
    return hasher.hexdigest()


def _image_size(path: Path) -> Tuple[int, int]:
    """(width, height) from the image header without decoding the pixels."""
    try:
        from PIL import Image

        with Image.open(path) as img:
            return int(img.width), int(img.height)
    except Exception:
        return -1, -1


def _frame_index(path: Path) -> int:
    """Trailing numeric segment of ``CASE.NNNNNN.jpg``-style names (else -1)."""
    parts = path.stem.rsplit(".", 1)
    if len(parts) == 2 and parts[1].isdigit():
        return int(parts[1])
    digits = "".join(ch for ch in path.stem if ch.isdigit())
    return int(digits) if digits else -1


def _write_csv(path: Path, rows: Sequence[Mapping[str, str]]) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as handle:
        writer = csv.DictWriter(handle, fieldnames=FULL_COLUMNS)
        writer.writeheader()
        for row in rows:
            merged = dict(_SENTINELS)
            merged.update(row)
            writer.writerow({c: merged.get(c, "") for c in FULL_COLUMNS})
    return _sha256(path)


def _read_csv(path: Path) -> List[Dict[str, str]]:
    with open(path, newline="", encoding="utf-8") as handle:
        return [dict(row) for row in csv.DictReader(handle)]


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def _counts_block(rows: Sequence[Mapping[str, str]]) -> Dict[str, object]:
    pos = sum(1 for r in rows if str(r.get("label")) == "1")
    neg = len(rows) - pos
    pos_cases = {r["case_id"] for r in rows if str(r.get("label")) == "1"}
    neg_cases = {r["case_id"] for r in rows if str(r.get("label")) != "1"}
    return {
        "frames": len(rows), "pos": pos, "neg": neg,
        "pos_cases": len(pos_cases), "neg_cases": len(neg_cases),
    }


def _summary_block(split: str, rows: Sequence[Mapping[str, str]]) -> Dict[str, object]:
    counts = _counts_block(rows)
    block: Dict[str, object] = {
        "split": split,
        "pos_cases": counts["pos_cases"], "neg_cases": counts["neg_cases"],
        "frames": counts["frames"],
        "pos_frames": counts["pos"], "neg_frames": counts["neg"],
        "label_counts": {"pos": counts["pos"], "neg": counts["neg"]},
    }
    morph_cases: Dict[str, set] = {}
    for row in rows:
        morph = row.get("morphology") or ""
        if str(row.get("label")) == "1" and morph:
            morph_cases.setdefault(morph, set()).add(row["case_id"])
    for morph, cases in sorted(morph_cases.items()):
        block[f"{morph}_cases"] = len(cases)
    return block


# ---------------------------------------------------------------------------
# SUN root scanning
# ---------------------------------------------------------------------------


@dataclass
class SunCase:
    case_id: str
    frames: List[Path]  # absolute paths, sorted by frame index
    morphology: Optional[str] = None


@dataclass
class SunRoot:
    root: Path
    pos_cases: Dict[str, SunCase] = field(default_factory=dict)
    neg_sources: Dict[str, SunCase] = field(default_factory=dict)


def scan_sun_root(root: Path) -> SunRoot:
    """Discover positive cases and negative source videos in a SUN layout.

    Case directories hold frames under ``<case>/images/`` (or directly in the
    case directory).  Directories whose name starts with ``NEG`` are negative
    source videos; the rest are positive cases.  An optional
    ``morphology.csv`` (columns ``case_id,morphology``) annotates positives.
    """
    root = Path(root)
    scanned = SunRoot(root=root)
    morph_map: Dict[str, str] = {}
    morph_csv = root / "morphology.csv"
    if morph_csv.exists():
        for row in _read_csv(morph_csv):
            morph_map[row["case_id"]] = row["morphology"]
    for case_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        frames_dir = case_dir / "images"
        if not frames_dir.is_dir():
            frames_dir = case_dir
        frames = sorted(
            (p for p in frames_dir.iterdir() if p.suffix.lower() in IMAGE_SUFFIXES),
            key=lambda p: (_frame_index(p), p.name),
        )
        if not frames:
            continue
        case = SunCase(case_id=case_dir.name, frames=frames,
                       morphology=morph_map.get(case_dir.name))
        if case_dir.name.upper().startswith("NEG"):
            scanned.neg_sources[case.case_id] = case
        else:
            scanned.pos_cases[case.case_id] = case
    return scanned


def _select_frames(case_frames: Sequence[Path], root: Path, salt: str,
                   frames_per_case: int) -> List[Path]:
    """``hmac_sha256(frame_path, salt)``-ranked subset, tie-break frame_path."""
    rel = [(p.relative_to(root).as_posix(), p) for p in case_frames]
    ranked = sorted(rel, key=lambda item: (hmac_rank_key(item[0], salt), item[0]))
    return [p for _, p in ranked[:frames_per_case]]


def _scaled_targets(targets: Sequence[int], available: int) -> List[int]:
    """Shrink split case targets proportionally when the root is smaller."""
    total = sum(targets)
    if available >= total:
        return list(targets)
    if available < len(targets):
        raise ValueError(
            f"need at least {len(targets)} cases (one per split), have {available}"
        )
    scaled = [max(1, (t * available) // total) for t in targets]
    while sum(scaled) > available:
        scaled[scaled.index(max(scaled))] -= 1
    return scaled


def _chunk_negatives(source: SunCase, frames_per_case: int) -> List[Dict[str, object]]:
    """Split a negative source video into 33-frame virtual cases.

    Mirrors the synthetic-case rows of the reference packs: consecutive
    non-overlapping chunks, named ``<source>_vNNN`` with chunk_start/chunk_end
    frame indices and ``synthetic_case=True``.
    """
    chunks = []
    usable = len(source.frames) // frames_per_case
    for index in range(usable):
        frames = source.frames[index * frames_per_case:(index + 1) * frames_per_case]
        chunks.append({
            "case_id": f"{source.case_id}_v{index + 1:03d}",
            "source_case_id": source.case_id,
            "chunk_start": _frame_index(frames[0]),
            "chunk_end": _frame_index(frames[-1]),
            "frames": frames,
        })
    return chunks


def _sun_row(*, split: str, case_id: str, frame: Path, root: Path, label: int,
             morphology: Optional[str], extra: Optional[Mapping[str, object]] = None,
             store_id: str = "sun") -> Dict[str, str]:
    # frame_path is declared relative to roots.sun (manifest
    # ``frame_sampling.path_is_relative_to``).  The reference stores frames in
    # a flat images/ dir so its paths drop the case dir; our scanned layout
    # keeps frames under <case>/images/, so the case dir stays in the path.
    rel = frame.relative_to(root).as_posix()
    frame_path = rel
    width, height = _image_size(frame)
    row = {
        "dataset": "SUN", "split": split, "case_id": case_id,
        "frame_id": rel, "frame_path": frame_path, "label": str(label),
        "store_id": store_id, "morphology": morphology or "",
        "frame_index": str(_frame_index(frame)),
        "width": str(width), "height": str(height),
    }
    if extra:
        row.update({k: str(v) for k, v in extra.items()})
    return row


def _build_sun_common(
    root: Path, out: Path, *, name: str, seed: int, frames_per_case: int,
    cases_per_split: Sequence[int], stratify_morphology: bool, command: str,
) -> Path:
    """Shared body of ``sun build`` and ``sun morph``."""
    import yaml

    root, out = Path(root), Path(out)
    scanned = scan_sun_root(root)
    if not scanned.pos_cases:
        raise ValueError(f"no positive cases found under {root}")
    if not scanned.neg_sources:
        raise ValueError(f"no NEG_* source videos found under {root}")
    splits = ["train", "val", "test"]
    salt = f"seed-{seed}"

    eligible_pos = [
        c for c in scanned.pos_cases.values() if len(c.frames) >= frames_per_case
    ]
    pos_targets = _scaled_targets(cases_per_split, len(eligible_pos))

    # Case selection: hmac_sha256(case_id, seed) ranking; morphology builds
    # stratify the ranking within each morphology stratum so split morphology
    # ratios track the dataset (sun_morphology/manifest.yaml policy.balance).
    pos_by_split: Dict[str, List[SunCase]] = {s: [] for s in splits}
    if stratify_morphology:
        strata: Dict[str, List[SunCase]] = {}
        for case in eligible_pos:
            strata.setdefault(case.morphology or "unknown", []).append(case)
        for stratum_cases in strata.values():
            ranked = sorted(stratum_cases, key=lambda c: hmac_rank_key(c.case_id, seed))
            stratum_targets = _scaled_targets(
                [max(1, round(t * len(stratum_cases) / len(eligible_pos)))
                 for t in pos_targets],
                len(stratum_cases),
            )
            cursor = 0
            for split, take in zip(splits, stratum_targets):
                pos_by_split[split].extend(ranked[cursor:cursor + take])
                cursor += take
    else:
        ranked = sorted(eligible_pos, key=lambda c: hmac_rank_key(c.case_id, seed))
        cursor = 0
        for split, take in zip(splits, pos_targets):
            pos_by_split[split] = ranked[cursor:cursor + take]
            cursor += take

    # Negative sources are split-disjoint (neg_sources_per_split in the
    # reference manifest): rank sources, deal them round-robin to splits,
    # then rank each split's virtual-case chunks and take the split target.
    sources_ranked = sorted(
        scanned.neg_sources.values(), key=lambda c: hmac_rank_key(c.case_id, seed)
    )
    source_split: Dict[str, List[SunCase]] = {s: [] for s in splits}
    for index, source in enumerate(sources_ranked):
        source_split[splits[index % len(splits)]].append(source)
    # Negative virtual-case capacity can undershoot on small roots; shrink
    # both sides of the balance so cases_pos == cases_neg always holds
    # (full-size roots meet the reference targets exactly).
    chunks_by_split: Dict[str, List[Dict[str, object]]] = {}
    for split in splits:
        chunks: List[Dict[str, object]] = []
        for source in source_split[split]:
            chunks.extend(_chunk_negatives(source, frames_per_case))
        if not chunks:
            raise ValueError(
                f"split {split!r} has no negative virtual cases "
                f"(sources: {[s.case_id for s in source_split[split]]}, "
                f"need >= {frames_per_case} frames per chunk)"
            )
        chunks.sort(key=lambda c: hmac_rank_key(str(c["case_id"]), seed))
        chunks_by_split[split] = chunks
    pos_targets = [
        min(target, len(chunks_by_split[split]))
        for split, target in zip(splits, pos_targets)
    ]
    for split, take in zip(splits, pos_targets):
        pos_by_split[split] = pos_by_split[split][:take]
    neg_targets = list(pos_targets)  # balance: cases_pos == cases_neg
    neg_by_split: Dict[str, List[Dict[str, object]]] = {
        split: chunks_by_split[split][:take]
        for split, take in zip(splits, neg_targets)
    }

    out.mkdir(parents=True, exist_ok=True)
    hashes: Dict[str, str] = {}
    counts: Dict[str, object] = {}
    summaries: List[Dict[str, object]] = []
    split_lists: Dict[str, Dict[str, List[str]]] = {}
    case_lengths: Dict[int, int] = {}
    for split in splits:
        rows: List[Dict[str, str]] = []
        for case in pos_by_split[split]:
            frames = _select_frames(case.frames, root, salt, frames_per_case)
            case_lengths[len(frames)] = case_lengths.get(len(frames), 0) + 1
            for frame in frames:
                rows.append(_sun_row(
                    split=split, case_id=case.case_id, frame=frame, root=root,
                    label=1, morphology=case.morphology,
                    extra={"source_case_id": case.case_id},
                ))
        for chunk in neg_by_split[split]:
            frames = chunk["frames"]
            case_lengths[len(frames)] = case_lengths.get(len(frames), 0) + 1
            for frame in frames:
                rows.append(_sun_row(
                    split=split, case_id=str(chunk["case_id"]), frame=frame,
                    root=root, label=0, morphology=None,
                    extra={
                        "synthetic_case_id": chunk["case_id"],
                        "source_case_id": chunk["source_case_id"],
                        "chunk_start": chunk["chunk_start"],
                        "chunk_end": chunk["chunk_end"],
                        "synthetic_case": "True",
                    },
                ))
        hashes[split] = _write_csv(out / f"{split}.csv", rows)
        counts[split] = _counts_block(rows)
        summaries.append(_summary_block(split, rows))
        split_lists[split] = {
            "pos_cases": [c.case_id for c in pos_by_split[split]],
            "neg_cases": [str(c["case_id"]) for c in neg_by_split[split]],
        }

    balance = f"cases_pos={pos_targets[0]},cases_neg={neg_targets[0]}"
    if stratify_morphology:
        balance += ",stratify=morphology"
    manifest = {
        "name": name,
        "version": "0.0",
        "generator": {
            "repo": "ssl4polyp-tpu",
            "command": command,
            "seed": seed,
        },
        "policy": {
            "unit_of_split": "case",
            "negative_split_unit": "case",
            "frames_per_case": frames_per_case,
            "balance": balance,
            "selection": "hmac_sha256(case_id,seed)",
        },
        "frame_sampling": {
            "selection": "hmac_sha256(frame_path,salt)",
            "path_normalization": "posix,no-leading-slash,single-slash",
            "path_is_relative_to": "roots.sun",
            "salt_id": salt,
            "tie_break": "frame_path",
            "frames_per_case": frames_per_case,
            "resampled_with_replacement": False,
        },
        "roots": {"sun": str(root)},
        "assertions": {
            "no_case_leakage_across_splits": True,
            "split_targets_met": {
                split: {
                    "pos_cases": pos_targets[i], "neg_cases": neg_targets[i],
                    "frames": (pos_targets[i] + neg_targets[i]) * frames_per_case,
                }
                for i, split in enumerate(splits)
            },
            f"all_cases_have_{frames_per_case}_frames": (
                set(case_lengths) == {frames_per_case}
            ),
            "no_negative_case_leakage": True,
            "neg_sources_per_split": {
                split: len(source_split[split]) for split in splits
            },
        },
        "splits": split_lists,
        "generated_at": _now_iso(),
        "hashes": hashes,
        "counts": counts,
        "summary_by_split": summaries,
        "case_lengths": {int(k): v for k, v in sorted(case_lengths.items())},
    }
    (out / "manifest.yaml").write_text(yaml.safe_dump(manifest, sort_keys=False),
                                       encoding="utf-8")
    return out


def build_sun_pack(root: Path, out: Path, *, seed: int = 47,
                   frames_per_case: int = 33,
                   cases_per_split: Sequence[int] = (70, 15, 15)) -> Path:
    """``polypdb sun build`` — the sun_full pack.

    Policy per ``data_packs/sun_full/manifest.yaml``: case-level splits,
    70/15/15 positive and negative cases, 33 HMAC-sampled frames per case,
    split-disjoint negative source videos chunked into synthetic cases.
    Targets scale proportionally on smaller roots (smoke tests).
    """
    command = (f"polypdb sun build --root {root} --out {out} "
               f"--seed {seed} --frames-per-case {frames_per_case}")
    return _build_sun_common(
        root, out, name="sun-full", seed=seed, frames_per_case=frames_per_case,
        cases_per_split=cases_per_split, stratify_morphology=False,
        command=command,
    )


def build_sun_morphology_pack(root: Path, out: Path, *, seed: int = 47,
                              frames_per_case: int = 33,
                              cases_per_split: Sequence[int] = (70, 15, 15)) -> Path:
    """``polypdb sun morph`` — morphology-stratified sun pack.

    Per ``data_packs/sun_morphology/manifest.yaml``: the case split is
    stratified on the flat/polypoid morphology annotation so every split
    keeps the dataset's morphology mix (exp3 strata analysis depends on it).
    """
    command = (f"polypdb sun morph --root {root} --out {out} "
               f"--seed {seed} --frames-per-case {frames_per_case}")
    return _build_sun_common(
        root, out, name="sun-morphology", seed=seed,
        frames_per_case=frames_per_case, cases_per_split=cases_per_split,
        stratify_morphology=True, command=command,
    )


def build_sun_subsets(pack: Path, out: Path, *, percents: Sequence[int] = (5, 10, 25, 50, 100),
                      seed: int = 13) -> List[Path]:
    """``polypdb sun subsets-canonical`` — nested train-percent subsets.

    Per ``data_packs/sun_subsets/sun_p05/manifest.yaml``: each percent keeps
    the top ``ceil(p% * N)`` positive and negative *cases* of the parent
    train split under the shared ``hmac_sha256(case_id, seed)`` ranking, so
    subsets nest canonically (p05 ⊂ p10 ⊂ … ⊂ p100).  Only train.csv is
    emitted; val/test come from the parent pack.
    """
    import yaml

    pack, out = Path(pack), Path(out)
    parent_manifest = yaml.safe_load((pack / "manifest.yaml").read_text(encoding="utf-8"))
    rows = _read_csv(pack / "train.csv")
    by_case: Dict[str, List[Dict[str, str]]] = {}
    case_label: Dict[str, int] = {}
    for row in rows:
        by_case.setdefault(row["case_id"], []).append(row)
        case_label[row["case_id"]] = int(row["label"])
    pos_ranked = sorted((c for c, l in case_label.items() if l == 1),
                        key=lambda c: hmac_rank_key(c, seed))
    neg_ranked = sorted((c for c, l in case_label.items() if l != 1),
                        key=lambda c: hmac_rank_key(c, seed))
    outputs = []
    for percent in percents:
        take_pos = max(1, math.ceil(len(pos_ranked) * percent / 100))
        take_neg = max(1, math.ceil(len(neg_ranked) * percent / 100))
        kept = pos_ranked[:take_pos] + neg_ranked[:take_neg]
        kept_set = set(kept)
        subset_rows = [row for row in rows if row["case_id"] in kept_set]
        subset_dir = out / f"sun_p{percent:02d}" if percent < 100 else out / "sun_p100"
        subset_dir.mkdir(parents=True, exist_ok=True)
        digest = _write_csv(subset_dir / "train.csv", subset_rows)
        manifest = {
            "name": subset_dir.name,
            "version": "0.0",
            "generator": {
                "repo": "ssl4polyp-tpu",
                "command": (f"polypdb sun subsets-canonical --pack {pack} "
                            f"--percents {' '.join(str(p) for p in percents)} "
                            f"--seed {seed} --out {out}"),
                "seed": seed,
                "percent_seed_map": {int(p): seed for p in percents},
            },
            "policy": dict(parent_manifest.get("policy", {}),
                           selection_scope="case", train_percent=int(percent)),
            "frame_sampling": dict(parent_manifest.get("frame_sampling", {}),
                                   selection_scope="frame"),
            "roots": parent_manifest.get("roots", {}),
            "parent_pack": {"name": parent_manifest.get("name"), "path": str(pack)},
            "assertions": {
                "canonical_nesting": True,
                "cases_kept": {"pos": take_pos, "neg": take_neg},
            },
            "generated_at": _now_iso(),
            "hashes": {"train": digest},
            "counts": {"train": _counts_block(subset_rows)},
            "summary_by_split": [_summary_block("train", subset_rows)],
        }
        (subset_dir / "manifest.yaml").write_text(
            yaml.safe_dump(manifest, sort_keys=False), encoding="utf-8")
        outputs.append(subset_dir)
    return outputs


def build_sun_perturbations(pack: Path, out: Path, *, master_seed: int = 47) -> Path:
    """``polypdb sun perturbations`` — the 16-variant robustness grid.

    Per ``data_packs/sun_test_perturbations/manifest.yaml``: every clean test
    frame of the parent pack expands into one row per grid entry
    (16 × 990 = 15,840 on the full pack), with
    ``rng_seed = HMAC_SHA256(master_seed, f"{orig_frame_id}:{perturbation_id}")``
    truncated to uint32 and ``render_in_pipeline=True`` so the loader's
    per-row perturber re-renders deterministically at eval time.
    """
    import yaml

    pack, out = Path(pack), Path(out)
    parent_manifest = yaml.safe_load((pack / "manifest.yaml").read_text(encoding="utf-8"))
    clean_rows = _read_csv(pack / "test.csv")
    rows: List[Dict[str, str]] = []
    for clean in clean_rows:
        orig_frame_id = clean["frame_id"]
        for spec in PERTURBATION_GRID:
            row = dict(clean)
            row.update({
                "orig_frame_id": orig_frame_id,
                "perturbation_id": str(spec["id"]),
                "rng_seed": str(_hmac_uint32(master_seed,
                                             f"{orig_frame_id}:{spec['id']}")),
                "render_in_pipeline": "True",
                "blur_sigma": str(spec.get("blur_sigma", -1.0)),
                "jpeg_q": str(spec.get("jpeg_q", -1)),
                "brightness": str(spec.get("brightness", -1.0)),
                "contrast": str(spec.get("contrast", -1.0)),
                "bbox_area_frac": str(spec.get("bbox_area_frac", -1.0)),
            })
            rows.append(row)
    out.mkdir(parents=True, exist_ok=True)
    digest = _write_csv(out / "test.csv", rows)
    manifest = {
        "name": "sun_test_perturbations",
        "version": "0.0",
        "generator": {
            "repo": "ssl4polyp-tpu",
            "command": (f"polypdb sun perturbations --pack {pack} --out {out} "
                        f"--master-seed {master_seed}"),
        },
        "evaluation_runtime": {
            "generate_perturbations_on_the_fly": True,
            "rng_master_seed": master_seed,
            "per_row_seed_rule": (
                "HMAC_SHA256(master_seed, f'{orig_frame_id}:{perturbation_id}') "
                "-> uint32"
            ),
            "occlusion_bbox_rule": "seeded square bbox from per_row_seed",
        },
        "policy": {"unit_of_split": "frame"},
        "roots": parent_manifest.get("roots", {}),
        "parent_pack": {"name": parent_manifest.get("name"), "path": str(pack)},
        "perturbations": [
            {"id": spec["id"], "kind": spec["kind"],
             "params": {k: v for k, v in spec.items() if k not in {"id", "kind"}}}
            for spec in PERTURBATION_GRID
        ],
        "generated_at": _now_iso(),
        "hashes": {"test": digest},
        "counts": {"test": _counts_block(rows)},
        "assertions": {
            "rows": len(rows),
            "rows_per_clean_frame": len(PERTURBATION_GRID),
            "clean_frames": len(clean_rows),
        },
    }
    (out / "manifest.yaml").write_text(yaml.safe_dump(manifest, sort_keys=False),
                                       encoding="utf-8")
    return out


# ---------------------------------------------------------------------------
# PolypGen
# ---------------------------------------------------------------------------


def _sequence_id(frame_id: str) -> Optional[str]:
    """``NEGSEQ.seq10_neg.00000`` → ``seq10_neg`` (None for non-sequence ids)."""
    parts = frame_id.split(".")
    if len(parts) >= 3 and parts[0] == "NEGSEQ":
        return parts[1]
    return None


def build_polypgen_pack(root: Path, out: Path, *,
                        include_negative_sequences: bool = False) -> Path:
    """``polypdb polypgen build`` — the clean PolypGen test pack.

    Per ``data_packs/polypgen_clean_test{,_extended}/manifest.yaml``: a
    frame-level, test-only pack.  Positive/negative pool frames carry their
    centre as ``case_id`` (C1..C6); with ``--include-negative-sequences``
    the negative-only sequences are appended with ``case_id=None`` and
    sequence identity encoded in ``frame_id`` (``NEGSEQ.<seq>.<idx>``).
    """
    import yaml

    root, out = Path(root), Path(out)
    rows: List[Dict[str, str]] = []

    def _frames(directory: Path) -> List[Path]:
        return sorted(p for p in directory.iterdir()
                      if p.suffix.lower() in IMAGE_SUFFIXES)

    centres = sorted(
        p for p in root.iterdir()
        if p.is_dir() and not p.name.endswith("_neg")
    )
    sequences = sorted(p for p in root.iterdir() if p.is_dir() and p.name.endswith("_neg"))
    for centre in centres:
        for label, sub in ((1, "positive"), (0, "negative")):
            sub_dir = centre / sub
            if not sub_dir.is_dir():
                continue
            for index, frame in enumerate(_frames(sub_dir)):
                width, height = _image_size(frame)
                rel = frame.relative_to(root).as_posix()
                rows.append({
                    "dataset": "PolypGen", "split": "test",
                    "case_id": centre.name,
                    "frame_id": f"POLYPGEN.{centre.name}.{sub}.{index:06d}",
                    "frame_path": rel, "label": str(label),
                    "store_id": "polypgen_clean",
                    "frame_index": "-1",
                    "width": str(width), "height": str(height),
                })
    if include_negative_sequences:
        for seq in sequences:
            for index, frame in enumerate(_frames(seq)):
                width, height = _image_size(frame)
                rel = frame.relative_to(root).as_posix()
                rows.append({
                    "dataset": "PolypGen", "split": "test",
                    "case_id": "None",
                    "frame_id": f"NEGSEQ.{seq.name}.{index:05d}",
                    "frame_path": rel, "label": "0",
                    "store_id": "polypgen_clean",
                    "frame_index": "-1",
                    "width": str(width), "height": str(height),
                })
    if not rows:
        raise ValueError(f"no PolypGen frames found under {root}")
    out.mkdir(parents=True, exist_ok=True)
    digest = _write_csv(out / "test.csv", rows)
    counts = _counts_block(rows)
    name = ("polypgen-clean-test-extended" if include_negative_sequences
            else "polypgen-clean-test")
    manifest = {
        "name": name,
        "version": "0.0",
        "generator": {
            "repo": "ssl4polyp-tpu",
            "command": (f"polypdb polypgen build --root {root} --out {out} "
                        f"--track clean"
                        + (" --include-negative-sequences"
                           if include_negative_sequences else "")),
        },
        "policy": {"unit_of_split": "frame"},
        "roots": {"polypgen_clean": str(root)},
        "assertions": {
            "class_presence": {"pos": ">0", "neg": ">0"},
            "label_counts": {"pos": counts["pos"], "neg": counts["neg"]},
            "no_train_val_test_in_test_pack": True,
        },
        "generated_at": _now_iso(),
        "hashes": {"test": digest},
        "counts": {"test": counts},
        "summary_by_split": [_summary_block("test", rows)],
    }
    (out / "manifest.yaml").write_text(yaml.safe_dump(manifest, sort_keys=False),
                                       encoding="utf-8")
    return out


def _val_fraction(budget: int) -> float:
    """The reference's val-fraction rule (polypgen_fewshot_s*/manifest.yaml)."""
    if budget < 100:
        return 0.1
    if budget < 200:
        return 0.15
    return 0.2


def build_polypgen_fewshot(parent_pack: Path, out: Path, *,
                           budgets: Sequence[int] = (50, 100, 200, 500),
                           seed: int = 13,
                           max_frames_per_sequence: int = 5) -> List[Path]:
    """``polypdb polypgen fewshot`` — budgeted few-shot packs (exp5c).

    Policy per ``data_packs/polypgen_fewshot/polypgen_fewshot_s500/manifest.yaml``:

    * per budget S, target S/2 positives + S/2 negatives, frame-level;
    * positives ranked by ``hmac_sha256(frame_id, seed)``;
    * negatives pool-first (centre negatives) then single-pass over
      HMAC-ranked negative sequences, capped at ``max_frames_per_sequence``;
    * train/val split by the val-fraction rule (0.1 / 0.15 / 0.2 by budget);
    * test = the parent complement with *whole* touched sequences excluded
      (sequence-level disjointness across train/val/test).
    """
    import yaml

    parent_pack, out = Path(parent_pack), Path(out)
    parent_manifest = yaml.safe_load(
        (parent_pack / "manifest.yaml").read_text(encoding="utf-8"))
    rows = _read_csv(parent_pack / "test.csv")
    pos_rows = [r for r in rows if r["label"] == "1"]
    pool_rows = [r for r in rows if r["label"] != "1"
                 and _sequence_id(r["frame_id"]) is None]
    seq_rows: Dict[str, List[Dict[str, str]]] = {}
    for row in rows:
        seq = _sequence_id(row["frame_id"])
        if row["label"] != "1" and seq is not None:
            seq_rows.setdefault(seq, []).append(row)

    pos_ranked = sorted(pos_rows, key=lambda r: hmac_rank_key(r["frame_id"], seed))
    pool_ranked = sorted(pool_rows, key=lambda r: hmac_rank_key(r["frame_id"], seed))
    seq_ids_ranked = sorted(seq_rows, key=lambda s: hmac_rank_key(s, seed))

    outputs = []
    for budget in budgets:
        per_class = budget // 2
        take_pos = min(per_class, len(pos_ranked))
        picked_pos = pos_ranked[:take_pos]

        picked_neg: List[Tuple[str, Dict[str, str]]] = []  # (unit, row)
        for row in pool_ranked[:per_class]:
            picked_neg.append((row["frame_id"], row))
        touched_sequences: List[str] = []
        for seq in seq_ids_ranked:
            if len(picked_neg) >= per_class:
                break
            frames = sorted(seq_rows[seq],
                            key=lambda r: hmac_rank_key(r["frame_id"], seed))
            take = min(max_frames_per_sequence, per_class - len(picked_neg))
            picked_neg.extend((seq, row) for row in frames[:take])
            touched_sequences.append(seq)

        # Split train/val.  Positives: frame-level HMAC with a val-salted
        # key; negatives: unit-level (whole sequences stay together).
        frac = _val_fraction(budget)
        val_pos_n = int(frac * len(picked_pos))
        pos_val_ranked = sorted(
            picked_pos, key=lambda r: hmac_rank_key(f"val:{r['frame_id']}", seed))
        val_pos = {r["frame_id"] for r in pos_val_ranked[:val_pos_n]}

        val_neg_quota = int(frac * len(picked_neg))
        units: Dict[str, List[Dict[str, str]]] = {}
        for unit, row in picked_neg:
            units.setdefault(unit, []).append(row)
        units_ranked = sorted(units, key=lambda u: hmac_rank_key(f"val:{u}", seed))
        val_neg: set = set()
        for unit in units_ranked:
            remaining = val_neg_quota - len(val_neg)
            if remaining <= 0:
                break
            # Units move whole (a sequence split across train/val would break
            # sequence_disjointness_across); skip units too big to fit.
            if len(units[unit]) > remaining:
                continue
            val_neg.update(row["frame_id"] for row in units[unit])

        used_ids = ({r["frame_id"] for r in picked_pos}
                    | {row["frame_id"] for _, row in picked_neg})
        touched = set(touched_sequences)

        split_rows: Dict[str, List[Dict[str, str]]] = {"train": [], "val": [], "test": []}
        for row in picked_pos:
            target = "val" if row["frame_id"] in val_pos else "train"
            split_rows[target].append(dict(row, split=target))
        for _, row in picked_neg:
            target = "val" if row["frame_id"] in val_neg else "train"
            split_rows[target].append(dict(row, split=target))
        for row in rows:
            if row["frame_id"] in used_ids:
                continue
            seq = _sequence_id(row["frame_id"])
            if seq is not None and seq in touched:
                continue  # sequence-level disjointness
            split_rows["test"].append(dict(row, split="test"))

        pack_dir = out / f"polypgen_fewshot_s{budget}"
        pack_dir.mkdir(parents=True, exist_ok=True)
        hashes, counts, summaries = {}, {}, []
        for split in ("train", "val", "test"):
            hashes[split] = _write_csv(pack_dir / f"{split}.csv", split_rows[split])
            counts[split] = _counts_block(split_rows[split])
            summaries.append(_summary_block(split, split_rows[split]))

        train_counts = counts["train"]
        seq_in_train = {
            _sequence_id(r["frame_id"]) for r in split_rows["train"]
            if _sequence_id(r["frame_id"]) is not None
        }
        pool_ids = {r["frame_id"] for r in pool_rows}
        neg_source = {
            split: {
                "base": sum(1 for r in split_rows[split]
                            if r["label"] != "1" and r["frame_id"] in pool_ids),
                "sequence": sum(1 for r in split_rows[split]
                                if r["label"] != "1" and r["frame_id"] not in pool_ids),
            }
            for split in ("train", "val", "test")
        }
        manifest = {
            "name": pack_dir.name,
            "version": "1.0.0",
            "policy": {
                "unit_of_split": "frame",
                "fewshot_budget_S": int(budget),
                "parent_pack": parent_manifest.get("name"),
                "target_train_size": int(budget),
                "target_class_balance": {"pos": per_class, "neg": per_class},
                "class_ratio_per_split": {
                    split: {"pos": counts[split]["pos"], "neg": counts[split]["neg"]}
                    for split in ("train", "val", "test")
                },
                "realized_train_size": train_counts["frames"],
                "realized_train_counts": {
                    "pos": train_counts["pos"], "neg": train_counts["neg"],
                },
                "balance_relaxed": take_pos < per_class or len(picked_neg) < per_class,
                "val_fraction_target": frac,
                "val_fraction_rule": {
                    "size_lt_100": 0.1, "size_100_to_199": 0.15, "size_gte_200": 0.2,
                },
                "neg_sampling": {
                    "strategy": "pool_first_sequence_cap_single_pass",
                    "pool_first": True,
                    "max_frames_per_sequence": max_frames_per_sequence,
                    "sequence_level_disjointness": True,
                    "phase_counts": {
                        "base_pool": sum(1 for u, _ in picked_neg if u in pool_ids),
                        "sequence": sum(1 for u, _ in picked_neg if u not in pool_ids),
                    },
                    "sequences_in_train": len(seq_in_train),
                },
                "negatives_source": neg_source,
                "max_frames_per_sequence_train": max_frames_per_sequence,
                "sequence_disjointness_across": ["train", "val", "test"],
                "sampling": (f"pos:frame_id; neg:frame_pool_then_sequence"
                             f"(cap={max_frames_per_sequence}); seed={seed}"),
            },
            "selection_keys": {
                "train": f"hmac_sha256(frame_id,{seed})",
                "val": f"hmac_sha256(unit_key=frame_id|sequence_id_or_frame_id,{seed})",
                "test": ("complement of train|val with neg-sequence exclusion "
                         f"within {parent_manifest.get('name')}"),
            },
            "roots": parent_manifest.get("roots", {}),
            "generated_at": _now_iso(),
            "hashes": hashes,
            "counts": counts,
            "summary_by_split": summaries,
        }
        (pack_dir / "manifest.yaml").write_text(
            yaml.safe_dump(manifest, sort_keys=False), encoding="utf-8")
        outputs.append(pack_dir)
    return outputs
