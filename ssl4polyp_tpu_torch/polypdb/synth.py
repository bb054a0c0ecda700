"""Synthetic data-pack generation for smoke tests and CI.

The port's copy of ``ssl4polyp_tpu/polypdb/synth.py``: the pack generator and
the SUN and PolypGen root generators, which from one seed write the same
bytes as the JAX package's (PIL imported where a frame is written).

The real SUN/Hyperkvasir/PolypGen packs reference licensed images that are
distributed separately; this module produces a schema-identical pack
(28-column-compatible CSVs, manifest with roots + SHA256 hashes) from random
frames so every pipeline stage can run end-to-end without the datasets.
"""

from __future__ import annotations

import csv
import hashlib
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "build_synthetic_pack",
    "build_synthetic_sun_root",
    "build_synthetic_polypgen_root",
    "PACK_COLUMNS",
]

PACK_COLUMNS = [
    "frame_path", "label", "case_id", "frame_id", "morphology",
    "variant", "perturbation_id", "rng_seed", "render_in_pipeline",
    "blur_sigma", "jpeg_q", "brightness", "contrast", "bbox_area_frac",
]


def _write_frame(path: Path, rng: np.random.Generator, label: int,
                 image_size: int) -> None:
    """Random frame; positives get a bright blob so models can learn."""
    from PIL import Image

    array = rng.integers(20, 120, (image_size, image_size, 3), dtype=np.uint8)
    if label:
        cx, cy = rng.integers(image_size // 4, 3 * image_size // 4, 2)
        r = image_size // 6
        yy, xx = np.ogrid[:image_size, :image_size]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        array[blob] = np.clip(array[blob].astype(int) + 110, 0, 255).astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(array).save(path, quality=92)


def build_synthetic_sun_root(
    out_dir: str | Path,
    *,
    pos_cases: int = 12,
    frames_per_case: int = 12,
    neg_sources: int = 3,
    frames_per_source: int = 40,
    image_size: int = 64,
    seed: int = 0,
) -> Path:
    """SUN-layout dataset root for exercising the ``polypdb sun`` builders.

    Layout matches :func:`.builders.scan_sun_root`:
    ``SUN_%04d/images/SUN_%04d.%06d.jpg`` positive cases,
    ``NEG_SUN_caseN/images/...`` negative source videos, and a
    ``morphology.csv`` annotating positives (flat/polypoid).
    """
    root = Path(out_dir)
    rng = np.random.default_rng(seed)
    morph_rows = []
    for case_index in range(1, pos_cases + 1):
        case_id = f"SUN_{case_index:04d}"
        for frame_index in range(1, frames_per_case + 1):
            _write_frame(root / case_id / "images" / f"{case_id}.{frame_index:06d}.jpg",
                         rng, 1, image_size)
        morph_rows.append((case_id, "flat" if case_index % 3 == 0 else "polypoid"))
    for source_index in range(1, neg_sources + 1):
        source_id = f"NEG_SUN_case{source_index}"
        for frame_index in range(1, frames_per_source + 1):
            _write_frame(root / source_id / "images" / f"{source_id}.{frame_index:06d}.jpg",
                         rng, 0, image_size)
    with open(root / "morphology.csv", "w", newline="", encoding="utf-8") as handle:
        writer = csv.writer(handle)
        writer.writerow(["case_id", "morphology"])
        writer.writerows(morph_rows)
    return root


def build_synthetic_polypgen_root(
    out_dir: str | Path,
    *,
    centres: int = 3,
    pos_per_centre: int = 12,
    neg_per_centre: int = 4,
    sequences: int = 4,
    frames_per_sequence: int = 10,
    image_size: int = 64,
    seed: int = 0,
) -> Path:
    """PolypGen-layout root for the ``polypdb polypgen`` builders.

    ``C<i>/positive/*.jpg`` + ``C<i>/negative/*.jpg`` per-centre frames plus
    ``seq<i>_neg/*.jpg`` negative-only sequences.
    """
    root = Path(out_dir)
    rng = np.random.default_rng(seed)
    for centre_index in range(1, centres + 1):
        centre = f"C{centre_index}"
        for frame_index in range(pos_per_centre):
            _write_frame(root / centre / "positive" / f"{centre}_pos_{frame_index:05d}.jpg",
                         rng, 1, image_size)
        for frame_index in range(neg_per_centre):
            _write_frame(root / centre / "negative" / f"{centre}_neg_{frame_index:05d}.jpg",
                         rng, 0, image_size)
    for seq_index in range(1, sequences + 1):
        seq = f"seq{seq_index}_neg"
        for frame_index in range(frames_per_sequence):
            _write_frame(root / seq / f"{seq}_{frame_index:05d}.jpg",
                         rng, 0, image_size)
    return root


def build_synthetic_pack(
    out_dir: str | Path,
    *,
    name: str = "synthetic_pack",
    splits: Sequence[str] = ("train", "val", "test"),
    frames_per_split: int | Mapping[str, int] = 32,
    image_size: int = 224,
    seed: int = 0,
    cases: int = 8,
) -> Path:
    """Write the pack ``name`` under ``out_dir`` and return its directory;
    ``frames_per_split`` is one count for every split or a count a split."""
    import yaml

    out_dir = Path(out_dir)
    pack_dir = out_dir / name
    images_dir = out_dir / f"{name}_images"
    pack_dir.mkdir(parents=True, exist_ok=True)
    images_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    manifest = {
        "name": name,
        "generator": {"tool": "polypdb synth", "seed": seed},
        "roots": {"store": str(images_dir)},
        "policy": {"unit_of_split": "case"},
        "counts": {},
    }
    for split in splits:
        frames = (frames_per_split[split] if isinstance(frames_per_split, Mapping)
                  else frames_per_split)
        rows = []
        for i in range(frames):
            rel = f"{split}_{i:04d}.jpg"
            label = i % 2
            _write_frame(images_dir / rel, rng, label, image_size)
            rows.append({
                "frame_path": f"store/{rel}",
                "label": str(label),
                "case_id": f"case_{i % cases}",
                "frame_id": f"{split}_{i}",
                "morphology": "polypoid" if label else "flat",
                "variant": "", "perturbation_id": "", "rng_seed": "-1",
                "render_in_pipeline": "False",
                "blur_sigma": "-1.0", "jpeg_q": "-1",
                "brightness": "-1.0", "contrast": "-1.0", "bbox_area_frac": "-1.0",
            })
        csv_path = pack_dir / f"{split}.csv"
        with open(csv_path, "w", newline="", encoding="utf-8") as handle:
            writer = csv.DictWriter(handle, fieldnames=PACK_COLUMNS)
            writer.writeheader()
            writer.writerows(rows)
        manifest[split] = {
            "csv": f"{split}.csv",
            "sha256": hashlib.sha256(csv_path.read_bytes()).hexdigest(),
        }
        manifest["counts"][split] = {
            "frames": frames,
            "label_counts": {
                "1": sum(1 for r in rows if r["label"] == "1"),
                "0": sum(1 for r in rows if r["label"] == "0"),
            },
        }
    (pack_dir / "manifest.yaml").write_text(yaml.safe_dump(manifest), encoding="utf-8")
    return pack_dir
