"""Synthetic data-pack generation for smoke tests and CI.

The port's copy of ``ssl4polyp_tpu/polypdb/synth.py``'s pack generator (the
SUN and PolypGen root generators come with the rest of ``polypdb``).

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

__all__ = ["build_synthetic_pack", "PACK_COLUMNS"]

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
