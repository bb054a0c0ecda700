"""Offline corruption rendering for robustness packs.

The port's copy of ``ssl4polyp_tpu/polypdb/robustness.py``, with the same
choice of codec: OpenCV where ``cv2`` imports, PIL otherwise, each imported
inside the function that uses it (PyYAML too, where the manifest is
written).  Both packages therefore write the same bytes on one machine; the
bytes of one variant differ between a machine with OpenCV and one without.

Behavioural parity with the reference builder
(``src/ssl4polyp/polypdb/robustness/build_variants.py``): gaussian blur with
kernel derived from σ, JPEG re-encode at a given quality, brightness scaling,
contrast scaling around mid-gray, and seeded square occlusions
(rng = 12345 + severity_index).  Each (variant, severity) pair produces a
directory of corrupted copies plus an extended ``test.csv`` carrying
``variant``/``severity`` columns, and the output root gets a manifest.

Implementation uses OpenCV when available and falls back to PIL/numpy — the
outputs differ only in codec-level rounding.
"""

from __future__ import annotations

import csv
import math
import random
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

__all__ = [
    "render_blur",
    "render_jpeg",
    "render_brightness",
    "render_contrast",
    "render_occlusion",
    "build_sun_test_corruptions",
    "ROBUSTNESS_RNG_SEED",
]

ROBUSTNESS_RNG_SEED = 12345


def _imread(path: Path) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is not None:
            return img
    except ImportError:
        pass
    from PIL import Image

    with Image.open(path) as handle:
        return np.asarray(handle.convert("RGB"))[:, :, ::-1].copy()  # BGR like cv2


def _imwrite(path: Path, img: np.ndarray, jpeg_quality: int | None = None) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import cv2

        flags = [int(cv2.IMWRITE_JPEG_QUALITY), int(jpeg_quality)] if jpeg_quality else []
        if cv2.imwrite(str(path), img, flags):
            return
    except ImportError:
        pass
    from PIL import Image

    rgb = img[:, :, ::-1] if img.ndim == 3 else img
    Image.fromarray(rgb).save(path, quality=jpeg_quality or 95)


def render_blur(src: Path, dst: Path, sigma: float) -> None:
    img = _imread(src)
    kernel = max(3, int(2 * round(3 * sigma) + 1))
    try:
        import cv2

        out = cv2.GaussianBlur(img, (kernel, kernel), sigmaX=sigma, sigmaY=sigma)
    except ImportError:
        from PIL import Image, ImageFilter

        rgb = Image.fromarray(img[:, :, ::-1])
        out = np.asarray(rgb.filter(ImageFilter.GaussianBlur(radius=sigma)))[:, :, ::-1]
    _imwrite(dst, out)


def render_jpeg(src: Path, dst: Path, quality: int) -> None:
    img = _imread(src)
    _imwrite(dst, img, jpeg_quality=int(quality))


def render_brightness(src: Path, dst: Path, factor: float) -> None:
    img = _imread(src).astype(np.float32)
    _imwrite(dst, np.clip(img * factor, 0, 255).astype(np.uint8))


def render_contrast(src: Path, dst: Path, factor: float) -> None:
    img = _imread(src).astype(np.float32)
    _imwrite(dst, np.clip((img - 128.0) * factor + 128.0, 0, 255).astype(np.uint8))


def render_occlusion(src: Path, dst: Path, area_ratio: float, rng: random.Random) -> None:
    img = _imread(src).copy()
    height, width = img.shape[:2]
    size = max(1, int(round(math.sqrt(area_ratio * height * width))))
    size = min(size, height, width)
    x0 = rng.randint(0, width - size) if width > size else 0
    y0 = rng.randint(0, height - size) if height > size else 0
    img[y0:y0 + size, x0:x0 + size] = 0
    _imwrite(dst, img)


_RENDERERS = {
    "blur": lambda src, dst, value, rng: render_blur(src, dst, float(value)),
    "jpeg": lambda src, dst, value, rng: render_jpeg(src, dst, int(value)),
    "brightness": lambda src, dst, value, rng: render_brightness(src, dst, float(value)),
    "contrast": lambda src, dst, value, rng: render_contrast(src, dst, float(value)),
    "occlusion": lambda src, dst, value, rng: render_occlusion(src, dst, float(value), rng),
}


def build_sun_test_corruptions(
    sun_full_pack: Path,
    spec: Mapping[str, Mapping[str, list]],
    roots: Mapping[str, str],
    out_dir: Path,
) -> None:
    """Render every (variant, severity) grid cell declared by ``spec``.

    ``spec`` maps variant name → {param_name: [severities...]}.
    """
    import yaml

    test_csv = Path(sun_full_pack) / "test.csv"
    with open(test_csv, newline="", encoding="utf-8") as handle:
        reader = csv.DictReader(handle)
        rows = list(reader)
        fieldnames = list(reader.fieldnames or [])

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    for variant, params in spec.items():
        if variant not in _RENDERERS:
            raise ValueError(f"Unknown corruption variant {variant!r}")
        _, severities = next(iter(params.items()))
        for index, severity in enumerate(severities):
            variant_dir = out_dir / f"{variant}_{severity}"
            variant_dir.mkdir(parents=True, exist_ok=True)
            rng = random.Random(ROBUSTNESS_RNG_SEED + index)
            out_rows = []
            for row in rows:
                frame = Path(row["frame_path"])
                root = frame.parts[0]
                relative = Path(*frame.parts[1:])
                src = Path(roots[root]) / relative
                dst = variant_dir / root / relative
                _RENDERERS[variant](src, dst, severity, rng)
                new_row = dict(row)
                new_row["frame_path"] = str(Path(root) / relative)
                new_row["variant"] = variant
                new_row["severity"] = str(severity)
                out_rows.append(new_row)
            extra = [c for c in ("variant", "severity") if c not in fieldnames]
            with open(variant_dir / "test.csv", "w", newline="", encoding="utf-8") as handle:
                writer = csv.DictWriter(handle, fieldnames=fieldnames + extra)
                writer.writeheader()
                writer.writerows(out_rows)

    manifest = {"spec": {k: dict(v) for k, v in spec.items()},
                "policy": {"robustness_rng": ROBUSTNESS_RNG_SEED}}
    (out_dir / "manifest.yaml").write_text(yaml.safe_dump(manifest), encoding="utf-8")
