"""Host-side image decode and deterministic per-row perturbations.

The port's copy of ``ssl4polyp_tpu/data/transforms.py`` (PIL is imported
where a frame is decoded or rendered).  The perturbation renderer reproduces
the reference's contract
(``src/ssl4polyp/classification/data/transforms.py:123-202``):

* every row carries ``variant``/``perturbation_id`` plus optional parameter
  columns (``blur_sigma``, ``jpeg_q``, ``brightness``, ``contrast``,
  ``bbox_area_frac``) and an optional explicit ``rng_seed``;
* when no seed is given, one is derived from
  HMAC-SHA256(key=``ssl4polyp``, msg=frame_path|frame_id|case_id|variant|
  perturbation_id) — deterministic across runs and hosts;
* variants dispatch on prefix: ``blur`` (gaussian), ``jpeg`` (re-encode),
  ``bc`` (brightness/contrast), ``occ`` (black box occlusion);
* parameters missing from the row are parsed from the variant token
  (e.g. ``blur_1p5`` → σ=1.5).

JPEG re-encoding must stay host-side (codec semantics); blur/bc/occ are also
rendered host-side with PIL so distributions match the reference exactly.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import math
import random
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DEFAULT_HMAC_KEY = b"ssl4polyp"

_UNSET = (None, "", -1, "-1", "-1.0", -1.0)


def _truthy(value: object) -> bool:
    if value is None:
        return False
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in {"1", "true", "yes", "y"}


def _numeric_token(token: str) -> Optional[float]:
    token = token.strip().lower()
    if not token:
        return None
    token = token.replace("minus", "-").replace("neg", "-").replace("p", ".")
    try:
        return float(token)
    except ValueError:
        return None


def parse_variant_params(variant: str) -> dict:
    """Best-effort parameter extraction from a variant token."""
    lowered = variant.lower()
    out: dict = {}
    if lowered.startswith("blur"):
        for part in reversed(lowered.split("_")):
            value = _numeric_token(part)
            if value is not None:
                out["blur_sigma"] = value
                break
    elif lowered.startswith("jpeg"):
        for part in reversed(lowered.split("_")):
            value = _numeric_token(part)
            if value is not None:
                out["jpeg_q"] = int(round(value))
                break
    elif lowered.startswith("bc"):
        for part in lowered.split("_"):
            if part.startswith("b") and not part.startswith("bc"):
                value = _numeric_token(part[1:])
                if value is not None:
                    out["brightness"] = value
            elif part.startswith("c"):
                value = _numeric_token(part[1:])
                if value is not None:
                    out["contrast"] = value
    elif lowered.startswith("occ"):
        token = lowered.split("a", 1)[1] if "a" in lowered else lowered.split("_")[-1]
        value = _numeric_token(token)
        if value is not None:
            out["bbox_area_frac"] = value
    return out


def row_hmac_seed(row: Mapping[str, object], key: bytes = DEFAULT_HMAC_KEY) -> int:
    """Deterministic 64-bit seed from identity fields of a row."""
    message = "|".join(
        str(row.get(name, ""))
        for name in ("frame_path", "frame_id", "case_id", "variant", "perturbation_id")
    )
    digest = hmac.new(key, message.encode("utf-8"), hashlib.sha256).digest()
    return int.from_bytes(digest[:8], "big", signed=False)


def _row_float(row: Mapping[str, object], name: str) -> Optional[float]:
    value = row.get(name)
    if value in _UNSET:
        return None
    try:
        return float(value)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return None


class PerRowPerturber:
    """Render a row's declared perturbation onto a PIL image, deterministically."""

    def __init__(self, key: bytes = DEFAULT_HMAC_KEY) -> None:
        self.key = key

    def __call__(self, image, row: Optional[Mapping[str, object]]):
        from PIL import Image, ImageDraw, ImageEnhance, ImageFilter

        if not row:
            return image
        if not _truthy(row.get("render_in_pipeline", True)):
            return image
        variant = str(row.get("variant") or row.get("perturbation_id") or "").strip()
        if not variant or variant.lower() == "clean":
            return image
        declared_seed = row.get("rng_seed")
        if declared_seed in _UNSET:
            seed = row_hmac_seed(row, self.key)
        else:
            seed = int(declared_seed)  # type: ignore[arg-type]
        rng = random.Random(seed)
        lowered = variant.lower()
        parsed = parse_variant_params(lowered)

        if lowered.startswith("blur"):
            sigma = _row_float(row, "blur_sigma")
            if sigma is None:
                sigma = parsed.get("blur_sigma")
            if sigma is None or sigma <= 0:
                return image
            return image.filter(ImageFilter.GaussianBlur(radius=float(sigma)))

        if lowered.startswith("jpeg"):
            quality = _row_float(row, "jpeg_q")
            if quality is None:
                quality = parsed.get("jpeg_q")
            if quality is None:
                return image
            quality = max(1, min(int(round(quality)), 100))
            buffer = io.BytesIO()
            image.save(buffer, format="JPEG", quality=quality, optimize=False, subsampling=0)
            buffer.seek(0)
            degraded = Image.open(buffer)
            degraded.load()
            return degraded.convert("RGB")

        if lowered.startswith("bc"):
            brightness = _row_float(row, "brightness")
            if brightness is None:
                brightness = parsed.get("brightness")
            contrast = _row_float(row, "contrast")
            if contrast is None:
                contrast = parsed.get("contrast")
            result = image
            if brightness is not None and brightness > 0:
                result = ImageEnhance.Brightness(result).enhance(brightness)
            if contrast is not None and contrast > 0:
                result = ImageEnhance.Contrast(result).enhance(contrast)
            return result

        if lowered.startswith("occ"):
            area = _row_float(row, "bbox_area_frac")
            if area is None:
                area = parsed.get("bbox_area_frac")
            if area is None or area <= 0:
                return image
            area = min(float(area), 1.0)
            result = image.copy()
            width, height = result.size
            occ_area = max(1.0, area * width * height)
            aspect = rng.uniform(0.5, 2.0)
            occ_w = max(1, min(width, int(round(math.sqrt(occ_area * aspect)))))
            occ_h = max(1, min(height, int(round(math.sqrt(occ_area / aspect)))))
            max_x = max(0, width - occ_w)
            max_y = max(0, height - occ_h)
            x0 = rng.randint(0, max_x) if max_x > 0 else 0
            y0 = rng.randint(0, max_y) if max_y > 0 else 0
            ImageDraw.Draw(result).rectangle(
                [x0, y0, min(width, x0 + occ_w), min(height, y0 + occ_h)], fill=(0, 0, 0)
            )
            return result

        return image


def decode_frame(
    path: str | Path,
    image_size: int = 224,
    row: Optional[Mapping[str, object]] = None,
    perturber: Optional[PerRowPerturber] = None,
) -> np.ndarray:
    """Decode one frame to (H, W, 3) uint8 at the target resolution.

    Resize happens before perturbation rendering, matching the reference's
    transform order (Resize is first in the chain —
    ``transforms.py:233-245`` — and the perturber runs after the pre-tensor
    chain for val/test where augmentations are disabled).
    """
    from PIL import Image

    with Image.open(path) as img:
        rgb = img.convert("RGB")
        resized = rgb.resize((image_size, image_size), Image.BILINEAR)
        if perturber is not None:
            resized = perturber(resized, row)
        return np.asarray(resized, dtype=np.uint8)
