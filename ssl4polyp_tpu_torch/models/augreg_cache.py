"""AugReg checkpoint cache conventions (SUP-imnet initialisation).

Counterpart of ``ssl4polyp_tpu/models/augreg_cache.py``, copied: the cache
path that ``factory.get_imagenet_or_random_vit(pretrained_npz="auto")``
reads and the structural check of a cached export.  ``AUGREG_URL`` names the
published file only; nothing here fetches it (``scripts/fetch_augreg.py``
does, on a host with network access).  Mirrors the reference's torch-hub
cache layout (``src/ssl4polyp/models/models.py:52-55,225``).
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["AUGREG_URL", "REQUIRED_KEYS", "cache_dir", "default_path", "verify"]

AUGREG_URL = (
    "https://storage.googleapis.com/vit_models/augreg/"
    "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0--"
    "imagenet2012-steps_20k-lr_0.01-res_224.npz"
)

# Keys every big_vision ViT-B/16 export must contain (verification is
# structural: numpy loads the archive and the factory's mapping succeeds).
REQUIRED_KEYS = (
    "embedding/kernel",
    "embedding/bias",
    "cls",
    "Transformer/posembed_input/pos_embedding",
    "Transformer/encoder_norm/scale",
    "Transformer/encoderblock_0/LayerNorm_0/scale",
    "Transformer/encoderblock_11/MlpBlock_3/Dense_1/kernel",
)


def cache_dir() -> Path:
    root = os.environ.get("SSL4POLYP_TPU_CACHE")
    if root:
        return Path(root)
    return Path.home() / ".cache" / "ssl4polyp_tpu"


def default_path() -> Path:
    return cache_dir() / Path(AUGREG_URL).name


def verify(path: Path) -> None:
    import numpy as np

    archive = np.load(path)
    missing = [k for k in REQUIRED_KEYS if k not in archive]
    if missing:
        raise SystemExit(f"{path}: not an AugReg ViT-B/16 export; missing {missing}")
    kernel = archive["embedding/kernel"]
    if kernel.shape != (16, 16, 3, 768):
        raise SystemExit(f"{path}: unexpected patch-embed shape {kernel.shape}")
    print(f"OK: {path} verified ({len(archive.files)} arrays)")
