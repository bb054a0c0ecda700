"""Unlabelled image folder for MAE pretraining.

Counterpart of ``ssl4polyp_tpu/data/folder.py``, whose package imports
PyYAML at import time.  The index is a sorted recursive listing; the loader
yields fixed-shape (B, S, S, 3) uint8 batches after a RandomResizedCrop and a
horizontal flip drawn from a numpy generator seeded per (seed, epoch,
sample), so the data stream is a function of (seed, epoch) and equals the
JAX loader's PIL path batch for batch.  Images are decoded with PIL,
imported where a frame is decoded; the JAX package's native JPEG decoder is
not ported.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List

import numpy as np

__all__ = ["ImageFolderIndex", "PretrainLoader", "sample_crop_box"]

_IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


class ImageFolderIndex:
    """Recursive index of the image files under a root (class folders ignored)."""

    def __init__(self, root: str | Path, no_train_dir: bool = False) -> None:
        base = Path(root)
        if not no_train_dir and (base / "train").is_dir():
            base = base / "train"
        self.paths: List[str] = sorted(
            str(p) for p in base.rglob("*") if p.suffix.lower() in _IMAGE_SUFFIXES
        )
        if not self.paths:
            raise FileNotFoundError(f"No images found under {base}")

    def __len__(self) -> int:
        return len(self.paths)


def sample_crop_box(
    width: int,
    height: int,
    rng: np.random.Generator,
    scale: tuple[float, float] = (0.2, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> tuple[int, int, int, int]:
    """torchvision's RandomResizedCrop box (10 tries, then a centre crop) as
    ``(y0, x0, h, w)`` in pixels."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            x0 = int(rng.integers(0, width - w + 1))
            y0 = int(rng.integers(0, height - h + 1))
            return y0, x0, h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


class PretrainLoader:
    """Yields (B, S, S, 3) uint8 crops from a thread pool, deterministically.

    The last short batch is dropped; batches are decoded ahead into a queue
    of ``prefetch_batches``.
    """

    def __init__(self, index: ImageFolderIndex, batch_size: int, *, image_size: int = 224,
                 seed: int = 0, num_workers: int = 16, prefetch_batches: int = 4) -> None:
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _order(self) -> np.ndarray:
        return np.random.default_rng(self.seed + self.epoch).permutation(len(self.index))

    def __len__(self) -> int:
        return len(self.index) // self.batch_size

    def _decode(self, position: int) -> np.ndarray:
        from PIL import Image

        # Crop and flip are a function of (seed, epoch, sample).
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch * 7_919 + position) % (2 ** 63))
        with Image.open(self.index.paths[position]) as img:
            rgb = img.convert("RGB")
            y0, x0, h, w = sample_crop_box(*rgb.size, rng)
            crop = rgb.crop((x0, y0, x0 + w, y0 + h)).resize(
                (self.image_size, self.image_size), Image.BICUBIC)
            array = np.asarray(crop, dtype=np.uint8)
        if rng.random() < 0.5:
            array = array[:, ::-1]
        return np.ascontiguousarray(array)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = self._order()
        n_batches = len(self)
        if n_batches == 0:
            return
        out_queue: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        failure: list = []

        def producer() -> None:
            # The sentinel reaches the consumer even when a decode raises, so
            # a failed decode stops the epoch instead of hanging it.
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            break
                        chunk = order[b * self.batch_size:(b + 1) * self.batch_size].tolist()
                        out_queue.put(np.stack(list(pool.map(self._decode, chunk))))
            except BaseException as exc:  # noqa: BLE001 - re-raised in the consumer
                failure.append(exc)
            finally:
                out_queue.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while (item := out_queue.get()) is not None:
                yield item
            if failure:
                raise RuntimeError("PretrainLoader producer failed") from failure[0]
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
