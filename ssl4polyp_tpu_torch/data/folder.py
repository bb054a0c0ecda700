"""Unlabelled image folder for MAE pretraining.

Counterpart of ``ssl4polyp_tpu/data/folder.py``, whose package imports
PyYAML at import time.  The index is a sorted recursive listing; the loader
yields fixed-shape (B, S, S, 3) uint8 batches after a RandomResizedCrop and a
horizontal flip drawn from a numpy generator seeded per (seed, epoch,
sample), so the data stream is a function of (seed, epoch) and equals the
JAX loader's batch for batch.  JPEG frames are cropped and resized by the
native decoder (:mod:`ssl4polyp_tpu_torch.native`) unless ``use_native`` is
False (as in the JAX loader, ``SSL4POLYP_NATIVE_DECODE`` is not read here);
frames without a JPEG header, and frames it fails, are decoded with PIL,
imported where a frame is decoded.  Both paths draw the same crop and flip.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from .. import native

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

    ``B`` is this process's batch.  With ``process_count`` > 1 each process
    reads its contiguous stripe of the epoch's permutation, padded by wrap-
    around to ``process_count * ceil(n / process_count)`` (the
    DistributedSampler contract, as in the JAX loader), so that every
    process yields the same number of batches.  With ``drop_last`` the last
    short batch is dropped, otherwise padded with copies of its last frame
    (as in the JAX loader); batches are decoded ahead into a queue of
    ``prefetch_batches``.
    """

    def __init__(self, index: ImageFolderIndex, batch_size: int, *, image_size: int = 224,
                 seed: int = 0, num_workers: int = 16, prefetch_batches: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True, use_native: Optional[bool] = None) -> None:
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.epoch = 0
        # None: native when the C++ decoder builds (a decoder that cannot be
        # built raises); both paths draw the same crop and flip.
        self.use_native = use_native
        self._dims_cache: dict[int, tuple[int, int]] = {}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _order(self) -> np.ndarray:
        order = np.random.default_rng(self.seed + self.epoch).permutation(len(self.index))
        if self.process_count > 1:
            per = (len(order) + self.process_count - 1) // self.process_count
            pad = per * self.process_count - len(order)
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.process_index * per:(self.process_index + 1) * per]
        return order

    def __len__(self) -> int:
        n = len(self._order())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _rng(self, position: int) -> np.random.Generator:
        # Crop and flip are a function of (seed, epoch, sample).
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch * 7_919 + position) % (2 ** 63))

    def _decode(self, position: int) -> np.ndarray:
        from PIL import Image

        rng = self._rng(position)
        with Image.open(self.index.paths[position]) as img:
            rgb = img.convert("RGB")
            y0, x0, h, w = sample_crop_box(*rgb.size, rng)
            crop = rgb.crop((x0, y0, x0 + w, y0 + h)).resize(
                (self.image_size, self.image_size), Image.BICUBIC)
            array = np.asarray(crop, dtype=np.uint8)
        if rng.random() < 0.5:
            array = array[:, ::-1]
        return np.ascontiguousarray(array)

    def _native_enabled(self) -> bool:
        return self.use_native is not False and native.native_available()

    def _dims(self, position: int) -> Optional[tuple[int, int]]:
        cached = self._dims_cache.get(position)
        if cached is None:
            cached = native.jpeg_dims(self.index.paths[position])
            if cached is not None:
                self._dims_cache[position] = cached
        return cached

    def _native_batch(self, chunk: List[int]) -> Optional[np.ndarray]:
        """Whole-batch decode through the C++ pool (no GIL on the hot path),
        on the same rng draws as :meth:`_decode`: ``sample_crop_box`` as
        fractions of the full frame, then the flip.  Frames without a JPEG
        header and frames the decoder fails go through PIL one by one; a
        batch without any JPEG returns None (the PIL pool takes it)."""
        native_pos: List[int] = []
        pil_fallback: List[int] = []
        crops: List[tuple] = []
        flips: List[bool] = []
        for j, position in enumerate(chunk):
            dims = self._dims(position)
            if dims is None:  # non-JPEG or unreadable header
                pil_fallback.append(j)
                continue
            width, height = dims
            rng = self._rng(position)
            y0, x0, h, w = sample_crop_box(width, height, rng)
            crops.append((y0 / height, x0 / width, h / height, w / width))
            flips.append(rng.random() < 0.5)
            native_pos.append(j)
        if not native_pos:
            return None
        sub_images, ok = native.decode_crop_resize_batch_status(
            [self.index.paths[chunk[j]] for j in native_pos], self.image_size, self.image_size,
            np.asarray(crops, dtype=np.float64), np.asarray(flips, dtype=np.uint8),
            n_threads=self.num_workers)
        images = np.empty((len(chunk), self.image_size, self.image_size, 3), dtype=np.uint8)
        images[native_pos] = sub_images
        retry = pil_fallback + [native_pos[k] for k in np.flatnonzero(~ok).tolist()]
        for j in sorted(retry):
            images[j] = self._decode(chunk[j])
        return images

    def __iter__(self) -> Iterator[np.ndarray]:
        order = self._order()
        n_batches = len(self)
        if n_batches == 0:
            return
        out_queue: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        failure: list = []
        use_native = self._native_enabled()

        def producer() -> None:
            # The sentinel reaches the consumer even when a decode raises, so
            # a failed decode stops the epoch instead of hanging it.
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            break
                        chunk = order[b * self.batch_size:(b + 1) * self.batch_size].tolist()
                        images = self._native_batch(chunk) if use_native else None
                        if images is None:
                            images = np.stack(list(pool.map(self._decode, chunk)))
                        if len(images) < self.batch_size:  # the last batch, kept
                            pad = np.repeat(images[-1:], self.batch_size - len(images), axis=0)
                            images = np.concatenate([images, pad])
                        out_queue.put(images)
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
