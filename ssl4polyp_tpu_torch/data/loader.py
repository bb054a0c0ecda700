"""Threaded host data loader producing fixed-shape uint8 numpy batches.

The port's copy of ``ssl4polyp_tpu/data/loader.py``, batch for batch the
same (it stands where the reference has torch's ``DataLoader`` +
``DistributedSampler``, ``packs.py:319-394``).  Frames decode through the
native libjpeg decoder (:mod:`ssl4polyp_tpu_torch.native`, as in the JAX
package) unless a perturber is set, a pack's first 16 frames are not all
JPEGs, ``use_native=False`` or ``SSL4POLYP_NATIVE_DECODE=0``; then through
PIL, as does each frame the native decoder fails.

* deterministic seeded epoch shuffling — the permutation is a pure function
  of ``(seed, epoch)``, so data order is fully reproducible and resume only
  needs ``(seed, epoch, step)``;
* per-host sharding by contiguous stripes of the permuted order (each
  process reads a disjoint subset; devices within a process receive the
  batch split along the data mesh axis downstream);
* fixed batch shapes: the final partial batch is padded and accompanied by
  a ``valid`` mask, so every step has identical shapes (instead of torch's
  ragged last batch);
* a thread pool decodes frames (PIL releases the GIL in its C codecs) and a
  small prefetch queue keeps the accelerator fed.

Yields dicts of numpy arrays: ``image`` (B, H, W, 3) uint8, ``label`` (B,)
int32, ``valid`` (B,) bool, ``index`` (B,) int32 (positions into the
:class:`~ssl4polyp_tpu_torch.data.packs.PackIndex` for metadata joins).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from .. import native
from .packs import PackIndex
from .transforms import PerRowPerturber, decode_frame

__all__ = ["HostDataLoader"]


class HostDataLoader:
    def __init__(
        self,
        index: PackIndex,
        batch_size: int,
        *,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        use_native: Optional[bool] = None,
    ) -> None:
        self.index = index
        self.batch_size = int(batch_size)
        self.shuffle = (index.stage == "train") if shuffle is None else bool(shuffle)
        self.seed = int(seed)
        self.num_workers = max(1, int(num_workers))
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

        if drop_last is None:
            drop_last = index.stage == "train"
        # Safety for tiny packs (reference packs.py:325-353): never drop the
        # only batch.
        per_process = len(index) // max(1, process_count)
        if drop_last and per_process < self.batch_size:
            drop_last = False
        self.drop_last = drop_last

        self._perturber = (
            PerRowPerturber(index.hmac_key) if index.perturbations_enabled else None
        )

        # Native batch JPEG decode (C++/libjpeg, DCT-domain downscale) when
        # no per-row perturbation rendering is needed; disable with
        # SSL4POLYP_NATIVE_DECODE=0.  A decoder that cannot be built raises.
        if use_native is None:
            use_native = os.environ.get("SSL4POLYP_NATIVE_DECODE", "1") != "0"
        self._use_native = (
            bool(use_native) and self._perturber is None
            and all(str(p).lower().endswith((".jpg", ".jpeg")) for p in index.paths[:16])
            and native.native_available()
        )

    # ------------------------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _epoch_order(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-process (positions, real) for this epoch.

        The global permuted order is padded with wrap-around duplicates up to
        ``process_count * ceil(n / process_count)`` (the DistributedSampler
        contract — reference ``packs.py:356-364``) so every process yields the
        SAME number of batches and multi-host SPMD dispatch stays in lockstep.
        Padded duplicates are flagged ``real=False`` and surface as
        ``valid=False`` rows, so losses/metrics never double-count them.
        """
        n = len(self.index)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        real = np.ones((n,), dtype=bool)
        if self.process_count > 1:
            per = (n + self.process_count - 1) // self.process_count
            pad = per * self.process_count - n
            if pad:
                order = np.concatenate([order, order[:pad]])
                real = np.concatenate([real, np.zeros((pad,), dtype=bool)])
            start = self.process_index * per
            order = order[start : start + per]
            real = real[start : start + per]
        return order.astype(np.int64), real

    def __len__(self) -> int:
        n = len(self._epoch_order()[0])
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _decode(self, position: int) -> Optional[np.ndarray]:
        row = self.index.meta[position] if position < len(self.index.meta) else None
        try:
            return decode_frame(
                self.index.paths[position],
                image_size=self.index.image_size,
                row=row,
                perturber=self._perturber,
            )
        except Exception:
            return None  # corrupt/missing frame → valid=False slot

    def _assemble(
        self,
        positions: np.ndarray,
        real: np.ndarray,
        pool: ThreadPoolExecutor,
    ) -> Dict[str, np.ndarray]:
        B = self.batch_size
        size = self.index.image_size
        batch_images = np.zeros((B, size, size, 3), dtype=np.uint8)
        batch_labels = np.zeros((B,), dtype=np.int32)
        batch_valid = np.zeros((B,), dtype=bool)
        batch_index = np.full((B,), -1, dtype=np.int32)
        decode_ok = np.ones((len(positions),), dtype=bool)

        if self._use_native:
            paths = [self.index.paths[int(p)] for p in positions]
            _, decode_ok = native.decode_resize_batch_status(
                paths, size, size, n_threads=self.num_workers,
                out=batch_images[: len(positions)],
            )
            # Native decode is JPEG-only; retry failures through PIL, which
            # handles other container formats and raises precise errors.
            for slot in np.flatnonzero(~decode_ok):
                image = self._decode(int(positions[slot]))
                if image is not None:
                    batch_images[slot] = image
                    decode_ok[slot] = True
        else:
            images = list(pool.map(self._decode, [int(p) for p in positions]))
            for slot, image in enumerate(images):
                if image is None:
                    decode_ok[slot] = False
                else:
                    batch_images[slot] = image

        for slot, position in enumerate(positions):
            if self.index.labels is not None:
                batch_labels[slot] = self.index.labels[int(position)]
            batch_valid[slot] = bool(real[slot]) and bool(decode_ok[slot])
            batch_index[slot] = int(position)
        return {
            "image": batch_images,
            "label": batch_labels,
            "valid": batch_valid,
            "index": batch_index,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order, real = self._epoch_order()
        n_batches = len(self)
        if n_batches == 0:
            return
        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        failure: list = []

        def producer() -> None:
            # The sentinel (or the failure record) MUST reach the consumer
            # even when batch assembly raises, or the consumer blocks on
            # out_queue.get() forever.
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            break
                        lo, hi = b * self.batch_size, (b + 1) * self.batch_size
                        out_queue.put(self._assemble(order[lo:hi], real[lo:hi], pool))
            except BaseException as exc:  # noqa: BLE001 - re-raised in consumer
                failure.append(exc)
            finally:
                out_queue.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is None:
                    if failure:
                        raise RuntimeError(
                            "HostDataLoader producer failed"
                        ) from failure[0]
                    break
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while thread.is_alive():
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
