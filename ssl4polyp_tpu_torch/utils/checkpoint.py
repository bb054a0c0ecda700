"""Checkpoint files with retention, pointers and resume metadata.

The port's copy of ``ssl4polyp_tpu/utils/checkpoint.py``, reading and writing
the same files without jax or flax: one msgpack document (the codec is
:mod:`.msgpack`, byte for byte what flax's serializer writes) holds
``{"payload": dict of arrays, "meta": JSON-safe dict}``; a ``.json`` sidecar
mirrors ``meta``; a pointer names the newest checkpoint; retention keeps the
last K checkpoints plus every-N-epoch milestones.  A file written by either
package is read by the other.

Where the JAX code asks ``is_primary()`` of its multi-host runtime, the
functions here take ``primary: bool = True``: a caller that runs one process
per GPU passes ``rank == 0``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import msgpack

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_checkpoint_meta",
    "update_pointer",
    "cleanup_checkpoints",
    "AsyncCheckpointer",
]

# Test hook: seconds to sleep between writing the .tmp file and the atomic
# rename (lets crash-safety tests kill the process mid-save).
_WRITE_DELAY_S = 0.0


def _to_numpy(tree: Any, copy: bool = False) -> Any:
    """Host-numpy snapshot of a tree of dicts, lists and arrays (torch
    tensors on any device included).  ``copy=True`` guarantees that the
    result aliases no caller memory, which the async writer needs: its caller
    goes on updating the source tensors in place."""
    if isinstance(tree, dict):
        return {key: _to_numpy(value, copy) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(item, copy) for item in tree]
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):  # a torch tensor
        tree = tree.detach().cpu().numpy()  # shares memory with a CPU tensor
        return tree.copy() if copy else tree
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        array = np.asarray(tree)
        if copy and (array is tree or array.base is not None or not array.flags["OWNDATA"]):
            array = array.copy()
        return array
    return tree


def _write_checkpoint_file(path: Path, snapshot: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Serialize, write and rename atomically.  ``snapshot`` is host numpy
    already (no device handles: safe off the main thread)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    data = msgpack.packb({"payload": snapshot, "meta": meta})
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    if _WRITE_DELAY_S:
        time.sleep(_WRITE_DELAY_S)
    tmp.replace(path)  # atomic on POSIX: a crash mid-save keeps the old file
    sidecar = path.with_suffix(path.suffix + ".json")
    try:
        sidecar.write_text(json.dumps(meta, indent=2, default=str), encoding="utf-8")
    except TypeError:
        pass


def save_checkpoint(path: str | Path, payload: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None, *, primary: bool = True) -> Path:
    """Serialise ``payload`` (trees of arrays or tensors and JSON-safe
    leaves) to ``path``.  Only the primary process writes; the others return
    the path untouched."""
    path = Path(path)
    if not primary:
        return path
    _write_checkpoint_file(path, _to_numpy(payload), meta or {})
    return path


class AsyncCheckpointer:
    """Overlap checkpoint writes with the next epoch's compute.

    * **synchronous** (caller's thread): the device-to-host snapshot of every
      leaf.  It completes before :meth:`save` returns, because the train
      steps update parameters and moments in place.
    * **asynchronous** (one background thread, at most one write in flight):
      serialization, the .tmp write, the atomic rename, then the optional
      pointer update and retention cleanup, all pure host I/O.

    A crash mid-write leaves the previous checkpoint and pointer intact (the
    rename is the commit point).  Exceptions from the writer thread re-raise
    on the next :meth:`save` or :meth:`wait`.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # serialize+write time of the last completed async save (telemetry)
        self.last_write_seconds: Optional[float] = None
        self.last_snapshot_seconds: Optional[float] = None

    def wait(self) -> None:
        """Join the in-flight write (call before load or exit)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(
        self,
        path: str | Path,
        payload: Dict[str, Any],
        meta: Optional[Dict[str, Any]] = None,
        *,
        pointer: Optional[str | Path] = None,
        cleanup: Optional[Callable[[], Any]] = None,
        primary: bool = True,
    ) -> Path:
        """Snapshot now, write in the background; returns right after the
        host snapshot.  ``pointer`` and ``cleanup`` run on the writer thread
        AFTER the atomic rename, so observers never see a pointer to a
        missing or partial file."""
        path = Path(path)
        if not primary:
            return path
        self.wait()  # at most one write in flight; surfaces prior errors
        t0 = time.perf_counter()
        snapshot = _to_numpy(payload, copy=True)
        self.last_snapshot_seconds = time.perf_counter() - t0
        meta_copy = dict(meta or {})

        def _run() -> None:
            try:
                w0 = time.perf_counter()
                _write_checkpoint_file(path, snapshot, meta_copy)
                if pointer is not None:
                    update_pointer(pointer, path)
                if cleanup is not None:
                    cleanup()
                self.last_write_seconds = time.perf_counter() - w0
            except BaseException as exc:  # noqa: BLE001 - re-raised on wait()
                self._error = exc

        self._thread = threading.Thread(target=_run, name="async-checkpoint", daemon=True)
        self._thread.start()
        return path


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """Load a checkpoint; returns ``{"payload": ..., "meta": ...}`` with numpy leaves."""
    return msgpack.unpackb(Path(path).read_bytes())


def load_checkpoint_meta(path: str | Path) -> Dict[str, Any]:
    sidecar = Path(path).with_suffix(Path(path).suffix + ".json")
    if sidecar.exists():
        return json.loads(sidecar.read_text(encoding="utf-8"))
    return load_checkpoint(path).get("meta", {})


def update_pointer(pointer: str | Path, target: str | Path, *, primary: bool = True) -> None:
    """Point ``pointer`` at ``target`` (symlink, copy fallback; primary only).

    The new pointer is made under a temporary name and moved over the old one
    with ``os.replace``: a reader, or a crash, never finds the pointer
    missing between an unlink and a symlink."""
    if not primary:
        return
    pointer = Path(pointer)
    target = Path(target)
    tmp = pointer.with_name(f"{pointer.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.unlink(missing_ok=True)
    try:
        tmp.symlink_to(target.name if target.parent == pointer.parent else target)
    except OSError:
        shutil.copy2(target, tmp)
    os.replace(tmp, pointer)


def cleanup_checkpoints(
    directory: str | Path,
    pattern: str = r"checkpoint-(\d+)\.ckpt",
    keep_last: int = 2,
    keep_every_n_epochs: Optional[int] = None,
    *,
    primary: bool = True,
) -> List[Path]:
    """Delete stale epoch checkpoints (primary only); returns removed paths."""
    if not primary:
        return []
    directory = Path(directory)
    matcher = re.compile(pattern)
    found: List[tuple[int, Path]] = []
    for item in directory.iterdir() if directory.exists() else []:
        match = matcher.fullmatch(item.name)
        if match:
            found.append((int(match.group(1)), item))
    found.sort()
    keep: set[Path] = {p for _, p in found[-keep_last:]} if keep_last else set()
    if keep_every_n_epochs:
        # Milestones on COMPLETED-epoch counts: the pretrain engine saves
        # when (epoch+1) % save_freq == 0 (epochs 19, 39, ...), so the
        # milestone filter uses the same 1-based convention.
        keep.update(p for epoch, p in found if (epoch + 1) % keep_every_n_epochs == 0)
    removed: List[Path] = []
    for _, item in found:
        if item not in keep:
            item.unlink(missing_ok=True)
            sidecar = item.with_suffix(item.suffix + ".json")
            sidecar.unlink(missing_ok=True)
            removed.append(item)
    return removed
