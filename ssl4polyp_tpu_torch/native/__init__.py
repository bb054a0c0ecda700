"""Native host-side JPEG decode (C++ via ctypes), the counterpart of
``ssl4polyp_tpu/native``.

``jpeg_loader.cpp`` (the JAX package's source, near-verbatim) decodes a JPEG
at the smallest of libjpeg's DCT-domain scales N/8 that still covers the
target, then resizes it: bilinear in :func:`decode_resize`, PIL's
filter-scaled cubic on a crop in :func:`decode_crop_resize`.  The batch
entry points decode across a std::thread pool, outside the GIL.

The library builds at first use: g++ against libjpeg-turbo 2.1.5's headers
in ``third_party/libjpeg-turbo``, linked by its path to the libjpeg that
PIL's ``_imaging`` has loaded (a wheel's ``pillow.libs/libjpeg-*.so.62*`` or
a system ``libjpeg.so.62``), into::

    build/ssl4polyp_tpu_torch/<sha256 of the source, headers, flags and libjpeg>/libjpeg_loader.so

under the checkout's root (``build/`` is git-ignored; g++'s output in
``g++.log`` beside it).  Before its first use the library decodes a small
JPEG that PIL writes and must give PIL's bytes.  Where the JAX package falls
back to PIL without a word, a library that cannot be built, loaded or
checked raises ``RuntimeError`` here.  Nothing runs at import time, and PIL
is imported only where the libjpeg is looked up and checked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "native_available",
    "decode_resize_batch",
    "decode_resize_batch_status",
    "decode_resize",
    "decode_crop_resize",
    "decode_crop_resize_batch_status",
    "jpeg_dims",
    "build_library",
    "libjpeg_path",
    "decode_counts",
    "reset_decode_counts",
]

_SOURCE = Path(__file__).resolve().parent / "jpeg_loader.cpp"
_HEADERS = _SOURCE.parent / "third_party" / "libjpeg-turbo"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ssl4polyp_tpu_torch"
# -ffp-contract=off: a host whose baseline has FMA (aarch64) would otherwise
# fuse the resamplers' multiply-adds, and the JAX package's x86-64 build has
# none.  --no-undefined: a libjpeg without libjpeg's symbols fails the link.
_FLAGS = ("-O3", "-funroll-loops", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
          "-pthread", "-Wl,--no-undefined")
# A wheel's pillow.libs/libjpeg-<hash>.so.62.x.y, or a system libjpeg.so.62.x.y.
_LIBJPEG_NAME = re.compile(r"/libjpeg(-[0-9a-f]+)?\.so\.62(\.[0-9]+)*$")
_U8P = ctypes.POINTER(ctypes.c_uint8)
_DP = ctypes.POINTER(ctypes.c_double)
_PATHS = ctypes.POINTER(ctypes.c_char_p)
# (name, restype, argtypes) of every C entry point of jpeg_loader.cpp.
_ENTRY_POINTS = (
    ("decode_resize", ctypes.c_int, [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int]),
    ("decode_resize_batch", ctypes.c_int,
     [_PATHS, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    ("decode_resize_batch_status", ctypes.c_int,
     [_PATHS, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]),
    ("jpeg_dims", ctypes.c_int,
     [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]),
    ("decode_crop_resize", ctypes.c_int,
     [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int]
     + [ctypes.c_double] * 4 + [ctypes.c_int]),
    ("decode_crop_resize_batch_status", ctypes.c_int,
     [_PATHS, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, _DP, _U8P, ctypes.c_int, _U8P]),
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Frames the batch entry points decoded and failed since the last
# reset_decode_counts() (the loaders send each failed frame to PIL).
frames_decoded = 0
frames_failed = 0
_count_lock = threading.Lock()


def libjpeg_path() -> Path:
    """The libjpeg that PIL's ``_imaging`` has mapped into this process."""
    import PIL
    import PIL.Image  # noqa: F401  (loads _imaging, which links libjpeg)

    with open("/proc/self/maps", encoding="utf-8") as maps:
        mapped = {fields[5] for fields in (line.rstrip("\n").split(maxsplit=5) for line in maps)
                  if len(fields) == 6 and _LIBJPEG_NAME.search(fields[5])}
    wheel = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    ours = sorted(p for p in mapped if Path(p).parent == wheel) or sorted(mapped)
    if len(ours) != 1:
        raise RuntimeError(
            f"PIL {PIL.__version__} ({PIL.__file__}) left {len(ours)} libjpeg.so.62 "
            f"candidates mapped ({ours}): the JPEG decoder links the one PIL decodes with, "
            "and cannot tell which that is")
    return Path(ours[0])


def _library_path(libjpeg: Path) -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update(str(libjpeg).encode())
    for source in [_SOURCE, *sorted(_HEADERS.glob("*.h"))]:
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return _BUILD_ROOT / digest.hexdigest()[:16] / "libjpeg_loader.so"


def build_library(force: bool = False) -> Path:
    """Compile ``jpeg_loader.cpp`` against PIL's libjpeg; returns its path.

    A library already built from the same source, headers, flags and libjpeg
    is reused unless ``force``.  Raises ``RuntimeError`` when g++ is missing
    or fails (its output is in ``g++.log`` beside the library)."""
    libjpeg = libjpeg_path()
    target = _library_path(libjpeg)
    if target.exists() and not force:
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: the JPEG decoder cannot be built "
                           f"(libjpeg {libjpeg})")
    target.parent.mkdir(parents=True, exist_ok=True)
    # Processes that build at once each write their own file, then rename it.
    partial = target.with_suffix(f".{os.getpid()}.tmp.so")
    command = [gxx, *_FLAGS, "-I", str(_HEADERS), str(_SOURCE), str(libjpeg),
               f"-Wl,-rpath,{libjpeg.parent}", "-o", str(partial)]
    result = subprocess.run(command, capture_output=True, text=True, timeout=300)
    log = target.parent / "g++.log"
    log_partial = log.with_suffix(f".{os.getpid()}.tmp")
    log_partial.write_text(" ".join(command) + "\n" + result.stdout + result.stderr)
    os.replace(log_partial, log)
    if result.returncode:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the JPEG decoder against libjpeg {libjpeg} "
                           f"(exit {result.returncode}; {log}):\n{result.stderr[-2000:]}")
    os.replace(partial, target)
    return target


def _check(lib: ctypes.CDLL, libjpeg: Path) -> None:
    """Decode a small JPEG that PIL writes at its own size (scale 8/8, no
    resize) and require PIL's bytes: a libjpeg of another ABI refuses every
    frame, which the loaders would otherwise send to PIL one by one."""
    from PIL import Image

    pixels = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "check.jpg"
        Image.fromarray(pixels).save(path, quality=90)
        with Image.open(path) as img:
            want = np.asarray(img.convert("RGB"), dtype=np.uint8)
        got = np.zeros_like(want)
        status = lib.decode_resize(os.fsencode(path), got.ctypes.data_as(_U8P), *want.shape[:2])
    if status != 0 or not np.array_equal(got, want):
        raise RuntimeError(
            f"the JPEG decoder linked to libjpeg {libjpeg} fails its first-use check: status "
            f"{status} on a 40x24 JPEG that PIL decodes, "
            f"{int((got != want).sum())} of {want.size} bytes unlike PIL's (a libjpeg of "
            "another ABI than libjpeg-turbo's 62 refuses every frame)")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            libjpeg = libjpeg_path()
            library = build_library()
            try:
                lib = ctypes.CDLL(str(library))
            except OSError as exc:
                raise RuntimeError(f"the JPEG decoder {library} (libjpeg {libjpeg}) does not "
                                   f"load: {exc}") from exc
            for name, restype, argtypes in _ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _check(lib, libjpeg)
            _lib = lib
    return _lib


def native_available() -> bool:
    """True once the library is built, loaded and checked; raises
    ``RuntimeError`` when it cannot be (no loader falls back to PIL for it)."""
    return _load() is not None


def decode_counts() -> dict[str, int]:
    """Frames the batch entry points decoded and failed since the last
    :func:`reset_decode_counts`."""
    return {"decoded": frames_decoded, "failed": frames_failed}


def reset_decode_counts() -> None:
    global frames_decoded, frames_failed
    with _count_lock:
        frames_decoded = frames_failed = 0


def _count(ok: np.ndarray) -> None:
    global frames_decoded, frames_failed
    with _count_lock:
        frames_decoded += int(ok.sum())
        frames_failed += int(ok.size - ok.sum())


def _paths(paths: Sequence[str | os.PathLike]):
    encoded = [os.fsencode(p) for p in paths]
    return (ctypes.c_char_p * len(encoded))(*encoded)


def _batch_out(out: Optional[np.ndarray], n: int, out_h: int, out_w: int) -> np.ndarray:
    if out is None:
        return np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    if out.shape != (n, out_h, out_w, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {(n, out_h, out_w, 3)}, "
                         f"not {out.dtype} {out.shape}")
    return out


def decode_resize(path: str | os.PathLike, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """Decode one JPEG to (out_h, out_w, 3) uint8; None when the frame fails."""
    lib = _load()
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    status = lib.decode_resize(os.fsencode(path), out.ctypes.data_as(_U8P), out_h, out_w)
    return out if status == 0 else None


def decode_resize_batch(
    paths: Sequence[str | os.PathLike],
    out_h: int,
    out_w: int,
    n_threads: int = 8,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decode a batch into (n, out_h, out_w, 3) uint8; failed frames are
    zero-filled.  Use :func:`decode_resize_batch_status` when the caller
    needs to know which frames failed."""
    return decode_resize_batch_status(paths, out_h, out_w, n_threads, out)[0]


def decode_resize_batch_status(
    paths: Sequence[str | os.PathLike],
    out_h: int,
    out_w: int,
    n_threads: int = 8,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch; returns ``(images, ok)`` where ``ok`` is a per-frame
    bool array (False = decode failed, frame zero-filled)."""
    lib = _load()
    n = len(paths)
    out = _batch_out(out, n, out_h, out_w)
    status = np.zeros((n,), dtype=np.uint8)
    lib.decode_resize_batch_status(_paths(paths), n, out.ctypes.data_as(_U8P), out_h, out_w,
                                   int(n_threads), status.ctypes.data_as(_U8P))
    ok = status.astype(bool)
    _count(ok)
    return out, ok


def jpeg_dims(path: str | os.PathLike) -> Optional[tuple[int, int]]:
    """(width, height) from the JPEG header only; None when it cannot be read."""
    lib = _load()
    width = ctypes.c_int()
    height = ctypes.c_int()
    if lib.jpeg_dims(os.fsencode(path), ctypes.byref(width), ctypes.byref(height)) != 0:
        return None
    return int(width.value), int(height.value)


def decode_crop_resize(
    path: str | os.PathLike,
    out_h: int,
    out_w: int,
    crop_frac: Sequence[float],
    hflip: bool = False,
) -> Optional[np.ndarray]:
    """Random-resized-crop decode of one frame.

    ``crop_frac`` = (fy, fx, fh, fw) fractions of the FULL image.  Decodes
    at the smallest DCT scale covering the scaled crop, skips rows outside
    it, cubic-resizes to (out_h, out_w, 3); None when the frame fails.
    """
    lib = _load()
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    fy, fx, fh, fw = (float(v) for v in crop_frac)
    status = lib.decode_crop_resize(os.fsencode(path), out.ctypes.data_as(_U8P), out_h, out_w,
                                    fy, fx, fh, fw, int(bool(hflip)))
    return out if status == 0 else None


def decode_crop_resize_batch_status(
    paths: Sequence[str | os.PathLike],
    out_h: int,
    out_w: int,
    crops: np.ndarray,
    hflips: np.ndarray,
    n_threads: int = 8,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched random-resized-crop decode into (n, out_h, out_w, 3) uint8.

    ``crops``: (n, 4) float64 [fy, fx, fh, fw] fractions; ``hflips``: (n,)
    bools.  Returns ``(images, ok)``; failed frames are zero-filled with
    ``ok=False``.
    """
    lib = _load()
    n = len(paths)
    crops = np.ascontiguousarray(crops, dtype=np.float64)
    flips = np.ascontiguousarray(hflips, dtype=np.uint8)
    if crops.shape != (n, 4) or flips.shape != (n,):
        raise ValueError(f"crops {crops.shape} / hflips {flips.shape} for n={n}")
    out = _batch_out(out, n, out_h, out_w)
    status = np.zeros((n,), dtype=np.uint8)
    lib.decode_crop_resize_batch_status(
        _paths(paths), n, out.ctypes.data_as(_U8P), out_h, out_w,
        crops.ctypes.data_as(_DP), flips.ctypes.data_as(_U8P), int(n_threads),
        status.ctypes.data_as(_U8P))
    ok = status.astype(bool)
    _count(ok)
    return out, ok
