"""Plain numpy versions of ``jpeg_loader.cpp``'s scale choices and resamplers.

Written op for op in float32, as the C++ computes them (built with
``-ffp-contract=off``, so no multiply-add is fused): uint8 promoted to
float, products and sums in the source's order, ``static_cast<int>`` as
truncation toward zero, ``+ 0.5f`` before the cast or the clamp.  Given the
image that libjpeg decodes at the chosen scale (PIL's ``Image.draft`` gives
it at 1/8, 2/8, 4/8 and 8/8), :func:`resize_decoded` and
:func:`crop_decoded` give :func:`~ssl4polyp_tpu_torch.native.decode_resize`'s
and :func:`~ssl4polyp_tpu_torch.native.decode_crop_resize`'s bytes.  The
tests and ``chip_smoke.py`` hold the library to them; nothing on the
loaders' path calls them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_scale", "crop_scale", "scaled_size", "crop_box", "bilinear_resize",
           "resample_axis", "cubic_crop_resize", "resize_decoded", "crop_decoded"]

_F = np.float32


def resize_scale(width: int, height: int, out_h: int, out_w: int) -> int:
    """``decode_resize``'s N of N/8: the smallest whose decode, rounded up,
    covers the target in both dimensions (``jpeg_loader.cpp:384-391``)."""
    for num in range(1, 9):
        if (width * num + 7) // 8 >= out_w and (height * num + 7) // 8 >= out_h:
            return num
    return 8


def crop_scale(width: int, height: int, out_h: int, out_w: int, fh: float, fw: float) -> int:
    """``decode_crop_resize``'s N of N/8: the smallest whose crop, truncated,
    covers the target (``jpeg_loader.cpp:245-252``, in doubles)."""
    for num in range(1, 9):
        sw = int(float(width) * num / 8 * fw)
        sh = int(float(height) * num / 8 * fh)
        if sw >= out_w and sh >= out_h:
            return num
    return 8


def scaled_size(size: int, num: int) -> int:
    """libjpeg's output size at scale num/8 (rounded up)."""
    return (size * num + 7) // 8


def crop_box(src_h: int, src_w: int, fy: float, fx: float, fh: float,
             fw: float) -> tuple[int, int, int, int]:
    """The crop ``(sy, sx, sh, sw)`` in pixels of the scaled decode, clamped
    as ``jpeg_loader.cpp:265-276`` clamps it."""
    sy, sx = int(fy * src_h + 0.5), int(fx * src_w + 0.5)
    sh, sw = int(fh * src_h + 0.5), int(fw * src_w + 0.5)
    sy, sx, sh, sw = max(sy, 0), max(sx, 0), max(sh, 1), max(sw, 1)
    if sy + sh > src_h:
        sy = max(src_h - sh, 0)
    if sx + sw > src_w:
        sx = max(src_w - sw, 0)
    return sy, sx, min(sh, src_h), min(sw, src_w)


def bilinear_resize(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, 3) uint8 to (out_h, out_w, 3) with pixel centres
    (``jpeg_loader.cpp:38-66``)."""
    src_h, src_w = src.shape[:2]
    scale_y = _F(src_h) / _F(out_h)
    scale_x = _F(src_w) / _F(out_w)
    fy = np.maximum((np.arange(out_h).astype(_F) + _F(0.5)) * scale_y - _F(0.5), _F(0))
    fx = np.maximum((np.arange(out_w).astype(_F) + _F(0.5)) * scale_x - _F(0.5), _F(0))
    y0, x0 = fy.astype(np.int64), fx.astype(np.int64)
    y1 = np.where(y0 + 1 < src_h, y0 + 1, src_h - 1)
    x1 = np.where(x0 + 1 < src_w, x0 + 1, src_w - 1)
    wy = (fy - y0.astype(_F))[:, None, None]
    wx = (fx - x0.astype(_F))[None, :, None]
    pixels = src.astype(_F)
    p00, p01 = pixels[y0][:, x0], pixels[y0][:, x1]
    p10, p11 = pixels[y1][:, x0], pixels[y1][:, x1]
    one = _F(1)
    v = (p00 * (one - wy) * (one - wx) + p01 * (one - wy) * wx
         + p10 * wy * (one - wx) + p11 * wy * wx)
    return (v + _F(0.5)).astype(np.uint8)


def _cubic(x: np.ndarray) -> np.ndarray:
    """Catmull-Rom, a = -0.5 (``jpeg_loader.cpp:74-80``)."""
    a = _F(-0.5)
    x = np.abs(x)
    inner = ((a + _F(2)) * x - (a + _F(3))) * x * x + _F(1)
    outer = (((x - _F(5)) * x + _F(8)) * x - _F(4)) * a
    return np.where(x < _F(1), inner, np.where(x < _F(2), outer, _F(0))).astype(_F)


def resample_axis(in_size: int, in_offset: int, in_span: int,
                  out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``ResampleAxis::init`` (``jpeg_loader.cpp:90-123``): each output
    index's first tap, tap count and normalised weights, (out_size,
    max_count) with zeros past the count.  Taps clamp to the crop box."""
    scale = _F(in_span) / _F(out_size)
    filterscale = scale if scale >= _F(1) else _F(1)
    support = _F(2) * filterscale
    max_count = int(support) * 2 + 2
    box_lo, box_hi = max(in_offset, 0), min(in_offset + in_span, in_size)
    center = _F(in_offset) + (np.arange(out_size).astype(_F) + _F(0.5)) * scale
    lo = np.maximum((center - support + _F(0.5)).astype(np.int64), box_lo)
    hi = np.minimum((center + support + _F(0.5)).astype(np.int64), box_hi)
    empty = hi <= lo
    lo = np.where(empty, np.minimum(lo, box_hi - 1), lo)
    hi = np.where(empty, lo + 1, hi)
    count = hi - lo
    weights = np.zeros((out_size, max_count), dtype=_F)
    total = np.zeros((out_size,), dtype=_F)
    for k in range(max_count):
        taps = k < count
        w = _cubic(((lo + k).astype(_F) - center + _F(0.5)) / filterscale)
        weights[:, k] = np.where(taps, w, _F(0))
        total = np.where(taps, total + weights[:, k], total)
    nonzero = total != _F(0)
    weights = np.where(nonzero[:, None], weights / np.where(nonzero, total, _F(1))[:, None],
                       weights)
    return lo, count, weights.astype(_F)


def cubic_crop_resize(src: np.ndarray, sy: int, sx: int, sh: int, sw: int, out_h: int,
                      out_w: int, hflip: bool = False) -> np.ndarray:
    """Crop (sy, sx, sh, sw) out of (H, W, 3) uint8 and resize it to
    (out_h, out_w, 3) with the filter-scaled cubic, horizontal pass first,
    then the vertical pass, the clamp and the flip
    (``jpeg_loader.cpp:128-185``)."""
    src_h, src_w = src.shape[:2]
    x_lo, x_count, x_weights = resample_axis(src_w, sx, sw, out_w)
    y_lo, y_count, y_weights = resample_axis(src_h, sy, sh, out_h)
    row_lo, row_hi = int(y_lo.min()), int((y_lo + y_count).max())
    rows = src[row_lo:row_hi].astype(_F)
    mid = np.zeros((row_hi - row_lo, out_w, 3), dtype=_F)
    for k in range(x_weights.shape[1]):
        taps = (k < x_count)[None, :, None]
        term = x_weights[:, k][None, :, None] * rows[:, np.minimum(x_lo + k, src_w - 1)]
        mid = np.where(taps, mid + term, mid)
    acc = np.zeros((out_h, out_w, 3), dtype=_F)
    for k in range(y_weights.shape[1]):
        taps = (k < y_count)[:, None, None]
        term = y_weights[:, k][:, None, None] * mid[np.minimum(y_lo - row_lo + k, len(mid) - 1)]
        acc = np.where(taps, acc + term, acc)
    v = acc + _F(0.5)
    out = np.where(v <= _F(0), _F(0), np.where(v >= _F(255), _F(255), v)).astype(np.uint8)
    return out[:, ::-1].copy() if hflip else out


def resize_decoded(decoded: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``decode_resize``'s output from the image decoded at its scale."""
    if decoded.shape[:2] == (out_h, out_w):
        return decoded.copy()
    return bilinear_resize(decoded, out_h, out_w)


def crop_decoded(decoded: np.ndarray, crop_frac, out_h: int, out_w: int,
                 hflip: bool = False) -> np.ndarray:
    """``decode_crop_resize``'s output from the image decoded at its scale.

    The library decodes only the rows from the crop's first (libjpeg-turbo's
    ``jpeg_skip_scanlines``) and resamples them at row offset 0: the
    resampler's centres are float32, so the offset changes the bits."""
    fy, fx, fh, fw = (float(v) for v in crop_frac)
    src_h, src_w = decoded.shape[:2]
    sy, sx, sh, sw = crop_box(src_h, src_w, fy, fx, fh, fw)
    return cubic_crop_resize(decoded[sy:sy + sh], 0, sx, sh, sw, out_h, out_w, hflip)
