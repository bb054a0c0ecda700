"""On-device normalisation and train-time augmentation of uint8 image batches.

Counterpart of ``normalize_batch`` and ``augment_batch`` in
``ssl4polyp_tpu/data/augment.py``, the reference train chain
(``src/ssl4polyp/classification/data/transforms.py:233-245``)::

    ColorJitter(0.4, 0.5, 0.25, 0.01) -> GaussianBlur(k=25, sigma in [0.001, 2])
    -> RandomHorizontalFlip -> RandomVerticalFlip -> RandomRotation(180)
    -> Normalize(ImageNet)

with the JAX package's formulas: the four jitter steps in a fixed order,
ITU-R 601 grayscale, the HSV round trip, a separable 25-tap blur with edge
padding and a bilinear rotation with zero fill (no ``grid_sample``, whose
conventions differ).  It is plain torch on the batch's device, as the JAX
package runs it in XLA.  The random draw (:func:`draw_augment_params`, from
an explicit ``torch.Generator``) is split from the deterministic chain
(:func:`apply_augment`), so tests hand both sides the same parameters: the
generators of the two frameworks give different numbers.

The ImageNet statistics are copies of ``ssl4polyp_tpu/data/transforms.py``'s,
whose package imports PyYAML at import time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "AugmentParams",
    "apply_augment",
    "augment_batch",
    "draw_augment_params",
    "normalize_batch",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_BLUR_TAPS = 25  # torchvision GaussianBlur kernel_size=(25, 25)


def normalize_batch(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalised NHWC in ``dtype``, every step in ``dtype``."""
    x = images_u8.to(dtype) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=images_u8.device)
    return (x - mean) / std


class AugmentParams(NamedTuple):
    """Per-sample parameters of the chain, each (B,) on the batch's device."""

    brightness: torch.Tensor  # factor in [0.6, 1.4)
    contrast: torch.Tensor    # factor in [0.5, 1.5)
    saturation: torch.Tensor  # factor in [0.75, 1.25)
    hue: torch.Tensor         # shift in [-0.01, 0.01)
    sigma: torch.Tensor       # blur sigma in [0.001, 2.0)
    hflip: torch.Tensor       # bool, probability 0.5
    vflip: torch.Tensor       # bool, probability 0.5
    angle: torch.Tensor       # radians in [-pi, pi)


def draw_augment_params(batch: int, generator: torch.Generator) -> AugmentParams:
    """Independent parameters for each of ``batch`` samples, drawn from
    ``generator`` on its device with the JAX package's ranges."""
    device = generator.device

    def uniform(low: float, high: float) -> torch.Tensor:
        return torch.rand(batch, generator=generator, device=device) * (high - low) + low

    return AugmentParams(
        brightness=uniform(0.6, 1.4),
        contrast=uniform(0.5, 1.5),
        saturation=uniform(0.75, 1.25),
        hue=uniform(-0.01, 0.01),
        sigma=uniform(0.001, 2.0),
        hflip=torch.rand(batch, generator=generator, device=device) < 0.5,
        vflip=torch.rand(batch, generator=generator, device=device) < 0.5,
        angle=uniform(-math.pi, math.pi),
    )


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None, None]


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, matching torchvision's rgb_to_grayscale."""
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _adjust_contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = _grayscale(x).mean(dim=(1, 2), keepdim=True)[..., None]
    f = _per_sample(factor)
    return torch.clip(x * f + mean * (1.0 - f), 0.0, 1.0)


def _adjust_saturation(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    f = _per_sample(factor)
    return torch.clip(x * f + _grayscale(x)[..., None] * (1.0 - f), 0.0, 1.0)


def _adjust_hue(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The HSV round trip of the JAX ``_rgb_to_hsv`` / ``_hsv_to_rgb``."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    hue = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    hue = torch.remainder(torch.where(delta == 0, torch.zeros_like(hue), hue / 6.0), 1.0)
    sat = torch.where(maxc == 0, torch.zeros_like(delta),
                      delta / torch.where(maxc == 0, torch.ones_like(maxc), maxc))
    h = torch.remainder(hue + shift.float()[:, None, None], 1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - sat)
    q = v * (1.0 - sat * f)
    t = v * (1.0 - sat * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    choices = torch.stack([
        torch.stack([v, q, p, p, t, v]),
        torch.stack([t, v, v, q, p, p]),
        torch.stack([p, p, t, v, v, q]),
    ])  # (3 channels, 6 sectors, B, H, W)
    index = i.long()[None, None].expand(3, 1, *i.shape)
    return torch.gather(choices, 1, index)[:, 0].permute(1, 2, 3, 0)


def _blur_matrices(kernels: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size, size) matrices A such that A @ v is the blur of v along an
    axis of ``size`` with edge padding: row i holds tap t at column
    clamp(i + t - taps // 2), taps that clamp to one column summed.

    A row's taps reach its columns in tap order, so each entry is the sum of
    one run of consecutive taps: a segmented sum, which adds a segment's
    values in order on either device.  A scatter of every tap would meet at
    the clamped edge columns, which CUDA's ``scatter_add_`` sums with atomics
    in no fixed order, so the same draw would blur to other bits from run to
    run."""
    batch, taps = kernels.shape
    offsets = torch.arange(taps, device=kernels.device) - taps // 2
    columns = torch.clamp(torch.arange(size, device=kernels.device)[:, None] + offsets, 0, size - 1)
    # The taps each entry takes: integer counts, exact in any order of addition.
    lengths = torch.zeros((size, size), dtype=torch.int64, device=kernels.device)
    lengths.scatter_add_(1, columns, torch.ones_like(columns))
    sums = torch.segment_reduce(
        kernels[:, None, :].expand(batch, size, taps).reshape(batch, size * taps), "sum",
        lengths=lengths.reshape(1, size * size).expand(batch, size * size), axis=1, unsafe=True)
    return sums.reshape(batch, size, size)


def _separable_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The JAX ``_separable_blur``: per-sample normalised 25-tap Gaussians
    along H, then W, with edge padding.  Where XLA fuses the JAX package's 25
    shifted adds per axis, the port takes each axis as one batched fp32
    product with a banded matrix: the same sums, in another order."""
    half = (_BLUR_TAPS - 1) / 2.0
    positions = torch.arange(_BLUR_TAPS, dtype=torch.float32, device=x.device) - half
    kernels = torch.exp(-0.5 * torch.square(positions[None, :] / sigma.float()[:, None]))
    kernels = kernels / kernels.sum(dim=1, keepdim=True)
    B, H, W, C = x.shape
    along_h = _blur_matrices(kernels, H)
    along_w = along_h if W == H else _blur_matrices(kernels, W)
    x = torch.matmul(along_h, x.reshape(B, H, W * C)).reshape(B, H, W, C)
    x = x.transpose(1, 2).reshape(B, W, H * C)
    return torch.matmul(along_w, x).reshape(B, W, H, C).transpose(1, 2)


def _rotate_bilinear(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each sample by its angle (radians) about the image centre,
    sampling bilinearly, zero outside."""
    B, H, W, C = x.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                            torch.arange(W, dtype=torch.float32, device=x.device), indexing="ij")
    cos = torch.cos(angle.float())[:, None, None]
    sin = torch.sin(angle.float())[:, None, None]
    dy, dx = (yy - cy)[None], (xx - cx)[None]
    src_y = cos * dy - sin * dx + cy
    src_x = sin * dy + cos * dx + cx
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[..., None], (src_x - x0)[..., None]
    flat = x.reshape(B, H * W, C)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (torch.clamp(yi, 0, H - 1).long() * W + torch.clamp(xi, 0, W - 1).long())
        vals = torch.gather(flat, 1, idx.reshape(B, H * W, 1).expand(-1, -1, C))
        return vals.reshape(B, H, W, C) * valid[..., None].to(x.dtype)

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


def apply_augment(images_u8: torch.Tensor, params: AugmentParams,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The deterministic chain on a uint8 NHWC batch: fp32 throughout, the
    normalised result cast to ``dtype`` once (``augment.py:182-208``)."""
    x = images_u8.float() / 255.0
    x = torch.clip(x * _per_sample(params.brightness), 0.0, 1.0)
    x = _adjust_contrast(x, params.contrast)
    x = _adjust_saturation(x, params.saturation)
    x = _adjust_hue(x, params.hue)
    x = _separable_blur(x, params.sigma)
    x = torch.where(params.hflip[:, None, None, None], torch.flip(x, dims=(2,)), x)
    x = torch.where(params.vflip[:, None, None, None], torch.flip(x, dims=(1,)), x)
    x = _rotate_bilinear(x, params.angle)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def augment_batch(images_u8: torch.Tensor, generator: torch.Generator,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full train chain with parameters drawn from ``generator``."""
    return apply_augment(images_u8, draw_augment_params(images_u8.shape[0], generator), dtype)
