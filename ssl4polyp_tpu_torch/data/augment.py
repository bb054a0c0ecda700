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

The batch regularisers of the upstream MAE fine-tune recipe (timm's
label smoothing, batch-mode Mixup/CutMix and RandomErasing; JAX
``augment.py:212-352``) take the same split: :func:`draw_mixup_params` draws
the batch's scalars on the host from a numpy generator, as timm's ``Mixup``
draws them (``torch.distributions.Beta`` takes no generator), and
:func:`draw_erasing_params` the per-sample boxes and their noise from a
``torch.Generator``; :func:`apply_mixup_cutmix` and
:func:`apply_random_erasing` are deterministic, with box masks built from
iotas (no loop over samples, no scatter).

The ImageNet statistics are copies of ``ssl4polyp_tpu/data/transforms.py``'s,
whose package imports PyYAML at import time.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "AugmentParams",
    "ErasingParams",
    "MixupParams",
    "apply_augment",
    "apply_mixup_cutmix",
    "apply_random_erasing",
    "augment_batch",
    "draw_augment_params",
    "draw_erasing_params",
    "draw_mixup_params",
    "mixup_cutmix_batch",
    "normalize_batch",
    "random_erasing",
    "smooth_one_hot",
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


# ---------------------------------------------------------------------------
# Batch-level regularisers of the upstream MAE fine-tune recipe (reference
# ``models/mae/main_finetune.py:87-112``: timm's Mixup/CutMix and
# RandomErasing knobs; JAX ``augment.py:212-352``).
# ---------------------------------------------------------------------------

def smooth_one_hot(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    """Label-smoothed one-hot fp32 targets (timm's ``Mixup`` smooths inside
    its label transform; reference ``main_finetune.py:87-88``)."""
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


class MixupParams(NamedTuple):
    """One batch's Mixup/CutMix draw: host scalars, fp32 where JAX's are."""

    apply: bool             # Bernoulli(prob)
    use_cutmix: bool        # Bernoulli(switch_prob) when both alphas are on
    lam_mix: np.float32     # Beta(mixup_alpha, mixup_alpha), 1 when mixup is off
    lam_cut: np.float32     # Beta(cutmix_alpha, cutmix_alpha), 1 when cutmix is off
    cy: int                 # the box centre, uniform over the rows
    cx: int                 # and the columns


def draw_mixup_params(rng: np.random.Generator, height: int, width: int, *,
                      mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0, prob: float = 1.0,
                      switch_prob: float = 0.5) -> MixupParams:
    """The batch's scalars from ``rng``, with the JAX ``mixup_cutmix_batch``'s
    distributions: each one drawn whether or not it is used."""
    apply = bool(rng.random() < prob)
    switch = bool(rng.random() < switch_prob)
    lam_mix = np.float32(rng.beta(mixup_alpha, mixup_alpha) if mixup_alpha > 0.0 else 1.0)
    lam_cut = np.float32(rng.beta(cutmix_alpha, cutmix_alpha) if cutmix_alpha > 0.0 else 1.0)
    cy, cx = int(rng.integers(0, height)), int(rng.integers(0, width))
    use_cutmix = switch if (mixup_alpha > 0.0 and cutmix_alpha > 0.0) else cutmix_alpha > 0.0
    return MixupParams(apply, use_cutmix, lam_mix, lam_cut, cy, cx)


def _box_mask(height: int, width: int, lam: np.float32, cy: int, cx: int,
              device: torch.device) -> Tuple[torch.Tensor, np.float32]:
    """(mask (H, W), corrected lambda): a box of area ratio about 1 - lam
    centred at (cy, cx), clipped at the borders (timm's ``rand_bbox``), with
    the JAX ``_box_mask``'s arithmetic: int32 cut sizes from an fp32
    sqrt(1 - lam), and lambda corrected to the clipped box in fp32."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(height) * ratio)
    cut_w = int(np.float32(width) * ratio)
    y0, y1 = min(max(cy - cut_h // 2, 0), height), min(max(cy + cut_h // 2, 0), height)
    x0, x1 = min(max(cx - cut_w // 2, 0), width), min(max(cx + cut_w // 2, 0), width)
    rows = torch.arange(height, device=device)[:, None]
    cols = torch.arange(width, device=device)[None, :]
    mask = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    corrected = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) / np.float32(height * width)
    return mask, corrected


def apply_mixup_cutmix(images: torch.Tensor, targets: torch.Tensor, params: MixupParams,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-mode Mixup or CutMix of an NHWC batch with ``params``: one lambda
    for the batch, each row paired with its partner in the reversed batch.

    The images come back in fp32, as JAX's fp32 lambda promotes them
    (``augment.py:289-298``): the model casts them to its compute dtype once.
    ``targets`` are soft (fp32).  Rows whose partner is not ``valid`` keep
    their own pixels and targets."""
    x = images.float()
    if not params.apply:
        return x, targets
    flipped = torch.flip(x, dims=(0,))
    flipped_targets = torch.flip(targets, dims=(0,))
    if params.use_cutmix:
        box, lam = _box_mask(x.shape[1], x.shape[2], params.lam_cut, params.cy, params.cx,
                             x.device)
        mixed = torch.where(box[None, :, :, None], flipped, x)
    else:
        lam = np.float32(params.lam_mix)
        mixed = float(lam) * x + float(np.float32(1.0) - lam) * flipped
    mixed_targets = float(lam) * targets + float(np.float32(1.0) - lam) * flipped_targets
    if valid is not None:
        pair_ok = (valid & torch.flip(valid, dims=(0,)))[:, None]
        mixed_targets = torch.where(pair_ok, mixed_targets, targets)
        mixed = torch.where(pair_ok[:, :, None, None], mixed, x)
    return mixed, mixed_targets


def mixup_cutmix_batch(images: torch.Tensor, targets: torch.Tensor, rng: np.random.Generator,
                       *, mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
                       prob: float = 1.0, switch_prob: float = 0.5,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``mixup_cutmix_batch`` with a numpy generator for its key:
    the batch unchanged when both alphas are off, else a draw and
    :func:`apply_mixup_cutmix`."""
    if mixup_alpha <= 0.0 and cutmix_alpha <= 0.0:
        return images, targets
    params = draw_mixup_params(rng, images.shape[1], images.shape[2], mixup_alpha=mixup_alpha,
                               cutmix_alpha=cutmix_alpha, prob=prob, switch_prob=switch_prob)
    return apply_mixup_cutmix(images, targets, params, valid)


class ErasingParams(NamedTuple):
    """Per-sample RandomErasing draws on the batch's device: B samples, each
    with ``count`` boxes."""

    do: torch.Tensor         # (B,) bool, Bernoulli(prob)
    area: torch.Tensor       # (B, count) fp32, the box's area fraction in [scale)
    log_ratio: torch.Tensor  # (B, count) fp32, log aspect ratio in [log ratio)
    y0: torch.Tensor         # (B, count) int64, top row in [0, H)
    x0: torch.Tensor         # (B, count) int64, left column in [0, W)
    noise: torch.Tensor      # (count, B, H, W, C) unit normal in the images' dtype


def draw_erasing_params(shape: Tuple[int, int, int, int], generator: torch.Generator, *,
                        prob: float = 0.25, scale: Tuple[float, float] = (0.02, 1.0 / 3.0),
                        ratio: Tuple[float, float] = (0.3, 10.0 / 3.0), count: int = 1,
                        dtype: torch.dtype = torch.float32) -> ErasingParams:
    """Draws for a (B, H, W, C) batch from ``generator``, on its device, with
    the JAX ``random_erasing``'s ranges."""
    b, h, w, c = shape
    device = generator.device

    def uniform(low: float, high: float) -> torch.Tensor:
        return torch.rand((b, count), generator=generator, device=device) * (high - low) + low

    do = torch.rand(b, generator=generator, device=device) < prob
    area = uniform(scale[0], scale[1])
    log_ratio = uniform(math.log(ratio[0]), math.log(ratio[1]))
    y0 = torch.randint(0, h, (b, count), generator=generator, device=device)
    x0 = torch.randint(0, w, (b, count), generator=generator, device=device)
    noise = torch.randn((count, b, h, w, c), generator=generator, device=device, dtype=dtype)
    return ErasingParams(do, area, log_ratio, y0, x0, noise)


def apply_random_erasing(images: torch.Tensor, params: ErasingParams) -> torch.Tensor:
    """RandomErasing in ``pixel`` mode with ``params``: each sample drawn to
    erase gets its boxes, in order, filled with its noise (the JAX
    ``random_erasing``'s boxes, clipped at the borders where timm
    rejection-samples).  Each box's mask is built from iotas over (B, H, W)."""
    b, h, w, _ = images.shape
    area = params.area * h * w
    aspect = torch.exp(params.log_ratio)
    eh = torch.clamp(torch.sqrt(area * aspect).to(torch.int32), 1, h)
    ew = torch.clamp(torch.sqrt(area / aspect).to(torch.int32), 1, w)
    rows = torch.arange(h, device=images.device)[None, :, None]
    cols = torch.arange(w, device=images.device)[None, None, :]
    out = images
    for i in range(params.area.shape[1]):
        y0, x0 = params.y0[:, i, None, None], params.x0[:, i, None, None]
        box = (params.do[:, None, None] & (rows >= y0) & (rows < y0 + eh[:, i, None, None])
               & (cols >= x0) & (cols < x0 + ew[:, i, None, None]))
        out = torch.where(box[..., None], params.noise[i], out)
    return out


def random_erasing(images: torch.Tensor, generator: torch.Generator, *, prob: float = 0.25,
                   scale: Tuple[float, float] = (0.02, 1.0 / 3.0),
                   ratio: Tuple[float, float] = (0.3, 10.0 / 3.0),
                   count: int = 1) -> torch.Tensor:
    """The JAX ``random_erasing`` with a ``torch.Generator`` for its key: the
    batch unchanged when ``prob`` or ``count`` is 0, else a draw and
    :func:`apply_random_erasing`."""
    if prob <= 0.0 or count <= 0:
        return images
    params = draw_erasing_params(tuple(images.shape), generator, prob=prob, scale=scale,
                                 ratio=ratio, count=count, dtype=images.dtype)
    return apply_random_erasing(images, params)
