"""DPT dense-prediction decoder over ViT feature taps.

Counterpart of ``ssl4polyp_tpu/models/dpt.py`` (the reference's
``models/DPT_decoder.py``, used when ``dense=True``).  Structure:

* taps: block outputs {2, 5, 8, 11} of the 12-block encoder;
* readout: what to do with the cls token before reassembly — ``"ignore"``
  (drop it), ``"add"`` (broadcast-add it to every spatial token), or
  ``"project"`` (concat it to every spatial token and project 2D→D with a
  GELU linear), the reference's Slice/AddReadout/ProjectReadout;
* reassemble: per-tap 1×1 projection to [96, 192, 384, 768] channels and
  spatial rescale to {4×, 2×, 1×, ½×} of the patch grid;
* scratch: 3×3 convs onto a common 256-channel pyramid;
* fusion: residual conv units merging coarse→fine with 2× upsampling;
* head: 3×3 conv → ReLU → 1×1 conv to ``num_classes`` logits at input/2.

The JAX package computes the convolutions with ``lax.conv_general_dilated``
outside any kernel; here they are ``F.conv2d`` on channels-first maps, the
weights in torch's (cout, cin, kh, kw) layout (the JAX (kh, kw, cin, cout)
kernels carry across in :func:`.weights.dpt_state_dict_from_jax`).  As in
the JAX decoder, every conv and linear rounds its product to the compute
dtype before it adds the bias, and the decoder runs in the taps' dtype.
The bilinear resize is ``jax.image.resize``'s: separable weight matrices
built as its ``compute_weight_mat`` builds them (a triangle kernel widened
by 1/scale when downsampling, which antialiases the ½× scale; weights
renormalised where they fall off the edge), cast to the compute dtype and
contracted in one ``einsum``.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers

__all__ = ["DPT", "DPTConfig", "TAP_BLOCKS", "dpt_forward", "resize_bilinear"]

TAP_BLOCKS = (2, 5, 8, 11)


@dataclass(frozen=True)
class DPTConfig:
    embed_dim: int = 768
    num_classes: int = 2
    features: int = 256
    reassemble_channels: Tuple[int, int, int, int] = (96, 192, 384, 768)
    grid_size: int = 14  # 224 / 16
    readout: str = "ignore"  # "ignore" | "add" | "project"


@contextlib.contextmanager
def _without_tf32():
    """cuDNN's TF32 off for the duration, the process's setting restored.
    cuDNN runs an fp32 convolution in TF32 (about three decimal digits) while
    ``torch.backends.cudnn.allow_tf32`` is True, as it is in a fresh process;
    the JAX decoder's convolutions are fp32."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


class _Fp32Conv(torch.autograd.Function):
    """A SAME-padded stride-1 fp32 convolution whose forward and backward both
    run without TF32.  Autograd runs a backward later than its forward, under
    whatever the flag says then, so the backward sets the flag itself."""

    @staticmethod
    def forward(ctx, x, weight, padding: int):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        with _without_tf32():
            return F.conv2d(x, weight, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        pad = ctx.padding
        with _without_tf32():
            dx, dweight, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dweight, None


class Conv(nn.Module):
    """A SAME-padded stride-1 conv, initialised as the JAX ``_conv_init``:
    uniform in ±sqrt(6 / (kh·kw·cin + cout)), zero bias.  In fp32 the
    convolution and its gradients run without TF32 (:class:`_Fp32Conv`)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(
            layers.xavier_uniform((cout, cin, kh, kw), kh * kw * cin, cout, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, padding = self.weight.to(x.dtype), self.weight.shape[-1] // 2
        if x.dtype != torch.float32:
            out = F.conv2d(x, weight, padding=padding)
        else:
            out = _Fp32Conv.apply(x, weight, padding)
        return out + self.bias.to(x.dtype)[:, None, None]


class ResidualUnit(nn.Module):
    def __init__(self, features: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Conv(3, 3, features, features, generator)
        self.conv2 = Conv(3, 3, features, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.conv1(F.relu(x))))
        return x + h


class Fusion(nn.Module):
    def __init__(self, features: int, generator: torch.Generator):
        super().__init__()
        self.res1 = ResidualUnit(features, generator)
        self.res2 = ResidualUnit(features, generator)
        self.project = Conv(1, 1, features, features, generator)


class DPT(nn.Module):
    """The decoder's parameters, in the JAX tree's shapes and nesting
    (``reassemble.{i}.project``, ``reassemble.{i}.readout_project`` under
    ``"project"``, ``scratch.{i}``, ``fusion.{i}.{res1,res2}.{conv1,conv2}``,
    ``fusion.{i}.project``, ``head.{conv1,conv2}``), random-initialised from
    ``generator`` in the JAX ``init_dpt`` order."""

    def __init__(self, cfg: DPTConfig, generator: torch.Generator):
        super().__init__()
        if cfg.readout not in ("ignore", "add", "project"):
            raise ValueError(
                f"readout must be 'ignore', 'add', or 'project', got {cfg.readout!r}"
            )
        self.cfg = cfg
        self.reassemble = nn.ModuleList()
        self.scratch = nn.ModuleList()
        for channels in cfg.reassemble_channels:
            reassemble = nn.Module()
            reassemble.project = Conv(1, 1, cfg.embed_dim, channels, generator)
            if cfg.readout == "project":
                # Per-tap 2D -> D GELU projection of [spatial ; cls].
                reassemble.readout_project = layers.Linear(2 * cfg.embed_dim, cfg.embed_dim,
                                                           generator)
            self.reassemble.append(reassemble)
            self.scratch.append(Conv(3, 3, channels, cfg.features, generator))
        self.fusion = nn.ModuleList(Fusion(cfg.features, generator)
                                    for _ in cfg.reassemble_channels)
        self.head = nn.Module()
        self.head.conv1 = Conv(3, 3, cfg.features, cfg.features // 2, generator)
        self.head.conv2 = Conv(1, 1, cfg.features // 2, cfg.num_classes, generator)

    def forward(self, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        return dpt_forward(self, taps)


@functools.lru_cache(maxsize=None)
def _weight_mat(input_size: int, output_size: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """``jax.image.resize``'s (input, output) weights for the bilinear
    kernel with antialiasing, translation 0 (``compute_weight_mat`` in
    ``jax/_src/image/scale.py``), computed in float32 as JAX computes them,
    then cast to ``dtype`` on ``device`` once: the decoder's six resizes
    copy nothing from the host after the first call.  The tensor is made
    outside inference mode, so that a forward under autograd may save it
    after an inference forward cached it."""
    scale = np.float32(output_size / input_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(output_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    weights = np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)
    with torch.inference_mode(False):
        return torch.from_numpy(weights).to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Resize a channels-first (B, C, H, W) map by ``factor`` (rounded,
    at least 1 pixel) as ``jax.image.resize(..., "bilinear")`` resizes the
    NHWC map: the weights cast to ``x``'s dtype, one contraction."""
    _, _, H, W = x.shape
    new_h = max(1, int(round(H * factor)))
    new_w = max(1, int(round(W * factor)))
    if (new_h, new_w) == (H, W):
        return x
    wh = _weight_mat(H, new_h, x.dtype, x.device)
    ww = _weight_mat(W, new_w, x.dtype, x.device)
    return torch.einsum("bchw,hH,wW->bcHW", x, wh, ww)


def dpt_forward(dpt: DPT, taps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Decode four tapped token sequences into dense logits.

    ``taps``: four (B, 1+N, D) token tensors from encoder blocks
    ``TAP_BLOCKS`` (shallowest first).  Returns (B, H/2, W/2, num_classes)
    relative to the encoder input resolution, in the taps' dtype.
    """
    if len(taps) != 4:
        raise ValueError("DPT expects exactly four feature taps")
    cfg = dpt.cfg
    grid = cfg.grid_size
    scales = (4.0, 2.0, 1.0, 0.5)

    pyramid: List[torch.Tensor] = []
    for i, tokens in enumerate(taps):
        spatial = tokens[:, 1:, :]
        if cfg.readout == "add":
            spatial = spatial + tokens[:, :1, :]
        elif cfg.readout == "project":
            readout = tokens[:, :1, :].expand(spatial.shape)
            stacked = torch.cat([spatial, readout], dim=-1)
            p_ro = dpt.reassemble[i].readout_project
            spatial = F.gelu(layers.linear(stacked, p_ro.weight, p_ro.bias))
        B, N, D = spatial.shape
        feature = spatial.reshape(B, grid, grid, D).permute(0, 3, 1, 2)
        feature = dpt.reassemble[i].project(feature)
        feature = resize_bilinear(feature, scales[i])
        feature = dpt.scratch[i](feature)
        pyramid.append(feature)

    # fusion: start from the deepest (coarsest) tap
    x = dpt.fusion[3].res2(pyramid[3])
    x = resize_bilinear(x, 2.0)
    x = dpt.fusion[3].project(x)
    for i in (2, 1, 0):
        skip = dpt.fusion[i].res1(pyramid[i])
        x = x + skip
        x = dpt.fusion[i].res2(x)
        x = resize_bilinear(x, 2.0)
        x = dpt.fusion[i].project(x)

    x = dpt.head.conv1(x)
    x = F.relu(x)
    x = dpt.head.conv2(x)
    return x.permute(0, 2, 3, 1)
