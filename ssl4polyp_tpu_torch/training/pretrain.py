"""MAE pretraining: the train step and the epoch loop.

Counterpart of ``ssl4polyp_tpu/training/pretrain.py`` (reference
``mae/main_pretrain.py`` and ``engine_pretrain.py``):

* bf16 compute with fp32 master parameters and fp32 AdamW (0.9, 0.95): the
  forward reads a compute copy (matrices in bf16, vectors the fp32 masters,
  cast at use), gradients are taken with respect to that copy and reach
  AdamW in fp32, and the copy is refreshed after the update;
* gradient accumulation over ``accum_iter`` microbatches inside one step;
* per-iteration warmup and half-cycle cosine learning rate, scaled by the
  effective batch / 256; no weight decay on biases, norms, tokens and
  position tables; learning rate 0 on the frozen sin-cos tables;
* a non-finite-loss abort and one JSON line per epoch.

The masking noise of each step comes from an explicit generator seeded from
(seed, epoch, step), so a run is a function of its settings.  Checkpoint
save and resume, SIGTERM handling and asynchronous writes are not ported yet.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.func import functional_call

from ..data.augment import normalize_batch
from ..data.folder import ImageFolderIndex, PretrainLoader
from ..models.layers import compute_copy
from ..models.mae import MAE, MAE_VIT_B16, MAEConfig
from . import optim
from .schedules import warmup_cosine

__all__ = [
    "PretrainSettings",
    "PretrainState",
    "init_pretrain_state",
    "loss_and_grads",
    "make_pretrain_step",
    "model_config",
    "run_pretraining",
]


@dataclass
class PretrainSettings:
    data_root: str = ""
    output_dir: str = "outputs/mae_pretrain"
    epochs: int = 400
    warmup_epochs: int = 40
    batch_size: int = 64  # per accumulation microbatch
    accum_iter: int = 1
    blr: float = 1e-3
    min_lr: float = 0.0
    weight_decay: float = 0.05
    mask_ratio: float = 0.75
    norm_pix_loss: bool = False
    seed: int = 0
    image_size: int = 224
    num_workers: int = 16
    log_interval: int = 20
    no_train_dir: bool = False
    device: str = "cuda"

    @property
    def effective_batch(self) -> int:
        return self.batch_size * self.accum_iter

    @property
    def absolute_lr(self) -> float:
        # blr scaled by effective batch / 256 (reference main_pretrain.py:203-204)
        return self.blr * self.effective_batch / 256.0


def model_config(settings: PretrainSettings) -> MAEConfig:
    """MAE ViT-B/16 in bf16; masked-MSE pretraining rounds the scores to bf16
    before the softmax, as the JAX recipe does.  The decoder's tokens count as
    padded to the next multiple of 8, as the JAX engine pads them with its
    kernels on (pretrain.py:134-135), which decides where the fusion knobs
    apply."""
    encoder = replace(MAE_VIT_B16.encoder, img_size=settings.image_size,
                      compute_dtype=torch.bfloat16, attention_softmax_f32=False)
    n_tokens = encoder.num_patches + 1
    return replace(MAE_VIT_B16, encoder=encoder, mask_ratio=settings.mask_ratio,
                   norm_pix_loss=settings.norm_pix_loss,
                   decoder_pad_to=-(-n_tokens // 8) * 8 if n_tokens % 8 else None)


@dataclass
class PretrainState:
    """What a step reads and updates in place."""

    model: MAE
    params: Dict[str, torch.Tensor]    # fp32 masters: the model's own parameters
    params_c: Dict[str, torch.Tensor]  # the compute copy the forward reads
    opt: optim.AdamWState
    lr_scale: Dict[str, float]
    wd_scale: Dict[str, float]


def init_pretrain_state(model: MAE) -> PretrainState:
    params = {name: p.detach() for name, p in model.named_parameters()}
    return PretrainState(
        model=model,
        params=params,
        params_c=compute_copy(params, model.cfg.encoder.compute_dtype),
        opt=optim.adamw_init(params),
        lr_scale=optim.pretrain_lr_scales(params),
        wd_scale=optim.no_weight_decay_scales(params),
    )


def _check_batch(cfg: MAEConfig, images_u8: torch.Tensor, noise: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 5 or images_u8.shape[0] < 1:
        raise ValueError(f"expected uint8 images (accum, B, H, W, 3), got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")
    if tuple(noise.shape) != (*images_u8.shape[:2], cfg.encoder.num_patches):
        raise ValueError(f"noise {tuple(noise.shape)} does not fit images "
                         f"{tuple(images_u8.shape)}")


def loss_and_grads(state: PretrainState, images_u8: torch.Tensor,
                   noise: torch.Tensor) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean loss and the mean fp32 gradients over the microbatches of
    ``images_u8`` (accum, B, H, W, 3) uint8 with ``noise`` (accum, B, L).

    Gradients are taken with respect to the compute copy; every parameter
    gets one, the frozen sin-cos tables too (their learning-rate scale is
    0), so the gradient norm counts what the JAX step's counts.
    """
    cfg = state.model.cfg
    _check_batch(cfg, images_u8, noise)
    accum = images_u8.shape[0]
    names = list(state.params_c)
    grads, loss_sum = None, None
    for micro in range(accum):
        leaves = {n: state.params_c[n].detach().requires_grad_() for n in names}
        images = normalize_batch(images_u8[micro], cfg.encoder.compute_dtype)
        loss, _, _ = functional_call(state.model, leaves, (images, noise[micro]))
        micro_grads = [g.float() for g in torch.autograd.grad(loss, list(leaves.values()))]
        if grads is None:  # the JAX step's zeros + g, without the zeros
            grads, loss_sum = micro_grads, loss.detach()
        else:
            torch._foreach_add_(grads, micro_grads)
            loss_sum = loss_sum + loss.detach()
    if accum > 1:
        torch._foreach_mul_(grads, 1.0 / accum)
        loss_sum = loss_sum * (1.0 / accum)
    return loss_sum, dict(zip(names, grads))


def make_pretrain_step(
    cfg: MAEConfig, accum_iter: int, weight_decay: float
) -> Callable[[PretrainState, torch.Tensor, torch.Tensor, float], Dict[str, torch.Tensor]]:
    """Build the train step ``(state, images_u8, noise, lr) -> {loss, grad_norm}``.

    ``images_u8`` is (accum_iter, B, H, W, 3) uint8 and ``noise`` (accum_iter,
    B, L) float, both on the model's device.  The step averages the fp32
    gradients of the microbatches (:func:`loss_and_grads`), then runs AdamW on
    the masters and refreshes the compute copy in one pass
    (``optim.adamw_update_fused``), all in place.
    """

    def step(state: PretrainState, images_u8: torch.Tensor, noise: torch.Tensor,
             lr: float) -> Dict[str, torch.Tensor]:
        if state.model.cfg != cfg or images_u8.shape[0] != accum_iter:
            raise ValueError(f"the step was built for {accum_iter} microbatches of {cfg}")
        loss, grads = loss_and_grads(state, images_u8, noise)
        grad_norm = optim.global_norm(grads)
        optim.adamw_update_fused(
            state.params, state.params_c, grads, state.opt, lr=lr, b1=0.9, b2=0.95,
            weight_decay=weight_decay, lr_scale=state.lr_scale, wd_scale=state.wd_scale,
        )
        return {"loss": loss, "grad_norm": grad_norm}

    return step


def _noise_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one step's masking noise: a hash of the whole (seed,
    epoch, step), as the JAX engine folds the epoch and then the step into
    its key, so that no two steps of a run share noise however long an
    epoch is.  ``SeedSequence``'s first 64-bit word, reduced below 2**63 for
    ``torch.Generator.manual_seed``."""
    word = np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0]
    return int(word) % (2 ** 63)


def _step_noise(seed: int, epoch: int, step: int, shape, device: torch.device) -> torch.Tensor:
    """One step's masking noise, uniform in [0, 1), from its own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_noise_seed(seed, epoch, step))
    return torch.rand(shape, generator=gen, device=device)


def run_pretraining(settings: PretrainSettings) -> Dict[str, Any]:
    """The epoch loop over an image folder; returns the last epoch's record.

    Writes one JSON line per epoch to ``<output_dir>/pretrain_log.jsonl`` and
    raises ``FloatingPointError`` on a non-finite loss.  The loader decodes
    with PIL, so the host needs it.
    """
    device = torch.device(settings.device)
    cfg = model_config(settings)
    output_dir = Path(settings.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    loader = PretrainLoader(
        ImageFolderIndex(settings.data_root, no_train_dir=settings.no_train_dir),
        batch_size=settings.effective_batch,
        image_size=settings.image_size,
        seed=settings.seed,
        num_workers=settings.num_workers,
    )
    steps_per_epoch = len(loader)
    schedule = warmup_cosine(settings.absolute_lr, steps_per_epoch * settings.epochs,
                             settings.warmup_epochs * steps_per_epoch, settings.min_lr)
    model = MAE(cfg, torch.Generator().manual_seed(settings.seed)).to(device)
    state = init_pretrain_state(model)
    train_step = make_pretrain_step(cfg, settings.accum_iter, settings.weight_decay)
    accum, micro = settings.accum_iter, settings.batch_size
    step_global = 0
    record: Dict[str, Any] = {}
    with open(output_dir / "pretrain_log.jsonl", "a") as log:
        for epoch in range(settings.epochs):
            loader.set_epoch(epoch)
            start = time.perf_counter()
            losses = []
            for it, batch in enumerate(loader):
                images = torch.from_numpy(batch.reshape(accum, micro, *batch.shape[1:])).to(device)
                noise = _step_noise(settings.seed, epoch, it,
                                    (accum, micro, cfg.encoder.num_patches), device)
                metrics = train_step(state, images, noise, schedule(step_global))
                step_global += 1
                if it % max(1, settings.log_interval) == 0:
                    loss = float(metrics["loss"])
                    if not math.isfinite(loss):
                        raise FloatingPointError(f"Loss is {loss} at step {step_global}, stopping")
                    losses.append(loss)
            record = {
                "epoch": epoch,
                "train_loss": sum(losses) / max(1, len(losses)),
                "lr": schedule(step_global),
                "epoch_time_s": time.perf_counter() - start,
            }
            log.write(json.dumps(record) + "\n")
            log.flush()
    return record
