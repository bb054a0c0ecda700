"""Upstream-MAE style fine-tune and linear-probe engines.

Counterpart of ``ssl4polyp_tpu/training/mae_finetune.py``.  The reference
vendors the upstream MAE fine-tuning path beside its own
(``models/mae/main_finetune.py``: AdamW with layer-wise LR decay, label
smoothing, Mixup/CutMix and RandomErasing; ``main_linprobe.py``: LARS over a
frozen encoder).  The study's experiments use the classification engine;
these ship for parity:

* :func:`run_mae_finetune`: full fine-tune with
  ``optim.layerwise_lr_decay_scales`` (decay 0.75 upstream) on the AdamW
  kernel, one learning-rate scale a tensor;
* :func:`run_linear_probe`: LARS on the head over the frozen encoder.

Both read the classifier and never write it: the fp32 masters are clones of
its parameters, and the forward reads a compute copy of them through
``torch.func.functional_call``, so a probe and a fine-tune can start from
the same pretrained weights one after the other.  Each step reseeds its
draws from ``utils/determinism.py::step_seed(seed, epoch, step)``: the
augmentation and the erasing from a ``torch.Generator`` on the device, the
batch's Mixup/CutMix scalars from a numpy generator on the host (as timm
draws them).  Every ``log_interval`` steps of an epoch the loop logs the
loss and learning rate at INFO on this module's logger, as upstream's
``print_freq`` prints them.  One process on one device: ``device`` takes the
place of the JAX functions' ``mesh``.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.augment import (AugmentParams, ErasingParams, MixupParams, apply_augment,
                            apply_mixup_cutmix, apply_random_erasing, draw_augment_params,
                            draw_erasing_params, draw_mixup_params, normalize_batch,
                            smooth_one_hot)
from ..data.loader import HostDataLoader
from ..data.packs import PackIndex
from ..models.factory import Classifier
from ..models.layers import compute_copy
from ..utils.determinism import step_seed
from . import optim
from .schedules import warmup_cosine

__all__ = ["FinetuneState", "MAEFinetuneSettings", "StepDraws", "draw_step",
           "finetune_state", "loss_and_grads", "make_finetune", "make_probe",
           "run_linear_probe", "run_mae_finetune"]

logger = logging.getLogger(__name__)


@dataclass
class MAEFinetuneSettings:
    epochs: int = 100
    warmup_epochs: int = 5
    base_lr: float = 1e-3
    layer_decay: float = 0.75
    weight_decay: float = 0.05
    batch_size: int = 64
    num_workers: int = 8
    seed: int = 0
    log_interval: int = 20
    # Upstream regularizer knobs (reference ``main_finetune.py:87-112``):
    # label smoothing, Mixup/CutMix (enabled when alpha > 0), RandomErasing.
    smoothing: float = 0.1
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    reprob: float = 0.25
    recount: int = 1
    num_classes: int = 2


def _soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """CE against soft targets (mixup/smoothed labels), masking padded rows."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    per_row = -torch.sum(targets * log_probs, dim=-1)
    valid_f = valid.float()
    return torch.sum(per_row * valid_f) / torch.clamp(torch.sum(valid_f), min=1.0)


class StepDraws(NamedTuple):
    """A step's random draws; None where the step takes no such draw (the
    probe takes none)."""

    augment: Optional[AugmentParams]
    erasing: Optional[ErasingParams]
    mixup: Optional[MixupParams]


def draw_step(shape: Tuple[int, int, int, int], settings: MAEFinetuneSettings,
              generator: torch.Generator, rng: np.random.Generator, *, augment: bool,
              dtype: torch.dtype) -> StepDraws:
    """The draws of one step on a (B, H, W, C) batch: the augmentation, then
    the erasing (when ``reprob`` and ``recount`` are positive; its noise in
    ``dtype``) from ``generator``, the Mixup/CutMix scalars (when an alpha
    is positive) from ``rng``."""
    if not augment:
        return StepDraws(None, None, None)
    b, h, w, _ = shape
    aug = draw_augment_params(b, generator)
    erasing = None
    if settings.reprob > 0.0 and settings.recount > 0:
        erasing = draw_erasing_params(shape, generator, prob=settings.reprob,
                                      count=settings.recount, dtype=dtype)
    mixup = None
    if settings.mixup_alpha > 0.0 or settings.cutmix_alpha > 0.0:
        mixup = draw_mixup_params(rng, h, w, mixup_alpha=settings.mixup_alpha,
                                  cutmix_alpha=settings.cutmix_alpha, prob=settings.mixup_prob,
                                  switch_prob=settings.mixup_switch_prob)
    return StepDraws(aug, erasing, mixup)


def loss_and_grads(classifier: Classifier, params_c: Dict[str, torch.Tensor],
                   images_u8: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                   draws: StepDraws, settings: MAEFinetuneSettings,
                   names: Optional[Iterable[str]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss and the fp32 gradients of ``names`` (every parameter
    when None), taken with respect to the compute copy ``params_c``, in the
    JAX step's order: the augmentation (or the normalisation alone) in the
    compute dtype, the smoothed targets, the erasing, Mixup/CutMix with
    ``valid``, the forward and the soft cross-entropy over the valid rows.
    Parameters outside ``names`` take no gradient, so no backward runs
    through them when they are the encoder."""
    dtype = classifier.cfg.compute_dtype
    names = list(params_c) if names is None else list(names)
    leaves = dict(params_c)
    for n in names:
        leaves[n] = params_c[n].detach().requires_grad_()
    if draws.augment is not None:
        images = apply_augment(images_u8, draws.augment, dtype)
    else:
        images = normalize_batch(images_u8, dtype)
    targets = smooth_one_hot(labels, settings.num_classes, settings.smoothing)
    if draws.erasing is not None:
        images = apply_random_erasing(images, draws.erasing)
    if draws.mixup is not None:
        images, targets = apply_mixup_cutmix(images, targets, draws.mixup, valid)
    logits = functional_call(classifier.model, leaves, (images,))
    loss = _soft_cross_entropy(logits, targets, valid)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), {n: g.float() for n, g in zip(names, grads)}


@dataclass
class FinetuneState:
    """What an engine's step reads and updates in place."""

    masters: Dict[str, torch.Tensor]   # fp32 clones of every classifier parameter
    params: Dict[str, torch.Tensor]    # the trained ones among them
    params_c: Dict[str, torch.Tensor]  # the compute copy the forward reads, all of them
    opt: Any                           # optim.AdamWState or optim.LARSState over ``params``


def finetune_state(classifier: Classifier, trained: Iterable[str],
                   opt_init: Callable[[Dict[str, torch.Tensor]], Any]) -> FinetuneState:
    """Clones of the classifier's parameters as fp32 masters (the
    classifier keeps its own), their compute copy, and ``opt_init`` over
    the ``trained`` ones."""
    masters = {n: p.detach().clone() for n, p in classifier.model.named_parameters()}
    params = {n: masters[n] for n in trained}
    return FinetuneState(masters, params, compute_copy(masters, classifier.cfg.compute_dtype),
                         opt_init(params))


Update = Callable[[FinetuneState, Dict[str, torch.Tensor], float], None]


def _check_device(classifier: Classifier, device: torch.device) -> None:
    where = next(classifier.model.parameters()).device
    if where.type != device.type or (device.index is not None and where.index != device.index):
        raise ValueError(f"the classifier's parameters lie on {where}, not on {device}")


def _epoch_loop(classifier: Classifier, state: FinetuneState, update: Update,
                train_index: PackIndex, settings: MAEFinetuneSettings, *, augment: bool,
                device: torch.device) -> float:
    """Every epoch's steps: the gradients of ``state.params``
    (:func:`loss_and_grads`), then ``update`` in place.  The loss of each
    epoch's last step is read back and must be finite.  Returns the last
    one."""
    loader = HostDataLoader(train_index, batch_size=settings.batch_size, seed=settings.seed,
                            num_workers=settings.num_workers)
    steps_per_epoch = len(loader)
    schedule = warmup_cosine(settings.base_lr, steps_per_epoch * settings.epochs,
                             settings.warmup_epochs * steps_per_epoch)
    generator = torch.Generator(device=device)
    dtype = classifier.cfg.compute_dtype
    global_step = 0
    last_loss = float("nan")
    for epoch in range(settings.epochs):
        loader.set_epoch(epoch)
        loss = None
        for it, batch in enumerate(loader):
            seed = step_seed(settings.seed, epoch, it)
            generator.manual_seed(seed)
            images = torch.from_numpy(batch["image"]).to(device)
            draws = draw_step(tuple(images.shape), settings, generator,
                              np.random.default_rng(seed), augment=augment, dtype=dtype)
            lr = schedule(global_step)
            loss, grads = loss_and_grads(classifier, state.params_c, images,
                                         torch.from_numpy(batch["label"]).long().to(device),
                                         torch.from_numpy(batch["valid"]).to(device), draws,
                                         settings, state.params)
            update(state, grads, lr)
            # Reading the loss waits for the device: only when a handler listens.
            if (settings.log_interval > 0 and it % settings.log_interval == 0
                    and logger.isEnabledFor(logging.INFO)):
                logger.info("epoch %d step %d/%d: loss %.6f, lr %.6e", epoch, it,
                            steps_per_epoch, float(loss), lr)
            global_step += 1
        last_loss = float("nan") if loss is None else float(loss)
        if not math.isfinite(last_loss):
            raise FloatingPointError(f"non-finite loss at epoch {epoch}")
    return last_loss


def make_finetune(classifier: Classifier, settings: MAEFinetuneSettings
                  ) -> Tuple[FinetuneState, Update]:
    """The fine-tune's state and update: every parameter trained by one AdamW
    pass (``optim.adamw_update_fused``) with the layer-wise decay's
    learning-rate scales and weight decay off the vectors, tokens and
    position table."""
    names = [n for n, _ in classifier.model.named_parameters()]
    state = finetune_state(classifier, names, optim.adamw_init)
    lr_scale = optim.layerwise_lr_decay_scales(state.params, classifier.cfg.depth,
                                               settings.layer_decay)
    wd_scale = optim.no_weight_decay_scales(state.params)

    def update(state: FinetuneState, grads: Dict[str, torch.Tensor], lr: float) -> None:
        optim.adamw_update_fused(state.params, state.params_c, grads, state.opt, lr=lr,
                                 weight_decay=settings.weight_decay, lr_scale=lr_scale,
                                 wd_scale=wd_scale)

    return state, update


def make_probe(classifier: Classifier, settings: MAEFinetuneSettings
               ) -> Tuple[FinetuneState, Update]:
    """The linear probe's state and update: LARS on the tensors that the
    ``none`` regime's scales train (the head's), nothing else differentiated."""
    named = dict(classifier.model.named_parameters())
    lr_scale = optim.finetune_lr_scales(named, "none", classifier.cfg.depth)
    state = finetune_state(classifier, [n for n in named if lr_scale[n] != 0.0], optim.lars_init)

    def update(state: FinetuneState, grads: Dict[str, torch.Tensor], lr: float) -> None:
        optim.lars_update(state.params, grads, state.opt, lr=lr,
                          weight_decay=settings.weight_decay, lr_scale=lr_scale,
                          params_c=state.params_c)

    return state, update


def run_mae_finetune(
    classifier: Classifier,
    train_index: PackIndex,
    settings: MAEFinetuneSettings = MAEFinetuneSettings(),
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Full fine-tune with layer-wise LR decay (upstream ``main_finetune``).

    pos_embed is TRAINABLE here (it receives the embeddings-group layer
    decay): upstream's fine-tune model is a standard trainable-pos-embed ViT
    whose table is initialised from the MAE checkpoint and then trained
    (``models_vit.py`` + ``lr_decay.param_groups_lrd``); only the SSL4POLYP
    classifier lineage (``ViT_from_MAE``) inherits the frozen buffer, which
    ``classification.ScheduleRuntime(freeze_pos_embed=...)`` handles.  The
    two lineages intentionally differ.

    Returns ``{"params": {name: fp32 tensor}, "train_loss": float}``.
    """
    device = torch.device(device)
    _check_device(classifier, device)
    state, update = make_finetune(classifier, settings)
    last_loss = _epoch_loop(classifier, state, update, train_index, settings, augment=True,
                            device=device)
    return {"params": state.masters, "train_loss": last_loss}


def run_linear_probe(
    classifier: Classifier,
    train_index: PackIndex,
    settings: MAEFinetuneSettings = MAEFinetuneSettings(
        base_lr=0.1, weight_decay=0.0, smoothing=0.0
    ),
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Linear probe: frozen encoder, LARS on the head (upstream ``main_linprobe``).

    The JAX engine differentiates every parameter and updates the encoder
    with a learning-rate scale of 0, which leaves it bit-unchanged.  Here only
    the tensors of non-zero scale (the head's) take a gradient and LARS, so
    the step runs the encoder's forward kernels and no backward kernel; the
    encoder comes back bit-equal to the classifier's.

    Returns ``{"params": {name: fp32 tensor}, "train_loss": float}``.
    """
    device = torch.device(device)
    _check_device(classifier, device)
    state, update = make_probe(classifier, settings)
    last_loss = _epoch_loop(classifier, state, update, train_index, settings, augment=False,
                            device=device)
    return {"params": state.masters, "train_loss": last_loss}
