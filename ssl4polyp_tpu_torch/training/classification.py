"""The classifier's fine-tune step and its uint8 -> logits eval forward.

Counterpart of ``ssl4polyp_tpu/training/classification.py``: the class
statistics that set the loss (``loss_settings``), the loss
(``_loss_from_logits``), the train step (``make_train_step``: on-device
augmentation, forward, loss, backward, AdamW with fine-tune scales), the
fine-tune schedule's learning rate and scales (``ScheduleRuntime``) and the
eval forward (``make_forward_fn``).  The engine's epoch loop, thresholds,
metrics and checkpoints come with a later slice.

The step keeps fp32 master parameters and takes gradients with respect to
their compute copy, as the pretrain step does (``pretrain.py``).  Its
augmentation parameters come from the state's explicit generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..data.augment import AugmentParams, apply_augment, draw_augment_params, normalize_batch
from ..models.factory import Classifier
from ..models.layers import compute_copy
from . import optim

__all__ = [
    "FinetuneStage",
    "ScheduleRuntime",
    "TrainContext",
    "TrainState",
    "init_train_state",
    "loss_and_grads",
    "loss_from_logits",
    "loss_settings",
    "make_forward_fn",
    "make_train_step",
]


@dataclass(frozen=True)
class FinetuneStage:
    """One stage of a multi-stage fine-tune schedule (the fields of
    ``ssl4polyp_tpu.training.protocol.FinetuneStage``)."""

    name: str
    mode: str
    epochs: int
    head_lr: Optional[float] = None
    backbone_lr: Optional[float] = None


@dataclass
class TrainContext:
    """What the step needs of a run: the classifier and the loss settings."""

    classifier: Classifier
    loss_mode: str  # "binary_bce" | "multiclass_ce"
    pos_weight: float
    class_weights: Sequence[float]
    weight_decay: float


def loss_settings(class_counts: Sequence[int], num_classes: int = 2
                  ) -> Tuple[str, float, List[float]]:
    """(loss_mode, pos_weight, class_weights) from the train split's class
    counts (JAX ``classification.py:200-216``, reference :5613-5630): BCE with
    pos_weight = negatives / positives for two classes, class-weighted
    cross-entropy otherwise; an empty class weighs 0."""
    total = sum(class_counts)
    class_weights = [total / (num_classes * c) if c > 0 else 0.0 for c in class_counts]
    if num_classes == 2:
        neg, pos = float(class_counts[0]), float(class_counts[1])
        return "binary_bce", (neg / pos) if pos > 0 else 1.0, class_weights
    return "multiclass_ce", 1.0, class_weights


def loss_from_logits(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                     loss_mode: str, pos_weight: float,
                     class_weights: Sequence[float]) -> torch.Tensor:
    """The mean loss over the valid rows, in fp32 (JAX ``_loss_from_logits``).

    ``binary_bce``: BCE on z = l1 - l0 (or l0 for one logit) with
    ``pos_weight`` on the positives.  ``multiclass_ce``: cross-entropy
    weighted by class, normalised by the sum of the valid rows' weights, as
    torch's ``CrossEntropyLoss(weight=...)`` does.
    """
    logits = logits.float()
    valid_f = valid.float()
    if loss_mode == "binary_bce":
        z = logits[:, 1] - logits[:, 0] if logits.shape[-1] == 2 else logits[:, 0]
        y = labels.float()
        # log sigmoid(z) = -logaddexp(0, -z); log(1 - sigmoid(z)) = -logaddexp(0, z)
        per = -(pos_weight * y * -F.softplus(-z) + (1.0 - y) * -F.softplus(z))
        return torch.sum(per * valid_f) / torch.clamp(torch.sum(valid_f), min=1.0)
    picked = torch.log_softmax(logits, dim=-1).gather(1, labels.long()[:, None])[:, 0]
    weights = torch.tensor(list(class_weights), dtype=torch.float32,
                           device=logits.device)[labels.long()]
    return torch.sum(-picked * weights * valid_f) / torch.clamp(
        torch.sum(weights * valid_f), min=1e-12)


@dataclass
class TrainState:
    """What a step reads and updates in place."""

    model: torch.nn.Module
    params: Dict[str, torch.Tensor]    # fp32 masters: the model's own parameters
    params_c: Dict[str, torch.Tensor]  # the compute copy the forward reads
    opt: optim.AdamWState
    generator: torch.Generator         # augmentation draws, on the model's device


def init_train_state(classifier: Classifier, generator: torch.Generator) -> TrainState:
    model = classifier.model
    params = {name: p.detach() for name, p in model.named_parameters()}
    return TrainState(model=model, params=params,
                      params_c=compute_copy(params, classifier.cfg.compute_dtype),
                      opt=optim.adamw_init(params), generator=generator)


def loss_and_grads(ctx: TrainContext, state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor, aug: AugmentParams
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one augmented batch and the fp32 gradient of every
    parameter (the frozen ones too, so that the gradient norm counts what
    the JAX step's counts), taken with respect to the compute copy."""
    cfg = ctx.classifier.cfg
    names = list(state.params_c)
    leaves = {n: state.params_c[n].detach().requires_grad_() for n in names}
    images = apply_augment(images_u8, aug, cfg.compute_dtype)
    logits = functional_call(state.model, leaves, (images,))
    loss = loss_from_logits(logits, labels, valid, ctx.loss_mode, ctx.pos_weight,
                            ctx.class_weights)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {n: g.float() for n, g in zip(names, grads)}


def make_train_step(ctx: TrainContext) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the step ``(state, images_u8, labels, valid, lr, lr_scale,
    wd_scale) -> {loss, grad_norm}`` (the contract of JAX ``make_train_step``).

    ``images_u8`` is (B, H, W, 3) uint8, ``labels`` (B,) int, ``valid`` (B,)
    bool, all on the model's device; ``lr_scale`` and ``wd_scale`` map each
    parameter name to its scale.  The step draws the augmentation from
    ``state.generator``, takes the gradients (:func:`loss_and_grads`), then
    runs AdamW (0.9, 0.999) on the fp32 masters and refreshes the compute
    copy in one pass (``optim.adamw_update_fused``), all in place.  Where
    the JAX engine fuses ``steps_per_call`` steps into one dispatch with
    ``lax.scan``, the port's caller calls this step that many times: eager
    PyTorch has no dispatch to amortise.
    """

    def step(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor, lr: float, lr_scale: Mapping[str, float],
             wd_scale: Mapping[str, float]) -> Dict[str, torch.Tensor]:
        if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
            raise ValueError(f"expected uint8 images (B, H, W, 3), got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        aug = draw_augment_params(images_u8.shape[0], state.generator)
        loss, grads = loss_and_grads(ctx, state, images_u8, labels, valid, aug)
        grad_norm = optim.global_norm(grads)
        optim.adamw_update_fused(state.params, state.params_c, grads, state.opt, lr=lr,
                                 weight_decay=ctx.weight_decay, lr_scale=lr_scale,
                                 wd_scale=wd_scale)
        return {"loss": loss, "grad_norm": grad_norm}

    return step


@dataclass
class ScheduleRuntime:
    """The learning rate and scales of each epoch under a multi-stage
    fine-tune schedule (JAX ``ScheduleRuntime``, reference
    ``FinetuneScheduleRuntime``, ``train_classification.py:860-954``)."""

    stages: Tuple[FinetuneStage, ...]
    base_lr: float
    depth: int
    # The MAE lineage's sin-cos table is a frozen buffer in the reference.
    freeze_pos_embed: bool = False

    def stage_at(self, epoch: int) -> Optional[FinetuneStage]:
        if not self.stages:
            return None
        boundary = 0
        for stage in self.stages:
            boundary += stage.epochs
            if epoch < boundary:
                return stage
        return self.stages[-1]

    def lr_and_scales(self, params: Mapping[str, torch.Tensor], epoch: int, default_mode: str
                      ) -> Tuple[float, Dict[str, float], str, Optional[str]]:
        """(lr, lr scales, mode, stage name) for ``epoch``."""
        stage = self.stage_at(epoch)
        if stage is None:
            scales = optim.finetune_lr_scales(params, default_mode, self.depth,
                                              freeze_pos_embed=self.freeze_pos_embed)
            return self.base_lr, scales, default_mode, None
        head_lr = stage.head_lr if stage.head_lr is not None else self.base_lr
        backbone_scale = 1.0
        if stage.backbone_lr is not None and head_lr > 0:
            backbone_scale = stage.backbone_lr / head_lr
        scales = optim.finetune_lr_scales(params, stage.mode, self.depth, head_scale=1.0,
                                          backbone_scale=backbone_scale,
                                          freeze_pos_embed=self.freeze_pos_embed)
        return head_lr, scales, stage.mode, stage.name


def make_forward_fn(
    classifier: Classifier, device: str | torch.device
) -> Callable[[Optional[Mapping[str, torch.Tensor]]], Callable[[np.ndarray], np.ndarray]]:
    """The eval forward on ``device``, as a binder over the parameters (the
    contract of JAX ``make_forward_fn``, which returns ``run(params)``).

    ``bind(params)`` returns ``forward(images_u8) -> logits``: a uint8 NHWC
    numpy batch to fp32 logits as numpy.  ``params`` maps each parameter's
    name to the tensor the forward reads (``torch.func.functional_call``): a
    train state's ``params_c`` is that mapping, updated in place by every
    step, so a forward bound to it follows training.  ``None`` binds a compute
    copy made here from the classifier's own parameters (matrices in the
    compute dtype, vectors fp32, as in the JAX recipe).  The classifier's
    module is read, never written: it keeps its fp32 masters and its device.
    The JAX version pads the batch to its data mesh; one device needs no
    padding, and several devices come with the multi-GPU slice.
    """
    device = torch.device(device)
    dtype = classifier.cfg.compute_dtype
    model = classifier.model

    def bind(params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Callable[[np.ndarray], np.ndarray]:
        if params is None:
            params = compute_copy(
                {name: p.to(device) for name, p in model.named_parameters()}, dtype)
        missing = [name for name, _ in model.named_parameters() if name not in params]
        if missing:
            raise KeyError(f"make_forward_fn: no tensor for parameters {missing}")
        bound = {name: t.detach().to(device) for name, t in params.items()}

        def forward(images_u8: np.ndarray) -> np.ndarray:
            host = np.asarray(images_u8)
            if host.dtype != np.uint8 or host.ndim != 4:
                raise TypeError(f"expected a uint8 NHWC batch, got {host.dtype} {host.shape}")
            host = np.require(host, requirements=("C", "W"))
            with torch.inference_mode():
                images = normalize_batch(torch.from_numpy(host).to(device), dtype)
                return functional_call(model, bound, (images,)).float().cpu().numpy()

        return forward

    return bind
