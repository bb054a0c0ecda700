"""Classification fine-tuning engine: the step, the epoch loop and the CLI.

Counterpart of ``ssl4polyp_tpu/training/classification.py`` (the reference
``src/ssl4polyp/classification/train_classification.py``):

* ``build()``        -> :func:`build_run` (datasets, class statistics, model,
  parent run)
* ``train_epoch()``  -> :func:`make_train_step` (on-device augmentation,
  forward, loss, backward, AdamW with fine-tune scales) inside
  :func:`run_classification_training`
* ``test()``         -> :mod:`..evaluation.evaluate`
* experiment rules   -> :mod:`.protocol` (RunPlan)
* run naming         -> :mod:`.layout`
* artifact schemas   -> :mod:`..evaluation.exports`

The step keeps fp32 master parameters and takes gradients with respect to
their compute copy, as the pretrain step does (``pretrain.py``).  Fine-tune
regimes and per-group learning rates are per-parameter scales on one AdamW;
multi-stage schedules (exp5c) swap the scales at stage boundaries
(:class:`ScheduleRuntime`).  The augmentation of each step is drawn from a
generator seeded from (seed, epoch, step), as the JAX engine folds the epoch
and the step into its key, so a resumed run draws what an uninterrupted one
draws.  Checkpoints hold the JAX package's layout (``models/weights.py``), so
either package resumes, evaluates or continues from the other's runs.

Data parallelism (``..parallel``): launched as N ranks (``torchrun``), every
rank loads ``batch_size / N`` rows of each global batch from its stripe of the
epoch's order, draws its augmentation from (seed + rank, epoch, step),
normalises its part of the loss by the global batch's valid count (or
weight sum), and all-reduces the gradients by their sum before AdamW, so
every rank takes the same update.  The evaluations gather every rank's
outputs, so every rank computes the same tau, best epoch and early stop;
only rank 0 writes, and the ranks meet at a barrier before one reads what
rank 0 wrote.  The JAX engine's loaders give each process a global batch of
its own stripe and then place it as the global array; here the global batch
is ``plan.batch_size``, as in the reference's DDP.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..configs.layered import load_layered_config
from ..data.augment import AugmentParams, apply_augment, draw_augment_params, normalize_batch
from ..data.loader import HostDataLoader
from ..data.packs import PackIndex, create_classification_datasets
from ..evaluation import exports
from ..evaluation.evaluate import evaluate_split
from ..metrics import thresholds as th
from ..metrics.performance import binary_metrics_block
from ..metrics.threshold_store import canonical_threshold_path
from ..models.factory import Classifier, build_classifier
from ..models.layers import compute_copy
from ..models.weights import jax_from_state_dict, state_dict_from_jax
from ..parallel import (barrier, build_mesh, cross_replica_sum, initialize_multihost,
                        is_distributed, is_primary, local_device, process_count, process_index,
                        replicate)
from ..utils.checkpoint import load_checkpoint, save_checkpoint, update_pointer
from ..utils.determinism import step_seed
from ..utils.logging import RunLogger, Throughput
from . import optim
from .layout import DatasetLayout, RunLayout, format_selection_tag, resolve_run_layout
from .protocol import FinetuneStage, RunPlan
from .schedules import EarlyStopper, PlateauScheduler, warmup_cosine

__all__ = [
    "FinetuneStage",
    "ParentRunReference",
    "ScheduleRuntime",
    "TrainContext",
    "TrainState",
    "build_run",
    "checkpoint_payload",
    "cli_main",
    "init_train_state",
    "load_parent_reference",
    "loss_and_grads",
    "loss_from_logits",
    "loss_normaliser",
    "loss_settings",
    "make_forward_fn",
    "make_train_step",
    "restore_state",
    "run_classification_training",
    "step_context",
]


# ---------------------------------------------------------------------------
# Parent run references (frozen-τ / canonical SUN init)
# ---------------------------------------------------------------------------

@dataclass
class ParentRunReference:
    checkpoint_path: Path
    checkpoint_sha256: Optional[str] = None
    metrics_path: Optional[Path] = None
    metrics_sha256: Optional[str] = None
    metrics_payload: Dict[str, Any] = field(default_factory=dict)

    def provenance_block(self, base_dir: Optional[Path]) -> Dict[str, Any]:
        def rel(path: Optional[Path]) -> Optional[str]:
            if path is None:
                return None
            try:
                return str(Path(path).resolve().relative_to(Path(base_dir).resolve()))
            except Exception:
                return str(path)

        block: Dict[str, Any] = {"checkpoint": rel(self.checkpoint_path)}
        if self.checkpoint_sha256:
            block["checkpoint_sha256"] = self.checkpoint_sha256
        if self.metrics_path:
            block["metrics"] = {
                "path": rel(self.metrics_path),
                **({"sha256": self.metrics_sha256} if self.metrics_sha256 else {}),
            }
        return block


def load_parent_reference(checkpoint_path: str | Path) -> ParentRunReference:
    """Load a parent checkpoint + its sibling metrics payload."""
    path = Path(checkpoint_path)
    if not path.exists():
        raise FileNotFoundError(f"Parent checkpoint not found: {path}")
    sha = exports.sha256_file(path)
    stem = path.with_suffix("")
    metrics_candidates = [
        Path(str(stem) + ".metrics.json"),
        Path(str(stem) + "_last.metrics.json"),
    ]
    metrics_path = next((c for c in metrics_candidates if c.exists()), None)
    payload: Dict[str, Any] = {}
    metrics_sha = None
    if metrics_path is not None:
        payload = json.loads(metrics_path.read_text(encoding="utf-8"))
        metrics_sha = exports.sha256_file(metrics_path)
    else:
        # thresholds may live in the checkpoint meta
        try:
            meta = load_checkpoint(path).get("meta", {})
            if isinstance(meta.get("thresholds"), Mapping):
                payload = {"thresholds": meta["thresholds"]}
        except Exception:
            payload = {}
    return ParentRunReference(
        checkpoint_path=path,
        checkpoint_sha256=sha,
        metrics_path=metrics_path,
        metrics_sha256=metrics_sha,
        metrics_payload=payload,
    )


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

@dataclass
class TrainContext:
    """A run: its plan and layout, the device, the classifier and its fp32
    masters (``params``: the model's own parameters by name), the datasets,
    the loss settings, the parent run and the logger.  The step reads the
    classifier, the loss settings and ``plan.weight_decay``."""

    plan: RunPlan
    layout: RunLayout
    device: torch.device
    classifier: Classifier
    params: Dict[str, torch.Tensor]
    datasets: Dict[str, PackIndex]
    dataset_summary: Dict[str, Dict[str, Any]]
    class_counts: List[int]
    class_weights: List[float]
    pos_weight: float
    loss_mode: str
    parent_reference: Optional[ParentRunReference]
    logger: RunLogger
    num_classes: int = 2
    eval_only: bool = False
    exp_config_name: Optional[str] = None


def step_context(classifier: Classifier, loss_mode: str, pos_weight: float,
                 class_weights: Sequence[float], weight_decay: float) -> TrainContext:
    """A context for :func:`make_train_step` alone (benchmarks, tests): the
    classifier, the loss settings and the weight decay, with no run layout,
    logger or data."""
    plan = RunPlan(experiment=None, model_cfg={}, model_key=None, model_tag="model", seed=0,
                   training_seeds=[], dataset_cfg={}, dataset_resolved={},
                   dataset_layout=DatasetLayout(name="", segments=(), data_tag=""),
                   weight_decay=weight_decay)
    return TrainContext(
        plan=plan, layout=None, device=next(classifier.model.parameters()).device,
        classifier=classifier,
        params={name: p.detach() for name, p in classifier.model.named_parameters()},
        datasets={}, dataset_summary={}, class_counts=[], class_weights=list(class_weights),
        pos_weight=pos_weight, loss_mode=loss_mode, parent_reference=None, logger=None,
        num_classes=len(class_weights))


def _dataset_summary(datasets: Mapping[str, PackIndex]) -> Dict[str, Dict[str, Any]]:
    summary: Dict[str, Dict[str, Any]] = {}
    for alias, index in datasets.items():
        entry = dict(index.provenance)
        entry["n_frames"] = len(index)
        summary[alias] = entry
    return summary


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


def build_run(
    plan: RunPlan,
    *,
    output_dir: str | Path,
    device: str | torch.device = "cuda",
    pack_root: Optional[Path] = None,
    roots_map: Optional[Mapping[str, str]] = None,
    checkpoint_root: Optional[Path] = None,
    exp_config_name: Optional[str] = None,
    num_classes: int = 2,
    check_exists: bool = True,
    model_overrides: Optional[Mapping[str, Any]] = None,
) -> TrainContext:
    """The run of ``plan`` on ``device``: its layout, datasets, class
    statistics, the classifier (random from ``plan.seed``, the weight file
    the model config names under ``checkpoint_root``: an MAE ``.ckpt`` or
    ``.pth``, an AugReg ``.npz``; or the parent checkpoint's parameters) and
    its logger.  The JAX engine's layout overrides
    (``unroll_blocks``, ``use_pallas_attention``) have nothing to decide
    here: the port runs its kernels on every CUDA tensor."""
    device = torch.device(device)
    layout = resolve_run_layout(
        output_dir=output_dir,
        model_tag=plan.model_tag,
        dataset_cfg=plan.dataset_cfg,
        dataset_resolved=plan.dataset_resolved,
        seed=plan.seed,
        parent_checkpoint=plan.parent_checkpoint,
        init_from=plan.init_from,
    )
    primary = is_primary()
    if primary:
        layout.output_dir.mkdir(parents=True, exist_ok=True)
    logger = RunLogger(layout.output_dir, layout.stem, primary=primary)

    resolved = plan.dataset_resolved
    datasets = create_classification_datasets(
        train_spec=resolved.get("train_pack"),
        val_spec=resolved.get("val_pack"),
        test_spec=resolved.get("test_pack"),
        train_split=resolved.get("train_split") or "train",
        val_split=resolved.get("val_split") or "val",
        test_split=resolved.get("test_split") or "test",
        pack_root=pack_root,
        roots_map=roots_map,
        image_size=plan.image_size,
        perturbation_splits=plan.perturbation_splits,
        snapshot_dir=layout.output_dir / "snapshot" if primary else None,
        check_exists=check_exists,
    )

    # class statistics from the train split (reference :5613-5630); an
    # eval-only run weighs every class 1
    train_index = datasets.get("train")
    if train_index is not None and train_index.labels is not None:
        counts = train_index.class_counts(num_classes).tolist()
        loss_mode, pos_weight, class_weights = loss_settings(counts, num_classes)
    else:
        counts = [0] * num_classes
        loss_mode, pos_weight, _ = loss_settings(counts, num_classes)
        class_weights = [1.0] * num_classes

    compute = torch.bfloat16 if plan.precision == "bf16" else torch.float32
    overrides: Dict[str, Any] = {"compute_dtype": compute, "img_size": plan.image_size}
    if model_overrides:
        overrides.update(model_overrides)
    classifier = build_classifier(
        torch.Generator().manual_seed(plan.seed),
        plan.model_cfg,
        num_classes=num_classes,
        checkpoint_root=checkpoint_root,
        device=device,
        **overrides,
    )
    params = {name: p.detach() for name, p in classifier.model.named_parameters()}

    parent_reference: Optional[ParentRunReference] = None
    if plan.parent_checkpoint:
        parent_reference = load_parent_reference(plan.parent_checkpoint)
        restored = load_checkpoint(parent_reference.checkpoint_path)
        parent_params = restored["payload"].get("params")
        if parent_params is None:
            raise ValueError(
                f"Parent checkpoint {parent_reference.checkpoint_path} lacks params"
            )
        optim.copy_into(params, state_dict_from_jax(parent_params, classifier.cfg))

    eval_only = datasets.get("train") is None

    return TrainContext(
        plan=plan,
        layout=layout,
        device=device,
        classifier=classifier,
        params=params,
        datasets=datasets,
        dataset_summary=_dataset_summary(datasets),
        class_counts=counts,
        class_weights=class_weights,
        pos_weight=pos_weight,
        loss_mode=loss_mode,
        parent_reference=parent_reference,
        logger=logger,
        num_classes=num_classes,
        eval_only=eval_only,
        exp_config_name=exp_config_name,
    )


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def loss_normaliser(labels: torch.Tensor, valid: torch.Tensor, loss_mode: str,
                    class_weights: Sequence[float]) -> torch.Tensor:
    """The denominator of :func:`loss_from_logits` over a batch, in fp32:
    the count of valid rows (``binary_bce``) or the sum of their class
    weights (``multiclass_ce``)."""
    valid_f = valid.float()
    if loss_mode == "binary_bce":
        return torch.sum(valid_f)
    weights = torch.tensor(list(class_weights), dtype=torch.float32,
                           device=labels.device)[labels.long()]
    return torch.sum(weights * valid_f)


def loss_from_logits(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                     loss_mode: str, pos_weight: float, class_weights: Sequence[float],
                     total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean loss over the valid rows, in fp32 (JAX ``_loss_from_logits``).

    ``binary_bce``: BCE on z = l1 - l0 (or l0 for one logit) with
    ``pos_weight`` on the positives.  ``multiclass_ce``: cross-entropy
    weighted by class, normalised by the sum of the valid rows' weights, as
    torch's ``CrossEntropyLoss(weight=...)`` does.  ``total`` replaces this
    batch's :func:`loss_normaliser` where the batch is one rank's rows of a
    global batch: the global one, so that the ranks' losses sum to the
    global batch's mean.
    """
    logits = logits.float()
    valid_f = valid.float()
    if total is None:
        total = loss_normaliser(labels, valid, loss_mode, class_weights)
    if loss_mode == "binary_bce":
        z = logits[:, 1] - logits[:, 0] if logits.shape[-1] == 2 else logits[:, 0]
        y = labels.float()
        # log sigmoid(z) = -logaddexp(0, -z); log(1 - sigmoid(z)) = -logaddexp(0, z)
        per = -(pos_weight * y * -F.softplus(-z) + (1.0 - y) * -F.softplus(z))
        return torch.sum(per * valid_f) / torch.clamp(total, min=1.0)
    picked = torch.log_softmax(logits, dim=-1).gather(1, labels.long()[:, None])[:, 0]
    weights = torch.tensor(list(class_weights), dtype=torch.float32,
                           device=logits.device)[labels.long()]
    return torch.sum(-picked * weights * valid_f) / torch.clamp(total, min=1e-12)


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
                   labels: torch.Tensor, valid: torch.Tensor, aug: AugmentParams,
                   total: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one augmented batch and the fp32 gradient of every
    parameter (the frozen ones too, so that the gradient norm counts what
    the JAX step's counts), taken with respect to the compute copy.
    ``total``: the loss's normaliser over the global batch, where this batch
    is one rank's rows of it (:func:`loss_from_logits`)."""
    cfg = ctx.classifier.cfg
    names = list(state.params_c)
    leaves = {n: state.params_c[n].detach().requires_grad_() for n in names}
    images = apply_augment(images_u8, aug, cfg.compute_dtype)
    logits = functional_call(state.model, leaves, (images,))
    loss = loss_from_logits(logits, labels, valid, ctx.loss_mode, ctx.pos_weight,
                            ctx.class_weights, total)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {n: g.float() for n, g in zip(names, grads)}


def make_train_step(ctx: TrainContext) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the step ``(state, images_u8, labels, valid, lr, lr_scale,
    wd_scale) -> {loss, grad_norm}`` (the contract of JAX ``make_train_step``).

    ``images_u8`` is (B, H, W, 3) uint8, ``labels`` (B,) int, ``valid`` (B,)
    bool, all on the model's device; ``lr_scale`` and ``wd_scale`` map each
    parameter name to its scale.  The step draws the augmentation from
    ``state.generator``, takes the gradients (:func:`loss_and_grads`), then
    runs AdamW (0.9, 0.999) with ``ctx.plan.weight_decay`` on the fp32
    masters and refreshes the compute copy in one pass
    (``optim.adamw_update_fused``), all in place.  In a process group the
    batch is this rank's rows of the global batch: the valid count (or weight
    sum) is all-reduced before the backward, and the loss and the gradients
    after it, by their sum, so every rank updates with the global batch's
    gradient (``loss`` is the global batch's).  Where the JAX engine fuses
    ``steps_per_call`` steps into one dispatch with ``lax.scan``, the port's
    engine calls this step that many times: eager PyTorch has no dispatch to
    amortise.
    """
    weight_decay = ctx.plan.weight_decay

    def step(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor, lr: float, lr_scale: Mapping[str, float],
             wd_scale: Mapping[str, float]) -> Dict[str, torch.Tensor]:
        if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
            raise ValueError(f"expected uint8 images (B, H, W, 3), got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        aug = draw_augment_params(images_u8.shape[0], state.generator)
        total = None
        if is_distributed():
            total = loss_normaliser(labels, valid, ctx.loss_mode, ctx.class_weights)
            cross_replica_sum([total])
        loss, grads = loss_and_grads(ctx, state, images_u8, labels, valid, aug, total)
        if total is not None:
            cross_replica_sum([loss, *grads.values()])
        grad_norm = optim.global_norm(grads)
        optim.adamw_update_fused(state.params, state.params_c, grads, state.opt, lr=lr,
                                 weight_decay=weight_decay, lr_scale=lr_scale,
                                 wd_scale=wd_scale)
        return {"loss": loss, "grad_norm": grad_norm}

    return step


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
    The JAX version pads the batch to its data mesh; here each rank runs its
    own rows on its own device, so no batch needs padding.
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


# ---------------------------------------------------------------------------
# Checkpoints in the JAX layout
# ---------------------------------------------------------------------------

def checkpoint_payload(state: TrainState, classifier: Classifier,
                       with_optimizer: bool = True) -> Dict[str, Any]:
    """The JAX engine's payload, ``{"params"[, "opt": {"step", "mu", "nu"}]}``,
    in the JAX layout with numpy leaves: the masters and both moments
    through ``jax_from_state_dict`` (the moments are elementwise, so the same
    transposes apply), the step a 0-d int32 array as the JAX state holds it."""
    cfg = classifier.cfg
    payload: Dict[str, Any] = {"params": jax_from_state_dict(state.params, cfg)}
    if with_optimizer:
        payload["opt"] = {
            "step": np.asarray(state.opt.step, dtype=np.int32),
            "mu": jax_from_state_dict(state.opt.mu, cfg),
            "nu": jax_from_state_dict(state.opt.nu, cfg),
        }
    return payload


def restore_state(state: TrainState, classifier: Classifier, payload: Mapping[str, Any]) -> None:
    """Write a :func:`checkpoint_payload` (from either package) into
    ``state`` in place: the masters, then the moments and the step where the
    payload holds them (a fresh optimizer state stays otherwise, as in the
    JAX engine).  The compute copy is refreshed from the masters."""
    cfg = classifier.cfg
    optim.copy_into(state.params, state_dict_from_jax(payload["params"], cfg))
    opt = payload.get("opt")
    if opt is not None:
        optim.copy_into(state.opt.mu, state_dict_from_jax(opt["mu"], cfg))
        optim.copy_into(state.opt.nu, state_dict_from_jax(opt["nu"], cfg))
        state.opt.step = int(np.asarray(opt["step"]))
    optim.refresh_compute_copy(state.params, state.params_c)


# ---------------------------------------------------------------------------
# Fine-tune schedule runtime
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Threshold runtime
# ---------------------------------------------------------------------------

def _resolve_policy_tau(
    ctx: TrainContext,
    policy: Optional[str],
    val_results: Optional[Mapping[str, Any]],
    epoch: int,
    previous_tau: Optional[float],
    val_split_path: Optional[str],
) -> Tuple[Optional[float], Optional[Dict[str, Any]]]:
    if not policy or policy == "none":
        return None, None
    if policy == "sun_val_frozen":
        if ctx.parent_reference is None or not ctx.parent_reference.metrics_payload:
            raise ValueError(
                "Policy 'sun_val_frozen' requires a parent run providing thresholds."
            )
        tau, record = th.resolve_frozen_sun_threshold(
            ctx.parent_reference.metrics_payload.get("thresholds") or {},
            source_key="primary",
            expected_split_substring="sun_full/val",
            checkpoint_path=ctx.parent_reference.checkpoint_path,
            checkpoint_sha256=ctx.parent_reference.checkpoint_sha256,
        )
        return tau, record
    if val_results is None:
        return previous_tau, None
    result = th.compute_policy_threshold(
        val_results["probabilities"],
        val_results["targets"],
        policy=policy,
        split_name=val_split_path or "val",
        epoch=epoch,
        previous_tau=previous_tau,
    )
    return result.tau, dict(result.record)


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------

def run_classification_training(
    ctx: TrainContext,
    thresholds_root: Optional[Path] = None,
    resume: bool = False,
) -> Dict[str, Any]:
    """Train (or, without a train split, only evaluate), select the best
    epoch, evaluate the test split at its threshold and write the run's
    artifacts; returns the JAX engine's summary plus ``timings``: seconds
    in the epochs' step loops (``train_s``, synchronised at the loss
    readback), the images they took, in validation, test and zero-shot
    evaluation, each save's host snapshot and write (``saves``: name,
    snapshot s, write s), the best checkpoint's reload and the exports.

    In a process group every rank calls this with the same plan; only rank
    0 writes (the others' ``saves`` stay empty)."""
    plan = ctx.plan
    layout = ctx.layout
    logger = ctx.logger
    device = ctx.device
    primary = is_primary()
    rank, ranks = process_index(), build_mesh().data
    if plan.batch_size % ranks:
        raise ValueError(f"batch_size {plan.batch_size} does not divide over {ranks} ranks")
    rank_batch = plan.batch_size // ranks
    timings: Dict[str, Any] = {"train_s": 0.0, "train_images": 0, "val_s": 0.0, "test_s": 0.0,
                               "zero_shot_s": 0.0, "saves": [], "reload_s": 0.0,
                               "export_s": 0.0}

    # Config snapshot (reference writes config.yaml + git commit per run)
    import yaml

    snapshot = {
        "plan": {
            key: (str(value) if isinstance(value, Path) else value)
            for key, value in dataclasses.asdict(plan).items()
            if not key.startswith("_") and key != "dataset_layout"
        },
        "stem": layout.stem,
    }
    if primary:
        (layout.output_dir / f"{layout.stem}.config.yaml").write_text(
            yaml.safe_dump(json.loads(json.dumps(snapshot, default=str))), encoding="utf-8"
        )

    val_split_path: Optional[str] = None
    data_block = exports.build_data_block(ctx.dataset_summary)
    if "val" in data_block:
        val_split_path = data_block["val"]["path"]

    selection_tag = format_selection_tag(plan.early_stop_monitor)
    monitor_name = plan.early_stop_monitor or "val_loss"
    monitor_key = monitor_name.split("_", 1)[1] if "_" in monitor_name else monitor_name
    monitor_mode = plan.early_stop_mode or (
        "max" if any(tok in monitor_key for tok in ("auroc", "auprc", "f1", "acc")) else "min"
    )

    forward_factory = make_forward_fn(ctx.classifier, device)
    dataset_name = plan.dataset_layout.name

    thresholds_map: Dict[str, float] = {}
    primary_record: Optional[Dict[str, Any]] = None
    sensitivity_record: Optional[Dict[str, Any]] = None
    primary_tau: Optional[float] = None
    sensitivity_tau: Optional[float] = None
    threshold_key = None
    sensitivity_threshold_key = None

    def eval_split_now(alias: str, params, tau: Optional[float], limit: Optional[int]):
        """``params``: a compute copy to bind, or None for one of the
        classifier's own parameters.  Each rank evaluates its stripe, which
        for an unshuffled split is contiguous: the gathered frames keep the
        one-process order when ``limit`` is None."""
        index = ctx.datasets[alias]
        loader = HostDataLoader(
            index, batch_size=rank_batch, shuffle=False,
            num_workers=plan.num_workers, drop_last=False,
            process_index=rank, process_count=ranks,
        )
        return evaluate_split(
            forward_factory(params),
            loader,
            index,
            split_name=alias,
            num_classes=ctx.num_classes,
            tau=tau,
            loss_mode=ctx.loss_mode,
            pos_weight=ctx.pos_weight,
            class_weights=ctx.class_weights,
            limit_batches=limit,
            morphology_eval=plan.morphology_eval or None,
            perturbation_eval=index.perturbations_enabled
            or dataset_name == "sun_test_perturbations",
        )

    run_mode = "train"
    if ctx.eval_only:
        run_mode = "eval"
    elif plan.finetune_mode == "none" and not plan.finetune_schedule and plan.is_exp5a:
        run_mode = "inference"

    summary: Dict[str, Any] = {}
    # The compute copy the evaluations bind: the classifier's own parameters
    # until a train state exists, then the state's, which follows training.
    eval_params: Optional[Dict[str, torch.Tensor]] = None
    zero_shot_block: Optional[Dict[str, Any]] = None
    zero_shot_outputs: Optional[Path] = None

    # ---------------- zero-shot pre-finetune inference (exp5c :291-426) ----
    if (
        not ctx.eval_only
        and ctx.parent_reference is not None
        and plan.threshold_policy == "sun_val_frozen"
        and dataset_name.startswith("polypgen_fewshot")
        and "test" in ctx.datasets
    ):
        start = time.perf_counter()
        tau0, record0 = _resolve_policy_tau(ctx, "sun_val_frozen", None, -1, None, val_split_path)
        zs = eval_split_now("test", eval_params, tau0, plan.limit_test_batches)
        timings["zero_shot_s"] = time.perf_counter() - start
        zero_shot_outputs = layout.output_dir / f"{layout.stem}_zeroshot_outputs.csv"
        zs_export = exports.export_frame_outputs(
            zero_shot_outputs,
            metadata_rows=zs["metadata_rows"],
            probabilities=zs["probabilities"],
            targets=zs["targets"],
            preds=zs["preds"],
            dataset_name=dataset_name,
            primary=primary,
        )
        zero_shot_block = {
            "tau": tau0,
            "metrics": exports.metric_block_for_export(zs),
            "outputs_csv": zero_shot_outputs.name,
            "outputs_csv_sha256": zs_export.sha256,
        }
        logger.text(
            f"zero-shot: AUROC {zs.get('auroc', float('nan')):.4f} at frozen tau {tau0}"
        )

    best_checkpoint_path: Optional[Path] = None
    best_monitor: Optional[float] = None
    last_epoch = -1
    train_loss_last: Optional[float] = None
    val_results: Optional[Dict[str, Any]] = None
    epochs_run = 0
    state: Optional[TrainState] = None

    def save(path: Path, with_optimizer: bool, meta: Dict[str, Any]) -> None:
        """Save the train state's payload synchronously, as the JAX engine
        does, timing the host snapshot (device to host, JAX layout) and the
        write (serialise, write, rename) apart; rank 0 only."""
        if not primary:
            return
        start = time.perf_counter()
        payload_tree = checkpoint_payload(state, ctx.classifier, with_optimizer)
        snapshot_s = time.perf_counter() - start
        save_checkpoint(path, payload_tree, meta, primary=primary)
        timings["saves"].append((path.name, snapshot_s, time.perf_counter() - start - snapshot_s))

    if not ctx.eval_only:
        train_index = ctx.datasets["train"]
        train_loader = HostDataLoader(
            train_index, batch_size=rank_batch, seed=plan.seed,
            num_workers=plan.num_workers, process_index=rank, process_count=ranks,
        )
        steps_per_epoch = len(train_loader)
        if plan.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, plan.limit_train_batches)
        total_steps = max(1, steps_per_epoch * plan.epochs)
        if plan.scheduler == "cosine":
            schedule = warmup_cosine(
                plan.lr, total_steps, plan.warmup_epochs * steps_per_epoch, plan.min_lr
            )
        else:
            schedule = lambda step: plan.lr  # noqa: E731
        plateau = (
            PlateauScheduler(
                factor=plan.scheduler_factor, patience=plan.scheduler_patience,
                mode=monitor_mode, min_lr=plan.min_lr,
            )
            if plan.scheduler == "plateau"
            else None
        )
        stopper = EarlyStopper(
            patience=plan.early_stop_patience,
            min_delta=plan.early_stop_min_delta,
            min_epochs=plan.early_stop_min_epochs,
            mode=monitor_mode,
        )

        depth = ctx.classifier.cfg.depth
        schedule_runtime = ScheduleRuntime(
            plan.finetune_schedule, plan.lr, depth,
            freeze_pos_embed=ctx.classifier.cfg.pos_embed == "sincos",
        )
        state = init_train_state(ctx.classifier, torch.Generator(device=device))
        if is_distributed():  # every rank starts from rank 0's masters
            replicate(state.params)
            optim.refresh_compute_copy(state.params, state.params_c)
        eval_params = state.params_c
        wd_scale = optim.no_weight_decay_scales(state.params)
        # 0 = "auto" (protocol._resolve_steps_per_call): the JAX engine fuses
        # 4 steps a dispatch on accelerators; eager calls have no dispatch to
        # amortise, so auto is 1 here.  K > 1 runs K calls of the step a
        # round, the same calls as K = 1; only the log cadence follows the
        # rounds, as in the JAX engine.
        steps_per_call = max(1, int(plan.steps_per_call))
        train_step = make_train_step(ctx)
        throughput = Throughput()
        global_step = 0
        current_mode = plan.finetune_mode
        stage_lr, lr_scale, current_mode, stage_name = schedule_runtime.lr_and_scales(
            state.params, 0, plan.finetune_mode
        )
        start_epoch = 0

        # ---- resume (reference build() resume path: pointer or newest
        # epoch checkpoint; the augmentation seeds are functions of (seed,
        # epoch, step), so data order and draws are reproduced) -----------
        if resume:
            barrier()  # rank 0's files are complete before any rank reads them
            candidates = sorted(layout.output_dir.glob(f"{layout.stem}_e*_*.ckpt"))
            pointer = layout.checkpoint_path
            resume_path = pointer if (pointer.exists() or pointer.is_symlink()) else (
                candidates[-1] if candidates else None
            )
            if resume_path is not None:
                restored = load_checkpoint(resume_path)
                restore_state(state, ctx.classifier, restored["payload"])
                meta = restored.get("meta", {})
                start_epoch = int(meta.get("epoch", -1)) + 1
                best_monitor = meta.get("monitor_value")
                thresholds_meta = meta.get("thresholds") or {}
                stored_primary = thresholds_meta.get("primary")
                if isinstance(stored_primary, Mapping) and stored_primary.get("tau") is not None:
                    primary_tau = float(stored_primary["tau"])
                    primary_record = dict(stored_primary)
                stored_sensitivity = thresholds_meta.get("sensitivity")
                if isinstance(stored_sensitivity, Mapping) and stored_sensitivity.get("tau") is not None:
                    sensitivity_tau = float(stored_sensitivity["tau"])
                    sensitivity_record = dict(stored_sensitivity)
                global_step = start_epoch * steps_per_epoch
                best_checkpoint_path = Path(resume_path).resolve()
                # Seed the early stopper / plateau scheduler from the
                # restored best: a fresh stopper (_best=None) would treat
                # the first post-resume epoch as an improvement and reset
                # patience, letting a resumed run train up to `patience`
                # extra epochs vs an uninterrupted one.  Resume continues
                # from the BEST epoch, so bad_epochs legitimately restarts
                # at 0; the best value/epoch must carry over.
                if best_monitor is not None:
                    stopper.load_state_dict({
                        "best": float(best_monitor),
                        "best_epoch": int(meta.get("epoch", -1)),
                        "bad_epochs": 0,
                    })
                    if plateau is not None:
                        plateau.load_state_dict({
                            "scale": float(meta.get("plateau_scale", 1.0)),
                            "best": float(best_monitor),
                            "bad_epochs": 0,
                        })
                logger.text(
                    f"resumed from {Path(resume_path).name} at epoch {start_epoch}"
                )

        for epoch in range(start_epoch, plan.epochs):
            new_lr, new_scale, new_mode, new_stage = schedule_runtime.lr_and_scales(
                state.params, epoch, plan.finetune_mode
            )
            if new_mode != current_mode or new_stage != stage_name:
                logger.text(
                    f"finetune schedule: entering stage {new_stage!r} (mode {new_mode}) at epoch {epoch}"
                )
            stage_lr, lr_scale, current_mode, stage_name = (
                new_lr, new_scale, new_mode, new_stage,
            )

            train_loader.set_epoch(epoch)
            losses: list = []
            pending_losses: list = []  # device scalars, read back in bursts

            def drain_losses() -> None:
                # One readback for the accumulated losses at log points and
                # at the epoch's end; every step is averaged into train_loss
                # and checked for finiteness (reference averages all
                # iterations).
                flat = (
                    torch.stack(pending_losses).double().cpu().numpy()
                    if pending_losses
                    else np.zeros((0,))
                )
                for offset, value in enumerate(flat):
                    if not math.isfinite(value):
                        step_at = global_step - len(flat) + offset + 1
                        raise FloatingPointError(f"non-finite loss at step {step_at}")
                    losses.append(float(value))
                pending_losses.clear()

            epoch_t0 = time.perf_counter()

            def step_lr(step_index: int) -> float:
                if plan.finetune_schedule:
                    return stage_lr
                if plan.scheduler == "cosine":
                    return schedule(step_index)
                if plateau is not None:
                    return plateau.scale(stage_lr)
                return stage_lr

            def on_device(batch):
                return (torch.from_numpy(batch["image"]).to(device),
                        torch.from_numpy(batch["label"]).long().to(device),
                        torch.from_numpy(batch["valid"]).to(device))

            iterator = iter(train_loader)
            it = 0
            steps_since_log = 0
            stop_epoch = False
            try:
                while not stop_epoch:
                    if plan.max_train_steps is not None and global_step >= plan.max_train_steps:
                        logger.text(
                            f"reached max_train_steps={plan.max_train_steps}; stopping epoch early"
                        )
                        break
                    # Collect up to steps_per_call batches for one round of
                    # calls (bounded additionally by steps_per_epoch and
                    # max_train_steps).
                    room = steps_per_epoch - it
                    if plan.max_train_steps is not None:
                        room = min(room, plan.max_train_steps - global_step)
                    chunk: list = []
                    while len(chunk) < min(steps_per_call, room):
                        try:
                            chunk.append(next(iterator))
                        except StopIteration:
                            stop_epoch = True
                            break
                    if not chunk:
                        break
                    k = len(chunk)
                    lrs = [step_lr(global_step + j) for j in range(k)]
                    for j, batch in enumerate(chunk):
                        # This step's augmentation: a function of (seed + rank,
                        # epoch, step), as the reference seeds seed + rank.
                        state.generator.manual_seed(step_seed(plan.seed + rank, epoch, it + j))
                        metrics = train_step(state, *on_device(batch), lrs[j], lr_scale,
                                             wd_scale)
                        pending_losses.append(metrics["loss"])
                    global_step += k
                    log_due = (it % plan.log_interval) < k if steps_per_call > 1 \
                        else it % plan.log_interval == 0
                    it += k
                    steps_since_log += k
                    if log_due:
                        drain_losses()
                        loss_value = losses[-1]
                        # Count the ACTUAL steps since the last log: the
                        # cadence of K calls a round is chunk-quantized.
                        rate = throughput.tick(plan.batch_size * steps_since_log)
                        steps_since_log = 0
                        logger.scalar("train/loss", loss_value, global_step)
                        logger.scalar("train/lr", lrs[-1], global_step)
                        logger.scalar("train/grad_norm", float(metrics["grad_norm"]), global_step)
                        if rate:
                            logger.scalar("train/images_per_sec", rate, global_step)
                    if it >= steps_per_epoch:
                        break
            finally:
                iterator.close()  # stops the loader's decode thread on every exit

            drain_losses()
            timings["train_s"] += time.perf_counter() - epoch_t0
            timings["train_images"] += plan.batch_size * it
            train_loss_last = float(np.mean(losses)) if losses else float("nan")
            epochs_run = epoch + 1
            last_epoch = epoch

            # ---- validation -------------------------------------------------
            val_results = None
            monitor_value = train_loss_last
            if "val" in ctx.datasets:
                start = time.perf_counter()
                val_results = eval_split_now("val", eval_params, primary_tau,
                                             plan.limit_val_batches)
                timings["val_s"] += time.perf_counter() - start
                primary_tau, primary_record = _resolve_policy_tau(
                    ctx, plan.threshold_policy, val_results, epoch, primary_tau, val_split_path
                )
                if plan.sensitivity_threshold_policy:
                    sensitivity_tau, sensitivity_record = _resolve_policy_tau(
                        ctx, plan.sensitivity_threshold_policy, val_results, epoch,
                        sensitivity_tau, val_split_path,
                    )
                monitor_value = float(val_results.get(monitor_key, val_results["loss"]))
                logger.scalars(
                    {k: v for k, v in val_results.items()
                     if isinstance(v, (int, float)) and not k.startswith("_")},
                    epoch, prefix="val/",
                )
                logger.text(
                    f"epoch {epoch}: train_loss {train_loss_last:.4f} "
                    f"val_loss {val_results['loss']:.4f} "
                    f"val_auroc {val_results.get('auroc', float('nan')):.4f} "
                    f"tau {primary_tau if primary_tau is not None else 'n/a'}"
                )
            if plateau is not None:
                plateau.step(monitor_value)

            if plan.threshold_policy and plan.threshold_policy != "none" and primary_tau is not None:
                threshold_key = th.format_threshold_key(
                    dataset_name, plan.dataset_resolved.get("val_split") or "val",
                    plan.threshold_policy,
                )
                thresholds_map[threshold_key] = float(primary_tau)
            if plan.sensitivity_threshold_policy and sensitivity_tau is not None:
                sensitivity_threshold_key = th.format_threshold_key(
                    dataset_name, plan.dataset_resolved.get("val_split") or "val",
                    plan.sensitivity_threshold_policy,
                )
                thresholds_map[sensitivity_threshold_key] = float(sensitivity_tau)

            # ---- checkpoint on improvement ---------------------------------
            improved = (
                best_monitor is None
                or (monitor_mode == "min" and monitor_value < best_monitor - plan.early_stop_min_delta)
                or (monitor_mode == "max" and monitor_value > best_monitor + plan.early_stop_min_delta)
            )
            if improved:
                best_monitor = monitor_value
                ckpt_name = f"{layout.stem}_e{epoch:02d}_{selection_tag}.ckpt"
                best_checkpoint_path = layout.output_dir / ckpt_name
                meta = {
                    "epoch": epoch,
                    "monitor_metric": monitor_name,
                    "monitor_value": monitor_value,
                    "seed": plan.seed,
                    "stem": layout.stem,
                    "model_cfg": _model_cfg_meta(ctx),
                    # plateau LR scale at save time — restored on resume so
                    # the reduced LR survives interruption
                    **({"plateau_scale": plateau.state_dict()["scale"]}
                       if plateau is not None else {}),
                    "thresholds": exports.build_thresholds_block(
                        thresholds_map,
                        policy=plan.threshold_policy,
                        primary=primary_record,
                        sensitivity=sensitivity_record,
                    ),
                }
                save(best_checkpoint_path, plan.checkpoint_optimizer_state, meta)
                update_pointer(layout.checkpoint_path, best_checkpoint_path, primary=primary)

            if stopper.update(epoch, monitor_value):
                logger.text(
                    f"early stopping at epoch {epoch} "
                    f"(best {monitor_name}={stopper.best} @ epoch {stopper.best_epoch})"
                )
                break

        # reload best checkpoint for the final test (reference :7380-7414),
        # into the train state, whose compute copy the evaluations bind;
        # every rank reads the file rank 0 wrote
        barrier()
        if best_checkpoint_path is not None and best_checkpoint_path.exists():
            start = time.perf_counter()
            restored = load_checkpoint(best_checkpoint_path)
            restore_state(state, ctx.classifier, {"params": restored["payload"]["params"]})
            timings["reload_s"] = time.perf_counter() - start
            meta = restored.get("meta", {})
            # Restore the BEST epoch's τ records alongside its params: the
            # loop variables hold the LAST epoch's τ, derived from a model
            # that is not the one being tested — exactly the τ/checkpoint
            # provenance mismatch the guardrails exist to prevent.
            best_thresholds = meta.get("thresholds") or {}
            stored_primary = best_thresholds.get("primary")
            if isinstance(stored_primary, Mapping) and stored_primary.get("tau") is not None:
                primary_tau = float(stored_primary["tau"])
                primary_record = dict(stored_primary)
                if plan.threshold_policy and plan.threshold_policy not in ("none",):
                    threshold_key = th.format_threshold_key(
                        dataset_name,
                        plan.dataset_resolved.get("val_split") or "val",
                        plan.threshold_policy,
                    )
                    thresholds_map[threshold_key] = primary_tau
            stored_sensitivity = best_thresholds.get("sensitivity")
            if isinstance(stored_sensitivity, Mapping) and stored_sensitivity.get("tau") is not None:
                sensitivity_tau = float(stored_sensitivity["tau"])
                sensitivity_record = dict(stored_sensitivity)
            logger.text(
                f"reloaded best checkpoint {best_checkpoint_path.name} "
                f"({monitor_name}={meta.get('monitor_value')})"
            )
    else:
        # eval-only runs (exp5a/5b): frozen τ from the parent
        primary_tau, primary_record = _resolve_policy_tau(
            ctx, plan.threshold_policy, None, -1, None, val_split_path
        )
        if plan.threshold_policy and primary_tau is not None:
            threshold_key = th.format_threshold_key(
                dataset_name, plan.dataset_resolved.get("val_split") or "val",
                plan.threshold_policy,
            )
            thresholds_map[threshold_key] = float(primary_tau)
        if plan.sensitivity_threshold_policy == "sun_val_frozen":
            sensitivity_tau, sensitivity_record = primary_tau, dict(primary_record or {})

    # ---------------- final test -------------------------------------------
    test_results: Optional[Dict[str, Any]] = None
    curve_metadata: Optional[Dict[str, Any]] = None
    outputs_csv_path: Optional[Path] = None
    if "test" in ctx.datasets:
        start = time.perf_counter()
        test_results = eval_split_now("test", eval_params, primary_tau, plan.limit_test_batches)
        timings["test_s"] = time.perf_counter() - start
        start = time.perf_counter()
        outputs_csv_path = layout.output_dir / f"{layout.stem}_test_outputs.csv"
        outputs_export = exports.export_frame_outputs(
            outputs_csv_path,
            metadata_rows=test_results["metadata_rows"],
            probabilities=test_results["probabilities"],
            targets=test_results["targets"],
            preds=test_results["preds"],
            dataset_name=dataset_name,
            primary=primary,
        )
        if "test" in plan.curve_export_splits:
            curve_metadata = exports.export_curve_sets(
                layout.output_dir / layout.stem,
                "test",
                probabilities=test_results["probabilities"],
                targets=test_results["targets"],
                grid_points=plan.curve_export_splits["test"]["points"],
                primary=primary,
            )
        timings["export_s"] += time.perf_counter() - start
        logger.text(
            f"test: AUROC {test_results.get('auroc', float('nan')):.4f} "
            f"F1 {test_results.get('f1', float('nan')):.4f} at tau {primary_tau}"
        )

    export_start = time.perf_counter()
    # ---------------- sensitivity block at test -----------------------------
    test_sensitivity_block = None
    if test_results is not None and sensitivity_tau is not None:
        test_sensitivity_block = binary_metrics_block(
            test_results["probabilities"], test_results["targets"],
            tau=sensitivity_tau, loss=test_results.get("loss"),
        )

    # align threshold record splits with data.val.path (reference :7533-7546)
    if primary_record is not None and val_split_path and primary_record.get("policy") != "sun_val_frozen":
        primary_record["split"] = val_split_path
    if sensitivity_record is not None and val_split_path and sensitivity_record.get("policy") != "sun_val_frozen":
        sensitivity_record["split"] = val_split_path

    # persist thresholds to the canonical store
    threshold_file_rel = None
    if thresholds_map and thresholds_root is not None:
        store_path = canonical_threshold_path(
            thresholds_root,
            val_pack=plan.dataset_resolved.get("val_pack"),
            model_tag=plan.model_tag,
            arch=plan.model_cfg.get("arch"),
            pretraining=plan.model_cfg.get("pretraining"),
            train_pack=plan.dataset_resolved.get("train_pack"),
            seed=plan.seed,
            policy=plan.threshold_policy,
        )
        th.save_thresholds(store_path, thresholds_map, primary=primary)
        threshold_file_rel = str(store_path)

    # ---------------- metrics.json -------------------------------------------
    run_block = exports.build_run_block(
        experiment=plan.experiment,
        experiment_config=ctx.exp_config_name,
        stem=layout.stem,
        model=plan.model_tag,
        arch=plan.model_cfg.get("arch"),
        pretraining=plan.model_cfg.get("pretraining"),
        finetune_mode=plan.finetune_mode,
        selection=selection_tag,
        seed=plan.seed,
        mode=run_mode,
        world_size=ranks,
    )
    provenance_block = exports.build_provenance_block(
        model=plan.model_key or plan.model_tag,
        arch=plan.model_cfg.get("arch"),
        train_seed=plan.seed,
        dataset_summary=ctx.dataset_summary,
        test_outputs_csv=outputs_csv_path.name if outputs_csv_path else None,
        test_outputs_sha256=outputs_export.sha256 if outputs_csv_path else None,
        zero_shot_outputs_csv=zero_shot_outputs.name if zero_shot_outputs else None,
        zero_shot_outputs_sha256=(
            zero_shot_block["outputs_csv_sha256"] if zero_shot_block else None
        ),
        subset_percent=plan.dataset_layout.percent,
        pack_seed=plan.dataset_layout.dataset_seed,
        fewshot_budget=plan.dataset_layout.size,
        test_split=plan.dataset_resolved.get("test_split"),
        parent_run=(
            ctx.parent_reference.provenance_block(layout.base_dir)
            if ctx.parent_reference
            else None
        ),
    )
    thresholds_block = exports.build_thresholds_block(
        thresholds_map,
        policy=plan.threshold_policy,
        primary=primary_record,
        sensitivity=sensitivity_record,
        sources={"val": threshold_key or "", "test": threshold_key or ""},
    )

    payload: Dict[str, Any] = {
        "seed": plan.seed,
        "epoch": int(last_epoch),
        "train_loss": train_loss_last,
        "monitor_metric": monitor_name,
        "monitor_value": best_monitor,
        "run": run_block,
        "provenance": provenance_block,
        "data": data_block,
        "thresholds": thresholds_block,
        "threshold_policy": plan.threshold_policy,
    }
    if ctx.eval_only:
        payload["eval_only"] = True
    if val_results is not None:
        payload["val"] = exports.metric_block_for_export(val_results)
    if test_results is not None:
        payload["test_primary"] = exports.metric_block_for_export(test_results)
        if "case_metrics" in test_results:
            payload["test_per_case"] = test_results["case_metrics"]
        if "morphology_metrics" in test_results:
            payload["test_morphology"] = {
                key: exports.metric_block_for_export(value)
                for key, value in test_results["morphology_metrics"].items()
            }
        if "perturbation_metrics" in test_results:
            block: Dict[str, Any] = {
                "per_tag": {
                    tag: exports.metric_block_for_export(stats)
                    for tag, stats in sorted(test_results["perturbation_metrics"].items())
                }
            }
            if "perturbation_case_metrics" in test_results:
                block["per_case"] = test_results["perturbation_case_metrics"]
            payload["test_perturbations"] = block
    if test_sensitivity_block is not None:
        payload["test_sensitivity"] = exports.metric_block_for_export(test_sensitivity_block)
    if curve_metadata is not None:
        payload["curve_exports"] = {
            "test": {
                "path": curve_metadata["path"],
                "sha256": curve_metadata["sha256"],
                "metadata": {
                    "points": curve_metadata["points"],
                    "roc_csv": curve_metadata["roc_csv"],
                    "pr_csv": curve_metadata["pr_csv"],
                },
            }
        }
    if zero_shot_block is not None:
        payload["zero_shot"] = zero_shot_block
    if threshold_file_rel and threshold_key:
        payload["threshold_files"] = {threshold_key: threshold_file_rel}
    if plan.sensitivity_threshold_policy:
        payload["sensitivity_threshold_policy"] = plan.sensitivity_threshold_policy

    if primary:
        layout.metrics_path.write_text(json.dumps(payload, indent=2, default=_json_default))
    timings["export_s"] += time.perf_counter() - export_start

    # _last checkpoint + metrics (reference :7557-7701)
    if not ctx.eval_only and last_epoch >= 0:
        last_name = f"{layout.stem}_last_e{last_epoch:02d}_{selection_tag}.ckpt"
        last_path = layout.output_dir / last_name
        save(
            last_path,
            False,
            {
                "epoch": last_epoch,
                "monitor_metric": monitor_name,
                "monitor_value": best_monitor,
                "seed": plan.seed,
                "model_cfg": _model_cfg_meta(ctx),
            },
        )
        update_pointer(layout.output_dir / f"{layout.stem}_last.ckpt", last_path,
                       primary=primary)
        if primary:
            last_metrics_path = layout.output_dir / f"{layout.stem}_last.metrics.json"
            last_metrics_path.write_text(json.dumps(payload, indent=2, default=_json_default))

    logger.close()
    summary = {
        "stem": layout.stem,
        "epochs_run": epochs_run,
        "best_monitor": best_monitor,
        "tau": primary_tau,
        "metrics_path": str(layout.metrics_path),
        "test_auroc": test_results.get("auroc") if test_results else None,
        "timings": timings,
        "payload": payload,
    }
    return summary


def _model_cfg_meta(ctx: TrainContext) -> Dict[str, Any]:
    """Architecture facts needed to rebuild the model at eval time."""
    cfg = ctx.classifier.cfg
    return {
        "img_size": cfg.img_size,
        "patch_size": cfg.patch_size,
        "embed_dim": cfg.embed_dim,
        "depth": cfg.depth,
        "num_heads": cfg.num_heads,
        "pos_embed": cfg.pos_embed,
        "out_token": cfg.out_token,
        "num_classes": cfg.num_classes,
        # Record the RESOLVED token padding (None → 0 = explicit no-pad), so
        # that an eval rebuilds the producing run's kernel route: it decides
        # where the fusion knobs apply (models/layers.py::block_route).
        "pad_tokens_to": int(cfg.pad_tokens_to or 0),
    }


def _json_default(value):
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, Path):
        return str(value)
    return str(value)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def cli_main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """``python -m ssl4polyp_tpu_torch.training.classification --exp-config
    ...``: the JAX package's ``ssl4polyp-train`` flags, plus ``--device``
    (the card unless ``--device cpu`` is given).  Prints the summary without
    its payload, as the JAX CLI does, and returns it; ``timings`` gains
    ``build_s``, the seconds of :func:`build_run` (datasets and model, the
    MAE checkpoint's read among them).  Under ``torchrun`` every rank runs
    it: the process group from the environment (``parallel.multihost``),
    each rank on its local device."""
    import argparse

    from .protocol import resolve_run_plan

    parser = argparse.ArgumentParser(description="Classification fine-tuning (PyTorch, CUDA)")
    parser.add_argument("--exp-config", required=True)
    parser.add_argument("--model-key", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output-dir", default="checkpoints/classification")
    parser.add_argument("--pack-root", default=None)
    parser.add_argument("--checkpoint-root", default=None)
    parser.add_argument("--thresholds-root", default=None)
    parser.add_argument("--parent-checkpoint", default=None)
    parser.add_argument(
        "--override", action="append", default=[],
        help="dotted config overrides key.path=value",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the run's checkpoint pointer / newest epoch checkpoint",
    )
    # First-class smoke-run limits (reference train_classification.py:7932-7958);
    # equivalent to --override but documented and typed.
    parser.add_argument("--limit-train-batches", type=int, default=None)
    parser.add_argument("--limit-val-batches", type=int, default=None)
    parser.add_argument("--limit-test-batches", type=int, default=None)
    parser.add_argument("--max-train-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the model runs; the kernels need a CUDA device")
    args = parser.parse_args(argv)
    device = local_device(args.device)
    initialize_multihost(backend="gloo" if device.type == "cpu" else None)

    cfg = load_layered_config(args.exp_config)
    overrides: Dict[str, Any] = {}
    for limit_key in (
        "limit_train_batches", "limit_val_batches", "limit_test_batches", "max_train_steps",
    ):
        value = getattr(args, limit_key)
        if value is not None:
            overrides[limit_key] = int(value)
    for item in args.override:
        key, _, raw = item.partition("=")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        try:
            value: Any = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node[parts[-1]] = value

    plan = resolve_run_plan(
        cfg,
        model_key=args.model_key,
        seed=args.seed,
        overrides=overrides,
        parent_checkpoint=args.parent_checkpoint,
        output_dir=args.output_dir,
        world_size=process_count(),
    )
    start = time.perf_counter()
    ctx = build_run(
        plan,
        output_dir=args.output_dir,
        device=device,
        pack_root=Path(args.pack_root) if args.pack_root else None,
        checkpoint_root=Path(args.checkpoint_root) if args.checkpoint_root else None,
        exp_config_name=args.exp_config,
    )
    build_s = time.perf_counter() - start
    thresholds_root = Path(args.thresholds_root) if args.thresholds_root else None
    summary = run_classification_training(
        ctx, thresholds_root=thresholds_root, resume=args.resume
    )
    summary["timings"]["build_s"] = build_s
    print(json.dumps({k: v for k, v in summary.items() if k != "payload"}, default=str))
    return summary


if __name__ == "__main__":
    cli_main()
