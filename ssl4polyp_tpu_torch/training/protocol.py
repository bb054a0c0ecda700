"""Experiment protocol: declarative resolution of a run plan from config.

The port's copy of ``ssl4polyp_tpu/training/protocol.py``; where that module
asks JAX for its device count, :func:`resolve_run_plan` takes
``world_size``, by default the process group's (``parallel.multihost``; 1
without a group): one GPU a rank.

This module replaces the imperative ``apply_experiment_config`` +
``build()``-era policy scattered through the reference monolith
(``train_classification.py:4157-4444, 5769-5854, 3992-4071``) with one
pure function: ``resolve_run_plan(experiment_cfg, model_key, seed, …) →
RunPlan``.  Every experiment-specific rule lives here:

* dataset spec resolution incl. ``train_pattern``/``pack_pattern``
  templating (sun_subsets / polypgen_fewshot);
* training-seed trio resolution (CLI > protocol > config);
* threshold-policy aliases, the auto table, and expected-policy assertions
  that hard-fail on mismatch;
* fine-tune mode + multi-stage schedules (exp5c budgets);
* early-stop / scheduler / batch-limit settings;
* exp5a detection and canonical-SUN-parent initialisation;
* few-shot per-rank batch adaptation.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..configs.layered import deep_merge, extract_dataset_config, resolve_model_entries
from ..parallel.multihost import process_count
from .layout import (
    DatasetLayout,
    canonical_sun_parent_checkpoint,
    canonicalize_tag,
    recommend_fewshot_batch_size,
    resolve_dataset_layout,
)

__all__ = [
    "RunPlan",
    "FinetuneStage",
    "resolve_run_plan",
    "resolve_dataset_specs",
    "resolve_threshold_policies",
    "normalise_finetune_mode",
    "POLICY_ALIASES",
    "ALLOWED_POLICIES",
]

POLICY_ALIASES = {
    "youden": "youden_on_val",
    "f1": "f1_opt_on_val",
    "f1-morph": "f1_opt_on_val",
}
ALLOWED_POLICIES = {
    "", "auto", "none",
    "f1_opt_on_val", "youden_on_val", "sun_val_frozen", "val_opt_youden",
}

VALID_FINETUNE_MODES = {"none", "full", "head+1", "head+2"}


def normalise_finetune_mode(raw: Any, default: str = "full") -> str:
    mode = (str(raw).strip().lower() if raw is not None else "") or str(default).strip().lower()
    if mode not in VALID_FINETUNE_MODES:
        raise ValueError(
            f"Unsupported fine-tuning mode {raw!r}; expected one of {sorted(VALID_FINETUNE_MODES)}"
        )
    return mode


@dataclass(frozen=True)
class FinetuneStage:
    name: str
    mode: str
    epochs: int
    head_lr: Optional[float] = None
    backbone_lr: Optional[float] = None


def _sanitize_schedule(raw: Any, default_mode: str) -> Tuple[FinetuneStage, ...]:
    if not raw:
        return ()
    stages: List[FinetuneStage] = []
    for i, entry in enumerate(raw):
        if not isinstance(entry, Mapping):
            raise ValueError("finetune_schedule entries must be mappings")
        epochs = int(entry.get("epochs", 0))
        if epochs <= 0:
            raise ValueError("finetune_schedule stages need positive 'epochs'")
        mode = normalise_finetune_mode(entry.get("mode"), default=default_mode)
        head_lr = entry.get("head_lr", entry.get("lr"))
        stages.append(
            FinetuneStage(
                name=str(entry.get("name", f"stage{i}")),
                mode=mode,
                epochs=epochs,
                head_lr=float(head_lr) if head_lr is not None else None,
                backbone_lr=float(entry["backbone_lr"]) if entry.get("backbone_lr") is not None else None,
            )
        )
    return tuple(stages)


def _normalize_seeds(raw: Any) -> List[int]:
    if raw is None:
        return []
    if isinstance(raw, (int, float)):
        return [int(raw)]
    if isinstance(raw, (list, tuple)):
        return [int(v) for v in raw]
    return []


def resolve_dataset_specs(
    dataset_cfg: Dict[str, Any],
    *,
    percent_override: Optional[int] = None,
    seed_override: Optional[int] = None,
    size_override: Optional[int] = None,
) -> Dict[str, Any]:
    """Resolve per-split pack specs, expanding patterns.

    Reference semantics (``train_classification.py:3992-4071``): subset packs
    template only the train split (val/test come from the base pack);
    few-shot packs template the whole pack.
    """
    splits = dataset_cfg.get("splits", {}) or {}
    train_split = splits.get("train")
    val_split = splits.get("val")
    test_split = splits.get("test")

    base_pack = dataset_cfg.get("pack")
    fallback_pack = dataset_cfg.get("base_pack", base_pack)
    train_pack = dataset_cfg.get("train_pack")
    if train_pack is None and train_split is not None:
        train_pack = base_pack
    val_pack = dataset_cfg.get("val_pack")
    if val_pack is None and val_split is not None:
        val_pack = fallback_pack
    test_pack = dataset_cfg.get("test_pack")
    if test_pack is None:
        test_pack = fallback_pack

    percent = dataset_cfg.get("percent", percent_override)
    seed = dataset_cfg.get("seed", seed_override)
    size = dataset_cfg.get("size", size_override)
    if percent is not None:
        if isinstance(percent, float) and not float(percent).is_integer():
            raise ValueError("Dataset percent must be an integer")
        percent = int(percent)
    if seed is not None:
        seed = int(seed)
    if size is not None:
        size = int(size)

    if "train_pattern" in dataset_cfg:
        if percent is None or seed is None:
            raise ValueError("train_pattern needs 'percent' and 'seed'")
        train_pack = dataset_cfg["train_pattern"].format(percent=percent, seed=seed)

    if "pack_pattern" in dataset_cfg:
        if size is None or seed is None:
            raise ValueError("pack_pattern needs 'size' and 'seed'")
        resolved = dataset_cfg["pack_pattern"].format(size=size, seed=seed)
        train_pack = dataset_cfg.get("train_pack", resolved)
        if val_pack is None:
            val_pack = resolved
        if test_pack is None:
            test_pack = resolved
        dataset_cfg.setdefault("pack", resolved)

    if percent is not None:
        dataset_cfg["percent"] = percent
    if seed is not None:
        dataset_cfg["seed"] = seed
    if size is not None:
        dataset_cfg["size"] = size

    return {
        "train_pack": str(train_pack) if train_pack else None,
        "val_pack": str(val_pack) if val_pack else None,
        "test_pack": str(test_pack) if test_pack else None,
        "train_split": train_split,
        "val_split": val_split,
        "test_split": test_split,
        "percent": percent,
        "seed": seed,
        "size": size,
    }


def resolve_threshold_policies(
    *,
    raw_policy: Optional[str],
    expected_primary: Optional[str],
    sensitivity_policy: Optional[str],
    dataset_name: str,
    binary_task: bool,
    is_exp5a: bool,
) -> Tuple[str, Optional[str]]:
    """Canonicalise policy names, apply the auto table, assert expectations.

    Auto table (reference ``train_classification.py:5796-5804``):
    non-binary → none; exp5a → sun_val_frozen; polypgen_fewshot →
    val_opt_youden; otherwise f1_opt_on_val.
    """
    policy = (raw_policy or "auto").strip().lower()
    policy = POLICY_ALIASES.get(policy, policy)
    if policy not in ALLOWED_POLICIES:
        raise ValueError(
            f"Unsupported threshold policy {policy!r}; allowed: {sorted(ALLOWED_POLICIES)}"
        )
    if policy in {"", "auto"}:
        if not binary_task:
            policy = "none"
        elif is_exp5a:
            policy = "sun_val_frozen"
        elif dataset_name.lower().startswith("polypgen_fewshot"):
            policy = "val_opt_youden"
        else:
            policy = "f1_opt_on_val"

    if expected_primary:
        canonical_expected = POLICY_ALIASES.get(
            expected_primary.strip().lower(), expected_primary.strip().lower()
        )
        if canonical_expected not in {"", "auto"} and canonical_expected != policy:
            raise ValueError(
                f"Experiment requires primary threshold policy {expected_primary!r} "
                f"(canonical {canonical_expected!r}) but resolved {policy!r}."
            )

    if policy in {"f1_opt_on_val", "youden_on_val", "val_opt_youden"} and not binary_task:
        policy = "none"

    sensitivity = None
    if sensitivity_policy:
        lowered = str(sensitivity_policy).strip().lower()
        sensitivity = POLICY_ALIASES.get(lowered, lowered)
        if sensitivity in {"", "auto", "none"}:
            sensitivity = None
    return policy, sensitivity


@dataclass
class RunPlan:
    """Everything the training engine needs, resolved ahead of time."""

    # identity
    experiment: Optional[str]
    model_cfg: Dict[str, Any]
    model_key: Optional[str]
    model_tag: str
    seed: int
    training_seeds: List[int]

    # dataset
    dataset_cfg: Dict[str, Any]
    dataset_resolved: Dict[str, Any]
    dataset_layout: DatasetLayout

    # optimisation
    lr: float = 1e-3
    weight_decay: float = 0.05
    batch_size: int = 128
    epochs: int = 100
    image_size: int = 224
    num_workers: int = 8
    log_interval: int = 10
    # Optimizer steps fused per device dispatch (lax.scan over stacked
    # batches; identical math — see classification.make_train_step).  >1
    # amortises fixed dispatch latency on high-latency links.  0 = "auto":
    # the engine resolves it per backend (4 on accelerators — round-4 A/B
    # measured +1.7% on v5e — 1 on CPU where the fused compile dominates).
    steps_per_call: int = 0
    precision: str = "bf16"
    scheduler: str = "cosine"
    warmup_epochs: int = 5
    min_lr: float = 1e-6
    scheduler_patience: int = 2
    scheduler_factor: float = 0.5

    # early stop
    early_stop_monitor: str = "val_loss"
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    early_stop_min_epochs: int = 0
    early_stop_mode: Optional[str] = None

    # protocol
    finetune_mode: str = "full"
    finetune_schedule: Tuple[FinetuneStage, ...] = ()
    threshold_policy: str = "auto"
    sensitivity_threshold_policy: Optional[str] = None
    expected_primary_policy: Optional[str] = None
    morphology_eval: List[str] = field(default_factory=list)
    curve_export_splits: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    is_exp5a: bool = False
    parent_checkpoint: Optional[str] = None
    init_from: Optional[str] = None
    eval_split: str = "test"
    perturbation_splits: List[str] = field(default_factory=list)
    reporting_inputs_subdir: Optional[str] = None

    # limits (smoke)
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    limit_test_batches: Optional[int] = None
    max_train_steps: Optional[int] = None
    # Include AdamW moments in best-checkpoints (exact-resume fidelity).
    # Disable on hosts with slow device->host paths; last/best params are
    # always saved.
    checkpoint_optimizer_state: bool = True


def _resolve_steps_per_call(raw: Any) -> int:
    """Parse the ``steps_per_call`` config value.

    ``"auto"`` (the default) returns the 0 sentinel — the engine resolves
    it per backend at run time (classification.py), matching the
    ``unroll_blocks`` platform policy.  Explicit integers are clamped ≥ 1.
    """
    if raw is None or (isinstance(raw, str) and raw.strip().lower() == "auto"):
        return 0
    return max(1, int(raw))


def _sanitize_curve_exports(raw: Any) -> Dict[str, Dict[str, Any]]:
    if not isinstance(raw, Mapping):
        return {}
    splits = raw.get("splits") or []
    points = int(raw.get("points", 200) or 200)
    return {str(s).strip().lower(): {"points": points} for s in splits}


def resolve_run_plan(
    experiment_cfg: Mapping[str, Any],
    *,
    model_key: Optional[str] = None,
    seed: Optional[int] = None,
    overrides: Optional[Mapping[str, Any]] = None,
    parent_checkpoint: Optional[str] = None,
    output_dir: Optional[str] = None,
    world_size: Optional[int] = None,
) -> RunPlan:
    cfg = copy.deepcopy(dict(experiment_cfg))
    if overrides:
        cfg = deep_merge(cfg, dict(overrides))

    dataset_cfg = extract_dataset_config(cfg)
    protocol_cfg = cfg.get("protocol") or {}

    # --- model selection -------------------------------------------------
    model_entries = resolve_model_entries(cfg.get("models", []))
    selected: Optional[Dict[str, Any]] = None
    if model_key:
        for entry in model_entries:
            if str(entry.get("key", "")).lower() == str(model_key).lower():
                selected = entry
                break
        if selected is None:
            available = [e.get("key") for e in model_entries]
            raise ValueError(f"Model key {model_key!r} not in experiment models {available}")
    elif len(model_entries) == 1:
        selected = model_entries[0]
    elif model_entries:
        raise ValueError(
            "Experiment defines multiple models; pass model_key to choose one."
        )
    else:
        selected = {}
    resolved_model_key = selected.get("key") or model_key

    # --- seeds ------------------------------------------------------------
    training_seeds = (
        _normalize_seeds(protocol_cfg.get("seeds")) or _normalize_seeds(cfg.get("seeds"))
    )
    if seed is not None:
        active_seed = int(seed)
        if active_seed in training_seeds:
            training_seeds = [active_seed] + [s for s in training_seeds if s != active_seed]
        else:
            training_seeds = [active_seed, *training_seeds]
    elif training_seeds:
        active_seed = training_seeds[0]
    else:
        active_seed = 0
        training_seeds = [0]

    # dataset (pack) seed: explicit wins; else the active training seed when
    # it is one of the declared pack seeds (a config listing several pack
    # seeds pairs them with the training trio); else the first declared
    # pack seed (the shipped configs declare a single pack seed [13], so
    # every training seed runs the same pack — reference semantics); else
    # the active training seed for patterned packs.
    dataset_seed_candidates = _normalize_seeds(dataset_cfg.get("seeds"))
    if dataset_cfg.get("seed") is None:
        if dataset_seed_candidates:
            dataset_cfg["seed"] = (
                active_seed if active_seed in dataset_seed_candidates
                else dataset_seed_candidates[0]
            )
        elif "train_pattern" in dataset_cfg or "pack_pattern" in dataset_cfg:
            dataset_cfg["seed"] = active_seed

    dataset_resolved = resolve_dataset_specs(dataset_cfg)
    dataset_layout = resolve_dataset_layout(dataset_cfg, dataset_resolved, active_seed)

    if "optimizer" in cfg and str(cfg["optimizer"]).lower() != "adamw":
        raise ValueError("Only AdamW is supported")

    # --- fine-tune regime --------------------------------------------------
    frozen_default = bool(selected.get("frozen", False))
    finetune_mode = normalise_finetune_mode(
        protocol_cfg.get("finetune"), default="none" if frozen_default else "full"
    )
    schedule = _sanitize_schedule(protocol_cfg.get("finetune_schedule"), finetune_mode)
    epochs = int(cfg.get("epochs", 100))
    lr = float(cfg.get("lr", 1e-3))
    if schedule:
        schedule_epochs = sum(stage.epochs for stage in schedule)
        if "epochs" in cfg and int(cfg["epochs"]) != schedule_epochs:
            raise ValueError(
                f"Experiment epochs ({cfg['epochs']}) disagree with the fine-tune "
                f"schedule total ({schedule_epochs})."
            )
        epochs = schedule_epochs
        finetune_mode = schedule[0].mode
        if schedule[0].head_lr is not None:
            lr = schedule[0].head_lr

    # --- thresholds (resolved below, after exp5a detection: the auto
    # table needs is_exp5a/dataset identity) -------------------------------
    thresholds_cfg = protocol_cfg.get("thresholds") or {}
    expected_primary = thresholds_cfg.get("primary")

    # --- exp5a detection + canonical parent ---------------------------------
    init_from = protocol_cfg.get("init_from")
    init_key = str(init_from or "").strip().lower()
    dataset_name = str(dataset_cfg.get("name", "")).strip().lower()
    is_exp5a = (
        dataset_name == "polypgen_clean_test"
        and finetune_mode == "none"
        and init_key == "canonical_sun_models"
    )
    resolved_parent = parent_checkpoint
    if init_key == "canonical_sun_models" and not resolved_parent:
        if not resolved_model_key:
            raise ValueError("canonical SUN initialisation requires a model key")
        model_tag = canonicalize_tag(selected.get("key") or selected.get("name") or "model")
        try:
            resolved_parent = str(
                canonical_sun_parent_checkpoint(
                    resolved_model_key, model_tag, active_seed, output_dir
                )
            )
        except KeyError as exc:
            raise ValueError(
                f"Unsupported model {resolved_model_key!r} for canonical SUN init"
            ) from exc

    # --- threshold policy resolution (aliases + auto table + assertion) ----
    binary_task = int(cfg.get("num_classes", dataset_cfg.get("num_classes", 2))) == 2
    threshold_policy, sensitivity_policy = resolve_threshold_policies(
        raw_policy=str(expected_primary or cfg.get("threshold_policy") or "auto"),
        expected_primary=expected_primary,
        sensitivity_policy=thresholds_cfg.get("sensitivity"),
        dataset_name=dataset_name,
        binary_task=binary_task,
        is_exp5a=is_exp5a,
    )

    # --- scheduler / early stop ----------------------------------------------
    scheduler_cfg = cfg.get("scheduler")
    scheduler_name = "none"
    warmup_epochs = 0
    min_lr = 1e-6
    scheduler_patience = 2
    scheduler_factor = 0.5
    if isinstance(scheduler_cfg, str):
        scheduler_name = scheduler_cfg
    elif isinstance(scheduler_cfg, Mapping):
        scheduler_name = str(scheduler_cfg.get("name", "none"))
        warmup_epochs = int(scheduler_cfg.get("warmup_epochs", 0))
        min_lr = float(scheduler_cfg.get("min_lr", 1e-6))
        scheduler_patience = int(scheduler_cfg.get("patience", 2))
        scheduler_factor = float(scheduler_cfg.get("factor", 0.5))

    early_cfg = cfg.get("early_stop") or {}

    # --- batch size (few-shot adaptation) --------------------------------------
    batch_size = int(cfg.get("batch_size", 128))
    recommended = recommend_fewshot_batch_size(dataset_layout)
    if recommended is not None and "batch_size" not in (overrides or {}):
        # The recommendation is PER-DEVICE and REPLACES the configured
        # batch (reference: ``args.batch_size = recommended * world_size``,
        # train_classification.py:5505-5516); our batch_size is global
        # across the ``world_size`` devices.
        if world_size is None:
            world_size = process_count()
        batch_size = recommended * max(1, world_size)

    perturbation_splits: List[str] = []
    if dataset_name == "sun_test_perturbations":
        perturbation_splits = [dataset_resolved.get("test_split") or "test"]

    reporting_cfg = cfg.get("reporting") or {}

    precision = "bf16"
    if cfg.get("amp") is False:
        precision = "fp32"

    plan = RunPlan(
        experiment=(Path(str(cfg.get("__sources__", ["exp"])[-1])).stem if cfg.get("__sources__") else None),
        model_cfg=dict(selected),
        model_key=resolved_model_key,
        model_tag=canonicalize_tag(selected.get("key") or selected.get("name") or "model"),
        seed=active_seed,
        training_seeds=training_seeds,
        dataset_cfg=dict(dataset_cfg),
        dataset_resolved=dataset_resolved,
        dataset_layout=dataset_layout,
        lr=lr,
        weight_decay=float(cfg.get("weight_decay", 0.05)),
        batch_size=batch_size,
        epochs=epochs,
        image_size=int(cfg.get("image_size", 224)),
        num_workers=int(cfg.get("num_workers", 8)),
        log_interval=int(cfg.get("log_interval", 10)),
        steps_per_call=_resolve_steps_per_call(cfg.get("steps_per_call", "auto")),
        precision=precision,
        scheduler=scheduler_name,
        warmup_epochs=warmup_epochs,
        min_lr=min_lr,
        scheduler_patience=scheduler_patience,
        scheduler_factor=scheduler_factor,
        early_stop_monitor=str(early_cfg.get("monitor", "val_loss")),
        early_stop_patience=int(early_cfg.get("patience", 0)),
        early_stop_min_delta=float(early_cfg.get("min_delta", 0.0)),
        early_stop_min_epochs=int(early_cfg.get("min_epochs", 0)),
        early_stop_mode=early_cfg.get("mode"),
        finetune_mode=finetune_mode,
        finetune_schedule=schedule,
        threshold_policy=threshold_policy,
        sensitivity_threshold_policy=sensitivity_policy,
        expected_primary_policy=expected_primary,
        morphology_eval=list(protocol_cfg.get("morphology_eval") or []),
        curve_export_splits=_sanitize_curve_exports(protocol_cfg.get("export_curves")),
        is_exp5a=is_exp5a,
        parent_checkpoint=resolved_parent,
        init_from=init_from,
        eval_split=str(protocol_cfg.get("eval_split", "test")),
        perturbation_splits=perturbation_splits,
        reporting_inputs_subdir=reporting_cfg.get("inputs_subdir"),
        limit_train_batches=cfg.get("limit_train_batches"),
        limit_val_batches=cfg.get("limit_val_batches"),
        limit_test_batches=cfg.get("limit_test_batches"),
        max_train_steps=cfg.get("max_train_steps"),
        checkpoint_optimizer_state=bool(cfg.get("checkpoint_optimizer_state", True)),
    )
    return plan
