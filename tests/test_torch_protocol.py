"""The port's copies of the fine-tune engine's leaf modules against the JAX
package's, on the same inputs: the layered configs, run plans, run layouts
and threshold-store paths of every shipped experiment config, the plateau
scheduler and early stopper on monitor sequences drawn by hypothesis, and
the exporters byte for byte."""

import dataclasses
import hashlib
from pathlib import Path

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ssl4polyp_tpu.configs import layered as jax_layered
from ssl4polyp_tpu.evaluation import exports as jax_exports
from ssl4polyp_tpu.metrics import threshold_store as jax_store
from ssl4polyp_tpu.training import layout as jax_layout
from ssl4polyp_tpu.training import protocol as jax_protocol
from ssl4polyp_tpu.training import schedules as jax_schedules
from ssl4polyp_tpu_torch.configs import layered
from ssl4polyp_tpu_torch.evaluation import exports
from ssl4polyp_tpu_torch.metrics import threshold_store
from ssl4polyp_tpu_torch.training import layout, protocol, schedules

ROOT = Path(__file__).resolve().parents[1]
EXP_CONFIGS = sorted(p.relative_to(ROOT / "config").as_posix()
                     for p in (ROOT / "config" / "exp").rglob("*.yaml"))
# The two configs that are parameterised per run (``--override``): exp4 by
# the subset percent, the bare exp5c by the few-shot budget.
OVERRIDES = {"exp/exp4.yaml": {"dataset": {"percent": 10}},
             "exp/exp5c.yaml": {"dataset": {"size": 50}}}


def _outcome(fn):
    """``fn()``'s value, or the type and text of what it raised."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - compared across the packages
        return ("raised", type(exc).__name__, str(exc))


def _runs(name):
    cfg = jax_layered.load_layered_config(name)
    keys = [str(e.get("key")) for e in jax_layered.resolve_model_entries(cfg.get("models", []))]
    seeds = cfg.get("seeds") or (cfg.get("protocol") or {}).get("seeds") or [13]
    return [(key, int(seed)) for key in keys for seed in seeds]


def test_every_exp_config_is_covered():
    assert len(EXP_CONFIGS) == 12 and "exp/exp2.yaml" in EXP_CONFIGS
    assert all(_runs(name) for name in EXP_CONFIGS)


@pytest.mark.parametrize("name", EXP_CONFIGS)
def test_layered_config_plan_layout_and_threshold_path_match_jax(name, tmp_path):
    cfg = layered.load_layered_config(name)
    want_cfg = jax_layered.load_layered_config(name)
    assert cfg == want_cfg
    for key, seed in _runs(name):
        kwargs = dict(model_key=key, seed=seed, overrides=OVERRIDES.get(name),
                      output_dir="checkpoints/classification")
        # The JAX plan's few-shot batch is per device times its device count.
        plan = _outcome(lambda: protocol.resolve_run_plan(
            cfg, world_size=jax.device_count(), **kwargs))
        want = _outcome(lambda: jax_protocol.resolve_run_plan(want_cfg, **kwargs))
        if isinstance(want, tuple):
            assert plan == want, (name, key, seed)
            continue
        # FinetuneStage, DatasetLayout: compared by their fields.
        assert dataclasses.asdict(plan) == dataclasses.asdict(want), (name, key, seed)
        assert type(plan.finetune_schedule) is tuple
        assert all(isinstance(s, protocol.FinetuneStage) for s in plan.finetune_schedule)

        def run_layout(module, p):
            return module.resolve_run_layout(
                output_dir=tmp_path / "out", model_tag=p.model_tag, dataset_cfg=p.dataset_cfg,
                dataset_resolved=p.dataset_resolved, seed=p.seed,
                parent_checkpoint=p.parent_checkpoint, init_from=p.init_from)

        ours, theirs = run_layout(layout, plan), run_layout(jax_layout, want)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), (name, key, seed)
        assert layout.format_selection_tag(plan.early_stop_monitor) == \
            jax_layout.format_selection_tag(want.early_stop_monitor)
        store = dict(val_pack=plan.dataset_resolved.get("val_pack"), model_tag=plan.model_tag,
                     arch=plan.model_cfg.get("arch"),
                     pretraining=plan.model_cfg.get("pretraining"),
                     train_pack=plan.dataset_resolved.get("train_pack"), seed=plan.seed,
                     policy=plan.threshold_policy)
        assert threshold_store.canonical_threshold_path(tmp_path, **store) == \
            jax_store.canonical_threshold_path(tmp_path, **store)


def test_exp2_plans_are_the_studys():
    cfg = layered.load_layered_config("exp/exp2")
    for key in ("ssl_imnet", "ssl_colon"):
        plan = protocol.resolve_run_plan(cfg, model_key=key, seed=47)
        assert plan.threshold_policy == "f1_opt_on_val"
        assert plan.sensitivity_threshold_policy == "youden_on_val"
        assert plan.dataset_layout.data_tag == "SUNFull" and plan.steps_per_call == 0
    assert plan.model_cfg["checkpoint"] == "checkpoints/pretrained/vit_b/mae_hyperkvasir.ckpt"
    # One device: the few-shot batch is the per-device recommendation itself.
    fewshot = protocol.resolve_run_plan(layered.load_layered_config("exp/exp5c/budgets/s50"),
                                        model_key="ssl_colon", seed=13)
    assert fewshot.batch_size == 4


MONITOR = st.lists(st.one_of(st.floats(0.0, 2.0, allow_nan=False),
                             st.sampled_from([0.5, 0.50005, 0.5001, 0.4999])),
                   min_size=1, max_size=30)


@settings(max_examples=60, deadline=None)
@given(values=MONITOR, patience=st.integers(-1, 4), min_delta=st.sampled_from([0.0, 1e-4, 0.05]),
       min_epochs=st.integers(0, 5), mode=st.sampled_from(["min", "max"]),
       split=st.integers(0, 30))
def test_early_stopper_matches_jax(values, patience, min_delta, min_epochs, mode, split):
    kwargs = dict(patience=patience, min_delta=min_delta, min_epochs=min_epochs, mode=mode)
    ours, theirs = schedules.EarlyStopper(**kwargs), jax_schedules.EarlyStopper(**kwargs)
    for epoch, value in enumerate(values):
        if epoch == split:  # a resume: the state carried across into fresh ones
            ours = schedules.EarlyStopper(**kwargs)
            ours.load_state_dict(theirs.state_dict())
        assert ours.update(epoch, value) == theirs.update(epoch, value)
        assert ours.state_dict() == theirs.state_dict()
        assert (ours.best, ours.best_epoch) == (theirs.best, theirs.best_epoch)


@settings(max_examples=60, deadline=None)
@given(values=MONITOR, patience=st.integers(0, 4), factor=st.sampled_from([0.1, 0.5]),
       mode=st.sampled_from(["min", "max"]), min_lr=st.sampled_from([0.0, 1e-6, 3e-4]),
       split=st.integers(0, 30))
def test_plateau_scheduler_and_constant_match_jax(values, patience, factor, mode, min_lr, split):
    kwargs = dict(factor=factor, patience=patience, mode=mode, min_lr=min_lr)
    ours, theirs = schedules.PlateauScheduler(**kwargs), jax_schedules.PlateauScheduler(**kwargs)
    for epoch, value in enumerate(values):
        if epoch == split:
            ours = schedules.PlateauScheduler(**kwargs)
            ours.load_state_dict(theirs.state_dict())
        assert ours.step(value) == theirs.step(value)
        assert ours.state_dict() == theirs.state_dict()
        assert ours.scale(1e-3) == theirs.scale(1e-3)
    assert [schedules.constant(3e-4)(s) for s in (0, 7, 10**6)] == \
        [jax_schedules.constant(3e-4)(s) for s in (0, 7, 10**6)]
    cosine, want = schedules.warmup_cosine(1e-3, 50, 5, 1e-6), \
        jax_schedules.warmup_cosine(1e-3, 50, 5, 1e-6)
    assert [cosine(s) for s in range(60)] == [want(s) for s in range(60)]


def _rows(rng, n, dataset):
    variants = ["", "clean", "blur_1p5", "jpeg_30", "bc_b0p7_c0p7"]
    rows = []
    for i in range(n):
        row = {"frame_id": f"f{i}", "case_id": f"case_{i % 3}", "morphology": ["flat", ""][i % 2],
               "origin": "store", "variant": variants[i % 5] if dataset == "perturbed" else ""}
        if dataset.startswith("polypgen"):
            row.update(frame_id=f"C{i % 4}_seq{i % 2}_{i}", center_id=f"C{i % 4}")
        rows.append(row)
    return rows


@pytest.mark.parametrize("dataset", ["sun_full", "polypgen_clean_test", "polypgen_fewshot_s50",
                                     "perturbed"])
def test_exported_files_are_byte_equal(dataset, tmp_path):
    rng = np.random.default_rng(len(dataset))
    n = 37
    probs = rng.random(n)
    probs[:3] = [0.0, 1.0, 0.5]
    targets = rng.integers(0, 2, n)
    preds = (probs >= 0.5).astype(int)
    rows = _rows(rng, n, dataset)
    results = {}
    for name, module in (("port", exports), ("jax", jax_exports)):
        out = module.export_frame_outputs(tmp_path / name / "run_test_outputs.csv",
                                          metadata_rows=rows, probabilities=probs,
                                          targets=targets, preds=preds, dataset_name=dataset)
        curves = module.export_curve_sets(tmp_path / name / "run", "test", probabilities=probs,
                                          targets=targets, grid_points=57)
        results[name] = (out, curves)
    (out, curves), (want_out, want_curves) = results["port"], results["jax"]
    assert curves == want_curves and out.sha256 == want_out.sha256
    for file in ("run_test_outputs.csv", "run_test_roc_curve.csv", "run_test_pr_curve.csv"):
        data = (tmp_path / "port" / file).read_bytes()
        assert data == (tmp_path / "jax" / file).read_bytes(), file
        assert exports.sha256_file(tmp_path / "port" / file) == hashlib.sha256(data).hexdigest()
    assert out.sha256 == exports.sha256_file(tmp_path / "port" / "run_test_outputs.csv")
    # Not the primary process: the same digests, nothing written.
    quiet = exports.export_frame_outputs(tmp_path / "quiet" / "x.csv", metadata_rows=rows,
                                         probabilities=probs, targets=targets, preds=preds,
                                         dataset_name=dataset, primary=False)
    quiet_curves = exports.export_curve_sets(tmp_path / "quiet" / "run", "test",
                                             probabilities=probs, targets=targets,
                                             grid_points=57, primary=False)
    assert quiet.sha256 == out.sha256 and quiet_curves == curves
    assert not (tmp_path / "quiet").exists()


def test_metric_blocks_match_jax(tmp_path):
    summary = {
        "train": {"csv_path": "/packs/sun_subsets/sun_p10/train.csv", "csv_sha256": "a" * 64,
                  "pack_spec": "sun_subsets/sun_p10", "manifest_path": "/packs/m.yaml",
                  "n_frames": 16},
        "val": {"csv_path": "/packs/sun_full/val.csv", "csv_sha256": "b" * 64, "n_frames": 8},
        "test": {"path": "/packs/sun_full/test.csv", "sha256": "c" * 64},
    }
    for module in (exports, jax_exports):
        assert module.normalise_manifest_path("/packs/sun_full/val.csv") == \
            jax_exports.normalise_manifest_path("/packs/sun_full/val.csv")
    assert exports.build_data_block(summary) == jax_exports.build_data_block(summary)
    run = dict(experiment="exp2", experiment_config="config/exp/exp2.yaml",
               stem="SslColon_SUNFull_s47", model="SslColon", arch="vit_b",
               pretraining="Hyperkvasir", finetune_mode="full", selection="valLoss", seed=47,
               mode="train", world_size=1)
    assert exports.build_run_block(**run) == jax_exports.build_run_block(**run)
    assert exports.build_run_block(mode="eval") == jax_exports.build_run_block(mode="eval")
    provenance = dict(model="ssl_colon", arch="vit_b", train_seed=47, dataset_summary=summary,
                      test_outputs_csv="x.csv", test_outputs_sha256="d" * 64,
                      zero_shot_outputs_csv="z.csv", zero_shot_outputs_sha256="e" * 64,
                      subset_percent=10, pack_seed=3, fewshot_budget=50, test_split="test",
                      parent_run={"checkpoint": "p.ckpt"})
    assert exports.build_provenance_block(**provenance) == \
        jax_exports.build_provenance_block(**provenance)
    bare = dict(model=None, arch=None, train_seed=1, dataset_summary={})
    assert exports.build_provenance_block(**bare) == jax_exports.build_provenance_block(**bare)
    thresholds = dict(policy="f1_opt_on_val", primary={"tau": 0.25, "policy": "f1_opt_on_val"},
                      sensitivity={"tau": 0.5}, sources={"val": "k", "test": ""})
    values = {"k": 0.25, "j": 0.5, "nan": float("nan"), "s": "x"}
    assert exports.build_thresholds_block(values, **thresholds) == \
        jax_exports.build_thresholds_block(values, **thresholds)
    assert exports.build_thresholds_block() == jax_exports.build_thresholds_block()
    metrics = {"auroc": np.float32(0.75), "tp": 3.0, "n_pos": np.int64(7), "n_total": 12.2,
               "loss": None, "name": "x", "_private": 1, "probabilities": np.ones(3),
               "curve": [1, 2], "nested": {"a": 1}, "f1": float("nan"), "count": 4.6}
    ours, theirs = exports.metric_block_for_export(metrics), \
        jax_exports.metric_block_for_export(metrics)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert type(ours[key]) is type(theirs[key]), key
        assert ours[key] == theirs[key] or (ours[key] != ours[key] and theirs[key] != theirs[key])
