"""The port's fine-tune engine (``build_run``, ``run_classification_training``)
on the CPU: each test of the JAX engine's ``test_classification_engine.py`` and
``test_exp_flows.py`` through the port, every port ``metrics.json`` through the
JAX package's guardrails, ``steps_per_call`` bit for bit, and the two engines
against each other: the same weights at lr 0 in fp32, the port's checkpoint
through both eval CLIs, parents across the packages, and a port resume of a
JAX run.  The tiny ViT (D 32, depth 2, 2 heads, patch 8) on 32-px packs."""

import csv
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.analysis.guardrails import GuardrailViolation, ResultLoader
from ssl4polyp_tpu.evaluation import eval_classification as jax_eval
from ssl4polyp_tpu.training import classification as jax_engine
from ssl4polyp_tpu.training import protocol as jax_proto
from ssl4polyp_tpu_torch.evaluation import eval_classification
from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
from ssl4polyp_tpu_torch.training import classification
from ssl4polyp_tpu_torch.training import protocol as proto
from ssl4polyp_tpu_torch.training.classification import build_run, run_classification_training
from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.conftest import make_image_pack
from tests.test_classification_engine import TINY_MODEL, tiny_cfg

# The two engines' fp32 forwards differ by summation order and the JAX
# GELU's polynomial erf (max error 2.2e-6): metric blocks to 1e-5 relative,
# the per-frame probabilities to 1e-6.
BLOCK_RTOL = 1e-5
PROB_ATOL = 1e-6
# The JAX eval CLI against the port's on one checkpoint: tau and metrics.
EVAL_TOL = 1e-6


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("packs") / "data_packs"
    root.mkdir()
    make_image_pack(root, name="sun_full", frames_per_split=16, image_size=32)
    return root


def run_port(cfg, packs, out_dir, *, model_key="sup_imnet", parent=None, resume=False,
             weights=None):
    """One port run of the tiny model on the CPU; ``weights`` (a JAX
    parameter tree) replace the random initial ones."""
    plan = proto.resolve_run_plan(cfg, model_key=model_key, seed=13, parent_checkpoint=parent)
    ctx = build_run(plan, output_dir=out_dir, pack_root=packs, model_overrides=TINY_MODEL,
                    exp_config_name="exp/test_exp.yaml", device="cpu")
    if weights is not None:
        incoming = state_dict_from_jax(weights, ctx.classifier.cfg)
        with torch.no_grad():
            for name, tensor in ctx.params.items():
                tensor.copy_(incoming[name])
    summary = run_classification_training(ctx, thresholds_root=Path(out_dir) / "thresholds",
                                          resume=resume)
    return ctx, summary


def run_jax(cfg, packs, out_dir, *, parent=None):
    plan = jax_proto.resolve_run_plan(cfg, model_key="sup_imnet", seed=13,
                                      parent_checkpoint=parent)
    ctx = jax_engine.build_run(plan, output_dir=out_dir, pack_root=packs,
                               model_overrides=TINY_MODEL, exp_config_name="exp/test_exp.yaml")
    return ctx, jax_engine.run_classification_training(
        ctx, thresholds_root=Path(out_dir) / "thresholds")


def validate(exp_id, summary):
    path = Path(summary["metrics_path"])
    payload = json.loads(path.read_text())
    ResultLoader(exp_id=exp_id, strict=True).validate(path, payload)
    return payload


def checkpoints(run_dir):
    return {p.name: load_checkpoint(p) for p in sorted(Path(run_dir).glob("*_e*_*.ckpt"))}


def tree_differences(a, b, prefix=""):
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{prefix}: keys {sorted(set(a) ^ set(b))}"]
        return [d for key in a for d in tree_differences(a[key], b[key], f"{prefix}/{key}")]
    a, b = np.asarray(a), np.asarray(b)
    same = a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return [] if same else [prefix]


def capture_first_step(monkeypatch):
    """Record the train state's masters, moments and step as the first step
    of the next run sees them."""
    seen = {}
    build = classification.make_train_step

    def recording_make_step(ctx):
        step = build(ctx)

        def wrapped(state, *args):
            if not seen:
                seen.update(params={n: t.clone() for n, t in state.params.items()},
                            mu={n: t.clone() for n, t in state.opt.mu.items()},
                            nu={n: t.clone() for n, t in state.opt.nu.items()},
                            step=state.opt.step)
            return step(state, *args)
        return wrapped

    monkeypatch.setattr(classification, "make_train_step", recording_make_step)
    return seen


def assert_restored(seen, checkpoint_path, cfg):
    """The first step's state equals the checkpoint's bits."""
    payload = load_checkpoint(checkpoint_path)["payload"]
    for key, tree in (("params", payload["params"]), ("mu", payload["opt"]["mu"]),
                      ("nu", payload["opt"]["nu"])):
        want = state_dict_from_jax(tree, cfg)
        wrong = [n for n, t in seen[key].items() if not torch.equal(t, want[n])]
        assert not wrong, (key, wrong)
    assert seen["step"] == int(payload["opt"]["step"])


@pytest.fixture(scope="module")
def port_run(packs, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("port") / "out"
    return run_port(tiny_cfg(), packs, out_dir)


@pytest.fixture(scope="module")
def jax_lr0_run(packs, tmp_path_factory):
    """One JAX run at lr 0 in fp32, shared by the cross-package tests."""
    out_dir = tmp_path_factory.mktemp("jax") / "out"
    return run_jax(lr0_cfg(), packs, out_dir)


def lr0_cfg(**extra):
    """lr 0 at every step: the cosine's floor is 0 too."""
    return tiny_cfg(lr=0.0, scheduler={"name": "cosine", "warmup_epochs": 1, "min_lr": 0.0},
                    **extra)


# ---------------------------------------------------------------------------
# test_classification_engine.py through the port
# ---------------------------------------------------------------------------

def test_full_finetune_run(port_run):
    ctx, summary = port_run
    out_dir = ctx.layout.base_dir
    assert summary["epochs_run"] == 2
    assert summary["tau"] is not None

    run_dir = ctx.layout.output_dir
    stem = ctx.layout.stem
    assert stem == "SupImnet_SUNFull_s13"
    assert (run_dir / f"{stem}.metrics.json").exists()
    assert (run_dir / f"{stem}_test_outputs.csv").exists()
    assert (run_dir / f"{stem}.ckpt").exists()  # best pointer
    assert (run_dir / f"{stem}_last.ckpt").exists()
    assert (run_dir / f"{stem}_test_roc_curve.csv").exists()
    assert (run_dir / f"{stem}_test_pr_curve.csv").exists()
    assert (run_dir / f"{stem}.config.yaml").exists()

    payload = json.loads((run_dir / f"{stem}.metrics.json").read_text())
    for block in ("thresholds", "data", "test_primary", "val", "run", "provenance"):
        assert block in payload, f"missing {block}"
    assert payload["data"]["val"]["path"] == "sun_full/val"
    assert payload["thresholds"]["primary"]["policy"] == "f1_opt_on_val"
    assert payload["thresholds"]["primary"]["split"] == "sun_full/val"
    assert payload["thresholds"]["sensitivity"]["policy"] == "youden_on_val"
    assert "test_sensitivity" in payload
    tp = payload["test_primary"]
    assert tp["tp"] + tp["fp"] + tp["tn"] + tp["fn"] == tp["n_pos"] + tp["n_neg"]
    assert payload["curve_exports"]["test"]["path"].endswith("_roc_curve.csv")
    assert payload["run"]["world_size"] == 1

    header = (run_dir / f"{stem}_test_outputs.csv").read_text().splitlines()[0]
    assert header == "frame_id,prob,label,pred,case_id,origin,center_id,sequence_id,morphology"
    assert payload["provenance"]["test_outputs_csv_sha256"] == classification.exports.sha256_file(
        run_dir / f"{stem}_test_outputs.csv")

    stores = list((out_dir / "thresholds").rglob("policy-*.json"))
    assert stores, "no canonical threshold file written"
    # The best epoch's tau is tested and recorded with its checkpoint.
    best = load_checkpoint(ctx.layout.checkpoint_path)
    assert best["meta"]["thresholds"]["primary"]["tau"] == summary["tau"]
    assert best["meta"]["model_cfg"]["pad_tokens_to"] == 24  # 17 tokens, to the next 8
    assert set(best["payload"]) == {"params", "opt"}
    assert set(load_checkpoint(run_dir / f"{stem}_last.ckpt")["payload"]) == {"params"}
    timings = summary["timings"]
    assert timings["train_images"] == 2 * 2 * 8 and timings["train_s"] > 0
    assert [name for name, *_ in timings["saves"]][-1] == f"{stem}_last_e01_valLoss.ckpt"
    assert all(snapshot > 0 and write > 0 for _, snapshot, write in timings["saves"])
    validate("exp1", summary)


def test_frozen_tau_eval_only(port_run, packs, tmp_path):
    parent_ctx, parent_summary = port_run
    out_dir = tmp_path / "out"
    make_image_pack(packs, name="polypgen_clean_test", frames_per_split=12, image_size=32)
    cfg = tiny_cfg("polypgen_clean_test")
    cfg["dataset"]["splits"] = {"test": "test"}
    cfg["protocol"] = {
        "finetune": "none",
        "init_from": "canonical_sun_models",
        "thresholds": {"primary": "sun_val_frozen"},
    }
    cfg["threshold_policy"] = "sun_val_frozen"
    plan = proto.resolve_run_plan(
        cfg, model_key="sup_imnet", seed=13,
        parent_checkpoint=str(parent_ctx.layout.checkpoint_path),
    )
    assert plan.is_exp5a
    ctx2 = build_run(plan, output_dir=out_dir, pack_root=packs, model_overrides=TINY_MODEL,
                     device="cpu")
    assert ctx2.eval_only
    assert ctx2.class_weights == [1.0, 1.0] and ctx2.pos_weight == 1.0
    summary2 = run_classification_training(ctx2)

    payload = json.loads(Path(summary2["metrics_path"]).read_text())
    assert payload["eval_only"] is True
    assert payload["thresholds"]["primary"]["policy"] == "sun_val_frozen"
    assert payload["thresholds"]["primary"]["source_split"] == "sun_full/val"
    assert payload["thresholds"]["primary"]["tau"] == pytest.approx(parent_summary["tau"])
    assert "test_primary" in payload
    assert "val" not in payload
    assert "parent_run" in payload["provenance"]
    run_dir = Path(summary2["metrics_path"]).parent
    stem2 = summary2["stem"]
    header = (run_dir / f"{stem2}_test_outputs.csv").read_text().splitlines()[0]
    assert header == "frame_id,prob,label,pred,origin,center_id,sequence_id"
    validate("exp5a", summary2)


def test_head_only_freeze_keeps_backbone(packs, tmp_path):
    cfg = tiny_cfg()
    cfg["protocol"]["finetune"] = "none"
    cfg["epochs"] = 1
    plan = proto.resolve_run_plan(cfg, model_key="sup_imnet", seed=13)
    ctx = build_run(plan, output_dir=tmp_path / "out", pack_root=packs,
                    model_overrides=TINY_MODEL, device="cpu")
    before = ctx.params["patch_embed.proj.weight"].clone()
    head_before = ctx.params["head.weight"].clone()
    run_classification_training(ctx)
    after = load_checkpoint(ctx.layout.checkpoint_path)["payload"]["params"]
    want = state_dict_from_jax(after, ctx.classifier.cfg)
    assert torch.equal(want["patch_embed.proj.weight"], before)
    assert not torch.equal(want["head.weight"], head_before)


def test_resume_continues_training(packs, tmp_path, monkeypatch):
    """A second invocation with resume=True picks up at the best epoch + 1,
    from the checkpoint's masters and moments."""
    out_dir = tmp_path / "out"
    first_ctx, first = run_port(tiny_cfg(epochs=1), packs, out_dir)
    assert first["epochs_run"] == 1

    seen = capture_first_step(monkeypatch)
    ctx2, second = run_port(tiny_cfg(epochs=2), packs, out_dir, resume=True)
    log_text = (ctx2.layout.output_dir / f"{ctx2.layout.stem}.log").read_text()
    assert "resumed from SupImnet_SUNFull_s13.ckpt at epoch 1" in log_text
    assert second["epochs_run"] == 2
    assert second["timings"]["train_images"] == 2 * 8  # only epoch 1 ran
    assert_restored(seen, first_ctx.layout.output_dir / "SupImnet_SUNFull_s13_e00_valLoss.ckpt",
                    ctx2.classifier.cfg)


@pytest.mark.parametrize("steps_per_call", [2, 3])
def test_steps_per_call_is_bit_equal(port_run, packs, tmp_path, steps_per_call):
    """16 frames / batch 8 = 2 steps an epoch: K = 2 takes them as one round
    of two calls, K = 3 as a tail round of single calls with no filler step.
    Every checkpoint (params, mu, nu, step) and the outputs CSV equal the
    K = 1 run's bit for bit."""
    base_ctx, base = port_run
    cfg = tiny_cfg()
    cfg["steps_per_call"] = steps_per_call
    ctx, summary = run_port(cfg, packs, tmp_path / "k")
    ours, theirs = checkpoints(ctx.layout.output_dir), checkpoints(base_ctx.layout.output_dir)
    assert ours.keys() == theirs.keys() and len(ours) >= 2
    for name in ours:
        assert not tree_differences(ours[name]["payload"], theirs[name]["payload"]), name
    stem = ctx.layout.stem
    assert (ctx.layout.output_dir / f"{stem}_test_outputs.csv").read_bytes() == \
        (base_ctx.layout.output_dir / f"{stem}_test_outputs.csv").read_bytes()
    assert summary["tau"] == base["tau"]
    m1, m2 = (json.loads(Path(s["metrics_path"]).read_text()) for s in (summary, base))
    assert m1["val"] == m2["val"] and m1["test_primary"] == m2["test_primary"]


# ---------------------------------------------------------------------------
# test_exp_flows.py through the port
# ---------------------------------------------------------------------------

def test_exp5c_schedule_and_zero_shot(port_run, packs, tmp_path):
    parent_ctx, parent_summary = port_run
    fs_dir = packs / "polypgen_fewshot"
    fs_dir.mkdir(exist_ok=True)
    make_image_pack(fs_dir, name="polypgen_fewshot_s50", frames_per_split=8, image_size=32)

    cfg = tiny_cfg("polypgen_fewshot")
    cfg["dataset"] = {
        "name": "polypgen_fewshot",
        "pack_pattern": "polypgen_fewshot/polypgen_fewshot_s{size}",
        "size": 50,
        "seeds": [13],
        "splits": {"train": "train", "val": "val", "test": "test"},
    }
    del cfg["epochs"]
    cfg["protocol"] = {
        "init_from": "canonical_sun_models",
        "eval_split": "test",
        "thresholds": {"primary": "sun_val_frozen", "sensitivity": "val_opt_youden"},
        "finetune_schedule": [
            {"name": "head_warmup", "mode": "none", "epochs": 1, "head_lr": 5e-4},
            {"name": "refine", "mode": "head+1", "epochs": 1, "head_lr": 5e-4,
             "backbone_lr": 5e-6},
        ],
    }
    cfg["threshold_policy"] = "sun_val_frozen"
    plan = proto.resolve_run_plan(
        cfg, model_key="sup_imnet", seed=13,
        parent_checkpoint=str(parent_ctx.layout.checkpoint_path),
    )
    assert plan.epochs == 2
    assert plan.batch_size == 4  # the per-device few-shot cap, on one device
    ctx2 = build_run(plan, output_dir=tmp_path / "out", pack_root=packs,
                     model_overrides=TINY_MODEL, device="cpu")
    summary = run_classification_training(ctx2)

    payload = json.loads(Path(summary["metrics_path"]).read_text())
    assert "zero_shot" in payload
    assert payload["zero_shot"]["tau"] == pytest.approx(parent_summary["tau"])
    zs_csv = Path(summary["metrics_path"]).parent / f"{summary['stem']}_zeroshot_outputs.csv"
    assert zs_csv.exists()
    assert payload["thresholds"]["primary"]["policy"] == "sun_val_frozen"
    assert payload["thresholds"]["sensitivity"]["policy"] == "val_opt_youden"
    assert "test_sensitivity" in payload
    assert "from" in summary["stem"]
    assert payload["provenance"]["fewshot_budget"] == 50
    assert "parent_run" in payload["provenance"]
    log_text = (ctx2.layout.output_dir / f"{ctx2.layout.stem}.log").read_text()
    assert "entering stage 'refine' (mode head+1) at epoch 1" in log_text
    validate("exp5c", summary)


def test_exp5b_perturbation_eval(port_run, packs, tmp_path):
    parent_ctx, parent_summary = port_run
    make_image_pack(packs, name="sun_test_perturbations", frames_per_split=10,
                    image_size=32, variant_rows=True)
    cfg = tiny_cfg("sun_test_perturbations")
    cfg["dataset"] = {
        "name": "sun_test_perturbations",
        "pack": "sun_test_perturbations",
        "splits": {"test": "test"},
    }
    cfg["protocol"] = {
        "init_from": "canonical_sun_models",
        "finetune": "none",
        "eval_split": "test",
        "thresholds": {"primary": "sun_val_frozen", "sensitivity": "sun_val_frozen"},
    }
    cfg["threshold_policy"] = "sun_val_frozen"
    plan = proto.resolve_run_plan(
        cfg, model_key="sup_imnet", seed=13,
        parent_checkpoint=str(parent_ctx.layout.checkpoint_path),
    )
    assert plan.perturbation_splits == ["test"]
    ctx2 = build_run(plan, output_dir=tmp_path / "out", pack_root=packs,
                     model_overrides=TINY_MODEL, device="cpu")
    assert ctx2.eval_only
    assert ctx2.datasets["test"].perturbations_enabled
    summary = run_classification_training(ctx2)

    payload = json.loads(Path(summary["metrics_path"]).read_text())
    assert payload["eval_only"] is True
    per_tag = payload["test_perturbations"]["per_tag"]
    assert "clean" in per_tag
    assert "ALL-perturbed" in per_tag
    assert any(t.startswith("blur") for t in per_tag)
    assert "per_case" in payload["test_perturbations"]
    assert payload["thresholds"]["primary"]["tau"] == pytest.approx(parent_summary["tau"])
    # Both engines write the frozen sensitivity record and test block that
    # exp5b asks for, and the JAX guardrails' exp5b spec has no sensitivity
    # entry: each payload fails strict validation on those two alone.
    _, jax_summary = run_jax(cfg, packs, tmp_path / "jax",
                             parent=str(parent_ctx.layout.checkpoint_path))
    for summary in (summary, jax_summary):
        path = Path(summary["metrics_path"])
        payload = json.loads(path.read_text())
        with pytest.raises(GuardrailViolation, match="unexpected thresholds.sensitivity"):
            ResultLoader(exp_id="exp5b", strict=True).validate(path, payload)
        payload["thresholds"].pop("sensitivity")
        with pytest.raises(GuardrailViolation, match="unexpected test_sensitivity block"):
            ResultLoader(exp_id="exp5b", strict=True).validate(path, payload)
        payload.pop("test_sensitivity")
        ResultLoader(exp_id="exp5b", strict=True).validate(path, payload)


def test_exp3_morphology_strata(packs, tmp_path):
    cfg = tiny_cfg(epochs=1)
    cfg["protocol"]["morphology_eval"] = ["flat", "polypoid"]
    plan = proto.resolve_run_plan(cfg, model_key="sup_imnet", seed=13)
    assert plan.morphology_eval == ["flat", "polypoid"]
    ctx, summary = run_port(cfg, packs, tmp_path / "out")
    payload = json.loads(Path(summary["metrics_path"]).read_text())
    strata = payload["test_morphology"]
    assert set(strata) == {"flat", "polypoid"}
    for block in strata.values():
        assert "recall" in block and "count" in block
    validate("exp1", summary)


def test_eval_cli_threshold_pack_recompute(port_run, packs, tmp_path):
    """--threshold-pack triggers a Youden recompute when no tau is stored."""
    ctx, _ = port_run
    restored = load_checkpoint(ctx.layout.checkpoint_path)
    bare = tmp_path / "bare.ckpt"
    save_checkpoint(bare, {"params": restored["payload"]["params"]},
                    {"model_cfg": restored["meta"]["model_cfg"]})
    result = eval_classification.evaluate(
        bare, packs / "sun_full", batch_size=8, image_size=32,
        threshold_pack=packs / "sun_full", num_workers=1, device="cpu",
    )
    assert result["tau"] is not None
    assert 0.0 <= result["tau"] <= 1.0


def test_exp4_subset_percent_flow(packs, tmp_path):
    subsets = packs / "sun_subsets"
    subsets.mkdir(exist_ok=True)
    make_image_pack(subsets, name="sun_p10", frames_per_split=8, image_size=32)

    cfg = tiny_cfg("sun_subsets", epochs=1)
    cfg["dataset"] = {
        "name": "sun_subsets",
        "base_pack": "sun_full",
        "available_percents": [5, 10, 25, 50, 100],
        "train_pattern": "sun_subsets/sun_p{percent:02d}",
        "seeds": [13],
        "splits": {"train": "train", "val": "val", "test": "test"},
        "percent": 10,
    }
    cfg["protocol"]["subset_percents"] = [5, 10, 25, 50, 100]
    plan = proto.resolve_run_plan(cfg, model_key="sup_imnet", seed=13)
    assert plan.dataset_resolved["percent"] == 10
    ctx = build_run(plan, output_dir=tmp_path / "out", pack_root=packs,
                    model_overrides=TINY_MODEL, device="cpu")
    assert "sun_p10" in str(ctx.datasets["train"].provenance.get("csv_path"))
    assert "sun_full" in str(ctx.datasets["val"].provenance.get("csv_path"))
    assert "sun_full" in str(ctx.datasets["test"].provenance.get("csv_path"))
    summary = run_classification_training(ctx)

    payload = validate("exp4", summary)
    assert payload["provenance"]["subset_percent"] == 10.0
    assert payload["data"]["train"]["path"] == "sun_subsets/sun_p10/train"
    assert payload["data"]["val"]["path"] == "sun_full/val"
    assert "p10" in summary["stem"].lower()


def test_exp2_protocol_flow(packs, tmp_path):
    cfg = tiny_cfg(epochs=1)
    cfg["models"] = [
        {"model": {"key": "ssl_imnet", "arch": "vit_b", "pretraining": "random"}},
        {"model": {"key": "ssl_colon", "arch": "vit_b", "pretraining": "random"}},
    ]
    cfg["protocol"]["comparison"] = "domain_vs_generic"
    cfg["reporting"] = {"inputs_subdir": "exp2_sun_baselines_sslcolon_vs_sslimnet"}
    stems = []
    for model in ("ssl_imnet", "ssl_colon"):
        plan = proto.resolve_run_plan(cfg, model_key=model, seed=13)
        assert plan.threshold_policy == "f1_opt_on_val"
        assert plan.sensitivity_threshold_policy == "youden_on_val"
        _, summary = run_port(cfg, packs, tmp_path / "out", model_key=model)
        stems.append(summary["stem"])
        payload = validate("exp2", summary)
        assert payload["provenance"]["model"] == model
        assert "test_sensitivity" in payload
    assert stems[0] != stems[1]


# ---------------------------------------------------------------------------
# The two engines against each other
# ---------------------------------------------------------------------------

def _rows(path):
    with open(path, newline="") as handle:
        return list(csv.DictReader(handle))


def _assert_blocks_close(ours, theirs, what):
    assert ours.keys() == theirs.keys(), what
    for key, want in theirs.items():
        got = ours[key]
        if key in {"tp", "fp", "tn", "fn", "n_pos", "n_neg", "n_total", "count"}:
            assert got == want, (what, key)
        elif isinstance(want, float) and np.isfinite(want):
            assert got == pytest.approx(want, rel=BLOCK_RTOL, abs=1e-12), (what, key)
        elif isinstance(want, list):  # the logits, per frame
            np.testing.assert_allclose(got, want, rtol=BLOCK_RTOL, atol=PROB_ATOL,
                                       err_msg=f"{what} {key}")
        else:
            assert got == want or (got != got and want != want), (what, key)


def test_lr0_fp32_runs_of_both_engines_agree(jax_lr0_run, packs, tmp_path):
    """(a) The same weights at lr 0 in fp32 through both engines: the model
    never moves, so validation and test see one function in two frameworks."""
    jax_ctx, jax_summary = jax_lr0_run
    # The JAX run's starting weights: its best checkpoint (epoch 0) and its
    # last hold them, since no step moved them.
    weights = load_checkpoint(jax_ctx.layout.checkpoint_path)["payload"]["params"]
    jax_last = load_checkpoint(jax_ctx.layout.output_dir / "SupImnet_SUNFull_s13_last.ckpt")
    assert not tree_differences(jax_last["payload"]["params"], weights)
    ctx, summary = run_port(lr0_cfg(), packs, tmp_path / "out", weights=weights)
    ours = json.loads(Path(summary["metrics_path"]).read_text())
    theirs = json.loads(Path(jax_summary["metrics_path"]).read_text())
    for block in ("val", "test_primary", "test_sensitivity"):
        _assert_blocks_close(ours[block], theirs[block], block)
    # tau is the score of one validation frame (or 0 or 1), so it carries
    # that frame's fp32 difference: the same frame chosen, its score within
    # PROB_ATOL, and the confusion counts at it identical.
    for policy in ("primary", "sensitivity"):
        got, want = ours["thresholds"][policy], theirs["thresholds"][policy]
        assert got["tau"] == pytest.approx(want["tau"], rel=0, abs=PROB_ATOL), policy
        assert got["metrics"] == want["metrics"] and got["n_candidates"] == want["n_candidates"]
    assert summary["tau"] == ours["thresholds"]["primary"]["tau"]
    assert ours["epoch"] == theirs["epoch"] == 1 and summary["best_monitor"] == pytest.approx(
        jax_summary["best_monitor"], rel=BLOCK_RTOL)
    stem = ctx.layout.stem
    got = _rows(ctx.layout.output_dir / f"{stem}_test_outputs.csv")
    want = _rows(jax_ctx.layout.output_dir / f"{stem}_test_outputs.csv")
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        assert abs(float(a.pop("prob")) - float(b.pop("prob"))) <= PROB_ATOL
        assert a == b
    # lr 0 moves no weight: the best checkpoint holds the JAX run's start.
    best = load_checkpoint(ctx.layout.checkpoint_path)["payload"]["params"]
    assert not tree_differences(best, weights)


def test_port_checkpoint_through_both_eval_clis(port_run, packs):
    """(b) The port's best checkpoint through the JAX eval CLI and the port's,
    both in fp32, the run's precision (the checkpoint's meta records the
    architecture, not the compute dtype)."""
    ctx, summary = port_run
    kwargs = dict(batch_size=8, image_size=32, num_workers=1)
    ours = eval_classification.evaluate(ctx.layout.checkpoint_path, packs / "sun_full",
                                        device="cpu", model_overrides={"compute_dtype": torch.float32},
                                        **kwargs)
    theirs = jax_eval.evaluate(ctx.layout.checkpoint_path, packs / "sun_full",
                               model_overrides={"compute_dtype": jax.numpy.float32}, **kwargs)
    assert ours["tau"] == theirs["tau"] == summary["tau"]
    assert ours["n_frames"] == theirs["n_frames"] == 16
    numbers = [k for k, v in theirs.items() if isinstance(v, (int, float)) and k != "tau"]
    assert {"auroc", "f1", "loss", "recall"} <= set(numbers)
    for key in numbers:
        assert ours[key] == pytest.approx(theirs[key], rel=EVAL_TOL, abs=EVAL_TOL), key
    # The engine's own test at that checkpoint and tau.
    payload = json.loads(Path(summary["metrics_path"]).read_text())
    for key in ("auroc", "f1", "loss"):
        assert ours[key] == pytest.approx(payload["test_primary"][key], rel=EVAL_TOL), key


def _exp5c_cfg():
    cfg = tiny_cfg("polypgen_fewshot")
    cfg["dataset"] = {
        "name": "polypgen_fewshot",
        "pack_pattern": "polypgen_fewshot/polypgen_fewshot_s{size}",
        "size": 50, "seeds": [13],
        "splits": {"train": "train", "val": "val", "test": "test"},
    }
    cfg["epochs"] = 1
    cfg["protocol"] = {
        "init_from": "canonical_sun_models", "eval_split": "test",
        "thresholds": {"primary": "sun_val_frozen", "sensitivity": "val_opt_youden"},
    }
    cfg["threshold_policy"] = "sun_val_frozen"
    return cfg


def test_parents_cross_the_packages(jax_lr0_run, port_run, packs, tmp_path):
    """(c) A JAX run is the parent of a port exp5c run, and a port run the
    parent of a JAX one: the frozen tau, its provenance and the parent's
    weights carry across."""
    fs_dir = packs / "polypgen_fewshot"
    fs_dir.mkdir(exist_ok=True)
    if not (fs_dir / "polypgen_fewshot_s50").exists():
        make_image_pack(fs_dir, name="polypgen_fewshot_s50", frames_per_split=8, image_size=32)
    jax_ctx, jax_summary = jax_lr0_run
    port_ctx, port_summary = port_run
    cases = [("port child", jax_ctx, jax_summary,
              lambda parent: run_port(_exp5c_cfg(), packs, tmp_path / "a", parent=parent)),
             ("jax child", port_ctx, port_summary,
              lambda parent: run_jax(_exp5c_cfg(), packs, tmp_path / "b", parent=parent))]
    for what, parent_ctx, parent_summary, run in cases:
        parent = str(parent_ctx.layout.checkpoint_path)
        ctx, summary = run(parent)
        payload = validate("exp5c", summary)
        assert payload["zero_shot"]["tau"] == parent_summary["tau"], what
        assert payload["thresholds"]["primary"]["tau"] == parent_summary["tau"], what
        assert payload["thresholds"]["primary"]["policy"] == "sun_val_frozen", what
        parent_block = payload["provenance"]["parent_run"]
        assert parent_block["checkpoint_sha256"] == classification.exports.sha256_file(parent)
        assert parent_block["metrics"]["path"].endswith("SupImnet_SUNFull_s13.metrics.json")
        assert "from" in summary["stem"], what


def test_port_resume_continues_a_jax_run(jax_lr0_run, packs, tmp_path, monkeypatch):
    """(d) ``--resume`` of the port in a copy of a JAX run's output
    directory: from the JAX best checkpoint's masters and moments, at its
    epoch + 1."""
    jax_ctx, _ = jax_lr0_run
    base = tmp_path / "out"
    shutil.copytree(jax_ctx.layout.base_dir, base, symlinks=True)
    seen = capture_first_step(monkeypatch)
    ctx, summary = run_port(lr0_cfg(epochs=3), packs, base, resume=True)
    best = jax_ctx.layout.output_dir / "SupImnet_SUNFull_s13_e00_valLoss.ckpt"
    log_text = (ctx.layout.output_dir / f"{ctx.layout.stem}.log").read_text()
    assert "resumed from SupImnet_SUNFull_s13.ckpt at epoch 1" in log_text
    assert summary["epochs_run"] == 3 and summary["timings"]["train_images"] == 2 * 2 * 8
    assert_restored(seen, best, ctx.classifier.cfg)
    assert seen["step"] == 2
    # lr 0: the port's last checkpoint still holds the JAX run's weights.
    last = load_checkpoint(ctx.layout.output_dir / "SupImnet_SUNFull_s13_last.ckpt")
    assert not tree_differences(last["payload"]["params"],
                                load_checkpoint(best)["payload"]["params"])


def test_ssl_colon_run_starts_from_the_mae_checkpoint(packs, tmp_path, monkeypatch):
    """exp2's SSL-colon arm: ``build_run`` reads the MAE checkpoint that the
    model config names under ``checkpoint_root``, and the first step sees
    its encoder's masters bit for bit (the head fresh)."""
    from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig, encoder_only
    from ssl4polyp_tpu_torch.models.vit import ViTConfig
    from ssl4polyp_tpu_torch.models.weights import jax_from_mae_state_dict

    cfg = MAEConfig(encoder=ViTConfig(img_size=32, patch_size=8, embed_dim=32, depth=2,
                                      num_heads=2),
                    decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
    tree = jax_from_mae_state_dict(dict(MAE(cfg, torch.Generator().manual_seed(5))
                                        .named_parameters()), cfg)
    relative = "checkpoints/pretrained/vit_b/mae_hyperkvasir.ckpt"
    save_checkpoint(tmp_path / "root" / relative, {"params": tree}, {"epoch": 399})
    run_cfg = tiny_cfg(epochs=1)
    run_cfg["models"] = [{"model": {"key": "ssl_colon", "arch": "vit_b", "ss_framework": "mae",
                                    "pretraining": "Hyperkvasir", "checkpoint": relative}}]
    plan = proto.resolve_run_plan(run_cfg, model_key="ssl_colon", seed=13)
    ctx = build_run(plan, output_dir=tmp_path / "out", pack_root=packs,
                    checkpoint_root=tmp_path / "root", model_overrides=TINY_MODEL, device="cpu")
    assert ctx.classifier.cfg.pos_embed == "sincos"
    seen = capture_first_step(monkeypatch)
    summary = run_classification_training(ctx)
    want = state_dict_from_jax(encoder_only(tree), ctx.classifier.cfg)
    assert set(seen["params"]) - set(want) == {"head.weight", "head.bias"}
    assert all(torch.equal(seen["params"][n], t) for n, t in want.items())
    assert summary["epochs_run"] == 1


@pytest.mark.parametrize("arm", ["sup_imnet", "ssl_imnet"])
def test_exp1_arms_start_from_their_weight_files(arm, packs, tmp_path, monkeypatch):
    """exp1's two arms, each from the file its model config names under
    ``checkpoint_root`` (an AugReg ``.npz``, an upstream MAE ``.pth``),
    written here at the tiny width: both engines build the arm's scheme from
    the file, the port's first step sees the file's encoder bit for bit, and
    at lr 0 in fp32, with the JAX run's fresh head copied in, the two
    engines' test probabilities agree within PROB_ATOL."""
    import yaml

    import chip_smoke
    from ssl4polyp_tpu_torch.models.mae import MAEConfig, encoder_only
    from ssl4polyp_tpu_torch.models.vit import ViTConfig

    root = Path(__file__).resolve().parents[1]
    model_cfg = yaml.safe_load((root / "config" / "model" / f"{arm}.yaml").read_text())["model"]
    cfg = lr0_cfg(epochs=1)
    cfg["models"] = [{"model": model_cfg}]
    cfg["reporting"] = {"inputs_subdir": "exp1_sun_baselines_sup_vs_ssl"}
    vit = ViTConfig(img_size=32, **TINY_MODEL, num_classes=2)
    weights = tmp_path / "weights" / model_cfg["checkpoint"]
    rng = np.random.default_rng(13)
    if arm == "sup_imnet":
        encoder = chip_smoke.write_augreg_npz(weights, vit, rng)
    else:
        mae = MAEConfig(encoder=vit, decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
        encoder = encoder_only(chip_smoke.write_mae_pth(weights, mae, rng))

    jax_plan = jax_proto.resolve_run_plan(cfg, model_key=arm, seed=13)
    jax_ctx = jax_engine.build_run(jax_plan, output_dir=tmp_path / "jax", pack_root=packs,
                                   checkpoint_root=tmp_path / "weights",
                                   model_overrides=TINY_MODEL, exp_config_name="exp/exp1.yaml")
    jax_summary = jax_engine.run_classification_training(
        jax_ctx, thresholds_root=tmp_path / "jax" / "thresholds")
    head = load_checkpoint(jax_ctx.layout.checkpoint_path)["payload"]["params"]["head"]

    plan = proto.resolve_run_plan(cfg, model_key=arm, seed=13)
    ctx = build_run(plan, output_dir=tmp_path / "port", pack_root=packs,
                    checkpoint_root=tmp_path / "weights", model_overrides=TINY_MODEL,
                    exp_config_name="exp/exp1.yaml", device="cpu")
    assert ctx.classifier.scheme == jax_ctx.classifier.scheme == arm
    with torch.no_grad():
        ctx.params["head.weight"].copy_(torch.from_numpy(np.ascontiguousarray(head["kernel"].T)))
        ctx.params["head.bias"].copy_(torch.from_numpy(np.array(head["bias"])))
    seen = capture_first_step(monkeypatch)
    summary = run_classification_training(ctx, thresholds_root=tmp_path / "port" / "thresholds")
    want = state_dict_from_jax(encoder, ctx.classifier.cfg)
    assert set(seen["params"]) - set(want) == {"head.weight", "head.bias"}
    assert all(torch.equal(seen["params"][n], t) for n, t in want.items())
    payload = validate("exp1", summary)
    assert payload["provenance"]["model"] == arm

    stem = ctx.layout.stem
    got = _rows(ctx.layout.output_dir / f"{stem}_test_outputs.csv")
    theirs = _rows(jax_ctx.layout.output_dir / f"{stem}_test_outputs.csv")
    assert len(got) == len(theirs) == 16
    for a, b in zip(got, theirs):
        assert abs(float(a.pop("prob")) - float(b.pop("prob"))) <= PROB_ATOL
        assert a == b
    # The test logits of the two fp32 forwards, two blocks of the file's
    # weights apart in summation order and the JAX GELU's polynomial erf:
    # 1e-5 absolute at logits up to |3|.
    ours = json.loads(Path(summary["metrics_path"]).read_text())["test_primary"]
    want = json.loads(Path(jax_summary["metrics_path"]).read_text())["test_primary"]
    np.testing.assert_allclose(np.asarray(ours["logits"]), np.asarray(want["logits"]), rtol=0,
                               atol=1e-5)
    assert ours["auroc"] == pytest.approx(want["auroc"], abs=1e-12)
