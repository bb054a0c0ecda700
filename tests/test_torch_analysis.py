"""The port's reporting layer (``ssl4polyp_tpu_torch/analysis``) against the
JAX package's: a port counterpart of each report, guardrail, bootstrap and
seed test of ``test_analysis.py``, asserting what that test asserts on the
port, with every report the port writes byte-equal to the JAX reporter's on
the same run directories (both write to one output path in turn); exp3's
strata report beside them; ``compute_binary_metrics`` bit for bit against
the JAX function (scikit-learn's values); and run directories written by
each engine (the tiny ViT, exp1's two arms, one seed each) read by both
packages' exp1 reporters byte for byte, and exp5b's engine output refused
by both with one ``GuardrailViolation``."""

from __future__ import annotations

import csv
import json
import math
import shutil
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from ssl4polyp_tpu import analysis as jax_analysis
from ssl4polyp_tpu.analysis import common as jax_common
from ssl4polyp_tpu.analysis import exp5a_domain_shift as jax_exp5a
from ssl4polyp_tpu.analysis import exp_reports as jax_reports
from ssl4polyp_tpu.analysis import frame_bootstrap as jax_frame_bootstrap
from ssl4polyp_tpu.analysis import report_core as jax_core
from ssl4polyp_tpu.training import classification as jax_engine
from ssl4polyp_tpu.training import protocol as jax_proto
from ssl4polyp_tpu_torch.analysis import (
    Bootstrapper,
    GuardrailViolation,
    ResultLoader,
    SeedCheckError,
    compute_binary_metrics,
    ensure_expected_seeds,
    load_common_run,
)
from ssl4polyp_tpu_torch.analysis import exp5a_domain_shift, frame_bootstrap, report_core
from ssl4polyp_tpu_torch.analysis.exp_reports import _Exp3Run, _retention_from_frames, run_report
from ssl4polyp_tpu_torch.analysis.frame_bootstrap import (
    FrameBootstrapper,
    FrameSample,
    bootstrap_curves,
)
from ssl4polyp_tpu_torch.analysis.guardrails import compute_file_sha256
from ssl4polyp_tpu_torch.training import protocol as proto
from ssl4polyp_tpu_torch.training.classification import build_run, run_classification_training
from tests.conftest import make_image_pack
from tests.test_analysis import _synth_exp5a_pair, synth_run
from tests.test_classification_engine import TINY_MODEL, tiny_cfg


def read_tree(directory: Path) -> dict[str, bytes]:
    return {p.relative_to(directory).as_posix(): p.read_bytes()
            for p in sorted(directory.rglob("*")) if p.is_file()}


def report_both(exp: str, runs: Path, out: Path, **kwargs) -> dict:
    """The port's report, then the JAX package's into the same directory:
    every file the two write must be byte-equal.  Returns the port's
    result (its paths now hold the JAX files, the same bytes)."""
    result = run_report(exp, runs, out, **kwargs)
    ours = read_tree(out)
    shutil.rmtree(out)
    jax_reports.run_report(exp, runs, out, **kwargs)
    theirs = read_tree(out)
    exp_id = result["markdown"].name[: -len("_report.md")]
    assert {f"{exp_id}_report.md", f"{exp_id}_metrics.csv", f"{exp_id}_manifest.json"} <= set(ours)
    assert sorted(ours) == sorted(theirs)
    assert [name for name in ours if ours[name] != theirs[name]] == []
    return result


def same_refusal(port_call, jax_call, error, jax_error, match: str) -> None:
    """Both packages refuse with the same exception name and message."""
    with pytest.raises(error, match=match) as ours:
        port_call()
    with pytest.raises(jax_error) as theirs:
        jax_call()
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert str(ours.value) == str(theirs.value)


def report_refused(exp, runs, out, match, **kwargs) -> None:
    same_refusal(lambda: run_report(exp, runs, out, **kwargs),
                 lambda: jax_reports.run_report(exp, runs, out, **kwargs),
                 GuardrailViolation, jax_analysis.GuardrailViolation, match)


def load_refused(exp, path, match, **kwargs) -> None:
    same_refusal(lambda: ResultLoader(exp, **kwargs).load(path),
                 lambda: jax_analysis.ResultLoader(exp, **kwargs).load(path),
                 GuardrailViolation, jax_analysis.GuardrailViolation, match)


def bits(value):
    """A metric's exact identity: its type and its bytes (NaN included)."""
    if isinstance(value, float):
        return "float", struct.pack("<d", value)
    return type(value).__name__, value


# ---------------------------------------------------------------------------
# Guardrails
# ---------------------------------------------------------------------------

def test_guardrails_accept_valid(tmp_path):
    synth_run(tmp_path)
    path = next(tmp_path.glob("*.metrics.json"))
    loader = ResultLoader("exp1")
    result = loader.load(path)
    assert 0.5 < result.primary_metrics["auroc"] <= 1.0
    assert loader.loaded_runs[0]["model"] == "SupImnet"
    reference = jax_analysis.ResultLoader("exp1")
    theirs = reference.load(path)
    assert result.primary_metrics == theirs.primary_metrics
    assert result.sensitivity_metrics == theirs.sensitivity_metrics
    assert loader.loaded_runs == reference.loaded_runs


def _tamper(tmp_path, edit):
    synth_run(tmp_path)
    path = next(tmp_path.glob("*.metrics.json"))
    payload = json.loads(path.read_text())
    edit(payload)
    path.write_text(json.dumps(payload))
    return path


def test_guardrails_reject_confusion_mismatch(tmp_path):
    path = _tamper(tmp_path, lambda p: p["test_primary"].update(tp=p["test_primary"]["tp"] + 5))
    load_refused("exp1", path, "confusion totals")


def test_guardrails_reject_wrong_policy(tmp_path):
    path = _tamper(tmp_path, lambda p: p["thresholds"]["primary"].update(policy="youden_on_val"))
    load_refused("exp1", path, "policy")


def test_guardrails_reject_missing_blocks(tmp_path):
    path = _tamper(tmp_path, lambda p: p.pop("val"))
    load_refused("exp1", path, "missing block 'val'")


def test_guardrails_split_binding(tmp_path):
    path = _tamper(tmp_path, lambda p: p["thresholds"]["primary"].update(split="other/val"))
    load_refused("exp1", path, "split")


def test_guardrails_rehash_outputs_csv(tmp_path):
    synth_run(tmp_path)
    path = next(tmp_path.glob("*.metrics.json"))
    with open(next(tmp_path.glob("*_test_outputs.csv")), "a") as handle:
        handle.write("tampered,0.5,1,1,case0,sun,,case0,flat\n")
    load_refused("exp1", path, "sha256 mismatch")


def test_guardrails_missing_outputs_csv(tmp_path):
    synth_run(tmp_path)
    path = next(tmp_path.glob("*.metrics.json"))
    next(tmp_path.glob("*_test_outputs.csv")).unlink()
    load_refused("exp1", path, "missing on disk")
    ours = ResultLoader("exp1", enforce_csv_hashes=False).load(path)
    theirs = jax_analysis.ResultLoader("exp1", enforce_csv_hashes=False).load(path)
    assert ours.primary_metrics == theirs.primary_metrics


def test_guardrails_cross_run_digest_registry(tmp_path):
    synth_run(tmp_path / "a", seed=13)
    synth_run(tmp_path / "b", seed=29)
    path_a = next((tmp_path / "a").glob("*.metrics.json"))
    path_b = next((tmp_path / "b").glob("*.metrics.json"))
    payload = json.loads(path_b.read_text())
    payload["data"]["test"]["sha256"] = "e" * 64
    path_b.write_text(json.dumps(payload))
    ours, theirs = ResultLoader("exp1"), jax_analysis.ResultLoader("exp1")
    ours.load(path_a)
    theirs.load(path_a)
    same_refusal(lambda: ours.load(path_b), lambda: theirs.load(path_b), GuardrailViolation,
                 jax_analysis.GuardrailViolation, "dataset digest mismatch")


@pytest.mark.parametrize("edit, match", [
    (lambda notes: notes.pop("source_checkpoint"), "source_checkpoint is required"),
    (lambda notes: notes.update(source_split_path="polypgen/val"), "does not contain"),
    (lambda notes: notes.update(source_checkpoint_sha256="nothex"), "64-hex"),
])
def test_guardrails_frozen_source_checkpoint(tmp_path, edit, match):
    synth_run(tmp_path, exp="exp5a")
    path = next(tmp_path.glob("*.metrics.json"))
    ResultLoader("exp5a").load(path)
    payload = json.loads(path.read_text())
    edit(payload["thresholds"]["primary"]["notes"])
    path.write_text(json.dumps(payload))
    load_refused("exp5a", path, match)


# ---------------------------------------------------------------------------
# Loading, bootstrap, seeds
# ---------------------------------------------------------------------------

def test_common_run_loading(tmp_path):
    synth_run(tmp_path, n_frames=30)
    path = next(tmp_path.glob("*.metrics.json"))
    run = load_common_run(path, require_outputs=True)
    assert len(run.frames) == 30
    assert run.seed == 13
    assert run.primary_tau == 0.5
    assert run.model == "SupImnet"
    theirs = jax_common.load_common_run(path, require_outputs=True)
    assert [vars(f) for f in run.frames] == [vars(f) for f in theirs.frames]
    assert (run.payload, run.outputs_path) == (theirs.payload, theirs.outputs_path)


def test_bootstrapper_deterministic_and_signed():
    rng = np.random.default_rng(0)
    low = {13: rng.normal(0.7, 0.05, 100), 29: rng.normal(0.7, 0.05, 100)}
    high = {13: low[13] + 0.1, 29: low[29] + 0.1}
    cases = {13: [f"c{i % 10}" for i in range(100)], 29: [f"c{i % 10}" for i in range(100)]}
    metrics = {"A": low, "B": high}
    clusters = {"A": cases, "B": cases}
    r1 = Bootstrapper(metrics, clusters=clusters, n_resamples=200).paired_delta("A", "B")
    r2 = Bootstrapper(metrics, clusters=clusters, n_resamples=200).paired_delta("A", "B")
    assert r1.mean == pytest.approx(0.1, abs=1e-9)
    assert r1.samples == r2.samples  # seeded rng 1337 -> identical draws
    assert r1.ci_lower > 0.09 and r1.ci_upper < 0.11
    theirs = jax_analysis.Bootstrapper(metrics, clusters=clusters,
                                       n_resamples=200).paired_delta("A", "B")
    assert (r1.mean, r1.ci_lower, r1.ci_upper, r1.samples) == (
        theirs.mean, theirs.ci_lower, theirs.ci_upper, theirs.samples)


@pytest.mark.parametrize("seeds, match", [
    ({"m": {13: 1}}, "missing seeds"),
    ({"m": {13: 1, 29: 1, 47: 1, 99: 1}}, "unexpected"),
])
def test_seed_checks(seeds, match):
    ensure_expected_seeds({"m": {13: 1, 29: 1, 47: 1}})
    same_refusal(lambda: ensure_expected_seeds(seeds),
                 lambda: jax_analysis.ensure_expected_seeds(seeds),
                 SeedCheckError, jax_analysis.SeedCheckError, match)


def test_t_confidence_interval_matches_reference_constant():
    values = [0.1, 0.2, 0.3]
    lo, hi = report_core.t_confidence_interval(values)
    margin = 4.302652729911275 * np.std(values, ddof=1) / np.sqrt(3)
    assert lo == pytest.approx(0.2 - margin, abs=1e-9)
    assert hi == pytest.approx(0.2 + margin, abs=1e-9)
    assert report_core.t_confidence_interval([0.1]) is None
    assert report_core.t_confidence_interval([0.1, 0.1]) == (0.1, 0.1)
    assert (lo, hi) == jax_core.t_confidence_interval(values)


def test_frame_bootstrap_true_auroc():
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 400)
    weak = np.clip(rng.normal(0.5 + (labels - 0.5) * 0.2, 0.25), 0, 1)
    strong = np.clip(rng.normal(0.5 + (labels - 0.5) * 0.6, 0.25), 0, 1)
    cases = [f"c{i % 40}" for i in range(400)]

    def samples_of(package):
        return {"weak": {13: package.FrameSample.build(weak, labels, cases, 0.5)},
                "strong": {13: package.FrameSample.build(strong, labels, cases, 0.5)}}

    samples = samples_of(frame_bootstrap)
    assert samples["weak"][13].metric("auroc") == pytest.approx(
        roc_auc_score(labels, weak), abs=1e-12)
    delta = FrameBootstrapper(samples, n_resamples=300).paired_delta("weak", "strong",
                                                                     metric="auroc")
    expected = roc_auc_score(labels, strong) - roc_auc_score(labels, weak)
    assert delta.mean == pytest.approx(expected, abs=1e-12)
    assert delta.ci_lower > 0
    again = FrameBootstrapper(samples, n_resamples=300).paired_delta("weak", "strong",
                                                                     metric="auroc")
    assert delta.samples == again.samples
    theirs = jax_frame_bootstrap.FrameBootstrapper(
        samples_of(jax_frame_bootstrap), n_resamples=300).paired_delta("weak", "strong",
                                                                       metric="auroc")
    assert (delta.mean, delta.ci_lower, delta.ci_upper, delta.samples) == (
        theirs.mean, theirs.ci_lower, theirs.ci_upper, theirs.samples)


def test_paired_bootstrap_indices_order_independent():
    base = object.__new__(_Exp3Run)
    cont = object.__new__(_Exp3Run)
    base.cases = {"a": np.array([0, 1]), "b": np.array([2]), "c": np.array([3, 4])}
    cont.cases = {"a": np.array([3, 4]), "b": np.array([0]), "c": np.array([1, 2])}
    drawn = ["c", "a", "c"]
    np.testing.assert_array_equal(base.indices_for(drawn), [3, 4, 0, 1, 3, 4])
    np.testing.assert_array_equal(cont.indices_for(drawn), [1, 2, 3, 4, 1, 2])
    view = object.__new__(exp5a_domain_shift.Exp5aView)
    view.centers = {"c1": np.array([5]), "c2": np.array([6, 7])}
    np.testing.assert_array_equal(view.indices_for_centers(["c2", "c2", "c1"]), [6, 7, 6, 7, 5])


def test_exp5a_view_raises_guardrail_violation():
    class FakeRun:
        frames = ()
        metrics_path = "<fake>"
        primary_tau = None

    same_refusal(lambda: exp5a_domain_shift.Exp5aView(FakeRun(), model="m", seed=13),
                 lambda: jax_exp5a.Exp5aView(FakeRun(), model="m", seed=13),
                 GuardrailViolation, jax_analysis.GuardrailViolation,
                 "needs outputs-CSV frames")


def test_frame_bootstrap_pairing_survives_row_reorder():
    rng = np.random.default_rng(3)
    n = 200
    labels = rng.integers(0, 2, n)
    probs = np.clip(rng.normal(0.5 + (labels - 0.5) * 0.4, 0.2), 0, 1)
    cases = [f"c{i % 20}" for i in range(n)]
    perm = rng.permutation(n)
    half = [i for i in range(n) if int(cases[i][1:]) < 10]

    def deltas(package):
        build = package.FrameSample.build
        same = package.FrameBootstrapper({
            "a": {13: build(probs, labels, cases, 0.5)},
            "b": {13: build(probs[perm], labels[perm], [cases[i] for i in perm], 0.5)},
        }, n_resamples=200).paired_delta("a", "b")
        full = build(probs, labels, cases, 0.5)
        part = build(probs[half], labels[half], [cases[i] for i in half], 0.5)
        partial = package.FrameBootstrapper({"a": {13: full}, "b": {13: part}},
                                            n_resamples=200).paired_delta("a", "b")
        return same, partial, part.metric("auroc") - full.metric("auroc")

    delta, delta_partial, expected_point = deltas(frame_bootstrap)
    assert delta.mean == 0.0
    assert all(abs(s) < 1e-12 for s in delta.samples)
    assert delta_partial.mean == pytest.approx(expected_point, abs=1e-12)
    assert delta_partial.ci_lower <= expected_point <= delta_partial.ci_upper
    assert len(delta_partial.samples) == 200
    theirs = deltas(jax_frame_bootstrap)
    for ours, reference in zip((delta, delta_partial), theirs):
        assert (ours.mean, ours.ci_lower, ours.ci_upper, ours.samples) == (
            reference.mean, reference.ci_lower, reference.ci_upper, reference.samples)


def test_bootstrap_curves_deltas_are_paired():
    def curves(package):
        rng = np.random.default_rng(11)
        data = {}
        for name in ("a", "b"):
            per_x = {}
            for x in (10.0, 25.0, 50.0):
                per_seed = {}
                for s in (13, 29):
                    labels = rng.integers(0, 2, 120)
                    probs = np.clip(rng.normal(0.5 + (labels - 0.5) * 0.4, 0.2), 0, 1)
                    cases = [f"c{i % 12}" for i in range(120)]
                    per_seed[s] = package.FrameSample.build(probs, labels, cases, 0.5)
                per_x[x] = per_seed
            data[name] = per_x
        data["b"] = data["a"]
        return package.bootstrap_curves(data, metric="auroc", n_resamples=100,
                                        pairs=[("a", "b")])

    result = curves(frame_bootstrap)
    for x, delta in result.per_x_deltas[("a", "b")].items():
        assert delta.mean == 0.0
        assert all(s == 0.0 for s in delta.samples), x
    lo, hi = result.aulc_deltas[("a", "b")][1:]
    assert lo == 0.0 and hi == 0.0
    assert bootstrap_curves is frame_bootstrap.bootstrap_curves
    theirs = curves(jax_frame_bootstrap)
    assert result.aulc_deltas == theirs.aulc_deltas
    assert {x: d.samples for x, d in result.per_x_deltas[("a", "b")].items()} == {
        x: d.samples for x, d in theirs.per_x_deltas[("a", "b")].items()}


# ---------------------------------------------------------------------------
# compute_binary_metrics bit for bit
# ---------------------------------------------------------------------------

def _metric_case(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    probs = rng.random(n)
    tau = 0.5
    if kind == "tied":
        probs = rng.integers(0, 5, n) / 4.0
    elif kind == "one_class_negative":
        labels = np.zeros(n, dtype=int)
    elif kind == "one_class_positive":
        labels = np.ones(n, dtype=int)
    elif kind == "all_below_tau":
        tau = float(probs.max()) + 0.01
    elif kind == "all_above_tau":
        tau = float(probs.min())
    return probs, labels, tau


@pytest.mark.parametrize("kind", ["random", "tied", "one_class_negative", "one_class_positive",
                                  "all_below_tau", "all_above_tau"])
def test_compute_binary_metrics_is_the_jax_functions_bit_for_bit(kind):
    compared = 0
    for n in (1, 2, 7, 60, 333):
        for seed in range(6):
            probs, labels, tau = _metric_case(kind, n, seed)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # one class: both warn, as scikit-learn does
                ours = compute_binary_metrics(probs, labels, tau)
                theirs = jax_analysis.compute_binary_metrics(probs, labels, tau)
            assert list(ours) == list(theirs)
            assert {k: bits(v) for k, v in ours.items()} == {k: bits(v) for k, v in theirs.items()}
            if np.unique(labels).size == 2:
                assert bits(frame_bootstrap.metric_from_frames("auprc", probs, labels, tau)) == \
                    bits(jax_frame_bootstrap.metric_from_frames("auprc", probs, labels, tau))
            compared += 1
    assert compared == 30


# ---------------------------------------------------------------------------
# Reports on synthetic run directories, byte for byte
# ---------------------------------------------------------------------------

def test_exp1_report_end_to_end(tmp_path):
    runs = tmp_path / "runs"
    for model, auroc in (("SupImnet", 0.85), ("SslImnet", 0.91)):
        for seed in (13, 29, 47):
            synth_run(runs / model / f"seed{seed}", model=model, seed=seed,
                      auroc=auroc, skill=2.0 if model == "SslImnet" else 1.2)
    result = report_both("exp1", runs, tmp_path / "report", n_resamples=100)
    markdown = result["markdown"].read_text()
    assert "SupImnet" in markdown and "SslImnet" in markdown
    assert (result["aggregates"]["SslImnet"]["auroc"]["mean"]
            > result["aggregates"]["SupImnet"]["auroc"]["mean"])
    deltas = result["deltas"][("SupImnet", "SslImnet")]["metrics"]
    assert deltas["auroc"]["mean"] > 0
    assert deltas["auroc"]["ci_lower"] is not None
    assert "f1" in deltas
    assert json.loads(result["manifest"].read_text())["n_runs"] == 6


def test_exp1_report_seed_enforcement(tmp_path):
    runs = tmp_path / "runs"
    synth_run(runs, model="SupImnet", seed=13)
    same_refusal(lambda: run_report("exp1", runs, tmp_path / "r", n_resamples=10),
                 lambda: jax_reports.run_report("exp1", runs, tmp_path / "r", n_resamples=10),
                 SeedCheckError, jax_analysis.SeedCheckError, "missing seeds")


def test_exp2_t_interval_ci(tmp_path):
    runs = tmp_path / "runs"
    for model, auroc, skill in (("SslImnet", 0.85, 1.2), ("SslColon", 0.91, 2.0)):
        for seed in (13, 29, 47):
            synth_run(runs / model / f"s{seed}", model=model, seed=seed,
                      auroc=auroc, exp="exp2", skill=skill)
    result = report_both("exp2", runs, tmp_path / "r", n_resamples=50)
    markdown = result["markdown"].read_text()
    assert "t 95% CI" in markdown
    per_seed = result["deltas"][("SslImnet", "SslColon")]["metrics"]["auroc"]["per_seed"]
    lo, hi = report_core.t_confidence_interval(list(per_seed.values()))
    assert f"[{lo:.3f}, {hi:.3f}]" in markdown


def test_exp3_morphology_strata_report(tmp_path):
    """exp3 (reported as ``exp3b``): the strata x policy tables recomputed
    from the frames at every policy's tau, on runs of the sun_morphology
    pack."""
    runs = tmp_path / "runs"
    for model, auroc, skill in (("SupImnet", 0.85, 1.2), ("SslColon", 0.91, 2.0)):
        for seed in (13, 29, 47):
            run_dir = runs / model / f"s{seed}"
            synth_run(run_dir, model=model, seed=seed, auroc=auroc, exp="exp2", skill=skill,
                      morphology=True)
            path = next(run_dir.glob("*.metrics.json"))
            payload = json.loads(path.read_text())
            for split in ("train", "val", "test"):
                payload["data"][split]["path"] = f"sun_morphology/{split}"
            for block in ("primary", "sensitivity"):
                payload["thresholds"][block]["split"] = "sun_morphology/val"
            path.write_text(json.dumps(payload))
    result = report_both("exp3", runs, tmp_path / "r", n_resamples=30)
    markdown = result["markdown"].read_text()
    assert result["markdown"].name == "exp3b_report.md"
    assert "## Morphology strata × threshold policy (frame-recomputed)" in markdown
    for policy in ("f1_opt_on_val", "youden_on_val"):
        assert f"| {policy} | SslColon | flat_plus_negs |" in markdown
    assert ("SupImnet", "SslColon") in result["deltas"]
    assert json.loads(result["manifest"].read_text())["n_runs"] == 6


def test_exp4_learning_curve(tmp_path):
    runs = tmp_path / "runs"
    for percent, auroc in ((10, 0.8), (50, 0.88), (100, 0.92)):
        for seed in (13, 29, 47):
            synth_run(runs / f"p{percent}" / f"s{seed}", model="SslColon", seed=seed,
                      auroc=auroc, exp="exp4", subset_percent=float(percent))
    for percent, auroc in ((10, 0.75), (50, 0.85), (100, 0.9)):
        for seed in (13, 29, 47):
            synth_run(runs / "sup" / f"p{percent}" / f"s{seed}", model="SupImnet", seed=seed,
                      auroc=auroc, exp="exp4", subset_percent=float(percent), skill=1.2)
    result = report_both("exp4", runs, tmp_path / "r", n_resamples=20)
    markdown = result["markdown"].read_text()
    assert "Learning curves" in markdown
    assert "AULC [95% CI]" in markdown
    assert "Pairwise deltas by percent" in markdown
    assert "AULC deltas" in markdown
    assert "SslColon@p10" in result["aggregates"]
    assert markdown.count("[") > 10


def _exp5b_runs(runs: Path) -> None:
    for seed in (13, 29, 47):
        synth_run(runs / f"s{seed}", model="SslColon", seed=seed, exp="exp5b",
                  perturbations=True)


def test_exp5b_retention(tmp_path):
    runs = tmp_path / "runs"
    _exp5b_runs(runs)
    result = report_both("exp5b", runs, tmp_path / "r", n_resamples=50)
    markdown = result["markdown"].read_text()
    assert "Perturbation retention" in markdown
    assert "blur_sigma=1.5" in markdown
    assert "| blur_sigma | 1.500 |" in markdown
    blur_row = next(line for line in markdown.splitlines() if "blur_sigma=1.5" in line)
    assert "[" in blur_row and "]" in blur_row
    means = []
    for seed in (13, 29, 47):
        run = load_common_run(runs / f"s{seed}" / f"SslColon_SUNFull_s{seed}.metrics.json")
        tag_f1, _ = _retention_from_frames(run)
        means.append(tag_f1["blur_sigma=1.5"])
    assert f"{float(np.mean(means)):.3f}" in blur_row


def test_exp5b_retention_survives_per_case_deletion(tmp_path):
    runs = tmp_path / "runs"
    _exp5b_runs(runs)

    def section(text):
        return text[text.index("## Perturbation retention"):]

    before = section(report_both("exp5b", runs, tmp_path / "r1",
                                 n_resamples=50)["markdown"].read_text())
    for path in runs.glob("**/*.metrics.json"):
        payload = json.loads(path.read_text())
        del payload["test_perturbations"]["per_case"]
        path.write_text(json.dumps(payload))
    after = report_both("exp5b", runs, tmp_path / "r2", n_resamples=50)
    assert section(after["markdown"].read_text()) == before


def test_exp5b_declared_per_tag_tamper_rejected(tmp_path):
    runs = tmp_path / "runs"
    _exp5b_runs(runs)
    path = runs / "s13" / "SslColon_SUNFull_s13.metrics.json"
    payload = json.loads(path.read_text())
    payload["test_perturbations"]["per_tag"]["blur_sigma=1.5"]["f1"] += 0.05
    path.write_text(json.dumps(payload))
    report_refused("exp5b", runs, tmp_path / "r", "disagrees", n_resamples=10)


def test_exp5c_zero_shot_anchor(tmp_path):
    runs = tmp_path / "runs"
    for seed in (13, 29, 47):
        synth_run(runs / f"s{seed}", model="SslColon", seed=seed, exp="exp5c",
                  fewshot_budget=50, zero_shot=True)
    result = report_both("exp5c", runs, tmp_path / "r", n_resamples=20)
    markdown = result["markdown"].read_text()
    assert "Zero-shot anchor" in markdown
    assert "SslColon@s50" in result["aggregates"]
    assert "Few-shot curves" in markdown
    curve_header = next(line for line in markdown.splitlines() if line.startswith("| model |"))
    assert "s0" in curve_header and "s50" in curve_header


def test_report_audit_rejects_tampered_primary(tmp_path):
    synth_run(tmp_path / "SupImnet" / "s13", model="SupImnet", seed=13)
    path = next((tmp_path / "SupImnet" / "s13").glob("*.metrics.json"))
    doctored = json.loads(path.read_text())
    doctored["test_primary"]["auroc"] = max(0.0, doctored["test_primary"]["auroc"] - 0.05)
    path.write_text(json.dumps(doctored))
    report_refused("exp1", tmp_path, tmp_path / "r", "disagrees", check_seed_protocol=False,
                   n_resamples=10)


def test_composition_mismatch_rejected(tmp_path):
    synth_run(tmp_path / "a", model="SupImnet", seed=13)
    synth_run(tmp_path / "b", model="SslImnet", seed=13)
    path_b = next((tmp_path / "b").glob("*.metrics.json"))
    csv_path = next((tmp_path / "b").glob("*_test_outputs.csv"))
    rows = csv_path.read_text().splitlines()
    header = rows[0].split(",")
    li, pi = header.index("label"), header.index("prob")
    cells = rows[1].split(",")
    cells[li] = "1" if cells[li] == "0" else "0"
    rows[1] = ",".join(cells)
    csv_path.write_text("\n".join(rows) + "\n")
    payload = json.loads(path_b.read_text())
    frames = [r.split(",") for r in rows[1:]]
    probs = np.asarray([float(r[pi]) for r in frames])
    labels = np.asarray([int(r[li]) for r in frames])
    payload["test_primary"] = compute_binary_metrics(probs, labels, 0.5)
    payload["provenance"]["test_outputs_csv_sha256"] = compute_file_sha256(csv_path)
    path_b.write_text(json.dumps(payload))
    report_refused("exp1", tmp_path, tmp_path / "r", "composition mismatch",
                   check_seed_protocol=False, n_resamples=10)


def test_composition_declared_vs_frames(tmp_path):
    synth_run(tmp_path)
    path = next(tmp_path.glob("*.metrics.json"))
    run = load_common_run(path)
    comp = report_core.composition_of(run)
    assert comp["n_pos"] + comp["n_neg"] == comp["total"] == 60
    assert comp == jax_core.composition_of(jax_common.load_common_run(path))
    run.payload["test_primary"]["n_pos"] = comp["n_pos"] + 1
    theirs = jax_common.load_common_run(path)
    theirs.payload["test_primary"]["n_pos"] = comp["n_pos"] + 1
    same_refusal(lambda: report_core.composition_of(run), lambda: jax_core.composition_of(theirs),
                 GuardrailViolation, jax_analysis.GuardrailViolation, "composition")


def test_exp1_requires_curve_exports(tmp_path):
    synth_run(tmp_path / "SupImnet", model="SupImnet", seed=13)
    path = next((tmp_path / "SupImnet").glob("*.metrics.json"))
    payload = json.loads(path.read_text())
    del payload["curve_exports"]
    path.write_text(json.dumps(payload))
    report_refused("exp1", tmp_path, tmp_path / "r", "curve_exports", check_seed_protocol=False,
                   n_resamples=10)


def test_exp5a_domain_shift_report(tmp_path):
    _sun_root, exp_root = _synth_exp5a_pair(tmp_path)
    report_dir = tmp_path / "report"
    result = report_both("exp5a", exp_root, report_dir, n_resamples=60)
    markdown = result["markdown"].read_text()
    assert "## Domain shift (SUN-test → PolypGen-test)" in markdown
    assert "### Per-centre performance" in markdown
    assert "### Pairwise deltas on PolypGen" in markdown
    assert "### Test-set composition" in markdown
    for name in ("exp5a_performance.csv", "exp5a_domain_shift.csv", "exp5a_composition.csv"):
        assert (report_dir / name).exists(), name

    with open(report_dir / "exp5a_domain_shift.csv", newline="") as handle:
        rows = {(r["model"], r["metric"]): r for r in csv.DictReader(handle)}

    def suite(run):
        return exp5a_domain_shift._suite(np.asarray([f.prob for f in run.frames]),
                                         np.asarray([f.label for f in run.frames]),
                                         run.primary_tau)

    for metric in ("auroc", "f1", "loss"):
        expected = []
        for seed in (13, 29, 47):
            name = f"SupImnet_SUNFull_s{seed}.metrics.json"
            polyp = load_common_run(exp_root / "SupImnet" / name)
            sun = load_common_run(tmp_path / "sun" / name)
            expected.append(suite(polyp)[metric] - suite(sun)[metric])
        row = rows[("SupImnet", metric)]
        assert float(row["mean"]) == pytest.approx(float(np.mean(expected)), abs=1e-9)
        assert int(row["n"]) == 3
        assert float(row["delta_seed13"]) == pytest.approx(expected[0], abs=1e-9)
        assert float(row["ci_lower"]) <= float(row["mean"]) <= float(row["ci_upper"])

    with open(report_dir / "exp5a_composition.csv", newline="") as handle:
        comp_rows = list(csv.DictReader(handle))
    scopes = [r["scope"] for r in comp_rows]
    assert scopes.count("overall") == 1
    assert scopes.count("center") == 6
    assert int(next(r for r in comp_rows if r["scope"] == "overall")["total"]) == 60


def test_exp5a_center_mismatch_excluded(tmp_path):
    _sun_root, exp_root = _synth_exp5a_pair(tmp_path, models=("SupImnet", "SslColon"))
    shutil.rmtree(exp_root / "SslColon")
    for seed in (13, 29, 47):
        synth_run(exp_root / "SslColon", model="SslColon", seed=seed, exp="exp5a",
                  auroc=0.75, skill=1.1, centers=[f"C{k}" for k in range(1, 6)],
                  parent=f"sun/SslColon_SUNFull_s{seed}.metrics.json")
    result = report_both("exp5a", exp_root, tmp_path / "report", n_resamples=20)
    markdown = result["markdown"].read_text()
    assert "### Warnings" in markdown
    assert "excluding from bootstrap" in markdown or "bootstrap disabled" in markdown


def test_exp5a_missing_parent_warns(tmp_path):
    exp_root = tmp_path / "exp5a"
    for seed in (13, 29, 47):
        synth_run(exp_root, model="SslColon", seed=seed, exp="exp5a",
                  centers=["C1", "C2", "C3"], parent="sun/does_not_exist.metrics.json")
    report_dir = tmp_path / "report"
    result = report_both("exp5a", exp_root, report_dir, n_resamples=10)
    assert "no parent SUN run resolvable" in result["markdown"].read_text()
    assert (report_dir / "exp5a_performance.csv").exists()
    with open(report_dir / "exp5a_domain_shift.csv", newline="") as handle:
        assert all(int(r["n"]) == 0 for r in csv.DictReader(handle))


# ---------------------------------------------------------------------------
# Run directories written by the engines
# ---------------------------------------------------------------------------

ARMS = ("sup_imnet", "ssl_imnet")


def _exp1_cfg(key):
    """Both arms start from the tiny ViT's random weights; the SSL-imnet arm
    trains at another rate, so that the two runs part."""
    cfg = tiny_cfg(epochs=1, lr=1e-3 if key == "sup_imnet" else 3e-3)
    cfg["models"] = [{"model": {"key": key, "arch": "vit_b", "pretraining": "random"}}
                     for key in ARMS]
    return cfg


def _exp5b_cfg():
    cfg = tiny_cfg("sun_test_perturbations")
    cfg["dataset"] = {"name": "sun_test_perturbations", "pack": "sun_test_perturbations",
                      "splits": {"test": "test"}}
    cfg["protocol"] = {"init_from": "canonical_sun_models", "finetune": "none",
                       "eval_split": "test",
                       "thresholds": {"primary": "sun_val_frozen", "sensitivity": "sun_val_frozen"}}
    cfg["threshold_policy"] = "sun_val_frozen"
    return cfg


def _run_engine(engine, cfg, packs, out_dir, model_key, parent=None):
    if engine == "port":
        plan = proto.resolve_run_plan(cfg, model_key=model_key, seed=13, parent_checkpoint=parent)
        ctx = build_run(plan, output_dir=out_dir, pack_root=packs, model_overrides=TINY_MODEL,
                        exp_config_name="exp/test_exp.yaml", device="cpu")
        summary = run_classification_training(ctx, thresholds_root=Path(out_dir) / "thresholds")
    else:
        plan = jax_proto.resolve_run_plan(cfg, model_key=model_key, seed=13,
                                          parent_checkpoint=parent)
        ctx = jax_engine.build_run(plan, output_dir=out_dir, pack_root=packs,
                                   model_overrides=TINY_MODEL, exp_config_name="exp/test_exp.yaml")
        summary = jax_engine.run_classification_training(
            ctx, thresholds_root=Path(out_dir) / "thresholds")
    return ctx, summary


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """Per engine: exp1's two arms (seed 13) under ``<engine>/exp1``, then
    exp5b's eval-only run from the sup_imnet arm's checkpoint under
    ``<engine>/exp5b``.  TensorBoard's import is blocked, so the port's
    ``RunLogger`` takes its own event writer (TensorFlow takes seconds to
    import)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(sys.modules, "torch.utils.tensorboard", None)
        return _engine_runs(tmp_path_factory.mktemp("engines"))


def _engine_runs(root: Path) -> dict[str, Path]:
    packs = root / "data_packs"
    packs.mkdir()
    make_image_pack(packs, name="sun_full", frames_per_split=16, image_size=32)
    make_image_pack(packs, name="sun_test_perturbations", frames_per_split=10, image_size=32,
                    variant_rows=True)
    out = {}
    for engine in ("port", "jax"):
        parent = None
        for key in ARMS:
            ctx, _ = _run_engine(engine, _exp1_cfg(key), packs, root / engine / "exp1" / key, key)
            parent = parent or str(ctx.layout.checkpoint_path)
        _run_engine(engine, _exp5b_cfg(), packs, root / engine / "exp5b", "sup_imnet",
                    parent=parent)
        out[engine] = root / engine
    return out


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_engine_run_directories_report_byte_equal(engine_runs, engine, tmp_path):
    """exp1's two arms as the engine wrote them, read by both packages'
    exp1 reporters (seed check off: one seed each)."""
    runs = engine_runs[engine] / "exp1"
    stems = sorted(p.name for p in runs.rglob("*.metrics.json"))
    assert stems == ["SslImnet_SUNFull_s13.metrics.json", "SslImnet_SUNFull_s13_last.metrics.json",
                     "SupImnet_SUNFull_s13.metrics.json", "SupImnet_SUNFull_s13_last.metrics.json"]
    result = report_both("exp1", runs, tmp_path / "report", check_seed_protocol=False,
                         n_resamples=20)
    manifest = json.loads(result["manifest"].read_text())
    assert manifest["n_runs"] == 2
    assert {run["condition"] for run in manifest["runs"]} == set(ARMS)
    assert set(manifest["deltas"]["sup_imnet->ssl_imnet"]) == {"auroc", "f1"}
    assert all(math.isfinite(result["aggregates"][arm]["auroc"]["mean"]) for arm in ARMS)


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_exp5b_engine_output_is_refused_by_both_reporters(engine_runs, engine, tmp_path):
    """The exp5b payload either engine writes carries the frozen
    sensitivity record that ``config/exp/exp5b.yaml`` asks for, and the
    guardrails' exp5b spec has none: both packages' reporters refuse it with
    the same violation, for parity (which side is wrong is left open)."""
    runs = engine_runs[engine] / "exp5b"
    payload = json.loads(next(runs.rglob("*.metrics.json")).read_text())
    assert payload["eval_only"] is True and "sensitivity" in payload["thresholds"]
    report_refused("exp5b", runs, tmp_path / "report", "unexpected thresholds.sensitivity",
                   check_seed_protocol=False, n_resamples=10)
