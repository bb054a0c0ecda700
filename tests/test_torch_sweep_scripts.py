"""The port's sweep scripts (``scripts/torch/``) on the CPU with the JAX stack
blocked: ``run_exp1.sh`` (through ``run_exp_common.sh``) sweeps exp1's two
arms over the seed trio {13, 29, 47} with the port's fine-tune CLI, stages
the reporting inputs, and the port's exp1 reporter, seed check on, reports
the staged tree byte-equal to the JAX reporter.  The tiny ViT (D 32, depth
2, 2 heads, patch 8, 32 px) comes from a ``sitecustomize`` on the test's
``PYTHONPATH`` that widens no flag of the port: it wraps
``models.factory.build_classifier`` as the module is imported, as the
hygiene scripts patch the factory, and blocks jax, flax, msgpack,
scikit-learn, the JAX package and TensorBoard in every process the scripts
start."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import yaml

from ssl4polyp_tpu.analysis import exp_reports as jax_reports
from ssl4polyp_tpu_torch.models.mae import MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)
SEEDS = (13, 29, 47)
STEMS = [f"{model}_SUNFull_s{seed}" for model in ("SupImnet", "SslImnet") for seed in SEEDS]

SITECUSTOMIZE = '''
import importlib.abc
import importlib.machinery
import sys

for name in ("jax", "flax", "msgpack", "sklearn", "ssl4polyp_tpu", "torch.utils.tensorboard"):
    sys.modules[name] = None  # any import of them raises ImportError

TINY = {"embed_dim": 32, "depth": 2, "num_heads": 2, "patch_size": 8}


class TinyFactory(importlib.abc.MetaPathFinder):
    """Widths of the tiny ViT for every classifier the factory builds."""

    def find_spec(self, name, path, target=None):
        if name != "ssl4polyp_tpu_torch.models.factory":
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            build = module.build_classifier
            module.build_classifier = lambda *a, **kw: build(*a, **{**kw, **TINY})
        spec.loader.exec_module = exec_module
        return spec


sys.meta_path.insert(0, TinyFactory())
'''


def script_env(tmp_path: Path, **extra: str) -> dict[str, str]:
    """The environment of a user's shell: ``python`` is this interpreter,
    the repository and the test's ``sitecustomize`` are importable."""
    hook = tmp_path / "hook"
    hook.mkdir(exist_ok=True)
    (hook / "sitecustomize.py").write_text(SITECUSTOMIZE)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env['PATH']}",
               PYTHONPATH=f"{hook}{os.pathsep}{ROOT}", **extra)
    return env


def write_inputs(root: Path) -> dict[str, Path]:
    """A sun_full pack of 32-px frames and the two arms' weight files at
    the tiny width, where their model configs name them."""
    import chip_smoke

    packs = root / "data_packs"
    build_synthetic_pack(packs, name="sun_full", frames_per_split=8, image_size=32)
    weights = root / "checkpoint_root"

    def named(model):
        return weights / yaml.safe_load((ROOT / "config" / "model" / f"{model}.yaml")
                                        .read_text())["model"]["checkpoint"]

    chip_smoke.write_augreg_npz(named("sup_imnet"), ViTConfig(**TINY, num_classes=2),
                                np.random.default_rng(1))
    chip_smoke.write_mae_pth(named("ssl_imnet"), MAEConfig(
        encoder=ViTConfig(**TINY), decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2),
        np.random.default_rng(0))
    return {"packs": packs, "weights": weights}


def test_run_exp1_sweeps_the_seed_trio_and_the_port_reports_it(tmp_path):
    inputs = write_inputs(tmp_path)
    out, results = tmp_path / "out", tmp_path / "results"
    env = script_env(tmp_path, OUTPUT_DIR=str(out), RESULTS_DIR=str(results))
    sweep = subprocess.run(
        ["bash", "scripts/torch/run_exp1.sh", "--pack-root", str(inputs["packs"]),
         "--checkpoint-root", str(inputs["weights"]), "--thresholds-root", str(tmp_path / "th"),
         "--device", "cpu", "--override", "epochs=1", "--override", "batch_size=4",
         "--override", "image_size=32", "--override", "num_workers=1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert sweep.returncode == 0, sweep.stderr[-4000:]
    lines = sweep.stdout.splitlines()
    assert [line for line in lines if line.startswith("===")] == [
        f"=== exp/exp1 model={model} seed={seed} ===" for model in ("sup_imnet", "ssl_imnet")
        for seed in SEEDS]
    summaries = [json.loads(line) for line in lines if line.startswith("{")]
    assert [s["stem"] for s in summaries] == STEMS
    assert all(s["epochs_run"] == 1 for s in summaries)
    assert lines[-1] == "staged 24 files into reporting_inputs/exp1_sun_baselines_sup_vs_ssl"
    staged = results / "reporting_inputs" / "exp1_sun_baselines_sup_vs_ssl"
    assert sorted(p.name for p in staged.rglob("*") if p.is_file()) == sorted(
        stem + suffix for stem in STEMS for suffix in (
            "_last.metrics.json", "_test_outputs.csv", "_test_roc_curve.csv",
            "_test_pr_curve.csv"))

    report = tmp_path / "report"
    said = subprocess.run(
        ["python", "-m", "ssl4polyp_tpu_torch.analysis.exp_reports", "exp1", "--runs-root",
         str(staged), "--output-dir", str(report), "--resamples", "50"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert said.returncode == 0, said.stderr[-4000:]
    assert said.stdout == f"wrote {report / 'exp1_report.md'}\n"
    ours = {p.name: p.read_bytes() for p in report.iterdir()}
    manifest = json.loads(ours["exp1_manifest.json"])
    assert manifest["n_runs"] == 6
    assert sorted((r["condition"], r["seed"]) for r in manifest["runs"]) == [
        (arm, seed) for arm in ("ssl_imnet", "sup_imnet") for seed in SEEDS]
    assert set(manifest["deltas"]["sup_imnet->ssl_imnet"]) == {"auroc", "f1"}

    shutil.rmtree(report)
    jax_reports.run_report("exp1", staged, report, n_resamples=50)
    assert {p.name: p.read_bytes() for p in report.iterdir()} == ours
