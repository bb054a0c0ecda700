"""The port's reporting-inputs staging (``ssl4polyp_tpu_torch/utils/
reporting_inputs.py``): port copies of ``test_reporting_inputs.py``'s
selection and staging tests, each also holding the port's choice and staged
tree to the JAX package's, and the CLI through both ``main``s on one
experiment config."""

from __future__ import annotations

import contextlib
import io
import shutil
from pathlib import Path

from ssl4polyp_tpu.utils import reporting_inputs as jax_reporting_inputs
from ssl4polyp_tpu_torch.utils.reporting_inputs import (
    main,
    select_metrics_files,
    stage_reporting_inputs,
)
from tests.test_reporting_inputs import make_run


def staged_tree(root: Path) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_select_prefers_last(tmp_path):
    make_run(tmp_path, "ModelA_SUN_s13")
    last = make_run(tmp_path, "ModelA_SUN_s13", last=True)
    assert select_metrics_files(tmp_path) == [last]
    assert jax_reporting_inputs.select_metrics_files(tmp_path) == [last]


def test_staging_copies_companions(tmp_path):
    runs = tmp_path / "runs"
    make_run(runs / "sun_baselines", "ModelA_SUN_s13")
    make_run(runs / "sun_baselines", "ModelA_SUN_s29")
    copied = stage_reporting_inputs(runs, tmp_path / "results", "exp1_inputs")
    dest = tmp_path / "results" / "reporting_inputs" / "exp1_inputs"
    names = sorted(p.name for p in dest.rglob("*") if p.is_file())
    assert "ModelA_SUN_s13.metrics.json" in names
    assert "ModelA_SUN_s13_test_outputs.csv" in names
    assert len(copied) == 4
    ours = staged_tree(dest)
    shutil.rmtree(tmp_path / "results")
    theirs = jax_reporting_inputs.stage_reporting_inputs(runs, tmp_path / "results",
                                                         "exp1_inputs")
    assert theirs == copied
    assert staged_tree(dest) == ours


def test_cli_stages_an_experiments_subdir_as_the_jax_cli_does(tmp_path):
    """``--exp-config exp/exp1`` names ``reporting.inputs_subdir``; every
    companion the engine writes (outputs, ROC and PR curves) is staged."""
    runs = tmp_path / "runs"
    for seed in (13, 29):
        metrics = make_run(runs / "sun_baselines", f"SupImnet_SUNFull_s{seed}", last=True)
        for kind in ("roc", "pr"):
            (metrics.parent / f"SupImnet_SUNFull_s{seed}_test_{kind}_curve.csv").write_text(
                "threshold,x,y\n0.5,0.1,0.9\n")
    argv = ["--exp-config", "exp/exp1", "--runs-root", str(runs),
            "--results-root", str(tmp_path / "results")]
    printed = []
    for cli in (main, jax_reporting_inputs.main):
        shutil.rmtree(tmp_path / "results", ignore_errors=True)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli(argv)
        printed.append((out.getvalue(), staged_tree(tmp_path / "results")))
    assert printed[0] == printed[1]
    said, tree = printed[0]
    assert said == "staged 8 files into reporting_inputs/exp1_sun_baselines_sup_vs_ssl\n"
    assert sorted(tree) == sorted(
        f"reporting_inputs/exp1_sun_baselines_sup_vs_ssl/sun_baselines/SupImnet_SUNFull_s{seed}"
        + suffix for seed in (13, 29)
        for suffix in ("_last.metrics.json", "_test_outputs.csv", "_test_roc_curve.csv",
                       "_test_pr_curve.csv"))
