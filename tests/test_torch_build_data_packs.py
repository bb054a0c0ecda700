"""``scripts/torch/build_data_packs.sh --synthetic`` against
``scripts/build_data_packs.sh --synthetic``: both write into one directory
in turn, and the port's writes the same file list, the same bytes in every
CSV and frame, and the same manifests once the one field that carries the
clock (``generated_at``) is dropped.  The port's script runs with the JAX
stack blocked."""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import yaml

from tests.test_torch_sweep_scripts import script_env

ROOT = Path(__file__).resolve().parents[1]


def written(out: Path) -> dict[str, object]:
    """Every file under ``out``: manifests parsed without their clock,
    every other file as bytes."""
    files = {}
    for path in sorted(p for p in out.rglob("*") if p.is_file()):
        key = path.relative_to(out).as_posix()
        if path.name == "manifest.yaml":
            manifest = yaml.safe_load(path.read_text())
            manifest.pop("generated_at")
            files[key] = manifest
        else:
            files[key] = path.read_bytes()
    return files


def test_synthetic_packs_match_the_jax_script(tmp_path):
    out = tmp_path / "data_packs"
    runs = {}
    for script, env in (
            ("scripts/build_data_packs.sh",
             {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
              "PYTHONPATH": str(ROOT), "PATH": script_env(tmp_path)["PATH"]}),
            ("scripts/torch/build_data_packs.sh", script_env(tmp_path))):
        shutil.rmtree(out, ignore_errors=True)
        result = subprocess.run(["bash", script, "--synthetic", str(out)], cwd=ROOT, env=env,
                                capture_output=True, text=True, timeout=600)
        assert result.returncode == 0, (script, result.stderr[-4000:])
        runs[script] = (result.stdout, written(out))
    theirs, ours = runs.values()
    assert ours[0] == theirs[0]
    assert ours[0].splitlines()[-1] == f"all packs written under {out}"
    assert sorted(ours[1]) == sorted(theirs[1])
    assert {name for name in ours[1] if name.endswith("manifest.yaml")} == {
        f"{pack}/manifest.yaml" for pack in (
            "sun_full", "sun_morphology", "sun_test_perturbations", "polypgen_clean_test",
            "polypgen_clean_test_extended")} | {
        f"sun_subsets/sun_p{p:02d}/manifest.yaml" for p in (5, 10, 25, 50, 100)} | {
        f"polypgen_fewshot/polypgen_fewshot_s{b}/manifest.yaml" for b in (20, 40)}
    assert [name for name in ours[1] if ours[1][name] != theirs[1][name]] == []
    assert sum(name.endswith(".csv") for name in ours[1]) > 20
