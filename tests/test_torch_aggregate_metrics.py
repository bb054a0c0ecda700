"""The port's ``scripts/torch/aggregate_metrics.py`` against the JAX package's
``scripts/aggregate_metrics.py``: the same JSON bytes on the same metrics
files, printed and written (as ``tests/test_reporting_inputs.py`` runs the
JAX script)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {"jax": ROOT / "scripts" / "aggregate_metrics.py",
           "torch": ROOT / "scripts" / "torch" / "aggregate_metrics.py"}


def _write_runs(root: Path, seeds, seed_offset: int = 0) -> list[Path]:
    """One ``<stem>.metrics.json`` a seed, as the engines write them: blocks
    of numbers, a non-finite value and a string the aggregation skips."""
    rng = np.random.default_rng(len(seeds) + seed_offset)
    paths = []
    for seed in seeds:
        run = root / f"s{seed}" / "sun_baselines"
        run.mkdir(parents=True)
        block = {"auroc": float(rng.uniform(0.8, 1.0)), "f1": float(rng.uniform(0.5, 0.9)),
                 "loss": float(rng.uniform(0.1, 0.7)), "tp": int(rng.integers(10, 90)),
                 "mcc": float("nan"), "policy": "f1_opt_on_val"}
        payload = {"seed": seed, "test_primary": block,
                   "val": {k: v for k, v in block.items() if k != "tp"}}
        path = run / f"SupImnet_SUNFull_s{seed}.metrics.json"
        path.write_text(json.dumps(payload))
        paths.append(path)
    return paths


def _run(which: str, args, out: Path | None = None) -> str:
    argv = [sys.executable, str(SCRIPTS[which]), *map(str, args)]
    if out is not None:
        argv += ["--output", str(out)]
    return subprocess.run(argv, capture_output=True, text=True, check=True, cwd=ROOT).stdout


@pytest.mark.parametrize("seeds, block, by_file", [
    ((13, 29, 47), "test_primary", False),
    ((13, 29, 47), "val", True),
    ((13,), "test_primary", False),
    ((13, 29, 47, 61, 71), "test_primary", True),
], ids=["trio", "trio-val-files", "one-seed", "five-seeds-files"])
def test_the_port_s_script_writes_the_jax_script_s_bytes(tmp_path, seeds, block, by_file):
    paths = _write_runs(tmp_path / "runs", seeds)
    args = [*paths] if by_file else [tmp_path / "runs"]
    args += ["--block", block]
    printed = {which: _run(which, args, tmp_path / f"{which}.json") for which in SCRIPTS}
    assert printed["torch"] == printed["jax"]
    written = {which: (tmp_path / f"{which}.json").read_bytes() for which in SCRIPTS}
    assert written["torch"] == written["jax"]
    payload = json.loads(printed["torch"])
    assert payload["n_files"] == len(seeds) and payload["block"] == block
    assert "mcc" not in payload["metrics"] and "policy" not in payload["metrics"]
    assert ("ci_lower" in payload["metrics"]["auroc"]) == (len(seeds) > 1)


def test_the_port_s_script_refuses_an_empty_root_as_the_jax_script_does(tmp_path):
    results = [subprocess.run([sys.executable, str(SCRIPTS[which]), str(tmp_path)],
                              capture_output=True, text=True, cwd=ROOT) for which in SCRIPTS]
    assert [r.returncode for r in results] == [1, 1]
    assert results[0].stderr == results[1].stderr
    assert "No metrics files found" in results[1].stderr


def test_the_port_s_script_differs_from_the_jax_script_in_its_docstring_only():
    def code(path):
        text = path.read_text()
        start = text.index('"""')
        return text[:start] + text[text.index('"""', start + 3) + 3:]
    assert code(SCRIPTS["torch"]) == code(SCRIPTS["jax"])
