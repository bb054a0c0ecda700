"""Stage per-run artifacts into the reporting-inputs tree.

Reference: ``src/ssl4polyp/utils/reporting_inputs.py`` — after each training
run, its metrics.json + outputs CSVs are copied into
``results/reporting_inputs/<exp_subdir>/`` (subdir from the experiment
config's ``reporting.inputs_subdir``), preferring ``*_last.metrics.json``
per leaf run directory.

The port's copy of ``ssl4polyp_tpu/utils/reporting_inputs.py``, run as
``python -m ssl4polyp_tpu_torch.utils.reporting_inputs`` with the same flags;
the experiment config is read through the port's own ``configs.layered``.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List, Optional

from ..configs.layered import load_layered_config

__all__ = ["select_metrics_files", "stage_reporting_inputs", "main"]


def select_metrics_files(run_dir: Path) -> List[Path]:
    """Pick the canonical metrics file per run stem (prefer ``*_last``)."""
    chosen: Dict[str, Path] = {}
    for path in sorted(run_dir.rglob("*.metrics.json")):
        name = path.name
        if name.endswith("_last.metrics.json"):
            stem = name[: -len("_last.metrics.json")]
            chosen[str(path.parent / stem)] = path
        else:
            stem = name[: -len(".metrics.json")]
            chosen.setdefault(str(path.parent / stem), path)
    return sorted(chosen.values())


def _companions(metrics_path: Path) -> List[Path]:
    stem = metrics_path.name
    for suffix in ("_last.metrics.json", ".metrics.json"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    out = []
    for pattern in (
        f"{stem}_test_outputs.csv",
        f"{stem}_zeroshot_outputs.csv",
        f"{stem}_test_roc_curve.csv",
        f"{stem}_test_pr_curve.csv",
    ):
        candidate = metrics_path.parent / pattern
        if candidate.exists():
            out.append(candidate)
    return out


def stage_reporting_inputs(
    runs_root: str | Path,
    results_root: str | Path,
    inputs_subdir: str,
) -> List[Path]:
    """Copy metrics + outputs into ``<results_root>/reporting_inputs/<subdir>``."""
    runs_root = Path(runs_root)
    destination = Path(results_root) / "reporting_inputs" / inputs_subdir
    destination.mkdir(parents=True, exist_ok=True)
    copied: List[Path] = []
    for metrics_path in select_metrics_files(runs_root):
        relative = metrics_path.relative_to(runs_root)
        target_dir = destination / relative.parent
        target_dir.mkdir(parents=True, exist_ok=True)
        for source in [metrics_path, *_companions(metrics_path)]:
            target = target_dir / source.name
            shutil.copy2(source, target)
            copied.append(target)
    return copied


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Stage run artifacts for reporting")
    parser.add_argument("--exp-config", required=True,
                        help="experiment config declaring reporting.inputs_subdir")
    parser.add_argument("--runs-root", required=True)
    parser.add_argument("--results-root", default="results")
    args = parser.parse_args(argv)

    cfg = load_layered_config(args.exp_config)
    subdir = (cfg.get("reporting") or {}).get("inputs_subdir")
    if not subdir:
        raise SystemExit("Experiment config has no reporting.inputs_subdir")
    copied = stage_reporting_inputs(args.runs_root, args.results_root, subdir)
    print(f"staged {len(copied)} files into reporting_inputs/{subdir}")


if __name__ == "__main__":
    main()
