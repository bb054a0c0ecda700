#!/usr/bin/env python
"""Aggregate per-seed metrics.json files: mean/std plus bootstrap CI.

Reference: ``scripts/aggregate_metrics.py``; the port's copy, host-only
numpy, on the metrics files either engine writes.  Input: one or more
metrics JSON files (or a glob root); output: a JSON document with
per-metric mean/std/min/max and a percentile bootstrap CI over seeds.
Usage:
    python scripts/torch/aggregate_metrics.py <metrics.json | dir>... [--block B] [--output F]
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np


def collect_metric_values(paths: List[Path], block: str) -> Dict[str, List[float]]:
    values: Dict[str, List[float]] = {}
    for path in paths:
        payload = json.loads(path.read_text(encoding="utf-8"))
        section = payload.get(block) or {}
        for key, value in section.items():
            if isinstance(value, (int, float)) and math.isfinite(float(value)):
                values.setdefault(key, []).append(float(value))
    return values


def aggregate(values: List[float], n_boot: int = 2000, ci: float = 0.95) -> Dict[str, float]:
    array = np.asarray(values, dtype=float)
    out = {
        "mean": float(array.mean()),
        "std": float(array.std(ddof=1)) if array.size > 1 else 0.0,
        "min": float(array.min()),
        "max": float(array.max()),
        "n": int(array.size),
    }
    if array.size > 1:
        rng = np.random.default_rng(1337)
        samples = rng.choice(array, size=(n_boot, array.size), replace=True).mean(axis=1)
        alpha = (1 - ci) / 2
        out["ci_lower"] = float(np.quantile(samples, alpha))
        out["ci_upper"] = float(np.quantile(samples, 1 - alpha))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("inputs", nargs="+", help="metrics.json files or directories")
    parser.add_argument("--block", default="test_primary")
    parser.add_argument("--output", default=None)
    args = parser.parse_args()

    paths: List[Path] = []
    for item in args.inputs:
        p = Path(item)
        if p.is_dir():
            paths.extend(sorted(p.rglob("*.metrics.json")))
        else:
            paths.append(p)
    if not paths:
        raise SystemExit("No metrics files found")

    values = collect_metric_values(paths, args.block)
    result = {
        "block": args.block,
        "n_files": len(paths),
        "metrics": {key: aggregate(vals) for key, vals in sorted(values.items())},
    }
    text = json.dumps(result, indent=2)
    if args.output:
        Path(args.output).write_text(text, encoding="utf-8")
    print(text)


if __name__ == "__main__":
    main()
