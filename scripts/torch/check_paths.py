#!/usr/bin/env python
"""Verify that every frame_path in a split CSV resolves via a roots map.

Reference: ``scripts/check_paths.py``; the port's copy, through its
``polypdb.cli``.  Usage:
    python scripts/torch/check_paths.py <split.csv> <roots.json> [--sample N]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ssl4polyp_tpu_torch.polypdb.cli import check_csv_paths


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("csv", type=Path)
    parser.add_argument("roots", type=Path)
    parser.add_argument("--sample", type=int, default=None)
    args = parser.parse_args()
    roots = json.loads(args.roots.read_text(encoding="utf-8"))
    missing = check_csv_paths(args.csv, roots, sample=args.sample)
    if missing:
        for path in missing[:20]:
            print(f"MISSING {path}")
        raise SystemExit(f"{len(missing)} unresolved frame paths")
    print("all frame paths resolve")


if __name__ == "__main__":
    main()
