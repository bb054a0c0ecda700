"""``polypdb`` CLI (reference ``src/ssl4polyp/polypdb/cli.py``).

The port's copy of ``ssl4polyp_tpu/polypdb/cli.py``, run as ``python -m
ssl4polyp_tpu_torch.polypdb.cli``: the same subcommands and flags, paths
resolved through the port's own ``configs``, PyYAML imported where a spec is
read.

Subcommands (the ``generator.command`` lines in the reference pack manifests
define the build surface — e.g. ``data_packs/sun_full/manifest.yaml``):

* ``sun build / morph / subsets-canonical / perturbations`` — pack builders
* ``sun corrupt`` — render corruption variants from a spec
* ``polypgen build / fewshot`` — PolypGen clean-test + few-shot packs
* ``synth`` / ``synth-root`` — synthetic smoke-test assets
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path
from typing import List, Optional

from ..configs import resolve_config_path, resolve_data_pack_path

from .robustness import build_sun_test_corruptions

__all__ = ["main", "check_csv_paths"]


def _resolve(path: Path, resolver) -> Path:
    if path.is_absolute() or path.exists():
        return path
    return resolver(path)


def check_csv_paths(csv_path: Path, roots: dict, sample: Optional[int] = None) -> List[Path]:
    """Verify every frame_path resolves through the roots map; returns misses."""
    missing: List[Path] = []
    with open(csv_path, newline="", encoding="utf-8") as handle:
        reader = csv.DictReader(handle)
        for index, row in enumerate(reader):
            if sample is not None and index >= sample:
                break
            frame = Path(row["frame_path"])
            root = frame.parts[0]
            if root in roots:
                resolved = Path(roots[root]).joinpath(*frame.parts[1:])
            else:
                resolved = frame
            if not resolved.exists():
                missing.append(resolved)
    return missing


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="polypdb")
    subparsers = parser.add_subparsers(dest="command")

    sun = subparsers.add_parser("sun")
    sun_sub = sun.add_subparsers(dest="sun_command")
    corrupt = sun_sub.add_parser("corrupt")
    corrupt.add_argument("--pack", type=Path, required=True)
    corrupt.add_argument("--spec", type=Path, required=True)
    corrupt.add_argument("--roots", type=Path, default=Path("data") / "roots.json")
    corrupt.add_argument(
        "--out", type=Path, default=Path("results") / "polypdb" / "sun_corruptions"
    )

    for builder_name in ("build", "morph"):
        builder = sun_sub.add_parser(
            builder_name, help=f"build the sun_{'full' if builder_name == 'build' else 'morphology'} pack"
        )
        builder.add_argument("--root", type=Path, required=True)
        builder.add_argument("--out", type=Path, required=True)
        builder.add_argument("--seed", type=int, default=47)
        builder.add_argument("--frames-per-case", type=int, default=33)
        builder.add_argument(
            "--cases-per-split", type=int, nargs=3, default=[70, 15, 15],
            metavar=("TRAIN", "VAL", "TEST"),
        )

    subsets = sun_sub.add_parser("subsets-canonical",
                                 help="nested train-percent subsets of a sun pack")
    subsets.add_argument("--pack", type=Path, required=True)
    subsets.add_argument("--percents", type=int, nargs="+",
                         default=[5, 10, 25, 50, 100])
    subsets.add_argument("--seed", type=int, default=13)
    subsets.add_argument("--out", type=Path, required=True)

    perturb = sun_sub.add_parser("perturbations",
                                 help="16-variant robustness grid over a sun test split")
    perturb.add_argument("--pack", type=Path, required=True)
    perturb.add_argument("--out", type=Path, required=True)
    perturb.add_argument("--master-seed", type=int, default=47)

    polypgen = subparsers.add_parser("polypgen")
    polypgen_sub = polypgen.add_subparsers(dest="polypgen_command")
    pg_build = polypgen_sub.add_parser("build", help="clean PolypGen test pack")
    pg_build.add_argument("--root", type=Path, required=True)
    pg_build.add_argument("--out", type=Path, required=True)
    pg_build.add_argument("--track", default="clean", choices=["clean"])
    pg_build.add_argument("--include-negative-sequences", action="store_true")
    pg_fewshot = polypgen_sub.add_parser("fewshot", help="budgeted few-shot packs")
    pg_fewshot.add_argument("--parent-pack", type=Path, required=True)
    pg_fewshot.add_argument("--out", type=Path, required=True)
    pg_fewshot.add_argument("--budgets", type=int, nargs="+",
                            default=[50, 100, 200, 500])
    pg_fewshot.add_argument("--seed", type=int, default=13)
    pg_fewshot.add_argument("--max-frames-per-sequence", type=int, default=5)

    synth_root = subparsers.add_parser(
        "synth-root", help="generate a synthetic SUN/PolypGen dataset root"
    )
    synth_root.add_argument("--layout", choices=["sun", "polypgen"], required=True)
    synth_root.add_argument("--out", type=Path, required=True)
    synth_root.add_argument("--seed", type=int, default=0)
    synth_root.add_argument("--image-size", type=int, default=64)
    synth_root.add_argument("--scale", type=float, default=1.0,
                            help="multiplier on the default case/frame counts")

    synth = subparsers.add_parser(
        "synth", help="generate a synthetic smoke-test pack (images + CSVs + manifest)"
    )
    synth.add_argument("--out", type=Path, required=True)
    synth.add_argument("--name", default="synthetic_pack")
    synth.add_argument("--frames-per-split", type=int, default=32)
    synth.add_argument("--image-size", type=int, default=224)
    synth.add_argument("--seed", type=int, default=0)
    synth.add_argument("--splits", nargs="+", default=["train", "val", "test"])

    args = parser.parse_args(argv)
    if args.command == "synth":
        from .synth import build_synthetic_pack

        pack_dir = build_synthetic_pack(
            args.out,
            name=args.name,
            splits=tuple(args.splits),
            frames_per_split=args.frames_per_split,
            image_size=args.image_size,
            seed=args.seed,
        )
        print(f"wrote synthetic pack to {pack_dir}")
    elif args.command == "synth-root":
        from .synth import build_synthetic_polypgen_root, build_synthetic_sun_root

        if args.layout == "sun":
            root = build_synthetic_sun_root(
                args.out, seed=args.seed, image_size=args.image_size,
                pos_cases=max(3, int(12 * args.scale)),
                frames_per_case=max(4, int(12 * args.scale)),
                frames_per_source=max(12, int(40 * args.scale)),
            )
        else:
            root = build_synthetic_polypgen_root(
                args.out, seed=args.seed, image_size=args.image_size,
                pos_per_centre=max(4, int(12 * args.scale)),
                frames_per_sequence=max(4, int(10 * args.scale)),
            )
        print(f"wrote synthetic {args.layout} root to {root}")
    elif args.command == "sun" and args.sun_command in {"build", "morph"}:
        from .builders import build_sun_morphology_pack, build_sun_pack

        builder_fn = build_sun_pack if args.sun_command == "build" else build_sun_morphology_pack
        out = builder_fn(
            args.root, args.out, seed=args.seed,
            frames_per_case=args.frames_per_case,
            cases_per_split=tuple(args.cases_per_split),
        )
        print(f"wrote pack to {out}")
    elif args.command == "sun" and args.sun_command == "subsets-canonical":
        from .builders import build_sun_subsets

        outs = build_sun_subsets(args.pack, args.out, percents=args.percents,
                                 seed=args.seed)
        print("\n".join(f"wrote subset {o}" for o in outs))
    elif args.command == "sun" and args.sun_command == "perturbations":
        from .builders import build_sun_perturbations

        out = build_sun_perturbations(args.pack, args.out,
                                      master_seed=args.master_seed)
        print(f"wrote perturbation grid to {out}")
    elif args.command == "polypgen" and args.polypgen_command == "build":
        from .builders import build_polypgen_pack

        out = build_polypgen_pack(
            args.root, args.out,
            include_negative_sequences=args.include_negative_sequences,
        )
        print(f"wrote pack to {out}")
    elif args.command == "polypgen" and args.polypgen_command == "fewshot":
        from .builders import build_polypgen_fewshot

        outs = build_polypgen_fewshot(
            args.parent_pack, args.out, budgets=args.budgets, seed=args.seed,
            max_frames_per_sequence=args.max_frames_per_sequence,
        )
        print("\n".join(f"wrote fewshot pack {o}" for o in outs))
    elif args.command == "sun" and args.sun_command == "corrupt":
        import yaml

        pack_dir = _resolve(args.pack, resolve_data_pack_path)
        spec_path = _resolve(args.spec, resolve_config_path)
        roots_path = _resolve(args.roots, resolve_config_path)
        spec = yaml.safe_load(spec_path.read_text(encoding="utf-8"))
        roots = json.loads(roots_path.read_text(encoding="utf-8"))
        missing = check_csv_paths(pack_dir / "test.csv", roots)
        if missing:
            raise SystemExit(
                f"{len(missing)} frame paths do not resolve; first: {missing[0]}"
            )
        build_sun_test_corruptions(pack_dir, spec, roots, args.out)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
