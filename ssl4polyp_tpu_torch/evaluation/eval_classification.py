"""Standalone evaluation CLI with canonical checkpoint discovery.

The port's copy of ``ssl4polyp_tpu/evaluation/eval_classification.py``: it
reads the same ``.ckpt`` files (:mod:`..utils.checkpoint`) and data packs,
and runs the forward on the card through the port's kernels::

    python -m ssl4polyp_tpu_torch.evaluation.eval_classification \\
        --checkpoint run/SupImnet_SUNFull_s13.ckpt --test-pack sun_full \\
        --pack-root data_packs --export-outputs

Capability parity with the reference evaluator
(``src/ssl4polyp/classification/eval_classification.py``):

* discovers checkpoints by parsing canonical stems
  ``<Model>_<Data>[_qualifiers]_s<seed>[_e<epoch>_<tag>].ckpt`` under a root
  and filters by ``--model-tag/--data-tag/--seed/--best-tag`` (``:106-218``);
* resolves the decision threshold from (in order) an explicit ``--tau``, a
  stored thresholds block in the checkpoint meta / sibling metrics.json, or
  a fresh Youden recompute on a ``--threshold-pack`` (``:821-910``);
* runs the evaluation split and writes ``eval_results.txt`` plus optional
  raw outputs via :mod:`.eval_outputs`.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import torch

from ..data.loader import HostDataLoader
from ..data.packs import create_classification_datasets
from ..metrics.thresholds import compute_youden_threshold, load_thresholds
from ..models.factory import build_classifier
from ..training.classification import make_forward_fn
from ..utils.checkpoint import load_checkpoint, load_checkpoint_meta
from .eval_outputs import write_outputs
from .evaluate import evaluate_split

__all__ = ["CheckpointInfo", "discover_checkpoints", "filter_candidates", "parse_checkpoint_name",
           "resolve_tau", "evaluate", "cli_main"]

_STEM_RE = re.compile(
    r"^(?P<model>[A-Za-z0-9]+)_(?P<data>[A-Za-z0-9]+)"
    r"(?P<qualifiers>(?:_[A-Za-z0-9+]+)*?)"
    r"_s(?P<seed>\d+)"
    r"(?:_last)?"
    r"(?:_e(?P<epoch>\d+)_(?P<tag>[A-Za-z0-9+]+))?$"
)


@dataclass(frozen=True)
class CheckpointInfo:
    path: Path
    model_tag: str
    data_tag: str
    seed: int
    epoch: Optional[int]
    selection_tag: Optional[str]
    is_pointer: bool

    @property
    def stem(self) -> str:
        return self.path.stem


def parse_checkpoint_name(path: Path) -> Optional[CheckpointInfo]:
    stem = path.name
    if stem.endswith(".ckpt"):
        stem = stem[: -len(".ckpt")]
    match = _STEM_RE.match(stem)
    if not match:
        return None
    return CheckpointInfo(
        path=path,
        model_tag=match.group("model"),
        data_tag=match.group("data"),
        seed=int(match.group("seed")),
        epoch=int(match.group("epoch")) if match.group("epoch") else None,
        selection_tag=match.group("tag"),
        is_pointer=match.group("epoch") is None,
    )


def discover_checkpoints(root: str | Path) -> List[CheckpointInfo]:
    root = Path(root)
    found: List[CheckpointInfo] = []
    for path in sorted(root.rglob("*.ckpt")):
        if path.name.endswith(".ckpt.json"):
            continue
        info = parse_checkpoint_name(path)
        if info is not None:
            found.append(info)
    return found


def filter_candidates(
    candidates: List[CheckpointInfo],
    *,
    model_tag: Optional[str] = None,
    data_tag: Optional[str] = None,
    seed: Optional[int] = None,
    best_tag: Optional[str] = None,
) -> List[CheckpointInfo]:
    out = candidates
    if model_tag:
        out = [c for c in out if c.model_tag.lower() == model_tag.lower()]
    if data_tag:
        out = [c for c in out if c.data_tag.lower() == data_tag.lower()]
    if seed is not None:
        out = [c for c in out if c.seed == int(seed)]
    if best_tag:
        out = [c for c in out if (c.selection_tag or "").lower() == best_tag.lower()]
    return out


def _load_threshold_sources(checkpoint_path: Path) -> Dict[str, Any]:
    """Collect thresholds from checkpoint meta, sidecars, and metrics.json."""
    sources: Dict[str, Any] = {"values": {}, "records": {}}
    try:
        meta = load_checkpoint_meta(checkpoint_path)
    except Exception:
        meta = {}
    block = meta.get("thresholds")
    if isinstance(block, Mapping):
        sources["records"].update(
            {k: v for k, v in block.items() if isinstance(v, Mapping)}
        )
        values = block.get("values")
        if isinstance(values, Mapping):
            sources["values"].update({str(k): float(v) for k, v in values.items()})

    stem = checkpoint_path.with_suffix("")
    sidecar = Path(str(stem) + ".thresholds.json")
    if sidecar.exists():
        sources["values"].update(load_thresholds(sidecar))
    for candidate in (Path(str(stem) + ".metrics.json"), Path(str(stem) + "_last.metrics.json")):
        if candidate.exists():
            payload = json.loads(candidate.read_text(encoding="utf-8"))
            block = payload.get("thresholds")
            if isinstance(block, Mapping):
                sources["records"].setdefault("primary", block.get("primary"))
                values = block.get("values")
                if isinstance(values, Mapping):
                    for key, value in values.items():
                        sources["values"].setdefault(str(key), float(value))
            break
    return sources


def resolve_tau(
    checkpoint_path: Path,
    *,
    explicit_tau: Optional[float] = None,
    threshold_key: Optional[str] = None,
) -> Optional[float]:
    if explicit_tau is not None:
        return float(explicit_tau)
    sources = _load_threshold_sources(checkpoint_path)
    if threshold_key:
        if threshold_key in sources["values"]:
            return float(sources["values"][threshold_key])
        # A NAMED key that is absent must fail loudly — silently falling
        # back to another stored tau would run threshold-sensitive
        # comparisons at an unintended operating point.
        available = ", ".join(sorted(sources["values"])) or "<none>"
        raise KeyError(
            f"threshold key {threshold_key!r} not stored with "
            f"{checkpoint_path} (available: {available})"
        )
    primary = sources["records"].get("primary")
    if isinstance(primary, Mapping) and isinstance(primary.get("tau"), (int, float)):
        return float(primary["tau"])
    if sources["values"]:
        return float(next(iter(sorted(sources["values"].items())))[1])
    return None


def evaluate(
    checkpoint: str | Path,
    test_spec: str | Path,
    *,
    pack_root: Optional[Path] = None,
    batch_size: int = 64,
    image_size: int = 224,
    tau: Optional[float] = None,
    threshold_key: Optional[str] = None,
    threshold_pack: Optional[str | Path] = None,
    output_dir: Optional[Path] = None,
    model_overrides: Optional[Mapping[str, Any]] = None,
    num_workers: int = 8,
    export_outputs: bool = False,
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Evaluate a trained classifier checkpoint on a test pack.

    The model runs on ``device``: on a CUDA device through the port's
    kernels, on ``"cpu"`` (the tests) through their plain versions.  One
    process evaluates the whole pack (the JAX package's per-host stripes come
    with the multi-GPU slice)."""
    checkpoint = Path(checkpoint)
    restored = load_checkpoint(checkpoint)

    datasets = create_classification_datasets(
        test_spec=test_spec, pack_root=pack_root, image_size=image_size,
    )
    index = datasets["test"]

    # Rebuild the architecture from the checkpoint's recorded model config,
    # allowing explicit overrides on top.
    overrides = {}
    stored_cfg = restored.get("meta", {}).get("model_cfg")
    num_classes = 2
    if isinstance(stored_cfg, Mapping):
        overrides.update({k: v for k, v in stored_cfg.items() if k != "num_classes"})
        # Rebuild with the TRAINING-TIME head width; hard-coding 2 made
        # multiclass checkpoints impossible to evaluate.
        stored_classes = stored_cfg.get("num_classes")
        if isinstance(stored_classes, int) and stored_classes > 0:
            num_classes = stored_classes
    overrides.update(dict(model_overrides or {}))
    overrides.setdefault("img_size", image_size)
    # The checkpoint holds the JAX package's parameter layout; the factory
    # carries it into the torch modules (models/weights.py).
    classifier = build_classifier(
        torch.Generator().manual_seed(0), {"pretraining": "random"},
        num_classes=num_classes, jax_params=restored["payload"]["params"], device=device,
        **overrides,
    )
    forward = make_forward_fn(classifier, device)()

    resolved_tau = resolve_tau(checkpoint, explicit_tau=tau, threshold_key=threshold_key)
    if resolved_tau is None and threshold_pack is not None:
        th_sets = create_classification_datasets(
            val_spec=threshold_pack, pack_root=pack_root, image_size=image_size,
        )
        th_loader = HostDataLoader(
            th_sets["val"], batch_size=batch_size, shuffle=False, num_workers=num_workers,
        )
        th_results = evaluate_split(
            forward, th_loader, th_sets["val"],
            split_name="threshold", num_classes=num_classes, tau=None,
        )
        resolved_tau = compute_youden_threshold(
            th_results["probabilities"], th_results["targets"]
        )

    loader = HostDataLoader(
        index, batch_size=batch_size, shuffle=False, num_workers=num_workers, drop_last=False,
    )
    results = evaluate_split(
        forward, loader, index,
        split_name="test", num_classes=num_classes, tau=resolved_tau,
        perturbation_eval=index.perturbations_enabled,
    )

    summary = {
        k: v for k, v in results.items()
        if isinstance(v, (int, float)) and not k.startswith("_")
    }
    summary["tau"] = resolved_tau
    summary["checkpoint"] = str(checkpoint)
    summary["n_frames"] = int(len(results["targets"]))

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        lines = [f"checkpoint: {checkpoint}", f"tau: {resolved_tau}"]
        lines += [f"{k}: {v}" for k, v in sorted(summary.items()) if isinstance(v, (int, float))]
        (output_dir / "eval_results.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
        if export_outputs:
            write_outputs(
                output_dir,
                logits=results["logits"],
                targets=results["targets"],
                metadata_rows=results["metadata_rows"],
                tau=resolved_tau,
            )
    return summary


def cli_main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Standalone classification evaluation")
    parser.add_argument("--checkpoint", default=None, help="explicit checkpoint path")
    parser.add_argument("--checkpoint-root", default=None, help="discovery root")
    parser.add_argument("--model-tag", default=None)
    parser.add_argument("--data-tag", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--best-tag", default=None)
    parser.add_argument("--test-pack", required=True)
    parser.add_argument("--pack-root", default=None)
    parser.add_argument("--threshold-pack", default=None)
    parser.add_argument("--threshold-key", default=None)
    parser.add_argument("--tau", type=float, default=None)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--output-dir", default="eval_out")
    parser.add_argument("--export-outputs", action="store_true")
    parser.add_argument("--num-workers", type=int, default=8, help="frame decode threads")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs; the kernels need a CUDA device")
    args = parser.parse_args(argv)

    checkpoint: Optional[Path] = Path(args.checkpoint) if args.checkpoint else None
    if checkpoint is None:
        if not args.checkpoint_root:
            raise SystemExit("Provide --checkpoint or --checkpoint-root")
        candidates = discover_checkpoints(args.checkpoint_root)
        filtered = filter_candidates(
            candidates,
            model_tag=args.model_tag, data_tag=args.data_tag,
            seed=args.seed, best_tag=args.best_tag,
        )
        if not filtered:
            listing = "\n".join(f"  {c.path}" for c in candidates[:20])
            raise SystemExit(
                f"No checkpoint matched the filters. Candidates seen:\n{listing}"
            )
        # Prefer concrete (epoch-tagged) checkpoints over pointers, newest epoch first.
        filtered.sort(key=lambda c: (c.is_pointer, -(c.epoch or -1)))
        checkpoint = filtered[0].path

    summary = evaluate(
        checkpoint,
        args.test_pack,
        pack_root=Path(args.pack_root) if args.pack_root else None,
        batch_size=args.batch_size,
        image_size=args.image_size,
        tau=args.tau,
        threshold_key=args.threshold_key,
        threshold_pack=args.threshold_pack,
        output_dir=Path(args.output_dir),
        export_outputs=args.export_outputs,
        num_workers=args.num_workers,
        device=args.device,
    )
    print(json.dumps(summary, indent=2, default=str))


if __name__ == "__main__":
    cli_main()
