"""Persist raw evaluation outputs (reference ``classification/eval_outputs.py``):
logits as both a torch-loadable ``logits.pt`` (the reference's wire format —
``eval_outputs.py:28`` writes ``torch.save(logits, out_dir / "logits.pt")``)
and ``logits.npz`` (this framework's native format, which also carries the
targets), per-frame metadata (jsonl), and the decision threshold (json).

The port's copy of ``ssl4polyp_tpu/evaluation/eval_outputs.py``;
``logits.pt`` goes through :mod:`ssl4polyp_tpu_torch.models.pth_writer`, and
``torch.load(..., weights_only=True)`` reads it back bit-exact."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..models.pth_writer import write_pt

__all__ = ["write_outputs"]


def write_outputs(
    output_dir: str | Path,
    *,
    logits: np.ndarray,
    targets: np.ndarray,
    metadata_rows: Sequence[Mapping[str, Any]],
    tau: Optional[float] = None,
) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    logits_np = np.asarray(logits)
    # Reference wire format: the bare (N, C) float tensor.
    write_pt(output_dir / "logits.pt", logits_np.astype(np.float32, copy=False))
    np.savez(
        output_dir / "logits.npz",
        logits=logits_np,
        targets=np.asarray(targets),
    )
    with open(output_dir / "metadata.jsonl", "w", encoding="utf-8") as handle:
        for row in metadata_rows:
            handle.write(json.dumps(dict(row), default=str) + "\n")
    (output_dir / "tau.json").write_text(
        json.dumps({"tau": float(tau) if tau is not None else None}, indent=2),
        encoding="utf-8",
    )
    return output_dir
