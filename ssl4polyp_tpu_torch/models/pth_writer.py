"""Writer for PyTorch ``.pt`` files from numpy object graphs.

Counterpart of ``ssl4polyp_tpu/models/pth_writer.py``, which emits torch's
zipfile format by hand because its hosts have no torch.  The port has torch:
``write_pt`` turns every numpy array of the graph into a CPU tensor and calls
``torch.save``, which writes the same format (``torch.load(...,
weights_only=True)`` reads it back).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["write_pt"]


def _tensors(obj: Any) -> Any:
    if isinstance(obj, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, dict):
        return {key: _tensors(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors(item) for item in obj)
    if obj is None or isinstance(obj, (str, bytes, bool, int, float)):
        return obj
    raise TypeError(f"cannot serialize {type(obj).__name__!r} into a .pt file")


def write_pt(path: str | Path, obj: Any) -> Path:
    """Serialize ``obj`` (any nesting of dict/list/tuple, str/bytes, numbers,
    None and numpy arrays, the arrays written as CPU tensors of the matching
    dtype) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_tensors(obj), path)
    return path
