"""Reader for PyTorch ``.pth`` checkpoints.

Counterpart of ``ssl4polyp_tpu/models/pth_reader.py``, which parses torch's
zip and legacy formats by hand with a restricted unpickler because its hosts
have no torch.  The port has torch, so ``torch.load`` with
``weights_only=True`` does the parsing, with torch's own restricted unpickler, and admits exactly
the globals the JAX allow-list admits beyond plain tensors: ``argparse.Namespace``
(the run arguments the published MAE checkpoints carry as ``args``),
``collections.OrderedDict`` and numpy's ``_reconstruct``, ``ndarray``,
``dtype`` and ``scalar``.  Any other global raises
:class:`TorchUnpickleError` naming it; nothing ever unpickles an arbitrary
callable.

Both formats load: the zip format of ``torch.save`` since torch 1.6, and the
legacy one before it.  The JAX reader refuses a legacy file whose storages
carry view metadata (pre-0.4 views of a root storage) and leaves it to
torch; torch reads such a file correctly, so the port loads it.

Tensors come back as numpy arrays, as the JAX reader returns them, except
bfloat16 ones: numpy has no bfloat16 without ``ml_dtypes``, which the port
does not use, so a bfloat16 tensor stays a CPU ``torch.Tensor``.  The
factory casts every imported leaf to fp32, as the JAX factory does.
"""

from __future__ import annotations

import argparse
import collections
import pickle
import pickletools
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["read_pth", "read_pth_state_dict", "TorchUnpickleError"]


class TorchUnpickleError(RuntimeError):
    """A ``.pth`` contained a construct outside the supported subset."""


def _safe_globals() -> list:
    """The JAX allow-list's globals beyond plain tensors, under the names a
    pickle gives them (numpy's private module moved from ``numpy.core`` to
    ``numpy._core`` in numpy 2, so both names are admitted).  A pickled dtype
    is built as an instance of its own class (``numpy.dtypes.Float32DType``
    and so on), so those classes are admitted with ``numpy.dtype``; the
    object dtype is not."""
    reconstruct = np.ndarray.__reduce__(np.zeros(1))[0]
    scalar = np.float32(0).__reduce__()[0]
    dtype_classes = {type(np.dtype(code)) for code in np.typecodes["All"] if code != "O"}
    admitted: list = [argparse.Namespace, collections.OrderedDict, np.ndarray, np.dtype,
                      *sorted(dtype_classes, key=str)]
    for module in ("numpy.core.multiarray", "numpy._core.multiarray"):
        admitted += [(reconstruct, f"{module}._reconstruct"), (scalar, f"{module}.scalar")]
    return admitted


def _to_numpy(obj: Any) -> Any:
    """Replace every tensor in a container graph by its numpy array
    (bfloat16 tensors stay tensors); dict/list/tuple/set/Namespace are
    walked, as the JAX reader's ``_materialize`` walks them."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            return obj.detach().contiguous()
        return obj.detach().contiguous().numpy()
    if isinstance(obj, dict):
        for k in list(obj):
            obj[k] = _to_numpy(obj[k])
        return obj
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_to_numpy(v) for v in obj)
    if isinstance(obj, set):
        return {_to_numpy(v) for v in obj}
    if isinstance(obj, argparse.Namespace):
        for k, v in vars(obj).items():
            setattr(obj, k, _to_numpy(v))
        return obj
    return obj


def read_pth(path: str | Path) -> Any:
    """Load a ``.pth`` checkpoint on the CPU.

    Returns the deserialized object graph with every tensor as a
    ``np.ndarray`` (bfloat16 ones as CPU tensors).  Raises
    :class:`TorchUnpickleError` for a pickle global outside the allow-list.
    """
    path = Path(path)
    try:
        with torch.serialization.safe_globals(_safe_globals()):
            graph = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise TorchUnpickleError(
            f"{path}: unsupported pickle globals {_refused_globals(path)} -- refusing to load "
            f"(the .pth reader supports plain tensor checkpoints)") from exc
    return _to_numpy(graph)


def _refused_globals(path: Path) -> list[str]:
    """The globals of ``path`` outside torch's tensor types and the
    allow-list, for the refusal's message: torch lists them in a zip file;
    a legacy file's pickle streams are scanned here."""
    admitted = _safe_globals()
    if zipfile.is_zipfile(path):
        with torch.serialization.safe_globals(admitted):
            return torch.serialization.get_unsafe_globals_in_checkpoint(path)
    known = {name if isinstance(name, str) else f"{name.__module__}.{name.__qualname__}"
             for name in (entry[1] if isinstance(entry, tuple) else entry
                          for entry in admitted)}
    found: list[str] = []
    with open(path, "rb") as handle:
        for _ in range(5):  # magic, protocol, sysinfo, the object, the storage keys
            strings: list[str] = []
            try:
                for op, arg, _pos in pickletools.genops(handle):
                    if op.name == "GLOBAL":
                        found.append(arg.replace(" ", "."))
                    elif op.name == "STACK_GLOBAL" and len(strings) >= 2:
                        found.append(".".join(strings[-2:]))
                    elif isinstance(arg, str):
                        strings.append(arg)
            except Exception:  # the storages' raw bytes follow the pickles
                break
    return sorted({name for name in found
                   if not name.startswith("torch.") and name not in known})


def read_pth_state_dict(path: str | Path, key: Optional[str] = "model") -> Dict[str, Any]:
    """Counterpart of ``torch.load(...)[key]`` -> a dict of numpy arrays
    (bfloat16 tensors as CPU tensors)."""
    payload = read_pth(path)
    state = payload
    if isinstance(payload, dict):
        if key and key in payload and isinstance(payload[key], dict):
            state = payload[key]
        else:
            for candidate in ("state_dict", "model", "model_state", "weights",
                              "params"):
                value = payload.get(candidate)
                if isinstance(value, dict):
                    state = value
                    break
    return {
        name: tensor
        for name, tensor in state.items()
        if isinstance(tensor, (np.ndarray, torch.Tensor))
    }
