"""Layered YAML configuration loading.

The port's copy of ``ssl4polyp_tpu/configs/layered.py``; PyYAML is imported
where a file is read, so that the port imports without it.

Implements the reference's hydra-like composition semantics
(``src/ssl4polyp/configs/layered.py:37-103``): a config file may declare a
``defaults:`` list of other config files which are loaded recursively and
deep-merged (later entries override earlier ones, the declaring file overrides
all of its defaults).  Cycles raise, and the merged result carries a
``__sources__`` provenance list of every file that contributed.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping

from . import config_root, resolve_config_path

__all__ = [
    "deep_merge",
    "load_layered_config",
    "resolve_model_entries",
    "extract_dataset_config",
    "ConfigCycleError",
]


class ConfigCycleError(ValueError):
    """Raised when the ``defaults`` graph contains a cycle."""


def deep_merge(base: Mapping[str, Any], overlay: Mapping[str, Any]) -> Dict[str, Any]:
    """Return ``base`` recursively updated with ``overlay`` (pure; inputs untouched)."""
    out: Dict[str, Any] = {k: copy.deepcopy(v) for k, v in base.items()}
    for key, value in overlay.items():
        existing = out.get(key)
        if isinstance(existing, Mapping) and isinstance(value, Mapping):
            out[key] = deep_merge(existing, value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _with_yaml_suffix(path: Path) -> Path:
    return path if path.suffix else path.with_suffix(".yaml")


def _locate(reference: str | Path, anchor: Path | None) -> Path:
    """Find the file a ``defaults`` entry refers to.

    Resolution order: absolute path as-is; relative to the file that declared
    it; relative to the configuration root.  The last candidate is returned
    even when missing so the subsequent ``open`` produces a clear error.
    """
    candidate = _with_yaml_suffix(Path(reference))
    if candidate.is_absolute():
        return candidate
    if anchor is not None:
        local = (anchor.parent / candidate).resolve()
        if local.exists():
            return local
    rooted = resolve_config_path(candidate)
    if rooted.exists():
        return rooted
    return (config_root() / candidate).resolve()


def _compose(path: Path, visiting: tuple[Path, ...]) -> tuple[Dict[str, Any], List[Path]]:
    if path in visiting:
        cycle = " -> ".join(str(p) for p in (*visiting, path))
        raise ConfigCycleError(f"defaults cycle detected: {cycle}")

    import yaml

    with open(path, "r", encoding="utf-8") as handle:
        document = yaml.safe_load(handle) or {}
    if not isinstance(document, dict):
        raise ValueError(f"Config file {path} must contain a mapping at top level")

    defaults = document.pop("defaults", [])
    if isinstance(defaults, (str, Path)):
        defaults = [defaults]

    merged: Dict[str, Any] = {}
    sources: List[Path] = []
    for entry in defaults:
        child = _locate(entry, anchor=path)
        child_cfg, child_sources = _compose(child, (*visiting, path))
        merged = deep_merge(merged, child_cfg)
        sources.extend(child_sources)

    merged = deep_merge(merged, document)
    sources.append(path)
    return merged, sources


def load_layered_config(reference: str | Path) -> Dict[str, Any]:
    """Load ``reference`` with recursive ``defaults`` composition.

    The returned mapping includes a ``__sources__`` key listing every file
    that contributed, in merge order (reference ``layered.py:72-79``).
    """
    path = _locate(reference, anchor=None)
    config, sources = _compose(path, ())
    config.setdefault("__sources__", [str(p) for p in sources])
    return config


def resolve_model_entries(entries: Iterable[Any]) -> List[Dict[str, Any]]:
    """Expand ``models:`` entries of an experiment config into model dicts.

    Entries may be config-file references (e.g. ``model/sup_imnet``) or inline
    mappings; file references are loaded through the layered loader and their
    ``model:`` section extracted (reference ``layered.py:82-95``).
    """
    resolved: List[Dict[str, Any]] = []
    for entry in entries:
        if isinstance(entry, (str, Path)):
            data: Dict[str, Any] = load_layered_config(entry)
        else:
            data = copy.deepcopy(dict(entry))
        model = data.get("model", data)
        resolved.append(copy.deepcopy(dict(model)))
    return resolved


def extract_dataset_config(config: Mapping[str, Any]) -> Dict[str, Any]:
    """Return the ``dataset:`` section, raising when absent."""
    dataset = copy.deepcopy(config.get("dataset") or {})
    if not dataset:
        raise ValueError(
            "Experiment configuration must define a 'dataset' section "
            "(directly or via defaults)."
        )
    return dict(dataset)
