"""Path anchors for configuration and data-pack assets.

The port's copy of ``ssl4polyp_tpu/configs/__init__.py``: configuration files
live under a repo-level ``config/`` directory and dataset packs under
``data_packs/``; both can be overridden through the same environment
variables as in the JAX package, so one deployment serves both.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = [
    "project_root",
    "config_root",
    "data_packs_root",
    "resolve_config_path",
    "resolve_data_pack_path",
]

_ENV_CONFIG_ROOT = "SSL4POLYP_TPU_CONFIG_ROOT"
_ENV_DATA_PACKS_ROOT = "SSL4POLYP_TPU_DATA_PACKS_ROOT"


def project_root() -> Path:
    """Repository root (the directory containing ``config/`` and ``data_packs/``)."""
    return Path(__file__).resolve().parents[2]


def config_root() -> Path:
    override = os.environ.get(_ENV_CONFIG_ROOT)
    if override:
        return Path(override).expanduser().resolve()
    return project_root() / "config"


def data_packs_root() -> Path:
    override = os.environ.get(_ENV_DATA_PACKS_ROOT)
    if override:
        return Path(override).expanduser().resolve()
    return project_root() / "data_packs"


def _anchor(path: str | Path, root: Path) -> Path:
    candidate = Path(path).expanduser()
    if candidate.is_absolute():
        return candidate
    anchored = root / candidate
    if anchored.exists():
        return anchored
    # Also accept paths that already include the root directory name
    # (e.g. "config/exp/exp1.yaml" passed from the repository root).
    parts = candidate.parts
    if parts and parts[0] == root.name:
        stripped = root / Path(*parts[1:])
        if stripped.exists():
            return stripped
    cwd_candidate = Path.cwd() / candidate
    if cwd_candidate.exists():
        return cwd_candidate
    return anchored


def resolve_config_path(path: str | Path) -> Path:
    """Resolve ``path`` against the configuration root."""
    return _anchor(path, config_root())


def resolve_data_pack_path(path: str | Path) -> Path:
    """Resolve ``path`` against the data-pack root."""
    return _anchor(path, data_packs_root())
