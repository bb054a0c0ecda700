"""Guardrailed result loading, bootstrap statistics, per-experiment reports.

Accelerator-free analysis layer mirroring the reference's
``src/ssl4polyp/classification/analysis`` capability surface: strict
metrics.json validation, frame-level metric recomputation from outputs CSVs,
seeded cluster bootstrap for paired deltas, expected-seed enforcement, and
one reporter per experiment (exp1–exp5c) emitting Markdown/CSV tables plus a
reproducibility manifest.

The port's copy of ``ssl4polyp_tpu/analysis``: every module's reports,
manifests and CSVs are byte-equal to the JAX package's on the same runs.
"""

from .guardrails import GuardrailViolation, ResultLoader, THRESHOLD_SPECS
from .bootstrapper import Bootstrapper, BootstrapDeltaResult
from .frame_bootstrap import FrameBootstrapper, FrameSample, bootstrap_curves
from .seed_checks import ensure_expected_seeds, SeedCheckError, EXPECTED_SEEDS
from .common import (
    CommonRun,
    FrameRecord,
    load_common_run,
    read_outputs_csv,
    compute_binary_metrics,
    build_cluster_map,
)

__all__ = [
    "GuardrailViolation",
    "ResultLoader",
    "THRESHOLD_SPECS",
    "Bootstrapper",
    "BootstrapDeltaResult",
    "FrameBootstrapper",
    "FrameSample",
    "bootstrap_curves",
    "ensure_expected_seeds",
    "SeedCheckError",
    "EXPECTED_SEEDS",
    "CommonRun",
    "FrameRecord",
    "load_common_run",
    "read_outputs_csv",
    "compute_binary_metrics",
    "build_cluster_map",
]
