"""Number formatting for report tables (reference ``analysis/display.py``).

The port's copy of ``ssl4polyp_tpu/analysis/display.py``.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["format_value", "format_with_ci", "format_percent", "format_delta"]


def format_value(value: Optional[float], digits: int = 3) -> str:
    if value is None or (isinstance(value, float) and not math.isfinite(value)):
        return "—"
    return f"{value:.{digits}f}"


def format_with_ci(
    value: Optional[float],
    lower: Optional[float] = None,
    upper: Optional[float] = None,
    digits: int = 3,
) -> str:
    base = format_value(value, digits)
    if base == "—" or lower is None or upper is None:
        return base
    return f"{base} [{format_value(lower, digits)}, {format_value(upper, digits)}]"


def format_percent(value: Optional[float], digits: int = 1) -> str:
    if value is None or (isinstance(value, float) and not math.isfinite(value)):
        return "—"
    return f"{value * 100:.{digits}f}%"


def format_delta(value: Optional[float], digits: int = 3) -> str:
    if value is None or (isinstance(value, float) and not math.isfinite(value)):
        return "—"
    return f"{value:+.{digits}f}"
