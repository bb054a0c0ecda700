"""Run logging: TensorBoard (optional), plain-text log, JSON line records.

The port's copy of ``ssl4polyp_tpu/utils/logging.py``.  The reference
writes three sinks from rank 0 (SURVEY §5 observability): TensorBoard
scalars, an appending ``<stem>.log``, and structured JSON.  The same trio
here; the TensorBoard writer falls back to the port's own scalar event
writer when ``torch.utils.tensorboard`` does not import (it needs the
``tensorboard`` package), and to a no-op when that fails too or the
filesystem refuses (reference ``utils/tensorboard.py:86-112`` self-disables
on OSError).

Where the JAX logger asks ``is_primary()`` of its multi-host runtime, this
one takes ``primary: bool = True``: a caller that runs one process per GPU
passes ``rank == 0``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["RunLogger", "Throughput"]


class _NoOpWriter:
    def add_scalar(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class RunLogger:
    """Bundles TB scalars + text log + JSON-lines for one run."""

    def __init__(
        self,
        output_dir: str | Path,
        stem: str,
        enable_tensorboard: bool = True,
        echo: bool = True,
        primary: bool = True,
    ) -> None:
        self.primary = bool(primary)
        self.output_dir = Path(output_dir)
        self.stem = stem
        self.echo = echo and self.primary
        self.text_path = self.output_dir / f"{stem}.log"
        self.jsonl_path = self.output_dir / f"{stem}.jsonl"
        self.tb = _NoOpWriter()
        if not self.primary:
            # Non-primary hosts keep the API but write nothing (reference
            # master-only sinks, util/misc.py:171).
            return
        self.output_dir.mkdir(parents=True, exist_ok=True)
        if enable_tensorboard:
            tb_dir = str(self.output_dir / "tb" / stem)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=tb_dir)
            except Exception:
                # Hosts without the tensorboard package: the pure-python
                # scalar event writer produces files TensorBoard loads
                # natively (tb_events.py).
                try:
                    from .tb_events import ScalarEventWriter

                    self.tb = ScalarEventWriter(tb_dir)
                except Exception:
                    self.tb = _NoOpWriter()

    def scalar(self, tag: str, value: float, step: int) -> None:
        try:
            self.tb.add_scalar(tag, float(value), int(step))
        except Exception:
            self.tb = _NoOpWriter()

    def scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for tag, value in values.items():
            if value is None:
                continue
            self.scalar(f"{prefix}{tag}" if prefix else tag, value, step)

    def text(self, message: str) -> None:
        if not self.primary:
            return
        stamped = f"{time.strftime('%Y-%m-%d %H:%M:%S')} {message}"
        with open(self.text_path, "a", encoding="utf-8") as handle:
            handle.write(stamped + "\n")
        if self.echo:
            print(stamped, flush=True)

    def json_line(self, record: Dict[str, Any]) -> None:
        if not self.primary:
            return
        with open(self.jsonl_path, "a", encoding="utf-8") as handle:
            handle.write(json.dumps(record, default=str) + "\n")

    def close(self) -> None:
        try:
            self.tb.flush()
            self.tb.close()
        except Exception:
            pass


class Throughput:
    """Images/sec EMA for the progress line (reference
    ``train_classification.py:4568-4606``)."""

    def __init__(self, smoothing: float = 0.9) -> None:
        self.smoothing = smoothing
        self._rate: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, n_items: int) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                instant = n_items / dt
                self._rate = (
                    instant
                    if self._rate is None
                    else self.smoothing * self._rate + (1 - self.smoothing) * instant
                )
        self._last = now
        return self._rate
