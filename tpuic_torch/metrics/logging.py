"""Rank-0 logging and the scalar metric writer
(``tpuic/metrics/logging.py``).

The reference gates its console output on ``args.local_rank == 0``
(train.py:39-42, 67-68, 94-95); so do :func:`host0_print` and
:class:`MetricLogger`, whose JSONL scalar log is active on process 0
only: ``metrics.jsonl`` and TensorBoard events
(``metrics/tensorboard.py``, no TensorFlow dependency), both under
``log_dir``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from tpuic_torch.runtime.distributed import process_index


def is_host0() -> bool:
    return process_index() == 0


def host0_print(*args, **kwargs) -> None:
    """print() on process 0 only — the reference's ``if args.local_rank ==
    0`` gate."""
    if is_host0():
        print(*args, **kwargs, flush=True)


class MetricLogger:
    """Scalar writer, active on process 0 only: ``metrics.jsonl`` (one
    JSON object a line) and TensorBoard events under ``log_dir``."""

    def __init__(self, log_dir: Optional[str] = None) -> None:
        self._fh = None
        self._tb = None
        # The active log dir on process 0 (None when logging is off):
        # callers park non-scalar sidecars (confusion matrices, per-class
        # detail) beside metrics.jsonl through this.
        self.root = log_dir if (log_dir and is_host0()) else None
        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
            self._fh = open(os.path.join(self.root, "metrics.jsonl"), "a")
            from tpuic_torch.metrics.tensorboard import TensorBoardWriter
            self._tb = TensorBoardWriter(self.root)

    @property
    def tb(self):
        """The active TensorBoardWriter (None when logging is off): the
        telemetry's TensorBoardSink bridges bus events through it."""
        return self._tb

    def write(self, step: int, **scalars) -> None:
        if self._fh is None:
            return
        vals = {k: float(v) for k, v in scalars.items()}
        self._fh.write(json.dumps({"step": step, "time": time.time(),
                                   **vals}) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.scalars(step, **vals)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
