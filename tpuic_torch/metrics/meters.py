"""Latency percentiles (copy of the ``tpuic/metrics/meters.py`` primitives).

Pinned method: **nearest-rank** (R-1 / inverse-CDF) — a reported value
is always an actually-observed sample, never an interpolation between
two samples, so "p99 = 38 ms" means a real request took 38 ms.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterable, Sequence


def _rank(n: int, q: float) -> int:
    """The nearest-rank formula: ceil(q/100 * n), clamped to [1, n]."""
    return max(1, min(n, math.ceil(q / 100.0 * n)))


def quantile_label(q: float) -> str:
    """Canonical metric key for a quantile: 50 -> 'p50', 99.9 -> 'p999'."""
    return "p" + format(float(q), "g").replace(".", "")


def quantiles(samples: Sequence[float],
              qs: Iterable[float]) -> Dict[str, float]:
    """{label: nearest-rank quantile} over one shared sort ({} if empty)."""
    s = sorted(samples)
    if not s:
        return {}
    return {quantile_label(q): s[_rank(len(s), q) - 1] for q in qs}


class LatencyMeter:
    """Latency percentile tracker over a bounded sliding window.

    ``update`` records one sample (seconds); ``percentiles_ms`` reads
    p50/p95/p99/p999 (milliseconds) over the last ``window`` samples;
    ``count`` covers every sample ever recorded.  Not thread-safe by
    itself — callers that update from several threads hold their own lock
    (``tpuic_torch.serve.metrics`` does)."""

    def __init__(self, window: int = 8192) -> None:
        self._win = deque(maxlen=max(1, int(window)))
        self.count = 0

    def update(self, seconds: float) -> None:
        self._win.append(float(seconds))
        self.count += 1

    def percentiles_ms(self, qs=(50, 95, 99, 99.9)) -> dict:
        """{'p50': ms, ..., 'p999': ms} over the window; {} when empty."""
        return {k: round(1000.0 * v, 3)
                for k, v in quantiles(self._win, qs).items()}
