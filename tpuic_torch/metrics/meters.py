"""Meters (copy of the ``tpuic/metrics/meters.py`` primitives).

``accuracy`` / ``topk_accuracy`` return per-sample 0/1 float32 tensors on
the logits' device; ``AverageMeter`` is the reference's running average
(utils.py:16-20); ``LatencyMeter`` and ``quantiles`` give latency
percentiles.

Pinned method: **nearest-rank** (R-1 / inverse-CDF) — a reported value
is always an actually-observed sample, never an interpolation between
two samples, so "p99 = 38 ms" means a real request took 38 ms.
"""

from __future__ import annotations

import math
from collections import deque
from typing import TYPE_CHECKING, Dict, Iterable, Sequence

if TYPE_CHECKING:  # pragma: no cover — annotations only
    import torch

# No module-level torch import, as ``tpuic``'s has no jax one: the
# stdlib-only serve tiers (the replica router and the canary rollout
# controller) import this module for the pinned quantile helpers, through
# telemetry/slo.py, and must never load torch or numpy.  ``accuracy``
# and ``topk_accuracy`` import torch when they are called.


def _rank(n: int, q: float) -> int:
    """The nearest-rank formula: ceil(q/100 * n), clamped to [1, n]."""
    return max(1, min(n, math.ceil(q / 100.0 * n)))


def quantile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of ``samples`` (``q`` in percent); raises on
    an empty sequence (a fabricated 0 would read as a perfect latency)."""
    s = sorted(samples)
    if not s:
        raise ValueError("quantile of empty sample set")
    return s[_rank(len(s), q) - 1]


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


def process_rss_bytes():
    """Resident set size of this process in bytes, from
    ``/proc/self/status`` (else ``getrusage``'s peak; None when neither
    answers)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys
        peak = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        return peak if sys.platform == "darwin" else peak * 1024.0
    except Exception:
        return None


class LatencyMeter:
    """Latency percentile tracker over a bounded sliding window.

    ``update`` records one sample (seconds); ``percentiles_ms`` reads
    p50/p95/p99/p999 (milliseconds) over the last ``window`` samples;
    ``count`` and ``total`` cover every sample ever recorded.  Not
    thread-safe by itself — callers that update from several threads hold
    their own lock (``tpuic_torch.serve.metrics`` does)."""

    def __init__(self, window: int = 8192) -> None:
        self._win = deque(maxlen=max(1, int(window)))
        self.count = 0
        self.total = 0.0

    def update(self, seconds: float) -> None:
        s = float(seconds)
        self._win.append(s)
        self.count += 1
        self.total += s

    def quantile_s(self, q: float):
        """One nearest-rank quantile in seconds over the window (None
        when there are no samples yet)."""
        if not self._win:
            return None
        return quantile(self._win, q)

    def percentiles_ms(self, qs=(50, 95, 99, 99.9)) -> dict:
        """{'p50': ms, ..., 'p999': ms} over the window; {} when empty."""
        return {k: round(1000.0 * v, 3)
                for k, v in quantiles(self._win, qs).items()}


class AverageMeter:
    """Running average with the reference's update semantics (utils.py:16-20)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample 0/1 correctness [B] float32; reference utils.py:25-27."""
    import torch
    return (torch.argmax(logits, dim=-1) == labels.long()).float()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 5) -> torch.Tensor:
    """Per-sample 0/1 top-k membership [B] float32 (k clamped to the class
    count)."""
    import torch
    k = min(k, logits.shape[-1])
    idx = torch.topk(logits, k, dim=-1).indices
    return (idx == labels.long()[:, None]).any(dim=-1).float()
