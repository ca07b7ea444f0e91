"""Serving counters (copy of ``tpuic/serve/metrics.py``).

Everything the engine's micro-batcher decides leaves a trace here: queue
wait and total latency percentiles, pad efficiency (valid rows / device
rows), the batch-size histogram, and the per-request span ledger.
``snapshot()`` keeps ``tpuic``'s keys.  In the port ``compiles`` counts
the one warm-up run of each bucket (eager PyTorch has no executables to
compile), and the executable-cache, rejection and hot-swap fields stay at
their idle values until the features that move them are ported.

All updates happen under one lock: the engine touches this from its
batcher thread while callers snapshot from theirs.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from tpuic_torch.metrics.meters import LatencyMeter

__all__ = ["LatencyMeter", "ServeStats", "SPAN_PHASES"]

# The request span ledger's phase order — cumulative host timestamps
# through a request's life, so the phases sum to the end-to-end latency:
#   queue    submit() -> batcher pops the request off the queue
#   batch    popped -> batch closed (waiting for batchmates / held-over)
#   staging  batch closed -> padded batch assembled (host gather/copy)
#   dispatch staged -> forward enqueued (H2D and kernel launches)
#   device   dispatched -> device->host readback complete (includes the
#            double-buffer wait behind the previous in-flight batch)
#   scatter  readback -> this request's future resolved (slice + deliver)
SPAN_PHASES = ("queue", "batch", "staging", "dispatch", "device", "scatter")


class ServeStats:
    """Thread-safe counters for one InferenceEngine."""

    def __init__(self, window: int = 8192) -> None:
        self._lock = threading.Lock()
        self._window = window
        self.executable_cost: Dict[int, dict] = {}
        self.swaps = 0
        self.generation = 0
        self.model_digest = ""
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.queue_wait = LatencyMeter(self._window)
            self.latency = LatencyMeter(self._window)
            self.spans = {p: LatencyMeter(self._window)
                          for p in SPAN_PHASES}
            self.batch_hist: Dict[int, int] = {}
            self.requests = 0
            self.images = 0
            self.valid_rows = 0
            self.padded_rows = 0
            self.device_calls = 0
            self.compiles = 0
            self.compiles_by_bucket: Dict[int, int] = {}
            self.compile_s = 0.0
            self.cache_hits = 0
            self.rejected = 0
            self.rejected_by: Dict[str, Dict[str, int]] = {}
            self._t0 = time.monotonic()

    # -- engine-side updates -------------------------------------------
    def record_compile(self, bucket: int, seconds: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compiles_by_bucket[bucket] = \
                self.compiles_by_bucket.get(bucket, 0) + 1
            self.compile_s += float(seconds)

    def record_reject(self, cause: str = "queue_full",
                      priority: str = "normal") -> None:
        """One rejected request, labeled by cause and priority class."""
        with self._lock:
            self.rejected += 1
            by_prio = self.rejected_by.setdefault(cause, {})
            by_prio[priority] = by_prio.get(priority, 0) + 1

    def record_dispatch(self, bucket: int, valid: int,
                        queue_waits) -> None:
        with self._lock:
            self.device_calls += 1
            self.batch_hist[bucket] = self.batch_hist.get(bucket, 0) + 1
            self.valid_rows += valid
            self.padded_rows += bucket - valid
            for w in queue_waits:
                self.queue_wait.update(w)

    def record_done(self, n_requests: int, n_images: int,
                    latencies) -> None:
        with self._lock:
            self.requests += n_requests
            self.images += n_images
            for lat in latencies:
                self.latency.update(lat)

    def record_spans(self, spans) -> None:
        """One request's span ledger (seconds, SPAN_PHASES order)."""
        with self._lock:
            for phase, s in zip(SPAN_PHASES, spans):
                self.spans[phase].update(s)

    # -- reads ---------------------------------------------------------
    def pad_efficiency_rows(self) -> tuple:
        """(valid_rows, padded_rows) so far."""
        with self._lock:
            return self.valid_rows, self.padded_rows

    def snapshot(self) -> dict:
        """One JSON-able dict of everything above (plus derived rates)."""
        with self._lock:
            elapsed = max(1e-9, time.monotonic() - self._t0)
            rows = self.valid_rows + self.padded_rows
            return {
                "requests": self.requests,
                "images": self.images,
                "device_calls": self.device_calls,
                "throughput_images_per_sec": round(self.images / elapsed, 2),
                "queue_wait_ms": self.queue_wait.percentiles_ms(),
                "latency_ms": self.latency.percentiles_ms(),
                "span_ms": {p: m.percentiles_ms((50, 99))
                            for p, m in self.spans.items() if m.count},
                "batch_hist": {str(k): v for k, v in
                               sorted(self.batch_hist.items())},
                "pad_efficiency": round(self.valid_rows / rows, 4)
                                  if rows else None,
                "compiles": self.compiles,
                "compiles_by_bucket": {str(k): v for k, v in
                                       sorted(self.compiles_by_bucket
                                              .items())},
                "compile_s": round(self.compile_s, 3),
                "executable_cache_hits": self.cache_hits,
                "rejected": self.rejected,
                "rejected_by": {c: dict(sorted(p.items())) for c, p in
                                sorted(self.rejected_by.items())},
                "executable_cost": {str(k): dict(v) for k, v in
                                    sorted(self.executable_cost.items())},
                "swaps": self.swaps,
                "generation": self.generation,
                "model_digest": self.model_digest,
                "elapsed_s": round(elapsed, 3),
            }
