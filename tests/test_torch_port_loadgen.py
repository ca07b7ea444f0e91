"""The port's load-generation harness (``tpuic_torch.serve.loadgen``)
through ``tpuic``'s cases (``tests/test_loadgen.py``), over the port's
engine on the CPU: ``probe_unbatched_rps`` and
``ServeStats.estimated_service_s`` against a COLD engine (where a
fabricated estimate would turn into a bogus spill limit or a shed storm),
and ``run_stream``'s ``on_retry`` hook, the router's failover contract.
"""

import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from _torch_threads import TORCH_THREADS

from tpuic_torch.serve import InferenceEngine, ServeStats
from tpuic_torch.serve.loadgen import probe_unbatched_rps, run_stream, settle
from tpuic_torch.serve.metrics import SPAN_PHASES

torch.set_num_threads(TORCH_THREADS)

SIZE = 4


def _sum_forward(images):
    return images.float().sum(dim=(1, 2, 3))


def _engine(**kw):
    kw.setdefault("forward_fn", _sum_forward)
    kw.setdefault("device", "cpu")
    kw.setdefault("image_size", SIZE)
    kw.setdefault("buckets", (1, 2, 4, 8))
    return InferenceEngine(**kw)


def _imgs(rng, n):
    return rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)


# -- probe_unbatched_rps against a cold engine -------------------------------
def test_probe_unbatched_rps_cold_engine():
    """A COLD engine (no warmup, no prior traffic): the probe must
    still return a coherent anchor — service time stripped of the
    coalescing stall, rps the exact reciprocal, raw >= stripped — and
    leave the stats ledger describing exactly the probe's requests."""
    eng = _engine(max_wait_ms=5.0)
    try:
        rng = np.random.default_rng(0)
        reqs = [_imgs(rng, 1) for _ in range(8)]
        rps, service_s, raw_s, stall_s = probe_unbatched_rps(
            eng, reqs, probe_n=8)
        assert rps > 0 and service_s >= 1e-6
        assert rps == pytest.approx(1.0 / service_s)
        assert raw_s >= service_s            # stall only ever subtracts
        assert stall_s >= 0.0
        assert service_s == pytest.approx(max(raw_s - stall_s, 1e-6))
        # The probe owns the ledger: it reset stats first, so exactly
        # its own requests are recorded (the soaks' anchor contract).
        snap = settle(eng.stats, 8)
        assert snap["requests"] == 8
        assert snap["rejected"] == 0
    finally:
        eng.close()


def test_probe_caps_at_available_requests():
    eng = _engine(max_wait_ms=0.0)
    try:
        rng = np.random.default_rng(1)
        reqs = [_imgs(rng, 1) for _ in range(3)]
        probe_unbatched_rps(eng, reqs, probe_n=16)  # n > len(reqs)
        assert settle(eng.stats, 3)["requests"] == 3
    finally:
        eng.close()


# -- estimated_service_s ------------------------------------------------------
def test_estimated_service_s_cold_is_zero():
    """No span samples -> 0.0, NOT a fabricated estimate: a cold
    engine sheds only already-expired deadlines, and a cold replica's
    spill limit must fall back to the permissive default instead of a
    made-up knee."""
    assert ServeStats().estimated_service_s() == 0.0
    eng = _engine(autostart=False)
    try:
        assert eng.stats.estimated_service_s() == 0.0
    finally:
        eng.close()


def test_estimated_service_s_is_sum_of_post_queue_p50s():
    """After traffic, the estimate is the span ledger's post-queue p50
    sum — the exact series the deadline shedder and the router's
    Little's-law spill limit consume."""
    s = ServeStats()
    # two ledger entries per phase: p50 of [a, b] (nearest-rank) = a
    s.record_spans([0.100, 0.010, 0.002, 0.003, 0.020, 0.001])
    s.record_spans([0.200, 0.020, 0.004, 0.005, 0.040, 0.003])
    est = s.estimated_service_s()
    assert est == pytest.approx(0.010 + 0.002 + 0.003 + 0.020 + 0.001)
    # the queue phase (0.1/0.2) is excluded: already behind a popped req
    assert est < 0.05


def test_estimated_service_s_live_engine_matches_ledger():
    eng = _engine(max_wait_ms=0.0)
    try:
        eng.warmup()
        rng = np.random.default_rng(2)
        for _ in range(6):
            eng.predict(_imgs(rng, 2), timeout=30)
        time.sleep(0.06)  # past the estimator's 50 ms snapshot cache
        est = eng.stats.estimated_service_s()
        assert est > 0.0
        snap = eng.stats.snapshot()
        expect = sum((snap["span_ms"][p]["p50"] or 0.0) / 1000.0
                     for p in SPAN_PHASES if p != "queue")
        # snapshot percentiles are display-rounded; the estimator reads
        # the raw meters — equality up to that rounding
        assert est == pytest.approx(expect, abs=1e-4)
    finally:
        eng.close()


# -- run_stream's on_retry outcome hook (endpoint-aware) ---------------------
class _FakeStats:
    def __init__(self):
        self.requests = 0

    def reset(self):
        self.requests = 0

    def snapshot(self):
        return {"requests": self.requests}


class _FakeEndpoint:
    """Minimal loadgen endpoint: resolves immediately, stamping
    tpuic_retries on selected items — the router's failover-replay
    contract, without a router."""

    def __init__(self, retried_items):
        self.stats = _FakeStats()
        self._retried = retried_items

    def submit(self, item, **kw):
        fut = Future()
        if item in self._retried:
            fut.tpuic_retries = 2
        fut.set_result(item)
        self.stats.requests += 1
        return fut


def test_run_stream_on_retry_fires_only_for_stamped_futures():
    ep = _FakeEndpoint(retried_items={1, 3})
    seen_retries, seen_done = [], []
    wall, arrival, snap = run_stream(
        ep, [0, 1, 2, 3],
        on_done=lambda i, ok, s: seen_done.append((i, ok)),
        on_retry=lambda i, n: seen_retries.append((i, n)))
    assert snap["requests"] == 4
    assert sorted(seen_retries) == [(1, 2), (3, 2)]
    assert sorted(i for i, ok in seen_done) == [0, 1, 2, 3]
    assert all(ok for _, ok in seen_done)
