"""Shared load-generation harness for driving a serve endpoint (a copy of
``tpuic/serve/loadgen.py``).

One paced submission loop and one counter-settling wait, used by
chip_smoke's ``[fleet]`` wave and by the port's router tests, so a fix to
the pacing or settling logic lands in every consumer.

**Endpoint-aware**: the drive targets anything implementing the
endpoint protocol — ``submit(item, **kw) -> Future`` plus a ``stats``
object with ``reset()``/``snapshot()`` whose snapshot keeps the exact
offered-traffic ledger.  An ``InferenceEngine`` and a
``tpuic_torch.serve.router.Router`` both qualify, so the same harness
drives one engine in-process or a whole replica fleet over sockets.

Workload items may carry per-request SLA fields: a bare array submits
plainly; an ``(array, kwargs)`` pair forwards ``kwargs`` to
``engine.submit`` (``priority``/``deadline_ms``/``tenant``/``timeout``
— docs/serving.md, "Admission control and overload").  Typed admission
verdicts are part of the measurement, not an error: a submit-time
``AdmissionError`` (quota/brownout/queue-full with ``timeout=0``) or a
future resolving with one (a pop-time deadline shed) is counted and the
drive continues — the engine's ``rejected_by`` counters carry the
breakdown, and ``accepted + rejected == offered`` stays exact.

Stdlib only, like the router it drives.
"""

from __future__ import annotations

import queue
import time
from typing import Callable, Optional, Sequence, Tuple

from tpuic_torch.serve.admission import AdmissionError


def settle(stats, n: int, timeout_s: float = 2.0) -> dict:
    """Wait (bounded) for ``stats`` to have recorded ``n`` resolved
    requests, then return the snapshot.

    Futures resolve BEFORE the batcher's ``record_done`` runs, so a
    caller that snapshots the instant its last result lands can be
    short the final batch's counters."""
    deadline = time.perf_counter() + timeout_s
    while (stats.snapshot()["requests"] < n
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    return stats.snapshot()


def probe_unbatched_rps(engine, reqs: Sequence,
                        probe_n: int = 16) -> Tuple[float, float,
                                                    float, float]:
    """Sequential single-request capacity probe: submit one, wait,
    repeat — the service rate with no batching to hide behind.

    A sequential ``predict()`` sits in batch formation for the full
    ``max_wait`` (empty queue, rows < max_batch) — a coalescing stall,
    not service — so the probe's own span ledger's queue + batch p50s
    are stripped from the raw per-request time.  This is THE rate
    anchor of an open-loop drive.  Resets ``engine.stats``.

    Returns ``(unbatched_rps, service_s, probe_raw_s, stall_s)``."""
    engine.stats.reset()
    n = max(1, min(probe_n, len(reqs)))
    t0 = time.perf_counter()
    for r in reqs[:n]:
        engine.predict(r)
    probe_raw_s = (time.perf_counter() - t0) / n
    span = engine.stats.snapshot()["span_ms"]
    stall_s = (span.get("queue", {}).get("p50", 0.0)
               + span.get("batch", {}).get("p50", 0.0)) / 1000.0
    service_s = max(probe_raw_s - stall_s, 1e-6)
    return 1.0 / service_s, service_s, probe_raw_s, stall_s


def probe_batched_rps(engine, reqs: Sequence, probe_n: int = 400) -> float:
    """Full-batching burst-capacity probe: offer a burst as fast as
    possible (run_stream, no pacing) and return requests/sec.

    The OTHER half of the dual anchor (docs/serving.md): micro-batching
    lets the engine sustain several times the unbatched rate, so an
    overload drive anchored only to ``probe_unbatched_rps`` can sit
    BELOW true capacity on a fast machine.  Resets ``engine.stats``
    (via run_stream)."""
    n = max(1, min(int(probe_n), len(reqs)))
    t0 = time.perf_counter()
    run_stream(engine, reqs[:n])
    return n / max(time.perf_counter() - t0, 1e-9)


def run_stream(engine, reqs: Sequence, *,
               offsets_s: Optional[Sequence[float]] = None,
               result_timeout_s: float = 600.0,
               on_done: Optional[Callable] = None,
               on_retry: Optional[Callable] = None
               ) -> Tuple[float, float, dict]:
    """Submit every item, wait for every outcome, settle the counters.

    ``reqs[i]`` is an image array or an ``(array, submit_kwargs)`` pair.
    ``offsets_s[i]`` is item *i*'s target submit time relative to the
    first submit — ``None`` offers the stream as fast as possible,
    ``[i / rate ...]`` is a closed-loop paced curve, cumulative
    exponential gaps make a Poisson open-loop arrival process.  The
    loop never waits on results until the whole stream is submitted
    (at deep saturation the engine's bounded queue blocks ``submit()``
    itself, which shows up honestly as achieved < offered — unless the
    item carries ``timeout=0``, in which case the rejection — typed
    when an AdmissionController is attached, bare ``queue.Full``
    otherwise — is counted instead).

    ``on_done(i, ok, latency_s)``: optional per-item outcome hook,
    called the instant item *i* settles — from the batcher thread for
    resolved/shed futures (a completion stamp undistorted by this
    harness's own result-wait loop), inline for submit-time rejections
    (``ok=False, latency_s=None``).  Per-class p99 accounting rides
    this instead of duplicating the pacing loop.

    ``on_retry(i, retries)``: optional retry outcome hook, fired
    alongside ``on_done`` for items whose future carries a nonzero
    ``tpuic_retries`` stamp — the endpoint contract the router uses to
    report that item *i* was replayed ``retries`` times after a
    replica loss.  An engine endpoint never stamps it, so the hook is
    free there; a fleet wave's failover accounting rides this instead
    of growing its own pacing loop.

    Returns ``(wall_s, arrival_s, snapshot)``: first submit -> last
    outcome, first submit -> last submit, and the settled stats.
    ``engine.stats`` is reset first, so ``snapshot["compiles"]`` is
    exactly the executables built during this run and
    ``snapshot["requests"] + snapshot["rejected"] == len(reqs)`` is the
    exact offered-traffic ledger."""
    engine.stats.reset()
    futs = [None] * len(reqs)
    t0 = time.perf_counter()
    for i, item in enumerate(reqs):
        arr, kw = item if isinstance(item, tuple) else (item, None)
        if offsets_s is not None:
            delay = t0 + offsets_s[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        ts = time.perf_counter()
        try:
            fut = engine.submit(arr, **(kw or {}))
        except (AdmissionError, queue.Full):
            # Submit-time verdict (typed quota/brownout/queue-full, or
            # the bare backpressure Full of a controller-less engine):
            # already recorded in stats.rejected_by by the engine; the
            # drive goes on — shed rate is a measurement, not a failure.
            if on_done is not None:
                on_done(i, False, None)
            continue
        futs[i] = fut
        if on_done is not None or on_retry is not None:
            def _settled(f, i=i, ts=ts):
                if on_retry is not None:
                    retries = getattr(f, "tpuic_retries", 0)
                    if retries:
                        on_retry(i, retries)
                if on_done is not None:
                    on_done(i, not f.cancelled() and f.exception() is None,
                            time.perf_counter() - ts)
            fut.add_done_callback(_settled)
    arrival_s = time.perf_counter() - t0
    resolved = 0
    for f in futs:
        if f is None:
            continue
        try:
            f.result(timeout=result_timeout_s)
            resolved += 1
        except AdmissionError:
            pass  # pop-time shed (DeadlineExceeded) / eviction: counted
    wall = time.perf_counter() - t0
    return wall, arrival_s, settle(engine.stats, resolved)
