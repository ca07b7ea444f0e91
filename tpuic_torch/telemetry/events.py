"""Structured event bus: lightweight publish/subscribe of typed events
(a copy of ``tpuic/telemetry/events.py``).

The train loop, the checkpoint manager, the dataset quarantine and the
kernel builds publish here; sinks subscribe — JSONL for machines, memory
for tests, TensorBoard for dashboards.

- **Free when idle**: ``publish`` on a bus with no subscribers is one
  attribute read and a falsy check.
- **Host-only**: event data are plain JSON-able scalars and strings the
  caller already holds on the host; publishing never reads a tensor back
  from the card.
- **Thread-safe**: subscription mutates under a lock while publish reads
  an immutable snapshot tuple.
- **Sink failures are contained**: a sink raising is counted
  (``bus.sink_errors``) and the event still reaches the other
  subscribers.

Compile events: ``tpuic`` bridges ``jax.monitoring``'s compile durations;
the port's compiles are its first-use ``nvcc`` builds
(``kernels/_build.py``) and the engine's CUDA-graph captures, each
published by :func:`publish_compile` as a ``compile`` event whose key
starts with ``backend_compile`` (the goodput tracker books it as
``compile`` and counts it).

This module imports neither torch nor numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Tuple

# The typed vocabulary, ``tpuic``'s.  Publishing an unlisted kind is
# allowed (the bus is a transport, not a validator) but the emitters stick
# to these; the serve, router, rollout, elastic and scoring kinds are
# ``tpuic``'s tiers the port has not wired yet.
EVENT_KINDS = ("step", "epoch", "eval", "drain", "checkpoint_commit",
               "rollback", "skip", "quarantine", "compile", "serve_batch",
               "serve_span", "slo", "admission", "trace", "goodput",
               "restart", "heartbeat", "memory", "flight_dump", "profile",
               "router_replica", "router_breaker", "router_retry",
               "router_failover", "swap", "rollout", "reform",
               "score_plan", "score_shard", "score_commit",
               "score_duplicate", "score_done", "compile_cache")


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str
    time: float          # wall clock (time.time()) at publish
    data: Dict[str, object]


class EventBus:
    """Synchronous pub/sub.  Subscribers run inline in the publishing
    thread (ordering is therefore the emission order); anything slow or
    blocking belongs in the subscriber's own buffering, not here."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Immutable snapshot: publish iterates without the lock.
        self._subs: Tuple[Tuple[Optional[frozenset], Callable], ...] = ()
        self.published = 0
        self.sink_errors = 0
        # Fleet rank tag (telemetry/fleet.py): when set (a plain dict,
        # e.g. {"rank": 2, "ranks": 8}), every published event's data is
        # merged over it, so per-rank JSONL streams are attributable
        # offline. None (the single-process default) costs one attribute
        # read per publish.  Emitter-provided keys win on collision.
        self.rank_tag: Optional[Dict[str, object]] = None

    def subscribe(self, fn: Callable[[Event], None],
                  kinds: Optional[Iterable[str]] = None) -> Callable[[], None]:
        """Register ``fn`` for ``kinds`` (None = every kind); returns an
        idempotent unsubscribe callable."""
        entry = (None if kinds is None else frozenset(kinds), fn)
        with self._lock:
            self._subs = self._subs + (entry,)

        def unsubscribe() -> None:
            with self._lock:
                self._subs = tuple(e for e in self._subs if e is not entry)
        return unsubscribe

    def active(self, kind: Optional[str] = None) -> bool:
        """Whether anything would receive ``kind`` (None: any subscriber
        at all) — lets emitters skip building expensive event data."""
        subs = self._subs
        if kind is None:
            return bool(subs)
        return any(k is None or kind in k for k, _ in subs)

    def publish(self, kind: str, **data) -> Optional[Event]:
        subs = self._subs
        if not subs:
            return None
        tag = self.rank_tag
        if tag is not None:
            data = {**tag, **data}
        ev = Event(kind, time.time(), data)
        delivered = False
        for kinds, fn in subs:
            if kinds is not None and kind not in kinds:
                continue
            delivered = True
            try:
                fn(ev)
            except Exception:
                # A broken sink must never kill the train loop or the
                # serve batcher; the counter makes the breakage visible.
                self.sink_errors += 1
        if delivered:
            self.published += 1
        return ev

    def reset(self) -> None:
        """Drop every subscriber (test isolation — the process-global
        bus otherwise accumulates them across constructed Trainers)."""
        with self._lock:
            self._subs = ()
            self.published = 0
            self.sink_errors = 0
            self.rank_tag = None


def read_jsonl(path: str, on_torn: Optional[Callable[[str], None]] = None
               ) -> list:
    """Tolerant JSONL reader: parse every line of ``path`` that parses.

    The reader for event streams written by :class:`JsonlSink`.  A
    SIGKILL can tear a line mid-write and the next attempt appends its
    first event onto the fragment; such lines are skipped (reported via
    ``on_torn`` when given) instead of crashing the reader.  A missing or
    unreadable file reads as an empty stream — absence is the caller's
    assertion to make, not an exception to catch.
    """
    out: list = []
    try:
        fh = open(path)
    except OSError:
        return out
    with fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                if on_torn is not None:
                    on_torn(ln)
    return out


# -- sinks -------------------------------------------------------------------
class MemorySink:
    """Bounded in-memory event recorder (tests, REPL debugging)."""

    def __init__(self, maxlen: int = 4096) -> None:
        self.events: deque = deque(maxlen=maxlen)

    def __call__(self, ev: Event) -> None:
        self.events.append(ev)

    def kinds(self) -> list:
        return [e.kind for e in self.events]

    def of(self, kind: str) -> list:
        return [e for e in self.events if e.kind == kind]


class JsonlSink:
    """One JSON line per event: ``{"event": kind, "t": ..., **data}``.

    Durability ladder (the chaos soak used to tolerate torn tail lines a
    SIGKILLed run simply lost; this sink stops losing them up front):

    - ``flush_every`` bounds buffered lines (1 = flush each event — the
      default, so a killed process loses nothing; per-line flush of an
      already-buffered file is microseconds against millisecond steps).
    - ``flush_interval_s`` bounds buffered *time* when ``flush_every``
      is raised for very hot event streams: the first write after the
      interval elapses flushes everything buffered.  The bound holds
      while events keep flowing (the hot-stream case it exists for);
      a stream that stops emitting holds its tail until the next
      ``flush()``/``close()`` — which every drain path calls — because
      the sink deliberately has no background timer thread.
    - ``fsync=True`` additionally fsyncs at every flush — survives a
      machine (not just process) kill; off by default, it is a real
      per-event disk round trip.
    - ``close()`` flushes (and fsyncs, if configured) before closing, so
      a clean drain never leaves a torn tail; it is idempotent and
      write-after-close is a no-op.

    Thread-safe: serve-thread and loop-thread events interleave whole
    lines, never bytes.
    """

    def __init__(self, path: str, flush_every: int = 1,
                 flush_interval_s: float = 0.5,
                 fsync: bool = False) -> None:
        self.path = path
        self._fh = open(path, "a")
        self._lock = threading.Lock()
        self._since_flush = 0
        self._flush_every = max(1, int(flush_every))
        self._flush_interval = max(0.0, float(flush_interval_s))
        self._fsync = bool(fsync)
        self._last_flush = time.monotonic()

    def _flush_locked(self) -> None:
        self._fh.flush()
        if self._fsync:
            try:
                os.fsync(self._fh.fileno())
            except OSError:
                pass  # durability best-effort; never kill the loop
        self._since_flush = 0
        self._last_flush = time.monotonic()

    def __call__(self, ev: Event) -> None:
        rec = {"event": ev.kind, "t": round(ev.time, 6), **ev.data}
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._since_flush += 1
            if (self._since_flush >= self._flush_every
                    or time.monotonic() - self._last_flush
                    >= self._flush_interval):
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._flush_locked()
                finally:
                    self._fh.close()
                    self._fh = None


class TensorBoardSink:
    """Bus -> TensorBoard bridge: skip/rollback/quarantine counts,
    goodput fractions, supervisor restarts, serve batch/span latencies,
    device-memory gauges, and SLO attainment become scalars instead of
    being log-only.

    Wraps an existing ``tpuic_torch.metrics.tensorboard.TensorBoardWriter``
    (the MetricLogger's); subscribes to ``step`` only to track the
    current global step so step-less events (quarantine fires in a
    producer thread) land at a sensible x-coordinate.  Serve events have
    no train step at all, so they ride their own monotonic counters.
    """

    def __init__(self, writer) -> None:
        self._tb = writer
        self._step = 0
        self._quarantined = 0
        self._rollbacks = 0
        self._serve_batches = 0
        self._serve_spans = 0

    def __call__(self, ev: Event) -> None:
        if self._tb is None:
            return
        d = ev.data
        if ev.kind == "step":
            self._step = int(d.get("step", self._step))
            return
        if ev.kind == "skip":
            self._tb.scalars(int(d.get("step", self._step)),
                             skip_streak=float(d.get("streak", 0)))
        elif ev.kind == "rollback":
            self._rollbacks += 1
            self._tb.scalars(self._step, rollbacks=float(self._rollbacks))
        elif ev.kind == "quarantine":
            # Accumulate per event rather than trusting the publisher's
            # 'count': that figure is dataset-local (train and val each
            # keep their own), so taking the last event's value would
            # regress the scalar whenever more than one dataset (or an
            # out-of-order producer thread) quarantines.
            self._quarantined += 1
            self._tb.scalars(self._step,
                             quarantined_total=float(self._quarantined))
        elif ev.kind == "goodput":
            scalars = {f"goodput_{k[5:]}": float(v) for k, v in d.items()
                       if k.startswith("frac_")}
            if "mfu" in d and d["mfu"] is not None:
                scalars["mfu"] = float(d["mfu"])
            if d.get("compute_dtype"):
                # Info-style scalar (constant 1, dtype in the tag): TB
                # has no string scalars, and runs compared side by side
                # need the precision arm visible.
                scalars[f"compute_dtype_{d['compute_dtype']}"] = 1.0
            if d.get("checkpoint_async_s") is not None:
                scalars["goodput_checkpoint_async_s"] = float(
                    d["checkpoint_async_s"])
            if scalars:
                self._tb.scalars(int(d.get("step", self._step)), **scalars)
        elif ev.kind == "restart":
            # Supervisor restart (runtime/supervisor.py): the count and
            # the downtime it cost, at the step the resumed run re-opened.
            self._tb.scalars(self._step,
                             restarts=float(d.get("restart", 0)),
                             restart_downtime_s=float(
                                 d.get("downtime_s", 0.0)))
        elif ev.kind == "serve_batch":
            self._serve_batches += 1
            self._tb.scalars(self._serve_batches,
                             serve_batch_latency_ms=float(
                                 d.get("latency_ms", 0.0)),
                             serve_batch_images=float(d.get("images", 0)),
                             serve_batch_bucket=float(d.get("bucket", 0)))
        elif ev.kind == "serve_span":
            # One point per request: end-to-end latency plus the two
            # spans that dominate tuning decisions (queue wait = load,
            # device = model cost); the full spans stay in JSONL.
            self._serve_spans += 1
            self._tb.scalars(self._serve_spans,
                             serve_request_total_ms=float(
                                 d.get("total_ms", 0.0)),
                             serve_request_queue_ms=float(
                                 d.get("queue_ms", 0.0)),
                             serve_request_device_ms=float(
                                 d.get("device_ms", 0.0)))
        elif ev.kind == "memory":
            # Device-memory accounting (telemetry/memory.py): the
            # aggregate gauges become scalars; the per-device split
            # stays in JSONL/prom (a per-device TB curve per chip would
            # be noise on a pod).
            scalars = {}
            for field in ("bytes_in_use", "peak_bytes_in_use",
                          "process_rss_bytes"):
                if d.get(field) is not None:
                    scalars[f"memory_{field}"] = float(d[field])
            if d.get("headroom_frac") is not None:
                scalars["memory_headroom_frac"] = float(d["headroom_frac"])
            if scalars:
                self._tb.scalars(int(d.get("step", self._step)), **scalars)
        elif ev.kind == "slo":
            name = str(d.get("name", "slo"))
            scalars = {}
            for field in ("attainment", "burn_rate", "budget_remaining"):
                if d.get(field) is not None:
                    scalars[f"slo_{name}_{field}"] = float(d[field])
            if scalars:
                self._tb.scalars(int(d.get("step", self._step)), **scalars)
        elif ev.kind == "profile":
            # Device-time waterfall (telemetry/profile.py): per-op-class
            # device milliseconds as scalars; layer rollups and verdicts
            # stay in JSONL/prom (a per-layer TB curve per analysis
            # would be noise).
            scalars = {}
            for cls, c in (d.get("classes") or {}).items():
                if isinstance(c, dict) and c.get("ms") is not None:
                    scalars[f"device_time_ms_{cls}"] = float(c["ms"])
            if d.get("device_ms_per_step") is not None:
                scalars["device_ms_per_step"] = float(
                    d["device_ms_per_step"])
            if scalars:
                self._tb.scalars(self._step, **scalars)


# -- the process-global bus --------------------------------------------------
bus = EventBus()


def publish(kind: str, **data) -> Optional[Event]:
    return bus.publish(kind, **data)


def subscribe(fn: Callable[[Event], None],
              kinds: Optional[Iterable[str]] = None) -> Callable[[], None]:
    return bus.subscribe(fn, kinds)


# -- compile events ---------------------------------------------------------
def publish_compile(what: str, duration_s: float, **data) -> None:
    """A ``compile`` event for one of the port's compiles: ``what`` is
    ``nvcc:<source>`` or ``cuda_graph:<tag>``."""
    publish("compile", key=f"backend_compile/{what}",
            duration_s=round(float(duration_s), 6), **data)
