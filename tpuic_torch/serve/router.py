"""Replica-fleet router: health-checked, breaker-guarded, retry-budgeted
(a copy of ``tpuic/serve/router.py`` over the port's replicas).

``python -m tpuic_torch.serve`` is one engine process; a single crash,
wedge or brownout would take the whole service down with it.  This module
is the front tier that makes the serve story a *fleet* story
(docs/serving.md, "Replica routing and failover"): it spawns (or
attaches to) N engine replicas speaking the socket-JSONL transport
(``--listen`` in serve/__main__.py) and routes requests with layered
fault handling:

- **Health states** per replica: a live probe (the transport's
  ``{"op": "ping"}`` answered with queue depth), heartbeat-file age
  (the supervisor protocol — spawned replicas run with
  ``TPUIC_HEARTBEAT_FILE`` set via the shared ``_Child``), and the
  ``brownout_level`` / span-ledger service estimate scraped from each
  replica's existing Prometheus exposition.  States:
  ``starting → up → (wedged|down) → starting…`` and terminal
  ``failed``/``stopped``.
- **Least-loaded shed-aware routing**: requests go to the routable
  replica with the fewest in-flight requests, preferring replicas whose
  brownout level would not shed the request's priority class; a replica
  at/over its **spill limit** — ``ceil(knee_rps × estimated_service_s)``
  by Little's law, i.e. the concurrency at the committed latency knee
  (``--knee-rps``) — is spilled *past*, and when every replica
  is at the limit the router sheds with a typed ``queue_full`` verdict
  instead of queueing toward a timeout.
- **Global retry budget** (:class:`RetryBudget`): a ratio of successes,
  not a per-request count — each delivered response deposits
  ``ratio`` tokens (capped), each replay withdraws one, so a fleet-wide
  failure cannot amplify into a retry storm.  Replays back off
  exponentially (capped) and only **idempotent** requests replay at
  all.
- **Circuit breakers** per replica (:class:`CircuitBreaker`):
  closed → open on ``threshold`` consecutive transport failures (and
  tripped immediately on conclusive connection loss); after a cooldown
  a **half-open** probe routes exactly one request — success closes the
  breaker (the respawned replica rejoins), failure re-opens it.
- **In-flight failover**: when a replica dies (socket EOF, SIGKILL,
  watchdog escalation), its in-flight requests requeue to survivors —
  at-most-once enforced by router-assigned request-id dedupe (a late
  duplicate response is dropped; the client future resolves exactly
  once).  Unreplayable requests (non-idempotent, attempts exhausted,
  budget dry) resolve with a typed
  :class:`~tpuic_torch.serve.admission.ReplicaLost` verdict — the
  ``replica_lost`` cause in the shared AdmissionError vocabulary.
- **Respawn rides the supervisor ladder**: spawned replicas are
  ``runtime/supervisor.py`` ``_Child`` processes (heartbeat file,
  per-attempt stack/flight dump artifacts, per-replica log files); a
  wedged replica is escalated SIGQUIT → SIGTERM → SIGKILL exactly like
  a wedged trainer, then respawned with backoff.
- **Graceful drain on SIGTERM** (the PR-2 preemption contract): stop
  accepting, wait out in-flight up to the drain timeout, typed
  straggler verdicts, then one TERM per replica with the flush window.

Telemetry: ``router_replica`` / ``router_breaker`` / ``router_retry`` /
``router_failover`` events (EVENT_KINDS, docs/observability.md) land in
the router ledger JSONL (and on a bus via the optional ``publish``
hook); counters render as ``tpuic_router_*`` Prometheus rows
(telemetry/prom.py ``router_exposition``).

Like the supervisor parent, this module is **stdlib-only** and must
stay that way: the router has to outlive any CUDA wedge its replicas
hit, so it never imports torch or numpy (request arrays are forwarded
as duck-typed ``.tobytes()`` base64 payloads — wire.py).  chip_smoke's
``[fleet]`` phase is its proof on the card: two ResNet-50 replicas under
a Poisson wave, one SIGKILLed mid-wave, zero client timeouts, breaker
open → half-open → closed rejoin, exact ledger.
"""

from __future__ import annotations

import heapq
import itertools
import json
import math
import os
import random
import shlex
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, Dict, List, Optional, Set, Tuple

from tpuic_torch.runtime.supervisor import _Child, read_heartbeat
from tpuic_torch.serve import wire
from tpuic_torch.serve.admission import (DEFAULT_PRIORITY, PRIORITIES,
                                   AdmissionRejected, DeadlineExceeded,
                                   ReplicaLost, priority_index)

# Replica health states (docs/serving.md, "Replica routing and
# failover").  Only "up" replicas with a permitting breaker are routed.
STARTING, UP, WEDGED, DOWN, FAILED, STOPPED = (
    "starting", "up", "wedged", "down", "failed", "stopped")


class RetryBudget:
    """Ratio-of-successes retry budget (the no-retry-storms rule).

    Each delivered response deposits ``ratio`` tokens (so sustained
    retries are bounded at ``ratio`` × the success rate); each replay
    withdraws one whole token.  ``cap`` bounds the burst — the bucket
    starts full so a cold-start failover (replica dies before any
    successes landed) can still replay its in-flight handful.  Not a
    per-request count: a single request may retry several times in a
    healthy fleet, and a thousand requests may not retry at all in a
    dying one.  Thread-safe."""

    def __init__(self, ratio: float = 0.1, cap: float = 32.0) -> None:
        if ratio < 0:
            raise ValueError(f"retry ratio must be >= 0, got {ratio}")
        self.ratio = float(ratio)
        self.cap = max(1.0, float(cap))
        self._lock = threading.Lock()
        self.tokens = self.cap
        self.spent = 0
        self.denied = 0

    def deposit(self) -> None:
        """One delivered response (result OR typed verdict — the
        transport worked) earns ``ratio`` tokens."""
        with self._lock:
            self.tokens = min(self.cap, self.tokens + self.ratio)

    def try_retry(self) -> bool:
        """Withdraw one token for a replay; False when the budget is
        dry (the caller sheds with ``replica_lost`` instead)."""
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False

    def state(self) -> dict:
        with self._lock:
            return {"tokens": round(self.tokens, 2), "cap": self.cap,
                    "ratio": self.ratio, "spent": self.spent,
                    "denied": self.denied}


class CircuitBreaker:
    """Per-replica transport circuit breaker.

    closed → open after ``threshold`` *consecutive* transport failures
    (or immediately via :meth:`trip` on conclusive evidence — a dropped
    connection).  After ``cooldown_s`` the first :meth:`try_acquire`
    moves to half-open and grants exactly one probe slot; the probe's
    outcome (``record_success``/``record_failure``) closes or re-opens
    the breaker.  Engine-side *typed* rejections are transport
    successes — the breaker watches the pipe, not the verdicts.

    ``on_transition(old, new, reason)`` fires outside the lock on every
    state change (the router publishes it as a ``router_breaker``
    event).  ``clock`` is injectable for deterministic tests."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 on_transition: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.threshold = max(1, int(threshold))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self.transitions = 0
        self._opened_at = 0.0
        self._probe_out = False

    def _set(self, new: str, reason: str) -> Optional[Tuple[str, str, str]]:
        old, self.state = self.state, new
        self.transitions += 1
        return (old, new, reason)

    def _emit(self, change) -> None:
        if change is not None and self._on_transition is not None:
            self._on_transition(*change)

    def try_acquire(self) -> bool:
        """Whether a request may route to this replica now.  Closed:
        always.  Open: past the cooldown, transitions to half-open and
        grants the one probe slot.  Half-open: only while the probe
        slot is free."""
        change = None
        with self._lock:
            if self.state == "closed":
                ok = True
            elif self.state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    change = self._set("half_open", "cooldown elapsed")
                    self._probe_out = True
                    ok = True
                else:
                    ok = False
            else:  # half_open
                ok = not self._probe_out
                if ok:
                    self._probe_out = True
        self._emit(change)
        return ok

    def record_success(self) -> None:
        change = None
        with self._lock:
            self.consecutive_failures = 0
            self._probe_out = False
            if self.state != "closed":
                change = self._set("closed", "probe succeeded")
        self._emit(change)

    def record_failure(self, reason: str = "transport failure") -> None:
        change = None
        with self._lock:
            self.consecutive_failures += 1
            self._probe_out = False
            if self.state == "half_open":
                change = self._set("open", f"probe failed: {reason}")
                self._opened_at = self._clock()
            elif (self.state == "closed"
                  and self.consecutive_failures >= self.threshold):
                change = self._set(
                    "open", f"{self.consecutive_failures} consecutive "
                    f"failures ({reason})")
                self._opened_at = self._clock()
        self._emit(change)

    def trip(self, reason: str) -> None:
        """Conclusive failure (connection lost): open immediately —
        counting to ``threshold`` against a dead socket only delays the
        verdict the EOF already delivered."""
        change = None
        with self._lock:
            self.consecutive_failures = max(self.consecutive_failures,
                                            self.threshold)
            self._probe_out = False
            if self.state != "open":
                change = self._set("open", reason)
                self._opened_at = self._clock()
        self._emit(change)

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "consecutive_failures": self.consecutive_failures,
                    "transitions": self.transitions}


class RouterStats:
    """Thread-safe router counters mirroring the ServeStats ledger
    contract: every offered request either resolves (``requests``),
    lands in ``rejected_by`` under exactly one typed cause, or — never,
    outside of bugs — counts as an untyped ``errors``.  The soak
    asserts ``requests + rejected + errors == offered`` exactly.

    Stdlib-only by design (the router rule), so the latency window
    carries its own nearest-rank quantile — the same pinned formula as
    ``tpuic_torch.metrics.meters.quantile`` (ceil(q/100·n), clamped), kept
    numerically identical so router percentiles and engine percentiles
    mean the same thing."""

    def __init__(self, window: int = 8192) -> None:
        self._lock = threading.Lock()
        self._window = window
        self.replica_state_fn: Optional[Callable[[], dict]] = None
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.offered = 0
            self.requests = 0          # resolved with a result
            self.rejected = 0          # typed verdicts, any cause
            self.rejected_by: Dict[str, Dict[str, int]] = {}
            self.errors = 0            # untyped failures (decode, bugs)
            self.retries = 0
            self.failovers = 0
            self.failover_requeued = 0
            self.failover_lost = 0
            self.duplicates = 0
            # Replica lines whose id the router never issued (torn
            # framing, protocol bugs) — NOT part of the offered-request
            # ledger, and deliberately not folded into `duplicates`: a
            # wire-corruption symptom must not masquerade as benign
            # at-most-once dedupe activity.
            self.wire_errors = 0
            self._lat = deque(maxlen=self._window)
            self._t0 = time.monotonic()

    # -- updates --------------------------------------------------------
    def record_offered(self) -> None:
        with self._lock:
            self.offered += 1

    def record_resolved(self, latency_s: float) -> None:
        with self._lock:
            self.requests += 1
            self._lat.append(float(latency_s))

    def record_reject(self, cause: str, priority: str) -> None:
        with self._lock:
            self.rejected += 1
            by = self.rejected_by.setdefault(cause, {})
            by[priority] = by.get(priority, 0) + 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def record_failover(self, requeued: int, lost: int) -> None:
        with self._lock:
            self.failovers += 1
            self.failover_requeued += requeued
            self.failover_lost += lost

    def record_duplicate(self) -> None:
        with self._lock:
            self.duplicates += 1

    def record_wire_error(self) -> None:
        with self._lock:
            self.wire_errors += 1

    # -- reads ----------------------------------------------------------
    @staticmethod
    def _quantile(samples: List[float], q: float) -> float:
        # Nearest-rank, pinned identically to tpuic_torch.metrics.meters.
        return samples[max(1, min(len(samples),
                                  math.ceil(q / 100.0 * len(samples)))) - 1]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "offered": self.offered,
                "requests": self.requests,
                "rejected": self.rejected,
                "rejected_by": {c: dict(sorted(p.items())) for c, p in
                                sorted(self.rejected_by.items())},
                "errors": self.errors,
                "retries": self.retries,
                "failovers": self.failovers,
                "failover_requeued": self.failover_requeued,
                "failover_lost": self.failover_lost,
                "duplicates": self.duplicates,
                "wire_errors": self.wire_errors,
                "latency_ms": ({f"p{q}": round(
                    1000.0 * self._quantile(lat, q), 3)
                    for q in (50, 95, 99)} if lat else {}),
                "elapsed_s": round(time.monotonic() - self._t0, 3),
            }
        fn = self.replica_state_fn
        if fn is not None:
            try:
                out["replicas"] = fn()
            except Exception:  # snapshot must never take the router down
                out["replicas"] = {}
        return out


class _Request:
    """One client request as the router tracks it: the wire payload
    (sans id — the router assigns its own unique wire id per send for
    at-most-once dedupe), the client's id/future, and the replay
    ledger."""

    __slots__ = ("client_id", "payload", "future", "priority", "tenant",
                 "idempotent", "deadline", "attempts", "t_offered",
                 "wire_id", "retry_deadline")

    def __init__(self, client_id: str, payload: dict, *,
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None, idempotent: bool = True,
                 deadline_ms: Optional[float] = None) -> None:
        self.client_id = client_id
        self.payload = payload
        self.future: Future = Future()
        self.priority = priority
        self.tenant = tenant
        self.idempotent = bool(idempotent)
        self.t_offered = time.monotonic()
        self.deadline = (None if deadline_ms is None
                         else self.t_offered + float(deadline_ms) / 1000.0)
        self.attempts = 0
        self.wire_id = ""
        self.retry_deadline: Optional[float] = None  # set when first requeued


class _Replica:
    """Router-side view of one engine replica (spawned or attached)."""

    def __init__(self, idx: int, router: "Router", *,
                 cmd: Optional[List[str]] = None,
                 addr: Optional[Tuple[str, int]] = None,
                 prom_port: Optional[int] = None) -> None:
        self.idx = idx
        self.name = f"r{idx}"
        self.router = router
        self.cmd = cmd                  # None = attached, never respawned
        self.addr = addr                # (host, port); spawned: from ready file
        self.prom_port = prom_port
        self.state = STARTING
        self.child: Optional[_Child] = None
        self.spawns = 0
        self.consecutive_spawn_failures = 0
        self.sock: Optional[socket.socket] = None
        self.reader: Optional[threading.Thread] = None
        self._send_lock = threading.Lock()
        self.inflight: Dict[str, _Request] = {}  # guarded by router._lock
        # Control-channel futures (swap lines etc.) — guarded by
        # router._lock, NEVER failed over to a survivor: replaying a
        # swap on a different replica would flip the wrong process.
        self.control: Dict[str, Future] = {}
        self.routed = 0
        self.transport_failures = 0
        # Per-replica outcome ledger (docs/serving.md, "Model
        # lifecycle"): what THIS replica answered — the canary rollout
        # controller's health signal (resolved + typed verdicts are
        # health; untyped errors on a canary trigger rollback).
        self.resolved = 0
        self.rejected_typed = 0
        self.resp_errors = 0
        # Model identity (ready file at spawn, then live pongs).
        self.digest: Optional[str] = None
        self.generation: Optional[int] = None
        self.dtypes: Optional[Tuple[str, ...]] = None
        self._digest_flagged = False
        self.breaker = CircuitBreaker(
            threshold=router.breaker_threshold,
            cooldown_s=router.breaker_cooldown_s,
            on_transition=lambda old, new, reason: router._publish(
                "router_breaker", replica=self.name, old=old, new=new,
                reason=reason))
        # Health signals
        self.connected_at = 0.0
        self.last_pong = 0.0
        self.last_ping_sent = 0.0
        self.queue_depth: Optional[int] = None
        self.brownout_level = 0
        self.service_est_s: Optional[float] = None
        self.last_scrape = 0.0
        self.respawn_at = 0.0
        self.started_at = time.monotonic()
        self._last_timeout_fail = 0.0
        self.state_dir = os.path.join(router.state_dir, self.name)
        self.ready_file = os.path.join(self.state_dir, "ready.json")
        self.heartbeat_file = os.path.join(self.state_dir, "heartbeat.json")
        self.log_file = os.path.join(self.state_dir, "replica.log")
        self._log_fh = None
        os.makedirs(self.state_dir, exist_ok=True)

    # -- health ---------------------------------------------------------
    def live(self, now: float) -> bool:
        """Live probe verdict: a pong (or fresh connect) inside the
        ping timeout."""
        anchor = max(self.last_pong, self.connected_at)
        return anchor > 0 and now - anchor <= self.router.ping_timeout_s

    def heartbeat_age_s(self) -> Optional[float]:
        if self.cmd is None:
            return None
        hb = read_heartbeat(self.heartbeat_file)
        if hb is None or not isinstance(hb.get("t"), (int, float)):
            return None
        return max(0.0, time.time() - float(hb["t"]))

    def spill_limit(self) -> int:
        """The shed-aware knee: Little's law concurrency at the
        committed knee (knee_rps × the replica's scraped service-time
        estimate), floored at 2 so a cold replica is still routable.
        ``--spill-inflight`` overrides; no knee signal = a permissive
        default (the engine's own bounded queue backstops)."""
        r = self.router
        if r.spill_inflight:
            return r.spill_inflight
        if r.knee_rps and self.service_est_s:
            return max(2, math.ceil(r.knee_rps * self.service_est_s))
        return 64

    def sheds(self, priority: str) -> bool:
        """Whether this replica's scraped brownout level would shed
        ``priority`` (the admission tier's level-L-sheds-the-L-lowest
        rule) — used to deprioritize, never to hard-exclude: if every
        replica sheds, the replica's own typed verdict is the answer."""
        lvl = self.brownout_level
        return lvl > 0 and priority_index(priority) >= len(PRIORITIES) - lvl

    def health(self) -> dict:
        now = time.monotonic()
        return {
            "state": self.state,
            "breaker": self.breaker.snapshot(),
            "inflight": len(self.inflight),
            "routed": self.routed,
            "resolved": self.resolved,
            "rejected_typed": self.rejected_typed,
            "resp_errors": self.resp_errors,
            "digest": self.digest,
            "generation": self.generation,
            "dtypes": (list(self.dtypes) if self.dtypes else None),
            "digest_ok": not self._digest_flagged,
            "transport_failures": self.transport_failures,
            "live": self.live(now),
            "queue_depth": self.queue_depth,
            "brownout_level": self.brownout_level,
            "service_est_s": self.service_est_s,
            "spill_limit": self.spill_limit(),
            "heartbeat_age_s": self.heartbeat_age_s(),
            "spawns": self.spawns,
            "pid": (self.child.pid if self.child is not None else None),
            "addr": (list(self.addr) if self.addr else None),
            "prom_port": self.prom_port,
        }

    # -- transport ------------------------------------------------------
    def send_line(self, rec: dict) -> None:
        """One JSONL line to the replica; raises OSError on transport
        failure (caller owns the breaker/retry consequences)."""
        data = (json.dumps(rec) + "\n").encode()
        with self._send_lock:
            sock = self.sock
            if sock is None:
                raise OSError("not connected")
            sock.sendall(data)

    def close_socket(self) -> None:
        with self._send_lock:
            sock, self.sock = self.sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def close_log(self) -> None:
        if self._log_fh is not None:
            try:
                self._log_fh.close()
            except OSError:
                pass
            self._log_fh = None


class Router:
    """The replica-fleet front tier (module docstring; docs/serving.md,
    "Replica routing and failover").

    Construct with either ``replica_cmd`` (+ ``n_replicas``) to spawn
    and supervise engine processes — a list command template;
    ``{i}`` is substituted with the replica index and ``{ready}`` with
    the per-replica ready-file path (appended as ``--ready-file`` if
    the template omits it) — or ``attach`` (a list of ``(host, port)``
    or ``(host, port, prom_port)`` tuples) to route to replicas managed
    elsewhere (attached replicas are reconnected but never respawned).

    ``submit(images, ...)`` / ``submit_line(request_dict)`` return a
    Future resolving to the replica's response record (the
    ``{"id", "pred", "prob", "topk"}`` wire shape, id rewritten to the
    client's) or raising the typed verdict.  The ``stats`` attribute
    satisfies the loadgen endpoint protocol (``reset``/``snapshot``
    with an exact offered-traffic ledger), so ``loadgen.run_stream``
    drives a Router exactly like an engine.
    """

    def __init__(self, *, replica_cmd: Optional[List[str]] = None,
                 n_replicas: int = 2,
                 attach: Optional[List[Tuple]] = None,
                 state_dir: str = "router-state",
                 knee_rps: float = 0.0, spill_inflight: int = 0,
                 retry_ratio: float = 0.1, retry_cap: float = 32.0,
                 max_attempts: int = 3, retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 1.0,
                 retry_window_s: float = 10.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 1.0,
                 ping_interval_s: float = 0.25, ping_timeout_s: float = 3.0,
                 wedge_timeout_s: float = 15.0,
                 spawn_timeout_s: float = 300.0,
                 respawn_backoff_s: float = 0.5, max_respawns: int = 8,
                 grace_s: float = 10.0, drain_timeout_s: float = 30.0,
                 publish: Optional[Callable] = None,
                 ledger_path: str = "",
                 log: Optional[Callable[[str], None]] = None) -> None:
        if not replica_cmd and not attach:
            raise ValueError("Router needs replica_cmd (spawn) and/or "
                             "attach (existing replicas)")
        self.state_dir = os.path.abspath(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.knee_rps = float(knee_rps)
        self.spill_inflight = int(spill_inflight)
        self.max_attempts = max(1, int(max_attempts))
        self.retry_backoff_s = max(0.0, float(retry_backoff_s))
        self.retry_backoff_cap_s = max(self.retry_backoff_s,
                                       float(retry_backoff_cap_s))
        self.retry_window_s = max(1.0, float(retry_window_s))
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.ping_interval_s = float(ping_interval_s)
        self.ping_timeout_s = float(ping_timeout_s)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.max_respawns = int(max_respawns)
        self.grace_s = float(grace_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._publish_hook = publish
        self._log = log or (lambda msg: print(f"[router] {msg}",
                                              file=sys.stderr, flush=True))
        self.stats = RouterStats()
        self.stats.replica_state_fn = self.replica_health
        self.retry_budget = RetryBudget(ratio=retry_ratio, cap=retry_cap)
        self._lock = threading.Lock()
        # Model-identity gate (docs/serving.md, "Model lifecycle"): the
        # first digest a replica reports becomes the fleet's; replicas
        # reporting a digest outside the allowed set are refused
        # traffic — hot-swap must not silently open a heterogeneous
        # fleet.  The rollout controller widens the set (allow_digest)
        # for the canary's candidate and narrows it again on
        # promote/rollback (set_fleet_digest / disallow_digest).
        self.fleet_digest: Optional[str] = None
        self._allowed_digests: Set[str] = set()
        # Canary traffic split: (frozenset of replica names, fraction).
        # None = normal least-loaded routing over the whole fleet.
        self._split: Optional[Tuple[frozenset, float]] = None
        # Deterministic-seedable split draw (tests inject their own).
        self._split_rng = random.Random()
        # Optional per-outcome hook: fn(replica_name, kind, latency_s)
        # with kind in ("resolved", "rejected", "error") — the rollout
        # controller's canary-scoped SLO feed.  Called outside locks;
        # exceptions contained.
        self.outcome_hook: Optional[Callable] = None
        # Digest transitions noted under self._lock, published outside
        # it (events write files).  A LIST, not a single slot: several
        # replica reader threads can transition at once (e.g. a
        # rollback disallowing a digest two replicas still report) and
        # the ledger must record every one.
        self._digest_events: List[Tuple[str, str, str, Optional[str]]] = []
        self._ledger_lock = threading.Lock()
        self.ledger_path = ledger_path or os.path.join(
            self.state_dir, "router_ledger.jsonl")
        self._wire_ids = itertools.count(1)
        # Replay queue: a HEAP on due time, not a FIFO — entries carry
        # attempt-dependent backoffs (up to retry_backoff_cap_s), so a
        # long-backoff head must not head-of-line block already-due
        # replays behind it.  The seq tiebreaks equal due times
        # (_Request is not orderable) and keeps same-instant replays
        # FIFO.
        self._retryq: List[Tuple[float, int, _Request]] = []
        self._retry_seq = itertools.count()
        self._draining = False
        self._closed = False
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.replicas: List[_Replica] = []
        idx = 0
        for spec in (attach or ()):
            host, port = spec[0], int(spec[1])
            prom = int(spec[2]) if len(spec) > 2 and spec[2] else None
            rep = _Replica(idx, self, addr=(host, port), prom_port=prom)
            self.replicas.append(rep)
            idx += 1
        if replica_cmd:
            for _ in range(max(1, int(n_replicas))):
                rep = _Replica(idx, self, cmd=list(replica_cmd))
                self.replicas.append(rep)
                idx += 1

    # -- model identity / canary split ----------------------------------
    def allow_digest(self, digest: str) -> None:
        """Authorize a second model digest fleet-wide (the rollout
        controller calls this for the canary's candidate BEFORE shifting
        traffic to it)."""
        with self._lock:
            self._allowed_digests.add(str(digest))
        self._publish("router_replica", replica="*",
                      action="digest_allow", digest=str(digest))

    def disallow_digest(self, digest: str) -> None:
        """Withdraw a digest's authorization (rollback): replicas still
        reporting it are refused traffic until they swap back — even a
        failed swap-back cannot leak candidate predictions."""
        with self._lock:
            self._allowed_digests.discard(str(digest))
        self._publish("router_replica", replica="*",
                      action="digest_disallow", digest=str(digest))

    def set_fleet_digest(self, digest: str) -> None:
        """Promotion: the candidate digest becomes THE fleet digest and
        the only authorized one."""
        with self._lock:
            self.fleet_digest = str(digest)
            self._allowed_digests = {str(digest)}
        self._publish("router_replica", replica="*",
                      action="fleet_digest", digest=str(digest))

    def set_traffic_split(self, canaries, fraction: float) -> None:
        """Route ``fraction`` of pick decisions to the named canary
        replicas, the rest to everyone else (least-loaded within each
        group).  A group with no routable member falls back to the
        other — availability beats split fidelity mid-rollout."""
        names = frozenset(str(n) for n in canaries)
        frac = min(1.0, max(0.0, float(fraction)))
        with self._lock:
            self._split = (names, frac)
        self._publish("router_replica", replica="*", action="split",
                      canaries=sorted(names), fraction=frac)

    def clear_traffic_split(self) -> None:
        with self._lock:
            self._split = None
        self._publish("router_replica", replica="*", action="split_clear")

    def _note_digest_locked(self, rep: _Replica) -> None:
        """Adopt / flag a replica's reported digest (caller holds
        ``self._lock``).  First digest seen becomes the fleet's; a
        digest outside the allowed set flags the replica (refused by
        ``_pick``) until it matches again or the set widens."""
        d = rep.digest
        if d is None:
            return
        if self.fleet_digest is None:
            self.fleet_digest = d
            self._allowed_digests.add(d)
        flagged = d not in self._allowed_digests
        if flagged != rep._digest_flagged:
            rep._digest_flagged = flagged
            self._digest_events.append(
                (rep.name, "digest_mismatch" if flagged else "digest_ok",
                 d, self.fleet_digest))

    def _flush_digest_event(self) -> None:
        """Publish digest transitions recorded under the lock (events
        write files — never inside ``self._lock``)."""
        with self._lock:
            if not self._digest_events:
                return
            evs, self._digest_events = self._digest_events, []
        for name, action, digest, fleet in evs:
            self._publish("router_replica", replica=name, action=action,
                          digest=digest, fleet_digest=fleet)
            if action == "digest_mismatch":
                self._log(f"{name}: MODEL DIGEST MISMATCH ({digest} not "
                          f"in allowed set; fleet {fleet}) — refusing "
                          "to route to it")

    # -- control channel ------------------------------------------------
    def control_request(self, replica: str, payload: dict,
                        timeout_s: float = 120.0) -> dict:
        """One control line (e.g. ``{"op": "swap", ...}``) to the NAMED
        replica; blocks for its keyed response.

        Control requests are deliberately OUTSIDE the failover path:
        they are never replayed on a survivor (a swap replayed on a
        different replica would flip the wrong process), never counted
        in the offered-traffic ledger, and a replica death mid-request
        raises :class:`ReplicaLost`.  A wire error record raises its
        rebuilt typed exception — a gate's ``SwapRejected`` crosses the
        socket intact (tpuic/serve/wire.py)."""
        rep = None
        for r in self.replicas:
            if r.name == str(replica):
                rep = r
                break
        if rep is None:
            raise ValueError(f"no replica named {replica!r} "
                             f"(have: {[r.name for r in self.replicas]})")
        wire_id = f"c{next(self._wire_ids)}"
        fut: Future = Future()
        with self._lock:
            rep.control[wire_id] = fut
        try:
            rep.send_line({**payload, "id": wire_id})
        except OSError as e:
            with self._lock:
                rep.control.pop(wire_id, None)
            self._on_replica_down(rep, f"control send: {e}")
            raise ReplicaLost(f"control send to {rep.name} failed: {e}")
        try:
            return fut.result(timeout=timeout_s)
        except _FutTimeout:
            with self._lock:
                rep.control.pop(wire_id, None)
            raise TimeoutError(
                f"control request to {rep.name} timed out after "
                f"{timeout_s:g}s (op={payload.get('op')!r})") from None

    # -- telemetry ------------------------------------------------------
    def _publish(self, kind: str, **data) -> None:
        rec = {"event": kind, "t": round(time.time(), 3), **data}
        with self._ledger_lock:
            try:
                with open(self.ledger_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass  # a full disk must not take down routing
        if self._publish_hook is not None:
            try:
                self._publish_hook(kind, **data)
            except Exception:
                pass

    # -- lifecycle ------------------------------------------------------
    def start(self, timeout_s: Optional[float] = None) -> "Router":
        """Spawn/connect every replica and start the health pump.
        Blocks until every replica is up (or ``timeout_s``, default
        ``spawn_timeout_s``); raises RuntimeError if none made it —
        a router with zero replicas can only shed."""
        for rep in self.replicas:
            if rep.cmd is not None:
                self._spawn(rep)
            else:
                self._try_connect(rep)
        self._stop.clear()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="tpuic-router-pump")
        self._pump.start()
        deadline = time.monotonic() + (self.spawn_timeout_s
                                       if timeout_s is None else timeout_s)
        while time.monotonic() < deadline:
            states = [r.state for r in self.replicas]
            if all(s == UP for s in states):
                return self
            if all(s in (FAILED, STOPPED) for s in states):
                break
            time.sleep(0.05)
        up = sum(r.state == UP for r in self.replicas)
        if up == 0:
            self.close(drain=False)
            raise RuntimeError(
                f"no replica became ready within the spawn timeout "
                f"(states: {[r.state for r in self.replicas]}; see "
                f"per-replica logs under {self.state_dir})")
        self._log(f"started with {up}/{len(self.replicas)} replicas up")
        return self

    def _spawn(self, rep: _Replica) -> None:
        rep.spawns += 1
        try:
            os.remove(rep.ready_file)
        except OSError:
            pass
        cmd = []
        for a in rep.cmd:
            cmd.append(a.replace("{i}", str(rep.idx))
                       .replace("{ready}", rep.ready_file))
        if "--ready-file" not in " ".join(cmd):
            cmd += ["--ready-file", rep.ready_file]
        rep.child = _Child(
            cmd, heartbeat_file=rep.heartbeat_file,
            stack_dump=os.path.join(rep.state_dir,
                                    f"stackdump-{rep.spawns}.txt"),
            flight_dump=os.path.join(rep.state_dir,
                                     f"flightdump-{rep.spawns}.jsonl"),
            label=rep.name)
        rep.close_log()
        rep._log_fh = open(rep.log_file, "a")
        rep.child.spawn(dict(os.environ), stdout=rep._log_fh,
                        stderr=subprocess.STDOUT)
        rep.state = STARTING
        rep.started_at = time.monotonic()
        self._publish("router_replica", replica=rep.name, state=STARTING,
                      action="spawn", spawn=rep.spawns, pid=rep.child.pid)

    def _try_connect(self, rep: _Replica) -> bool:
        if rep.addr is None:
            return False
        try:
            sock = socket.create_connection(rep.addr, timeout=2.0)
        except OSError:
            return False
        sock.settimeout(2.0)  # send timeout; recv loop handles its own
        rep.sock = sock
        rep.connected_at = time.monotonic()
        rep.last_pong = rep.connected_at
        rep.state = UP
        rep.reader = threading.Thread(
            target=self._reader, args=(rep, sock), daemon=True,
            name=f"tpuic-router-read-{rep.name}")
        rep.reader.start()
        self._publish("router_replica", replica=rep.name, state=UP,
                      action="connect", addr=list(rep.addr))
        self._log(f"{rep.name}: connected to {rep.addr[0]}:{rep.addr[1]}"
                  + (f" (breaker {rep.breaker.state})"
                     if rep.breaker.state != "closed" else ""))
        return True

    # -- submit path ----------------------------------------------------
    def submit(self, images=None, *, line: Optional[dict] = None,
               timeout: Optional[float] = None,
               priority: str = DEFAULT_PRIORITY,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               idempotent: bool = True,
               client_id: str = "") -> Future:
        """Route one request; returns a Future resolving to the
        replica's response record (or raising its typed verdict).

        ``images``: a duck-typed array (``.tobytes()``/``.shape``/
        ``.dtype``) shipped as a base64 payload — the router never
        imports numpy.  A dict is treated as a raw request line
        (``line``).  ``timeout`` bounds the wait for a routable replica
        (None blocks, 0 sheds immediately — the engine's backpressure
        contract).  ``idempotent=False`` marks the request
        non-replayable: if its replica dies mid-flight it resolves with
        :class:`ReplicaLost` instead of being requeued."""
        if isinstance(images, dict) and line is None:
            images, line = None, images
        payload: dict = dict(line or {})
        payload.pop("id", None)
        if payload.get("op") is not None:
            # Control lines (swap, ping) must NEVER ride the data path:
            # submit() failover-replays idempotent requests onto
            # survivors — a replayed swap would flip a replica nobody
            # named — and an unauthenticated front-end forwarding raw
            # lines here must not be a one-line weight flip.  The only
            # control channel is Router.control_request.
            raise ValueError(
                f"control line op={payload['op']!r} cannot ride the "
                "data path — use Router.control_request")
        if images is not None:
            payload.update(wire.encode_array(images))
        if priority != DEFAULT_PRIORITY or "priority" in payload:
            payload.setdefault("priority", priority)
        priority = payload.get("priority", priority)
        priority_index(priority)  # validate early, typed error
        if deadline_ms is not None:
            payload.setdefault("deadline_ms", float(deadline_ms))
        if tenant is not None:
            payload.setdefault("tenant", tenant)
        idempotent = bool(payload.pop("idempotent", idempotent))
        req = _Request(client_id, payload, priority=priority, tenant=tenant,
                       idempotent=idempotent,
                       deadline_ms=payload.get("deadline_ms"))
        self.stats.record_offered()
        if self._draining or self._closed:
            self._resolve_reject(req, AdmissionRejected(
                "router draining", cause="queue_full", priority=priority,
                tenant=tenant))
            return req.future
        self._dispatch(req, timeout=timeout)
        return req.future

    def submit_line(self, req_line: dict) -> Tuple[str, Future]:
        """CLI accept path: one parsed request line (path-based or b64)
        routed non-blocking.  Returns ``(client_id, future)``."""
        rid = str(req_line.get("id", req_line.get("path", "?")))
        fut = self.submit(line=dict(req_line), timeout=0, client_id=rid)
        return rid, fut

    def _resolve_reject(self, req: _Request, exc: Exception) -> None:
        from tpuic_torch.serve.admission import AdmissionError
        if isinstance(exc, AdmissionError):
            self.stats.record_reject(exc.cause, req.priority)
        else:
            self.stats.record_error()
        if not req.future.done():
            req.future.set_exception(exc)

    def _try_once(self, req: _Request) -> Tuple[bool, Optional[str]]:
        """ONE non-blocking route attempt: pick + send, re-picking past
        transport failures until either the request is handled (sent,
        or typed-resolved) or no replica is routable right now.
        Returns ``(handled, why_not)``.  Never sleeps — safe on the
        health-pump thread."""
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._resolve_reject(req, DeadlineExceeded(
                "deadline expired before a replica accepted it",
                priority=req.priority, tenant=req.tenant))
            return True, None
        while True:
            rep, why = self._pick(req.priority)
            if rep is None:
                return False, why
            if self._send(rep, req):
                return True, None
            # transport failure: breaker recorded, socket condemned —
            # the next pick sees it unroutable; loop is bounded by
            # replicas going unroutable.

    def _dispatch(self, req: _Request,
                  timeout: Optional[float] = 0.0) -> None:
        """Pick a replica and send; shed typed when none is routable
        within ``timeout``.  Runs on caller threads (submit)."""
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        while True:
            handled, why = self._try_once(req)
            if handled:
                return
            if self._draining or self._closed:
                why = "router draining"
            elif deadline is not None and time.monotonic() >= deadline:
                pass  # shed below
            else:
                time.sleep(0.005)
                continue
            self._resolve_reject(req, AdmissionRejected(
                f"router shed: {why} (priority={req.priority})",
                cause="queue_full", priority=req.priority,
                tenant=req.tenant))
            return

    def _pick(self, priority: str
              ) -> Tuple[Optional[_Replica], Optional[str]]:
        """Least-loaded shed-aware selection (module docstring), behind
        the model-identity gate and the canary traffic split."""
        now = time.monotonic()
        with self._lock:
            cands = [r for r in self.replicas
                     if r.state == UP and r.live(now)]
            if not cands:
                return None, "no live replica"
            # Model-identity gate (docs/serving.md, "Model lifecycle"):
            # a replica reporting a digest outside the allowed set is
            # refused — a hot-swap mid-rollout must not silently serve
            # unauthorized weights.  Unknown digests (no signal yet,
            # pre-identity replicas) pass: the gate refuses proven
            # heterogeneity, it does not demand proof of homogeneity.
            gated = [r for r in cands if not r._digest_flagged]
            if not gated:
                return None, (f"all {len(cands)} live replicas refused: "
                              "model digest outside the allowed set")
            cands = gated
            split = self._split
            if split is not None:
                names, frac = split
                canary = [r for r in cands if r.name in names]
                rest = [r for r in cands if r.name not in names]
                if canary and rest:
                    at_limit = lambda grp: all(  # noqa: E731
                        len(r.inflight) >= r.spill_limit() for r in grp)
                    chosen = (canary if self._split_rng.random() < frac
                              else rest)
                    other = rest if chosen is canary else canary
                    # Availability over split fidelity: a group at its
                    # spill limit falls back to the other instead of
                    # shedding while capacity idles.
                    if at_limit(chosen) and not at_limit(other):
                        chosen = other
                    cands = chosen
            ranked = sorted(
                cands, key=lambda r: (r.sheds(priority),
                                      len(r.inflight) >= r.spill_limit(),
                                      len(r.inflight), r.routed))
            if all(len(r.inflight) >= r.spill_limit() for r in ranked):
                # Shed-aware: every replica is at/past its committed
                # knee — spilling anywhere buys queueing toward a
                # timeout, so the router sheds typed instead.
                return None, (f"all {len(ranked)} replicas at their "
                              "spill limit")
        for rep in ranked:
            if rep.breaker.try_acquire():
                return rep, None
        return None, "breaker open on every live replica"

    def _send(self, rep: _Replica, req: _Request) -> bool:
        req.attempts += 1
        wire_id = f"q{next(self._wire_ids)}"
        req.wire_id = wire_id
        with self._lock:
            rep.inflight[wire_id] = req
            rep.routed += 1
        try:
            rep.send_line({**req.payload, "id": wire_id})
        except OSError as e:
            # A failed sendall may have left a PARTIAL line on the
            # socket: the connection's framing is indeterminate and
            # every later request on it would be corrupted — conclusive
            # for this connection, exactly like a recv error.  Pop our
            # own wire id first (this request is handled HERE), then
            # run the down path directly — it trips the breaker, closes
            # the socket, and fails over whatever else is in flight.
            # Don't wait for the reader to notice the close: whether
            # the sender or the reader sees the failure first is a
            # race, and _on_replica_down is idempotent either way.
            with self._lock:
                owned = rep.inflight.pop(wire_id, None) is not None
            self._on_replica_down(rep, f"send: {e}")
            if not owned:
                # The reader's failover beat us to the pop and owns the
                # request now (replay or typed verdict) — a second
                # dispatch here would double-route it.
                return True
            if not req.idempotent:
                # The line may have partially left; a non-idempotent
                # request cannot risk double execution.
                self._resolve_reject(req, ReplicaLost(
                    f"send to {rep.name} failed and the request is "
                    f"not idempotent: {e}", priority=req.priority,
                    tenant=req.tenant))
                return True  # handled (verdict delivered)
            return False
        # A successful send is NOT a breaker success — only a delivered
        # response is (the reader records it); half-open probes stay
        # out until their outcome arrives.
        return True

    # -- replica reader -------------------------------------------------
    def _reader(self, rep: _Replica, sock: socket.socket) -> None:
        buf = b""
        reason = "connection closed by replica"
        while not self._stop.is_set():
            try:
                sock.settimeout(0.5)
                chunk = sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError as e:
                reason = f"recv: {e}"
                chunk = b""
            if not chunk:
                break
            *lines, buf = (buf + chunk).split(b"\n")
            for raw in lines:
                if raw.strip():
                    self._on_line(rep, raw.decode("utf-8", "replace"))
        with rep._send_lock:
            # rep.sock is sock: EOF/error on the live socket — the
            # replica is gone.  rep.sock is None: somebody condemned
            # THIS connection (close_socket nulls the slot before
            # shutting the fd down) — the down path must still run,
            # and _on_replica_down's state check makes the second
            # call from a racing sender/ping a no-op.  Only a non-None
            # DIFFERENT socket means a reconnect already replaced this
            # connection; downing the replica then would kill the new
            # link.
            replaced = rep.sock is not None and rep.sock is not sock
        if not self._stop.is_set() and not replaced:
            self._on_replica_down(rep, reason)

    def _on_line(self, rep: _Replica, raw: str) -> None:
        try:
            rec = json.loads(raw)
            if not isinstance(rec, dict):
                raise ValueError
        except ValueError:
            return  # a torn line from a dying replica
        if rec.get("op") == "pong":
            rep.last_pong = time.monotonic()
            if rec.get("queue_depth") is not None:
                rep.queue_depth = int(rec["queue_depth"])
            if rec.get("generation") is not None:
                rep.generation = int(rec["generation"])
            if rec.get("digest") is not None:
                # Live model identity: a hot-swap shows up here within
                # one ping interval, and the identity gate reacts
                # before the next pick.
                with self._lock:
                    rep.digest = str(rec["digest"])
                    self._note_digest_locked(rep)
                self._flush_digest_event()
            return
        wire_id = rec.get("id")
        with self._lock:
            ctl = (rep.control.pop(wire_id, None)
                   if wire_id is not None else None)
            req = (rep.inflight.pop(wire_id, None)
                   if ctl is None else None)
        if ctl is not None:
            # Control-channel outcome (swap lines): typed errors rebuild
            # to the exception the in-process gate would have raised;
            # breaker credit applies (the transport worked), the
            # offered-traffic ledger is untouched.
            rep.breaker.record_success()
            if ctl.done():
                return
            if "error" in rec:
                ctl.set_exception(wire.rebuild_error(rec))
            else:
                ctl.set_result(dict(rec))
            return
        if req is None:
            if (isinstance(wire_id, str) and wire_id[:1] in ("q", "c")
                    and wire_id[1:].isdigit()):
                # An id this router issued (request or control), no
                # longer in flight: a late duplicate (e.g. the original
                # response raced a failover replay, or a control
                # response landed after its timeout).  At-most-once =
                # first wins.
                self.stats.record_duplicate()
            else:
                # An id we never issued (a replica's id-less
                # bad-request-line answer, torn framing): a protocol
                # symptom, counted apart from dedupe activity.
                self.stats.record_wire_error()
            return
        rep.breaker.record_success()
        self.retry_budget.deposit()
        if req.future.done():
            self.stats.record_duplicate()
            return
        if "error" in rec:
            exc = wire.rebuild_error(rec)
            from tpuic_torch.serve.admission import AdmissionError
            if isinstance(exc, AdmissionError):
                self.stats.record_reject(exc.cause, req.priority)
                rep.rejected_typed += 1
                self._outcome(rep.name, "rejected", None)
            else:
                self.stats.record_error()
                rep.resp_errors += 1
                self._outcome(rep.name, "error", None)
            req.future.set_exception(exc)
            return
        out = dict(rec)
        out["id"] = req.client_id
        out["replica"] = rep.name
        latency_s = time.monotonic() - req.t_offered
        self.stats.record_resolved(latency_s)
        rep.resolved += 1
        if req.attempts > 1:
            # The outcome hook contract loadgen.run_stream consumes:
            # replayed requests stamp their retry count on the future.
            req.future.tpuic_retries = req.attempts - 1
        req.future.set_result(out)
        self._outcome(rep.name, "resolved", latency_s)

    def _outcome(self, replica: str, kind: str,
                 latency_s: Optional[float]) -> None:
        """Invoke the optional per-outcome hook (rollout controller's
        canary-scoped SLO feed) — contained, outside locks."""
        hook = self.outcome_hook
        if hook is None:
            return
        try:
            hook(replica, kind, latency_s)
        except Exception:  # a monitoring hook must never kill routing
            pass

    # -- failure handling -----------------------------------------------
    def _on_replica_down(self, rep: _Replica, reason: str) -> None:
        with self._lock:
            if rep.state in (DOWN, FAILED, STOPPED):
                return
            was_wedged = rep.state == WEDGED
            rep.state = DOWN
            orphans = list(rep.inflight.values())
            rep.inflight.clear()
            controls = list(rep.control.values())
            rep.control.clear()
            rep.respawn_at = (time.monotonic() + self.respawn_backoff_s
                              * (2.0 ** min(6, rep.consecutive_spawn_failures)))
        rep.close_socket()
        rep.transport_failures += 1
        rep.breaker.trip(f"connection lost: {reason}")
        for ctl in controls:
            # Control requests never fail over (a swap replayed on a
            # survivor would flip the wrong replica): the caller gets
            # the typed loss verdict and decides.
            if not ctl.done():
                ctl.set_exception(ReplicaLost(
                    f"replica {rep.name} lost mid-control-request "
                    f"({reason})"))
        requeued = lost = 0
        for req in orphans:
            if req.future.done():
                continue
            if not req.idempotent:
                self._resolve_reject(req, ReplicaLost(
                    f"replica {rep.name} lost mid-request and the "
                    "request is not idempotent", priority=req.priority,
                    tenant=req.tenant))
                lost += 1
            elif req.attempts >= self.max_attempts:
                self._resolve_reject(req, ReplicaLost(
                    f"replica {rep.name} lost mid-request; "
                    f"{req.attempts} attempts exhausted",
                    priority=req.priority, tenant=req.tenant))
                lost += 1
            elif not self.retry_budget.try_retry():
                self._resolve_reject(req, ReplicaLost(
                    f"replica {rep.name} lost mid-request; retry "
                    "budget exhausted (no retry storms)",
                    priority=req.priority, tenant=req.tenant))
                lost += 1
            else:
                self.stats.record_retry()
                delay = min(self.retry_backoff_cap_s,
                            self.retry_backoff_s
                            * (2.0 ** max(0, req.attempts - 1)))
                if req.retry_deadline is None:
                    req.retry_deadline = (time.monotonic()
                                          + self.retry_window_s)
                with self._lock:
                    heapq.heappush(self._retryq,
                                   (time.monotonic() + delay,
                                    next(self._retry_seq), req))
                self._publish("router_retry", replica=rep.name,
                              attempt=req.attempts + 1,
                              backoff_s=round(delay, 4),
                              budget=self.retry_budget.state()["tokens"])
                requeued += 1
        if requeued or lost:
            self.stats.record_failover(requeued, lost)
        self._publish("router_failover", replica=rep.name, reason=reason,
                      requeued=requeued, lost=lost, wedged=was_wedged)
        self._publish("router_replica", replica=rep.name, state=DOWN,
                      action="down", reason=reason)
        self._log(f"{rep.name}: DOWN ({reason}) — {requeued} in-flight "
                  f"requeued, {lost} replica_lost")

    def _declare_wedge(self, rep: _Replica, age: float) -> None:
        """Heartbeat stale past the watchdog: the _Child escalation
        ladder (SIGQUIT stacks + flight dump → TERM flush → KILL), then
        the normal down/respawn path.  Runs the blocking ladder on its
        own thread so pings/retries keep flowing."""
        with self._lock:
            if rep.state != UP:
                return
            rep.state = WEDGED
        self._publish("router_replica", replica=rep.name, state=WEDGED,
                      action="wedge", heartbeat_age_s=round(age, 1),
                      stack_dump=(rep.child.stack_dump
                                  if rep.child else None))
        self._log(f"{rep.name}: WEDGE — heartbeat stale {age:.1f}s; "
                  "escalating SIGQUIT→TERM→KILL")
        rep.close_socket()  # reader EOF -> immediate failover of in-flight

        def _ladder() -> None:
            try:
                if rep.child is not None and rep.child.alive():
                    rep.child.escalate(quit_wait_s=2.0,
                                       grace_s=self.grace_s)
            finally:
                # Backstop only: the reader's EOF normally ran the
                # down path long before the ladder finishes.  Gate on
                # still-WEDGED so a replica that was already downed
                # AND respawned (state STARTING by now) is not
                # condemned a second time.
                if rep.state == WEDGED:
                    self._on_replica_down(rep, "wedge escalation")

        threading.Thread(target=_ladder, daemon=True,
                         name=f"tpuic-router-escalate-{rep.name}").start()

    # -- the pump (health, retries, respawn) -----------------------------
    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            self._pump_retries(now)
            for rep in self.replicas:
                try:
                    self._pump_replica(rep, now)
                except Exception as e:  # health must never kill routing
                    self._log(f"{rep.name}: pump error: {e}")
            self._stop.wait(0.05)

    def _pump_retries(self, now: float) -> None:
        """Dispatch due replays WITHOUT blocking: the pump is also the
        fleet's health heartbeat, and a failover burst sleeping here
        would stop pings exactly when the survivors' liveness matters
        most.  A replay that finds nothing routable right now re-queues
        on a short tick until its retry window closes, then resolves
        typed replica_lost (the budget was already spent — honest
        accounting beats a second withdrawal)."""
        requeue = []
        while True:
            with self._lock:
                if not self._retryq or self._retryq[0][0] > now:
                    break
                _, _, req = heapq.heappop(self._retryq)
            handled, why = self._try_once(req)
            if handled:
                continue
            if (self._draining or self._closed
                    or (req.retry_deadline is not None
                        and now > req.retry_deadline)):
                self._resolve_reject(req, ReplicaLost(
                    f"failover replay found no routable replica "
                    f"({why})", priority=req.priority,
                    tenant=req.tenant))
            else:
                requeue.append((now + 0.05, req))
        if requeue:
            with self._lock:
                for due, req in requeue:
                    heapq.heappush(self._retryq,
                                   (due, next(self._retry_seq), req))

    def _pump_replica(self, rep: _Replica, now: float) -> None:
        if rep.state == UP:
            if now - rep.last_ping_sent >= self.ping_interval_s:
                rep.last_ping_sent = now
                try:
                    rep.send_line({"op": "ping", "id": f"hp{rep.idx}"})
                except OSError as e:
                    # A torn ping corrupts the framing for everything
                    # after it — conclusive: run the down/failover
                    # path directly (trips the breaker, closes the
                    # socket, requeues in-flight) instead of waiting
                    # for the reader to notice the close.
                    self._on_replica_down(rep, f"ping send: {e}")
                    return
            if (not rep.live(now)
                    and now - rep.connected_at > self.ping_timeout_s
                    and now - rep._last_timeout_fail > self.ping_timeout_s):
                # Pings go unanswered: one transport failure per timeout
                # window accrues toward the breaker (the live() gate
                # already unroutes the replica meanwhile).
                rep._last_timeout_fail = now
                rep.transport_failures += 1
                rep.breaker.record_failure("ping timeout")
            if rep.child is not None:
                age = rep.heartbeat_age_s()
                if age is not None and age > self.wedge_timeout_s:
                    self._declare_wedge(rep, age)
                    return
            if (rep.prom_port and now - rep.last_scrape >= 1.0):
                rep.last_scrape = now
                self._scrape(rep)
            return
        if rep.state == STARTING:
            self._pump_starting(rep, now)
            return
        if rep.state == DOWN:
            if rep.cmd is None:
                # Attached replica: reconnect (the breaker's half-open
                # probe governs rejoin) with backoff.
                if now >= rep.respawn_at:
                    rep.respawn_at = now + min(
                        5.0, self.respawn_backoff_s
                        * (2.0 ** min(6, rep.consecutive_spawn_failures)))
                    if self._try_connect(rep):
                        rep.consecutive_spawn_failures = 0
                    else:
                        rep.consecutive_spawn_failures += 1
                return
            if self._draining or self._closed:
                return
            if rep.spawns >= self.max_respawns + 1:
                rep.state = FAILED
                self._publish("router_replica", replica=rep.name,
                              state=FAILED, action="giveup",
                              spawns=rep.spawns)
                self._log(f"{rep.name}: FAILED — respawn budget "
                          f"exhausted ({rep.spawns} spawns)")
                return
            if now >= rep.respawn_at and (rep.child is None
                                          or not rep.child.alive()):
                if rep.child is not None and rep.child.proc is not None:
                    rep.child.proc.poll()  # reap: no zombie per respawn
                self._spawn(rep)

    def _pump_starting(self, rep: _Replica, now: float) -> None:
        if rep.cmd is None:
            # Attached replica: keep knocking on the configured address.
            if now >= rep.respawn_at:
                rep.respawn_at = now + 0.5
                self._try_connect(rep)
            return
        if rep.child is not None and rep.child.poll() is not None:
            rep.consecutive_spawn_failures += 1
            self._on_replica_down(
                rep, f"exited {rep.child.poll()} during startup")
            return
        if now - rep.started_at > self.spawn_timeout_s:
            rep.consecutive_spawn_failures += 1
            if rep.child is not None:
                rep.child.term()
                rep.child.wait_or_kill(self.grace_s)
            self._on_replica_down(rep, "startup timeout")
            return
        ready = wire.read_ready_file(rep.ready_file)
        if ready is None:
            return
        if (rep.child is not None and rep.child.pid is not None
                and ready.get("pid") not in (None, rep.child.pid)):
            return  # stale file from a previous life
        port = ready.get("port")
        if port is None:
            return
        rep.addr = ("127.0.0.1", int(port))
        if ready.get("prom_port"):
            rep.prom_port = int(ready["prom_port"])
        if ready.get("dtypes"):
            rep.dtypes = tuple(str(t) for t in ready["dtypes"])
        if ready.get("generation") is not None:
            rep.generation = int(ready["generation"])
        if ready.get("digest"):
            # Boot identity from the handoff (live identity rides the
            # pongs): the heterogeneous-fleet gate engages before the
            # first request is ever routed to this replica.
            with self._lock:
                rep.digest = str(ready["digest"])
                self._note_digest_locked(rep)
            self._flush_digest_event()
        if self._try_connect(rep):
            rep.consecutive_spawn_failures = 0

    def _scrape(self, rep: _Replica) -> None:
        """Best-effort scrape of the replica's own prom exposition:
        brownout level (the shed-aware routing signal) and the span
        ledger's post-queue p50s (the service estimate the spill limit
        consumes — the same sum as ServeStats.estimated_service_s)."""
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rep.prom_port}/metrics",
                    timeout=0.8) as resp:
                text = resp.read().decode("utf-8", "replace")
        except Exception:
            return  # monitoring outage != replica outage
        est = 0.0
        for ln in text.splitlines():
            if ln.startswith("#") or not ln.strip():
                continue
            try:
                key, val = ln.rsplit(None, 1)
                v = float(val)
            except ValueError:
                continue
            if key.startswith("tpuic_serve_brownout_level"):
                rep.brownout_level = int(v)
            elif key.startswith("tpuic_serve_span_ms{phase=\""):
                phase = key.split('phase="', 1)[1].split('"', 1)[0]
                if phase != "queue" and 'quantile="p50"' in key:
                    est += v / 1000.0
        if est > 0:
            rep.service_est_s = est

    # -- views ----------------------------------------------------------
    def replica_health(self) -> dict:
        return {rep.name: rep.health() for rep in self.replicas}

    def snapshot(self) -> dict:
        """Stats + retry budget + per-replica health + model-identity
        state, one JSON-able dict (the prom exposition's input)."""
        out = self.stats.snapshot()
        out["retry_budget"] = self.retry_budget.state()
        with self._lock:
            out["fleet_digest"] = self.fleet_digest
            out["allowed_digests"] = sorted(self._allowed_digests)
            split = self._split
        out["traffic_split"] = (
            {"canaries": sorted(split[0]), "fraction": split[1]}
            if split is not None else None)
        return out

    # -- drain / close ---------------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> int:
        """Stop accepting (new submits shed typed), wait out in-flight
        and queued replays up to the timeout, then resolve stragglers
        with a typed ``replica_lost`` verdict (the fleet is going
        away).  Returns the straggler count.  The PR-2 preemption
        contract: everything accepted either resolves or gets an
        explicit typed verdict — never a silent drop."""
        self._draining = True
        deadline = time.monotonic() + (self.drain_timeout_s
                                       if timeout_s is None else timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                pending = (sum(len(r.inflight) for r in self.replicas)
                           + len(self._retryq))
            if pending == 0:
                return 0
            time.sleep(0.02)
        stragglers: List[_Request] = []
        with self._lock:
            for rep in self.replicas:
                stragglers.extend(rep.inflight.values())
                rep.inflight.clear()
            stragglers.extend(req for _, _, req in self._retryq)
            self._retryq.clear()
        n = 0
        for req in stragglers:
            if req.future.done():
                continue
            n += 1
            self._resolve_reject(req, ReplicaLost(
                "drain timeout: router shutting down before this "
                "request finished", priority=req.priority,
                tenant=req.tenant))
        if n:
            self._log(f"drain: {n} straggler(s) resolved replica_lost")
        return n

    def close(self, drain: bool = True) -> None:
        """Drain (optionally), then stop the fleet: one SIGTERM per
        replica (the engine's own graceful drain — _Child.term's
        one-TERM-per-pid guard), the grace window, SIGKILL leftovers,
        reap, close sockets and threads."""
        if self._closed:
            return
        if drain:
            self.drain()
        self._closed = True
        self._draining = True
        self._stop.set()
        for rep in self.replicas:
            if rep.child is not None and rep.child.alive():
                rep.child.term()
        for rep in self.replicas:
            if rep.child is not None and rep.child.proc is not None:
                try:
                    rep.child.wait_or_kill(self.grace_s)
                except Exception:
                    pass
            rep.state = STOPPED if rep.state != FAILED else FAILED
            rep.close_socket()
            rep.close_log()
        if self._pump is not None:
            self._pump.join(timeout=2.0)
            self._pump = None
        for rep in self.replicas:
            if rep.reader is not None:
                rep.reader.join(timeout=2.0)
        self._publish("router_replica", replica="*", state=STOPPED,
                      action="close")

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- CLI ---------------------------------------------------------------------
def pump_stdin(handle: Callable[[str], None], guard,
               beat: Optional[Callable[[], None]] = None) -> None:
    """Select-gated raw stdin pump (the serve CLI's idiom: PEP 475
    would resume a blocked readline right through SIGTERM; raw os.read
    because TextIOWrapper buffering hides burst-written lines from
    select).  Shared by the router CLI and the rollout CLI — one
    implementation of the accept loop, not three.  ``handle`` gets each
    complete line; ``beat`` ticks the supervised-liveness heartbeat."""
    import select
    try:
        stdin_fd = sys.stdin.fileno()
    except (ValueError, OSError, AttributeError):
        stdin_fd = None
    if stdin_fd is None:
        for line in sys.stdin:
            if guard.triggered:
                return
            handle(line)
        return
    tail = b""
    while not guard.triggered:
        try:
            ready, _, _ = select.select([stdin_fd], [], [], 0.2)
        except (OSError, ValueError):
            return
        if beat is not None:
            beat()
        if not ready:
            continue
        chunk = os.read(stdin_fd, 1 << 16)
        if not chunk:
            break  # EOF
        *lines, tail = (tail + chunk).split(b"\n")
        for raw in lines:
            handle(raw.decode("utf-8", "replace"))
    if tail.strip() and not guard.triggered:
        handle(tail.decode("utf-8", "replace"))


def make_line_handler(router: Router, out, out_lock: threading.Lock
                      ) -> Callable[[str], None]:
    """Client-line handler for the stdin CLIs (router and rollout):
    parse one JSONL request line, route it, write the outcome (result
    record or typed error line) to ``out`` under ``out_lock``.  One
    implementation so the two CLIs cannot drift on the wire shape."""

    def emit_outcome(rid: str, fut) -> None:
        try:
            rec = fut.result()
            line = json.dumps({**rec, "id": rid}) + "\n"
        except Exception as e:  # noqa: BLE001 — typed via the one encoder
            line = wire.error_line(rid, e)
        with out_lock:
            out.write(line)
            out.flush()

    def handle(line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError
        except ValueError:
            with out_lock:
                out.write(wire.error_line(
                    None, f"bad request line: {line[:80]}"))
                out.flush()
            return
        try:
            rid, fut = router.submit_line(req)
        except (ValueError, TypeError) as e:
            with out_lock:
                out.write(wire.error_line(
                    str(req.get("id", "?")), e))
                out.flush()
            return
        fut.add_done_callback(lambda f, rid=rid: emit_outcome(rid, f))

    return handle


def main(argv=None) -> int:
    """``python -m tpuic_torch.serve.router`` — stdin-JSONL in, fleet out.

    Same client protocol as ``python -m tpuic_torch.serve`` stdin mode
    (``{"id", "path", ...}`` per line; responses/typed error lines to
    --out, keyed by id — responses may arrive out of submission
    order).  Lines may carry ``"idempotent": false`` to forbid
    failover replay for that request."""
    import argparse

    p = argparse.ArgumentParser(
        description="Replica-fleet router over socket-JSONL engine "
                    "replicas (docs/serving.md)")
    p.add_argument("--replicas", type=int, default=2,
                   help="replica count to spawn from --replica-cmd")
    p.add_argument("--replica-cmd", default="",
                   help="replica command template ({i} = index, {ready} "
                        "= ready-file path); must include --listen. "
                        "E.g.: 'python -m tpuic_torch.serve --synthetic-init "
                        "--model resnet50 --num-classes 1000 --resize 224 "
                        "--listen 127.0.0.1:0 --prom-port -1' (-1: a free "
                        "port for the replica's /metrics, named in its "
                        "ready file, which the router scrapes for brownout "
                        "and spans; 0 turns the exposition off)")
    p.add_argument("--attach", action="append", default=[],
                   metavar="HOST:PORT[:PROMPORT]",
                   help="attach to an already-running replica "
                        "(repeatable; reconnected but never respawned)")
    p.add_argument("--state-dir", default="router-state")
    p.add_argument("--knee-rps", type=float, default=0.0,
                   help="committed per-replica latency knee (req/s, "
                        "measured on the card) — with the scraped "
                        "service estimate it sets the spill limit")
    p.add_argument("--spill-inflight", type=int, default=0,
                   help="explicit per-replica in-flight spill limit "
                        "(overrides the knee-derived one)")
    p.add_argument("--retry-ratio", type=float, default=0.1)
    p.add_argument("--retry-cap", type=float, default=32.0)
    p.add_argument("--max-attempts", type=int, default=3)
    p.add_argument("--breaker-threshold", type=int, default=5)
    p.add_argument("--breaker-cooldown-s", type=float, default=1.0)
    p.add_argument("--ping-interval-s", type=float, default=0.25)
    p.add_argument("--ping-timeout-s", type=float, default=3.0)
    p.add_argument("--wedge-timeout-s", type=float, default=15.0)
    p.add_argument("--spawn-timeout-s", type=float, default=300.0)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--http-port", type=int, default=0,
                   help="HTTP front-end (tpuic/serve/http.py): POST "
                        "/predict with typed-verdict 429/503 mapping + "
                        "Retry-After, GET /healthz, GET /metrics. "
                        "0 disables; -1 binds a kernel-assigned port "
                        "(logged)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="interface for --http-port (loopback default — "
                        "unauthenticated; bind 0.0.0.0 only behind a "
                        "firewall/load balancer)")
    p.add_argument("--prom-port", type=int, default=0,
                   help="serve the router's own tpuic_router_* "
                        "/metrics exposition on this port (0 disables)")
    p.add_argument("--prom-host", default="127.0.0.1")
    p.add_argument("--prom-dump", default="",
                   help="write the router exposition here on shutdown")
    p.add_argument("--out", default="", help="output JSONL (default stdout)")
    args = p.parse_args(argv)

    attach = []
    for spec in args.attach:
        parts = spec.split(":")
        if len(parts) < 2:
            raise SystemExit(f"router: bad --attach {spec!r} "
                             "(expected HOST:PORT[:PROMPORT])")
        attach.append((parts[0], int(parts[1]),
                       int(parts[2]) if len(parts) > 2 else None))
    cmd = shlex.split(args.replica_cmd) if args.replica_cmd else None
    if not cmd and not attach:
        raise SystemExit("router: need --replica-cmd and/or --attach")

    import signal

    from tpuic_torch.runtime.preemption import PreemptionGuard
    from tpuic_torch.runtime.supervisor import (HeartbeatWriter,
                                          install_stack_dump_handler)
    from tpuic_torch.telemetry.prom import PromServer, router_exposition, \
        write_exposition
    guard = PreemptionGuard(signals=(signal.SIGTERM,)).install()
    heartbeat = HeartbeatWriter.from_env()
    if heartbeat is not None:
        install_stack_dump_handler()

    router = Router(
        replica_cmd=cmd, n_replicas=args.replicas, attach=attach,
        state_dir=args.state_dir, knee_rps=args.knee_rps,
        spill_inflight=args.spill_inflight, retry_ratio=args.retry_ratio,
        retry_cap=args.retry_cap, max_attempts=args.max_attempts,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        ping_interval_s=args.ping_interval_s,
        ping_timeout_s=args.ping_timeout_s,
        wedge_timeout_s=args.wedge_timeout_s,
        spawn_timeout_s=args.spawn_timeout_s,
        drain_timeout_s=args.drain_timeout)
    router.start()

    prom_server = None
    if args.prom_port:
        prom_server = PromServer(
            args.prom_port, lambda: router_exposition(router.snapshot()),
            host=args.prom_host)
        print(f"[router] prometheus /metrics on "
              f"{args.prom_host}:{prom_server.port}", file=sys.stderr)
    http_server = None
    if args.http_port:
        from tpuic_torch.serve.http import RouterHTTPServer
        http_server = RouterHTTPServer(router, port=max(0, args.http_port),
                                       host=args.http_host)
        print(f"[router] http front-end on "
              f"{args.http_host}:{http_server.port} "
              "(POST /predict, GET /healthz, GET /metrics)",
              file=sys.stderr)

    out = open(args.out, "w") if args.out else sys.stdout
    out_lock = threading.Lock()
    handle = make_line_handler(router, out, out_lock)

    try:
        pump_stdin(handle, guard,
                   beat=(heartbeat.beat if heartbeat is not None
                         else None))
    except KeyboardInterrupt:
        pass
    finally:
        guard.uninstall()
        stragglers = router.drain(args.drain_timeout)
        router.close(drain=False)
        if http_server is not None:
            http_server.close()
        if prom_server is not None:
            prom_server.close()
        if args.prom_dump:
            try:
                write_exposition(args.prom_dump,
                                 router_exposition(router.snapshot()))
            except OSError as e:
                print(f"[router] prom dump failed: {e}", file=sys.stderr)
        snap = router.snapshot()
        print(f"[router] done: {json.dumps(snap)}"
              + (f" ({stragglers} stragglers)" if stragglers else ""),
              file=sys.stderr)
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
