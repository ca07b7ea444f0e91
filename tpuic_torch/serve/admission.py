"""SLA-aware admission control for the serve tier (copy of
``tpuic/serve/admission.py``; stdlib only).

- **Priority classes** (:data:`PRIORITIES`): ``high``/``normal``/``low``.
  The engine's queue pops higher classes first (FIFO within a class),
  and a full queue *evicts* the youngest lowest-priority request to
  admit a strictly-higher-priority arrival: under overload the flood is
  what waits (or sheds), never the traffic with an SLO.
- **Typed verdicts**: every rejection is an :class:`AdmissionRejected`
  (or :class:`DeadlineExceeded` for pop-time sheds) carrying ``cause``
  (``queue_full|deadline|quota|brownout``), ``priority`` and ``tenant``,
  the same labels ``ServeStats.rejected_by`` counts under, so a caller's
  error handling and the operator's counters speak one vocabulary.
  ``replica_lost`` and ``swap_corrupt``/``swap_accuracy`` are the router's
  and the hot-swap gate's verdicts.
- **Deadline-aware shedding**: ``submit(deadline_ms=...)`` stamps an
  absolute deadline; at *pop* time the batcher sheds any request whose
  deadline has already expired (or will, within the span ledger's
  rolling estimate of remaining service time).  Batchmates are
  untouched.
- **Per-tenant token-bucket quotas** with a shared free pool: each
  configured tenant refills at its own req/s; a dry tenant (and any
  unconfigured tenant) falls through to the ``*`` pool when one is
  configured.  No pool configured = unconfigured tenants are unlimited.
- **Brownout** (:class:`BrownoutController`): sheds one priority class
  per SLO report whose error-budget burn rate crosses ``tighten_above``
  (the highest class is never shed), and recovers one level after
  ``recover_after`` consecutive reports at or below ``recover_below``.
  ``attach(bus)`` takes any object with ``subscribe`` (and ``publish``);
  the serve CLI refuses ``--brownout-*`` until the port has SLOs.

Everything here is host-side arithmetic on monotonic clocks: no device
work.  Names and clocks are ``tpuic``'s, so one sequence drives both
copies to the same decisions.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional, Tuple

# Highest class first.  Index = strictness: brownout level L sheds the L
# lowest classes; the queue pops lower indices first.
PRIORITIES: Tuple[str, ...] = ("high", "normal", "low")
_PRIORITY_INDEX = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "normal"

# The typed rejection vocabulary — exactly the causes the split
# rejected_total counter and the prom rows are labeled with.
# ``replica_lost`` is the routing tier's verdict (tpuic/serve/router.py):
# the replica serving a request died and the request could not be safely
# replayed (non-idempotent, retries exhausted, or the retry budget dry).
# ``swap_corrupt``/``swap_accuracy`` are the model-lifecycle tier's
# verdicts: a hot-swap CANDIDATE
# refused at the pre-flip gate — failed the checkpoint CRC/manifest
# integrity ladder, or failed the pinned-eval accuracy gate — so a bad
# artifact never reaches traffic.  They label the refused swap request,
# never serving traffic.
CAUSES: Tuple[str, ...] = ("queue_full", "deadline", "quota", "brownout",
                           "replica_lost", "swap_corrupt", "swap_accuracy")

# The --quota spec key for the shared free pool.
FREE_POOL = "*"


def priority_index(priority: str) -> int:
    """Validated index of ``priority`` in :data:`PRIORITIES`."""
    try:
        return _PRIORITY_INDEX[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority {priority!r} "
            f"(known: {', '.join(PRIORITIES)})") from None


class AdmissionError(RuntimeError):
    """Base of every typed admission verdict: ``cause`` names why
    (one of :data:`CAUSES`), ``priority``/``tenant`` name who."""

    def __init__(self, message: str, *, cause: str,
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        super().__init__(message)
        self.cause = cause
        self.priority = priority
        self.tenant = tenant


class AdmissionRejected(AdmissionError, queue.Full):
    """Submit-time rejection (queue_full / quota / brownout) — also a
    ``queue.Full`` so pre-admission callers that handled backpressure
    with ``except queue.Full`` keep working unchanged."""


class DeadlineExceeded(AdmissionError):
    """Pop-time shed: the request's deadline expired (or would, within
    the estimated remaining service time) before it reached a batch
    slot.  Set on the request's future by the batcher."""

    def __init__(self, message: str, *, priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        super().__init__(message, cause="deadline", priority=priority,
                         tenant=tenant)


class ReplicaLost(AdmissionError):
    """Routing-tier verdict (tpuic/serve/router.py): the replica holding
    this request died (or wedged past the watchdog) and the request was
    NOT replayed — it was non-idempotent, its retry attempts were
    exhausted, or the global retry budget was dry (a storm of failovers
    must not amplify into a retry storm).  At-most-once delivery holds:
    a ``replica_lost`` verdict means the caller may safely retry
    end-to-end, knowing the router never emitted a response for it."""

    def __init__(self, message: str, *, priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        super().__init__(message, cause="replica_lost", priority=priority,
                         tenant=tenant)


class SwapRejected(AdmissionError):
    """Swap-time gate verdict: a hot-swap candidate was refused BEFORE
    the weight flip — it never served a request.  ``cause`` is
    ``swap_corrupt`` (the candidate failed the checkpoint CRC/manifest
    integrity check: missing, manifest-less, or bytes that don't match
    their recorded checksums)
    or ``swap_accuracy`` (the candidate failed the pinned-eval gate:
    non-finite outputs, or a dtype-ladder rung disagreeing with the
    candidate's own fp32 past the committed epsilon).  The incumbent
    keeps serving untouched — refusal is always zero-downtime."""

    def __init__(self, message: str, *, cause: str = "swap_corrupt",
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        if cause not in ("swap_corrupt", "swap_accuracy"):
            raise ValueError(f"SwapRejected cause must be swap_corrupt or "
                             f"swap_accuracy, got {cause!r}")
        super().__init__(message, cause=cause, priority=priority,
                         tenant=tenant)


class Decision:
    """One admission verdict: ``admit`` or the rejecting ``cause``."""

    __slots__ = ("admit", "cause")

    def __init__(self, admit: bool, cause: Optional[str] = None) -> None:
        self.admit = admit
        self.cause = cause

    def __bool__(self) -> bool:
        return self.admit


_ADMIT = Decision(True)


class TokenBucket:
    """Classic token bucket on the monotonic clock: refills at ``rate``
    tokens/sec up to ``burst`` (default: one second of rate, min 1), so
    a tenant can spike briefly but sustains exactly its quota.

    ``clock`` is injectable for deterministic refill-math tests.  Not
    internally locked — the AdmissionController serializes access."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if rate <= 0:
            raise ValueError(f"token-bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.capacity = float(burst) if burst is not None \
            else max(1.0, self.rate)
        if self.capacity <= 0:
            raise ValueError("token-bucket burst must be > 0")
        self._clock = clock
        self.tokens = self.capacity  # start full: a fresh tenant may burst
        self._t = self._clock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens if available; False (taking nothing) when
        the bucket is dry — never goes negative, never blocks."""
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


def parse_quotas(specs) -> Dict[str, float]:
    """``['tenantA=50', '*=200']`` (or one comma list) -> {tenant: rps}.

    ``*`` is the shared free pool.  Malformed specs raise ValueError up
    front — a typo'd quota that silently never applies would read as
    "unlimited" exactly when you meant to cap someone."""
    out: Dict[str, float] = {}
    if isinstance(specs, str):
        specs = specs.split(",")
    for raw in specs or ():
        for spec in str(raw).split(","):
            spec = spec.strip()
            if not spec:
                continue
            tenant, sep, rate = spec.partition("=")
            tenant = tenant.strip()
            try:
                rps = float(rate)
            except ValueError:
                rps = -1.0
            if not sep or not tenant or rps <= 0:
                raise ValueError(
                    f"bad quota spec {spec!r} (expected tenant=rps with "
                    f"rps > 0, '{FREE_POOL}' for the shared free pool)")
            if tenant in out:
                raise ValueError(f"duplicate quota for tenant {tenant!r}")
            out[tenant] = rps
    return out


class BrownoutController:
    """SLO-coupled progressive load shedding with hysteresis.

    Subscribes to the bus's ``slo`` events (``tpuic``'s SLO tracker publishes
    one per objective every ``publish_every`` samples); reacts only to
    the named objective.  State machine over ``level`` in
    ``0..max_level`` (``max_level`` < len(PRIORITIES), so the highest
    class is never shed):

    - ``burn_rate >= tighten_above``  -> level += 1 (immediately, one
      class per report — progressive, not cliff-edge)
    - ``burn_rate <= recover_below`` for ``recover_after`` consecutive
      reports -> level -= 1 (the hysteresis band between the two
      thresholds holds the level steady)

    Every transition publishes an ``admission`` event (level, burn rate,
    direction) so the JSONL/TensorBoard record shows when and why the
    tier browned out.  Thread-safe: slo events arrive from whatever
    thread published the underlying latency sample, while ``sheds()``
    is read on the submit path."""

    def __init__(self, slo_name: str, *, tighten_above: float = 2.0,
                 recover_below: float = 1.0, recover_after: int = 3,
                 max_level: int = len(PRIORITIES) - 1,
                 publish=None) -> None:
        if not slo_name:
            raise ValueError("brownout needs the name of an SLO objective")
        if recover_below > tighten_above:
            raise ValueError(
                f"recover_below ({recover_below}) must not exceed "
                f"tighten_above ({tighten_above}) — the band between "
                "them is the hysteresis")
        self.slo_name = slo_name
        self.tighten_above = float(tighten_above)
        self.recover_below = float(recover_below)
        self.recover_after = max(1, int(recover_after))
        self.max_level = max(0, min(int(max_level), len(PRIORITIES) - 1))
        self._publish = publish
        self._lock = threading.Lock()
        self._level = 0
        self._good_streak = 0
        self.transitions = 0

    @property
    def level(self) -> int:
        return self._level

    def sheds(self, priority: str) -> bool:
        """Whether the current level sheds ``priority`` (level L sheds
        the L lowest classes)."""
        return priority_index(priority) >= len(PRIORITIES) - self._level

    def attach(self, bus) -> Callable[[], None]:
        """Subscribe to ``bus`` for ``slo`` events; transitions publish
        ``admission`` events back to the same bus.  Returns the
        unsubscribe callable."""
        if self._publish is None:
            self._publish = bus.publish
        return bus.subscribe(self.on_event, kinds=("slo",))

    def on_event(self, ev) -> None:
        """One SLO report for the coupled objective -> maybe transition."""
        if ev.data.get("name") != self.slo_name:
            return
        burn = ev.data.get("burn_rate")
        if burn is None:
            return
        self.observe(float(burn))

    def observe(self, burn_rate: float) -> None:
        """Feed one burn-rate sample through the state machine (the
        event-free entry point tests and pollers use)."""
        action = None
        with self._lock:
            if burn_rate >= self.tighten_above:
                self._good_streak = 0
                if self._level < self.max_level:
                    self._level += 1
                    action = "tighten"
            elif burn_rate <= self.recover_below:
                self._good_streak += 1
                if (self._good_streak >= self.recover_after
                        and self._level > 0):
                    self._level -= 1
                    self._good_streak = 0
                    action = "recover"
            else:
                # Inside the hysteresis band: hold the level, and a
                # recovery streak does not survive a band excursion.
                self._good_streak = 0
            level = self._level
        if action is not None:
            self.transitions += 1
            if self._publish is not None:
                self._publish("admission", action=action, level=level,
                              slo=self.slo_name,
                              burn_rate=round(burn_rate, 4),
                              sheds=[p for p in PRIORITIES
                                     if priority_index(p)
                                     >= len(PRIORITIES) - level])

    def state(self) -> dict:
        """JSON-able snapshot for the exit summary / prom exposition."""
        with self._lock:
            return {"slo": self.slo_name, "level": self._level,
                    "max_level": self.max_level,
                    "tighten_above": self.tighten_above,
                    "recover_below": self.recover_below,
                    "transitions": self.transitions}


class AdmissionController:
    """Submit-time admission: brownout class shedding, then per-tenant
    token-bucket quotas with the shared free pool.

    The controller sits *in front of* the engine's queue (the engine
    consults it before the put); queue-full itself stays the engine's
    verdict because only the queue knows.  ``admit()`` is one lock, two
    dict lookups and at most two bucket refills — cheap enough for the
    submit hot path, and it touches no device state ever."""

    def __init__(self, quotas: Optional[Dict[str, float]] = None,
                 brownout: Optional[BrownoutController] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        quotas = dict(quotas or {})
        self._lock = threading.Lock()
        self.brownout = brownout
        pool_rate = quotas.pop(FREE_POOL, None)
        self._pool = (TokenBucket(pool_rate, clock=clock)
                      if pool_rate is not None else None)
        self._buckets = {t: TokenBucket(r, clock=clock)
                         for t, r in quotas.items()}

    def admit(self, *, priority: str = DEFAULT_PRIORITY,
              tenant: Optional[str] = None) -> Decision:
        """Verdict for one arriving request.  Never blocks."""
        priority_index(priority)  # validate early, typed error
        if self.brownout is not None and self.brownout.sheds(priority):
            return Decision(False, "brownout")
        with self._lock:
            bucket = self._buckets.get(tenant) if tenant else None
            if bucket is not None:
                if bucket.try_take():
                    return _ADMIT
                # Dry tenant bucket: borrow from the shared pool when
                # one exists — a quota is a guarantee floor, not a cap,
                # as long as spare capacity is pooled.
                if self._pool is not None and self._pool.try_take():
                    return _ADMIT
                return Decision(False, "quota")
            if self._pool is not None:
                # Unconfigured tenant (or no tenant): the free pool is
                # the only thing between it and the queue.
                if self._pool.try_take():
                    return _ADMIT
                return Decision(False, "quota")
            return _ADMIT

    def state(self) -> dict:
        """JSON-able snapshot: per-tenant tokens + brownout state.
        Buckets refill lazily (inside ``try_take``), so reads refill
        first — a dry bucket with no traffic since must not scrape as
        permanently out of quota."""
        with self._lock:
            for b in self._buckets.values():
                b._refill()
            if self._pool is not None:
                self._pool._refill()
            tenants = {t: round(b.tokens, 2)
                       for t, b in self._buckets.items()}
            pool = round(self._pool.tokens, 2) if self._pool else None
        return {"tenant_tokens": tenants, "free_pool_tokens": pool,
                "brownout": (self.brownout.state()
                             if self.brownout is not None else None)}
