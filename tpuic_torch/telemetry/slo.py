"""SLO accounting: latency objectives, rolling attainment, error budgets
(a copy of ``tpuic/telemetry/slo.py``).

Latency *percentiles* say "p99 is 38 ms"; this module gives them
*objectives* — the difference between "p99 is 38 ms" and "p99 must stay
under 50 ms, and we are burning error budget 2.1x faster than allowed".
An objective is a threshold on a latency metric plus an attainment
target::

    serve_latency:p99<=50ms          # implies target 0.99 (from p99)
    train_step:p50<=400ms@0.95       # explicit attainment target

Semantics (the standard SRE framing, over a rolling window):

- **attainment** — fraction of samples meeting the threshold.  "p99 <=
  50 ms" is exactly "99% of requests finish within 50 ms", so the
  quantile in the spec doubles as the default target.
- **error budget** — the allowed violation fraction, ``1 - target``.
- **burn rate** — observed violation fraction / budget.  1.0 means the
  objective is being missed at exactly the allowed rate; 2.0 means the
  budget will be exhausted in half the window.
- **budget_remaining** — ``1 - burn_rate`` over the window (negative
  when the objective is blown; a scraper alerts on it crossing 0).

The tracker subscribes to the event bus: ``serve_latency`` objectives
consume the per-request ``serve_span`` events (the port's engine does
not publish them yet), ``train_step`` objectives consume the ``step``
events the StepTimer already publishes.  Everything is host-side
arithmetic on event payloads: no device sync.  Quantile reads are the
pinned nearest-rank helper (``tpuic_torch.metrics.meters.quantile``).

Exposure: ``report()`` feeds ``prom.slo_rows``, and every ``publish_every``
samples per objective the tracker publishes an ``slo`` event (JSONL /
TensorBoard scalars via the existing sinks).
"""

from __future__ import annotations

import dataclasses
import re
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from tpuic_torch.metrics.meters import quantile, quantile_label

# metric name -> (event kind, payload field carrying milliseconds)
METRIC_EVENTS: Dict[str, Tuple[str, str]] = {
    "serve_latency": ("serve_span", "total_ms"),
    "train_step": ("step", "total_ms"),
}

_SPEC_RE = re.compile(
    r"^(?P<metric>[a-z_]+):p(?P<q>[0-9.]+)<=(?P<thresh>[0-9.]+)ms"
    r"(?:@(?P<target>[0-9.]+))?$")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One latency objective: ``quantile`` of ``metric`` must stay under
    ``threshold_ms``, i.e. a ``target`` fraction of samples meet it."""
    metric: str          # key of METRIC_EVENTS
    quantile: float      # e.g. 99.0 — also the default target (0.99)
    threshold_ms: float
    target: float        # attainment target in (0, 1)
    name: str = ""       # exposition label; defaulted from the fields

    def __post_init__(self):
        if self.metric not in METRIC_EVENTS:
            raise ValueError(
                f"unknown SLO metric {self.metric!r} "
                f"(known: {', '.join(sorted(METRIC_EVENTS))})")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {self.target}")
        if self.threshold_ms <= 0:
            raise ValueError("SLO threshold must be positive")
        if not self.name:
            object.__setattr__(
                self, "name",
                f"{self.metric}_{quantile_label(self.quantile)}")


def parse_objective(spec: str,
                    allowed: Optional[Sequence[str]] = None) -> Objective:
    """``metric:pQ<=Nms[@target]`` -> Objective (see module docstring).

    The quantile implies the default target (p99 -> 0.99); ``@target``
    overrides it.  Malformed specs raise ValueError naming the grammar —
    a typo'd SLO that silently never tracks would read as "no
    violations".  ``allowed`` restricts the metric to the ones the
    calling process actually emits: a serve_latency objective in a
    train process would subscribe to ``serve_span`` events that never
    fire and read as a silently dead SLO, so every construction point
    (train.py / TrainTelemetry / ``python -m tpuic.serve``) passes its
    own list and the mismatch fails up front."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad SLO spec {spec!r} (expected metric:pQ<=Nms[@target], "
            f"e.g. serve_latency:p99<=50ms@0.99; metrics: "
            f"{', '.join(sorted(METRIC_EVENTS))})")
    q = float(m.group("q"))
    target = (float(m.group("target")) if m.group("target")
              else q / 100.0)
    obj = Objective(metric=m.group("metric"), quantile=q,
                    threshold_ms=float(m.group("thresh")), target=target)
    if allowed is not None and obj.metric not in allowed:
        raise ValueError(
            f"objective {obj.name!r} tracks {obj.metric!r}, which this "
            f"process never emits (emitted here: "
            f"{', '.join(sorted(allowed))}) — it would record nothing, "
            "forever")
    return obj


def parse_objectives(specs: str,
                     allowed: Optional[Sequence[str]] = None
                     ) -> List[Objective]:
    """Comma list of specs -> objectives (empty string -> []);
    ``allowed`` as in :func:`parse_objective`."""
    return [parse_objective(s, allowed=allowed)
            for s in specs.split(",") if s.strip()]


class _ObjState:
    __slots__ = ("met", "samples_win", "samples", "violations")

    def __init__(self, window: int) -> None:
        self.met: deque = deque(maxlen=window)        # bool per sample
        self.samples_win: deque = deque(maxlen=window)  # ms per sample
        self.samples = 0       # lifetime
        self.violations = 0    # lifetime


class SLOTracker:
    """Rolling attainment/burn-rate accounting over bus events.

    Thread-safe: serve spans arrive from the batcher thread while step
    events come from the train loop.  ``attach(bus)`` subscribes to
    exactly the event kinds the configured objectives need (which is
    also what turns per-request span publishing on in the serve engine)
    and returns an unsubscribe callable.
    """

    def __init__(self, objectives: Sequence[Objective], *,
                 window: int = 1024, publish_every: int = 64,
                 publish=None) -> None:
        if not objectives:
            raise ValueError("SLOTracker needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.objectives = tuple(objectives)
        self._window = max(1, int(window))
        self._publish_every = max(1, int(publish_every))
        self._publish = publish
        self._lock = threading.Lock()
        self._state = {o.name: _ObjState(self._window)
                       for o in self.objectives}
        # event kind -> [(field, objective)] — one dict lookup per event.
        self._by_kind: Dict[str, List[Tuple[str, Objective]]] = {}
        for o in self.objectives:
            kind, field = METRIC_EVENTS[o.metric]
            self._by_kind.setdefault(kind, []).append((field, o))

    def kinds(self) -> Tuple[str, ...]:
        """The event kinds the configured objectives consume."""
        return tuple(self._by_kind)

    def attach(self, bus):
        """Subscribe to ``bus`` for exactly the kinds needed; defaults
        the ``slo``-event publisher to the same bus.  Returns the
        unsubscribe callable."""
        if self._publish is None:
            self._publish = bus.publish
        return bus.subscribe(self.on_event, kinds=self.kinds())

    # -- event intake ---------------------------------------------------
    def on_event(self, ev) -> None:
        matches = self._by_kind.get(ev.kind)
        if not matches:
            return
        pending = []
        with self._lock:
            for field, obj in matches:
                v = ev.data.get(field)
                if v is None:
                    continue
                ms = float(v)
                st = self._state[obj.name]
                ok = ms <= obj.threshold_ms
                st.met.append(ok)
                st.samples_win.append(ms)
                st.samples += 1
                if not ok:
                    st.violations += 1
                if st.samples % self._publish_every == 0:
                    pending.append(self._obj_report(obj, st))
        # Publish OUTSIDE the lock: sinks may be slow, and a sink that
        # re-enters the tracker (another slo subscriber) must not
        # deadlock.  The bus itself is re-entrancy-safe.
        if self._publish is not None:
            for rep in pending:
                self._publish("slo", **rep)

    # -- reads ----------------------------------------------------------
    def _obj_report(self, obj: Objective, st: _ObjState) -> dict:
        n = len(st.met)
        att = (sum(st.met) / n) if n else None
        budget = 1.0 - obj.target
        burn = None if att is None else (1.0 - att) / budget
        cur = (round(quantile(st.samples_win, obj.quantile), 3)
               if n else None)
        return {
            "name": obj.name, "metric": obj.metric,
            "quantile": obj.quantile,
            "threshold_ms": obj.threshold_ms, "target": obj.target,
            "samples": st.samples, "window_samples": n,
            "attainment": None if att is None else round(att, 6),
            "current_ms": cur,
            "burn_rate": None if burn is None else round(burn, 4),
            "budget_remaining": (None if burn is None
                                 else round(1.0 - burn, 4)),
        }

    def burn_rate(self, name: str) -> Optional[float]:
        """Current rolling burn rate of the named objective (None until
        it has samples) — the poll-side twin of the ``slo`` events the
        brownout controller (tpuic/serve/admission.py) consumes.  Raises
        KeyError for an unknown name: a brownout coupled to an objective
        this tracker doesn't carry would silently never tighten."""
        for obj in self.objectives:
            if obj.name == name:
                with self._lock:
                    return self._obj_report(
                        obj, self._state[obj.name])["burn_rate"]
        raise KeyError(
            f"no SLO objective named {name!r} "
            f"(configured: {', '.join(o.name for o in self.objectives)})")

    def report(self) -> dict:
        """{"objectives": [per-objective dicts]} — feed prom.slo_rows."""
        with self._lock:
            return {"objectives": [
                self._obj_report(o, self._state[o.name])
                for o in self.objectives]}

    def summary_line(self) -> str:
        """One log line: per objective, attainment vs target and burn."""
        parts = []
        for obj in self.report()["objectives"]:
            if obj["attainment"] is None:
                parts.append(f"{obj['name']}: no samples")
                continue
            parts.append(
                f"{obj['name']}: {100 * obj['attainment']:.2f}% "
                f"<= {obj['threshold_ms']:g}ms (target "
                f"{100 * obj['target']:g}%, burn {obj['burn_rate']:.2f}x)")
        return "; ".join(parts)
