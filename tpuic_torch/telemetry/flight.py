"""Crash flight recorder: the last N events, dumped when the process
dies (a copy of ``tpuic/telemetry/flight.py``).

The supervisor's hang escalation (``runtime/supervisor.py``) captures
*where* a wedged child is stuck: SIGQUIT makes faulthandler write every
thread's stack.  This module records *what happened on the way in*: a
bounded ring of bus events (``serve_batch``, ``admission``, ``slo``,
``swap``, ...), dumped as JSONL next to the stack dump when the process is
killed or dies with an unhandled exception.

- The supervisor sets ``TPUIC_FLIGHT_DUMP`` to
  ``<state_dir>/flightdump-<attempt>.jsonl`` per attempt;
  :func:`install_flight_recorder` (called by ``python -m
  tpuic_torch.serve``) reads it, subscribes a :class:`FlightRecorder` to
  the process-global bus, and registers the dump on SIGQUIT and on
  unhandled exceptions.  Unsupervised processes get ``None`` and pay
  nothing.
- **Order matters**: the Python SIGQUIT handler is registered *before*
  ``install_stack_dump_handler(chain=True)``, which saves it and runs it
  after the C-level stack dump.  One SIGQUIT then yields stacks (always)
  plus the event timeline (whenever the main thread still executes
  bytecode: every sleep- or IO-shaped hang).
- The dump is written atomically (tmp + rename) and ends with a trailer
  record ``{"event": "flight_dump", "t", "reason", "events", "pid"}``.

Everything here is stdlib-only host code: recording an event is one
deque append under a lock.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional


class FlightRecorder:
    """Bounded ring of the last ``capacity`` bus events + dump-on-demand.

    A bus sink (``bus.subscribe(recorder)``); thread-safe — events
    arrive from the train loop, the serve batcher, and producer threads
    alike.  ``dump()`` snapshots the ring and writes it as JSONL; it is
    safe to call from a signal handler (plain file I/O only — no locks,
    no bus publishing; see its docstring).

    ``exclude_kinds`` (default: ``serve_span``) drops per-request
    firehose kinds from the ring: at a few hundred rps, spans would
    evict the coarse timeline (serve_batch/admission/slo/memory) within
    seconds — exactly the longer-horizon record the dump exists for.
    Aggregate span percentiles are already in the stats snapshot.
    """

    def __init__(self, path: str, capacity: int = 1024,
                 exclude_kinds=("serve_span",)) -> None:
        self.path = path
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._exclude = frozenset(exclude_kinds or ())
        self.dumps = 0

    def __call__(self, ev) -> None:
        if ev.kind in self._exclude:
            return
        with self._lock:
            self._ring.append((ev.kind, ev.time, ev.data))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def subscribe(self, bus):
        """Subscribe to every kind on ``bus`` (the exclusion list is
        applied at record time, so unregistered/custom kinds are still
        captured).  Returns the unsubscribe callable."""
        return bus.subscribe(self)

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write the ring as JSONL to ``self.path`` (atomic), ending
        with the ``flight_dump`` trailer record; returns the path.
        Never raises — a failing dump must not mask the signal or the
        exception that triggered it.

        Deliberately LOCK-FREE and BUS-FREE: the SIGQUIT handler runs
        on the main thread, which may have been interrupted *inside*
        ``__call__`` (or any other sink's ``__call__``) with a
        non-reentrant lock held — taking ``self._lock`` here, or
        publishing an announcement event back through the bus into
        those same sinks, would deadlock exactly when the dump matters
        most.  ``list(deque)`` is a single C-level call that never
        releases the GIL, so the snapshot is safe against both producer
        threads and the interrupted frame; the trailer record in the
        file IS the announcement."""
        events = list(self._ring)
        trailer = {"event": "flight_dump", "t": round(time.time(), 6),
                   "reason": reason, "events": len(events),
                   "pid": os.getpid()}
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                for kind, t, data in events:
                    f.write(json.dumps({"event": kind, "t": round(t, 6),
                                        **data}, default=str) + "\n")
                f.write(json.dumps(trailer) + "\n")
            os.replace(tmp, self.path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self.dumps += 1
        return self.path

    # -- triggers -------------------------------------------------------
    def install_signal_handler(self) -> bool:
        """Dump on SIGQUIT, then chain to whatever Python-level handler
        was there before (none, usually — faulthandler registers at the
        C level and is not visible here).  Main-thread only; returns
        False when registration is impossible."""
        if not hasattr(signal, "SIGQUIT"):
            return False
        prev = signal.getsignal(signal.SIGQUIT)

        def _on_sigquit(signum, frame):
            self.dump(reason="sigquit")
            if callable(prev):
                try:
                    prev(signum, frame)
                except Exception:
                    pass

        try:
            signal.signal(signal.SIGQUIT, _on_sigquit)
        except (ValueError, OSError):  # non-main thread / exotic platform
            return False
        return True

    def install_excepthook(self) -> None:
        """Dump on a fatal (unhandled) exception, then defer to the
        previous excepthook — the crash report itself is untouched."""
        prev = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.dump(reason=f"unhandled:{exc_type.__name__}")
            prev(exc_type, exc, tb)

        sys.excepthook = _hook


def install_flight_recorder(bus=None, capacity: int = 1024
                            ) -> Optional[FlightRecorder]:
    """The one-call wiring for supervised entry points (``python -m
    tpuic_torch.serve``): when the supervisor set
    ``TPUIC_FLIGHT_DUMP``, build a recorder on the process-global bus,
    register the SIGQUIT + excepthook dumps, and return it.  Call
    ``install_stack_dump_handler(chain=True)`` *after* this so the
    faulthandler stack dump chains into the flight dump.  Returns None
    (and installs nothing) unsupervised."""
    from tpuic_torch.runtime.supervisor import ENV_FLIGHT_DUMP
    path = os.environ.get(ENV_FLIGHT_DUMP, "")
    if not path:
        return None
    if bus is None:
        from tpuic_torch.telemetry.events import bus as _bus
        bus = _bus
    rec = FlightRecorder(path, capacity=capacity)
    rec.subscribe(bus)
    rec.install_signal_handler()
    rec.install_excepthook()
    return rec
