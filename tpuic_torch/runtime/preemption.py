"""Graceful-preemption latch (``tpuic/runtime/preemption.py``, copied).

SIGTERM (by default) sets a flag instead of killing the process; the
serve CLI polls it between requests, stops accepting, drains what is in
flight for ``--drain-timeout`` seconds and exits 0, and the ``Trainer``
polls it between steps, flushes a step-exact ``latest`` checkpoint and
returns (the train CLI then exits 43).  The handler only records; the
loop acts, so no work runs inside a signal handler.

:func:`agree` is ``tpuic``'s cross-host OR of the latch, as a collective:
one all-reduce (MAX) of a one-element flag over the default process
group, so every process takes the same decision at the same step.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Iterable, Optional


class PreemptionGuard:
    """Installable SIGTERM (by default) latch.

    Usage::

        guard = PreemptionGuard().install()
        ...
        if guard.triggered:  # between steps / epochs
            save_and_exit()

    ``install`` chains any previously-installed handler (so outer runtimes
    still observe the signal) and is a no-op off the main thread, where
    CPython forbids signal.signal.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)) -> None:
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}
        self._installed = False
        # Wall clock (time.time()) of the first trip of this span: the
        # start of the flush window a preempted run reports.
        self.triggered_at: Optional[float] = None

    def _handler(self, signum, frame):
        self._mark()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if not self._installed:
            # Fresh span: a latch left set by a PREVIOUS install/uninstall
            # span (fit() N-1's SIGTERM — uninstall deliberately leaves the
            # flag readable so callers can branch on it post-span) must not
            # make a reused guard report 'triggered' at step 0 of the next
            # fit(). Cleared only when beginning a new span — a trigger()
            # fired after install() (cooperative shutdown, tests) survives
            # the re-entrant install() calls an installed guard sees.
            self._event.clear()
            self.triggered_at = None
            # Span state is marked BEFORE the thread check: off the main
            # thread no handler can be registered, but the span is still
            # begun — otherwise every re-entrant install() there would
            # re-run the clear above and wipe a cooperative trigger().
            self._installed = True
        # Handler registration is tracked separately (by _prev) from the
        # span flag: a span begun off the main thread still gets its
        # handlers when a later install() runs ON the main thread — e.g.
        # a guard constructed in a worker and handed to fit() — without
        # re-clearing a latch set in between.
        if self._prev or threading.current_thread() is not threading.main_thread():
            return self  # registered already / signal.signal would raise
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # exotic embedding; stay inert
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Programmatic trip (tests; cooperative shutdown)."""
        self._mark()

    def _mark(self) -> None:
        if self.triggered_at is None:
            self.triggered_at = time.time()
        self._event.set()


def agree(flag: bool) -> bool:
    """The OR of every process's ``flag`` (``tpuic``'s ``agree``).

    A scheduler delivers SIGTERM to each process on its own, at slightly
    different times or to a subset: a process that acted on its local
    latch alone would leave the step loop while the others enter the next
    step's collectives, and the group would hang for the whole grace
    window.  So the loop acts on the latch only at boundaries every
    process reaches together, through this call: one all-reduce (MAX) of
    a one-element flag over the default process group, on the group's
    device (the card under NCCL, the CPU under gloo).  Every process must
    call it at the same point.  Without a group, or in a group of one,
    there is no collective and the flag comes back as it is."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
