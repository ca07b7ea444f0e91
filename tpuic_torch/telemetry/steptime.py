"""Per-step wall-clock breakdown: data wait, dispatch and device (a port
of ``tpuic/telemetry/steptime.py``).

- **data wait**: time inside the loader iterator's ``__next__``
  (``wrap_epoch``), the first batch's device-cache upload included.
- **dispatch**: the ``train_step`` call.  PyTorch launches CUDA work
  asynchronously, so this is the host's time to enqueue the step: the
  Python of the forward, the backward's launches and the optimizer's.
- **device**: the residual of the step's wall time, dominated by the
  deferred log drain waiting on metric tensors (one interval behind, so
  the host is held to the card's speed) plus loop bookkeeping.

Everything is ``time.perf_counter`` arithmetic: no host sync and no
device work (``tests/test_torch_port_telemetry.py`` counts the reads
with telemetry on and off).

Every completed step publishes one ``step`` event: ``{step, total_ms,
data_ms, dispatch_ms, device_ms}``, ``tpuic``'s keys.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, Optional

from tpuic_torch.metrics.meters import LatencyMeter


class StepTimer:
    """Accumulates one step's phase timings and publishes the breakdown.

    Usage (``tpuic_torch/train/loop.py``)::

        timer.epoch_start()
        it = timer.wrap_epoch(loader.epoch(e))   # times __next__ = data wait
        for step, batch in enumerate(it):
            timer.dispatch_start()
            state, metrics = train_step(state, batch)   # async launches
            timer.dispatch_end()
            ...deferred drain, bookkeeping...
            timer.step_end(global_step)
    """

    def __init__(self, bus=None, window: int = 4096) -> None:
        if bus is None:
            from tpuic_torch.telemetry.events import bus as _global_bus
            bus = _global_bus
        self.bus = bus
        self.total = LatencyMeter(window)
        self.data_wait = LatencyMeter(window)
        self.dispatch = LatencyMeter(window)
        self.steps = 0
        self.last_step = 0  # last published global step number
        self._t_mark: Optional[float] = None
        self._data_s = 0.0
        self._dispatch_s = 0.0
        self._t_dispatch: Optional[float] = None

    # -- loop hooks ----------------------------------------------------
    def epoch_start(self) -> None:
        """Step-boundary reset: the first step's total is measured from
        here, so epoch setup (permutation, resident-cache upload inside
        the first ``__next__``) is attributed, not lost."""
        self._t_mark = time.perf_counter()
        self._data_s = 0.0
        self._dispatch_s = 0.0

    def wrap_epoch(self, it: Iterable) -> Iterator:
        """Pass-through iterator that accumulates time spent waiting on
        the loader into the upcoming step's data-wait."""
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self._data_s += time.perf_counter() - t0
            yield item

    def dispatch_start(self) -> None:
        self._t_dispatch = time.perf_counter()

    def dispatch_end(self) -> None:
        if self._t_dispatch is not None:
            self._dispatch_s += time.perf_counter() - self._t_dispatch
            self._t_dispatch = None

    def step_end(self, step: int) -> dict:
        """Close the step: compute the breakdown, publish the ``step``
        event, reset the accumulators.  Returns the breakdown dict."""
        now = time.perf_counter()
        if self._t_mark is None:
            self._t_mark = now
        total = max(0.0, now - self._t_mark)
        self._t_mark = now
        data = min(self._data_s, total)
        disp = min(self._dispatch_s, max(0.0, total - data))
        device = max(0.0, total - data - disp)
        self._data_s = 0.0
        self._dispatch_s = 0.0
        self.steps += 1
        self.last_step = int(step)
        self.total.update(total)
        self.data_wait.update(data)
        self.dispatch.update(disp)
        out = {"step": int(step),
               "total_ms": round(1000.0 * total, 3),
               "data_ms": round(1000.0 * data, 3),
               "dispatch_ms": round(1000.0 * disp, 3),
               "device_ms": round(1000.0 * device, 3)}
        self.bus.publish("step", **out)
        return out

    # -- reads ---------------------------------------------------------
    def mean_total_s(self) -> float:
        return self.total.total / self.total.count if self.total.count else 0.0

    def summary(self) -> dict:
        """Percentile summary over the window (shared-meter semantics:
        recent behavior, not lifetime)."""
        return {
            "steps": self.steps,
            "total_ms": self.total.percentiles_ms(),
            "data_ms": self.data_wait.percentiles_ms(),
            "dispatch_ms": self.dispatch.percentiles_ms(),
            "data_frac": (round(self.data_wait.total
                                / max(self.total.total, 1e-12), 4)
                          if self.total.count else None),
        }
