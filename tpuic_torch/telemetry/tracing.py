"""Triggered ``torch.profiler`` traces: capture the regression, not the
baseline (a port of ``tpuic/telemetry/tracing.py``).

``TraceTrigger`` watches step totals (the ``step`` events the StepTimer
publishes) and opens a bounded profiler window when a step regresses
past ``threshold`` x the rolling median:

- **Trigger**: after ``warmup`` observed steps, a step whose total
  exceeds ``threshold x median(recent window)`` starts a window over the
  next ``trace_steps`` steps.
- **Manual**: ``TPUIC_TRACE=dir`` forces one window at once.
- **Bounded**: each window writes ``trace_dir/trace-NNNN-<time>/trace.json``
  (a Chrome trace: ``torch.profiler``'s CPU ops and, on the card, its
  CUDA runtime calls and kernels); at most ``keep`` are retained, oldest
  first.
- **Cooldown**: after a window the trigger sleeps ``cooldown`` steps.
- Every transition publishes a ``trace`` event (``action``:
  started/stopped/error, ``path``, ``reason``/``ratio``).
- **on_capture**: called with the window's directory after it closes
  (the device-time analyzer, ``telemetry/profile.py``, hangs here); a
  hook failure publishes ``action: analyze_error`` and the trigger keeps
  capturing.

While another profiler session records (``--profile-dir``'s first
epoch) the trigger waits; a profiler that cannot start is published as
an error and disables the trigger.  No window open, the
trigger is ``perf_counter`` arithmetic on the step events: no sync and
no device work.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import statistics
import time
from collections import deque
from typing import Optional

TRACE_FILE = "trace.json"


def start_profiler():
    """A started ``torch.profiler.profile`` over the CPU and, when a card
    is present, CUDA (kernels and runtime calls).

    Unless the environment says otherwise, CUPTI is torn down when the
    session stops (``TEARDOWN_CUPTI=1``): left attached, it taxes every
    later kernel launch, and a launch-bound step (InceptionV3's bf16
    step, ~11,800 kernels) ran 1.3-1.4x slower after a window for the
    rest of the run.  Teardown is for processes without CUDA graphs (the
    trainer's); torch's own profiler turns it off under inductor's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def profiler_on() -> bool:
    """True while a ``torch.profiler`` session is recording (the fit-level
    ``--profile-dir`` trace's, say)."""
    try:
        import torch
        return bool(torch._C._autograd._profiler_enabled())
    except Exception:
        return False


def scope(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records
    (the layer ``profile.parse_trace`` rolls a kernel's time up to), else
    a context that does nothing."""
    if profiler_on():
        import torch
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def stop_profiler(prof, path: str) -> str:
    """Stop ``prof`` and write its Chrome trace into the directory
    ``path``; returns the file."""
    prof.stop()
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, TRACE_FILE)
    prof.export_chrome_trace(out)
    return out


class TraceTrigger:
    def __init__(self, trace_dir: str, threshold: float = 3.0,
                 window: int = 64, warmup: int = 5, trace_steps: int = 3,
                 keep: int = 4, cooldown: int = 16, bus=None,
                 force_first: bool = False, on_capture=None) -> None:
        if bus is None:
            from tpuic_torch.telemetry.events import bus as _global_bus
            bus = _global_bus
        self.bus = bus
        self.on_capture = on_capture
        self.trace_dir = trace_dir
        self.threshold = float(threshold)
        self.warmup = max(2, int(warmup))
        self.trace_steps = max(1, int(trace_steps))
        self.keep = max(1, int(keep))
        self.cooldown = max(0, int(cooldown))
        self._totals: deque = deque(maxlen=max(8, int(window)))
        self._active_path: Optional[str] = None
        self._remaining = 0
        self._cooldown_left = 0
        self._counter = 0
        self._force = bool(force_first)
        self._disabled = False
        self._profiler = None
        self.fired = 0

    # -- bus hook ------------------------------------------------------
    def on_event(self, ev) -> None:
        if ev.kind == "step":
            self.observe(float(ev.data.get("total_ms", 0.0)) / 1000.0)

    def observe(self, total_s: float) -> None:
        """One step's total wall time; called from the loop thread (the
        profiler start/stop must stay on one thread)."""
        if self._disabled:
            return
        if self._active_path is not None:
            self._remaining -= 1
            if self._remaining <= 0:
                self._stop()
            return
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._totals.append(total_s)
            return
        if profiler_on():
            # Another session records (--profile-dir's first epoch): the
            # window waits for it; a forced one stays pending.
            self._totals.append(total_s)
            return
        if self._force:
            self._force = False
            self._totals.append(total_s)
            self._start(reason="TPUIC_TRACE", ratio=None)
            return
        ratio = None
        if (self.threshold > 0 and len(self._totals) >= self.warmup):
            med = statistics.median(self._totals)
            if med > 0 and total_s > self.threshold * med:
                ratio = total_s / med
        self._totals.append(total_s)
        if ratio is not None:
            self._start(reason="slow_step", ratio=round(ratio, 2))

    def finish(self) -> None:
        """Close any open window (end of fit — a trace must never leak
        past the run that started it)."""
        if self._active_path is not None:
            self._stop()

    # -- internals -----------------------------------------------------
    def _prune(self) -> None:
        # Oldest-first by mtime, NOT by name: the dir name starts with a
        # per-run counter, so across process restarts a fresh run's
        # trace-0000 sorts before the previous run's trace-0003 and a
        # name sort would delete the evidence just captured while
        # keeping the stale traces.
        try:
            names = [d for d in os.listdir(self.trace_dir)
                     if d.startswith("trace-")]
        except OSError:
            return

        def age(d: str):
            try:
                return os.path.getmtime(os.path.join(self.trace_dir, d))
            except OSError:
                return 0.0
        names.sort(key=lambda d: (age(d), d))
        for d in names[:max(0, len(names) - (self.keep - 1))]:
            shutil.rmtree(os.path.join(self.trace_dir, d),
                          ignore_errors=True)

    def _start(self, reason: str, ratio) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prune()
        path = os.path.join(self.trace_dir,
                            f"trace-{self._counter:04d}-{int(time.time())}")
        self._counter += 1
        try:
            self._profiler = start_profiler()
        except Exception as e:
            # Another trace active (fit --profile-dir) or a backend
            # without profiler support: report and stand down.
            self._disabled = True
            self.bus.publish("trace", action="error", path=path,
                             reason=str(e)[:200])
            return
        self._active_path = path
        self._remaining = self.trace_steps
        self.fired += 1
        self.bus.publish("trace", action="started", path=path,
                         reason=reason, ratio=ratio,
                         steps=self.trace_steps)

    def _stop(self) -> None:
        path, self._active_path = self._active_path, None
        self._cooldown_left = self.cooldown
        try:
            stop_profiler(self._profiler, path)
            self._profiler = None
        except Exception as e:
            self._disabled = True
            self.bus.publish("trace", action="error", path=path,
                             reason=str(e)[:200])
            return
        self.bus.publish("trace", action="stopped", path=path)
        if self.on_capture is not None:
            # Auto-analysis of the capture (telemetry/profile.py). An
            # analyzer failure is reported, NOT escalated: the trigger
            # keeps capturing — raw traces beat no traces.
            try:
                self.on_capture(path)
            except Exception as e:
                self.bus.publish("trace", action="analyze_error",
                                 path=path, reason=str(e)[:200])
