"""``TrainTelemetry``: one training run's telemetry wiring (a port of
``tpuic/telemetry/wiring.py``).

It owns the run's subscribers on the process-global bus: the JSONL sink
(``run.metrics_jsonl``; rank k of a process group writes
``<stem>.rank<k>.jsonl`` beside it, and tags its events with ``rank`` and
``ranks`` for ``python -m tpuic_torch.telemetry.fleet``), the supervisor's
heartbeat (when ``TPUIC_HEARTBEAT_FILE`` is set), the step timer, the
memory sampler,
the goodput tracker, the SLO tracker (``run.slo``), the device-time
analyzer (``run.trace_analyze``), the trace trigger (``run.trace_dir`` or
``TPUIC_TRACE``) and a TensorBoard bridge.  The emitters (the loop, the
checkpoint manager, the dataset quarantine, the kernel builds and the
engine's graph captures) publish to the bus without knowing any of this.

Exactly one instance is live per process: building one closes the
previous run's subscribers first.
"""

from __future__ import annotations

import os
from typing import Optional

from tpuic_torch.runtime.supervisor import HeartbeatWriter
from tpuic_torch.telemetry.events import JsonlSink, TensorBoardSink, bus
from tpuic_torch.telemetry.fleet import rank_stream_path, tag_bus_with_rank
from tpuic_torch.telemetry.goodput import (GoodputTracker,
                                           analytic_flops_per_step,
                                           peak_flops)
from tpuic_torch.telemetry.memory import MemorySampler
from tpuic_torch.telemetry.slo import SLOTracker, parse_objectives
from tpuic_torch.telemetry.steptime import StepTimer
from tpuic_torch.telemetry.tracing import TraceTrigger


def device_peak(device, compute_dtype: str) -> Optional[float]:
    """The card's peak for a step in ``compute_dtype`` ('bf16' or 'f32'):
    an f32 step at the TF32 rate exactly when
    ``torch.backends.cuda.matmul.allow_tf32`` is on.  None off the card
    and for a card without a row."""
    import torch
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return None
    return peak_flops(torch.cuda.get_device_name(device),
                      compute_dtype or "bf16",
                      tf32=torch.backends.cuda.matmul.allow_tf32)


class TrainTelemetry:
    """One training run's telemetry wiring over the process-global bus
    (see the module docstring).  ``n_devices`` multiplies the per-card
    peak (one card a process)."""

    def __init__(self, run_cfg, *, model_name: str = "", image_size: int = 0,
                 global_batch: int = 0, n_devices: int = 1, device=None,
                 tb=None, compute_dtype: str = "", rank: int = 0,
                 log=None) -> None:
        global _active
        if _active is not None:
            _active.close()
        _active = self
        self._sinks = []
        self._unsubs = []
        self.rank, self.ranks = tag_bus_with_rank(
            bus, int(rank), max(1, int(n_devices)))
        jsonl = getattr(run_cfg, "metrics_jsonl", "") or ""
        if jsonl:
            sink = JsonlSink(rank_stream_path(jsonl, self.rank))
            self._sinks.append(sink)
            self._unsubs.append(bus.subscribe(sink))
        # Supervised liveness: under ``python -m tpuic_torch.supervise``
        # the parent set TPUIC_HEARTBEAT_FILE, and bus activity (the
        # step events the loop publishes anyway) is mirrored into it:
        # host-side file writes, no device sync.
        self.heartbeat = HeartbeatWriter.from_env(publish=bus.publish)
        if self.heartbeat is not None:
            self._unsubs.append(bus.subscribe(self.heartbeat))
        self.steptime = StepTimer(bus)
        self.memory = MemorySampler(publish=bus.publish, device=device,
                                    log=log)
        self._unsubs.append(bus.subscribe(self.memory.on_event,
                                          kinds=("step",)))
        flops = analytic_flops_per_step(model_name, image_size, global_batch)
        peak = device_peak(device, compute_dtype)
        self.peak = None if peak is None else peak * self.ranks
        self.goodput = GoodputTracker(flops_per_step=flops,
                                      peak_flops=self.peak,
                                      global_batch=global_batch,
                                      compute_dtype=compute_dtype)
        self._unsubs.append(bus.subscribe(self.goodput.on_event))
        self.slo: Optional[SLOTracker] = None
        slo_specs = getattr(run_cfg, "slo", "") or ""
        if slo_specs:
            self.slo = SLOTracker(parse_objectives(
                slo_specs, allowed=("train_step",)))
            self._unsubs.append(self.slo.attach(bus))
        self.profile = None
        if getattr(run_cfg, "trace_analyze", False):
            from tpuic_torch.telemetry.profile import CaptureAnalyzer
            self.profile = CaptureAnalyzer(bus=bus)
            # Before the tracer: the analyzer must see a window's steps
            # before the tracer closes it.
            self._unsubs.append(bus.subscribe(self.profile.on_event,
                                              kinds=("step", "trace")))
        trace_dir = os.environ.get("TPUIC_TRACE", "") or \
            getattr(run_cfg, "trace_dir", "") or ""
        self.tracer: Optional[TraceTrigger] = None
        if trace_dir:
            self.tracer = TraceTrigger(
                trace_dir,
                threshold=float(getattr(run_cfg, "trace_threshold", 3.0)),
                trace_steps=int(getattr(run_cfg, "trace_steps", 3)),
                keep=int(getattr(run_cfg, "trace_keep", 4)),
                force_first=bool(os.environ.get("TPUIC_TRACE")),
                bus=bus,
                on_capture=(self.profile.on_capture
                            if self.profile is not None else None))
            self._unsubs.append(bus.subscribe(self.tracer.on_event,
                                              kinds=("step",)))
        if tb is not None:
            tbs = TensorBoardSink(tb)
            self._unsubs.append(bus.subscribe(
                tbs, kinds=("step", "skip", "rollback", "quarantine",
                            "goodput", "restart", "slo", "memory",
                            "profile")))

    def subscribe(self, fn, kinds=None) -> None:
        """``fn`` on the bus for this run: unsubscribed at :meth:`close`."""
        self._unsubs.append(bus.subscribe(fn, kinds=kinds))

    def flush(self) -> None:
        if self.profile is not None:
            self.profile.finalize()
        for s in self._sinks:
            s.flush()

    def close(self) -> None:
        """Unsubscribe this run's consumers and close its sinks
        (idempotent)."""
        global _active
        for unsub in self._unsubs:
            unsub()
        self._unsubs = []
        for s in self._sinks:
            s.close()
        self._sinks = []
        if _active is self:
            _active = None


_active: Optional[TrainTelemetry] = None
