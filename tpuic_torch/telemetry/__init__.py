"""The port's telemetry (``tpuic/telemetry``): an event bus with JSONL,
memory and TensorBoard sinks (``events``), the per-step breakdown
(``steptime``), goodput and MFU (``goodput``), memory accounting
(``memory``), step-time SLOs (``slo``), triggered ``torch.profiler``
windows (``tracing``), the kernel-class waterfall of a capture
(``profile``), the Prometheus exposition and ``/metrics`` server
(``prom``), the crash flight recorder (``flight``), the per-rank fleet
aggregator (``fleet``, ``python -m tpuic_torch.telemetry.fleet``) and one
training run's wiring (``wiring.TrainTelemetry``).

Everything is host-side: no module here reads a tensor back from the
card or launches device work.  Re-exports resolve lazily (PEP 562), so
importing the package imports neither torch nor numpy.
"""

from __future__ import annotations

_LAZY = {
    "Event": ("tpuic_torch.telemetry.events", "Event"),
    "EventBus": ("tpuic_torch.telemetry.events", "EventBus"),
    "JsonlSink": ("tpuic_torch.telemetry.events", "JsonlSink"),
    "MemorySink": ("tpuic_torch.telemetry.events", "MemorySink"),
    "TensorBoardSink": ("tpuic_torch.telemetry.events", "TensorBoardSink"),
    "bus": ("tpuic_torch.telemetry.events", "bus"),
    "publish": ("tpuic_torch.telemetry.events", "publish"),
    "publish_compile": ("tpuic_torch.telemetry.events", "publish_compile"),
    "read_jsonl": ("tpuic_torch.telemetry.events", "read_jsonl"),
    "subscribe": ("tpuic_torch.telemetry.events", "subscribe"),
    "GoodputTracker": ("tpuic_torch.telemetry.goodput", "GoodputTracker"),
    "HBM_GBPS": ("tpuic_torch.telemetry.goodput", "HBM_GBPS"),
    "PEAK_FLOPS": ("tpuic_torch.telemetry.goodput", "PEAK_FLOPS"),
    "analytic_flops_per_step": ("tpuic_torch.telemetry.goodput",
                                "analytic_flops_per_step"),
    "hbm_bandwidth": ("tpuic_torch.telemetry.goodput", "hbm_bandwidth"),
    "peak_flops": ("tpuic_torch.telemetry.goodput", "peak_flops"),
    "roofline_intensity": ("tpuic_torch.telemetry.goodput",
                           "roofline_intensity"),
    "MemorySampler": ("tpuic_torch.telemetry.memory", "MemorySampler"),
    "Objective": ("tpuic_torch.telemetry.slo", "Objective"),
    "SLOTracker": ("tpuic_torch.telemetry.slo", "SLOTracker"),
    "parse_objectives": ("tpuic_torch.telemetry.slo", "parse_objectives"),
    "StepTimer": ("tpuic_torch.telemetry.steptime", "StepTimer"),
    "TraceTrigger": ("tpuic_torch.telemetry.tracing", "TraceTrigger"),
    "TrainTelemetry": ("tpuic_torch.telemetry.wiring", "TrainTelemetry"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(
        f"module 'tpuic_torch.telemetry' has no attribute '{name}'")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
