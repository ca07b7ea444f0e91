"""Device-time attribution: the per-op-class waterfall of a
``torch.profiler`` capture (a port of ``tpuic/telemetry/profile.py``).

- :func:`parse_trace` reads the Chrome trace a ``TraceTrigger`` window
  wrote (``trace.json``) and sums the device events (``kernel``,
  ``gpu_memcpy``, ``gpu_memset``) per op class, by the kernel's name:

  ===========  ==========================================================
  class        kernels
  ===========  ==========================================================
  matmul       cuBLAS (``gemm``, ``nvjet``) / CUTLASS GEMMs and cuDNN
               convolutions
  port         the port's own kernels (K1-K4), also split by kernel id
               under ``port_kernels``
  elementwise  PyTorch's elementwise and everything not named below
  reduce       reductions, softmax, norms, scans, sorts
  copy         memcpy / memset, layout changes (cuDNN's
               ``nchwToNhwc`` included), copies, concatenation
  collective   NCCL
  overhead     the measured stall (below)
  ===========  ==========================================================

  It rolls the same time up per layer from the ``record_function``
  scope whose host range encloses the kernel's launch (the ViT's
  ``tokenize``, ``block{i}``, ``cls_pool``, the step's ``loss`` and
  ``optimizer``; a kernel launched by the autograd engine is
  ``backward``, any other ``(unattributed)``), and reports the device's
  busy time (the union of the kernels' intervals) against the capture's
  span: ``idle_frac`` (under the profiler, whose own host cost stretches
  the span), with the kernels and host ops a step and the top kernels by
  time.  A capture with no device event (the CPU) returns None.
- :func:`attribute_device_time` anchors the measured per-step class
  times on the measured device bucket of the ``step`` events, as
  ``tpuic`` does: the mean step's excess over the kernels' busy time is
  booked to ``overhead`` as ``stall_ms``.

``tpuic``'s HLO cost model (``hlo_waterfall``) has no counterpart: eager
PyTorch has no compiled program to read.  Analysis runs in the capture
and finalize hooks only, never per step, and a failure publishes a
``profile`` event with an ``error`` field instead of raising.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import re
import statistics
from collections import deque
from typing import Dict, List, Optional, Sequence

# The port's kernels by the symbols of kernels/csrc/*.cu.
PORT_KERNELS = (
    ("conv_bn_relu", "K3"),
    ("xent_fwd_kernel", "K1f"), ("xent_bwd_kernel", "K1b"),
    ("lars_", "K2a"), ("lamb_", "K2b"), ("trust_ratio", "K2"),
    ("flash_fwd", "K4f"), ("flash_bwd_dq_kernel", "K4b-dq"),
    ("flash_bwd_dkv_kernel", "K4b-dkv"),
)
# Layout changes first: cuDNN's nchwToNhwc kernels are copies.
_LAYOUT = re.compile(r"memcpy|memset|nchwtonhwc|nhwctonchw|transpose|"
                     r"copy_kernel|catarray", re.I)
_MATMUL = re.compile(r"gemm|nvjet|cutlass|xmma|cublas|wgmma|hmma|cudnn|"
                     r"conv|winograd|implicit|fft|dgrad|wgrad|fprop", re.I)
_REDUCE = re.compile(r"reduce|softmax|norm|welford|scan|cumsum|sort|topk|"
                     r"argmax|argmin|max_|min_|sum_|mean", re.I)
_COPY = re.compile(r"copy|cat_|permute|index|gather|scatter|fill", re.I)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host scopes a kernel's launch rolls up to (record_function names).
LAYER_SCOPE = re.compile(r"^(tokenize|block\d+|cls_pool|loss|optimizer|"
                         r"forward)$")
_BACKWARD = "autograd::engine::evaluate_function"
TOP_KERNELS = 12
SCOPE_DEPTH = 32


def port_kernel(name: str) -> Optional[str]:
    """The K id of one of the port's kernels, or None."""
    return next((k for sym, k in PORT_KERNELS if sym in name), None)


def classify_kernel(name: str, category: str = "kernel") -> str:
    """A device event's op class (the table in the module docstring)."""
    if category in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    if port_kernel(name) is not None:
        return "port"
    if "nccl" in name.lower():
        return "collective"
    if _LAYOUT.search(name):
        return "copy"
    if _MATMUL.search(name):
        return "matmul"
    if _REDUCE.search(name):
        return "reduce"
    if _COPY.search(name):
        return "copy"
    return "elementwise"


def _trace_files(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        return []
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith((".json", ".json.gz")))


def _load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    if isinstance(data, dict):
        return list(data.get("traceEvents") or ())
    return list(data) if isinstance(data, list) else []


def _union_ms(intervals: List[tuple]) -> float:
    """Length of the union of ``(start_us, end_us)`` intervals, in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1000.0


class _Scopes:
    """Per host thread, the ranges of the layer scopes and of the
    autograd engine's functions, for the launch-to-layer lookup."""

    def __init__(self, events: List[dict]) -> None:
        by_tid: Dict[tuple, list] = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in ("user_annotation",
                                                          "cpu_op"):
                continue
            name = str(e.get("name", ""))
            if LAYER_SCOPE.match(name):
                layer = name
            elif name.startswith(_BACKWARD):
                layer = "backward"
            else:
                continue
            t0 = float(e.get("ts", 0.0))
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), layer))
        self._tids = {}
        for key, spans in by_tid.items():
            spans.sort()
            self._tids[key] = ([s[0] for s in spans], spans)

    def layer(self, pid, tid, ts: float) -> str:
        found = self._tids.get((pid, tid))
        if found is None:
            return "(unattributed)"
        starts, spans = found
        i = bisect.bisect_right(starts, ts) - 1
        # The innermost enclosing scope: the latest start whose range
        # still covers ``ts`` (a layer scope wins over the autograd
        # function it sits in, as it starts later).  Scopes nest a few
        # deep, so the walk back stops after SCOPE_DEPTH of them.
        for j in range(i, max(-1, i - SCOPE_DEPTH), -1):
            a, b, layer = spans[j]
            if a <= ts <= b:
                return layer
        return "(unattributed)"


def parse_trace(path: str, steps: int = 1) -> Optional[dict]:
    """Per-op-class device time of a ``torch.profiler`` capture (``path``:
    the window's directory or its ``trace.json``), per step over
    ``steps`` traced steps; None when it holds no device event."""
    classes: Dict[str, float] = {}
    ports: Dict[str, float] = {}
    layers: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    intervals: List[tuple] = []
    span = [None, None]
    n_ops = host_ops = 0
    syncs = {"cudaStreamSynchronize": 0, "cudaDeviceSynchronize": 0}
    for f in _trace_files(path):
        try:
            events = _load_events(f)
        except (OSError, ValueError):
            continue
        launches = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            span[0] = ts if span[0] is None else min(span[0], ts)
            span[1] = ts + dur if span[1] is None else max(span[1],
                                                           ts + dur)
            if e.get("cat") == "cpu_op":
                host_ops += 1
            if e.get("cat") == "cuda_runtime":
                name = str(e.get("name", ""))
                if name in syncs:
                    syncs[name] += 1
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("pid"), e.get("tid"), ts)
        scopes = _Scopes(events)
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat not in _DEVICE_CATS:
                continue
            dur_us = float(e.get("dur", 0.0))
            if dur_us <= 0:
                continue
            name = str(e.get("name", ""))
            ms = dur_us / 1000.0
            cls = classify_kernel(name, cat)
            classes[cls] = classes.get(cls, 0.0) + ms
            key = (cls, name[:100])
            kernels[key] = kernels.get(key, 0.0) + ms
            if cls == "port":
                k = port_kernel(name)
                ports[k] = ports.get(k, 0.0) + ms
            ts = float(e.get("ts", 0.0))
            intervals.append((ts, ts + dur_us))
            n_ops += 1
            launch = launches.get((e.get("args") or {}).get("correlation"))
            layer = (scopes.layer(*launch) if launch is not None
                     else "(unattributed)")
            layers[layer] = layers.get(layer, 0.0) + ms
    if not n_ops:
        return None
    steps = max(1, int(steps))
    busy = _union_ms(intervals)
    span_ms = (span[1] - span[0]) / 1000.0 if span[0] is not None else 0.0
    total = sum(classes.values())

    def per_step(d):
        return {k: round(v / steps, 4) for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])}

    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {"source": "trace", "steps_traced": steps, "ops": n_ops,
            "kernels_per_step": round(n_ops / steps, 1),
            "host_ops_per_step": round(host_ops / steps, 1),
            "device_ms_total": round(total, 3),
            "busy_ms_per_step": round(busy / steps, 4),
            "span_ms_per_step": round(span_ms / steps, 4),
            "idle_frac": (round(1.0 - busy / span_ms, 4) if span_ms > 0
                          else None),
            "classes": {k: {"ms": v, "frac": round(v * steps / total, 4)}
                        for k, v in per_step(classes).items()},
            "port_kernels": per_step(ports), "layers": per_step(layers),
            "top_kernels": [[name, cls, round(ms / steps, 4)]
                            for (cls, name), ms in top],
            "syncs": {k: round(v / steps, 3) for k, v in syncs.items()}}


def attribute_device_time(trace_wf: dict,
                          device_ms_steps: Sequence[float]) -> dict:
    """``trace_wf`` (per step) anchored on the measured device bucket: the
    mean of ``device_ms_steps`` over the kernels' busy time per step is
    ``stall_ms``, booked to ``overhead``; the classes then sum to
    ``max(mean device bucket, busy)``."""
    out = dict(trace_wf)
    classes = {k: dict(v) for k, v in trace_wf["classes"].items()}
    steps = [float(s) for s in device_ms_steps if s > 0]
    stall = 0.0
    if steps:
        mean = statistics.fmean(steps)
        out["device_ms_per_step"] = round(mean, 3)
        out["steps"] = len(steps)
        stall = max(0.0, mean - trace_wf["busy_ms_per_step"])
    out["stall_ms"] = round(stall, 4)
    oh = classes.setdefault("overhead", {"ms": 0.0})
    oh["ms"] = round(oh["ms"] + stall, 4)
    total = sum(c["ms"] for c in classes.values())
    for c in classes.values():
        c["frac"] = round(c["ms"] / total, 4) if total > 0 else 0.0
    out["classes"] = classes
    return out


class CaptureAnalyzer:
    """Analyzes every triggered capture and, at run end, publishes the
    last analysis again with ``final: true`` (``profile`` events).

    Subscribed to ``step`` and ``trace`` events: steps measured while a
    window is open (and the one that absorbed its stop) are excluded from
    the device bucket, and counted (``tainted_steps_excluded``)."""

    def __init__(self, *, bus=None, window: int = 1024,
                 warmup_steps: int = 2) -> None:
        if bus is None:
            from tpuic_torch.telemetry.events import bus as _global_bus
            bus = _global_bus
        self.bus = bus
        self.warmup_steps = int(warmup_steps)
        self._device_ms: deque = deque(maxlen=max(16, int(window)))
        self._tracing = False
        self._traced_steps = 0
        self._taint_next = 0
        self._finalized = False
        self.tainted_steps = 0
        self.last: Optional[dict] = None
        self.analyses = 0

    def on_event(self, ev) -> None:
        if ev.kind == "step":
            if self._tracing or self._taint_next > 0:
                if self._tracing:
                    self._traced_steps += 1
                self._taint_next = max(0, self._taint_next - 1)
                self.tainted_steps += 1
                return
            self._device_ms.append(float(ev.data.get("device_ms", 0.0)))
        elif ev.kind == "trace":
            action = ev.data.get("action")
            if action == "started":
                self._tracing = True
                self._traced_steps = 0
            elif action in ("stopped", "error"):
                if self._tracing:
                    self._taint_next = 1
                self._tracing = False

    def on_capture(self, trace_path: str) -> None:
        self._analyze(trace_path, final=False)

    def finalize(self) -> None:
        """The run-end record (idempotent)."""
        if self._finalized:
            return
        self._finalized = True
        if self.last is None:
            self.bus.publish("profile", final=True,
                             error="no trace window was captured")
            return
        self.bus.publish("profile", **{**self.last, "final": True})

    def _steps_window(self) -> List[float]:
        steps = [s for s in self._device_ms if s > 0]
        if len(steps) > self.warmup_steps + 2:
            steps = steps[self.warmup_steps:]
        return steps

    def _analyze(self, trace_path: str, final: bool) -> None:
        try:
            wf = parse_trace(trace_path, steps=self._traced_steps or 1)
            if wf is None:
                self.bus.publish("profile", final=final,
                                 trace_path=trace_path,
                                 error="no device events in the trace")
                return
            wf = attribute_device_time(wf, self._steps_window())
            wf.update(final=final, trace_path=trace_path)
            if self.tainted_steps:
                wf["tainted_steps_excluded"] = self.tainted_steps
            self.last = wf
            self.analyses += 1
            self.bus.publish("profile", **wf)
        except Exception as e:
            self.bus.publish("profile", final=final, trace_path=trace_path,
                             error=str(e)[:200])
