"""Prometheus text exposition of the serve and train counters (from
``tpuic/telemetry/prom.py``).

No client library: the exposition format is lines of
``name{label="v"} value`` with ``# HELP``/``# TYPE`` comments,
hand-rendered and accepted by any Prometheus scraper or ``promtool check
metrics``.  ``train_exposition(goodput.report(), steptime.summary())``
renders goodput fractions, MFU and step-time percentiles, with the SLO,
memory and device-time rows; ``write_exposition`` writes it atomically
(the train CLI's ``--prom-dump``, scrapeable through node_exporter's
textfile collector).  ``serve_exposition(stats.snapshot(), ...)``
renders the engine's counters with ``tpuic``'s metric names, labels and
help strings: latency and span percentiles, pad efficiency, the bucket
histogram, rejects by cause and priority (``admission_rows``), brownout
and quota gauges, SLO, memory and device-time rows.  The port has no
compiled-program registry: its ``compile_cache_*`` rows count the
engine's per-bucket CUDA graphs (``compile_cache_rows``).
``PromServer`` serves ``/metrics`` over HTTP from a daemon thread (the
serve CLI's ``--prom-port``).  The router, rollout and score rows are
ROADMAP §1 items 2 and 14.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterable, List, Optional, Tuple


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render(rows: Iterable[Tuple], prefix: str = "tpuic") -> str:
    """rows: (name, value, type, help, labels-or-None).  Values of None
    are skipped (a percentile with no samples yet must not render as a
    bogus 0).  TYPE/HELP are emitted once per metric name."""
    seen = set()
    out: List[str] = []
    for name, value, mtype, help_, labels in rows:
        if value is None:
            continue
        full = f"{prefix}_{name}"
        if full not in seen:
            seen.add(full)
            out.append(f"# HELP {full} {help_}")
            out.append(f"# TYPE {full} {mtype}")
        out.append(f"{full}{_fmt_labels(labels)} {float(value):g}")
    return "\n".join(out) + "\n" if out else ""


def slo_rows(slo_report: Optional[dict]) -> List[Tuple]:
    """SLOTracker.report() -> exposition rows (telemetry/slo.py): per
    objective, the configured target/threshold plus rolling attainment,
    error-budget burn rate, and remaining budget.  Shared by the serve
    and train expositions; an empty/None report renders nothing."""
    rows: List[Tuple] = []
    for obj in (slo_report or {}).get("objectives", ()):
        labels = {"slo": obj.get("name", "slo")}
        for field, mtype, help_ in (
                ("target", "gauge",
                 "configured attainment target for this SLO"),
                ("threshold_ms", "gauge",
                 "latency threshold the SLO is measured against"),
                ("samples", "counter",
                 "samples observed in the rolling SLO window"),
                ("attainment", "gauge",
                 "rolling fraction of samples meeting the objective"),
                ("current_ms", "gauge",
                 "current value of the SLO's quantile over the window"),
                ("burn_rate", "gauge",
                 "error-budget burn rate (1.0 = burning exactly at "
                 "budget; >1 = on track to exhaust it)"),
                ("budget_remaining", "gauge",
                 "fraction of the rolling error budget left (can go "
                 "negative when the objective is blown)")):
            if obj.get(field) is not None:
                rows.append((f"slo_{field}", obj[field], mtype, help_,
                             labels))
    return rows


def memory_rows(memory: Optional[dict]) -> List[Tuple]:
    """MemorySampler.snapshot() -> exposition rows (telemetry/memory.py):
    per device, ``device_memory_bytes{device,kind}`` with kind in
    ``in_use|peak|limit`` plus a per-device headroom gauge — the HBM
    curve the multi-host/MFU roadmap items steer by.  Shared by the
    serve and train expositions; None renders nothing (CPU runs with no
    sample yet must not scrape as 0 bytes)."""
    rows: List[Tuple] = []
    for dev in (memory or {}).get("devices") or ():
        labels = {"device": str(dev.get("device", "?"))}
        for field, kind in (("bytes_in_use", "in_use"),
                            ("peak_bytes_in_use", "peak"),
                            ("bytes_limit", "limit")):
            if dev.get(field) is not None:
                rows.append(("device_memory_bytes", dev[field], "gauge",
                             "per-device memory bytes by kind "
                             "(in_use|peak|limit); source per "
                             "docs/observability.md 'Device memory'",
                             {**labels, "kind": kind}))
        if dev.get("headroom_frac") is not None:
            rows.append(("device_memory_headroom_frac",
                         dev["headroom_frac"], "gauge",
                         "1 - in_use/limit per device (alert low: the "
                         "next allocation spike is an OOM)", labels))
    return rows


_VERDICT_CODE = {"hbm-bound": 0.0, "compute-bound": 1.0, "overhead": -1.0}


def profile_rows(waterfall: Optional[dict]) -> List[Tuple]:
    """Device-time waterfall (telemetry/profile.py) -> exposition rows:
    per op class, ``device_time_ms{op_class}`` / ``device_time_frac``
    plus the roofline intensity and an encoded verdict
    (1 = compute-bound, 0 = hbm-bound, -1 = overhead — numeric so a
    dashboard can alert on a class flipping sides of the ridge).
    Shared by the serve and train expositions; None renders nothing (a
    run that never analyzed must not scrape as a zero waterfall)."""
    rows: List[Tuple] = []
    for cls, c in sorted((waterfall or {}).get("classes", {}).items()):
        if not isinstance(c, dict):
            continue
        labels = {"op_class": cls}
        rows.append(("device_time_ms", c.get("ms"), "gauge",
                     "device time per op class from the last waterfall "
                     "analysis (docs/observability.md, 'Device-time "
                     "attribution')", labels))
        rows.append(("device_time_frac", c.get("frac"), "gauge",
                     "fraction of the device bucket per op class",
                     labels))
        rows.append(("roofline_intensity", c.get("intensity"), "gauge",
                     "arithmetic intensity (FLOPs/HBM byte) per op class",
                     labels))
        rows.append(("roofline_verdict", _VERDICT_CODE.get(
            c.get("verdict")), "gauge",
            "roofline verdict per op class (1=compute-bound, "
            "0=hbm-bound, -1=overhead)", labels))
    if (waterfall or {}).get("device_ms_per_step") is not None:
        rows.append(("device_ms_per_step", waterfall["device_ms_per_step"],
                     "gauge", "mean measured device bucket the waterfall "
                     "sums to", None))
    return rows


def compile_cache_rows(counters: Optional[dict]) -> List[Tuple]:
    """The engine's per-bucket CUDA-graph table as ``tpuic``'s four
    compiled-program registry rows (the port's counterpart of the XLA
    registry): a capture is a miss, a replay of a captured graph a hit, a
    capture made at warmup or by a swap's standby counts as prewarmed, and
    the graphs the engine holds are the entries.  None renders nothing."""
    if counters is None:
        return []
    c = counters
    return [
        ("compile_cache_hits_total", c.get("hits", 0), "counter",
         "CUDA graph replays of a captured bucket graph (no capture)",
         None),
        ("compile_cache_misses_total", c.get("misses", 0), "counter",
         "CUDA graph captures of a bucket's forward (includes prewarms)",
         None),
        ("compile_cache_prewarmed_total", c.get("prewarmed", 0), "counter",
         "CUDA graphs captured ahead of traffic (warmup and a swap's "
         "standby)", None),
        ("compile_cache_entries", c.get("entries", 0), "gauge",
         "CUDA graphs the engine holds (live slot and standby)", None),
    ]


def _process_rss_row() -> Tuple:
    """The ``process_rss_bytes`` gauge both expositions render — host
    memory next to the device curve it eventually takes down.  Lazy
    import keeps this module importable without the metrics stack."""
    from tpuic_torch.metrics.meters import process_rss_bytes
    return ("process_rss_bytes", process_rss_bytes(), "gauge",
            "resident set size of this process", None)


def admission_rows(snapshot: dict,
                   admission: Optional[dict] = None) -> List[Tuple]:
    """The admission-control exposition (docs/serving.md, "Admission
    control and overload"): the ``rejected_total`` counter split by
    cause (``queue_full|deadline|quota|brownout``) and priority class —
    the labels every typed :class:`tpuic_torch.serve.admission.AdmissionError`
    carries — plus, when an ``AdmissionController.state()`` dict is
    handed in, the brownout level and remaining quota tokens.  A cause
    that never fired renders no series (Prometheus treats an absent
    counter as 0); the unlabeled total lives on in
    ``snapshot()['rejected']`` for humans."""
    rows: List[Tuple] = []
    for cause, by_prio in (snapshot.get("rejected_by") or {}).items():
        for prio, n in (by_prio or {}).items():
            rows.append(("rejected_total", n, "counter",
                         "requests rejected or shed, by cause "
                         "(queue_full|deadline|quota|brownout) and "
                         "priority class",
                         {"cause": cause, "priority": prio}))
    brownout = (admission or {}).get("brownout") or {}
    if brownout.get("level") is not None:
        rows.append(("brownout_level", brownout["level"], "gauge",
                     "SLO-coupled brownout level (0 = admitting every "
                     "class; level L sheds the L lowest classes)",
                     {"slo": brownout.get("slo", "")}))
    for tenant, tokens in ((admission or {}).get("tenant_tokens")
                           or {}).items():
        rows.append(("quota_tokens", tokens, "gauge",
                     "remaining token-bucket quota per tenant",
                     {"tenant": tenant}))
    if (admission or {}).get("free_pool_tokens") is not None:
        rows.append(("quota_tokens", admission["free_pool_tokens"],
                     "gauge", "remaining token-bucket quota per tenant",
                     {"tenant": "*"}))
    return rows


def serve_exposition(snapshot: dict, prefix: str = "tpuic_serve",
                     heartbeat_age_s: Optional[float] = None,
                     slo: Optional[dict] = None,
                     admission: Optional[dict] = None,
                     memory: Optional[dict] = None,
                     profile: Optional[dict] = None,
                     compile_cache: Optional[dict] = None) -> str:
    """ServeStats.snapshot() -> Prometheus text.

    ``heartbeat_age_s``: seconds since the supervised-liveness heartbeat
    file was last written (runtime/supervisor.py), when the server runs
    under ``python -m tpuic_torch.supervise``; omitted (None) unsupervised —
    a scraper alerting on staleness must not see a bogus 0.
    ``slo``: an SLOTracker.report() to append (telemetry/slo.py).
    ``admission``: an AdmissionController.state() for brownout/quota
    gauges; the rejected_total{cause,priority} split renders from the
    snapshot itself.
    ``memory``: a MemorySampler.snapshot() for the per-device
    ``device_memory_bytes{device,kind}`` rows (telemetry/memory.py).
    ``profile``: a device-time waterfall (telemetry/profile.py — the
    engine's ``profile_waterfall()``) for ``device_time_ms{op_class}``
    rows.
    ``compile_cache``: the engine's CUDA-graph table counters
    (``InferenceEngine.graph_cache_counters()``) for the four
    ``compile_cache_*`` rows."""
    rows: List[Tuple] = [
        _process_rss_row(),
        ("heartbeat_age_seconds", heartbeat_age_s, "gauge",
         "seconds since the liveness heartbeat file was last written "
         "(supervised runs only)", None),
        ("requests_total", snapshot.get("requests"), "counter",
         "requests resolved", None),
        ("images_total", snapshot.get("images"), "counter",
         "images scored", None),
        ("device_calls_total", snapshot.get("device_calls"), "counter",
         "bucketed device dispatches", None),
        ("compiles_total", snapshot.get("compiles"), "counter",
         "bucket executable compiles (0 after warmup = the AOT contract)",
         None),
        ("executable_cache_hits_total", snapshot.get("executable_cache_hits"),
         "counter", "steady-state executable cache hits", None),
        ("compile_seconds_total", snapshot.get("compile_s"), "counter",
         "cumulative compile wall time", None),
        ("pad_efficiency", snapshot.get("pad_efficiency"), "gauge",
         "valid rows / device rows (1.0 = no padding waste)", None),
        ("swaps_total", snapshot.get("swaps"), "counter",
         "atomic weight hot-swaps completed (docs/serving.md, "
         "'Model lifecycle')", None),
        ("generation", snapshot.get("generation"), "gauge",
         "weight generation: 0 at boot, +1 per hot-swap", None),
        ("throughput_images_per_sec", snapshot.get(
            "throughput_images_per_sec"), "gauge",
         "lifetime images/sec", None),
        ("elapsed_seconds", snapshot.get("elapsed_s"), "gauge",
         "seconds since stats reset", None),
    ]
    for src, name, help_ in (
            ("queue_wait_ms", "queue_wait_ms",
             "enqueue->dispatch wait percentiles over the sliding window"),
            ("latency_ms", "latency_ms",
             "enqueue->result latency percentiles over the sliding window")):
        for q, v in (snapshot.get(src) or {}).items():
            rows.append((name, v, "gauge", help_, {"quantile": q}))
    # Request span ledger percentiles (docs/observability.md, "Request
    # tracing"): one series per phase of a request's life.
    for phase, qs in (snapshot.get("span_ms") or {}).items():
        for q, v in (qs or {}).items():
            rows.append(("span_ms", v, "gauge",
                         "per-request span percentiles by phase "
                         "(queue/batch/staging/dispatch/device/scatter)",
                         {"phase": phase, "quantile": q}))
    for bucket, n in (snapshot.get("batch_hist") or {}).items():
        rows.append(("batches_total", n, "counter",
                     "device calls per padding bucket", {"bucket": bucket}))
    # Per-bucket executable cost analysis (serve/engine.py _compile):
    # FLOPs/bytes/intensity of each AOT bucket — the roofline context
    # for the span ledger's device phase.
    for bucket, c in sorted((snapshot.get("executable_cost")
                             or {}).items()):
        labels = {"bucket": str(bucket)}
        for field, help_ in (("flops", "compiled FLOPs per executable "
                              "call, by padding bucket"),
                             ("bytes", "compiled HBM bytes accessed per "
                              "executable call, by padding bucket"),
                             ("intensity", "arithmetic intensity "
                              "(FLOPs/byte) per bucket executable")):
            if c.get(field) is not None:
                rows.append((f"executable_{field}", c[field], "gauge",
                             help_, labels))
    if snapshot.get("model_digest"):
        # Info-style row (value 1, identity in the label): what weights
        # are serving — scrape-join it against the router's view.
        rows.append(("model_info", 1, "gauge",
                     "serving-weights identity (digest label; "
                     "generation row says how many swaps ago)",
                     {"digest": str(snapshot["model_digest"])}))
    rows.extend(profile_rows(profile))
    rows.extend(admission_rows(snapshot, admission))
    rows.extend(memory_rows(memory))
    rows.extend(slo_rows(slo))
    rows.extend(compile_cache_rows(compile_cache))
    return render(rows, prefix=prefix)


def train_exposition(report: dict, steptime: Optional[dict] = None,
                     prefix: str = "tpuic_train",
                     heartbeat_age_s: Optional[float] = None,
                     slo: Optional[dict] = None,
                     memory: Optional[dict] = None,
                     profile: Optional[dict] = None) -> str:
    """GoodputTracker.report() (+ StepTimer.summary()) -> Prometheus text.

    ``heartbeat_age_s``: the supervisor heartbeat's age (None
    unsupervised renders no row); ``restart_count``
    comes from the report's ``restarts`` field.
    ``slo``: an SLOTracker.report() for the step-time objectives.
    ``memory``: a MemorySampler.snapshot() (telemetry/memory.py).
    ``profile``: the last device-time waterfall (telemetry/profile.py,
    ``CaptureAnalyzer.last``) for ``device_time_ms{op_class}`` rows."""
    rows: List[Tuple] = [
        _process_rss_row(),
        ("restart_count", report.get("restarts"), "counter",
         "supervisor restarts absorbed by this run "
         "(runtime/supervisor.py exit-code contract)", None),
        ("heartbeat_age_seconds", heartbeat_age_s, "gauge",
         "seconds since the liveness heartbeat file was last written "
         "(supervised runs only)", None),
        ("steps_total", report.get("steps"), "counter",
         "train steps dispatched", None),
        ("wall_seconds", report.get("wall_s"), "gauge",
         "goodput window wall time", None),
        ("mfu", report.get("mfu"), "gauge",
         "running model FLOPs utilization (analytic)", None),
        ("compiles_total", report.get("compiles"), "counter",
         "backend compiles observed (flat after step 1 = no retraces)",
         None),
        ("skipped_steps", report.get("skipped_steps_est"), "counter",
         "estimated non-finite guard-skipped steps", None),
        ("goodput_accounted_fraction", report.get("accounted_frac"),
         "gauge", "fraction of wall time the named buckets explain", None),
    ]
    for k, v in report.items():
        if k.startswith("frac_"):
            rows.append(("goodput_fraction", v, "gauge",
                         "fraction of wall time per goodput bucket",
                         {"bucket": k[5:]}))
    if report.get("compute_dtype"):
        # Info-style row (value 1, dtype as label): lets dashboards and
        # alerts split MFU/step-time series by precision arm.
        rows.append(("compute_dtype_info", 1, "gauge",
                     "active train compute dtype",
                     {"dtype": str(report["compute_dtype"])}))
    rows.append(("checkpoint_async_seconds",
                 report.get("checkpoint_async_s"), "gauge",
                 "checkpoint commit work overlapped with compute (async "
                 "commits; blocking stall is goodput_fraction "
                 "bucket=checkpoint)", None))
    for src, name in ((steptime or {}).get("total_ms"), "step_total_ms"), \
                     ((steptime or {}).get("data_ms"), "step_data_wait_ms"):
        for q, v in (src or {}).items():
            rows.append((name, v, "gauge",
                         "step-time percentiles over the sliding window",
                         {"quantile": q}))
    rows.extend(profile_rows(profile))
    rows.extend(memory_rows(memory))
    rows.extend(slo_rows(slo))
    return render(rows, prefix=prefix)


def write_exposition(path: str, text: str) -> None:
    """Atomic dump (textfile-collector discipline: scrapers must never
    read a half-written exposition)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class PromServer:
    """Minimal /metrics HTTP endpoint around a ``collect() -> str``
    callable; runs in a daemon thread, ``close()`` shuts it down.

    Binds loopback by default (the node_exporter convention): the
    endpoint has no auth, so exposing it beyond the host is an explicit
    caller decision (``--prom-host`` in ``python -m tpuic_torch.serve``)."""

    def __init__(self, port: int, collect: Callable[[], str],
                 host: str = "127.0.0.1") -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self_inner):  # noqa: N805
                if self_inner.path.rstrip("/") not in ("", "/metrics"):
                    self_inner.send_response(404)
                    self_inner.end_headers()
                    return
                try:
                    body = collect().encode()
                except Exception as e:  # collector bug -> 500, not crash
                    self_inner.send_response(500)
                    self_inner.end_headers()
                    self_inner.wfile.write(str(e).encode())
                    return
                self_inner.send_response(200)
                self_inner.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self_inner.send_header("Content-Length", str(len(body)))
                self_inner.end_headers()
                self_inner.wfile.write(body)

            def log_message(self_inner, *a):  # quiet: stderr is for stats
                pass

        self._srv = ThreadingHTTPServer((host, int(port)), Handler)
        self.port = self._srv.server_address[1]  # resolved (port 0 = any)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="tpuic-prom")
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)
