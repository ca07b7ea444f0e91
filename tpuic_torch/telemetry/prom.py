"""Prometheus text exposition of the train counters (from
``tpuic/telemetry/prom.py``: ``train_exposition`` and the row helpers it
uses).

No client library: the exposition format is lines of
``name{label="v"} value`` with ``# HELP``/``# TYPE`` comments,
hand-rendered and accepted by any Prometheus scraper or ``promtool check
metrics``.  ``train_exposition(goodput.report(), steptime.summary())``
renders goodput fractions, MFU and step-time percentiles, with the SLO,
memory and device-time rows; ``write_exposition`` writes it atomically
(the train CLI's ``--prom-dump``, scrapeable through node_exporter's
textfile collector).  The port has no compiled-program registry (its
counterpart is the engine's per-bucket CUDA graphs), so no
``compile_cache_*`` rows.  The serve expositions are not ported yet.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Tuple


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


def _process_rss_row() -> Tuple:
    """The ``process_rss_bytes`` gauge both expositions render — host
    memory next to the device curve it eventually takes down.  Lazy
    import keeps this module importable without the metrics stack."""
    from tpuic_torch.metrics.meters import process_rss_bytes
    return ("process_rss_bytes", process_rss_bytes(), "gauge",
            "resident set size of this process", None)


def train_exposition(report: dict, steptime: Optional[dict] = None,
                     prefix: str = "tpuic_train",
                     heartbeat_age_s: Optional[float] = None,
                     slo: Optional[dict] = None,
                     memory: Optional[dict] = None,
                     profile: Optional[dict] = None) -> str:
    """GoodputTracker.report() (+ StepTimer.summary()) -> Prometheus text.

    ``heartbeat_age_s``: the supervisor heartbeat's age (``tpuic``'s
    supervisor is not ported: None renders no row); ``restart_count``
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
