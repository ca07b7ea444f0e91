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
``router_exposition(router.snapshot(), rollout=...)`` renders the replica
router's ``tpuic_router_*`` rows and a canary rollout's
``tpuic_rollout_*`` rows (``rollout_rows``).  ``PromServer`` serves
``/metrics`` over HTTP from a daemon thread (the serve and router CLIs'
``--prom-port``).  ``score_rows`` renders a bulk-scoring worker's
``score_done`` summary or the fleet's score-ledger audit as
``tpuic_score_*`` rows (``python -m tpuic_torch.score --prom-dump``,
``python -m tpuic_torch.telemetry.fleet --score-ledger --prom-dump``).
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


def score_rows(report: Optional[dict]) -> List[Tuple]:
    """Bulk-scoring exposition rows (``tpuic``'s): works off either a
    worker's ``score_done`` summary (``score/driver.py``) or the fleet
    audit report (``telemetry/fleet.py`` ``score_audit``); the two share
    their key vocabulary, and fields only one side carries render only
    there.  None renders nothing."""
    r = report or {}
    rows: List[Tuple] = []
    for field, mtype, help_ in (
            ("n", "gauge", "corpus rows the scoring plan covers"),
            ("shards", "gauge", "shards in the scoring plan"),
            ("shards_committed", "gauge",
             "shards with a verified result manifest"),
            ("shards_missing", "gauge",
             "planned shards with no ledger commit record (audit; "
             "alert nonzero: dropped work)"),
            ("shards_duplicated", "gauge",
             "shards with more than one ledger commit record (audit; "
             "alert nonzero: double-counted corpus)"),
            ("rows_scored", "counter", "corpus rows scored"),
            ("rows_quarantined", "counter",
             "corpus rows quarantined (undecodable at pack time or "
             "failing their packed row CRC at read time)"),
            ("recovered_records", "counter",
             "ledger commit records appended by a survivor for a dead "
             "winner (crash-window repair, not a violation)"),
            ("duplicate_score_events", "counter",
             "double-scored shard attempts deduped at commit (lease "
             "races cost throughput, not correctness)"),
            ("steady_compiles", "gauge",
             "executables compiled AFTER engine warmup during scoring "
             "(the zero-steady-state-compile contract; alert nonzero)"),
            ("steals_this_life", "counter",
             "expired/orphaned shard leases this worker stole"),
    ):
        if r.get(field) is not None:
            rows.append((f"score_{field}", r[field], mtype, help_, None))
    if r.get("ok") is not None:
        rows.append(("score_ledger_exact", 1.0 if r["ok"] else 0.0,
                     "gauge", "1 when the ledger audit held exactly "
                     "(scored + quarantined == corpus, zero duplicates, "
                     "zero drops)", None))
    return rows


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


_BREAKER_CODE = {"closed": 0.0, "half_open": 0.5, "open": 1.0}
_REPLICA_STATE_CODE = {"starting": 0.0, "up": 1.0, "wedged": 2.0,
                       "down": 3.0, "failed": 4.0, "stopped": 5.0}


_ROLLOUT_PHASE_CODE = {"idle": 0.0, "gating": 1.0, "canary": 2.0,
                       "promoting": 3.0, "rolling_back": 4.0,
                       "promoted": 5.0, "rolled_back": 6.0,
                       "refused": 7.0, "aborted": 8.0}


def rollout_rows(rollout: Optional[dict]) -> List[Tuple]:
    """``CanaryRollout.state()`` -> tpuic_rollout_* rows
    (serve/rollout.py, docs/serving.md "Model lifecycle").
    Phase is a numeric code (0=idle 1=gating 2=canary 3=promoting
    4=rolling_back 5=promoted 6=rolled_back 7=refused 8=aborted) so a
    dashboard alerts on 4+/6+ without string matching."""
    if not rollout:
        return []
    rows: List[Tuple] = [
        ("rollout_phase", _ROLLOUT_PHASE_CODE.get(rollout.get("phase")),
         "gauge", "rollout phase (0=idle 1=gating 2=canary 3=promoting "
         "4=rolling_back 5=promoted 6=rolled_back 7=refused 8=aborted)",
         None),
        ("rollout_stage_index", rollout.get("stage_index"), "gauge",
         "current canary stage index (-1 before the first stage)",
         None),
        ("rollout_stage_fraction", rollout.get("stage_fraction"),
         "gauge", "fraction of traffic routed to the canary", None),
        ("rollout_canary_errors_total", rollout.get("canary_errors"),
         "counter", "untyped errors observed on the canary (any one "
         "triggers rollback)", None),
    ]
    if rollout.get("objective"):
        labels = {"slo": str(rollout["objective"])}
        rows.append(("rollout_burn_rate", rollout.get("burn_rate"),
                     "gauge", "canary-scoped error-budget burn rate of "
                     "the watched objective", labels))
        rows.append(("rollout_canary_window_samples",
                     rollout.get("canary_window_samples"), "gauge",
                     "canary latency samples in the SLO window", labels))
    return rows


def router_exposition(snapshot: dict,
                      prefix: str = "tpuic_router",
                      rollout: Optional[dict] = None) -> str:
    """``Router.snapshot()`` -> Prometheus text (serve/router.py,
    docs/serving.md "Replica routing and failover").

    Fleet-level counters (the exact offered-traffic ledger: ``offered ==
    requests + rejected + errors``), the retry budget gauge, end-to-end
    latency quantiles, and per-replica rows — health state and breaker
    state as numeric codes (state: 0=starting 1=up 2=wedged 3=down
    4=failed 5=stopped; breaker: 0=closed 0.5=half_open 1=open) so a
    dashboard can alert on a replica leaving 1/0.  ``rollout`` appends
    the tpuic_rollout_* rows (:func:`rollout_rows`) when a canary
    rollout controller is attached.  No ``process_rss_bytes`` row, as in
    ``tpuic``'s exposition, so both render the same text."""
    rows: List[Tuple] = [
        ("offered_total", snapshot.get("offered"), "counter",
         "requests offered to the router", None),
        ("requests_total", snapshot.get("requests"), "counter",
         "requests resolved with a result", None),
        ("errors_total", snapshot.get("errors"), "counter",
         "untyped request failures (decode errors, bugs)", None),
        ("retries_total", snapshot.get("retries"), "counter",
         "budgeted failover replays", None),
        ("failovers_total", snapshot.get("failovers"), "counter",
         "replica-loss failover events", None),
        ("failover_requeued_total", snapshot.get("failover_requeued"),
         "counter", "in-flight requests requeued to a survivor", None),
        ("failover_lost_total", snapshot.get("failover_lost"), "counter",
         "in-flight requests resolved replica_lost", None),
        ("duplicate_responses_total", snapshot.get("duplicates"),
         "counter", "late/duplicate replica responses dropped by the "
         "at-most-once id dedupe", None),
        ("wire_errors_total", snapshot.get("wire_errors"), "counter",
         "replica lines with an id the router never issued (torn "
         "framing / protocol errors — alert: not benign dedupe)", None),
        ("elapsed_seconds", snapshot.get("elapsed_s"), "gauge",
         "seconds since stats reset", None),
    ]
    for cause, by_prio in (snapshot.get("rejected_by") or {}).items():
        for prio, n in (by_prio or {}).items():
            rows.append(("rejected_total", n, "counter",
                         "typed verdicts by cause (queue_full|deadline|"
                         "quota|brownout|replica_lost) and priority",
                         {"cause": cause, "priority": prio}))
    budget = snapshot.get("retry_budget") or {}
    rows.append(("retry_budget_tokens", budget.get("tokens"), "gauge",
                 "remaining retry-budget tokens (deposits = ratio x "
                 "successes; one whole token per replay)", None))
    rows.append(("retry_budget_denied_total", budget.get("denied"),
                 "counter", "replays denied by a dry retry budget",
                 None))
    for q, v in (snapshot.get("latency_ms") or {}).items():
        rows.append(("latency_ms", v, "gauge",
                     "submit->resolve latency percentiles over the "
                     "sliding window", {"quantile": q}))
    for name, rep in sorted((snapshot.get("replicas") or {}).items()):
        labels = {"replica": name}
        rows.append(("replica_state", _REPLICA_STATE_CODE.get(
            rep.get("state")), "gauge",
            "replica health state (0=starting 1=up 2=wedged 3=down "
            "4=failed 5=stopped)", labels))
        rows.append(("replica_breaker_state", _BREAKER_CODE.get(
            (rep.get("breaker") or {}).get("state")), "gauge",
            "circuit-breaker state (0=closed 0.5=half_open 1=open)",
            labels))
        rows.append(("replica_breaker_transitions_total",
                     (rep.get("breaker") or {}).get("transitions"),
                     "counter", "breaker state transitions", labels))
        rows.append(("replica_inflight", rep.get("inflight"), "gauge",
                     "requests in flight on this replica", labels))
        rows.append(("replica_routed_total", rep.get("routed"),
                     "counter", "requests routed to this replica",
                     labels))
        rows.append(("replica_transport_failures_total",
                     rep.get("transport_failures"), "counter",
                     "transport failures (send errors, ping timeouts, "
                     "connection loss)", labels))
        rows.append(("replica_spill_limit", rep.get("spill_limit"),
                     "gauge", "in-flight ceiling before load spills "
                     "past this replica (Little's law at the committed "
                     "knee)", labels))
        rows.append(("replica_brownout_level", rep.get("brownout_level"),
                     "gauge", "brownout level scraped from the "
                     "replica's own exposition", labels))
        rows.append(("replica_queue_depth", rep.get("queue_depth"),
                     "gauge", "engine queue depth from the last pong",
                     labels))
        rows.append(("replica_heartbeat_age_seconds",
                     rep.get("heartbeat_age_s"), "gauge",
                     "age of the replica's supervisor heartbeat file",
                     labels))
        rows.append(("replica_spawns_total", rep.get("spawns"),
                     "counter", "times this replica was (re)spawned",
                     labels))
        rows.append(("replica_generation", rep.get("generation"),
                     "gauge", "replica weight generation (0 at boot, "
                     "+1 per hot-swap; from the live pong)", labels))
        rows.append(("replica_resolved_total", rep.get("resolved"),
                     "counter", "requests this replica resolved with a "
                     "result", labels))
        rows.append(("replica_typed_rejects_total",
                     rep.get("rejected_typed"), "counter",
                     "typed verdicts this replica returned", labels))
        rows.append(("replica_errors_total", rep.get("resp_errors"),
                     "counter", "untyped error responses from this "
                     "replica (the canary rollback trigger)", labels))
        rows.append(("replica_digest_ok",
                     (None if rep.get("digest") is None
                      else float(bool(rep.get("digest_ok")))), "gauge",
                     "1 = replica's model digest is in the fleet's "
                     "allowed set, 0 = refused traffic by the identity "
                     "gate (absent until the replica reports one)",
                     labels))
        if rep.get("digest"):
            rows.append(("replica_model_info", 1, "gauge",
                         "replica serving-weights identity (digest "
                         "label)", {**labels,
                                    "digest": str(rep["digest"])}))
    if snapshot.get("fleet_digest"):
        rows.append(("fleet_model_info", 1, "gauge",
                     "THE fleet model digest the identity gate "
                     "enforces (docs/serving.md, 'Model lifecycle')",
                     {"digest": str(snapshot["fleet_digest"])}))
    split = snapshot.get("traffic_split")
    rows.append(("traffic_split_fraction",
                 (split or {}).get("fraction"), "gauge",
                 "fraction of picks routed to the canary group (absent "
                 "outside a rollout)", None))
    rows.extend(rollout_rows(rollout))
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
