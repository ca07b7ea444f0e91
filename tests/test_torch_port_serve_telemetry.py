"""The operated serving replica on the CPU: ``tpuic_torch.telemetry.prom``'s
serving half against ``tpuic``'s, the engine's events and fault points,
and the serve CLI's ``--slo``, ``--brownout-*`` and ``--prom-*``.

- ``serve_exposition`` and ``admission_rows`` of both packages render the
  same text from the same snapshot dict (with SLO, admission, memory and
  waterfall inputs), but for the process-RSS value and the compile-cache
  rows, which read each process's own state (the port's: its CUDA-graph
  table, under ``tpuic``'s four row names).  ``PromServer`` serves the
  collector's text on ``/metrics``.  ``ServeStats.snapshot()`` has
  ``tpuic``'s keys.
- A small ResNet served on the CPU publishes ``serve_batch``,
  ``serve_span`` and ``swap`` events with ``tpuic``'s field sets (taken
  from ``tpuic``'s engine in the same test); a span's six phases sum to
  its ``total_ms``; no ``serve_span`` is published (nor its dict built)
  while nothing subscribes to the kind.
- ``hang_device`` stalls a device call; ``canary_degrade`` fires only on
  weights other than the boot weights, as in ``tests/test_serve.py``.
- The serve CLI (engine stubbed, as ``tpuic``'s CLI tests stub it): the
  ``flood`` storm with a quota, brownout tightening under it with the
  rejects and the brownout gauge in ``--prom-dump``, the exposition of a
  ``--watch --once`` run, ``--prom-port``'s ``/metrics`` while serving,
  and the start-time errors.
- On the card (``cuda``): the measured waterfall beside the engine's
  graphs; skips here.

``tpuic`` and JAX are imported inside fixtures.
"""

import io
import json
import os
import re
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import tpuic_torch.serve.__main__ as pserve
from tpuic_torch.checkpoint.convert import init_params
from tpuic_torch.models import create_model
from tpuic_torch.runtime import faults as pf
from tpuic_torch.serve import InferenceEngine
from tpuic_torch.serve import engine as peng
from tpuic_torch.serve.admission import AdmissionController, BrownoutController
from tpuic_torch.serve.metrics import SPAN_PHASES, ServeStats
from tpuic_torch.telemetry import events as pev
from tpuic_torch.telemetry import prom as pprom
from tpuic_torch.telemetry.slo import SLOTracker, parse_objectives
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 16


@pytest.fixture(scope="module")
def jt():
    pytest.importorskip("jax")
    from tpuic.serve import metrics as jmetrics
    from tpuic.telemetry import prom as jprom
    return types.SimpleNamespace(prom=jprom, metrics=jmetrics)


# -- the exposition ----------------------------------------------------------
def _stats() -> ServeStats:
    st = ServeStats()
    st.record_compile(1, 0.5)
    st.record_compile(8, 0.75)
    for i in range(40):
        st.record_dispatch(8 if i % 3 else 1, 1 + i % 8, [0.001 * (i % 7)])
        st.record_done(1, 1 + i % 8, [0.002 * (1 + i % 11)])
        st.record_spans([0.0001 * (1 + (i + k) % 5) for k in range(6)])
    st.record_reject("queue_full", "low")
    st.record_reject("brownout", "low")
    st.record_reject("deadline", "high")
    st.note_identity("0a1b2c3d", 0)
    st.record_swap(1, "deadbeef")
    return st


def _inputs():
    slo = SLOTracker(parse_objectives(
        "serve_latency:p99<=5ms,serve_latency:p50<=1ms@0.9",
        allowed=("serve_latency",)))
    bus = pev.EventBus()
    slo.attach(bus)
    for i in range(100):
        bus.publish("serve_span", total_ms=0.5 + 0.1 * (i % 70))
    ctl = AdmissionController({"teamA": 5.0, "*": 20.0},
                              brownout=BrownoutController(
                                  "serve_latency_p99", tighten_above=1.5))
    ctl.brownout.observe(3.0)
    memory = {"devices": [{"device": "0", "kind": "H100",
                           "bytes_in_use": 1 << 30,
                           "peak_bytes_in_use": 3 << 30,
                           "bytes_limit": 80 << 30,
                           "headroom_frac": 0.9875}]}
    profile = {"classes": {"port": {"ms": 2.5, "frac": 0.625},
                           "copy": {"ms": 0.5, "frac": 0.125},
                           "overhead": {"ms": 1.0, "frac": 0.25}},
               "device_ms_per_step": 4.0}
    return dict(slo=slo.report(), admission=ctl.state(), memory=memory,
                profile=profile)


def _strip(text: str) -> str:
    """The exposition without the RSS value and the compile-cache rows:
    the parts that read the rendering process's own state."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("tpuic_serve_process_rss_bytes")
                     and "compile_cache_" not in ln)


@pytest.mark.parametrize("extras", ["none", "heartbeat", "all"])
def test_serve_exposition_matches_tpuic(jt, extras):
    snap = _stats().snapshot()
    kw = {} if extras == "none" else {"heartbeat_age_s": 0.25}
    if extras == "all":
        kw.update(_inputs())
    mine = pprom.serve_exposition(snap, compile_cache={
        "hits": 12, "misses": 3, "prewarmed": 3, "entries": 3}, **kw)
    theirs = jt.prom.serve_exposition(snap, **kw)
    assert _strip(mine) == _strip(theirs)
    for name in ("hits_total", "misses_total", "prewarmed_total",
                 "entries"):
        assert f"tpuic_serve_compile_cache_{name} " in mine
    assert "tpuic_serve_compile_cache_hits_total 12" in mine
    assert "CUDA graph" in mine
    if extras == "all":
        for row in ('tpuic_serve_rejected_total{cause="brownout",'
                    'priority="low"} 1',
                    'tpuic_serve_brownout_level{slo="serve_latency_p99"} 1',
                    'tpuic_serve_device_time_ms{op_class="port"} 2.5',
                    'tpuic_serve_quota_tokens{tenant="teamA"}',
                    'tpuic_serve_device_memory_bytes{device="0",'
                    'kind="limit"}', "tpuic_serve_slo_burn_rate"):
            assert row in mine, row


@pytest.mark.parametrize("admission", [False, True])
def test_admission_rows_match_tpuic(jt, admission):
    snap = _stats().snapshot()
    state = _inputs()["admission"] if admission else None
    assert pprom.admission_rows(snap, state) == \
        jt.prom.admission_rows(snap, state)


def test_compile_cache_rows_keep_tpuics_names(jt):
    mine = [r[0] for r in pprom.compile_cache_rows({})]
    theirs = [r[0] for r in jt.prom.compile_cache_rows()]
    assert mine == theirs
    assert pprom.compile_cache_rows(None) == []


def test_serve_stats_snapshot_keys_match_tpuic(jt):
    mine, theirs = ServeStats(), jt.metrics.ServeStats()
    for st in (mine, theirs):
        st.record_dispatch(8, 5, [0.001])
        st.record_done(1, 5, [0.002])
        st.record_spans([0.0001] * 6)
        st.record_reject("deadline", "high")
    a, b = mine.snapshot(), theirs.snapshot()
    assert set(a) == set(b)
    assert set(a["span_ms"]) == set(b["span_ms"])
    assert SPAN_PHASES == jt.metrics.SPAN_PHASES


def test_prom_server_serves_metrics():
    calls = {"n": 0}

    def collect():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("collector bug")
        return "tpuic_serve_requests_total 3\n"

    srv = pprom.PromServer(0, collect)
    try:
        url = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(url + "/metrics", timeout=5).read()
        assert body.decode() == "tpuic_serve_requests_total 3\n"
        with pytest.raises(urllib.error.HTTPError, match="500"):
            urllib.request.urlopen(url + "/metrics", timeout=5)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(url + "/other", timeout=5)
    finally:
        srv.close()


# -- the engine's events -------------------------------------------------------
@pytest.fixture(scope="module")
def tpuic_fields(jt):
    """``tpuic``'s field set of each serving event kind, from its own
    engine (a tiny forward) serving and swapping."""
    import jax.numpy as jnp

    from tpuic.serve import InferenceEngine as JEngine
    from tpuic.telemetry import events as jev

    def fwd(variables, images):
        return jnp.sum(images, axis=(1, 2, 3)) + variables["bias"]

    sink = jev.MemorySink()
    unsub = jev.bus.subscribe(sink)
    eng = JEngine(forward_fn=fwd, variables={"bias": jnp.float32(0.0)},
                  image_size=4, buckets=(1, 2), max_wait_ms=0.0)
    try:
        eng.warmup()
        eng.predict(np.zeros((1, 4, 4, 3), np.float32))
        eng.swap_weights({"bias": jnp.float32(1.0)})
    finally:
        eng.close()
        unsub()
    return {k: set(sink.of(k)[0].data) for k in ("serve_batch", "serve_span",
                                                  "swap")}


def _resnet(seed: int):
    return init_params(create_model("resnet18", 3, dtype="float32",
                                    fused_conv_bn=True, device="cpu"),
                       seed, device="cpu").eval()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)


@pytest.fixture(scope="module")
def small_engine():
    eng = InferenceEngine(_resnet(1), image_size=SIZE, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 4), max_wait_ms=0.0,
                          device="cpu")
    eng.warmup()
    yield eng
    eng.close()


def test_engine_events_carry_tpuics_fields(tpuic_fields, small_engine):
    eng = small_engine
    sink = pev.MemorySink()
    unsub = pev.bus.subscribe(sink)
    try:
        futs = [eng.submit(_images(n, n)) for n in (1, 3, 2)]
        for f in futs:
            f.result(60)
        res = eng.swap_weights(_resnet(2))
        eng.predict(_images(2, 9))
        eng.swap_weights(_resnet(1))
    finally:
        unsub()
    for kind in ("serve_batch", "serve_span", "swap"):
        recs = sink.of(kind)
        assert recs, kind
        assert all(set(ev.data) == tpuic_fields[kind] for ev in recs), kind
    spans = sink.of("serve_span")
    assert len(spans) == 4 and {s.data["rows"] for s in spans} == {1, 2, 3}
    for ev in spans:
        d = ev.data
        assert abs(sum(d[f"{p}_ms"] for p in SPAN_PHASES)
                   - d["total_ms"]) < 1e-3
    swap = sink.of("swap")[0].data
    assert (swap["generation"], swap["digest"]) == (res["generation"],
                                                    res["digest"])
    batches = sink.of("serve_batch")
    assert sum(b.data["images"] for b in batches) == 1 + 3 + 2 + 2
    assert {b.data["variant"] for b in batches} == {"fp32"}


def test_no_serve_span_is_built_without_a_subscriber(small_engine,
                                                     monkeypatch):
    published = []
    real = peng._tm_publish

    def record(kind, **data):
        published.append(kind)
        return real(kind, **data)

    monkeypatch.setattr(peng, "_tm_publish", record)
    assert not pev.bus.active("serve_span")
    unsub = pev.bus.subscribe(lambda ev: None, kinds=("serve_batch",))
    try:
        small_engine.predict(_images(3, 4))
        assert "serve_batch" in published and "serve_span" not in published
        unsub2 = pev.bus.subscribe(lambda ev: None, kinds=("serve_span",))
        try:
            small_engine.predict(_images(1, 5))
        finally:
            unsub2()
        assert published.count("serve_span") == 1
    finally:
        unsub()


def test_hang_device_stalls_one_device_call(small_engine):
    pf.reset()
    pf.arm("hang_device", times=1, param=0.3)
    try:
        t0 = time.perf_counter()
        probs, _ = small_engine.predict(_images(1, 6))
        assert time.perf_counter() - t0 >= 0.3 and probs.shape == (1, 3)
        assert pf.fired("hang_device") == 1
        t0 = time.perf_counter()
        small_engine.predict(_images(1, 7))
        assert pf.fired("hang_device") == 1
    finally:
        pf.reset()


def test_canary_degrade_fires_only_on_non_boot_weights(small_engine):
    eng = small_engine
    boot = {k: v.clone() for k, v in eng.model.state_dict().items()}
    pf.reset()
    pf.arm("canary_degrade", param=0.0)  # 0 s: a count-only firing
    try:
        eng.predict(_images(1, 1))
        assert pf.fired("canary_degrade") == 0
        eng.swap_weights(_resnet(3))
        eng.predict(_images(1, 2))
        n = pf.fired("canary_degrade")
        assert n >= 1
        eng.swap_weights(boot)  # the boot weights back
        assert eng.model_digest == eng._boot_digest
        eng.predict(_images(1, 3))
        assert pf.fired("canary_degrade") == n
    finally:
        pf.reset()


def test_cpu_engine_has_no_graphs_and_no_window(small_engine):
    eng = small_engine
    assert not eng.waterfall
    c = eng.graph_cache_counters()
    assert c == {"hits": 0, "misses": 0, "prewarmed": 0, "entries": 0}
    assert eng.profile_waterfall() is None


def test_profile_waterfall_rescales_onto_the_device_span():
    """The window's per-replay classes are anchored on the measured
    ``device`` span (``attribute_device_time``): the classes then sum to
    the mean device span, the excess booked to ``overhead``."""
    eng = InferenceEngine(_resnet(1), image_size=SIZE, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 4), device="cpu",
                          autostart=False)
    eng._gen.waterfall = {
        "classes": {"port": {"ms": 1.5, "frac": 0.75},
                    "copy": {"ms": 0.5, "frac": 0.25}},
        "busy_ms_per_step": 2.0, "bucket": 4, "gen": 0}
    got = eng.profile_waterfall()
    assert got["classes"]["port"]["ms"] == 1.5 and "stall_ms" not in got
    for ms in (3.0, 5.0):
        eng.stats.record_spans([0, 0, 0, 0, ms / 1000.0, 0])
    got = eng.profile_waterfall()
    assert got["device_ms_per_step"] == 4.0 and got["stall_ms"] == 2.0
    assert sum(c["ms"] for c in got["classes"].values()) == \
        pytest.approx(4.0)
    assert (got["bucket"], got["gen"]) == (4, 0)
    eng.close()


# -- the serve CLI -------------------------------------------------------------
def _toy_engine(**kw):
    def fwd(images):
        s = images.float().sum(dim=(1, 2, 3))
        probs = torch.softmax(torch.stack([s, -s], -1) * 1e-3, -1)
        return probs, torch.argsort(-probs, dim=-1, stable=True)

    eng = InferenceEngine(forward_fn=fwd, image_size=SIZE,
                          input_dtype=np.uint8, buckets=(1, 2, 4),
                          device="cpu", **kw)
    eng.warmup()
    return eng


@pytest.fixture
def stub_engine(monkeypatch):
    def fake_build_engine(args):
        return _toy_engine(max_wait_ms=2.0, queue_size=args.queue_size), \
            SIZE, 2, "stub"

    monkeypatch.setattr(pserve, "build_engine", fake_build_engine)


def _png(path, seed=0):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3),
                                 np.uint8)).save(path)
    return str(path)


def test_cli_admission_flags_and_flood(stub_engine, tmp_path, monkeypatch,
                                       capsys):
    """As ``tests/test_admission.py``'s: SLA fields ride the request
    lines, a dry quota is a typed error line, the 'flood' point storms
    from inside the server, and the exit summary has the [admission]
    line."""
    img = _png(tmp_path / "im.png", 11)
    lines = [{"id": "hi", "path": img, "priority": "high",
              "deadline_ms": 60000, "tenant": "t1"},
             {"id": "q1", "path": img, "tenant": "capped"},
             {"id": "q2", "path": img, "tenant": "capped"},
             {"id": "typo", "path": img, "priority": "urgent"}]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in lines)))
    pf.reset()
    pf.arm("flood", param=200.0)
    out = tmp_path / "resp.jsonl"
    try:
        assert pserve.main(["--device", "cpu", "--out", str(out),
                            "--num-classes", "2", "--quota",
                            "capped=1"]) == 0
    finally:
        pf.reset()
    got = {r["id"]: r for r in map(json.loads,
                                   out.read_text().splitlines())}
    assert got["hi"]["pred"] in {"0", "1"}
    quota = [r for r in (got["q1"], got["q2"]) if "error" in r]
    assert len(quota) == 1 and quota[0]["cause"] == "quota"
    assert "unknown priority" in got["typo"]["error"]
    err = capsys.readouterr().err
    assert "fault 'flood' armed" in err
    assert "[admission]" in err and "rejected_by" in err


def test_cli_brownout_tightens_under_the_flood(stub_engine, tmp_path,
                                               monkeypatch, capsys):
    """A blown ``--slo`` coupled to ``--brownout-slo``: under the flood
    the brownout tightens (its 'admission' event and the exposition's
    gauge), the flood's low class is shed with cause ``brownout``, a high
    request is still answered, and ``--prom-dump`` carries the SLO,
    reject and graph rows."""
    img = _png(tmp_path / "im.png", 3)
    read_fd, write_fd = os.pipe()

    def feed():
        with os.fdopen(write_fd, "w") as w:
            time.sleep(1.5)  # the storm burns the SLO meanwhile
            w.write(json.dumps({"id": "hi", "path": img,
                                "priority": "high"}) + "\n")
            w.flush()
            time.sleep(0.5)

    feeder = threading.Thread(target=feed)
    feeder.start()
    monkeypatch.setattr(sys, "stdin", os.fdopen(read_fd))
    sink = pev.MemorySink()
    unsub = pev.bus.subscribe(sink, kinds=("admission",))
    pf.reset()
    pf.arm("flood", param=400.0)
    dump, out = tmp_path / "m.prom", tmp_path / "out.jsonl"
    try:
        assert pserve.main([
            "--device", "cpu", "--num-classes", "2", "--out", str(out),
            "--queue-size", "16", "--slo", "serve_latency:p99<=0.01ms",
            "--brownout-slo", "serve_latency_p99", "--brownout-tighten",
            "1.5", "--prom-dump", str(dump)]) == 0
    finally:
        pf.reset()
        unsub()
        feeder.join(timeout=30)
    assert not feeder.is_alive()
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["id"] for r in recs] == ["hi"] and "pred" in recs[0]
    assert any(e.data["action"] == "tighten" for e in sink.of("admission"))
    text = dump.read_text()
    assert re.search(r'tpuic_serve_brownout_level\{slo="serve_latency_p99"\}'
                     r' [12]', text)
    assert 'tpuic_serve_rejected_total{cause="brownout",priority="low"}' \
        in text
    for row in ('tpuic_serve_slo_burn_rate{slo="serve_latency_p99"}',
                'tpuic_serve_latency_ms{quantile="p99"}',
                "tpuic_serve_compile_cache_entries 0",
                "tpuic_serve_process_rss_bytes"):
        assert row in text, row
    err = capsys.readouterr().err
    assert "[serve] slo: serve_latency_p99" in err
    assert not pev.bus.active("serve_span")  # the CLI unsubscribed


def test_cli_prom_dump_of_a_watch_run(stub_engine, tmp_path):
    """As ``tests/test_telemetry.py``'s: the exposition of a ``--watch
    --once`` run carries the queue-wait, latency and pad rows."""
    watch = tmp_path / "incoming"
    watch.mkdir()
    for i in range(4):
        _png(watch / f"im_{i}.png", i)
    dump = tmp_path / "metrics.prom"
    assert pserve.main(["--device", "cpu", "--watch", str(watch), "--once",
                        "--out", str(tmp_path / "resp.jsonl"),
                        "--num-classes", "2", "--prom-dump",
                        str(dump)]) == 0
    text = dump.read_text()
    assert 'tpuic_serve_queue_wait_ms{quantile="p50"}' in text
    assert 'tpuic_serve_latency_ms{quantile="p95"}' in text
    assert "tpuic_serve_pad_efficiency " in text
    assert "tpuic_serve_images_total 4" in text


def test_cli_prom_port_serves_metrics_while_listening(stub_engine, tmp_path,
                                                     monkeypatch):
    """``--listen`` with ``--prom-port -1``: the ready file names the
    bound metrics port, and a scrape carries the served request.  The
    server runs on a thread here, so its SIGTERM latch is a stand-in the
    test sets."""
    import socket

    from tpuic_torch.runtime import preemption
    from tpuic_torch.serve import wire
    stop = threading.Event()

    class Latch:
        def __init__(self, *a, **kw):
            pass

        def install(self):
            return self

        def uninstall(self):
            pass

        @property
        def triggered(self):
            return stop.is_set()

    monkeypatch.setattr(preemption, "PreemptionGuard", Latch)
    ready = tmp_path / "ready.json"
    box = {}
    server = threading.Thread(target=lambda: box.update(rc=pserve.main([
        "--device", "cpu", "--num-classes", "2", "--listen",
        "127.0.0.1:0", "--ready-file", str(ready), "--prom-port", "-1"])))
    server.start()
    try:
        deadline = time.monotonic() + 60
        while (info := wire.read_ready_file(str(ready))) is None:
            assert time.monotonic() < deadline and server.is_alive()
            time.sleep(0.05)
        assert info["prom_port"] > 0
        with socket.create_connection(("127.0.0.1", info["port"]),
                                      timeout=30) as sock:
            sock.sendall((json.dumps({"id": "a", **wire.encode_array(
                _images(1))}) + "\n").encode())
            buf = b""
            while b"\n" not in buf:
                buf += sock.recv(4096)
        assert json.loads(buf.split(b"\n")[0])["id"] == "a"
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{info['prom_port']}/metrics",
            timeout=10).read().decode()
        assert "tpuic_serve_requests_total 1" in body
        assert "tpuic_serve_compile_cache_hits_total" in body
    finally:
        stop.set()
        server.join(timeout=60)
    assert box.get("rc") == 0


@pytest.mark.parametrize("argv,match", [
    (["--brownout-slo", "serve_latency_p99"],
     "--brownout-slo 'serve_latency_p99' names no --slo objective"),
    (["--slo", "serve_latency:p99<=5ms", "--brownout-slo", "p50"],
     "names no --slo objective \\(configured: serve_latency_p99\\)"),
    (["--slo", "train_step:p99<=5ms"], "--slo"),
    (["--slo", "serve_latency:p99<5"], "--slo")])
def test_cli_start_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        pserve.main(["--device", "cpu", "--num-classes", "2"] + argv)


# -- on the card ---------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_waterfall_window_beside_graph_replays():
    """The measured waterfall beside the engine's CUDA graphs: after the
    warmup's window and after a swap's, the largest bucket's replays are
    bit for bit an eager forward; the window's kernel classes are the
    port's K3 (``port``) and the rest, and the rescaled classes sum to
    the device span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine captures CUDA graphs "
                    "and the window traces their kernels")
    from tpuic_torch.serve import make_forward
    model = init_params(create_model("resnet18", 10, dtype="float32",
                                     fused_conv_bn=True, device="cuda"), 1,
                        device="cuda").eval()
    eng = InferenceEngine(model, image_size=64, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 8), waterfall=True)
    try:
        eng.warmup()
        wf = eng.profile_waterfall()
        assert wf["bucket"] == 8 and wf["gen"] == 0
        assert wf["classes"]["port"]["ms"] > 0
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (8, 64, 64, 3), np.uint8)
        x = torch.from_numpy(imgs).cuda()
        eager = make_forward(model, normalize=True)(x)
        for _ in range(2):
            got = [t.clone() for t in eng.replay(8, x)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, eager))
            res = eng.swap_weights(init_params(create_model(
                "resnet18", 10, dtype="float32", fused_conv_bn=True,
                device="cuda"), 1, device="cuda").eval())
            assert eng.profile_waterfall()["gen"] in (res["generation"], 0)
        eng.predict(imgs)
        wf = eng.profile_waterfall()
        total = sum(c["ms"] for c in wf["classes"].values())
        assert total == pytest.approx(max(wf["device_ms_per_step"],
                                          wf["busy_ms_per_step"]), rel=1e-3)
    finally:
        eng.close()
