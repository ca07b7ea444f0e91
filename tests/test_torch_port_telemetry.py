"""Port parity: ``tpuic_torch.telemetry`` against ``tpuic.telemetry``.

- The copied modules on the same inputs as their originals: the event
  bus's JSONL round trip (every record but its wall clock), ``slo``
  parsing and attainment, the ``prom`` train exposition byte for byte,
  the goodput buckets over the same event stream and the ``StepTimer``
  summary over the same stamps (both under one scripted clock), and
  TensorBoard files each package's reader decodes from the other's
  writer.
- The port's own pieces: the peak tables (the card's, by its name; none
  for the CPU or an unknown card), ``profile.parse_trace`` on a small
  hand-written Chrome trace with known class totals, the trace trigger's
  bounded windows over ``torch.profiler``.
- A four-step CPU ``Trainer`` of each package publishes the same event
  kinds with the same keys (``tpuic``'s ``compile`` events aside: the
  port's compiles are its ``nvcc`` builds and graph captures, which a CPU
  run has none of; and the goodput report's ``mfu``, which ``tpuic``
  takes against a nominal CPU peak and the port does not report
  without a card).
- The same port run calls ``Tensor.item``, ``Tensor.cpu``,
  ``Tensor.__float__`` and ``torch.cuda.synchronize`` as often with
  telemetry on as with it off.
- The train CLI takes the eight telemetry flags on ``--device cpu`` and
  writes its files.

JAX-only imports are inside fixtures.
"""

import collections
import json
import os

import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.telemetry import events as pev
from tpuic_torch.telemetry import goodput as pgp
from tpuic_torch.telemetry import profile as pprof
from tpuic_torch.telemetry import prom as pprom
from tpuic_torch.telemetry import slo as pslo
from tpuic_torch.telemetry import steptime as pst
from tpuic_torch.telemetry import tracing as ptr
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def jt():
    pytest.importorskip("jax")
    from tpuic.metrics import tensorboard as jtb
    from tpuic.telemetry import events as jev
    from tpuic.telemetry import goodput as jgp
    from tpuic.telemetry import prom as jprom
    from tpuic.telemetry import slo as jslo
    from tpuic.telemetry import steptime as jst
    return dict(ev=jev, gp=jgp, prom=jprom, slo=jslo, st=jst, tb=jtb)


class _Clock:
    """A scripted clock: each read advances by the next step of ``dts``."""

    def __init__(self, dts):
        self.t, self.dts = 1000.0, list(dts)

    def __call__(self):
        if self.dts:
            self.t += self.dts.pop(0)
        return self.t


_STREAM = [
    ("compile", dict(key="backend_compile/nvcc:x", duration_s=0.03)),
    *[("step", dict(step=i + 1, total_ms=50.0 + i, data_ms=10.0,
                    dispatch_ms=1.0, device_ms=39.0 + i)) for i in range(5)],
    ("checkpoint_commit", dict(track="latest", epoch=0, step=4,
                               phase="stage", duration_s=0.01)),
    ("checkpoint_commit", dict(track="latest", epoch=0, step=4,
                               phase="commit", blocking=False,
                               duration_s=0.02)),
    ("skip", dict(step=4, streak=2, delta=2)),
    ("eval", dict(epoch=0, duration_s=0.04)),
    ("drain", dict(duration_s=0.005)),
]


def test_jsonl_round_trip_matches_tpuic(jt, tmp_path):
    recs = []
    for mod, name in ((pev, "port"), (jt["ev"], "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        bus = mod.EventBus()
        sink = mod.JsonlSink(path)
        ms = mod.MemorySink()
        bus.subscribe(sink)
        bus.subscribe(ms, kinds=("step",))
        for kind, data in _STREAM:
            bus.publish(kind, **data)
        sink.close()
        assert [e.data["step"] for e in ms.of("step")] == [1, 2, 3, 4, 5]
        recs.append([{k: v for k, v in r.items() if k != "t"}
                     for r in mod.read_jsonl(path)])
    assert recs[0] == recs[1] and len(recs[0]) == len(_STREAM)
    assert recs[0][0] == {"event": "compile", **_STREAM[0][1]}


@pytest.mark.parametrize("spec", [
    "train_step:p99<=60ms", "train_step:p50<=52ms@0.9",
    "train_step:p95<=51ms@0.5,train_step:p99<=100ms"])
def test_slo_parsing_and_attainment_match_tpuic(jt, spec):
    reports = []
    for mod in (pslo, jt["slo"]):
        objs = mod.parse_objectives(spec, allowed=("train_step",))
        tr = mod.SLOTracker(objs)
        for kind, data in _STREAM:
            if kind == "step":
                tr.on_event(pev.Event("step", 0.0, data))
        reports.append((tr.report(), tr.summary_line(),
                        [tuple(sorted(vars(o).items())) for o in objs]))
    assert reports[0] == reports[1]
    for mod in (pslo, jt["slo"]):
        with pytest.raises(ValueError):
            mod.parse_objectives("serve_latency:p99<=5ms",
                                 allowed=("train_step",))


def _goodput_report(mod_gp, clock, monkeypatch):
    monkeypatch.setattr(mod_gp.time, "monotonic", clock)
    gt = mod_gp.GoodputTracker(flops_per_step=1e9, peak_flops=1e12,
                               global_batch=4, compute_dtype="f32")
    gt.start()
    for kind, data in _STREAM:
        gt.on_event(pev.Event(kind, 0.0, data))
    return gt.report(step=5), gt.summary_line()


def test_goodput_buckets_match_tpuic(jt, monkeypatch):
    port = _goodput_report(pgp, _Clock([0.0] + [0.1] * 8), monkeypatch)
    jax = _goodput_report(jt["gp"], _Clock([0.0] + [0.1] * 8), monkeypatch)
    assert port == jax
    r = port[0]
    assert r["steps"] == 5 and r["skip_s"] > 0
    assert r["compiles"] == 1 and r["checkpoint_s"] == 0.01
    assert r["checkpoint_async_s"] == 0.02 and "mfu" in r


def test_steptime_summary_matches_tpuic(jt, monkeypatch):
    out = []
    for mod in (pst, jt["st"]):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(
            [0.0] + [0.003, 0.011, 0.002, 0.007, 0.013] * 4))
        ms = pev.MemorySink()
        bus = pev.EventBus()
        bus.subscribe(ms)
        timer = mod.StepTimer(bus)
        timer.epoch_start()
        for i, _ in enumerate(timer.wrap_epoch(iter(range(4)))):
            timer.dispatch_start()
            timer.dispatch_end()
            timer.step_end(i + 1)
        out.append(([e.data for e in ms.of("step")], timer.summary()))
    assert out[0] == out[1]
    assert [d["step"] for d in out[0][0]] == [1, 2, 3, 4]


def test_prom_train_exposition_matches_tpuic_byte_for_byte(jt, monkeypatch):
    """Both renders with the RSS row pinned; ``tpuic``'s compiled-program
    registry rows left out (the port has no registry)."""
    report = _goodput_report(pgp, _Clock([0.0] + [0.1] * 8),
                             monkeypatch)[0]
    steptime = {"total_ms": {"p50": 51.0, "p99": 54.0},
                "data_ms": {"p50": 10.0}}
    slo = pslo.SLOTracker(pslo.parse_objectives("train_step:p99<=60ms"))
    slo.on_event(pev.Event("step", 0.0, {"total_ms": 50.0}))
    memory = {"devices": [{"device": "0", "kind": "NVIDIA H100 80GB HBM3",
                           "bytes_in_use": 10, "peak_bytes_in_use": 20,
                           "bytes_limit": 100, "headroom_frac": 0.9}]}
    wf = {"classes": {"matmul": {"ms": 1.5, "frac": 0.6},
                      "overhead": {"ms": 1.0, "frac": 0.4}},
          "device_ms_per_step": 2.5}
    from tpuic.metrics import meters as jmeters
    from tpuic_torch.metrics import meters as pmeters
    monkeypatch.setattr(jmeters, "process_rss_bytes", lambda: 123.0)
    monkeypatch.setattr(pmeters, "process_rss_bytes", lambda: 123.0)
    # tpuic's compiled-program registry rows: the port has no registry.
    monkeypatch.setattr(jt["prom"], "compile_cache_rows", lambda: [])
    texts = [mod.train_exposition(report, steptime, slo=slo.report(),
                                  memory=memory, profile=wf)
             for mod in (pprom, jt["prom"])]
    assert texts[0] == texts[1]
    assert "tpuic_train_device_time_ms{op_class=\"matmul\"} 1.5" in texts[0]


def test_tensorboard_files_cross_read(jt, tmp_path):
    from tpuic_torch.metrics import tensorboard as ptb
    for writer_mod, reader_mod, name in ((ptb, jt["tb"], "p"),
                                         (jt["tb"], ptb, "j")):
        d = str(tmp_path / name)
        w = writer_mod.TensorBoardWriter(d)
        w.scalars(3, loss=0.5, acc=0.25)
        w.close()
        (f,) = os.listdir(d)
        evs = [e for e in reader_mod.read_events(os.path.join(d, f))
               if e.get("scalars")]
        assert evs[0]["step"] == 3
        assert evs[0]["scalars"] == {"loss": 0.5, "acc": 0.25}


def test_peak_tables_are_the_cards():
    h100 = "NVIDIA H100 80GB HBM3"
    assert pgp.peak_flops(h100, "bf16") == 989.4e12
    assert pgp.peak_flops(h100, "f32", tf32=True) == 494.7e12
    assert pgp.peak_flops(h100, "f32", tf32=False) == 66.9e12
    assert pgp.hbm_bandwidth(h100) == 3.35e12
    for name in ("cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB", None):
        assert pgp.peak_flops(name, "bf16") is None
        assert pgp.hbm_bandwidth(name) is None
    assert not any("TPU" in k for k in pgp.PEAK_FLOPS)
    gt = pgp.GoodputTracker(flops_per_step=1e9, peak_flops=None)
    assert gt.mfu(wall_s=1.0) is None and "mfu" not in gt.report()
    with pytest.raises(ValueError):
        pgp.peak_flops(h100, "fp8")


def test_analytic_flops_match_tpuic(jt):
    for name, size, batch in (("vit-s16-moe", 224, 64),
                              ("inceptionv3", 299, 32),
                              ("resnet50", 224, 8), ("vit-tiny-moe", 16, 4),
                              ("unknown", 224, 8)):
        assert pgp.analytic_flops_per_step(name, size, batch) == \
            jt["gp"].analytic_flops_per_step(name, size, batch)
    assert pgp.analytic_flops_per_step("vit-s16-moe", 224, 1) == \
        pytest.approx(3 * 9.2e9)
    # The roofline helpers, copied as they are.
    for flops, nbytes in ((1e9, 1e6), (1e6, 1e9), (0.0, 0.0), (5.0, 0.0)):
        assert pgp.roofline_intensity(flops, nbytes) == \
            jt["gp"].roofline_intensity(flops, nbytes)
        assert pgp.roofline_verdict(flops, nbytes, 989.4e12, 3.35e12) == \
            jt["gp"].roofline_verdict(flops, nbytes, 989.4e12, 3.35e12)
    assert pgp.ridge_intensity(989.4e12, 3.35e12) == \
        jt["gp"].ridge_intensity(989.4e12, 3.35e12)


def test_device_peak_follows_the_tf32_flag(monkeypatch):
    from tpuic_torch.telemetry import wiring
    assert wiring.device_peak(torch.device("cpu"), "bf16") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cuda = torch.device("cuda", 0)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert wiring.device_peak(cuda, "f32") == 66.9e12
        torch.backends.cuda.matmul.allow_tf32 = True
        assert wiring.device_peak(cuda, "f32") == 494.7e12
        assert wiring.device_peak(cuda, "bf16") == 989.4e12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_memory_sampler_reads_the_allocator_once_a_sample(monkeypatch):
    """On the card one ``memory_stats`` read a sample (the peak is its
    ``allocated_bytes.all.peak``), the card's name and limit read once,
    one sample every ``CARD_EVERY`` steps; on the CPU every
    ``CPU_EVERY``."""
    from tpuic_torch.telemetry import memory as pmem
    reads = []

    def stats(dev):
        reads.append(dev)
        return {"allocated_bytes.all.current": 30,
                "allocated_bytes.all.peak": 50,
                "reserved_bytes.all.current": 64}

    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    monkeypatch.setattr(pmem, "_card_label", lambda dev: {
        "device": "0", "kind": "NVIDIA H100 80GB HBM3", "bytes_limit": 100})
    ms = pev.MemorySink()
    bus = pev.EventBus()
    bus.subscribe(ms)
    sampler = pmem.MemorySampler(publish=bus.publish,
                                 device=torch.device("cuda", 0))
    for k in range(2 * pmem.CARD_EVERY):
        sampler.on_event(pev.Event("step", 0.0, {"step": k + 1}))
    got = ms.of("memory")
    assert [e.data["step"] for e in got] == [1, pmem.CARD_EVERY + 1]
    assert len(reads) == 2
    d = got[0].data
    assert (d["bytes_in_use"], d["peak_bytes_in_use"], d["bytes_limit"],
            d["headroom_frac"]) == (30, 50, 100, 0.7)
    assert d["devices"][0]["reserved_bytes"] == 64
    cpu = pmem.MemorySampler(publish=bus.publish, device=torch.device("cpu"))
    assert cpu._every == pmem.CPU_EVERY


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def test_parse_trace_classes_layers_and_idle(tmp_path):
    """Two traced steps: a GEMM and K4f in block0, a K1f in loss, an
    elementwise kernel launched by the autograd engine, a memcpy and an
    NCCL all-reduce; one cudaStreamSynchronize."""
    host = [
        _x("user_annotation", "block0", 0, 100, pid=1, tid=1),
        _x("user_annotation", "loss", 150, 50, pid=1, tid=1),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           300, 50, pid=1, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 5, pid=1, tid=1,
           correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, pid=1, tid=1,
           correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 5, pid=1, tid=1,
           correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 5, pid=1, tid=2,
           correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 400, 5, pid=1, tid=1,
           correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 420, 5, pid=1, tid=1,
           correlation=6),
        _x("cuda_runtime", "cudaStreamSynchronize", 500, 100, pid=1,
           tid=1),
    ]
    dev = [
        _x("kernel", "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n", 30, 1000,
           correlation=1),
        _x("kernel", "void flash_fwd_kernel<64>(FwdParams)", 1030, 500,
           correlation=2),
        _x("kernel", "void xent_fwd_kernel<true>(float const*)", 1600,
           100, correlation=3),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>",
           1700, 200, correlation=4),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1900, 100,
           correlation=5),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2000, 400,
           correlation=6),
    ]
    path = tmp_path / "trace-0000"
    path.mkdir()
    with open(path / "trace.json", "w") as f:
        json.dump({"traceEvents": host + dev}, f)
    wf = pprof.parse_trace(str(path), steps=2)
    assert wf["ops"] == 6
    assert wf["classes"]["matmul"]["ms"] == 0.5
    assert wf["classes"]["port"]["ms"] == 0.3
    assert wf["classes"]["elementwise"]["ms"] == 0.1
    assert wf["classes"]["copy"]["ms"] == 0.05
    assert wf["classes"]["collective"]["ms"] == 0.2
    assert wf["port_kernels"] == {"K4f": 0.25, "K1f": 0.05}
    assert wf["layers"]["block0"] == 0.75
    assert wf["layers"]["loss"] == 0.05
    assert wf["layers"]["backward"] == 0.1
    assert wf["layers"]["(unattributed)"] == 0.25
    # Busy 2.3 ms (30 .. 1530 and 1600 .. 2400 us) of a 2.4 ms span
    # (0 .. 2400 us), per step halved.
    assert wf["busy_ms_per_step"] == 1.15
    assert wf["idle_frac"] == pytest.approx(1 - 2.3 / 2.4, abs=1e-4)
    assert wf["syncs"]["cudaStreamSynchronize"] == 0.5
    anchored = pprof.attribute_device_time(wf, [2.0, 2.2, 1.8])
    assert anchored["stall_ms"] == pytest.approx(2.0 - 1.15, abs=1e-4)
    total = sum(c["ms"] for c in anchored["classes"].values())
    assert total == pytest.approx(2.0, abs=1e-3)
    assert pprof.classify_kernel("void conv_bn_relu_tc_kernel<1>") == "port"
    assert pprof.classify_kernel(
        "cudnn_infer_ampere_scudnn_128x64_relu_interior_nn_v1") == "matmul"
    assert pprof.classify_kernel(
        "void at::native::reduce_kernel<512, 1>") == "reduce"
    # A capture with no device event (the CPU) is no waterfall.
    with open(path / "trace.json", "w") as f:
        json.dump({"traceEvents": host}, f)
    assert pprof.parse_trace(str(path)) is None


def test_trace_trigger_opens_bounded_torch_profiler_windows(tmp_path):
    bus = pev.EventBus()
    ms = pev.MemorySink()
    bus.subscribe(ms)
    seen = []
    trig = ptr.TraceTrigger(str(tmp_path / "tr"), threshold=3.0, warmup=4,
                            trace_steps=2, keep=2, cooldown=2, bus=bus,
                            on_capture=seen.append)
    for i in range(12):
        torch.ones(4).add_(1)
        trig.observe(0.2 if i == 6 else 0.01)
    trig.finish()
    actions = [e.data["action"] for e in ms.of("trace")]
    assert actions == ["started", "stopped"]
    assert trig.fired == 1 and len(seen) == 1
    assert os.path.isfile(os.path.join(seen[0], ptr.TRACE_FILE))
    for _ in range(3):
        trig._force = True
        trig.observe(0.01)
        trig.observe(0.01)
        trig.observe(0.01)
    trig.finish()
    assert not ptr.profiler_on()
    dirs = [d for d in os.listdir(tmp_path / "tr") if d.startswith("trace-")]
    assert len(dirs) <= 2


@pytest.mark.parametrize("preset", [None, "0"])
def test_profiler_tears_cupti_down_unless_told_otherwise(monkeypatch,
                                                         tmp_path, preset):
    # A window must not leave CUPTI attached to the launches after it,
    # and a TEARDOWN_CUPTI the user set stands.
    if preset is None:
        monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    else:
        monkeypatch.setenv("TEARDOWN_CUPTI", preset)
    prof = ptr.start_profiler()
    torch.ones(4).add_(1)
    ptr.stop_profiler(prof, str(tmp_path))
    assert os.environ["TEARDOWN_CUPTI"] == (preset or "1")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("telemetry_data"))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=4,
                               size=20)
    return root


def _port_cfg(folder, tmp, batch=4, **run):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=folder, resize_size=16,
                             batch_size=batch,
                             num_workers=2, shuffle_seed=0, pack=False,
                             native=False),
        model=pcfg.ModelConfig(name="vit-tiny", num_classes=0,
                               dtype="float32"),
        optim=pcfg.OptimConfig(optimizer="adam", learning_rate=1e-3,
                               class_weights=(), milestones=()),
        run=pcfg.RunConfig(epochs=2, ckpt_dir=str(tmp / "cp"),
                           save_period=1, resume=False, log_every_steps=1,
                           max_steps=4, **run))


def _records(path):
    recs = [json.loads(ln) for ln in open(path)]
    keys = collections.defaultdict(set)
    for r in recs:
        keys[r["event"]] |= set(r) - {"t", "final"}
    return recs, keys


def test_trainer_publishes_tpuics_events_with_its_keys(jt, tmp_path):
    """Both Trainers on one folder of 48 train images, global batch 16
    (``tpuic``: 2 a device over the test suite's 8 CPU devices): three
    steps an epoch, so ``max_steps`` 4 stops in epoch 1 after one val
    pass and its saves."""
    from tpuic import config as jcfg
    from tpuic.train.loop import Trainer as JTrainer
    from tpuic_torch.train.loop import Trainer
    import jax
    folder = str(tmp_path / "data")
    make_synthetic_imagefolder(folder, classes=("a", "b", "c"),
                               per_class=16, size=20)
    pj = tmp_path / "port.jsonl"
    port = Trainer(_port_cfg(folder, tmp_path / "p", batch=16,
                             metrics_jsonl=str(pj)), device="cpu",
                   log=lambda m: None)
    port.fit()
    port.telemetry.close()
    jj = tmp_path / "jax.jsonl"
    jax_cfg = jcfg.Config(
        data=jcfg.DataConfig(data_dir=folder, resize_size=16,
                             batch_size=16 // len(jax.devices()),
                             num_workers=2, shuffle_seed=0),
        model=jcfg.ModelConfig(name="vit-tiny", num_classes=0,
                               dtype="float32"),
        optim=jcfg.OptimConfig(optimizer="adam", learning_rate=1e-3,
                               class_weights=(), milestones=()),
        run=jcfg.RunConfig(epochs=2, ckpt_dir=str(tmp_path / "j" / "cp"),
                           save_period=1, resume=False, log_every_steps=1,
                           max_steps=4, metrics_jsonl=str(jj),
                           handle_preemption=False))
    jtrainer = JTrainer(jax_cfg)
    jtrainer.fit()
    jtrainer.telemetry.close()
    precs, pkeys = _records(pj)
    _, jkeys = _records(jj)
    jkinds = set(jkeys) - {"compile", "compile_cache"}
    assert jkinds <= set(pkeys), jkinds - set(pkeys)
    # ``mfu`` aside: ``tpuic`` divides by a nominal 1e12 FLOP/s on the
    # CPU, the port has no CPU peak and reports no MFU there.
    jkeys["goodput"].discard("mfu")
    for kind in jkinds:
        assert pkeys[kind] == jkeys[kind], kind
    steps = [r for r in precs if r["event"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    final = [r for r in precs if r["event"] == "goodput" and r.get("final")]
    assert len(final) == 1
    named = sum(final[0][f"{k}_s"] for k in pgp._BUCKETS)
    assert named + final[0]["other_s"] == pytest.approx(
        final[0]["wall_s"], abs=0.01)


def _count_reads(monkeypatch, folder, tmp, **run):
    from tpuic_torch.train.loop import Trainer
    counts = collections.Counter()

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    trainer = Trainer(_port_cfg(folder, tmp, **run), device="cpu",
                      log=lambda m: None)
    with monkeypatch.context() as m:
        for name in ("item", "cpu", "__float__"):
            m.setattr(torch.Tensor, name,
                      counting(name, getattr(torch.Tensor, name)))
        m.setattr(torch.cuda, "synchronize",
                  counting("synchronize", torch.cuda.synchronize))
        trainer.fit()
    trainer.telemetry.close()
    return counts


def test_telemetry_adds_no_host_reads(monkeypatch, folder, tmp_path):
    off = _count_reads(monkeypatch, folder, tmp_path / "off")
    on = _count_reads(monkeypatch, folder, tmp_path / "on",
                      metrics_jsonl=str(tmp_path / "on.jsonl"),
                      trace_dir=str(tmp_path / "tr"), trace_threshold=0.0,
                      trace_analyze=True, slo="train_step:p99<=60000ms")
    assert off == on
    assert off["__float__"] > 0  # the deferred drain's reads are seen
    recs, _ = _records(tmp_path / "on.jsonl")
    assert {"step", "epoch", "eval", "goodput", "checkpoint_commit",
            "memory"} <= {r["event"] for r in recs}


def test_train_cli_takes_the_telemetry_flags(folder, tmp_path, capsys,
                                             monkeypatch):
    from tpuic_torch.train.__main__ import build_parser, main
    out = tmp_path / "run"
    # TPUIC_TRACE forces one window at once (here: once --profile-dir's
    # first epoch has stopped recording).
    monkeypatch.setenv("TPUIC_TRACE", str(out / "traces"))
    argv = ["--datadir", folder, "--device", "cpu", "--dtype", "float32",
            "--no-pack", "--no-native", "--model", "vit-tiny-moe",
            "--resize", "16", "--batchsize", "4", "--epochs", "2",
            "--no-class-weights", "--milestones", "--workers", "2",
            "--log-every-steps", "1", "--ckpt-dir", str(out / "cp"),
            "--metrics-jsonl", str(out / "events.jsonl"),
            "--trace-dir", str(out / "traces"), "--trace-threshold", "1.0",
            "--trace-steps", "1", "--trace-analyze",
            "--prom-dump", str(out / "train.prom"),
            "--slo", "train_step:p99<=60000ms",
            "--profile-dir", str(out / "profile")]
    args = build_parser().parse_args(argv)
    assert (args.trace_steps, args.trace_threshold) == (1, 1.0)
    assert main(argv) == 0
    printed = capsys.readouterr().out
    assert "[slo] train_step_p99" in printed and "[goodput]" in printed
    recs, _ = _records(out / "events.jsonl")
    kinds = collections.Counter(r["event"] for r in recs)
    assert kinds["step"] == 6 and kinds["epoch"] == 2 and kinds["eval"] == 2
    # --profile-dir traced epoch 0; the forced window waited for it.
    assert os.path.isfile(out / "profile" / "epoch0" / "trace.json")
    assert kinds["trace"] >= 2
    assert any(r["event"] == "profile" and r.get("final") for r in recs)
    prom = (out / "train.prom").read_text()
    assert "tpuic_train_goodput_fraction{bucket=\"productive\"}" in prom
    assert "tpuic_train_slo_attainment" in prom
    with pytest.raises(SystemExit, match="--slo"):
        main(argv[:-4] + ["--slo", "serve_latency:p99<=5ms"])
    # A flag still to port fails by name beside the telemetry flags.
    with pytest.raises(SystemExit, match="not yet ported.*mesh.fsdp"):
        main(argv + ["--fsdp"])
