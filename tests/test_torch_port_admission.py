"""``tpuic_torch.serve.admission`` and the engine's admission side on the
CPU, held against ``tpuic``'s.

- The port's copy of ``admission.py`` against ``tpuic``'s: the same
  ``parse_quotas`` inputs give the same tables or the same errors; the
  same ``admit`` sequence on one stepped clock gives equal ``Decision``s
  and ``state()``s; the same ``BrownoutController.observe`` sequence
  gives equal levels and events.
- The port's ``_PriorityQueue`` against ``tpuic``'s: one put/get script
  gives the same pops, evictions, ``queue.Full`` and ``queue.Empty``; the
  two engines' ``_gather`` shed and batch the same requests.
- The port engine (``tests/test_admission.py``'s contract): typed
  ``AdmissionRejected`` for a quota and a full queue, eviction by a
  higher class, ``DeadlineExceeded`` at pop time with the batchmates
  resolved, accepted + rejected == offered, and ``ValueError`` for a bad
  ``priority`` or ``dtype``.

``tpuic`` is imported inside the tests.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from tpuic_torch.serve import admission as padm
from tpuic_torch.serve.engine import InferenceEngine, _PriorityQueue

SIZE = 4


class _Clock:
    """A monotonic clock the test steps by hand."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _sum_forward(images):
    return images.float().sum(dim=(1, 2, 3))


def _engine(**kw):
    kw.setdefault("forward_fn", _sum_forward)
    kw.setdefault("image_size", SIZE)
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("device", "cpu")
    return InferenceEngine(**kw)


def _imgs(n=1, value=1.0):
    return np.full((n, SIZE, SIZE, 3), value, np.float32)


# -- the copied module against tpuic's ---------------------------------------
@pytest.mark.parametrize("spec", [
    ["a=10", "*=5"], "a=10,b=2.5", [], ["a=1", " b = 3 ", ""], ["*=0.5"],
    ["a"], ["a="], ["a=0"], ["a=-1"], ["=5"], ["a=x"], ["a=1", "a=2"]],
    ids=str)
def test_parse_quotas_matches_tpuic(spec):
    from tpuic.serve import admission as jadm

    def outcome(mod):
        try:
            return mod.parse_quotas(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(padm) == outcome(jadm)
    assert padm.CAUSES == jadm.CAUSES and padm.FREE_POOL == jadm.FREE_POOL
    assert padm.PRIORITIES == jadm.PRIORITIES


@pytest.mark.parametrize("quotas,brownout_level", [
    (["a=2", "*=1"], 0), (["a=1"], 0), (["t=3", "u=0.5"], 1), ([], 2)])
def test_admit_sequence_matches_tpuic(quotas, brownout_level):
    from tpuic.serve import admission as jadm
    rng = np.random.default_rng(len(quotas) + brownout_level)
    script = [(float(rng.choice([0.0, 0.1, 0.3, 1.0])),
               str(rng.choice(["a", "t", "u", "zzz", ""])) or None,
               str(rng.choice(padm.PRIORITIES))) for _ in range(60)]
    ctls = []
    for mod in (padm, jadm):
        clock = _Clock()
        bo = mod.BrownoutController("slo_x")
        for _ in range(brownout_level):
            bo.observe(5.0)
        ctls.append((mod.AdmissionController(mod.parse_quotas(quotas),
                                             brownout=bo, clock=clock),
                     clock))
    for dt, tenant, priority in script:
        got = []
        for ctl, clock in ctls:
            clock.t += dt
            d = ctl.admit(priority=priority, tenant=tenant)
            got.append((bool(d), d.cause))
        assert got[0] == got[1], (dt, tenant, priority)
        assert ctls[0][0].state() == ctls[1][0].state()
    for ctl, _ in ctls:
        with pytest.raises(ValueError, match="unknown priority"):
            ctl.admit(priority="urgent")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brownout_observe_matches_tpuic(seed):
    from tpuic.serve import admission as jadm
    rng = np.random.default_rng(seed)
    burns = rng.choice([0.2, 0.9, 1.0, 1.5, 2.0, 3.0, 8.0], 80)
    runs = []
    for mod in (padm, jadm):
        events = []
        bo = mod.BrownoutController(
            "slo_x", tighten_above=2.0, recover_below=1.0, recover_after=3,
            publish=lambda kind, **d: events.append((kind, d)))
        levels = []
        for b in burns:
            bo.observe(float(b))
            levels.append((bo.level, tuple(bo.sheds(p)
                                           for p in mod.PRIORITIES)))
        runs.append((levels, events, bo.state()))
    assert runs[0] == runs[1]
    for mod in (padm, jadm):
        with pytest.raises(ValueError, match="hysteresis"):
            mod.BrownoutController("x", tighten_above=1.0,
                                   recover_below=2.0)


def test_brownout_attach_takes_any_bus():
    """``attach`` subscribes to ``slo`` events of any object with
    ``subscribe``/``publish``; transitions publish ``admission``."""
    class Ev:
        def __init__(self, **data):
            self.data = data

    class Bus:
        def __init__(self):
            self.subs, self.published = [], []

        def subscribe(self, fn, kinds=()):
            self.subs.append((fn, kinds))
            return lambda: self.subs.remove((fn, kinds))

        def publish(self, kind, **data):
            self.published.append((kind, data))

    bus = Bus()
    bo = padm.BrownoutController("p99", tighten_above=2.0)
    unsub = bo.attach(bus)
    fn, kinds = bus.subs[0]
    assert kinds == ("slo",)
    fn(Ev(name="other", burn_rate=9.0))
    fn(Ev(name="p99", burn_rate=None))
    assert bo.level == 0
    fn(Ev(name="p99", burn_rate=5.0))
    assert bo.level == 1 and bus.published[0][0] == "admission"
    assert bus.published[0][1]["sheds"] == ["low"]
    unsub()
    assert not bus.subs


# -- the priority queue against tpuic's --------------------------------------
class _Item:
    __slots__ = ("pidx", "tag")

    def __init__(self, pidx, tag):
        self.pidx, self.tag = pidx, tag


@pytest.mark.parametrize("seed", range(4))
def test_priority_queue_matches_tpuic(seed):
    from tpuic.serve.engine import _PriorityQueue as JaxQueue
    rng = np.random.default_rng(seed)
    ours, theirs = _PriorityQueue(4), JaxQueue(4)
    trace = []
    for i in range(120):
        step = []
        op = rng.random()
        pidx = int(rng.integers(0, 3))
        for q in (ours, theirs):
            try:
                if op < 0.6:
                    victim = q.put(_Item(pidx, i), timeout=0)
                    step.append(("put", None if victim is None
                                 else victim.tag))
                else:
                    step.append(("get", q.get_nowait().tag))
            except queue.Full:
                step.append("Full")
            except queue.Empty:
                step.append("Empty")
            step.append(q.qsize())
        assert step[:2] == step[2:], (i, step)
        trace.append(step[0])
    kinds = {s if isinstance(s, str) else s[0] for s in trace}
    assert kinds == {"put", "get", "Full", "Empty"}
    assert any(isinstance(s, tuple) and s[0] == "put" and s[1] is not None
               for s in trace)  # evictions happened


def test_gather_sheds_and_batches_like_tpuic():
    """The same submissions (classes, sizes, two expired deadlines) into
    both engines, queued before the batcher runs: ``_gather`` sheds the
    same requests and forms the same batches, highest class first."""
    import jax.numpy as jnp
    from tpuic.serve.engine import InferenceEngine as JaxEngine

    theirs = JaxEngine(forward_fn=lambda v, x: jnp.sum(x, axis=(1, 2, 3)),
                       variables={"b": np.float32(0)}, image_size=SIZE,
                       buckets=(1, 2, 4), max_wait_ms=0.0, autostart=False,
                       queue_size=64)
    ours = _engine(max_wait_ms=0.0, autostart=False, queue_size=64)
    script = [("low", 1, None), ("high", 2, 1.0), ("normal", 3, None),
              ("high", 1, None), ("low", 2, 1.0), ("normal", 1, 60_000.0),
              ("high", 2, None), ("low", 4, None), ("normal", 2, None)]
    futs = {}
    for name, eng in (("ours", ours), ("theirs", theirs)):
        futs[name] = [eng.submit(_imgs(n), priority=p, deadline_ms=d)
                      for p, n, d in script]
    time.sleep(0.05)  # both 1 ms deadlines expire while queued
    batches = {}
    for name, eng in (("ours", ours), ("theirs", theirs)):
        out = []
        while (reqs := eng._gather(0.0)) is not None:
            out.append([r.trace for r in reqs])
        batches[name] = out
    assert batches["ours"] == batches["theirs"]
    assert batches["ours"][0][0] == 4  # the first unshed high leads
    for name in futs:
        shed = [i for i, f in enumerate(futs[name]) if f.done()]
        assert shed == [1, 4], name
        assert all(f.exception().cause == "deadline"
                   for f in (futs[name][1], futs[name][4]))
    assert ours.stats.snapshot()["rejected_by"] == \
        theirs.stats.snapshot()["rejected_by"] == {
            "deadline": {"high": 1, "low": 1}}


# -- the port engine ---------------------------------------------------------
@pytest.mark.parametrize("cause", ["quota", "queue_full"])
def test_typed_rejection_through_the_engine(cause):
    clock = _Clock()
    ctl = padm.AdmissionController(
        padm.parse_quotas(["t1=1"] if cause == "quota" else []), clock=clock)
    eng = _engine(admission=ctl, autostart=False, queue_size=1)
    ok = eng.submit(_imgs(), tenant="t1", timeout=0)
    with pytest.raises(padm.AdmissionRejected) as ei:
        eng.submit(_imgs(), tenant="t1", timeout=0)
    assert ei.value.cause == cause and ei.value.tenant == "t1"
    assert isinstance(ei.value, queue.Full)
    eng.start()
    assert ok.result(timeout=30)[0].shape == (1,)
    eng.close()
    assert eng.stats.snapshot()["rejected_by"] == {cause: {"normal": 1}}


def test_full_queue_evicts_the_youngest_lowest_class():
    eng = _engine(queue_size=2, autostart=False)
    low1 = eng.submit(_imgs(), priority="low")
    low2 = eng.submit(_imgs(), priority="low")
    with pytest.raises(queue.Full):  # same class: plain backpressure
        eng.submit(_imgs(), priority="low", timeout=0)
    high = eng.submit(_imgs(), priority="high", timeout=0)
    with pytest.raises(padm.AdmissionRejected) as ei:
        low2.result(timeout=1)
    assert ei.value.cause == "queue_full" and ei.value.priority == "low"
    assert "evicted" in str(ei.value)
    eng.start()
    assert high.result(timeout=30)[0].shape == (1,)
    assert low1.result(timeout=30)[0].shape == (1,)
    eng.close()
    snap = eng.stats.snapshot()
    assert snap["rejected"] == 2
    assert snap["rejected_by"] == {"queue_full": {"low": 2}}
    assert high.tpuic_trace == 4 and low1.tpuic_trace == 1


def test_expired_deadline_sheds_at_pop_batchmates_resolve():
    eng = _engine(autostart=False, max_wait_ms=0.0)
    doomed = eng.submit(_imgs(), deadline_ms=1.0)
    healthy = [eng.submit(_imgs(value=i + 1)) for i in range(3)]
    time.sleep(0.05)
    eng.start()
    with pytest.raises(padm.DeadlineExceeded) as ei:
        doomed.result(timeout=30)
    assert ei.value.cause == "deadline" and ei.value.priority == "normal"
    for i, f in enumerate(healthy):
        assert f.result(timeout=30)[0][0] == (i + 1) * SIZE * SIZE * 3
    eng.close()
    snap = eng.stats.snapshot()
    assert snap["rejected_by"] == {"deadline": {"normal": 1}}
    assert snap["requests"] == 3


def test_cancelled_request_is_dropped_at_pop():
    """A request whose future its caller cancelled never joins a batch:
    no device call runs for it, and its batchmates resolve."""
    eng = _engine(autostart=False, max_wait_ms=0.0)
    gone = eng.submit(_imgs(value=7))
    kept = eng.submit(_imgs(value=2))
    assert gone.cancel()
    batch = eng._gather(0.01)
    assert [r.future for r in batch] == [kept]
    eng.start()
    eng._resolve(eng._dispatch(batch))
    assert kept.result(timeout=30)[0][0] == 2 * SIZE * SIZE * 3
    eng.close()
    snap = eng.stats.snapshot()
    assert snap["device_calls"] == 1 and snap["rejected_by"] == {}


def test_estimated_service_feeds_the_shedder():
    """After traffic the span ledger gives a positive estimate, and a
    deadline inside it sheds although it has not yet passed at pop."""
    eng = _engine(max_wait_ms=0.0)
    for _ in range(6):
        eng.predict(_imgs(), timeout=30)
    est = eng.stats.estimated_service_s()
    assert est > 0.0
    eng.close()
    eng = InferenceEngine(forward_fn=_sum_forward, image_size=SIZE,
                          buckets=(1,), device="cpu", autostart=False,
                          stats=eng.stats)
    doomed = eng.submit(_imgs(), deadline_ms=60_000.0)
    eng.stats._est, eng.stats._est_t = 120.0, time.monotonic()
    eng.start()
    with pytest.raises(padm.DeadlineExceeded):
        doomed.result(timeout=30)
    eng.close()


def test_accepted_plus_rejected_equals_offered():
    """A low flood from four threads and high requests with deadlines
    against a small queue with a quota: every offer is answered or
    rejected under exactly one cause."""
    ctl = padm.AdmissionController(padm.parse_quotas(["flood=400"]))
    eng = _engine(admission=ctl, queue_size=8, max_wait_ms=1.0)
    outcomes, lock = [], threading.Lock()

    def offer(n, **sla):
        for _ in range(n):
            try:
                fut = eng.submit(_imgs(), timeout=0, **sla)
            except padm.AdmissionRejected as e:
                with lock:
                    outcomes.append(e.cause)
                continue
            try:
                fut.result(timeout=30)
                res = "ok"
            except padm.AdmissionError as e:
                res = e.cause
            with lock:
                outcomes.append(res)

    threads = [threading.Thread(target=offer, args=(60,),
                                kwargs=dict(priority="low", tenant="flood"))
               for _ in range(4)]
    threads.append(threading.Thread(target=offer, args=(20,), kwargs=dict(
        priority="high", deadline_ms=30_000.0)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    eng.close()
    snap = eng.stats.snapshot()
    assert len(outcomes) == 260
    assert outcomes.count("ok") == snap["requests"]
    assert snap["requests"] + snap["rejected"] == 260
    assert sum(v for by in snap["rejected_by"].values()
               for v in by.values()) == snap["rejected"]


@pytest.mark.parametrize("kw,match", [
    (dict(priority="urgent"), "unknown priority"),
    (dict(dtype="int8"), "unknown serve dtype 'int8'"),
    (dict(deadline_ms="soon"), "could not convert")])
def test_bad_sla_fields_raise_before_admission(kw, match):
    clock = _Clock()
    ctl = padm.AdmissionController(padm.parse_quotas(["t=1"]), clock=clock)
    eng = _engine(admission=ctl, autostart=False)
    with pytest.raises(ValueError, match=match):
        eng.submit(_imgs(), tenant="t", **kw)
    # No quota token was spent on the refused request.
    assert ctl.state()["tenant_tokens"]["t"] == 1.0
    fut = eng.submit(_imgs(), tenant="t", dtype="fp32")
    eng.start()
    assert fut.result(timeout=30)[0].shape == (1,)
    eng.close()


def test_served_rows_are_unchanged_by_admission():
    """The same rows through an engine with and without a controller."""
    x = np.random.default_rng(0).standard_normal(
        (3, SIZE, SIZE, 3)).astype(np.float32)
    want = _sum_forward(torch.from_numpy(x)).numpy()
    ctl = padm.AdmissionController(padm.parse_quotas(["*=100"]))
    with _engine(admission=ctl) as eng:
        got = eng.submit(x, priority="high", tenant="any").result(30)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)
