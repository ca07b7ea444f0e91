"""``tpuic_torch.serve.InferenceEngine`` on the CPU (``device="cpu"``).

The engine's results are held against a direct forward on the same rows
(1e-5: the only difference is the batch a row was computed in), its
counters against ``tpuic``'s snapshot keys, and — the slice as a whole —
a fused ResNet served by the port against ``tpuic``'s forward on the
same flax variables and the same uint8 images (1e-4, the fused-kernel
pin of tests/test_kernels.py).
"""

import queue
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from tpuic_torch.checkpoint import init_synthetic
from tpuic_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tpuic_torch.models import create_model
from tpuic_torch.serve.engine import (InferenceEngine, _Request,
                                      default_buckets, make_forward)
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

SIZE = 16


@pytest.fixture(scope="module")
def model():
    m = create_model("resnet18-cifar", 10, dtype="float32",
                     fused_conv_bn=True, device="cpu")
    init_synthetic(m, seed=0, device="cpu")
    return m.eval()


def _engine(model, **kw):
    kw.setdefault("image_size", SIZE)
    kw.setdefault("buckets", (1, 4, 8))
    kw.setdefault("device", "cpu")
    return InferenceEngine(model, **kw)


def _u8(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def test_mixed_sizes_from_threads_resolve_to_their_own_rows(model):
    direct = make_forward(model, normalize=True)
    eng = _engine(model, input_dtype=np.uint8, normalize=True,
                  max_wait_ms=2.0)
    eng.warmup()
    results, errors = {}, []

    def client(tid):
        rng = np.random.default_rng(100 + tid)
        try:
            for i in range(6):
                n = int(rng.integers(1, 6))
                imgs = _u8(1000 * tid + i, n)
                results[(tid, i)] = (imgs, eng.submit(imgs))
        except Exception as e:  # pragma: no cover — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    for imgs, fut in results.values():
        probs, order = fut.result(timeout=60)
        assert probs.shape == (imgs.shape[0], 10)
        assert order.shape == (imgs.shape[0], 10)
        want_p, want_o = direct(torch.from_numpy(imgs))
        np.testing.assert_allclose(probs, want_p.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(order[:, 0], want_o[:, 0].numpy())
    eng.close()
    snap = eng.stats.snapshot()
    assert snap["requests"] == len(results)
    assert snap["images"] == sum(i.shape[0] for i, _ in results.values())
    assert set(snap["batch_hist"]) <= {"1", "4", "8"}
    assert snap["compiles"] == 3


def test_padding_rows_never_leak(model):
    eng = _engine(model, autostart=False)
    x = np.random.default_rng(0).standard_normal((3, SIZE, SIZE, 3)).astype(
        np.float32)
    fut = eng.submit(x)
    inflight = eng._dispatch(eng._gather(0.0))
    assert inflight[2] == 4  # padded to the 4 bucket
    eng._resolve(inflight)
    probs, order = fut.result(timeout=10)
    assert probs.shape == (3, 10) and order.shape == (3, 10)
    want, _ = make_forward(model)(torch.from_numpy(x))
    np.testing.assert_allclose(probs, want.numpy(), rtol=1e-5, atol=1e-5)
    assert eng.stats.pad_efficiency_rows() == (3, 1)


def test_overflow_request_is_held_and_leads_the_next_batch(model):
    eng = _engine(model, autostart=False, max_wait_ms=50.0)
    a, b = (np.zeros((5, SIZE, SIZE, 3), np.float32) for _ in range(2))
    fa, fb = eng.submit(a), eng.submit(b)
    first = eng._gather(0.0)
    assert [r.future for r in first] == [fa] and eng._held.future is fb
    second = eng._gather(0.0)
    assert [r.future for r in second] == [fb] and eng._held is None


def test_oversize_and_closed_engine_raise(model):
    eng = _engine(model)
    with pytest.raises(ValueError, match="exceeds max bucket 8"):
        eng.submit(np.zeros((9, SIZE, SIZE, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        eng.submit(np.zeros((1, SIZE + 1, SIZE, 3), np.float32))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros((1, SIZE, SIZE, 3), np.float32))


def test_full_queue_raises_and_counts(model):
    eng = _engine(model, autostart=False, queue_size=1)
    eng.submit(np.zeros((1, SIZE, SIZE, 3), np.float32))
    with pytest.raises(queue.Full):
        eng.submit(np.zeros((1, SIZE, SIZE, 3), np.float32), timeout=0)
    assert eng.stats.snapshot()["rejected_by"] == {
        "queue_full": {"normal": 1}}


class _BoomArray:
    """Looks like a [1,S,S,C] array; detonates when np materializes it."""
    shape = (1, SIZE, SIZE, 3)

    def __array__(self, *a, **k):
        raise RuntimeError("boom: unmaterializable request")


def _sum_forward(images):
    return images.float().sum(dim=(1, 2, 3))


def test_dispatch_isolates_bad_request_from_batchmates():
    eng = InferenceEngine(forward_fn=_sum_forward, image_size=SIZE,
                          buckets=(1, 2, 4, 8), autostart=False,
                          device="cpu")
    good1 = _Request(np.full((1, SIZE, SIZE, 3), 1, np.float32), Future())
    bad = _Request(_BoomArray(), Future())
    good2 = _Request(np.full((1, SIZE, SIZE, 3), 2, np.float32), Future())
    inflight = eng._dispatch([good1, bad, good2])
    assert inflight is not None and inflight[2] == 2  # survivors re-bucket
    eng._resolve(inflight)
    assert isinstance(bad.future.exception(), RuntimeError)
    np.testing.assert_allclose(good1.future.result(timeout=1)[0],
                               [SIZE * SIZE * 3 * 1.0])
    np.testing.assert_allclose(good2.future.result(timeout=1)[0],
                               [SIZE * SIZE * 3 * 2.0])


def test_resolve_isolates_scatter_failure():
    class EvilFuture(Future):
        def set_result(self, result):
            raise RuntimeError("scatter boom")

    eng = InferenceEngine(forward_fn=_sum_forward, image_size=SIZE,
                          buckets=(1, 2, 4, 8), autostart=False,
                          device="cpu")
    evil = _Request(np.ones((1, SIZE, SIZE, 3), np.float32), EvilFuture())
    good = _Request(np.full((1, SIZE, SIZE, 3), 3, np.float32), Future())
    eng._resolve(eng._dispatch([evil, good]))
    assert isinstance(evil.future.exception(), RuntimeError)
    np.testing.assert_allclose(good.future.result(timeout=1)[0],
                               [SIZE * SIZE * 3 * 3.0])


def test_snapshot_has_the_tpuic_keys(model):
    from tpuic.serve.metrics import ServeStats as JaxServeStats
    eng = _engine(model)
    eng.predict(np.zeros((2, SIZE, SIZE, 3), np.float32), timeout=30)
    eng.close()
    snap = eng.stats.snapshot()
    assert set(snap) == set(JaxServeStats().snapshot())
    assert set(snap["span_ms"]) == {"queue", "batch", "staging", "dispatch",
                                    "device", "scatter"}
    # One sequence of updates, the same counters: rejections by cause and
    # priority, the served identity (kept across reset()), the service
    # estimate the deadline shed reads.
    from tpuic_torch.serve.metrics import ServeStats
    snaps = []
    for st in (ServeStats(), JaxServeStats()):
        st.note_identity("abcd1234")
        for cause, prio in (("quota", "low"), ("queue_full", "high"),
                            ("queue_full", "high"), ("deadline", "normal")):
            st.record_reject(cause, prio)
        before = st.snapshot()
        st.record_swap(1, "ffff0000")
        st.record_swap(2, "abcd1234")
        st.reset()
        for i in range(5):
            st.record_spans([0.001 * (i + 1) * (k + 1) for k in range(6)])
        after = st.snapshot()
        snaps.append((
            {k: before[k] for k in ("rejected", "rejected_by", "swaps",
                                    "generation", "model_digest")},
            {k: after[k] for k in ("rejected", "rejected_by", "swaps",
                                   "generation", "model_digest", "span_ms")},
            round(st.estimated_service_s(), 9)))
    assert snaps[0] == snaps[1]
    assert snaps[0][1]["swaps"] == 2 and snaps[0][1]["rejected"] == 0


def test_uint8_normalize_equals_normalizing_outside(model):
    imgs = _u8(7, 4)
    with _engine(model, input_dtype=np.uint8, normalize=True) as eng:
        got_p, got_o = eng.predict(imgs, timeout=30)
    pre = ((imgs.astype(np.float32) / 255.0 - IMAGENET_MEAN)
           / IMAGENET_STD).astype(np.float32)
    with _engine(model) as eng:
        want_p, want_o = eng.predict(pre, timeout=30)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_o[:, 0], want_o[:, 0])


def test_order_is_a_stable_descending_sort():
    probs, order = make_forward(lambda x: torch.zeros(x.shape[0], 5))(
        torch.zeros(2, SIZE, SIZE, 3))
    np.testing.assert_array_equal(order.numpy(), [[0, 1, 2, 3, 4]] * 2)
    np.testing.assert_allclose(probs.numpy(), 0.2)


def test_forward_runs_with_tf32_off_and_restores_the_flags():
    """The served forward runs the model with cuDNN's and cuBLAS's TF32
    off (cuDNN's TF32 algorithms differ by batch size, so a row would
    depend on its bucket), and puts both flags back as it found them."""
    seen = []

    def model(x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return torch.zeros(x.shape[0], 3)

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for before in ((True, False), (True, True)):
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = before
            make_forward(model)(torch.zeros(2, SIZE, SIZE, 3))
            assert seen[-1] == (False, False)
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == before
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_launch_tally_is_the_capturing_threads_own():
    """A thread inside ``counting.tally()`` (the engine capturing a CUDA
    graph) counts into its own tally; another thread's launches meanwhile
    reach the counter, and a replay adds the tally to it."""
    from tpuic_torch.kernels import counting

    def kernel():
        pass

    kernel.launches = 0
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        for _ in range(5):
            counting.count_launch(kernel)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with counting.tally() as mine:
        counting.count_launch(kernel)
        counting.count_launch(kernel)
        inside.set()
        assert done.wait(10)
    t.join(timeout=10)
    assert not t.is_alive()
    assert mine == {kernel: 2} and kernel.launches == 5
    counting.count_launch(kernel)
    counting.add_launches(mine.items())
    assert kernel.launches == 8


def test_default_device_is_the_card(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, image_size=SIZE, autostart=False)
    assert next(model.parameters()).device.type == "cpu"


def test_default_buckets_match_tpuic():
    from tpuic.serve.engine import default_buckets as jax_default_buckets
    for b in (1, 7, 64, 128, 1000):
        assert default_buckets(b) == jax_default_buckets(b)


def test_copied_helpers_match_tpuic():
    """The port's copies of ``tpuic``'s meter and resize stay identical."""
    from tpuic.data.transforms import resize_nearest as jax_resize
    from tpuic.metrics.meters import LatencyMeter as JaxLatencyMeter
    from tpuic_torch.data.transforms import resize_nearest
    from tpuic_torch.metrics.meters import LatencyMeter
    rng = np.random.default_rng(2)
    ours, theirs = LatencyMeter(window=50), JaxLatencyMeter(window=50)
    for v in rng.exponential(0.01, 120):
        ours.update(v)
        theirs.update(v)
    assert ours.percentiles_ms() == theirs.percentiles_ms()
    assert ours.count == theirs.count == 120
    img = rng.integers(0, 256, (37, 23, 3), dtype=np.uint8)
    for size in (16, 37, 50):
        np.testing.assert_array_equal(resize_nearest(img, size),
                                      jax_resize(img, size))


def test_served_resnet_matches_the_jax_forward():
    """The slice end to end: flax variables of a fused resnet18-cifar
    served through the port's engine (uint8 in, normalized in the
    forward) against ``tpuic``'s forward of the same variables."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from tpuic.models import create_model as jax_create_model
    from tpuic.serve.engine import make_forward as jax_make_forward

    imgs = _u8(11, 4)
    jm = jax_create_model("resnet18-cifar", 10, dtype="float32",
                          fused_conv_bn=True)
    variables = jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), train=False))(
        jax.random.key(3))
    want_p, want_o = jax.jit(jax_make_forward(jm, normalize=True))(
        variables, jnp.asarray(imgs))
    pm = create_model("resnet18-cifar", 10, dtype="float32",
                      fused_conv_bn=True, device="cpu")
    with _engine(pm, variables=jax.tree.map(np.asarray, variables),
                 input_dtype=np.uint8, normalize=True) as eng:
        eng.warmup()
        futs = [eng.submit(imgs[:1]), eng.submit(imgs[1:])]
        got = [f.result(timeout=60) for f in futs]
    got_p = np.concatenate([g[0] for g in got])
    got_o = np.concatenate([g[1] for g in got])
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got_o[:, 0], np.asarray(want_o)[:, 0])
