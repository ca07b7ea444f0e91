"""Dynamic-batching inference engine (``tpuic/serve/engine.py``, core).

The engine sits between callers and the model and keeps the device busy
with few, large, fixed-shape calls:

- **Micro-batcher**: a bounded request queue (backpressure: ``submit``
  blocks or raises ``queue.Full`` when the server is saturated) feeds one
  batcher thread that coalesces FIFO requests until ``max_batch`` rows
  are ready or ``max_wait_ms`` has passed since the batch opened —
  whichever comes first.  A request that would overflow the batch is
  held and leads the next one; requests are never split.
- **Padding buckets**: every device call is padded up to one of a small
  ladder of batch sizes (default 1/8/32/128).  Padding rows are sliced
  off before futures resolve — they never reach a caller.
- **Double buffering**: the batcher assembles and dispatches batch N+1
  (host gather, pad, H2D, kernel launches, and the device->host copy
  enqueued behind them) *before* it waits on batch N's readback.  CUDA's
  asynchronous launch plays the role of JAX's async dispatch; the wait on
  the batch's event in ``_resolve`` is where device errors surface.
  The H2D copy is from pageable memory and therefore synchronous in this
  slice: it waits for the device to finish the batch before, so the
  overlap is the host's gather and padding of N+1 with N's device time.
- **Counters**: ``tpuic_torch.serve.metrics.ServeStats`` —
  ``engine.stats.snapshot()`` is one JSON-able dict with ``tpuic``'s keys.

The forward contract: ``forward(images[B,S,S,C] tensor on the engine's
device) -> tensor or tuple of tensors``, batch dim first.  The default
forward is predict's — softmax probs + class order.  Results resolve per
request as numpy arrays sliced to the request's rows.

H2D, the kernels, and the readback all run on the batcher thread's
current stream (the device's default stream unless the caller set one),
and the readback waits on an event recorded on that stream.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from tpuic_torch.checkpoint.convert import load_jax_variables
from tpuic_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tpuic_torch.device import resolve_device
from tpuic_torch.serve.metrics import ServeStats

DEFAULT_BUCKETS = (1, 8, 32, 128)


def default_buckets(max_batch: int) -> tuple:
    """Bucket ladder for a known caller batch size: ``max_batch`` and
    /4 steps down to 1 (e.g. 64 -> (1, 4, 16, 64)).  Keeps worst-case
    pad waste at 4x while holding the bucket count at ~log4(B)."""
    b, out = max(1, int(max_batch)), []
    while b > 1:
        out.append(b)
        b = max(1, b // 4)
    out.append(1)
    return tuple(sorted(set(out)))


def make_forward(model, *, normalize: bool = False, mean=None, std=None):
    """predict's forward as an engine-compatible function.

    ``normalize=True`` folds uint8 -> (x/255 - mean)/std into the forward
    (serving raw images ships 4x fewer H2D bytes).  Returns float32
    softmax probabilities and the class order of a stable descending
    sort (``jnp.argsort(-probs)``'s tie order)."""
    m = torch.as_tensor(IMAGENET_MEAN if mean is None else mean,
                        dtype=torch.float32)
    s = torch.as_tensor(IMAGENET_STD if std is None else std,
                        dtype=torch.float32)
    on_device = {}

    def forward(images: torch.Tensor):
        with torch.inference_mode():
            x = images
            if normalize:
                dev = x.device
                if dev not in on_device:
                    on_device[dev] = (m.to(dev), s.to(dev))
                dm, ds = on_device[dev]
                x = (x.float() / 255.0 - dm) / ds
            logits = model(x)
            probs = torch.softmax(logits.float(), dim=-1)
            order = torch.argsort(-probs, dim=-1, stable=True)
            return probs, order

    return forward


class _Request:
    """One submitted request plus the host timestamps its span ledger is
    computed from (``time.monotonic()`` reads — no device interaction)."""

    __slots__ = ("images", "n", "future", "t_enqueue", "t_gather")

    def __init__(self, images: np.ndarray, future: Future) -> None:
        self.images = images
        self.n = images.shape[0]
        self.future = future
        self.t_enqueue = time.monotonic()
        self.t_gather = self.t_enqueue  # stamped when the batcher pops it


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class InferenceEngine:
    """Queue + micro-batcher + padding buckets around one model.

    Parameters
    ----------
    model, variables : the port model and, optionally, a ``tpuic``
        variables tree to load into it (``None`` serves the model's
        weights as they are).  The engine puts the model on ``device`` in
        eval mode once; a fused model folds its BN weights at the first
        forward (``warmup``).  ``forward_fn`` overrides
        ``make_forward(model)`` entirely (then ``model`` may be None).
    image_size, channels, input_dtype : the fixed per-row shape/dtype
        every request must carry — [n, S, S, C] of ``input_dtype``.
    buckets : padding ladder; the largest bucket is ``max_batch`` (the
        coalescing cut) and the largest request size accepted.
    max_wait_ms : how long an open batch waits for more requests before
        dispatching below max_batch.
    queue_size : bound of the request queue — backpressure, not memory.
    autostart : start the batcher thread in the constructor.  Tests pass
        False to exercise queue semantics deterministically.
    device : where the model runs; ``None`` means the card, and raises
        when there is none.
    """

    def __init__(self, model=None, variables=None, *, image_size: int,
                 channels: int = 3, input_dtype=np.float32,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, queue_size: int = 256,
                 normalize: bool = False, mean=None, std=None,
                 forward_fn=None, stats: Optional[ServeStats] = None,
                 autostart: bool = True, device=None) -> None:
        if not buckets:
            raise ValueError("need at least one padding bucket")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.device = resolve_device(device)
        self.max_batch = self.buckets[-1]
        self.image_size = int(image_size)
        self.channels = int(channels)
        self.input_dtype = np.dtype(input_dtype)
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        if model is not None:
            # One up-front placement: the weights go to the device once,
            # never per call.
            if variables is not None:
                load_jax_variables(model, variables)
            model.to(self.device).eval()
        elif variables is not None:
            raise ValueError("variables given without a model")
        self._forward = (forward_fn if forward_fn is not None
                         else make_forward(model, normalize=normalize,
                                           mean=mean, std=std))
        self.stats = stats if stats is not None else ServeStats()
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            max(1, int(queue_size)))
        self._held: Optional[_Request] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "InferenceEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="tpuic-torch-serve-batcher")
            self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Drain queued requests, then stop the batcher thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # Batcher wedged past the timeout (e.g. a stuck device
                # call).  It still owns the queue: do not fail requests it
                # may yet serve, and do not pretend it is gone.
                return
            self._thread = None
        # A submit() racing close() can slip a request in after the
        # batcher's final drain check — fail it rather than hang its
        # caller (submit() runs the same sweep after its put).
        self._fail_queued()

    def _fail_queued(self) -> None:
        """Fail every queued request — only once the batcher is gone."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if not req.future.cancelled():
                req.future.set_exception(RuntimeError("engine closed"))

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- buckets / warmup ----------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the shape the device will actually see)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"request of {n} rows exceeds max bucket "
                         f"{self.max_batch}")

    def warmup(self) -> dict:
        """Run every bucket's shape once, to the end of its readback, and
        return ``{bucket: secs}``.  The first run builds the kernels and
        folds the model's weights; each run is recorded through
        ``stats.record_compile``, so ``compiles`` counts the buckets."""
        timings = {}
        for b in self.buckets:
            batch = np.zeros((b, self.image_size, self.image_size,
                              self.channels), self.input_dtype)
            t0 = time.perf_counter()
            self._readback(self._launch(batch))
            timings[b] = round(time.perf_counter() - t0, 3)
            self.stats.record_compile(b, timings[b])
        return timings

    # -- request side --------------------------------------------------
    def submit(self, images, *, timeout: Optional[float] = None) -> Future:
        """Enqueue [n,S,S,C] (or one [S,S,C] row) for inference.

        Returns a Future resolving to the forward's outputs (numpy)
        sliced to this request's n rows.  When the queue is full:
        ``timeout=None`` blocks (backpressure), ``timeout=0`` raises
        ``queue.Full`` immediately, other values wait that long first.

        The engine BORROWS the array until the future resolves (no
        defensive copy): callers reusing a staging buffer must copy."""
        arr = np.asarray(images, self.input_dtype)
        if arr.ndim == 3:
            arr = arr[None]
        expect = (self.image_size, self.image_size, self.channels)
        if arr.ndim != 4 or arr.shape[1:] != expect:
            raise ValueError(f"expected [n,{expect[0]},{expect[1]},"
                             f"{expect[2]}] images, got {arr.shape}")
        if arr.shape[0] == 0:
            raise ValueError("empty request")
        if arr.shape[0] > self.max_batch:
            raise ValueError(f"request of {arr.shape[0]} rows exceeds max "
                             f"bucket {self.max_batch}; chunk it caller-side")
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        fut: Future = Future()
        req = _Request(arr, fut)
        try:
            self._queue.put(req, timeout=timeout)
        except queue.Full:
            self.stats.record_reject("queue_full")
            raise
        # Re-check after the put: a close() that ran between the check
        # above and the put has already drained the queue, and nothing
        # will ever read this request — fail it instead of hanging.
        if self._stop.is_set() and (self._thread is None
                                    or not self._thread.is_alive()):
            self._fail_queued()
        return fut

    def predict(self, images, *, timeout: Optional[float] = None):
        """Blocking convenience: submit + wait for the result."""
        return self.submit(images).result(timeout)

    def queue_depth(self) -> int:
        """Requests queued but not yet popped by the batcher."""
        return self._queue.qsize()

    # -- device side ---------------------------------------------------
    def _launch(self, batch: np.ndarray):
        """H2D, the forward, and the device->host copy, all enqueued on
        the current stream; returns ``(host tensors, event)`` where the
        event marks the copy's end (``None`` on the CPU)."""
        x = torch.from_numpy(batch).to(self.device)
        out = _as_tuple(self._forward(x))
        if self.device.type != "cuda":
            return out, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    @staticmethod
    def _readback(launched):
        host, event = launched
        if event is not None:
            event.synchronize()
        return tuple(t.numpy() for t in host)

    # -- batcher thread ------------------------------------------------
    def _gather(self, idle_timeout: float):
        """One coalescing decision: FIFO requests until max_batch rows or
        max_wait_ms after the batch opened.  A request that would overflow
        max_batch is held and leads the next batch."""
        first, self._held = self._held, None
        if first is None:
            try:
                first = self._queue.get(timeout=idle_timeout)
            except queue.Empty:
                return None
            first.t_gather = time.monotonic()
        reqs, rows = [first], first.n
        deadline = time.monotonic() + self.max_wait
        while rows < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            nxt.t_gather = time.monotonic()
            if rows + nxt.n > self.max_batch:
                self._held = nxt
                break
            reqs.append(nxt)
            rows += nxt.n
        return reqs

    def _dispatch(self, reqs):
        """Pad to bucket, then launch.  Returns the in-flight batch (None
        when every request failed staging); results are NOT read back
        here, so the device works on this batch while the batcher
        assembles the next one.

        Error isolation: a request whose array fails the staging copy gets
        the exception on ITS future and is dropped from the batch — its
        batchmates still dispatch and resolve."""
        t_batch = time.monotonic()  # batch closed: formation span ends
        rows = sum(r.n for r in reqs)
        bucket = self.bucket_for(rows)
        if len(reqs) == 1 and reqs[0].n == bucket:
            batch = reqs[0].images  # exact fit: no staging copy
        else:
            batch = np.zeros((bucket, self.image_size, self.image_size,
                              self.channels), self.input_dtype)
            off = 0
            ok = []
            for r in reqs:
                try:
                    batch[off:off + r.n] = r.images
                except Exception as e:
                    if not r.future.cancelled():
                        r.future.set_exception(e)
                    continue
                ok.append(r)
                off += r.n
            if not ok:
                return None
            if off < rows:
                # Some request dropped: the survivors may fit a smaller
                # bucket (rows packed contiguously from 0).
                reqs = ok
                bucket = self.bucket_for(off)
                batch = batch[:bucket]
                rows = off
        t_staged = time.monotonic()  # staging (pad/copy) span ends
        self.stats.record_dispatch(bucket, rows,
                                   [t_staged - r.t_enqueue for r in reqs])
        launched = self._launch(np.ascontiguousarray(batch))
        return reqs, launched, bucket, (t_batch, t_staged, time.monotonic())

    def _resolve(self, inflight) -> None:
        """Wait for the batch's readback, slice per request, resolve
        futures.  Rows past the batch's valid count are padding and are
        never part of any slice.  This wait is the error edge: a device
        fault surfaces here and fails the batch's futures."""
        reqs, launched, bucket, (t_batch, t_staged, t_dispatched) = inflight
        try:
            host = self._readback(launched)
        except Exception as e:
            for r in reqs:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        now = time.monotonic()  # device span ends: results are on host
        # Counters first: a caller woken by set_result may snapshot stats
        # immediately, and the batch it just completed must be in them.
        self.stats.record_done(len(reqs), sum(r.n for r in reqs),
                               [now - r.t_enqueue for r in reqs])
        off = 0
        for r in reqs:
            lo, hi = off, off + r.n
            off = hi
            if r.future.cancelled():
                continue
            # Per-request isolation: a failure while slicing/setting ONE
            # request's result lands on that future alone.
            try:
                r.future.set_result(tuple(a[lo:hi] for a in host))
            except Exception as e:
                try:
                    r.future.set_exception(e)
                except Exception:
                    pass  # future already done — nothing left to deliver
            t_done = time.monotonic()  # scatter span ends
            self.stats.record_spans((r.t_gather - r.t_enqueue,
                                     t_batch - r.t_gather,
                                     t_staged - t_batch,
                                     t_dispatched - t_staged,
                                     now - t_dispatched,
                                     t_done - now))

    def _run(self) -> None:
        inflight = None
        while True:
            if (self._stop.is_set() and self._held is None
                    and self._queue.empty()):
                break
            # With a batch in flight, poll briefly so its readback isn't
            # delayed when the queue goes idle; when nothing is pending a
            # longer block keeps the idle loop cheap.
            reqs = self._gather(0.002 if inflight is not None else 0.05)
            if reqs is not None:
                try:
                    nxt = self._dispatch(reqs)
                except Exception as e:  # resolve, don't kill the loop
                    for r in reqs:
                        if not r.future.cancelled():
                            r.future.set_exception(e)
                    nxt = None
                if inflight is not None:
                    self._resolve(inflight)
                inflight = nxt
            elif inflight is not None:
                self._resolve(inflight)
                inflight = None
        if inflight is not None:
            self._resolve(inflight)
