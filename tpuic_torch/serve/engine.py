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
- **One CUDA graph per bucket** (on a CUDA device): ``warmup`` runs each
  bucket once eagerly (the kernels build, K3 folds its weights), then
  captures the forward — normalise, model, softmax, argsort — into a
  ``torch.cuda.CUDAGraph`` with a static input and static outputs; a
  bucket not warmed is captured at its first use, once.  A device call
  copies the batch into the bucket's static input and replays the graph:
  one launch from Python instead of one per kernel.  This is the port's
  counterpart of ``tpuic``'s per-bucket AOT executables.  There is no
  eager fallback on the card: a capture that fails raises, naming the
  bucket.  On the CPU (the tests) the forward runs eagerly.
- **Double buffering**: the batcher assembles and dispatches batch N+1
  (host gather, pad, the copy in, the replay, and the device->host copy
  enqueued behind them) *before* it waits on batch N's readback.  The
  wait on the batch's event in ``_resolve`` is where device errors
  surface.  A numpy request's copy in is from pageable memory and
  therefore synchronous: it waits for the device to finish the batch
  before, so the overlap is the host's gather and padding of N+1 with N's
  device time.
- **Device-resident requests**: ``submit`` also takes a torch tensor on
  the engine's device (a ``Loader`` batch, say).  It is copied device to
  device into the static input — an exact fit as one copy, otherwise
  padded on the device — and never bounces through the host.
- **Counters**: ``tpuic_torch.serve.metrics.ServeStats`` —
  ``engine.stats.snapshot()`` is one JSON-able dict with ``tpuic``'s keys.
  The kernels' ``.launches`` counters count replays too: each graph
  records its launches per counter at capture, and every replay adds
  them.

The forward contract: ``forward(images[B,S,S,C] tensor on the engine's
device) -> tensor or tuple of tensors``, batch dim first.  The default
forward is predict's — softmax probs + class order.  Results resolve per
request as numpy arrays sliced to the request's rows.

The copy in, the replay and the readback all run on the batcher thread's
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
from tpuic_torch.kernels import no_tf32
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
    sort (``jnp.argsort(-probs)``'s tie order).

    The model runs with TF32 off in cuDNN (and cuBLAS) for the call, the
    flags restored after it: under torch's default flags cuDNN runs a
    float32 convolution in TF32 with algorithms chosen by batch size, so a
    row's probabilities would depend on the bucket it rides in (ResNet's
    unfused branch; ``chip_smoke.py``'s ``[model]`` phase measures it).
    The flags are global to the process; while the engine serves, its
    batcher thread is the only thread that runs forwards."""
    m = torch.as_tensor(IMAGENET_MEAN if mean is None else mean,
                        dtype=torch.float32)
    s = torch.as_tensor(IMAGENET_STD if std is None else std,
                        dtype=torch.float32)
    on_device = {}

    def forward(images: torch.Tensor):
        with torch.inference_mode(), no_tf32():
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
    computed from (``time.monotonic()`` reads — no device interaction).
    ``images`` is a numpy array, or a tensor on the engine's device whose
    producer stream ``ready`` marks (``None`` for numpy and on the CPU)."""

    __slots__ = ("images", "n", "future", "t_enqueue", "t_gather", "ready")

    def __init__(self, images, future: Future, ready=None) -> None:
        self.images = images
        self.n = images.shape[0]
        self.future = future
        self.ready = ready
        self.t_enqueue = time.monotonic()
        self.t_gather = self.t_enqueue  # stamped when the batcher pops it


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class _BucketGraph:
    """One bucket's captured forward: the graph, its static input and
    outputs, the launches each counted kernel makes per replay, and what
    it holds on the device."""

    __slots__ = ("graph", "static_in", "outputs", "launches", "scratch",
                 "folded", "pool_bytes")

    def __init__(self, graph, static_in, outputs, launches, scratch,
                 folded, pool_bytes) -> None:
        self.graph = graph
        self.static_in = static_in
        self.outputs = outputs
        self.launches = launches
        self.scratch = scratch
        self.folded = folded
        self.pool_bytes = pool_bytes


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

    Identity (the socket transport's ``pong`` and ready file carry it):
    ``generation`` (0: weights are never swapped yet), ``model_digest``
    (``checkpoint.variables_digest`` of the served model) and
    ``variant_tags()`` (``("fp32",)``: no dtype ladder yet).
    """

    generation = 0

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
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names the current card; a tensor on it says cuda:N.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.max_batch = self.buckets[-1]
        self.image_size = int(image_size)
        self.channels = int(channels)
        self.input_dtype = np.dtype(input_dtype)
        self._torch_dtype = torch.from_numpy(
            np.zeros(0, self.input_dtype)).dtype
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        if model is not None:
            # One up-front placement: the weights go to the device once,
            # never per call.
            if variables is not None:
                load_jax_variables(model, variables)
            model.to(self.device).eval()
        elif variables is not None:
            raise ValueError("variables given without a model")
        self.model = model
        self._digest: Optional[str] = None
        self._forward = (forward_fn if forward_fn is not None
                         else make_forward(model, normalize=normalize,
                                           mean=mean, std=std))
        self.stats = stats if stats is not None else ServeStats()
        # Requests whose rows reached the device as tensors on it, and
        # those that came as host arrays.
        self.device_requests = 0
        self.host_requests = 0
        self._graphs = {}
        self._pool = None
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            max(1, int(queue_size)))
        self._held: Optional[_Request] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- identity ------------------------------------------------------
    @property
    def model_digest(self) -> Optional[str]:
        """``variables_digest`` of the served model, computed once (None
        for an engine built from a bare ``forward_fn``)."""
        if self._digest is None and self.model is not None:
            from tpuic_torch.checkpoint.loading import variables_digest
            self._digest = variables_digest(self.model)
        return self._digest

    def variant_tags(self) -> tuple:
        """The dtype ladder's tags: float32 weights only so far."""
        return ("fp32",)

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
        """Make every bucket ready and return ``{bucket: secs}``, each
        recorded through ``stats.record_compile`` (``compiles`` counts the
        buckets).  On a CUDA device a bucket runs once eagerly, is
        captured into its graph and replayed once to the end of its
        readback; on the CPU it runs once eagerly.  The first run builds
        the kernels and folds the model's weights."""
        timings = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            if self.device.type == "cuda" and b not in self._graphs:
                self._graphs[b] = self._capture(b)
            batch = np.zeros((b, self.image_size, self.image_size,
                              self.channels), self.input_dtype)
            self._readback(self._launch([(0, torch.from_numpy(batch))], b))
            timings[b] = round(time.perf_counter() - t0, 3)
            self.stats.record_compile(b, timings[b])
        # The stats snapshot carries the served model's identity.
        self.stats.model_digest = self.model_digest or ""
        return timings

    def graph_memory(self) -> dict:
        """Device bytes the captured graphs hold: their shared pool's
        segments (what the captures added to the reserved memory), their
        static inputs, and the K3 split-K scratch baked into them."""
        return {"buckets": sorted(self._graphs),
                "pool_bytes": sum(g.pool_bytes
                                  for g in self._graphs.values()),
                "static_input_bytes": sum(
                    g.static_in.numel() * g.static_in.element_size()
                    for g in self._graphs.values()),
                "scratch_bytes": sum(
                    t.numel() * t.element_size()
                    for g in self._graphs.values() for t in g.scratch)}

    # -- request side --------------------------------------------------
    def submit(self, images, *, timeout: Optional[float] = None) -> Future:
        """Enqueue [n,S,S,C] (or one [S,S,C] row) for inference: a numpy
        array (or anything ``np.asarray`` takes), or a torch tensor of
        ``input_dtype`` on the engine's device.  A tensor on another
        device, the CPU included for an engine on the card, is refused
        with ``ValueError``.

        Returns a Future resolving to the forward's outputs (numpy)
        sliced to this request's n rows.  When the queue is full:
        ``timeout=None`` blocks (backpressure), ``timeout=0`` raises
        ``queue.Full`` immediately, other values wait that long first.

        The engine BORROWS the array or tensor until the future resolves
        (no defensive copy): callers reusing a staging buffer must copy.
        A tensor is read on the batcher's stream after the work its
        caller's current stream had queued when it was submitted."""
        if isinstance(images, torch.Tensor):
            arr = images
            if arr.device != self.device:
                raise ValueError(f"tensor on {arr.device}; this engine "
                                 f"takes tensors on {self.device} (or "
                                 "numpy arrays)")
            if arr.dtype != self._torch_dtype:
                raise ValueError(f"tensor of {arr.dtype}; expected "
                                 f"{self._torch_dtype}")
        else:
            arr = np.asarray(images, self.input_dtype)
        if arr.ndim == 3:
            arr = arr[None]
        expect = (self.image_size, self.image_size, self.channels)
        if arr.ndim != 4 or tuple(arr.shape[1:]) != expect:
            raise ValueError(f"expected [n,{expect[0]},{expect[1]},"
                             f"{expect[2]}] images, got {tuple(arr.shape)}")
        if arr.shape[0] == 0:
            raise ValueError("empty request")
        if arr.shape[0] > self.max_batch:
            raise ValueError(f"request of {arr.shape[0]} rows exceeds max "
                             f"bucket {self.max_batch}; chunk it caller-side")
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        ready = None
        if isinstance(arr, torch.Tensor) and arr.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(arr.device))
        fut: Future = Future()
        req = _Request(arr, fut, ready)
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
    def _capture(self, bucket: int) -> _BucketGraph:
        """Capture bucket ``bucket``'s forward into a CUDA graph.  Raises
        ``RuntimeError`` naming the bucket when the run before it or the
        capture fails: the card has no eager fallback."""
        from tpuic_torch.kernels import conv_bn_relu, counted_kernels
        dev = self.device
        static_in = torch.zeros(
            (bucket, self.image_size, self.image_size, self.channels),
            dtype=self._torch_dtype, device=dev)
        # Hazard, K3's split-K scratch: it is keyed by (device, stream) and
        # grows on demand, and a capture bakes its addresses into the
        # graph.  Each bucket therefore captures on a stream of its own,
        # after one eager run on that stream, which sizes the stream's
        # scratch for exactly this bucket's convs; the capture then finds
        # it large enough and allocates none, and nothing else ever runs
        # on that stream, so the scratch is never replaced.  The graph
        # keeps a reference to it all the same.  The counters start
        # every replay at zero: the kernel leaves each it took at zero,
        # and the eager run left them so.  Two graphs never share a
        # scratch, and all replays go to the batcher's one stream.
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        counters = counted_kernels()
        try:
            # The eager run builds the kernels, folds K3's weights and
            # makes the forward's device constants, none of which a
            # capture may do.
            with torch.cuda.stream(stream):
                _as_tuple(self._forward(static_in))
            stream.synchronize()
            before = [fn.launches for fn in counters]
            if self._pool is None:
                # Hazard, memory: one pool for every bucket's graph.  That
                # is safe because the buckets' graphs never run at once
                # and each is used as one unit: the batcher enqueues the
                # copy into a static input, the replay and the copy out of
                # the static outputs back to back on its one stream, so a
                # block that two graphs share (an intermediate of one that
                # is a static tensor of another) is free again before the
                # next unit's copy in.  Every graph's static tensors stay
                # referenced here, so no later capture reuses them.
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # Hazard, flags: the forward sets its TF32 flags itself
            # (``make_forward`` turns TF32 off for the call), inside the
            # capture as in the eager run, so the captured kernels are the
            # ones the eager forward chooses.
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(dev)
                outputs = _as_tuple(self._forward(static_in))
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of bucket {bucket} "
                               f"failed: {e}") from e
        # Hazard, launch counters: they count in Python, so during the
        # capture, which launches nothing.  The capture's counts become
        # the graph's launches per replay and are taken back off.
        launches = []
        for fn, b in zip(counters, before):
            n = fn.launches - b
            if n:
                fn.launches = b
                launches.append((fn, n))
        scratch = conv_bn_relu._SCRATCH.get(
            (static_in.get_device(), stream.cuda_stream))
        scratch = (tuple(t for t in (scratch.ws, scratch.counters)
                         if t is not None) if scratch is not None else ())
        # The graph also bakes in the addresses of K3's folded weights,
        # which the model drops when it refolds (``invalidate_packed``):
        # the graph holds them, so a replay never reads freed memory.
        folded = tuple(m._packed for m in (self.model.modules()
                                           if self.model is not None else ())
                       if getattr(m, "_packed", None) is not None)
        return _BucketGraph(graph, static_in, outputs, tuple(launches),
                            scratch, folded, pool_bytes)

    def _graph_for(self, bucket: int) -> _BucketGraph:
        g = self._graphs.get(bucket)
        if g is None:
            # A bucket not warmed is captured at its first use, once.
            t0 = time.perf_counter()
            g = self._graphs[bucket] = self._capture(bucket)
            self.stats.record_compile(bucket,
                                      round(time.perf_counter() - t0, 3))
        return g

    def replay(self, bucket: int, x: Optional[torch.Tensor] = None):
        """Copy ``x`` ([bucket, S, S, C] on the card; None keeps the
        static input as it is) into bucket ``bucket``'s static input,
        replay its graph on the current stream and return the static
        outputs, which the next replay of the bucket overwrites.  Adds
        the graph's launches to each kernel's counter."""
        g = self._graph_for(bucket)
        if x is not None:
            g.static_in.copy_(x)
        g.graph.replay()
        for fn, n in g.launches:
            fn.launches += n
        return g.outputs

    def _launch(self, parts, bucket: int):
        """The copy in, the forward and the device->host copy, all
        enqueued on the current stream; returns ``(host tensors, event)``
        where the event marks the copy's end (``None`` on the CPU).
        ``parts`` are ``(row offset, tensor)`` pieces of the batch, on the
        host or on the engine's device; rows past the last piece are
        padding (zeros)."""
        rows = sum(t.shape[0] for _, t in parts)
        if self.device.type != "cuda":
            if len(parts) == 1 and rows == bucket:
                x = parts[0][1]
            else:
                x = torch.zeros((bucket,) + tuple(parts[0][1].shape[1:]),
                                dtype=parts[0][1].dtype)
                for off, t in parts:
                    x[off:off + t.shape[0]] = t
            return _as_tuple(self._forward(x.to(self.device))), None
        g = self._graph_for(bucket)
        stream = torch.cuda.current_stream(self.device)
        for off, t in parts:
            g.static_in[off:off + t.shape[0]].copy_(t)
        if rows < bucket:
            g.static_in[rows:].zero_()
        out = self.replay(bucket)
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
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

    def _stage(self, reqs):
        """``(requests kept, bucket, (offset, tensor) parts)``.  Host
        arrays are gathered into one padded host batch (one copy to the
        device); tensors on the device go in as they are, padded on the
        device.

        Error isolation: a request whose array fails the staging copy gets
        the exception on ITS future and is dropped from the batch — its
        batchmates still dispatch and resolve.  The survivors may then fit
        a smaller bucket (rows packed contiguously from 0)."""
        bucket = self.bucket_for(sum(r.n for r in reqs))
        hosts = [r for r in reqs if not isinstance(r.images, torch.Tensor)]
        if len(hosts) < len(reqs):
            parts, off = [], 0
            for r in reqs:
                t = (r.images if isinstance(r.images, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(r.images)))
                if r.ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        r.ready)
                parts.append((off, t))
                off += r.n
            self.device_requests += len(reqs) - len(hosts)
            self.host_requests += len(hosts)
            return reqs, bucket, parts
        if len(reqs) == 1 and reqs[0].n == bucket:
            self.host_requests += 1
            return reqs, bucket, [(0, torch.from_numpy(
                np.ascontiguousarray(reqs[0].images)))]  # no staging copy
        batch = np.zeros((bucket, self.image_size, self.image_size,
                          self.channels), self.input_dtype)
        off, ok = 0, []
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
        bucket = self.bucket_for(off)
        self.host_requests += len(ok)
        return ok, bucket, [(0, torch.from_numpy(batch[:bucket]))]

    def _dispatch(self, reqs):
        """Pad to bucket, then launch.  Returns the in-flight batch (None
        when every request failed staging); results are NOT read back
        here, so the device works on this batch while the batcher
        assembles the next one."""
        t_batch = time.monotonic()  # batch closed: formation span ends
        staged = self._stage(reqs)
        if staged is None:
            return None
        reqs, bucket, parts = staged
        rows = sum(r.n for r in reqs)
        t_staged = time.monotonic()  # staging (pad/copy) span ends
        self.stats.record_dispatch(bucket, rows,
                                   [t_staged - r.t_enqueue for r in reqs])
        launched = self._launch(parts, bucket)
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
