"""Dynamic-batching inference engine (``tpuic/serve/engine.py``).

The engine sits between callers and the model and keeps the device busy
with few, large, fixed-shape calls:

- **Micro-batcher**: a bounded request queue feeds one batcher thread
  that coalesces requests until ``max_batch`` rows are ready or
  ``max_wait_ms`` has passed since the batch opened — whichever comes
  first.  A request that would overflow the batch is held and leads the
  next one; requests are never split.
- **Priorities, admission and shedding** (``admission.py``): the queue
  keeps one lane per priority class and pops the highest first; a full
  queue evicts the youngest request of the lowest class strictly below
  an arrival's (its future gets a typed ``AdmissionRejected``), else
  ``submit`` blocks or raises ``queue.Full``.  An attached
  ``AdmissionController`` (``engine.admission``) rejects up front by
  quota or brownout.  A request whose deadline has passed, or will
  within the span ledger's estimate of the service still ahead of it,
  is shed at pop time with ``DeadlineExceeded``, before it joins a
  batch.
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
- **Pinned host staging**: on the card, host (numpy) requests are
  gathered into one of two page-locked buffers of their bucket and copied
  to the device with ``non_blocking=True`` on the batcher's stream; an
  event recorded after the copy guards the buffer, and the host waits on
  it before it writes that buffer again.  So the batcher does not wait
  for the device to take a batch: it goes on to the previous batch's
  readback, and the device runs the copy, then the replay.
- **Double buffering**: the batcher assembles and dispatches batch N+1
  *before* it waits on batch N's readback.  The wait on the batch's event
  in ``_resolve`` is where device errors surface.
- **Device-resident requests**: ``submit`` also takes a torch tensor on
  the engine's device (a ``Loader`` batch, say).  It is copied device to
  device into the static input and never bounces through the host.
- **The dtype ladder** (``variants``): beside the default rung (the
  model given, ``fp32``) the engine may serve other representations of
  the same weights — ``tpuic_torch.quant.serve_variants``'s ``bf16`` and
  ``int8`` modules — each with its own forward and its own graph per
  bucket, sharing the bucket ladder, the queue and the batcher.  A request
  names its rung (``submit(dtype=...)``); a device batch holds requests of
  one rung, so a rung boundary closes a batch as an overflow does.  A
  bf16 rung whose convolutions run on cuDNN runs at the largest bucket
  only (``rows_follow_batch``), so its rows do not move with the batch.
- **Generations and hot swap**: the served weights are a *slot* — every
  rung's model with its forward and its graphs, and their memory pool.
  ``swap_weights`` writes a candidate ladder (one candidate per rung: the
  ladder swaps as one unit) into a standby slot (a second copy of every
  rung with graphs of its own, built off-path at the first swap), folds
  K3's weights into the tensors those graphs read, and flips
  the live slot between two batches: the batcher reads the live slot
  once per dispatch, so a batch runs all old or all new weights, and
  nothing queued is dropped or re-run.  The old slot becomes the
  standby; the next swap waits on the event of the last batch dispatched
  with it before writing it.  ``candidate_outputs`` runs the standby's
  graphs on a candidate without touching what traffic sees; a
  ``swap_weights`` of the same candidate object right after it flips the
  standby as it is, without writing it again.
- **Counters**: ``tpuic_torch.serve.metrics.ServeStats`` —
  ``engine.stats.snapshot()`` is one JSON-able dict with ``tpuic``'s keys.
  The kernels' ``.launches`` counters count replays too: each graph
  records its launches per counter at capture, in a tally of the
  capturing thread's own (``kernels.counting``), and every replay adds
  them.

The forward contract: ``forward(images[B,S,S,C] tensor on the engine's
device) -> tensor or tuple of tensors``, batch dim first.  The default
forward is predict's — softmax probs + class order.  Results resolve per
request as numpy arrays sliced to the request's rows.

The copy in, the replay and the readback all run on the batcher thread's
current stream (the device's default stream unless the caller set one),
and the readback waits on an event recorded on that stream.  A swap's
writes, captures and gate replays run on the standby slot's own streams.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import queue
import threading
import time
from collections import deque
from collections.abc import Mapping
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from tpuic_torch.checkpoint.convert import load_jax_variables
from tpuic_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tpuic_torch.device import resolve_device
from tpuic_torch.kernels import counting, no_tf32
from tpuic_torch.models.vit import ViT
from tpuic_torch.serve.admission import (DEFAULT_PRIORITY, PRIORITIES,
                                         AdmissionRejected, DeadlineExceeded,
                                         priority_index)
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
    The flags are global to the process, and ``no_tf32`` runs the blocks
    of several threads one after another."""
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


def rows_follow_batch(tag: str, model) -> bool:
    """Whether rung ``tag`` of ``model`` would compute a row otherwise at
    another batch.  ``fp32`` and ``int8`` compute in float32 with TF32 off,
    and their rows keep to 1e-5.  In bf16 cuDNN picks its convolution
    algorithms by batch, and each layer rounds its output to 8 mantissa
    bits, so a row of a backbone whose convolutions run on cuDNN moves
    with its bucket (InceptionV3's beyond the bf16 rung's 1e-2;
    ``chip_smoke.py``'s ``[ladder]`` measures it per family).  The ViT
    (cuBLAS and K4f) and the fused ResNet (K3, split-K planned at a fixed
    batch) keep their rows.  The engine runs such a rung at its largest
    bucket only, so a request's rows do not depend on its company."""
    if tag != "bf16":
        return False
    backbone = getattr(model, "backbone", model)
    return not (isinstance(backbone, ViT)
                or getattr(backbone, "fused_inference", False))


class _Request:
    """One submitted request plus its trace id, its SLA fields and the
    host timestamps its span ledger is computed from (``time.monotonic()``
    reads — no device interaction).  ``images`` is a numpy array, or a
    tensor on the engine's device whose producer stream ``ready`` marks
    (``None`` for numpy and on the CPU)."""

    __slots__ = ("images", "n", "future", "trace", "priority", "pidx",
                 "tenant", "deadline", "variant", "t_enqueue", "t_gather",
                 "ready")

    def __init__(self, images, future: Future, ready=None, trace: int = 0,
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 variant: str = "fp32") -> None:
        self.images = images
        self.n = images.shape[0]
        self.future = future
        self.ready = ready
        self.trace = trace
        self.priority = priority
        self.pidx = priority_index(priority)
        self.tenant = tenant
        self.variant = variant
        self.t_enqueue = time.monotonic()
        self.t_gather = self.t_enqueue  # stamped when the batcher pops it
        # Absolute monotonic deadline; None = the caller waits forever.
        self.deadline = (None if deadline_ms is None
                         else self.t_enqueue + float(deadline_ms) / 1000.0)


class _PriorityQueue:
    """Bounded multi-class FIFO (``tpuic``'s): one lane per priority
    class; ``get`` pops the highest populated class first and FIFO within
    it.  ``put`` on a full queue may **evict** the youngest request of the
    lowest populated class strictly below the arrival's.  All-one-class
    traffic is exactly a bounded FIFO: nothing is evicted by its own
    class, and ``queue.Full``/``queue.Empty`` keep the stdlib
    semantics."""

    def __init__(self, maxsize: int) -> None:
        self._maxsize = max(1, int(maxsize))
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._lanes = tuple(deque() for _ in PRIORITIES)
        self._size = 0

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def empty(self) -> bool:
        return self.qsize() == 0

    def _evict_locked(self, pidx: int) -> Optional[_Request]:
        """Youngest request of the lowest class strictly below ``pidx``
        (None when every queued request is >= the arrival's class)."""
        for lane in reversed(self._lanes[pidx + 1:]):
            if lane:
                self._size -= 1
                return lane.pop()
        return None

    def put(self, req: _Request,
            timeout: Optional[float] = None) -> Optional[_Request]:
        """Enqueue ``req``; returns the evicted lower-priority request
        when admission came at someone else's expense (the caller fails
        its future).  ``timeout=None`` blocks, ``0`` raises ``queue.Full``
        at once, else waits that long — only when no eviction candidate
        exists."""
        with self._not_full:
            deadline = (None if timeout is None
                        else time.monotonic() + max(0.0, timeout))
            while self._size >= self._maxsize:
                victim = self._evict_locked(req.pidx)
                if victim is not None:
                    self._lanes[req.pidx].append(req)
                    self._size += 1
                    self._not_empty.notify()
                    return victim
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise queue.Full
                self._not_full.wait(remaining)
            self._lanes[req.pidx].append(req)
            self._size += 1
            self._not_empty.notify()
            return None

    def get(self, timeout: Optional[float] = None) -> _Request:
        with self._not_empty:
            deadline = (None if timeout is None
                        else time.monotonic() + max(0.0, timeout))
            while self._size == 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._not_empty.wait(remaining)
            for lane in self._lanes:
                if lane:
                    self._size -= 1
                    self._not_full.notify()
                    return lane.popleft()
            raise queue.Empty  # unreachable: _size > 0 implies a lane

    def get_nowait(self) -> _Request:
        return self.get(timeout=0)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _copy_into(dst, src) -> None:
    """Copy a nest of tensors (dicts, tuples) into one of the same
    structure, tensor by tensor, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _BucketGraph:
    """One bucket's captured forward: the graph, its static input and
    outputs, the launches each counted kernel makes per replay, and what
    it holds on the device."""

    __slots__ = ("graph", "static_in", "outputs", "launches", "scratch",
                 "pool_bytes")

    def __init__(self, graph, static_in, outputs, launches, scratch,
                 pool_bytes) -> None:
        self.graph = graph
        self.static_in = static_in
        self.outputs = outputs
        self.launches = launches
        self.scratch = scratch
        self.pool_bytes = pool_bytes


class _Rung:
    """One rung of a slot's dtype ladder: the model (None for a bare
    ``forward_fn``), its forward, on the card a CUDA graph per bucket; the
    ``(module, folded weights)`` pairs its graphs read, recorded at its
    first capture; and the candidate last written into it while its slot
    stood by (None once the slot is flipped live or a write fails)."""

    __slots__ = ("model", "forward", "graphs", "folded", "staged")

    def __init__(self, model, forward) -> None:
        self.model = model
        self.forward = forward
        self.graphs = {}
        self.folded: Optional[tuple] = None
        self.staged = None


class _Slot:
    """One set of served weights: a rung per ladder tag, the default
    rung's first; their graphs' memory pool, of the slot's own, and the
    stream a swap's work on it runs on; its generation and digest once it
    has served; the event of the last batch dispatched with it; and the
    captures made for it since it last went live.  ``model``, ``graphs``
    and ``folded`` are the default rung's."""

    __slots__ = ("rungs", "pool", "stream", "generation", "digest",
                 "last_event", "captures")

    def __init__(self, rungs: dict, stream=None) -> None:
        self.rungs = rungs
        self.pool = None
        self.stream = stream
        self.generation = 0
        self.digest: Optional[str] = None
        self.last_event = None
        self.captures = 0

    @property
    def _default(self) -> _Rung:
        return next(iter(self.rungs.values()))

    @property
    def model(self):
        return self._default.model

    @property
    def graphs(self) -> dict:
        return self._default.graphs

    @property
    def folded(self):
        return self._default.folded

    @folded.setter
    def folded(self, value) -> None:
        self._default.folded = value


class InferenceEngine:
    """Queue + micro-batcher + padding buckets around one model.

    Parameters
    ----------
    model, variables : the port model and, optionally, a ``tpuic``
        variables tree to load into it (``None`` serves the model's
        weights as they are).  The engine puts the model on ``device`` in
        eval mode once; a fused model folds its BN weights at the first
        forward (``warmup``).  ``forward_fn`` overrides
        ``make_forward(model)`` entirely (then ``model`` may be None, and
        the engine cannot swap weights).
    image_size, channels, input_dtype : the fixed per-row shape/dtype
        every request must carry — [n, S, S, C] of ``input_dtype``.
    buckets : padding ladder; the largest bucket is ``max_batch`` (the
        coalescing cut) and the largest request size accepted.
    max_wait_ms : how long an open batch waits for more requests before
        dispatching below max_batch.
    queue_size : bound of the request queue — backpressure, not memory.
    admission : an ``AdmissionController`` consulted at submit (None
        admits whatever the queue takes); public and settable later.
    autostart : start the batcher thread in the constructor.  Tests pass
        False to exercise queue semantics deterministically.
    device : where the model runs; ``None`` means the card, and raises
        when there is none.
    variants, default_variant : the dtype ladder (``tpuic``'s
        parameters of the same names): ``model`` is the rung
        ``default_variant`` (``"fp32"``), and ``variants`` maps each other
        tag to its module — ``tpuic_torch.quant.serve_variants``'s
        ``bf16`` and ``int8`` rungs of the same weights — which the engine
        places on ``device`` in eval mode and serves through
        ``make_forward`` (TF32 off) with a graph per bucket of its own.
        A rung whose rows would move with their batch runs at the
        largest bucket only (:func:`rows_follow_batch`).

    Identity (the socket transport's ``pong`` and ready file carry it):
    ``generation`` (0 at boot, +1 per swap), ``model_digest``
    (``checkpoint.variables_digest`` of the default rung's live weights)
    and ``variant_tags()`` (the default rung first).
    """

    def __init__(self, model=None, variables=None, *, image_size: int,
                 channels: int = 3, input_dtype=np.float32,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, queue_size: int = 256,
                 normalize: bool = False, mean=None, std=None,
                 forward_fn=None, stats: Optional[ServeStats] = None,
                 admission=None, autostart: bool = True,
                 device=None, variants: Optional[dict] = None,
                 default_variant: str = "fp32") -> None:
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
        self._forward_kw = dict(normalize=normalize, mean=mean, std=std)
        self.default_variant = str(default_variant)
        rungs = {self.default_variant: _Rung(
            model, forward_fn if forward_fn is not None
            else make_forward(model, **self._forward_kw))}
        for tag, rung_model in (variants or {}).items():
            tag = str(tag)
            if tag == self.default_variant:
                continue  # the constructor's model IS the default rung
            if model is None or not isinstance(rung_model, torch.nn.Module):
                raise ValueError(f"ladder rung {tag!r} needs a model, as "
                                 "the default rung does")
            rung_model.to(self.device).eval()
            rungs[tag] = _Rung(rung_model, make_forward(rung_model,
                                                        **self._forward_kw))
        self._gen = _Slot(rungs, torch.cuda.Stream(self.device)
                          if self.device.type == "cuda" else None)
        self._rung_buckets = {
            tag: self.buckets[-1:] if rows_follow_batch(tag, r.model)
            else self.buckets for tag, r in rungs.items()}
        self._standby: Optional[_Slot] = None
        # One swap at a time; the batcher holds _flip for the read of the
        # live slot and the launch with it, a swap for the flip.
        self._swap_lock = threading.Lock()
        self._flip = threading.Lock()
        self.stats = stats if stats is not None else ServeStats()
        # Requests whose rows reached the device as tensors on it, and
        # those that came as host arrays.
        self.device_requests = 0
        self.host_requests = 0
        # On the card: per bucket two page-locked staging buffers, each
        # with the event of its last copy to the device, and the next to
        # use.
        self._staging = {}
        self._traces = itertools.count(1)
        self.admission = admission
        self._queue = _PriorityQueue(max(1, int(queue_size)))
        self._held: Optional[_Request] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- identity ------------------------------------------------------
    @property
    def model(self):
        """The live slot's model."""
        return self._gen.model

    @property
    def generation(self) -> int:
        """Weight generation counter: 0 at boot, +1 per hot swap."""
        return self._gen.generation

    @property
    def model_digest(self) -> Optional[str]:
        """``variables_digest`` of the live weights (None for an engine
        built from a bare ``forward_fn``)."""
        gen = self._gen
        if gen.digest is None and gen.model is not None:
            from tpuic_torch.checkpoint.loading import variables_digest
            gen.digest = variables_digest(gen.model)
        return gen.digest

    def variant_tags(self) -> tuple:
        """The dtype ladder's tags, the default rung first."""
        return tuple(self._gen.rungs)

    def _variant(self, variant: Optional[str]) -> str:
        """``variant`` checked against the ladder; None is the default
        rung."""
        tag = self.default_variant if variant is None else str(variant)
        if tag not in self._gen.rungs:
            raise ValueError(f"unknown serve dtype {tag!r}; configured: "
                             f"{sorted(self._gen.rungs)}")
        return tag

    @property
    def _graphs(self) -> dict:
        """The live slot's graphs, by bucket."""
        return self._gen.graphs

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
    def bucket_for(self, n: int, variant: Optional[str] = None) -> int:
        """Smallest bucket >= n of rung ``variant`` (the default rung's
        when None): the shape the device will actually see."""
        for b in self._rung_buckets[self._variant(variant)]:
            if b >= n:
                return b
        raise ValueError(f"request of {n} rows exceeds max bucket "
                         f"{self.max_batch}")

    def warmup(self) -> dict:
        """Make every (rung, bucket) ready and return ``{bucket: secs}``
        for a single-rung engine, ``{variant: {bucket: secs}}`` for a
        ladder (``tpuic``'s shapes), each recorded through
        ``stats.record_compile`` (``compiles`` counts them).  On a CUDA
        device a bucket runs once eagerly, is captured into its graph and
        replayed once, from its pinned staging buffer, to the end of its
        readback; on the CPU it runs once eagerly.  The first run builds
        the kernels and folds the model's weights."""
        per_variant = {}
        for tag in self._gen.rungs:
            timings = per_variant[tag] = {}
            for b in self._rung_buckets[tag]:
                t0 = time.perf_counter()
                if self.device.type == "cuda":
                    with self._flip:
                        gen = self._gen
                        self._graph_for(gen, b, tag, record=False)
                        buf, ev = self._pinned(b)
                        buf.zero_()
                        launched = self._launch(gen, [(0, buf)], b, ev, tag)
                else:
                    batch = np.zeros((b, self.image_size, self.image_size,
                                      self.channels), self.input_dtype)
                    launched = self._launch(
                        self._gen, [(0, torch.from_numpy(batch))], b,
                        variant=tag)
                self._readback(launched)
                timings[b] = round(time.perf_counter() - t0, 3)
                self.stats.record_compile(b, timings[b])
        self._gen.captures = 0
        # The stats snapshot carries the served model's identity.
        self.stats.note_identity(self.model_digest or "", self.generation)
        if len(per_variant) == 1:
            return per_variant[self.default_variant]
        return per_variant

    def graph_memory(self) -> dict:
        """Device bytes the captured graphs hold, over the live slot and
        the standby (``slots``): their pools' segments (what the captures
        added to the reserved memory; ``pool_bytes_by_variant`` splits
        them by rung), their static inputs, and the K3 split-K scratch
        baked into them; and the page-locked host bytes of the staging
        buffers, by bucket."""
        slots = [s for s in (self._gen, self._standby) if s is not None]
        graphs = [(tag, g) for s in slots for tag, r in s.rungs.items()
                  for g in r.graphs.values()]
        by_variant = {}
        for tag, g in graphs:
            by_variant[tag] = by_variant.get(tag, 0) + g.pool_bytes
        return {"buckets": sorted(self._gen.graphs),
                "slots": sum(1 for s in slots
                             if any(r.graphs for r in s.rungs.values())),
                "pool_bytes": sum(g.pool_bytes for _, g in graphs),
                "pool_bytes_by_variant": by_variant,
                "static_input_bytes": sum(
                    g.static_in.numel() * g.static_in.element_size()
                    for _, g in graphs),
                "scratch_bytes": sum(t.numel() * t.element_size()
                                     for _, g in graphs for t in g.scratch),
                "pinned_bytes": {str(b): sum(
                    buf.numel() * buf.element_size() for buf, _ in bufs)
                    for b, (bufs, _) in sorted(self._staging.items())}}

    # -- request side --------------------------------------------------
    def submit(self, images, *, timeout: Optional[float] = None,
               priority: str = DEFAULT_PRIORITY,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               dtype: Optional[str] = None) -> Future:
        """Enqueue [n,S,S,C] (or one [S,S,C] row) for inference: a numpy
        array (or anything ``np.asarray`` takes), or a torch tensor of
        ``input_dtype`` on the engine's device.  A tensor on another
        device, the CPU included for an engine on the card, is refused
        with ``ValueError``.

        Returns a Future resolving to the forward's outputs (numpy)
        sliced to this request's n rows; ``fut.tpuic_trace`` is its trace
        id.  When the queue is full: ``timeout=None`` blocks
        (backpressure), ``timeout=0`` raises ``queue.Full`` immediately,
        other values wait that long first — unless a strictly
        lower-priority request is queued, in which case IT is evicted
        (its future gets a typed ``AdmissionRejected``) and this one is
        admitted.

        SLA fields: ``priority`` is one of ``admission.PRIORITIES``;
        ``deadline_ms`` is the request's latency budget, past which (or
        past which the estimated service would end) the batcher sheds it
        at pop time with ``DeadlineExceeded``; ``tenant`` names the quota
        bucket of an attached ``AdmissionController``, which may reject
        with a typed ``AdmissionRejected`` (also a ``queue.Full``).  With
        a controller attached a full queue raises ``AdmissionRejected``
        (cause ``queue_full``) too.  ``dtype`` names the ladder rung
        (``None``: the default rung); an unknown one raises ``ValueError``.

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
        # The SLA fields are validated before admission: a malformed one
        # failing after admit() would have spent a quota token.
        priority_index(priority)
        variant = self._variant(dtype)
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
        if self.admission is not None:
            verdict = self.admission.admit(priority=priority, tenant=tenant)
            if not verdict:
                self.stats.record_reject(verdict.cause, priority)
                raise AdmissionRejected(
                    f"admission rejected ({verdict.cause}, "
                    f"priority={priority}, tenant={tenant})",
                    cause=verdict.cause, priority=priority, tenant=tenant)
        ready = None
        if isinstance(arr, torch.Tensor) and arr.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(arr.device))
        fut: Future = Future()
        req = _Request(arr, fut, ready, trace=next(self._traces),
                       priority=priority, tenant=tenant,
                       deadline_ms=deadline_ms, variant=variant)
        fut.tpuic_trace = req.trace
        try:
            evicted = self._queue.put(req, timeout=timeout)
        except queue.Full:
            self.stats.record_reject("queue_full", priority)
            if self.admission is not None:
                raise AdmissionRejected(
                    f"queue full (priority={priority})", cause="queue_full",
                    priority=priority, tenant=tenant) from None
            raise
        if evicted is not None:
            # From the evicted request's point of view the queue was full
            # of more important work: the same typed verdict.
            self.stats.record_reject("queue_full", evicted.priority)
            if not evicted.future.cancelled():
                evicted.future.set_exception(AdmissionRejected(
                    f"evicted by a higher-priority arrival "
                    f"(priority={evicted.priority})", cause="queue_full",
                    priority=evicted.priority, tenant=evicted.tenant))
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
    def _capture(self, slot: _Slot, bucket: int, tag: str) -> _BucketGraph:
        """Capture bucket ``bucket``'s forward of ``slot``'s rung ``tag``
        into a CUDA graph in the slot's pool.  Raises ``RuntimeError``
        naming the bucket when the run before it or the capture fails: the
        card has no eager fallback."""
        from tpuic_torch.kernels import conv_bn_relu
        dev = self.device
        rung = slot.rungs[tag]
        static_in = torch.zeros(
            (bucket, self.image_size, self.image_size, self.channels),
            dtype=self._torch_dtype, device=dev)
        # Hazard, K3's split-K scratch: it is keyed by (device, stream)
        # and grows on demand, and a capture bakes its addresses into the
        # graph.  Each bucket therefore captures on a stream of its own,
        # after one eager run on that stream, which sizes a scratch for
        # exactly this bucket's convs; the capture then finds it large
        # enough and allocates none.  torch hands out its streams again
        # after a while, so the stream's scratch entry is dropped before
        # the eager run and after the capture: the graph holds the only
        # reference to its scratch, and no other launch or graph uses it.
        # The counters start every replay at zero: the kernel leaves
        # each it took at zero, and the eager run left them so.
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        key = (static_in.get_device(), stream.cuda_stream)
        try:
            conv_bn_relu._SCRATCH.pop(key, None)
            # The eager run builds the kernels, folds K3's weights and
            # makes the forward's device constants, none of which a
            # capture may do.
            with torch.cuda.stream(stream):
                _as_tuple(rung.forward(static_in))
            stream.synchronize()
            if slot.pool is None:
                # Hazard, memory: one pool for every graph of a slot,
                # every rung's.  That is safe because a slot's graphs never run
                # at once and each is used as one unit: the copy into a
                # static input, the replay and the copy out of the static
                # outputs go back to back on one stream (the batcher's,
                # or the swap's for a standby), so a block that two
                # graphs share is free again before the next unit's copy
                # in.  Every graph's static tensors stay referenced here,
                # so no later capture reuses them.  Another slot, whose
                # graphs may replay at the same time on another stream,
                # has a pool of its own.
                slot.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(dev)
            # The capture's stream has run everything before it (the
            # synchronize above), so ``torch.cuda.graph``'s device-wide
            # synchronize, which would wait on the batcher's replays, is
            # not needed: the capture is begun and ended by hand.
            with torch.cuda.stream(stream):
                graph.capture_begin(slot.pool,
                                    capture_error_mode="thread_local")
                try:
                    # Hazard, launch counters: they count in Python, so
                    # during the capture too, which launches nothing.
                    # This thread's counts go to a tally of its own, the
                    # graph's launches per replay, and never reach the
                    # counters that replays on other threads add to.
                    # Hazard, flags: the forward sets its TF32 flags
                    # itself (``make_forward``), inside the capture as in
                    # the eager run, under ``no_tf32``'s process-wide
                    # lock.
                    with counting.tally() as launches:
                        outputs = _as_tuple(rung.forward(static_in))
                finally:
                    graph.capture_end()
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of bucket {bucket} "
                               f"({tag}) failed: {e}") from e
        scratch = conv_bn_relu._SCRATCH.pop(key, None)
        scratch = (tuple(t for t in (scratch.ws, scratch.counters)
                         if t is not None) if scratch is not None else ())
        # The graph also bakes in the addresses of K3's folded weights.
        # The rung's first capture records them, a swap folds new weights
        # into these same tensors (``_write``), and every later capture
        # must read them too.  (The int8 rung folds inside its forward:
        # it keeps none.)
        folded = tuple((m, m._packed) for m in (
            rung.model.modules() if rung.model is not None else ())
            if getattr(m, "_packed", None) is not None)
        if rung.folded is None:
            rung.folded = folded
        elif [(id(m), id(t)) for m, t in folded] != [
                (id(m), id(t)) for m, t in rung.folded]:
            raise RuntimeError(f"CUDA graph of bucket {bucket} ({tag}) reads "
                               f"folded weights that the rung's other "
                               f"graphs do not")
        slot.captures += 1
        return _BucketGraph(graph, static_in, outputs,
                            tuple(launches.items()), scratch, pool_bytes)

    def _graph_for(self, slot: _Slot, bucket: int, tag: Optional[str] = None,
                   record: bool = True) -> _BucketGraph:
        tag = self.default_variant if tag is None else tag
        graphs = slot.rungs[tag].graphs
        g = graphs.get(bucket)
        if g is None:
            # A bucket not warmed is captured at its first use, once.
            t0 = time.perf_counter()
            g = graphs[bucket] = self._capture(slot, bucket, tag)
            if record:
                self.stats.record_compile(
                    bucket, round(time.perf_counter() - t0, 3))
        return g

    def _replay(self, g: _BucketGraph):
        """Replay ``g`` on the current stream; adds its launches to each
        kernel's counter."""
        g.graph.replay()
        counting.add_launches(g.launches)
        return g.outputs

    def replay(self, bucket: int, x: Optional[torch.Tensor] = None):
        """Copy ``x`` ([bucket, S, S, C] on the card; None keeps the
        static input as it is) into the default rung's static input of
        bucket ``bucket`` in the live slot, replay its graph on the
        current stream and return the static outputs, which the next
        replay of the bucket overwrites.  Adds the graph's launches to
        each kernel's counter."""
        g = self._graph_for(self._gen, bucket)
        if x is not None:
            g.static_in.copy_(x)
        return self._replay(g)

    def _pinned(self, bucket: int):
        """The next of the bucket's two page-locked staging buffers and
        its event, once the buffer's last copy to the device has ended
        (allocated at the bucket's first use).  Reusing a buffer before
        its copy ran would change a batch on its way to the device, with
        no error."""
        entry = self._staging.get(bucket)
        if entry is None:
            shape = (bucket, self.image_size, self.image_size, self.channels)
            bufs = [(torch.empty(shape, dtype=self._torch_dtype,
                                 pin_memory=True), torch.cuda.Event())
                    for _ in range(2)]
            entry = self._staging[bucket] = [bufs, 0]
        bufs, nxt = entry
        entry[1] = 1 - nxt
        buf, ev = bufs[nxt]
        ev.synchronize()  # returns at once for an event never recorded
        return buf, ev

    def _launch(self, slot: _Slot, parts, bucket: int, staged=None,
                variant: Optional[str] = None):
        """The copy in, the forward and the device->host copy with
        ``slot``'s rung ``variant`` (the default rung when None), all
        enqueued on the current stream; returns ``(host tensors, event)``
        where the event marks the copy's end (``None`` on the CPU).
        ``parts`` are ``(row offset, tensor)`` pieces of the batch, on the
        host (page-locked on the card) or on the engine's device; rows
        past the last piece are padding (zeros).  ``staged`` is the event
        of the staging buffer the host pieces came from, recorded after
        their copies."""
        rows = sum(t.shape[0] for _, t in parts)
        if self.device.type != "cuda":
            if len(parts) == 1 and rows == bucket:
                x = parts[0][1]
            else:
                x = torch.zeros((bucket,) + tuple(parts[0][1].shape[1:]),
                                dtype=parts[0][1].dtype)
                for off, t in parts:
                    x[off:off + t.shape[0]] = t
            tag = self.default_variant if variant is None else variant
            return _as_tuple(slot.rungs[tag].forward(
                x.to(self.device))), None
        g = self._graph_for(slot, bucket, variant)
        stream = torch.cuda.current_stream(self.device)
        for off, t in parts:
            g.static_in[off:off + t.shape[0]].copy_(t, non_blocking=True)
        if staged is not None:
            staged.record(stream)
        if rows < bucket:
            g.static_in[rows:].zero_()
        out = self._replay(g)
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

    # -- hot swap ------------------------------------------------------
    def _candidate(self, variables, variants) -> dict:
        """A swap's candidates by rung: the tag set must equal the
        ladder's (the ladder swaps as one unit)."""
        staged = {}
        if variables is not None:
            staged[self.default_variant] = variables
        for tag, spec in (variants or {}).items():
            tag = str(tag)
            if tag in staged:
                raise ValueError(f"duplicate swap rung {tag!r}")
            staged[tag] = spec
        if set(staged) != set(self._gen.rungs):
            raise ValueError(
                f"swap must replace the dtype ladder as one unit: "
                f"configured rungs {sorted(self._gen.rungs)}, swap covers "
                f"{sorted(staged)}")
        return staged

    @staticmethod
    def _same_shapes(a: torch.nn.Module, b: torch.nn.Module) -> bool:
        sa, sb = a.state_dict(), b.state_dict()
        return (list(sa) == list(sb) and all(
            sa[k].shape == sb[k].shape and sa[k].dtype == sb[k].dtype
            for k in sa) and type(a) is type(b))

    def _stream_ctx(self, slot: _Slot):
        return (torch.cuda.stream(slot.stream) if slot.stream is not None
                else contextlib.nullcontext())

    def _write(self, rung: _Rung, cand) -> None:
        """Write ``cand`` (a ``tpuic`` variables tree, a ``state_dict`` or
        a model) into ``rung``'s model in place, then fold K3's weights
        into the tensors its graphs read (``rung.folded``).  Loading drops
        a model's folded weights, and the next fold would build new
        tensors while the graphs go on reading the old ones: the old
        weights, with no error.  Runs on the current stream (the standby
        slot's)."""
        model = rung.model
        rung.staged = None
        with torch.no_grad():
            try:
                if isinstance(cand, torch.nn.Module):
                    model.load_state_dict(cand.state_dict())
                elif isinstance(cand, Mapping) and "params" in cand:
                    load_jax_variables(model, cand)
                elif isinstance(cand, Mapping):
                    model.load_state_dict(cand)
                else:
                    raise TypeError(f"swap candidate must be a tpuic "
                                    f"variables tree, a state_dict or a "
                                    f"model, got {type(cand).__name__}")
            finally:
                # A load that fails has dropped them too (torch checks the
                # keys after it wrote those that match): the graphs' fold
                # targets go back either way.
                for m, packed in rung.folded or ():
                    m._packed = packed
            for m, packed in rung.folded or ():
                m._packed = None
                _copy_into(packed, m.packed_weights())
                m._packed = packed
        rung.staged = cand

    def _new_slot(self, models: dict) -> _Slot:
        return _Slot({tag: _Rung(m, make_forward(m, **self._forward_kw))
                      for tag, m in models.items()},
                     torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)

    def _load(self, cands: dict, *, new_shapes: bool) -> _Slot:
        """The slot that holds ``cands`` (``{tag: candidate}``) once it
        returns (its work on the device done): the standby with each
        candidate written into its rung (made at the first swap from a
        copy of every live rung, its graphs captured then), or — for
        models of other shapes, when ``new_shapes`` — a new slot around
        those models, one a rung, captured off-path.  Call under the swap
        lock."""
        live = self._gen
        if live.model is None:
            raise ValueError("swap needs an engine built from a model; this "
                             "one serves a bare forward_fn")
        reshaped = [tag for tag, c in cands.items()
                    if isinstance(c, torch.nn.Module) and not
                    self._same_shapes(c, live.rungs[tag].model)]
        if reshaped:
            if not new_shapes:
                raise ValueError(
                    "candidate model is not shaped like the serving model: "
                    "gate it through swap_weights, which captures a new "
                    "slot for it")
            if not all(isinstance(cands.get(t), torch.nn.Module)
                       for t in live.rungs):
                raise ValueError(
                    f"rungs {reshaped} of the swap are shaped unlike the "
                    "serving ladder: every rung then needs a model")
            slot = self._new_slot({t: cands[t].to(self.device).eval()
                                   for t in live.rungs})
            if slot.stream is not None:
                slot.stream.wait_stream(torch.cuda.current_stream(
                    self.device))
        else:
            slot = self._standby
            if slot is None:
                slot = self._standby = self._new_slot({})
            elif slot.last_event is not None:
                # The last batch dispatched with this slot before it went
                # standby must be done before its weights change.
                slot.last_event.synchronize()
            if slot.stream is not None:
                # The candidate's tensors may still be in the making on
                # the caller's stream.
                slot.stream.wait_stream(torch.cuda.current_stream(
                    self.device))
            with self._stream_ctx(slot):
                if not slot.rungs:
                    slot.rungs.update(self._new_slot(
                        {t: copy.deepcopy(r.model)
                         for t, r in live.rungs.items()}).rungs)
                for tag, cand in cands.items():
                    rung = slot.rungs[tag]
                    if rung.staged is not cand:
                        # A gate's candidate_outputs wrote it already.
                        self._write(rung, cand)
        if self.device.type == "cuda":
            with torch.cuda.stream(slot.stream):
                for tag in slot.rungs:
                    for b in self._rung_buckets[tag]:
                        self._graph_for(slot, b, tag)
            slot.stream.synchronize()
        return slot

    def swap_weights(self, variables=None, *,
                     variants: Optional[dict] = None) -> dict:
        """Atomically replace the serving weights: no drain, no dropped
        request.

        ``variables`` is the new default rung: a ``tpuic`` variables tree
        (numpy leaves), a port ``state_dict`` or a model; ``variants``
        maps the other ladder tags to theirs (the rung's module or its
        ``state_dict``: ``tpuic_torch.quant.serve_variants`` of the new
        float32 model).  The tag set must equal the configured ladder
        (``ValueError`` otherwise): the ladder swaps as one unit.

        A ladder shaped like the serving one is written into the standby
        slot, whose graphs then read it: ``reused_executables`` is true
        when no (rung, bucket) was captured for it (every swap after the
        first); ``prewarmed`` counts the captures made since the slot last
        served.  Models of other shapes get a new slot, captured off-path;
        the old one is freed once its last batch has run.  A candidate
        object that ``candidate_outputs`` was just given is already in the
        standby and is not written again: the engine borrows it,
        unchanged, from the one call to the other.  The flip is one
        reference assignment between two batches: a batch runs all old or
        all new weights, and in-flight and queued requests resolve, none
        re-run.  One swap at a time.  Returns ``{generation, digest,
        reused_executables, prewarmed, duration_s, batcher_hold_s}``, the
        last the host time the flip held the batcher."""
        from tpuic_torch.checkpoint.loading import variables_digest
        t0 = time.perf_counter()
        with self._swap_lock:
            cands = self._candidate(variables, variants)
            slot = self._load(cands, new_shapes=True)
            # The digest reads the weights off the batcher's stream.
            with self._stream_ctx(slot):
                slot.digest = variables_digest(slot.model)
            for rung in slot.rungs.values():
                rung.staged = None
            with self._flip:
                t_flip = time.perf_counter()
                old = self._gen
                slot.generation = old.generation + 1
                self._gen = slot  # THE flip: one reference
                hold = time.perf_counter() - t_flip
            if slot is self._standby:
                old.captures = 0
                self._standby = old
            else:
                # Other shapes: the old slots cannot take the next
                # candidate.  The old live slot goes once its last batch
                # has run (the graphs hold its memory until then).
                self._standby = None
                if old.last_event is not None:
                    old.last_event.synchronize()
                del old
            prewarmed, slot.captures = slot.captures, 0
            duration_s = time.perf_counter() - t0
            self.stats.record_swap(slot.generation, slot.digest)
        return {"generation": slot.generation, "digest": slot.digest,
                "reused_executables": prewarmed == 0,
                "prewarmed": prewarmed, "duration_s": round(duration_s, 4),
                "batcher_hold_s": round(hold, 6)}

    def candidate_outputs(self, variables, images, *,
                          variant: Optional[str] = None):
        """The outputs of rung ``variant`` (the default rung when None)
        on ``images`` with ``variables`` in place of its serving weights,
        without touching what traffic sees: the candidate is written into
        the standby slot's rung and its graphs replay on the slot's
        stream — the same graphs, and so the same bits, that serve it
        after a swap.  Raises ``ValueError`` for an unknown rung, and for
        a model shaped unlike the serving one (swap_weights captures
        those).  Returns numpy arrays with ``images``' rows."""
        variant = self._variant(variant)
        arr = np.asarray(images, self.input_dtype)
        if arr.ndim == 3:
            arr = arr[None]
        chunks = []
        with self._swap_lock:
            slot = self._load({variant: variables}, new_shapes=False)
            rung = slot.rungs[variant]
            for lo in range(0, arr.shape[0], self.max_batch):
                chunk = arr[lo:lo + self.max_batch]
                n = chunk.shape[0]
                bucket = self.bucket_for(n, variant)
                if slot.stream is None:
                    x = np.zeros((bucket,) + chunk.shape[1:], chunk.dtype)
                    x[:n] = chunk
                    out = _as_tuple(rung.forward(torch.from_numpy(x)))
                    chunks.append(tuple(t[:n].numpy() for t in out))
                    continue
                with torch.cuda.stream(slot.stream):
                    g = self._graph_for(slot, bucket, variant)
                    g.static_in[:n].copy_(torch.from_numpy(
                        np.ascontiguousarray(chunk)))
                    g.static_in[n:].zero_()
                    out = self._replay(g)
                    chunks.append(tuple(t[:n].cpu().numpy() for t in out))
        if len(chunks) == 1:
            return chunks[0]
        return tuple(np.concatenate(xs, axis=0) for xs in zip(*chunks))

    # -- batcher thread ------------------------------------------------
    def _maybe_shed(self, req: _Request) -> bool:
        """Pop-time deadline shed: True when ``req``'s deadline has passed
        or will within ``stats.estimated_service_s()``; its future then
        gets a typed ``DeadlineExceeded``.  Shedding happens strictly
        before batch membership, so batchmates are untouched.  True also
        for a request whose caller cancelled its future (the serve CLI's
        drain does): it costs no device work, and a close after a drain
        does not wait on it."""
        if req.future.cancelled():
            return True
        if req.deadline is None:
            return False
        if time.monotonic() + self.stats.estimated_service_s() \
                <= req.deadline:
            return False
        self.stats.record_reject("deadline", req.priority)
        if not req.future.cancelled():
            req.future.set_exception(DeadlineExceeded(
                f"deadline expired before service (trace {req.trace}, "
                f"priority={req.priority})", priority=req.priority,
                tenant=req.tenant))
        return True

    def _gather(self, idle_timeout: float):
        """One coalescing decision: requests (highest priority class
        first, FIFO within a class) until max_batch rows or max_wait_ms
        after the batch opened.  A request that would overflow max_batch,
        or that names another rung than the batch's, is held and leads the
        next batch, whatever its class.  Expired deadlines are shed here,
        at pop time."""
        first, self._held = self._held, None
        if first is not None and self._maybe_shed(first):
            first = None
        while first is None:
            try:
                first = self._queue.get(timeout=idle_timeout)
            except queue.Empty:
                return None
            # A held request keeps its first pop time: the wait while held
            # belongs to batch formation.
            first.t_gather = time.monotonic()
            if self._maybe_shed(first):
                first = None
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
            if self._maybe_shed(nxt):
                continue
            if rows + nxt.n > self.max_batch or nxt.variant != first.variant:
                # A device batch runs ONE rung's graph, so a rung boundary
                # closes the batch as an overflow does: the request is
                # held and leads the next batch.
                self._held = nxt
                break
            reqs.append(nxt)
            rows += nxt.n
        return reqs

    def _stage(self, reqs):
        """``(requests kept, bucket, (offset, tensor) parts, event)``.
        Host arrays are gathered into one padded batch — on the card into
        a page-locked staging buffer, whose event comes back with the
        parts; tensors on the device go in as they are, padded on the
        device.

        Error isolation: a request whose array fails the staging copy
        gets the exception on ITS future and is dropped from the batch —
        its batchmates still dispatch and resolve.  The survivors may then
        fit a smaller bucket (rows packed contiguously from 0)."""
        variant = reqs[0].variant  # _gather keeps a batch to one rung
        bucket = self.bucket_for(sum(r.n for r in reqs), variant)
        on_card = self.device.type == "cuda"
        n_hosts = sum(not isinstance(r.images, torch.Tensor) for r in reqs)
        buf = ev = batch = None
        if on_card and n_hosts:
            buf, ev = self._pinned(bucket)
            batch = buf.numpy()
        elif n_hosts == len(reqs) == 1 and reqs[0].n == bucket:
            self.host_requests += 1
            return reqs, bucket, [(0, torch.from_numpy(
                np.ascontiguousarray(reqs[0].images)))], None
        elif n_hosts:
            batch = np.zeros((bucket, self.image_size, self.image_size,
                              self.channels), self.input_dtype)
        parts, off, ok, hosts = [], 0, [], 0
        for r in reqs:
            if isinstance(r.images, torch.Tensor):
                if r.ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        r.ready)
                parts.append((off, r.images))
            else:
                try:
                    batch[off:off + r.n] = r.images
                except Exception as e:
                    if not r.future.cancelled():
                        r.future.set_exception(e)
                    continue
                parts.append((off, None))
                hosts += 1
            ok.append(r)
            off += r.n
        if not ok:
            return None
        if hosts:
            rows = buf if on_card else torch.from_numpy(batch)
            parts = ([(0, rows[:off])] if hosts == len(ok) else
                     [(o, rows[o:o + r.n] if t is None else t)
                      for (o, t), r in zip(parts, ok)])
        self.device_requests += len(ok) - hosts
        self.host_requests += hosts
        return (ok, self.bucket_for(off, variant), parts,
                ev if hosts else None)

    def _dispatch(self, reqs):
        """Pad to bucket, then launch.  Returns the in-flight batch (None
        when every request failed staging); results are NOT read back
        here, so the device works on this batch while the batcher
        assembles the next one."""
        t_batch = time.monotonic()  # batch closed: formation span ends
        staged = self._stage(reqs)
        if staged is None:
            return None
        reqs, bucket, parts, used = staged
        rows = sum(r.n for r in reqs)
        t_staged = time.monotonic()  # staging (pad/copy) span ends
        self.stats.record_dispatch(bucket, rows,
                                   [t_staged - r.t_enqueue for r in reqs])
        # ONE read of the live slot per batch: a swap flips it between
        # batches, never inside one, and cannot write the old slot until
        # this batch's event (the slot's last) has completed.
        with self._flip:
            gen = self._gen
            launched = self._launch(gen, parts, bucket, used,
                                    reqs[0].variant)
            gen.last_event = launched[1]
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
