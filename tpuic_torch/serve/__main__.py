"""``python -m tpuic_torch.serve`` — the port's online inference server
(``tpuic/serve/__main__.py``).

Three request sources, all feeding the same ``InferenceEngine``:

- **stdin JSONL** (default): one request per line,
  ``{"id": "r1", "path": "img.png"}`` (``id`` optional, defaults to the
  path).  Responses stream to --out (default stdout) as JSONL:
  ``{"id", "pred", "prob", "topk": [[name, prob], ...]}``.
- **directory watch** (``--watch DIR``): polls DIR for new image files
  and classifies each once; ``--once`` processes the current contents
  and exits.
- **socket JSONL** (``--listen HOST:PORT``): the replica transport.  Same
  request lines as stdin plus a ``{"b64", "shape", "dtype"}`` raw-array
  payload (``wire.py``) and a ``{"op": "ping"}`` probe answered with
  ``pong``, the queue depth, the model's identity (digest, generation)
  and the process's kernel launches; responses go back on the
  requesting connection, keyed by id.  ``--ready-file`` atomically
  publishes the bound port and pid once the engine is warm.

On the card the engine's warmup captures one CUDA graph per bucket
(``--buckets``), and every device call replays one.  Decoding request N+1
overlaps the device call for batch N: the server only submits work and
drains completed futures; the engine's batcher thread owns the device.

    python -m tpuic_torch.serve --ckpt-dir dtmodel/cp --model auto < reqs.jsonl
    python -m tpuic_torch.serve --ckpt-dir dtmodel/cp --watch incoming/ --once
    python -m tpuic_torch.serve --ckpt-dir dtmodel/cp --listen 127.0.0.1:0 \\
        --ready-file ready.json

``--device cpu`` runs on the CPU (the tests).  A final stats line goes to
stderr on shutdown.  SIGTERM latches a ``PreemptionGuard``: the server
stops accepting, drains what is in flight for up to ``--drain-timeout``
seconds (stragglers get a typed error line, never a silent drop), closes
the engine and exits 0.

Admission (``--admission``, ``--quota TENANT=RPS``; a quota implies
admission): request lines may carry ``priority``, ``deadline_ms`` and
``tenant``; the enqueue does not block, and a full queue, a dry quota or
a passed deadline answers with a typed error line naming its cause.
Without ``--admission`` those fields are ignored, as in ``tpuic``.

The dtype ladder (``--serve-dtypes fp32,bf16,int8``;
``tpuic_torch.quant``): beside fp32 the engine serves the bf16 model and
the int8 weight-only quantization of the same checkpoint, each rung with
its own CUDA graph per bucket.  At start every rung must agree with fp32
on the top-1 class of at least ``1 - quant.DEFAULT_EPSILON`` of the
pinned eval images, or the server exits nonzero.  A request's
``serve_dtype`` names its rung (default fp32; one not configured gets a
typed error line), and pongs and the ready file list the rungs in
``dtypes``.

Hot swap: a ``{"op": "swap", "id", "synthetic_seed": N}`` line (seeded
weights of the served architecture) or ``{"op": "swap", "id",
"ckpt_dir", "track"}`` line (a committed checkpoint, CRC-verified, no
ladder) gates and flips the candidate on a worker thread while traffic
and pings go on: the ladder is rebuilt from the candidate and swaps as
one unit.  A candidate that fails the integrity gate gets a typed
``swap_corrupt`` line, one with non-finite outputs on the pinned eval
images, or a rung that disagrees with the candidate's fp32, a
``swap_accuracy`` line, and a flipped one ``{"op":
"swap_result", "ok": true, "generation", "digest", ...}``; ``pong`` and
the ready file carry the new identity.

Operating the replica, as ``tpuic``'s server does:

- ``--slo 'serve_latency:p99<=50ms'`` tracks latency objectives from the
  engine's per-request ``serve_span`` events; ``--brownout-slo`` names
  one whose error-budget burn past ``--brownout-tighten`` sheds the
  lowest priority class still admitted, recovering below
  ``--brownout-recover`` (brownout implies ``--admission``).
- ``--prom-port`` serves ``/metrics`` (``-1``: a free port, named in the
  ready file), ``--prom-dump`` writes the exposition at shutdown (and
  each ``--watch`` tick): latency and span percentiles, rejects by cause
  and priority, brownout and quota gauges, SLO rows, the device memory
  (the allocator's counters, read at scrape time with no sync), the
  engine's CUDA-graph rows, and the measured waterfall of the largest
  bucket's graph, taken at warmup and after a swap that captured graphs
  of new shapes, never at scrape time.
- Under ``python -m tpuic_torch.supervise`` the server writes the
  heartbeat from its batches and its accept loop, installs the flight
  recorder and a faulthandler stack dump on SIGQUIT (chained).
- ``TPUIC_FAULTS`` (``runtime/faults.py``): ``flood#RATE`` submits a
  low-priority storm from inside the process, ``replica_crash@N``
  SIGKILLs the server at the Nth request ``--listen`` accepts and
  ``replica_wedge@N`` stops servicing its socket there; the engine fires
  ``hang_device`` and ``canary_degrade``.  A spec that does not parse, or
  that arms a point the port's serving path does not fire, fails at start.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future as _FutFuture
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np

from tpuic_torch.serve import wire
from tpuic_torch.serve.admission import AdmissionError

_PROG = "python -m tpuic_torch.serve"

# One swap at a time per process: a second candidate racing the first
# would gate against a moving incumbent.
_SWAP_LOCK = threading.Lock()


def eval_images(n: int, size: int, seed: int = 0) -> np.ndarray:
    """The pinned synthetic eval set the gates use
    (``tpuic_torch.quant.eval_images``)."""
    from tpuic_torch import quant
    return quant.eval_images(n, size, seed)


def _load_image(path: str, size: int) -> np.ndarray:
    """Decode + resize exactly like the training/predict pipeline
    (folder.py -> transforms.resize_nearest): the checkpoint's val
    accuracy was measured on nearest-resized pixels, and serving the same
    image through another interpolation would shift predictions relative
    to ``python -m tpuic_torch.predict``."""
    from PIL import Image

    from tpuic_torch.data.transforms import resize_nearest
    img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return resize_nearest(img, size)


def _class_names(ckpt_dir: str, model: str, num_classes: int,
                 classes_file: str) -> dict:
    """index -> display name: --classes file (one name per line) wins,
    else the class_to_idx.json sidecar the Trainer writes, else indices."""
    names = {i: str(i) for i in range(num_classes)}
    if classes_file:
        with open(classes_file) as f:
            for i, line in enumerate(ln.strip() for ln in f):
                if line:
                    names[i] = line
        return names
    sidecar = os.path.join(ckpt_dir, model, "class_to_idx.json")
    try:
        with open(sidecar) as f:
            names.update({int(v): k for k, v in json.load(f).items()})
    except (OSError, ValueError):
        pass
    return names


def _result_record(rid, probs, order, names, k: int) -> dict:
    """One response record: ``{"id", "pred", "prob", "topk"}`` — the
    shape every transport (stdin, watch, socket) emits."""
    topk = [[names.get(int(order[0, j]), str(int(order[0, j]))),
             round(float(probs[0, order[0, j]]), 6)]
            for j in range(k)]
    return {"id": rid, "pred": topk[0][0], "prob": topk[0][1],
            "topk": topk}


def _kernel_launches() -> dict:
    """This process's launches of each counted kernel wrapper (graph
    replays included): a pong's ``kernel_launches``, so a parent reads
    them per replica life.  Host counters; no device read."""
    from tpuic_torch.kernels import counted_kernels
    return {fn.__name__: fn.launches for fn in counted_kernels()}


def serve_socket(engine, *, listen: str, names, top_k: int, size: int,
                 guard, beat=lambda: None, drain_timeout: float = 30.0,
                 ready_file: str = "", prom_port=None,
                 log=lambda msg: print(msg, file=sys.stderr)) -> int:
    """The socket-JSONL replica transport; returns the requests served.

    Accepts connections on ``listen`` (HOST:PORT, port 0 = kernel
    assigned) and speaks newline-delimited JSON per connection:

    - request lines as in stdin mode (``path`` or a ``b64`` raw-array
      payload), answered on the SAME connection with the usual result
      record or a typed error line (``wire.py``); responses are keyed by
      id and may arrive out of submission order.
      Under ``--admission`` (``engine.admission`` set) the SLA fields
      ``priority``/``deadline_ms``/``tenant`` are honoured and the
      enqueue does not block: a rejection is a typed error line.
    - ``{"op": "ping", "id": ...}`` -> ``{"op": "pong", "id",
      "queue_depth", "inflight", "digest", "generation", "pid",
      "kernel_launches"}`` (the last the port's: each counted kernel's
      launches in this process, graph replays included).
    - ``{"op": "swap", ...}`` -> gate and flip on a worker thread
      (``submit_swap``); its ``swap_result`` or typed verdict comes back
      keyed by id like any answer, and the ready file is written again
      with the new identity.

    Single-threaded select loop: reads submit, completed futures flush
    each tick, ``beat()`` ticks the supervisor's heartbeat, and the
    SIGTERM latch drains everything in flight for up to ``drain_timeout``
    seconds with typed straggler lines.  ``ready_file`` is written
    (atomically, with ``prom_port``) once the socket is bound; the engine
    is already warm by then.

    Fault points (``runtime/faults.py``): ``replica_crash`` SIGKILLs this
    process at the Nth accepted request; ``replica_wedge`` stops
    servicing the socket there (pings included), so the heartbeat goes
    stale."""
    import select
    import signal as _signal
    import socket as _socket

    from tpuic_torch.runtime import faults as _faults

    host, port = wire.parse_hostport(listen)
    srv = _socket.create_server((host, port), backlog=64)
    srv.setblocking(False)
    bound = srv.getsockname()[1]

    def publish_ready() -> None:
        if ready_file:
            wire.write_ready_file(
                ready_file, port=int(bound), pid=os.getpid(),
                prom_port=prom_port, digest=engine.model_digest,
                dtypes=list(engine.variant_tags()),
                generation=engine.generation)

    publish_ready()
    log(f"[serve] socket-JSONL transport on {host}:{bound}"
        + (f" (ready file {ready_file})" if ready_file else ""))

    # socket -> {"buf": bytes, "out": bytearray, "out_ofs": int,
    #            "pending": deque}; "out" holds unsent response bytes
    # from index "out_ofs" on (cleared when fully drained, so its
    # truthiness means "has pending output" at every check site).
    conns: dict = {}
    served = 0
    accepted = 0
    # A peer that stops reading grows its out buffer without bound; past
    # this the connection is dropped rather than ballooning the server.
    max_out_buf = 8 << 20

    def close_conn(sock) -> None:
        st = conns.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass
        if st is None:
            return
        for _, fut in st["pending"]:
            # Client gone: nothing to deliver to.  Swallow the outcome so
            # an abandoned future never logs "exception never retrieved".
            fut.add_done_callback(lambda f: f.cancelled() or f.exception())

    def pump_out(sock) -> None:
        """Drain as much of the connection's out buffer as the kernel
        will take WITHOUT blocking: a stalled peer must never stall the
        select loop (and every other connection's pings).  The buffer is
        consumed through an offset, compacted every 256 KB.  Each send
        takes a copy of at most 256 KB of it, never a memoryview: a view
        still alive when the buffer is resized below raises BufferError
        ("Existing exports of data") and killed a replica under the
        router's pings."""
        st = conns.get(sock)
        if st is None or not st["out"]:
            return
        ofs = st["out_ofs"]
        try:
            n = sock.send(bytes(st["out"][ofs:ofs + (1 << 18)]))
        except (BlockingIOError, InterruptedError):
            return  # kernel buffer full: the writable set drains it
        except OSError:
            close_conn(sock)
            return
        st["out_ofs"] += n
        if st["out_ofs"] >= len(st["out"]):
            del st["out"][:]
            st["out_ofs"] = 0
        elif st["out_ofs"] > (1 << 18):
            del st["out"][:st["out_ofs"]]
            st["out_ofs"] = 0

    def send(sock, rec: dict) -> None:
        st = conns.get(sock)
        if st is None:
            return
        st["out"] += (json.dumps(rec) + "\n").encode()
        if len(st["out"]) - st["out_ofs"] > max_out_buf:
            close_conn(sock)  # peer stopped reading: conclusive
            return
        pump_out(sock)

    def handle_line(sock, st, raw: str) -> None:
        nonlocal accepted
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                raise ValueError("not an object")
        except ValueError:
            send(sock, wire.error_record(
                None, f"bad request line: {raw[:80]}"))
            return
        if req.get("op") == "ping":
            send(sock, {"id": req.get("id"), "op": "pong",
                        "queue_depth": engine.queue_depth(),
                        "inflight": sum(len(s["pending"])
                                        for s in conns.values()),
                        "digest": engine.model_digest,
                        "generation": engine.generation,
                        "dtypes": list(engine.variant_tags()),
                        "pid": os.getpid(),
                        "kernel_launches": _kernel_launches()})
            return
        if req.get("op") == "swap":
            # Control line, not traffic: gate and flip on a worker thread
            # so pings and requests keep flowing.
            st["pending"].append((str(req.get("id", "swap")),
                                  submit_swap(engine, req, log)))
            return
        accepted += 1
        if _faults.fire("replica_crash", accepted):
            os.kill(os.getpid(), _signal.SIGKILL)
        if _faults.fire("replica_wedge", accepted):
            w = _faults.param("replica_wedge")
            time.sleep(3600.0 if w is None else float(w))
        rid = str(req.get("id", req.get("path", accepted)))
        try:
            if req.get("b64") is not None:
                img = wire.decode_array(req)
            elif req.get("path") is not None:
                img = _load_image(str(req["path"]), size)
            else:
                raise ValueError("request needs 'path' or 'b64'")
        except Exception as e:  # noqa: BLE001
            send(sock, wire.error_record(rid, f"decode: {e}"))
            return
        try:
            st["pending"].append((rid, engine.submit(img, **_sla(engine,
                                                                 req))))
        except (AdmissionError, ValueError, TypeError) as e:
            send(sock, wire.error_record(rid, e))

    def flush(sock, st) -> None:
        """Emit every completed future on this connection (any order:
        responses are keyed by id)."""
        nonlocal served
        still = deque()
        while st["pending"]:
            rid, fut = st["pending"].popleft()
            if not fut.done():
                still.append((rid, fut))
                continue
            if fut.cancelled():
                send(sock, wire.error_record(rid, "cancelled"))
            elif fut.exception() is not None:
                send(sock, wire.error_record(rid, fut.exception()))
            elif isinstance(fut.result(), dict):
                # A swap's outcome: already a record, not traffic.
                send(sock, {**fut.result(), "id": rid})
                publish_ready()
            else:
                probs, order = fut.result()
                send(sock, _result_record(rid, probs, order, names, top_k))
                served += 1
            if sock not in conns:
                # send() failed and close_conn ran: the entries already
                # moved to `still` get the same treatment as the rest.
                for _, f in still:
                    f.add_done_callback(
                        lambda fu: fu.cancelled() or fu.exception())
                return
        st["pending"] = still

    try:
        while not guard.triggered:
            # Only pending futures need the fast poll tick: buffered
            # output is event-driven through the writable set.
            busy = any(s["pending"] for s in conns.values())
            try:
                ready, writable, _ = select.select(
                    [srv] + list(conns),
                    [s for s, st in conns.items() if st["out"]], [],
                    0.005 if busy else 0.1)
            except (OSError, ValueError):
                break
            for sock in writable:
                pump_out(sock)
            for sock in ready:
                if sock is srv:
                    try:
                        c, _ = srv.accept()
                        c.setblocking(False)  # sends buffer, never stall
                        conns[c] = {"buf": b"", "out": bytearray(),
                                    "out_ofs": 0, "pending": deque()}
                    except OSError:
                        pass
                    continue
                st = conns.get(sock)
                if st is None:
                    continue
                try:
                    chunk = sock.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue  # spurious wakeup on a non-blocking sock
                except OSError:
                    chunk = b""
                if not chunk:
                    close_conn(sock)  # peer EOF
                    continue
                *lines, st["buf"] = (st["buf"] + chunk).split(b"\n")
                for raw in lines:
                    if sock not in conns:
                        # The connection was dropped mid-chunk: the rest
                        # of it has nobody to answer to.
                        break
                    if raw.strip():
                        handle_line(sock, st, raw.decode("utf-8", "replace"))
            for sock in list(conns):
                if sock in conns:
                    flush(sock, conns[sock])
            beat()
        # SIGTERM drain: stop accepting, flush in-flight for the grace
        # window, typed straggler lines.
        n_pending = sum(len(s["pending"]) for s in conns.values())
        if guard.triggered and n_pending:
            log(f"[serve] SIGTERM: draining {n_pending} in-flight "
                f"socket request(s) (timeout {drain_timeout:.1f}s)")
            deadline = time.monotonic() + max(0.0, drain_timeout)
            while (any(s["pending"] for s in conns.values())
                   and time.monotonic() < deadline):
                for sock in list(conns):
                    if sock in conns:
                        flush(sock, conns[sock])
                        pump_out(sock)
                time.sleep(0.02)
            for sock in list(conns):
                st = conns.get(sock)
                if st is None:
                    continue
                flush(sock, st)
                for rid, fut in st["pending"]:
                    fut.cancel()
                    send(sock, wire.error_record(
                        rid, "drain timeout: engine shutting down "
                        "before this request finished"))
                st["pending"] = deque()
        # Flush buffered response bytes before the sockets close: a typed
        # straggler line left in an out buffer is a silent drop to the
        # peer.
        flush_deadline = time.monotonic() + 2.0
        while (any(s["out"] for s in conns.values())
               and time.monotonic() < flush_deadline):
            try:
                _, writable, _ = select.select(
                    [], [s for s, st in conns.items() if st["out"]],
                    [], 0.05)
            except (OSError, ValueError):
                break
            for sock in writable:
                pump_out(sock)
    finally:
        for sock in list(conns):
            close_conn(sock)
        try:
            srv.close()
        except OSError:
            pass
        if ready_file:
            try:
                os.remove(ready_file)  # a stopped server must not look ready
            except OSError:
                pass
    return served


def _sla(engine, req: dict) -> dict:
    """``submit`` keywords from a request line: under ``--admission`` its
    ``priority``/``deadline_ms``/``tenant`` and a non-blocking enqueue
    (without it a client self-assigning ``high`` could evict others'
    requests on a plain FIFO server); ``serve_dtype`` names the rung
    (``dtype`` is the array payload's element type)."""
    sla = {}
    if engine.admission is not None:
        sla = {f: req[f] for f in ("priority", "deadline_ms", "tenant")
               if req.get(f) is not None}
        sla["timeout"] = 0
    if req.get("serve_dtype") is not None:
        sla["dtype"] = str(req["serve_dtype"])
    return sla


def _swap_context(engine, *, mcfg, resize: int, mean, std,
                  ckpt_dir: str, track: str) -> None:
    """Attach what a later ``{"op": "swap"}`` line needs to build and gate
    a candidate for this engine: the served architecture, its image size
    and normalisation, the default checkpoint location.  An engine built
    elsewhere has none and answers swap lines with a typed error."""
    engine.tpuic_swap_ctx = {"mcfg": mcfg, "resize": int(resize),
                             "tags": tuple(engine.variant_tags()),
                             "mean": mean, "std": std,
                             "ckpt_dir": ckpt_dir, "track": track}


def _gate_outputs(engine, cand, imgs, tag: str):
    """A candidate's outputs on the gate images: through the standby
    slot's graphs (``candidate_outputs``) when it is shaped like the
    served model, else through its own eager forward (``swap_weights``
    captures a slot for it)."""
    import torch

    from tpuic_torch.serve.engine import make_forward
    try:
        return engine.candidate_outputs(cand, imgs, variant=tag)
    except ValueError:
        if not isinstance(cand, torch.nn.Module):
            raise
        ctx = engine.tpuic_swap_ctx
        out = make_forward(cand, normalize=True, mean=ctx["mean"],
                           std=ctx["std"])(torch.from_numpy(np.asarray(
                               imgs, engine.input_dtype)).to(engine.device))
        return tuple(t.cpu().numpy() for t in out)


def run_swap(engine, req: dict, log) -> dict:
    """Gate and flip for one ``{"op": "swap", ...}`` line
    (``tpuic.serve.__main__.run_swap``).

    Candidate: ``{"synthetic_seed": N}`` (the served architecture with
    flax-default weights drawn from seed N) or ``{"ckpt_dir", "track"}``
    (defaults: the serving checkpoint), read by
    ``load_candidate_variables``: the named track only, its manifest
    required and verified.

    Gates before the flip, in order: integrity (``swap_corrupt``;
    checkpoint candidates); finite outputs on ``quant.eval_images(128,
    resize)`` through the standby's graphs (``swap_accuracy``); the
    ladder rebuilt from the candidate (``quant.serve_variants``), each
    further rung finite and agreeing with the candidate's fp32 on the
    top-1 class of at least ``1 - quant.DEFAULT_EPSILON`` of those images
    (``swap_accuracy``).  Then ``engine.swap_weights`` of the whole
    ladder.  A refused candidate never touches traffic.  Raises
    ``SwapRejected`` / ``ValueError``; returns the ``swap_result``
    record."""
    from tpuic_torch import quant
    from tpuic_torch.checkpoint.convert import init_params
    from tpuic_torch.checkpoint.loading import load_candidate_variables
    from tpuic_torch.config import Config, DataConfig, OptimConfig, RunConfig
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.predict import sidecar_ema
    from tpuic_torch.serve.admission import SwapRejected
    ctx = getattr(engine, "tpuic_swap_ctx", None)
    if ctx is None:
        raise ValueError("swap unsupported: this engine was built "
                         "without a swap context")
    if not _SWAP_LOCK.acquire(blocking=False):
        raise RuntimeError("swap already in progress — one candidate "
                           "at a time")
    try:
        resize, tags, mcfg = ctx["resize"], ctx["tags"], ctx["mcfg"]
        if req.get("synthetic_seed") is not None:
            seed = int(req["synthetic_seed"])
            cand = init_params(create_model_from_config(
                mcfg, device=engine.device, image_size=resize), seed,
                device=engine.device).eval()
            source = f"synthetic:{seed}"
        else:
            ckpt_dir = str(req.get("ckpt_dir") or ctx["ckpt_dir"] or "")
            if not ckpt_dir:
                raise ValueError(
                    "swap line needs 'ckpt_dir' (or 'synthetic_seed')")
            track = str(req.get("track") or ctx["track"] or "best")
            # An EMA-trained candidate serves its EMA weights.
            cfg = Config(data=DataConfig(data_dir=".", resize_size=resize),
                         model=mcfg, optim=OptimConfig(
                             ema_decay=sidecar_ema(ckpt_dir, mcfg.name)),
                         run=RunConfig(ckpt_dir=ckpt_dir))
            cand, _ = load_candidate_variables(cfg, track=track, log=log,
                                               device=engine.device)
            source = os.path.join(ckpt_dir, mcfg.name, track)
        # Rebuild the dtype ladder FROM the candidate: it swaps as one unit.
        rungs = quant.serve_variants(cand, tags) if len(tags) > 1 else {
            tags[0]: cand}
        imgs = eval_images(128, resize)
        ref = _gate_outputs(engine, rungs[tags[0]], imgs, tags[0])
        if not np.isfinite(ref[0]).all():
            raise SwapRejected(
                f"swap candidate {source} produced non-finite outputs on "
                "the pinned eval set — refusing to flip it into traffic",
                cause="swap_accuracy")
        floor = 1.0 - quant.DEFAULT_EPSILON
        for tag in tags[1:]:
            out = _gate_outputs(engine, rungs[tag], imgs, tag)
            agree = float(np.mean(ref[1][:, 0] == out[1][:, 0]))
            if not np.isfinite(out[0]).all() or agree < floor:
                raise SwapRejected(
                    f"swap candidate {source} rung {tag!r} FAILED the "
                    f"accuracy gate: top-1 agreement with the candidate's "
                    f"fp32 is {agree:.4f} < {floor:.4f} on the pinned eval "
                    f"set (epsilon {quant.DEFAULT_EPSILON})",
                    cause="swap_accuracy")
        res = engine.swap_weights(rungs[tags[0]], variants={
            t: rungs[t] for t in tags[1:]})
        how = ("graphs reused" if res["reused_executables"]
               else f"{res['prewarmed']} bucket graphs captured")
        log(f"[serve] hot-swap OK: {source} -> generation "
            f"{res['generation']} digest {res['digest']} ({how}, "
            f"{res['duration_s'] * 1000:.0f} ms)")
        return {"op": "swap_result", "ok": True, "source": source, **res}
    finally:
        _SWAP_LOCK.release()


def submit_swap(engine, req: dict, log) -> _FutFuture:
    """Run ``run_swap`` on a worker thread; a Future of its record (or
    its typed verdict).  The transports treat it like a request's future,
    so the loops keep serving traffic and pings while the candidate
    loads and gates."""
    fut = _FutFuture()

    def _worker() -> None:
        try:
            fut.set_result(run_swap(engine, req, log))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=_worker, daemon=True,
                     name="tpuic-torch-swap").start()
    return fut


def _parse_dtypes(spec: str) -> tuple:
    """--serve-dtypes 'fp32,bf16,int8' -> validated ladder tags (fp32
    always present and always the default rung)."""
    from tpuic_torch import quant
    tags = [t.strip() for t in (spec or "fp32").split(",") if t.strip()]
    for t in tags:
        if t not in quant.DTYPE_TAGS:
            raise SystemExit(f"{_PROG}: --serve-dtypes: unknown dtype {t!r} "
                             f"(supported: {', '.join(quant.DTYPE_TAGS)})")
    if "fp32" in tags:
        tags.remove("fp32")
    return tuple(dict.fromkeys(["fp32"] + tags))


def _ladder_variants(model, tags, size: int, *, mean, std, log) -> dict:
    """Build the ladder's rungs (``quant.serve_variants``) and run the
    startup accuracy gate: a rung whose top-1 agreement with fp32 on the
    pinned synthetic eval set falls below ``1 - quant.DEFAULT_EPSILON``
    is REFUSED — a quantization bug must fail the server loudly, not
    silently serve degraded predictions."""
    from tpuic_torch import quant
    from tpuic_torch.serve.engine import make_forward
    variants = quant.serve_variants(model, tags)
    if len(tags) > 1:
        dev = next(model.parameters()).device
        imgs = eval_images(128, size)
        fwd = {t: make_forward(m.to(dev).eval(), normalize=True, mean=mean,
                               std=std) for t, m in variants.items()}
        floor = 1.0 - quant.DEFAULT_EPSILON
        for tag in tags[1:]:
            agree = quant.top1_agreement(fwd["fp32"], fwd[tag], imgs,
                                         device=dev)
            if agree < floor:
                raise SystemExit(
                    f"{_PROG}: dtype ladder rung {tag!r} FAILED the "
                    f"accuracy gate: top-1 agreement with fp32 is "
                    f"{agree:.4f} < {floor:.4f} on the pinned eval set "
                    f"(epsilon {quant.DEFAULT_EPSILON}) — refusing to "
                    "serve a quantization that moves predictions")
            log(f"dtype ladder rung {tag}: top-1 agreement "
                f"{agree:.4f} >= {floor:.4f} (accuracy gate OK)")
    return variants


def build_engine(args):
    """Checkpoint (or seeded init) -> a warm ``InferenceEngine``, with the
    loading rules predict shares: ``(engine, size, num_classes, model)``."""
    from tpuic_torch.checkpoint.convert import init_params
    from tpuic_torch.checkpoint.loading import (_resolved_model_config,
                                                load_inference_variables)
    from tpuic_torch.config import Config, DataConfig, OptimConfig, RunConfig
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.predict import (resolve_model_auto,
                                     serving_model_config, sidecar_ema)
    from tpuic_torch.serve import InferenceEngine

    def log(*a):
        print("[serve]", *a, file=sys.stderr)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    model_name, num_classes, resize = args.model, args.num_classes, args.resize
    if args.synthetic_init:
        # Seeded init, no checkpoint: the load-testing replica mode.  The
        # port's flax-default init draws from a CPU generator seeded 0,
        # so every replica carries the same bits (the same digest).
        if model_name == "auto" or num_classes <= 0:
            raise SystemExit(f"{_PROG}: --synthetic-init needs an explicit "
                             "--model and --num-classes (there is no "
                             "checkpoint to resolve them from)")
        resize = 299 if resize is None else resize
        mcfg = serving_model_config(model_name, num_classes)
        model = init_params(create_model_from_config(
            mcfg, device=args.device, image_size=resize), 0,
            device=args.device)
        how = f"synthetic init ({model_name}); "
    else:
        ema_decay = 0.0
        if model_name == "auto":
            saved = resolve_model_auto(args.ckpt_dir)
            model_name = saved["name"]
            num_classes = num_classes or saved["num_classes"]
            ema_decay = saved["ema_decay"]
            if resize is None:
                resize = saved["resize_size"]
            log(f"auto-resolved model '{model_name}' (num_classes="
                f"{num_classes}, resize={resize})")
        elif not args.init_from:
            # An EMA-trained checkpoint serves its EMA weights (the ones
            # 'best' was picked on), as in tpuic.
            ema_decay = sidecar_ema(args.ckpt_dir, model_name)
        resize = 299 if resize is None else resize
        if num_classes <= 0:
            raise SystemExit(f"{_PROG}: --num-classes required (or --model "
                             "auto with a config.json sidecar)")
        cfg = Config(data=DataConfig(data_dir=".", resize_size=resize),
                     model=serving_model_config(model_name, num_classes),
                     optim=OptimConfig(ema_decay=ema_decay),
                     run=RunConfig(ckpt_dir=args.ckpt_dir,
                                   init_from=args.init_from))
        model = load_inference_variables(cfg, track=args.track,
                                         device=args.device, log=log)
        mcfg = (cfg.model if args.init_from
                else _resolved_model_config(cfg)[0])
        how = ""
    dc = DataConfig()
    # The dtype ladder (--serve-dtypes): bf16/int8 rungs of the same
    # weights behind the startup accuracy gate; request lines pick one
    # with "serve_dtype".
    tags = _parse_dtypes(args.serve_dtypes)
    variants = _ladder_variants(model, tags, resize, mean=dc.mean,
                                std=dc.std, log=log)
    # Raw uint8 in, normalised inside the forward (4x fewer bytes to the
    # device than float32).
    engine = InferenceEngine(model, image_size=resize, input_dtype=np.uint8,
                             normalize=True, mean=dc.mean, std=dc.std,
                             buckets=buckets, max_wait_ms=args.max_wait_ms,
                             queue_size=args.queue_size, device=args.device,
                             variants={t: m for t, m in variants.items()
                                       if t != "fp32"},
                             waterfall=bool(args.prom_port or args.prom_dump))
    t = engine.warmup()
    n = sum(len(v) if isinstance(v, dict) else 1 for v in t.values())
    made = ("captured {} bucket CUDA graphs" if engine.device.type == "cuda"
            else "ran {} buckets eagerly")
    log(f"{how}warmup {made.format(n)}: {t}")
    _swap_context(engine, mcfg=mcfg, resize=resize, mean=dc.mean,
                  std=dc.std, ckpt_dir=args.ckpt_dir, track=args.track)
    return engine, resize, num_classes, model_name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=_PROG, description="Dynamic-batching inference server of the "
        "port (stdin JSONL, directory watch or socket JSONL)")
    p.add_argument("--ckpt-dir", default="dtmodel/cp")
    p.add_argument("--model", default="auto")
    p.add_argument("--num-classes", type=int, default=0)
    p.add_argument("--resize", type=int, default=None)
    p.add_argument("--track", default="best", choices=("best", "latest"))
    p.add_argument("--init-from", default="",
                   help="reference torch checkpoint instead of a port one")
    p.add_argument("--buckets", default="1,8,32,128",
                   help="padding-bucket ladder (comma list); on the card "
                        "one CUDA graph per bucket")
    p.add_argument("--serve-dtypes", default="fp32",
                   help="dtype ladder (comma list of fp32, bf16, int8; "
                        "fp32 is always served and the default): each "
                        "rung must pass the startup accuracy gate; request "
                        "lines pick one with \"serve_dtype\"")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--queue-size", type=int, default=256)
    p.add_argument("--compile-cache-dir", default="~/.cache/tpuic/xla",
                   help="accepted for tpuic's command lines and unused: "
                        "the port compiles no programs at start; warmup "
                        "captures the per-bucket CUDA graphs in memory")
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--classes", default="",
                   help="optional file of class names, one per line")
    p.add_argument("--watch", default="",
                   help="watch this directory for images instead of stdin")
    p.add_argument("--poll-s", type=float, default=0.5)
    p.add_argument("--once", action="store_true",
                   help="with --watch: process current files, then exit")
    p.add_argument("--listen", default="",
                   help="serve socket JSONL on HOST:PORT instead of stdin "
                        "(port 0 = kernel-assigned)")
    p.add_argument("--ready-file", default="",
                   help="with --listen: atomically write {port, pid, "
                        "digest, dtypes, generation} here once the engine "
                        "is warm and the socket is bound")
    p.add_argument("--synthetic-init", action="store_true",
                   help="seeded init instead of a checkpoint (load "
                        "testing; needs explicit --model and "
                        "--num-classes)")
    p.add_argument("--out", default="", help="output JSONL (default stdout)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="on SIGTERM/SIGINT, wait up to this many seconds "
                        "for in-flight requests before failing stragglers "
                        "with an error line and exiting")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on "
                        "the CPU)")
    p.add_argument("--admission", action="store_true",
                   help="SLA-aware admission control: request lines may "
                        "carry priority/deadline_ms/tenant; a full queue "
                        "rejects with a typed, cause-labeled error line "
                        "instead of blocking the accept loop, higher "
                        "priority classes are batched first (and evict "
                        "lower ones from a full queue), and expired "
                        "deadlines shed at pop time")
    p.add_argument("--quota", action="append", default=[],
                   metavar="TENANT=RPS",
                   help="per-tenant token-bucket quota in requests/sec "
                        "(repeatable, or one comma list); '*=RPS' sets "
                        "the shared free pool unconfigured tenants and "
                        "dry tenant buckets draw from. Implies "
                        "--admission")
    p.add_argument("--prom-port", type=int, default=0,
                   help="serve a Prometheus /metrics endpoint on this "
                        "port (0 disables; -1 binds a kernel-assigned free "
                        "port, named in --ready-file)")
    p.add_argument("--prom-host", default="127.0.0.1",
                   help="interface for --prom-port (loopback by default: "
                        "the endpoint is unauthenticated)")
    p.add_argument("--prom-dump", default="",
                   help="write the Prometheus text exposition to this "
                        "file on shutdown (and each poll tick under "
                        "--watch): the textfile-collector transport")
    p.add_argument("--slo", default="",
                   help="latency SLOs, comma list of "
                        "'serve_latency:pQ<=Nms[@target]' specs; the "
                        "tracker subscribes to the engine's per-request "
                        "serve_span events")
    p.add_argument("--brownout-slo", default="",
                   help="name of one --slo objective (e.g. "
                        "serve_latency_p99) whose error-budget burn rate "
                        "drives brownout: past --brownout-tighten the "
                        "controller sheds one more priority class per SLO "
                        "report, recovering below --brownout-recover. "
                        "Implies --admission")
    p.add_argument("--brownout-tighten", type=float, default=2.0,
                   help="burn rate at/above which brownout tightens one "
                        "level")
    p.add_argument("--brownout-recover", type=float, default=1.0,
                   help="burn rate at/below which (after 3 consecutive "
                        "reports) brownout relaxes one level")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _parse_dtypes(args.serve_dtypes)
    # The chaos spec parses first: one that does not parse, or that arms
    # a point the serving path does not fire, fails the command line.
    try:
        from tpuic_torch.runtime import faults as _faults
        _faults.check_fired("serve", os.environ.get("TPUIC_FAULTS"))
    except ValueError as e:
        raise SystemExit(f"{_PROG}: error: {e}")
    if args.quota or args.brownout_slo:
        args.admission = True
    # SLOs and admission parse before the checkpoint load and warmup: a
    # typo'd quota would read as "unlimited" exactly when it was meant to
    # cap, and a brownout coupled to an objective --slo does not track
    # would never tighten.
    slo_tracker = None
    if args.slo:
        from tpuic_torch.telemetry.slo import SLOTracker, parse_objectives
        try:
            slo_tracker = SLOTracker(parse_objectives(
                args.slo, allowed=("serve_latency",)))
        except ValueError as e:
            raise SystemExit(f"{_PROG}: error: --slo: {e}")
    admission_ctl = None
    if args.admission:
        from tpuic_torch.serve.admission import (AdmissionController,
                                                 BrownoutController,
                                                 parse_quotas)
        try:
            quotas = parse_quotas(args.quota)
        except ValueError as e:
            raise SystemExit(f"{_PROG}: error: --quota: {e}")
        brownout = None
        if args.brownout_slo:
            known = ([o.name for o in slo_tracker.objectives]
                     if slo_tracker is not None else [])
            if args.brownout_slo not in known:
                raise SystemExit(
                    f"{_PROG}: error: --brownout-slo {args.brownout_slo!r} "
                    f"names no --slo objective (configured: "
                    f"{', '.join(known) or 'none'}): brownout would never "
                    "see a burn rate")
            brownout = BrownoutController(
                args.brownout_slo, tighten_above=args.brownout_tighten,
                recover_below=args.brownout_recover)
        admission_ctl = AdmissionController(quotas, brownout=brownout)

    # Install the latch BEFORE the checkpoint load and warmup: an eviction
    # during startup must also exit cleanly.
    import signal

    from tpuic_torch.runtime.preemption import PreemptionGuard
    guard = PreemptionGuard(signals=(signal.SIGTERM,)).install()

    if args.classes and not os.path.isfile(args.classes):
        raise SystemExit(f"{_PROG}: --classes file not found: "
                         f"{args.classes}")
    # Supervised liveness (runtime/supervisor.py): under ``python -m
    # tpuic_torch.supervise`` the parent set the heartbeat and dump
    # paths.  The flight recorder registers its SIGQUIT dump first, so
    # that the faulthandler stack dump chains into it.  Installed before
    # the checkpoint load and warmup: a wedge there dumps too.
    from tpuic_torch.runtime.supervisor import (HeartbeatWriter,
                                                install_stack_dump_handler)
    from tpuic_torch.telemetry.events import bus as _bus
    from tpuic_torch.telemetry.flight import install_flight_recorder
    flight = install_flight_recorder()
    heartbeat = HeartbeatWriter.from_env()
    if heartbeat is not None or flight is not None:
        install_stack_dump_handler(chain=flight is not None)
    # This run's subscribers leave the process-global bus at exit.
    unsubs = []
    if heartbeat is not None:
        # Engine activity (serve_batch events) beats; the loops below
        # tick it too, as an idle server is alive.
        unsubs.append(_bus.subscribe(heartbeat))

    def _beat() -> None:
        if heartbeat is not None:
            heartbeat.beat()

    engine, size, num_classes, model_name = build_engine(args)
    names = _class_names(args.ckpt_dir, model_name, num_classes,
                         args.classes)
    if slo_tracker is not None:
        # Subscribing to serve_span is what turns the engine's span
        # events on.
        unsubs.append(slo_tracker.attach(_bus))
    if admission_ctl is not None:
        engine.admission = admission_ctl
        if admission_ctl.brownout is not None:
            # Brownout reads the SLO reports on the same bus; its
            # transitions come back as 'admission' events.
            unsubs.append(admission_ctl.brownout.attach(_bus))
        print(f"[serve] admission control on: "
              f"{json.dumps(admission_ctl.state())}", file=sys.stderr)

    # The Prometheus exposition.  Device memory is sampled at scrape time
    # from the allocator's counters (no sync) and is not published: a
    # scraper must not keep a wedged server looking alive to the
    # heartbeat.  The waterfall rows read what the engine's window left;
    # a scrape never opens one.
    from tpuic_torch.telemetry.memory import MemorySampler
    from tpuic_torch.telemetry.prom import (PromServer, serve_exposition,
                                            write_exposition)
    mem_sampler = MemorySampler(publish=lambda *a, **kw: None,
                                device=engine.device)

    def _prom_text() -> str:
        mem_sampler.sample()
        return serve_exposition(
            engine.stats.snapshot(),
            heartbeat_age_s=(heartbeat.age_s() if heartbeat is not None
                             else None),
            slo=slo_tracker.report() if slo_tracker is not None else None,
            admission=(admission_ctl.state() if admission_ctl is not None
                       else None),
            memory=mem_sampler.snapshot(),
            profile=engine.profile_waterfall(),
            compile_cache=engine.graph_cache_counters())

    prom_server = None
    if args.prom_port:
        prom_server = PromServer(max(0, args.prom_port), _prom_text,
                                 host=args.prom_host)
        print(f"[serve] prometheus /metrics on "
              f"{args.prom_host}:{prom_server.port}", file=sys.stderr)
    # 'flood' (runtime/faults.py): a low-priority storm from inside the
    # process at #PARAM requests/s.  One shared image: the staging copy
    # goes through the engine's pinned buffers, which pin nothing more.
    # Paced by due time: a wait after each submit (tpuic's) falls short of
    # the rate once the GIL is contended, and a storm that never reaches
    # the replica's knee drives nothing; a backlog past a second is
    # dropped rather than sent as one burst.
    flood_stop = threading.Event()
    if _faults.fire("flood"):
        flood_rate = _faults.param("flood")
        flood_rate = 50.0 if flood_rate is None else float(flood_rate)
        flood_img = np.zeros((1, size, size, 3), engine.input_dtype)

        def _flood() -> None:
            period = 1.0 / max(flood_rate, 1e-3)
            due = time.monotonic()
            while not flood_stop.is_set() and not guard.triggered:
                try:
                    fut = engine.submit(flood_img, timeout=0,
                                        priority="low", tenant="_flood")
                    fut.add_done_callback(
                        lambda f: f.cancelled() or f.exception())
                except Exception:  # noqa: BLE001 — rejects are the point
                    pass
                due += period
                ahead = due - time.monotonic()
                if ahead > 0:
                    flood_stop.wait(ahead)
                elif ahead < -1.0:
                    due = time.monotonic()

        threading.Thread(target=_flood, daemon=True,
                         name="tpuic-torch-flood").start()
        print(f"[serve] fault 'flood' armed: synthetic low-priority storm "
              f"at {flood_rate:g} req/s", file=sys.stderr)
    k = max(1, min(args.top_k, num_classes))
    out = open(args.out, "w") if args.out else sys.stdout
    pending = deque()  # (id, Future) in submission order
    # Swap lines drain out of order, in their own lane: a checkpoint load
    # and gate take seconds, and must not hold back the answers behind
    # them (responses are keyed by id).
    control_pending = deque()
    served = 0

    def emit(rid, probs, order) -> None:
        nonlocal served
        out.write(json.dumps(_result_record(rid, probs, order,
                                            names, k)) + "\n")
        out.flush()
        served += 1

    def emit_outcome(rid, res) -> None:
        """A resolved future: ``(probs, order)`` emits the usual record; a
        dict is a swap's record, written as it is (not counted as
        served traffic)."""
        if isinstance(res, dict):
            out.write(json.dumps({**res, "id": rid}) + "\n")
            out.flush()
        else:
            emit(rid, res[0], res[1])

    def drain_control(block: bool = False, deadline: float = None) -> None:
        """Emit completed swap outcomes, in any order.  ``block`` waits
        each out, up to ``deadline``; past it the straggler gets an error
        line, as in ``drain``."""
        still = deque()
        while control_pending:
            rid, fut = control_pending.popleft()
            if not fut.done():
                if not block:
                    still.append((rid, fut))
                    continue
                if deadline is None:
                    while not fut.done() and not guard.triggered:
                        try:
                            fut.result(timeout=0.5)
                        except (TimeoutError, _FutTimeout):
                            pass
                        except Exception:  # noqa: BLE001 — read below
                            break
                    if not fut.done() and guard.triggered:
                        deadline = (time.monotonic()
                                    + max(0.0, args.drain_timeout))
                try:
                    if deadline is not None and not fut.done():
                        fut.result(timeout=max(
                            0.0, deadline - time.monotonic()))
                except (TimeoutError, _FutTimeout):
                    fut.cancel()
                    out.write(wire.error_line(
                        rid, "drain timeout: swap unresolved at shutdown"))
                    out.flush()
                    continue
                except Exception:  # noqa: BLE001 — read below
                    pass
            if fut.cancelled():
                out.write(wire.error_line(rid, "cancelled"))
            elif fut.exception() is not None:
                out.write(wire.error_line(rid, fut.exception()))
            else:
                emit_outcome(rid, fut.result())
            out.flush()
        control_pending.extend(still)

    def drain(block: bool, deadline: float = None) -> None:
        """Emit completed responses; ``block`` waits for stragglers, up to
        ``deadline`` (time.monotonic()).  Past the deadline, requests the
        device DID finish still emit their results (in submission order);
        only unresolved ones get an explicit error line — never a silent
        drop, never a discarded finished result.

        The no-deadline blocking wait polls in short slices re-checking
        the SIGTERM latch (PEP 475 would resume a bare ``result()``
        through the signal); the latch turns the wait into a
        ``--drain-timeout`` deadline.  Swap outcomes drain on their own
        lane, last when blocking."""
        drain_control()
        while pending and (block or pending[0][1].done()):
            rid, fut = pending.popleft()
            try:
                if block and deadline is None:
                    while not fut.done() and not guard.triggered:
                        try:
                            fut.result(timeout=0.5)
                        except (TimeoutError, _FutTimeout):
                            pass
                    if not fut.done() and guard.triggered:
                        deadline = (time.monotonic()
                                    + max(0.0, args.drain_timeout))
                if deadline is None:
                    res = fut.result()
                else:
                    res = fut.result(
                        timeout=max(0.0, deadline - time.monotonic()))
            except (TimeoutError, _FutTimeout):
                pending.appendleft((rid, fut))
                expired = list(pending)
                pending.clear()
                for srid, sfut in expired:
                    if sfut.done() and not sfut.cancelled():
                        try:
                            sres = sfut.result()
                        except Exception as e:  # noqa: BLE001
                            out.write(wire.error_line(srid, e))
                        else:
                            emit(srid, sres[0], sres[1])
                        continue
                    sfut.cancel()  # not yet dispatched may still cancel
                    out.write(wire.error_line(
                        srid, "drain timeout: engine shutting down "
                        "before this request finished"))
                out.flush()
                drain_control(block=True, deadline=deadline)
                return
            except Exception as e:  # noqa: BLE001 — per-request error line
                # A typed verdict (a deadline shed, an eviction) keeps its
                # cause and class labels (wire.py).
                out.write(wire.error_line(rid, e))
                out.flush()
                continue
            except BaseException:
                # KeyboardInterrupt/SystemExit mid-wait: this request is
                # already popped; put it back so the follow-up drain
                # still owns it.
                pending.appendleft((rid, fut))
                raise
            emit(rid, res[0], res[1])
        if block:
            drain_control(block=True, deadline=deadline)

    def submit(rid: str, path: str, req: dict = None) -> bool:
        """Decode + enqueue with the request line's SLA fields
        (``_sla``); False = decode failed (error line emitted).  A typed
        rejection, or a bad SLA field, is an error line at once."""
        try:
            img = _load_image(path, size)
        except Exception as e:  # noqa: BLE001
            out.write(wire.error_line(rid, f"decode: {e}"))
            out.flush()
            return False
        try:
            pending.append((rid, engine.submit(img, **_sla(engine,
                                                           req or {}))))
        except (AdmissionError, ValueError, TypeError) as e:
            out.write(wire.error_line(rid, e))
            out.flush()
            return True  # handled: the verdict went out
        drain(block=False)  # opportunistic: decode overlaps device work
        return True

    try:
        if args.listen:
            served = serve_socket(
                engine, listen=args.listen, names=names, top_k=k,
                size=size, guard=guard, beat=_beat,
                drain_timeout=args.drain_timeout,
                ready_file=args.ready_file,
                prom_port=(prom_server.port if prom_server is not None
                           else None),
                log=lambda msg: print(msg, file=sys.stderr))
        elif args.watch:
            exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
            seen: set = set()
            attempts: dict = {}
            while not guard.triggered:
                fresh = sorted(
                    f for f in os.listdir(args.watch)
                    if f.lower().endswith(exts) and f not in seen)
                for f in fresh:
                    if guard.triggered:
                        break  # stop ACCEPTING; in-flight drains below
                    if submit(f, os.path.join(args.watch, f)):
                        seen.add(f)
                        attempts.pop(f, None)
                    else:
                        # A file mid-copy decodes as truncated: retry on
                        # later ticks, give up after 3 (in --once mode at
                        # once: there is no later tick).
                        attempts[f] = attempts.get(f, 0) + 1
                        if args.once or attempts[f] >= 3:
                            seen.add(f)
                drain(block=False)
                _beat()
                if args.prom_dump:
                    # A textfile collector sees live counters; a dump that
                    # fails must not take serving down.
                    try:
                        write_exposition(args.prom_dump, _prom_text())
                    except OSError as e:
                        print(f"[serve] prom dump failed: {e}",
                              file=sys.stderr)
                if args.once:
                    drain(block=True)
                    break
                time.sleep(args.poll_s)
        else:
            def handle(line: str) -> None:
                line = line.strip()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise TypeError("not an object")
                    if req.get("op") == "swap":
                        # Gate and flip off-thread; the outcome drains on
                        # the control lane.
                        control_pending.append(
                            (str(req.get("id", "swap")),
                             submit_swap(engine, req, lambda m: print(
                                 m, file=sys.stderr))))
                        return
                    path = req["path"]
                except (ValueError, KeyError, TypeError):
                    out.write(wire.error_line(
                        None, f"bad request line: {line[:80]}"))
                    out.flush()
                    return
                submit(str(req.get("id", path)), path, req)

            # select()-gated raw reads, not ``for line in sys.stdin``: a
            # signal handler only sets the latch, and PEP 475 would
            # resume a blocked readline, so an idle server would never
            # see SIGTERM.  Raw os.read with explicit line splitting,
            # because Python's stdin buffering would hide burst-written
            # lines from select.  A stdin without a file descriptor (a
            # StringIO in a test) is read unguarded.
            import select
            try:
                stdin_fd = sys.stdin.fileno()
            except (ValueError, OSError, AttributeError):
                stdin_fd = None
            if stdin_fd is None:
                for line in sys.stdin:
                    if guard.triggered:
                        break
                    handle(line)
            else:
                tail = b""
                while not guard.triggered:
                    try:
                        ready, _, _ = select.select([stdin_fd], [], [], 0.2)
                    except (OSError, ValueError):  # stdin closed under us
                        break
                    if not ready:
                        drain(block=False)
                        _beat()
                        continue
                    _beat()
                    chunk = os.read(stdin_fd, 1 << 16)  # ready: won't block
                    if not chunk:
                        break  # EOF
                    *lines, tail = (tail + chunk).split(b"\n")
                    for raw in lines:
                        handle(raw.decode("utf-8", "replace"))
                if tail.strip() and not guard.triggered:
                    handle(tail.decode("utf-8", "replace"))  # no newline
        if guard.triggered:
            # Graceful preemption: everything already accepted drains for
            # up to --drain-timeout; stragglers get explicit error lines.
            print(f"[serve] SIGTERM: draining {len(pending)} in-flight "
                  f"request(s) (timeout {args.drain_timeout:.1f}s)",
                  file=sys.stderr)
            drain(block=True,
                  deadline=time.monotonic() + max(0.0, args.drain_timeout))
        else:
            drain(block=True)
    except KeyboardInterrupt:
        drain(block=True,
              deadline=time.monotonic() + max(0.0, args.drain_timeout))
    finally:
        guard.uninstall()
        flood_stop.set()
        engine.close(timeout=max(5.0, args.drain_timeout))
        if prom_server is not None:
            prom_server.close()
        if args.prom_dump:
            try:
                write_exposition(args.prom_dump, _prom_text())
                print(f"[serve] prometheus exposition -> {args.prom_dump}",
                      file=sys.stderr)
            except OSError as e:
                print(f"[serve] prom dump failed: {e}", file=sys.stderr)
        if slo_tracker is not None:
            print(f"[serve] slo: {slo_tracker.summary_line()}",
                  file=sys.stderr)
        if admission_ctl is not None:
            # Every cause of the typed vocabulary, zero-filled, so a
            # ledger reads each from this one line.
            from tpuic_torch.serve.admission import CAUSES
            snap = engine.stats.snapshot()
            rej = {c: snap["rejected_by"].get(c, {}) for c in CAUSES}
            rej.update({c: by for c, by in snap["rejected_by"].items()
                        if c not in rej})
            print(f"[admission] state={json.dumps(admission_ctl.state())} "
                  f"rejected_by={json.dumps(rej)}", file=sys.stderr)
        print(f"[serve] served {served} requests; stats: "
              f"{json.dumps(engine.stats.snapshot())}", file=sys.stderr)
        if out is not sys.stdout:
            out.close()
        for unsub in unsubs:
            unsub()
    return 0


if __name__ == "__main__":
    sys.exit(main())
