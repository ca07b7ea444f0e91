"""Serve-tier wire format (``tpuic/serve/wire.py``, copied).

- :func:`error_record` / :func:`error_line`: the one typed verdict line.
  ``python -m tpuic_torch.serve``'s accept path and its drain both call
  it, so a typed :class:`~tpuic_torch.serve.admission.AdmissionError`
  renders as ``{"id", "error", "cause", "priority"}`` wherever it was
  issued; :func:`rebuild_error` is its inverse for a client.
- ``encode_array`` / ``decode_array``: the socket transport's array
  payload, base64 of the raw row-major bytes plus shape and dtype.
- ``write_ready_file`` / ``read_ready_file``: how a replica started with
  ``--listen HOST:0 --ready-file F`` tells its parent the port it bound.

Stdlib only at module level, as in ``tpuic`` (its router imports this
file); ``decode_array`` imports numpy when it is called.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Tuple, Union


def error_record(rid: Optional[str], err: Union[str, BaseException],
                 **extra) -> dict:
    """The one typed verdict shape: ``{"id", "error"}`` plus, when
    ``err`` is an :class:`~tpuic_torch.serve.admission.AdmissionError`, the
    ``cause``/``priority`` labels the rejected_total counters carry.
    ``rid=None`` omits the id (a request line too malformed to have
    one).  ``extra`` appends caller fields (e.g. a trace id)."""
    from tpuic_torch.serve.admission import AdmissionError
    rec: dict = {}
    if rid is not None:
        rec["id"] = rid
    rec["error"] = str(err)
    if isinstance(err, AdmissionError):
        rec["cause"] = err.cause
        rec["priority"] = err.priority
    rec.update(extra)
    return rec


def error_line(rid: Optional[str], err: Union[str, BaseException],
               **extra) -> str:
    """:func:`error_record` as one newline-terminated JSONL line."""
    return json.dumps(error_record(rid, err, **extra)) + "\n"


def rebuild_error(record: dict) -> Exception:
    """Inverse of :func:`error_record` for the router's client side: a
    wire error record becomes the typed exception its future raises, so
    a caller sees the same exception type whether the verdict came from
    a local engine or crossed a socket.  Untyped records (decode
    failures, drain timeouts) become plain RuntimeError."""
    from tpuic_torch.serve.admission import (AdmissionRejected, DeadlineExceeded,
                                       ReplicaLost, SwapRejected)
    msg = str(record.get("error", "unknown error"))
    cause = record.get("cause")
    if cause is None:
        return RuntimeError(msg)
    priority = record.get("priority", "normal")
    if cause == "deadline":
        return DeadlineExceeded(msg, priority=priority,
                                tenant=record.get("tenant"))
    if cause == "replica_lost":
        return ReplicaLost(msg, priority=priority,
                           tenant=record.get("tenant"))
    if cause in ("swap_corrupt", "swap_accuracy"):
        # Swap-gate refusal crossing the wire (the rollout controller's
        # control channel): same typed exception as an in-process gate.
        return SwapRejected(msg, cause=cause, priority=priority,
                            tenant=record.get("tenant"))
    return AdmissionRejected(msg, cause=cause, priority=priority,
                             tenant=record.get("tenant"))


# -- array payloads (socket-JSONL transport) ---------------------------------
def encode_array(arr) -> dict:
    """``{"b64", "shape", "dtype"}`` fields for a request line.  Duck
    typed (``.tobytes()``/``.shape``/``.dtype``) so the stdlib-only
    router can encode a caller's numpy array without importing numpy
    itself; the bytes are the C-contiguous row-major buffer."""
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "shape": [int(s) for s in arr.shape],
            "dtype": str(getattr(arr.dtype, "name", arr.dtype))}


def decode_array(req: dict):
    """Engine-side inverse of :func:`encode_array` (imports numpy —
    never called by the router).  Raises ValueError on a malformed
    payload so the transport can answer with a typed error line instead
    of dying."""
    import numpy as np
    try:
        raw = base64.b64decode(req["b64"])
        shape = tuple(int(s) for s in req["shape"])
        dtype = np.dtype(req.get("dtype", "uint8"))
        return np.frombuffer(raw, dtype).reshape(shape).copy()
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad array payload: {e}") from None


# -- replica ready-file protocol ---------------------------------------------
def write_ready_file(path: str, **payload) -> None:
    """Atomic (tmp + rename, the heartbeat discipline) dump of the
    replica's bound address: ``{"port", "pid", ...}``.  The router polls
    for this file after spawning — it is the only port-handoff channel,
    so a torn read must be impossible."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def read_ready_file(path: str) -> Optional[dict]:
    """Parse a ready file; None while absent/unreadable (still
    starting)."""
    try:
        with open(path) as f:
            out = json.load(f)
    except (OSError, ValueError):
        return None
    return out if isinstance(out, dict) else None


def parse_hostport(spec: str) -> Tuple[str, int]:
    """``'127.0.0.1:8000'`` -> (host, port); port 0 = kernel-assigned."""
    host, sep, port = spec.rpartition(":")
    if not sep or not host:
        raise ValueError(f"expected HOST:PORT, got {spec!r}")
    return host, int(port)
