"""Minimal HTTP front-end for the replica router (a copy of
``tpuic/serve/http.py``, kept deliberately small).

Stdlib ``ThreadingHTTPServer`` over a
:class:`~tpuic_torch.serve.router.Router`
(docs/serving.md, "Replica routing and failover"):

- ``POST /predict`` — body is one JSON request line (the same shape the
  stdin/socket transports accept: ``{"path": ...}`` or a
  ``{"b64", "shape", "dtype"}`` payload, optional SLA fields).  A
  result returns 200 with the usual record; a **typed verdict** maps to
  an HTTP status a load balancer understands, with ``Retry-After``:

  ====================  ======  =============================
  cause                 status  meaning to the caller
  ====================  ======  =============================
  ``queue_full``        429     back off, the fleet is saturated
  ``quota``             429     your tenant is over its budget
  ``brownout``          503     shedding your class to protect the SLO
  ``deadline``          503     your deadline passed before service
  ``replica_lost``      503     safe to retry end-to-end (at-most-once
                                held: no response was emitted)
  ====================  ======  =============================

  The JSON body carries the same ``{"error", "cause", "priority"}``
  record the socket tier emits (tpuic_torch/serve/wire.py — one vocabulary,
  three transports).  Untyped failures are 500.
- ``GET /healthz`` — 200 ``{"status": "ok", ...}`` while at least one
  replica is up, else 503 ``{"status": "down"}`` (a load balancer's
  eject signal).
- ``GET /metrics`` — the ``tpuic_router_*`` Prometheus exposition
  (telemetry/prom.py ``router_exposition``).

Stdlib-only (the router-process rule).  One OS thread per in-flight
HTTP request (ThreadingHTTPServer) — the router behind it is
non-blocking, so threads spend their life parked on a Future; the
admission tiers bound how many requests are genuinely in flight.
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as _FutTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpuic_torch.serve import wire
from tpuic_torch.serve.admission import AdmissionError

# Typed verdict -> HTTP status (module docstring table).  Unknown typed
# causes (vocabulary growth) conservatively map to 503: retryable-ish,
# and never a silent 200.
CAUSE_STATUS = {
    "queue_full": 429,
    "quota": 429,
    "brownout": 503,
    "deadline": 503,
    "replica_lost": 503,
}


class RouterHTTPServer:
    """HTTP front tier over a Router; ``port=0`` = kernel-assigned.

    ``result_timeout_s`` bounds how long one HTTP request waits for the
    fleet; past it the caller gets 503 + Retry-After (the request's
    future keeps its at-most-once accounting inside the router)."""

    def __init__(self, router, port: int = 0, host: str = "127.0.0.1",
                 result_timeout_s: float = 60.0,
                 retry_after_s: int = 1) -> None:
        self.router = router
        self.result_timeout_s = float(result_timeout_s)
        self.retry_after_s = int(retry_after_s)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, status: int, payload: dict,
                       retry_after: Optional[int] = None) -> None:
                body = (json.dumps(payload) + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if self.path == "/healthz":
                    outer._healthz(self)
                elif self.path == "/metrics":
                    outer._metrics(self)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if self.path != "/predict":
                    self._reply(404, {"error": "not found"})
                    return
                outer._predict(self)

            def log_message(self, *a) -> None:
                pass  # stderr belongs to the router's own logs

        self._srv = ThreadingHTTPServer((host, int(port)), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self.host = host
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="tpuic-router-http")
        self._thread.start()

    # -- endpoints ------------------------------------------------------
    def _healthz(self, h) -> None:
        up = sum(r.state == "up" for r in self.router.replicas)
        payload = {
            "status": "ok" if up else "down",
            "replicas_up": up,
            "replicas": len(self.router.replicas),
            "fleet_digest": self.router.fleet_digest,
        }
        h._reply(200 if up else 503, payload,
                 retry_after=None if up else self.retry_after_s)

    def _metrics(self, h) -> None:
        from tpuic_torch.telemetry.prom import router_exposition
        text = router_exposition(self.router.snapshot()).encode()
        h.send_response(200)
        h.send_header("Content-Type", "text/plain; version=0.0.4")
        h.send_header("Content-Length", str(len(text)))
        h.end_headers()
        h.wfile.write(text)

    def _predict(self, h) -> None:
        try:
            n = int(h.headers.get("Content-Length", 0))
            req = json.loads(h.rfile.read(n).decode("utf-8", "replace"))
            if not isinstance(req, dict):
                raise ValueError("not an object")
        except (ValueError, OSError) as e:
            h._reply(400, {"error": f"bad request body: {e}"})
            return
        rid = str(req.get("id", "http"))
        try:
            _, fut = self.router.submit_line(req)
            rec = fut.result(timeout=self.result_timeout_s)
        except AdmissionError as e:
            status = CAUSE_STATUS.get(e.cause, 503)
            h._reply(status, wire.error_record(rid, e),
                     retry_after=self.retry_after_s)
            return
        except (ValueError, TypeError) as e:
            # The request's problem, not the server's (unknown
            # priority, a control 'op' line on the data path, bad SLA
            # fields): 400, so a load balancer counting 5xx toward
            # replica health never ejects a healthy fleet over a
            # malformed client.
            h._reply(400, wire.error_record(rid, e))
            return
        except (TimeoutError, _FutTimeout):
            h._reply(503, wire.error_record(
                rid, f"no response within {self.result_timeout_s:g}s"),
                retry_after=self.retry_after_s)
            return
        except Exception as e:  # noqa: BLE001 — untyped = server error
            h._reply(500, wire.error_record(rid, e))
            return
        h._reply(200, {**rec, "id": rid})

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
