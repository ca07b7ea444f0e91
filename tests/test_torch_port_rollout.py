"""Model lifecycle at the fleet tier on the port (``tpuic``'s
``tests/test_rollout.py`` cases over ``tpuic_torch.serve.rollout``,
``.router`` and ``.http``): canary rollout controller, router model-identity
gate, traffic split, control channel, HTTP front-end, against fake stdlib
replicas (no torch in the router process).

The full two-real-replica lifecycle on the card (clean promote,
corrupt checkpoint refused, degraded canary rolled back) is chip_smoke's
``[fleet]``; everything here isolates one mechanism with in-process fake
replica servers speaking the socket-JSONL transport, including the
``{"op": "swap"}`` control line and the digest-carrying pong.  Beside
them, ``rollout_rows`` against ``tpuic``'s on one rollout state.
"""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tpuic_torch.serve import wire
from tpuic_torch.serve.admission import (AdmissionRejected, ReplicaLost,
                                   SwapRejected)
from tpuic_torch.serve.http import RouterHTTPServer
from tpuic_torch.serve.rollout import CanaryRollout
from tpuic_torch.serve.router import Router


# -- fake replica with model identity + swap ---------------------------------
class FakeReplica:
    """Stdlib socket replica: pongs carry a live digest/generation,
    ``{"op": "swap"}`` lines run a swap handler (default: adopt digest
    ``S<synthetic_seed>``, bump the generation, optionally change the
    per-request service latency), requests answer after ``latency_s``.

    ``swap_error`` (an error record dict) makes every swap a typed
    refusal — the gate-says-no shape."""

    def __init__(self, *, digest: str = "S0", latency_s: float = 0.0,
                 swap_error: dict = None, hold_swap: bool = False,
                 swap_latency: dict = None) -> None:
        self.digest = digest
        self.generation = 0
        self.latency_s = latency_s
        self.swap_error = swap_error
        self.hold_swap = hold_swap  # record swaps, never answer them
        # synthetic_seed -> post-swap service latency (the degraded-
        # canary knob): {"1": 0.2} makes candidate seed 1 serve slow.
        self.swap_latency = swap_latency or {}
        self.seen = []          # every non-ping, non-swap request
        self.swaps = []         # every swap line
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self._conns = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.srv.settimeout(0.2)
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        buf = b""
        conn.settimeout(0.2)
        while not self._stop.is_set():
            try:
                chunk = conn.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            *lines, buf = (buf + chunk).split(b"\n")
            for raw in lines:
                if not raw.strip():
                    continue
                req = json.loads(raw)
                if req.get("op") == "ping":
                    self._send(conn, {"id": req.get("id"), "op": "pong",
                                      "queue_depth": 0,
                                      "digest": self.digest,
                                      "generation": self.generation})
                elif req.get("op") == "swap":
                    self.swaps.append(req)
                    if self.hold_swap:
                        continue
                    if self.swap_error is not None:
                        self._send(conn, {**self.swap_error,
                                          "id": req["id"]})
                        continue
                    seed = req.get("synthetic_seed", 0)
                    self.digest = f"S{seed}"
                    self.generation += 1
                    self.latency_s = float(
                        self.swap_latency.get(str(seed), 0.0))
                    self._send(conn, {
                        "id": req["id"], "op": "swap_result", "ok": True,
                        "digest": self.digest,
                        "generation": self.generation,
                        "reused_executables": True, "prewarmed": 0})
                else:
                    self.seen.append(req)
                    if self.latency_s:
                        time.sleep(self.latency_s)
                    self._send(conn, {"id": req["id"], "pred": "0",
                                      "prob": 1.0, "topk": [["0", 1.0]]})

    def _send(self, conn, rec) -> None:
        try:
            conn.sendall((json.dumps(rec) + "\n").encode())
        except OSError:
            pass

    def kill(self) -> None:
        self._stop.set()
        try:
            self.srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


def _router(tmp_path, fakes, **kw):
    kw.setdefault("ping_interval_s", 0.03)
    kw.setdefault("ping_timeout_s", 1.0)
    kw.setdefault("breaker_cooldown_s", 0.2)
    kw.setdefault("retry_backoff_s", 0.01)
    kw.setdefault("respawn_backoff_s", 0.05)
    kw.setdefault("drain_timeout_s", 2.0)
    r = Router(attach=[("127.0.0.1", f.port) for f in fakes],
               state_dir=str(tmp_path / "router"), **kw)
    return r.start(timeout_s=10.0)


def _wait(cond, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _pump(router, stop, period=0.004):
    """Background client traffic: fire-and-forget submits (outcomes
    self-retrieved) so the rollout has live latency samples."""
    i = 0
    while not stop.is_set():
        try:
            fut = router.submit(line={"path": "x.png"}, timeout=0,
                                client_id=f"t{i}")
            fut.add_done_callback(
                lambda f: f.cancelled() or f.exception())
        except Exception:
            pass
        i += 1
        time.sleep(period)


def _ledger(router):
    with open(router.ledger_path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


# -- import purity -----------------------------------------------------------
def test_lifecycle_modules_are_stdlib_only():
    """The supervisor-parent rule extends to the whole lifecycle tier:
    the rollout controller (and the slo/meters helpers it reuses verbatim)
    and the HTTP front-end must import neither jax nor numpy."""
    code = ("import sys; import tpuic_torch.serve.rollout; "
            "import tpuic_torch.serve.http; "
            "import tpuic_torch.telemetry.slo; "
            "from tpuic_torch.metrics.meters import quantile; "
            "bad = [m for m in ('jax', 'numpy', 'flax', 'torch') "
            "if m in sys.modules]; "
            "assert not bad, f'lifecycle tier imported {bad}'; "
            "print('pure')")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "pure" in out.stdout


def test_swap_and_rollout_event_kinds_registered():
    from tpuic_torch.telemetry.events import EVENT_KINDS
    assert "swap" in EVENT_KINDS and "rollout" in EVENT_KINDS


# -- control channel ---------------------------------------------------------
def test_control_request_round_trip_and_typed_refusal(tmp_path):
    ok_fake = FakeReplica()
    bad_fake = FakeReplica(swap_error=wire.error_record(
        None, "candidate failed the integrity gate",
        cause="swap_corrupt"))
    # error_record omits cause unless err is an AdmissionError — build
    # the refusal the way the serve tier does, from the typed exception.
    bad_fake.swap_error = wire.error_record(
        None, SwapRejected("candidate failed the integrity gate",
                           cause="swap_corrupt"))
    r = _router(tmp_path, [ok_fake, bad_fake])
    try:
        resp = r.control_request("r0", {"op": "swap",
                                        "synthetic_seed": 3})
        assert resp["op"] == "swap_result" and resp["digest"] == "S3"
        assert ok_fake.swaps and ok_fake.swaps[0]["id"].startswith("c")
        with pytest.raises(SwapRejected) as ei:
            r.control_request("r1", {"op": "swap", "synthetic_seed": 3})
        assert ei.value.cause == "swap_corrupt"
        # Control futures never enter the offered-traffic ledger.
        assert r.stats.snapshot()["offered"] == 0
    finally:
        r.close()
        ok_fake.kill(), bad_fake.kill()


def test_control_request_replica_death_raises_replica_lost(tmp_path):
    # A swap the replica never answers, then abrupt death mid-request:
    # control futures are NOT failed over (a swap replayed on a
    # survivor would flip the wrong process) — typed ReplicaLost.
    fake = FakeReplica(hold_swap=True)
    r = _router(tmp_path, [fake])
    try:
        box = {}

        def call():
            try:
                r.control_request("r0", {"op": "swap",
                                         "synthetic_seed": 1},
                                  timeout_s=8.0)
            except Exception as e:  # noqa: BLE001
                box["exc"] = e

        t = threading.Thread(target=call, daemon=True)
        t.start()
        _wait(lambda: fake.swaps, msg="swap line delivered")
        fake.kill()
        t.join(timeout=8.0)
        assert isinstance(box.get("exc"), ReplicaLost)
    finally:
        r.close()
        fake.kill()


# -- model-identity gate -----------------------------------------------------
def test_digest_gate_refuses_heterogeneous_replica(tmp_path):
    f0, f1 = FakeReplica(digest="S0"), FakeReplica(digest="S0")
    r = _router(tmp_path, [f0, f1])
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        # r1 silently starts serving different weights (the hole the
        # gate closes): its pong digest changes without authorization.
        f1.digest = "SX"
        _wait(lambda: not r.replicas[1].health()["digest_ok"],
              msg="digest flag")
        f0.seen.clear(), f1.seen.clear()
        for i in range(20):
            r.submit(line={"path": "x.png"}, timeout=0.5,
                     client_id=f"g{i}").result(timeout=5.0)
        assert len(f0.seen) == 20 and not f1.seen, \
            "unauthorized digest still got traffic"
        ev = [e for e in _ledger(r) if e.get("action")
              == "digest_mismatch"]
        assert ev and ev[0]["replica"] == "r1" and ev[0]["digest"] == "SX"
        # Authorize it (what the rollout controller does for a canary).
        r.allow_digest("SX")
        _wait(lambda: r.replicas[1].health()["digest_ok"],
              msg="digest unflag")
        f0.seen.clear(), f1.seen.clear()
        for i in range(40):
            r.submit(line={"path": "x.png"}, timeout=0.5,
                     client_id=f"h{i}").result(timeout=5.0)
        assert f1.seen, "authorized digest never rejoined the rotation"
    finally:
        r.close()
        f0.kill(), f1.kill()


def test_all_replicas_digest_refused_sheds_typed(tmp_path):
    f0 = FakeReplica(digest="S0")
    r = _router(tmp_path, [f0])
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        f0.digest = "SX"
        _wait(lambda: not r.replicas[0].health()["digest_ok"],
              msg="digest flag")
        with pytest.raises(AdmissionRejected) as ei:
            r.submit(line={"path": "x.png"}, timeout=0,
                     client_id="x").result(timeout=5.0)
        assert "digest" in str(ei.value)
    finally:
        r.close()
        f0.kill()


# -- traffic split -----------------------------------------------------------
def test_traffic_split_fraction_honored(tmp_path):
    import random
    f0, f1 = FakeReplica(), FakeReplica()
    r = _router(tmp_path, [f0, f1])
    try:
        r._split_rng = random.Random(42)
        r.set_traffic_split({"r0"}, 0.3)
        n = 300
        for i in range(n):
            r.submit(line={"path": "x.png"}, timeout=0.5,
                     client_id=f"s{i}").result(timeout=5.0)
        share = len(f0.seen) / n
        assert 0.18 <= share <= 0.42, \
            f"canary share {share} far from the 0.3 split"
        r.clear_traffic_split()
        assert r.snapshot()["traffic_split"] is None
    finally:
        r.close()
        f0.kill(), f1.kill()


# -- the rollout controller --------------------------------------------------
def _rollout(r, fakes, **kw):
    kw.setdefault("objective", "serve_latency:p99<=80ms")
    kw.setdefault("stages", (0.5, 1.0))
    kw.setdefault("hold_s", 0.2)
    kw.setdefault("min_samples", 8)
    kw.setdefault("burn_rollback", 2.0)
    kw.setdefault("rollback_after", 2)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("stage_timeout_s", 20.0)
    return CanaryRollout(r, kw.pop("candidate",
                                   {"synthetic_seed": 5}),
                         kw.pop("incumbent", {"synthetic_seed": 0}),
                         **kw)


def test_rollout_clean_promote(tmp_path):
    f0, f1 = FakeReplica(digest="S0"), FakeReplica(digest="S0")
    r = _router(tmp_path, [f0, f1])
    stop = threading.Event()
    t = threading.Thread(target=_pump, args=(r, stop), daemon=True)
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        t.start()
        verdict = _rollout(r, [f0, f1]).run()
        assert verdict["verdict"] == "promoted", verdict
        assert verdict["canary"] == "r0" and verdict["digest"] == "S5"
        assert f0.swaps and f1.swaps, "promotion must swap EVERY replica"
        assert r.fleet_digest == "S5"
        assert r.snapshot()["traffic_split"] is None
        actions = [e["action"] for e in _ledger(r)
                   if e.get("event") == "rollout"]
        assert actions[0] == "start" and "promote" in actions \
            and actions.count("stage") == 2 and "done" in actions
        # Post-promote traffic still flows (zero-downtime end state).
        r.submit(line={"path": "x.png"}, timeout=0.5,
                 client_id="post").result(timeout=5.0)
    finally:
        stop.set()
        t.join(timeout=2.0)
        r.close()
        f0.kill(), f1.kill()


def test_rollout_refused_candidate_never_sees_traffic(tmp_path):
    refusal = wire.error_record(
        None, SwapRejected("manifest mismatch", cause="swap_corrupt"))
    f0 = FakeReplica(digest="S0", swap_error=refusal)
    f1 = FakeReplica(digest="S0")
    r = _router(tmp_path, [f0, f1])
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        verdict = _rollout(r, [f0, f1]).run()
        assert verdict["verdict"] == "refused"
        assert verdict["cause"] == "swap_corrupt"
        assert r.fleet_digest == "S0"
        assert not f1.swaps, "refusal must stop the rollout cold"
        actions = [e["action"] for e in _ledger(r)
                   if e.get("event") == "rollout"]
        assert "stage" not in actions, \
            "a refused candidate must never get a traffic stage"
        assert r.snapshot()["traffic_split"] is None
    finally:
        r.close()
        f0.kill(), f1.kill()


def test_rollout_auto_rollback_on_slo_burn(tmp_path):
    # Candidate seed 5 serves at 200ms on the canary — every sample
    # violates p99<=80ms, burn saturates, rollback after 2 polls.
    f0 = FakeReplica(digest="S0", swap_latency={"5": 0.2})
    f1 = FakeReplica(digest="S0")
    r = _router(tmp_path, [f0, f1])
    stop = threading.Event()
    t = threading.Thread(target=_pump, args=(r, stop), daemon=True)
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        t.start()
        verdict = _rollout(r, [f0, f1], stages=(1.0,),
                           min_samples=4).run()
        assert verdict["verdict"] == "rolled_back", verdict
        assert verdict["reason"] == "slo_burn"
        assert verdict["burn"] >= 2.0
        # Rollback is itself a swap: the canary got the incumbent line.
        assert f0.swaps[-1].get("synthetic_seed") == 0
        assert not f1.swaps, "the incumbent replica must not be touched"
        assert r.fleet_digest == "S0"
        assert r.snapshot()["traffic_split"] is None
        # Swap-back restored the incumbent digest: routable again.
        _wait(lambda: r.replicas[0].health()["digest_ok"],
              msg="canary rejoin after rollback")
        actions = [e["action"] for e in _ledger(r)
                   if e.get("event") == "rollout"]
        assert "rollback" in actions and "promote" not in actions
        # The candidate digest was disallowed BEFORE the swap-back.
        dis = [e for e in _ledger(r)
               if e.get("action") == "digest_disallow"]
        assert dis and dis[0]["digest"] == "S5"
    finally:
        stop.set()
        t.join(timeout=2.0)
        r.close()
        f0.kill(), f1.kill()


def test_rollout_no_evidence_no_promote(tmp_path):
    # NO client traffic: stages gather zero samples and the rollout
    # must roll back on stage timeout instead of promoting blind.
    f0, f1 = FakeReplica(digest="S0"), FakeReplica(digest="S0")
    r = _router(tmp_path, [f0, f1])
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        verdict = _rollout(r, [f0, f1], stages=(1.0,),
                           stage_timeout_s=0.6).run()
        assert verdict["verdict"] == "rolled_back"
        assert verdict["reason"] == "stage_timeout"
        assert r.fleet_digest == "S0" and not f1.swaps
    finally:
        r.close()
        f0.kill(), f1.kill()


def test_rollout_state_feeds_prom_rows(tmp_path):
    from tpuic_torch.telemetry.prom import router_exposition
    f0 = FakeReplica(digest="S0")
    r = _router(tmp_path, [f0])
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        ro = _rollout(r, [f0])
        txt = router_exposition(r.snapshot(), rollout=ro.state())
        assert "tpuic_router_rollout_phase 0" in txt
        assert "tpuic_router_replica_model_info" in txt
        assert 'digest="S0"' in txt
    finally:
        r.close()
        f0.kill()


# -- HTTP front-end ----------------------------------------------------------
def _http(method, port, path, body=None, timeout=10.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=(json.dumps(body).encode() if body is not None else None),
        method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_http_predict_healthz_metrics(tmp_path):
    f0 = FakeReplica(digest="S0")
    r = _router(tmp_path, [f0])
    srv = RouterHTTPServer(r, port=0)
    try:
        status, _, body = _http("POST", srv.port, "/predict",
                                {"id": "h1", "path": "x.png"})
        assert status == 200
        rec = json.loads(body)
        assert rec["id"] == "h1" and rec["pred"] == "0"
        status, _, body = _http("GET", srv.port, "/healthz")
        assert status == 200
        h = json.loads(body)
        assert h["status"] == "ok" and h["replicas_up"] == 1
        assert h["fleet_digest"] == "S0"
        status, _, body = _http("GET", srv.port, "/metrics")
        assert status == 200
        assert "tpuic_router_offered_total" in body
        assert 'tpuic_router_fleet_model_info{digest="S0"}' in body
        status, _, _ = _http("GET", srv.port, "/nope")
        assert status == 404
    finally:
        srv.close()
        r.close()
        f0.kill()


def test_http_typed_verdicts_map_to_429_503(tmp_path):
    f0 = FakeReplica(digest="S0")
    r = _router(tmp_path, [f0], spill_inflight=1)
    srv = RouterHTTPServer(r, port=0, result_timeout_s=5.0)
    try:
        # Saturate the one replica's spill limit with a held request
        # (the fake answers after 0.5 s), then POST: the router sheds
        # queue_full -> 429 + Retry-After.
        f0.latency_s = 0.5
        slow = r.submit(line={"path": "x.png"}, timeout=0,
                        client_id="slow")
        status, headers, body = _http("POST", srv.port, "/predict",
                                      {"id": "h2", "path": "x.png"})
        assert status == 429, body
        assert headers.get("Retry-After")
        rec = json.loads(body)
        assert rec["cause"] == "queue_full" and rec["id"] == "h2"
        slow.result(timeout=5.0)
        # healthz flips 503 when the whole fleet is gone.
        f0.latency_s = 0.0
        f0.kill()
        _wait(lambda: r.replicas[0].state != "up", msg="replica down")
        status, headers, body = _http("GET", srv.port, "/healthz")
        assert status == 503 and json.loads(body)["status"] == "down"
        assert headers.get("Retry-After")
    finally:
        srv.close()
        r.close()
        f0.kill()


# -- review hardening regressions --------------------------------------------
def test_data_path_refuses_control_op_lines(tmp_path):
    """Control lines must never ride the data path: submit() would
    failover-replay them onto survivors (a replayed swap flips a
    replica nobody named), and a front-end forwarding raw lines must
    not be a one-line weight flip.  Typed refusal, ledger untouched."""
    f0 = FakeReplica()
    r = _router(tmp_path, [f0])
    try:
        with pytest.raises(ValueError, match="control_request"):
            r.submit(line={"op": "swap", "synthetic_seed": 2})
        with pytest.raises(ValueError, match="control_request"):
            r.submit_line({"op": "ping", "id": "x"})
        assert r.stats.snapshot()["offered"] == 0
        assert not f0.swaps and not f0.seen
    finally:
        r.close()
        f0.kill()


def test_http_client_errors_are_400_not_500(tmp_path):
    f0 = FakeReplica()
    r = _router(tmp_path, [f0])
    srv = RouterHTTPServer(r, port=0)
    try:
        # A control line over the unauthenticated front-end: 400.
        status, _, body = _http("POST", srv.port, "/predict",
                                {"op": "swap", "synthetic_seed": 2})
        assert status == 400, body
        assert not f0.swaps
        # Malformed SLA field: the client's problem, not the server's.
        status, _, body = _http("POST", srv.port, "/predict",
                                {"path": "x.png", "priority": "urgent"})
        assert status == 400, body
    finally:
        srv.close()
        r.close()
        f0.kill()


def test_rollout_aborts_without_fleet_digest(tmp_path):
    """No incumbent digest = no rollout: adopt-first-seen would crown
    the CANDIDATE as the fleet digest and a later rollback would empty
    the allowed set — the controller must abort pre-swap instead."""
    f0 = FakeReplica(digest=None)  # pong carries no identity
    r = _router(tmp_path, [f0])
    try:
        verdict = _rollout(r, [f0]).run()  # ~10s identity grace window
        assert verdict["verdict"] == "aborted"
        assert verdict["reason"] == "no_fleet_digest"
        assert not f0.swaps, "abort must happen BEFORE the canary swap"
    finally:
        r.close()
        f0.kill()


def test_digest_events_not_lost_under_concurrent_transitions(tmp_path):
    """The digest-transition ledger records EVERY transition even when
    several replicas flip at once (the rollback-disallows-a-digest-two-
    replicas-report shape): events queue under the lock, flush outside."""
    fakes = [FakeReplica(digest="S0") for _ in range(3)]
    r = _router(tmp_path, fakes)
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        for f in fakes:
            f.digest = "SX"  # all three go unauthorized together
        _wait(lambda: all(not rep.health()["digest_ok"]
                          for rep in r.replicas),
              msg="all flagged")

        def mismatches():
            return {e["replica"] for e in _ledger(r)
                    if e.get("action") == "digest_mismatch"}

        # The flag flips under the lock before the ledger write lands:
        # wait for the writes, then assert none was lost.
        _wait(lambda: len(mismatches()) == 3,
              msg="all three digest_mismatch ledger events")
        assert mismatches() == {"r0", "r1", "r2"}
    finally:
        r.close()
        for f in fakes:
            f.kill()


def test_partial_promotion_keeps_skipped_replica_routable(tmp_path):
    """A replica down at promote time respawns on the INCUMBENT
    weights: the incumbent digest must stay authorized (explicit,
    ledger-visible heterogeneity) or it would rejoin permanently
    unroutable — silent capacity loss behind a 'promoted' verdict."""
    fakes = [FakeReplica(digest="S0") for _ in range(3)]
    r = _router(tmp_path, fakes)
    stop = threading.Event()
    t = threading.Thread(target=_pump, args=(r, stop), daemon=True)
    try:
        _wait(lambda: r.fleet_digest == "S0", msg="digest adoption")
        fakes[2].kill()  # r2 is down before (and through) the rollout
        _wait(lambda: r.replicas[2].state != "up", msg="r2 down")
        t.start()
        verdict = _rollout(r, fakes).run()
        assert verdict["verdict"] == "promoted", verdict
        assert verdict["skipped"] == ["r2"]
        assert verdict["promoted"] == ["r1"]
        snap = r.snapshot()
        assert snap["fleet_digest"] == "S5"
        # Both digests authorized: a respawned r2 (booting S0) rejoins
        # routable instead of being digest-flagged forever.
        assert set(snap["allowed_digests"]) == {"S0", "S5"}
        assert any(e.get("action") == "promote_partial"
                   for e in _ledger(r) if e.get("event") == "rollout")
    finally:
        stop.set()
        t.join(timeout=2.0)
        r.close()
        for f in fakes:
            f.kill()


ROLLOUT_STATES = (
    None,
    {"phase": "idle", "stage_index": -1, "stage_fraction": 0.0,
     "canary_errors": 0},
    {"phase": "canary", "stage_index": 0, "stage_fraction": 0.05,
     "canary_errors": 0, "objective": "serve_latency_p99",
     "burn_rate": 2.5, "canary_window_samples": 40},
    {"phase": "rolled_back", "stage_index": 1, "stage_fraction": 0.5,
     "canary_errors": 3, "objective": "serve_latency_p99",
     "burn_rate": None, "canary_window_samples": 0},
)


@pytest.mark.parametrize("state", ROLLOUT_STATES,
                         ids=["none", "idle", "canary", "rolled_back"])
def test_rollout_rows_match_tpuic(state):
    """``tpuic_rollout_*`` rows: the same rows and the same rendered
    text as ``tpuic``'s on one rollout state."""
    from tpuic.telemetry import prom as theirs
    from tpuic_torch.telemetry import prom as ours

    assert ours.rollout_rows(state) == theirs.rollout_rows(state)
    assert ours.render(ours.rollout_rows(state), "tpuic_router") == \
        theirs.render(theirs.rollout_rows(state), "tpuic_router")


def test_rollout_cli_promotes_a_seeded_candidate_over_real_replicas(
        tmp_path):
    """``python -m tpuic_torch.serve.rollout`` over two real CPU
    replicas (resnet18 at 32 px): a ``synthetic_seed`` candidate gates,
    canaries over two stages under live stdin traffic and promotes; every
    request line is answered and the verdict lands on stdout."""
    import numpy as np

    from _torch_threads import subprocess_env

    cmd = [sys.executable, "-m", "tpuic_torch.serve", "--device", "cpu",
           "--synthetic-init", "--model", "resnet18", "--num-classes",
           "10", "--resize", "32", "--buckets", "1,4", "--max-wait-ms", "2",
           "--listen", "127.0.0.1:0", "--prom-port", "-1"]
    rng = np.random.default_rng(2)
    pool = [json.dumps(wire.encode_array(
        rng.integers(0, 256, (1, 32, 32, 3), np.uint8)))[1:-1]
        for _ in range(16)]
    err = tmp_path / "rollout.err"
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        prom_port = probe.getsockname()[1]
    with open(err, "w") as ef:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuic_torch.serve.rollout",
             "--replicas", "2", "--state-dir", str(tmp_path / "state"),
             "--replica-cmd", " ".join(cmd),
             "--candidate", '{"synthetic_seed": 1}',
             "--incumbent", '{"synthetic_seed": 0}',
             "--slo", "serve_latency:p99<=5000ms@0.9", "--stages",
             "0.5,1.0", "--hold-s", "0.5", "--min-samples", "5",
             "--poll-s", "0.1", "--stage-timeout-s", "60",
             "--prom-port", str(prom_port)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=ef,
            text=True, env=subprocess_env())
    # The answers are read as they come: a stdout pipe left full would
    # block the rollout's writer, then its reader, then the feed below.
    out_lines, sent = [], []
    stop = threading.Event()
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout),
                              daemon=True)

    def feed():
        # Live traffic, ~40 requests a second, until the verdict: a stage
        # without samples never promotes.  At most 16 requests ahead of
        # the answers (what the stdin pipe held), so a slow host's
        # replicas are not buried under a backlog.
        try:
            while not stop.is_set():
                n = len(sent)
                if n - len(out_lines) >= 16:
                    time.sleep(0.01)
                    continue
                proc.stdin.write(
                    f'{{"id": "q{n}", {pool[n % len(pool)]}}}\n')
                proc.stdin.flush()
                sent.append(n)
                time.sleep(0.025)
        except (BrokenPipeError, ValueError):
            pass  # the rollout exited: its failure is asserted below

    writer = threading.Thread(target=feed, daemon=True)
    reader.start()
    writer.start()
    try:
        deadline = time.monotonic() + 240
        while "[rollout] verdict" not in err.read_text():
            assert time.monotonic() < deadline, err.read_text()[-2000:]
            assert proc.poll() is None, err.read_text()[-2000:]
            time.sleep(0.05)
        stop.set()
        writer.join(timeout=30)
        assert not writer.is_alive()
        # The rollout's rows where a user reads them: the CLI's
        # --prom-port exposition, beside the router's.
        with urllib.request.urlopen(
                f"http://127.0.0.1:{prom_port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        proc.stdin.close()
        proc.wait(timeout=180)
        reader.join(timeout=30)
        assert not reader.is_alive()
    finally:
        stop.set()
        if proc.poll() is None:
            # SIGTERM first: the router drains and stops its replicas (a
            # SIGKILL would leave them running).
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    n = len(sent)
    recs = [json.loads(ln) for ln in out_lines if ln.strip()]
    verdict = recs[-1]
    assert verdict["op"] == "rollout_verdict", err.read_text()[-2000:]
    assert verdict["verdict"] == "promoted", verdict
    assert proc.returncode == 0
    answered = [r for r in recs[:-1] if "pred" in r]
    assert sorted(r["id"] for r in answered) == sorted(
        f"q{i}" for i in range(n)), [r for r in recs if "pred" not in r][:5]
    assert {r["replica"] for r in answered} == {"r0", "r1"}
    assert "tpuic_router_offered_total" in metrics
    assert "tpuic_router_rollout_phase" in metrics


def test_rollout_cli_crash_verdict_matches_tpuic(tmp_path, monkeypatch):
    """A rollout whose thread raises ends the rollout CLI with
    ``tpuic``'s verdict record, value for value (``reason:
    driver_error``), over the same fake replica and an empty stdin."""
    import io

    from tpuic.serve import rollout as theirs
    from tpuic_torch.serve import rollout as ours

    def boom(self):
        raise RuntimeError("boom")

    got = {}
    for name, mod in (("ours", ours), ("theirs", theirs)):
        f0 = FakeReplica(digest="S0")
        monkeypatch.setattr(mod.CanaryRollout, "run", boom)
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        out = tmp_path / f"{name}.jsonl"
        try:
            rc = mod.main(["--attach", f"127.0.0.1:{f0.port}",
                           "--state-dir", str(tmp_path / name),
                           "--candidate", '{"synthetic_seed": 1}',
                           "--incumbent", '{"synthetic_seed": 0}',
                           "--drain-timeout", "1", "--out", str(out)])
        finally:
            f0.kill()
        got[name] = (rc, [json.loads(ln) for ln in
                          out.read_text().splitlines()])
    assert got["ours"] == got["theirs"]
    assert got["ours"] == (2, [{"op": "rollout_verdict",
                                "verdict": "aborted",
                                "reason": "driver_error",
                                "error": "boom"}])
