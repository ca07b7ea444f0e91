"""The port's replica router (``tpuic_torch.serve.router``) through
``tpuic``'s cases (``tests/test_router.py``): health-checked routing,
breakers, retry budget, kill-mid-flight failover, against the same fake
stdlib replicas (real sockets, real reader threads, real breaker state
machines, and a ``kill()`` as abrupt as a SIGKILL).

Beside them: the router in front of two real ``python -m
tpuic_torch.serve --device cpu --synthetic-init --listen`` replicas
(answers equal a direct port forward; a SIGKILL mid-wave fails over with
an exact ledger), and the router's exposition against ``tpuic``'s on one
snapshot.  chip_smoke's ``[fleet]`` is the same story on the card.
"""

import json
import socket
import subprocess
import sys
import threading
import time

import pytest

from tpuic_torch.serve.admission import (AdmissionError, AdmissionRejected,
                                   DeadlineExceeded, ReplicaLost)
from tpuic_torch.serve.router import CircuitBreaker, RetryBudget, Router
from tpuic_torch.serve import wire


# -- fake replica ------------------------------------------------------------
class FakeReplica:
    """Stdlib socket server speaking the replica transport: pongs
    pings, answers requests via ``respond`` (default: a canned result
    record), optionally *holds* requests (never answers — in-flight
    fodder for failover tests).  ``kill()`` drops every connection and
    the listener abruptly, the SIGKILL shape."""

    def __init__(self, *, hold: bool = False, respond=None,
                 port: int = 0) -> None:
        self.hold = hold
        self.respond = respond or (lambda req: {
            "id": req["id"], "pred": "0", "prob": 1.0,
            "topk": [["0", 1.0]]})
        deadline = time.monotonic() + 5.0
        while True:
            try:
                self.srv = socket.create_server(("127.0.0.1", port))
                break
            except OSError:
                # Rebinding a just-killed replica's fixed port: the old
                # accept syscall may not have released the fd yet.
                if port == 0 or time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self.port = self.srv.getsockname()[1]
        self.held = []          # requests received while hold=True
        self.seen = []          # every non-ping request
        self._conns = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._accept.start()

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
                                      "queue_depth": 0})
                    continue
                self.seen.append(req)
                if self.hold:
                    self.held.append(req)
                    continue
                self._send(conn, self.respond(req))

    def _send(self, conn, rec) -> None:
        try:
            conn.sendall((json.dumps(rec) + "\n").encode())
        except OSError:
            pass

    def kill(self) -> None:
        """Abrupt death: listener and every connection dropped."""
        self._stop.set()
        try:
            self.srv.close()
        except OSError:
            pass
        self._accept.join(timeout=2.0)  # release the listener fd
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
    kw.setdefault("ping_interval_s", 0.05)
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


# -- import purity -----------------------------------------------------------
def test_router_module_is_stdlib_only():
    """The supervisor-parent rule: importing the router (and the wire +
    admission modules it rides on) must pull neither jax nor numpy —
    the router has to outlive any backend wedge its replicas hit."""
    code = ("import sys; import tpuic_torch.serve.router; "
            "bad = [m for m in ('jax', 'numpy', 'flax', 'torch') "
            "if m in sys.modules]; "
            "assert not bad, f'router imported {bad}'; print('pure')")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "pure" in out.stdout


# -- unit: retry budget ------------------------------------------------------
def test_retry_budget_ratio_of_successes():
    b = RetryBudget(ratio=0.5, cap=2.0)
    assert b.try_retry() and b.try_retry()  # starts full (cold-start room)
    assert not b.try_retry()                # dry
    assert b.state()["denied"] == 1
    for _ in range(2):
        b.deposit()                         # 2 successes x 0.5 = 1 token
    assert b.try_retry()
    assert not b.try_retry()


def test_retry_budget_cap_bounds_burst():
    b = RetryBudget(ratio=1.0, cap=3.0)
    for _ in range(100):
        b.deposit()
    assert b.state()["tokens"] == 3.0
    assert all(b.try_retry() for _ in range(3))
    assert not b.try_retry()


# -- unit: circuit breaker ---------------------------------------------------
def test_breaker_opens_on_consecutive_failures_and_probes():
    now = [0.0]
    seen = []
    cb = CircuitBreaker(threshold=3, cooldown_s=1.0, clock=lambda: now[0],
                        on_transition=lambda o, n, r: seen.append((o, n)))
    assert cb.try_acquire()
    cb.record_failure()
    cb.record_failure()
    cb.record_success()        # success resets the consecutive count
    cb.record_failure()
    cb.record_failure()
    assert cb.state == "closed"
    cb.record_failure()        # third consecutive -> open
    assert cb.state == "open"
    assert not cb.try_acquire()            # cooling down
    now[0] = 1.5
    assert cb.try_acquire()                # half-open probe slot
    assert cb.state == "half_open"
    assert not cb.try_acquire()            # one probe at a time
    cb.record_success()
    assert cb.state == "closed"
    assert ("closed", "open") in seen and ("open", "half_open") in seen \
        and ("half_open", "closed") in seen


def test_breaker_probe_failure_reopens_and_trip_is_immediate():
    now = [0.0]
    cb = CircuitBreaker(threshold=3, cooldown_s=0.5, clock=lambda: now[0])
    cb.trip("connection lost")             # conclusive: open NOW
    assert cb.state == "open"
    now[0] = 1.0
    assert cb.try_acquire()
    cb.record_failure("probe died")
    assert cb.state == "open"              # re-opened, fresh cooldown
    assert not cb.try_acquire()
    now[0] = 2.0
    assert cb.try_acquire()
    cb.record_success()
    assert cb.state == "closed"


# -- routing -----------------------------------------------------------------
def test_routes_and_resolves_responses(tmp_path):
    fakes = [FakeReplica(), FakeReplica()]
    r = _router(tmp_path, fakes)
    try:
        futs = [r.submit(line={"path": f"img{i}.png"}, timeout=5,
                         client_id=f"c{i}") for i in range(8)]
        for i, f in enumerate(futs):
            rec = f.result(timeout=10)
            assert rec["pred"] == "0" and rec["id"] == f"c{i}"
            assert rec["replica"] in ("r0", "r1")
        snap = r.stats.snapshot()
        assert snap["offered"] == 8 and snap["requests"] == 8
        assert snap["rejected"] == 0 and snap["errors"] == 0
        # least-loaded + routed tiebreak spread the work across both
        assert all(rep["routed"] > 0
                   for rep in snap["replicas"].values())
    finally:
        r.close(drain=False)
        for f in fakes:
            f.kill()


def test_typed_replica_verdicts_cross_the_wire(tmp_path):
    """An engine-side typed rejection (here: deadline) crosses the
    socket and resolves the client future as the SAME exception type a
    local engine would raise — wire.rebuild_error round trip."""
    def shed(req):
        return wire.error_record(
            req["id"], DeadlineExceeded("deadline expired before "
                                        "service", priority="low"))
    fakes = [FakeReplica(respond=shed)]
    r = _router(tmp_path, fakes)
    try:
        fut = r.submit(line={"path": "x.png", "priority": "low"},
                       timeout=5)
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=10)
        assert ei.value.cause == "deadline"
        snap = r.stats.snapshot()
        assert snap["rejected_by"] == {"deadline": {"low": 1}}
        assert snap["requests"] == 0 and snap["offered"] == 1
    finally:
        r.close(drain=False)
        fakes[0].kill()


def test_spill_limit_sheds_typed_when_fleet_saturated(tmp_path):
    """Shed-aware routing: with every replica at its spill limit the
    router sheds with a typed queue_full verdict instead of queueing
    toward a timeout (the ROADMAP's 'sheds instead of timing out')."""
    fakes = [FakeReplica(hold=True), FakeReplica(hold=True)]
    r = _router(tmp_path, fakes, spill_inflight=1)
    try:
        held = [r.submit(line={"path": "a"}, timeout=5) for _ in range(2)]
        _wait(lambda: sum(len(f.held) for f in fakes) == 2,
              msg="both replicas holding one request")
        with pytest.raises(AdmissionRejected) as ei:
            r.submit(line={"path": "c"}, timeout=0).result(timeout=5)
        assert ei.value.cause == "queue_full"
        assert "spill limit" in str(ei.value)
        snap = r.stats.snapshot()
        assert snap["rejected_by"]["queue_full"]["normal"] == 1
        for f in held:
            assert not f.done()  # the held ones are untouched
    finally:
        r.close(drain=False)
        for f in fakes:
            f.kill()


# -- failover ----------------------------------------------------------------
def test_kill_mid_flight_fails_over_to_survivor(tmp_path):
    """THE tentpole contract in miniature: a replica dies with a
    request in flight; the request requeues to the survivor under the
    retry budget and resolves — zero client timeouts — while the dead
    replica's breaker trips open; in-flight work elsewhere and the
    ledger stay exact."""
    victim, survivor = FakeReplica(hold=True), FakeReplica()
    r = _router(tmp_path, [victim, survivor])
    try:
        fut = r.submit(line={"path": "v.png"}, timeout=5, client_id="v")
        _wait(lambda: len(victim.held) == 1, msg="victim holding")
        victim.kill()
        rec = fut.result(timeout=10)      # failover, not a timeout
        assert rec["id"] == "v" and rec["replica"] == "r1"
        assert fut.tpuic_retries == 1     # the loadgen on_retry contract
        snap = r.stats.snapshot()
        assert snap["requests"] == 1 and snap["offered"] == 1
        assert snap["failovers"] == 1 and snap["retries"] == 1
        assert snap["failover_requeued"] == 1
        assert snap["replicas"]["r0"]["state"] == "down"
        assert snap["replicas"]["r0"]["breaker"]["state"] == "open"
        # the failover + breaker trail landed in the ledger
        events = [json.loads(ln) for ln in
                  open(r.ledger_path).read().splitlines()]
        kinds = [e["event"] for e in events]
        assert "router_failover" in kinds and "router_retry" in kinds
        breaker = [e for e in events if e["event"] == "router_breaker"
                   and e["replica"] == "r0"]
        assert any(e["new"] == "open" for e in breaker)
    finally:
        r.close(drain=False)
        survivor.kill()


def test_non_idempotent_request_gets_replica_lost(tmp_path):
    victim = FakeReplica(hold=True)
    survivor = FakeReplica()
    r = _router(tmp_path, [victim, survivor])
    try:
        fut = r.submit(line={"path": "v.png"}, timeout=5,
                       idempotent=False)
        _wait(lambda: len(victim.held) == 1, msg="victim holding")
        victim.kill()
        with pytest.raises(ReplicaLost) as ei:
            fut.result(timeout=10)
        assert ei.value.cause == "replica_lost"
        assert "not idempotent" in str(ei.value)
        snap = r.stats.snapshot()
        assert snap["rejected_by"]["replica_lost"]["normal"] == 1
        assert snap["failover_lost"] == 1 and snap["retries"] == 0
        assert len(survivor.seen) == 0  # never replayed
    finally:
        r.close(drain=False)
        survivor.kill()


def test_dry_retry_budget_sheds_instead_of_storming(tmp_path):
    """No retry storms: with the budget dry, a replica loss resolves
    its in-flight as replica_lost instead of replaying."""
    victim = FakeReplica(hold=True)
    survivor = FakeReplica()
    r = _router(tmp_path, [victim, survivor],
                retry_ratio=0.0, retry_cap=1.0)  # exactly one token, ever
    try:
        futs = [r.submit(line={"path": f"{i}.png"}, timeout=5)
                for i in range(3)]
        _wait(lambda: len(victim.held) >= 1, msg="victim holding")
        time.sleep(0.2)  # let routing settle (some land on survivor)
        n_victim = len(victim.held)
        victim.kill()
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=10)
                outcomes.append("ok")
            except ReplicaLost:
                outcomes.append("lost")
        snap = r.stats.snapshot()
        # every request resolved exactly once; at most ONE replay spent
        assert snap["requests"] + snap["rejected"] == 3
        assert snap["retries"] <= 1
        if n_victim >= 2:
            assert outcomes.count("lost") == n_victim - 1
            assert snap["rejected_by"]["replica_lost"]["normal"] \
                == n_victim - 1
    finally:
        r.close(drain=False)
        survivor.kill()


def test_breaker_half_open_rejoins_restarted_replica(tmp_path):
    """The rejoin path the soak asserts: kill -> breaker open ->
    replica comes back on the same address -> reconnect -> half-open
    probe -> closed, and traffic flows to it again."""
    victim, survivor = FakeReplica(), FakeReplica()
    r = _router(tmp_path, [victim, survivor], breaker_cooldown_s=0.1)
    try:
        assert r.submit(line={"path": "warm"},
                        timeout=5).result(10)["pred"] == "0"
        port = victim.port
        victim.kill()
        _wait(lambda: (r.replicas[0].state == "down"
                       and r.replicas[0].breaker.state == "open"),
              msg="victim down with breaker open")
        # requests keep flowing to the survivor meanwhile
        assert r.submit(line={"path": "mid"},
                        timeout=5).result(10)["replica"] == "r1"
        reborn = FakeReplica(port=port)     # same address, new process
        _wait(lambda: r.replicas[0].state == "up", msg="reconnect")
        # route until the half-open probe lands on r0 and closes it
        _wait(lambda: (any(r.submit(line={"path": "p"}, timeout=5)
                           .result(10) is not None for _ in [0])
                       and r.replicas[0].breaker.state == "closed"),
              timeout=10.0, msg="half-open probe to close")
        events = [json.loads(ln) for ln in
                  open(r.ledger_path).read().splitlines()
                  if '"router_breaker"' in ln]
        states = [e["new"] for e in events if e["replica"] == "r0"]
        assert "open" in states and "half_open" in states \
            and "closed" in states
        i_open = states.index("open")
        assert states.index("half_open", i_open) < states.index(
            "closed", i_open)  # open -> half_open -> closed, in order
        reborn.kill()
    finally:
        r.close(drain=False)
        survivor.kill()


def test_condemned_socket_runs_down_path_and_reconnects(tmp_path):
    """Regression: when the SENDER condemns a socket (a failed request
    or ping send calls close_socket, which nulls ``rep.sock`` before
    shutting the fd down), the reader must still run the down/failover
    path.  The old ``rep.sock is sock`` guard was always false in that
    shape: in-flight requests hung until drain and the replica sat in
    state "up" with no socket, never reconnecting."""
    victim, survivor = FakeReplica(hold=True), FakeReplica()
    r = _router(tmp_path, [victim, survivor])
    try:
        fut = r.submit(line={"path": "v.png"}, timeout=5, client_id="v")
        _wait(lambda: len(victim.held) == 1, msg="victim holding")
        # The condemned-socket shape, exactly as the send/ping failure
        # paths produce it.  The FakeReplica itself stays alive, so
        # only the router-side down path can notice anything.
        r.replicas[0].close_socket()
        rec = fut.result(timeout=10)      # failover, not a hang
        assert rec["id"] == "v" and rec["replica"] == "r1"
        assert r.stats.snapshot()["failover_requeued"] == 1
        # the still-listening attached replica is reconnected (the old
        # bug left it wedged in "up" with sock=None forever)
        _wait(lambda: (r.replicas[0].state == "up"
                       and r.replicas[0].sock is not None),
              msg="victim reconnect after condemned socket")
    finally:
        r.close(drain=False)
        victim.kill()
        survivor.kill()


def test_ping_send_failure_fails_over_in_flight(tmp_path):
    """Regression: a ping-path transport failure runs the down path
    directly — breaker trip, socket condemned, in-flight requeued to a
    survivor — instead of only closing the socket and leaving the
    replica routable."""
    victim, survivor = FakeReplica(hold=True), FakeReplica()
    r = _router(tmp_path, [victim, survivor])
    try:
        fut = r.submit(line={"path": "v.png"}, timeout=5, client_id="v")
        _wait(lambda: len(victim.held) == 1, msg="victim holding")

        def boom(rec):
            raise OSError("stubbed ping transport failure")

        r.replicas[0].send_line = boom    # next ping tick hits it
        rec = fut.result(timeout=10)
        assert rec["replica"] == "r1"
        snap = r.stats.snapshot()
        assert snap["failover_requeued"] == 1
        assert snap["replicas"]["r0"]["breaker"]["state"] == "open"
    finally:
        r.close(drain=False)
        victim.kill()
        survivor.kill()


def test_retry_queue_pops_by_due_time_not_fifo(tmp_path):
    """Regression: the replay queue orders by due time — a long-backoff
    entry queued FIRST must not head-of-line block an already-due
    replay behind it (the FIFO deque broke exactly that, delaying
    failover into the retry window)."""
    victim, survivor = FakeReplica(hold=True), FakeReplica()
    r = _router(tmp_path, [victim, survivor], max_attempts=6,
                retry_backoff_s=0.3, retry_backoff_cap_s=2.0,
                breaker_cooldown_s=0.6)
    try:
        # Open the survivor's breaker so BOTH requests route to the
        # held victim; the 0.6s cooldown outlasts the submit setup (so
        # a slow machine can't leak a half-open probe to the survivor
        # early) yet expires well before the 2.0s capped backoff, so
        # the due replay is admitted with margin under the 1.5s bound.
        r.replicas[1].breaker.trip("test setup")
        fut1 = r.submit(line={"path": "slow.png"}, timeout=5)
        _wait(lambda: len(victim.held) == 1, msg="first held")
        with r._lock:
            # Aged replay: 4 prior attempts -> 0.3 * 2**3 = 2.4s
            # backoff, capped at 2.0s.  Queued first on failover.
            next(iter(r.replicas[0].inflight.values())).attempts = 4
        fut2 = r.submit(line={"path": "fast.png"}, timeout=5)
        _wait(lambda: len(victim.held) == 2, msg="both held")
        t_kill = time.monotonic()
        victim.kill()
        rec2 = fut2.result(timeout=10)    # 0.3s backoff, behind fut1
        assert rec2["replica"] == "r1"
        assert time.monotonic() - t_kill < 1.5, \
            "due replay was head-of-line blocked behind a longer backoff"
        assert fut1.result(timeout=10)["replica"] == "r1"
    finally:
        r.close(drain=False)
        victim.kill()  # idempotent; covers a failure before the mid-body kill
        survivor.kill()


# -- drain -------------------------------------------------------------------
def test_drain_sheds_new_and_resolves_stragglers_typed(tmp_path):
    holder = FakeReplica(hold=True)
    r = _router(tmp_path, [holder])
    try:
        fut = r.submit(line={"path": "stuck"}, timeout=5)
        _wait(lambda: len(holder.held) == 1, msg="held")
        stragglers = r.drain(timeout_s=0.3)
        assert stragglers == 1
        with pytest.raises(ReplicaLost, match="drain timeout"):
            fut.result(timeout=5)
        with pytest.raises(AdmissionRejected, match="draining"):
            r.submit(line={"path": "late"}, timeout=0).result(timeout=5)
        snap = r.stats.snapshot()
        assert snap["requests"] == 0
        assert snap["rejected"] == 2 == snap["offered"]
    finally:
        r.close(drain=False)
        holder.kill()


# -- loadgen endpoint protocol ----------------------------------------------
def test_run_stream_drives_router_with_on_retry_hook(tmp_path):
    """The one-harness pledge: loadgen.run_stream drives a Router like
    an engine — same ledger contract, and the on_retry outcome hook
    reports failover replays."""
    from tpuic_torch.serve.loadgen import run_stream

    victim, survivor = FakeReplica(hold=True), FakeReplica()
    r = _router(tmp_path, [victim, survivor])
    try:
        retries, done = [], []
        items = [{"path": f"{i}.png"} for i in range(10)]

        def kill_late():
            _wait(lambda: len(victim.held) >= 1, msg="victim holding")
            victim.kill()

        killer = threading.Thread(target=kill_late, daemon=True)
        killer.start()
        wall, arrival, snap = run_stream(
            r, items, offsets_s=[0.03 * i for i in range(10)],
            result_timeout_s=30.0,
            on_done=lambda i, ok, s: done.append((i, ok)),
            on_retry=lambda i, n: retries.append((i, n)))
        killer.join(timeout=5)
        assert len(done) == 10
        assert snap["requests"] + snap["rejected"] == 10  # exact ledger
        assert snap["offered"] == 10
        if snap["retries"]:
            assert retries  # replays surfaced through the hook
            assert all(n >= 1 for _, n in retries)
    finally:
        r.close(drain=False)
        survivor.kill()


# -- wire --------------------------------------------------------------------
def test_wire_error_lines_identical_across_tiers():
    """The satellite contract: one encoder, one shape — an
    AdmissionError renders the same {id,error,cause,priority} record
    whether the accept path, drain(), or the router emits it."""
    exc = AdmissionRejected("queue full (priority=low)",
                            cause="queue_full", priority="low")
    rec = json.loads(wire.error_line("r1", exc))
    assert rec == {"id": "r1", "error": "queue full (priority=low)",
                   "cause": "queue_full", "priority": "low"}
    # untyped errors carry no cause fields
    rec = json.loads(wire.error_line("r2", "decode: boom"))
    assert rec == {"id": "r2", "error": "decode: boom"}
    # id-less (malformed line) records omit the id
    assert "id" not in json.loads(wire.error_line(None, "bad line"))


def test_wire_rebuild_error_round_trip():
    for exc in (AdmissionRejected("q", cause="brownout", priority="low"),
                DeadlineExceeded("d", priority="high"),
                ReplicaLost("r", priority="normal")):
        back = wire.rebuild_error(wire.error_record("x", exc))
        assert type(back) is type(exc)
        assert isinstance(back, AdmissionError)
        assert back.cause == exc.cause and back.priority == exc.priority
    assert isinstance(wire.rebuild_error({"error": "plain"}),
                      RuntimeError)


def test_wire_array_round_trip():
    np = pytest.importorskip("numpy")
    arr = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    rec = wire.encode_array(arr)
    assert set(rec) == {"b64", "shape", "dtype"}
    back = wire.decode_array(rec)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert (back == arr).all()
    with pytest.raises(ValueError, match="bad array payload"):
        wire.decode_array({"b64": "!!!", "shape": [1]})


# -- the exposition against tpuic's -------------------------------------------
def test_router_exposition_matches_tpuic_on_one_snapshot(tmp_path):
    """``tpuic_router_*`` rows: the same text as ``tpuic``'s renderer on
    the same snapshot (counters, typed rejects, per-replica rows, the
    fleet digest), with and without a rollout state."""
    from tpuic.telemetry.prom import router_exposition as theirs
    from tpuic_torch.telemetry.prom import router_exposition as ours

    def answer(req):
        if req.get("path") == "late.png":
            return wire.error_record(req["id"], DeadlineExceeded(
                "deadline expired before service", priority="low"))
        return {"id": req["id"], "pred": "0", "prob": 1.0,
                "topk": [["0", 1.0]]}

    fakes = [FakeReplica(respond=answer), FakeReplica(respond=answer)]
    r = _router(tmp_path, fakes)
    try:
        for i in range(4):
            r.submit(line={"path": f"{i}.png"}, timeout=5).result(timeout=10)
        with pytest.raises(DeadlineExceeded):
            r.submit(line={"path": "late.png", "priority": "low"},
                     timeout=5).result(timeout=10)
        snap = r.snapshot()
        assert snap["rejected_by"] == {"deadline": {"low": 1}}
        rollout = {"phase": "canary", "stage_index": 1,
                   "stage_fraction": 0.5, "canary_errors": 0,
                   "objective": "serve_latency_p99", "burn_rate": 0.25,
                   "canary_window_samples": 12}
        assert ours(snap) == theirs(snap)
        assert ours(snap, rollout=rollout) == theirs(snap, rollout=rollout)
        assert "tpuic_router_replica_state" in ours(snap)
    finally:
        r.close(drain=False)
        for f in fakes:
            f.kill()


# -- real port replicas --------------------------------------------------------
REAL_SIZE = 32


def _real_cmd():
    return [sys.executable, "-m", "tpuic_torch.serve", "--device", "cpu",
            "--synthetic-init", "--model", "resnet18", "--num-classes",
            "10", "--resize", str(REAL_SIZE), "--buckets", "1,4",
            "--max-wait-ms", "2", "--listen", "127.0.0.1:0",
            "--prom-port", "-1"]


def test_real_replicas_answer_like_a_direct_forward_and_fail_over(
        tmp_path, monkeypatch):
    """Two ``python -m tpuic_torch.serve --synthetic-init --listen``
    replicas behind the router: every answer equals a direct forward of
    the port model with the same seeded weights within 1e-5, and a
    SIGKILL of one replica with requests in flight fails them over to the
    other with an exact ledger (no untyped error, no duplicate, nothing
    lost)."""
    import os
    import signal

    import numpy as np
    import torch

    from _torch_threads import TORCH_THREADS, subprocess_env
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.predict import serving_model_config
    from tpuic_torch.serve.engine import make_forward

    torch.set_num_threads(TORCH_THREADS)
    for k, v in subprocess_env().items():
        monkeypatch.setenv(k, v)
    r = Router(replica_cmd=_real_cmd(), n_replicas=2,
               state_dir=str(tmp_path / "state"), spawn_timeout_s=120.0,
               ping_interval_s=0.1, breaker_cooldown_s=0.3,
               max_respawns=0)
    try:
        r.start(timeout_s=120.0)
        assert all(rep.state == "up" for rep in r.replicas)
        model = init_params(create_model_from_config(
            serving_model_config("resnet18", 10), device="cpu",
            image_size=REAL_SIZE), 0, device="cpu").eval()
        rng = np.random.default_rng(0)
        x = rng.integers(0, 256, (24, REAL_SIZE, REAL_SIZE, 3), np.uint8)
        probs, _ = make_forward(model, normalize=True)(torch.from_numpy(x))
        probs = probs.numpy()

        def check(recs):
            for i, rec in recs:
                assert int(rec["pred"]) == int(probs[i].argmax()), i
                assert abs(rec["prob"] - float(probs[i].max())) < 1e-5, i

        futs = [(i, r.submit(x[i:i + 1], timeout=30)) for i in range(8)]
        check([(i, f.result(timeout=60)) for i, f in futs])
        assert {rec["replica"] for _, rec in
                [(i, f.result(timeout=60)) for i, f in futs]} == {"r0",
                                                                  "r1"}

        r.stats.reset()
        futs = [(i, r.submit(x[i:i + 1], timeout=30)) for i in range(8, 24)]
        victim = r.replicas[0]
        _wait(lambda: len(victim.inflight) > 0, msg="victim in flight")
        os.kill(victim.child.pid, signal.SIGKILL)
        recs = [(i, f.result(timeout=60)) for i, f in futs]
        check(recs)
        snap = r.stats.snapshot()
        assert snap["offered"] == 16 == snap["requests"] + snap["rejected"]
        assert snap["errors"] == 0 and snap["duplicates"] == 0
        assert snap["rejected"] == 0 and snap["failovers"] == 1
        assert snap["failover_requeued"] >= 1 and snap["failover_lost"] == 0
        replayed = [f for _, f in futs if getattr(f, "tpuic_retries", 0)]
        assert replayed and all(f.result(timeout=60)["replica"] == "r1"
                                for f in replayed)
    finally:
        r.close(drain=False)


def test_router_cli_with_http_front_end_over_a_real_replica(tmp_path):
    """``python -m tpuic_torch.serve.router`` over one real CPU replica:
    stdin request lines in, one record per line out, ``--http-port``'s
    ``/healthz`` and ``/predict`` while it runs, and the final ledger
    exact on stderr."""
    import re
    import urllib.request

    import numpy as np

    from _torch_threads import subprocess_env

    rng = np.random.default_rng(1)
    lines = [json.dumps({"id": f"q{i}", **wire.encode_array(
        rng.integers(0, 256, (1, REAL_SIZE, REAL_SIZE, 3), np.uint8))})
        for i in range(6)]
    err = tmp_path / "router.err"
    with open(err, "w") as ef:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuic_torch.serve.router",
             "--replicas", "1", "--state-dir", str(tmp_path / "state"),
             "--http-port", "-1", "--replica-cmd",
             " ".join(_real_cmd())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=ef,
            text=True, env=subprocess_env())
    try:
        def http_port():
            m = re.search(r"http front-end on 127\.0\.0\.1:(\d+)",
                          err.read_text())
            return int(m.group(1)) if m else None
        _wait(lambda: http_port() is not None, timeout=120,
              msg="http front-end up")
        base = f"http://127.0.0.1:{http_port()}"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["status"] == "ok"
        req = urllib.request.Request(base + "/predict",
                                     data=lines[0].encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200 and "pred" in json.loads(resp.read())
        out, _ = proc.communicate("\n".join(lines) + "\n", timeout=120)
    finally:
        if proc.poll() is None:
            # SIGTERM first: the router drains and stops its replicas (a
            # SIGKILL would leave them running).
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    assert proc.returncode == 0
    recs = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    assert sorted(r["id"] for r in recs) == [f"q{i}" for i in range(6)]
    assert all("pred" in r and r["replica"] == "r0" for r in recs)
    done = re.search(r"\[router\] done: (\{.*\})", err.read_text())
    snap = json.loads(done.group(1))
    assert snap["offered"] == 7 == snap["requests"]
    assert snap["errors"] == 0 and snap["rejected"] == 0
