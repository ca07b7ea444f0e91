"""Port parity: ``tpuic_torch.runtime.supervisor`` and ``python -m
tpuic_torch.supervise`` against ``tpuic``'s.

- ``classify_exit`` gives the same outcome on a table of return codes.
- A heartbeat file that one package writes, the other's ``read_heartbeat``
  reads, and ``restart_info`` reads the same environment alike.
- The supervision loop's cases of ``tests/test_supervisor.py`` (restart,
  poison, preemption flush, crash loop, budget, shutdown, the watchdog's
  SIGQUIT -> SIGTERM -> SIGKILL ladder with its stack dump) on a tiny
  Python child that speaks the protocol through the port's
  ``HeartbeatWriter``; the ladder also leaves the flight recorder's dump.
- The CLI: a child supervised to a clean exit; ``tpuic``'s elastic
  flags refused by name.
- ``TrainTelemetry`` writes the heartbeat from the bus when the
  supervisor set its file.

The children import only ``tpuic_torch.runtime.supervisor`` and
``tpuic_torch.telemetry`` (stdlib modules), so an attempt costs a bare
interpreter start.  ``tpuic`` is imported inside fixtures.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from tpuic_torch.runtime.supervisor import (EXIT_CRASH_LOOP, EXIT_OK,
                                            EXIT_POISON, EXIT_PREEMPTED,
                                            HeartbeatWriter, Supervisor,
                                            classify_exit, read_heartbeat,
                                            restart_info)
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent

_CHILD_PRELUDE = textwrap.dedent("""\
    import os, signal, sys, time
    from tpuic_torch.runtime.supervisor import (EXIT_PREEMPTED, EXIT_POISON,
                                                HeartbeatWriter,
                                                install_stack_dump_handler)
    hb = HeartbeatWriter(os.environ["TPUIC_HEARTBEAT_FILE"],
                         min_interval_s=0.0)
    attempt = int(os.environ.get("TPUIC_RESTART", "0"))
    def beat(step):
        hb.last_step = step
        hb.beat()
""")


@pytest.fixture(scope="module")
def js():
    from tpuic.runtime import supervisor
    return supervisor


def _child(tmp_path, body: str) -> list:
    path = os.path.join(str(tmp_path), "child.py")
    with open(path, "w") as f:
        f.write(_CHILD_PRELUDE + textwrap.dedent(body))
    return [sys.executable, path]


def _sup(tmp_path, cmd, **kw) -> Supervisor:
    kw.setdefault("watchdog_s", 30.0)
    kw.setdefault("startup_grace_s", 60.0)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("backoff_max_s", 0.05)
    kw.setdefault("env", {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    kw.setdefault("log", lambda msg: None)
    return Supervisor(cmd, os.path.join(str(tmp_path), "state"), **kw)


def _ledger(sup) -> list:
    with open(os.path.join(sup.state_dir, "ledger.jsonl")) as f:
        return [json.loads(ln) for ln in f]


# -- the protocol, against tpuic's ---------------------------------------------
@pytest.mark.parametrize("rc", [0, 1, 2, 7, 43, 44, 45, 46, 77, 137, -9,
                                -11, -15])
@pytest.mark.parametrize("shutting_down", [False, True])
def test_classify_exit_matches_tpuic(js, rc, shutting_down):
    assert classify_exit(rc, shutting_down) == \
        js.classify_exit(rc, shutting_down)


def test_exit_codes_and_env_names_are_tpuics(js):
    from tpuic_torch.runtime import supervisor as ps
    for name in ("EXIT_OK", "EXIT_PREEMPTED", "EXIT_POISON",
                 "EXIT_CRASH_LOOP", "EXIT_BELOW_MIN", "ENV_HEARTBEAT_FILE",
                 "ENV_HEARTBEAT_INTERVAL", "ENV_STACK_DUMP",
                 "ENV_FLIGHT_DUMP", "ENV_RESTART", "ENV_DOWN_SINCE",
                 "ENV_RESUME_STEP", "RETRYABLE", "PREEMPTED", "POISON",
                 "DONE"):
        assert getattr(ps, name) == getattr(js, name), name


@pytest.mark.parametrize("writer", ["port", "tpuic"])
def test_heartbeat_reads_across_packages(js, tmp_path, writer):
    path = str(tmp_path / "hb.json")
    cls = HeartbeatWriter if writer == "port" else js.HeartbeatWriter
    hb = cls(path, min_interval_s=0.0)
    for step in (7, 8, 9):
        hb(types.SimpleNamespace(kind="step", data={"step": step}))
    hb(types.SimpleNamespace(kind="checkpoint_commit", data={"step": 9}))
    mine = read_heartbeat(path)
    theirs = js.read_heartbeat(path)
    assert mine == theirs
    assert (mine["step"], mine["first_step"], mine["beats"]) == (9, 7, 4)
    assert mine["pid"] == os.getpid()


def test_restart_info_reads_the_same_environment(js, monkeypatch):
    for count, since in (("0", None), ("2", repr(time.time() - 5.0)),
                         ("junk", None), ("3", "junk")):
        monkeypatch.setenv("TPUIC_RESTART", count)
        if since is None:
            monkeypatch.delenv("TPUIC_DOWN_SINCE", raising=False)
        else:
            monkeypatch.setenv("TPUIC_DOWN_SINCE", since)
        mine, theirs = restart_info(), js.restart_info()
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine[0] == theirs[0]
            assert abs(mine[1] - theirs[1]) < 1.0


def test_heartbeat_throttle_echo_and_commit_bypass(tmp_path):
    path = str(tmp_path / "hb.json")
    beats = []
    hb = HeartbeatWriter(path, min_interval_s=60.0,
                         publish=lambda kind, **d: beats.append((kind, d)))
    hb(types.SimpleNamespace(kind="heartbeat", data={"step": 1}))
    assert hb.beats == 0 and read_heartbeat(path) is None
    hb(types.SimpleNamespace(kind="step", data={"step": 7}))
    hb(types.SimpleNamespace(kind="step", data={"step": 8}))  # throttled
    assert read_heartbeat(path)["step"] == 7
    hb(types.SimpleNamespace(kind="checkpoint_commit", data={"step": 8}))
    assert read_heartbeat(path)["step"] == 8
    assert beats == [("heartbeat", {"step": 7, "beats": 1}),
                     ("heartbeat", {"step": 8, "beats": 2})]


# -- the supervision loop (tests/test_supervisor.py's cases) -------------------
def test_clean_exit_no_restart(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        beat(3)
        sys.exit(0)
    """))
    assert sup.run() == 0
    assert sup.restarts == 0 and len(sup.attempts) == 1
    assert sup.best_step == 3 and not sup.attempts[0].hung


def test_retryable_crash_restarts_and_tracks_progress(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        if attempt == 0:
            beat(3)
            os._exit(1)
        beat(4)
        sys.exit(0)
    """))
    assert sup.run() == 0
    assert sup.restarts == 1 and len(sup.attempts) == 2
    assert sup.attempts[0].returncode == 1 and sup.best_step == 4
    assert sup.violations == 0
    events = [r["event"] for r in _ledger(sup)]
    assert events.count("spawn") == 2 and events[-1] == "done"


def test_poison_exit_is_not_restarted(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        beat(1)
        sys.exit(EXIT_POISON)
    """))
    assert sup.run() == EXIT_POISON
    assert sup.restarts == 0 and len(sup.attempts) == 1


def test_preemption_flush_restarts_with_resume(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        if attempt == 0:
            beat(2)
            sys.exit(EXIT_PREEMPTED)
        beat(4)
        sys.exit(0)
    """))
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.attempts[0].returncode == EXIT_PREEMPTED
    assert sup.best_step == 4


def test_crash_loop_gives_up_with_diagnosis(tmp_path):
    sup = _sup(tmp_path, [sys.executable, "-c", "import sys; sys.exit(7)"],
               crash_loop_k=2, max_restarts=10)
    assert sup.run() == EXIT_CRASH_LOOP
    assert sup.restarts == 1 and len(sup.attempts) == 2
    last = _ledger(sup)[-1]
    assert last["event"] == "giveup" and "crash loop" in last["reason"]


def test_preemption_flushes_do_not_consume_restart_budget(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        if attempt < 3:
            beat(attempt + 1)
            sys.exit(EXIT_PREEMPTED)
        beat(4)
        sys.exit(0)
    """), max_restarts=1)
    assert sup.run() == 0
    assert sup.restarts == 3 and sup.crash_restarts == 0
    assert sup.best_step == 4


def test_progressing_flush_resets_crash_loop_counter(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        if attempt in (0, 2):
            os._exit(1)
        if attempt in (1, 3):
            beat(attempt * 10)
            sys.exit(EXIT_PREEMPTED)
        beat(100)
        sys.exit(0)
    """), crash_loop_k=2)
    assert sup.run() == 0
    assert sup.crash_restarts == 2 and sup.restarts == 4


def test_no_progress_preemption_loop_trips_crash_loop(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        hb.beat()
        sys.exit(EXIT_PREEMPTED)
    """), crash_loop_k=2)
    assert sup.run() == EXIT_CRASH_LOOP
    assert sup.crash_restarts == 0 and sup.restarts == 1
    assert len(sup.attempts) == 2


def test_shutdown_signal_death_exit_code_stays_in_range(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        beat(1)
        time.sleep(60)
    """), grace_s=0.5)
    code = {}
    runner = threading.Thread(target=lambda: code.update(rc=sup.run()))
    runner.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            read_heartbeat(sup.heartbeat_file) is None:
        time.sleep(0.05)
    assert read_heartbeat(sup.heartbeat_file) is not None
    sup._on_signal(signal.SIGTERM, None)
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert code["rc"] == 128 + signal.SIGKILL


def test_restart_budget_bounds_even_with_progress(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        beat(attempt + 1)
        os._exit(1)
    """), max_restarts=2, crash_loop_k=10)
    assert sup.run() == EXIT_CRASH_LOOP
    assert len(sup.attempts) == 3


def test_hang_watchdog_escalates_with_stack_and_flight_dumps(tmp_path):
    """No heartbeat change past the watchdog window: SIGQUIT (the child's
    faulthandler stack dump chained after the flight recorder's dump),
    then SIGTERM, then SIGKILL for a child that ignores SIGTERM.  Both
    per-attempt artifacts are on disk: the stacks, and the bus events
    that led in with the flight dump's trailer last."""
    sup = _sup(tmp_path, _child(tmp_path, """
        from tpuic_torch.telemetry.events import bus
        from tpuic_torch.telemetry.flight import install_flight_recorder
        rec = install_flight_recorder()
        install_stack_dump_handler(chain=rec is not None)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        for i in range(3):
            bus.publish("serve_batch", bucket=8, requests=i + 1)
        bus.publish("serve_span", trace=1)  # the ring leaves spans out
        beat(1)
        while True:
            time.sleep(0.2)
    """), watchdog_s=0.6, quit_wait_s=1.5, grace_s=0.5, max_restarts=0)
    assert sup.run() == EXIT_CRASH_LOOP
    (attempt,) = sup.attempts
    assert attempt.hung and attempt.last_step == 1
    body = open(os.path.join(sup.state_dir, "stackdump-0.txt")).read()
    assert "File" in body
    with open(os.path.join(sup.state_dir, "flightdump-0.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["event"] for r in recs] == ["serve_batch"] * 3 + [
        "flight_dump"]
    assert recs[-1]["reason"] == "sigquit" and recs[-1]["events"] == 3
    hang = [r for r in _ledger(sup) if r["event"] == "hang"]
    assert hang and hang[0]["flight_dump"].endswith("flightdump-0.jsonl")


def test_stepless_healthy_lives_do_not_accumulate_crash_loop(tmp_path):
    sup = _sup(tmp_path, _child(tmp_path, """
        if attempt < 3:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 0.9:
                hb.beat()
                time.sleep(0.05)
            os._exit(1)
        sys.exit(0)
    """), watchdog_s=0.3, startup_grace_s=0.3, crash_loop_k=2,
               max_restarts=10)
    assert sup.run() == 0
    assert sup.restarts == 3 and sup.violations == 0


def test_ledger_records_match_tpuics_for_one_child(js, tmp_path):
    """The same child under each package's supervisor writes a ledger of
    the same records (times and pids aside)."""
    body = """
        if attempt == 0:
            beat(2)
            os._exit(3)
        beat(3)
        sys.exit(0)
    """
    got = {}
    for name, cls in (("port", Supervisor), ("tpuic", js.Supervisor)):
        d = tmp_path / name
        d.mkdir()
        sup = cls(_child(d, body), str(d / "state"), watchdog_s=30.0,
                  startup_grace_s=60.0, poll_s=0.05, backoff_s=0.01,
                  backoff_max_s=0.05, log=lambda m: None,
                  env={"PYTHONPATH": str(ROOT)})
        assert sup.run() == 0
        with open(d / "state" / "ledger.jsonl") as f:
            got[name] = [{k: v for k, v in json.loads(ln).items()
                          if k not in ("t", "pid", "duration_s")}
                         for ln in f]
    assert got["port"] == got["tpuic"]


# -- the CLI ---------------------------------------------------------------------
def test_supervise_cli_runs_a_child_to_a_clean_exit(tmp_path):
    child = _child(tmp_path, """
        beat(5)
        sys.exit(0)
    """)
    state = tmp_path / "state"
    out = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.supervise", "--state-dir",
         str(state), "--poll-s", "0.05", "--", *child], cwd=ROOT,
        env=subprocess_env(PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "child exited cleanly" in out.stderr
    assert read_heartbeat(str(state / "heartbeat.json"))["step"] == 5


@pytest.mark.parametrize("flag", [
    ["--elastic"], ["--min-ranks", "2"], ["--max-respawns", "3"],
    ["--elastic", "--gang", "2"], ["--min-ranks", "2", "--gang-ckpt",
                                   "/w/cp{rank}"],
    ["--max-respawns", "3", "--coordinator", "localhost:1234"]],
    ids=lambda f: " ".join(f[::2]))
def test_supervise_cli_refuses_the_gang_flags_by_name(flag):
    """The gang supervisor is ported (``--gang``, ``--gang-ckpt``,
    ``--coordinator``: ``tests/test_torch_port_gang.py``); elastic
    membership is not, and its flags are refused by name, beside the
    gang's flags or alone."""
    from tpuic_torch import supervise
    with pytest.raises(SystemExit, match=f"{flag[0]}: elastic membership "
                       "is not yet ported.*item 13"):
        supervise.main(flag + ["--", sys.executable, "-c", "pass"])


def test_supervise_cli_takes_every_tpuic_flag(js):
    """Every flag of ``python -m tpuic.supervise`` parses in the port's
    CLI (the elastic ones to be refused)."""
    import tpuic.supervise as jsup

    from tpuic_torch import supervise
    mine = {a.dest for a in supervise.build_parser()._actions}
    theirs = {a.dest for a in jsup.build_parser()._actions}
    assert theirs <= mine


def test_train_telemetry_writes_the_heartbeat(tmp_path, monkeypatch):
    from tpuic_torch.config import RunConfig
    from tpuic_torch.telemetry.events import bus
    from tpuic_torch.telemetry.wiring import TrainTelemetry
    path = tmp_path / "hb.json"
    monkeypatch.setenv("TPUIC_HEARTBEAT_FILE", str(path))
    monkeypatch.setenv("TPUIC_HEARTBEAT_INTERVAL_S", "0")
    tm = TrainTelemetry(RunConfig())
    try:
        assert tm.heartbeat is not None
        bus.publish("step", step=3, total_ms=1.0)
        bus.publish("step", step=4, total_ms=1.0)
        hb = read_heartbeat(str(path))
        assert hb["step"] == 4 and hb["first_step"] == 3
    finally:
        tm.close()
    monkeypatch.delenv("TPUIC_HEARTBEAT_FILE")
    tm = TrainTelemetry(RunConfig())
    try:
        assert tm.heartbeat is None
    finally:
        tm.close()
