"""Port parity: ``tpuic_torch.runtime.gang`` and ``python -m
tpuic_torch.supervise --gang`` against ``tpuic.runtime.gang``.

- ``rank_path``, ``committed_steps`` and ``fleet_resume_step`` against
  ``tpuic``'s on the same manifest dirs, and one shared dir (the port's
  process-0 writer) agreeing with itself.
- The gang scenarios of ``tests/test_gang.py`` (coordinated teardown with
  the survivor's flush window, poison, a gang-wide flush, the fleet-min
  crash-loop currency, the rank-attributed hang, poison during a hang's
  teardown, the shared eviction, the resume env, the rank identity, the
  command template, the CLI) over the port's ``GangSupervisor`` with stub
  children that speak the protocol through the port's
  ``HeartbeatWriter``; elastic membership is not ported (ROADMAP §1 item
  13) and its flags are refused by name.

The children import only ``tpuic_torch.runtime.supervisor`` (the
stdlib), so an attempt costs a bare interpreter start.  ``tpuic`` is
imported in fixtures.
"""

import json
import os
import signal
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest
import torch

from tpuic_torch.runtime.gang import (GangSupervisor, committed_steps,
                                      fleet_resume_step, rank_path)
from tpuic_torch.runtime.supervisor import (ENV_RESUME_STEP, EXIT_CRASH_LOOP,
                                            EXIT_POISON, EXIT_PREEMPTED,
                                            read_heartbeat)
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent

# The rank-aware child: the port's HeartbeatWriter on the heartbeat file
# the gang assigned, the rank from the fleet environment.
_CHILD_PRELUDE = textwrap.dedent("""\
    import os, signal, sys, time
    from tpuic_torch.runtime.supervisor import (EXIT_PREEMPTED, EXIT_POISON,
                                                HeartbeatWriter)
    hb = HeartbeatWriter(os.environ["TPUIC_HEARTBEAT_FILE"],
                         min_interval_s=0.0)
    attempt = int(os.environ.get("TPUIC_RESTART", "0"))
    rank = int(os.environ.get("TPUIC_FLEET_RANK", "0"))
    def beat(step):
        hb.last_step = step
        hb.beat()
    def flush_on_term():
        # The trainer's preemption flush: SIGTERM -> exit 43.
        signal.signal(signal.SIGTERM, lambda s, f: sys.exit(EXIT_PREEMPTED))
    def await_peers(n=2, timeout=30.0):
        # Every rank's heartbeat on disk before anyone dies, so that a
        # fast crash cannot race a slower peer out of its first beat.
        base = os.environ["TPUIC_HEARTBEAT_FILE"]
        stem = base.replace(".rank%d" % rank if rank else "", "")
        root, ext = os.path.splitext(stem)
        paths = [stem if k == 0 else "%s.rank%d%s" % (root, k, ext)
                 for k in range(n)]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(os.path.exists(p) for p in paths):
                return
            time.sleep(0.02)
""")


@pytest.fixture(scope="module")
def jg():
    from tpuic.runtime import gang
    return gang


def _child(tmp_path, body: str) -> list:
    path = os.path.join(str(tmp_path), "child.py")
    with open(path, "w") as f:
        f.write(_CHILD_PRELUDE + textwrap.dedent(body))
    return [sys.executable, path]


def _gang(tmp_path, cmd, ranks=2, **kw) -> GangSupervisor:
    kw.setdefault("watchdog_s", 30.0)
    kw.setdefault("startup_grace_s", 60.0)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("grace_s", 10.0)
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("backoff_max_s", 0.05)
    kw.setdefault("env", {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    kw.setdefault("log", lambda msg: None)
    return GangSupervisor(cmd, os.path.join(str(tmp_path), "state"),
                          ranks=ranks, **kw)


def _ledger(sup) -> list:
    with open(sup.ledger_file) as f:
        return [json.loads(ln) for ln in f]


def _write_manifest(d, track, step):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, track + ".manifest.json"), "w") as f:
        json.dump({"version": 1, "step": step, "files": {}}, f)


# -- the copied helpers ------------------------------------------------------
def test_rank_path_matches_tpuics_and_the_fleet_convention(jg):
    for path in ("/a/b/events.jsonl", "heartbeat.json", "/x/noext"):
        for rank in (0, 1, 7):
            assert rank_path(path, rank) == jg.rank_path(path, rank)


@pytest.mark.parametrize("case", [
    # (per-rank {track: step}, ...): the survivor's newer flush, no common
    # step, a rank with nothing, a .prev rung, an unreadable manifest.
    ({"latest": 9, "latest.prev": 6, "best": 6}, {"latest": 6}),
    ({"latest": 9, "best": 6}, {"latest": 5}),
    ({"latest": 4}, {}),
    ({"best.prev": 2, "latest": 7}, {"latest.prev": 2, "best": 3}),
    ({"latest": "x", "best": 5}, {"best": 5}),
], ids=["survivor-flush", "no-common", "empty-rank", "prev-rungs",
        "unreadable"])
def test_committed_steps_and_fleet_resume_step_match_tpuics(jg, tmp_path,
                                                            case):
    dirs = []
    for k, tracks in enumerate(case):
        d = str(tmp_path / f"cp{k}" / "m")
        os.makedirs(d, exist_ok=True)
        for track, step in tracks.items():
            _write_manifest(d, track, step)
        dirs.append(d)
    for d in dirs:
        assert committed_steps(d) == jg.committed_steps(d)
    assert fleet_resume_step(dirs) == jg.fleet_resume_step(dirs)
    assert fleet_resume_step([]) is jg.fleet_resume_step([]) is None


def test_a_shared_gang_ckpt_dir_is_every_rank_s(tmp_path):
    """The port's process 0 writes the one checkpoint dir every rank
    reads: ``--gang-ckpt`` without ``{rank}`` names it for each rank, and
    the fleet step is its newest commit."""
    d = str(tmp_path / "cp" / "resnet50")
    _write_manifest(d, "latest", 8)
    _write_manifest(d, "best", 4)
    sup = _gang(tmp_path, ["true"], ranks=3, ckpt_dirs=d)
    assert sup.ckpt_dirs == [d, d, d]
    assert fleet_resume_step(sup.ckpt_dirs) == 8
    sup = _gang(tmp_path, ["true"], ranks=2,
                ckpt_dirs=str(tmp_path / "cp{rank}" / "m"))
    assert sup.ckpt_dirs == [str(tmp_path / f"cp{k}" / "m") for k in (0, 1)]
    with pytest.raises(ValueError, match="3 entries for 2 ranks"):
        _gang(tmp_path, ["true"], ranks=2, ckpt_dirs=[d, d, d])


# -- the gang's lifecycle ----------------------------------------------------
def test_gang_all_ranks_done(tmp_path):
    sup = _gang(tmp_path, _child(tmp_path, """
        beat(3 + rank)
        sys.exit(0)
    """))
    assert sup.run() == 0
    assert sup.restarts == 0 and len(sup.attempts) == 1
    res = sup.attempts[0]
    assert res.codes == [0, 0] and res.outcome == "done"
    assert res.last_steps == [3, 4] and res.fleet_step == 3
    assert read_heartbeat(os.path.join(sup.state_dir,
                                       "heartbeat.json"))["step"] == 3
    assert read_heartbeat(os.path.join(sup.state_dir,
                                       "heartbeat.rank1.json"))["step"] == 4


def test_single_rank_crash_tears_down_gang_with_flush_window(tmp_path):
    """Rank 1 dying tears the whole gang down: the survivor gets its
    SIGTERM flush window (exit 43) and both ranks restart together."""
    sup = _gang(tmp_path, _child(tmp_path, """
        flush_on_term()
        if attempt == 0 and rank == 1:
            beat(2)
            await_peers()
            os._exit(1)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            beat(5 if attempt else 3)
            time.sleep(0.02)
            if attempt == 1:
                sys.exit(0)
    """))
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.crash_restarts == 1
    first = sup.attempts[0]
    assert first.outcome == "retryable"
    assert first.codes[1] == 1 and first.codes[0] == EXIT_PREEMPTED
    events = [r["event"] for r in _ledger(sup)]
    assert "teardown" in events and events.count("spawn") == 4
    td = [r for r in _ledger(sup) if r["event"] == "teardown"][0]
    assert td["why"] == "retryable" and td["rank"] == 1


def test_poison_from_any_rank_stops_the_gang(tmp_path):
    sup = _gang(tmp_path, _child(tmp_path, """
        flush_on_term()
        if rank == 1:
            beat(1)
            await_peers()
            sys.exit(EXIT_POISON)
        while True:
            beat(1)
            time.sleep(0.02)
    """))
    assert sup.run() == EXIT_POISON
    assert sup.restarts == 0 and len(sup.attempts) == 1
    res = sup.attempts[0]
    assert res.codes[1] == EXIT_POISON and res.codes[0] == EXIT_PREEMPTED
    assert _ledger(sup)[-1]["event"] == "giveup"


def test_gang_preemption_flush_restarts_free(tmp_path):
    """Every rank exiting 43 restarts at once and takes nothing of the
    retryable budget (0 here)."""
    sup = _gang(tmp_path, _child(tmp_path, """
        flush_on_term()
        if attempt == 0:
            beat(2)
            await_peers()
            if rank == 0:
                sys.exit(EXIT_PREEMPTED)
            while True:
                beat(2)
                time.sleep(0.02)
        beat(4)
        sys.exit(0)
    """), max_restarts=0)
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.crash_restarts == 0
    assert sup.attempts[0].outcome == "preempted"


def test_fleet_min_progress_one_healthy_rank_cannot_mask(tmp_path):
    sup = _gang(tmp_path, _child(tmp_path, """
        flush_on_term()
        beat(10 + attempt if rank == 0 else 1)
        await_peers()
        os._exit(1)
    """), crash_loop_k=2, max_restarts=10)
    assert sup.run() == EXIT_CRASH_LOOP
    assert len(sup.attempts) == 3 and sup.restarts == 2
    assert sup.best_steps == [12, 1] and sup.best_fleet_step == 1
    give = _ledger(sup)[-1]
    assert give["event"] == "giveup" and "crash loop" in give["reason"]


def test_fleet_min_progress_resets_streak(tmp_path):
    sup = _gang(tmp_path, _child(tmp_path, """
        flush_on_term()
        beat(10 * (attempt + 1) + rank)
        if attempt < 2:
            await_peers()
            os._exit(1)
        sys.exit(0)
    """), crash_loop_k=2, max_restarts=10)
    assert sup.run() == 0
    assert sup.restarts == 2 and sup.crash_restarts == 2
    assert sup.best_fleet_step == 30


def test_hang_is_rank_attributed_and_tears_down(tmp_path):
    sup = _gang(tmp_path, _child(tmp_path, """
        from tpuic_torch.runtime.supervisor import install_stack_dump_handler
        install_stack_dump_handler()
        flush_on_term()
        if rank == 1:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            beat(1)
            await_peers()
            while True:
                time.sleep(0.2)
        while True:
            beat(2)
            time.sleep(0.02)
    """), watchdog_s=0.6, quit_wait_s=1.5, grace_s=1.0, max_restarts=0)
    assert sup.run() == EXIT_CRASH_LOOP
    (res,) = sup.attempts
    assert res.hung_ranks == [1] and res.outcome == "retryable"
    assert res.codes[0] == EXIT_PREEMPTED
    hangs = [r for r in _ledger(sup) if r["event"] == "hang"]
    assert len(hangs) == 1 and hangs[0]["rank"] == 1
    dump = os.path.join(sup.state_dir, "stackdump-0.rank1.txt")
    with open(dump) as f:
        assert "File" in f.read()


def test_poison_during_hang_teardown_still_stops_the_gang(tmp_path):
    sup = _gang(tmp_path, _child(tmp_path, """
        if rank == 0:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            beat(1)
            await_peers()
            while True:
                time.sleep(0.2)
        signal.signal(signal.SIGTERM,
                      lambda s, f: sys.exit(EXIT_POISON))
        while True:
            beat(1)
            time.sleep(0.02)
    """), watchdog_s=0.6, quit_wait_s=1.0, grace_s=1.0, max_restarts=10)
    assert sup.run() == EXIT_POISON
    assert sup.restarts == 0 and len(sup.attempts) == 1
    (res,) = sup.attempts
    assert res.hung_ranks == [0] and res.outcome == "poison"
    assert res.codes[1] == EXIT_POISON


def test_gang_shutdown_shared_eviction(tmp_path):
    """SIGTERM to the gang supervisor forwards one flush-window TERM to
    every rank; both flush and the supervisor exits 43."""
    sup = _gang(tmp_path, _child(tmp_path, """
        flush_on_term()
        while True:
            beat(1)
            time.sleep(0.02)
    """))
    code = {}
    runner = threading.Thread(target=lambda: code.setdefault(
        "rc", sup.run()))
    runner.start()
    hbs = [os.path.join(sup.state_dir, "heartbeat.json"),
           os.path.join(sup.state_dir, "heartbeat.rank1.json")]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(
            read_heartbeat(p) is None for p in hbs):
        time.sleep(0.05)
    assert all(read_heartbeat(p) is not None for p in hbs)
    sup._on_signal(signal.SIGTERM, None)
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert code["rc"] == EXIT_PREEMPTED
    assert sup.attempts[0].codes == [EXIT_PREEMPTED, EXIT_PREEMPTED]


# -- the fleet-agreed resume -------------------------------------------------
def test_gang_restart_passes_fleet_resume_env(tmp_path):
    """On a restart the agreed step rides TPUIC_RESUME_STEP into every
    rank (the gang_resume ledger line records it); attempt 0 has none."""
    for k, steps in ((0, {"latest": 9, "best": 6}), (1, {"latest": 6})):
        for track, s in steps.items():
            _write_manifest(str(tmp_path / f"cp{k}" / "m"), track, s)
    sup = _gang(tmp_path, _child(tmp_path, """
        out = os.path.join(os.path.dirname(__file__),
                           f"env.{attempt}.{rank}")
        with open(out, "w") as f:
            f.write(os.environ.get("TPUIC_RESUME_STEP", "<unset>"))
        beat(6 + attempt)
        await_peers()   # both wrote theirs before either exits
        sys.exit(0 if attempt else 1)
    """), ckpt_dirs=str(tmp_path / "cp{rank}" / "m"))
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.last_resume_step == 6
    for rank in (0, 1):
        assert (tmp_path / f"env.0.{rank}").read_text() == "<unset>"
        assert (tmp_path / f"env.1.{rank}").read_text() == "6"
    resume = [r for r in _ledger(sup) if r["event"] == "gang_resume"]
    assert len(resume) == 1 and resume[0]["step"] == 6


def test_spawn_env_rank_identity_and_rendezvous(jg, tmp_path):
    """``TPUIC_FLEET_RANK(S)`` always; the trio only with a coordinator;
    the same environment as ``tpuic``'s gang on the same arguments."""
    sup = _gang(tmp_path, ["true"], ranks=3)
    env = sup._spawn_env(2, 1, 0.0, resume_step=None)
    assert env["TPUIC_FLEET_RANK"] == "1"
    assert env["TPUIC_FLEET_RANKS"] == "3"
    assert env["TPUIC_RESTART"] == "2"
    assert "TPUIC_COORDINATOR_ADDRESS" not in env
    assert "TPUIC_PROCESS_ID" not in env
    assert ENV_RESUME_STEP not in env
    sup2 = _gang(tmp_path, ["true"], ranks=3, coordinator="host:1234",
                 chaos=["rank_crash@6#1"])
    env2 = sup2._spawn_env(0, 2, 0.0, resume_step=7)
    assert env2["TPUIC_COORDINATOR_ADDRESS"] == "host:1234"
    assert env2["TPUIC_NUM_PROCESSES"] == "3"
    assert env2["TPUIC_PROCESS_ID"] == "2"
    assert env2[ENV_RESUME_STEP] == "7"
    assert env2["TPUIC_FAULTS"] == "rank_crash@6#1"
    theirs = jg.GangSupervisor(["true"], os.path.join(str(tmp_path), "j"),
                               ranks=3, coordinator="host:1234",
                               chaos=["rank_crash@6#1"],
                               env={"PYTHONPATH": str(ROOT),
                                    "OMP_NUM_THREADS": "1"})
    assert theirs._spawn_env(0, 2, 0.0, resume_step=7) == env2


def test_rank_cmd_template_substitution(tmp_path):
    sup = _gang(tmp_path, ["python", "train.py", "--ckpt-dir",
                           "/w/cp{rank}"], ranks=2)
    assert sup._rank_cmd(0)[-1] == "/w/cp0"
    assert sup._rank_cmd(1)[-1] == "/w/cp1"


# -- the supervise CLI -------------------------------------------------------
def test_supervise_cli_gang_end_to_end(tmp_path):
    """``--gang N`` through the CLI: ``{rank}`` reaches the children, and
    a clean gang exits 0."""
    from tpuic_torch.supervise import main
    marker = os.path.join(str(tmp_path), "rank{rank}.txt")
    rc = main(["--state-dir", str(tmp_path / "state"), "--gang", "2",
               "--startup-grace-s", "60", "--poll-s", "0.05", "--",
               sys.executable, "-c",
               f"open(r'{marker}'.replace('{{rank}}', "
               "__import__('os').environ['TPUIC_FLEET_RANK']), 'w')"
               ".write('ok')"])
    assert rc == 0
    assert (tmp_path / "rank0.txt").exists()
    assert (tmp_path / "rank1.txt").exists()


@pytest.mark.parametrize("flag", [["--elastic"], ["--min-ranks", "2"],
                                  ["--max-respawns", "3"]],
                         ids=lambda f: f[0])
def test_supervise_cli_refuses_elastic_membership_by_name(flag):
    from tpuic_torch import supervise
    with pytest.raises(SystemExit, match=f"{flag[0]}: elastic membership "
                       "is not yet ported.*item 13"):
        supervise.main(["--gang", "2"] + flag + ["--", sys.executable, "-c",
                                                 "pass"])
