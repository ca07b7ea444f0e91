"""Port parity: ``tpuic_torch.telemetry.fleet`` and
``tpuic_torch.telemetry.flight`` against ``tpuic``'s.

- The same per-rank JSONL streams (a straggler rank, warmup steps, a
  partial step, restart duplicates) load into the same streams, and
  ``aggregate`` and ``summary_lines`` agree; so do ``membership_timeline``
  over a gang ledger, ``score_audit`` over a scoring ledger (exact and
  tampered), ``tag_bus_with_rank``'s sources and errors, and the CLI's
  output and exit codes (``--require-ranks``, ``--expect-straggler``,
  ``--membership``, ``--score-ledger``).
- The flight recorder's ring, its dump and its trailer are the same
  records in both packages (dump time and pid aside).
- The aggregator reads the rank streams the port's ``TrainTelemetry``
  writes (rank k of n: ``<stem>.rank<k>.jsonl``, every event tagged).

``tpuic``'s modules are imported inside fixtures.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from tpuic_torch.telemetry import events as pev
from tpuic_torch.telemetry import fleet as pfl
from tpuic_torch.telemetry import flight as pflight
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jt():
    from tpuic.telemetry import events as jev
    from tpuic.telemetry import fleet as jfl
    from tpuic.telemetry import flight as jflight
    return types.SimpleNamespace(ev=jev, fl=jfl, flight=jflight)


def _step(rank, step, total, **kw):
    return {"event": "step", "step": step, "total_ms": total,
            "data_ms": kw.get("data", 1.0), "dispatch_ms": 0.5,
            "device_ms": total - 1.5, "rank": rank, "ranks": 3}


def _write_fleet(d: Path) -> None:
    """Three ranks; rank 2 is slow; rank 1 misses step 9; rank 0 replays
    steps 3-4 after a restart; plus a record torn mid-line."""
    d.mkdir(parents=True, exist_ok=True)
    streams = {0: [], 1: [], 2: []}
    for s in range(1, 10):
        for r in range(3):
            if r == 1 and s == 9:
                continue
            total = 10.0 + s * 0.1 + (4.0 if r == 2 else 0.0) + 0.5 * r
            streams[r].append(_step(r, s, total))
    streams[0] += [_step(0, 3, 11.0), _step(0, 4, 12.0)]
    streams[1].append({"event": "eval", "epoch": 0, "rank": 1})
    for r, recs in streams.items():
        name = "events.jsonl" if r == 0 else f"events.rank{r}.jsonl"
        with open(d / name, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
            if r == 2:
                f.write('{"event": "step", "st')  # torn by a SIGKILL


@pytest.mark.parametrize("warmup", [0, 2, 20])
def test_aggregate_and_summary_lines_agree(jt, tmp_path, warmup):
    _write_fleet(tmp_path)
    mine = pfl.load_streams([str(tmp_path)])
    theirs = jt.fl.load_streams([str(tmp_path)])
    assert mine == theirs
    rep = pfl.aggregate(mine, warmup=warmup)
    assert rep == jt.fl.aggregate(theirs, warmup=warmup)
    assert pfl.summary_lines(rep) == jt.fl.summary_lines(rep)
    if warmup == 0:
        assert rep["straggler"]["rank"] == 2
        assert rep["duplicate_steps"] == {"0": 2}


def test_single_rank_and_untagged_streams_agree(jt, tmp_path):
    p = tmp_path / "solo.jsonl"
    p.write_text("".join(json.dumps({"event": "step", "step": s,
                                     "total_ms": 5.0 + s}) + "\n"
                         for s in range(4)))
    mine = pfl.load_streams([str(p)])
    assert mine == jt.fl.load_streams([str(p)]) and list(mine) == [0]
    rep = pfl.aggregate(mine)
    assert rep == jt.fl.aggregate(mine) and rep["straggler"] is None
    assert pfl.summary_lines(rep) == jt.fl.summary_lines(rep)


def _gang_ledger(path: Path) -> None:
    recs = [{"event": "spawn", "rank": r, "t": 1.0} for r in range(3)]
    recs += [{"event": "membership", "version": 1, "reason": "init",
              "active": [0, 1, 2], "t": 1.0},
             {"event": "membership", "version": 2, "reason": "degrade",
              "active": [0, 2], "rank": 1, "resume_step": 40, "t": 2.0},
             {"event": "respawn", "rank": 3, "t": 3.0},
             {"event": "membership", "version": 3, "reason": "rejoin",
              "active": [0, 2, 3], "rank": 3, "resume_step": 60, "t": 4.0}]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def test_membership_timeline_agrees(jt, tmp_path):
    _gang_ledger(tmp_path / "ledger.jsonl")
    p = str(tmp_path / "ledger.jsonl")
    mine = pfl.membership_timeline(p)
    assert mine == jt.fl.membership_timeline(p)
    assert mine["ever_ranks"] == [0, 1, 2, 3]


def _score_streams(tamper: str = ""):
    plan = {"event": "score_plan", "n": 10, "shards": 3, "shard_size": 4,
            "corpus_token": "abc", "shard_table": [[0, 4], [4, 8],
                                                   [8, 10]],
            "dtype": "int8"}
    commits = [{"event": "score_commit", "shard": s, "scored": hi - lo,
                "quarantined": 0, "lo": lo, "hi": hi}
               for s, (lo, hi) in enumerate(plan["shard_table"])]
    commits[1] = dict(commits[1], scored=3, quarantined=1)
    if tamper == "drop":
        commits.pop(2)
    elif tamper == "dup":
        commits.append(dict(commits[0]))
    elif tamper == "count":
        commits[0] = dict(commits[0], scored=2)
    return {0: [plan, commits[0], {"event": "score_duplicate",
                                   "shard": 0}],
            1: [dict(plan)] + commits[1:]}


@pytest.mark.parametrize("tamper", ["", "drop", "dup", "count"])
def test_score_audit_agrees(jt, tamper):
    streams = _score_streams(tamper)
    mine = pfl.score_audit(streams)
    assert mine == jt.fl.score_audit(streams)
    assert mine["ok"] is (tamper == "")
    assert pfl.score_summary_lines(mine) == jt.fl.score_summary_lines(mine)


def test_tag_bus_with_rank_sources_agree(jt, monkeypatch):
    for mod, ev in ((pfl, pev), (jt.fl, jt.ev)):
        bus = ev.EventBus()
        monkeypatch.delenv("TPUIC_FLEET_RANK", raising=False)
        monkeypatch.delenv("TPUIC_FLEET_RANKS", raising=False)
        assert mod.tag_bus_with_rank(bus) == (0, 1)
        assert bus.rank_tag is None
        monkeypatch.setenv("TPUIC_FLEET_RANK", "2")
        monkeypatch.setenv("TPUIC_FLEET_RANKS", "4")
        assert mod.tag_bus_with_rank(bus) == (2, 4)
        assert bus.rank_tag == {"rank": 2, "ranks": 4}
        assert mod.tag_bus_with_rank(bus, rank=1, ranks=3) == (1, 3)
        monkeypatch.delenv("TPUIC_FLEET_RANKS")
        with pytest.raises(ValueError, match="half-set"):
            mod.tag_bus_with_rank(bus)
        with pytest.raises(ValueError, match="both rank and ranks"):
            mod.tag_bus_with_rank(bus, rank=2)
    for r in (0, 1, 3):
        for p in ("a/events.jsonl", "noext", "x.y/ev.log"):
            assert pfl.rank_stream_path(p, r) == jt.fl.rank_stream_path(p, r)


def _fleet_cli(module: str, *args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=subprocess_env(PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args", [
    [], ["--warmup", "2"], ["--require-ranks", "3"],
    ["--require-ranks", "4"], ["--expect-straggler", "2"],
    ["--expect-straggler", "0"], ["--membership", "LEDGER"],
    ["--score-ledger"]], ids=lambda a: " ".join(a) or "plain")
def test_cli_output_and_exit_codes_agree(tmp_path, args):
    _write_fleet(tmp_path / "fleet")
    _gang_ledger(tmp_path / "ledger.jsonl")
    argv = [str(tmp_path / "fleet")] + [
        str(tmp_path / "ledger.jsonl") if a == "LEDGER" else a
        for a in args]
    mine = _fleet_cli("tpuic_torch.telemetry.fleet", *argv)
    theirs = _fleet_cli("tpuic.telemetry.fleet", *argv)
    assert mine.returncode == theirs.returncode
    assert mine.stdout == theirs.stdout
    assert mine.stderr == theirs.stderr


def test_cli_score_prom_dump_equals_tpuics(tmp_path):
    """``--score-ledger --prom-dump`` writes ``tpuic``'s exposition byte
    for byte, with the same stdout, stderr and exit code, over a clean
    ledger and a tampered one."""
    _write_fleet(tmp_path / "fleet")
    clean = tmp_path / "score"
    clean.mkdir()
    plan = {"event": "score_plan", "n": 10, "shards": 2, "shard_size": 5,
            "corpus_token": 1, "dtype": "int8",
            "shard_table": [[0, 5], [5, 10]]}
    commits = [{"event": "score_commit", "shard": s, "scored": 5 - s,
                "quarantined": s, "recovered": bool(s)} for s in (0, 1)]
    (clean / "ledger.jsonl").write_text("".join(
        json.dumps(r) + "\n" for r in [plan, commits[0]]))
    (clean / "ledger.rank1.jsonl").write_text("".join(
        json.dumps(dict(r, rank=1, ranks=2)) + "\n"
        for r in [plan, commits[1], {"event": "score_duplicate",
                                     "shard": 0}]))
    tampered = tmp_path / "tampered"
    tampered.mkdir()
    (tampered / "ledger.jsonl").write_text("".join(
        json.dumps(r) + "\n" for r in [plan] + commits + commits[:1]))
    got = {}
    for d in (clean, tampered, tmp_path / "fleet"):
        outs = []
        for mod in ("tpuic_torch.telemetry.fleet", "tpuic.telemetry.fleet"):
            prom = tmp_path / f"{d.name}-{mod.split('.')[0]}.prom"
            cli = _fleet_cli(mod, str(d), "--score-ledger", "--prom-dump",
                             str(prom))
            outs.append((cli.returncode, cli.stdout.replace(str(prom), "P"),
                         cli.stderr, prom.read_text()))
        assert outs[0] == outs[1]
        got[d.name] = outs[0]
    assert got["score"][0] == 0 and got["tampered"][0] == 1
    assert "tpuic_score_ledger_exact 1" in got["score"][3]
    assert "tpuic_score_recovered_records 1" in got["score"][3]
    assert "tpuic_score_shards_duplicated 1" in got["tampered"][3]


# -- the flight recorder -------------------------------------------------------
def _recorded(mod, evmod, path):
    bus = evmod.EventBus()
    rec = mod.FlightRecorder(str(path), capacity=4)
    rec.subscribe(bus)
    for i in range(6):
        bus.publish("serve_batch", bucket=8, requests=i)
        bus.publish("serve_span", trace=i)  # excluded from the ring
    bus.publish("admission", action="tighten", level=1)
    assert len(rec) == 4
    assert rec.dump(reason="manual") == str(path)
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    return [{k: v for k, v in r.items() if k not in ("t", "pid")}
            for r in recs]


def test_flight_dump_and_trailer_agree(jt, tmp_path):
    mine = _recorded(pflight, pev, tmp_path / "port.jsonl")
    theirs = _recorded(jt.flight, jt.ev, tmp_path / "tpuic.jsonl")
    assert mine == theirs
    assert mine[-1] == {"event": "flight_dump", "reason": "manual",
                        "events": 4}
    assert [r["event"] for r in mine[:-1]] == ["serve_batch"] * 3 + [
        "admission"]


def test_install_flight_recorder_is_a_noop_unsupervised(monkeypatch):
    monkeypatch.delenv("TPUIC_FLIGHT_DUMP", raising=False)
    assert pflight.install_flight_recorder() is None


# -- the port's own rank streams -----------------------------------------------
def test_aggregator_reads_train_telemetry_rank_streams(tmp_path,
                                                       monkeypatch):
    """Two ranks' ``TrainTelemetry`` (as the train CLI's processes build
    them) write ``events.jsonl`` and ``events.rank1.jsonl`` with every
    event tagged; the aggregator merges them and names the slow rank."""
    from tpuic_torch.config import RunConfig
    from tpuic_torch.telemetry.wiring import TrainTelemetry
    monkeypatch.delenv("TPUIC_HEARTBEAT_FILE", raising=False)
    path = str(tmp_path / "events.jsonl")
    for rank in (0, 1):
        tm = TrainTelemetry(RunConfig(metrics_jsonl=path), rank=rank,
                            n_devices=2)
        try:
            for s in range(1, 6):
                pev.bus.publish("step", step=s,
                                total_ms=10.0 + 3.0 * rank + s,
                                data_ms=1.0, dispatch_ms=0.5, device_ms=8.0)
        finally:
            tm.close()
    pev.bus.rank_tag = None
    assert sorted(os.listdir(tmp_path)) == ["events.jsonl",
                                            "events.rank1.jsonl"]
    streams = pfl.load_streams([str(tmp_path)])
    assert sorted(streams) == [0, 1]
    assert all(r.get("ranks") == 2 for rs in streams.values() for r in rs)
    rep = pfl.aggregate(streams)
    assert rep["steps_common"] == 5 and rep["straggler"]["rank"] == 1
