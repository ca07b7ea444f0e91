"""The port's elastic bulk scorer (``tpuic_torch.score``) through
``tpuic``'s cases (``tests/test_score.py``): leases, exactly-once
commits, resume, quarantine accounting and the fleet ledger audit, with
a torch stub forward where ``tpuic``'s use a jax one.

Beside them:

- parity: ``tpuic``'s ``run_score`` with a jax stub and the port's with a
  torch stub on one synthetic corpus give the same ``plan.json`` and
  byte-identical result files.  The stub's probabilities are multiples of
  1/8 computed from the integer pixel sum, exact in float32 in both
  frameworks, so the %.6f strings cannot round apart;
- a real model: resnet18-cifar at 32 px with ``tpuic``'s variables,
  scored from a port checkpoint through the CLI's loading path: ``pred``
  is ``tpuic``'s argmax and ``prob`` within 1e-5 of its softmax, with the
  plain K3 on every convolution;
- the CLI end to end on the CPU (with ``--prom-dump``), each score fault
  point fired through it, and two worker processes with
  ``scorer_crash@1#1`` and a replacement, audited exact and bitwise equal
  to one worker.

Every subprocess and every poll has a timeout of its own.  JAX and
``tpuic`` are imported inside fixtures and tests.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuic_torch.runtime import faults
from tpuic_torch.score.commit import ShardStore, result_line
from tpuic_torch.score.work import (LeaseDir, corpus_token, plan_shards,
                                    write_or_verify_plan)
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
CLASSES = ("a", "b", "c")
PROC_TIMEOUT = 240.0   # one CPU scoring process, start to exit
POLL_TIMEOUT = 120.0   # a wait for a file another process writes


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _exact_probs(s, arange):
    """Three probabilities per row, each (k + 1) / 8 for k = (s + c) mod 3:
    exact in float32 and distinct, so the class order is unambiguous."""
    return (((s[:, None] + arange[None, :]) % 3) + 1) / 8.0


def torch_stub(images):
    s = images.to(torch.int64).sum(dim=(1, 2, 3))
    probs = _exact_probs(s, torch.arange(3)).to(torch.float32)
    return probs, torch.argsort(-probs, dim=-1, stable=True)


def _run(data, out, **kw):
    from tpuic_torch.score.driver import run_score
    kw.setdefault("resize", 16)
    kw.setdefault("batch_size", 4)
    kw.setdefault("shard_size", 5)
    kw.setdefault("dtype", "fp32")
    kw.setdefault("poll_s", 0.02)
    kw.setdefault("device", "cpu")
    kw.setdefault("_forward", torch_stub)
    return run_score(data_dir=data, out_dir=out, **kw)


@pytest.fixture()
def corpus(tmp_path_factory):
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    root = tmp_path_factory.mktemp("score_corpus")
    make_synthetic_imagefolder(str(root), classes=CLASSES, per_class=4,
                               size=16)
    return str(root)


def _ledger(out):
    from tpuic_torch.telemetry.events import read_jsonl
    recs = []
    for p in sorted(glob.glob(os.path.join(out, "*.jsonl"))):
        recs.extend(read_jsonl(p))
    return recs


def _audit(out):
    from tpuic_torch.telemetry.fleet import load_streams, score_audit
    return score_audit(load_streams([out]))


def _shard_bytes(out):
    return {os.path.basename(p): open(p, "rb").read() for p in sorted(
        glob.glob(os.path.join(out, "results", "shard-*.jsonl")))}


# -- plan --------------------------------------------------------------------
def test_plan_shards_math():
    assert plan_shards(12, 5) == [(0, 5), (5, 10), (10, 12)]
    assert plan_shards(4, 5) == [(0, 4)]
    assert plan_shards(10, 5) == [(0, 5), (5, 10)]
    with pytest.raises(ValueError):
        plan_shards(0, 5)
    with pytest.raises(ValueError):
        plan_shards(5, 0)


def test_plan_file_first_wins_and_mismatch_is_loud(tmp_path):
    w = str(tmp_path)
    tok = corpus_token(12, 16, [f"id{i}" for i in range(12)])
    plan, created = write_or_verify_plan(w, n=12, shard_size=5, token=tok,
                                         dtype="fp32")
    assert created and len(plan["shards"]) == 3
    plan2, created2 = write_or_verify_plan(w, n=12, shard_size=5,
                                           token=tok, dtype="fp32")
    assert not created2 and plan2 == plan
    for kw in ({"n": 13}, {"shard_size": 4}, {"token": tok + 1},
               {"dtype": "int8"}):
        full = {"n": 12, "shard_size": 5, "token": tok, "dtype": "fp32",
                **kw}
        with pytest.raises(ValueError, match="plan mismatch"):
            write_or_verify_plan(w, **full)


# -- leases ------------------------------------------------------------------
def test_lease_acquire_is_exclusive_then_released(tmp_path):
    a = LeaseDir(str(tmp_path), rank=0, ttl_s=30.0)
    b = LeaseDir(str(tmp_path), rank=1, ttl_s=30.0)
    assert a.acquire(3)
    assert not b.acquire(3)
    assert a.renew(3)
    assert not b.renew(3)
    a.release(3)
    assert b.acquire(3)
    b.release(3)


def test_lease_ttl_expiry_steal_and_token_confirm(tmp_path):
    a = LeaseDir(str(tmp_path), rank=0, ttl_s=0.5)
    b = LeaseDir(str(tmp_path), rank=1, ttl_s=0.5)
    assert a.acquire(0)
    past = os.stat(a.path(0)).st_mtime - 5.0
    os.utime(a.path(0), (past, past))
    assert b.acquire(0)
    assert b.steals == 1
    assert not a.renew(0)
    rec = b.owner(0)
    assert rec["rank"] == 1 and rec["token"] == b.token


def test_lease_membership_orphan_steals_without_waiting_ttl(tmp_path):
    a = LeaseDir(str(tmp_path), rank=1, ttl_s=3600.0)
    b = LeaseDir(str(tmp_path), rank=0, ttl_s=3600.0)
    assert a.acquire(2)
    assert not b.acquire(2, active=[0, 1])
    assert b.acquire(2, active=[0])
    assert b.owner(2)["rank"] == 0


def test_lease_membership_file_drives_active_ranks(tmp_path):
    """``active_ranks`` reads the port's membership copy: None without a
    file, the active set once one is written."""
    from tpuic_torch.runtime.membership import Membership, write_membership
    from tpuic_torch.score.work import active_ranks
    path = str(tmp_path / "membership.json")
    assert active_ranks("") is None and active_ranks(path) is None
    write_membership(path, Membership(version=2, world=2, active=[0],
                                      resume_step=None, reason="degrade",
                                      rank=1))
    assert active_ranks(path) == [0]


def test_lease_skew_fault_forces_expiry(tmp_path):
    a = LeaseDir(str(tmp_path), rank=0, ttl_s=3600.0)
    b = LeaseDir(str(tmp_path), rank=1, ttl_s=3600.0)
    assert a.acquire(7)
    faults.arm("lease_skew")
    assert b.acquire(7)
    assert faults.fired("lease_skew") >= 1


# -- commits -----------------------------------------------------------------
def _lines(lo, hi):
    return [result_line({"index": i, "id": f"id{i}", "label": 0,
                         "pred": 1, "prob": "0.900000"})
            for i in range(lo, hi)]


def test_commit_link_arbitration_is_exactly_once(tmp_path):
    a = ShardStore(str(tmp_path), rank=0)
    b = ShardStore(str(tmp_path), rank=1)
    lines = _lines(0, 5)
    va, _ = a.commit(0, 0, 5, lines, scored=5, quarantined=0)
    vb, man = b.commit(0, 0, 5, lines, scored=5, quarantined=0)
    assert (va, vb) == ("committed", "duplicate")
    assert a.commits == 1 and b.commits == 0 and b.duplicates == 1
    assert a.state(0) == "committed"
    assert man["rank"] == 0 and not man["adopted"]
    assert open(a.result_path(0)).read() == "".join(lines)


def test_commit_crash_window_orphan_is_adopted_not_rescored(tmp_path):
    a = ShardStore(str(tmp_path), rank=0)
    a.commit(1, 5, 10, _lines(5, 10), scored=5, quarantined=0)
    os.unlink(a.manifest_path(1))
    b = ShardStore(str(tmp_path), rank=1)
    assert b.state(1) == "orphan"
    man = b.adopt(1, 5, 10, scored=5, quarantined=0)
    assert man["adopted"] and man["rank"] == 1
    assert b.state(1) == "committed"


def test_commit_duplicate_finishes_a_dead_winners_manifest(tmp_path):
    a = ShardStore(str(tmp_path), rank=0)
    a.commit(2, 0, 5, _lines(0, 5), scored=5, quarantined=0)
    os.unlink(a.manifest_path(2))
    b = ShardStore(str(tmp_path), rank=1)
    verdict, man = b.commit(2, 0, 5, _lines(0, 5), scored=5,
                            quarantined=0)
    assert verdict == "duplicate" and man["adopted"]
    assert b.state(2) == "committed"


def test_commit_detects_atrest_bitrot_and_discards(tmp_path):
    s = ShardStore(str(tmp_path), rank=0)
    s.commit(3, 0, 5, _lines(0, 5), scored=5, quarantined=0)
    assert s.state(3) == "committed"
    faults.corrupt_file(s.result_path(3), offset=4, nbytes=4)
    assert s.state(3) == "corrupt"
    s.discard(3)
    assert s.state(3) == "missing"


def test_commit_files_equal_tpuics(tmp_path):
    """The same commit through both packages leaves the same result bytes
    and the same manifest."""
    from tpuic.score.commit import ShardStore as TShardStore
    from tpuic.score.commit import result_line as t_result_line
    recs = [{"index": i, "id": f"id{i}", "label": i % 3, "pred": 2,
             "prob": "0.375000"} for i in range(4)]
    recs[2] = {"index": 2, "id": "id2", "quarantined": True,
               "reason": "row_crc"}
    got = {}
    for name, store_cls, line in (("port", ShardStore, result_line),
                                  ("tpuic", TShardStore, t_result_line)):
        store = store_cls(str(tmp_path / name), rank=1)
        verdict, man = store.commit(0, 0, 4, [line(r) for r in recs],
                                    scored=3, quarantined=1)
        assert verdict == "committed"
        got[name] = (open(store.result_path(0), "rb").read(), man,
                     open(store.manifest_path(0)).read())
    assert got["port"] == got["tpuic"]


def test_scorer_crash_fires_in_spec_grammar():
    plan = faults.FaultPlan("scorer_crash@1#1,shard_corrupt@2#1,"
                            "lease_skew#120")
    assert plan.fire("scorer_crash", step=1)
    assert not plan.fire("scorer_crash", step=2)
    assert plan.param("scorer_crash") == 1.0
    assert plan.fire("shard_corrupt", step=2)
    assert plan.param("lease_skew") == 120.0


# -- driver ------------------------------------------------------------------
def test_driver_single_rank_exact_ledger_zero_steady_compiles(
        corpus, tmp_path):
    out = str(tmp_path / "out")
    s = _run(corpus, out)
    assert s["shards_committed"] == s["shards"] == 3
    assert s["rows_scored"] == s["n"] == 12
    assert s["rows_quarantined"] == 0
    assert s["steady_compiles"] == 0
    rep = _audit(out)
    assert rep["ok"], rep["errors"]
    kinds = [r["event"] for r in _ledger(out)]
    assert kinds.count("score_plan") == 1
    assert kinds.count("score_commit") == 3
    assert kinds.count("score_done") == 1


def test_driver_resumes_without_rescoring_committed_shards(corpus,
                                                           tmp_path):
    base = str(tmp_path / "base")
    _run(corpus, base)
    out = str(tmp_path / "out")
    s1 = _run(corpus, out, max_commits=1)
    assert s1["halted"] and s1["commits_this_life"] == 1
    s2 = _run(corpus, out)
    assert s2["commits_this_life"] == s2["shards"] - 1
    assert s2["shards_committed"] == s2["shards"]
    rep = _audit(out)
    assert rep["ok"], rep["errors"]
    assert _shard_bytes(out) == _shard_bytes(base)
    assert len(_shard_bytes(out)) == s2["shards"]


def test_driver_two_ranks_share_the_queue_exactly_once(corpus, tmp_path):
    out = str(tmp_path / "out")
    results = {}

    def worker(rank):
        results[rank] = _run(corpus, out, rank=rank, ranks=2, shard_size=3)
    threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=POLL_TIMEOUT)
        assert not t.is_alive(), "a scoring thread did not finish"
    rep = _audit(out)
    assert rep["ok"], rep["errors"]
    assert rep["shards_committed"] == 4
    assert rep["rows_scored"] == 12 and rep["shards_duplicated"] == 0
    total = sum(r["commits_this_life"] + r["duplicates_this_life"]
                for r in results.values())
    assert total >= 4
    assert os.path.exists(os.path.join(out, "ledger.jsonl"))
    assert os.path.exists(os.path.join(out, "ledger.rank1.jsonl"))


def test_driver_shard_corrupt_fault_lands_in_quarantined_column(corpus,
                                                                tmp_path):
    out = str(tmp_path / "out")
    faults.arm("shard_corrupt", steps=1, param=2)
    s = _run(corpus, out)
    assert s["rows_quarantined"] == 1
    assert s["rows_scored"] == s["n"] - 1
    rep = _audit(out)
    assert rep["ok"], rep["errors"]
    assert rep["rows_quarantined"] == 1
    commit = [r for r in _ledger(out) if r["event"] == "score_commit"
              and r["shard"] == 1][0]
    assert commit["quarantined"] == 1
    from tpuic_torch.telemetry.events import read_jsonl
    rows = read_jsonl(os.path.join(out, "results", "shard-00001.jsonl"))
    bad = [r for r in rows if r.get("quarantined")]
    assert len(bad) == 1 and bad[0]["index"] == 7
    assert bad[0]["reason"] == "injected"


def test_driver_packed_bitrot_row_quarantined_corpus_still_exact(tmp_path):
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    data = str(tmp_path / "data")
    make_synthetic_imagefolder(data, classes=("a", "b"), per_class=4,
                               size=16)
    out1 = str(tmp_path / "clean")
    _run(data, out1)
    [bin_path] = glob.glob(os.path.join(data, ".tpuic_pack",
                                        "pack-val-16.bin"))
    row = 16 * 16 * 3
    faults.corrupt_file(bin_path, offset=3 * row + 7, nbytes=16)
    out2 = str(tmp_path / "rotted")
    s = _run(data, out2)
    assert s["rows_quarantined"] == 1
    rep = _audit(out2)
    assert rep["ok"], rep["errors"]
    assert rep["rows_quarantined"] == 1
    from tpuic_torch.telemetry.events import read_jsonl
    rows = read_jsonl(os.path.join(out2, "results", "shard-00000.jsonl"))
    bad = [r for r in rows if r.get("quarantined")]
    assert len(bad) == 1 and bad[0]["index"] == 3
    assert bad[0]["reason"] == "row_crc"


def test_driver_rescores_a_rotted_result_file(corpus, tmp_path):
    out = str(tmp_path / "out")
    _run(corpus, out)
    victim = os.path.join(out, "results", "shard-00002.jsonl")
    before = open(victim, "rb").read()
    faults.corrupt_file(victim, offset=8, nbytes=8)
    s = _run(corpus, out)
    assert s["commits_this_life"] == 1
    assert open(victim, "rb").read() == before
    rep = _audit(out)
    assert not rep["ok"]
    assert rep["shards_duplicated"] == 1


def test_run_score_defaults_to_the_card(corpus, tmp_path):
    """No fallback hides the card: without ``device`` the scorer runs on
    the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from tpuic_torch.score.driver import run_score
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_score(data_dir=corpus, out_dir=str(tmp_path / "out"),
                  resize=16, _forward=torch_stub)
    assert not os.path.exists(tmp_path / "out")


# -- ledger audit (bidirectional) -------------------------------------------
def test_score_ledger_cli_passes_clean_and_fails_tampered(corpus, tmp_path,
                                                          capsys):
    from tpuic_torch.telemetry.fleet import main as fleet_main
    out = str(tmp_path / "out")
    _run(corpus, out)
    rep_json = str(tmp_path / "audit.json")
    prom = str(tmp_path / "score.prom")
    assert fleet_main([out, "--score-ledger", "--json", rep_json,
                       "--prom-dump", prom]) == 0
    assert json.load(open(rep_json))["ok"]
    text = open(prom).read()
    assert "tpuic_score_rows_scored 12" in text
    assert "tpuic_score_ledger_exact 1" in text
    capsys.readouterr()

    ledger = os.path.join(out, "ledger.jsonl")
    lines = open(ledger).read().splitlines(keepends=True)
    commits = [ln for ln in lines if '"score_commit"' in ln]
    open(ledger, "a").write(commits[0])
    assert fleet_main([out, "--score-ledger"]) == 1
    assert "committed 2 times" in capsys.readouterr().err
    open(ledger, "w").writelines(ln for ln in lines if ln != commits[0])
    assert fleet_main([out, "--score-ledger"]) == 1
    assert "NO commit record" in capsys.readouterr().err


def test_score_audit_counts_mismatch_and_foreign_shards():
    from tpuic_torch.telemetry.fleet import score_audit
    plan = {"event": "score_plan", "n": 10, "shards": 2, "shard_size": 5,
            "corpus_token": 1, "dtype": "fp32",
            "shard_table": [[0, 5], [5, 10]]}

    def commit(shard, scored, quar):
        return {"event": "score_commit", "shard": shard, "scored": scored,
                "quarantined": quar}
    good = score_audit({0: [plan, commit(0, 5, 0), commit(1, 4, 1)]})
    assert good["ok"] and good["rows_quarantined"] == 1
    short = score_audit({0: [plan, commit(0, 5, 0), commit(1, 3, 1)]})
    assert not short["ok"]
    assert any("shard 1" in e for e in short["errors"])
    foreign = score_audit({0: [plan, commit(0, 5, 0), commit(1, 5, 0),
                               commit(7, 5, 0)]})
    assert not foreign["ok"]
    assert any("never defined" in e for e in foreign["errors"])
    no_plan = score_audit({0: [commit(0, 5, 0)]})
    assert not no_plan["ok"]


def test_score_event_kinds_and_fault_points_registered():
    from tpuic_torch.telemetry.events import EVENT_KINDS
    for kind in ("score_plan", "score_shard", "score_commit",
                 "score_duplicate", "score_done"):
        assert kind in EVENT_KINDS
    for point in ("scorer_crash", "shard_corrupt", "lease_skew"):
        assert point in faults.REGISTERED_POINTS
        assert point in faults.FIRED_BY["score"]


@pytest.mark.parametrize("report", [
    {"n": 48, "shards": 12, "shards_committed": 12, "rows_scored": 47,
     "rows_quarantined": 1, "steady_compiles": 0, "steals_this_life": 2},
    {"n": 10, "shards": 2, "shards_committed": 2, "shards_missing": 0,
     "shards_duplicated": 1, "rows_scored": 10, "rows_quarantined": 0,
     "recovered_records": 1, "duplicate_score_events": 3, "ok": False},
    None], ids=["done", "audit", "none"])
def test_prom_score_rows_equal_tpuics(report):
    from tpuic.telemetry import prom as tprom
    from tpuic_torch.telemetry.prom import render, score_rows
    text = render(score_rows(report))
    assert text == tprom.render(tprom.score_rows(report))
    if report is None:
        assert text == ""
    elif "ok" not in report:
        assert "tpuic_score_rows_quarantined 1" in text
        assert "tpuic_score_steady_compiles 0" in text
        assert "# TYPE tpuic_score_rows_scored counter" in text
    else:
        assert "tpuic_score_ledger_exact 0" in text


# -- parity with tpuic's run_score -------------------------------------------
@pytest.fixture()
def jax_stub():
    import jax.numpy as jnp

    def fwd(variables, images):
        s = jnp.sum(images.astype(jnp.int32), axis=(1, 2, 3))
        probs = _exact_probs(s, jnp.arange(3)).astype(jnp.float32)
        return probs, jnp.argsort(-probs, axis=-1)
    return fwd


@pytest.mark.parametrize("quarantine", [False, True],
                         ids=["clean", "shard_corrupt"])
def test_plan_and_result_files_byte_identical_to_tpuics(
        corpus, tmp_path, jax_stub, quarantine):
    from tpuic.runtime import faults as tfaults
    from tpuic.score.driver import run_score as t_run_score
    kw = dict(resize=16, batch_size=4, shard_size=5, dtype="fp32",
              poll_s=0.02)
    outs = {"tpuic": str(tmp_path / "tpuic"),
            "port": str(tmp_path / "port")}
    try:
        if quarantine:
            tfaults.arm("shard_corrupt", steps=1, param=2)
            faults.arm("shard_corrupt", steps=1, param=2)
        t_run_score(data_dir=corpus, out_dir=outs["tpuic"],
                    cache_dir=str(tmp_path / "tpack"), _forward=jax_stub,
                    **kw)
        s = _run(corpus, outs["port"], cache_dir=str(tmp_path / "ppack"),
                 **kw)
    finally:
        tfaults.reset()
    assert s["shards_committed"] == 3
    assert s["rows_quarantined"] == (1 if quarantine else 0)
    plans = {k: open(os.path.join(v, "plan.json")).read()
             for k, v in outs.items()}
    assert plans["port"] == plans["tpuic"]
    got, want = _shard_bytes(outs["port"]), _shard_bytes(outs["tpuic"])
    assert len(got) == 3 and got == want
    manifests = {k: [json.load(open(p)) for p in sorted(glob.glob(
        os.path.join(v, "manifests", "*.json")))] for k, v in outs.items()}
    assert manifests["port"] == manifests["tpuic"]


# -- a real model ------------------------------------------------------------
def _save_port_ckpt(model, ckpt_dir: str, name: str, size: int) -> None:
    """``model``'s weights as a Trainer's ``best`` save, with its
    ``config.json`` sidecar (what ``--model auto`` reads)."""
    from tpuic_torch import config as pcfg
    from tpuic_torch.checkpoint import CheckpointManager
    from tpuic_torch.train.optimizer import make_optimizer
    from tpuic_torch.train.state import create_train_state
    ocfg = pcfg.OptimConfig(optimizer="sgd", class_weights=(),
                            milestones=())
    mgr = CheckpointManager(ckpt_dir, name, async_commit=False,
                            log=lambda m: None)
    mgr.save_best(create_train_state(model, make_optimizer(ocfg)), 0, 50.0)
    mgr.wait()
    cfg = pcfg.Config(data=pcfg.DataConfig(resize_size=size),
                      model=pcfg.ModelConfig(name=name,
                                             num_classes=len(CLASSES),
                                             dtype="float32"), optim=ocfg)
    with open(os.path.join(mgr.root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, default=str)


def test_real_resnet18_cifar_pred_and_prob_against_tpuic(tmp_path,
                                                         monkeypatch):
    import jax
    import jax.numpy as jnp

    from tpuic.models import create_model as t_create_model
    from tpuic_torch.checkpoint import load_jax_variables
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    from tpuic_torch.kernels import conv_bn_relu as k3
    from tpuic_torch.models import create_model
    from tpuic_torch.score.driver import run_score
    size, name = 32, "resnet18-cifar"
    jm = t_create_model(name, len(CLASSES), dtype="float32")
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(3), jnp.zeros((1, size, size, 3)), train=False))
    pm = create_model(name, len(CLASSES), dtype="float32",
                      fused_conv_bn=True, device="cpu")
    load_jax_variables(pm, variables)
    ckpt = str(tmp_path / "ckpt")
    _save_port_ckpt(pm, ckpt, name, size)
    data = str(tmp_path / "data")
    make_synthetic_imagefolder(data, classes=CLASSES, per_class=3,
                               size=size + 4, seed=5)

    plain_calls = []
    plain = k3.fused_conv_bn_relu_plain
    monkeypatch.setattr(k3, "fused_conv_bn_relu_plain",
                        lambda *a, **k: plain_calls.append(1) or
                        plain(*a, **k))
    out = str(tmp_path / "out")
    s = run_score(data_dir=data, out_dir=out, model_name=name,
                  num_classes=len(CLASSES), resize=size, batch_size=4,
                  shard_size=4, dtype="fp32", ckpt_dir=ckpt,
                  device="cpu", log=lambda *a: None)
    assert s["shards_committed"] == s["shards"] == 3
    assert s["steady_compiles"] == 0
    # 20 convolutions a resnet18-cifar forward, each K3's plain version:
    # warmup's two buckets (1, 4) and three batches of 4.
    assert len(plain_calls) == 20 * 5

    rows = []
    for p in sorted(glob.glob(os.path.join(out, "results", "*.jsonl"))):
        rows += [json.loads(ln) for ln in open(p)]
    meta_path, = glob.glob(os.path.join(data, ".tpuic_pack", "*.json"))
    meta = json.load(open(meta_path))
    raw = np.fromfile(meta_path[:-5] + ".bin", np.uint8).reshape(
        meta["n"], size, size, 3)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    x = (raw.astype(np.float32) / 255.0 - mean) / std
    probs = np.asarray(jax.nn.softmax(
        jm.apply(variables, jnp.asarray(x), train=False), axis=-1))
    assert [r["index"] for r in rows] == list(range(meta["n"]))
    assert [r["pred"] for r in rows] == probs.argmax(-1).tolist()
    np.testing.assert_allclose([float(r["prob"]) for r in rows],
                               probs.max(-1), atol=1e-5)
    assert [r["label"] for r in rows] == meta["labels"]


# -- the CLI -----------------------------------------------------------------
@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A port checkpoint of resnet18-cifar (3 classes, 16 px, seeded
    initialisation) with its sidecar, and a 24-image corpus packed once."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    from tpuic_torch.models import create_model
    root = tmp_path_factory.mktemp("score_job")
    ckpt = str(root / "ckpt")
    model = init_params(create_model("resnet18-cifar", len(CLASSES),
                                     dtype="float32", device="cpu"), 1,
                        device="cpu")
    _save_port_ckpt(model, ckpt, "resnet18-cifar", 16)
    data = str(root / "data")
    make_synthetic_imagefolder(data, classes=CLASSES, per_class=8,
                               size=20, seed=2)
    return {"root": root, "ckpt": ckpt, "data": data}


def _cli_args(job, out, *extra):
    return ["--datadir", job["data"], "--out", out, "--ckpt-dir",
            job["ckpt"], "--model", "auto", "--shard-size", "4",
            "--batchsize", "4", "--poll", "0.05", *extra]


def test_cli_end_to_end_on_cpu_with_prom_dump(job, tmp_path, capsys):
    from tpuic_torch.score.driver import main
    out, prom = str(tmp_path / "out"), str(tmp_path / "score.prom")
    assert main(_cli_args(job, out, "--device", "cpu", "--prom-dump",
                          prom)) == 0
    stdout = capsys.readouterr().out
    assert "[score] auto-resolved model 'resnet18-cifar' (num_classes=3, " \
           "resize=16)" in stdout
    summary = json.loads([ln for ln in stdout.splitlines()
                          if ln.startswith("{")][-1])
    assert summary["shards_committed"] == summary["shards"] == 6
    assert summary["dtype"] == "int8" and summary["steady_compiles"] == 0
    text = open(prom).read()
    assert "tpuic_score_rows_scored 24" in text
    assert "tpuic_score_steady_compiles 0" in text
    assert _audit(out)["ok"]
    # Resume: every shard committed and recorded, nothing scored again.
    assert main(_cli_args(job, out, "--device", "cpu")) == 0
    again = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith("{")][-1])
    assert again["commits_this_life"] == 0


def _score_proc(job, out, env_extra, *extra, log=None):
    env = subprocess_env(PYTHONPATH=str(ROOT), **env_extra)
    if "TPUIC_FAULTS" not in env_extra:
        env.pop("TPUIC_FAULTS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "tpuic_torch.score",
         *_cli_args(job, out, "--device", "cpu", *extra)],
        cwd=ROOT, env=env, stdout=log or subprocess.DEVNULL,
        stderr=subprocess.STDOUT if log else subprocess.DEVNULL)


def _wait(proc, what: str) -> int:
    try:
        return proc.wait(timeout=PROC_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        pytest.fail(f"{what} did not exit within {PROC_TIMEOUT} s")


def _poll(cond, what: str, procs=()) -> None:
    deadline = time.monotonic() + POLL_TIMEOUT
    while not cond():
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            pytest.fail(f"timed out after {POLL_TIMEOUT} s waiting for "
                        f"{what}")
        time.sleep(0.05)


def test_score_cli_without_a_card_raises(job, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    out = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.score",
         *_cli_args(job, str(tmp_path / "out"))], cwd=ROOT,
        env=subprocess_env(PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=PROC_TIMEOUT)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("point", ["scorer_crash", "shard_corrupt",
                                   "lease_skew"])
def test_score_cli_fires_each_point(job, tmp_path, capsys, point):
    """Each score fault point armed for the CLI fires at its site."""
    from tpuic_torch.score.driver import main
    out = str(tmp_path / "out")
    if point == "scorer_crash":
        # The victim dies by SIGKILL between its first link and manifest.
        proc = _score_proc(job, out, {"TPUIC_FAULTS": "scorer_crash@1"})
        assert _wait(proc, "the armed scorer") == -9
        store = ShardStore(out, rank=0)
        states = [store.state(s) for s in range(6)]
        assert states.count("orphan") == 1
        assert states.count("missing") == 5
        return
    if point == "shard_corrupt":
        faults.arm("shard_corrupt", steps=2, param=1)
    else:
        # A live, hour-long lease of another rank: only the skew frees it.
        LeaseDir(out, rank=1, ttl_s=3600.0).acquire(0)
        faults.arm("lease_skew")
    assert main(_cli_args(job, out, "--device", "cpu")) == 0
    summary = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")][-1])
    assert faults.fired(point) >= 1
    if point == "shard_corrupt":
        assert summary["rows_quarantined"] == 1
    else:
        assert summary["steals_this_life"] >= 1
    assert _audit(out)["ok"]


def test_two_worker_processes_crash_and_replacement_exact_and_bitwise(
        job, tmp_path):
    """``tpuic``'s score soak on the CPU: rank 1 armed ``scorer_crash@1#1``
    dies by SIGKILL at its first commit (result linked, no manifest); the
    membership file books the death (init -> degrade), rank 0 steals the
    dead rank's lease at once and adopts its shard, the rejoin is booked
    and a replacement rank 1 joins.  The audit is exact with a recovered
    record and every shard file equals a one-worker run's bytes."""
    from tpuic_torch.runtime.membership import (ENV_MEMBERSHIP_FILE,
                                                Membership, write_membership)
    from tpuic_torch.score.driver import main
    from tpuic_torch.telemetry.fleet import ENV_FLEET_RANK, ENV_FLEET_RANKS
    base = str(tmp_path / "base")
    assert main(_cli_args(job, base, "--device", "cpu")) == 0

    out = str(tmp_path / "elastic")
    member = str(tmp_path / "membership.json")
    write_membership(member, Membership(version=1, world=2, active=[0, 1],
                                        resume_step=None, reason="init"))

    def env(rank, **extra):
        return {ENV_FLEET_RANK: str(rank), ENV_FLEET_RANKS: "2",
                ENV_MEMBERSHIP_FILE: member, **extra}

    def orphans():
        return [p for p in glob.glob(os.path.join(out, "results",
                                                  "shard-*.jsonl"))
                if not os.path.exists(p.replace("results", "manifests")
                                      .replace(".jsonl", ".json"))]

    def plan_published(path):
        return os.path.exists(path) and '"score_plan"' in open(path).read()

    procs = []
    try:
        w1 = _score_proc(job, out, env(1, TPUIC_FAULTS="scorer_crash@1#1"))
        procs.append(w1)
        # Rank 0 starts once the victim has planned, so the victim is
        # provably first to a commit.
        _poll(lambda: plan_published(os.path.join(out, "ledger.rank1.jsonl"))
              or w1.poll() is not None, "rank 1's plan", procs)
        w0 = _score_proc(job, out, env(0))
        procs.append(w0)
        assert _wait(w1, "rank 1") == -9
        write_membership(member, Membership(
            version=2, world=2, active=[0], resume_step=None,
            reason="degrade", rank=1))
        _poll(lambda: not orphans(), "the dead rank's shard to be adopted",
              procs)
        write_membership(member, Membership(
            version=3, world=2, active=[0, 1], resume_step=None,
            reason="rejoin", rank=1))
        w1b = _score_proc(job, out, env(1))
        procs.append(w1b)
        assert _wait(w0, "rank 0") == 0
        assert _wait(w1b, "the replacement rank 1") == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    rep = _audit(out)
    assert rep["ok"], rep["errors"]
    assert rep["n"] == 24 and rep["shards_committed"] == 6
    assert rep["rows_scored"] == 24 and rep["shards_duplicated"] == 0
    assert rep["recovered_records"] >= 1
    assert _shard_bytes(out) == _shard_bytes(base)
    assert len(_shard_bytes(out)) == 6
    dones = [r for r in _ledger(out) if r["event"] == "score_done"]
    assert len(dones) == 2  # the SIGKILLed life publishes none
    assert all(d["steady_compiles"] == 0 for d in dones)
    steals = {d["rank"]: d["steals_this_life"] for d in dones}
    assert steals[0] >= 1
