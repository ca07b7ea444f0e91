"""Port parity: ``tpuic_torch.runtime.faults`` against
``tpuic.runtime.faults``, and the CLIs' ``TPUIC_FAULTS`` handling.

- One table of ``TPUIC_FAULTS`` strings, valid and malformed, gives the
  same plans (each armed point's steps, times and payload) and the same
  errors in both packages; ``REGISTERED_POINTS`` is one set; a scripted
  arm/fire/disarm sequence fires alike; the at-rest corruption helpers
  leave the same bytes.
- The train CLI no longer drops a chaos spec: it fires the training
  points and refuses by name the one it does not fire
  (``rank_rejoin_flap``), and a spec that does not parse.  The serve CLI
  takes the serving points (``swap_corrupt`` among them) and refuses the
  rest the same way.

``tpuic.runtime.faults`` imports only the stdlib; it is imported in a
fixture all the same, as every ``tpuic`` import of the port's tests is.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpuic_torch.runtime import faults as pf
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jf():
    from tpuic.runtime import faults
    return faults


SPECS = (
    "",
    "flood",
    "flood#200",
    "replica_crash@20",
    "replica_wedge@3#0.5",
    "hang_device*2#0.25",
    "canary_degrade#0.05",
    "nan_batch@100-105,sigterm@200",
    " slow_step#0.3 , hard_crash@7 ",
    "rank_crash@8#1,rank_hang@9*1",
    "scorer_crash@1#1,shard_corrupt@2#1,lease_skew#120",
    "flood#1e3,,",
    # Malformed: each raises the same ValueError in both packages.
    "bogus",
    "flood@x",
    "flood#fast",
    "nan_batch@1-y",
    "hang_device*many",
    "replica_crash@3,typo_point@4",
)


def _plan(mod, spec):
    """``(arms, None)`` of a parsed plan, or ``(None, error text)``."""
    try:
        plan = mod.FaultPlan(spec)
    except ValueError as e:
        return None, str(e)
    arms = {p: (None if a.steps is None else sorted(a.steps), a.times,
                a.param) for p, a in plan._arms.items()}
    return arms, None


@pytest.mark.parametrize("spec", SPECS)
def test_spec_table_parses_the_same_in_both_packages(jf, spec):
    assert _plan(pf, spec) == _plan(jf, spec)


def test_registered_points_are_one_set(jf):
    assert pf.REGISTERED_POINTS == jf.REGISTERED_POINTS
    # Every point the port fires is registered, and the serving set is
    # the one the port's serving path fires.
    assert pf.FIRED_BY["serve"] == {"flood", "replica_crash",
                                    "replica_wedge", "hang_device",
                                    "canary_degrade", "swap_corrupt"}
    assert pf.FIRED_BY["train"] == {
        "nan_batch", "sigterm", "decode_error", "ckpt_kill", "slow_step",
        "hard_crash", "hang_step", "rank_crash", "rank_hang",
        "bf16_master_truncate"}
    assert pf.FIRED_BY["score"] == {"scorer_crash", "shard_corrupt",
                                    "lease_skew"}
    # What no path fires: elastic membership's point.
    assert pf.REGISTERED_POINTS - set().union(*pf.FIRED_BY.values()) == {
        "rank_rejoin_flap"}
    assert all(p <= pf.REGISTERED_POINTS for p in pf.FIRED_BY.values())


def test_scripted_firings_agree(jf):
    def script(mod):
        plan = mod.FaultPlan("replica_crash@3,flood*2#50")
        plan.arm("adhoc", steps=range(2, 4), times=1, param="x")
        log = []
        for step in range(6):
            log.append([plan.fire(p, step) for p in
                        ("replica_crash", "flood", "adhoc", "nope")])
        log.append((plan.param("flood"), plan.param("adhoc"),
                    plan.param("nope"), dict(plan.fired)))
        plan.disarm("flood")
        log.append(plan.fire("flood"))
        plan.reset()
        log.append((plan.fire("replica_crash", 3), dict(plan.fired)))
        return log
    assert script(pf) == script(jf)


def test_module_level_arming_fires_and_resets():
    pf.reset()
    try:
        pf.arm("hang_device", times=1, param=0.0)
        assert pf.param("hang_device") == 0.0
        assert pf.fire("hang_device") and not pf.fire("hang_device")
        assert pf.fired("hang_device") == 1
        pf.disarm()
        assert not pf.fire("hang_device")
    finally:
        pf.reset()
    assert pf.fired("hang_device") == 0


def test_corruption_helpers_leave_the_same_bytes(jf, tmp_path):
    data = bytes(range(256)) * 3
    out = {}
    for name, mod in (("port", pf), ("tpuic", jf)):
        a, b = tmp_path / f"{name}_a", tmp_path / f"{name}_b"
        a.write_bytes(data)
        b.write_bytes(data)
        mod.truncate_file(str(a), keep=10)
        mod.corrupt_file(str(b), offset=700, nbytes=200)
        out[name] = (a.read_bytes(), b.read_bytes())
    assert out["port"] == out["tpuic"]
    assert len(out["port"][0]) == 10 and out["port"][1] != data


@pytest.mark.parametrize("entry,spec,match", [
    ("train", "rank_rejoin_flap@3", "'rank_rejoin_flap' not fired by the "
     "port's train path \\('rank_rejoin_flap' comes with ROADMAP §1 item "
     "13\\)"),
    ("train", "flood#10", "'flood' not fired by the port's train path "
     "\\(the serve path fires 'flood'\\)"),
    ("serve", "nan_batch@3", "'nan_batch' not fired by the port's "
     "serve path \\(the train path fires 'nan_batch'\\)"),
    ("serve", "scorer_crash@1#1", "'scorer_crash' not fired by the "
     "port's serve path \\(the score path fires 'scorer_crash'\\)"),
    ("train", "lease_skew#120", "'lease_skew' not fired by the port's "
     "train path \\(the score path fires 'lease_skew'\\)"),
    ("score", "flood#10", "'flood' not fired by the port's score path "
     "\\(the serve path fires 'flood'\\)"),
    ("score", "rank_rejoin_flap@3", "'rank_rejoin_flap' comes with "
     "ROADMAP §1 item 13"),
    ("serve", "flood@x", "malformed directive 'flood@x'"),
])
def test_check_fired_refuses_by_name(entry, spec, match):
    with pytest.raises(ValueError, match=match):
        pf.check_fired(entry, spec)


def test_check_fired_passes_the_serving_points():
    pf.check_fired("serve", "flood#400,replica_crash@5,replica_wedge@2#1,"
                            "hang_device#0,canary_degrade#0.05,"
                            "swap_corrupt")
    pf.check_fired("train", "")
    pf.check_fired("train", "nan_batch@10-13*4,sigterm@5,decode_error@2,"
                            "ckpt_kill,slow_step#0.1,hard_crash@9,"
                            "hang_step@3#1,rank_crash@6#1,rank_hang@7,"
                            "bf16_master_truncate")


def test_check_fired_passes_the_score_points():
    """The score CLI fires all three bulk-scoring points
    (``tests/test_torch_port_score.py`` fires each through it)."""
    pf.check_fired("score", "")
    pf.check_fired("score", "scorer_crash@1#1,shard_corrupt@2#1,"
                            "lease_skew#120")
    assert pf.FIRED_BY["score"] == {"scorer_crash", "shard_corrupt",
                                    "lease_skew"}


def _cli(module: str, spec: str, *args) -> subprocess.CompletedProcess:
    env = subprocess_env(PYTHONPATH=str(ROOT), TPUIC_FAULTS=spec)
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=180)


def test_train_cli_no_longer_drops_a_chaos_spec(tmp_path):
    """The repair: ``python -m tpuic_torch.train`` used to start and train
    with ``TPUIC_FAULTS`` set, the spec dropped without a word.  Now a
    point its path does not fire (``rank_rejoin_flap``: elastic
    membership) is refused by name before anything loads, and so is a
    spec that does not parse."""
    out = _cli("tpuic_torch.train", "rank_rejoin_flap@2", "--datadir",
               str(tmp_path), "--device", "cpu")
    assert out.returncode != 0
    assert ("TPUIC_FAULTS: 'rank_rejoin_flap' not fired by the port's train "
            "path ('rank_rejoin_flap' comes with ROADMAP §1 item 13)"
            ) in out.stderr
    out = _cli("tpuic_torch.train", "hard_crash@", "--datadir",
               str(tmp_path), "--device", "cpu")
    assert out.returncode != 0
    assert "malformed directive 'hard_crash@'" in out.stderr


def test_serve_cli_refuses_unfired_and_malformed_specs(tmp_path):
    for spec, want in (("ckpt_kill@1", "'ckpt_kill' not fired by the "
                        "port's serve path"),
                       ("floods#3", "unknown injection point 'floods'")):
        out = _cli("tpuic_torch.serve", spec, "--device", "cpu",
                   "--ckpt-dir", str(tmp_path))
        assert out.returncode != 0 and want in out.stderr, out.stderr


def test_score_cli_refuses_points_it_does_not_fire(tmp_path):
    """``python -m tpuic_torch.score`` refuses a serving or training point
    by name before anything loads, as the serve and train CLIs do."""
    for spec, want in (("flood#10", "'flood' not fired by the port's score "
                        "path (the serve path fires 'flood')"),
                       ("hard_crash@2", "'hard_crash' not fired by the "
                        "port's score path (the train path fires "
                        "'hard_crash')")):
        out = _cli("tpuic_torch.score", spec, "--datadir", str(tmp_path),
                   "--out", str(tmp_path / "out"), "--device", "cpu")
        assert out.returncode != 0 and want in out.stderr, out.stderr
        assert not os.path.exists(tmp_path / "out")
