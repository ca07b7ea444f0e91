"""Port parity: the training fault points fire at their sites
(``runtime/faults.py``), ``--init-from``, and the supervised trainer.

- In the ``Trainer``'s step loop, keyed by the global step number:
  ``sigterm`` (the real latch and flush), ``nan_batch`` (the prepared
  images times NaN, skipped by the guard), ``slow_step`` and
  ``hang_step`` (their sleeps), ``hard_crash``, ``rank_crash`` and
  ``rank_hang`` (SIGKILL or a wedge, on the rank ``TPUIC_FLEET_RANK``
  names); ``os.kill`` and the wedge's sleep are intercepted.
- ``decode_error`` in ``ImageFolderDataset.load``: the same rows,
  labels and quarantine counts as ``tpuic``'s under the same arming (a
  persistent error quarantines, a transient one recovers at the retry).
- ``ckpt_kill`` in the commit: ``InjectedFault`` after the staged save,
  the committed track untouched.  ``bf16_master_truncate`` in the step:
  every applied update rounds the master weights through bf16.
  ``swap_corrupt`` in the swap gate: the candidate refused.
- ``--init-from`` on a seeded torchvision-layout ResNet state dict: the
  ``Trainer``'s weights equal ``tpuic``'s ``init_state_from_torch``
  result loaded through ``load_jax_variables``.
- The SIGTERM latch beside the flight recorder's SIGQUIT dump; a
  ``sigterm`` under ``python -m tpuic_torch.supervise``, and a SIGTERM
  sent to the supervised trainer: exit 43, booked ``preempted``,
  restarted at once, resumed at that step, exit 0.

``tpuic`` is imported in fixtures.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch.checkpoint import CheckpointManager, load_jax_variables
from tpuic_torch.checkpoint.loading import load_candidate_variables
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.models import create_model
from tpuic_torch.runtime import faults
from tpuic_torch.runtime.preemption import PreemptionGuard
from tpuic_torch.runtime.supervisor import read_heartbeat
from tpuic_torch.serve.admission import SwapRejected
from tpuic_torch.train.loop import Trainer
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 16


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test's checkpoints (~90 MB a save of resnet18-cifar with its
    optimizer state) leave the disk when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from tpuic import config
    from tpuic.checkpoint import torch_convert
    from tpuic.data import folder
    from tpuic.models import create_model as jcreate
    from tpuic.runtime import faults as jfaults

    def random_tree(name, classes, size, seed=0):
        """A variables tree of ``tpuic``'s structure and shapes, every
        leaf drawn at random (traced, not compiled)."""
        m = jcreate(name, classes, dtype="float32")
        shapes = jax.eval_shape(lambda: m.init(
            jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))
        rng = np.random.default_rng(seed)
        return jax.tree.map(lambda s: rng.standard_normal(
            s.shape).astype(np.float32), shapes)

    return dict(cfg=config, tc=torch_convert, folder=folder,
                faults=jfaults, random_tree=random_tree)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fault_data"))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=4,
                               size=SIZE, folds=("train",))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=2,
                               size=SIZE, folds=("val",), seed=1)
    return root


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _cfg(folder, ckpt_dir, epochs=1, **run):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=folder, resize_size=SIZE, batch_size=4,
                             num_workers=2),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=0,
                               dtype="float32"),
        optim=pcfg.OptimConfig(optimizer="sgd", learning_rate=0.05,
                               milestones=(), class_weights=()),
        run=pcfg.RunConfig(**dict(dict(epochs=epochs, ckpt_dir=ckpt_dir,
                                       save_period=1, log_every_steps=1,
                                       seed=0), **run)))


def _quiet(cfg):
    return Trainer(cfg, device="cpu", log=lambda m: None)


class _Killed(BaseException):
    pass


def _intercept_kill(monkeypatch):
    """``os.kill`` recorded instead of sent; a SIGKILL ends ``fit`` the
    way the process would end: nothing after it runs."""
    sent = []

    def kill(pid, sig):
        sent.append(sig)
        if sig == signal.SIGKILL:
            raise _Killed()

    monkeypatch.setattr(os, "kill", kill)
    return sent


# -- the step loop's points ----------------------------------------------------
def test_sigterm_point_latches_and_flushes_at_its_step(folder, tmp_path):
    faults.arm("sigterm", steps=2)
    trainer = _quiet(_cfg(folder, str(tmp_path / "ck")))
    trainer.fit()
    assert faults.fired("sigterm") == 1 and trainer.preemption.triggered
    with open(tmp_path / "ck" / "resnet18-cifar" / "latest.meta.json") as f:
        assert json.load(f)["step_in_epoch"] == 2
    # The latch is gone with fit's span: the default handler is back.
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_nan_batch_poisons_the_prepared_images_on_their_device(folder,
                                                              tmp_path):
    trainer = _quiet(_cfg(folder, str(tmp_path / "ck"), skip_threshold=0))
    faults.arm("nan_batch", steps=1)
    seen, inner = [], trainer.train_step

    def step(state, batch, **kw):
        img = batch["image"]
        seen.append((bool(torch.isnan(img).all()), img.dtype, img.device))
        out = inner(state, batch, **kw)
        seen[-1] += (float(out[1]["skip_count"]),)
        return out

    trainer.train_step = step
    trainer.fit()
    assert [s[0] for s in seen] == [False, True, False]
    assert {(s[1], s[2].type) for s in seen} == {(torch.float32, "cpu")}
    assert [s[3] for s in seen] == [0.0, 1.0, 0.0]
    assert int(trainer.state.step) == 2


def test_slow_step_and_hang_step_sleep_their_payloads(folder, tmp_path,
                                                      monkeypatch):
    slept = []
    main = threading.main_thread()
    real = time.sleep

    def sleep(s):
        if threading.current_thread() is main:
            slept.append(s)
        real(min(s, 0.01))

    monkeypatch.setattr(time, "sleep", sleep)
    faults.arm("slow_step", steps=0, param=0.25)
    faults.arm("hang_step", steps=1, param=0.3)
    trainer = _quiet(_cfg(folder, str(tmp_path / "ck")))
    t0 = time.monotonic()
    trainer.fit()
    assert faults.fired("slow_step") == faults.fired("hang_step") == 1
    assert slept[0] == 0.25 and set(slept[1:]) == {0.5}
    assert time.monotonic() - t0 >= 0.3  # the hang's deadline held


def test_hard_crash_kills_at_its_step(folder, tmp_path, monkeypatch):
    sent = _intercept_kill(monkeypatch)
    faults.arm("hard_crash", steps=2)
    trainer = _quiet(_cfg(folder, str(tmp_path / "ck")))
    with pytest.raises(_Killed):
        trainer.fit()
    assert sent == [signal.SIGKILL] and int(trainer.state.step) == 2


@pytest.mark.parametrize("fleet_rank,victim,killed", [
    ("1", 1, True), ("1", 0, False), (None, 0, True)])
def test_rank_crash_kills_only_the_named_rank(folder, tmp_path, monkeypatch,
                                              fleet_rank, victim, killed):
    if fleet_rank is None:
        monkeypatch.delenv("TPUIC_FLEET_RANK", raising=False)
    else:
        monkeypatch.setenv("TPUIC_FLEET_RANK", fleet_rank)
    sent = _intercept_kill(monkeypatch)
    faults.arm("rank_crash", steps=1, param=float(victim))
    trainer = _quiet(_cfg(folder, str(tmp_path / "ck")))
    if killed:
        with pytest.raises(_Killed):
            trainer.fit()
        assert int(trainer.state.step) == 1
    else:
        trainer.fit()
        assert int(trainer.state.step) == 3
    assert faults.fired("rank_crash") == 1
    assert sent == ([signal.SIGKILL] if killed else [])


@pytest.mark.parametrize("victim,wedged", [(0, True), (1, False)])
def test_rank_hang_wedges_only_the_named_rank(folder, tmp_path, monkeypatch,
                                             victim, wedged):
    class _Wedged(BaseException):
        pass

    main = threading.main_thread()
    real = time.sleep

    def sleep(s):
        if threading.current_thread() is main and s == 0.5:
            raise _Wedged()
        real(s)

    monkeypatch.setattr(time, "sleep", sleep)
    monkeypatch.delenv("TPUIC_FLEET_RANK", raising=False)
    faults.arm("rank_hang", steps=1, param=float(victim))
    trainer = _quiet(_cfg(folder, str(tmp_path / "ck")))
    if wedged:
        with pytest.raises(_Wedged):
            trainer.fit()
    else:
        trainer.fit()
    assert faults.fired("rank_hang") == 1


# -- the data, checkpoint, step and swap-gate points ---------------------------
@pytest.mark.parametrize("times", [None, 1], ids=["persistent",
                                                  "transient"])
def test_decode_error_quarantines_as_tpuics(jx, folder, times):
    jc = jx["cfg"].DataConfig(data_dir=folder, resize_size=SIZE,
                              native=False, pack=False,
                              quarantine_backoff_s=0.0)
    pc = pcfg.DataConfig(data_dir=folder, resize_size=SIZE, native=False,
                         pack=False, quarantine_backoff_s=0.0)
    jds = jx["folder"].ImageFolderDataset(folder, "train", SIZE, jc)
    pds = ImageFolderDataset(folder, "train", SIZE, pc)
    jx["faults"].reset()
    try:
        for mod in (faults, jx["faults"]):
            mod.arm("decode_error", steps=5, times=times)
        for i in (4, 5, 6):
            img, label, image_id = pds.load(i)
            jimg, jlabel, jid = jds.load(i)
            np.testing.assert_array_equal(img, np.asarray(jimg))
            assert (label, image_id) == (jlabel, jid)
        assert pds.quarantine_count == jds.quarantine_count == (
            1 if times is None else 0)
        assert faults.fired("decode_error") == \
            jx["faults"].fired("decode_error") == (2 if times is None
                                                   else 1)
    finally:
        jx["faults"].reset()


def _state(seed=0):
    model = create_model("resnet18-cifar", 3, dtype="float32",
                         image_size=SIZE, device="cpu")
    from tpuic_torch.checkpoint import init_params
    init_params(model, seed, device="cpu")
    return create_train_state(model, make_optimizer(pcfg.OptimConfig(
        optimizer="sgd", class_weights=(), milestones=())))


def test_ckpt_kill_leaves_the_committed_track(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "resnet18-cifar",
                            async_commit=False, log=lambda m: None)
    first = _state(0)
    mgr.save_latest(first, 0, 1.0)
    faults.arm("ckpt_kill", times=1)
    with pytest.raises(faults.InjectedFault, match="before committing "
                       "checkpoint 'latest'"):
        mgr.save_latest(_state(1), 1, 2.0)
    assert os.path.isdir(os.path.join(mgr.root, "latest.new"))
    assert mgr.verify_track("latest")[0]
    got = _state(2)
    _, epoch, best = mgr.restore_into(got)
    assert (epoch, best, mgr.last_restore_rung) == (1, 1.0, "latest")
    for a, b in zip(got.model.state_dict().values(),
                    first.model.state_dict().values()):
        assert torch.equal(a, b)
    mgr.save_latest(_state(1), 1, 2.0)  # disarmed after one firing
    assert not os.path.exists(os.path.join(mgr.root, "latest.new"))


@pytest.mark.parametrize("armed", [True, False], ids=["armed", "unarmed"])
def test_bf16_master_truncate_rounds_each_applied_update(armed):
    if armed:
        faults.arm("bf16_master_truncate")
    state = _state(0)
    step = make_train_step(
        pcfg.OptimConfig(optimizer="sgd", learning_rate=0.05,
                         class_weights=(), milestones=()),
        pcfg.ModelConfig(name="resnet18-cifar", num_classes=3,
                         dtype="float32"), device="cpu")
    assert faults.fired("bf16_master_truncate") == int(armed)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)),
        "label": torch.tensor([0, 2], dtype=torch.int32),
        "mask": torch.ones(2)}
    step(state, batch)
    rounds = [torch.equal(p, p.to(torch.bfloat16).float())
              for p in state.model.parameters() if p.dim() >= 2]
    assert all(rounds) if armed else not any(rounds)


def test_swap_corrupt_is_refused_by_the_gate(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "resnet18-cifar",
                            async_commit=False, log=lambda m: None)
    mgr.save_latest(_state(0), 0, 1.0)
    cfg = pcfg.Config(
        data=pcfg.DataConfig(data_dir=".", resize_size=SIZE),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=3,
                               dtype="float32"),
        run=pcfg.RunConfig(ckpt_dir=str(tmp_path)))
    faults.arm("swap_corrupt", times=1)
    logs = []
    with pytest.raises(SwapRejected, match="failed the integrity gate: "
                       "checksum mismatch in state.pt") as e:
        load_candidate_variables(cfg, track="latest", log=logs.append,
                                 device="cpu")
    assert e.value.cause == "swap_corrupt"
    assert any("fault 'swap_corrupt': corrupted state.pt" in m for m in logs)


# -- --init-from ---------------------------------------------------------------
def test_init_from_matches_tpuics_init_state_from_torch(jx, folder,
                                                       tmp_path):
    """A seeded torchvision-layout ResNet-18 state dict (5 classes; the
    model's head is 3 wide): the Trainer's weights equal ``tpuic``'s
    ``init_state_from_torch`` result through ``load_jax_variables``, but
    for the shape-skipped out layer, which keeps the Trainer's own
    initialisation; the EMA restarts at the merged weights."""
    v = jx["random_tree"]("resnet18", 5, SIZE)
    sd = jx["tc"].export_state_dict(v["params"], v.get("batch_stats", {}))
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(a))
                               for k, a in sd.items()}}, path)

    @dataclasses.dataclass
    class _JState:
        params: dict
        batch_stats: dict
        ema_params: object = None

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    cur = jx["random_tree"]("resnet18", 3, SIZE, seed=1)
    merged = jx["tc"].init_state_from_torch(
        _JState(cur["params"], cur["batch_stats"]), path, "resnet18",
        log=lambda m: None)
    want = create_model("resnet18", 3, dtype="float32", image_size=SIZE,
                        device="cpu")
    load_jax_variables(want, {"params": merged.params,
                              "batch_stats": merged.batch_stats})
    cfg = _cfg(folder, str(tmp_path / "ck"), init_from=path)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, name="resnet18",
                                       num_classes=3),
        optim=dataclasses.replace(cfg.optim, ema_decay=0.9))
    logs = []
    trainer = Trainer(cfg, device="cpu", log=logs.append)
    got = trainer.model.state_dict()
    fresh = _quiet(dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, init_from="", ckpt_dir=str(tmp_path / "ck2"))))
    init = fresh.model.state_dict()
    # The 5-class out layer is shape-skipped on both sides.
    for k, t in want.state_dict().items():
        skipped = k.startswith("head.out.")
        assert torch.equal(got[k], init[k] if skipped else t), k
    for e, p in zip(trainer.state.ema_params, trainer.model.parameters()):
        assert torch.equal(e, p)
    assert any("[init] " + path in m and "param" in m for m in logs)


# -- the signal handlers and the supervisor ---------------------------------------
def test_the_latch_sits_beside_the_flight_recorder(tmp_path):
    """Under supervision the flight recorder dumps on SIGQUIT; the
    SIGTERM latch, installed over it for fit's span, leaves that dump
    working and gives SIGTERM back when its span ends."""
    from tpuic_torch.telemetry import flight
    from tpuic_torch.telemetry.events import bus, publish
    dump = tmp_path / "flight.jsonl"
    quit_prev = signal.getsignal(signal.SIGQUIT)
    term_prev = signal.getsignal(signal.SIGTERM)
    rec = flight.FlightRecorder(str(dump))
    unsub = rec.subscribe(bus)
    assert rec.install_signal_handler()
    try:
        guard = PreemptionGuard().install()
        publish("step", step=1, total_ms=1.0)
        os.kill(os.getpid(), signal.SIGQUIT)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
        with open(dump) as f:
            lines = [json.loads(ln) for ln in f]
        assert lines[-1]["reason"] == "sigquit"
        guard.uninstall()
        assert signal.getsignal(signal.SIGTERM) == term_prev
    finally:
        unsub()
        signal.signal(signal.SIGQUIT, quit_prev)
        signal.signal(signal.SIGTERM, term_prev)


def test_supervised_sigterm_is_a_preemption_and_resumes(folder, tmp_path):
    """``python -m tpuic_torch.supervise --chaos sigterm@2`` over the train
    CLI: the first life flushes and exits 43 (booked ``preempted``), the
    second resumes at epoch 0 step 2 with a ``restart`` line and exits 0;
    the supervisor exits 0."""
    state = tmp_path / "state"
    out = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.supervise", "--state-dir",
         str(state), "--poll-s", "0.05", "--backoff-s", "0.01", "--chaos",
         "sigterm@2", "--", sys.executable, "-m", "tpuic_torch.train",
         "--datadir", folder, "--device", "cpu", "--epochs", "1", "--model",
         "resnet18-cifar", "--resize", str(SIZE), "--batchsize", "4",
         "--optimizer", "sgd", "--lr", "0.05", "--no-class-weights",
         "--milestones", "--dtype", "float32", "--workers", "2",
         "--log-every-steps", "1", "--ckpt-dir", str(tmp_path / "ck")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=subprocess_env(PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    with open(state / "ledger.jsonl") as f:
        ledger = [json.loads(ln) for ln in f]
    exits = [(r["returncode"], r["outcome"]) for r in ledger
             if r["event"] == "exit"]
    assert exits == [(43, "preempted"), (0, "done")]
    assert "resuming epoch 0 at step 2" in out.stdout
    assert "[supervise] restart #1: resumed at epoch 0 step 2" in out.stdout
    assert read_heartbeat(str(state / "heartbeat.json"))["step"] == 3


def test_a_sigtermed_supervised_trainer_is_booked_preempted(folder,
                                                            tmp_path):
    """SIGTERM to a supervised trainer (the scheduler's eviction of one
    process): it finishes its step, flushes ``latest`` at that step and
    exits 43; the supervisor books it ``preempted``, restarts it at once,
    and the next life resumes at that step and exits 0."""
    state = tmp_path / "state"
    ckpt = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuic_torch.supervise", "--state-dir",
         str(state), "--poll-s", "0.05", "--heartbeat-interval-s", "0",
         "--chaos", "slow_step#1.0", "--",
         sys.executable, "-m", "tpuic_torch.train", "--datadir", folder,
         "--device", "cpu", "--epochs", "1", "--model", "resnet18-cifar",
         "--resize", str(SIZE), "--batchsize", "4", "--optimizer", "sgd",
         "--lr", "0.05", "--no-class-weights", "--milestones", "--dtype",
         "float32", "--workers", "2", "--log-every-steps", "1",
         "--ckpt-dir", str(ckpt)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=subprocess_env(PYTHONPATH=str(ROOT)))
    deadline = time.monotonic() + 120
    beat = None
    while time.monotonic() < deadline:
        beat = read_heartbeat(str(state / "heartbeat.json"))
        if beat is not None and (beat.get("step") or 0) >= 1:
            break
        time.sleep(0.05)
    os.kill(beat["pid"], signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    with open(state / "ledger.jsonl") as f:
        exits = [json.loads(ln) for ln in f if '"exit"' in ln]
    assert [(r["returncode"], r["outcome"]) for r in exits] == [
        (43, "preempted"), (0, "done")]
    flushed = out.split("[preempt] signal received during epoch 0 (step ")
    done = int(flushed[1].split("/")[0])
    assert 1 <= done < 3
    assert f"resuming epoch 0 at step {done}" in out
