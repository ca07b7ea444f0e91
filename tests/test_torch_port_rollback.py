"""Port parity: the non-finite rollback (``tpuic/train/loop.py:774-814``,
``:915-995``) and its LR re-warm.

- A NaN streak (``nan_batch`` on the prepared images) past
  ``skip_threshold``: the guard skips (the parameters stay), the drain
  flags a rollback, ``fit`` restores the last good checkpoint through
  ``restore_into`` (the restored ``step`` is the checkpoint's), one
  ``rollback`` event, and the replayed steps' logged ``lr`` is
  ``tpuic``'s ``make_schedule`` times its ``rewarm_scale`` at the
  restored step; the optimizer applies the same ramp.
- ``max_rollbacks`` overrun and a rollback with no checkpoint raise
  ``NonRetryableError``, and the train CLI exits 44; ``rollback=False``
  keeps skipping.

``tpuic`` is imported in fixtures.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.runtime import faults
from tpuic_torch.runtime.supervisor import EXIT_POISON, NonRetryableError
from tpuic_torch.telemetry.events import bus
from tpuic_torch.train.loop import Trainer
from tpuic_torch.train.optimizer import rewarm_scale
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 16
STEPS = 6  # an epoch: 24 train images at batch 4


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test's checkpoints (~90 MB a save of resnet18-cifar with its
    optimizer state) leave the disk when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jx():
    from tpuic import config
    from tpuic.train import optimizer
    return {"cfg": config, "opt": optimizer}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rollback_data"))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=8,
                               size=SIZE, folds=("train",))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=2,
                               size=SIZE, folds=("val",), seed=1)
    return root


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


OPTIM = dict(optimizer="sgd", learning_rate=0.05, warmup_epochs=1,
             milestones=(), class_weights=(), weight_decay=1e-4)


def _cfg(folder, ckpt_dir, epochs=2, **run):
    run = dict(dict(epochs=epochs, ckpt_dir=ckpt_dir, save_period=1,
                    log_every_steps=1, seed=0, skip_threshold=3,
                    rollback_rewarm_steps=4), **run)
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=folder, resize_size=SIZE, batch_size=4,
                             num_workers=2),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=0,
                               dtype="float32"),
        optim=pcfg.OptimConfig(**OPTIM),
        run=pcfg.RunConfig(**run))


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


def test_rewarm_scale_matches_tpuics(jx):
    for s0, n in ((0, 1), (8, 4), (13, 5)):
        port, theirs = rewarm_scale(s0, n), jx["opt"].rewarm_scale(s0, n)
        for t in range(max(0, s0 - 2), s0 + n + 3):
            assert float(port(torch.tensor(t, dtype=torch.int32))) == \
                pytest.approx(float(theirs(np.int32(t))), rel=1e-7)


def test_nan_streak_rolls_back_and_rewarms_as_tpuics_composite(jx, folder,
                                                             tmp_path):
    """Steps 8-11 poisoned once each (epoch 1's steps 2-5): the guard
    skips them, the streak reaches 3, the run restores epoch 0's
    ``latest`` (step 6) and replays epoch 1 from its first step with the
    ramped LR, which is what the optimizer applies."""
    events = []
    unsub = bus.subscribe(lambda ev: events.append((ev.kind, dict(ev.data))),
                          kinds=("rollback", "skip"))
    logs = []
    trainer = Trainer(_cfg(folder, str(tmp_path / "ck")), device="cpu",
                      log=logs.append)
    faults.arm("nan_batch", steps=range(8, 12), times=4)
    seen = {}
    inner = trainer.train_step
    lrs = []

    def step(state, batch, **kw):
        if bool(torch.isnan(batch["image"]).any()) and "before" not in seen:
            seen["before"] = _params(trainer)
        out = inner(state, batch, **kw)
        return out

    trainer.train_step = step
    rollback = trainer._do_rollback

    def do_rollback():
        seen["at_rollback"] = _params(trainer)
        epoch = rollback()
        seen["restored_step"] = int(trainer.state.step)
        new = trainer.train_step

        def logged(state, batch, **kw):
            s = int(state.step)
            count = int(state.opt_state.count)
            out = new(state, batch, **kw)
            lrs.append((s, float(out[1]["lr"]),
                        float(state.tx.lr(torch.tensor(count)))))
            return out

        trainer.train_step = logged
        return epoch

    trainer._do_rollback = do_rollback
    try:
        trainer.fit()
    finally:
        unsub()
    assert faults.fired("nan_batch") == 4
    # The skipped steps left every parameter as it was.
    for a, b in zip(seen["before"], seen["at_rollback"]):
        assert torch.equal(a, b)
    rollbacks = [d for k, d in events if k == "rollback"]
    assert len(rollbacks) == 1 and trainer.rollbacks == 1
    assert (rollbacks[0]["epoch"], rollbacks[0]["step_in_epoch"],
            rollbacks[0]["rung"]) == (1, 0, "latest")
    # The event says so too: finite parameters, epoch 1's 2 clean steps
    # applied on epoch 0's 6, none of the skipped ones.
    assert rollbacks[0]["params_finite"] is True
    assert rollbacks[0]["applied_steps"] == STEPS + 2
    assert seen["restored_step"] == STEPS
    assert any("[rollback] 3 consecutive non-finite steps" in m for m in logs)
    # tpuic's composite: its schedule times its rewarm_scale at step 6.
    jcfg = jx["cfg"].OptimConfig(**OPTIM)
    base = jx["opt"].make_schedule(jcfg, STEPS, 2, global_batch=4)
    scale = jx["opt"].rewarm_scale(STEPS, 4)
    assert [s for s, _, _ in lrs] == list(range(STEPS, 2 * STEPS))
    for s, logged, applied in lrs:
        want = float(base(np.int32(s)) * scale(np.int32(s)))
        assert logged == pytest.approx(want, rel=1e-6)
        assert applied == pytest.approx(want, rel=1e-6)
    assert lrs[0][1] == pytest.approx(float(base(np.int32(STEPS))) / 4,
                                      rel=1e-6)
    assert trainer.state.skip_count.item() == 0
    assert all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters())


def test_max_rollbacks_overrun_raises_nonretryable(folder, tmp_path):
    trainer = Trainer(_cfg(folder, str(tmp_path / "ck"), max_rollbacks=0),
                      device="cpu", log=lambda m: None)
    faults.arm("nan_batch", steps=range(8, 12))
    with pytest.raises(NonRetryableError, match="rollback #1 exceeds "
                       "run.max_rollbacks=0"):
        trainer.fit()


def test_rollback_without_a_checkpoint_raises_nonretryable(folder,
                                                           tmp_path):
    trainer = Trainer(_cfg(folder, str(tmp_path / "ck")), device="cpu",
                      log=lambda m: None)
    faults.arm("nan_batch", steps=range(0, 4))
    with pytest.raises(NonRetryableError, match="before any checkpoint "
                       "existed"):
        trainer.fit()


def test_no_rollback_keeps_skipping(folder, tmp_path):
    trainer = Trainer(_cfg(folder, str(tmp_path / "ck"), epochs=1,
                           rollback=False), device="cpu", log=lambda m: None)
    faults.arm("nan_batch", steps=range(1, 5))
    trainer.fit()
    assert trainer.rollbacks == 0 and int(trainer.state.step) == 2


def test_cli_exits_44_when_the_rollbacks_run_out(folder, tmp_path):
    """A streak before any checkpoint through the train CLI: exit 44 (the
    poison code: a supervisor stops instead of restarting)."""
    out = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.train", "--datadir", folder,
         "--device", "cpu", "--epochs", "1", "--model", "resnet18-cifar",
         "--resize", str(SIZE), "--batchsize", "4", "--optimizer", "sgd",
         "--lr", "0.05", "--no-class-weights", "--milestones", "--dtype",
         "float32", "--workers", "2", "--log-every-steps", "1",
         "--skip-threshold", "2", "--rewarm-steps", "2", "--ckpt-dir",
         str(tmp_path / "ck")], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=subprocess_env(PYTHONPATH=str(ROOT),
                                        TPUIC_FAULTS="nan_batch@0-5"))
    assert out.returncode == EXIT_POISON, out.stderr[-3000:]
    assert "NON-RETRYABLE" in out.stdout
    assert "[rollback] 2 consecutive non-finite steps" in out.stdout
    assert not os.path.exists(tmp_path / "ck" / "resnet18-cifar" / "latest")
    with open(tmp_path / "ck" / "resnet18-cifar" / "config.json") as f:
        run = json.load(f)["run"]
    assert (run["skip_threshold"], run["rollback_rewarm_steps"],
            run["rollback"]) == (2, 2, True)
