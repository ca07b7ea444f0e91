"""Port parity: preemption and step-exact resume (``tpuic/train/loop.py``,
``tpuic/runtime/preemption.py``, ``tpuic/data/pipeline.py``'s
``start_step``), against ``tpuic`` where it has the same function.

- ``Loader.epoch(e, start_step)``: the indices, labels and images of
  ``tpuic``'s ``Loader`` on the same folder and seed, on the decode path,
  and the packed paths' own uninterrupted batches from that step; an
  offset outside the epoch raises.
- ``_validated_start_step``: ``tpuic``'s decisions and messages on the
  same geometry cases.
- ``agree`` ORs the latch over two gloo processes (one process: the flag
  as it is); the SIGTERM latch chains to the handler that was there.
- A preempted ``fit`` on ``resnet18-cifar`` at 32 px, resumed, ends on the
  uninterrupted run's bits (parameters, BN statistics, the optimizer
  state, ``step``); a flush at the epoch's last step resumes into the
  pending val pass (``tests/test_preemption.py:161``); a changed global
  batch replays the epoch.
- The train CLI under ``TPUIC_FAULTS=sigterm@K`` exits 43 with ``latest``
  at step K, and the same command resumes there and ends on the
  uninterrupted run's bits.

``tpuic`` is imported in fixtures.
"""

import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.pack import pack_dataset
from tpuic_torch.data.pipeline import Loader
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.runtime.preemption import PreemptionGuard, agree
from tpuic_torch.train.loop import Trainer
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 32


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test's checkpoints (~90 MB a save of resnet18-cifar with its
    optimizer state) leave the disk when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jx():
    from tpuic import config
    from tpuic.data import folder, pipeline
    from tpuic.train import loop
    return {"cfg": config, "folder": folder, "pipe": pipeline, "loop": loop}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 classes: 8 train images a class (batch 4: 6 steps an epoch) and
    2 val images a class."""
    root = str(tmp_path_factory.mktemp("preempt_data"))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=8,
                               size=SIZE, folds=("train",))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=2,
                               size=SIZE, folds=("val",), seed=1)
    return root


def _cfg(folder, ckpt_dir, epochs=2, resize=SIZE, batch=4):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=folder, resize_size=resize,
                             batch_size=batch, num_workers=2),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=0,
                               dtype="float32", fused_conv_bn=True),
        optim=pcfg.OptimConfig(optimizer="lars", learning_rate=0.5,
                               milestones=(), class_weights=(),
                               weight_decay=1e-4, label_smoothing=0.1,
                               fused_loss=True, fused_optimizer=True),
        run=pcfg.RunConfig(epochs=epochs, ckpt_dir=ckpt_dir, save_period=1,
                           log_every_steps=1, seed=0))


def _quiet(cfg):
    return Trainer(cfg, device="cpu", log=lambda m: None)


def _trip_after(trainer, n_steps):
    """Latch the trainer's preemption after ``n_steps`` step calls;
    returns the call list."""
    inner, calls = trainer.train_step, []

    def step(state, batch, **kw):
        out = inner(state, batch, **kw)
        calls.append(1)
        if len(calls) == n_steps:
            trainer.preemption.trigger()
        return out

    trainer.train_step = step
    return calls


def _tensors(trainer) -> dict:
    st = trainer.state
    out = dict(trainer.model.state_dict())
    out.update({f"trace.{i}": t for i, t in enumerate(st.opt_state.trace)})
    out.update(count=st.opt_state.count, step=st.step,
               skip_count=st.skip_count)
    return out


def _assert_same_bits(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the Loader's start_step --------------------------------------------------
def test_loader_start_step_matches_tpuics(jx, folder):
    """Decode path: ``tpuic``'s batches from ``start_step`` on, bit for
    bit (images, labels, masks, indices, ids); nothing before it."""
    jd = jx["cfg"].DataConfig(data_dir=folder, resize_size=SIZE,
                              native=False, pack=False)
    pd = pcfg.DataConfig(data_dir=folder, resize_size=SIZE, native=False,
                         pack=False)
    kw = dict(drop_last=True, seed=5)
    jl = jx["pipe"].Loader(jx["folder"].ImageFolderDataset(
        folder, "train", SIZE, jd), 4, None, num_workers=2,
        process_index=0, process_count=1, **kw)
    pl = Loader(ImageFolderDataset(folder, "train", SIZE, pd), 4,
                num_workers=2, device="cpu", **kw)
    for epoch, start in ((0, 0), (0, 4), (1, 2), (1, 6)):
        jb = list(jl.epoch(epoch, start_step=start))
        pb = list(pl.epoch(epoch, start_step=start))
        assert len(jb) == len(pb) == len(pl) - start
        for a, b in zip(jb, pb):
            for key in ("image", "label", "mask"):
                np.testing.assert_array_equal(b[key].numpy(),
                                              np.asarray(a[key]))
            np.testing.assert_array_equal(b.indices, a.indices)
            assert b.image_ids == a.image_ids
    for bad in (-1, len(pl) + 1):
        with pytest.raises(ValueError, match=f"start_step {bad} outside"):
            next(iter(pl.epoch(0, start_step=bad)))
        with pytest.raises(ValueError, match=f"start_step {bad} outside"):
            next(iter(jl.epoch(0, start_step=bad)))


@pytest.mark.parametrize("cache_mb", [4096, 0], ids=["resident",
                                                     "streaming"])
def test_packed_start_step_serves_the_uninterrupted_remainder(folder,
                                                              tmp_path,
                                                              cache_mb):
    """The packed paths: the batches from ``start_step`` equal the
    uninterrupted epoch's from that step, bit for bit, and the skipped
    ones draw nothing (a row's draws are ``(seed, epoch, index)``'s)."""
    pd = pcfg.DataConfig(data_dir=folder, resize_size=SIZE,
                         device_cache_mb=cache_mb)
    packed = pack_dataset(ImageFolderDataset(folder, "train", SIZE, pd),
                          str(tmp_path / "c"), verbose=False)
    loader = Loader(packed, 4, device="cpu", seed=3, drop_last=True,
                    device_cache_bytes=cache_mb << 20)
    assert loader.resident == bool(cache_mb)
    whole = list(loader.epoch(1))
    drawn = []
    real = loader._draw_params
    loader._draw_params = lambda idx, e: (drawn.append(list(idx)),
                                          real(idx, e))[1]
    part = list(loader.epoch(1, start_step=3))
    assert len(part) == len(whole) - 3 and len(drawn) == len(part)
    for a, b in zip(whole[3:], part):
        for key in ("image", "label", "mask"):
            assert torch.equal(a[key], b[key])
        np.testing.assert_array_equal(a.indices, b.indices)
    assert list(loader.epoch(1, start_step=len(loader))) == []


# -- the resume's decisions ----------------------------------------------------
GEOMETRY_CASES = [
    # (step_in_epoch, saved geometry, live geometry, steps an epoch)
    (0, (16, 0, 48), (16, 0, 48), 3),
    (2, (16, 0, 48), (16, 0, 48), 3),
    (3, (16, 0, 48), (16, 0, 48), 3),
    (2, (12, 0, 48), (16, 0, 48), 3),
    (2, (16, 1, 48), (16, 0, 48), 3),
    (2, (16, 0, 40), (16, 0, 48), 3),
    (2, (-1, -1, -1), (16, 0, 48), 3),
    (4, (16, 0, 48), (16, 0, 48), 3),
    (None, None, (16, 0, 48), 3),
]


@pytest.mark.parametrize("case", GEOMETRY_CASES,
                         ids=[f"case{i}" for i in range(len(GEOMETRY_CASES))])
def test_validated_start_step_matches_tpuics(jx, case, capsys):
    """The same offset, and the same message, as ``tpuic``'s method on
    the same restored checkpoint and loader geometry."""
    sie, saved, live, steps = case
    gb, seed, n = live
    stub = types.SimpleNamespace(
        ckpt=types.SimpleNamespace(last_restore_step_in_epoch=sie,
                                   last_restore_geometry=saved,
                                   last_restore_meta=(1, sie)),
        train_loader=type("L", (), {
            "global_batch": gb, "seed": seed, "dataset": [None] * n,
            "__len__": lambda self: steps})())
    logs = []
    stub.log = logs.append
    stub._loader_geometry = types.MethodType(Trainer._loader_geometry, stub)
    want = jx["loop"].Trainer._validated_start_step(stub)
    printed = capsys.readouterr().out.strip()
    got = Trainer._validated_start_step(stub)
    assert got == want
    assert "\n".join(logs) == printed


# -- agree and the latch ---------------------------------------------------------
def test_agree_ors_the_latch_across_two_gloo_processes(tmp_path):
    assert agree(True) is True and agree(False) is False
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import json, sys, torch.distributed as dist\n"
        "from tpuic_torch.runtime.preemption import agree\n"
        "rank = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='tcp://localhost:"
        f"{port}', world_size=2, rank=rank)\n"
        "got = [agree(rank == 1), agree(False), agree(True), agree(rank == 0)]\n"
        "dist.destroy_process_group()\n"
        "print(json.dumps(got))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT,
                              env=subprocess_env(PYTHONPATH=str(ROOT)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert json.loads(out.strip().splitlines()[-1]) == [True, False,
                                                            True, True]


def test_guard_latches_sigterm_and_chains():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        g = PreemptionGuard().install()
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.triggered and seen == [signal.SIGTERM]
        g.uninstall()
        assert signal.getsignal(signal.SIGTERM) is not g._handler
    finally:
        signal.signal(signal.SIGTERM, prev)


# -- the Trainer's flush and resume --------------------------------------------
def test_preempted_fit_resumes_bit_for_bit(folder, tmp_path):
    """resnet18-cifar at 32 px: a run latched after 2 steps of epoch 1
    flushes ``latest`` at (epoch 1, step 2) and returns; the resumed run
    continues there (no step replayed, none skipped) and ends on the
    uninterrupted run's bits."""
    straight = _quiet(_cfg(folder, str(tmp_path / "a")))
    steps = straight.train_loader.steps_per_epoch()
    assert steps == 6
    straight.fit()
    first = _quiet(_cfg(folder, str(tmp_path / "b")))
    calls = _trip_after(first, steps + 2)
    from tpuic_torch.kernels import counted_kernels
    from tpuic_torch.telemetry.events import bus
    events = []
    unsub = bus.subscribe(lambda ev: events.append((ev.kind, dict(ev.data))),
                          kinds=("preempt", "kernel_launches"))
    try:
        first.fit()
    finally:
        unsub()
    assert first.preemption.triggered and len(calls) == steps + 2
    # The committed flush's event, then the span's launches (none on the
    # CPU, where every wrapper runs its plain version).
    assert [k for k, _ in events] == ["preempt", "kernel_launches"]
    flush = events[0][1]
    assert (flush["epoch"], flush["step_in_epoch"], flush["step"]) == \
        (1, 2, steps + 2)
    assert 0 <= flush["flush_s"] < 60
    assert events[1][1] == {fn.__name__: 0 for fn in counted_kernels()}
    with open(tmp_path / "b" / "resnet18-cifar" / "latest.meta.json") as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["step_in_epoch"]) == (1, 2)
    assert (meta["global_batch"], meta["data_seed"],
            meta["data_len"]) == (4, 0, 24)
    resumed = _quiet(_cfg(folder, str(tmp_path / "b")))
    assert (resumed.start_epoch, resumed.start_step) == (1, 2)
    assert resumed._steps_done == steps + 2
    calls2 = _trip_after(resumed, 10 ** 9)
    resumed.fit()
    assert len(calls) + len(calls2) == 2 * steps
    _assert_same_bits(_tensors(straight), _tensors(resumed))


def test_resume_after_a_skipped_step_keeps_the_step_numbers(
        folder, tmp_path, monkeypatch):
    """A NaN step below the threshold (skipped: ``state.step`` falls one
    behind the steps run), a flush at epoch 1 step 2, a resume: the fault
    points see the same global step numbers as the uninterrupted run, the
    ``max_steps`` budget ends both after the same 10 steps, and the two
    end on the same bits."""
    from tpuic_torch.runtime import faults
    seen = []
    fire = faults.fire

    def spy(point, step=None):
        if point == "slow_step":
            seen.append(step)
        return fire(point, step)

    monkeypatch.setattr(faults, "fire", spy)

    def cfg(ckpt):
        c = _cfg(folder, str(tmp_path / ckpt))
        return dataclasses.replace(
            c, run=dataclasses.replace(c.run, max_steps=10))

    try:
        faults.arm("nan_batch", steps={1})
        straight = _quiet(cfg("a"))
        straight.fit()
        keys_straight, seen[:] = list(seen), []
        faults.reset()
        faults.arm("nan_batch", steps={1})
        first = _quiet(cfg("b"))
        calls = _trip_after(first, 8)
        first.fit()
        faults.reset()
        assert int(first.state.step) == 7  # the NaN step was skipped
        resumed = _quiet(cfg("b"))
        assert (resumed.start_epoch, resumed.start_step) == (1, 2)
        assert resumed._steps_done == 8
        calls2 = _trip_after(resumed, 10 ** 9)
        resumed.fit()
    finally:
        faults.reset()
    assert keys_straight == list(range(10))
    assert seen == keys_straight
    assert len(calls) + len(calls2) == 10
    _assert_same_bits(_tensors(straight), _tensors(resumed))


def test_boundary_preemption_resumes_into_pending_val(folder, tmp_path):
    """Latched on the epoch's last step: the flush records every step
    done and no val ran (no ``best``); the resume trains none of that
    epoch, runs its pending val pass (``best`` saved), then epoch 1."""
    ckpt = str(tmp_path / "ck")
    trainer = _quiet(_cfg(folder, ckpt, resize=16))
    steps = trainer.train_loader.steps_per_epoch()
    _trip_after(trainer, steps)
    trainer.fit()
    root = os.path.join(ckpt, "resnet18-cifar")
    with open(os.path.join(root, "latest.meta.json")) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["best_score"]) == (0, 0.0)
    assert meta["step_in_epoch"] == steps and meta["global_batch"] == 4
    assert not os.path.isdir(os.path.join(root, "best"))
    resumed = _quiet(_cfg(folder, ckpt, resize=16))
    assert (resumed.start_epoch, resumed.start_step) == (0, steps)
    order = []
    inner, val = resumed.train_step, resumed.val_epoch
    resumed.train_step = lambda *a, **k: (order.append("step"),
                                          inner(*a, **k))[1]
    resumed.val_epoch = lambda e: (order.append(f"val{e}"), val(e))[1]
    resumed.fit()
    assert order == ["val0"] + ["step"] * steps + ["val1"]
    with open(os.path.join(root, "latest.meta.json")) as f:
        assert json.load(f)["epoch"] == 1


def test_resume_with_changed_global_batch_replays_epoch(folder, tmp_path):
    ckpt = str(tmp_path / "ck")
    trainer = _quiet(_cfg(folder, ckpt, epochs=3, resize=16))
    _trip_after(trainer, trainer.train_loader.steps_per_epoch() + 1)
    trainer.fit()
    logs = []
    resumed = Trainer(_cfg(folder, ckpt, epochs=3, resize=16, batch=3),
                      device="cpu", log=logs.append)
    assert (resumed.start_epoch, resumed.start_step) == (1, 0)
    assert any("replaying epoch 1 from its start" in m for m in logs)


def test_preemption_before_the_first_step_resumes_at_zero(folder, tmp_path):
    ckpt = str(tmp_path / "ck")
    trainer = _quiet(_cfg(folder, ckpt, resize=16))
    trainer.preemption.install()
    trainer.preemption.trigger()
    trainer.fit()
    assert trainer.last_epoch_steps == 0
    resumed = _quiet(_cfg(folder, ckpt, resize=16))
    assert (resumed.start_epoch, resumed.start_step) == (0, 0)


# -- the CLI: exit 43, then the same command -----------------------------------
def _cli(args, **env):
    return subprocess.run([sys.executable, "-m", "tpuic_torch.train", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=subprocess_env(PYTHONPATH=str(ROOT), **env))


def test_cli_sigterm_exits_43_and_the_same_command_resumes(folder, tmp_path):
    """``TPUIC_FAULTS=sigterm@3`` (resnet18-cifar, 16 px, the fused loss
    and LARS, the packed resident path): exit 43 with ``latest``
    committed at epoch 0 step 3; the same command resumes there, exits 0
    and ends on an uninterrupted ``Trainer``'s bits."""
    ckpt = str(tmp_path / "ck")
    args = ["--datadir", folder, "--device", "cpu", "--epochs", "1",
            "--model", "resnet18-cifar", "--resize", "16", "--batchsize",
            "4", "--optimizer", "lars", "--lr", "0.5", "--weight-decay",
            "1e-4", "--label-smoothing", "0.1", "--no-class-weights",
            "--milestones", "--fused-loss", "--fused-optimizer",
            "--fused-conv-bn", "--dtype", "float32", "--workers", "2",
            "--save-period", "1", "--log-every-steps", "1", "--ckpt-dir",
            ckpt]
    out = _cli(args, TPUIC_FAULTS="sigterm@3")
    assert out.returncode == 43, out.stderr[-3000:]
    assert "[preempt] signal received during epoch 0 (step 3/6)" in out.stdout
    with open(os.path.join(ckpt, "resnet18-cifar",
                           "latest.manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["epoch"], manifest["step_in_epoch"],
            manifest["step"]) == (0, 3, 3)
    out = _cli(args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resuming epoch 0 at step 3" in out.stdout
    assert "Epoch: 0; step 4;" in out.stdout
    straight = _quiet(_cfg(folder, str(tmp_path / "straight"), epochs=1,
                           resize=16))
    straight.fit()
    saved = torch.load(os.path.join(ckpt, "resnet18-cifar", "latest",
                                    "state.pt"), weights_only=True)
    for k, t in straight.model.state_dict().items():
        assert torch.equal(saved["model"][k], t), k
    assert int(saved["step"]) == int(straight.state.step) == 6
