"""Port parity: ``tpuic_torch``'s checkpoints against ``tpuic``'s.

- ``lenient_restore``: the same trees through both; the same counts and
  the same leaves taken, with a shape mismatch and a key missing on either
  side.
- The restore ladder: the same sequence of saves through ``tpuic``'s
  ``CheckpointManager`` (Orbax, run as tests/test_faults.py and
  tests/test_gang.py run it) and the port's, each in its own directory;
  then corruption of the newest rung's payload, and ``TPUIC_RESUME_STEP``.
  Both pick the same rung and return the same ``(start_epoch,
  best_score)``.
- Resume: a ``Trainer`` on a tiny synthetic folder (augmentation on)
  trains 2 of 3 epochs, a new one resumes and trains the third; its
  weights and optimizer state equal a 3-epoch uninterrupted run's bit for
  bit.
- The payload loads with ``torch.load(..., weights_only=True)``; the
  commit writes the manifest, the sidecars and the ``.prev`` rotation.

JAX and ``tpuic`` are imported inside fixtures, so this file collects
where JAX is not installed.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from tpuic_torch import config as pcfg
from tpuic_torch.checkpoint import (CheckpointManager,
                                    load_inference_variables,
                                    lenient_restore, variables_digest)
from tpuic_torch.checkpoint.manager import ENV_RESUME_STEP, PAYLOAD
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.train.loop import Trainer
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from flax import linen as fnn
    from tpuic.checkpoint import manager as jmanager
    from tpuic.config import OptimConfig
    from tpuic.runtime import faults
    from tpuic.train.optimizer import make_optimizer as jopt
    from tpuic.train.state import create_train_state as jstate

    class Small(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.Dense(3)(x.reshape((x.shape[0], -1)))

    def state(seed):
        ocfg = OptimConfig(optimizer="adam", learning_rate=1e-3,
                           class_weights=(), milestones=())
        return jstate(Small(), jopt(ocfg), jax.random.key(seed),
                      (2, 2, 2, 3))

    return dict(jax=jax, manager=jmanager, faults=faults, state=state)


def _port_state(seed):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Flatten(), nn.Linear(12, 3))
    ocfg = pcfg.OptimConfig(optimizer="adam", learning_rate=1e-3,
                            class_weights=(), milestones=())
    return create_train_state(model, make_optimizer(ocfg))


def _flip_byte(path, offset=64):
    """One byte of ``path`` XOR 0xFF, the size kept: only the CRC sees it."""
    with open(path, "r+b") as f:
        f.seek(min(offset, os.path.getsize(path) - 1))
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _newest_payload_file(track_dir):
    """The largest file of a committed track: the payload."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(track_dir)
             for f in fs]
    return max(files, key=os.path.getsize)


# -- lenient_restore ----------------------------------------------------------
LENIENT_CASES = {
    "same": ({"a": (2,), "b": {"c": (3, 4)}}, {"a": (2,), "b": {"c": (3, 4)}}),
    "missing_in_saved": ({"a": (2,), "b": {"c": (3,)}, "new": (4,)},
                         {"a": (2,), "b": {"c": (3,)}}),
    "missing_in_current": ({"a": (2,)}, {"a": (2,), "old": (5,)}),
    "shape_mismatch": ({"w": (2, 2), "b": (2,)}, {"w": (3, 3), "b": (2,)}),
    "all_three": ({"w": (2, 2), "b": (2,), "new": {"x": (1,)}},
                  {"w": (2, 3), "b": (2,), "old": (7,)}),
}


def _tree(shapes, fill, prefix=""):
    out = {}
    for k, v in shapes.items():
        out[k] = (_tree(v, fill, prefix + k + ".") if isinstance(v, dict)
                  else np.full(v, fill(prefix + k), np.float32))
    return out


def _dotted(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, prefix + k + "."))
        else:
            out[prefix + k] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("case", sorted(LENIENT_CASES))
def test_lenient_restore_matches_tpuic(jx, case):
    cur_shapes, saved_shapes = LENIENT_CASES[case]
    current = _tree(cur_shapes, lambda name: 0.0)
    saved = _tree(saved_shapes, lambda name: 1.0 + len(name))
    want, want_loaded, want_total = jx["manager"].lenient_restore(current,
                                                                  saved)
    got, loaded, total = lenient_restore(_dotted(current), _dotted(saved))
    assert (loaded, total) == (want_loaded, want_total)
    want_flat = _dotted(jx["jax"].tree.map(np.asarray, want))
    assert sorted(got) == sorted(want_flat)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want_flat[name].numpy())


# -- the restore ladder -------------------------------------------------------
# Saves as (track, epoch, best, step, step_in_epoch); then the rungs to
# corrupt (each: the payload of the newest rung left, or a manifest), and
# the TPUIC_RESUME_STEP cap.
LADDER = {
    "healthy": ([("best", 0, 5.0, 2, -1), ("latest", 1, 5.0, 4, -1),
                 ("latest", 2, 5.0, 6, -1)], [], None),
    "corrupt_latest": ([("best", 0, 5.0, 2, -1), ("latest", 1, 5.0, 4, -1),
                        ("latest", 2, 5.0, 6, -1)], ["latest"], None),
    "corrupt_latest_and_best": ([("best", 0, 5.0, 2, -1),
                                 ("latest", 1, 5.0, 4, -1),
                                 ("latest", 2, 5.0, 6, -1)],
                                ["latest", "best"], None),
    "best_newer": ([("latest", 0, 1.0, 2, -1), ("best", 3, 9.0, 8, -1)],
                   [], None),
    "cap": ([("best", 0, 5.0, 2, -1), ("latest", 1, 5.0, 4, -1),
             ("latest", 2, 5.0, 6, -1)], [], 5),
    "cap_corrupt": ([("best", 0, 5.0, 2, -1), ("latest", 1, 5.0, 4, -1),
                     ("latest", 2, 5.0, 6, -1)], ["latest.prev"], 5),
    "cap_mid_epoch": ([("best", 0, 50.0, 6, -1),
                       ("latest", 1, 50.0, 9, 3)], [], 6),
    "cap_below_all": ([("best", 0, 50.0, 6, -1),
                       ("latest", 1, 50.0, 9, 3)], [], 3),
    "mid_epoch": ([("best", 0, 50.0, 6, -1), ("latest", 1, 50.0, 9, 3)],
                  [], None),
}


def _run_ladder(mgr, make_state, set_step, saves, corrupt, cap, monkeypatch,
                payload_of):
    for track, epoch, best, step, sie in saves:
        state = set_step(make_state(epoch), step)
        if track == "best":
            mgr.save_best(state, epoch, best)
        else:
            mgr.save_latest(state, epoch, best, step_in_epoch=sie)
    mgr.wait()
    for rung in corrupt:
        _flip_byte(payload_of(os.path.join(mgr.root, rung)))
    if cap is not None:
        monkeypatch.setenv(ENV_RESUME_STEP, str(cap))
    try:
        _, start_epoch, best = mgr.restore_into(make_state(9))
    finally:
        monkeypatch.delenv(ENV_RESUME_STEP, raising=False)
    return mgr.last_restore_rung, start_epoch, best


@pytest.mark.parametrize("case", sorted(LADDER))
def test_ladder_picks_the_same_rung_as_tpuic(jx, tmp_path, monkeypatch,
                                             case):
    saves, corrupt, cap = LADDER[case]
    monkeypatch.delenv(ENV_RESUME_STEP, raising=False)
    want = _run_ladder(
        jx["manager"].CheckpointManager(str(tmp_path / "jax"), "m"),
        jx["state"], lambda s, step: s.replace(step=np.asarray(step)),
        saves, corrupt, cap, monkeypatch,
        # tpuic_faults-style: the largest file of the Orbax directory.
        _newest_payload_file)

    def set_step(s, step):
        s.step.fill_(step)
        return s

    got = _run_ladder(
        CheckpointManager(str(tmp_path / "port"), "m", log=lambda m: None),
        _port_state, set_step, saves, corrupt, cap, monkeypatch,
        lambda d: os.path.join(d, PAYLOAD))
    assert got == want


def test_restore_missing_is_noop_and_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "m", log=lambda m: None)
    state = _port_state(0)
    before = [p.clone() for p in state.model.parameters()]
    assert mgr.restore_into(state)[1:] == (0, 0.0)
    assert mgr.last_restore_rung is None
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 state.model.parameters()))
    mgr.save_latest(state, 0, 1.0)
    mgr.save_latest(state, 1, 1.0)
    for rung in ("latest", "latest.prev"):
        _flip_byte(os.path.join(mgr.root, rung, PAYLOAD))
    with pytest.raises(RuntimeError, match="every integrity-ladder rung"):
        mgr.restore_into(_port_state(1))


# -- the payload and the commit -----------------------------------------------
@pytest.mark.parametrize("async_commit", [False, True])
def test_payload_weights_only_manifest_and_rotation(tmp_path, async_commit):
    mgr = CheckpointManager(str(tmp_path), "m", save_period=2,
                            async_commit=async_commit, log=lambda m: None)
    a, b = _port_state(0), _port_state(1)
    a.step.fill_(3)
    mgr.maybe_save_latest(a, epoch=1, best_score=0.0)  # 1 % 2: no save
    mgr.wait()
    assert not os.path.isdir(os.path.join(mgr.root, "latest"))
    mgr.maybe_save_latest(a, epoch=0, best_score=7.5)  # epoch 0 saves
    # The save holds a host copy: changing the live state after it
    # returns does not reach the file.
    with torch.no_grad():
        for p in a.model.parameters():
            p.add_(1.0)
    mgr.save_latest(b, epoch=2, best_score=8.5, step_in_epoch=4,
                    global_batch=16, data_seed=3, data_len=99)
    mgr.wait()
    root = mgr.root
    assert sorted(os.listdir(root)) == sorted(
        ["latest", "latest.manifest.json", "latest.meta.json", "latest.prev",
         "latest.prev.manifest.json", "latest.prev.meta.json"])
    payload = torch.load(os.path.join(root, "latest.prev", PAYLOAD),
                         weights_only=True)
    assert sorted(payload) == ["meta", "model", "opt_state", "skip_count",
                               "step"]
    assert sorted(payload["opt_state"]) == ["count", "mu", "nu"]
    for name, t in a.model.state_dict().items():
        assert torch.equal(payload["model"][name] + 1.0, t)
    assert int(payload["step"]) == 3 and payload["meta"]["epoch"] == 0
    with open(os.path.join(root, "latest.manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["version"] == 1 and manifest["step_in_epoch"] == 4
    assert (manifest["epoch"], manifest["step"]) == (2, 0)
    assert list(manifest["files"]) == [PAYLOAD]
    assert manifest["files"][PAYLOAD][0] == os.path.getsize(
        os.path.join(root, "latest", PAYLOAD))
    with open(os.path.join(root, "latest.meta.json")) as f:
        assert json.load(f) == {"epoch": 2, "best_score": 8.5,
                                "step_in_epoch": 4, "global_batch": 16,
                                "data_seed": 3, "data_len": 99}
    assert mgr.verify_track("latest")[0]
    # A mid-epoch save restores to its epoch, with the meta keys back.
    _, start, best = mgr.restore_into(_port_state(5))
    assert (start, best) == (2, 8.5)
    assert mgr.last_restore_step_in_epoch == 4
    assert mgr.last_restore_geometry == (16, 3, 99)
    assert mgr.last_save["bytes"] == os.path.getsize(
        os.path.join(root, "latest", PAYLOAD))


# -- resume through the Trainer -----------------------------------------------
@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_data")
    make_synthetic_imagefolder(str(root), classes=("a", "b", "c"),
                               per_class=4, size=16, folds=("train",))
    make_synthetic_imagefolder(str(root), classes=("a", "b", "c"),
                               per_class=2, size=16, folds=("val",), seed=1)
    return str(root)


def _cfg(folder, ckpt_dir, epochs=3):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=folder, resize_size=16, batch_size=4,
                             num_workers=2, native=False, pack=False),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=0,
                               dtype="float32", fused_conv_bn=True),
        optim=pcfg.OptimConfig(optimizer="lars", learning_rate=0.5,
                               milestones=(), class_weights=(),
                               weight_decay=1e-4, label_smoothing=0.1,
                               fused_loss=True, fused_optimizer=True),
        run=pcfg.RunConfig(epochs=epochs, ckpt_dir=ckpt_dir, save_period=1,
                           log_every_steps=1, seed=0))


def _tensors(trainer):
    st = trainer.state
    out = dict(trainer.model.state_dict())
    out.update({f"trace.{i}": t for i, t in enumerate(st.opt_state.trace)})
    out.update(count=st.opt_state.count, step=st.step,
               skip_count=st.skip_count)
    return out


def test_resumed_training_equals_uninterrupted(folder, tmp_path):
    """2 epochs, a new Trainer resumes, 1 more: the weights, BN statistics
    and optimizer state equal a 3-epoch run's bit for bit (augmentation
    on; the batches are functions of the seed, the epoch and the index)."""
    quiet = dict(device="cpu", log=lambda m: None)
    whole = Trainer(_cfg(folder, str(tmp_path / "whole")), **quiet)
    whole.fit()
    first = Trainer(_cfg(folder, str(tmp_path / "split")), **quiet)
    assert first.start_epoch == 0
    first.fit(epochs=2)
    root = first.ckpt.root
    assert os.path.isdir(os.path.join(root, "latest.prev"))  # epochs 0, 1
    with open(os.path.join(root, "config.json")) as f:
        assert json.load(f)["model"]["num_classes"] == 3
    with open(os.path.join(root, "class_to_idx.json")) as f:
        assert json.load(f) == {"a": 0, "b": 1, "c": 2}
    second = Trainer(_cfg(folder, str(tmp_path / "split")), **quiet)
    assert second.start_epoch == 2
    assert second.ckpt.last_restore_rung == "latest"
    assert second.best_score == first.best_score
    second.fit()
    got, want = _tensors(second), _tensors(whole)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert second.best_score == whole.best_score
    # A third Trainer finds nothing left to train.
    third = Trainer(_cfg(folder, str(tmp_path / "split")), **quiet)
    assert third.start_epoch == 3 and third.fit() == whole.best_score
    # Loading for inference: the sidecar gives the class count.
    cfg = _cfg(folder, str(tmp_path / "split"))
    model = load_inference_variables(cfg, track="latest", device="cpu",
                                     log=lambda m: None)
    assert not model.training and model.head.out.out_features == 3
    assert variables_digest(model) == variables_digest(whole.model)
    with pytest.raises(FileNotFoundError, match="no 'nope' checkpoint"):
        load_inference_variables(cfg, track="nope", device="cpu")


def test_resume_off_and_partial_restore(folder, tmp_path):
    """``resume=False`` starts fresh; a checkpoint of another head width
    restores the backbone only (lenient), leaves the optimizer state
    fresh, and refuses to load for inference."""
    import dataclasses
    cfg = _cfg(folder, str(tmp_path), epochs=1)
    Trainer(cfg, device="cpu", log=lambda m: None).fit()
    fresh = Trainer(dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, resume=False)), device="cpu",
        log=lambda m: None)
    assert fresh.start_epoch == 0 and int(fresh.state.step) == 0
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=5))
    partial = Trainer(wide, device="cpu", log=lambda m: None)
    loaded, total = partial.ckpt.last_restore_loaded
    assert 0 < loaded < total
    assert partial.start_epoch == 1 and int(partial.state.step) == 0
    assert int(partial.state.opt_state.count) == 0
    # The wide Trainer rewrote the run's sidecar (5 classes): loading the
    # 3-class checkpoint through it restores part of the model.
    with pytest.raises(ValueError, match="restored only"):
        load_inference_variables(cfg, track="latest", device="cpu",
                                 log=lambda m: None)
