"""Parameter EMA through the ``Trainer``, the checkpoint and serving
(``tpuic/train/state.py:28-46``, ``tpuic/checkpoint/manager.py:235-236``,
``:736-769``, ``tpuic/checkpoint/loading.py:78``, ``tpuic/predict.py``).

- The val pass scores the EMA weights with the current BN statistics,
  through K3's folds (the plain version on the CPU) built from the EMA
  weights at every pass: its accuracy equals an unfused model's holding
  ``ema_params``, after one epoch and again after another (a fold kept
  from the first pass would score stale weights); the model's own
  parameters come back after the pass, bit for bit.
- The checkpoint carries ``ema_params``: a restore gives them back bit
  for bit; an EMA run restored from a save without them restarts its EMA
  at the restored parameters.
- Predict (``--model auto`` over the ``Trainer``'s save) scores
  ``ema_params``: each row's probabilities within 1e-5 of a direct
  forward of them.
- The carrier: ``load_jax_ema`` of a ``tpuic`` state's ``ema_params``
  (``test_torch_port_recipe_vit.py`` continues one), strict on a missing
  leaf.
"""

import csv
import os

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import (CheckpointManager, init_params,
                                    load_jax_ema)
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.predict import main as predict_main
from tpuic_torch.serve import make_forward
from tpuic_torch.train.loop import Trainer
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

SIZE = 24
CLASSES = ("ant", "bee", "cicada")


def _cfg(root, ckpt, **run):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=root, resize_size=SIZE, batch_size=4,
                             val_batch_size=4, num_workers=2, pack=False,
                             native=False),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=0,
                               dtype="float32", fused_conv_bn=True),
        optim=pcfg.OptimConfig(optimizer="sgd", learning_rate=0.05,
                               class_weights=(), milestones=(),
                               ema_decay=0.5),
        run=pcfg.RunConfig(ckpt_dir=ckpt, resume=False, log_every_steps=1,
                           async_checkpoint=False, save_period=1, **run))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ema_data"))
    make_synthetic_imagefolder(root, classes=CLASSES, per_class=4,
                               size=SIZE)
    ckpt = os.path.join(root, "ckpt")
    trainer = Trainer(_cfg(root, ckpt, epochs=1), device="cpu",
                      log=lambda m: None)
    trainer.fit()
    return root, ckpt, trainer


def _unfused_with_ema(trainer) -> torch.nn.Module:
    """An unfused model holding the Trainer's ``ema_params`` and its BN
    statistics, in eval mode."""
    st = trainer.state
    ref = port_models.create_model("resnet18-cifar", len(CLASSES),
                                   dtype="float32", device="cpu")
    ref.load_state_dict(st.model.state_dict())
    with torch.no_grad():
        for p, e in zip(ref.parameters(), st.ema_params):
            p.copy_(e)
    return ref.eval()


def _accuracy(model, trainer) -> float:
    correct = count = 0
    with torch.no_grad():
        for batch in trainer.val_loader.epoch(0):
            pred = model(batch["image"]).argmax(-1)
            m = batch["mask"] > 0
            correct += int(((pred == batch["label"].long()) & m).sum())
            count += int(m.sum())
    return 100.0 * correct / count


def test_val_pass_scores_the_ema_through_fresh_folds(trained):
    _, _, trainer = trained
    st = trainer.state
    assert st.ema_params is not None
    params = [p.detach().clone() for p in st.model.parameters()]
    assert any(not torch.equal(p, e) for p, e in zip(params, st.ema_params))
    for epoch in (1, 2):
        if epoch == 2:
            trainer.train_epoch(1)  # moves params, EMA and statistics
            params = [p.detach().clone() for p in st.model.parameters()]
        score = trainer.val_epoch(epoch)
        assert score == _accuracy(_unfused_with_ema(trainer), trainer)
        for p, q in zip(st.model.parameters(), params):
            assert torch.equal(p, q)
        with st.inference_weights() as model:  # K3's folds of the EMA
            x = next(iter(trainer.val_loader.epoch(0)))["image"]
            with torch.no_grad():
                fused = model.eval()(x)
        torch.testing.assert_close(fused, _unfused_with_ema(trainer)(x),
                                   rtol=1e-5, atol=1e-5)


def test_checkpoint_carries_the_ema(trained, tmp_path):
    _, _, trainer = trained
    st = trainer.state
    mgr = CheckpointManager(str(tmp_path), "m", async_commit=False,
                            log=lambda m: None)
    mgr.save_best(st, 0, 1.0)
    mgr.wait()

    def fresh(ema):
        model = init_params(port_models.create_model(
            "resnet18-cifar", len(CLASSES), dtype="float32", device="cpu"),
            9, device="cpu")
        return create_train_state(model, make_optimizer(trainer.cfg.optim),
                                  ema=ema)

    back = fresh(True)
    mgr.restore_into(back, track="best")
    for a, b in zip(back.ema_params, st.ema_params):
        assert torch.equal(a, b)
    plain = CheckpointManager(str(tmp_path), "p", async_commit=False,
                              log=lambda m: None)
    plain.save_best(fresh(False), 0, 1.0)
    plain.wait()
    back = fresh(True)
    plain.restore_into(back, track="best")
    for p, e in zip(back.model.parameters(), back.ema_params):
        assert torch.equal(p.detach(), e)


def test_predict_scores_the_ema(trained, tmp_path):
    root, ckpt, trainer = trained
    out = str(tmp_path / "preds.csv")
    assert predict_main(["--datadir", root, "--ckpt-dir", ckpt, "--out", out,
                         "--no-pack", "--device", "cpu", "--batchsize",
                         "4"]) == 0
    saved = CheckpointManager(ckpt, "resnet18-cifar", log=lambda m: None)
    back = create_train_state(init_params(port_models.create_model(
        "resnet18-cifar", len(CLASSES), dtype="float32", device="cpu"), 9,
        device="cpu"), make_optimizer(trainer.cfg.optim), ema=True)
    saved.restore_into(back, track="best")
    model = back.model
    with torch.no_grad():
        for p, e in zip(model.parameters(), back.ema_params):
            p.copy_(e)
    ds = trainer.val_loader.dataset
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(ds)
    x = torch.cat([b["image"][b["mask"] > 0]
                   for b in trainer.val_loader.epoch(0)])
    probs, order = make_forward(model.eval())(x)
    for i, r in enumerate(rows):
        assert r["image_id"] == ds.image_id(i)
        assert r["pred"] == CLASSES[int(order[i, 0])]
        assert abs(float(r["prob"]) - float(probs[i, order[i, 0]])) < 1e-5


def test_load_jax_ema_is_strict():
    model = port_models.create_model("vit-tiny", 3, dtype="float32",
                                     image_size=16, device="cpu")
    pytest.importorskip("jax")
    import jax
    from tpuic import models as jmodels
    jm = jmodels.create_model("vit-tiny", 3, dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(
        k, jax.numpy.zeros((1, 16, 16, 3)), train=False))(
        jax.random.key(0))["params"])
    ema = load_jax_ema(model, params, device="cpu")
    assert [tuple(e.shape) for e in ema] == [tuple(p.shape)
                                            for p in model.parameters()]
    del params["head"]
    with pytest.raises(KeyError, match="lacks"):
        load_jax_ema(model, params, device="cpu")
