"""``python -m tpuic_torch.predict`` on the CPU (``--device cpu``).

- Accuracy: the port's predict over the val fold of a ``best`` save equals
  the port ``Trainer``'s val accuracy for that save
  (tests/test_predict.py::test_predict_matches_val_epoch's bar).
- Parity: one reference torch checkpoint (``--init-from``, written by
  ``tpuic``'s ``export_state_dict`` from a ``tpuic``-initialised model)
  scored by ``tpuic``'s ``run_predict`` and the port's over the same fold:
  the same ``pred`` column, ``prob`` within 1e-5, the same accuracy.
- Edge cases: an unlabeled flat fold; a fold with no train tree;
  ``--model auto`` and its ambiguity error; a missing checkpoint; the
  wrong model for a checkpoint; ``--no-pack`` required; an EMA-trained
  checkpoint refused.
- ``--model auto`` on an InceptionV3 and an EfficientNet-B0 checkpoint:
  each row is a direct eval forward's (1e-5); a bf16 run's checkpoint is
  scored in float32, as the serve CLI serves it, each row a float32
  forward's (1e-5).

JAX and ``tpuic`` are imported inside fixtures and tests.
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tpuic_torch import config as pcfg
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.predict import main as predict_main
from tpuic_torch.predict import resolve_model_auto, run_predict
from tpuic_torch.train.loop import Trainer

SIZE = 32
CLASSES = ("ant", "bee", "cicada")


def _cfg(root, ckpt, name="resnet18", num_classes=0, batch=4, **run):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=root, resize_size=SIZE,
                             batch_size=batch, val_batch_size=batch,
                             num_workers=2, pack=False, native=False),
        model=pcfg.ModelConfig(name=name, num_classes=num_classes,
                               dtype="float32", fused_conv_bn=True),
        optim=pcfg.OptimConfig(optimizer="sgd", learning_rate=0.02,
                               class_weights=(), milestones=()),
        run=pcfg.RunConfig(ckpt_dir=ckpt, **run))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port Trainer's run over a synthetic folder: one epoch, then its
    val accuracy and a ``best`` save of the same state."""
    root = str(tmp_path_factory.mktemp("pdata"))
    make_synthetic_imagefolder(root, classes=CLASSES, per_class=5,
                               size=SIZE + 4)
    ckpt = os.path.join(root, "ckpt")
    trainer = Trainer(_cfg(root, ckpt, epochs=1, save_period=1,
                           resume=False, log_every_steps=1,
                           async_checkpoint=False),
                      device="cpu", log=lambda m: None)
    trainer.fit()
    val_acc = trainer.val_epoch(1)
    trainer.ckpt.save_best(trainer.state, 1, val_acc)
    trainer.ckpt.wait()
    return root, ckpt, val_acc


def test_predict_matches_the_trainers_val_accuracy(trained, tmp_path):
    root, ckpt, val_acc = trained
    out = str(tmp_path / "preds.csv")
    summary = run_predict(_cfg(root, ckpt), fold="val", track="best",
                          top_k=2, out_path=out, device="cpu")
    assert summary["rows"] == 15
    assert summary["accuracy"] == val_acc
    # Every batch went in as a tensor on the engine's device.
    assert summary["device_requests"] == 4 and summary["host_requests"] == 0
    assert summary["full_batches"] == 3
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 15
    for r in rows:
        assert r["label"] in CLASSES and r["pred"] in CLASSES
        assert r["pred_2"] in CLASSES and r["pred_2"] != r["pred"]
        assert 0.0 <= float(r["prob_2"]) <= float(r["prob"]) <= 1.0
    acc = 100.0 * np.mean([r["label"] == r["pred"] for r in rows])
    assert acc == pytest.approx(summary["accuracy"], abs=1e-9)


def test_cli_model_auto_limit_and_refusals(trained, tmp_path):
    root, ckpt, _ = trained
    assert resolve_model_auto(ckpt) == {"name": "resnet18", "num_classes": 3,
                                        "resize_size": SIZE,
                                        "ema_decay": 0.0}
    out = str(tmp_path / "auto.csv")
    assert predict_main(["--datadir", root, "--ckpt-dir", ckpt, "--out", out,
                         "--batchsize", "4", "--limit", "5", "--no-pack",
                         "--device", "cpu"]) == 0
    with open(out) as f:
        assert len(list(csv.DictReader(f))) == 5
    with pytest.raises(SystemExit, match="--no-pack is required.*item 7"):
        predict_main(["--datadir", root, "--ckpt-dir", ckpt,
                      "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        resolve_model_auto(str(tmp_path / "none"))
    # Two trained models under one dir: --model auto refuses to guess.
    two = tmp_path / "two"
    for name in ("resnet18", "vit-tiny"):
        (two / name).mkdir(parents=True)
        shutil.copy(os.path.join(ckpt, "resnet18", "config.json"),
                    two / name / "config.json")
    with pytest.raises(ValueError, match="pass --model"):
        resolve_model_auto(str(two))
    # An EMA-trained checkpoint: tpuic would score its EMA weights.
    ema = tmp_path / "ema"
    shutil.copytree(ckpt, ema)
    side = ema / "resnet18" / "config.json"
    saved = json.loads(side.read_text())
    saved["optim"]["ema_decay"] = 0.99
    side.write_text(json.dumps(saved))
    with pytest.raises(SystemExit, match="ema_decay.*item 8"):
        predict_main(["--datadir", root, "--ckpt-dir", str(ema),
                      "--no-pack", "--device", "cpu"])


def test_missing_and_mismatched_checkpoints_raise(trained, tmp_path):
    root, ckpt, _ = trained
    with pytest.raises(FileNotFoundError, match="no 'best' checkpoint"):
        run_predict(_cfg(root, str(tmp_path / "nope")), fold="val",
                    track="best", top_k=1, out_path=None, device="cpu")
    # The resnet18 checkpoint masquerading as a vit-tiny one.
    wrong = tmp_path / "wrong"
    shutil.copytree(os.path.join(ckpt, "resnet18"), wrong / "vit-tiny")
    with pytest.raises(ValueError, match="wrong --model"):
        run_predict(_cfg(root, str(wrong), name="vit-tiny"), fold="val",
                    track="best", top_k=1, out_path=None, device="cpu")


def test_unlabeled_flat_fold_and_no_train_tree(trained, tmp_path):
    root, ckpt, _ = trained
    rng = np.random.default_rng(3)
    flat = os.path.join(root, "incoming")
    os.makedirs(flat, exist_ok=True)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3),
                                     np.uint8)).save(
            os.path.join(flat, f"new_{i}.png"))
    out = str(tmp_path / "flat.csv")
    summary = run_predict(_cfg(root, ckpt), fold="incoming", track="best",
                          top_k=1, out_path=out, device="cpu")
    assert summary["rows"] == 5 and "accuracy" not in summary
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [r["image_id"] for r in rows] == [f"new_{i}" for i in range(5)]
    assert all(r["label"] == "" and r["pred"] in CLASSES for r in rows)
    # No train/ tree: the class count must be given; names are indices.
    lone = tmp_path / "lone"
    (lone / "imgs").mkdir(parents=True)
    Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(
        lone / "imgs" / "x.png")
    with pytest.raises(ValueError, match="num-classes"):
        run_predict(_cfg(str(lone), ckpt), fold="imgs", track="best",
                    top_k=1, out_path=None, device="cpu")
    out = str(tmp_path / "lone.csv")
    summary = run_predict(_cfg(str(lone), ckpt, num_classes=3), fold="imgs",
                          track="best", top_k=1, out_path=out, device="cpu")
    with open(out) as f:
        (row,) = list(csv.DictReader(f))
    assert summary["rows"] == 1
    assert row["pred"] in {"0", "1", "2"} and row["label"] == ""


def test_flat_train_fold_still_rejected(tmp_path):
    os.makedirs(tmp_path / "bad" / "train")
    Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(
        tmp_path / "bad" / "train" / "oops.png")
    with pytest.raises(ValueError, match="no images"):
        ImageFolderDataset(str(tmp_path / "bad"), "train", SIZE)
    ds = ImageFolderDataset(str(tmp_path / "bad"), "train", SIZE,
                            allow_unlabeled=True)
    assert not ds.labeled and ds.samples[0][1] == -1


def test_predict_matches_tpuic_on_one_torch_checkpoint(trained, tmp_path):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from tpuic.checkpoint.torch_convert import export_state_dict
    from tpuic.config import Config, DataConfig, ModelConfig, RunConfig
    from tpuic.models import create_model as jcreate
    from tpuic.predict import run_predict as jax_run_predict

    root, _, _ = trained
    # flax's default init, drawn from the traced shapes (compiling
    # tpuic's init would cost seconds): kernels normal with variance
    # 1/fan_in, BN the identity, biases 0.
    m = jcreate("resnet18", 3, dtype="float32")
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(5)

    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return np.full(s.shape, path[-1].key in ("scale", "var"), np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    sd = export_state_dict(v["params"], v["batch_stats"])
    ckpt = str(tmp_path / "best_model.pth")
    torch.save({"epoch": 2, "best_score": 0.0, "state_dict": {
        k: torch.tensor(np.asarray(a)) for k, a in sd.items()}}, ckpt)
    want_csv, got_csv = str(tmp_path / "tpuic.csv"), str(tmp_path / "p.csv")
    want = jax_run_predict(
        Config(data=DataConfig(data_dir=root, resize_size=SIZE, batch_size=4,
                               val_batch_size=4, num_workers=2, pack=False,
                               native=False),
               model=ModelConfig(name="resnet18", num_classes=3,
                                 dtype="float32"),
               run=RunConfig(ckpt_dir=str(tmp_path / "none"),
                             init_from=ckpt)),
        fold="val", track="best", top_k=2, out_path=want_csv)
    got = run_predict(_cfg(root, str(tmp_path / "none"), num_classes=3,
                           init_from=ckpt),
                      fold="val", track="best", top_k=2, out_path=got_csv,
                      device="cpu")
    with open(want_csv) as f:
        want_rows = list(csv.DictReader(f))
    with open(got_csv) as f:
        got_rows = list(csv.DictReader(f))
    assert [r["image_id"] for r in got_rows] == [r["image_id"]
                                                 for r in want_rows]
    for g, w in zip(got_rows, want_rows):
        assert (g["label"], g["pred"], g["pred_2"]) == (w["label"], w["pred"],
                                                        w["pred_2"])
        np.testing.assert_allclose(
            [float(g["prob"]), float(g["prob_2"])],
            [float(w["prob"]), float(w["prob_2"])], atol=1e-5)
    assert got["accuracy"] == want["accuracy"]


@pytest.mark.parametrize("name,size", [("inceptionv3", 75),
                                       ("efficientnet-b0", SIZE)])
def test_model_auto_scores_inception_and_efficientnet(tmp_path, name, size):
    """``--model auto`` on a port checkpoint of each new family (its
    sidecar written as a ``Trainer`` writes it): every row's top-1 and
    probability are a direct eval forward's of the same weights over the
    same pixels (1e-5)."""
    from tpuic_torch.checkpoint import CheckpointManager, init_params
    from tpuic_torch.data.pipeline import Loader
    from tpuic_torch.models import create_model
    from tpuic_torch.train.optimizer import make_optimizer
    from tpuic_torch.train.state import create_train_state
    root = str(tmp_path / "data")
    make_synthetic_imagefolder(root, classes=CLASSES, per_class=2,
                               size=size + 3)
    ckpt = str(tmp_path / "ckpt")
    model = init_params(create_model(name, 3, dtype="float32",
                                     device="cpu"), 3, device="cpu")
    cfg = _cfg(root, ckpt, name=name, num_classes=3)
    cfg = cfg.replace(data=pcfg.DataConfig(
        data_dir=root, resize_size=size, batch_size=4, val_batch_size=4,
        num_workers=2, pack=False, native=False))
    mgr = CheckpointManager(ckpt, name, async_commit=False,
                            log=lambda m: None)
    mgr.save_best(create_train_state(model, make_optimizer(cfg.optim)), 0,
                  10.0)
    mgr.wait()
    import dataclasses
    with open(os.path.join(mgr.root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, default=str)
    out = str(tmp_path / "p.csv")
    assert predict_main(["--datadir", root, "--ckpt-dir", ckpt, "--out",
                         out, "--batchsize", "4", "--no-pack", "--device",
                         "cpu"]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    ds = ImageFolderDataset(root, "val", size, cfg.data)
    batch = next(iter(Loader(ds, 8, shuffle=False, num_workers=1,
                             augment=False, device="cpu").epoch(0)))
    model.eval()
    with torch.no_grad():
        probs = torch.softmax(model(batch["image"]), -1).numpy()
    names = {i: c for c, i in ds.class_to_idx.items()}
    assert [r["image_id"] for r in rows] == batch.image_ids[:len(rows)]
    assert len(rows) == 6
    for i, r in enumerate(rows):
        assert r["pred"] == names[int(probs[i].argmax())]
        assert float(r["prob"]) == pytest.approx(float(probs[i].max()),
                                                 abs=1e-5)


def test_a_bf16_run_is_scored_in_float32(tmp_path):
    """A ``Trainer`` run in bf16 (its sidecar says ``bfloat16``): predict
    scores the ``best`` save as the serve CLI serves it, in float32
    (``serving_model_config``): every row's top-1 and probability are a
    float32 eval forward's of the saved weights over the same pixels
    (1e-5), and the accuracy is that forward's."""
    from tpuic_torch.data.pipeline import Loader
    from tpuic_torch.models import create_model
    from tpuic_torch.predict import serving_model_config
    root = str(tmp_path / "data")
    make_synthetic_imagefolder(root, classes=CLASSES, per_class=5,
                               size=SIZE + 4)
    ckpt = str(tmp_path / "ckpt")
    cfg = _cfg(root, ckpt, name="resnet18-cifar", epochs=1, save_period=1,
               resume=False, log_every_steps=1, async_checkpoint=False)
    cfg = cfg.replace(model=pcfg.ModelConfig(name="resnet18-cifar",
                                             num_classes=3,
                                             dtype="bfloat16"))
    trainer = Trainer(cfg, device="cpu", log=lambda m: None)
    assert trainer.mcfg.dtype == "bfloat16"
    trainer.fit()
    trainer.ckpt.save_best(trainer.state, 1, trainer.val_epoch(1))
    trainer.ckpt.wait()
    with open(os.path.join(ckpt, "resnet18-cifar", "config.json")) as f:
        assert json.load(f)["model"]["dtype"] == "bfloat16"
    assert serving_model_config("resnet18-cifar", 3).dtype == "float32"
    out = str(tmp_path / "p.csv")
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert predict_main(["--datadir", root, "--ckpt-dir", ckpt,
                             "--out", out, "--batchsize", "4", "--no-pack",
                             "--device", "cpu"]) == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(out) as f:
        rows = list(csv.DictReader(f))
    model = create_model("resnet18-cifar", 3, dtype="float32", device="cpu")
    model.load_state_dict(trainer.model.state_dict())
    model.eval()
    ds = ImageFolderDataset(root, "val", SIZE, cfg.data)
    batch = next(iter(Loader(ds, 64, shuffle=False, num_workers=1,
                             augment=False, device="cpu").epoch(0)))
    with torch.no_grad():
        probs = torch.softmax(model(batch["image"]), -1).numpy()
    names = {i: c for c, i in ds.class_to_idx.items()}
    labels = batch["label"].numpy()
    assert len(rows) == len(ds) and [r["image_id"] for r in rows] == \
        batch.image_ids[:len(rows)]
    for i, r in enumerate(rows):
        assert r["pred"] == names[int(probs[i].argmax())]
        assert float(r["prob"]) == pytest.approx(float(probs[i].max()),
                                                 abs=1e-5)
    hits = (probs[:len(rows)].argmax(-1) == labels[:len(rows)]).sum()
    assert summary["accuracy"] == pytest.approx(100.0 * hits / len(rows))
