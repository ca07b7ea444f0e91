"""The port's real dataset: sklearn's handwritten digits as an ImageFolder.

- The committed split (``tpuic_torch/data/digits_split.npz``) written by
  ``write_digits_folder`` equals the repo's
  ``scripts/make_digits_dataset.build``, file name for file name and
  pixel for pixel.  Needs sklearn; skips where it is absent.
- ``write_digits_folder`` alone (no sklearn) gives 1,438 train and 359
  val 8x8 grayscale PNGs over 10 classes.
- The digits recipe of ``perf/convergence_digits.json``
  (``resnet18-cifar``, 32 px, batch 128, SGD lr 0.05 with 3 warmup epochs
  of a cosine schedule, wd 5e-4, no augmentation, no class weights, the
  fused loss) through
  ``python -m tpuic_torch.train`` on the CPU for one epoch, then predict
  on its ``best`` save: the accuracies are equal.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tpuic_torch.data import digits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_committed_split_equals_the_scripts_build(tmp_path):
    pytest.importorskip("sklearn", reason="the script's build needs "
                                          "sklearn's bundled digits")
    spec = importlib.util.spec_from_file_location(
        "make_digits_dataset",
        os.path.join(ROOT, "scripts", "make_digits_dataset.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert digits.write_digits_folder(ours) == script.build(theirs)
    names = _files(ours)
    assert names == _files(theirs) and len(names) == 1797
    for name in names:
        a = np.asarray(Image.open(os.path.join(ours, name)))
        b = np.asarray(Image.open(os.path.join(theirs, name)))
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), name
    split = digits.make_split()
    with np.load(digits.SPLIT_PATH) as f:
        for k in ("images", "labels", "val"):
            assert np.array_equal(f[k], split[k]), k


def test_write_digits_folder_needs_no_sklearn(tmp_path):
    counts = digits.write_digits_folder(str(tmp_path))
    assert counts == {"train": 1438, "val": 359}
    for fold, n in counts.items():
        classes = sorted(os.listdir(tmp_path / fold))
        assert classes == [str(c) for c in range(10)]
        assert len(_files(str(tmp_path / fold))) == n
    img = Image.open(tmp_path / "val" / "3" / sorted(
        os.listdir(tmp_path / "val" / "3"))[0])
    assert img.mode == "L" and img.size == (8, 8)


RECIPE = ["--model", "resnet18-cifar", "--resize", "32", "--batchsize", "128",
          "--optimizer", "sgd", "--lr", "0.05", "--warmup-epochs", "3",
          "--weight-decay", "5e-4", "--milestones", "--no-augment",
          "--no-class-weights", "--fused-loss", "--no-pack", "--no-native"]


def test_digits_recipe_runs_one_epoch_on_cpu(tmp_path):
    data, ckpt = str(tmp_path / "digits"), str(tmp_path / "ckpt")
    digits.write_digits_folder(data)
    # Two threads a process: the suite runs several test processes on
    # the same cores, and a full thread pool each only oversubscribes.
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.train", "--datadir", data,
         "--ckpt-dir", ckpt, "--device", "cpu", "--epochs", "1",
         "--dtype", "float32", "--workers", "2", "--log-every-steps", "11",
         *RECIPE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    assert "[model] resnet18-cifar" in out.stdout
    assert "batch 128, optimizer sgd, on cpu, float32 compute" in out.stdout
    assert "Epoch: 0; step 11;" in out.stdout  # 1438 // 128 steps
    val = [ln for ln in out.stdout.splitlines() if "Val Accuracy" in ln]
    assert len(val) == 1
    acc = float(val[0].split("Val Accuracy ")[1].split(";")[0])
    assert acc > 10.0  # above chance after one epoch (18.11 here)
    pred = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.predict", "--datadir", data,
         "--ckpt-dir", ckpt, "--batchsize", "128", "--no-pack", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert pred.returncode == 0, pred.stderr
    summary = json.loads(pred.stdout.strip().splitlines()[-1])
    assert summary["rows"] == 359
    # The log prints 4 decimals; one image is 0.28 points.
    assert round(summary["accuracy"], 4) == acc
