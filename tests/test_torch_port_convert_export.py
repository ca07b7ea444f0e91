"""The converter's export direction on the port against ``tpuic``'s:

- ``export_state_dict`` of a port model loaded from a ``tpuic`` tree
  equals ``tpuic``'s ``export_state_dict`` of that tree, key for key and
  bit for bit, for every family;
- port -> ``tpuic`` tree -> port round-trips bit for bit;
- ``--export-torch`` from a port checkpoint, composed with ``--verify``,
  exits 0, and the file holds the checkpoint's weights;
- ``detect_vit_variant`` and ``_infer_head`` answer as ``tpuic``'s.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _convert_ref import CLASSES
from _convert_ref import records as _records
from _convert_ref import reference_file as _reference_file
from _torch_threads import TORCH_THREADS

from tpuic.checkpoint import torch_convert as jconv
from tpuic.checkpoint import torch_ref as jref
from tpuic_torch import config as pcfg
from tpuic_torch.checkpoint import CheckpointManager, init_params
from tpuic_torch.checkpoint import convert as pconvert
from tpuic_torch.checkpoint import torch_convert as pconv
from tpuic_torch.checkpoint import torch_ref as pref
from tpuic_torch.models import create_model
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state

torch.set_num_threads(TORCH_THREADS)


# The families' trees: tpuic's converter over a tpuic replica.
EXPORT_CASES = (("resnet18", 32, True), ("resnet18", 32, False),
                ("inceptionv3", 75, True), ("efficientnet-b0", 32, True),
                ("efficientnet-b0", 32, False), ("vit-tiny", 16, True))


@pytest.mark.parametrize("arch,size,mlp", EXPORT_CASES,
                         ids=[f"{a}-{'mlp' if m else 'linear'}"
                              for a, _, m in EXPORT_CASES])
def test_export_state_dict_equals_tpuic_bit_for_bit(arch, size, mlp,
                                                    tmp_path):
    path = _reference_file(jref.build_reference_model, arch, size,
                           tmp_path / "ref.pth", mlp_head=mlp)
    sd = jconv.load_reference_checkpoint(path)["state_dict"]
    tree = jconv.convert_state_dict(sd, arch=arch)
    kw = {} if mlp else {"head_widths": ()}
    model = create_model(arch, CLASSES, dtype="float32", image_size=size,
                         device="cpu", **kw)
    pconvert.load_jax_variables(model, tree)
    want = jconv.export_state_dict(tree["params"], tree["batch_stats"])
    exported = pconvert.export_jax_variables(model)
    got = pconv.export_state_dict(exported["params"],
                                  exported["batch_stats"])
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.array_equal(a, b), k
    # And back through the reference layout: every key of the replica.
    replica = pref.build_reference_model(arch, CLASSES, mlp_head=mlp,
                                         image_size=size)
    missing, unexpected = replica.load_state_dict(
        pconv._replica_state_dict(got, arch), strict=True)
    assert not missing and not unexpected


ROUND_TRIP = ("resnet18", "resnet50", "inceptionv3", "efficientnet-b0",
              "vit-tiny", "vit-tiny-moe")


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_port_tree_port_round_trips_bit_for_bit(name):
    size = 75 if name == "inceptionv3" else 32
    a = init_params(create_model(name, CLASSES, dtype="float32",
                                 image_size=size, device="cpu"), 0,
                    device="cpu")
    b = init_params(create_model(name, CLASSES, dtype="float32",
                                 image_size=size, device="cpu"), 1,
                    device="cpu")
    tree = pconvert.export_jax_variables(a)
    pconvert.load_jax_variables(b, tree)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    # The tree is a copy: writing the model does not move it.
    before = {k: v.copy() for k, v in tree["params"].get(
        "head", {}).get("out", {}).items()}
    with torch.no_grad():
        for p in a.parameters():
            p.add_(1.0)
    for k, v in before.items():
        assert np.array_equal(tree["params"]["head"]["out"][k], v)


def test_detect_vit_variant_and_infer_head_match_tpuic(tmp_path):
    for arch, size in (("vit-tiny", 16), ("vit-s16", 32)):
        for mlp in (True, False):
            path = _reference_file(jref.build_reference_model, arch, size,
                                   tmp_path / f"{arch}{mlp}.pth",
                                   mlp_head=mlp)
            sd = jconv.load_reference_checkpoint(path)["state_dict"]
            assert pconv.detect_vit_variant(sd) == \
                jconv.detect_vit_variant(sd) == arch
            assert pconv._infer_head(sd) == jconv._infer_head(sd) == \
                (CLASSES, mlp)


def _port_checkpoint(root, name: str = "resnet18", size: int = 32):
    model = init_params(create_model(name, CLASSES, dtype="float32",
                                     device="cpu"), 3, device="cpu")
    ocfg = pcfg.OptimConfig(optimizer="sgd", class_weights=(),
                            milestones=())
    mgr = CheckpointManager(str(root), name, async_commit=False,
                            log=lambda m: None)
    mgr.save_best(create_train_state(model, make_optimizer(ocfg)), 2, 47.25)
    mgr.wait()
    cfg = pcfg.Config(data=pcfg.DataConfig(resize_size=size),
                      model=pcfg.ModelConfig(name=name, num_classes=CLASSES,
                                             dtype="float32"), optim=ocfg)
    with open(os.path.join(mgr.root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, default=str)
    return model.eval(), os.path.join(mgr.root, "best")


def test_export_torch_from_a_port_checkpoint_composes_with_verify(
        tmp_path, capsys):
    model, track = _port_checkpoint(tmp_path / "ckpt")
    out = str(tmp_path / "exported.pth")
    rc, lines = _records(pconv.main, [track, "--export-torch", out,
                                      "--verify", "--image-size", "32",
                                      "--device", "cpu"], capsys)
    assert rc == 0
    exported, info, ver = lines
    assert exported["exported"] == out and exported["epoch"] == 2
    assert info["arch"] == "resnet18" and info["num_classes"] == CLASSES
    assert ver["verify"] == "ok" and ver["max_logits_delta"] < 1e-3
    payload = torch.load(out, weights_only=True)
    assert payload["epoch"] == 2 and payload["best_score"] == 47.25
    assert all(k.startswith("module.encoder.") for k in payload["state_dict"])
    # The file holds the checkpoint's weights: tpuic's converter reads it
    # back into a port model bit for bit.
    tree = jconv.convert_reference_checkpoint(out)
    back = create_model("resnet18", CLASSES, dtype="float32", device="cpu")
    pconvert.load_jax_variables(back, {"params": tree["params"],
                                       "batch_stats": tree["batch_stats"]})
    for (k, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k
    # Without --verify it only exports.
    rc, lines = _records(pconv.main, [track, "--export-torch", out,
                                      "--device", "cpu"], capsys)
    assert rc == 0 and len(lines) == 1


def test_export_torch_refuses_a_directory_without_a_sidecar(tmp_path):
    (tmp_path / "m" / "best").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="config.json"):
        pconv.main([str(tmp_path / "m" / "best"), "--export-torch",
                    str(tmp_path / "o.pth"), "--device", "cpu"])
