"""Rematerialisation (``models/remat.py``): every policy gives the
numbers of no remat.

- ``vit-tiny`` (32 px, batch 4, drop-path 0.2 with fixed masks) under
  ``dots``, ``attention``, ``gelu`` and ``blocks``, dense and flash
  attention (the K4 wrapper's plain version on the CPU): the loss and
  every parameter's gradient equal the run without remat, bit for bit.
- ``resnet18-cifar`` under ``dots``: gradients and the BN running
  statistics (updated once, not again by the recompute) equal the run
  without remat.
- One train step of the ViT recipe (mixup, CutMix, erasing, drop-path,
  EMA) under ``--remat --remat-policy dots``: its loss, gradient norm,
  parameters and EMA equal the step without remat.
- ``tpuic``'s warnings where a policy has no effect.
"""

import dataclasses
import warnings

import pytest
import torch
import torch.nn.functional as F

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import init_params
from tpuic_torch.models import remat, vit
from tpuic_torch.models.remat import resolve_remat_policy
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

CLASSES = 5


def _grads(name, policy, size, attention="dense", drop_path=0.0):
    model = init_params(port_models.create_model(
        name, CLASSES, dtype="float32", attention=attention,
        drop_path=drop_path, image_size=size, remat_policy=policy,
        device="cpu"), 4, device="cpu")
    model.train()
    recomputed = []
    for m in model.modules():  # which forwards ran inside a recompute
        m.register_forward_hook(
            lambda *a: recomputed.append(remat.recomputing()))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, size, size, 3, generator=gen)
    rates = model.drop_path_rates()
    kw = {}
    if rates:
        kw["drop_masks"] = torch.rand(len(rates), 4, generator=gen) < 0.6
    gelu, core = F.gelu, vit._dense_core

    def seen(fn):
        def run(*a, **k):
            recomputed.append(remat.recomputing())
            return fn(*a, **k)
        return run

    F.gelu, vit._dense_core = seen(gelu), seen(core)
    try:
        loss = model(x, **kw).square().sum()
        loss.backward()
    finally:
        F.gelu, vit._dense_core = gelu, core
    grads = {n: p.grad for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if "running" in n}
    return loss.detach(), grads, stats, any(recomputed)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", ["dots", "attention", "gelu", "blocks"])
def test_vit_policies_give_the_gradients_of_no_remat(policy, attention):
    want = _grads("vit-tiny", "", 32, attention, 0.2)
    got = _grads("vit-tiny", policy, 32, attention, 0.2)
    assert not want[3]
    # 'attention' has nothing to recompute under flash (it warns).
    assert got[3] == (policy != "attention" or attention == "dense")
    assert torch.equal(got[0], want[0])
    for n, g in want[1].items():
        assert torch.equal(got[1][n], g), n


def test_resnet_dots_updates_bn_statistics_once():
    want = _grads("resnet18-cifar", "", 16)
    got = _grads("resnet18-cifar", "dots", 16)
    assert got[3] and not want[3]
    assert torch.equal(got[0], want[0])
    for n, g in want[1].items():
        assert torch.equal(got[1][n], g), n
    assert want[2]
    for n, s in want[2].items():
        assert torch.equal(got[2][n], s), n


RECIPE = dict(optimizer="adam", learning_rate=1e-3, weight_decay=0.05,
              grad_clip_norm=1.0, milestones=(), class_weights=(),
              label_smoothing=0.1, fused_loss=True, mixup_alpha=0.2,
              cutmix_alpha=1.0, random_erase=0.25, ema_decay=0.9)


def _one_step(remat: bool):
    mcfg = pcfg.ModelConfig(name="vit-tiny", num_classes=CLASSES,
                            dtype="float32", attention="flash",
                            drop_path=0.1, remat=remat,
                            remat_policy="dots")
    ocfg = pcfg.OptimConfig(**RECIPE)
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cpu", image_size=32), 2, device="cpu")
    state = create_train_state(model, make_optimizer(ocfg), ema=True)
    step = make_train_step(ocfg, mcfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(9)
    batch = {"image": torch.randn(8, 32, 32, 3, generator=gen),
             "label": torch.randint(0, CLASSES, (8,), generator=gen,
                                    dtype=torch.int32),
             "mask": torch.ones(8)}
    state, m = step(state, batch, step=0)
    return m, state


def test_recipe_step_under_dots_equals_no_remat():
    want_m, want = _one_step(False)
    got_m, got = _one_step(True)
    assert got.model.remat_dots and not want.model.remat_dots
    for key in ("loss", "grad_norm"):
        assert torch.equal(got_m[key], want_m[key]), key
    for a, b in zip(got.model.parameters(), want.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(got.ema_params, want.ema_params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,attention,policy,warns", [
    ("vit-tiny", "flash", "attention", True),
    ("vit-tiny", "dense", "attention", False),
    ("resnet50", "dense", "gelu", True),
    ("resnet50", "dense", "blocks", True),
    ("resnet50", "dense", "dots", False),
    ("vit-tiny", "flash", "gelu", False),
])
def test_policies_without_effect_warn_as_tpuic(name, attention, policy,
                                                warns):
    cfg = pcfg.ModelConfig(name=name, attention=attention, remat=True,
                           remat_policy=policy)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert resolve_remat_policy(cfg) == policy
    assert bool([w for w in seen if "no effect" in str(w.message)]) == warns
    assert resolve_remat_policy(dataclasses.replace(cfg, remat=False)) \
        is None
    with pytest.raises(ValueError, match="unknown remat_policy"):
        resolve_remat_policy(dataclasses.replace(cfg, remat_policy="all"))
