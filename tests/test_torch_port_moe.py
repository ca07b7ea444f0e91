"""Port parity: the Switch-MoE ViT (``tpuic_torch.models.moe``, the MoE
blocks of ``models/vit.py`` and the train step's load-balancing loss)
against ``tpuic.models.moe``, ``tpuic.models.vit`` and ``tpuic``'s step.

Every case feeds the same numpy inputs and the same flax weights (carried
by ``load_jax_variables``) to both packages, on the CPU, at
``vit-tiny-moe`` (16 px, patch 4, 17 tokens, 4 experts, MoE in block 1)
or a bare ``SwitchMoEMlp`` of width 16:

- the layer's output at atol and rtol 1e-5 in float32, with identical
  routing (top-1 experts, gates, dispatch); the smallest top-1 / top-2
  router margin of the inputs is asserted to be far from a tie (at least
  1e-4 in probability), so the argmax cannot flip on rounding;
- a capacity case (``capacity_factor`` 0.5) that drops tokens, with the
  same dropped set;
- ``switch_aux_loss`` with and without a padding mask, at rtol 1e-6;
- the gradients of ``router``, ``w1`` and ``w2`` against ``jax.grad`` at
  atol 1e-5, rtol 1e-4;
- the bf16 forward within 2e-2 times max |out| (the port's bf16 bound,
  ``test_torch_port_bf16.py``), with identical routing;
- two SGD steps of ``vit-tiny-moe`` with the aux loss, and two with mixup
  on ``tpuic``'s own draws (``tests/_tpuic_draws.py``), against
  ``tpuic``'s step: loss, gradient norm and accuracy at rtol 1e-4, the
  parameters at atol 5e-5;
- two gloo ranks against one process on the global batch, with drop-path
  0.3: loss at rtol 1e-5, gradients at atol 1e-6;
- ``remat_blocks`` against no remat: the same aux loss and gradients
  (bitwise);
- a row served alone equal to the same row in a full bucket (the
  engine on the CPU, rtol 1e-5), and the serve CLI answering a request;
- the int8 rung's leaf set equal to ``tpuic.quant``'s;
- the strict load, the optimizer state and the EMA carrying the
  ``block{i}/moe`` leaves in ``tpuic``'s layouts.

JAX-only imports are inside fixtures, so the file collects where JAX is
not installed.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch import quant
from tpuic_torch.checkpoint import (init_params, load_jax_opt_state,
                                    load_jax_variables)
from tpuic_torch.models import moe as pmoe
from tpuic_torch.runtime import distributed
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CLASSES = 5
SIZE = 16
WIDTH = 16
MIN_MARGIN = 1e-4
SGD = dict(optimizer="sgd", learning_rate=0.05, milestones=(),
           class_weights=(), fused_loss=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic import config as jcfg
    from tpuic import models as jmodels
    from tpuic import quant as jquant
    from tpuic.models import moe as jmoe
    from tpuic.train import optimizer as jopt
    from tpuic.train.state import create_train_state as jstate
    from tpuic.train.step import make_train_step as jtrain
    return dict(jax=jax, jnp=jnp, cfg=jcfg, models=jmodels, quant=jquant,
                moe=jmoe, opt=jopt, state=jstate, train=jtrain)


def _np(tree, jax):
    return jax.tree.map(lambda a: np.asarray(getattr(a, "value", a)), tree,
                        is_leaf=lambda a: hasattr(a, "value"))


def _tokens(seed, b=3, n=17, d=WIDTH):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, d)).astype(np.float32)


def _layer(jx, experts, cf, x, dtype="float32"):
    """``(flax layer, its float32 params as numpy, port layer)``, the port
    layer holding the same weights.  The router is drawn at std 0.5 (the
    init's 0.02 would put every token near a tie)."""
    jax, jnp = jx["jax"], jx["jnp"]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jx["moe"].SwitchMoEMlp(experts, 4, capacity_factor=cf, dtype=jdt)
    params = _np(jm.init(jax.random.key(0), jnp.asarray(x))["params"], jax)
    params["router"] = (np.random.default_rng(9).standard_normal(
        params["router"].shape) * 0.5).astype(np.float32)
    params["b1"] = (np.random.default_rng(10).standard_normal(
        params["b1"].shape) * 0.1).astype(np.float32)
    pm = pmoe.SwitchMoEMlp(x.shape[-1], experts, 4, capacity_factor=cf,
                           dtype=getattr(torch, dtype)).train()
    with torch.no_grad():
        for k, v in params.items():
            getattr(pm, k).copy_(torch.from_numpy(v))
    return jm, params, pm


def _jax_apply(jx, jm, params, x):
    out, st = jm.apply({"params": params}, jx["jnp"].asarray(x),
                       mutable=["intermediates"])
    probs, onehot = st["intermediates"]["moe_router"][0]
    return np.asarray(out), np.asarray(probs), np.asarray(onehot)


def _margin(probs: np.ndarray) -> float:
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _dropped(onehot: np.ndarray, capacity: int) -> np.ndarray:
    pos = np.cumsum(onehot, axis=1) * onehot
    return np.argwhere(pos > capacity)


@pytest.mark.parametrize("experts,cf,seed", [(4, 1.25, 1), (8, 1.25, 2),
                                             (4, 0.5, 3)])
def test_layer_output_and_routing_match_tpuic(jx, experts, cf, seed):
    x = _tokens(seed)
    jm, params, pm = _layer(jx, experts, cf, x)
    want, probs, onehot = _jax_apply(jx, jm, params, x)
    got = pm(torch.from_numpy(x))
    gp, go = pm.router_stats
    assert _margin(probs) > MIN_MARGIN, _margin(probs)
    np.testing.assert_array_equal(go.numpy(), onehot)
    np.testing.assert_allclose(gp.detach().numpy(), probs, rtol=1e-5,
                               atol=1e-6)
    _, gate, _, disp = pm.route(torch.from_numpy(x))
    np.testing.assert_allclose(gate.detach().numpy(), probs.max(-1),
                               rtol=1e-6)
    C = pm.capacity(x.shape[1])
    assert disp.shape == (x.shape[0], x.shape[1], experts, C)
    np.testing.assert_array_equal(_dropped(go.numpy(), C),
                                  _dropped(onehot, C))
    if cf < 1.0:
        assert len(_dropped(onehot, C)) > 0  # the capacity case drops
        # A dropped token's dispatch row is all zero.
        for b, n, _ in _dropped(onehot, C):
            assert float(disp[b, n].sum()) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_switch_aux_loss_matches_tpuic(jx, masked):
    jnp = jx["jnp"]
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 9, 6)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    onehot = np.eye(6, dtype=np.float32)[probs.argmax(-1)]
    mask = np.array([1, 1, 0, 1], np.float32) if masked else None
    want = float(jx["moe"].switch_aux_loss(
        jnp.asarray(probs), jnp.asarray(onehot),
        None if mask is None else jnp.asarray(mask)))
    got = float(pmoe.switch_aux_loss(
        torch.from_numpy(probs), torch.from_numpy(onehot),
        None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # The data-parallel pieces on one rank give the same value.
    p, o = torch.from_numpy(probs), torch.from_numpy(onehot)
    m = None if mask is None else torch.from_numpy(mask)
    sums = pmoe.router_sums(p, o, m)
    np.testing.assert_allclose(
        float(pmoe.global_aux_term(p, o, m, sums, 1)), want, rtol=1e-6)


def test_gradients_match_jax_grad(jx):
    """d/d(router, w1, w2, b1, b2) of ``sum(out * r) + aux`` at 4 experts."""
    jax, jnp = jx["jax"], jx["jnp"]
    x = _tokens(5)
    jm, params, pm = _layer(jx, 4, 1.25, x)
    r = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def loss(params):
        out, st = jm.apply({"params": params}, jnp.asarray(x),
                           mutable=["intermediates"])
        p, o = st["intermediates"]["moe_router"][0]
        return jnp.sum(out * r) + jx["moe"].switch_aux_loss(p, o)

    want = jax.grad(loss)({k: jnp.asarray(v) for k, v in params.items()})
    out = pm(torch.from_numpy(x))
    p, o = pm.router_stats
    (torch.sum(out * torch.from_numpy(r))
     + pmoe.switch_aux_loss(p, o)).backward()
    for k in ("router", "w1", "w2", "b1", "b2"):
        g = getattr(pm, k).grad
        assert g is not None and float(g.abs().max()) > 0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_bf16_forward_matches_tpuic(jx):
    x = _tokens(7)
    jm, params, pm = _layer(jx, 4, 1.25, x, dtype="bfloat16")
    want, probs, onehot = _jax_apply(jx, jm, params, x)
    got = pm(torch.from_numpy(x)).float().detach().numpy()
    np.testing.assert_array_equal(pm.router_stats[1].numpy(), onehot)
    assert got.shape == want.shape
    scale = float(np.abs(want.astype(np.float32)).max())
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=0,
                               atol=2e-2 * scale)


def _vit_pair(jx, **mkw):
    """``tpuic``'s ``vit-tiny-moe`` train state and the port's model and
    state on the same weights (SGD); the router redrawn at std 0.5."""
    jax = jx["jax"]
    mcfg = jx["cfg"].ModelConfig(name="vit-tiny-moe", num_classes=CLASSES,
                                 dtype="float32", **mkw)
    ocfg = jx["cfg"].OptimConfig(**SGD)
    jstate = jx["state"](jx["models"].create_model_from_config(mcfg),
                         jx["opt"].make_optimizer(ocfg, 3, 10),
                         jax.random.key(0), (4, SIZE, SIZE, 3))
    router = jstate.params["backbone"]["block1"]["moe"]["router"]
    r = np.random.default_rng(11).standard_normal(
        np.shape(getattr(router, "value", router))).astype(np.float32) * 0.5
    params = jax.tree.map(lambda a: a, jstate.params)
    params["backbone"]["block1"]["moe"]["router"] = router.replace_boxed(
        jx["jnp"].asarray(r))
    jstate = jstate.replace(params=params)
    pm = pcfg.ModelConfig(name="vit-tiny-moe", num_classes=CLASSES,
                          dtype="float32", **mkw)
    po = pcfg.OptimConfig(**SGD)
    model = port_models.create_model_from_config(pm, device="cpu",
                                                 image_size=SIZE)
    load_jax_variables(model, {"params": _np(jstate.params, jax)})
    names = [n for n, _ in model.named_parameters()]
    pstate = create_train_state(model, make_optimizer(po, 3, 10))
    pstate.opt_state = load_jax_opt_state(_np(jstate.opt_state, jax), names,
                                          device="cpu")
    return mcfg, ocfg, jstate, pm, po, model, pstate


def _batches(k, b=4, seed=12):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, SIZE, SIZE, 3)).astype(
                 np.float32),
             "label": rng.integers(0, CLASSES, b).astype(np.int32),
             "mask": np.array([1.0] * (b - 1) + [0.0], np.float32)}
            for _ in range(k)]


@pytest.mark.parametrize("mixup", [0.0, 0.4])
def test_train_steps_with_aux_loss_match_tpuic(jx, mixup):
    """Two SGD steps with the aux loss (weight 0.01, padded last row);
    with mixup the port takes ``tpuic``'s draws.  The aux loss is added
    once, after the mix, in both."""
    import _tpuic_draws as replay
    jax, jnp = jx["jax"], jx["jnp"]
    mcfg, ocfg, jstate, pm, po, model, pstate = _vit_pair(jx)
    if mixup:
        ocfg = jx["cfg"].OptimConfig(**SGD, mixup_alpha=mixup)
        po = pcfg.OptimConfig(**SGD, mixup_alpha=mixup)
    jstep = jx["train"](ocfg, mcfg, None,
                        lr_schedule=jx["opt"].make_schedule(ocfg, 3, 10),
                        donate=False, seed=3)
    pstep = make_train_step(po, pm, lr_schedule=make_schedule(po, 3, 10),
                            device="cpu", seed=3)
    assert po.optimizer == "sgd" and pm.moe_aux_weight == 0.01
    for k, batch in enumerate(_batches(2)):
        draws = (replay.step_draws(jax, 3, k, 4, mixup_alpha=mixup)
                 if mixup else None)
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in batch.items()})
        pstate, m = pstep(pstate, {n: torch.from_numpy(v)
                                   for n, v in batch.items()},
                          step=k, draws=draws)
        assert float(m["moe_aux"]) > 0.9  # E * sum f p >= 1 at balance
        for key in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k} {key}")
    ref = port_models.create_model_from_config(pm, device="cpu",
                                               image_size=SIZE)
    load_jax_variables(ref, {"params": _np(jstate.params, jax)})
    want = dict(ref.named_parameters())
    for name, got in model.named_parameters():
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[name].detach().numpy(), rtol=1e-4,
                                   atol=5e-5, err_msg=name)


def test_strict_load_takes_the_moe_leaves(jx):
    """Every ``block{i}/moe`` leaf maps in ``tpuic``'s layout, and a
    missing one raises."""
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("vit-s16-moe", 10, dtype="float32")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    tree = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    pm = port_models.create_model("vit-s16-moe", 10, dtype="float32",
                                  device="meta")
    load_jax_variables(pm, tree)
    moe = pm.backbone.block11.moe
    assert tuple(moe.router.shape) == (384, 8)
    assert tuple(moe.w1.shape) == (8, 384, 1536)
    assert tuple(moe.w2.shape) == (8, 1536, 384)
    assert [i for i in range(12) if hasattr(getattr(
        pm.backbone, f"block{i}"), "moe")] == [1, 3, 5, 7, 9, 11]
    assert pm.backbone.block11.moe.capacity(197) == 31
    del tree["params"]["backbone"]["block3"]["moe"]["w2"]
    with pytest.raises(KeyError, match="lacks 1 model tensors"):
        load_jax_variables(pm, tree)


def test_opt_state_and_ema_carriers_take_the_moe_leaves(jx):
    """``tpuic``'s Adam moments and EMA of ``vit-tiny-moe`` (after one
    step, so both are nonzero) carried by ``load_jax_opt_state`` and
    ``load_jax_ema``: the MoE leaves in their flax layouts, as the
    variables are."""
    from tpuic_torch.checkpoint import load_jax_ema
    jax, jnp = jx["jax"], jx["jnp"]
    ADAM = dict(optimizer="adam", learning_rate=1e-3, milestones=(),
                class_weights=(), ema_decay=0.9)
    mcfg = jx["cfg"].ModelConfig(name="vit-tiny-moe", num_classes=CLASSES,
                                 dtype="float32")
    ocfg = jx["cfg"].OptimConfig(**ADAM)
    jstate = jx["state"](jx["models"].create_model_from_config(mcfg),
                         jx["opt"].make_optimizer(ocfg, 3, 10),
                         jax.random.key(0), (4, SIZE, SIZE, 3), ema=True)
    jstep = jx["train"](ocfg, mcfg, None, donate=False)
    jstate, _ = jstep(jstate, {n: jnp.asarray(v)
                               for n, v in _batches(1)[0].items()})
    model = port_models.create_model("vit-tiny-moe", CLASSES,
                                     dtype="float32", image_size=SIZE,
                                     device="cpu")
    load_jax_variables(model, {"params": _np(jstate.params, jax)})
    names = [n for n, _ in model.named_parameters()]
    opt = load_jax_opt_state(_np(jstate.opt_state, jax), names,
                             device="cpu")
    ema = load_jax_ema(model, _np(jstate.ema_params, jax), device="cpu")
    by_name = dict(zip(names, zip(opt.mu, opt.nu, ema)))
    ema_moe = _np(jstate.ema_params, jax)["backbone"]["block1"]["moe"]
    for leaf in ("router", "w1", "b1", "w2", "b2"):
        mu, nu, e = by_name[f"backbone.block1.moe.{leaf}"]
        assert tuple(mu.shape) == tuple(getattr(
            model.backbone.block1.moe, leaf).shape)
        assert float(nu.abs().max()) > 0
        np.testing.assert_array_equal(e.numpy(), ema_moe[leaf])


def test_quantized_leaf_set_matches_tpuic(jx):
    """The int8 rung's leaves: ``tpuic.quant`` takes ``kernel`` and
    ``embedding`` leaves, so ``router``, ``w1`` and ``w2`` stay float."""
    import test_torch_port_quant as tq
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("vit-tiny-moe", CLASSES, dtype="float32")
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 32, 32, 3)), train=False), jax.random.key(0))
    qshapes = jax.eval_shape(jx["quant"].quantize_variables,
                             {"params": shapes["params"]})
    want = set(tq._quantized_paths(jx, qshapes))
    pm = port_models.create_model("vit-tiny-moe", CLASSES, dtype="float32",
                                  image_size=32, device="meta")
    got = set(quant.quantized_leaves(pm))
    assert got == want
    assert not {n for n in got if ".moe." in n}


def test_remat_blocks_keeps_aux_loss_and_gradients():
    """``remat_policy='blocks'``: the backward's recompute records no
    second router stats, and the aux loss and every gradient equal the
    step without remat."""
    results = []
    for remat in (False, True):
        mcfg = pcfg.ModelConfig(name="vit-tiny-moe", num_classes=CLASSES,
                                dtype="float32", remat=remat,
                                remat_policy="blocks")
        ocfg = pcfg.OptimConfig(**SGD)
        model = init_params(port_models.create_model_from_config(
            mcfg, device="cpu", image_size=SIZE), 2, device="cpu")
        assert model.backbone.remat_blocks == remat
        state = create_train_state(model, make_optimizer(ocfg, 3, 10))
        step = make_train_step(ocfg, mcfg, device="cpu")
        batch = {n: torch.from_numpy(v) for n, v in _batches(1)[0].items()}
        _, m = step(state, batch, step=0)
        assert model.backbone.block1.moe.router_stats is None
        results.append((float(m["moe_aux"]), float(m["loss"]),
                        [p.grad.clone() for p in model.parameters()]))
    (a0, l0, g0), (a1, l1, g1) = results
    assert a0 == a1 and l0 == l1
    for x, y in zip(g0, g1):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_served_row_is_independent_of_its_bucket():
    """The engine on the CPU: one image alone (bucket 1) and the same image
    as the first row of a full bucket of 4."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.serve import InferenceEngine
    model = port_models.create_model("vit-tiny-moe", CLASSES,
                                     dtype="float32", image_size=SIZE,
                                     device="cpu")
    init_synthetic(model, seed=1, device="cpu")
    eng = InferenceEngine(model.eval(), image_size=SIZE, buckets=(1, 4),
                          device="cpu", max_wait_ms=1.0)
    try:
        eng.warmup()
        x = np.random.default_rng(13).standard_normal(
            (4, SIZE, SIZE, 3)).astype(np.float32)
        alone, _ = eng.submit(x[:1]).result(timeout=60)
        full, _ = eng.submit(x).result(timeout=60)
    finally:
        eng.close()
    assert alone.shape == (1, CLASSES) and full.shape == (4, CLASSES)
    assert np.isfinite(full).all()
    np.testing.assert_allclose(alone[0], full[0], rtol=1e-5, atol=1e-6)


def test_serve_cli_serves_moe_models(tmp_path):
    """``python -m tpuic_torch.serve`` on a seeded ``vit-tiny-moe``: one
    image file over stdin answered with its top-1."""
    from PIL import Image
    path = str(tmp_path / "a.png")
    Image.fromarray(np.random.default_rng(15).integers(
        0, 255, (SIZE, SIZE, 3), dtype=np.uint8)).save(path)
    out = subprocess.run(
        [sys.executable, "-m", "tpuic_torch.serve", "--model",
         "vit-tiny-moe", "--synthetic-init", "--device", "cpu",
         "--num-classes", str(CLASSES), "--resize", str(SIZE)],
        input=json.dumps({"path": path}) + "\n", cwd=ROOT, text=True,
        capture_output=True, timeout=240,
        env=subprocess_env(PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    (rec,) = [json.loads(line) for line in out.stdout.splitlines()
              if line.startswith("{")]
    assert rec["id"] == path and 0.0 < rec["prob"] <= 1.0
    assert rec["pred"] in {str(c) for c in range(CLASSES)}


# -- data parallel: two gloo ranks against one process -------------------
WORLD = 2
GLOBAL = 8


def _dp_run(rank: int = 0, world: int = 1) -> dict:
    """One SGD step of ``vit-tiny-moe`` with drop-path 0.3 on this
    process's rows of a global batch of 8 (one padded row)."""
    mcfg = pcfg.ModelConfig(name="vit-tiny-moe", num_classes=CLASSES,
                            dtype="float32", drop_path=0.3)
    ocfg = pcfg.OptimConfig(**SGD)
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cpu", image_size=SIZE), 5, device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(7)
        model.backbone.block1.moe.router.copy_(torch.randn(
            model.backbone.block1.moe.router.shape, generator=g) * 0.5)
    state = create_train_state(model, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, device="cpu", seed=6)
    batch = _batches(1, b=GLOBAL, seed=14)[0]
    lb = GLOBAL // world
    _, m = step(state, {n: torch.from_numpy(v[rank * lb:(rank + 1) * lb])
                        for n, v in batch.items()}, step=0)
    return {"metrics": {n: float(v) for n, v in m.items()},
            "grads": [p.grad.numpy().copy() for p in model.parameters()],
            "names": [n for n, _ in model.named_parameters()]}


def _dp_rank_main(workdir: str) -> None:
    info = distributed.initialize(device="cpu")
    out = _dp_run(info.process_index, info.process_count)
    with open(os.path.join(workdir, f"rank{info.process_index}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    distributed.shutdown()


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("moe_dp"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = ["-c", f"import sys; sys.path.insert(0, {HERE!r}); "
                 "import test_torch_port_moe as t; "
                 f"t._dp_rank_main({work!r})"]
    procs = [subprocess.Popen(
        [sys.executable, *cmd], cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=subprocess_env(
            PYTHONPATH=ROOT, TPUIC_COORDINATOR_ADDRESS=f"localhost:{port}",
            TPUIC_NUM_PROCESSES=str(WORLD), TPUIC_PROCESS_ID=str(r)))
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert not any(p.returncode for p in procs), "\n".join(
        o[-3000:] for o in outs)
    got = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def test_two_ranks_aux_loss_equals_one_process(dp_ranks):
    """The global-batch aux loss over two ranks: the logged loss and aux
    value are the one process's, and DDP's mean gradient is its gradient
    (the router's included, which the aux loss alone reaches through the
    probabilities)."""
    want = _dp_run()
    for r, got in enumerate(dp_ranks):
        for key in ("loss", "moe_aux"):
            np.testing.assert_allclose(got["metrics"][key],
                                       want["metrics"][key], rtol=1e-5,
                                       err_msg=f"rank {r} {key}")
        for name, a, b in zip(want["names"], got["grads"], want["grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {name}")
