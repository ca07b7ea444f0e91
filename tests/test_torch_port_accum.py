"""Port parity: gradient accumulation (``optax.MultiSteps``) and
``freeze_backbone`` (``optax.multi_transform``) against ``tpuic``.

- **Accumulation, the optimizer alone**: K = 2 and 4 for adam, sgd,
  lars and lamb (plain, and lars / lamb fused, the K2 kernels' plain
  versions on the CPU) with clipping at 1.5 and a milestone at micro-step
  2 (``lr(t_real) = micro(t_real * K)``), ``2K + 1`` micro-steps with a
  non-finite one in the middle (the port's ``finite`` gate off, ``tpuic``'s
  state passed through, as its skip guard does), against
  ``tpuic.train.optimizer.make_optimizer(grad_accum_steps=K)``:
  parameters after every micro-step at ``test_torch_port_optimizer.py``'s
  trajectory tolerance (rtol 2e-5 / atol 1e-6), bit for bit unchanged on
  the micro-steps between updates; ``mini_step``, ``gradient_step``,
  ``count`` and ``acc`` through ``load_jax_opt_state``.
- **Accumulation, the whole step**: ``resnet18-cifar`` at 32 px, K = 2,
  ``test_torch_port_train.py``'s recipe (fused LARS, the 7 class weights,
  smoothing 0.1), EMA 0.5 and the skip guard, five micro-steps with a NaN batch
  third (each window's two micro-batches one batch, see the test), against ``tpuic``'s ``make_train_step``: loss, gradient norm and
  lr each micro-step (rtol 1e-4), then parameters, BN statistics and the
  EMA (``test_torch_port_train.py``'s tolerances); the EMA holds between
  real updates.
- **freeze_backbone**: two AdamW steps (wd 0.05) of ``resnet18-cifar``:
  the backbone's parameters bit for bit, no gradient computed for them;
  the head, the BN statistics (which still update) and the head-only
  gradient norm against ``tpuic``; ``tpuic``'s partitioned optimizer
  state carried onto the head's parameters.

JAX and ``tpuic`` are imported inside fixtures.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import (load_jax_ema, load_jax_opt_state,
                                    load_jax_variables)
from tpuic_torch.config import OptimConfig
from tpuic_torch.train import optimizer as port_opt
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

TRAJ_TOL = dict(rtol=2e-5, atol=1e-6)
OCFG = OptimConfig(optimizer="sgd", learning_rate=0.1, class_weights=(),
                   milestones=(2,), gamma=0.5, weight_decay=1e-3,
                   grad_clip_norm=1.5)
CLASSES = 7
# test_torch_port_train.py's step recipe (the 7 class weights, smoothing,
# the fused loss and LARS), whose float32 runs agree on its batches.
TRAIN_OPTIM = dict(optimizer="lars", learning_rate=0.1, milestones=(),
                   class_weights=(3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0),
                   weight_decay=1e-4, label_smoothing=0.1, fused_loss=True,
                   fused_optimizer=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import optax
    from tpuic import config as jcfg
    from tpuic import models as jmodels
    from tpuic.train import optimizer as jopt
    from tpuic.train.state import create_train_state as jstate
    from tpuic.train.step import make_train_step as jtrain
    return dict(jax=jax, jnp=jnp, optax=optax, cfg=jcfg, models=jmodels,
                opt=jopt, state=jstate, train=jtrain)


def _np(tree, jax):
    return jax.tree.map(np.asarray, tree)


# -- the optimizer alone -------------------------------------------------------

def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": rng.standard_normal((6, 5)).astype(np.float32)},
            "b": {"bias": np.zeros((5,), np.float32)},
            "c": {"scale": rng.standard_normal((7,)).astype(np.float32)}}


NAMES = ("a.weight", "b.bias", "c.weight")
LEAVES = (("a", "kernel"), ("b", "bias"), ("c", "scale"))


def _grad(params, k):
    rng = np.random.default_rng(100 + k)
    return {m: {leaf: (0.5 * v + rng.standard_normal(v.shape)).astype(
        np.float32) for leaf, v in d.items()} for m, d in params.items()}


def _port_layout(tree):
    return [torch.from_numpy(np.array(
        tree[m][leaf].T if tree[m][leaf].ndim == 2 else tree[m][leaf]))
        for m, leaf in LEAVES]


CASES = [("adam", False, 1e-2), ("sgd", False, 0.1), ("lars", False, 2.0),
         ("lamb", False, 0.05), ("lars", True, 2.0), ("lamb", True, 0.05)]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name,fused,lr", CASES)
def test_accumulation_matches_multisteps(jx, name, fused, lr, k):
    jax, jnp, optax = jx["jax"], jx["jnp"], jx["optax"]
    cfg = dataclasses.replace(OCFG, optimizer=name, learning_rate=lr,
                              fused_optimizer=fused, grad_accum_steps=k)
    tx = jx["opt"].make_optimizer(
        jx["cfg"].OptimConfig(**dataclasses.asdict(cfg)), 1, 10)
    jp = jax.tree.map(jnp.asarray, _params(3))
    js = tx.init(jp)
    ptx = port_opt.make_optimizer(cfg, 1, 10)
    pp = _port_layout(_params(3))
    ps = ptx.init(pp)
    bad = k + 1  # a non-finite micro-step in the middle of the 2nd window
    for t in range(2 * k + 1):
        g = _grad(jax.tree.map(np.asarray, jp), t)
        before = [p.clone() for p in pp]
        if t == bad:
            pg = [torch.full_like(p, float("nan")) for p in pp]
            ptx.update(pp, pg, ps, torch.tensor(False))
            for a, b in zip(pp, before):
                assert torch.equal(a, b)
            continue
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        emit = int(ps.mini_step) == k - 1
        ptx.update(pp, _port_layout(g), ps, torch.tensor(True))
        if not emit:
            for a, b in zip(pp, before):
                assert torch.equal(a, b), f"micro-step {t} moved params"
        for got, want in zip(pp, _port_layout(_np(jp, jax))):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       err_msg=f"{name} K={k} step {t}",
                                       **TRAJ_TOL)
    carried = load_jax_opt_state(_np(js, jax), NAMES, device="cpu")
    assert int(ps.mini_step) == int(carried.mini_step) == 0
    assert int(ps.gradient_step) == int(carried.gradient_step) == 2
    assert int(ps.count) == int(carried.count) == 2
    for a, b in zip(ps.acc, carried.acc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TRAJ_TOL)


def test_accumulated_lr_runs_in_micro_step_time():
    cfg = dataclasses.replace(OCFG, grad_accum_steps=2)
    ptx = port_opt.make_optimizer(cfg, 1, 10)
    micro = port_opt.make_schedule(cfg, 1, 10)
    for t in range(4):
        c = torch.tensor(t, dtype=torch.int32)
        assert float(ptx.lr(c)) == float(micro(c * 2))


# -- the whole step ------------------------------------------------------------

def _batches(k, b=4, size=32, seed=6):
    """``test_torch_port_train.py``'s batches (seed 6, a padded last row),
    on which this net's float32 gradients agree between the packages."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, size, size, 3)).astype(
                np.float32),
             "label": rng.integers(0, CLASSES, b).astype(np.int32),
             "mask": np.array([1.0] * (b - 1) + [0.0], np.float32)}
            for _ in range(k)]


def _setups(jx, optim):
    jax = jx["jax"]
    mcfg = jx["cfg"].ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                                 dtype="float32")
    ocfg = jx["cfg"].OptimConfig(**optim)
    jstate = jx["state"](jx["models"].create_model_from_config(mcfg),
                         jx["opt"].make_optimizer(ocfg, 3, 10),
                         jax.random.key(0), (4, 32, 32, 3),
                         ema=ocfg.ema_decay > 0)
    jstep = jx["train"](ocfg, mcfg, None,
                        lr_schedule=jx["opt"].make_schedule(ocfg, 3, 10),
                        donate=False)
    start = _np(jstate, jax)
    pm = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                          dtype="float32")
    po = pcfg.OptimConfig(**optim)
    model = port_models.create_model_from_config(pm, device="cpu")
    load_jax_variables(model, {"params": start.params,
                               "batch_stats": start.batch_stats})
    pstate = create_train_state(model, port_opt.make_optimizer(po, 3, 10),
                                ema=po.ema_decay > 0)
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    pstate.opt_state = load_jax_opt_state(start.opt_state, trained,
                                          device="cpu")
    pstep = make_train_step(po, pm,
                            lr_schedule=port_opt.make_schedule(po, 3, 10),
                            device="cpu")
    return jstate, jstep, pstate, pstep


def _run(jx, jstate, jstep, pstate, pstep, batches, keys):
    jnp = jx["jnp"]
    for k, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in batch.items()})
        pstate, m = pstep(pstate, {n: torch.from_numpy(v)
                                   for n, v in batch.items()})
        for key in keys:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k} {key}")
    return jstate, pstate


def _reference(jx, jstate):
    jax = jx["jax"]
    ref = port_models.create_model("resnet18-cifar", CLASSES,
                                   dtype="float32", device="cpu")
    load_jax_variables(ref, {"params": _np(jstate.params, jax),
                             "batch_stats": _np(jstate.batch_stats, jax)})
    return ref


def _same_model(got, want, names=None):
    w = want.state_dict()
    for name, t in got.state_dict().items():
        if name.endswith("num_batches_tracked") or (
                names is not None and name not in names):
            continue
        tol = (dict(rtol=1e-4, atol=1e-5) if "running" in name
               else dict(rtol=1e-4, atol=5e-5))
        np.testing.assert_allclose(t.numpy(), w[name].numpy(), err_msg=name,
                                   **tol)


def test_accumulation_and_ema_steps_match_tpuic(jx):
    optim = dict(TRAIN_OPTIM, grad_accum_steps=2, ema_decay=0.5)
    jstate, jstep, pstate, pstep = _setups(jx, optim)
    # Each window's two micro-batches are one batch: at the initial
    # weights this net's float32 gradient of seed 6's second batch lies up
    # to 7% (in single tensors) from one package to the other, which the
    # first update's trust ratio of 1 on every zero bias passes on whole;
    # its first batch agrees to 2e-5, and its second does at the weights
    # after one update.  The mean of distinct gradients is held by
    # test_accumulation_matches_multisteps.
    a, b, c = _batches(3)
    nan = {k: v.copy() for k, v in c.items()}
    nan["image"][0, 0, 0, 0] = np.nan
    batches = [a, a, nan, b, b]
    emas = []
    for batch in batches:
        jstate, pstate = _run(jx, jstate, jstep, pstate, pstep, [batch],
                              ("loss", "grad_norm", "lr", "skipped"))
        emas.append([e.clone() for e in pstate.ema_params])
    # Micro-steps 0, 1, (NaN), 2, 3: the EMA moves on the 2nd and the 4th
    # finite ones, the real updates, and holds on the others.
    moved = [any(not torch.equal(a, b) for a, b in zip(x, y))
             for x, y in zip(emas, emas[1:])]
    assert moved == [True, False, False, True]
    assert int(pstate.step) == int(jstate.step) == 4
    assert int(pstate.opt_state.gradient_step) == 2
    _same_model(pstate.model, _reference(jx, jstate))
    want_ema = load_jax_ema(pstate.model, _np(jstate.ema_params, jx["jax"]),
                            device="cpu")
    for a, b in zip(pstate.ema_params, want_ema):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=5e-5)


def test_freeze_backbone_steps_match_tpuic(jx):
    optim = dict(TRAIN_OPTIM, optimizer="adam", learning_rate=1e-3,
                 weight_decay=0.05, fused_optimizer=False,
                 freeze_backbone=True)
    jstate, jstep, pstate, pstep = _setups(jx, optim)
    model = pstate.model
    frozen = {n: p.detach().clone()
              for n, p in model.backbone.named_parameters()}
    head = [n for n, p in model.named_parameters() if p.requires_grad]
    assert head and all(n.startswith("head.") for n in head)
    assert len(pstate.opt_state.mu) == len(head)
    stats0 = [b.clone() for b in pstate.bn_buffers()]
    jstate, pstate = _run(jx, jstate, jstep, pstate, pstep, _batches(2),
                          ("loss", "grad_norm", "accuracy"))
    for n, p in model.backbone.named_parameters():
        assert torch.equal(p.detach(), frozen[n]), n
        assert p.grad is None, n
    assert any(not torch.equal(a, b)
               for a, b in zip(stats0, pstate.bn_buffers()))
    ref = _reference(jx, jstate)
    _same_model(model, ref, names=set(head) | {
        n for n, _ in model.named_buffers() if "running" in n})
    for n, p in ref.backbone.named_parameters():  # tpuic's stayed too
        assert torch.equal(p.detach(), frozen[n]), n
    carried = load_jax_opt_state(_np(jstate.opt_state, jx["jax"]), head,
                                 device="cpu")
    assert int(carried.count) == int(pstate.opt_state.count) == 2
    for a, b in zip(pstate.opt_state.mu, carried.mu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=5e-5)
