"""Port parity: EfficientNet-B0 training with stochastic depth 0.2
against ``tpuic``'s ``make_train_step``.

Three SGD steps (momentum 0.9, no class weights, as
``recipes/README.md`` section 3, at lr 0.01) of EfficientNet-B0 at 64 px,
batch 4, float32, from one flax init carried by ``load_jax_variables``
and ``load_jax_opt_state``; each step takes the stochastic-depth masks
``tpuic``'s model draws at that step (``tests/_tpuic_draws.py``: 9 draw
sites, one per block with a residual).  Loss, gradient norm and accuracy
rtol 1e-4 each step; then parameters and the momentum trace rtol 1e-4 /
atol 5e-5, BN statistics rtol 1e-4 / atol 1e-5
(``test_torch_port_train.py::test_three_train_steps_match_tpuic``'s
tolerances; ``test_torch_port_efficientnet.py`` says why 64 px and batch
4 keep float32 well conditioned; at lr 0.01 the worst tensor, a late
stage's BN mean, lies at 0.13 of its tolerance, at lr 0.05 it drifts
past it, in step with the gradient norm's growth).  A control: a step
whose masks drop a block gives another loss with every block kept.

JAX and ``tpuic`` are imported inside fixtures.
"""

import numpy as np
import pytest
import torch

import _tpuic_draws as replay
from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import load_jax_opt_state, load_jax_variables
from tpuic_torch.train import augment
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

CLASSES = 7
SIZE = 64
BATCH = 4
OPTIM = dict(optimizer="sgd", learning_rate=0.01, milestones=(),
             class_weights=())
SEED = 0


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic import config as jcfg
    from tpuic import models as jmodels
    from tpuic.train import optimizer as jopt
    from tpuic.train.state import create_train_state as jstate
    from tpuic.train.step import make_train_step as jtrain
    return dict(jax=jax, jnp=jnp, cfg=jcfg, models=jmodels, opt=jopt,
                state=jstate, train=jtrain)


def _np(tree, jax):
    return jax.tree.map(np.asarray, tree)


def _batches(k, seed=3):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
                np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32),
             "mask": np.ones(BATCH, np.float32)} for _ in range(k)]


@pytest.fixture(scope="module")
def runs(jx):
    """``tpuic``'s three steps, the masks it drew, and the carried start."""
    jax, jnp = jx["jax"], jx["jnp"]
    mcfg = jx["cfg"].ModelConfig(name="efficientnet-b0", num_classes=CLASSES,
                                 dtype="float32")
    ocfg = jx["cfg"].OptimConfig(**OPTIM)
    jmodel = jx["models"].create_model_from_config(mcfg)
    jstate = jx["state"](jmodel, jx["opt"].make_optimizer(ocfg, 3, 10),
                         jax.random.key(0), (BATCH, SIZE, SIZE, 3))
    start = _np(jstate, jax)
    jstep = jx["train"](ocfg, mcfg, None,
                        lr_schedule=jx["opt"].make_schedule(ocfg, 3, 10),
                        donate=False, seed=SEED)
    batches, masks, metrics = _batches(3), [], []
    for k, batch in enumerate(batches):
        # The masks depend on the key and the batch size alone: record
        # them on small images (an eager apply at 64 px is slow).
        masks.append(replay.drop_masks(
            jax, jmodel, {"params": jstate.params,
                          "batch_stats": jstate.batch_stats},
            batch["image"][:, ::4, ::4], SEED, k))
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in batch.items()})
        metrics.append({k: float(v) for k, v in jm.items()})
    return dict(start=start, end=_np(jstate, jax), masks=masks,
                metrics=metrics, batches=batches)


def _port(start):
    pm = pcfg.ModelConfig(name="efficientnet-b0", num_classes=CLASSES,
                          dtype="float32")
    po = pcfg.OptimConfig(**OPTIM)
    model = port_models.create_model_from_config(pm, device="cpu")
    load_jax_variables(model, {"params": start.params,
                               "batch_stats": start.batch_stats})
    state = create_train_state(model, make_optimizer(po, 3, 10))
    state.opt_state = load_jax_opt_state(
        start.opt_state, [n for n, _ in model.named_parameters()],
        device="cpu")
    step = make_train_step(po, pm, lr_schedule=make_schedule(po, 3, 10),
                           device="cpu", seed=SEED)
    return state, step


def test_three_steps_with_stochastic_depth_match_tpuic(runs):
    assert all(m.shape == (9, BATCH) for m in runs["masks"])
    assert any(not bool(m.all()) for m in runs["masks"])  # something drops
    state, step = _port(runs["start"])
    for k, batch in enumerate(runs["batches"]):
        draws = augment.StepDraws(None, None, runs["masks"][k])
        state, m = step(state, {n: torch.from_numpy(v)
                                for n, v in batch.items()},
                        step=k, draws=draws)
        for key in ("loss", "grad_norm", "accuracy", "lr"):
            np.testing.assert_allclose(float(m[key]),
                                       runs["metrics"][k][key], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {k} {key}")
    end = runs["end"]
    ref = port_models.create_model("efficientnet-b0", CLASSES,
                                   dtype="float32", device="cpu")
    load_jax_variables(ref, {"params": end.params,
                             "batch_stats": end.batch_stats})
    want = ref.state_dict()
    for name, got in state.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = (dict(rtol=1e-4, atol=1e-5) if "running" in name
               else dict(rtol=1e-4, atol=5e-5))
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **tol)
    carried = load_jax_opt_state(
        end.opt_state, [n for n, _ in state.model.named_parameters()],
        device="cpu")
    for a, b in zip(state.opt_state.trace, carried.trace):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=5e-5)


def test_the_masks_change_the_loss(runs):
    """The control: on a batch whose masks drop a block, the same step
    from the same state keeping every block gives another loss."""
    k = next(i for i, m in enumerate(runs["masks"]) if not bool(m.all()))
    batch = {n: torch.from_numpy(v) for n, v in runs["batches"][k].items()}
    losses = []
    for masks in (runs["masks"][k], torch.ones_like(runs["masks"][k])):
        state, step = _port(runs["start"])
        _, m = step(state, batch, step=k,
                    draws=augment.StepDraws(None, None, masks))
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) > 1e-3 * abs(losses[1])
