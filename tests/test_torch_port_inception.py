"""Port parity: InceptionV3 with its aux head, against ``tpuic``'s.

One flax initialisation (``tpuic``'s ``InceptionV3``, 7 classes, init in
train mode at 299 px so the aux head has parameters) goes into the port
through ``load_jax_variables``; inputs come from numpy seeds.

- Eval logits at 75 px, batch 2, float32.  The running statistics are
  calibrated first (a train-mode pass at momentum 0 on another batch), so
  the logits are O(100) rather than flax-init's ~1e-4.  Tolerance: atol
  1e-4 times max |logit| (measured 3.7e-5 times: float32 sums in another
  order through 94 convolutions).
- Train mode at 299 px, batch 2: logits (atol 1e-4; measured 1.8e-5 of
  max 0.26) and aux logits (atol 2e-3; measured 4.9e-4 of max 1.38: the
  aux head's last BN normalises two values, one a sample, and a float64
  port forward lies 2.0e-4 from the port's float32 and 3.9e-4 from
  ``tpuic``'s), the updated BN statistics (rtol 1e-3, atol 5e-5; measured
  1.2e-5 in that same BN), then one Adam step of ``tpuic``'s
  ``make_train_step`` with the 0.4-weighted aux loss and class weights:
  the loss (rtol 1e-4; measured 1.7e-5), every updated BN statistic, and
  the parameters: all within two Adam steps (2 lr), and all but 1% within
  2e-6.  Adam's first step is lr times the gradient's sign, and float32
  gradients of this net are noise at 0.44% of the weights (the port's own
  against its float64 gradient, batch 4, most in ``mixed7c``).
- ``convert_inception`` of a torchvision-layout state dict gives the same
  tree in both packages.
- ``cuda``: the step through K1 (2 forward, 2 backward launches: main and
  aux logits) against the plain loss on the card.

JAX and ``tpuic`` are imported inside fixtures, so the ``cuda`` test runs
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import load_jax_variables
from tpuic_torch.checkpoint import torch_convert as ptc
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

CLASSES = 7
WEIGHTS = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)
OPTIM = dict(optimizer="adam", learning_rate=1e-4, milestones=(),
             class_weights=WEIGHTS)


def _images(seed, size, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic import config as jcfg
    from tpuic.models import create_model_from_config
    from tpuic.train import optimizer as jopt
    from tpuic.train.state import TrainState
    from tpuic.train.step import make_train_step as jtrain
    mcfg = jcfg.ModelConfig(name="inceptionv3", num_classes=CLASSES,
                            dtype="float32")
    model = create_model_from_config(mcfg)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 299, 299, 3)),
        train=True))(jax.random.key(0))
    tree = jax.tree.map(np.asarray, {"params": variables["params"],
                                     "batch_stats": variables["batch_stats"]})
    return dict(jax=jax, jnp=jnp, cfg=jcfg, mcfg=mcfg, model=model,
                tree=tree, opt=jopt, TrainState=TrainState, train=jtrain)


def _port(tree):
    pm = port_models.create_model("inceptionv3", CLASSES, dtype="float32",
                                  device="cpu")
    return load_jax_variables(pm, tree)


def _calibrated(jx):
    """The flax tree with every BN's running statistics set to one
    batch's statistics (a port train-mode pass at flax momentum 0; the aux
    head's keep their init, which no eval forward reads)."""
    pm = _port(jx["tree"])
    for m in pm.modules():
        if hasattr(m, "flax_momentum"):
            m.flax_momentum = 0.0
    pm.backbone.aux_classes = 0  # 75 px is too small for the aux branch
    pm.train()
    with torch.no_grad():
        pm.backbone(torch.from_numpy(_images(11, 75, batch=4)))
    sd = pm.state_dict()
    stats = {}
    for path in _flat(jx["tree"]["batch_stats"]):
        *mods, leaf = path.split("/")
        name = ".".join(mods) + (".running_mean" if leaf == "mean"
                                 else ".running_var")
        node = stats
        for k in mods[:-1]:
            node = node.setdefault(k, {})
        node.setdefault(mods[-1], {})[leaf] = sd[name].numpy().copy()
    return {"params": jx["tree"]["params"], "batch_stats": stats}


def test_eval_logits_match_tpuic_at_75px(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    tree = _calibrated(jx)
    x = _images(0, 75)
    want = np.asarray(jax.jit(lambda v, x: jx["model"].apply(
        v, x, train=False))(tree, jnp.asarray(x)))
    pm = _port(tree).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, CLASSES)
    scale = np.abs(want).max()
    assert scale > 1.0  # calibrated: not flax-init's ~1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def train_ref(jx):
    """tpuic's train-mode forward and one Adam step at 299 px, batch 2."""
    jax, jnp = jx["jax"], jx["jnp"]
    x = _images(1, 299)
    labels = np.array([2, 5], np.int32)
    (logits, aux), upd = jax.jit(lambda v, x: jx["model"].apply(
        v, x, train=True, mutable=["batch_stats"]))(jx["tree"],
                                                    jnp.asarray(x))
    ocfg = jx["cfg"].OptimConfig(**OPTIM)
    tx = jx["opt"].make_optimizer(ocfg, 3, 10)
    params = jax.tree.map(jnp.asarray, jx["tree"]["params"])
    state = jx["TrainState"](
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, jx["tree"]["batch_stats"]),
        opt_state=tx.init(params), apply_fn=jx["model"].apply, tx=tx,
        skip_count=jnp.zeros((), jnp.int32))
    step = jx["train"](ocfg, jx["mcfg"], None, donate=False)
    batch = {"image": x, "label": labels, "mask": np.ones(2, np.float32)}
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(batch=batch, logits=np.asarray(logits), aux=np.asarray(aux),
                fwd_stats=jax.tree.map(np.asarray, upd["batch_stats"]),
                loss=float(metrics["loss"]),
                params=jax.tree.map(np.asarray, new.params),
                stats=jax.tree.map(np.asarray, new.batch_stats))


def _assert_tree(model, tree, tol):
    ref = _port(tree)
    want = ref.state_dict()
    for name, got in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        kind = "stats" if "running" in name else "params"
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **tol[kind])


def test_train_mode_logits_aux_and_bn_stats_match_tpuic(jx, train_ref):
    pm = _port(jx["tree"]).train()
    with torch.no_grad():
        out = pm(torch.from_numpy(train_ref["batch"]["image"]))
    assert isinstance(out, tuple) and len(out) == 2
    logits, aux = (t.numpy() for t in out)
    assert logits.shape == aux.shape == (2, CLASSES)
    assert logits.dtype == aux.dtype == np.float32
    np.testing.assert_allclose(logits, train_ref["logits"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(aux, train_ref["aux"], rtol=0, atol=2e-3)
    _assert_tree(pm, {"params": jx["tree"]["params"],
                      "batch_stats": train_ref["fwd_stats"]},
                 {"params": dict(rtol=0, atol=0),
                  "stats": dict(rtol=1e-3, atol=5e-5)})
    pm.eval()  # eval mode: features only, no aux output
    with torch.no_grad():
        assert pm(torch.from_numpy(_images(2, 75))).shape == (2, CLASSES)


def test_one_adam_step_with_aux_loss_matches_tpuic(jx, train_ref):
    mcfg = pcfg.ModelConfig(name="inceptionv3", num_classes=CLASSES,
                            dtype="float32")
    ocfg = pcfg.OptimConfig(**OPTIM)
    pm = _port(jx["tree"])
    state = create_train_state(pm, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, device="cpu")
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in train_ref["batch"].items()})
    assert float(m["skipped"]) == 0.0
    np.testing.assert_allclose(float(m["loss"]), train_ref["loss"],
                               rtol=1e-4)
    want = _port({"params": train_ref["params"],
                  "batch_stats": train_ref["stats"]}).state_dict()
    lr = OPTIM["learning_rate"]
    far = total = 0
    for name, p in pm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        # Adam's first step moves a weight by lr * g / (|g| + eps): no two
        # runs can be further apart than two steps.
        assert diff.max() <= 2 * lr + 2e-6, name
        far += int((diff > 2e-6).sum())
        total += diff.size
    # Where |g| is at float32 noise the step's sign is noise: the port's
    # own float32 gradient has the sign of its float64 gradient for all
    # but 0.44% of the weights at batch 4 (the ill-conditioned mixed7c).
    assert far <= 0.01 * total, (far, total)
    for name, got in pm.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                       rtol=1e-3, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("prefix", ["", "module.encoder."])
def test_convert_inception_matches_tpuic(prefix):
    pytest.importorskip("jax")
    from tpuic.checkpoint import torch_convert as jtc
    from tpuic.checkpoint.torch_ref import build_inception
    torch.manual_seed(0)
    sd = {prefix + k: v for k, v in
          build_inception(num_classes=CLASSES).state_dict().items()}
    assert ptc.detect_arch(sd) == jtc.detect_arch(sd) == "inceptionv3"
    got, want = ptc.convert_state_dict(sd), jtc.convert_state_dict(sd)
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(want[coll])
        assert set(g) == set(w) and g
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert "aux" in got["params"]["backbone"]
    # The converted tree loads into the port model strictly.
    load_jax_variables(port_models.create_model(
        "inceptionv3", CLASSES, dtype="float32", device="cpu"), got)


@pytest.mark.cuda
def test_cuda_aux_step_through_k1_matches_plain_loss():
    """One InceptionV3 step at 299 px, batch 8, from one state: the fused
    loss (K1 on the main and the aux logits: 2 forward and 2 backward
    launches) against the plain loss, TF32 off: loss rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import (cross_entropy_bwd, cross_entropy_fwd,
                                     no_tf32)
    mcfg = pcfg.ModelConfig(name="inceptionv3", num_classes=CLASSES,
                            dtype="float32")
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(_images(3, 299, batch=8)).cuda(),
             "label": torch.from_numpy(rng.integers(0, CLASSES, 8)
                                       .astype(np.int32)).cuda(),
             "mask": torch.ones(8, device="cuda")}
    losses = {}
    for fused in (True, False):
        ocfg = pcfg.OptimConfig(**OPTIM, fused_loss=fused)
        model = init_params(port_models.create_model_from_config(
            mcfg, device="cuda"), 0, device="cuda")
        state = create_train_state(model, make_optimizer(ocfg, 3, 10))
        step = make_train_step(ocfg, mcfg, device="cuda")
        torch.cuda.synchronize()
        before = (cross_entropy_fwd.launches, cross_entropy_bwd.launches)
        with no_tf32():
            state, m = step(state, batch)
        torch.cuda.synchronize()
        launched = (cross_entropy_fwd.launches - before[0],
                    cross_entropy_bwd.launches - before[1])
        assert launched == ((2, 2) if fused else (0, 0))
        losses[fused] = float(m["loss"])
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
