"""Port parity: the bf16 compute tier against ``tpuic``'s.

- bf16 logits: ``resnet18-cifar`` (32 px) and InceptionV3 (75 px), eval,
  with random running statistics near the identity, each from float32
  master weights carried by ``load_jax_variables``, against ``tpuic``'s
  ``dtype="bfloat16"`` forward.  Bound: 2e-2 times max |logit| (bf16
  keeps 8 bits of mantissa; products and sums round in other places on
  the two sides; InceptionV3 measured 4.7e-3, each side within 5e-3 of
  float32).  Statistics calibrated to one batch are not used here: at 75
  px they make the net chaotic under bf16 rounding (either side's bf16
  logits move O(1) from its own float32 ones).
- The ``--bn-bf16-stats`` experiment (``bn_f32_stats=False``): a
  train-mode bf16 ``resnet18-cifar`` forward and its updated BN
  statistics against ``tpuic``'s, at the same bound.
- Three bf16 training steps (``compute_dtype="bf16"``, Adam, class
  weights) of ``resnet18-cifar`` against ``tpuic``'s: per-step loss rtol
  2e-2.  Parameters and optimizer moments stay float32.
- Static loss scaling: ``loss_scale=128`` in float32 gives the step of
  ``loss_scale=1`` (atol 1e-6; a power of two scales exactly).
- Every bf16 case also holds, through forward hooks, that each
  convolution's output is bfloat16: the bounds above are loose enough
  that a float32 forward would pass them.
- Three bf16 steps of ``vit-tiny`` with flash attention against
  ``tpuic``'s (K4's bf16 build is on this path since its Hopper redesign;
  the Trainer no longer refuses the ViT family in bf16).  EfficientNet
  training is refused by name.
- ``resolve_compute_dtype``'s copy agrees with ``tpuic``'s on every
  spelling.

JAX and ``tpuic`` are imported inside fixtures.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import init_params, load_jax_variables
from tpuic_torch.models.classifier import Classifier
from tpuic_torch.models.inception import InceptionV3
from tpuic_torch.train.loop import unported_settings
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step

CLASSES = 7
WEIGHTS = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)
BF16_TOL = 2e-2


def _images(seed, size, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)).astype(np.float32)


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


def _init(jx, model, size, train=False):
    jax, jnp = jx["jax"], jx["jnp"]
    v = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                     jnp.zeros((1, size, size, 3)),
                                     train=train))(jax.random.key(0))
    return jax.tree.map(np.asarray, {"params": v["params"],
                                     "batch_stats": v["batch_stats"]})


def _with_stats(tree, seed=1):
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "var":
                out[k] = (rng.random(v.shape) + 0.5).astype(np.float32)
            else:
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
        return out

    return {"params": tree["params"], "batch_stats": walk(
        tree["batch_stats"])}


@contextlib.contextmanager
def _conv_outputs_in(model, dtype):
    """Fails unless every convolution ``model`` runs inside the block
    (at least one) returns ``dtype``."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
    assert seen and set(seen) == {dtype}, set(seen)


def _close(got, want, tol=BF16_TOL):
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_resnet_bf16_logits_match_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("resnet18-cifar", CLASSES,
                                   dtype="bfloat16")
    tree = _with_stats(_init(jx, jm, 32))
    x = _images(0, 32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        tree, jnp.asarray(x)))
    pm = port_models.create_model("resnet18-cifar", CLASSES,
                                  dtype="bfloat16", device="cpu")
    load_jax_variables(pm, tree).eval()
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    with torch.no_grad(), _conv_outputs_in(pm, torch.bfloat16):
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got.numpy(), want)


def test_inception_bf16_logits_match_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("inceptionv3", CLASSES, dtype="bfloat16")
    tree = _with_stats(_init(jx, jm, 75))  # eval init: no aux head
    x = _images(0, 75)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        tree, jnp.asarray(x)))
    pm = Classifier(InceptionV3(dtype=torch.bfloat16, device="cpu"),
                    CLASSES, dtype=torch.bfloat16, device="cpu")
    load_jax_variables(pm, tree).eval()
    with torch.no_grad(), _conv_outputs_in(pm, torch.bfloat16):
        got = pm(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_bn_bf16_stats_train_forward_matches_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("resnet18-cifar", CLASSES,
                                   dtype="bfloat16", bn_f32_stats=False)
    tree = _init(jx, jm, 32)
    x = _images(2, 32, batch=4)
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(tree, jnp.asarray(x))
    pm = port_models.create_model("resnet18-cifar", CLASSES,
                                  dtype="bfloat16", bn_f32_stats=False,
                                  device="cpu")
    load_jax_variables(pm, tree).train()
    assert not pm.backbone.bn1.f32_stats
    with torch.no_grad(), _conv_outputs_in(pm, torch.bfloat16):
        got = pm(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(want))
    ref = port_models.create_model("resnet18-cifar", CLASSES,
                                   dtype="float32", device="cpu")
    load_jax_variables(ref, {"params": tree["params"], "batch_stats":
                             jax.tree.map(np.asarray, upd["batch_stats"])})
    want_sd = ref.state_dict()
    for name, t in pm.state_dict().items():
        if "running" in name:
            assert t.dtype == torch.float32
            w = want_sd[name].numpy()
            np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                       atol=BF16_TOL * np.abs(w).max(),
                                       err_msg=name)


OPTIM = dict(optimizer="adam", learning_rate=1e-3, milestones=(),
             class_weights=WEIGHTS)


def _batches(k, b=4, size=32, seed=5):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, size, size, 3)).astype(
                np.float32),
             "label": rng.integers(0, CLASSES, b).astype(np.int32),
             "mask": np.array([1.0] * (b - 1) + [0.0], np.float32)}
            for _ in range(k)]


def test_three_bf16_steps_match_tpuic(jx):
    """``compute_dtype="bf16"`` as the Trainer runs it (``dtype`` forced
    to bfloat16): per-step loss within rtol 2e-2 of tpuic's bf16 step;
    parameters, BN statistics and Adam's moments stay float32."""
    jax, jnp = jx["jax"], jx["jnp"]
    jm_cfg = jx["cfg"].ModelConfig(name="resnet18-cifar",
                                   num_classes=CLASSES, dtype="bfloat16",
                                   compute_dtype="bf16")
    jo_cfg = jx["cfg"].OptimConfig(**OPTIM)
    jm = jx["models"].create_model_from_config(jm_cfg)
    tx = jx["opt"].make_optimizer(jo_cfg, 3, 10)
    jstate = jx["state"](jm, tx, jax.random.key(0), (4, 32, 32, 3))
    jstep = jx["train"](jo_cfg, jm_cfg, None, donate=False)
    tree = jax.tree.map(np.asarray, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="bfloat16", compute_dtype="bf16")
    ocfg = pcfg.OptimConfig(**OPTIM)
    pm = load_jax_variables(port_models.create_model_from_config(
        mcfg, device="cpu"), tree)
    state = create_train_state(pm, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, device="cpu")
    for k, batch in enumerate(_batches(3)):
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v)
                                      for n, v in batch.items()})
        with _conv_outputs_in(pm, torch.bfloat16):
            state, m = step(state, {n: torch.from_numpy(v)
                                    for n, v in batch.items()})
        assert float(m["skipped"]) == 0.0
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=2e-2, err_msg=f"step {k}")
    assert all(t.dtype == torch.float32 for t in pm.state_dict().values()
               if t.is_floating_point())
    for moments in (state.opt_state.mu, state.opt_state.nu):
        assert moments and all(t.dtype == torch.float32 for t in moments)


def test_three_bf16_vit_steps_match_tpuic(jx):
    """``vit-tiny`` with ``attention="flash"`` under ``compute_dtype=
    "bf16"``, now that K4's bf16 build carries it: three Adam steps from
    one init against ``tpuic``'s bf16 step (its flash in Pallas interpret
    mode), per-step loss within rtol 2e-2; every attention block's input
    and output are bfloat16 (a forward hook) and the parameters and
    moments stay float32."""
    jax, jnp = jx["jax"], jx["jnp"]
    kw = dict(name="vit-tiny", num_classes=CLASSES, dtype="bfloat16",
              compute_dtype="bf16", attention="flash")
    jm_cfg = jx["cfg"].ModelConfig(**kw)
    jo_cfg = jx["cfg"].OptimConfig(**OPTIM)
    jm = jx["models"].create_model_from_config(jm_cfg)
    jstate = jx["state"](jm, jx["opt"].make_optimizer(jo_cfg, 3, 10),
                         jax.random.key(0), (4, 16, 16, 3))
    jstep = jx["train"](jo_cfg, jm_cfg, None, donate=False)
    mcfg = pcfg.ModelConfig(**kw)
    ocfg = pcfg.OptimConfig(**OPTIM)
    pm = port_models.create_model_from_config(mcfg, device="cpu",
                                              image_size=16)
    load_jax_variables(pm, {"params": jax.tree.map(np.asarray,
                                                   jstate.params)})
    state = create_train_state(pm, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, device="cpu")
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.extend((i[0].dtype, o.dtype)))
        for n, m in pm.named_modules() if n.endswith(".attn")]
    for k, batch in enumerate(_batches(3, size=16)):
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v)
                                      for n, v in batch.items()})
        state, m = step(state, {n: torch.from_numpy(v)
                                for n, v in batch.items()})
        assert float(m["skipped"]) == 0.0
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=2e-2, err_msg=f"step {k}")
    for h in hooks:
        h.remove()
    assert len(seen) == 3 * 2 * 2 and set(seen) == {torch.bfloat16}
    assert all(t.dtype == torch.float32 for t in pm.state_dict().values()
               if t.is_floating_point())
    for moments in (state.opt_state.mu, state.opt_state.nu):
        assert moments and all(t.dtype == torch.float32 for t in moments)


def test_loss_scale_in_float32_gives_the_unscaled_step():
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="float32")
    batch = {n: torch.from_numpy(v) for n, v in _batches(1)[0].items()}
    out = {}
    for scale in (1.0, 128.0):
        ocfg = pcfg.OptimConfig(optimizer="sgd", learning_rate=0.1,
                                milestones=(), class_weights=WEIGHTS,
                                loss_scale=scale)
        model = init_params(port_models.create_model_from_config(
            mcfg, device="cpu"), 0, device="cpu")
        state = create_train_state(model, make_optimizer(ocfg, 3, 10))
        state, m = make_train_step(ocfg, mcfg, device="cpu")(state, batch)
        out[scale] = (float(m["loss"]), float(m["grad_norm"]),
                      [p.detach().clone() for p in model.parameters()])
    assert out[128.0][0] == pytest.approx(out[1.0][0], abs=1e-6)
    assert out[128.0][1] == pytest.approx(out[1.0][1], rel=1e-6)
    for a, b in zip(out[128.0][2], out[1.0][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,dtype,compute,refused", [
    # The ViT family trains in bf16 since K4's bf16 build was redesigned:
    # accepted, as every other family but EfficientNet is.
    ("vit-tiny", "bfloat16", "", None),
    ("vit-tiny", "float32", "bf16", None),
    ("efficientnet-b0", "float32", "", "EfficientNet training"),
    ("efficientnet-b3", "bfloat16", "bf16", "EfficientNet training"),
])
def test_trainer_refuses_by_name(name, dtype, compute, refused):
    cfg = pcfg.Config(
        data=pcfg.DataConfig(pack=False, native=False),
        model=pcfg.ModelConfig(name=name, dtype=dtype,
                               compute_dtype=compute))
    bad = unported_settings(cfg)
    if refused is None:
        assert bad == []
        return
    assert len(bad) == 1 and refused in bad[0]
    ok = dataclasses.replace(cfg, model=pcfg.ModelConfig(
        name="inceptionv3", dtype=dtype, compute_dtype=compute))
    assert unported_settings(ok) == []


def test_resolve_compute_dtype_matches_tpuic(jx):
    jcfg = jx["cfg"]
    assert pcfg._COMPUTE_DTYPES == jcfg._COMPUTE_DTYPES
    for s in sorted(jcfg._COMPUTE_DTYPES) + ["BF16", "Float32", "fp16",
                                             "half", "x"]:
        holder = type("M", (), {"compute_dtype": s})()
        try:
            want = jcfg.resolve_compute_dtype(holder)
        except ValueError:
            with pytest.raises(ValueError, match="unknown compute_dtype"):
                pcfg.resolve_compute_dtype(holder)
            with pytest.raises(ValueError, match="unknown compute_dtype"):
                pcfg.ModelConfig(compute_dtype=s)
            continue
        assert pcfg.resolve_compute_dtype(holder) == want
        assert pcfg.resolve_compute_dtype(
            pcfg.ModelConfig(compute_dtype=s)) == want
