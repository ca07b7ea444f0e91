"""Port parity: the ``tpuic_torch`` ViT family against ``tpuic.models.vit``.

- Logits: the same flax variables (a JAX ``init``, carried by
  ``load_jax_variables``) and the same numpy images through both packages,
  float32, eval mode, under ``attention="dense"`` and ``"flash"`` (JAX's
  flash in Pallas interpret mode: the folded kernels for ``vit-tiny``'s
  head dim 16, the lane-packed ones for head dim 64), atol/rtol 1e-5.
- ViT-B/16's strict load, by structure only (``jax.eval_shape``, zero-
  stride leaves, the port model on the meta device): every leaf maps and
  every tensor is written, with no 86 M-parameter init.
- Two AdamW steps of ``vit-tiny`` with ``attention="flash"``, the fused
  loss, clipping and label smoothing, against ``tpuic``'s step from the
  same weights and batches, at test_torch_port_train.py's tolerances.
- The CLI and the Trainer's refusals, flax's init distributions.

JAX and ``tpuic`` are imported inside fixtures, so the ``cuda`` test of
this file runs where JAX is not installed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import (init_params, load_jax_opt_state,
                                    load_jax_variables)
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.models.classifier import Classifier
from tpuic_torch.models.layers import LayerNorm
from tpuic_torch.models.vit import ViT
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 7
OPTIM = dict(optimizer="adam", learning_rate=1e-3, weight_decay=0.05,
             grad_clip_norm=1.0, milestones=(), class_weights=(),
             label_smoothing=0.1, fused_loss=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic import config as jcfg
    from tpuic import models as jmodels
    from tpuic.models import classifier as jclassifier
    from tpuic.models import vit as jvit
    from tpuic.train import optimizer as jopt
    from tpuic.train.state import create_train_state as jstate
    from tpuic.train.step import make_train_step as jtrain
    return dict(jax=jax, jnp=jnp, cfg=jcfg, models=jmodels,
                classifier=jclassifier, vit=jvit, opt=jopt, state=jstate,
                train=jtrain)


def _images(seed, size, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)).astype(np.float32)


def _np(tree, jax):
    return jax.tree.map(np.asarray, tree)


_INITS = {}


def _init(jx, key, model, x):
    """One flax init per parameter structure: dense and flash share it."""
    if key not in _INITS:
        jax, jnp = jx["jax"], jx["jnp"]
        _INITS[key] = _np(jax.jit(lambda k: model.init(k, jnp.asarray(x),
                                                       train=False))(
            jax.random.key(0)), jax)
    return _INITS[key]


def _logits(jx, model, variables, x):
    jax, jnp = jx["jax"], jx["jnp"]
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))


def _port_logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_tiny_logits_match_jax(jx, attention):
    """``vit-tiny``: 16x16 images, patch 4, 17 tokens, head dim 16."""
    x = _images(1, 16)
    jm = jx["models"].create_model("vit-tiny", 10, dtype="float32",
                                   attention=attention)
    variables = _init(jx, "vit-tiny", jm, x)
    want = _logits(jx, jm, variables, x)
    pm = port_models.create_model("vit-tiny", 10, dtype="float32",
                                  attention=attention, image_size=16,
                                  device="cpu")
    load_jax_variables(pm, variables)
    got = _port_logits(pm, x)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_tiny_bf16_logits_match_jax(jx, attention):
    """``vit-tiny`` in bfloat16 from float32 master weights, eval: the
    same variables and images through ``tpuic``'s bf16 ViT (flash in
    Pallas interpret mode) and the port's (K4's plain version on the
    CPU), within 2e-2 times max |logit| (test_torch_port_bf16.py's
    bound), every projection computing in bfloat16."""
    jax = jx["jax"]
    x = _images(2, 16, batch=4)
    jm32 = jx["models"].create_model("vit-tiny", 10, dtype="float32",
                                     attention=attention)
    variables = _init(jx, "vit-tiny", jm32, x[:2])
    jm = jx["models"].create_model("vit-tiny", 10, dtype="bfloat16",
                                   attention=attention)
    want = _logits(jx, jm, variables, x)
    pm = port_models.create_model("vit-tiny", 10, dtype="bfloat16",
                                  attention=attention, image_size=16,
                                  device="cpu")
    load_jax_variables(pm, variables)
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
             for m in pm.modules() if isinstance(m, LayerNorm)]
    got = _port_logits(pm, x)
    for h in hooks:
        h.remove()
    assert seen and set(seen) == {torch.bfloat16}
    assert got.dtype == np.float32 and want.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    del jax


@pytest.mark.parametrize("patch,hidden,heads,size,attention", [
    (8, 128, 2, 32, "dense"), (8, 128, 2, 32, "flash"),
    (4, 64, 4, 18, "dense")])
def test_narrow_vit_logits_match_jax(jx, patch, hidden, heads, size,
                                     attention):
    """Head dim 64 with two heads (JAX's packed flash kernels), and an
    image the patch does not divide (18 / 4: SAME padding, one pixel on
    each side)."""
    x = _images(size, size)
    jm = jx["classifier"].Classifier(
        backbone=jx["vit"].ViT(patch=patch, hidden=hidden, depth=2,
                               num_heads=heads, attention=attention),
        num_classes=10)
    variables = _init(jx, (patch, hidden, heads, size), jm, x)
    want = _logits(jx, jm, variables, x)
    pm = Classifier(ViT(patch=patch, hidden=hidden, depth=2, num_heads=heads,
                        image_size=size, attention=attention, device="cpu"),
                    10, device="cpu")
    load_jax_variables(pm, variables)
    np.testing.assert_allclose(_port_logits(pm, x), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("patch,size", [(4, 16), (4, 17), (16, 32),
                                        (16, 40)])
def test_patch_embedding_equals_the_convolution(patch, size):
    """``embed_patches`` (a reshape and one ``F.linear``) against
    ``F.conv2d`` with the same weights at stride = kernel, atol 1e-6: patch
    4 and 16, with no padding (16 / 4, 32 / 16) and with flax's SAME
    padding (17 / 4 pads (1, 2), 40 / 16 pads (4, 4)).  Both sides run in
    float64, so the two summation orders agree to ~1e-15 and any patch or
    channel put in the wrong place shows far above the tolerance."""
    torch.manual_seed(size)
    f64 = dict(dtype=torch.float64, param_dtype=torch.float64)
    vit = ViT(patch=patch, hidden=24, depth=0, num_heads=2, image_size=size,
              device="cpu", **f64)
    with torch.no_grad():
        vit.patch_embed.bias.normal_()
    x = torch.randn(3, size, size, 3, dtype=torch.float64)
    lo, hi = vit.pads
    assert (lo + hi > 0) == (size % patch != 0)
    conv = vit.patch_embed
    want = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi)),
                    conv.weight, conv.bias, conv.stride)
    want = want.flatten(2).transpose(1, 2)
    with torch.no_grad():
        got = vit.embed_patches(x)
    assert got.shape == want.shape == (3, (-(-size // patch)) ** 2, 24)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_vit_b16_strict_load_by_structure(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("vit-b16", 1000, dtype="float32")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    tree = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    pm = port_models.create_model("vit-b16", 1000, dtype="float32",
                                  device="meta")
    n_params = sum(p.numel() for p in pm.parameters())
    assert n_params == sum(int(np.prod(a.shape)) for a in
                           jax.tree.leaves(tree))
    load_jax_variables(pm, tree)  # raises on any unmapped leaf or tensor
    assert pm.backbone.pos_embed.shape == (1, 197, 768)
    del tree["params"]["backbone"]["block11"]["attn"]["qkv"]
    with pytest.raises(KeyError, match="lacks 2 model tensors"):
        load_jax_variables(pm, tree)


def _batches(k, b=4, size=16, seed=5):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, size, size, 3)).astype(
                 np.float32),
             "label": rng.integers(0, CLASSES, b).astype(np.int32),
             "mask": np.array([1.0] * (b - 1) + [0.0], np.float32)}
            for _ in range(k)]


def test_adamw_steps_with_flash_match_tpuic(jx):
    """``vit-tiny``, flash attention, fused loss, AdamW (wd 0.05), clipping
    at 1.0 and label smoothing 0.1, two steps from identical weights and
    optimizer state: per-step loss, gradient norm and accuracy at rtol
    1e-4, then parameters and both moments at atol 5e-5."""
    jax, jnp = jx["jax"], jx["jnp"]
    mcfg = jx["cfg"].ModelConfig(name="vit-tiny", num_classes=CLASSES,
                                 dtype="float32", attention="flash")
    ocfg = jx["cfg"].OptimConfig(**OPTIM)
    sched = jx["opt"].make_schedule(ocfg, 3, 10)
    jstate = jx["state"](jx["models"].create_model_from_config(mcfg),
                         jx["opt"].make_optimizer(ocfg, 3, 10),
                         jax.random.key(0), (4, 16, 16, 3))
    jstep = jx["train"](ocfg, mcfg, None, lr_schedule=sched, donate=False)

    pm = pcfg.ModelConfig(name="vit-tiny", num_classes=CLASSES,
                          dtype="float32", attention="flash")
    po = pcfg.OptimConfig(**OPTIM)
    model = port_models.create_model_from_config(pm, device="cpu",
                                                 image_size=16)
    load_jax_variables(model, {"params": _np(jstate.params, jax)})
    names = [n for n, _ in model.named_parameters()]
    pstate = create_train_state(model, make_optimizer(po, 3, 10))
    pstate.opt_state = load_jax_opt_state(_np(jstate.opt_state, jax), names,
                                          device="cpu")
    assert pstate.tx.kind == "adamw"
    pstep = make_train_step(po, pm, lr_schedule=make_schedule(po, 3, 10),
                            device="cpu")
    for k, batch in enumerate(_batches(2)):
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in batch.items()})
        pstate, m = pstep(pstate, {n: torch.from_numpy(v)
                                   for n, v in batch.items()})
        for key in ("loss", "grad_norm", "accuracy", "lr", "skipped"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k} {key}")
    ref = port_models.create_model_from_config(pm, device="cpu",
                                               image_size=16)
    load_jax_variables(ref, {"params": _np(jstate.params, jax)})
    want = dict(ref.named_parameters())
    for name, got in model.named_parameters():
        got, exp = got.detach().numpy(), want[name].detach().numpy()
        if name.endswith("attn.qkv.bias"):
            # The key bias adds q.b_k to every score of a row, which the
            # softmax cancels: its gradient is 0 up to rounding, and Adam's
            # normalised step turns that noise into steps of up to lr in
            # either direction, in either package: held to two steps each.
            third = got.shape[0] // 3
            key = slice(third, 2 * third)
            assert np.abs(got[key] - exp[key]).max() <= \
                2 * 2 * OPTIM["learning_rate"]
            got, exp = np.delete(got, key, 0), np.delete(exp, key, 0)
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=5e-5,
                                   err_msg=name)
    carried = load_jax_opt_state(_np(jstate.opt_state, jax), names,
                                 device="cpu")
    assert int(carried.count) == int(pstate.opt_state.count) == 2
    for mine, theirs in ((pstate.opt_state.mu, carried.mu),
                         (pstate.opt_state.nu, carried.nu)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=5e-5)


def test_init_params_draws_flax_vit_distributions():
    """Dense kernels of the ViT xavier-uniform, the head's and the patch
    conv's lecun-normal (truncated at 2 sigma), LayerNorm 1/0, cls 0,
    pos_embed normal(0.02), every bias 0."""
    model = init_params(port_models.create_model(
        "vit-s16", 10, dtype="float32", image_size=64, device="cpu"), 3,
        device="cpu")
    vit = model.backbone
    up = vit.block0.mlp_up.weight.detach()
    limit = (6.0 / (up.shape[0] + up.shape[1])) ** 0.5
    assert float(up.abs().max()) <= limit
    assert float(up.abs().max()) > 0.9 * limit
    conv = vit.patch_embed.weight.detach()
    std = (1.0 / conv[0].numel()) ** 0.5 / 0.87962566103423978
    assert float(conv.abs().max()) <= 2 * std
    assert abs(float(vit.pos_embed.std()) - 0.02) < 0.002
    assert float(vit.cls.abs().max()) == 0.0
    for m in model.modules():
        if isinstance(m, LayerNorm):
            assert bool((m.weight == 1).all()) and bool((m.bias == 0).all())
        if getattr(m, "bias", None) is not None:
            assert float(m.bias.abs().max()) == 0.0


def test_unported_vit_settings_raise():
    with pytest.raises(NotImplementedError, match="'ring' is not yet"):
        port_models.create_model("vit-tiny", 3, attention="ring",
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown attention impl"):
        port_models.create_model("vit-tiny", 3, attention="sparse",
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="drop_path"):
        port_models.create_model("vit-tiny", 3, drop_path=0.1, device="cpu")
    with pytest.raises(ValueError, match="built for 16x16"):
        port_models.create_model("vit-tiny", 3, image_size=16,
                                 device="cpu")(torch.zeros(1, 32, 32, 3))


def test_vit_defaults_to_the_card():
    """``device=None`` means the card: without one, building raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pm = port_models.create_model("vit-tiny", 3, image_size=16)
        assert next(pm.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_models.create_model("vit-tiny", 3, image_size=16)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vit_data"))
    make_synthetic_imagefolder(root, classes=("a", "b", "c"), per_class=4,
                               size=20)
    return root


def _cli(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "tpuic_torch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_trains_vit_with_flash_on_cpu(folder, tmp_path):
    out = _cli(["--datadir", folder, "--device", "cpu", "--steps", "2",
                "--ckpt-dir", str(tmp_path),
                "--model", "vit-tiny", "--attention", "flash", "--resize",
                "16", "--batchsize", "4", "--optimizer", "adam", "--lr",
                "1e-3", "--weight-decay", "0.05", "--clip-grad-norm", "1.0",
                "--no-class-weights", "--milestones", "--fused-loss",
                "--label-smoothing", "0.1", "--dtype", "float32",
                "--no-pack", "--no-native", "--workers", "2",
                "--log-every-steps", "1"])
    assert out.returncode == 0, out.stderr
    assert "[model] vit-tiny:" in out.stdout
    assert "optimizer adamw, on cpu" in out.stdout
    assert "step budget (2) reached" in out.stdout


def test_cli_refuses_unported_attention_and_drop_path(folder):
    from tpuic_torch.train.__main__ import main
    base = ["--datadir", folder, "--device", "cpu", "--dtype", "float32",
            "--no-pack", "--no-native", "--model", "vit-tiny", "--resize",
            "16"]
    with pytest.raises(SystemExit, match="'ring' is not yet ported"):
        main(base + ["--attention", "ring"])
    with pytest.raises(SystemExit, match="--drop-path: not yet ported"):
        main(base + ["--drop-path", "0.1"])


@pytest.mark.cuda
def test_cuda_vit_train_step_makes_no_host_sync():
    """Two ``vit-tiny`` steps through the K4 kernels and K1 (AdamW,
    clipping, warmup-cosine) under ``torch.cuda.set_sync_debug_mode
    ("error")``: any host sync in the step raises.  Per step: 2 forward,
    2 dq and 2 dk/dv launches (depth 2) and one K1 forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import importlib
    FA = importlib.import_module("tpuic_torch.kernels.flash_attention")
    from tpuic_torch.kernels import cross_entropy_fwd
    mcfg = pcfg.ModelConfig(name="vit-tiny", num_classes=CLASSES,
                            dtype="float32", attention="flash")
    ocfg = pcfg.OptimConfig(**dict(OPTIM, warmup_epochs=1))
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cuda", image_size=16), 0, device="cuda")
    state = create_train_state(model, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(ocfg, 3, 10),
                           device="cuda")
    batches = [{n: torch.from_numpy(v).cuda() for n, v in b.items()}
               for b in _batches(2)]
    torch.cuda.synchronize()
    counters = (FA.flash_attention_fwd, FA.flash_attention_bwd_dq,
                FA.flash_attention_bwd_dkv, cross_entropy_fwd)
    before = [c.launches for c in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            state, metrics = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [4, 4, 4, 2]
    assert int(state.step) == 2 and float(metrics["skipped"]) == 0.0
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


@pytest.mark.cuda
def test_cuda_vit_row_ignores_its_batch():
    """A ViT-B/16 row does not depend on the batch it rides in: one image's
    probabilities from a batch-1 forward equal its row of a batch-32
    forward within 1e-5, with the model called directly (not through the
    engine, which turns TF32 off for its call) under torch's default flags
    (cuDNN's TF32 allowed).  The patch embedding is one ``F.linear``, not a
    cuDNN convolution, and K4's forward plan does not depend on the
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tpuic_torch.checkpoint import init_synthetic
    assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    model = init_synthetic(port_models.create_model(
        "vit-b16", 1000, dtype="float32", attention="flash",
        image_size=224), seed=0)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, 224, 224, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        big = model(x).softmax(-1)
        for row in (0, 17, 31):
            one = model(x[row:row + 1]).softmax(-1)
            torch.testing.assert_close(one[0], big[row], rtol=0, atol=1e-5)
