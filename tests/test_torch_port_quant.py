"""Port parity: ``tpuic_torch.quant`` (the serve ladder's weight
representations and its accuracy gate) against ``tpuic.quant``.

- ``eval_images`` equals ``tpuic``'s, image for image.
- ``absmax_quantize``: the round trip lies within half a step of each
  output channel's scale, and the int8 ``q`` of a weight equals
  ``tpuic``'s bit for bit through the carrier's transposes (per output
  channel on axis 0 here, the last axis there), its ``scale`` within one
  float32 ulp.
- The quantized-leaf set equals ``tpuic``'s, by carrier path, for the
  ResNet, InceptionV3 (its tree by structure only: ``jax.eval_shape`` at
  299 px), EfficientNet and ViT families.  ``tpuic`` leaves the ViT's
  encoder Dense kernels float32 (they are boxed with partitioning
  metadata); so does the port.
- Each rung's logits against ``tpuic``'s rung from the same weights and
  images: fp32 within 1e-5, int8 within 1e-4 (both dequantize ``q *
  scale`` in float32, then the float32 forward), bf16 within 2e-2 times
  max |logit| (test_torch_port_bf16.py's bound) and, for ResNet and ViT,
  closer to ``tpuic``'s bf16 than to the port's own float32 (mean
  |difference|; EfficientNet's every convolution returns bfloat16).
- The gate: clean rungs agree with fp32 on at least ``1 -
  DEFAULT_EPSILON`` of the pinned eval images; the corruption arm lands
  far below it.

JAX and ``tpuic`` are imported inside fixtures.
"""

import numpy as np
import pytest
import torch

from tpuic_torch import models as port_models
from tpuic_torch import quant
from tpuic_torch.checkpoint import init_params, load_jax_variables
from tpuic_torch.checkpoint.convert import _port_name
from tpuic_torch.serve.engine import make_forward
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

CLASSES = 10
BF16_TOL = 2e-2
# (model, image size, create_model keywords): the rung parity cases.
FAMILIES = {"resnet18-cifar": (32, dict(fused_conv_bn=True)),
            "efficientnet-b0": (64, {}),
            "vit-tiny": (32, dict(attention="flash"))}
# Where the port's bf16 rung is held closer to tpuic's bf16 than to its
# own float32.  EfficientNet's is not: its bf16 rung lies nearer its own
# float32 (mean |difference| 2.6e-4 at 64 px) than tpuic's bf16 (3.4e-4),
# so every convolution there is held to return bfloat16 instead.
CLOSER = ("resnet18-cifar", "vit-tiny")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic import models as jmodels
    from tpuic import quant as jquant
    return dict(jax=jax, jnp=jnp, models=jmodels, quant=jquant)


def _images(seed, size, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)).astype(np.float32)


_TREES = {}


def _tree(jx, name):
    """A ``tpuic`` variables tree of ``name`` (float32, numpy leaves) by
    structure: ``jax.eval_shape`` of its init (the ViT's Dense kernels
    still boxed), filled from a numpy seed — kernels at fan-in scale, BN
    statistics near the identity — with no init computed.  Once per
    module."""
    if name not in _TREES:
        jax, jnp = jx["jax"], jx["jnp"]
        size, kw = FAMILIES[name]
        jm = jx["models"].create_model(name, CLASSES, dtype="float32", **kw)
        shapes = jax.eval_shape(lambda k: jm.init(
            k, jnp.zeros((1, size, size, 3)), train=False),
            jax.random.key(0))
        rng = np.random.default_rng(0)

        def fill(path, leaf):
            key = str(getattr(path[-1], "key", path[-1]))
            shape = leaf.shape
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.standard_normal(shape) * np.sqrt(1.0 / fan_in)
            elif key == "var":
                v = rng.random(shape) + 0.5
            elif key == "scale":
                v = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                v = 0.1 * rng.standard_normal(shape)
            return v.astype(np.float32)

        _TREES[name] = jax.tree_util.tree_map_with_path(fill, shapes)
    return _TREES[name]


def _port(name, tree):
    size, kw = FAMILIES[name]
    if name.startswith("vit"):
        kw = dict(kw, image_size=size)
    pm = port_models.create_model(name, CLASSES, dtype="float32",
                                  device="cpu", **kw)
    return load_jax_variables(pm, tree).eval()


def _quantized_paths(jx, qtree) -> dict:
    """``{port name: {"q", "scale"}}`` of a ``tpuic`` int8 tree."""
    marker = jx["quant"].QUANT_LEAF
    out = {}

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict) and marker in v:
                out[_port_name("params", p.split("/", 1)[1])] = v
            elif isinstance(v, dict):
                walk(v, p)

    walk(qtree, "")
    return out


def test_eval_images_equal_tpuics(jx):
    for n, size, seed in ((128, 32, 0), (4, 224, 0), (8, 24, 3)):
        got = quant.eval_images(n, size, seed)
        want = jx["quant"].eval_images(n, size, seed)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 5), (8, 3, 3, 3), (4, 1, 3, 3)])
def test_absmax_round_trip_per_output_channel(shape):
    """q * scale within half a step of w, every channel's step its own
    absmax / 127; a zero channel keeps a positive scale and q = 0."""
    rng = np.random.default_rng(len(shape))
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w[1] = 0.0
    w[2] *= 100.0
    q, scale = quant.absmax_quantize(w)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == (shape[0],) + (1,) * (len(shape) - 1)
    assert int(q.abs().max()) == 127 and bool((q[1] == 0).all())
    absmax = w.abs().reshape(shape[0], -1).amax(1)
    torch.testing.assert_close(scale.reshape(-1),
                               torch.clamp(absmax, min=1e-12) / 127.0,
                               rtol=0, atol=0)
    err = (q.float() * scale - w).abs().reshape(shape[0], -1).amax(1)
    assert bool((err <= scale.reshape(-1) / 2 * (1 + 1e-6)).all())
    deq = quant.dequantize_variables({"w": {"q": q, "scale": scale},
                                      "b": w[0]})
    torch.testing.assert_close(deq["w"], q.float() * scale, rtol=0, atol=0)
    assert deq["b"] is w[0] or torch.equal(deq["b"], w[0])


@pytest.mark.parametrize("name", ["resnet18-cifar", "vit-tiny"])
def test_q_and_scale_match_tpuic(jx, name):
    """The same numpy weights through both packages: ``q`` bit for bit,
    ``scale`` within one float32 ulp, in the port's layout."""
    tree = _tree(jx, name)
    # Eagerly, as tpuic's serve CLI quantizes (under jit XLA may divide
    # through a reciprocal: one tie in millions rounds the other way).
    want = _quantized_paths(jx, jx["jax"].tree.map(
        np.asarray, jx["quant"].quantize_variables(tree)))
    got = quant.quantize_variables(_port(name, tree))
    assert sorted(n for n, v in got.items() if isinstance(v, dict)) == \
        sorted(want)
    for name_, leaf in want.items():
        q = np.asarray(leaf["q"])
        s = np.asarray(leaf["scale"])
        layout = (3, 2, 0, 1) if q.ndim == 4 else (1, 0)
        np.testing.assert_array_equal(got[name_]["q"].numpy(),
                                      q.transpose(layout), err_msg=name_)
        np.testing.assert_array_max_ulp(got[name_]["scale"].numpy(),
                                        s.transpose(layout), maxulp=1)


@pytest.mark.parametrize("name,size", [("resnet18-cifar", 32),
                                       ("inceptionv3", 299),
                                       ("efficientnet-b0", 64),
                                       ("vit-tiny", 32)])
def test_quantized_leaf_set_matches_tpuic(jx, name, size):
    """The leaves ``tpuic``'s int8 rung quantizes, by structure
    (``jax.eval_shape``: no init is computed), mapped to port names: the
    set ``quantized_leaves`` picks on the port model."""
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model(name, CLASSES, dtype="float32")
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k, "dropout": k},
                          jnp.zeros((1, size, size, 3)),
                          train=name == "inceptionv3"), jax.random.key(0))
    shapes = {"params": shapes["params"]}
    qshapes = jax.eval_shape(jx["quant"].quantize_variables, shapes)
    want = set(_quantized_paths(jx, qshapes))
    kw = dict(image_size=size) if name.startswith("vit") else {}
    pm = port_models.create_model(name, CLASSES, dtype="float32",
                                  device="meta", **kw)
    got = set(quant.quantized_leaves(pm))
    assert got == want
    if name.startswith("vit"):
        # Of a ViT only the patch embedding and the head's Dense layers.
        assert got == {"backbone.patch_embed.weight"} | {
            f"head.{n}.weight" for n in ("fc0", "fc1", "fc2", "out")}
        boxed = [n for n, _ in pm.named_parameters()
                 if n.endswith(("qkv.weight", "out.weight", "mlp_up.weight",
                                "mlp_down.weight")) and "head" not in n]
        assert boxed and not set(boxed) & got


def _jax_rungs(jx, name, tree, x):
    """``tpuic``'s fp32, int8 and bf16 rung logits: int8 as its
    ``quantized_forward`` runs it (the dequantized tree through the
    float32 model), bf16 as its serve CLI does (``bf16_variables`` through
    a bfloat16 model)."""
    jax, jnp, jq = jx["jax"], jx["jnp"], jx["quant"]
    kw = FAMILIES[name][1]
    f32 = jx["models"].create_model(name, CLASSES, dtype="float32", **kw)
    b16 = jx["models"].create_model(name, CLASSES, dtype="bfloat16", **kw)

    def apply(model):  # one compile a model: fp32 and int8 share avals
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
        return lambda v: np.asarray(fn(v, jnp.asarray(x)), np.float32)

    run32 = apply(f32)
    # Each jitted whole: leaf by leaf, every shape would compile its own.
    return {"fp32": run32(tree),
            "int8": run32(jax.jit(lambda t: jq.dequantize_variables(
                jq.quantize_variables(t)))(tree)),
            "bf16": apply(b16)(jax.jit(jq.bf16_variables)(tree))}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_rungs_match_tpuic(jx, name):
    size, _ = FAMILIES[name]
    tree = _tree(jx, name)
    x = _images(0, size, batch=4)
    want = _jax_rungs(jx, name, tree, x)
    rungs = quant.serve_variants(_port(name, tree), quant.DTYPE_TAGS)
    assert isinstance(rungs["int8"], quant.QuantizedModel)
    assert all(t.dtype == torch.bfloat16 for t in
               rungs["bf16"].state_dict().values() if t.is_floating_point())
    with torch.no_grad():
        got = {t: m(torch.from_numpy(x)).float().numpy()
               for t, m in rungs.items()}
    np.testing.assert_allclose(got["fp32"], want["fp32"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["int8"], want["int8"], rtol=1e-4,
                               atol=1e-4)
    scale = float(np.abs(want["bf16"]).max())
    np.testing.assert_allclose(got["bf16"], want["bf16"], rtol=0,
                               atol=BF16_TOL * scale)
    if name in CLOSER:
        # Mean |difference| over the batch's logits: a rung computing in
        # float32 would sit at its own float32, not at tpuic's bf16.
        to_tpuic = np.abs(got["bf16"] - want["bf16"]).mean()
        to_own_f32 = np.abs(got["bf16"] - got["fp32"]).mean()
        assert to_tpuic < to_own_f32, (to_tpuic, to_own_f32)
    else:
        seen = []
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.append(o.dtype))
            for m in rungs["bf16"].modules()
            if isinstance(m, torch.nn.Conv2d)]
        with torch.no_grad():
            rungs["bf16"](torch.from_numpy(x))
        for h in hooks:
            h.remove()
        assert seen and set(seen) == {torch.bfloat16}
    # The int8 rung keeps int8 weights and float32 scales between calls.
    q = dict(rungs["int8"].named_buffers())
    assert {k[:-len("_q")] for k in q if k.endswith("weight_q")} == {
        "model." + n for n in quant.quantized_leaves(_port(name, tree))}
    assert all(q[k].dtype == torch.int8 for k in q if k.endswith("_q"))


@pytest.mark.parametrize("name", ["resnet18-cifar", "vit-tiny"])
def test_gate_passes_clean_rungs_and_refuses_the_corruption(name):
    size, kw = FAMILIES[name]
    if name.startswith("vit"):
        kw = dict(kw, image_size=size)
    model = init_params(port_models.create_model(
        name, CLASSES, dtype="float32", device="cpu", **kw), 0,
        device="cpu").eval()
    imgs = quant.eval_images(64, size)
    fwd = {t: make_forward(m, normalize=True)
           for t, m in quant.serve_variants(model, quant.DTYPE_TAGS).items()}
    floor = 1.0 - quant.DEFAULT_EPSILON
    for tag in ("bf16", "int8"):
        assert quant.top1_agreement(fwd["fp32"], fwd[tag], imgs) >= floor
    bad = quant.quantized_forward(quant.corrupt_variables(model, seed=0))
    agree = quant.top1_agreement(fwd["fp32"], make_forward(
        bad, normalize=True), imgs)
    assert agree < floor
    # Deterministic: the same seed corrupts the same way.
    again = quant.corrupt_variables(model, seed=0)
    first = quant.corrupt_variables(model, seed=0)
    for a, b in zip(again.parameters(), first.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown serve dtype 'fp8'"):
        quant.serve_variants(model, ("fp32", "fp8"))
