"""Port parity: EfficientNet against ``tpuic``'s.

- B0 at 64 px, 7 classes, float32, from one flax init carried by
  ``load_jax_variables``: eval logits at batch 2 with calibrated running
  statistics (a train-mode pass at momentum 0 on another batch of 16, so
  the logits are not flax-init's ~1e-6; measured 2.4e-6 of max 0.53), and
  a train-mode forward at ``drop_path_rate=0`` on both sides at batch 4
  (measured 3.5e-6 of max 0.24): logits and every updated BN statistic.
  Tolerance: atol 1e-4 times max |logit|, BN statistics rtol 1e-4 / atol
  1e-5.  Not 32 px at batch 2: there the last stages are 1x1 maps whose
  train-mode BN normalises two values a channel, and float32 is chaotic
  (the port's float32 logits lie 0.26 from its float64 ones, tpuic's
  0.06, at max 0.30); at 64 px and batch 4 both lie within 5e-6 of it.
- TF "SAME" padding (``models.layers.Conv``) against
  ``lax.conv_general_dilated(..., "SAME")`` at odd and even sizes, strides
  1 and 2, depthwise and dense: atol 1e-5.
- B0-B7 widths and depths against ``tpuic``'s ``_SCALING`` /
  ``_round_filters`` / ``_round_repeats``, by construction only.
- ``convert_efficientnet`` of an efficientnet_pytorch-layout state dict
  gives the same tree in both packages, and the variant is detected
  alike.
- Stochastic depth is not ported: a train-mode forward at a rate above 0
  raises, and the ``Trainer`` refuses EfficientNet by name.

JAX and ``tpuic`` are imported inside fixtures.
"""

import numpy as np
import pytest
import torch

from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import load_jax_variables
from tpuic_torch.checkpoint import torch_convert as ptc
from tpuic_torch.models import efficientnet as peff
from tpuic_torch.models.classifier import Classifier
from tpuic_torch.models.layers import Conv

CLASSES = 7
SIZE = 64


def _images(seed, size=SIZE, batch=2):
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
    from tpuic.models import classifier as jcls
    from tpuic.models import efficientnet as jeff
    model = jcls.Classifier(backbone=jeff.efficientnet("b0",
                                                       drop_path_rate=0.0),
                            num_classes=CLASSES)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(jax.random.key(0))
    tree = jax.tree.map(np.asarray, {"params": variables["params"],
                                     "batch_stats": variables["batch_stats"]})
    return dict(jax=jax, jnp=jnp, jeff=jeff, model=model, tree=tree)


def _port(tree, **kw):
    pm = Classifier(peff.efficientnet("b0", drop_path_rate=0.0,
                                      device="cpu", **kw), CLASSES,
                    device="cpu")
    return load_jax_variables(pm, tree)


def _calibrated(tree):
    pm = _port(tree)
    for m in pm.modules():
        if hasattr(m, "flax_momentum"):
            m.flax_momentum = 0.0
    pm.train()
    with torch.no_grad():
        pm(torch.from_numpy(_images(11, batch=16)))
    sd = pm.state_dict()
    stats = {}
    for path in _flat(tree["batch_stats"]):
        *mods, leaf = path.split("/")
        node = stats
        for k in mods[:-1]:
            node = node.setdefault(k, {})
        node.setdefault(mods[-1], {})[leaf] = sd[".".join(mods) + (
            ".running_mean" if leaf == "mean" else ".running_var")].numpy()
    return {"params": tree["params"], "batch_stats": stats}


def test_b0_eval_logits_match_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    tree = _calibrated(jx["tree"])
    x = _images(0)
    want = np.asarray(jax.jit(lambda v, x: jx["model"].apply(
        v, x, train=False))(tree, jnp.asarray(x)))
    got = _port(tree).eval()(torch.from_numpy(x)).detach().numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (2, CLASSES) and scale > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_b0_train_mode_bn_matches_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    x = _images(1, batch=4)
    want, upd = jax.jit(lambda v, x: jx["model"].apply(
        v, x, train=True, mutable=["batch_stats"]))(jx["tree"],
                                                    jnp.asarray(x))
    want = np.asarray(want)
    pm = _port(jx["tree"]).train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    ref = _port({"params": jx["tree"]["params"],
                 "batch_stats": jax.tree.map(np.asarray,
                                             upd["batch_stats"])})
    want_sd = ref.state_dict()
    for name, t in pm.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(t.numpy(), want_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel,depthwise", [(3, True), (5, True),
                                              (3, False)])
def test_same_padding_matches_lax(jx, size, stride, kernel, depthwise):
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(size * 10 + stride + kernel)
    c = 4
    x = rng.standard_normal((2, size, size, c)).astype(np.float32)
    cin = 1 if depthwise else c
    w = rng.standard_normal((kernel, kernel, cin, c)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c if depthwise else 1))
    conv = Conv(c, c, kernel, stride, "SAME", groups=c if depthwise else 1,
                device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-size // stride),
                                       -(-size // stride), c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", [f"b{i}" for i in range(8)])
def test_widths_and_depths_match_tpuic(variant):
    pytest.importorskip("jax")
    from tpuic.models import efficientnet as jeff
    assert peff._SCALING == jeff._SCALING
    assert peff._BASE_BLOCKS == jeff._BASE_BLOCKS
    width, depth, _ = jeff._SCALING[variant]
    with torch.device("meta"):
        net = peff.efficientnet(variant, device="meta")
    assert net.stem_conv.out_channels == jeff._round_filters(32, width)
    assert net.num_features == jeff._round_filters(1280, width)
    names = []
    for si, (expand, ch, repeats, stride, kernel) in \
            enumerate(jeff._BASE_BLOCKS):
        out_f = jeff._round_filters(ch, width)
        for r in range(jeff._round_repeats(repeats, depth)):
            blk = getattr(net, f"block{si}_{r}")
            names.append(f"block{si}_{r}")
            assert blk.project_conv.out_channels == out_f
            assert blk.dw_conv.kernel_size == (kernel, kernel)
            assert blk.dw_conv.stride == ((stride, stride) if r == 0
                                          else (1, 1))
            assert blk.dw_conv.groups == blk.dw_conv.in_channels
            assert hasattr(blk, "expand_conv") == (expand != 1)
            cin = blk.dw_conv.in_channels // expand
            assert blk.se.reduce.out_channels == max(1, int(cin * 0.25))
            assert blk.se.reduce.bias is not None
    assert names == net._blocks


@pytest.mark.parametrize("variant", ["b0", "b2"])
def test_convert_efficientnet_matches_tpuic(variant):
    pytest.importorskip("jax")
    from tpuic.checkpoint import torch_convert as jtc
    from tpuic.checkpoint.torch_ref import build_efficientnet
    torch.manual_seed(0)
    sd = build_efficientnet(variant, num_classes=CLASSES).state_dict()
    assert ptc.detect_arch(sd) == jtc.detect_arch(sd) == "efficientnet"
    assert ptc.detect_efficientnet_variant(sd) == \
        jtc.detect_efficientnet_variant(sd) == variant
    got, want = ptc.convert_state_dict(sd), jtc.convert_state_dict(sd)
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(want[coll])
        assert set(g) == set(w) and g
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    dw = got["params"]["backbone"]["block1_0"]["dw_conv"]["kernel"]
    assert dw.shape[2] == 1  # depthwise HWIO [k, k, 1, C]
    pm = port_models.create_model(f"efficientnet-{variant}", CLASSES,
                                  head_widths=(), dtype="float32",
                                  device="cpu")
    load_jax_variables(pm, got)  # strict: every tensor written


def test_stochastic_depth_is_refused_in_train_mode():
    pm = port_models.create_model("efficientnet-b0", CLASSES,
                                  dtype="float32", device="cpu")
    assert pm.backbone.drop_path_rate == 0.2  # tpuic's default
    pm.eval()
    with torch.no_grad():
        assert pm(torch.from_numpy(_images(2))).shape == (2, CLASSES)
    pm.train()
    with pytest.raises(NotImplementedError, match="item 8"):
        pm(torch.from_numpy(_images(2)))
