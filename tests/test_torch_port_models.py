"""Port parity: ``tpuic_torch.models`` against ``tpuic.models``.

The same flax variables (a JAX ``init``) go into both packages —
through ``load_jax_variables`` on the port side — and the same numpy
images through both forwards, in eval mode and float32.  Each model runs
with ``fused_conv_bn`` off and on, on both sides (the JAX fused branch in
Pallas interpret mode, the port's through the kernel's plain version on
the CPU).  Tolerance: atol/rtol 1e-4, the fused-kernel pin of
tests/test_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuic import config as jax_config
from tpuic import models as jax_models
from tpuic.models import classifier as jax_classifier
from tpuic.models import resnet as jax_resnet
from tpuic_torch import config as port_config
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import init_synthetic, load_jax_variables
from tpuic_torch.kernels import fused_conv_bn_relu
from tpuic_torch.models.classifier import Classifier
from tpuic_torch.models.resnet import Bottleneck, ResNet, s2d_stem_kernel


def _images(seed, size, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)).astype(np.float32)


_INITS = {}


def _jax_init(key, model, x):
    """One flax init per model structure (fused and unfused share it: the
    fused flag never changes the parameter tree), with non-trivial running
    statistics, so BN folding is really exercised."""
    if key not in _INITS:
        variables = jax.jit(lambda k: model.init(k, jnp.asarray(x),
                                                 train=False))(
            jax.random.key(0))
        rng = np.random.default_rng(1)

        def stat(path, a):
            if path[-1].key == "var":
                return (rng.random(a.shape) + 0.5).astype(np.float32)
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

        stats = jax.tree_util.tree_map_with_path(stat,
                                                 variables["batch_stats"])
        _INITS[key] = {"params": variables["params"], "batch_stats": stats}
    return _INITS[key]


def _np_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _jax_logits(model, variables, x):
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return np.asarray(fwd(variables, jnp.asarray(x)))


def _port_logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name,size", [("resnet18-cifar", 32),
                                       ("resnet50-s2d", 64)])
@pytest.mark.parametrize("fused", [False, True])
def test_zoo_logits_match_jax(name, size, fused):
    x = _images(size, size)
    jm = jax_models.create_model(name, 10, dtype="float32",
                                 fused_conv_bn=fused)
    variables = _jax_init(name, jm, x)
    want = _jax_logits(jm, variables, x)
    pm = port_models.create_model(name, 10, dtype="float32",
                                  fused_conv_bn=fused, device="cpu")
    load_jax_variables(pm, _np_tree(variables))
    got = _port_logits(pm, x)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_narrow_bottleneck_resnet_matches_jax(fused):
    x = _images(3, 16)
    jm = jax_classifier.Classifier(
        backbone=jax_resnet.ResNet(stage_sizes=(1, 1),
                                   block=jax_resnet.Bottleneck,
                                   num_filters=8, fused_inference=fused),
        num_classes=10)
    variables = _jax_init("narrow", jm, x)
    want = _jax_logits(jm, variables, x)
    pm = Classifier(ResNet(stage_sizes=(1, 1), block=Bottleneck,
                           num_filters=8, fused_inference=fused,
                           device="cpu"), 10, device="cpu")
    load_jax_variables(pm, _np_tree(variables))
    np.testing.assert_allclose(_port_logits(pm, x), want, rtol=1e-4,
                               atol=1e-4)


def test_fused_path_launches_through_the_kernel_wrapper(monkeypatch):
    """Every conv -> BN pair of a fused eval forward goes through
    ``fused_conv_bn_relu``: 53 calls for ResNet-50 (the stem, 16
    bottlenecks x 3 convs, 4 downsample convs), at exactly the shapes
    ``chip_smoke.resnet50_launches`` times on the card."""
    import chip_smoke
    from tpuic_torch.models import resnet as port_resnet
    calls = []
    real = port_resnet.fused_conv_bn_relu

    def recording(x, w, scale, bias, *, strides, padding, relu):
        calls.append((tuple(x.shape), tuple(w.shape), strides, padding,
                      relu))
        return real(x, w, scale, bias, strides=strides, padding=padding,
                    relu=relu)

    monkeypatch.setattr(port_resnet, "fused_conv_bn_relu", recording)
    pm = port_models.create_model("resnet50", 10, dtype="float32",
                                  fused_conv_bn=True, device="cpu")
    init_synthetic(pm, seed=0, device="cpu")
    _port_logits(pm, _images(0, 64, batch=1))
    assert calls == chip_smoke.resnet50_launches(1, 64)
    assert len(calls) == 53
    pm.train()
    with torch.no_grad():
        pm(torch.from_numpy(_images(0, 32)))  # train mode: unfused
    assert len(calls) == 53


def test_packed_weights_follow_reloads_and_mode_changes():
    """The folded-weight cache is built once and dropped on a reload, a
    mode change, or a move, so the fused path never serves stale weights."""
    x = _images(4, 32)
    pm = port_models.create_model("resnet18-cifar", 10, dtype="float32",
                                  fused_conv_bn=True, device="cpu")
    init_synthetic(pm, seed=0, device="cpu")
    pm.eval()
    packed = pm.backbone.packed_weights()
    assert pm.backbone.packed_weights() is packed
    first = _port_logits(pm, x)
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    init_synthetic(pm, seed=1, device="cpu")
    second = _port_logits(pm, x)
    assert not np.allclose(first, second)
    pm.load_state_dict(state)
    np.testing.assert_array_equal(_port_logits(pm, x), first)
    pm.train()
    assert pm.backbone._packed is None
    pm.eval()
    pm.backbone.packed_weights()
    pm.to("cpu", torch.float32)
    assert pm.backbone._packed is None


def test_s2d_stem_kernel_is_bitwise_jax():
    w = np.random.default_rng(0).standard_normal((7, 7, 3, 16)).astype(
        np.float32)
    want = np.asarray(jax_resnet.s2d_stem_kernel(jnp.asarray(w)))
    got = s2d_stem_kernel(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_s2d_stem_equals_standard_stem():
    """The s2d stem with a converted 7x7 kernel computes the 7x7/s2 stem."""
    from tpuic_torch.kernels import fused_conv_bn_relu_plain
    from tpuic_torch.models.resnet import space_to_depth
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 7, 3, 8)).astype(np.float32))
    one, zero = torch.ones(8), torch.zeros(8)
    want = fused_conv_bn_relu_plain(x, w, one, zero, 2, 3, False)
    got = fused_conv_bn_relu(space_to_depth(x), s2d_stem_kernel(w), one,
                             zero, padding=((2, 1), (2, 1)), relu=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_load_jax_variables_is_strict():
    x = _images(0, 32)
    jm = jax_models.create_model("resnet18-cifar", 10, dtype="float32")
    tree = _np_tree(_jax_init("resnet18-cifar", jm, x))
    pm = port_models.create_model("resnet18-cifar", 10, dtype="float32",
                                  device="cpu")

    missing = jax.tree.map(lambda a: a, tree)
    del missing["params"]["backbone"]["layer2_0"]["conv1"]
    with pytest.raises(KeyError, match="lacks 1 model tensors"):
        load_jax_variables(pm, missing)

    bad = jax.tree.map(lambda a: a, tree)
    bad["params"]["head"]["fc1"]["kernel"] = np.zeros((128, 65), np.float32)
    with pytest.raises(ValueError, match="params/head/fc1/kernel: shape"):
        load_jax_variables(pm, bad)

    extra = jax.tree.map(lambda a: a, tree)
    extra["params"]["backbone"]["bogus"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError, match="params/backbone/bogus/kernel"):
        load_jax_variables(pm, extra)


def test_registry_covers_the_jax_zoo():
    ported = set(port_models.available_models())
    assert ported == {"resnet18", "resnet34", "resnet50", "resnet101",
                      "resnet152", "resnet18-cifar", "resnet50-s2d",
                      "vit-b16", "vit-l16", "vit-b32", "vit-l32", "vit-s16",
                      "vit-tiny", "inceptionv3"} | {
                          f"efficientnet-b{i}" for i in range(8)}
    assert port_models.NOT_YET_PORTED == ("vit-s16-moe", "vit-tiny-moe")
    assert set(jax_models.available_models()) == \
        ported | set(port_models.NOT_YET_PORTED)
    with pytest.raises(ValueError, match="not yet ported"):
        port_models.create_model("vit-s16-moe", 10, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        port_models.create_model("resnet9000", 10, device="cpu")


def test_create_model_defaults_and_device():
    pm = port_models.create_model("resnet18", 5, device="cpu")
    assert pm.backbone.compute_dtype == torch.bfloat16  # tpuic's default
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_models.create_model("resnet18", 5)


def test_config_defaults_match_jax():
    for port_cls, jax_cls in ((port_config.ModelConfig,
                               jax_config.ModelConfig),
                              (port_config.DataConfig,
                               jax_config.DataConfig),
                              (port_config.OptimConfig,
                               jax_config.OptimConfig),
                              (port_config.RunConfig,
                               jax_config.RunConfig),
                              (port_config.MeshConfig,
                               jax_config.MeshConfig)):
        jax_defaults = {f.name: f.default
                        for f in dataclasses.fields(jax_cls)}
        for f in dataclasses.fields(port_cls):
            assert f.default == jax_defaults[f.name], f.name
    assert port_config.ATTENTION_IMPLS == jax_models.ATTENTION_IMPLS
    cfg = port_config.ModelConfig(name="resnet18-cifar", num_classes=3,
                                  dtype="float32", fused_conv_bn=True)
    pm = port_models.create_model_from_config(cfg, device="cpu")
    assert pm.backbone.fused_inference and pm.head.out.out_features == 3
