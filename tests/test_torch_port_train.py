"""Port parity: the ``tpuic_torch`` training path against ``tpuic``'s.

- Train-mode BatchNorm updates its running statistics as flax does (the
  biased batch variance), at rtol 1e-6.
- Three train steps of ``resnet18-cifar`` (32x32, batch 4, 7 classes)
  with the fused loss, fused LARS, class weights, label smoothing 0.1 and
  a padded mask, from carried identical weights and optimizer state:
  per-step loss, gradient norm and accuracy, then parameters, BN
  statistics and optimizer state after step 3.
- The non-finite skip guard, the eval-step sums, the ``Loader``'s batches
  (bit for bit, two epochs, padded val batch) and the CLI.

JAX runs on the CPU; the fused loss there is the Pallas kernel in
interpret mode, the port's the kernels' plain versions.  JAX and
``tpuic`` are imported inside fixtures, so the ``cuda`` test of this file
runs where JAX is not installed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import load_jax_opt_state, load_jax_variables
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.pipeline import Loader
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.models.layers import BatchNorm
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_eval_step, make_train_step
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 7
WEIGHTS = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)
OPTIM = dict(optimizer="lars", learning_rate=0.1, milestones=(),
             class_weights=WEIGHTS, weight_decay=1e-4, label_smoothing=0.1,
             fused_loss=True, fused_optimizer=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic import config as jcfg
    from tpuic.data import folder as jfolder
    from tpuic.data import pipeline as jpipe
    from tpuic.models import create_model_from_config
    from tpuic.models import layers as jlayers
    from tpuic.train import optimizer as jopt
    from tpuic.train.state import create_train_state as jstate
    from tpuic.train.step import make_eval_step as jeval
    from tpuic.train.step import make_train_step as jtrain
    return dict(jax=jax, jnp=jnp, cfg=jcfg, folder=jfolder, pipe=jpipe,
                create=create_model_from_config, layers=jlayers, opt=jopt,
                state=jstate, eval=jeval, train=jtrain)


def _np(tree, jax):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(4, 3, 3, 5), (2, 2, 2, 8)])
def test_train_mode_bn_updates_stats_like_flax(jx, shape):
    """One train-mode forward from non-trivial running statistics:
    ``running_mean``/``running_var`` equal flax's ``batch_stats``
    (momentum 0.9, biased variance) at rtol 1e-6.  ``nn.BatchNorm2d``'s
    unbiased update is n/(n-1) away: 36/35 and 8/7 here."""
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(sum(shape))
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    c = shape[-1]
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = (rng.random(c) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    bn = jx["layers"].batch_norm(train=True)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(c, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    port.train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    port.eval()  # eval mode: the running statistics, unchanged
    before = port.running_var.clone()
    with torch.no_grad():
        port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(port.running_var, before)


def _batches(k, b=4, size=32, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        out.append({
            "image": rng.standard_normal((b, size, size, 3)).astype(
                np.float32),
            "label": rng.integers(0, CLASSES, b).astype(np.int32),
            "mask": np.array([1.0] * (b - 1) + [0.0], np.float32)})
    return out


def _jax_setup(jx, optim):
    jax = jx["jax"]
    mcfg = jx["cfg"].ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                                 dtype="float32")
    ocfg = jx["cfg"].OptimConfig(**optim)
    model = jx["create"](mcfg)
    sched = jx["opt"].make_schedule(ocfg, 3, 10)
    tx = jx["opt"].make_optimizer(ocfg, 3, 10)
    state = jx["state"](model, tx, jax.random.key(0), (4, 32, 32, 3))
    return mcfg, ocfg, sched, state


def _port_setup(state_np, optim):
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="float32")
    ocfg = pcfg.OptimConfig(**optim)
    model = port_models.create_model_from_config(mcfg, device="cpu")
    load_jax_variables(model, {"params": state_np.params,
                               "batch_stats": state_np.batch_stats})
    tx = make_optimizer(ocfg, 3, 10)
    state = create_train_state(model, tx)
    state.opt_state = load_jax_opt_state(
        state_np.opt_state, [n for n, _ in model.named_parameters()],
        device="cpu")
    return mcfg, ocfg, make_schedule(ocfg, 3, 10), state


def _compare_states(jx, jstate, pstate, params_tol, stats_tol, opt_tol):
    jax = jx["jax"]
    ref = port_models.create_model("resnet18-cifar", CLASSES,
                                   dtype="float32", device="cpu")
    load_jax_variables(ref, {"params": _np(jstate.params, jax),
                             "batch_stats": _np(jstate.batch_stats, jax)})
    want = ref.state_dict()
    for name, got in pstate.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = stats_tol if "running" in name else params_tol
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **tol)
    carried = load_jax_opt_state(
        _np(jstate.opt_state, jax),
        [n for n, _ in pstate.model.named_parameters()], device="cpu")
    assert int(carried.count) == int(pstate.opt_state.count)
    for a, b in zip(pstate.opt_state.trace, carried.trace):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **opt_tol)


def test_three_train_steps_match_tpuic(jx):
    """Fused loss + fused LARS + class weights + smoothing + a padded mask,
    3 steps from identical carried weights.  Step 1 takes the trust = 1
    branch on every zero-initialised bias.

    This net at batch 4 is ill-conditioned in float32: on other batches
    (seed 7) single elements of ``tpuic``'s float32 gradient lie up to 20%
    from its own float64 gradient, which the port's float32 gradient
    matches to 1e-7.  On this batch (seed 6) the two float32 runs agree to
    ~1e-5, and the tolerances keep a 10x margin over that: loss, accuracy
    and gradient norm rtol 1e-4; parameters and optimizer trace atol 5e-5;
    BN statistics rtol 1e-4 / atol 1e-5."""
    jax, jnp = jx["jax"], jx["jnp"]
    mcfg, ocfg, jsched, jstate = _jax_setup(jx, OPTIM)
    jstep = jx["train"](ocfg, mcfg, None, lr_schedule=jsched, donate=False)
    pm, po, psched, pstate = _port_setup(_np(jstate, jax), OPTIM)
    pstep = make_train_step(po, pm, lr_schedule=psched, device="cpu")
    for k, batch in enumerate(_batches(3, seed=6)):
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in batch.items()})
        pstate, m = pstep(pstate, {n: torch.from_numpy(v)
                                   for n, v in batch.items()})
        for key in ("loss", "grad_norm", "accuracy", "lr", "skipped",
                    "skip_count"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k} {key}")
    assert int(pstate.step) == int(jstate.step) == 3
    _compare_states(jx, jstate, pstate, dict(rtol=1e-4, atol=5e-5),
                    dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-4, atol=5e-5))


def test_nan_batch_leaves_state_unchanged():
    """A NaN batch: params, optimizer state (count included), BN
    statistics and step stay bit for bit; skip_count goes 0 -> 1 -> 2,
    and the next finite step applies and resets it."""
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="float32")
    ocfg = pcfg.OptimConfig(**OPTIM)
    model = port_models.create_model_from_config(mcfg, device="cpu")
    from tpuic_torch.checkpoint import init_params
    init_params(model, 0, device="cpu")
    state = create_train_state(model, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(ocfg, 3, 10),
                           device="cpu")
    good = {n: torch.from_numpy(v) for n, v in _batches(1)[0].items()}
    state, _ = step(state, good)

    def snapshot():
        return ([t.clone() for t in model.state_dict().values()]
                + [t.clone() for t in state.opt_state.trace]
                + [state.opt_state.count.clone(), state.step.clone()])

    before = snapshot()
    bad = dict(good, image=good["image"] * float("nan"))
    for streak in (1, 2):
        state, m = step(state, bad)
        assert float(m["skipped"]) == 1.0 and int(m["skip_count"]) == streak
        assert int(state.skip_count) == streak
        for a, b in zip(snapshot(), before):
            assert torch.equal(a, b)
    state, m = step(state, good)
    assert float(m["skipped"]) == 0.0 and int(state.skip_count) == 0
    assert int(state.step) == 2 and int(state.opt_state.count) == 2


def test_eval_step_sums_match_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    mcfg, ocfg, _, jstate = _jax_setup(jx, OPTIM)
    _, po, _, pstate = _port_setup(_np(jstate, jax), OPTIM)
    batch = _batches(1, b=6, seed=3)[0]
    want = jx["eval"](ocfg, mcfg)(jstate, {n: jnp.asarray(v)
                                           for n, v in batch.items()})
    pm = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                          dtype="float32")
    got = make_eval_step(po, pm, device="cpu")(
        pstate, {n: torch.from_numpy(v) for n, v in batch.items()})
    assert set(got) == set(want) == {"correct", "count", "loss_num",
                                     "loss_den", "correct5"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    # 19 train images (batch 4: 4 steps, 3 dropped), 11 val (3 batches,
    # the last padded by one).
    make_synthetic_imagefolder(str(root), classes=("a", "b", "c"),
                               per_class=7, size=20, folds=("train",))
    make_synthetic_imagefolder(str(root), classes=("a", "b", "c"),
                               per_class=4, size=20, folds=("val",), seed=1)
    os.remove(os.path.join(root, "train", "c", "c_train_6.png"))
    os.remove(os.path.join(root, "val", "a", "a_val_3.png"))
    return str(root)


def test_loader_batches_bitwise_tpuic(jx, folder):
    """``pack=False``, ``native=False``: the same images, labels, masks,
    indices and ids as tpuic's Loader, for two epochs of the train fold
    (shuffled, augmented, drop_last) and the padded val fold."""
    jd = jx["cfg"].DataConfig(data_dir=folder, resize_size=24, native=False,
                              pack=False)
    pd = pcfg.DataConfig(data_dir=folder, resize_size=24, native=False,
                         pack=False)
    for fold, kw in (("train", dict(drop_last=True, seed=5)),
                     ("val", dict(shuffle=False))):
        jds = jx["folder"].ImageFolderDataset(folder, fold, 24, jd)
        pds = ImageFolderDataset(folder, fold, 24, pd)
        jl = jx["pipe"].Loader(jds, 4, None, num_workers=3,
                               process_index=0, process_count=1, **kw)
        pl = Loader(pds, 4, num_workers=2, device="cpu", **kw)
        assert len(jl) == len(pl)
        for epoch in (0, 1):
            jb = list(jl.epoch(epoch))
            pb = list(pl.epoch(epoch))
            assert len(jb) == len(pb) == len(pl)
            for a, b in zip(jb, pb):
                for key in ("image", "label", "mask"):
                    np.testing.assert_array_equal(b[key].numpy(),
                                                  np.asarray(a[key]))
                np.testing.assert_array_equal(b.indices, a.indices)
                assert b.image_ids == a.image_ids
        if fold == "val":
            assert pb[-1]["mask"].tolist() == [1.0, 1.0, 0.0, 0.0][:4] or \
                float(pb[-1]["mask"].sum()) == len(pds) % 4


def _cli(args, timeout=240, threads=None):
    env = subprocess_env(PYTHONPATH=ROOT)
    if threads:  # the suite's processes share the cores
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.run([sys.executable, "-m", "tpuic_torch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_trains_on_cpu(folder, tmp_path):
    out = _cli(["--datadir", folder, "--device", "cpu", "--steps", "2",
                "--ckpt-dir", str(tmp_path),
                "--model", "resnet18-cifar", "--resize", "24",
                "--batchsize", "4", "--optimizer", "lars", "--lr", "1.0",
                "--no-class-weights", "--milestones", "--fused-loss",
                "--fused-optimizer", "--label-smoothing", "0.1",
                "--dtype", "float32", "--no-pack", "--no-native",
                "--workers", "2", "--log-every-steps", "1"])
    assert out.returncode == 0, out.stderr
    assert "optimizer fused_lars, on cpu" in out.stdout
    assert "step budget (2) reached" in out.stdout
    assert "Epoch: 0; step 2;" in out.stdout


def test_cli_refuses_unported_settings(folder):
    from tpuic_torch.train.__main__ import main
    from tpuic_torch.train.loop import unported_settings
    base = ["--datadir", folder, "--device", "cpu", "--dtype", "float32",
            "--no-pack", "--no-native", "--model", "resnet18-cifar"]
    with pytest.raises(SystemExit, match="not yet ported to tpuic_torch: "
                       "mesh.seq"):
        main(base + ["--seq-axis", "2"])
    # The packed loader, the native core, the failure story (--init-from,
    # rollback) are ported: their fields are no longer refused, and a
    # flag still to port is.
    assert unported_settings(pcfg.Config()) == []
    assert unported_settings(pcfg.Config(run=pcfg.RunConfig(
        init_from="x", skip_threshold=3, rollback=False,
        rollback_rewarm_steps=4))) == []
    with pytest.raises(SystemExit, match="not yet ported to tpuic_torch: "
                       "mesh.fsdp"):
        main(base[:-4] + ["--model", "resnet18-cifar", "--fsdp"])
    # Item 8's recipe features are ported: no field of theirs is refused.
    cfg = pcfg.Config(
        model=pcfg.ModelConfig(name="efficientnet-b0", remat=True,
                               drop_path=0.1),
        optim=pcfg.OptimConfig(mixup_alpha=0.2, cutmix_alpha=1.0,
                               random_erase=0.25, ema_decay=0.9999,
                               grad_accum_steps=4, freeze_backbone=True),
        data=pcfg.DataConfig(pack=False, native=False))
    assert unported_settings(cfg) == []


@pytest.mark.parametrize("recipe", [
    # recipes/README.md section 4 (ViT-B/16), on vit-tiny at 16 px.
    ["--model", "vit-tiny", "--attention", "flash", "--resize", "16",
     "--optimizer", "adam", "--lr", "3e-4", "--weight-decay", "0.05",
     "--warmup-epochs", "10", "--label-smoothing", "0.1", "--mixup", "0.2",
     "--cutmix", "1.0", "--random-erase", "0.25", "--drop-path", "0.1",
     "--clip-grad-norm", "1.0", "--ema-decay", "0.9999",
     "--dtype", "bfloat16"],
    # Section 3 (EfficientNet-B0), at 32 px.
    ["--model", "efficientnet-b0", "--resize", "32", "--optimizer", "sgd",
     "--lr", "0.4", "--warmup-epochs", "5", "--dtype", "bfloat16"],
    # Section 5's accumulation, freeze and remat, on resnet18-cifar.
    ["--model", "resnet18-cifar", "--resize", "16", "--optimizer", "lars",
     "--lr", "4.8", "--weight-decay", "1e-4", "--fused-optimizer",
     "--grad-accum-steps", "2", "--freeze-backbone", "--remat",
     "--remat-policy", "dots", "--dtype", "float32"],
], ids=["vit-section4", "effnet-section3", "accum-freeze-remat"])
def test_cli_runs_the_recipe_flags_on_cpu(folder, tmp_path, capsys, recipe):
    from tpuic_torch.train.__main__ import main
    assert main(["--datadir", folder, "--device", "cpu", "--no-pack",
                 "--no-native", "--no-class-weights", "--batchsize", "4",
                 "--epochs", "2", "--steps", "2", "--workers", "2",
                 "--log-every-steps", "1", "--ckpt-dir",
                 str(tmp_path), *recipe]) == 0
    out = capsys.readouterr().out
    assert "step budget (2) reached" in out and "Epoch: 0; step 2;" in out


def test_cli_reference_defaults_run_on_cpu(tmp_path):
    """The reference's own command line: InceptionV3 with its aux head at
    299 px, bfloat16, Adam, batch 4, the 7 class weights; one step."""
    root = str(tmp_path / "data")
    make_synthetic_imagefolder(root, classes=tuple(f"c{i}"
                                                   for i in range(7)),
                               per_class=1, size=299)
    out = _cli(["--datadir", root, "--device", "cpu", "--no-pack",
                "--no-native", "--ckpt-dir", str(tmp_path / "ck"),
                "--steps", "1", "--workers", "2", "--log-every-steps", "1"],
               threads=2)
    assert out.returncode == 0, out.stderr
    assert ("[model] inceptionv3: 24.6M params, 7 classes, batch 4, "
            "optimizer adam, on cpu, bfloat16 compute") in out.stdout
    assert "Epoch: 0; step 1;" in out.stdout
    assert "step budget (1) reached" in out.stdout


@pytest.mark.cuda
def test_cuda_train_step_makes_no_host_sync():
    """Two fused-LARS steps (the second on the kernels' cached leaf table)
    under ``torch.cuda.set_sync_debug_mode("error")``: any host sync in
    the step raises.  Then the state is finite and both kernels ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import cross_entropy_fwd, lars_update
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="float32")
    ocfg = pcfg.OptimConfig(**OPTIM)
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cuda"), 0, device="cuda")
    state = create_train_state(model, make_optimizer(ocfg, 3, 10))
    step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(ocfg, 3, 10),
                           device="cuda")
    batches = [{n: torch.from_numpy(v).cuda() for n, v in b.items()}
               for b in _batches(3)]
    torch.cuda.synchronize()
    before = (cross_entropy_fwd.launches, lars_update.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            state, metrics = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (cross_entropy_fwd.launches - before[0],
            lars_update.launches - before[1]) == (3, 3)
    assert int(state.step) == 3 and float(metrics["skipped"]) == 0.0
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
