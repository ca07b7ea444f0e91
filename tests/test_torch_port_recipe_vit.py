"""Port parity: the ViT recipe's step randomness and recipe features
(``recipes/README.md`` section 4: mixup 0.2, CutMix 1.0, random erase
0.25, drop-path 0.1, EMA 0.9999, AdamW with wd 0.05, clipping at 1.0,
label smoothing 0.1) against ``tpuic``'s ``make_train_step``.

- **Draws**: ``tests/_tpuic_draws.py`` replays ``tpuic``'s ``fold_in``
  chain in JAX and records the drop-path masks its ViT draws, and the
  port's step takes them (``train_step(..., draws=...)``).
- **The whole step**: three steps of ``vit-tiny`` at 32 px, batch 8,
  ``attention="flash"`` (``tpuic``'s Pallas kernels in interpret mode),
  the fused loss, from one flax init and optimizer state carried by the
  weight carriers (``load_jax_variables``, ``load_jax_opt_state``,
  ``load_jax_ema``): loss, gradient norm and accuracy rtol 1e-4 each
  step, then parameters and the EMA atol 5e-5 (as
  ``test_torch_port_vit.py``'s AdamW steps; its note on the key bias
  holds here too).  The seed is one whose three steps take both mixup and
  CutMix and erase some rows.
- **Drop-path alone**: the train-mode forward and backward with fixed
  masks, and the ViT's draw sites and rates (``drop_path * i /
  max(1, depth - 1)``, two a block).
- **The port's own draws** depend on ``(seed, step)`` alone, and their
  distributions are the ones asked for: Beta moments, erase area and
  aspect ranges and apply rate, drop-path keep rate, a permutation.
- **Refusals kept**: the sequence-parallel attention impls.

JAX and ``tpuic`` are imported inside fixtures.
"""

import math

import numpy as np
import pytest
import torch

import _tpuic_draws as replay
from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import (load_jax_ema, load_jax_opt_state,
                                    load_jax_variables)
from tpuic_torch.train import augment
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

CLASSES = 7
SIZE = 32
BATCH = 8
RECIPE = dict(optimizer="adam", learning_rate=1e-3, weight_decay=0.05,
              grad_clip_norm=1.0, milestones=(), class_weights=(),
              label_smoothing=0.1, fused_loss=True, mixup_alpha=0.2,
              cutmix_alpha=1.0, random_erase=0.25, ema_decay=0.9999)
DRAW = dict(mixup_alpha=0.2, cutmix_alpha=1.0, random_erase=0.25)
# A seed whose steps 0-2 take mixup and CutMix both, and erase rows.
SEED = 2


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


def _batches(k, seed=5):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
                np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32),
             "mask": np.ones(BATCH, np.float32)} for _ in range(k)]


def test_the_replayed_draws_take_every_branch(jx):
    """SEED's three steps exercise what the whole-step test claims."""
    jax = jx["jax"]
    draws = [replay.step_draws(jax, SEED, k, BATCH, **DRAW)
             for k in range(3)]
    assert {bool(d.mix.use_mixup) for d in draws} == {True, False}
    assert any(bool(d.erase.apply.any()) for d in draws)
    for d in draws:
        assert sorted(d.mix.perm.tolist()) == list(range(BATCH))


def test_recipe_steps_match_tpuic(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    mcfg = jx["cfg"].ModelConfig(name="vit-tiny", num_classes=CLASSES,
                                 dtype="float32", attention="flash",
                                 drop_path=0.1)
    ocfg = jx["cfg"].OptimConfig(**RECIPE)
    jmodel = jx["models"].create_model_from_config(mcfg)
    jstate = jx["state"](jmodel, jx["opt"].make_optimizer(ocfg, 3, 10),
                         jax.random.key(0), (BATCH, SIZE, SIZE, 3), ema=True)
    jstep = jx["train"](ocfg, mcfg, None,
                        lr_schedule=jx["opt"].make_schedule(ocfg, 3, 10),
                        donate=False, seed=SEED)
    dense = jx["models"].create_model_from_config(
        jx["cfg"].ModelConfig(name="vit-tiny", num_classes=CLASSES,
                              dtype="float32", drop_path=0.1))

    pm = pcfg.ModelConfig(name="vit-tiny", num_classes=CLASSES,
                          dtype="float32", attention="flash", drop_path=0.1)
    po = pcfg.OptimConfig(**RECIPE)
    model = port_models.create_model_from_config(pm, device="cpu",
                                                 image_size=SIZE)
    load_jax_variables(model, {"params": _np(jstate.params, jax)})
    names = [n for n, _ in model.named_parameters()]
    pstate = create_train_state(model, make_optimizer(po, 3, 10), ema=True)
    pstate.opt_state = load_jax_opt_state(_np(jstate.opt_state, jax), names,
                                          device="cpu")
    pstate.ema_params = load_jax_ema(model, _np(jstate.ema_params, jax),
                                     device="cpu")
    assert model.drop_path_rates() == [0.1, 0.1]
    pstep = make_train_step(po, pm, lr_schedule=make_schedule(po, 3, 10),
                            device="cpu", seed=SEED)
    for k, batch in enumerate(_batches(3)):
        masks = replay.drop_masks(
            jax, dense, {"params": jstate.params}, batch["image"], SEED, k)
        assert masks.shape == (2, BATCH)
        draws = replay.step_draws(jax, SEED, k, BATCH, masks=masks, **DRAW)
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in batch.items()})
        pstate, m = pstep(pstate, {n: torch.from_numpy(v)
                                   for n, v in batch.items()},
                          step=k, draws=draws)
        for key in ("loss", "grad_norm", "accuracy", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k} {key}")
    ref = port_models.create_model_from_config(pm, device="cpu",
                                               image_size=SIZE)
    load_jax_variables(ref, {"params": _np(jstate.params, jax)})
    want = dict(ref.named_parameters())
    ema_want = dict(zip(names, load_jax_ema(ref, _np(jstate.ema_params, jax),
                                            device="cpu")))
    for (name, got), ema in zip(model.named_parameters(), pstate.ema_params):
        pairs = [(got.detach().numpy(), want[name].detach().numpy(), 2.0),
                 (ema.numpy(), ema_want[name].numpy(), 2e-4)]
        for g, w, steps_of_lr in pairs:
            if name.endswith("attn.qkv.bias"):
                # Adam's normalised step on a gradient that is 0 up to
                # rounding (test_torch_port_vit.py): held to two steps of
                # lr, scaled by (1 - decay) * 3 steps for the EMA.
                third = g.shape[0] // 3
                key = slice(third, 2 * third)
                assert np.abs(g[key] - w[key]).max() <= \
                    2 * steps_of_lr * RECIPE["learning_rate"] + 1e-7
                g, w = np.delete(g, key, 0), np.delete(w, key, 0)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=5e-5,
                                       err_msg=name)


def test_drop_path_forward_and_backward_match_tpuic(jx):
    """Train-mode ``vit-tiny`` (depth 2, dense) at drop_path 0.5 with the
    masks ``tpuic`` draws: logits and every parameter's gradient of their
    sum, rtol 1e-4 / atol 1e-5."""
    jax, jnp = jx["jax"], jx["jnp"]
    jm = jx["models"].create_model("vit-tiny", CLASSES, dtype="float32",
                                   drop_path=0.5)
    x = _batches(1, seed=9)[0]["image"]
    variables = _np(jax.jit(lambda k: jm.init(k, jnp.asarray(x),
                                              train=False))(
        jax.random.key(1)), jax)
    rng = replay.dropout_rng(jax, 3, 0)

    def f(params):
        out = jm.apply({"params": params}, jnp.asarray(x), train=True,
                       rngs={"dropout": rng})
        return jnp.sum(out), out

    with replay.recording_bernoulli(jax) as seen:
        (_, want), grads = jax.value_and_grad(f, has_aux=True)(
            variables["params"])
    masks = torch.from_numpy(np.stack([s.reshape(-1) for s in seen]))
    assert masks.shape == (2, BATCH)          # block 1: attention, MLP
    assert 0 < int(masks.sum()) < masks.numel()
    pm = port_models.create_model("vit-tiny", CLASSES, dtype="float32",
                                  drop_path=0.5, image_size=SIZE,
                                  device="cpu")
    load_jax_variables(pm, variables)
    pm.train()
    got = pm(torch.from_numpy(x), drop_masks=masks)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    ref = port_models.create_model("vit-tiny", CLASSES, dtype="float32",
                                   image_size=SIZE, device="cpu")
    load_jax_variables(ref, {"params": _np(grads, jax)})
    want_g = dict(ref.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_g[name].detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="pass drop_masks"):
        pm(torch.from_numpy(x))


@pytest.mark.parametrize("depth,rate", [(2, 0.1), (12, 0.1), (1, 0.3)])
def test_vit_drop_path_sites_and_rates(depth, rate):
    from tpuic_torch.models.vit import ViT
    vit = ViT(patch=4, hidden=16, depth=depth, num_heads=2, image_size=8,
              drop_path=rate, device="cpu")
    want = [rate * i / max(1, depth - 1) for i in range(depth)]
    assert vit.drop_path_rates() == [r for r in want if r > 0
                                     for _ in range(2)]
    vit.eval()
    with torch.no_grad():  # eval mode draws nothing and needs no masks
        assert vit(torch.zeros(2, 8, 8, 3)).shape == (2, 16)


# -- the port's own draws -----------------------------------------------------

def _own(seed, step, n=64, keep=(0.9, 0.5)):
    gen = torch.Generator()
    return augment.draw_step(gen, seed, step, n, keep=torch.tensor(keep),
                             device="cpu", **DRAW)


def _flat(draws):
    out = []
    for part in draws:
        if part is None:
            continue
        for t in (part if isinstance(part, tuple) else (part,)):
            if t is not None:
                out.append(t.reshape(-1).double())
    return torch.cat(out)


def test_own_draws_depend_on_seed_and_step_alone():
    a = _own(0, 5)
    torch.manual_seed(123)  # the global RNG plays no part
    torch.rand(10)
    assert torch.equal(_flat(a), _flat(_own(0, 5)))
    assert not torch.equal(_flat(a), _flat(_own(0, 6)))
    assert not torch.equal(_flat(a), _flat(_own(1, 5)))
    # Turning erasing off changes no other feature's draws.
    gen = torch.Generator()
    b = augment.draw_step(gen, 0, 5, 64, mixup_alpha=0.2, cutmix_alpha=1.0,
                          keep=torch.tensor((0.9, 0.5)), device="cpu")
    assert b.erase is None
    assert torch.equal(b.mix.perm, a.mix.perm)
    assert torch.equal(b.drop_masks, a.drop_masks)


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_draws_have_beta_moments(alpha):
    """4,000 draws: mean 1/2 (sd of the mean 0.0055 at alpha 0.2) and
    variance 1 / (4 (2 alpha + 1)), within 5 standard errors."""
    gen = torch.Generator().manual_seed(7)
    x = torch.stack([augment.beta(gen, alpha, "cpu")
                     for _ in range(4000)]).double()
    var = 1.0 / (4.0 * (2 * alpha + 1))
    assert abs(float(x.mean()) - 0.5) < 5 * math.sqrt(var / 4000)
    assert abs(float(x.var()) - var) < 0.1 * var
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_erase_and_drop_draws_have_their_ranges_and_rates():
    gen = torch.Generator().manual_seed(3)
    e = augment.draw_erase(gen, 20000, 0.25, "cpu")
    assert 0.02 <= float(e.area.min()) and float(e.area.max()) < 0.33
    ar = torch.exp(e.log_ar)
    assert 0.3 - 1e-6 <= float(ar.min()) and float(ar.max()) < 3.3 + 1e-6
    assert abs(float(e.apply.float().mean()) - 0.25) < 0.02
    assert float(e.cy.min()) >= 0 and float(e.cx.max()) < 1
    m = augment.draw_drop_masks(gen, 20000, torch.tensor([0.9, 0.5]))
    np.testing.assert_allclose(m.float().mean(1).numpy(), [0.9, 0.5],
                               atol=0.015)


def test_erase_box_area_and_aspect():
    """Drawn boxes on a 64 x 64 image: every applied box is zero inside
    and its pixel count is the clipped box's."""
    gen = torch.Generator().manual_seed(4)
    e = augment.draw_erase(gen, 32, 1.0, "cpu")
    out = augment.erase_batch(torch.ones(32, 64, 64, 3), e)
    zero = (out[..., 0] == 0).sum(dim=(1, 2)).double()
    assert bool((zero > 0).all())
    assert float((zero / 4096).max()) <= 0.33 + 2 * 64 / 4096


def test_cutmix_lam_is_the_kept_area():
    gen = torch.Generator().manual_seed(5)
    d = augment.draw_mix(gen, 4, 0.0, 1.0, "cpu")
    imgs = torch.arange(4, dtype=torch.float32)[:, None, None, None] \
        .expand(4, 16, 16, 3).contiguous()
    out, labels_mix, lam = augment.mix_batch(
        imgs, torch.arange(4), torch.ones(4), d)
    pasted = (out[..., 0] != imgs[..., 0]).float().mean(dim=(1, 2))
    moved = d.perm != torch.arange(4)
    np.testing.assert_allclose(pasted[moved].numpy(), float(1 - lam),
                               atol=1e-6)
    assert torch.equal(labels_mix, d.perm)


def test_padding_partners_itself():
    gen = torch.Generator().manual_seed(6)
    d = augment.draw_mix(gen, 4, 0.2, 0.0, "cpu")
    imgs = torch.randn(4, 8, 8, 3)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    out, labels_mix, lam = augment.mix_batch(imgs, torch.arange(4), mask, d)
    for i in range(4):
        j = int(d.perm[i])
        if mask[i] * mask[j] == 0:
            torch.testing.assert_close(out[i], imgs[i])
            assert int(labels_mix[i]) == i


def test_sequence_parallel_attention_stays_refused():
    with pytest.raises(NotImplementedError, match="'ring' is not yet"):
        port_models.create_model("vit-tiny", 3, attention="ring",
                                 device="cpu")


@pytest.mark.cuda
def test_cuda_recipe_step_makes_no_host_sync():
    """Four ``vit-tiny`` micro-steps of the recipe (mixup, CutMix,
    erasing, drop-path, EMA) with ``grad_accum_steps`` 2, through the K4
    kernels and K1, under ``torch.cuda.set_sync_debug_mode("error")``:
    the draws (a CUDA generator), the mix, the accumulation gate and the
    EMA stay on the card.  Per micro-step: 2 K4 forward, dq and dk/dv
    launches (depth 2) and two K1 forward (the mixed loss's terms); the
    EMA moved on the two real updates."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import importlib
    from tpuic_torch.checkpoint import init_params
    FA = importlib.import_module("tpuic_torch.kernels.flash_attention")
    from tpuic_torch.kernels import cross_entropy_fwd
    mcfg = pcfg.ModelConfig(name="vit-tiny", num_classes=CLASSES,
                            dtype="float32", attention="flash",
                            drop_path=0.1)
    ocfg = pcfg.OptimConfig(**dict(RECIPE, grad_accum_steps=2))
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cuda", image_size=SIZE), 0, device="cuda")
    state = create_train_state(model, make_optimizer(ocfg, 3, 10), ema=True)
    step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(ocfg, 3, 10),
                           device="cuda", seed=SEED)
    batches = [{n: torch.from_numpy(v).cuda() for n, v in b.items()}
               for b in _batches(4)]
    ema0 = [e.clone() for e in state.ema_params]
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
    assert [c.launches - n for c, n in zip(counters, before)] == [8, 8, 8, 8]
    assert int(state.opt_state.gradient_step) == 2
    assert any(not torch.equal(a, b) for a, b in zip(ema0, state.ema_params))
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
