"""``tpuic``'s train-step draws, replayed in JAX for the port's parity tests.

``tpuic/train/step.py`` draws everything of a step from
``dropout_rng = fold_in(key(seed), state.step)`` (``:198``): mixup and
CutMix from ``fold_in(dropout_rng, 0x6D69)`` (``:217-264``), random
erasing from ``fold_in(dropout_rng, 0x6572)`` (``:282-300``), and the
models' drop-path masks from flax's ``"dropout"`` stream of the same key.
:func:`step_draws` rebuilds the first two as the port's
``augment.StepDraws``; :func:`drop_masks` records the masks ``tpuic``'s
model draws, by wrapping ``jax.random.bernoulli`` around an eager flax
``apply`` with ``rngs={"dropout": dropout_rng}`` (the masks depend on
the key and the shapes only, so any images of the batch's shape do).
Nothing in ``tpuic`` changes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpuic_torch.train import augment


def dropout_rng(jax, seed: int, step: int):
    return jax.random.fold_in(jax.random.key(seed), step)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def step_draws(jax, seed: int, step: int, n: int, *, mixup_alpha=0.0,
               cutmix_alpha=0.0, random_erase=0.0,
               masks=None) -> augment.StepDraws:
    """The port's ``StepDraws`` holding what ``tpuic``'s step ``step``
    draws for a global batch of ``n`` (``masks`` [sites, n] bool, or
    None)."""
    jnp = jax.numpy
    rng = dropout_rng(jax, seed, step)
    mix = erase = None
    if mixup_alpha > 0 or cutmix_alpha > 0:
        mix_rng = jax.random.fold_in(rng, 0x6D69)
        perm = jax.random.permutation(jax.random.fold_in(mix_rng, 1), n)
        lam_m = lam_c = center = use = None
        if mixup_alpha > 0:
            lam_m = _t(jax.random.beta(mix_rng, mixup_alpha, mixup_alpha))
        if cutmix_alpha > 0:
            lam_c = _t(jax.random.beta(mix_rng, cutmix_alpha, cutmix_alpha))
            center = _t(jax.random.uniform(jax.random.fold_in(mix_rng, 2),
                                           (2,)))
        if mixup_alpha > 0 and cutmix_alpha > 0:
            use = _t(jax.random.bernoulli(jax.random.fold_in(mix_rng, 3)))
        mix = augment.MixDraws(_t(perm, torch.int64), lam_m, lam_c, center,
                               use)
    if random_erase > 0:
        ks = jax.random.split(jax.random.fold_in(rng, 0x6572), 5)
        erase = augment.EraseDraws(
            area=_t(jax.random.uniform(ks[0], (n,), minval=0.02,
                                       maxval=0.33)),
            log_ar=_t(jax.random.uniform(ks[1], (n,), minval=jnp.log(0.3),
                                         maxval=jnp.log(3.3))),
            cy=_t(jax.random.uniform(ks[2], (n,))),
            cx=_t(jax.random.uniform(ks[3], (n,))),
            apply=_t(jax.random.bernoulli(ks[4], random_erase, (n,))))
    return augment.StepDraws(mix, erase, masks)


@contextlib.contextmanager
def recording_bernoulli(jax):
    """Every ``jax.random.bernoulli`` output inside the block, in call
    order, as numpy arrays."""
    orig = jax.random.bernoulli
    seen = []

    def wrapped(key, p=0.5, shape=None):
        out = orig(key, p, shape)
        seen.append(np.asarray(out))
        return out

    jax.random.bernoulli = wrapped
    try:
        yield seen
    finally:
        jax.random.bernoulli = orig


def drop_masks(jax, model, variables, images, seed: int, step: int):
    """``[sites, B]`` bool: the drop-path masks ``tpuic``'s ``model``
    draws in a train-mode ``apply`` at step ``step`` (None: none)."""
    with recording_bernoulli(jax) as seen:
        model.apply(variables, jax.numpy.asarray(images), train=True,
                    mutable=["batch_stats", "intermediates"],
                    rngs={"dropout": dropout_rng(jax, seed, step)})
    if not seen:
        return None
    return torch.from_numpy(np.stack([m.reshape(-1) for m in seen]))
