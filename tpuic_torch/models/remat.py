"""Rematerialisation (``ModelConfig.remat``; ``tpuic/train/step.py:68-134``,
``tpuic/models/vit.py:41-60``, ``:97-160``) through
``torch.utils.checkpoint``.

- ``dots``: the whole forward under selective activation checkpointing
  that saves the outputs of ``mm``, ``addmm``, ``bmm`` and
  ``convolution`` and recomputes everything else in the backward
  (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``'s
  counterpart).  A hand-written kernel's autograd function is no such op,
  so its forward runs again in the backward, as a Pallas call does under
  ``jax.checkpoint``.
- ``attention``: only the dense ViT attention core, saving nothing.
- ``gelu``: each ViT block's ``mlp_up`` + GELU, saving nothing.
- ``blocks``: each ViT encoder block, saving nothing.

A recomputed forward must not update BN running statistics a second
time: :func:`recomputing` is true while the backward recomputes, and
``models.layers.BatchNorm`` skips its buffer update then.  Remat changes
no number.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("dots", "attention", "blocks", "gelu")

_LOCAL = threading.local()
_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.convolution.default))


def recomputing() -> bool:
    """True inside a checkpointed region's backward recompute."""
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def _recompute(inner):
    """``inner`` (a checkpoint's recompute context), with
    :func:`recomputing` true inside."""
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        with inner:
            yield
    finally:
        _LOCAL.depth -= 1


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn, *args, save_dots: bool = False):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant);
    ``save_dots`` keeps the outputs of the matrix products and
    convolutions, else nothing is saved.  Random numbers come in as
    arguments, so the recompute needs no RNG state."""
    def contexts():
        if save_dots:
            fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
            return fwd, _recompute(rec)
        return contextlib.nullcontext(), _recompute(contextlib.nullcontext())

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)


def resolve_remat_policy(model_cfg):
    """The policy ``model_cfg`` asks for (None when ``remat`` is off),
    warning as ``tpuic`` does where it has no effect."""
    if not model_cfg.remat:
        return None
    policy = model_cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy '{policy}'; available: "
                         f"{list(REMAT_POLICIES)}")
    vit = "vit" in model_cfg.name
    if policy == "attention" and (not vit or model_cfg.attention != "dense"):
        warnings.warn(
            f"remat_policy='attention' has no effect for model="
            f"'{model_cfg.name}' with attention='{model_cfg.attention}': "
            "only the dense ViT attention core is rematerializable; NO "
            "remat is applied. Use remat_policy='dots' for whole-forward "
            "remat.", stacklevel=2)
    elif policy in ("gelu", "blocks") and not vit:
        warnings.warn(
            f"remat_policy='{policy}' has no effect for model="
            f"'{model_cfg.name}': only the ViT encoder has it; NO remat is "
            "applied. Use remat_policy='dots' for whole-forward remat.",
            stacklevel=2)
    return policy
