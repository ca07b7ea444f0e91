"""Checkpoint -> a model for inference (``tpuic/checkpoint/loading.py``).

Restoring weights to serve is stricter than the trainer's lenient resume:

- a missing ``--ckpt-dir`` or track is an error, never a confident run on
  a fresh initialisation;
- a partial key-intersection restore is an error too: fresh tensors in
  the forward mean the wrong model or class count;
- the model comes back on its device, in eval mode;
- with ``cfg.optim.ema_decay`` above 0 (the run's sidecar, read by
  predict and the serve CLI) the model holds the checkpoint's
  ``ema_params``, the weights ``tpuic`` scores and serves
  (``tpuic/checkpoint/loading.py:78``, ``:182``); a checkpoint without
  them gives its parameters.

The run's ``config.json`` sidecar (written by the ``Trainer`` beside the
tracks) gives the architecture the run trained: the class count it
inferred, the head widths, the BN settings and the image size.  The
caller's ``cfg.model`` gives the rest: the backbone name (the directory
the tracks live in), the compute dtype, the fused conv+BN path and the
attention impl.

``load_candidate_variables`` is the hot-swap gate's read, stricter still:
the named track only, its commit manifest required and verified, every
failure a typed ``SwapRejected`` (cause ``swap_corrupt``), and the
weights restored into a fresh model, never into a serving one.  The
fault point ``swap_corrupt`` (``runtime/faults.py``) flips bytes of the
candidate's largest payload file after it is located and before it is
verified, so the gate must refuse it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Optional, Tuple

import torch

from tpuic_torch.checkpoint.convert import _invalidate
from tpuic_torch.checkpoint.manager import CheckpointManager
from tpuic_torch.runtime import faults

#: Sidecar fields that fix the architecture a run trained.
ARCH_FIELDS = ("num_classes", "head_widths", "bn_momentum", "bn_eps")


def _resolved_model_config(cfg) -> Tuple[object, Optional[int]]:
    """``(ModelConfig, image size)``: ``cfg.model`` with :data:`ARCH_FIELDS`
    from the run's ``config.json`` sidecar, and the sidecar's
    ``data.resize_size``; ``cfg`` as it is (and ``cfg.data.resize_size``)
    when the run wrote no sidecar."""
    root = os.path.join(cfg.run.ckpt_dir, cfg.model.name)
    path = os.path.join(root, "config.json")
    if not os.path.isfile(path):
        return cfg.model, cfg.data.resize_size
    with open(path) as f:
        saved = json.load(f)
    model = saved.get("model", {})
    arch = {k: (tuple(model[k]) if isinstance(model[k], list) else model[k])
            for k in ARCH_FIELDS if k in model}
    size = saved.get("data", {}).get("resize_size", cfg.data.resize_size)
    return dataclasses.replace(cfg.model, **arch), int(size)


def _inference_params(state) -> None:
    """Write ``state.ema_params`` (when the state keeps them) into its
    model: ``tpuic``'s ``inference_params``."""
    if state.ema_params is not None:
        with torch.no_grad():
            torch._foreach_copy_(list(state.model.parameters()),
                                 state.ema_params)
        _invalidate(state.model)


def load_inference_variables(cfg, *, track: str = "best", device=None,
                             log=print):
    """A port model built from ``cfg`` (and the run's sidecar, see the
    module docstring) with the weights of ``track``, on ``device`` (None:
    the card), in eval mode.  Raises ``FileNotFoundError`` when the track
    does not exist and ``ValueError`` when it restores only part of the
    model.

    ``cfg.run.init_from`` (a reference torch checkpoint) wins over the
    track, as in ``tpuic``: the model is built from ``cfg.model`` at
    ``cfg.data.resize_size`` with its fresh initialisation and the
    checkpoint merged in leniently (``torch_convert.init_from_torch``)."""
    from tpuic_torch.checkpoint.convert import init_params
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer
    from tpuic_torch.train.state import create_train_state

    if cfg.run.init_from:
        from tpuic_torch.checkpoint.torch_convert import init_from_torch
        model = init_params(create_model_from_config(
            cfg.model, device=device, image_size=cfg.data.resize_size), 0,
            device=device)
        init_from_torch(model, cfg.run.init_from, cfg.model.name, log=log)
        return model.eval()
    mcfg, size = _resolved_model_config(cfg)
    mgr = CheckpointManager(cfg.run.ckpt_dir, mcfg.name, log=log)
    if not os.path.isdir(os.path.join(mgr.root, track)):
        raise FileNotFoundError(f"no '{track}' checkpoint under {mgr.root}")
    model = init_params(create_model_from_config(mcfg, device=device,
                                                 image_size=size), 0,
                        device=device)
    state = create_train_state(model, make_optimizer(cfg.optim),
                               ema=cfg.optim.ema_decay > 0)
    _, _, best = mgr.restore_into(state, track=track)
    _inference_params(state)
    loaded, total = mgr.last_restore_loaded or (0, 0)
    if loaded < total:
        raise ValueError(
            f"checkpoint {mgr.root}/{track} restored only {loaded}/{total} "
            f"tensors into model '{mcfg.name}': wrong --model or "
            "--num-classes for this checkpoint?")
    saved_epoch, sie = mgr.last_restore_meta
    saved_at = (f"epoch {saved_epoch} step {sie}" if sie >= 0
                else f"epoch {saved_epoch}")
    log(f"[load] restored {mcfg.name}/{mgr.last_restore_rung} (saved at "
        f"{saved_at}, best {best:.2f})")
    return model.eval()


def load_candidate_variables(cfg, *, track: str = "best", log=print,
                             device=None):
    """Gate-grade load of a hot-swap candidate: ``(model, digest)``, the
    model built as :func:`load_inference_variables` builds it (on
    ``device``, None: the card, in eval mode) with ``track``'s weights.

    - No ladder: only the named track is read (``restore_exact``); a
      swap that fell back to ``.prev`` would serve weights nobody named.
    - The commit manifest is mandatory and verified: a missing track, a
      missing ``.manifest.json``, a failed ``verify_track`` or a failed
      read raises ``SwapRejected`` with cause ``swap_corrupt``.
    - A partial restore (another model or class count) raises
      ``ValueError``.
    - The weights go into a fresh model: a serving model is never
      touched, whatever fails."""
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.serve.admission import SwapRejected
    from tpuic_torch.train.optimizer import make_optimizer
    from tpuic_torch.train.state import create_train_state

    mcfg, size = _resolved_model_config(cfg)
    mgr = CheckpointManager(cfg.run.ckpt_dir, mcfg.name, log=log)
    path = os.path.join(mgr.root, track)
    if not os.path.isdir(path):
        raise SwapRejected(f"swap candidate missing: no '{track}' "
                           f"checkpoint under {mgr.root}",
                           cause="swap_corrupt")
    if faults.fire("swap_corrupt"):
        # Bit-rot between producer and gate: flip the largest payload
        # file's first bytes before the verification below reads them.
        victim, size = None, -1
        for dirpath, _, filenames in os.walk(path):
            for fn in filenames:
                fp = os.path.join(dirpath, fn)
                if os.path.getsize(fp) > size:
                    victim, size = fp, os.path.getsize(fp)
        if victim is not None:
            faults.corrupt_file(victim)
            log(f"[swap] fault 'swap_corrupt': corrupted "
                f"{os.path.relpath(victim, path)} pre-verification")
    if not os.path.exists(path + ".manifest.json"):
        raise SwapRejected(
            f"swap candidate {mgr.root}/{track} has no commit manifest — "
            "the swap gate requires CRC-verifiable bytes",
            cause="swap_corrupt")
    ok, detail = mgr.verify_track(track)
    if not ok:
        raise SwapRejected(f"swap candidate {mgr.root}/{track} failed the "
                           f"integrity gate: {detail}", cause="swap_corrupt")
    # No initialisation: the restore writes every tensor, or the load is
    # refused below.
    model = create_model_from_config(mcfg, device=device, image_size=size)
    state = create_train_state(model, make_optimizer(cfg.optim),
                               ema=cfg.optim.ema_decay > 0)
    try:
        _, _, best = mgr.restore_exact(state, track)
    except Exception as e:
        raise SwapRejected(
            f"swap candidate {mgr.root}/{track} failed to restore: "
            f"{type(e).__name__}: {e}", cause="swap_corrupt") from e
    _inference_params(state)
    loaded, total = mgr.last_restore_loaded
    if loaded < total:
        raise ValueError(
            f"swap candidate {mgr.root}/{track} restored only "
            f"{loaded}/{total} tensors into model '{mcfg.name}' — wrong "
            "model/num_classes for this checkpoint")
    digest = variables_digest(model)
    log(f"[swap] candidate {mcfg.name}/{track} verified ({detail}; best "
        f"{best:.2f}, digest {digest})")
    return model.eval(), digest


def variables_digest(model_or_state_dict) -> str:
    """Content digest of a model's ``state_dict`` (8 hex chars): CRC32
    folded over every tensor's name, shape, dtype and bytes, in sorted
    name order.  Two models with the same digest hold the same bits."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    crc = 0
    for name in sorted(sd):
        t = sd[name].detach().to("cpu").contiguous()
        head = f"{name}|{tuple(t.shape)}|{t.dtype}|"
        crc = zlib.crc32(head.encode(), crc)
        crc = zlib.crc32(t.reshape(-1).view(torch.uint8).numpy().tobytes(),
                         crc)
    return f"{crc & 0xFFFFFFFF:08x}"
