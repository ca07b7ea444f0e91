"""Checkpoint -> a model for inference (``tpuic/checkpoint/loading.py``).

Restoring weights to serve is stricter than the trainer's lenient resume:

- a missing ``--ckpt-dir`` or track is an error, never a confident run on
  a fresh initialisation;
- a partial key-intersection restore is an error too: fresh tensors in
  the forward mean the wrong model or class count;
- the model comes back on its device, in eval mode.

The run's ``config.json`` sidecar (written by the ``Trainer`` beside the
tracks) gives the architecture the run trained: the class count it
inferred, the head widths, the BN settings and the image size.  The
caller's ``cfg.model`` gives the rest: the backbone name (the directory
the tracks live in), the compute dtype, the fused conv+BN path and the
attention impl.

Not ported yet: ``load_candidate_variables``, the hot-swap gate's read,
which waits for the engine's ``swap_weights``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Optional, Tuple

import torch

from tpuic_torch.checkpoint.manager import CheckpointManager

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


def load_inference_variables(cfg, *, track: str = "best", device=None,
                             log=print):
    """A port model built from ``cfg`` (and the run's sidecar, see the
    module docstring) with the weights of ``track``, on ``device`` (None:
    the card), in eval mode.  Raises ``FileNotFoundError`` when the track
    does not exist and ``ValueError`` when it restores only part of the
    model."""
    from tpuic_torch.checkpoint.convert import init_params
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer
    from tpuic_torch.train.state import create_train_state

    mcfg, size = _resolved_model_config(cfg)
    mgr = CheckpointManager(cfg.run.ckpt_dir, mcfg.name, log=log)
    if not os.path.isdir(os.path.join(mgr.root, track)):
        raise FileNotFoundError(f"no '{track}' checkpoint under {mgr.root}")
    model = init_params(create_model_from_config(mcfg, device=device,
                                                 image_size=size), 0,
                        device=device)
    state = create_train_state(model, make_optimizer(cfg.optim))
    _, _, best = mgr.restore_into(state, track=track)
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
