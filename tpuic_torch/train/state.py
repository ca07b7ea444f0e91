"""Train state (``tpuic/train/state.py``).

``tpuic`` keeps one immutable pytree of params, BN statistics, optimizer
state and step.  Here the parameters and BN running statistics live in
the ``nn.Module``, and the step updates them, the optimizer state and the
counters in place.  ``step`` and ``skip_count`` are 0-d int32 tensors on
the model's device, so the train step never reads them back to the host.

**Parameter EMA** (``OptimConfig.ema_decay``, ``tpuic/train/state.py:28-46``,
``:82-110``): ``ema_params`` is a float32 copy of every parameter made
at step 0, which the train step moves as ``e = d*e + (1-d)*p`` after
each applied update.  ``inference_weights()`` puts it into the model for
the block: what the val pass, best-checkpoint selection, predict and
serving score (``tpuic``'s ``inference_params``), with the BN running
statistics as they are (``tpuic`` keeps no EMA of them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
from torch import nn

from tpuic_torch.checkpoint.convert import _invalidate as invalidate_folds
from tpuic_torch.train.optimizer import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """``model`` holds params + BN buffers; ``step`` counts applied
    (micro-)steps; ``skip_count`` is the streak of consecutive non-finite
    (skipped) steps, 0 after every applied one; ``ema_params`` (one
    float32 tensor per ``model.parameters()`` entry) or None."""

    model: nn.Module
    opt_state: OptState
    tx: Optimizer
    step: torch.Tensor
    skip_count: torch.Tensor
    ema_params: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        """The parameters the optimizer updates (all but a frozen
        backbone's)."""
        return [p for p in self.model.parameters() if p.requires_grad]

    def bn_buffers(self) -> List[torch.Tensor]:
        """Every BN running statistic, in ``named_buffers`` order."""
        return [b for name, b in self.model.named_buffers()
                if name.endswith(("running_mean", "running_var"))]

    @contextlib.contextmanager
    def inference_weights(self):
        """The model holds ``ema_params`` inside the block (nothing changes
        without an EMA); its own parameters come back after it.  Folded
        weights are rebuilt on both sides, so a fused forward inside
        folds the EMA weights."""
        if self.ema_params is None:
            yield self.model
            return
        params = list(self.model.parameters())
        with torch.no_grad():
            saved = [p.detach().clone() for p in params]
            torch._foreach_copy_(params, self.ema_params)
        invalidate_folds(self.model)
        try:
            yield self.model
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, saved)
            invalidate_folds(self.model)


def create_train_state(model: nn.Module, tx: Optimizer,
                       ema: bool = False) -> TrainState:
    """A state at step 0 around ``model`` (already initialised and on its
    device), with ``tx``'s fresh optimizer state over the parameters it
    trains (``tx.freeze_backbone`` turns the backbone's
    ``requires_grad`` off) and, with ``ema``, ``ema_params`` a copy of
    the parameters."""
    if tx.freeze_backbone:
        model.backbone.requires_grad_(False)
    dev = next(model.parameters()).device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    trained = [p for p in model.parameters() if p.requires_grad]
    ema_params = ([p.detach().float().clone() for p in model.parameters()]
                  if ema else None)
    return TrainState(model=model, opt_state=tx.init(trained), tx=tx,
                      step=zero.clone(), skip_count=zero.clone(),
                      ema_params=ema_params)
