"""Train state (``tpuic/train/state.py``).

``tpuic`` keeps one immutable pytree of params, BN statistics, optimizer
state and step.  Here the parameters and BN running statistics live in
the ``nn.Module``, and the step updates them, the optimizer state and the
counters in place.  ``step`` and ``skip_count`` are 0-d int32 tensors on
the model's device, so the train step never reads them back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch
from torch import nn

from tpuic_torch.train.optimizer import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """``model`` holds params + BN buffers; ``step`` counts applied
    updates; ``skip_count`` is the streak of consecutive non-finite
    (skipped) steps, 0 after every applied one.  ``ema_params`` stays
    None: parameter EMA is not ported."""

    model: nn.Module
    opt_state: OptState
    tx: Optimizer
    step: torch.Tensor
    skip_count: torch.Tensor
    ema_params: Any = None

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def bn_buffers(self) -> List[torch.Tensor]:
        """Every BN running statistic, in ``named_buffers`` order."""
        return [b for name, b in self.model.named_buffers()
                if name.endswith(("running_mean", "running_var"))]


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    """A state at step 0 around ``model`` (already initialised and on its
    device), with ``tx``'s fresh optimizer state."""
    dev = next(model.parameters()).device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(model=model, opt_state=tx.init(list(model.parameters())),
                      tx=tx, step=zero.clone(), skip_count=zero.clone())
