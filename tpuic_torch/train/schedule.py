"""Learning-rate schedules (``tpuic/train/schedule.py``).

Each schedule is a function of the optimizer step, a 0-d integer tensor,
and returns a 0-d float32 tensor on the step's device: the step stays on
the card, so reading the learning rate needs no host sync.  The
arithmetic is optax's (``piecewise_constant_schedule``,
``warmup_cosine_decay_schedule``, ``constant_schedule``), which the
reference schedules are built from, so the two agree step for step.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(t: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=t.device)


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float, steps_per_epoch: int) -> Schedule:
    """lr * gamma^(number of milestone epochs passed): torch
    ``MultiStepLR`` stepped per epoch (reference train.py:156, 166)."""
    boundaries = sorted({int(m) * steps_per_epoch for m in milestones})

    def schedule(t):
        v = _f32(t, base_lr)
        for b in boundaries:
            v = torch.where(t >= b, v * gamma, v)
        return v

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int,
                           total_epochs: int, steps_per_epoch: int,
                           end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_epochs``, then
    cosine decay to ``end_lr``: ``optax.warmup_cosine_decay_schedule``,
    whose ``decay_steps`` counts the warmup too."""
    warmup = max(warmup_epochs * steps_per_epoch, 1)
    total = max(total_epochs * steps_per_epoch, warmup_epochs *
                steps_per_epoch + 1)
    decay = total - warmup
    if decay <= 0:
        raise ValueError(f"cosine decay needs positive steps, got {decay}")
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr

    def schedule(t):
        # optax.linear_schedule(0, base_lr): (init - end) * frac + end.
        frac = 1.0 - torch.clamp(t, 0, warmup).float() / float(warmup)
        warm = (0.0 - base_lr) * frac + base_lr
        count = torch.clamp((t - warmup).float(), max=float(decay))
        cos = 0.5 * (1.0 + torch.cos(math.pi * count / float(decay)))
        main = base_lr * ((1.0 - alpha) * cos + alpha)
        return torch.where(t < warmup, warm, main).float()

    return schedule


def constant_schedule(base_lr: float) -> Schedule:
    return lambda t: _f32(t, base_lr)


def batch_scaled_warmup_schedule(base_lr: float, global_batch: int,
                                 base_batch: int, warmup_epochs: int,
                                 steps_per_epoch: int,
                                 main: Schedule) -> Schedule:
    """Goyal linear-scaling warmup (arXiv:1706.02677): a linear ramp from
    ``base_lr`` to ``base_lr * global_batch / base_batch`` over
    ``warmup_epochs``, then ``main`` (built at the scaled peak)."""
    peak = base_lr * (float(global_batch) / float(base_batch))
    warmup = max(1, int(warmup_epochs) * int(steps_per_epoch))

    def schedule(t):
        frac = torch.clamp(t.float() / warmup, 0.0, 1.0)
        ramp = base_lr + (peak - base_lr) * frac
        return torch.where(t < warmup, ramp, main(t)).float()

    return schedule
