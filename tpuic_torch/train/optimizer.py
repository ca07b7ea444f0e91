"""Optimizers (``tpuic/train/optimizer.py``), with optax's semantics.

``make_optimizer(cfg, ...)`` returns an :class:`Optimizer` for
``cfg.optimizer``:

- ``adam`` (the reference default, train.py:127) as ``optax.adam``, or
  ``optax.adamw`` when ``weight_decay`` is set: eps outside the square
  root, bias correction with ``t = count + 1``, decoupled decay;
- ``sgd`` as ``optax.sgd(lr, momentum=0.9)``, after
  ``add_decayed_weights`` when ``weight_decay`` is set;
- ``lars`` / ``lamb`` as optax chains them, in plain torch; with
  ``fused_optimizer`` they run the K2 kernels instead
  (``tpuic_torch/kernels/optimizer_update.py``);
- ``grad_clip_norm`` as ``optax.clip_by_global_norm`` in front.

The state is a plain :class:`OptState`: ``count`` (updates applied, the
schedule clock) as a 0-d int32 tensor on the parameters' device, and the
moment lists ``trace`` (sgd, lars) or ``mu``/``nu`` (adam, lamb), one
float32 tensor per parameter in ``model.parameters()`` order.  The weight
carrier (``tpuic_torch.checkpoint.load_jax_opt_state``) fills it from a
``tpuic`` optimizer state.

``Optimizer.update(params, grads, state, finite)`` updates parameters and
state in place, and only where the 0-d bool tensor ``finite`` is true:
the train step's non-finite guard, applied on the device.  ``count``
advances by ``finite``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from tpuic_torch.config import OptimConfig
from tpuic_torch.kernels import optimizer_update as K2
from tpuic_torch.train import schedule as sched

OPTIMIZERS = ("adam", "sgd", "lars", "lamb")


def make_schedule(cfg: OptimConfig, steps_per_epoch: int, total_epochs: int,
                  global_batch: int = 0) -> sched.Schedule:
    """The config's LR schedule in optimizer-step time (``tpuic``'s
    ``make_schedule``): the Goyal linear-scaling warmup when
    ``base_batch_size`` and ``global_batch`` are set, else warmup + cosine,
    milestones, or a constant."""
    if cfg.base_batch_size and global_batch:
        peak = cfg.learning_rate * global_batch / cfg.base_batch_size
        if cfg.milestones and not cfg.warmup_epochs:
            main = sched.multistep_schedule(peak, cfg.milestones, cfg.gamma,
                                            steps_per_epoch)
        elif cfg.warmup_epochs > 0:
            main = sched.warmup_cosine_schedule(peak, cfg.warmup_epochs,
                                                total_epochs, steps_per_epoch)
        else:
            main = sched.constant_schedule(peak)
        return sched.batch_scaled_warmup_schedule(
            cfg.learning_rate, global_batch, cfg.base_batch_size,
            max(1, cfg.warmup_epochs), steps_per_epoch, main)
    if cfg.warmup_epochs > 0:
        return sched.warmup_cosine_schedule(cfg.learning_rate,
                                            cfg.warmup_epochs, total_epochs,
                                            steps_per_epoch)
    if cfg.milestones:
        return sched.multistep_schedule(cfg.learning_rate, cfg.milestones,
                                        cfg.gamma, steps_per_epoch)
    return sched.constant_schedule(cfg.learning_rate)


def rewarm_scale(start_step: int, rewarm_steps: int) -> sched.Schedule:
    """LR factor ramping linearly 1/N -> 1 over ``rewarm_steps`` steps from
    ``start_step``, then 1 (the Trainer's post-rollback re-entry)."""
    n = max(1, int(rewarm_steps))
    s0 = int(start_step)

    def scale(t):
        return torch.clamp((t - s0 + 1).float() / n, 1.0 / n, 1.0)

    return scale


@dataclasses.dataclass
class OptState:
    """``count``: updates applied (0-d int32); ``trace`` (sgd, lars) or
    ``mu``/``nu`` (adam, lamb): one float32 tensor per parameter."""

    count: torch.Tensor
    trace: Optional[List[torch.Tensor]] = None
    mu: Optional[List[torch.Tensor]] = None
    nu: Optional[List[torch.Tensor]] = None


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all tensors together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [t.float() for t in tensors])))


def _where_(finite, dsts, news) -> None:
    for d, n in zip(dsts, news):
        d.copy_(torch.where(finite, n, d))


def _trust(w, u, coeff: float):
    pn, un = torch.linalg.vector_norm(w), torch.linalg.vector_norm(u)
    return torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn),
                       coeff * pn / un)


class Optimizer:
    """One optimizer kind over a parameter list; see the module docstring.
    ``kind`` is one of ``adam``, ``adamw``, ``sgd``, ``lars``, ``lamb``,
    ``fused_lars``, ``fused_lamb``; ``lr`` a schedule of the count."""

    KINDS = ("adam", "adamw", "sgd", "lars", "lamb", "fused_lars",
             "fused_lamb")

    def __init__(self, kind: str, lr: Callable, *, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float = 0.0) -> None:
        if kind not in self.KINDS:
            raise ValueError(f"unknown optimizer kind '{kind}'; available: "
                             f"{self.KINDS}")
        self.kind, self.lr = kind, lr
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.trust_coefficient = float(trust_coefficient)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.clip_norm = float(clip_norm)
        self._table = K2.LeafTable()

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        dev = params[0].device

        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                    for p in params]

        count = torch.zeros((), dtype=torch.int32, device=dev)
        if self.kind in ("sgd", "lars", "fused_lars"):
            return OptState(count, trace=zeros())
        return OptState(count, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: OptState,
               finite: torch.Tensor,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """One step in place where ``finite``; ``grad_norm`` (the global
        norm of ``grads``) saves recomputing it for clipping."""
        lr = self.lr(state.count).float()
        if self.clip_norm:
            gn = global_norm(grads) if grad_norm is None else grad_norm
            trigger = gn < self.clip_norm
            grads = [torch.where(trigger, g, (g / gn) * self.clip_norm)
                     for g in grads]
        getattr(self, "_" + self.kind)(params, grads, state, lr, finite)
        state.count.add_(finite.to(torch.int32))

    # -- plain kinds: optax's chains, out of place, then a select ---------
    def _adam_dir(self, grads, state, finite):
        t = (state.count + 1).float()
        bc1 = 1.0 - torch.pow(torch.full_like(t, self.b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, self.b2), t)
        mus = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads,
                                                               state.mu)]
        nus = [(1 - self.b2) * (g * g) + self.b2 * v
               for g, v in zip(grads, state.nu)]
        dirs = [(m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                for m, v in zip(mus, nus)]
        _where_(finite, state.mu, mus)
        _where_(finite, state.nu, nus)
        return dirs

    def _apply(self, params, updates, finite) -> None:
        _where_(finite, params, [p + u for p, u in zip(params, updates)])

    def _adam(self, params, grads, state, lr, finite) -> None:
        dirs = self._adam_dir(grads, state, finite)
        self._apply(params, [-lr * u for u in dirs], finite)

    def _adamw(self, params, grads, state, lr, finite) -> None:
        dirs = self._adam_dir(grads, state, finite)
        self._apply(params, [-lr * (u + self.weight_decay * p)
                             for u, p in zip(dirs, params)], finite)

    def _sgd(self, params, grads, state, lr, finite) -> None:
        if self.weight_decay:
            grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        trace = [g + self.momentum * t for g, t in zip(grads, state.trace)]
        _where_(finite, state.trace, trace)
        self._apply(params, [-lr * t for t in trace], finite)

    def _lars(self, params, grads, state, lr, finite) -> None:
        upd = []
        for p, g in zip(params, grads):
            u = g + self.weight_decay * p
            upd.append(-lr * (u * _trust(p, u, self.trust_coefficient)))
        trace = [u + self.momentum * t for u, t in zip(upd, state.trace)]
        _where_(finite, state.trace, trace)
        self._apply(params, trace, finite)

    def _lamb(self, params, grads, state, lr, finite) -> None:
        dirs = self._adam_dir(grads, state, finite)
        upd = []
        for p, u in zip(params, dirs):
            u = u + self.weight_decay * p
            upd.append(-lr * (u * _trust(p, u, 1.0)))
        self._apply(params, upd, finite)

    # -- fused kinds: the K2 kernels (plain versions on the CPU) ----------
    def _fused_lars(self, params, grads, state, lr, finite) -> None:
        K2.lars_update(list(params), list(grads), state.trace, lr, finite,
                       weight_decay=self.weight_decay,
                       trust_coefficient=self.trust_coefficient,
                       momentum=self.momentum, table=self._table)

    def _fused_lamb(self, params, grads, state, lr, finite) -> None:
        K2.lamb_update(list(params), list(grads), state.mu, state.nu,
                       state.count, lr, finite, b1=self.b1, b2=self.b2,
                       eps=self.eps, weight_decay=self.weight_decay,
                       table=self._table)


def make_optimizer(cfg: OptimConfig, steps_per_epoch: int = 1,
                   total_epochs: int = 100,
                   global_batch: int = 0) -> Optimizer:
    """``tpuic``'s ``make_optimizer`` for one device: the schedule, the
    optimizer kind, and gradient clipping.  Gradient accumulation and
    ``freeze_backbone`` are not ported and raise."""
    if cfg.grad_accum_steps > 1:
        raise NotImplementedError("grad_accum_steps > 1 is not yet ported "
                                  "to tpuic_torch")
    if cfg.freeze_backbone:
        raise NotImplementedError("freeze_backbone is not yet ported to "
                                  "tpuic_torch")
    lr = make_schedule(cfg, steps_per_epoch, total_epochs,
                       global_batch=global_batch)
    name = cfg.optimizer.lower()
    clip = cfg.grad_clip_norm
    wd = cfg.weight_decay
    if name == "adam":
        return Optimizer("adamw" if wd else "adam", lr, weight_decay=wd,
                         clip_norm=clip)
    if name == "sgd":
        return Optimizer("sgd", lr, weight_decay=wd, momentum=0.9,
                         clip_norm=clip)
    if name == "lars":
        return Optimizer("fused_lars" if cfg.fused_optimizer else "lars", lr,
                         weight_decay=wd, momentum=cfg.lars_momentum,
                         trust_coefficient=cfg.lars_trust_coefficient,
                         clip_norm=clip)
    if name == "lamb":
        return Optimizer("fused_lamb" if cfg.fused_optimizer else "lamb", lr,
                         weight_decay=wd, b1=cfg.lamb_b1, b2=cfg.lamb_b2,
                         eps=cfg.lamb_eps, clip_norm=clip)
    raise ValueError(f"unknown optimizer '{cfg.optimizer}'")
