"""Switch-style top-1 mixture-of-experts MLP (``tpuic/models/moe.py``).

Routing groups are batch rows: capacity and the dispatch one-hots are per
image, ``C = ceil(capacity_factor * N / E)``, so the dispatch tensor is
``[B, N, E, C]`` and a row's routing does not depend on the batch it
rides in.  The router runs in float32 from ``x.float()``: softmax, then
``gate = max``, ``expert = argmax`` (the first maximum on a tie, as
``jnp.argmax``).  A token's queue slot is its cumulative count along N
within its row; tokens past ``C`` are dropped (they contribute zero and
the block's residual carries them through).  Dispatch, the experts
(exact GELU) and the combine run in the compute dtype; ``combine`` is
``disp * gate`` cast after the multiply, as ``tpuic`` casts it.

Both one-hots are comparisons against an ``arange``: ``tpuic`` relies on
``nn.one_hot(-1)`` and ``nn.one_hot(>= C)`` being all-zero (that is the
drop mask), which ``F.one_hot`` refuses, and ``F.one_hot`` checks its
input's range on the host, which would sync inside the engine's CUDA
graph capture.

The parameters keep ``tpuic``'s layouts and names: ``router`` ``(D, E)``,
``w1`` ``(E, D, H)``, ``b1`` ``(E, H)``, ``w2`` ``(E, H, D)``, ``b2``
``(E, D)``.

Load balancing (Switch eq. 4): a train-mode forward records its router
``(probs, onehot)`` on the layer (``tpuic``'s ``sow``), except inside a
backward recompute (``models/remat.py``); the train step takes them with
:func:`take_router_stats` and adds ``moe_aux_weight`` times the mean of
:func:`switch_aux_loss` over the layers to the task loss.  The layer
draws nothing.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpuic_torch.models.remat import recomputing


def switch_aux_loss(probs: torch.Tensor, onehot: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``E * sum_e f_e * p_e`` over ``[B, N, E]`` router probabilities and
    top-1 one-hots; ``mask`` ([B] validity) excludes padded samples from
    both the routed fractions and the mean probabilities."""
    E = probs.shape[-1]
    if mask is None:
        frac = torch.mean(onehot, dim=(0, 1))
        mean_prob = torch.mean(probs, dim=(0, 1))
    else:
        w = mask.float()[:, None, None]
        denom = torch.clamp(torch.sum(w) * probs.shape[1], min=1.0)
        frac = torch.sum(onehot * w, dim=(0, 1)) / denom
        mean_prob = torch.sum(probs * w, dim=(0, 1)) / denom
    return E * torch.sum(frac * mean_prob)


def router_sums(probs: torch.Tensor, onehot: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[2E + 1]``: the masked one-hot sums, the masked probability sums
    and the masked token count of one layer, the quantities a data-parallel
    step all-reduces (values only)."""
    if mask is None:
        w = torch.ones(probs.shape[0], 1, 1, dtype=torch.float32,
                       device=probs.device)
    else:
        w = mask.float()[:, None, None]
    return torch.cat([torch.sum(onehot * w, dim=(0, 1)),
                      torch.sum(probs.detach() * w, dim=(0, 1)),
                      (torch.sum(w) * probs.shape[1]).reshape(1)])


def global_aux_term(probs: torch.Tensor, onehot: torch.Tensor,
                    mask: Optional[torch.Tensor], sums: torch.Tensor,
                    world: int) -> torch.Tensor:
    """This rank's share of the global-batch ``switch_aux_loss``:
    ``E * sum_e (F_e / T) * (p_local_e / T) * world`` where ``F`` and ``T``
    are the global one-hot sums and token count (``sums``, all-reduced
    :func:`router_sums`).  Gradient flows through this rank's
    probabilities alone, so DDP's mean over ranks is the global
    gradient, and the mean of the ranks' values is the global loss."""
    E = probs.shape[-1]
    w = (torch.ones(probs.shape[0], 1, 1, dtype=torch.float32,
                    device=probs.device) if mask is None
         else mask.float()[:, None, None])
    p_local = torch.sum(probs * w, dim=(0, 1))
    denom = torch.clamp(sums[2 * E], min=1.0)
    return E * torch.sum((sums[:E] / denom) * (p_local / denom)) * world


class SwitchMoEMlp(nn.Module):
    """Top-1 routed expert MLP over ``[B, N, D]`` tokens (see the module
    docstring)."""

    def __init__(self, hidden: int, num_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        E, D, H = num_experts, hidden, hidden * mlp_ratio
        kw = dict(dtype=param_dtype, device=device)
        self.num_experts, self.capacity_factor = E, float(capacity_factor)
        self.compute_dtype = dtype
        self.router = nn.Parameter(torch.zeros(D, E, **kw))
        self.w1 = nn.Parameter(torch.zeros(E, D, H, **kw))
        self.b1 = nn.Parameter(torch.zeros(E, H, **kw))
        self.w2 = nn.Parameter(torch.zeros(E, H, D, **kw))
        self.b2 = nn.Parameter(torch.zeros(E, D, **kw))
        self.router_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def capacity(self, tokens: int) -> int:
        return int(math.ceil(self.capacity_factor * tokens
                             / self.num_experts))

    def route(self, x: torch.Tensor):
        """``(probs, gate, onehot, disp)`` of ``[B, N, D]`` tokens: float32
        router probabilities ``[B, N, E]``, the top-1 gate ``[B, N]``, its
        one-hot ``[B, N, E]`` and the dispatch ``[B, N, E, C]``."""
        E, C = self.num_experts, self.capacity(x.shape[1])
        logits = torch.einsum("bnd,de->bne", x.float(), self.router.float())
        probs = torch.softmax(logits, dim=-1)
        gate = torch.amax(probs, dim=-1)
        idx = torch.argmax(probs, dim=-1)
        experts = torch.arange(E, device=x.device)
        onehot = (idx[..., None] == experts).float()
        # 1-based queue position within the row; the 0-based slot is -1
        # for an unrouted pair and >= C past capacity: no slot matches.
        pos = torch.cumsum(onehot, dim=1) * onehot
        slots = torch.arange(C, device=x.device, dtype=torch.float32)
        disp = ((pos - 1.0)[..., None] == slots).float()
        return probs, gate, onehot, disp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        probs, gate, onehot, disp = self.route(x)
        if self.training and not recomputing():
            self.router_stats = (probs, onehot)
        dt = self.compute_dtype
        expert_in = torch.einsum("bnec,bnd->becd", disp.to(dt), x.to(dt))
        h = torch.einsum("becd,edh->bech", expert_in, self.w1.to(dt))
        h = F.gelu(h + self.b1.to(dt)[None, :, None, :], approximate="none")
        out = torch.einsum("bech,ehd->becd", h, self.w2.to(dt))
        out = out + self.b2.to(dt)[None, :, None, :]
        combine = (disp * gate[..., None, None]).to(dt)
        return torch.einsum("bnec,becd->bnd", combine, out)


def moe_layers(model: nn.Module) -> List[SwitchMoEMlp]:
    return [m for m in model.modules() if isinstance(m, SwitchMoEMlp)]


def take_router_stats(layers) -> list:
    """The ``(probs, onehot)`` each layer recorded in the last train-mode
    forward, cleared; raises when a layer recorded none (a silently
    missing layer would drop its load-balancing loss)."""
    out = []
    for layer in layers:
        if layer.router_stats is None:
            raise RuntimeError("a SwitchMoEMlp recorded no router stats in "
                               "this forward")
        out.append(layer.router_stats)
        layer.router_stats = None
    return out


def routing_summary(onehot: torch.Tensor, capacity: int) -> torch.Tensor:
    """``[E + 1]`` on the device from a layer's ``[B, N, E]`` top-1
    one-hot: each expert's share of the tokens routed to it, then the
    share of tokens dropped past ``capacity``."""
    pos = torch.cumsum(onehot, dim=1) * onehot
    n = float(onehot.shape[0] * onehot.shape[1])
    return torch.cat([onehot.sum(dim=(0, 1)) / n,
                      (pos > capacity).sum().float().reshape(1) / n])
