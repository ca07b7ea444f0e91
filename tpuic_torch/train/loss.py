"""Loss functions (``tpuic/train/loss.py``).

Torch ``nn.CrossEntropyLoss(weight=...)`` semantics, as the reference's
weighted CE (train.py:157-158): per-sample NLL scaled by the label's class
weight, normalised by the *sum of the applied weights*.  A validity mask
zeroes padded samples; label smoothing mixes the one-hot target with the
uniform one.  The inception path adds ``loss1 + 0.4 * loss2`` over main
and aux logits (train.py:48-52).

**The global batch.**  ``tpuic`` divides ``sum(w * nll)`` by the
``sum(w)`` of the *global* batch: its step is one program over the
sharded batch (``tpuic/train/loss.py:50``; the fused impl passes that
global scale into its backward kernel under ``shard_map``,
``tpuic/kernels/cross_entropy.py:214-230``).  The port's data-parallel
step runs one process per shard, and DDP takes the mean of their
gradients, so ``classification_loss(..., data_parallel=True)`` returns
each rank's share ``sum_local(w * nll) / all_reduce(sum(w)) * world``:
the mean of those over ranks is the global loss, and the mean of their
gradients its gradient.  A per-rank mean would weight each rank's
samples by that rank's own ``sum(w)``, a different gradient whenever
class weights or labels differ between ranks.

**Mixup / CutMix** (``tpuic/train/step.py:346-356``): the loss is
``lam * L(y) + (1 - lam) * L(y_perm)``, each term with its own
normaliser: class weights follow the labels, so ``L(y_perm)``'s global
``sum(w)`` is not ``L(y)``'s.  In a data-parallel step the two sums go
through one all-reduce, stacked.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None,
                           label_smoothing: float = 0.0,
                           weight_sum: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mean weighted CE over valid samples (reference semantics).

    logits [B, C] (upcast to float32), labels [B] int, class_weights [C]
    or None, mask [B] (1 = valid) or None.  As in ``tpuic``, a label
    outside ``[0, C)`` has an empty one-hot: its NLL is 0 and, with no
    class weights, its weight is 1 (with class weights, 0).
    ``weight_sum`` (a 0-d tensor) replaces this batch's ``sum(w)`` as the
    divisor: the global batch's, in a data-parallel step."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (classes[None, :] == labels[:, None].long()).float()
    target = onehot
    if label_smoothing > 0.0:
        target = onehot * (1.0 - label_smoothing) + \
            label_smoothing / num_classes
    nll = -torch.sum(target * logp, dim=-1)  # [B]
    if class_weights is not None:
        w = torch.sum(onehot * class_weights.float()[None, :], dim=-1)
    else:
        w = torch.ones_like(nll)
    if mask is not None:
        w = w * mask.float()
    if weight_sum is None:
        weight_sum = torch.sum(w)
    return torch.sum(w * nll) / torch.clamp(weight_sum, min=1e-12)


def _weight_sum(labels, num_classes: int, class_weights, mask,
                impl: str) -> torch.Tensor:
    """This batch's ``sum(w)`` as ``impl`` applies it (a label outside
    ``[0, C)`` weighs 1 in the reference impl without class weights, 0 in
    the fused one)."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (classes[None, :] == labels[:, None].long()).float()
    if class_weights is not None:
        w = torch.sum(onehot * class_weights.float()[None, :], dim=-1)
    elif impl == "fused":
        w = torch.sum(onehot, dim=-1)
    else:
        w = torch.ones(labels.shape, device=labels.device)
    if mask is not None:
        w = w * mask.float()
    return torch.sum(w)


LOSS_IMPLS = ("reference", "fused")


def classification_loss(outputs, labels, *, class_weights=None, mask=None,
                        aux_weight: float = 0.4,
                        label_smoothing: float = 0.0,
                        impl: str = "reference",
                        data_parallel: bool = False,
                        mix=None) -> torch.Tensor:
    """Main loss, plus the inception aux term when ``outputs`` is a tuple
    (reference train.py:48-56).  ``impl='fused'`` runs the K1 kernels
    (``tpuic_torch/kernels/cross_entropy.py``), same numerics.

    ``mix=(labels_mix, lam)``: ``lam * loss(labels) + (1 - lam) *
    loss(labels_mix)`` (mixup, CutMix), each with its own ``sum(w)``.

    ``data_parallel=True`` in a process group of more than one process:
    this rank's share of the global-batch loss (module docstring), one
    all-reduce of the ``sum(w)`` of each label set serving the main and
    the aux logits, which share labels and mask."""
    if impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss impl '{impl}'; available: {LOSS_IMPLS}")
    if impl == "fused":
        from tpuic_torch.kernels.cross_entropy import \
            fused_weighted_cross_entropy as ce_fn
    else:
        ce_fn = weighted_cross_entropy

    world = dist.get_world_size() if (data_parallel
                                      and dist.is_initialized()) else 1
    label_sets = [labels] if mix is None else [labels, mix[0]]
    weight_sums = [None] * len(label_sets)
    if world > 1:
        logits = outputs[0] if isinstance(outputs, tuple) else outputs
        sums = torch.stack([_weight_sum(y, logits.shape[-1], class_weights,
                                        mask, impl) for y in label_sets])
        dist.all_reduce(sums)
        weight_sums = list(sums.unbind())

    def loss_for(y, weight_sum):
        def ce(logits):
            return ce_fn(logits, y, class_weights, mask, label_smoothing,
                         weight_sum)

        if isinstance(outputs, tuple):
            logits, aux_logits = outputs
            return ce(logits) + aux_weight * ce(aux_logits)
        return ce(outputs)

    loss = loss_for(labels, weight_sums[0])
    if mix is not None:
        lam = mix[1]
        loss = lam * loss + (1.0 - lam) * loss_for(mix[0], weight_sums[1])
    return loss * world if world > 1 else loss
