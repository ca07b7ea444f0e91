"""Loss functions (``tpuic/train/loss.py``).

Torch ``nn.CrossEntropyLoss(weight=...)`` semantics, as the reference's
weighted CE (train.py:157-158): per-sample NLL scaled by the label's class
weight, normalised by the *sum of the applied weights*.  A validity mask
zeroes padded samples; label smoothing mixes the one-hot target with the
uniform one.  The inception path adds ``loss1 + 0.4 * loss2`` over main
and aux logits (train.py:48-52).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean weighted CE over valid samples (reference semantics).

    logits [B, C] (upcast to float32), labels [B] int, class_weights [C]
    or None, mask [B] (1 = valid) or None.  As in ``tpuic``, a label
    outside ``[0, C)`` has an empty one-hot: its NLL is 0 and, with no
    class weights, its weight is 1 (with class weights, 0)."""
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
    return torch.sum(w * nll) / torch.clamp(torch.sum(w), min=1e-12)


LOSS_IMPLS = ("reference", "fused")


def classification_loss(outputs, labels, *, class_weights=None, mask=None,
                        aux_weight: float = 0.4,
                        label_smoothing: float = 0.0,
                        impl: str = "reference") -> torch.Tensor:
    """Main loss, plus the inception aux term when ``outputs`` is a tuple
    (reference train.py:48-56).  ``impl='fused'`` runs the K1 kernels
    (``tpuic_torch/kernels/cross_entropy.py``), same numerics."""
    if impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss impl '{impl}'; available: {LOSS_IMPLS}")
    if impl == "fused":
        from tpuic_torch.kernels.cross_entropy import \
            fused_weighted_cross_entropy as ce_fn
    else:
        ce_fn = weighted_cross_entropy

    def ce(logits):
        return ce_fn(logits, labels, class_weights, mask, label_smoothing)

    if isinstance(outputs, tuple):
        logits, aux_logits = outputs
        return ce(logits) + aux_weight * ce(aux_logits)
    return ce(outputs)
