"""Classifier = backbone + MLP head (``tpuic/models/classifier.py``).

Re-design of reference nn/classifier.py:7-37: backbone and head are
separate submodules (``backbone``, ``head``), as in ``tpuic``, so a
``tpuic`` variables tree maps onto this module by name.  Inception-v3's
aux head (nn/classifier.py:22-23) surfaces as a second logits output in
train mode (``has_aux``), for the 0.4-weighted aux loss (train.py:48-52).

``drop_path_rates()`` and the forward's ``drop_masks`` pass the
backbone's drop-path draw sites through (``train/augment.py``);
``remat_dots`` runs a train-mode forward under the ``dots`` remat policy
(``models/remat.py``), the whole forward as ``tpuic``'s step-level
``jax.checkpoint`` wraps it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.models.layers import MLPHead
from tpuic_torch.models.remat import checkpointed


class Classifier(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int,
                 head_widths: Sequence[int] = (128, 64, 32), *,
                 has_aux: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.has_aux = has_aux
        self.remat_dots = False
        self.backbone = backbone
        self.head = MLPHead(backbone.num_features, num_classes, head_widths,
                            dtype=dtype, param_dtype=param_dtype,
                            device=resolve_device(device))

    def drop_path_rates(self) -> list:
        rates = getattr(self.backbone, "drop_path_rates", None)
        return rates() if rates is not None else []

    def forward(self, images: torch.Tensor, drop_masks=None):
        """images: [B, H, W, 3] (normalized).  Returns float32 logits
        [B, C]; with ``has_aux`` in train mode, (logits, aux_logits).
        ``drop_masks``: the backbone's drop-path draws (train mode)."""
        if self.remat_dots and self.training:
            return checkpointed(self._forward, images, drop_masks,
                                save_dots=True)
        return self._forward(images, drop_masks)

    def _forward(self, images: torch.Tensor, drop_masks=None):
        out = (self.backbone(images) if drop_masks is None
               else self.backbone(images, drop_masks=drop_masks))
        aux = None
        if isinstance(out, tuple):
            out, aux = out
        logits = self.head(out)
        if self.has_aux and self.training:
            return logits, aux
        return logits
