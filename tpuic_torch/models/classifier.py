"""Classifier = backbone + MLP head (``tpuic/models/classifier.py``).

Re-design of reference nn/classifier.py:7-37: backbone and head are
separate submodules (``backbone``, ``head``), as in ``tpuic``, so a
``tpuic`` variables tree maps onto this module by name.  Inception-v3's
aux head (nn/classifier.py:22-23) surfaces as a second logits output in
train mode (``has_aux``), for the 0.4-weighted aux loss (train.py:48-52).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.models.layers import MLPHead


class Classifier(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int,
                 head_widths: Sequence[int] = (128, 64, 32), *,
                 has_aux: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.has_aux = has_aux
        self.backbone = backbone
        self.head = MLPHead(backbone.num_features, num_classes, head_widths,
                            dtype=dtype, param_dtype=param_dtype,
                            device=resolve_device(device))

    def forward(self, images: torch.Tensor):
        """images: [B, H, W, 3] (normalized).  Returns float32 logits
        [B, C]; with ``has_aux`` in train mode, (logits, aux_logits)."""
        out = self.backbone(images)
        aux = None
        if isinstance(out, tuple):
            out, aux = out
        logits = self.head(out)
        if self.has_aux and self.training:
            return logits, aux
        return logits
