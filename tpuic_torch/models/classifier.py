"""Classifier = backbone + MLP head (``tpuic/models/classifier.py``).

Re-design of reference nn/classifier.py:7-37: backbone and head are
separate submodules (``backbone``, ``head``), as in ``tpuic``, so a
``tpuic`` variables tree maps onto this module by name.
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
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.backbone = backbone
        self.head = MLPHead(backbone.num_features, num_classes, head_widths,
                            dtype=dtype, param_dtype=param_dtype,
                            device=resolve_device(device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] (normalized). Returns float32 logits [B, C]."""
        return self.head(self.backbone(images))
