"""Shared model building blocks (``tpuic/models/layers.py``).

The MLP classifier head is the reference's
``in_features -> 128 -> ReLU -> 64 -> ReLU -> 32 -> ReLU -> num_classes``
head (nn/classifier.py:26-34).  Like the flax modules, every layer keeps
its parameters in ``param_dtype`` and computes in ``dtype``.

Convolutions and BN here take and return NCHW tensors; the ResNet keeps
them in channels_last memory (an NCHW view of NHWC data), so the
reference's NHWC layout never needs a copy.  BN takes flax's momentum
convention (``0.9`` == torch's ``0.1``) and torch's default eps.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.kernels.conv_bn_relu import Padding, norm_padding


class MLPHead(nn.Module):
    """Reference nn/classifier.py:26-34 head: widths (128, 64, 32) + ReLU,
    then ``out`` in float32."""

    def __init__(self, in_features: int, num_classes: int,
                 widths: Sequence[int] = (128, 64, 32), *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.widths = tuple(int(w) for w in widths)
        self.compute_dtype = dtype
        dims = (int(in_features),) + self.widths
        for i, w in enumerate(self.widths):
            setattr(self, f"fc{i}", nn.Linear(dims[i], w, dtype=param_dtype,
                                              device=device))
        self.out = nn.Linear(dims[-1], num_classes, dtype=param_dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        for i in range(len(self.widths)):
            fc = getattr(self, f"fc{i}")
            x = F.relu(F.linear(x.to(dt), fc.weight.to(dt), fc.bias.to(dt)))
        return F.linear(x.float(), self.out.weight.float(),
                        self.out.bias.float())


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` over an NCHW tensor, normalising in float32 and
    returning the compute dtype."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__(features, eps=eps, momentum=1.0 - momentum,
                         dtype=param_dtype, device=resolve_device(device))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.compute_dtype)


def batch_norm(features: int, *, momentum: float = 0.9, eps: float = 1e-5,
               dtype=torch.float32, param_dtype=torch.float32,
               device=None) -> BatchNorm:
    """BatchNorm with torch-default hyperparameters (flax momentum 0.9)."""
    return BatchNorm(features, momentum=momentum, eps=eps, dtype=dtype,
                     param_dtype=param_dtype, device=device)


class Conv(nn.Conv2d):
    """Bias-free ``nn.Conv2d`` with four-sided padding
    ``((top, bottom), (left, right))`` and a compute dtype."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, padding: Padding = 0, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__(in_features, features, kernel_size, stride=strides,
                         padding=0, bias=False, dtype=param_dtype,
                         device=resolve_device(device))
        self.pads = norm_padding(padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        (pt, pb), (pl, pr) = self.pads
        x, w = x.to(dt), self.weight.to(dt)
        if pt == pb and pl == pr:
            return F.conv2d(x, w, None, self.stride, (pt, pl))
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, None, self.stride)


def conv3x3(in_features: int, features: int, strides: int = 1, *,
            dtype=torch.float32, param_dtype=torch.float32,
            device=None) -> Conv:
    return Conv(in_features, features, 3, strides, 1, dtype=dtype,
                param_dtype=param_dtype, device=device)


def conv1x1(in_features: int, features: int, strides: int = 1, *,
            dtype=torch.float32, param_dtype=torch.float32,
            device=None) -> Conv:
    return Conv(in_features, features, 1, strides, 0, dtype=dtype,
                param_dtype=param_dtype, device=device)
