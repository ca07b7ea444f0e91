"""Shared model building blocks (``tpuic/models/layers.py``).

The MLP classifier head is the reference's
``in_features -> 128 -> ReLU -> 64 -> ReLU -> 32 -> ReLU -> num_classes``
head (nn/classifier.py:26-34).  Like the flax modules, every layer keeps
its parameters in ``param_dtype`` and computes in ``dtype``.

Convolutions and BN here take and return NCHW tensors; the ResNet keeps
them in channels_last memory (an NCHW view of NHWC data), so the
reference's NHWC layout never needs a copy.  BN takes flax's momentum
convention (``0.9`` == torch's ``0.1``), torch's default eps, and flax's
biased running-variance update in train mode.  ``LayerNorm`` (the ViT's)
takes flax's eps 1e-6 and normalises in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

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
    """BatchNorm over an NCHW tensor with flax's semantics, returning the
    compute dtype.

    Eval mode is ``nn.BatchNorm2d``'s in float32: the running statistics.
    Train mode normalises with the batch mean and the *biased* batch
    variance over (N, H, W) and updates the buffers as flax does,
    ``ra = momentum * ra + (1 - momentum) * batch_stat``, with that same
    biased variance (``nn.BatchNorm2d`` would put the unbiased one into
    ``running_var``, n/(n-1) away from flax's).

    ``f32_stats=False`` is flax's ``force_float32_reductions=False``
    (``tpuic/models/layers.py:44-60``, the ``--bn-bf16-stats``
    experiment): in train mode the batch mean and ``E[x^2] - E[x]^2`` are
    taken in the compute dtype and the centring happens there too; the
    affine and the running statistics stay float32."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=torch.float32, f32_stats: bool = True,
                 device=None) -> None:
        super().__init__(features, eps=eps, momentum=1.0 - momentum,
                         dtype=param_dtype, device=resolve_device(device))
        self.flax_momentum = momentum
        self.compute_dtype = dtype
        self.f32_stats = f32_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.running_mean.dtype == torch.float32:
                return super().forward(x.float()).to(self.compute_dtype)
            # bf16 statistics and affine (the serve ladder's bf16 rung):
            # the same function in float32.
            return F.batch_norm(x.float(), self.running_mean.float(),
                                self.running_var.float(),
                                self.weight.float(), self.bias.float(),
                                False, 0.0, self.eps).to(self.compute_dtype)
        if self.f32_stats:
            x = x.float()
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        else:
            x = x.to(self.compute_dtype)
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp(torch.square(x).mean(dim=(0, 2, 3))
                              - torch.square(mean), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y.to(self.compute_dtype)


def batch_norm(features: int, *, momentum: float = 0.9, eps: float = 1e-5,
               dtype=torch.float32, param_dtype=torch.float32,
               f32_stats: bool = True, device=None) -> BatchNorm:
    """BatchNorm with torch-default hyperparameters (flax momentum 0.9)."""
    return BatchNorm(features, momentum=momentum, eps=eps, dtype=dtype,
                     param_dtype=param_dtype, f32_stats=f32_stats,
                     device=device)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last dim: eps 1e-6 (flax's default,
    not torch's 1e-5), ``weight``/``bias`` for flax's ``scale``/``bias``,
    normalising in float32 and returning the compute dtype."""

    def __init__(self, features: int, *, eps: float = 1e-6,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.features, self.eps = int(features), float(eps)
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.features,), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/flax ``"SAME"`` padding of one spatial dim: the output is
    ``ceil(size / stride)`` and an odd total puts the extra row or column
    after (bottom, right), as ``lax.padtype_to_pads`` does."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with four-sided padding ``((top, bottom), (left,
    right))`` or ``"SAME"`` (flax's, asymmetric at stride 2), an optional
    bias and groups (``groups=features`` is a depthwise conv, flax's
    ``feature_group_count``), computing in ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides: int = 1, padding: Union[Padding, str] = 0, *,
                 groups: int = 1, bias: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__(in_features, features, kernel_size, stride=strides,
                         padding=0, groups=groups, bias=bias,
                         dtype=param_dtype, device=resolve_device(device))
        if isinstance(padding, str):
            if padding != "SAME":
                raise ValueError(f"padding {padding!r}: only 'SAME' or "
                                 "explicit pads")
            self.pads = padding
        else:
            self.pads = norm_padding(padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.pads == "SAME":
            (kh, kw), (sh, sw) = self.kernel_size, self.stride
            pads = (same_pads(x.shape[2], kh, sh),
                    same_pads(x.shape[3], kw, sw))
        else:
            pads = self.pads
        (pt, pb), (pl, pr) = pads
        x, w = x.to(dt), self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if pt == pb and pl == pr:
            return F.conv2d(x, w, b, self.stride, (pt, pl), 1, self.groups)
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b, self.stride, 0, 1,
                        self.groups)


class ConvBN(nn.Module):
    """``tpuic``'s ``inception.ConvBN`` (``tpuic/models/inception.py:29-46``):
    a bias-free conv (``conv``), BN (``bn``, eps 1e-3 by default, float32
    statistics) and ReLU, on NCHW views."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1, padding: Padding = 0, *,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-3,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, strides,
                         padding, dtype=dtype, param_dtype=param_dtype,
                         device=device)
        self.bn = batch_norm(features, momentum=bn_momentum, eps=bn_eps,
                             dtype=dtype, param_dtype=param_dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


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
