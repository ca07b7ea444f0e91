"""EfficientNet B0-B7 (``tpuic/models/efficientnet.py``).

MBConv blocks (expand 1x1 -> depthwise kxk -> squeeze-excite -> project
1x1) with the paper's compound width and depth scaling (Tan & Le 2019)
and swish activations, under the flax module names (``stem_conv``,
``block{stage}_{repeat}.expand_conv``, ``.dw_conv``, ``.se.reduce``,
``.se.expand``, ``.project_conv``, ``head_conv``, each ``*_bn``), so a
``tpuic`` variables tree carries across by name.

- Convolutions pad TF-style ``"SAME"``, asymmetric at stride 2 (the extra
  row and column at the bottom and right), as flax and the
  efficientnet_pytorch package do; depthwise convs are ``groups=mid``.
- The SE width is ``max(1, int(in_features * 0.25))`` of the *block's
  input*; its two 1x1 convs carry a bias.  BN eps is 1e-3.
- ``drop_path_rate`` is ``tpuic``'s stochastic depth (0.2 by default):
  the per-sample drop needs the train step's RNG plumbing, which is not
  ported (ROADMAP §1 item 8), so a train-mode forward with a rate above
  0 raises.  Eval mode (serving, predict) and train-mode BN at rate 0
  are ported.

Images come in NHWC ``[B, H, W, 3]``; the backbone returns float32 pooled
features ``[B, num_features]``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.models.layers import Conv, batch_norm

# (expand_ratio, channels, num_blocks, stride, kernel): the B0 base.
_BASE_BLOCKS: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# name -> (width_mult, depth_mult, dropout): the published compound
# scaling coefficients.
_SCALING = {
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5),
    "b7": (2.0, 3.1, 0.5),
}


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, se_features: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        kw = dict(bias=True, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        self.reduce = Conv(features, se_features, 1, **kw)
        self.expand = Conv(se_features, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 expand_ratio: int, strides: int, kernel: int,
                 se_ratio: float = 0.25,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-3, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        bn = partial(batch_norm, momentum=bn_momentum, eps=bn_eps, **kw)
        mid = in_features * expand_ratio
        self.residual = strides == 1 and in_features == out_features
        if expand_ratio != 1:
            self.expand_conv = Conv(in_features, mid, 1, **kw)
            self.expand_bn = bn(mid)
        self.dw_conv = Conv(mid, mid, kernel, strides, "SAME", groups=mid,
                            **kw)
        self.dw_bn = bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(in_features * se_ratio)),
                                **kw)
        self.project_conv = Conv(mid, out_features, 1, **kw)
        self.project_bn = bn(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if hasattr(self, "expand_conv"):
            y = F.silu(self.expand_bn(self.expand_conv(y)))
        y = F.silu(self.dw_bn(self.dw_conv(y)))
        y = self.project_bn(self.project_conv(self.se(y)))
        if self.residual:
            y = y + x
        return y


class EfficientNet(nn.Module):
    """Returns float32 pooled features ``[B, num_features]``."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 drop_path_rate: float = 0.2, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-3, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        bn = partial(batch_norm, momentum=bn_momentum, eps=bn_eps, **kw)
        self.compute_dtype = dtype
        self.drop_path_rate = float(drop_path_rate)
        stem = _round_filters(32, width_mult)
        self.stem_conv = Conv(3, stem, 3, 2, "SAME", **kw)
        self.stem_bn = bn(stem)
        in_f = stem
        self._blocks = []
        for si, (expand, ch, repeats, stride, kernel) in \
                enumerate(_BASE_BLOCKS):
            out_f = _round_filters(ch, width_mult)
            for r in range(_round_repeats(repeats, depth_mult)):
                name = f"block{si}_{r}"
                setattr(self, name, MBConv(
                    in_f, out_f, expand, stride if r == 0 else 1, kernel,
                    bn_momentum=bn_momentum, bn_eps=bn_eps, **kw))
                self._blocks.append(name)
                in_f = out_f
        head = _round_filters(1280, width_mult)
        self.head_conv = Conv(in_f, head, 1, **kw)
        self.head_bn = bn(head)
        self.num_features = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.drop_path_rate > 0.0:
            raise NotImplementedError(
                f"EfficientNet training with stochastic depth "
                f"(drop_path_rate {self.drop_path_rate}) is not yet ported "
                "to tpuic_torch: it needs the train step's RNG plumbing "
                "(ROADMAP §1 item 8)")
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NCHW view
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self._blocks:
            x = getattr(self, name)(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(2, 3)).float()


def efficientnet(variant: str, **kw) -> EfficientNet:
    width, depth, _ = _SCALING[variant]
    return EfficientNet(width_mult=width, depth_mult=depth, **kw)
