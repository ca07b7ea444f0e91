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
- ``drop_path_rate`` is ``tpuic``'s stochastic depth (0.2 by default,
  ``tpuic/models/efficientnet.py:117-128``, ``:155-164``): block ``bi``
  (counted over the whole network) drops its residual branch per sample
  at the rate ``drop_path_rate * bi / total_blocks`` and scales a
  survivor by ``1 / keep``, wherever the block has a residual (stride 1,
  ``in == out``) and the rate is above 0: one draw site each, in block
  order (``drop_path_rates``).  The module takes the masks
  (``drop_masks``, ``[sites, B]`` bool, from the train step's generator)
  and draws nothing itself; a train-mode forward needs them.

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
from tpuic_torch.models.vit import check_drop_masks

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
                 drop_rate: float = 0.0, se_ratio: float = 0.25,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-3, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        bn = partial(batch_norm, momentum=bn_momentum, eps=bn_eps, **kw)
        mid = in_features * expand_ratio
        self.residual = strides == 1 and in_features == out_features
        self.drop_rate = float(drop_rate)
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

    @property
    def drops(self) -> bool:
        """Whether this block is a drop-path draw site."""
        return self.residual and self.drop_rate > 0.0

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """``mask`` [B] bool: the stochastic-depth draw of a train-mode
        forward (None: no drop)."""
        y = x
        if hasattr(self, "expand_conv"):
            y = F.silu(self.expand_bn(self.expand_conv(y)))
        y = F.silu(self.dw_bn(self.dw_conv(y)))
        y = self.project_bn(self.project_conv(self.se(y)))
        if self.residual:
            if mask is not None:
                keep = 1.0 - self.drop_rate
                y = y * mask.to(y.dtype)[:, None, None, None] / keep
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
        total = sum(_round_repeats(r, depth_mult)
                    for _, _, r, _, _ in _BASE_BLOCKS)
        for si, (expand, ch, repeats, stride, kernel) in \
                enumerate(_BASE_BLOCKS):
            out_f = _round_filters(ch, width_mult)
            for r in range(_round_repeats(repeats, depth_mult)):
                name = f"block{si}_{r}"
                drop = self.drop_path_rate * len(self._blocks) / max(1, total)
                setattr(self, name, MBConv(
                    in_f, out_f, expand, stride if r == 0 else 1, kernel,
                    drop_rate=drop, bn_momentum=bn_momentum, bn_eps=bn_eps,
                    **kw))
                self._blocks.append(name)
                in_f = out_f
        head = _round_filters(1280, width_mult)
        self.head_conv = Conv(in_f, head, 1, **kw)
        self.head_bn = bn(head)
        self.num_features = head

    def drop_path_rates(self) -> list:
        """The drop rate of each draw site, in block order."""
        return [b.drop_rate for b in (getattr(self, n) for n in self._blocks)
                if b.drops]

    def forward(self, x: torch.Tensor, drop_masks=None) -> torch.Tensor:
        """``drop_masks``: ``[sites, B]`` bool, one row per entry of
        ``drop_path_rates()``; required in train mode, ignored in eval
        mode."""
        masks = check_drop_masks(self, drop_masks, x.shape[0])
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NCHW view
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        site = 0
        for name in self._blocks:
            block = getattr(self, name)
            m = None
            if masks is not None and block.drops:
                m, site = masks[site], site + 1
            x = block(x, m)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(2, 3)).float()


def efficientnet(variant: str, **kw) -> EfficientNet:
    width, depth, _ = _SCALING[variant]
    return EfficientNet(width_mult=width, depth_mult=depth, **kw)
