"""ResNet family (18/34/50/101/152) as PyTorch modules (``tpuic/models/resnet.py``).

Torchvision's architecture, as in the reference — 7x7/stride-2 stem,
maxpool, four stages of Basic/Bottleneck blocks, global average pool —
with the flax module names (``conv1``, ``bn1``, ``layer3_5.conv2``,
``layer1_0.downsample_conv``), so a ``tpuic`` variables tree carries
across by name (``tpuic_torch.checkpoint``).  Images come in NHWC
``[B, H, W, 3]``, as in ``tpuic``.

Variants: ``small_stem`` (3x3 stride-1 stem, no maxpool) for 32x32 CIFAR
inputs, and ``space_to_depth`` (the 7x7/stride-2 stem as a 4x4/stride-1
conv on the 2x2 space-to-depth transform ``[H/2, W/2, 12]``; convert
stem weights with :func:`s2d_stem_kernel`).

Two branches:

- **unfused** (``fused_inference=False``, or a module in training mode):
  ``nn.Conv2d`` + ``nn.BatchNorm2d`` in plain PyTorch over an NCHW view
  of the NHWC data (channels_last memory, no copy).  In training mode BN
  uses batch statistics, reduced in float32 unless ``bn_f32_stats`` is
  off (the ``--bn-bf16-stats`` experiment, ``models/layers.py``).
- **fused inference** (``fused_inference=True`` in eval mode): every
  conv -> BN (-> ReLU) runs as one ``fused_conv_bn_relu`` kernel launch
  on NHWC activations, which stay NHWC-contiguous from block to block.
  The residual add, the block's final ReLU, the stem's maxpool and the
  global average pool stay plain PyTorch, as they stay plain jnp in
  ``tpuic``.  BN is folded and the weights repacked to HWIO once per set
  of weights (:meth:`ResNet.packed_weights`), not per call: the cache is
  dropped whenever the module changes mode, moves, or loads weights.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.kernels.conv_bn_relu import fused_conv_bn_relu, pack_conv_bn
from tpuic_torch.models.layers import Conv, batch_norm, conv1x1, conv3x3

Packed = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _cbr(x, packed, *, strides=1, padding=0, relu=True):
    w, scale, bias = packed
    return fused_conv_bn_relu(x, w, scale, bias, strides=strides,
                              padding=padding, relu=relu)


class _Block(nn.Module):
    """Shared plumbing: the (conv, bn) pairs a block folds for the kernel."""

    expansion = 1
    PAIRS: Tuple[Tuple[str, str], ...] = ()

    def conv_bn_pairs(self):
        for conv, bn in self.PAIRS + (("downsample_conv", "downsample_bn"),):
            if hasattr(self, conv):
                yield conv, bn


class BasicBlock(_Block):
    expansion = 1
    PAIRS = (("conv1", "bn1"), ("conv2", "bn2"))

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 bn_f32_stats: bool = True, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype,
                  device=resolve_device(device))
        bn = partial(batch_norm, momentum=bn_momentum, eps=bn_eps,
                     f32_stats=bn_f32_stats, **kw)
        self.strides = strides
        self.conv1 = conv3x3(in_features, features, strides, **kw)
        self.bn1 = bn(features)
        self.conv2 = conv3x3(features, features, **kw)
        self.bn2 = bn(features)
        if strides != 1 or in_features != features:
            self.downsample_conv = conv1x1(in_features, features, strides,
                                           **kw)
            self.downsample_bn = bn(features)

    def forward(self, x: torch.Tensor,
                packed: Optional[Packed] = None) -> torch.Tensor:
        if packed is not None:  # fused inference, NHWC
            y = _cbr(x, packed["conv1"], strides=self.strides, padding=1)
            y = _cbr(y, packed["conv2"], padding=1, relu=False)
            residual = x
            if "downsample_conv" in packed:
                residual = _cbr(x, packed["downsample_conv"],
                                strides=self.strides, relu=False)
            # In place on the kernel's fresh output: saves one activation.
            return y.add_(residual).relu_()
        residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck(_Block):
    expansion = 4  # block output is 4 * features
    PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 bn_f32_stats: bool = True, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype,
                  device=resolve_device(device))
        bn = partial(batch_norm, momentum=bn_momentum, eps=bn_eps,
                     f32_stats=bn_f32_stats, **kw)
        out_features = features * 4
        self.strides = strides
        self.conv1 = conv1x1(in_features, features, **kw)
        self.bn1 = bn(features)
        # torchvision places the stride on the 3x3 (v1.5 ResNet).
        self.conv2 = conv3x3(features, features, strides, **kw)
        self.bn2 = bn(features)
        self.conv3 = conv1x1(features, out_features, **kw)
        self.bn3 = bn(out_features)
        if strides != 1 or in_features != out_features:
            self.downsample_conv = conv1x1(in_features, out_features,
                                           strides, **kw)
            self.downsample_bn = bn(out_features)

    def forward(self, x: torch.Tensor,
                packed: Optional[Packed] = None) -> torch.Tensor:
        if packed is not None:  # fused inference, NHWC
            y = _cbr(x, packed["conv1"])
            y = _cbr(y, packed["conv2"], strides=self.strides, padding=1)
            y = _cbr(y, packed["conv3"], relu=False)
            residual = x
            if "downsample_conv" in packed:
                residual = _cbr(x, packed["downsample_conv"],
                                strides=self.strides, relu=False)
            # In place on the kernel's fresh output: saves one activation.
            return y.add_(residual).relu_()
        residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, H/2, W/2, 4C]``, channels in
    (di, dj, c) order — the activation side of :func:`s2d_stem_kernel`."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth stem needs even H/W, got {(h, w)}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class ResNet(nn.Module):
    """Returns pooled float32 features ``[B, num_features]``; the
    classifier head is separate."""

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 num_filters: int = 64, small_stem: bool = False,
                 space_to_depth: bool = False, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5, *, dtype=torch.float32,
                 param_dtype=torch.float32, fused_inference: bool = False,
                 bn_f32_stats: bool = True, device=None) -> None:
        super().__init__()
        self._packed: Optional[Dict[str, Packed]] = None
        self.compute_dtype = dtype
        self.small_stem = small_stem
        self.space_to_depth = space_to_depth
        self.fused_inference = fused_inference
        kw = dict(dtype=dtype, param_dtype=param_dtype,
                  device=resolve_device(device))
        if small_stem:
            self._stem = (1, 1)
            self.conv1 = Conv(3, num_filters, 3, 1, 1, **kw)
        elif space_to_depth:
            # Taps of output row oi cover original rows 2oi-3..2oi+3; with
            # the kernel zero-padded to 8 the window is 2(oi-2)..2oi+3 —
            # four s2d rows, hence 4x4 stride-1 with (2, 1) padding.
            self._stem = (1, ((2, 1), (2, 1)))
            self.conv1 = Conv(12, num_filters, 4, *self._stem, **kw)
        else:
            self._stem = (2, 3)
            self.conv1 = Conv(3, num_filters, 7, *self._stem, **kw)
        self.bn1 = batch_norm(num_filters, momentum=bn_momentum, eps=bn_eps,
                              f32_stats=bn_f32_stats, **kw)
        in_features = num_filters
        self._blocks = []
        for stage, n_blocks in enumerate(stage_sizes):
            for i in range(n_blocks):
                strides = 2 if stage > 0 and i == 0 else 1
                name = f"layer{stage + 1}_{i}"
                features = num_filters * 2 ** stage
                setattr(self, name, block(in_features, features, strides,
                                          bn_momentum, bn_eps,
                                          bn_f32_stats=bn_f32_stats, **kw))
                self._blocks.append(name)
                in_features = features * block.expansion
        self.num_features = in_features

    # -- the fused path's folded weights --------------------------------
    def packed_weights(self) -> Dict[str, Packed]:
        """``{"stem": (w, scale, bias), block: {conv: (w, scale, bias)}}``
        for every conv -> BN pair: HWIO weights and the folded BN affine
        (eps from each BN), built once and reused until invalidated."""
        if self._packed is None:
            # Ordinary tensors even when the first fused call runs under
            # inference_mode, so later calls in any grad mode can read them.
            with torch.inference_mode(False), torch.no_grad():
                def pack(conv, bn):
                    return pack_conv_bn(conv.weight, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var,
                                        bn.eps)
                packed = {"stem": pack(self.conv1, self.bn1)}
                for name in self._blocks:
                    blk = getattr(self, name)
                    packed[name] = {c: pack(getattr(blk, c), getattr(blk, b))
                                    for c, b in blk.conv_bn_pairs()}
            self._packed = packed
        return self._packed

    def invalidate_packed(self) -> None:
        """Drop the folded weights; the next fused call rebuilds them."""
        self._packed = None

    def train(self, mode: bool = True) -> "ResNet":
        self._packed = None  # training may change weights and statistics
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None  # .to()/.cuda()/.float() replace the tensors
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = None
        return super()._load_from_state_dict(*args, **kwargs)

    # -- forward --------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.space_to_depth:
            x = space_to_depth(x)
        if self.fused_inference and not self.training:
            return self._forward_fused(x.contiguous())
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC data
        x = F.relu(self.bn1(self.conv1(x)))
        if not self.small_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()  # global average pool

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        packed = self.packed_weights()
        strides, padding = self._stem
        x = _cbr(x, packed["stem"], strides=strides, padding=padding)
        if not self.small_stem:
            # Pools through the channels_last view: NHWC in, NHWC out.
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
            x = x.permute(0, 2, 3, 1).contiguous()
        for name in self._blocks:
            x = getattr(self, name)(x, packed[name])
        return x.mean(dim=(1, 2)).float()  # global average pool


def s2d_stem_kernel(w77: torch.Tensor) -> torch.Tensor:
    """HWIO ``[7, 7, Cin, F]`` stem kernel -> its space-to-depth
    equivalent ``[4, 4, 4*Cin, F]``: zero-pad to 8x8 with the extra row and
    column at the LEADING edge, then fold each 2x2 tap block into channels
    in (di, dj, c) order, matching :func:`space_to_depth`."""
    k, _, cin, f = w77.shape
    if k != 7 or w77.shape[1] != 7:
        raise ValueError(f"expected a [7,7,Cin,F] kernel, got "
                         f"{tuple(w77.shape)}")
    w88 = F.pad(w77, (0, 0, 0, 0, 1, 0, 1, 0))
    w = w88.reshape(4, 2, 4, 2, cin, f).permute(0, 2, 1, 3, 4, 5)
    return w.reshape(4, 4, 4 * cin, f)


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block=Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block=Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), block=Bottleneck, **kw)
