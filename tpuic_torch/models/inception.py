"""Inception-v3 with its auxiliary head (``tpuic/models/inception.py``).

The reference's default backbone (train.py:122 'inceptionv3';
nn/classifier.py:20-23): torchvision's inception_v3 with ``AuxLogits.fc``
replaced by a fresh Linear and the main ``fc`` replaced by the MLP head.
Stem (5 convs, 2 pools), 3x InceptionA, InceptionB, 4x InceptionC,
InceptionD, 2x InceptionE, and the aux classifier after the InceptionC
stack.  Every conv is a ``ConvBN`` (bias-free conv, BN with eps 1e-3,
ReLU).  The flax module names (``stem1``..``stem5``, ``mixed5b``..
``mixed7c``, ``b1x1``, ``b7_2``, ``aux.conv0``, ``aux.fc``, each
ConvBN's ``conv``/``bn``) let a ``tpuic`` variables tree carry across by
name (``tpuic_torch.checkpoint``).

Images come in NHWC ``[B, H, W, 3]``; the convs run on an NCHW view of
them.  Flax's average pools count the padding in the divisor
(``count_include_pad=True``); its max pools are VALID.  In train mode
with ``aux_classes > 0`` the forward returns ``(features, aux_logits)``,
else features ``[B, 2048]``, both float32.  The aux branch needs a
17x17 map after ``mixed6e``, i.e. an input of about 299 px.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.models.layers import ConvBN


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


# Flax ((top, bottom), (left, right)) paddings of the factorised convs.
_P1x7 = ((0, 0), (3, 3))
_P7x1 = ((3, 3), (0, 0))
_P1x3 = ((0, 0), (1, 1))
_P3x1 = ((1, 1), (0, 0))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, conv) -> None:
        super().__init__()
        self.b1x1 = conv(cin, 64, 1)
        self.b5_1 = conv(cin, 48, 1)
        self.b5_2 = conv(48, 64, 5, padding=2)
        self.b3_1 = conv(cin, 64, 1)
        self.b3_2 = conv(64, 96, 3, padding=1)
        self.b3_3 = conv(96, 96, 3, padding=1)
        self.bpool = conv(cin, pool_features, 1)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.b1x1(x)
        b5 = self.b5_2(self.b5_1(x))
        b3 = self.b3_3(self.b3_2(self.b3_1(x)))
        bp = self.bpool(_avgpool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, conv) -> None:
        super().__init__()
        self.b3 = conv(cin, 384, 3, strides=2)
        self.bd_1 = conv(cin, 64, 1)
        self.bd_2 = conv(64, 96, 3, padding=1)
        self.bd_3 = conv(96, 96, 3, strides=2)
        self.out_features = 384 + 96 + cin

    def forward(self, x):
        b3 = self.b3(x)
        bd = self.bd_3(self.bd_2(self.bd_1(x)))
        return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, conv) -> None:
        super().__init__()
        c7 = channels_7x7
        self.b1x1 = conv(cin, 192, 1)
        self.b7_1 = conv(cin, c7, 1)
        self.b7_2 = conv(c7, c7, (1, 7), padding=_P1x7)
        self.b7_3 = conv(c7, 192, (7, 1), padding=_P7x1)
        self.bd_1 = conv(cin, c7, 1)
        self.bd_2 = conv(c7, c7, (7, 1), padding=_P7x1)
        self.bd_3 = conv(c7, c7, (1, 7), padding=_P1x7)
        self.bd_4 = conv(c7, c7, (7, 1), padding=_P7x1)
        self.bd_5 = conv(c7, 192, (1, 7), padding=_P1x7)
        self.bpool = conv(cin, 192, 1)
        self.out_features = 4 * 192

    def forward(self, x):
        b1 = self.b1x1(x)
        b7 = self.b7_3(self.b7_2(self.b7_1(x)))
        bd = self.bd_1(x)
        for name in ("bd_2", "bd_3", "bd_4", "bd_5"):
            bd = getattr(self, name)(bd)
        bp = self.bpool(_avgpool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, conv) -> None:
        super().__init__()
        self.b3_1 = conv(cin, 192, 1)
        self.b3_2 = conv(192, 320, 3, strides=2)
        self.b7_1 = conv(cin, 192, 1)
        self.b7_2 = conv(192, 192, (1, 7), padding=_P1x7)
        self.b7_3 = conv(192, 192, (7, 1), padding=_P7x1)
        self.b7_4 = conv(192, 192, 3, strides=2)
        self.out_features = 320 + 192 + cin

    def forward(self, x):
        b3 = self.b3_2(self.b3_1(x))
        b7 = self.b7_4(self.b7_3(self.b7_2(self.b7_1(x))))
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, conv) -> None:
        super().__init__()
        self.b1x1 = conv(cin, 320, 1)
        self.b3_1 = conv(cin, 384, 1)
        self.b3_2a = conv(384, 384, (1, 3), padding=_P1x3)
        self.b3_2b = conv(384, 384, (3, 1), padding=_P3x1)
        self.bd_1 = conv(cin, 448, 1)
        self.bd_2 = conv(448, 384, 3, padding=1)
        self.bd_3a = conv(384, 384, (1, 3), padding=_P1x3)
        self.bd_3b = conv(384, 384, (3, 1), padding=_P3x1)
        self.bpool = conv(cin, 192, 1)
        self.out_features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b1 = self.b1x1(x)
        b3 = self.b3_1(x)
        b3 = torch.cat([self.b3_2a(b3), self.b3_2b(b3)], dim=1)
        bd = self.bd_2(self.bd_1(x))
        bd = torch.cat([self.bd_3a(bd), self.bd_3b(bd)], dim=1)
        bp = self.bpool(_avgpool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionAux(nn.Module):
    """Aux classifier (torchvision InceptionAux with the reference's fresh
    ``Linear(768, num_classes)``, nn/classifier.py:22-23): 5x5/3 average
    pool, two ConvBNs, the spatial mean, then ``fc`` in float32."""

    def __init__(self, cin: int, num_classes: int, conv, *,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.conv0 = conv(cin, 128, 1)
        self.conv1 = conv(128, 768, 5)
        self.fc = nn.Linear(768, num_classes, dtype=param_dtype,
                            device=device)

    def forward(self, x):
        x = F.avg_pool2d(x, 5, 3)
        x = self.conv1(self.conv0(x))
        x = x.mean(dim=(2, 3)).float()
        return F.linear(x, self.fc.weight.float(), self.fc.bias.float())


class InceptionV3(nn.Module):
    """Returns float32 features ``[B, 2048]``; in train mode with
    ``aux_classes > 0``, ``(features, aux_logits)``."""

    def __init__(self, aux_classes: int = 0, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-3, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = dtype
        self.aux_classes = int(aux_classes)
        C = partial(ConvBN, bn_momentum=bn_momentum, bn_eps=bn_eps,
                    dtype=dtype, param_dtype=param_dtype, device=device)
        self.stem1 = C(3, 32, 3, strides=2)
        self.stem2 = C(32, 32, 3)
        self.stem3 = C(32, 64, 3, padding=1)
        self.stem4 = C(64, 80, 1)
        self.stem5 = C(80, 192, 3)
        cin = 192
        blocks = [("mixed5b", InceptionA, (32,)), ("mixed5c", InceptionA, (64,)),
                  ("mixed5d", InceptionA, (64,)), ("mixed6a", InceptionB, ()),
                  ("mixed6b", InceptionC, (128,)),
                  ("mixed6c", InceptionC, (160,)),
                  ("mixed6d", InceptionC, (160,)),
                  ("mixed6e", InceptionC, (192,)),
                  ("mixed7a", InceptionD, ()), ("mixed7b", InceptionE, ()),
                  ("mixed7c", InceptionE, ())]
        for name, cls, args in blocks:
            block = cls(cin, *args, C)
            setattr(self, name, block)
            if name == "mixed6e":
                aux_in = block.out_features
            cin = block.out_features
        if self.aux_classes:
            self.aux = InceptionAux(aux_in, self.aux_classes, C,
                                    param_dtype=param_dtype, device=device)
        self._blocks = [name for name, _, _ in blocks]
        self.num_features = cin

    def forward(self, x: torch.Tensor):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NCHW view
        x = self.stem3(self.stem2(self.stem1(x)))
        x = _maxpool3s2(x)
        x = self.stem5(self.stem4(x))
        x = _maxpool3s2(x)
        aux = None
        for name in self._blocks:
            x = getattr(self, name)(x)
            if name == "mixed6e" and self.aux_classes and self.training:
                aux = self.aux(x)
        features = x.mean(dim=(2, 3)).float()
        if aux is not None:
            return features, aux
        return features
