"""Bare-torch replicas of the reference's model families (the port's own
copy of ``tpuic/checkpoint/torch_ref.py``).

The reference builds ``Classifier(name, n)`` from torchvision /
efficientnet_pytorch pretrained backbones (nn/classifier.py:9-23) with an
MLP head (in->128->64->32->n, nn/classifier.py:26-34). Those packages are
not installed; these replicas reproduce the exact upstream *module
naming* (so their ``state_dict`` keys match real checkpoints) and forward
semantics in bare torch, on ``torch.nn``'s own layers: nothing here comes
from the port's ``models/``, so the replica is an oracle independent of
the code it checks.  Used by:

- ``python -m tpuic_torch.checkpoint.torch_convert <ckpt> --verify`` —
  load a reference checkpoint into the replica and into the port model,
  and print the max logits delta;
- the converter's tests (tests/test_torch_port_convert_cli.py) and
  chip_smoke's ``[convert]`` phase, which build reference-layout
  checkpoints from these replicas.

Everything imports torch lazily, as the original does.
"""

from __future__ import annotations

import math


def _torch():
    import torch
    import torch.nn as tnn
    import torch.nn.functional as F
    return torch, tnn, F


def reference_mlp_head(in_features: int, num_classes: int):
    """nn/classifier.py:26-34: Sequential Linear/ReLU indices fc.0/2/4/6."""
    _, tnn, _ = _torch()
    return tnn.Sequential(
        tnn.Linear(in_features, 128), tnn.ReLU(),
        tnn.Linear(128, 64), tnn.ReLU(),
        tnn.Linear(64, 32), tnn.ReLU(),
        tnn.Linear(32, num_classes))


# ---------------------------------------------------------------------------
# ResNet (torchvision naming)
# ---------------------------------------------------------------------------

_RESNET_CFG = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def build_resnet(arch: str, num_classes: int = 7, mlp_head: bool = True):
    torch, tnn, F = _torch()
    # '-cifar' suffix: 3x3/s1 small stem, no maxpool — mirrors the flax
    # zoo's small_stem variant (models/resnet.py) so the digits/CIFAR
    # convergence control trains the architecture the zoo ships.
    small_stem = arch.endswith("-cifar")
    kind, sizes = _RESNET_CFG[arch[:-len("-cifar")] if small_stem else arch]
    expansion = 1 if kind == "basic" else 4

    class BasicBlock(tnn.Module):
        def __init__(self, inp, out, stride=1):
            super().__init__()
            self.conv1 = tnn.Conv2d(inp, out, 3, stride, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(out)
            self.conv2 = tnn.Conv2d(out, out, 3, 1, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(out)
            self.relu = tnn.ReLU(inplace=True)
            self.downsample = None
            if stride != 1 or inp != out:
                self.downsample = tnn.Sequential(
                    tnn.Conv2d(inp, out, 1, stride, bias=False),
                    tnn.BatchNorm2d(out))

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
            return self.relu(y + idt)

    class Bottleneck(tnn.Module):
        def __init__(self, inp, width, stride=1):
            super().__init__()
            out = width * 4
            self.conv1 = tnn.Conv2d(inp, width, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(width)
            self.conv2 = tnn.Conv2d(width, width, 3, stride, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(width)
            self.conv3 = tnn.Conv2d(width, out, 1, bias=False)
            self.bn3 = tnn.BatchNorm2d(out)
            self.relu = tnn.ReLU(inplace=True)
            self.downsample = None
            if stride != 1 or inp != out:
                self.downsample = tnn.Sequential(
                    tnn.Conv2d(inp, out, 1, stride, bias=False),
                    tnn.BatchNorm2d(out))

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            return self.relu(y + idt)

    class ResNet(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = (tnn.Conv2d(3, 64, 3, 1, 1, bias=False) if small_stem
                          else tnn.Conv2d(3, 64, 7, 2, 3, bias=False))
            self.bn1 = tnn.BatchNorm2d(64)
            self.relu = tnn.ReLU(inplace=True)
            self.maxpool = (tnn.Identity() if small_stem
                            else tnn.MaxPool2d(3, 2, 1))
            widths = (64, 128, 256, 512)
            inp = 64
            for s, (w, n) in enumerate(zip(widths, sizes), start=1):
                blocks = []
                for i in range(n):
                    stride = 2 if s > 1 and i == 0 else 1
                    if kind == "basic":
                        blocks.append(BasicBlock(inp, w, stride))
                        inp = w
                    else:
                        blocks.append(Bottleneck(inp, w, stride))
                        inp = w * 4
                setattr(self, f"layer{s}", tnn.Sequential(*blocks))
            feat = 512 * expansion
            self.fc = (reference_mlp_head(feat, num_classes) if mlp_head
                       else tnn.Linear(feat, num_classes))

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for s in (1, 2, 3, 4):
                x = getattr(self, f"layer{s}")(x)
            x = x.mean(dim=(2, 3))
            return self.fc(x)

    return ResNet()


# ---------------------------------------------------------------------------
# Inception-v3 (torchvision naming)
# ---------------------------------------------------------------------------

def build_inception(num_classes: int = 7, aux: bool = True,
                    mlp_head: bool = True):
    torch, tnn, F = _torch()

    class BasicConv2d(tnn.Module):
        def __init__(self, inp, out, **kw):
            super().__init__()
            self.conv = tnn.Conv2d(inp, out, bias=False, **kw)
            self.bn = tnn.BatchNorm2d(out, eps=0.001)

        def forward(self, x):
            return F.relu(self.bn(self.conv(x)))

    class InceptionA(tnn.Module):
        def __init__(self, inp, pool_features):
            super().__init__()
            self.branch1x1 = BasicConv2d(inp, 64, kernel_size=1)
            self.branch5x5_1 = BasicConv2d(inp, 48, kernel_size=1)
            self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
            self.branch3x3dbl_1 = BasicConv2d(inp, 64, kernel_size=1)
            self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
            self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
            self.branch_pool = BasicConv2d(inp, pool_features, kernel_size=1)

        def forward(self, x):
            b1 = self.branch1x1(x)
            b5 = self.branch5x5_2(self.branch5x5_1(x))
            b3 = self.branch3x3dbl_3(
                self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
            bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1))
            return torch.cat([b1, b5, b3, bp], 1)

    class InceptionB(tnn.Module):
        def __init__(self, inp):
            super().__init__()
            self.branch3x3 = BasicConv2d(inp, 384, kernel_size=3, stride=2)
            self.branch3x3dbl_1 = BasicConv2d(inp, 64, kernel_size=1)
            self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
            self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

        def forward(self, x):
            return torch.cat([
                self.branch3x3(x),
                self.branch3x3dbl_3(
                    self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
                F.max_pool2d(x, 3, stride=2)], 1)

    class InceptionC(tnn.Module):
        def __init__(self, inp, c7):
            super().__init__()
            self.branch1x1 = BasicConv2d(inp, 192, kernel_size=1)
            self.branch7x7_1 = BasicConv2d(inp, c7, kernel_size=1)
            self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                           padding=(0, 3))
            self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1),
                                           padding=(3, 0))
            self.branch7x7dbl_1 = BasicConv2d(inp, c7, kernel_size=1)
            self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                              padding=(3, 0))
            self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                              padding=(0, 3))
            self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                              padding=(3, 0))
            self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7),
                                              padding=(0, 3))
            self.branch_pool = BasicConv2d(inp, 192, kernel_size=1)

        def forward(self, x):
            b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
            bd = self.branch7x7dbl_1(x)
            for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
                bd = m(bd)
            bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1))
            return torch.cat([self.branch1x1(x), b7, bd, bp], 1)

    class InceptionD(tnn.Module):
        def __init__(self, inp):
            super().__init__()
            self.branch3x3_1 = BasicConv2d(inp, 192, kernel_size=1)
            self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
            self.branch7x7x3_1 = BasicConv2d(inp, 192, kernel_size=1)
            self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7),
                                             padding=(0, 3))
            self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1),
                                             padding=(3, 0))
            self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

        def forward(self, x):
            b7 = self.branch7x7x3_1(x)
            for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
                b7 = m(b7)
            return torch.cat([
                self.branch3x3_2(self.branch3x3_1(x)), b7,
                F.max_pool2d(x, 3, stride=2)], 1)

    class InceptionE(tnn.Module):
        def __init__(self, inp):
            super().__init__()
            self.branch1x1 = BasicConv2d(inp, 320, kernel_size=1)
            self.branch3x3_1 = BasicConv2d(inp, 384, kernel_size=1)
            self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                            padding=(0, 1))
            self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                            padding=(1, 0))
            self.branch3x3dbl_1 = BasicConv2d(inp, 448, kernel_size=1)
            self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3,
                                              padding=1)
            self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                               padding=(0, 1))
            self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                               padding=(1, 0))
            self.branch_pool = BasicConv2d(inp, 192, kernel_size=1)

        def forward(self, x):
            b3 = self.branch3x3_1(x)
            b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
            bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
            bd = torch.cat([self.branch3x3dbl_3a(bd),
                            self.branch3x3dbl_3b(bd)], 1)
            bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1))
            return torch.cat([self.branch1x1(x), b3, bd, bp], 1)

    class InceptionAux(tnn.Module):
        def __init__(self, inp, n):
            super().__init__()
            self.conv0 = BasicConv2d(inp, 128, kernel_size=1)
            self.conv1 = BasicConv2d(128, 768, kernel_size=5)
            self.fc = tnn.Linear(768, n)

        def forward(self, x):
            x = F.avg_pool2d(x, 5, stride=3)
            x = self.conv1(self.conv0(x))
            x = F.adaptive_avg_pool2d(x, (1, 1)).flatten(1)
            return self.fc(x)

    class InceptionV3(tnn.Module):
        """torchvision-named inception_v3 body + the reference's MLP head
        (+ the reference's replaced AuxLogits.fc, nn/classifier.py:22-23)."""

        def __init__(self):
            super().__init__()
            self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
            self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
            self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
            if aux:
                self.AuxLogits = InceptionAux(768, num_classes)
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280)
            self.Mixed_7c = InceptionE(2048)
            self.fc = (reference_mlp_head(2048, num_classes)
                       if mlp_head else tnn.Linear(2048, num_classes))

        def forward(self, x):
            x = self.Conv2d_1a_3x3(x)
            x = self.Conv2d_2a_3x3(x)
            x = self.Conv2d_2b_3x3(x)
            x = F.max_pool2d(x, 3, stride=2)
            x = self.Conv2d_3b_1x1(x)
            x = self.Conv2d_4a_3x3(x)
            x = F.max_pool2d(x, 3, stride=2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                         "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
            x = x.mean(dim=(2, 3))
            return self.fc(x)

    return InceptionV3()


# ---------------------------------------------------------------------------
# EfficientNet (efficientnet_pytorch naming, TF SAME padding)
# ---------------------------------------------------------------------------

# (expand, channels, repeats, stride, kernel) — the B0 base blocks.
_EFFNET_BASE_BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
                       (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
                       (6, 320, 1, 1, 3))
# (width_coefficient, depth_coefficient) per variant.
_EFFNET_COEF = {"b0": (1.0, 1.0), "b1": (1.0, 1.1),
                "b2": (1.1, 1.2), "b3": (1.2, 1.4),
                "b4": (1.4, 1.8), "b5": (1.6, 2.2),
                "b6": (1.8, 2.6), "b7": (2.0, 3.1)}


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def build_efficientnet(variant: str = "b0", num_classes: int = 7,
                       mlp_head: bool = False):
    """efficientnet_pytorch-named EfficientNet with its single-Linear _fc.

    Note the reference's efficientnet branch is broken upstream
    (nn/classifier.py:17-18+27 sets ``.fc`` on a model whose attr is
    ``._fc``); the package's own ``_fc`` head is replicated, which the
    converter maps to ``head/out``. ``mlp_head=True`` replaces it with the
    reference-style MLP Sequential at attribute ``fc`` (keys fc.{0,2,..})
    — the layout tpuic's export emits for MLP-head efficientnet
    checkpoints, so --export-torch --verify has a loadable replica."""
    torch, tnn, F = _torch()
    width, depth = _EFFNET_COEF[variant]

    class SameConv2d(tnn.Conv2d):
        def forward(self, x):
            ih, iw = x.shape[-2:]
            kh, kw = self.weight.shape[-2:]
            sh, sw = self.stride
            ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
            pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
            x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
            return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                            self.dilation, self.groups)

    def swish(x):
        return x * torch.sigmoid(x)

    class MBConv(tnn.Module):
        def __init__(self, inp, out, expand, kernel, stride):
            super().__init__()
            mid = inp * expand
            self.has_expand = expand != 1
            if self.has_expand:
                self._expand_conv = SameConv2d(inp, mid, 1, bias=False)
                self._bn0 = tnn.BatchNorm2d(mid, eps=1e-3)
            self._depthwise_conv = SameConv2d(mid, mid, kernel, stride=stride,
                                              groups=mid, bias=False)
            self._bn1 = tnn.BatchNorm2d(mid, eps=1e-3)
            se_ch = max(1, int(inp * 0.25))
            self._se_reduce = SameConv2d(mid, se_ch, 1)
            self._se_expand = SameConv2d(se_ch, mid, 1)
            self._project_conv = SameConv2d(mid, out, 1, bias=False)
            self._bn2 = tnn.BatchNorm2d(out, eps=1e-3)
            self.skip = stride == 1 and inp == out

        def forward(self, x):
            y = x
            if self.has_expand:
                y = swish(self._bn0(self._expand_conv(y)))
            y = swish(self._bn1(self._depthwise_conv(y)))
            s = F.adaptive_avg_pool2d(y, 1)
            s = self._se_expand(swish(self._se_reduce(s)))
            y = torch.sigmoid(s) * y
            y = self._bn2(self._project_conv(y))
            return y + x if self.skip else y

    class EfficientNet(tnn.Module):
        def __init__(self):
            super().__init__()
            stem = _round_filters(32, width)
            self._conv_stem = SameConv2d(3, stem, 3, stride=2, bias=False)
            self._bn0 = tnn.BatchNorm2d(stem, eps=1e-3)
            blocks = []
            inp = stem
            for expand, ch, repeats, stride, kernel in _EFFNET_BASE_BLOCKS:
                out = _round_filters(ch, width)
                for r in range(_round_repeats(repeats, depth)):
                    blocks.append(MBConv(inp, out, expand, kernel,
                                         stride if r == 0 else 1))
                    inp = out
            self._blocks = tnn.ModuleList(blocks)
            head = _round_filters(1280, width)
            self._conv_head = SameConv2d(inp, head, 1, bias=False)
            self._bn1 = tnn.BatchNorm2d(head, eps=1e-3)
            if mlp_head:
                self.fc = reference_mlp_head(head, num_classes)
            else:
                self._fc = tnn.Linear(head, num_classes)

        def forward(self, x):
            x = swish(self._bn0(self._conv_stem(x)))
            for b in self._blocks:
                x = b(x)
            x = swish(self._bn1(self._conv_head(x)))
            x = F.adaptive_avg_pool2d(x, 1).flatten(1)
            return self.fc(x) if mlp_head else self._fc(x)

    return EfficientNet()


# ---------------------------------------------------------------------------
# ViT (torchvision vision_transformer naming: vit_b_16 / vit_l_16 / vit_s_16)
# ---------------------------------------------------------------------------

_VIT_CFG = {  # name -> (patch, hidden, depth, heads)
    "vit-b16": (16, 768, 12, 12),
    "vit-l16": (16, 1024, 24, 16),
    "vit-b32": (32, 768, 12, 12),
    "vit-l32": (32, 1024, 24, 16),
    "vit-s16": (16, 384, 12, 6),
    # test-scale (tpuic-only size; same module naming)
    "vit-tiny": (4, 64, 2, 4),
}


def build_vit(variant: str = "vit-b16", num_classes: int = 7,
              image_size: int = 224, mlp_head: bool = True):
    """torchvision ``VisionTransformer``-naming replica: conv_proj,
    class_token, encoder.pos_embedding, encoder.layers.encoder_layer_i
    (ln_1 / self_attention / ln_2 / mlp.{0,3}), encoder.ln, heads.head.
    ``self_attention`` is a real ``nn.MultiheadAttention`` so
    in_proj_weight/out_proj match upstream checkpoints exactly."""
    torch, tnn, F = _torch()
    patch, hidden, depth, heads = _VIT_CFG[variant]
    n_tokens = (image_size // patch) ** 2 + 1

    class EncoderBlock(tnn.Module):
        def __init__(self):
            super().__init__()
            self.ln_1 = tnn.LayerNorm(hidden, eps=1e-6)
            self.self_attention = tnn.MultiheadAttention(
                hidden, heads, batch_first=True)
            self.ln_2 = tnn.LayerNorm(hidden, eps=1e-6)
            # torchvision MLPBlock state-dict naming (>=0.12): Sequential
            # indices 0 (Linear), 1 (GELU), 2 (Dropout), 3 (Linear).
            self.mlp = tnn.Sequential(
                tnn.Linear(hidden, 4 * hidden), tnn.GELU(),
                tnn.Dropout(0.0), tnn.Linear(4 * hidden, hidden))

        def forward(self, x):
            y = self.ln_1(x)
            y, _ = self.self_attention(y, y, y, need_weights=False)
            x = x + y
            return x + self.mlp(self.ln_2(x))

    class Encoder(tnn.Module):
        def __init__(self):
            super().__init__()
            self.pos_embedding = tnn.Parameter(
                torch.empty(1, n_tokens, hidden).normal_(std=0.02))
            self.layers = tnn.Sequential()
            for i in range(depth):
                self.layers.add_module(f"encoder_layer_{i}", EncoderBlock())
            self.ln = tnn.LayerNorm(hidden, eps=1e-6)

        def forward(self, x):
            return self.ln(self.layers(x + self.pos_embedding))

    class VisionTransformer(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv_proj = tnn.Conv2d(3, hidden, patch, patch)
            self.class_token = tnn.Parameter(torch.zeros(1, 1, hidden))
            self.encoder = Encoder()
            self.heads = tnn.Sequential()
            self.heads.add_module(
                "head", reference_mlp_head(hidden, num_classes) if mlp_head
                else tnn.Linear(hidden, num_classes))

        def forward(self, x):
            b = x.shape[0]
            x = self.conv_proj(x)                     # [B, D, H', W']
            x = x.reshape(b, hidden, -1).permute(0, 2, 1)   # [B, N, D]
            x = torch.cat([self.class_token.expand(b, -1, -1), x], dim=1)
            x = self.encoder(x)
            return self.heads(x[:, 0])

    return VisionTransformer()


def build_reference_model(arch: str, num_classes: int = 7,
                          mlp_head: bool = True, image_size: int = 224):
    """Replica of the reference ``Classifier(name, n)`` for a backbone name
    (nn/classifier.py:8-34). arch: resnet18/34/50/101/152, inceptionv3,
    efficientnet-b{0..7}, vit-{b16,l16,s16,tiny}. ``mlp_head`` selects the
    reference MLP head vs the family's plain single-Linear head
    (torchvision fc / efficientnet_pytorch _fc) — pass what _infer_head
    detected so --verify builds a replica that can actually load the
    checkpoint. ``image_size`` only matters for ViT (pos-embedding length);
    CNNs ignore it."""
    if (arch in _RESNET_CFG
            or (arch.endswith("-cifar")
                and arch[:-len("-cifar")] in _RESNET_CFG)):
        return build_resnet(arch, num_classes, mlp_head=mlp_head)
    if arch.startswith("inception"):
        return build_inception(num_classes, mlp_head=mlp_head)
    if arch.startswith("efficientnet"):
        variant = arch.rsplit("-", 1)[-1] if "-" in arch else "b0"
        return build_efficientnet(variant, num_classes, mlp_head=mlp_head)
    if arch in _VIT_CFG:
        return build_vit(arch, num_classes, image_size=image_size,
                         mlp_head=mlp_head)
    raise ValueError(f"no torch replica for arch '{arch}'")
