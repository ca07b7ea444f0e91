"""Vision Transformer (ViT-B/16 and friends) as PyTorch modules
(``tpuic/models/vit.py``).

The flax module names (``patch_embed``, ``cls``, ``pos_embed``,
``block3.attn.qkv``, ``block3.mlp_up``, ``ln_final``) so a ``tpuic``
variables tree carries across by name (``tpuic_torch.checkpoint``).
Images come in NHWC ``[B, H, W, 3]``; the backbone returns the float32 CLS
feature ``[B, hidden]`` after the final LayerNorm.

- The patch embedding is flax's ``nn.Conv`` with ``padding="SAME"`` and a
  bias: it pads nothing when the patch divides the image (224/16) and pads
  like flax when it does not.  Its patches do not overlap, so the forward
  computes it as a reshape and one ``F.linear`` (``ViT.embed_patches``);
  the ``patch_embed`` ``Conv2d`` holds the parameters.
- Attention: ``attention="dense"`` is the reference's einsum core in plain
  torch ops (scores, float32 softmax, probabilities times v);
  ``"flash"`` runs the K4 kernels (``kernels/flash_attention.py``) on
  strided views of the qkv projection, forward and backward.  The
  sequence-parallel impls (``ring``, ``ring-flash``, ``ulysses``,
  ``ulysses-flash``) and ``drop_path > 0`` raise ``NotImplementedError``.
- Every ``Linear`` of the backbone is marked ``kernel_init =
  "xavier_uniform"``, flax's init for the ViT's Dense layers
  (``checkpoint.init_params`` reads it).

``image_size`` fixes the token count, hence ``pos_embed``'s shape, at
construction (flax infers it from the first input).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuic_torch.config import ATTENTION_IMPLS
from tpuic_torch.device import resolve_device
from tpuic_torch.kernels.flash_attention import flash_attention
from tpuic_torch.models.layers import LayerNorm

PORTED_ATTENTION = ("dense", "flash")


def check_attention(attention: str) -> None:
    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl '{attention}'; available: "
                         f"{ATTENTION_IMPLS}")
    if attention not in PORTED_ATTENTION:
        raise NotImplementedError(f"attention '{attention}' is not yet "
                                  f"ported to tpuic_torch; ported: "
                                  f"{PORTED_ATTENTION}")


def _dense(in_features: int, features: int, dtype, param_dtype,
           device) -> nn.Linear:
    lin = nn.Linear(in_features, features, dtype=param_dtype, device=device)
    lin.kernel_init = "xavier_uniform"
    # flax boxes these kernels with partitioning metadata, so ``tpuic``'s
    # int8 rung passes them by (``tpuic_torch.quant.quantized_leaves``).
    lin.boxed = True
    lin.compute_dtype = dtype
    return lin


def _apply(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    dt = lin.compute_dtype
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


class MultiHeadAttention(nn.Module):
    """``qkv`` projection, per-head attention, ``out`` projection."""

    def __init__(self, hidden: int, num_heads: int, attention: str = "dense",
                 *, dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        check_attention(attention)
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads, self.attention = num_heads, attention
        self.qkv = _dense(hidden, 3 * hidden, dtype, param_dtype, device)
        self.out = _dense(hidden, hidden, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads
        qkv = _apply(self.qkv, x)
        # Strided [B, N, H, hd] views of the projection: no copy.
        q, k, v = (t.view(b, n, self.num_heads, hd)
                   for t in qkv.split(d, dim=-1))
        if self.attention == "flash":
            out = flash_attention(q, k, v)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
                1.0 / math.sqrt(hd))
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return _apply(self.out, out.reshape(b, n, d))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))`` with an
    exact-erf GELU (``MlpUpGelu``)."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: int = 4,
                 attention: str = "dense", *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln1 = LayerNorm(hidden, **kw)
        self.attn = MultiHeadAttention(hidden, num_heads, attention, **kw)
        self.ln2 = LayerNorm(hidden, **kw)
        self.mlp_up = _dense(hidden, hidden * mlp_ratio, dtype, param_dtype,
                             device)
        self.mlp_down = _dense(hidden * mlp_ratio, hidden, dtype,
                               param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = F.gelu(_apply(self.mlp_up, self.ln2(x)), approximate="none")
        return x + _apply(self.mlp_down, y)


def same_padding(size: int, patch: int):
    """flax ``padding="SAME"`` for a ``patch`` x ``patch`` conv with stride
    ``patch``: (low, high) pads of one spatial dim."""
    out = -(-size // patch)
    total = max((out - 1) * patch + patch - size, 0)
    return total // 2, total - total // 2


class ViT(nn.Module):
    """Returns the float32 CLS-token feature ``[B, hidden]``."""

    def __init__(self, patch: int = 16, hidden: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4, *,
                 image_size: int = 224, attention: str = "dense",
                 moe_experts: int = 0, drop_path: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        if moe_experts:
            raise NotImplementedError("ViT MoE blocks (tpuic/models/moe.py) "
                                      "are not yet ported to tpuic_torch")
        if drop_path > 0:
            raise NotImplementedError("drop_path > 0 is not yet ported to "
                                      "tpuic_torch")
        check_attention(attention)
        device = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.patch, self.hidden, self.depth = patch, hidden, depth
        self.compute_dtype = dtype
        self.image_size = int(image_size)
        self.pads = same_padding(self.image_size, patch)
        side = -(-self.image_size // patch)
        self.patch_embed = nn.Conv2d(3, hidden, patch, stride=patch,
                                     dtype=param_dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden, dtype=param_dtype,
                                            device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, side * side + 1, hidden, dtype=param_dtype, device=device))
        for i in range(depth):
            setattr(self, f"block{i}", EncoderBlock(
                hidden, num_heads, mlp_ratio, attention, **kw))
        self.ln_final = LayerNorm(hidden, **kw)
        self.num_features = hidden

    def embed_patches(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, H, W, C]`` -> ``[B, N, hidden]`` tokens in (row, col)
        order: the stride-equals-kernel convolution written as what it is,
        one matrix product over non-overlapping patches.  Each patch
        flattens in the ``(C, p, p)`` order of the OIHW ``patch_embed``
        weight.  As ``F.linear`` it runs in float32 on the card whatever
        cuDNN's TF32 flag says (cuBLAS matmuls keep TF32 off by default),
        so a row's tokens do not depend on the batch it rides in."""
        lo, hi = self.pads
        if lo or hi:
            x = F.pad(x, (0, 0, lo, hi, lo, hi))
        b, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, (h // p) * (w // p), c * p * p)
        conv = self.patch_embed
        weight = conv.weight.to(x.dtype).reshape(self.hidden, -1)
        return F.linear(x, weight, conv.bias.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"images are {h}x{w}; this ViT was built for "
                             f"{self.image_size}x{self.image_size}")
        dt = self.compute_dtype
        x = self.embed_patches(x.to(dt))
        cls = self.cls.to(dt).expand(b, 1, self.hidden)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.ln_final(x)[:, 0].float()


def vit_b16(**kw) -> ViT:
    return ViT(patch=16, hidden=768, depth=12, num_heads=12, **kw)


def vit_l16(**kw) -> ViT:
    return ViT(patch=16, hidden=1024, depth=24, num_heads=16, **kw)


def vit_b32(**kw) -> ViT:
    return ViT(patch=32, hidden=768, depth=12, num_heads=12, **kw)


def vit_l32(**kw) -> ViT:
    return ViT(patch=32, hidden=1024, depth=24, num_heads=16, **kw)


def vit_s16(**kw) -> ViT:
    return ViT(patch=16, hidden=384, depth=12, num_heads=6, **kw)


def vit_tiny(**kw) -> ViT:
    """Test-scale ViT."""
    return ViT(patch=4, hidden=64, depth=2, num_heads=4, **kw)
