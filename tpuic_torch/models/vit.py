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
  ``ulysses-flash``) raise ``NotImplementedError``.
- Drop-path (stochastic depth, ``tpuic/models/vit.py:183-199``,
  ``:286-297``): block ``i`` drops each residual branch per sample at
  the rate ``drop_path * i / max(1, depth - 1)``, and a survivor is
  scaled by ``1 / max(keep, 1e-6)``: two draw sites a block (attention,
  then MLP) wherever the rate is above 0, in block order
  (``drop_path_rates``).  The module takes the masks (``drop_masks``,
  ``[sites, B]`` bool, from the train step's generator) and draws
  nothing itself; a train-mode forward with a rate above 0 needs them.
- Remat (``remat_core``, ``remat_mlp``, ``remat_blocks``:
  ``ModelConfig.remat_policy`` ``attention``, ``gelu``, ``blocks``;
  ``models/remat.py``) recomputes in the backward the dense attention
  core, each ``mlp_up`` + GELU, or each block, saving nothing.
- Every ``Linear`` of the backbone is marked ``kernel_init =
  "xavier_uniform"``, flax's init for the ViT's Dense layers
  (``checkpoint.init_params`` reads it).
- MoE (``moe_experts`` > 0, ``tpuic/models/vit.py:214-218``,
  ``:290-297``): every ``moe_every``-th block, counting from block
  ``moe_every - 1``, replaces its dense MLP by a ``SwitchMoEMlp``
  (``models/moe.py``) named ``moe``.

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
from tpuic_torch.models.moe import SwitchMoEMlp
from tpuic_torch.models.remat import checkpointed
from tpuic_torch.telemetry.tracing import scope

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
                 *, remat_core: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        check_attention(attention)
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads, self.attention = num_heads, attention
        self.remat_core = remat_core
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
        elif self.remat_core and self.training:
            out = checkpointed(_dense_core, q, k, v)
        else:
            out = _dense_core(q, k, v)
        return _apply(self.out, out.reshape(b, n, d))


def _dense_core(q, k, v):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
        1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _drop(y: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """``y * (mask / max(keep, 1e-6))`` per sample (``tpuic``'s
    ``_residual``)."""
    keep = 1.0 - rate
    return y * (mask.to(y.dtype)[:, None, None] / max(keep, 1e-6))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))`` with an
    exact-erf GELU (``MlpUpGelu``), or a routed ``SwitchMoEMlp`` when
    ``moe_experts`` > 0; in train mode at ``drop_path`` > 0 each branch is
    dropped per sample by the ``masks`` pair (attention's, MLP's)."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: int = 4,
                 attention: str = "dense", *, drop_path: float = 0.0,
                 moe_experts: int = 0, remat_core: bool = False,
                 remat_mlp: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.drop_path = float(drop_path)
        self.remat_mlp = remat_mlp
        self.ln1 = LayerNorm(hidden, **kw)
        self.attn = MultiHeadAttention(hidden, num_heads, attention,
                                       remat_core=remat_core, **kw)
        self.ln2 = LayerNorm(hidden, **kw)
        self.moe_experts = moe_experts
        if moe_experts:
            self.moe = SwitchMoEMlp(hidden, moe_experts, mlp_ratio, **kw)
        else:
            self.mlp_up = _dense(hidden, hidden * mlp_ratio, dtype,
                                 param_dtype, device)
            self.mlp_down = _dense(hidden * mlp_ratio, hidden, dtype,
                                   param_dtype, device)

    def _up_gelu(self, y: torch.Tensor) -> torch.Tensor:
        return F.gelu(_apply(self.mlp_up, y), approximate="none")

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        y = self.attn(self.ln1(x))
        x = x + (y if masks is None else _drop(y, masks[0], self.drop_path))
        y = self.ln2(x)
        if self.moe_experts:
            y = self.moe(y)
        else:
            y = (checkpointed(self._up_gelu, y) if self.remat_mlp
                 and self.training else self._up_gelu(y))
            y = _apply(self.mlp_down, y)
        return x + (y if masks is None else _drop(y, masks[1],
                                                  self.drop_path))


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
                 moe_experts: int = 0, moe_every: int = 2,
                 drop_path: float = 0.0, remat_core: bool = False,
                 remat_mlp: bool = False, remat_blocks: bool = False,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
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
        self.remat_blocks = remat_blocks
        self.block_rates = [drop_path * i / max(1, depth - 1)
                            if drop_path else 0.0 for i in range(depth)]
        for i in range(depth):
            moe = (moe_experts if moe_experts
                   and i % moe_every == moe_every - 1 else 0)
            setattr(self, f"block{i}", EncoderBlock(
                hidden, num_heads, mlp_ratio, attention,
                drop_path=self.block_rates[i], moe_experts=moe,
                remat_core=remat_core, remat_mlp=remat_mlp, **kw))
        self.ln_final = LayerNorm(hidden, **kw)
        self.num_features = hidden

    def drop_path_rates(self) -> list:
        """The drop rate of each draw site, in draw order: attention's,
        then the MLP's, for every block whose rate is above 0."""
        return [r for r in self.block_rates if r > 0 for _ in range(2)]

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

    def forward(self, x: torch.Tensor, drop_masks=None) -> torch.Tensor:
        """``drop_masks``: ``[sites, B]`` bool, one row per entry of
        ``drop_path_rates()``; required in train mode when it is not
        empty, ignored in eval mode."""
        b, h, w, _ = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"images are {h}x{w}; this ViT was built for "
                             f"{self.image_size}x{self.image_size}")
        masks = check_drop_masks(self, drop_masks, b)
        dt = self.compute_dtype
        # Profiler scopes named as tpuic's (the waterfall's layers).
        with scope("tokenize"):
            x = self.embed_patches(x.to(dt))
            cls = self.cls.to(dt).expand(b, 1, self.hidden)
            x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        site = 0
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            m = None
            if masks is not None and self.block_rates[i] > 0:
                m, site = masks[site:site + 2], site + 2
            with scope(f"block{i}"):
                if self.remat_blocks and self.training:
                    x = checkpointed(block, x, m)
                else:
                    x = block(x, m)
        with scope("cls_pool"):
            return self.ln_final(x)[:, 0].float()


def check_drop_masks(module: nn.Module, drop_masks, batch: int):
    """``drop_masks`` for a forward of ``module`` (None in eval mode or
    when it has no site), after checking its shape."""
    sites = len(module.drop_path_rates())
    if not module.training or not sites:
        return None
    if drop_masks is None:
        raise ValueError(
            f"{type(module).__name__} drops paths in train mode "
            f"({sites} draw sites): pass drop_masks, the train step's "
            "draws (tpuic_torch.train.augment.draw_drop_masks)")
    if tuple(drop_masks.shape) != (sites, batch):
        raise ValueError(f"drop_masks is {tuple(drop_masks.shape)}; "
                         f"expected {(sites, batch)}")
    return drop_masks


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


def vit_s16_moe(**kw) -> ViT:
    """ViT-S/16 with 8-expert Switch MoE in every other block."""
    return ViT(patch=16, hidden=384, depth=12, num_heads=6, moe_experts=8,
               **kw)


def vit_tiny_moe(**kw) -> ViT:
    """Test-scale MoE ViT (4 experts, MoE in block 1)."""
    return ViT(patch=4, hidden=64, depth=2, num_heads=4, moe_experts=4, **kw)
