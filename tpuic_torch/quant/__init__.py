"""The serve ladder's weight representations and its accuracy gate
(``tpuic/quant/__init__.py``).

Three rungs, each a module the engine serves beside the others
(:func:`serve_variants`), all from one float32 model:

- **fp32**: the model as it is.  The engine runs it with TF32 off
  (``serve/engine.py:make_forward``), so a row's outputs do not depend on
  the bucket it rides in (to 1e-5).
- **bf16**: ``tpuic``'s checkpoint-served configuration, a bfloat16 model
  over :func:`bf16_variables` (every floating parameter and statistic
  rounded to bfloat16, what ``tpuic``'s ``bf16_variables`` does to the
  tree): half the weight bytes, and bf16 on the tensor cores — cuDNN and
  cuBLAS for InceptionV3, EfficientNet and the ViT's matmuls, K3 with bf16
  activations for the ResNet family, K4's bf16 forward for the ViT.
  Where cuDNN runs its convolutions the engine runs it at its largest
  bucket only (``serve/engine.py:rows_follow_batch``).
- **int8**: weight-only absmax quantization per output channel
  (:func:`absmax_quantize`: ``scale_c = absmax_c / 127``, ``q =
  round(w / scale)``, round half to even as ``jnp.round``) of the leaves
  ``tpuic`` quantizes (:func:`quantized_leaves`), over the float32 model:
  :class:`QuantizedModel` holds the int8 weights and float32 scales on the
  device and widens them (``q.float() * scale``) inside its forward, as
  ``tpuic``'s ``quantized_forward`` does inside the compiled program.  The
  fused ResNet folds BN into the widened weights inside that forward too
  and runs K3 on them: K3's folds kept between calls cannot be taken from
  int8 weights.  Biases, BN parameters and statistics stay float32.

The output channel is axis 0 of a torch weight (Linear ``[out, in]``,
Conv OIHW), where ``tpuic`` quantizes the last axis of the flax layouts
(Dense ``[in, out]``, Conv HWIO): the same channels, the same ``q`` bits.

Which leaves: ``tpuic`` quantizes every ``kernel``/``embedding`` leaf of
rank >= 2 that its walk over plain dicts reaches.  The ViT's encoder Dense
kernels are boxed with partitioning metadata (``LogicallyPartitioned``),
so the walk passes them by: of a ViT, only the patch embedding and the
head's Dense layers are quantized, and every ``qkv``, ``out``, ``mlp_up``
and ``mlp_down`` weight stays float32.  The port quantizes exactly that
set (the ViT marks those ``Linear`` modules ``boxed``).

**Accuracy gate**: a rung ships only when its top-1 predictions agree
with fp32 on the pinned synthetic eval set (:func:`eval_images`) on at
least ``1 - DEFAULT_EPSILON`` of the images (:func:`top1_agreement`); a
seeded weight corruption (:func:`corrupt_variables`) must fail the same
gate.
"""

from __future__ import annotations

import copy
import zlib
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

DTYPE_TAGS = ("fp32", "bf16", "int8")
# The committed accuracy epsilon: a quantized ladder rung must agree
# with fp32 top-1 on at least (1 - epsilon) of the pinned eval set.
# 0.1 is sized to the PINNED gate workload (a seeded random-init model,
# whose near-zero logit margins make ~5% int8 top-1 flips intrinsic —
# measured 0.941 int8 / 0.980 bf16 agreement on the pinned seed; a
# trained checkpoint's margins put agreement well above 0.99).  The
# must-fail corruption arm lands at ~0.0 agreement, so the gate keeps
# a >9x firing margin both ways (scripts/quant_gate.py).
DEFAULT_EPSILON = 0.1


def eval_images(n: int = 256, size: int = 24, seed: int = 0,
                dtype="uint8"):
    """THE pinned synthetic eval set (seeded, shared by the CI gate,
    bench_serve's ladder gate, and the tests): uniform uint8 images —
    deterministic across machines, no dataset dependency."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3)).astype(dtype)


def absmax_quantize(w: torch.Tensor, axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 along ``axis`` (the output channel of a
    torch weight): ``(q, scale)`` with ``q * scale ~= w``; ``scale`` keeps
    ``w``'s rank (size-1 axes) so the dequant is one broadcast multiply."""
    w = w.detach().float()
    axis %= w.dim()
    reduce = tuple(i for i in range(w.dim()) if i != axis)
    absmax = torch.amax(torch.abs(w), dim=reduce, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_leaves(model: nn.Module) -> Tuple[str, ...]:
    """The parameter names ``tpuic`` quantizes: the rank >= 2 weights of
    convolutions and dense layers, less the ViT's boxed Dense kernels."""
    out = []
    for mod_name, mod in model.named_modules():
        w = mod._parameters.get("weight")
        if (isinstance(mod, (nn.Conv2d, nn.Linear)) and w is not None
                and w.dim() >= 2 and not getattr(mod, "boxed", False)):
            out.append(f"{mod_name}.weight" if mod_name else "weight")
    return tuple(out)


def quantize_variables(model: nn.Module) -> Dict[str, object]:
    """The model's ``state_dict`` with every quantized weight replaced by
    ``{"q": int8, "scale": float32}`` (``tpuic``'s int8 tree, by port
    name); everything else passes through."""
    leaves = set(quantized_leaves(model))
    out = {}
    for name, t in model.state_dict().items():
        if name in leaves:
            q, s = absmax_quantize(t)
            out[name] = {"q": q, "scale": s}
        else:
            out[name] = t
    return out


def dequantize_variables(qvars: Dict[str, object], dtype=None
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_variables`: each int8 leaf widens to
    ``dtype`` (float32 by default) through one multiply; the rest is
    returned as it is."""
    dt = torch.float32 if dtype is None else dtype
    return {k: ((v["q"].float() * v["scale"]).to(dt)
                if isinstance(v, dict) else v) for k, v in qvars.items()}


def _invalidate_folds(model: nn.Module) -> None:
    for m in model.modules():
        if hasattr(m, "invalidate_packed"):
            m.invalidate_packed()


class QuantizedModel(nn.Module):
    """The int8 rung: ``model``'s quantized weights as int8 buffers
    ``<weight>_q`` with float32 ``<weight>_scale`` beside them (the
    float32 parameters are dropped), every other tensor as it was.  The
    forward widens each one into the module's ``weight`` attribute, runs
    the model, and drops the widened tensors again; a fused ResNet's BN
    folds are built from them inside the same forward.  ``model`` is
    taken over, not copied."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        names = quantized_leaves(model)
        self.model = model
        self._leaves = []
        for name in names:
            mod_name, attr = name.rpartition(".")[::2]
            mod = model.get_submodule(mod_name)
            q, scale = absmax_quantize(getattr(mod, attr))
            del mod._parameters[attr]
            mod.register_buffer(f"{attr}_q", q)
            mod.register_buffer(f"{attr}_scale", scale)
            setattr(mod, attr, None)
            self._leaves.append((mod, attr))
        self.quantized = names
        _invalidate_folds(model)

    def forward(self, x: torch.Tensor):
        for mod, attr in self._leaves:
            setattr(mod, attr, getattr(mod, f"{attr}_q").float()
                    * getattr(mod, f"{attr}_scale"))
        _invalidate_folds(self.model)
        try:
            return self.model(x)
        finally:
            for mod, attr in self._leaves:
                setattr(mod, attr, None)
            _invalidate_folds(self.model)


def _retype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every module's compute dtype and every floating tensor to
    ``dtype``, in place."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model.to(dtype)


def bf16_variables(model: nn.Module) -> nn.Module:
    """The bf16 rung: a copy of ``model`` computing in bfloat16, with
    every floating parameter and statistic cast to bfloat16 (what
    ``tpuic``'s ``bf16_variables`` does to the tree, under a model whose
    ``dtype`` is bfloat16)."""
    return _retype(copy.deepcopy(model), torch.bfloat16)


def quantized_forward(model: nn.Module) -> QuantizedModel:
    """The int8 rung: a :class:`QuantizedModel` over a copy of the
    float32 ``model`` (its forward dequantizes inside itself, so a CUDA
    graph of it reads the int8 buffers)."""
    return QuantizedModel(copy.deepcopy(model))


def serve_variants(model: nn.Module, tags: Iterable[str]
                   ) -> Dict[str, nn.Module]:
    """``{tag: module}`` for the engine's dtype ladder from the float32
    ``model``: ``fp32`` is ``model`` itself, ``bf16`` and ``int8`` new
    modules built from it.  Unknown tags raise up front — a typo'd ladder
    must fail the CLI, not serve fp32 under an int8 label."""
    out = {}
    for tag in tags:
        if tag == "fp32":
            out[tag] = model
        elif tag == "bf16":
            out[tag] = bf16_variables(model)
        elif tag == "int8":
            out[tag] = quantized_forward(model)
        else:
            raise ValueError(f"unknown serve dtype {tag!r}; "
                             f"supported: {DTYPE_TAGS}")
    return out


def corrupt_variables(model: nn.Module, seed: int = 0,
                      factor: float = 12.0) -> nn.Module:
    """Seeded weight corruption for the accuracy gate's must-fail arm: a
    copy of ``model`` whose every quantizable weight gets additive
    Gaussian noise at ``factor`` times its own standard deviation, drawn
    from a generator seeded with ``seed`` and the leaf's name (crc32
    folded in, as ``tpuic`` folds the tree path into its key).  Not
    ``jax.random``'s bits: the same effect, far below the gate's floor."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for name in quantized_leaves(out):
            w = out.get_parameter(name)
            crc = zlib.crc32(name.encode()) & 0x7FFFFFFF
            g = torch.Generator().manual_seed(int(seed) * 2 ** 31 + crc)
            noise = torch.randn(w.shape, generator=g).to(w.device)
            std = torch.std(w.float(), correction=0)
            w.add_((factor * std * noise).to(w.dtype))
    _invalidate_folds(out)
    return out


def top1_agreement(forward_a: Callable, forward_b: Callable, images,
                   batch: int = 32, device=None) -> float:
    """Fraction of the pinned eval images on which the two forwards agree
    on the top-1 class — the accuracy-delta statistic the ladder gate
    compares against the committed epsilon.  ``forward_*`` follow the
    engine contract (tensor ``[B, S, S, C]`` in, ``(probs, order)`` out);
    ``images`` is a numpy ``[N, S, S, C]`` array, sent to ``device`` (the
    CPU when None) ``batch`` images at a time."""
    n = images.shape[0]
    agree = 0
    for lo in range(0, n, batch):
        chunk = torch.from_numpy(np.ascontiguousarray(images[lo:lo + batch]))
        if device is not None:
            chunk = chunk.to(device)
        _, oa = forward_a(chunk)
        _, ob = forward_b(chunk)
        agree += int((oa[:, 0] == ob[:, 0]).sum())
    return agree / max(1, n)


def weight_bytes(model: nn.Module) -> int:
    """Bytes of a rung's parameters and buffers: what it keeps on the
    device between calls."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))

