"""Model registry (``tpuic/models/__init__.py``).

``create_model(name, num_classes)`` builds ``Classifier(backbone, head)``
with the same names, defaults and parameter structure as ``tpuic``'s.
The ResNet family is ported; every other ``tpuic`` model name raises
``ValueError`` saying it is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from tpuic_torch.config import ModelConfig
from tpuic_torch.device import resolve_device
from tpuic_torch.models import resnet as _resnet
from tpuic_torch.models.classifier import Classifier

_REGISTRY: Dict[str, Callable[..., torch.nn.Module]] = {}

#: ``tpuic`` model names whose backbones are later slices of the port.
NOT_YET_PORTED = tuple(
    [f"efficientnet-b{i}" for i in range(8)]
    + ["vit-b16", "vit-l16", "vit-b32", "vit-l32", "vit-s16", "vit-tiny",
       "vit-s16-moe", "vit-tiny-moe", "inceptionv3"])

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def register(name: str, factory: Callable[..., torch.nn.Module]) -> None:
    _REGISTRY[name] = factory


def available_models():
    return sorted(_REGISTRY)


def _dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if dt not in _DTYPES:
        raise ValueError(f"unknown dtype {dt!r}; available: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[dt]


def create_backbone(name: str, *, dtype=torch.float32,
                    param_dtype=torch.float32, bn_momentum: float = 0.9,
                    bn_eps: float = 1e-5, fused_conv_bn: bool = False,
                    device=None) -> torch.nn.Module:
    if name not in _REGISTRY:
        if name in NOT_YET_PORTED:
            raise ValueError(f"model '{name}' is not yet ported to "
                             f"tpuic_torch; available: {available_models()}")
        raise ValueError(f"unknown model '{name}'; available: "
                         f"{available_models()}")
    return _REGISTRY[name](dtype=_dtype(dtype),
                           param_dtype=_dtype(param_dtype),
                           bn_momentum=bn_momentum, bn_eps=bn_eps,
                           fused_inference=fused_conv_bn,
                           device=resolve_device(device))


def create_model(name: str, num_classes: int, *, head_widths=(128, 64, 32),
                 dtype="bfloat16", param_dtype="float32",
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                 fused_conv_bn: bool = False, device=None) -> Classifier:
    """The ``tpuic.models.create_model`` counterpart, built on ``device``
    (``None`` = the card)."""
    device = resolve_device(device)
    backbone = create_backbone(name, dtype=dtype, param_dtype=param_dtype,
                               bn_momentum=bn_momentum, bn_eps=bn_eps,
                               fused_conv_bn=fused_conv_bn, device=device)
    return Classifier(backbone, num_classes, tuple(head_widths),
                      dtype=_dtype(dtype), param_dtype=_dtype(param_dtype),
                      device=device)


def create_model_from_config(cfg: ModelConfig, device=None) -> Classifier:
    return create_model(cfg.name, cfg.num_classes,
                        head_widths=cfg.head_widths, dtype=cfg.dtype,
                        param_dtype=cfg.param_dtype,
                        bn_momentum=cfg.bn_momentum, bn_eps=cfg.bn_eps,
                        fused_conv_bn=cfg.fused_conv_bn, device=device)


register("resnet18", _resnet.resnet18)
register("resnet34", _resnet.resnet34)
register("resnet50", _resnet.resnet50)
register("resnet101", _resnet.resnet101)
register("resnet152", _resnet.resnet152)
register("resnet18-cifar", lambda **kw: _resnet.resnet18(small_stem=True,
                                                         **kw))
# Space-to-depth stem: the 7x7/s2 stem re-indexed as 4x4/s1 on
# [H/2, W/2, 12]; convert standard stem weights with
# models.resnet.s2d_stem_kernel.
register("resnet50-s2d", lambda **kw: _resnet.resnet50(space_to_depth=True,
                                                       **kw))
