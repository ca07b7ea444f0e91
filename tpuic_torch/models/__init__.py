"""Model registry (``tpuic/models/__init__.py``).

``create_model(name, num_classes)`` builds ``Classifier(backbone, head)``
with the same names, defaults and parameter structure as ``tpuic``'s.
The ResNet, InceptionV3, EfficientNet and dense ViT families are ported;
the MoE ViTs raise ``ValueError`` saying they are not ported yet.
InceptionV3 and EfficientNet keep BN eps 1e-3 and float32 statistics
whatever ``bn_eps`` and ``bn_f32_stats`` say, and ``fused_conv_bn`` stays
ResNet-only, as in ``tpuic`` (``tpuic/models/__init__.py:146-193``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpuic_torch.config import ATTENTION_IMPLS, ModelConfig
from tpuic_torch.device import resolve_device
from tpuic_torch.models import efficientnet as _effnet
from tpuic_torch.models import inception as _inception
from tpuic_torch.models import resnet as _resnet
from tpuic_torch.models import vit as _vit
from tpuic_torch.models.classifier import Classifier

# name -> (factory, has_aux)
_REGISTRY: Dict[str, Tuple[Callable[..., torch.nn.Module], bool]] = {}

#: ``tpuic`` model names whose backbones are later slices of the port.
NOT_YET_PORTED = ("vit-s16-moe", "vit-tiny-moe")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def register(name: str, factory: Callable[..., torch.nn.Module],
             has_aux: bool = False) -> None:
    _REGISTRY[name] = (factory, has_aux)


def available_models():
    return sorted(_REGISTRY)


def _dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if dt not in _DTYPES:
        raise ValueError(f"unknown dtype {dt!r}; available: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[dt]


def create_backbone(name: str, num_classes: int = 0, *,
                    dtype=torch.float32, param_dtype=torch.float32,
                    bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                    attention: str = "dense", bn_f32_stats: bool = True,
                    drop_path: float = 0.0, fused_conv_bn: bool = False,
                    image_size: Optional[int] = None,
                    device=None) -> Tuple[torch.nn.Module, bool]:
    """``(backbone, has_aux)``.  ``num_classes`` sizes InceptionV3's aux
    head; ``image_size`` sizes the ViT's position embedding (default 224);
    CNNs ignore it, as they ignore ``attention`` and ``drop_path``."""
    if name not in _REGISTRY:
        if name in NOT_YET_PORTED:
            raise ValueError(f"model '{name}' is not yet ported to "
                             f"tpuic_torch; available: {available_models()}")
        raise ValueError(f"unknown model '{name}'; available: "
                         f"{available_models()}")
    if attention not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl '{attention}'; "
                         f"available: {ATTENTION_IMPLS}")
    factory, has_aux = _REGISTRY[name]
    return factory(num_classes=num_classes, dtype=_dtype(dtype),
                   param_dtype=_dtype(param_dtype),
                   bn_momentum=bn_momentum, bn_eps=bn_eps,
                   attention=attention, bn_f32_stats=bn_f32_stats,
                   drop_path=drop_path, fused_conv_bn=fused_conv_bn,
                   image_size=image_size,
                   device=resolve_device(device)), has_aux


def create_model(name: str, num_classes: int, *, head_widths=(128, 64, 32),
                 dtype="bfloat16", param_dtype="float32",
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                 attention: str = "dense", bn_f32_stats: bool = True,
                 drop_path: float = 0.0, fused_conv_bn: bool = False,
                 image_size: Optional[int] = None,
                 device=None) -> Classifier:
    """The ``tpuic.models.create_model`` counterpart, built on ``device``
    (``None`` = the card)."""
    device = resolve_device(device)
    backbone, has_aux = create_backbone(
        name, num_classes, dtype=dtype, param_dtype=param_dtype,
        bn_momentum=bn_momentum, bn_eps=bn_eps, attention=attention,
        bn_f32_stats=bn_f32_stats, drop_path=drop_path,
        fused_conv_bn=fused_conv_bn, image_size=image_size, device=device)
    return Classifier(backbone, num_classes, tuple(head_widths),
                      has_aux=has_aux, dtype=_dtype(dtype),
                      param_dtype=_dtype(param_dtype), device=device)


def create_model_from_config(cfg: ModelConfig, device=None,
                             image_size: Optional[int] = None) -> Classifier:
    return create_model(cfg.name, cfg.num_classes,
                        head_widths=cfg.head_widths, dtype=cfg.dtype,
                        param_dtype=cfg.param_dtype,
                        bn_momentum=cfg.bn_momentum, bn_eps=cfg.bn_eps,
                        attention=cfg.attention,
                        bn_f32_stats=cfg.bn_f32_stats,
                        drop_path=cfg.drop_path,
                        fused_conv_bn=cfg.fused_conv_bn,
                        image_size=image_size, device=device)


def _cnn(factory, **extra):
    def make(*, num_classes, dtype, param_dtype, bn_momentum, bn_eps,
             attention, bn_f32_stats, drop_path, fused_conv_bn, image_size,
             device):
        del num_classes, attention, drop_path, image_size  # ViT/aux only
        return factory(dtype=dtype, param_dtype=param_dtype,
                       bn_momentum=bn_momentum, bn_eps=bn_eps,
                       bn_f32_stats=bn_f32_stats,
                       fused_inference=fused_conv_bn, device=device, **extra)
    return make


def _eff(variant):
    def make(*, num_classes, dtype, param_dtype, bn_momentum, bn_eps,
             attention, bn_f32_stats, drop_path, fused_conv_bn, image_size,
             device):
        # eps 1e-3 and float32 statistics whatever the config says; the
        # stochastic depth stays tpuic's default 0.2, as tpuic's factory
        # never overrides it.
        del (num_classes, bn_eps, attention, bn_f32_stats, drop_path,
             fused_conv_bn, image_size)
        return _effnet.efficientnet(variant, dtype=dtype,
                                    param_dtype=param_dtype,
                                    bn_momentum=bn_momentum, device=device)
    return make


def _inc(*, num_classes, dtype, param_dtype, bn_momentum, bn_eps, attention,
         bn_f32_stats, drop_path, fused_conv_bn, image_size, device):
    # eps 1e-3 and float32 statistics; the aux head is num_classes wide.
    del (bn_eps, attention, bn_f32_stats, drop_path, fused_conv_bn,
         image_size)
    return _inception.InceptionV3(aux_classes=num_classes, dtype=dtype,
                                  param_dtype=param_dtype,
                                  bn_momentum=bn_momentum, device=device)


def _vit_factory(ctor):
    def make(*, num_classes, dtype, param_dtype, bn_momentum, bn_eps,
             attention, bn_f32_stats, drop_path, fused_conv_bn, image_size,
             device):
        del num_classes, bn_momentum, bn_eps, bn_f32_stats  # no BN
        del fused_conv_bn  # ResNet-only
        return ctor(dtype=dtype, param_dtype=param_dtype,
                    attention=attention, drop_path=drop_path,
                    image_size=224 if image_size is None else image_size,
                    device=device)
    return make


register("resnet18", _cnn(_resnet.resnet18))
register("resnet34", _cnn(_resnet.resnet34))
register("resnet50", _cnn(_resnet.resnet50))
register("resnet101", _cnn(_resnet.resnet101))
register("resnet152", _cnn(_resnet.resnet152))
register("resnet18-cifar", _cnn(_resnet.resnet18, small_stem=True))
# Space-to-depth stem: the 7x7/s2 stem re-indexed as 4x4/s1 on
# [H/2, W/2, 12]; convert standard stem weights with
# models.resnet.s2d_stem_kernel.
register("resnet50-s2d", _cnn(_resnet.resnet50, space_to_depth=True))
for _v in _effnet._SCALING:
    register(f"efficientnet-{_v}", _eff(_v))
register("inceptionv3", _inc, has_aux=True)
register("vit-b16", _vit_factory(_vit.vit_b16))
register("vit-l16", _vit_factory(_vit.vit_l16))
register("vit-b32", _vit_factory(_vit.vit_b32))
register("vit-l32", _vit_factory(_vit.vit_l32))
register("vit-s16", _vit_factory(_vit.vit_s16))
register("vit-tiny", _vit_factory(_vit.vit_tiny))
