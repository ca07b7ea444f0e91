"""The configuration fields the port reads (own copy of ``tpuic/config.py``).

Field names and defaults are ``tpuic``'s (``ModelConfig`` and the
normalization/size fields of ``DataConfig``); a test holds the defaults
equal.  The rest of ``tpuic``'s config arrives with the slices that read it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input settings (reference dp/loader.py)."""

    # Image side length; reference hard-codes 299 (train.py:110).
    resize_size: int = 299
    # ImageNet normalization stats (reference dp/loader.py:86-91).
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model settings (reference nn/classifier.py + train.py:122-123)."""

    # Backbone name; reference default 'inceptionv3' (train.py:122).
    name: str = "inceptionv3"
    num_classes: int = 7
    # MLP head widths (reference nn/classifier.py:26-34: in->128->64->32->n).
    head_widths: Sequence[int] = (128, 64, 32)
    # Compute dtype; parameters stay float32.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # BatchNorm momentum/eps matching torch defaults the reference inherits.
    bn_momentum: float = 0.9  # flax convention: ema = m*ema + (1-m)*batch
    bn_eps: float = 1e-5
    # Inference-only fused conv+BN+ReLU kernel for the ResNet family
    # (tpuic_torch/kernels/conv_bn_relu.py): every conv -> BN -> ReLU of an
    # eval-mode forward is one kernel launch with BN folded into its
    # epilogue.  Parameter structure is unchanged; training ignores it.
    fused_conv_bn: bool = False
