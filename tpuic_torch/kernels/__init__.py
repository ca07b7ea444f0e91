"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources live in ``csrc/`` and are built by ``nvcc`` at first use
(``_build``).  A wrapper takes the plain version for a CPU tensor and
launches its kernel, or raises, for a CUDA tensor.  Ported so far: the
inference fused conv + folded-BN + ReLU (``tpuic/kernels/conv_bn_relu.py``).
"""

from tpuic_torch.kernels.conv_bn_relu import (fold_bn,  # noqa: F401
                                              fused_conv_bn_from_params,
                                              fused_conv_bn_relu,
                                              fused_conv_bn_relu_plain,
                                              no_tf32, pack_conv_bn)
