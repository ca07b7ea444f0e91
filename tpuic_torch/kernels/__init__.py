"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources live in ``csrc/`` and are built by ``nvcc`` at first use
(``_build``).  A wrapper takes the plain version for a CPU tensor and
launches its kernel, or raises, for a CUDA tensor.  Ported so far:

- K3, the inference fused conv + folded-BN + ReLU
  (``tpuic/kernels/conv_bn_relu.py``): ``conv_bn_relu``;
- K1, the fused weighted cross-entropy forward and backward
  (``tpuic/kernels/cross_entropy.py``): ``cross_entropy``;
- K2, the fused LARS and LAMB updates
  (``tpuic/kernels/optimizer_update.py``): ``optimizer_update``;
- K4, flash attention, forward and the dq and dk/dv backward
  (``tpuic/kernels/flash_attention.py``): ``flash_attention``.
"""

from tpuic_torch.kernels.conv_bn_relu import (fold_bn,  # noqa: F401
                                              fused_conv_bn_from_params,
                                              fused_conv_bn_relu,
                                              fused_conv_bn_relu_plain,
                                              no_tf32, pack_conv_bn)
from tpuic_torch.kernels.cross_entropy import (  # noqa: F401
    cross_entropy_bwd, cross_entropy_bwd_plain, cross_entropy_fwd,
    cross_entropy_fwd_plain, fused_weighted_cross_entropy)
from tpuic_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from tpuic_torch.kernels.optimizer_update import (  # noqa: F401
    lamb_update, lamb_update_plain, lars_update, lars_update_plain)


def counted_kernels() -> tuple:
    """Every kernel wrapper that counts its launches (``.launches``): the
    wrappers add one where they launch their kernel, and the serve engine
    adds a CUDA graph's launches at each replay."""
    return (fused_conv_bn_relu, cross_entropy_fwd, cross_entropy_bwd,
            lars_update, lamb_update, flash_attention_fwd,
            flash_attention_bwd_dq, flash_attention_bwd_dkv)
