"""Fused conv + folded-BN affine + ReLU: the Hopper port of the TPU kernel.

Replaces ``tpuic/kernels/conv_bn_relu.py:_kernel`` (the Pallas kernel
launched by ``pl.pallas_call`` in ``_fused``).  At inference BN is a
per-channel affine of constants, so ``conv -> BN -> ReLU`` becomes one
kernel that applies ``y * scale + bias`` and the ReLU to its float32
accumulators and writes the output once, instead of writing the conv
output, reading it back for BN, writing again and reading again for the
ReLU.

The kernel (``csrc/conv_bn_relu.cu``) is an implicit GEMM in CUDA C++ for
``sm_90a``: output pixels x output channels, reduced over the
``kh*kw*Cin`` taps, gathered from NHWC with zero padding, on the CUDA
cores.  What bounds it on an H100: in float32 the FLOPs against the
card's float32 non-tensor peak (67 TFLOP/s on the SXM part), or, for the
1x1 convs at 7x7, the weight's bytes against HBM bandwidth.  This first
version is simple and right; ``wgmma``/TMA and a tensor-core bf16 path
are later work (the source note says how).

Public layout is the reference's: activations ``[B, H, W, Cin]`` NHWC,
weights ``[kh, kw, Cin, Cout]`` HWIO, ``scale``/``bias`` float32
``[Cout]`` from :func:`fold_bn`.  Padding is four-sided,
``((top, bottom), (left, right))`` — the space-to-depth stem pads
``((2, 1), (2, 1))``.  Accumulation is float32 whatever the input type;
the output takes the input's type.

:func:`fused_conv_bn_relu` takes the plain version only for a tensor that
lies on the CPU.  For a CUDA tensor it launches the kernel or raises.
``fused_conv_bn_relu.launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[int, Sequence[Tuple[int, int]]]
Strides = Union[int, Tuple[int, int]]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BN running stats -> the per-channel affine the kernel applies:
    ``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``,
    float32 rows of shape [Cout] (``tpuic.kernels.fold_bn``)."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    bias = beta.float() - mean.float() * scale
    return scale, bias


def norm_strides(strides: Strides) -> Tuple[int, int]:
    if isinstance(strides, int):
        return (strides, strides)
    return (int(strides[0]), int(strides[1]))


def norm_padding(padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def _out_hw(x, w, strides, padding) -> Tuple[int, int]:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected x [B,H,W,Cin] and w [kh,kw,Cin,Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    _, h, w_in, cin = x.shape
    kh, kw, wcin, _ = w.shape
    if wcin != cin:
        raise ValueError(f"kernel expects Cin={wcin}, input has {cin}")
    (sh, sw), ((pt, pb), (pl, pr)) = strides, padding
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w_in + pl + pr - kw) // sw + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for input {tuple(x.shape)}, kernel "
                         f"{tuple(w.shape)}, strides {strides}, padding "
                         f"{padding}")
    return ho, wo


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls in the block
    (cuDNN's default TF32 keeps about three decimal digits); restores both
    flags on exit."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def fused_conv_bn_relu_plain(x, w, scale, bias, strides: Strides = 1,
                             padding: Padding = 0, relu: bool = True):
    """The kernel's function in plain PyTorch: four-sided ``F.pad``, then
    ``F.conv2d`` in float32 (TF32 off), the affine, the ReLU; NHWC out in
    ``x``'s dtype.  The CPU path of :func:`fused_conv_bn_relu` and the
    reference the kernel is held against on the card."""
    strides, padding = norm_strides(strides), norm_padding(padding)
    _out_hw(x, w, strides, padding)
    (pt, pb), (pl, pr) = padding
    xc = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    with no_tf32():
        y = F.conv2d(xc, w.float().permute(3, 2, 0, 1), stride=strides)
    y = y * scale.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _lib():
    lib = getattr(_lib, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _build.load("conv_bn_relu")
        fn = lib.tpuic_conv_bn_relu
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib.cdll = lib
    return lib


def _check_cuda_args(x, w, scale, bias) -> None:
    cout = w.shape[3]
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/bfloat16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be float32 [{cout}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_conv_bn_relu(x, w, scale, bias, *, strides: Strides = 1,
                       padding: Padding = 0, relu: bool = True):
    """``relu(conv(x, w) * scale + bias)`` with one output write.

    x: [B, H, W, Cin] NHWC; w: [kh, kw, Cin, Cout] HWIO; scale/bias:
    float32 [Cout] from :func:`fold_bn`.  ``relu=False`` stops before the
    activation (the residual-add case).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream or
    raises."""
    strides, padding = norm_strides(strides), norm_padding(padding)
    ho, wo = _out_hw(x, w, strides, padding)
    if x.device.type == "cpu":
        return fused_conv_bn_relu_plain(x, w, scale, bias, strides, padding,
                                        relu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_args(x, w, scale, bias)
    b, h, w_in, cin = x.shape
    kh, kw, _, cout = w.shape
    if b * ho * wo >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"input {tuple(x.shape)} is too large for the "
                         "kernel's 32-bit pixel index")
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    (sh, sw), ((pt, _), (pl, _)) = strides, padding
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tpuic_conv_bn_relu(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w_in, cin, kh, kw, cout, ho, wo, sh, sw,
            pt, pl, int(bool(relu)), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[w.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"conv_bn_relu kernel launch failed: CUDA error "
                           f"{rc} for x {tuple(x.shape)}, w {tuple(w.shape)}")
    fused_conv_bn_relu.launches += 1
    return out


fused_conv_bn_relu.launches = 0


def pack_conv_bn(weight, gamma, beta, mean, var, eps: float = 1e-5):
    """An ``nn.Conv2d`` OIHW weight and its BN leaves -> the ``(HWIO
    weight, scale, bias)`` the kernel takes.  The model does this once per
    set of weights, not per call."""
    w = weight.detach().permute(2, 3, 1, 0).contiguous()
    scale, bias = fold_bn(gamma.detach(), beta.detach(), mean, var, eps)
    return w, scale.contiguous(), bias.contiguous()


def fused_conv_bn_from_params(x, weight, gamma, beta, mean, var, *,
                              strides: Strides = 1, padding: Padding = 0,
                              relu: bool = True, eps: float = 1e-5):
    """Convenience over module tensors (``tpuic``'s
    ``fused_conv_bn_from_flax``): ``weight`` is the ``nn.Conv2d`` OIHW
    weight, ``gamma``/``beta``/``mean``/``var`` the BN weight, bias and
    running statistics.  Folds and repacks on every call."""
    w, scale, bias = pack_conv_bn(weight, gamma, beta, mean, var, eps)
    return fused_conv_bn_relu(x, w, scale, bias, strides=strides,
                              padding=padding, relu=relu)
