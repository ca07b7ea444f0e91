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
``kh*kw*Cin`` taps, gathered from NHWC with zero padding.  With float32
weights it runs on the tensor cores in 3xTF32 (``mma.sync``, three TF32
products a float32 product, so the result keeps float32 accuracy whatever
``torch.backends.cudnn.allow_tf32`` says), fed by a ring of ``cp.async``
stages, with a deterministic split-K for the shapes whose grid would not
fill the card.  bf16 activations with float32 weights (what
``create_model(dtype="bfloat16")`` builds, and the serve ladder's bf16
rung) with Cin and Cout multiples of 64 take a second build,
``csrc/conv_bn_relu_sm90.cu``: the same implicit GEMM on ``wgmma``, w in
bf16 parts (a float32 w split by the wrapper into hi and lo, which keep 16
of its bits; a bf16 w, as the bf16 rung folds, its own single part); the
stem and other bf16 shapes take the first, with bf16 weights widened to
float32 before the launch (exactly).  :func:`plan` and :func:`plan_sm90`
pick the tiling from the shape; the sources' notes say what bounds each
build and what its design does about it.

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
import functools
import threading
from typing import Dict, NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpuic_torch.kernels.counting import count_launch

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


# The TF32 flags are global to the process, so the lock that keeps one
# thread from restoring them under another's block is too.
_TF32_FLAGS = threading.RLock()


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls in the block
    (cuDNN's default TF32 keeps about three decimal digits); restores both
    flags on exit.  Blocks of several threads run one after another (the
    flags are process-global: a thread leaving its block would otherwise
    turn TF32 back on under another thread's forward)."""
    with _TF32_FLAGS:
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


class Plan(NamedTuple):
    """How the kernel runs one shape (:func:`plan`)."""
    bm: int       # output pixels a block: 64 or 128 (64 output channels)
    splits: int   # K slices (split-K), summed in slice order 0..splits-1
    gather: int   # bytes an activation copy moves: 16, or one element
    wgather: int  # bytes a weight copy moves: 16 or 4


# An H100 has 132 SMs; a grid of fewer than two blocks an SM leaves the
# card short of warps to hide latency with, so K is split until it has them.
SMS = 132
TARGET_BLOCKS = 2 * SMS
BN = 64                  # output channels a block
# The batch the slice count is chosen for, whatever the call's batch: the
# order of a row's K sum must not depend on the batch it rides in (the
# engine pads requests into buckets of 1, 8 and 32).
NOMINAL_BATCH = 8
BK = 32                  # K values a stage
MAX_SPLITS = 16
MIN_STAGES = 4           # a slice walks at least 4 stages (128 K values)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(x_shape, w_shape, strides: Strides = 1, padding: Padding = 0,
         dtype=torch.float32) -> Plan:
    """The kernel's tiling for x ``[B, H, W, Cin]`` (``dtype``) and float32
    w ``[kh, kw, Cin, Cout]``.

    Depends on everything but B: the block height, the split count and so
    the order of every output's K sum are chosen at a nominal batch of 8,
    so a row's bits are the same at any batch.  Blocks are 128 pixels
    high where the grid at batch 8 still has three blocks an SM, else 64.
    Split-K goes in until the grid at batch 8 has two blocks an SM, while
    each slice keeps four stages.  The activation gather copies 16 bytes
    (4 float32 or 8 bf16 channels of one tap) when Cin allows, else one
    element; the weight tile 16 bytes when Cout % 4 == 0, else 4.  The
    wrapper narrows either to one element for a tensor that is not
    16-byte aligned."""
    strides, padding = norm_strides(strides), norm_padding(padding)
    _, h, w_in, cin = x_shape
    kh, kw, _, cout = w_shape
    (sh, sw), ((pt, pb), (pl, pr)) = strides, padding
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w_in + pl + pr - kw) // sw + 1
    size = dtype.itemsize
    gather = 16 if cin % (16 // size) == 0 else size
    wgather = 16 if cout % 4 == 0 else 4
    m, n_tiles = NOMINAL_BATCH * ho * wo, _cdiv(cout, BN)
    bm = 128 if _cdiv(m, 128) * n_tiles >= 3 * SMS else 64
    tiles = _cdiv(m, bm) * n_tiles
    stages = _cdiv(kh * kw * cin, BK)
    splits = 1
    while (tiles * splits < TARGET_BLOCKS and splits < MAX_SPLITS
           and _cdiv(stages, splits + 1) >= MIN_STAGES):
        splits += 1
    splits = _cdiv(stages, _cdiv(stages, splits))  # no empty slice
    return Plan(bm, splits, gather, wgather)


# The bf16 build (csrc/conv_bn_relu_sm90.cu): 128 pixels x 128 output
# channels a block, stages of one tap's 64 input channels.
SM90_BM = 128
SM90_BN = 128
SM90_BK = 64
SM90_NOMINAL_BATCH = 32


def takes_sm90(x_shape, w_shape, dtype) -> bool:
    """Whether the wgmma build runs this call: bf16 x, Cin and Cout
    multiples of 64 (every ResNet-50 conv but the stem)."""
    return (dtype == torch.bfloat16 and x_shape[3] % SM90_BK == 0
            and w_shape[3] % BN == 0)


def plan_sm90(x_shape, w_shape, strides: Strides = 1,
              padding: Padding = 0) -> Tuple[int, int]:
    """The wgmma build's ``(splits, output channels a block)``:
    128-channel blocks, or 64 where those would leave the card short of
    two blocks an SM, then split-K slices until it has them, each keeping
    two 64-deep stages (the 128 K values of :func:`plan`'s slices).
    Chosen, as :func:`plan`'s, for a nominal batch whatever the call's, so
    a row's bits do not depend on its batch: for the engine's largest
    bucket, SM90_NOMINAL_BATCH, where a slice's partial-tile round trip
    costs more than it wins once the grid is full."""
    strides, padding = norm_strides(strides), norm_padding(padding)
    _, h, w_in, cin = x_shape
    b = SM90_NOMINAL_BATCH
    kh, kw, _, cout = w_shape
    (sh, sw), ((pt, pb), (pl, pr)) = strides, padding
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w_in + pl + pr - kw) // sw + 1
    nb = SM90_BN
    tiles = _cdiv(b * ho * wo, SM90_BM) * _cdiv(cout, nb)
    if tiles < TARGET_BLOCKS:
        nb = BN
        tiles = _cdiv(b * ho * wo, SM90_BM) * _cdiv(cout, nb)
    stages = kh * kw * cin // SM90_BK
    splits = 1
    while (tiles * splits < TARGET_BLOCKS and splits < MAX_SPLITS
           and _cdiv(stages, splits + 1) >= MIN_STAGES * BK // SM90_BK):
        splits += 1
    return _cdiv(stages, _cdiv(stages, splits)), nb  # no empty slice


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares ``tpuic_conv_bn_relu``'s C signature on a library built
    from ``csrc/conv_bn_relu.cu``: seven pointers, the int32 dims array,
    vec_x, vec_w and the stream."""
    fn = lib.tpuic_conv_bn_relu
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = getattr(_lib, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _lib.cdll = bind(_build.load("conv_bn_relu"))
    return lib


def bind_sm90(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares ``tpuic_conv_bn_relu_sm90``'s C signature on a library
    built from ``csrc/conv_bn_relu_sm90.cu``: eight pointers, the int32
    dims array and the stream."""
    fn = lib.tpuic_conv_bn_relu_sm90
    fn.argtypes = [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return lib


def _lib_sm90():
    lib = getattr(_lib_sm90, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _lib_sm90.cdll = bind_sm90(_build.load("conv_bn_relu_sm90"))
    return lib


@functools.lru_cache(maxsize=4096)
def _launch_spec(x_shape, w_shape, strides, padding, relu, dtype):
    """The shape-only work of a launch, once per distinct call (a serving
    or eval loop makes the same few dozen): the plan, the output shape, the
    kernel's integer arguments as an int32 array (kept alive here) and its
    address, the output tiles a split-K launch counts and the float32s of
    one partial tile."""
    b, h, w_in, cin = x_shape
    kh, kw, _, cout = w_shape
    (sh, sw), ((pt, pb), (pl, pr)) = strides, padding
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w_in + pl + pr - kw) // sw + 1
    if b * ho * wo >= 2 ** 31:
        raise ValueError(f"input {tuple(x_shape)} is too large for the "
                         "kernel's 32-bit pixel index")
    if takes_sm90(x_shape, w_shape, dtype):
        # The wgmma build: 128 pixels a block, its own slice count.
        splits, bn = plan_sm90(x_shape, w_shape, strides, padding)
        pl_ = Plan(SM90_BM, splits, 16, 16)
        dims = (ctypes.c_int * 16)(b, h, w_in, cin, kh, kw, cout, ho, wo,
                                   sh, sw, pt, pl, int(bool(relu)),
                                   pl_.splits, bn)
    else:
        pl_ = plan(x_shape, w_shape, strides, padding, dtype)
        dims = (ctypes.c_int * 17)(b, h, w_in, cin, kh, kw, cout, ho, wo, sh,
                                   sw, pt, pl, int(bool(relu)),
                                   _DTYPE_CODE[dtype], pl_.bm, pl_.splits)
        bn = BN
    tiles = _cdiv(b * ho * wo, pl_.bm) * _cdiv(cout, bn)
    # The wgmma build keeps a 128 x 128 partial tile whatever its width.
    tile_floats = pl_.bm * (SM90_BN if len(dims) == 16 else BN)
    return (pl_, (b, ho, wo, cout), (dims, ctypes.addressof(dims)), tiles,
            tile_floats)


class _Scratch:
    """Split-K scratch of one (device, stream): the partial tiles and one
    int32 counter per output tile, grown as needed.  Launches in order on
    one stream can share it: a launch reads its partials before it ends,
    and the kernel leaves every counter it took at zero again."""

    def __init__(self):
        self.ws = self.counters = None

    def get(self, device, floats: int, tiles: int):
        if self.ws is None or self.ws.numel() < floats:
            self.ws = torch.empty(floats, dtype=torch.float32, device=device)
        if self.counters is None or self.counters.numel() < tiles:
            self.counters = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                        device=device)
        return self.ws, self.counters


_SCRATCH: Dict[Tuple[int, int], _Scratch] = {}


def _check_cuda_args(x, w, scale, bias) -> None:
    cout = w.shape[3]
    dev = x.get_device()
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/bfloat16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (cout,):
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
    version; a CUDA tensor launches the kernel on the current stream with
    the tiling of :func:`plan` (bf16 x with Cin and Cout multiples of 64:
    the wgmma build, split as :func:`plan_sm90` says; a float32 w goes in as
    bf16 parts hi + lo, a bf16 w as it is), or raises.  The mma.sync build
    takes a bf16 w widened to float32: exact, the same function."""
    strides, padding = norm_strides(strides), norm_padding(padding)
    _out_hw(x, w, strides, padding)
    if x.device.type == "cpu":
        return fused_conv_bn_relu_plain(x, w, scale, bias, strides, padding,
                                        relu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_args(x, w, scale, bias)
    sm90 = takes_sm90(x.shape, w.shape, x.dtype)
    w_lo = None
    if sm90:
        # w as bf16 parts hi + lo (a bf16 w is its hi alone), each an
        # aligned tensor: the wgmma build copies 16 bytes at a time.
        if w.dtype != torch.bfloat16:
            w_hi = w.to(torch.bfloat16)
            w_lo = (w - w_hi.float()).to(torch.bfloat16)
            w = w_hi
        x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
    elif w.dtype != torch.float32:
        w = w.float()
    if x.numel() >= 2 ** 31:
        raise ValueError(f"input {tuple(x.shape)} is too large for the "
                         "kernel's 32-bit pixel index")
    pl_, out_shape, (_, dims), tiles, tile_floats = _launch_spec(
        tuple(x.shape), tuple(w.shape), strides, padding, bool(relu),
        x.dtype)
    xp, wp = x.data_ptr(), w.data_ptr()
    # The 16-byte copies need 16-byte aligned tensors: a view that starts
    # elsewhere is copied one element at a time.
    vec_x = int(pl_.gather == 16 and xp % 16 == 0)
    vec_w = int(pl_.wgather == 16 and wp % 16 == 0)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    dev = x.get_device()
    # The launch goes to x's device; the context switch costs host time, so
    # it is taken only when another device is current.
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev)
        wsp = cp = None
        if pl_.splits > 1:
            # Per tile and slice, the block's partial tile.
            ws, counters = _SCRATCH.setdefault((dev, stream), _Scratch()).get(
                x.device, tiles * pl_.splits * tile_floats, tiles)
            wsp, cp = ws.data_ptr(), counters.data_ptr()
        if sm90:
            rc = _lib_sm90().tpuic_conv_bn_relu_sm90(
                xp, wp, None if w_lo is None else w_lo.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(), wsp, cp,
                dims, stream)
        else:
            rc = _lib().tpuic_conv_bn_relu(
                xp, wp, scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                wsp, cp, dims, vec_x, vec_w, stream)
    if rc != 0:
        raise RuntimeError(f"conv_bn_relu kernel launch failed: CUDA error "
                           f"{rc} for x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"{pl_}")
    count_launch(fused_conv_bn_relu)
    return out


fused_conv_bn_relu.launches = 0


def pack_conv_bn(weight, gamma, beta, mean, var, eps: float = 1e-5):
    """An ``nn.Conv2d`` OIHW weight and its BN leaves -> the ``(HWIO
    weight, scale, bias)`` the kernel takes.  The model does this once per
    set of weights, not per call.  A bf16 weight (the serve ladder's bf16
    rung) stays bf16: the wgmma build reads it as it is."""
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
