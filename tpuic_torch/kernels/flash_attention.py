"""Flash attention, forward and backward: the Hopper port of K4.

Replaces ``tpuic/kernels/flash_attention.py``: ``_fwd_kernel`` (the
online-softmax forward, which also writes the log-sum-exp the backward
reads), ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the blockwise backward
``ds = p * (dp - rowsum(do * o))``), each launched by ``pl.pallas_call``,
and their lane-packed variants, which exist for the TPU's 128-lane tiling
only.  The CUDA kernels (``csrc/flash_attention.cu``) read ``[B, N, H,
D]`` tensors through their strides, so the strided q/k/v views of a qkv
projection go in with no copy and no padding.

Layout and numerics:

- q, k, v, o, do: ``[B, N, H, D]``, float32 or bfloat16 (one dtype), the
  head dim contiguous; D in (16, 32, 64, 128).  Scores, softmax and
  accumulation are float32 whatever the input type.
- ``lse``: float32 ``[B, H, N]``, unpadded: the natural log of the sum of
  ``exp(s)`` over the valid keys, and ``masked_sentinel`` for a row with
  no valid key, whose output is 0.  (``tpuic`` keeps ``[B*H, 1,
  N_padded]`` for the TPU's (8, 128) block rule; the meaning is the same.)
- Keys at or past ``valid_len``, or past ``*valid`` (a 1-element int32
  tensor on the device, read by the kernel, so no host sync), get the
  score ``-1e30``, as in the reference.  ``masked_sentinel`` is 0.0 for
  the single-call path; the ring composition passes ``-1e30``.
- ``delta = rowsum(do * o)`` is computed by the dq kernel's prologue and
  written out for the dk/dv kernel, which runs after it on the stream.
- Every kernel runs on the tensor cores: float32 in 3xTF32, which keeps
  float32 accuracy whatever ``torch.backends.cuda.matmul.allow_tf32``
  says (they read no flag, and give the same bits either way); bfloat16
  with ``p`` (and ``ds``) rounded to bf16 before the second product, as
  the reference does.  They copy rows 16 bytes at a time, so a tensor
  whose rows are not 16-byte aligned goes in as a contiguous copy.  A
  query row's output depends only on its own (b, h) slice: the same bits
  at batch 1 as inside batch 32.

:func:`flash_attention` is a ``torch.autograd.Function`` (the reference's
``custom_vjp``): its forward saves ``(q, k, v, o, lse)``, all O(N*D), and
never an ``[N, N]`` tensor.  Each wrapper takes its plain version (the
kernel's arithmetic in plain PyTorch, ``torch.matmul`` and float32
softmax) only for CPU tensors; for CUDA tensors it launches the kernel or
raises.  ``.launches`` on ``flash_attention_fwd``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tpuic_torch.kernels.counting import count_launch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
#: The head dim of the forward's TMA and wgmma build for bfloat16
#: (``csrc/flash_fwd_sm90.cu``); other head dims and float32 take the
#: mma.sync build of ``csrc/flash_attention.cu``.
SM90_HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _key_mask(n: int, valid_len: Optional[int], valid, device):
    """[N] bool: the keys that are attended to."""
    kpos = torch.arange(n, device=device)
    if valid is not None:
        return kpos < valid.reshape(()).to(device)
    return kpos < (n if valid_len is None else int(valid_len))


def _heads_first(t):
    """[B, N, H, D] -> float32 [B, H, N, D]."""
    return t.float().permute(0, 2, 1, 3)


def _heads_last(t, like):
    """float32 [B, H, N, D] -> [B, N, H, D] in ``like``'s dtype."""
    return t.permute(0, 2, 1, 3).contiguous().to(like.dtype)


def flash_attention_fwd_plain(q, k, v, *, valid_len: Optional[int] = None,
                              valid=None, masked_sentinel: float = 0.0):
    """``_fwd_kernel``'s function: ``(o [B, N, H, D], lse [B, H, N])``."""
    n, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    keep = _key_mask(n, valid_len, valid, q.device)
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2))
    s = torch.where(keep, s * scale, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p, _heads_first(v)) / l
    masked = m <= NEG_INF / 2
    o = torch.where(masked, 0.0, o)
    lse = torch.where(masked, masked_sentinel, m + torch.log(l))[..., 0]
    return _heads_last(o, q), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *,
                              valid_len: Optional[int] = None, valid=None):
    """``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``'s function: ``(dq, dk,
    dv)``, each [B, N, H, D] in its operand's dtype.  ``p`` is rebuilt
    from ``lse``; ``delta = rowsum(do * o)``."""
    n, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (_heads_first(t) for t in (q, k, v, o, do))
    keep = _key_mask(n, valid_len, valid, q.device)
    s = torch.where(keep, scale * torch.matmul(qf, kf.transpose(-1, -2)),
                    NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    delta = torch.sum(gf * of, dim=-1, keepdim=True)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return _heads_last(dq, q), _heads_last(dk, k), _heads_last(dv, v)


def bind(lib):
    """``lib`` (a build of ``csrc/flash_attention.cu``) with its C entry
    points' signatures declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpuic_flash_fwd.argtypes = [p] * 7 + [i] * 6 + [f, f, p]
    lib.tpuic_flash_bwd_dq.argtypes = [p] * 10 + [i] * 6 + [f, p]
    lib.tpuic_flash_bwd_dkv.argtypes = [p] * 10 + [i] * 6 + [f, p]
    for fn in (lib.tpuic_flash_fwd, lib.tpuic_flash_bwd_dq,
               lib.tpuic_flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = getattr(_lib, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _lib.cdll = bind(_build.load("flash_attention"))
    return lib


def bind_sm90(lib):
    """``lib`` (a build of ``csrc/flash_fwd_sm90.cu``) with its entry
    point's signature declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpuic_flash_fwd_sm90.argtypes = [p] * 7 + [i] * 4 + [f, f, p]
    lib.tpuic_flash_fwd_sm90.restype = ctypes.c_int
    return lib


def _lib_sm90():
    lib = getattr(_lib_sm90, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _lib_sm90.cdll = bind_sm90(_build.load("flash_fwd_sm90"))
    return lib


def _check_cuda(q, others, valid) -> None:
    """Raise on what the kernels do not take: shapes, dtypes, devices, a
    head dim that is not contiguous, a D they are not built for."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, N, H, D], got {tuple(q.shape)}")
    b, n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernels are "
                         f"built for {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {q.dtype}")
    if b * h >= 2 ** 31 or -(-n // 64) > 65535:
        raise ValueError(f"q {tuple(q.shape)} too large for the kernels' "
                         "grid")
    for name, t in (("q", q),) + tuple(others):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must be {q.dtype} {list(q.shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim, "
                             f"strides {t.stride()}")
    if valid is not None and (valid.device != q.device
                              or valid.dtype != torch.int32
                              or valid.numel() != 1):
        raise ValueError("valid must be a 1-element int32 tensor on "
                         f"{q.device}, got {valid.dtype} "
                         f"{list(valid.shape)} on {valid.device}")


def _check_rows(name, t, q) -> None:
    b, n, h, _ = q.shape
    if (t.device != q.device or t.dtype != torch.float32
            or tuple(t.shape) != (b, h, n) or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 [{b}, {h}, {n}] "
                         f"on {q.device}, got {t.dtype} {list(t.shape)} on "
                         f"{t.device}")


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn, name, q, args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc >= 10000:
        raise RuntimeError(f"{name}: the driver refused a TMA tensor map "
                           f"(CUresult {rc - 10000}) for q {tuple(q.shape)} "
                           f"{q.dtype} with strides {q.stride()}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"for q {tuple(q.shape)} {q.dtype}")


def _row_aligned(t):
    """``t`` itself when every row it has starts on a 16-byte boundary (the
    kernels copy rows into shared memory 16 bytes at a time),
    else a contiguous copy.  The ViT's strided q/k/v views of one qkv
    projection are aligned and go in as they are."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st * size % 16 == 0
            for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _valid_args(q, valid_len, valid):
    n = q.shape[1]
    return (None if valid is None else valid.data_ptr(),
            n if valid_len is None else max(0, min(int(valid_len), n)))


def flash_attention_fwd(q, k, v, *, valid_len: Optional[int] = None,
                        valid=None, masked_sentinel: float = 0.0):
    """``(o, lse)``: o [B, N, H, D] in q's dtype, lse float32 [B, H, N]
    (K4 forward)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, valid_len=valid_len,
                                         valid=valid,
                                         masked_sentinel=masked_sentinel)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, (("k", k), ("v", v)), valid)
    q, k, v = (_row_aligned(t) for t in (q, k, v))
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16 and d == SM90_HEAD_DIM:
        _launch(_lib_sm90().tpuic_flash_fwd_sm90, "flash_attention_fwd", q,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _strides(q, k, v),
                 *_valid_args(q, valid_len, valid), b, n, h,
                 1.0 / math.sqrt(d), float(masked_sentinel)))
        count_launch(flash_attention_fwd)
        return o, lse
    _launch(_lib().tpuic_flash_fwd, "flash_attention_fwd", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _strides(q, k, v),
             *_valid_args(q, valid_len, valid), b, n, h, d,
             _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d),
             float(masked_sentinel)))
    count_launch(flash_attention_fwd)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, o, lse, do, *,
                           valid_len: Optional[int] = None, valid=None):
    """``(dq, delta)``: dq [B, N, H, D] in q's dtype and ``delta =
    rowsum(do * o)``, float32 [B, H, N], which the dk/dv kernel reads (K4
    backward, dq).  CUDA tensors only: on the CPU the backward is
    :func:`flash_attention_bwd_plain`."""
    if q.device.type != "cuda":
        raise ValueError(f"no dq kernel for device {q.device}")
    _check_cuda(q, (("k", k), ("v", v), ("o", o), ("do", do)), valid)
    _check_rows("lse", lse, q)
    q, k, v, o, do = (_row_aligned(t) for t in (q, k, v, o, do))
    b, n, h, d = q.shape
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch(_lib().tpuic_flash_bwd_dq, "flash_attention_bwd_dq", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             _strides(q, k, v, o, do), *_valid_args(q, valid_len, valid), b,
             n, h, d, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d)))
    count_launch(flash_attention_bwd_dq)
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, *,
                            valid_len: Optional[int] = None, valid=None):
    """``(dk, dv)``, each [B, N, H, D] in q's dtype, from the ``delta``
    that :func:`flash_attention_bwd_dq` wrote (K4 backward, dk/dv).  CUDA
    tensors only."""
    if q.device.type != "cuda":
        raise ValueError(f"no dk/dv kernel for device {q.device}")
    _check_cuda(q, (("k", k), ("v", v), ("do", do)), valid)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    q, k, v, do = (_row_aligned(t) for t in (q, k, v, do))
    b, n, h, d = q.shape
    dk = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    _launch(_lib().tpuic_flash_bwd_dkv, "flash_attention_bwd_dkv", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _strides(q, k, v, do), *_valid_args(q, valid_len, valid), b, n,
             h, d, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d)))
    count_launch(flash_attention_bwd_dkv)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *,
                        valid_len: Optional[int] = None, valid=None):
    """``(dq, dk, dv)`` (K4 backward): the plain version for CPU tensors,
    else the dq kernel, then the dk/dv kernel on the delta it wrote."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do,
                                         valid_len=valid_len, valid=valid)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do,
                                       valid_len=valid_len, valid=valid)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                     valid_len=valid_len, valid=valid)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid_len):
        o, lse = flash_attention_fwd(q, k, v, valid_len=valid_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.valid_len = valid_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         valid_len=ctx.valid_len)
        return dq, dk, dv, None


def flash_attention(q, k, v, valid_len: Optional[int] = None):
    """Softmax attention over ``[B, N, H, D]`` q/k/v (bidirectional, no
    causal mask), keys at or past ``valid_len`` masked; ``tpuic``'s
    ``flash_attention`` custom-vjp.  Returns o [B, N, H, D]."""
    return _FlashAttention.apply(q, k, v, valid_len)
