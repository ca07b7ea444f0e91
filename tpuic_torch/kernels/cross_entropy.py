"""Fused weighted cross-entropy (forward + backward): the Hopper port of K1.

Replaces ``tpuic/kernels/cross_entropy.py``: ``_fwd_kernel`` (per-row
log-sum-exp, smoothed NLL and the weight ``w = cw[y] * mask``) and
``_bwd_kernel`` (``(softmax - target) * w * g / sum(w)``), each launched
by ``pl.pallas_call``.  Numerics are ``tpuic.train.loss``'s: per-sample
NLL times the label's class weight, normalised by the sum of applied
weights; an optional validity mask; optional label smoothing, where ``w``
comes from the unsmoothed one-hot.  A label outside ``[0, C)`` gets
``w = 0`` (its one-hot is empty), as in the Pallas kernel.

:func:`fused_weighted_cross_entropy` is a ``torch.autograd.Function``.
Its forward runs :func:`cross_entropy_fwd` (per-row ``w * nll`` and
``w``) and keeps the normalisation ``sum(w * nll) / max(sum(w), 1e-12)``
as torch ops outside the kernel; its backward runs
:func:`cross_entropy_bwd` with ``scale = g / max(sum(w), 1e-12)`` passed
as a device tensor, so a step reads nothing back to the host.  A
data-parallel step passes the global batch's ``sum(w)`` in place of the
local one, as ``tpuic`` passes its global scale into ``_bwd_kernel``.

Each wrapper takes its plain version (``cross_entropy_fwd_plain``,
``cross_entropy_bwd_plain``, the Pallas kernels' arithmetic in plain
PyTorch) only for CPU tensors; for CUDA tensors it launches the kernel of
``csrc/cross_entropy.cu`` or raises.  ``.launches`` on each wrapper counts
kernel launches.  The kernels take float32 logits (the classifier head
returns float32) and int32 labels.  Each kernel reads a row once: the
forward a warp per row, the backward a 128-thread block per row that keeps
rows up to C = 1024 in registers.  A row's bits do not depend on its
batch.  ``cross_entropy_bench`` keeps the earlier designs and the
backward's warp-per-row variant and times them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpuic_torch.kernels.counting import count_launch


def _targets(x, labels, label_smoothing: float):
    """(onehot, smoothed target) for [B, C] float32 logits."""
    c = x.shape[-1]
    classes = torch.arange(c, device=x.device)
    onehot = (classes[None, :] == labels[:, None].long()).float()
    if label_smoothing > 0.0:
        return onehot, onehot * (1.0 - label_smoothing) + label_smoothing / c
    return onehot, onehot


def cross_entropy_fwd_plain(logits, labels, cw, mask,
                            label_smoothing: float = 0.0):
    """``_fwd_kernel``'s function: per-row ``(w * nll, w)``, float32 [B]."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1, keepdim=True)
    onehot, target = _targets(x, labels, label_smoothing)
    nll = -torch.sum(target * (x - lse), dim=-1)
    w = torch.sum(onehot * cw[None, :].float(), dim=-1) * mask.float()
    return w * nll, w


def cross_entropy_bwd_plain(logits, labels, cw, mask, scale,
                            label_smoothing: float = 0.0):
    """``_bwd_kernel``'s function: ``(softmax - target) * w * scale`` in
    the logits' dtype; ``scale`` is a 0-d tensor."""
    x = logits.float()
    p = torch.softmax(x, dim=-1)
    onehot, target = _targets(x, labels, label_smoothing)
    w = torch.sum(onehot * cw[None, :].float(), dim=-1) * mask.float()
    return ((p - target) * (w * scale.float())[:, None]).to(logits.dtype)


def bind(lib):
    """``lib`` (a build of ``csrc/cross_entropy.cu``) with its C entry
    points declared."""
    for fn in (lib.tpuic_xent_fwd, lib.tpuic_xent_bwd):
        fn.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = getattr(_lib, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _lib.cdll = bind(_build.load("cross_entropy"))
    return lib


def _check_cuda_args(logits, labels, cw, mask, scale=None) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits must be [B, C], got {tuple(logits.shape)}")
    b, c = logits.shape
    if b >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"logits {tuple(logits.shape)} too large")
    checks = [("logits", logits, torch.float32, (b, c)),
              ("labels", labels, torch.int32, (b,)),
              ("class_weights", cw, torch.float32, (c,)),
              ("mask", mask, torch.float32, (b,))]
    if scale is not None:
        checks.append(("scale", scale, torch.float32, ()))
    for name, t, dtype, shape in checks:
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on "
                             f"{logits.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn, name, logits, args):
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"for logits {tuple(logits.shape)}")


def cross_entropy_fwd(logits, labels, cw, mask, label_smoothing: float = 0.0):
    """Per-row ``(w * nll, w)``, float32 [B] each (K1 forward)."""
    if logits.device.type == "cpu":
        return cross_entropy_fwd_plain(logits, labels, cw, mask,
                                       label_smoothing)
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    _check_cuda_args(logits, labels, cw, mask)
    b, c = logits.shape
    wnll = torch.empty(b, dtype=torch.float32, device=logits.device)
    w = torch.empty(b, dtype=torch.float32, device=logits.device)
    _launch(_lib().tpuic_xent_fwd, "cross_entropy_fwd", logits,
            (logits.data_ptr(), labels.data_ptr(), cw.data_ptr(),
             mask.data_ptr(), wnll.data_ptr(), w.data_ptr(), b, c,
             float(label_smoothing)))
    count_launch(cross_entropy_fwd)
    return wnll, w


cross_entropy_fwd.launches = 0


def cross_entropy_bwd(logits, labels, cw, mask, scale,
                      label_smoothing: float = 0.0):
    """``d loss / d logits`` for ``scale = g / max(sum(w), 1e-12)``, a 0-d
    float32 tensor on the logits' device (K1 backward)."""
    if logits.device.type == "cpu":
        return cross_entropy_bwd_plain(logits, labels, cw, mask, scale,
                                       label_smoothing)
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    _check_cuda_args(logits, labels, cw, mask, scale)
    b, c = logits.shape
    dx = torch.empty_like(logits)
    _launch(_lib().tpuic_xent_bwd, "cross_entropy_bwd", logits,
            (logits.data_ptr(), labels.data_ptr(), cw.data_ptr(),
             mask.data_ptr(), scale.data_ptr(), dx.data_ptr(), b, c,
             float(label_smoothing)))
    count_launch(cross_entropy_bwd)
    return dx


cross_entropy_bwd.launches = 0


def _canonicalize(logits, labels, class_weights, mask):
    b, c = logits.shape
    dev = logits.device
    cw = (torch.ones(c, dtype=torch.float32, device=dev)
          if class_weights is None
          else torch.as_tensor(class_weights, dtype=torch.float32,
                               device=dev).contiguous())
    m = (torch.ones(b, dtype=torch.float32, device=dev) if mask is None
         else torch.as_tensor(mask, device=dev).float().contiguous())
    return labels.to(torch.int32).contiguous(), cw, m


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, cw, mask, label_smoothing, weight_sum):
        logits = logits.contiguous()
        wnll, w = cross_entropy_fwd(logits, labels, cw, mask,
                                    label_smoothing)
        sum_w = torch.sum(w) if weight_sum is None else weight_sum.float()
        ctx.save_for_backward(logits, labels, cw, mask, sum_w)
        ctx.label_smoothing = label_smoothing
        return torch.sum(wnll) / torch.clamp(sum_w, min=1e-12)

    @staticmethod
    def backward(ctx, g):
        logits, labels, cw, mask, sum_w = ctx.saved_tensors
        scale = (g / torch.clamp(sum_w, min=1e-12)).float()
        dlogits = cross_entropy_bwd(logits, labels, cw, mask, scale,
                                    ctx.label_smoothing)
        return dlogits, None, None, None, None, None


def fused_weighted_cross_entropy(logits, labels,
                                 class_weights: Optional[torch.Tensor] = None,
                                 mask: Optional[torch.Tensor] = None,
                                 label_smoothing: float = 0.0,
                                 weight_sum: Optional[torch.Tensor] = None):
    """Drop-in fused equivalent of ``weighted_cross_entropy``
    (``tpuic_torch/train/loss.py``): a 0-d float32 loss whose gradient
    with respect to ``logits`` runs the backward kernel.  ``weight_sum``
    replaces this batch's ``sum(w)`` in the forward's divisor and in the
    backward's ``scale``: the global batch's, in a data-parallel step."""
    labels, cw, m = _canonicalize(logits, labels, class_weights, mask)
    return _FusedCrossEntropy.apply(logits, labels, cw, m,
                                    float(label_smoothing), weight_sum)

