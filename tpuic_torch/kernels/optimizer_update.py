"""Fused LARS / LAMB updates over the whole parameter list: the Hopper port
of K2.

Replaces ``tpuic/kernels/optimizer_update.py``: ``_lars_kernel`` and
``_lamb_kernel`` (one ``pl.pallas_call`` per parameter leaf) together
with the trust-ratio norms the JAX wrappers compute around them.
Semantics are ``optax.lars`` / ``optax.lamb``'s, as ``tpuic``'s fused
transforms pin them:

- **LARS**: ``u = g + wd*w``; ``trust = tc*||w||/||u||`` per leaf (1 when
  either norm is 0); ``m' = (-lr*trust)*u + mu*m``, which *is* the update
  (optax's trace runs after the lr scaling); ``w' = w + m'``.
- **LAMB**: Adam moments ``m', v'`` debiased with ``t = count + 1``;
  ``u = m^/(sqrt(v^) + eps) + wd*w``; ``trust = ||w||/||u||`` (1 when
  either norm is 0); ``w' = w + (-lr*trust)*u``.

:func:`lars_update` and :func:`lamb_update` update ``params`` and the
moment lists **in place** (the CUDA kernel saves a copy of each ~95 MB
tensor at ResNet-50 size), and only where the 0-d bool tensor ``finite``
is true: the train step's non-finite guard, read on the device.  For
CPU tensors they take the plain versions (:func:`lars_update_plain`,
:func:`lamb_update_plain`, ports of ``impl="jnp"``) and select with
``torch.where``; for CUDA tensors they launch ``csrc/optimizer_update.cu``
(three multi-tensor launches: per-chunk norms, per-leaf trust ratio,
update) or raise.  ``.launches`` on each wrapper counts calls that
launched the kernel.  The trust-ratio norms are a pass of the kernel with
per-chunk partial sums reduced in a fixed order (no atomics), not torch
reductions.  Both updates' passes stream 16-byte loads and stores, a warp
per ``CHUNK`` elements, and take any alignment (a leaf that is not 16-byte
aligned goes through scalar loads).  LAMB's debias factors are computed
in the kernels from the device ``count``.  ``optimizer_update_bench``
keeps the earlier designs of both and times them beside these.

Every tensor must be float32 and contiguous on one device; ``lr`` is a
0-d float32 tensor and ``count`` a 0-d int32 tensor, both on that device.
The per-leaf checks run only when the :class:`LeafTable` is (re)built, so
a repeat call with the same tensors walks the lists once.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch

from tpuic_torch.kernels.counting import count_launch

#: Elements per chunk of the update kernels' grids (one warp each): a BN
#: vector of 64-2,048 elements takes a warp, not a block.
CHUNK = 4096


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(t * t))


def _trust(pn, un, coeff: float):
    return torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn),
                       coeff * pn / un)


def lars_update_plain(params, grads, trace, lr, *, weight_decay: float,
                      trust_coefficient: float,
                      momentum: float) -> List[torch.Tensor]:
    """New traces ``m'`` (== the updates), one per leaf, out of place."""
    out = []
    for w, g, m in zip(params, grads, trace):
        u = g.float() + weight_decay * w.float()
        a = -lr * _trust(_norm(w.float()), _norm(u), trust_coefficient)
        out.append(a * u + momentum * m.float())
    return out


def lamb_debias(count, b1: float, b2: float):
    """``(c1, c2) = 1 / (1 - b^t)`` with ``t = count + 1``, float32: the
    plain version's debias (the CUDA kernels compute the same from the
    device ``count``)."""
    t = (count.to(torch.int32) + 1).float()
    one = torch.ones((), dtype=torch.float32, device=t.device)
    c1 = one / (one - torch.pow(torch.full_like(one, b1), t))
    c2 = one / (one - torch.pow(torch.full_like(one, b2), t))
    return c1, c2


def lamb_update_plain(params, grads, mu, nu, count, lr, *, b1: float,
                      b2: float, eps: float, weight_decay: float):
    """``(updates, mu', nu')`` lists, out of place."""
    c1, c2 = lamb_debias(count, b1, b2)
    upd, mus, nus = [], [], []
    for w, g, m, v in zip(params, grads, mu, nu):
        g32, w32 = g.float(), w.float()
        m_new = b1 * m.float() + (1.0 - b1) * g32
        v_new = b2 * v.float() + (1.0 - b2) * g32 * g32
        u = (m_new * c1) / (torch.sqrt(v_new * c2) + eps) + weight_decay * w32
        trust = _trust(_norm(w32), _norm(u), 1.0)
        upd.append((-lr * trust) * u)
        mus.append(m_new)
        nus.append(v_new)
    return upd, mus, nus


def _select_(finite, dsts: Sequence[torch.Tensor],
             news: Sequence[torch.Tensor]) -> None:
    with torch.no_grad():
        for d, n in zip(dsts, news):
            d.copy_(torch.where(finite, n.to(d.dtype), d))


# -- the kernel's leaf table ------------------------------------------------

class LeafTable:
    """The device table one multi-tensor launch reads: per leaf its
    pointers, size and chunk range, and per chunk its leaf and first
    element.  Built on first use and rebuilt only when its key changes:
    the chunk size, the lists' lengths and, for every tensor, what the
    kernel relies on (pointer, size, dtype, contiguity, device).  The
    checks of those (:func:`check_leaves`) run only then, so a repeat call
    with the same tensors walks the lists once, to make the key.  The
    caller keeps one per parameter list (the optimizer does).  The host
    copy goes through pinned memory without a synchronise."""

    def __init__(self) -> None:
        self.key = None

    def get(self, lists: Sequence[Sequence[torch.Tensor]],
            chunk: int = CHUNK):
        key = (chunk, tuple(len(ts) for ts in lists)) + tuple(
            (t.data_ptr(), t.numel(), t.dtype, t.is_contiguous(),
             t.get_device()) for ts in lists for t in ts)
        if key != self.key:
            check_leaves(lists)
            self._build(lists, chunk)
            self.key = key
        return self

    def _build(self, lists, chunk: int) -> None:
        first = lists[0]
        dev = first[0].device
        null = [0] * len(first)
        ptrs = [[t.data_ptr() for t in ts] for ts in lists]
        ptrs += [null] * (4 - len(ptrs))
        leaves, chunks = [], []
        for i, t in enumerate(first):
            n = t.numel()
            if n >= 2 ** 31:
                raise ValueError(f"leaf {i} has {n} elements; the kernel "
                                 "indexes chunks with 32 bits")
            nc = max(1, math.ceil(n / chunk))
            leaves.append([ptrs[0][i], ptrs[1][i], ptrs[2][i], ptrs[3][i], n,
                           len(chunks), nc])
            chunks += [[i, c * chunk] for c in range(nc)]
        pin = dev.type == "cuda"
        host_l = torch.tensor(leaves, dtype=torch.int64)
        host_c = torch.tensor(chunks, dtype=torch.int32)
        if pin:
            host_l, host_c = host_l.pin_memory(), host_c.pin_memory()
        self.chunk = chunk
        self.leaves = host_l.to(dev, non_blocking=pin)
        self.chunks = host_c.to(dev, non_blocking=pin)
        self._host = (host_l, host_c)  # alive until the copies are done
        self.n_leaves, self.n_chunks = len(leaves), len(chunks)
        self.partials = torch.empty((len(chunks), 2), dtype=torch.float32,
                                    device=dev)
        # a_l per leaf, then the c1, c2 LAMB's first pass used.
        self.a = torch.empty(len(leaves) + 2, dtype=torch.float32,
                             device=dev)


def bind(lib, kinds=("lars", "lamb")):
    """``lib`` (a build of ``csrc/optimizer_update.cu``) with the C entry
    points of ``kinds`` declared."""
    # table, chunks; n_leaves, n_chunks, chunk; then the pointers (LARS:
    # lr, finite, partials, a; LAMB: lr, count, finite, partials, a), the
    # float hyperparameters and the stream.
    pointers = {"lars": 4, "lamb": 5}
    floats = {"lars": 3, "lamb": 6}
    for kind in kinds:
        fn = getattr(lib, f"tpuic_{kind}_update")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p] * pointers[kind] + \
            [ctypes.c_float] * floats[kind] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = getattr(_lib, "cdll", None)
    if lib is None:
        from tpuic_torch.kernels import _build
        lib = _lib.cdll = bind(_build.load("optimizer_update"))
    return lib


def check_leaves(lists) -> None:
    """Raise unless the leaf lists are of one length and every tensor is
    float32, contiguous, on the first one's device and shaped as its leaf
    in the first list: what one multi-tensor launch relies on."""
    if not lists[0]:
        raise ValueError("empty parameter list")
    dev = lists[0][0].device
    n = len(lists[0])
    for ts in lists:
        if len(ts) != n:
            raise ValueError(f"leaf lists differ in length: {len(ts)} vs {n}")
        for i, (t, ref) in enumerate(zip(ts, lists[0])):
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.shape != ref.shape:
                raise ValueError(
                    f"leaf {i}: every tensor must be float32, contiguous, "
                    f"on {dev} and shaped {tuple(ref.shape)}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


def _check_scalars(dev, scalars) -> None:
    for name, t, dtype in scalars:
        if t.device != dev or t.dtype != dtype or t.numel() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a one-element {dtype} tensor "
                             f"on {dev}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")


def _launch(fn, name, dev, args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def lars_update(params, grads, trace, lr, finite, *, weight_decay: float,
                trust_coefficient: float, momentum: float,
                table: Optional[LeafTable] = None) -> None:
    """In place, where ``finite``: ``trace <- m'`` and ``params <- w + m'``
    for every leaf (K2a)."""
    dev = params[0].device
    if dev.type == "cpu":
        new = lars_update_plain(params, grads, trace, lr,
                                weight_decay=weight_decay,
                                trust_coefficient=trust_coefficient,
                                momentum=momentum)
        _select_(finite, params, [w + m for w, m in zip(params, new)])
        _select_(finite, trace, new)
        return
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    tb = (table or LeafTable()).get((grads, params, trace))
    _check_scalars(dev, (("lr", lr, torch.float32),
                         ("finite", finite, torch.bool)))
    _launch(_lib().tpuic_lars_update, "lars_update", dev,
            (tb.leaves.data_ptr(), tb.chunks.data_ptr(), tb.n_leaves,
             tb.n_chunks, tb.chunk, lr.data_ptr(), finite.data_ptr(),
             tb.partials.data_ptr(), tb.a.data_ptr(), float(weight_decay),
             float(trust_coefficient), float(momentum)))
    count_launch(lars_update)


lars_update.launches = 0


def lamb_update(params, grads, mu, nu, count, lr, finite, *, b1: float,
                b2: float, eps: float, weight_decay: float,
                table: Optional[LeafTable] = None) -> None:
    """In place, where ``finite``: ``mu <- m'``, ``nu <- v'`` and
    ``params <- w + update`` for every leaf (K2b).  ``count`` is the number
    of previous updates (optax's convention); it is not advanced here."""
    dev = params[0].device
    if dev.type == "cpu":
        upd, mus, nus = lamb_update_plain(params, grads, mu, nu, count, lr,
                                          b1=b1, b2=b2, eps=eps,
                                          weight_decay=weight_decay)
        _select_(finite, params, [w + u for w, u in zip(params, upd)])
        _select_(finite, mu, mus)
        _select_(finite, nu, nus)
        return
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    tb = (table or LeafTable()).get((grads, params, mu, nu))
    _check_scalars(dev, (("lr", lr, torch.float32),
                         ("count", count, torch.int32),
                         ("finite", finite, torch.bool)))
    _launch(_lib().tpuic_lamb_update, "lamb_update", dev,
            (tb.leaves.data_ptr(), tb.chunks.data_ptr(), tb.n_leaves,
             tb.n_chunks, tb.chunk, lr.data_ptr(), count.data_ptr(),
             finite.data_ptr(), tb.partials.data_ptr(), tb.a.data_ptr(),
             float(b1), float(b2),
             1.0 - b1, 1.0 - b2, float(eps), float(weight_decay)))
    count_launch(lamb_update)


lamb_update.launches = 0
