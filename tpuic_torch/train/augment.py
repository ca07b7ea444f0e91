"""The train step's randomness and its batch augments
(``tpuic/train/step.py:196-311``).

``tpuic`` draws every random number of a step from
``fold_in(key(seed), state.step)``.  The port draws them from an explicit
``torch.Generator`` on the model's device, reseeded for each purpose from
``(seed, step, purpose)`` (:func:`step_seed`), where ``step`` is the
index the host already knows (the ``Trainer``'s global micro-step).
Nothing here touches torch's global RNG, and the draws are a function of
``(seed, step)`` alone: a resumed run draws what the uninterrupted one
drew.

Every draw has the shape of the **global** batch ``n``; a process of a
data-parallel group takes the rows ``[offset, offset + b)`` of it, as
``tpuic``'s sharded arrays do, so N processes draw together exactly what
one process draws.  The draws (:class:`MixDraws`, :class:`EraseDraws`,
the drop-path masks) are separate from the functions that apply them
(:func:`mix_batch`, :func:`erase_batch`), so a test can feed ``tpuic``'s
own draws to the port.

- **Mixup / CutMix** (``step.py:200-274``): one global permutation a
  step pairs the rows; ``lam ~ Beta(a, a)``, drawn as two
  ``torch._standard_gamma`` draws ``X / (X + Y)``.  Mixup blends in
  float32; CutMix pastes the partner's box (centre uniform, side
  ``sqrt(1 - lam)`` of the image's, clipped at the borders) and its
  ``lam`` is the exact kept area.  With both on, a Bernoulli(0.5) draw
  picks one a step: both are computed and the pick is a select on the
  device, so the step reads nothing back.  A row whose partner is padding
  (``mask``) partners itself.
- **Random erasing** (``step.py:276-311``): per row, with probability
  ``p``, a box of area 2-33% of the image and aspect 0.3-3.3 is zeroed
  (the per-channel mean after normalisation).
- **Drop-path masks** (``tpuic/models/vit.py:183-199``,
  ``efficientnet.py:117-128``): one Bernoulli(keep) per row and per draw
  site of the model (``Classifier.drop_path_rates()``), in the model's
  fixed site order, as one ``[sites, n]`` boolean tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

#: Purposes folded into a step's seed.
MIX, ERASE, DROP_PATH = 1, 2, 3

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, step: int, purpose: int) -> int:
    """A 63-bit generator seed for ``purpose`` at ``step`` of a run seeded
    ``seed``: splitmix64 folded over the three."""
    h = 0
    for v in (seed, step, purpose):
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h >> 1


def reseed(gen: torch.Generator, seed: int, step: int,
           purpose: int) -> torch.Generator:
    gen.manual_seed(step_seed(seed, step, purpose))
    return gen


def beta(gen: torch.Generator, alpha: float, device) -> torch.Tensor:
    """A 0-d float32 ``Beta(alpha, alpha)`` draw on ``device``."""
    g = torch._standard_gamma(
        torch.full((2,), float(alpha), dtype=torch.float32, device=device),
        generator=gen)
    return g[0] / (g[0] + g[1])


class MixDraws(NamedTuple):
    """One step's mixup / CutMix draws over a global batch of ``n``:
    ``perm`` [n] int64; ``lam_mixup`` and ``lam_cutmix`` (0-d, the Beta
    draws; None when that mode is off); ``center`` [2] (cy, cx) uniform
    in [0, 1), CutMix's box centre; ``use_mixup`` (0-d bool, only when
    both modes are on)."""

    perm: torch.Tensor
    lam_mixup: Optional[torch.Tensor] = None
    lam_cutmix: Optional[torch.Tensor] = None
    center: Optional[torch.Tensor] = None
    use_mixup: Optional[torch.Tensor] = None


class EraseDraws(NamedTuple):
    """One step's random-erasing draws, each [n]: ``area`` in
    [0.02, 0.33), ``log_ar`` in [log 0.3, log 3.3), the box centre
    ``cy``/``cx`` in [0, 1) of the height / width, and ``apply`` (bool,
    Bernoulli(p))."""

    area: torch.Tensor
    log_ar: torch.Tensor
    cy: torch.Tensor
    cx: torch.Tensor
    apply: torch.Tensor


def draw_mix(gen: torch.Generator, n: int, mixup_alpha: float,
             cutmix_alpha: float, device) -> MixDraws:
    perm = torch.randperm(n, generator=gen, device=device)
    lam_m = beta(gen, mixup_alpha, device) if mixup_alpha > 0 else None
    lam_c = center = None
    if cutmix_alpha > 0:
        lam_c = beta(gen, cutmix_alpha, device)
        center = torch.rand(2, generator=gen, device=device)
    use = None
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use = torch.rand((), generator=gen, device=device) < 0.5
    return MixDraws(perm, lam_m, lam_c, center, use)


def draw_erase(gen: torch.Generator, n: int, p: float,
               device) -> EraseDraws:
    def uniform(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    area = uniform(0.02, 0.33)
    log_ar = uniform(math.log(0.3), math.log(3.3))
    cy = torch.rand(n, generator=gen, device=device)
    cx = torch.rand(n, generator=gen, device=device)
    apply = torch.rand(n, generator=gen, device=device) < p
    return EraseDraws(area, log_ar, cy, cx, apply)


def draw_drop_masks(gen: torch.Generator, n: int,
                    keep: torch.Tensor) -> torch.Tensor:
    """``[sites, n]`` bool: row ``s`` is Bernoulli(``keep[s]``) per sample
    (``keep`` a float32 vector on the generator's device)."""
    u = torch.rand((keep.numel(), n), generator=gen, device=keep.device)
    return u < keep[:, None]


def _cutmix_box(lam0: torch.Tensor, center: torch.Tensor, h: int, w: int):
    cut = torch.sqrt(1.0 - lam0)
    cy, cx = center[0], center[1]
    bh, bw = cut * h, cut * w
    y0 = torch.clamp(cy * h - bh / 2, 0, h)
    y1 = torch.clamp(cy * h + bh / 2, 0, h)
    x0 = torch.clamp(cx * w - bw / 2, 0, w)
    x1 = torch.clamp(cx * w + bw / 2, 0, w)
    ys = torch.arange(h, dtype=torch.float32, device=lam0.device)
    xs = torch.arange(w, dtype=torch.float32, device=lam0.device)
    box = ((ys[:, None] >= y0) & (ys[:, None] < y1)
           & (xs[None, :] >= x0) & (xs[None, :] < x1))
    return box, 1.0 - box.float().mean()


def mix_batch(images: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor], draws: MixDraws,
              offset: int = 0, pool=None):
    """``(images, labels_mix, lam)`` for rows ``[offset, offset + b)`` of
    the global batch.  ``images`` [b, H, W, C], ``labels`` [b] and
    ``mask`` [b] are this process's rows; ``pool`` is the global batch's
    ``(images, labels, mask)`` its partners come from (None: this batch is
    the global one)."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    all_images, all_labels, all_mask = pool or (images, labels, mask)
    idx = draws.perm[offset:offset + b]
    partners = all_images[idx]
    labels_mix = all_labels[idx]
    if mask is not None:
        ok = (mask * all_mask[idx]) > 0
        partners = torch.where(ok[:, None, None, None], partners, images)
        labels_mix = torch.where(ok, labels_mix, labels)
    out = lam = None
    if draws.lam_mixup is not None:
        lam = draws.lam_mixup
        out = (lam * images.float() + (1.0 - lam) * partners.float()
               ).to(images.dtype)
    if draws.lam_cutmix is not None:
        box, lam_c = _cutmix_box(draws.lam_cutmix, draws.center, h, w)
        cut = torch.where(box[None, :, :, None], partners, images)
        if out is None:
            out, lam = cut, lam_c
        else:
            out = torch.where(draws.use_mixup, out, cut)
            lam = torch.where(draws.use_mixup, lam, lam_c)
    return out, labels_mix, lam


def erase_batch(images: torch.Tensor, draws: EraseDraws,
                offset: int = 0) -> torch.Tensor:
    """``images`` (rows ``[offset, offset + b)`` of the global batch) with
    each drawn box zeroed."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    sl = slice(offset, offset + b)
    area, log_ar = draws.area[sl], draws.log_ar[sl]
    ar = torch.exp(log_ar)
    bh = torch.clamp(torch.sqrt(area * h * w * ar), 1, h)
    bw = torch.clamp(torch.sqrt(area * h * w / ar), 1, w)
    cy, cx = draws.cy[sl] * h, draws.cx[sl] * w
    y0 = torch.clamp(cy - bh / 2, 0, h)[:, None, None]
    y1 = torch.clamp(cy + bh / 2, 0, h)[:, None, None]
    x0 = torch.clamp(cx - bw / 2, 0, w)[:, None, None]
    x1 = torch.clamp(cx + bw / 2, 0, w)[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=images.device)
    xs = torch.arange(w, dtype=torch.float32, device=images.device)
    box = ((ys[None, :, None] >= y0) & (ys[None, :, None] < y1)
           & (xs[None, None, :] >= x0) & (xs[None, None, :] < x1)
           & draws.apply[sl][:, None, None])
    return torch.where(box[..., None], torch.zeros_like(images), images)


class StepDraws(NamedTuple):
    mix: Optional[MixDraws]
    erase: Optional[EraseDraws]
    drop_masks: Optional[torch.Tensor]


def draw_step(gen: torch.Generator, seed: int, step: int, n: int, *,
              mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
              random_erase: float = 0.0,
              keep: Optional[torch.Tensor] = None, device=None) -> StepDraws:
    """Every draw of step ``step`` over a global batch of ``n``, each
    purpose from its own reseed of ``gen`` (so turning one feature on
    changes no other feature's draws)."""
    mix = erase = masks = None
    if mixup_alpha > 0 or cutmix_alpha > 0:
        mix = draw_mix(reseed(gen, seed, step, MIX), n, mixup_alpha,
                       cutmix_alpha, device)
    if random_erase > 0:
        erase = draw_erase(reseed(gen, seed, step, ERASE), n, random_erase,
                           device)
    if keep is not None and keep.numel():
        masks = draw_drop_masks(reseed(gen, seed, step, DROP_PATH), n, keep)
    return StepDraws(mix, erase, masks)


def site_keep(rates: Sequence[float], device) -> Optional[torch.Tensor]:
    """The keep probabilities of a model's drop-path sites, on ``device``
    (None when it has none); to a card through pinned memory, without a
    host sync."""
    if not rates:
        return None
    keep = torch.tensor([1.0 - r for r in rates], dtype=torch.float32)
    if torch.device(device).type == "cuda":
        keep = keep.pin_memory()
    return keep.to(device, non_blocking=True)
