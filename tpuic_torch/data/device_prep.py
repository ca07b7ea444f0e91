"""Augmentation and normalisation on the loader's device
(``tpuic/data/device_prep.py``).

With the packed uint8 cache (``pack.py``) the host's work an epoch is
batch assembly; the per-sample transform chain of the reference (rot90^k,
vflip, hflip: dp/loader.py:63-71; the if/elif colour jitter: :74-81; /255
and the ImageNet standardisation: :86-91) runs on the batch's device as
plain torch ops.  ``tpuic`` computes this in ``jnp`` outside any Pallas
kernel, so it is not one of its TPU kernels.

The decisions are drawn on the host from the (seed, epoch, index) stream
(``transforms.draw_augment``), so a sample's augmentation is the decode
path's; this module only applies them, per sample:

- geometry on the uint8 batch, before the float conversion: the four
  rot90 variants and the flips selected per sample with ``torch.where``,
  a permutation, so bitwise the NumPy path's;
- colour in float32 with ``transforms.adjust_*``'s arithmetic, clipped to
  [0, 255]; the contrast op's batch mean sums in another order than
  NumPy's (< 1e-5 after the normalisation);
- normalise: x / 255, then (x - mean) / std, float32.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpuic_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, _LUMA

PARAM_KEYS = ("rot", "vflip", "hflip", "color", "factor")


def _geometry(x: torch.Tensor, rot: torch.Tensor, vflip: torch.Tensor,
              hflip: torch.Tensor) -> torch.Tensor:
    """``[B, S, S, C]``: ``np.rot90(m, k, axes=(0, 1))`` then the flips,
    selected per sample."""
    sel = lambda v: v.reshape(-1, 1, 1, 1)
    xt = x.transpose(1, 2)
    r1 = xt.flip(1)            # out[i, j] = m[j, S-1-i]
    r2 = x.flip(1).flip(2)
    r3 = xt.flip(2)            # out[i, j] = m[S-1-j, i]
    rot = sel(rot)
    g = torch.where(rot == 1, r1, torch.where(
        rot == 2, r2, torch.where(rot == 3, r3, x)))
    g = torch.where(sel(vflip != 0), g.flip(1), g)
    return torch.where(sel(hflip != 0), g.flip(2), g)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, mean: Optional[Sequence[float]],
               std: Optional[Sequence[float]]):
    """The luma weights, mean and std on ``device``, copied there once (a
    copy from pageable memory would stall the host at every batch)."""
    return tuple(torch.as_tensor(np.asarray(v, np.float32), device=device)
                 for v in (_LUMA, IMAGENET_MEAN if mean is None else mean,
                           IMAGENET_STD if std is None else std))


def apply_batch_augment(images_u8: torch.Tensor,
                        params: Dict[str, torch.Tensor], mean=None, std=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """``[B, S, S, 3]`` uint8 and per-sample params -> ``[B, S, S, 3]``
    normalised ``out_dtype``, on the images' device.

    ``params``: ``rot`` (k in 0..3), ``vflip``, ``hflip``, ``color`` (0
    none, 1 saturation, 2 brightness, 3 contrast) and ``factor``, each a
    ``[B]`` tensor on that device."""
    luma, mean, std = _constants(
        images_u8.device, None if mean is None else tuple(mean),
        None if std is None else tuple(std))
    # A rotated variant leaves transposed strides: one contiguous copy of
    # the uint8 batch keeps every later pass, and the output, NHWC.
    g = _geometry(images_u8, params["rot"], params["vflip"],
                  params["hflip"]).contiguous().to(torch.float32)
    color = params["color"].reshape(-1, 1, 1, 1)
    factor = params["factor"].to(torch.float32).reshape(-1, 1, 1, 1)
    gray = (g * luma).sum(-1, keepdim=True)
    sat = (gray + (g - gray) * factor).clamp(0.0, 255.0)
    bright = (g * factor).clamp(0.0, 255.0)
    gmean = g.mean(dim=(1, 2, 3), keepdim=True)
    contrast = (gmean + (g - gmean) * factor).clamp(0.0, 255.0)
    y = torch.where(color == 1, sat, torch.where(
        color == 2, bright, torch.where(color == 3, contrast, g)))
    return ((y / 255.0 - mean) / std).to(out_dtype)


def identity_params(batch: int) -> Dict[str, np.ndarray]:
    """No augmentation (val and other folds): normalise only."""
    return {
        "rot": np.zeros((batch,), np.int32),
        "vflip": np.zeros((batch,), np.int32),
        "hflip": np.zeros((batch,), np.int32),
        "color": np.zeros((batch,), np.int32),
        "factor": np.ones((batch,), np.float32),
    }


def pack_params(params: Dict[str, np.ndarray]) -> np.ndarray:
    """``[B, 5]`` float32, a row a sample: one host-to-device copy
    instead of five."""
    return np.stack([np.asarray(params[k], np.float32)
                     for k in PARAM_KEYS], axis=1)


def _unpack_params(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: (packed[:, i] if k == "factor"
                else packed[:, i].to(torch.int32))
            for i, k in enumerate(PARAM_KEYS)}


def make_device_prep(mean=None, std=None, out_dtype=torch.float32):
    """``(images_u8 [B, S, S, 3], packed params [B, 5] float32) ->``
    the normalised batch, on their device (the streaming path)."""
    def prep(images_u8: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
        return apply_batch_augment(images_u8, _unpack_params(packed),
                                   mean=mean, std=std, out_dtype=out_dtype)
    return prep


def make_resident_prep(mean=None, std=None, out_dtype=torch.float32):
    """``(dataset_u8 [N, S, S, 3], indices [B] int, packed params) ->``
    the normalised batch: a row gather on the device, then the augment
    (the device-resident cache: a batch ships only indices and params)."""
    def prep(data: torch.Tensor, idx: torch.Tensor,
             packed: torch.Tensor) -> torch.Tensor:
        imgs = data.index_select(0, idx.to(torch.int64))
        return apply_batch_augment(imgs, _unpack_params(packed), mean=mean,
                                   std=std, out_dtype=out_dtype)
    return prep
