"""Image transforms (copy of ``tpuic/data/transforms.py``).

Pure NumPy with explicit RNG, so the port gives the same bits as ``tpuic``
from the same seed (reference dp/loader.py:39-91):

- decode: keep first 3 channels (dp/loader.py:45); grayscale broadcast to 3.
- resize: nearest-neighbor to (S, S) (cv2.INTER_NEAREST, dp/loader.py:45).
- augment (train only, dp/loader.py:63-83): random rot90 k in {0..3};
  vertical flip p=.5; horizontal flip p=.5; then an if/elif chain —
  saturation p=.05, elif brightness, elif contrast — factor ~ U[0.9, 1.1).
  At most ONE color op per sample.  ``draw_augment`` is the single source
  of the RNG stream.
- normalize: /255 then per-channel (x-mean)/std with ImageNet stats
  (dp/loader.py:86-91); HWC float32.  The serving engine folds the same
  normalization into its forward.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """HW or HWC uint8 -> HW3, keeping the first 3 channels (dp/loader.py:45)."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[:, :, :3]


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize to (size, size); matches cv2.INTER_NEAREST."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    # cv2 nearest: src index = floor(dst * scale) with scale = src/dst.
    rows = np.minimum((np.arange(size) * (h / size)).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(size) * (w / size)).astype(np.int64), w - 1)
    return img[rows][:, cols]


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """img * factor (float image in [0,255] space)."""
    return np.clip(img.astype(np.float32) * factor, 0.0, 255.0)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend with the global gray mean."""
    mean = img.astype(np.float32).mean()
    return np.clip(mean + (img.astype(np.float32) - mean) * factor, 0.0, 255.0)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend with the per-pixel luma grayscale."""
    gray = (img.astype(np.float32) @ _LUMA)[..., None]
    return np.clip(gray + (img.astype(np.float32) - gray) * factor, 0.0, 255.0)


def draw_augment(rng: np.random.Generator,
                 p_vflip: float = 0.5, p_hflip: float = 0.5,
                 p_saturation: float = 0.05, p_brightness: float = 0.05,
                 p_contrast: float = 0.05, jitter_lo: float = 0.9,
                 jitter_hi: float = 1.1):
    """Draw the augmentation decisions (reference dp/loader.py:63-83 RNG
    order: rot90 k, vflip, hflip, color branch, factor): the single source
    of the RNG stream, as in ``tpuic``, so per (seed, epoch, index) a
    sample is the same bits in both packages.

    Returns (k, vflip, hflip, color_op, factor); color_op: 0 none,
    1 saturation, 2 brightness, 3 contrast."""
    k = int(rng.integers(0, 4))  # rot90 k in {0,1,2,3} (dp/loader.py:64-65)
    vflip = rng.random() < p_vflip   # dp/loader.py:67-68
    hflip = rng.random() < p_hflip   # dp/loader.py:70-71
    # if/elif color chain (dp/loader.py:74-81): at most one op fires.
    r = rng.random()
    factor = jitter_lo + (jitter_hi - jitter_lo) * rng.random()
    if r < p_saturation:
        color = 1
    elif r < p_saturation + p_brightness:
        color = 2
    elif r < p_saturation + p_brightness + p_contrast:
        color = 3
    else:
        color = 0
    return k, vflip, hflip, color, factor


def apply_augment(img: np.ndarray, k: int, vflip: bool, hflip: bool,
                  color: int, factor: float) -> np.ndarray:
    """Apply pre-drawn augmentation decisions (NumPy path)."""
    if k:
        img = np.rot90(img, k, axes=(0, 1))
    if vflip:
        img = img[::-1, :, :]
    if hflip:
        img = img[:, ::-1, :]
    if color == 1:
        img = adjust_saturation(img, factor)
    elif color == 2:
        img = adjust_brightness(img, factor)
    elif color == 3:
        img = adjust_contrast(img, factor)
    return np.ascontiguousarray(img)


def augment(img: np.ndarray, rng: np.random.Generator, **kw) -> np.ndarray:
    """Train-time augmentation chain, reference dp/loader.py:63-83."""
    return apply_augment(img, *draw_augment(rng, **kw))


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """/255 then per-channel standardize (dp/loader.py:86-91). HWC float32:
    the port's models take NHWC batches, as ``tpuic``'s do."""
    img = img.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
