"""Image transforms the serving slice uses (copy of ``tpuic/data/transforms.py``).

- resize: nearest-neighbor to (S, S) (cv2.INTER_NEAREST, reference
  dp/loader.py:45).
- normalize stats: ImageNet mean/std (reference dp/loader.py:86-91); the
  engine folds ``(x/255 - mean)/std`` into its forward.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize to (size, size); matches cv2.INTER_NEAREST."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    # cv2 nearest: src index = floor(dst * scale) with scale = src/dst.
    rows = np.minimum((np.arange(size) * (h / size)).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(size) * (w / size)).astype(np.int64), w - 1)
    return img[rows][:, cols]
