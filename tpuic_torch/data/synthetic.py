"""Synthetic ImageFolder trees for tests and smoke runs
(copy of ``tpuic/data/synthetic.py``)."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image


def make_synthetic_imagefolder(root: str, classes: Sequence[str] = ("cat", "dog"),
                               per_class: int = 8, size: int = 40,
                               folds: Sequence[str] = ("train", "val"),
                               seed: int = 0) -> str:
    """Write data_dir/{fold}/{class}/{class}_{fold}_{i}.png with
    class-correlated pixel statistics (so a model can overfit it)."""
    rng = np.random.default_rng(seed)
    for fold in folds:
        for ci, cls in enumerate(classes):
            d = os.path.join(root, fold, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                base = np.full((size, size, 3),
                               40 + 150 * ci // max(1, len(classes) - 1),
                               np.uint8)
                noise = rng.integers(0, 60, (size, size, 3), np.uint8)
                img = np.clip(base.astype(np.int32) + noise, 0, 255).astype(np.uint8)
                Image.fromarray(img).save(
                    os.path.join(d, f"{cls}_{fold}_{i}.png"))
    return root
