"""The handwritten-digits ImageFolder: the port's real dataset.

sklearn's bundled UCI handwritten digits (1,797 images, 10 classes, 8x8
grayscale) is the one real image-classification set that needs no
download.  ``digits_split.npz`` beside this module holds it as the
repo's ``scripts/make_digits_dataset.py`` splits it: pixels
``round(x * 255 / 16)`` as uint8, a stratified 80/20 split per class
from ``np.random.default_rng(0)``.  :func:`write_digits_folder` writes
the ImageFolder from that file (``root/{train,val}/{class}/d{i:04d}.png``,
1,438 train and 359 val images) on a machine without sklearn.

Regenerate the file (needs sklearn)::

    python -m tpuic_torch.data.digits
"""

from __future__ import annotations

import os

import numpy as np

SPLIT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits_split.npz")
VAL_FRAC = 0.2


def make_split(seed: int = 0) -> dict:
    """``{"images": [N, 8, 8] uint8, "labels": [N] uint8, "val": [N]
    bool}`` from sklearn, split as ``scripts/make_digits_dataset.py``
    splits it."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    images = np.round(digits.images * (255.0 / 16.0)).astype(np.uint8)
    labels = digits.target
    val = np.zeros(len(labels), bool)
    rng = np.random.default_rng(seed)
    for cls in range(10):
        idx = np.nonzero(labels == cls)[0]
        idx = idx[rng.permutation(len(idx))]
        n_val = max(1, int(round(len(idx) * VAL_FRAC)))
        val[idx[:n_val]] = True
    return {"images": images, "labels": labels.astype(np.uint8), "val": val}


def write_digits_folder(root: str, split_path: str = SPLIT_PATH) -> dict:
    """Write the ImageFolder under ``root`` from the committed split;
    returns ``{"train": n, "val": n}``."""
    from PIL import Image

    with np.load(split_path) as f:
        images, labels, val = f["images"], f["labels"], f["val"]
    counts = {"train": 0, "val": 0}
    for i in range(len(labels)):
        fold = "val" if val[i] else "train"
        d = os.path.join(root, fold, str(int(labels[i])))
        os.makedirs(d, exist_ok=True)
        Image.fromarray(images[i], mode="L").save(
            os.path.join(d, f"d{i:04d}.png"))
        counts[fold] += 1
    return counts


if __name__ == "__main__":
    np.savez_compressed(SPLIT_PATH, **make_split())
    print(f"wrote {SPLIT_PATH}")
