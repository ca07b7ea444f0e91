"""ImageFolder dataset: index + per-sample load (``tpuic/data/folder.py``).

- Layout: ``data_dir/{fold}/{class_name}/{image}`` (dp/loader.py:20-21).
- Class mapping: the sorted subdirectory names of the TRAIN fold, mapped
  to contiguous ids; val shares the mapping.
- ``image_id``: the file name without its extension.
- ``allow_unlabeled=True`` (predict): a fold of loose images with no
  class subdirectories yields label -1 and ``labeled`` False.
- Index order is sorted and deterministic; shuffling is the sampler's
  (``pipeline.py``).

Decode is PIL's (``tpuic``'s ``native=False`` path), so a sample is the
same bits as ``tpuic``'s for the same (seed, epoch, index).  A file that
does not decode raises: ``tpuic``'s quarantine (retry, then a same-class
substitute) is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from tpuic_torch.config import DataConfig
from tpuic_torch.data import transforms as T

_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp"}


def _is_image(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _IMAGE_EXTS


class ImageFolderDataset:
    def __init__(self, data_dir: str, fold: str, resize_size: int,
                 cfg: Optional[DataConfig] = None,
                 class_to_idx: Optional[Dict[str, int]] = None,
                 allow_unlabeled: bool = False) -> None:
        self.cfg = cfg or DataConfig()
        self.data_dir = data_dir
        self.fold = fold
        self.train = fold == "train"
        self.resize_size = resize_size
        root = os.path.join(data_dir, fold)
        if not os.path.isdir(root):
            raise FileNotFoundError(f"no such fold: {root}")
        if class_to_idx is None:
            map_root = os.path.join(data_dir, "train")
            if not os.path.isdir(map_root):
                map_root = root
            classes = sorted(d for d in os.listdir(map_root)
                             if os.path.isdir(os.path.join(map_root, d)))
            class_to_idx = {c: i for i, c in enumerate(classes)}
        self.class_to_idx: Dict[str, int] = dict(class_to_idx)
        self.classes: List[str] = sorted(self.class_to_idx,
                                         key=self.class_to_idx.get)
        samples: List[Tuple[str, int]] = []
        for cls in sorted(os.listdir(root)):
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir) or cls not in self.class_to_idx:
                continue
            for fname in sorted(os.listdir(cdir)):
                fpath = os.path.join(cdir, fname)
                if _is_image(fpath):
                    samples.append((fpath, self.class_to_idx[cls]))
        # Flat (unlabeled) fold: images directly under the fold dir, no
        # class subdirectories; label -1.  Opt-in (predict passes
        # allow_unlabeled=True): training on label -1 would give a zero
        # one-hot target, so for the Trainer a flat fold stays an error.
        self.labeled = bool(samples)
        if not samples and allow_unlabeled:
            samples = [(os.path.join(root, f), -1)
                       for f in sorted(os.listdir(root))
                       if _is_image(os.path.join(root, f))]
        if not samples:
            raise ValueError(f"no images under {root}")
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def num_classes(self) -> int:
        return len(self.class_to_idx)

    def image_id(self, index: int) -> str:
        path, _ = self.samples[index]
        return os.path.splitext(os.path.basename(path))[0]

    def class_counts(self) -> np.ndarray:
        """[num_classes] int64 sample count per class id."""
        labels = np.asarray([lb for _, lb in self.samples])
        return np.bincount(labels[labels >= 0],
                           minlength=self.num_classes).astype(np.int64)

    def _decode(self, path: str) -> np.ndarray:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB") if im.mode not in ("RGB",)
                              else im)

    def load(self, index: int, rng: Optional[np.random.Generator] = None
             ) -> Tuple[np.ndarray, int, str]:
        """Decode -> RGB -> resize -> [augment] -> normalize: (HWC float32
        image, label, image_id), reference dp/loader.py:39-61 in NHWC.
        Augment decisions are drawn once (``transforms.draw_augment``) from
        the caller's (seed, epoch, index) generator, train fold only."""
        path, label = self.samples[index]
        c = self.cfg
        img = T.to_rgb(self._decode(path))
        if self.train and rng is not None:
            k, vflip, hflip, color, factor = T.draw_augment(
                rng, p_vflip=c.p_vflip, p_hflip=c.p_hflip,
                p_saturation=c.p_saturation, p_brightness=c.p_brightness,
                p_contrast=c.p_contrast, jitter_lo=c.jitter_lo,
                jitter_hi=c.jitter_hi)
        else:
            k = vflip = hflip = color = 0
            factor = 1.0
        img = T.resize_nearest(img, self.resize_size)
        img = T.apply_augment(img, k, vflip, hflip, color, factor)
        img = T.normalize(img, c.mean, c.std)
        return img, label, self.image_id(index)
