"""ImageFolder dataset: index + per-sample load (``tpuic/data/folder.py``).

- Layout: ``data_dir/{fold}/{class_name}/{image}`` (dp/loader.py:20-21).
- Class mapping: the sorted subdirectory names of the TRAIN fold, mapped
  to contiguous ids; val shares the mapping.
- ``image_id``: the file name without its extension.
- ``allow_unlabeled=True`` (predict): a fold of loose images with no
  class subdirectories yields label -1 and ``labeled`` False.
- Index order is sorted and deterministic; shuffling is the sampler's
  (``pipeline.py``).
- **Decode**: the native core (``tpuic_torch.native``) when
  ``cfg.native`` and its build is available, else PIL; the fused native
  prep, else the NumPy transforms.  PNG gives the same bits either way,
  and the same bits as ``tpuic`` for the same (seed, epoch, index).
- **Sample quarantine** (``quarantined_decode``): a file that does not
  decode is retried with a backoff, then replaced by a deterministic
  same-class sample, whose label and id travel with it, and counted
  (``quarantine_count``, ``quarantined``).  ``cfg.quarantine=False``
  re-raises.  Each replacement publishes a ``quarantine`` bus event
  (``path``, ``count``) from the thread that decoded it.
- **Fault point** ``decode_error`` (``runtime/faults.py``, keyed by the
  dataset index): ``load`` raises an ``OSError`` in place of the decode,
  at every attempt while armed, so a spec without ``*TIMES`` models a
  corrupt file (the retries fail too, quarantine serves a replacement)
  and ``*1`` a transient read (the retry recovers).  Like ``tpuic``'s it
  sits on the decode path; the pack decodes through ``pack.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from tpuic_torch.config import DataConfig
from tpuic_torch.data import transforms as T
from tpuic_torch.runtime import faults
from tpuic_torch.telemetry.events import publish

# What PIL raises for unreadable or corrupt image bytes: its
# UnidentifiedImageError and "image file is truncated" are OSErrors,
# decoder failures ValueErrors, and old PIL raised SyntaxError for broken
# PNG chunks.
_DECODE_ERRORS = (OSError, ValueError, SyntaxError)


def quarantined_decode(dataset, index: int, decode):
    """The quarantine policy, shared by ``load`` and the pack: try
    ``decode(index)``; on a decode error retry ``cfg.quarantine_retries``
    times ``cfg.quarantine_backoff_s`` apart, then, with
    ``cfg.quarantine`` on, record the event and try up to 8 same-class
    replacements in turn (an interrupted copy often hits neighbours too).

    Returns ``(value, actual_index)``: the caller takes the replacement's
    label and id when ``actual_index != index``.  Re-raises the original
    error when quarantine is off or every candidate fails.  Only
    ``_DECODE_ERRORS`` engage the policy."""
    cfg = dataset.cfg
    try:
        return decode(index), index
    except _DECODE_ERRORS:
        for _ in range(max(0, int(cfg.quarantine_retries))):
            time.sleep(max(0.0, float(cfg.quarantine_backoff_s)))
            try:
                return decode(index), index
            except _DECODE_ERRORS:
                continue
        if not cfg.quarantine:
            raise
        dataset._record_quarantine(dataset.samples[index][0])
        j = index
        for _ in range(8):
            j = dataset.quarantine_replacement(j)
            try:
                return decode(j), j
            except _DECODE_ERRORS:
                continue
        raise  # every candidate corrupt: the original error


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
        # Quarantine events in all, and per path; a lock, as loads run on
        # the Loader's worker threads.
        self.quarantine_count = 0
        self.quarantined: Dict[str, int] = {}
        self._quarantine_lock = threading.Lock()

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

    def _decode_sized(self, index: int) -> np.ndarray:
        """Sample ``index``'s pixels: the native core's decode and nearest
        resize when ``cfg.native`` and it is built (the downstream resize
        is then a no-op), else PIL at full size.  A corrupt file makes the
        native decode return None and PIL raise, so the quarantine
        engages either way."""
        path = self.samples[index][0]
        if self.cfg.native:
            from tpuic_torch import native
            if native.decode_available():
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    data = b""
                if data:
                    out = native.decode_resize(data, self.resize_size)
                    if out is not None:
                        return out
        return self._decode(path)

    def quarantine_replacement(self, index: int) -> int:
        """The substitute for a sample that does not decode: the next
        index (cyclic) with the same label, else the plain next index
        (a one-sample class; its own label travels with it)."""
        label = self.samples[index][1]
        n = len(self.samples)
        for off in range(1, n):
            j = (index + off) % n
            if self.samples[j][1] == label:
                return j
        return (index + 1) % n

    def _record_quarantine(self, path: str) -> None:
        with self._quarantine_lock:
            self.quarantine_count += 1
            self.quarantined[path] = self.quarantined.get(path, 0) + 1
            count = self.quarantine_count
        publish("quarantine", path=path, count=count)

    def load(self, index: int, rng: Optional[np.random.Generator] = None
             ) -> Tuple[np.ndarray, int, str]:
        """Decode -> RGB -> resize -> [augment] -> normalize: (HWC float32
        image, label, image_id), reference dp/loader.py:39-61 in NHWC.
        Augment decisions are drawn once (``transforms.draw_augment``) from
        the caller's (seed, epoch, index) generator, train fold only, then
        applied by the native prep when ``cfg.native`` and it is built,
        else by the NumPy transforms: the same image either way.  A file
        that does not decode goes through ``quarantined_decode``, and a
        replacement brings its own image, label and id."""
        def decode_index(i: int) -> np.ndarray:
            if faults.fire("decode_error", step=i):
                raise OSError(f"injected decode error for index {i}")
            return self._decode_sized(i)

        img, index = quarantined_decode(self, index, decode_index)
        label = self.samples[index][1]
        c = self.cfg
        img = T.to_rgb(img)
        if self.train and rng is not None:
            k, vflip, hflip, color, factor = T.draw_augment(
                rng, p_vflip=c.p_vflip, p_hflip=c.p_hflip,
                p_saturation=c.p_saturation, p_brightness=c.p_brightness,
                p_contrast=c.p_contrast, jitter_lo=c.jitter_lo,
                jitter_hi=c.jitter_hi)
        else:
            k = vflip = hflip = color = 0
            factor = 1.0
        if c.native:
            from tpuic_torch import native
            out = native.prep_image(
                np.ascontiguousarray(img), self.resize_size, rot_k=k,
                vflip=vflip, hflip=hflip, color_op=color, factor=factor,
                mean=c.mean, std=c.std)
            if out is not None:
                return out, label, self.image_id(index)
        img = T.resize_nearest(img, self.resize_size)
        img = T.apply_augment(img, k, vflip, hflip, color, factor)
        img = T.normalize(img, c.mean, c.std)
        return img, label, self.image_id(index)
