"""Packed dataset cache (``tpuic/data/pack.py``): decode once, serve every
epoch from a memory-mapped uint8 file.

- ``pack_dataset`` decodes and nearest-resizes every image of a fold
  once (the native libjpeg/libpng core when it is built, else PIL) into a
  flat uint8 ``pack-{fold}-{size}.bin`` beside a ``.json`` meta file
  (labels, image ids, the class mapping, a fingerprint of the sources and
  a CRC32 a row).  The format is ``tpuic``'s, version 2: for the same tree
  either package builds the same bytes and reuses the other's cache.
- ``PackedDataset`` memory-maps the ``.bin``; a sample costs a row copy
  instead of a decode, and the ``Loader`` augments and normalises the
  batch on its device (``device_prep.py``).

Row i is sample i of the sorted ``ImageFolderDataset`` index, so the
epoch's permutation and the (seed, epoch, index) augment draws are the
decode path's.  A file that does not decode is quarantined as on the
decode path: its row holds a same-class replacement, with that sample's
label and id.  Writes are atomic: a uniquely named temporary file, then
a rename, so processes that pack the same fold at once leave one whole
cache (the last rename wins).
"""

from __future__ import annotations

import functools
import json
import os
import time
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpuic_torch.data import transforms as T
from tpuic_torch.data.folder import ImageFolderDataset, quarantined_decode

# Version 2 has per-row CRC32s in the meta; another version rebuilds.
_PACK_VERSION = 2

_print = functools.partial(print, flush=True)


def _pack_paths(cache_dir: str, fold: str, size: int) -> Tuple[str, str]:
    base = os.path.join(cache_dir, f"pack-{fold}-{size}")
    return base + ".bin", base + ".json"


def _fingerprint(dataset: ImageFolderDataset) -> List[Tuple[str, int, int]]:
    out = []
    for path, _ in dataset.samples:
        st = os.stat(path)
        out.append((os.path.basename(path), int(st.st_mtime), st.st_size))
    return out


def _decode_one(path: str, size: int, decoded: Dict[str, int]) -> np.ndarray:
    """Decode and nearest-resize one file to ``[size, size, 3]`` uint8:
    the native core first (whatever ``cfg.native`` says, as in
    ``tpuic``), PIL when it is not built or rejects the bytes.
    ``decoded`` counts each."""
    from tpuic_torch import native
    if native.decode_available():
        with open(path, "rb") as f:
            data = f.read()
        out = native.decode_resize(data, size)
        if out is not None:
            decoded["native"] += 1
            return out
    from PIL import Image
    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB") if im.mode not in ("RGB",) else im)
    out = T.resize_nearest(T.to_rgb(img), size)
    decoded["pil"] += 1
    return out


def pack_dataset(dataset: ImageFolderDataset, cache_dir: str,
                 force: bool = False, verbose: bool = True,
                 log=_print) -> "PackedDataset":
    """Build (or reuse) the packed cache of ``dataset`` and return it.

    Reuse needs the same version, size, row count and source fingerprint;
    anything else rebuilds.  ``PackedDataset.decoded`` says what decoded
    the rows: ``{"native": n, "pil": m}``, or None for a reused cache."""
    size = dataset.resize_size
    bin_path, meta_path = _pack_paths(cache_dir, dataset.fold, size)
    fp = _fingerprint(dataset)
    if not force and os.path.exists(bin_path) and os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if (meta.get("version") == _PACK_VERSION
                    and meta.get("n") == len(dataset)
                    and meta.get("size") == size
                    and [tuple(x) for x in meta.get("fingerprint", [])] == fp):
                if verbose:
                    log(f"[pack] {dataset.fold}: reused {bin_path} "
                        f"({len(dataset)} rows, no decode)")
                return PackedDataset(bin_path, meta, train=dataset.train,
                                     cfg=dataset.cfg)
        except (OSError, ValueError):
            pass
    os.makedirs(cache_dir, exist_ok=True)
    n = len(dataset)
    row = size * size * 3
    token = uuid.uuid4().hex
    tmp = f"{bin_path}.tmp.{token}"
    mm = np.memmap(tmp, np.uint8, "w+", shape=(n, row))
    t0 = time.perf_counter()
    labels = [int(lb) for _, lb in dataset.samples]
    image_ids = [dataset.image_id(i) for i in range(n)]
    row_crc32: List[int] = []
    decoded = {"native": 0, "pil": 0}
    quarantined = 0
    for i in range(n):
        # The decode path's quarantine: the row takes the replacement's
        # pixels, label and id.
        img, j = quarantined_decode(
            dataset, i,
            lambda idx: _decode_one(dataset.samples[idx][0], size, decoded))
        if j != i:
            labels[i] = int(dataset.samples[j][1])
            image_ids[i] = dataset.image_id(j)
            quarantined += 1
        mm[i] = img.reshape(-1)
        row_crc32.append(zlib.crc32(np.ascontiguousarray(img).tobytes()))
        if verbose and i and i % 2000 == 0:
            rate = i / (time.perf_counter() - t0)
            log(f"[pack] {dataset.fold}: {i}/{n} ({rate:.0f} img/s)")
    if verbose and quarantined:
        log(f"[pack] {dataset.fold}: quarantined {quarantined} undecodable "
            "file(s); packed same-class replacements")
    mm.flush()
    del mm
    os.replace(tmp, bin_path)
    meta = {
        "version": _PACK_VERSION,
        "fold": dataset.fold,
        "size": size,
        "n": n,
        "labels": labels,
        "image_ids": image_ids,
        "class_to_idx": dataset.class_to_idx,
        "fingerprint": fp,
        "row_crc32": row_crc32,
    }
    with open(f"{meta_path}.tmp.{token}", "w") as f:
        json.dump(meta, f)
    os.replace(f"{meta_path}.tmp.{token}", meta_path)
    dt = time.perf_counter() - t0
    if verbose:
        log(f"[pack] {dataset.fold}: packed {n} images @ {size}px in "
            f"{dt:.1f}s ({n / max(dt, 1e-9):.0f} img/s; decoded "
            f"{decoded['native']} native, {decoded['pil']} PIL) -> "
            f"{bin_path}")
    packed = PackedDataset(bin_path, meta, train=dataset.train,
                           cfg=dataset.cfg)
    packed.quarantine_count = quarantined
    packed.decoded = decoded
    packed.pack_seconds = dt
    return packed


def pack_folds(datasets, d, log) -> list:
    """Pack each dataset into ``d.cache_dir`` (``{data_dir}/.tpuic_pack``
    by default) and log, a fold, which decoder packed it; when the native
    decode core did not build, also the compiler's first error line."""
    from tpuic_torch import native
    cache = d.cache_dir or os.path.join(d.data_dir, ".tpuic_pack")
    out = []
    for ds in datasets:
        packed = pack_dataset(ds, cache, verbose=False)
        log(f"[pack] {ds.fold}: {decoder_line(packed)}")
        out.append(packed)
    built = native.status("decode")["decode"]
    if built != "built":
        log(f"[pack] native decode core {built}")
    return out


def decoder_line(packed) -> str:
    """What decoded a packed fold's rows, for the log."""
    if packed.decoded is None:
        return f"reused {packed.bin_path} ({len(packed)} rows, no decode)"
    n = len(packed)
    return (f"packed {n} rows in {packed.pack_seconds:.2f} s "
            f"({n / max(packed.pack_seconds, 1e-9):.0f} img/s): "
            f"{packed.decoded['native']} decoded by the native core, "
            f"{packed.decoded['pil']} by PIL"
            + (f"; {packed.quarantine_count} quarantined"
               if packed.quarantine_count else ""))


class PackedDataset:
    """Memory-mapped uint8 image cache with the ``ImageFolderDataset``
    surface.  ``raw(i)`` is the stored ``[S, S, 3]`` uint8 row; ``load``
    runs the host float path for callers that want it; the ``Loader``'s
    packed path takes ``raw_batch`` or, resident, ``array()``."""

    def __init__(self, bin_path: str, meta: Dict, train: bool,
                 cfg=None) -> None:
        from tpuic_torch.config import DataConfig
        self.cfg = cfg or DataConfig()
        self.bin_path = bin_path
        self.train = train
        self.fold = meta["fold"]
        self.resize_size = int(meta["size"])
        self._labels = np.asarray(meta["labels"], np.int32)
        self._image_ids = list(meta["image_ids"])
        self.class_to_idx: Dict[str, int] = dict(meta["class_to_idx"])
        self.classes: List[str] = sorted(self.class_to_idx,
                                         key=self.class_to_idx.get)
        # A flat (unlabeled) source fold stores label -1 a row.
        self.labeled = bool(len(self._labels) == 0
                            or int(self._labels.min()) >= 0)
        n, s = int(meta["n"]), self.resize_size
        self._mm = np.memmap(bin_path, np.uint8, "r", shape=(n, s, s, 3))
        self._row_crc32 = meta.get("row_crc32") or None
        # Pack-time quarantine events (a reused cache reports 0) and what
        # decoded the rows (None: reused).
        self.quarantine_count = 0
        self.quarantined: Dict[str, int] = {}
        self.decoded: Optional[Dict[str, int]] = None
        self.pack_seconds = 0.0

    def __len__(self) -> int:
        return self._mm.shape[0]

    @property
    def num_classes(self) -> int:
        return len(self.class_to_idx)

    def image_id(self, index: int) -> str:
        return self._image_ids[index]

    def label(self, index: int) -> int:
        return int(self._labels[index])

    def class_counts(self) -> np.ndarray:
        """[num_classes] int64 sample count per class id."""
        return np.bincount(self._labels[self._labels >= 0],
                           minlength=self.num_classes).astype(np.int64)

    def raw(self, index: int) -> np.ndarray:
        return self._mm[index]

    def row_crc32(self, index: int) -> Optional[int]:
        """The pack-time CRC32 of row ``index`` (None on a pre-v2 meta)."""
        if self._row_crc32 is None:
            return None
        return int(self._row_crc32[index])

    def verify_row(self, index: int) -> bool:
        """Whether row ``index``'s bytes still hash to their pack-time
        CRC32 (True when the meta has none)."""
        if self._row_crc32 is None:
            return True
        row = np.ascontiguousarray(self._mm[index])
        return zlib.crc32(row.tobytes()) == int(self._row_crc32[index])

    def raw_batch(self, indices) -> np.ndarray:
        """``[B, S, S, 3]`` uint8 gather: one fancy-index copy, so the
        result is a writable array of its own."""
        return self._mm[np.asarray(indices, np.int64)]

    def label_batch(self, indices) -> np.ndarray:
        return self._labels[np.asarray(indices, np.int64)]

    def array(self) -> np.ndarray:
        """The whole ``[N, S, S, 3]`` uint8 memmap (read-only, no copy):
        the resident upload's source."""
        return self._mm

    def load(self, index: int, rng: Optional[np.random.Generator] = None
             ) -> Tuple[np.ndarray, int, str]:
        """Host float path, as ``ImageFolderDataset.load``."""
        img = np.asarray(self._mm[index])
        c = self.cfg
        if self.train and rng is not None:
            k, vflip, hflip, color, factor = T.draw_augment(
                rng, p_vflip=c.p_vflip, p_hflip=c.p_hflip,
                p_saturation=c.p_saturation, p_brightness=c.p_brightness,
                p_contrast=c.p_contrast, jitter_lo=c.jitter_lo,
                jitter_hi=c.jitter_hi)
            img = T.apply_augment(img, k, vflip, hflip, color, factor)
        return (T.normalize(img, c.mean, c.std), int(self._labels[index]),
                self._image_ids[index])
