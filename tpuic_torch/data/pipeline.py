"""Input pipeline with host worker threads (``tpuic/data/pipeline.py``).

- **Sampler**: one epoch-seeded permutation (``_epoch_indices``, the same
  as ``tpuic``'s), padded by wrapping to a multiple of the batch; padded
  positions carry ``mask = 0``, so eval sums stay exact.  ``drop_last``
  (the Trainer's train loader) drops the partial batch.
- **Workers**: a thread pool decodes and augments samples (PIL and NumPy
  release the GIL for the heavy parts); a producer thread assembles
  batches and keeps a bounded queue ahead of the consumer.
- **Per-sample augment RNG** is ``(seed, epoch, index)``-derived, so a
  batch is the same bits as ``tpuic``'s whatever the worker count.
- **To the device**: on a CUDA device the producer copies each batch into
  pinned host memory, and the consumer starts its host-to-device copy on
  a side stream with ``non_blocking=True``, one batch ahead, so the copy
  overlaps the step that runs meanwhile.  The current stream waits for
  the copy before the batch is used.

- **Per-process shard** (``tpuic/data/pipeline.py:133-176``,
  ``:290-310``): with ``process_count`` processes each materialises
  ``local_batch = global_batch / process_count`` rows of every global
  batch, rank ``r`` the rows ``order[b * global_batch + r * local_batch :
  ... + local_batch]``.  The order is global and every row draws its
  augmentation from its own ``(seed, epoch, index)``, so rank ``r``'s rows
  are bit for bit the rows the one-process run puts there.  A train
  loader drops the last partial *global* batch; a val loader pads it with
  mask-0 rows on every rank, so every rank takes the same number of
  steps and collectives.  ``batch.indices`` is the whole global batch's
  order and ``image_ids`` the local rows'.  Both arguments default to the
  process group's (``tpuic_torch.runtime.distributed``), and the shard
  math is pure in them, so one process can simulate N ranks.

- **Packed path** (``tpuic/data/pipeline.py:181-215``, ``:275-330``):
  when the dataset is a ``PackedDataset`` (``pack.py``) the producer
  skips the decode; it draws each row's augment decisions from the same
  ``(seed, epoch, index)`` stream on the host and ships them as one
  ``[B, 5]`` float32 block, and ``device_prep.py`` applies them on the
  loader's device.  Two flavours:

  - *resident*: when the uint8 dataset fits the device-cache budget
    (``DataConfig.device_cache_mb``, or ``device_cache_bytes``), it is
    uploaded once into one preallocated tensor on the device, in chunks
    of ``TPUIC_UPLOAD_CHUNK_MB`` (64) MiB through one pinned staging
    buffer, so the device holds the data and nothing more; a batch then
    ships its ``[B]`` int32 indices and the params, and the gather runs
    on the device.  Under several processes each holds the whole
    dataset, as ``tpuic`` replicates it.
  - *streaming*: the producer gathers the batch's rows from the memmap
    (a copy), pins them, and the consumer ships the uint8 rows: a
    quarter of the float32 bytes.

  On a CUDA device the consumer starts each batch's copies and then its
  device prep on the side stream, one batch ahead; the current stream
  waits for them before the batch is used.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np
import torch

from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.device import resolve_device
from tpuic_torch.runtime import distributed


def _upload_chunk_bytes() -> int:
    """``TPUIC_UPLOAD_CHUNK_MB`` (MiB, a fraction allowed; default 64)."""
    mb = float(os.environ.get("TPUIC_UPLOAD_CHUNK_MB", "64"))
    return max(1, int(mb * (1 << 20)))


def upload_resident(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` (``[N, ...]`` uint8, a read-only memmap) into one tensor
    preallocated on ``device``, a chunk of ``TPUIC_UPLOAD_CHUNK_MB`` MiB at
    a time: the host reads one chunk at a time, and the device holds the
    data and nothing more.  On a CUDA device each chunk goes through one
    pinned staging buffer, its copy waited for before the next fills it."""
    out = torch.empty(arr.shape, dtype=torch.uint8, device=device)
    n = len(arr)
    row_bytes = max(1, int(arr.nbytes // max(1, n)))
    rows = max(1, _upload_chunk_bytes() // row_bytes)
    cuda = device.type == "cuda"
    staging = (torch.empty((min(rows, n),) + tuple(arr.shape[1:]),
                           dtype=torch.uint8, pin_memory=True)
               if cuda and n else None)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        if cuda:
            part = staging[:hi - lo]
            part.numpy()[...] = arr[lo:hi]
            out[lo:hi].copy_(part, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
        else:
            # np.array copies the read-only rows into a writable array.
            out[lo:hi] = torch.from_numpy(np.array(arr[lo:hi]))
    return out


class Batch(dict):
    """``{"image", "label", "mask"}`` tensors on the loader's device, with
    host-side identity: ``image_ids`` (ids of the rows) and ``indices``
    (the batch's dataset indices)."""
    image_ids: List[str]
    indices: np.ndarray


def _epoch_indices(n: int, epoch: int, seed: int, shuffle: bool,
                   global_batch: int):
    """Global order for one epoch, padded by wrapping to a batch multiple:
    ``(padded order, number of valid entries)``."""
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    pad = (-n) % global_batch
    if pad:
        # np.resize tiles cyclically — correct even when pad > n.
        order = np.resize(order, n + pad)
    return order, n


class Loader:
    """Iterates this process's shard of every global batch of ``dataset``
    on ``device`` (``None`` = the card).

    ``device_cache_bytes`` overrides ``DataConfig.device_cache_mb`` for
    this loader: the budget is a per-process total, so a caller that
    builds several loaders splits it (the ``Trainer``: train first, val
    the remainder)."""

    def __init__(self, dataset: ImageFolderDataset, global_batch: int,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 num_workers: int = 6, prefetch: int = 2,
                 drop_last: bool = False, augment: Optional[bool] = None,
                 device=None, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 device_cache_bytes: Optional[int] = None) -> None:
        self.dataset = dataset
        self.global_batch = int(global_batch)
        self.shuffle = dataset.train if shuffle is None else shuffle
        self.augment = dataset.train if augment is None else bool(augment)
        if self.augment and not dataset.train:
            raise ValueError("augment=True is only valid on a train fold")
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self.process_index = (distributed.process_index()
                              if process_index is None else int(process_index))
        self.process_count = (distributed.process_count()
                              if process_count is None else int(process_count))
        if self.global_batch % self.process_count:
            raise ValueError("global batch must divide across processes")
        self.local_batch = self.global_batch // self.process_count
        self.packed = hasattr(dataset, "raw")
        self.resident = False
        self.resident_bytes = 0
        self.device_cache_bytes = 0
        self._data = None
        self._prep = None
        if self.packed:
            from tpuic_torch.data.device_prep import (make_device_prep,
                                                      make_resident_prep)
            c = dataset.cfg
            s = dataset.resize_size
            data_bytes = len(dataset) * s * s * 3
            self.device_cache_bytes = (
                int(c.device_cache_mb) << 20 if device_cache_bytes is None
                else int(device_cache_bytes))
            if self.device_cache_bytes and data_bytes <= \
                    self.device_cache_bytes:
                self._data = upload_resident(dataset.array(), self.device)
                self._prep = make_resident_prep(mean=c.mean, std=c.std)
                self.resident = True
                self.resident_bytes = data_bytes
            else:
                self._prep = make_device_prep(mean=c.mean, std=c.std)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return -(-n // self.global_batch)

    @property
    def quarantine_count(self) -> int:
        """Samples the dataset served a quarantine replacement for, in all
        (monotonic; the ``Trainer`` logs each epoch's increase)."""
        return int(getattr(self.dataset, "quarantine_count", 0) or 0)

    def steps_per_epoch(self) -> int:
        return len(self)

    def bytes_per_batch(self) -> int:
        """Bytes a batch ships from the host to the device: float32 images
        on the decode path, uint8 rows when streaming, int32 indices when
        resident; plus the int32 labels, the float32 mask and, packed, the
        ``[B, 5]`` float32 params."""
        lb, s = self.local_batch, self.dataset.resize_size
        image = (lb * 4 if self.resident else
                 lb * s * s * 3 * (1 if self.packed else 4))
        return image + lb * 8 + (lb * 5 * 4 if self.packed else 0)

    def _load_one(self, index: int, epoch: int):
        rng = (np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(index)]))
            if self.augment else None)  # rng=None -> clean eval load
        return self.dataset.load(int(index), rng)

    def _draw_params(self, idx: np.ndarray, epoch: int) -> np.ndarray:
        """The rows' augment decisions from the decode path's
        ``(seed, epoch, index)`` stream, as one ``[B, 5]`` float32 block
        (identity rows when the loader does not augment)."""
        from tpuic_torch.data import transforms as T
        from tpuic_torch.data.device_prep import identity_params, pack_params
        params = identity_params(len(idx))
        if self.augment:
            c = self.dataset.cfg
            for i, index in enumerate(idx):
                rng = np.random.default_rng(np.random.SeedSequence(
                    [self.seed, epoch, int(index)]))
                k, vf, hf, color, factor = T.draw_augment(
                    rng, p_vflip=c.p_vflip, p_hflip=c.p_hflip,
                    p_saturation=c.p_saturation,
                    p_brightness=c.p_brightness, p_contrast=c.p_contrast,
                    jitter_lo=c.jitter_lo, jitter_hi=c.jitter_hi)
                params["rot"][i] = k
                params["vflip"][i] = int(vf)
                params["hflip"][i] = int(hf)
                params["color"][i] = color
                params["factor"][i] = factor
        return pack_params(params)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Batch]:
        """Yield the batches of ``epoch`` from batch ``start_step`` on
        (``tpuic/data/pipeline.py:247-296``): step-exact resume.  The
        order is a ``(seed, epoch)`` permutation and every row's draws
        are keyed by ``(seed, epoch, index)``, so the batches served are
        bit for bit the uninterrupted epoch's from that step; nothing is
        loaded or drawn for the skipped ones.  ``start_step`` outside
        ``[0, steps]`` raises."""
        n = len(self.dataset)
        order, n_valid = _epoch_indices(n, epoch, self.seed, self.shuffle,
                                        self.global_batch)
        n_batches = len(order) // self.global_batch
        if self.drop_last and n % self.global_batch:
            n_batches -= 1
        if not 0 <= start_step <= n_batches:
            raise ValueError(f"start_step {start_step} outside this epoch's "
                             f"0..{n_batches} steps")
        gb, lb = self.global_batch, self.local_batch
        size = self.dataset.resize_size
        pin = self.device.type == "cuda"
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def decode_batch(pool, lo):
            futs = [pool.submit(self._load_one, i, epoch)
                    for i in order[lo:lo + lb]]
            imgs = np.empty((lb, size, size, 3), np.float32)
            labels = np.zeros((lb,), np.int32)
            ids = [""] * lb
            for pos, f in enumerate(futs):
                imgs[pos], labels[pos], ids[pos] = f.result()
            return [imgs, labels], ids

        def packed_batch(lo):
            ds = self.dataset
            idx = np.asarray(order[lo:lo + lb], np.int32)
            # raw_batch's fancy index copies the memmap rows.
            payload = idx if self.resident else ds.raw_batch(idx)
            labels = ds.label_batch(idx).astype(np.int32)
            ids = [ds.image_id(int(j)) for j in idx]
            return [payload, labels, self._draw_params(idx, epoch)], ids

        def produce_loop():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(start_step, n_batches):
                    if stop.is_set():
                        break
                    gidx = order[b * gb:(b + 1) * gb]
                    lo = b * gb + self.process_index * lb
                    arrays, ids = (packed_batch(lo) if self.packed
                                   else decode_batch(pool, lo))
                    mask = (np.arange(lo, lo + lb)
                            < n_valid).astype(np.float32)
                    # [image or indices, label, (params,)] + mask
                    host = [torch.from_numpy(a) for a in arrays + [mask]]
                    if pin:
                        host = [t.pin_memory() for t in host]
                    if not _put((host, ids, gidx)):
                        return

        def produce():
            try:
                produce_loop()
                _put(None)
            except BaseException as e:  # surfaced to the consumer
                _put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        copy_stream = torch.cuda.Stream(self.device) if pin else None
        try:
            pending: Optional[Batch] = None
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                host, ids, gidx = item
                copied = None
                if pin:
                    # This batch's copies and device prep overlap the
                    # consumer's step on the previous one.
                    with torch.cuda.stream(copy_stream):
                        dev = self._to_device(host, copy_stream)
                        copied = torch.cuda.Event()
                        copied.record(copy_stream)
                else:
                    dev = self._to_device(host, None)
                batch = Batch(image=dev[0], label=dev[1], mask=dev[2])
                batch.image_ids = ids
                batch.indices = np.asarray(gidx)
                if pending is not None:
                    yield self._ready(*pending)
                pending = (batch, copied)
            if pending is not None:
                yield self._ready(*pending)
        finally:
            stop.set()
            producer.join(timeout=5.0)

    def _to_device(self, host: list, stream) -> list:
        """``[image, label, mask]`` on the device from the host tensors.
        Packed, the image is the device prep's output over the copied rows
        (streaming) or over the resident data gathered at the copied
        indices; the copies and the prep run in order on ``stream``."""
        dev = [t.to(self.device, non_blocking=stream is not None)
               for t in host]
        if not self.packed:
            return dev
        payload, labels, params, mask = dev
        if self.resident:
            if stream is not None:
                # The resident data, made on another stream, is read here.
                self._data.record_stream(stream)
            image = self._prep(self._data, payload, params)
        else:
            image = self._prep(payload, params)
        return [image, labels, mask]

    def _ready(self, batch: Batch, copied) -> Batch:
        """Order the current stream after the batch's copy, and tell the
        allocator the batch is used there."""
        if copied is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(copied)
            for t in batch.values():
                t.record_stream(current)
        return batch
