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

``tpuic``'s packed uint8 path and its device-side augmentation are not
ported.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np
import torch

from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.device import resolve_device
from tpuic_torch.runtime import distributed


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
    on ``device`` (``None`` = the card)."""

    def __init__(self, dataset: ImageFolderDataset, global_batch: int,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 num_workers: int = 6, prefetch: int = 2,
                 drop_last: bool = False, augment: Optional[bool] = None,
                 device=None, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> None:
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

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return -(-n // self.global_batch)

    def steps_per_epoch(self) -> int:
        return len(self)

    def _load_one(self, index: int, epoch: int):
        rng = (np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(index)]))
            if self.augment else None)  # rng=None -> clean eval load
        return self.dataset.load(int(index), rng)

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """Yield the batches of ``epoch``."""
        n = len(self.dataset)
        order, n_valid = _epoch_indices(n, epoch, self.seed, self.shuffle,
                                        self.global_batch)
        n_batches = len(order) // self.global_batch
        if self.drop_last and n % self.global_batch:
            n_batches -= 1
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

        def produce_loop():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        break
                    gidx = order[b * gb:(b + 1) * gb]
                    lo = b * gb + self.process_index * lb
                    futs = [pool.submit(self._load_one, i, epoch)
                            for i in order[lo:lo + lb]]
                    imgs = np.empty((lb, size, size, 3), np.float32)
                    labels = np.zeros((lb,), np.int32)
                    ids = [""] * lb
                    for pos, f in enumerate(futs):
                        imgs[pos], labels[pos], ids[pos] = f.result()
                    mask = (np.arange(lo, lo + lb)
                            < n_valid).astype(np.float32)
                    host = [torch.from_numpy(a) for a in (imgs, labels, mask)]
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
                    # H2D of this batch overlaps the consumer's step on
                    # the previous one.
                    with torch.cuda.stream(copy_stream):
                        dev = [t.to(self.device, non_blocking=True)
                               for t in host]
                        copied = torch.cuda.Event()
                        copied.record(copy_stream)
                else:
                    dev = [t.to(self.device) for t in host]
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

    def _ready(self, batch: Batch, copied) -> Batch:
        """Order the current stream after the batch's copy, and tell the
        allocator the batch is used there."""
        if copied is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(copied)
            for t in batch.values():
                t.record_stream(current)
        return batch
