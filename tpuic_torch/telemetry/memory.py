"""Per-device memory accounting sampled at step boundaries (a port of
``tpuic/telemetry/memory.py``).

On the card the sample is one read of the caching allocator's counters,
``torch.cuda.memory_stats(device)``: ``allocated_bytes.all.current`` as
``bytes_in_use``, ``allocated_bytes.all.peak`` (what
``torch.cuda.max_memory_allocated`` returns) as ``peak_bytes_in_use``,
``reserved_bytes.all.current``, and the card's total memory as the
limit.  It is host-side bookkeeping, no sync and no device work, but it
flattens the allocator's statistics in Python: a fraction of a
millisecond, so a step boundary samples every ``CARD_EVERY``-th step.
On the CPU the sample is the live tensor bytes the garbage collector can
reach, a walk of every tracked object, every ``CPU_EVERY``-th step.  Both
add the process's RSS.

Each sample publishes a ``memory`` event; the last one is kept for
:meth:`MemorySampler.snapshot`, which ``prom.memory_rows`` renders as
``device_memory_bytes{device,kind}`` rows.  The first sample whose
headroom falls under ``warn_headroom_frac`` logs one warning and carries
``warning: "low_headroom"``.
"""

from __future__ import annotations

import threading
from typing import Optional

from tpuic_torch.metrics.meters import process_rss_bytes

CARD_EVERY = 8
CPU_EVERY = 64


def _on_card(dev) -> bool:
    return dev is not None and getattr(dev, "type", "cpu") == "cuda"


def _card_label(dev) -> dict:
    """The card's name and total memory (read once)."""
    import torch
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    return {"device": str(idx), "kind": props.name,
            "bytes_limit": int(props.total_memory)}


def _cuda_sample(dev, label: dict) -> dict:
    """One read of the card's allocator counters."""
    import torch
    stats = torch.cuda.memory_stats(dev)
    out = {"device": label["device"], "kind": label["kind"],
           "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                              0)),
           "reserved_bytes": int(stats.get("reserved_bytes.all.current",
                                           0)),
           "bytes_limit": label["bytes_limit"]}
    out["headroom_frac"] = round(
        1.0 - out["bytes_in_use"] / max(1, out["bytes_limit"]), 4)
    return out


def _live_tensor_sample() -> dict:
    """CPU: the bytes of the live tensors the garbage collector tracks
    (storages counted once)."""
    import gc

    import torch
    seen, total = set(), 0
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: no object's __class__ hook runs.
            if (not issubclass(type(obj), torch.Tensor)
                    or obj.device.type != "cpu"):
                continue
            st = obj.untyped_storage()
            key = st.data_ptr()
        except Exception:
            continue
        if key in seen:
            continue
        seen.add(key)
        total += st.nbytes()
    return {"device": "cpu", "kind": "cpu", "bytes_in_use": int(total)}


class MemorySampler:
    """Samples ``device``'s memory and publishes ``memory`` events.

    Wired by ``TrainTelemetry`` as a bus subscriber on ``step`` events:
    one sample every ``every`` step boundaries (default ``CARD_EVERY`` on
    the card, ``CPU_EVERY`` on the CPU); :meth:`sample` takes one at
    once."""

    def __init__(self, publish=None, device=None,
                 every: Optional[int] = None,
                 warn_headroom_frac: float = 0.05, log=None) -> None:
        if publish is None:
            from tpuic_torch.telemetry.events import bus as _bus
            publish = _bus.publish
        self._publish = publish
        self._device = device
        self._label = None
        if every is None:
            every = CARD_EVERY if _on_card(device) else CPU_EVERY
        self._every = max(1, int(every))
        self._warn_frac = float(warn_headroom_frac)
        self._log = log
        self._lock = threading.Lock()
        self._warned = False
        self._seen_steps = 0
        self.samples = 0
        self.last: Optional[dict] = None

    def on_event(self, ev) -> None:
        self._seen_steps += 1
        if (self._seen_steps - 1) % self._every:
            return
        self.sample(step=ev.data.get("step"))

    def sample(self, step=None) -> Optional[dict]:
        """Take one sample, publish it as a ``memory`` event and return it
        (never raises into the loop)."""
        try:
            if _on_card(self._device):
                if self._label is None:
                    self._label = _card_label(self._device)
                source, row = "memory_stats", _cuda_sample(self._device,
                                                           self._label)
            else:
                source, row = "live_tensors", _live_tensor_sample()
        except Exception:
            return None
        out = {"source": source, "devices": [row]}
        if step is not None:
            out["step"] = int(step)
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                  "headroom_frac"):
            if row.get(k) is not None:
                out[k] = row[k]
        rss = process_rss_bytes()
        if rss is not None:
            out["process_rss_bytes"] = int(rss)
        head = row.get("headroom_frac")
        with self._lock:
            warn = (not self._warned and head is not None
                    and head < self._warn_frac)
            if warn:
                self._warned = True
            self.samples += 1
            self.last = out
        if warn:
            out["warning"] = "low_headroom"
            if self._log is not None:
                self._log(
                    f"[memory] LOW HEADROOM: device {row['device']} "
                    f"({row['kind']}) at {100 * (1 - head):.1f}% of "
                    f"{row.get('bytes_limit', 0) / 2**30:.2f} GiB — the "
                    "next allocation spike is an OOM")
        self._publish("memory", **out)
        return out

    def snapshot(self) -> Optional[dict]:
        """The most recent sample (for the Prometheus exposition)."""
        with self._lock:
            return self.last
