"""MFU and goodput accounting: where did the wall time go?  (A port of
``tpuic/telemetry/goodput.py``.)

- the **peak tables** of the card (:data:`PEAK_FLOPS`, :data:`HBM_GBPS`),
  keyed on ``torch.cuda.get_device_name()``, and the analytic per-model
  FLOPs (``tpuic``'s table, copied as it is);
- a **GoodputTracker** that subscribes to the event bus and classifies
  wall time into buckets::

      productive   device/dispatch time of non-skipped train steps
      input        loader wait (the input-bound fraction)
      compile      first-use nvcc builds and CUDA-graph captures,
                   subtracted from the step/eval span they stalled
      checkpoint   checkpoint stage + commit spans
      skip         estimated time of guard-skipped (non-finite) steps
      rollback     checkpoint-restore spans after a non-finite streak
      eval         validation epochs
      restart      supervised-restart downtime
      other        wall - all of the above (setup, logging gaps)

  ``report()`` returns the buckets, their fractions, the accounted
  fraction and, where the card's peak is known, the running MFU.

MFU's denominator is the card's dense peak for the step's arithmetic:
bf16 tensor cores for a bf16 step; for a float32 step TF32 tensor cores
when ``torch.backends.cuda.matmul.allow_tf32`` is on (the caller reads it
and passes ``tf32``), else the float32 rate outside the tensor cores.  A
card with no row, and the CPU, have no peak: MFU is ``None``.  The FLOPs
come from the analytic table alone (``tpuic``'s ``cost_analysis_dict``
reads XLA's count, which eager PyTorch does not have).

Skip time is an **estimate** (the skip streak is only seen at the deferred
drain), and MFU counts productive steps only, as in ``tpuic``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# Dense peak FLOP/s and HBM bandwidth by card (NVIDIA data sheets), first
# match of a key in the device name wins; "H100 80GB HBM3" is the SXM
# part.  Columns: bf16 tensor cores, TF32 tensor cores, float32 (CUDA
# cores), HBM bytes/s.
_CARDS = (
    ("H100 PCIe", 756e12, 378e12, 51.2e12, 2.0e12),
    ("H100 NVL", 835e12, 417.5e12, 60.0e12, 3.9e12),
    ("H100 80GB HBM3", 989.4e12, 494.7e12, 66.9e12, 3.35e12),
)
PEAK_FLOPS = {k: bf16 for k, bf16, _, _, _ in _CARDS}
PEAK_FLOPS_TF32 = {k: tf32 for k, _, tf32, _, _ in _CARDS}
PEAK_FLOPS_F32 = {k: f32 for k, _, _, f32, _ in _CARDS}
HBM_GBPS = {k: hbm / 1e9 for k, _, _, _, hbm in _CARDS}


def _card(name) -> Optional[str]:
    name = str(name or "")
    return next((k for k in PEAK_FLOPS if k in name), None)


def peak_flops(device_name, dtype: str = "bf16",
               tf32: bool = False) -> Optional[float]:
    """The card's dense peak FLOP/s for a step in ``dtype`` ('bf16' or
    'f32'; an f32 step at the TF32 rate when ``tf32``), or None for a
    card without a row (and for the CPU)."""
    dt = str(dtype).lower()
    if dt not in ("bf16", "bfloat16", "f32", "float32"):
        raise ValueError(f"peak_flops: unknown dtype {dtype!r} "
                         "(want 'bf16' or 'f32')")
    card = _card(device_name)
    if card is None:
        return None
    if dt in ("bf16", "bfloat16"):
        return PEAK_FLOPS[card]
    return PEAK_FLOPS_TF32[card] if tf32 else PEAK_FLOPS_F32[card]


def hbm_bandwidth(device_name) -> Optional[float]:
    """The card's HBM bytes/s, or None for a card without a row."""
    card = _card(device_name)
    return None if card is None else HBM_GBPS[card] * 1e9


def roofline_intensity(flops: float, bytes_accessed: float) -> Optional[float]:
    """Arithmetic intensity (FLOPs per HBM byte), or None when no bytes
    move."""
    if not bytes_accessed or bytes_accessed <= 0:
        return None
    return float(flops) / float(bytes_accessed)


def ridge_intensity(peak: float, hbm_bytes_per_s: float) -> float:
    """The roofline ridge point (FLOPs/byte): below it a kernel at peak
    bandwidth cannot reach peak FLOPs — it is HBM-bound by arithmetic."""
    return float(peak) / max(1.0, float(hbm_bytes_per_s))


def roofline_verdict(flops: float, bytes_accessed: float, peak: float,
                     hbm_bytes_per_s: float) -> str:
    """'compute-bound' | 'hbm-bound' | 'overhead' for a (FLOPs, bytes)
    workload on a (peak, bandwidth) machine.  'overhead' means neither
    axis is exercised (no flops AND no bytes — control flow, tuples,
    host stalls booked to the device bucket)."""
    if (not flops or flops <= 0) and (not bytes_accessed
                                      or bytes_accessed <= 0):
        return "overhead"
    inten = roofline_intensity(flops, bytes_accessed)
    if inten is None:  # flops but no bytes: register-resident compute
        return "compute-bound"
    return ("compute-bound"
            if inten >= ridge_intensity(peak, hbm_bytes_per_s)
            else "hbm-bound")


# Analytic forward FLOPs per image at a canonical resolution, copied from
# ``tpuic/telemetry/goodput.py`` as it is (prefix-matched, longest key
# first, so 'vit-s16-moe' takes 'vit-s16''s figure); the training step is
# forward + backward ~= 3x forward.
FWD_FLOPS_PER_IMAGE = {
    "resnet18-cifar": (1.11e9, 32),
    "resnet18": (3.64e9, 224),
    "resnet34": (7.34e9, 224),
    "resnet50": (8.2e9, 224),
    "resnet101": (15.6e9, 224),
    "resnet152": (23.0e9, 224),
    "inceptionv3": (11.4e9, 299),
    "efficientnet-b0": (0.78e9, 224),
    "efficientnet-b3": (3.6e9, 300),
    "efficientnet-b7": (74e9, 600),
    "vit-tiny": (6.3e9, 224),
    "vit-s16": (9.2e9, 224),
    "vit-b16": (35.2e9, 224),
    "vit-b32": (8.8e9, 224),
    "vit-l16": (123.2e9, 224),
    "vit-l32": (30.8e9, 224),
}


def analytic_flops_per_step(model_name: str, image_size: int,
                            global_batch: int,
                            train: bool = True) -> Optional[float]:
    """Analytic FLOPs of one step, or None for an unknown model.

    Longest-prefix match over FWD_FLOPS_PER_IMAGE, scaled by
    ``(image_size / canonical)^2`` (conv/attention cost is ~quadratic in
    side length; an approximation).
    """
    if not model_name or not global_batch:
        return None
    name = model_name.lower()
    best = None
    for key, (gf, base) in FWD_FLOPS_PER_IMAGE.items():
        if name.startswith(key) and (best is None or len(key) > len(best[0])):
            best = (key, gf, base)
    if best is None:
        return None
    _, gf, base = best
    scale = (float(image_size) / base) ** 2 if image_size else 1.0
    fwd = gf * scale * global_batch
    return 3.0 * fwd if train else fwd


_BUCKETS = ("productive", "input", "compile", "checkpoint", "skip",
            "rollback", "eval", "restart")


class GoodputTracker:
    """Wall-time classifier over bus events (see module docstring).

    Thread-safe: ``compile`` events arrive from whatever thread compiled
    (the serve batcher included) while ``step`` events come from the
    train loop.
    """

    def __init__(self, flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None, global_batch: int = 0,
                 compute_dtype: str = "") -> None:
        self._lock = threading.Lock()
        self.flops_per_step = flops_per_step
        self.peak = None if not peak_flops else float(peak_flops)
        self.compute_dtype = str(compute_dtype)
        self.global_batch = int(global_batch)
        self._t0: Optional[float] = None
        self.buckets = {k: 0.0 for k in _BUCKETS}
        self.steps = 0
        self.skipped_est = 0.0   # estimated skipped steps (from streaks)
        self.compiles = 0        # backend_compile count
        self.restarts = 0        # supervisor restart count of this run
        self._pending_compile = 0.0
        self._step_total_s = 0.0  # for the rolling mean (skip estimate)
        self.ckpt_async_s = 0.0   # deferred commits (overlapped, not wall)

    # -- event intake --------------------------------------------------
    def start(self) -> None:
        """Open the measurement window (idempotent: first call wins, so
        a resumed fit() keeps its original origin)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()

    def on_event(self, ev) -> None:
        kind, d = ev.kind, ev.data
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()
            if kind == "step":
                total = float(d.get("total_ms", 0.0)) / 1000.0
                data = min(float(d.get("data_ms", 0.0)) / 1000.0, total)
                attr = total - data
                c = min(self._pending_compile, attr)
                self._pending_compile -= c
                self.buckets["compile"] += c
                self.buckets["productive"] += attr - c
                self.buckets["input"] += data
                self.steps += 1
                self._step_total_s += total
            elif kind == "compile":
                dur = float(d.get("duration_s", 0.0))
                self._pending_compile += dur
                if str(d.get("key", "")).startswith("backend_compile"):
                    self.compiles += 1
            elif kind == "eval":
                dur = float(d.get("duration_s", 0.0))
                c = min(self._pending_compile, dur)
                self._pending_compile -= c
                self.buckets["compile"] += c
                self.buckets["eval"] += dur - c
            elif kind == "drain":
                # Post-loop blocking drain (break paths): device time of
                # the final dispatched step, after its step event closed
                # — productive, the same work just billed late.
                dur = float(d.get("duration_s", 0.0))
                c = min(self._pending_compile, dur)
                self._pending_compile -= c
                self.buckets["compile"] += c
                self.buckets["productive"] += dur - c
            elif kind == "checkpoint_commit":
                # A deferred (async) commit ran concurrently with compute
                # — it consumed no wall clock the step loop could have
                # used, so charging it to the 'checkpoint' bucket would
                # double-book seconds already in 'productive'.  Tracked
                # separately so report() still shows the overlapped work.
                if d.get("blocking", True):
                    self.buckets["checkpoint"] += float(
                        d.get("duration_s", 0.0))
                else:
                    self.ckpt_async_s += float(d.get("duration_s", 0.0))
            elif kind == "rollback":
                self.buckets["rollback"] += float(d.get("duration_s", 0.0))
            elif kind == "restart":
                # Supervised restart (runtime/supervisor.py): the
                # downtime — previous child's death through backoff,
                # respawn, re-init, restore — happened BEFORE this
                # process's measurement window opened. Extend the window
                # back over it and book it to 'restart', so a run that
                # lost 40s to a crash reports frac_restart instead of a
                # wall clock that silently forgot the outage.
                down = max(0.0, float(d.get("downtime_s", 0.0)))
                self.restarts = int(d.get("restart", self.restarts + 1))
                self._t0 -= down
                self.buckets["restart"] += down
            elif kind == "skip":
                # Streak delta observed at the deferred drain; charge the
                # skipped steps at the rolling mean step time and move
                # them out of 'productive' (they were booked there when
                # their step events arrived).
                delta = max(0, int(d.get("delta", 0)))
                if delta and self.steps:
                    est = delta * (self._step_total_s / self.steps)
                    est = min(est, self.buckets["productive"])
                    self.buckets["productive"] -= est
                    self.buckets["skip"] += est
                    self.skipped_est += delta

    # -- reads ---------------------------------------------------------
    def mfu(self, wall_s: Optional[float] = None) -> Optional[float]:
        """Running MFU: productive-step FLOPs / (peak * wall); None
        without a peak or an analytic FLOPs count."""
        if not self.flops_per_step or self.peak is None:
            return None
        if wall_s is None:
            wall_s = (time.monotonic() - self._t0) if self._t0 else 0.0
        if wall_s <= 0:
            return None
        productive_steps = max(0.0, self.steps - self.skipped_est)
        return self.flops_per_step * productive_steps / (self.peak * wall_s)

    def report(self, step: Optional[int] = None) -> dict:
        """Snapshot: buckets (s), fractions of wall, accounted fraction,
        and MFU.  ``accounted_frac`` ~ 1.0 means the named buckets cover
        the wall clock (the tier-1 acceptance gate); the gap is reported
        honestly as ``other_s`` (setup, logging, epoch turnaround)."""
        with self._lock:
            wall = (time.monotonic() - self._t0) if self._t0 else 0.0
            named = sum(self.buckets.values()) + self._pending_compile
            out = {"wall_s": round(wall, 3), "steps": self.steps}
            if step is not None:
                out["step"] = int(step)
            buckets = dict(self.buckets)
            # Compile time not yet absorbed by a step/eval span (e.g. a
            # warmup compile before the loop) is still compile time.
            buckets["compile"] += self._pending_compile
            for k in _BUCKETS:
                out[f"{k}_s"] = round(buckets[k], 3)
            out["other_s"] = round(max(0.0, wall - named), 3)
            if wall > 0:
                for k in _BUCKETS:
                    out[f"frac_{k}"] = round(buckets[k] / wall, 4)
                out["frac_other"] = round(max(0.0, wall - named) / wall, 4)
                out["accounted_frac"] = round(min(named / wall, 1.0), 4)
            if self.global_batch:
                out["images"] = self.steps * self.global_batch
            out["skipped_steps_est"] = round(self.skipped_est, 1)
            out["compiles"] = self.compiles
            out["restarts"] = self.restarts
            out["checkpoint_async_s"] = round(self.ckpt_async_s, 3)
            if self.compute_dtype:
                out["compute_dtype"] = self.compute_dtype
            m = self.mfu(wall)
            if m is not None:
                out["mfu"] = round(m, 4)
            return out

    def summary_line(self) -> str:
        """One epoch-log line: the headline fractions."""
        r = self.report()
        parts = [f"wall {r['wall_s']:.1f}s"]
        for k in _BUCKETS + ("other",):
            f = r.get(f"frac_{k}")
            if f:
                parts.append(f"{k} {100.0 * f:.1f}%")
        if r.get("mfu") is not None:
            parts.append(f"mfu {r['mfu']:.4f}")
        return ", ".join(parts)
