"""Checkpoints of the port (``tpuic/checkpoint/manager.py``): best and
latest tracks, atomic commit, the restore ladder, lenient restore.

``tpuic`` writes Orbax directories; the card's machine has neither Orbax
nor JAX, so the port owns a torch-file format that keeps ``tpuic``'s
protocol:

- **Tracks.** ``{ckpt_dir}/{name}/best``, saved on every val improvement
  (reference train.py:173-180), and ``{ckpt_dir}/{name}/latest``, saved
  when ``epoch % save_period == 0`` (train.py:183-188, so epoch 0 saves).
  ``save_latest`` is unconditional and records the resume keys
  (``RESUME_META_KEYS``; -1 at an epoch boundary).
- **Payload.** One file, ``{track}/state.pt``: the model's
  ``state_dict`` (parameters and BN buffers), the ``OptState`` tensors,
  ``step`` and ``skip_count``, and ``meta`` (``epoch``, ``best_score``,
  the resume keys and ``step``).  Only tensors, dicts, lists, ints, floats
  and strings: ``torch.load(..., weights_only=True)`` reads it back.
- **Snapshot, then write.** The port's step updates parameters and
  optimizer state in place, so a save first copies every tensor to the
  host on the caller's thread (into pinned memory, one synchronise).  Only
  then does the write start, on a background thread with ``async_commit``
  (``RunConfig.async_checkpoint``), else on the caller's.  The next step
  can no longer change what is written.
- **Atomic commit**, in ``tpuic``'s order: stage to ``{track}.new``; write
  the manifest ``{track}.new.manifest.json`` (``version``, ``epoch``,
  ``step_in_epoch``, ``step`` and ``files`` = {relpath: [size, crc32]})
  atomically; rotate the previous save and its sidecars to
  ``{track}.prev``; rename ``{track}.new`` to ``{track}``; write the
  ``{track}.meta.json`` sidecar.  ``wait()`` drains a background write and
  re-raises what it hit; every reader and every save goes through it.
- **Restore ladder.** ``restore_into`` starts at the newest of latest and
  best (``newest_track``; latest wins ties), checks each rung's CRC
  manifest (``verify_track``) and walks newest -> the other track -> their
  ``.prev``, logging every rung it skips; ``last_restore_rung`` names the
  one used.  ``TPUIC_RESUME_STEP`` caps the rungs at a fleet-agreed step
  (``_apply_resume_cap``).  No checkpoint: ``(state, 0, 0.0)``; every rung
  corrupt: ``RuntimeError``.
- **Lenient restore** (train.py:143-148): a key intersection over
  ``state_dict`` names with equal shapes.  The optimizer state, ``step``
  and ``skip_count`` are restored only when every model tensor was.

- **Exact restore.** ``restore_exact`` reads one named track with no
  ladder: the hot-swap gate's read (``loading.load_candidate_variables``),
  where falling back to another rung would serve weights nobody named.

Not ported: the fault point ``ckpt_kill``, the ``checkpoint_commit``
telemetry event, the multi-host commit barrier and EMA parameters.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from tpuic_torch.checkpoint.convert import _invalidate

# The resume keys, as tpuic writes them: completed steps of the saved epoch
# at a mid-epoch flush, and the loader geometry that offset is valid for;
# -1 at an epoch boundary.
RESUME_META_KEYS = ("step_in_epoch", "global_batch", "data_seed", "data_len")
GEOMETRY_META_KEYS = ("global_batch", "data_seed", "data_len")
#: The fleet-agreed resume step a gang supervisor passes (the name
#: ``tpuic/runtime/supervisor.py`` uses).
ENV_RESUME_STEP = "TPUIC_RESUME_STEP"
PAYLOAD = "state.pt"
_MANIFEST_VERSION = 1
_OPT_FIELDS = ("trace", "mu", "nu")


def lenient_restore(current: Mapping[str, torch.Tensor],
                    restored: Mapping[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Key-intersection merge of two ``state_dict``s (reference
    train.py:143-148): ``(merged, n_loaded, n_total)``.  A tensor is taken
    from ``restored`` (cast to the current tensor's dtype and device) iff
    its name is in both and the shapes are equal; ``n_total`` counts
    ``current``."""
    merged, loaded = {}, 0
    for name, cur in current.items():
        r = restored.get(name)
        if r is not None and tuple(r.shape) == tuple(cur.shape):
            merged[name] = r.to(dtype=cur.dtype, device=cur.device)
            loaded += 1
        else:
            merged[name] = cur
    return merged, loaded, len(current)


def _dir_manifest(path: str) -> Dict[str, Any]:
    """{relpath: [size, crc32]} for every file under ``path``, in sorted
    order (bit-rot and torn writes, not adversaries)."""
    files: Dict[str, Any] = {}
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames.sort()
        for fn in sorted(filenames):
            fp = os.path.join(dirpath, fn)
            rel = os.path.relpath(fp, path).replace(os.sep, "/")
            crc = size = 0
            with open(fp, "rb") as f:
                while chunk := f.read(1 << 20):
                    crc = zlib.crc32(chunk, crc)
                    size += len(chunk)
            files[rel] = [size, crc]
    return files


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except OSError:
            pass


def _host_copies(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies of ``tensors``: CUDA tensors into pinned memory,
    enqueued together and synchronised once; CPU tensors cloned."""
    out, cuda = {}, False
    for k, t in tensors.items():
        t = t.detach()
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            cuda = True
        else:
            h = t.clone()
        out[k] = h
    if cuda:
        torch.cuda.synchronize()
    return out


def snapshot(state) -> Dict[str, Any]:
    """A ``TrainState``'s tensors on the host: ``{"model": state_dict,
    "opt_state": {"count", "trace" | "mu", "nu"}, "step",
    "skip_count"}``."""
    flat = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.opt_state
    flat["opt/count"] = opt.count
    for field in _OPT_FIELDS:
        for i, t in enumerate(getattr(opt, field) or ()):
            flat[f"opt/{field}/{i}"] = t
    flat["step"], flat["skip_count"] = state.step, state.skip_count
    host = _host_copies(flat)
    out = {"model": {k[6:]: v for k, v in host.items()
                     if k.startswith("model/")},
           "opt_state": {"count": host["opt/count"]},
           "step": host["step"], "skip_count": host["skip_count"]}
    for field in _OPT_FIELDS:
        seq = getattr(opt, field)
        if seq is not None:
            out["opt_state"][field] = [host[f"opt/{field}/{i}"]
                                       for i in range(len(seq))]
    return out


def _copy_opt_state(opt, saved: Mapping) -> bool:
    """Write a saved ``OptState`` into ``opt`` in place when the fields,
    lengths, shapes and dtypes all match; else leave it and return
    False."""
    pairs = [(opt.count, saved.get("count"))]
    for field in _OPT_FIELDS:
        live, got = getattr(opt, field), saved.get(field)
        if (live is None) != (got is None):
            return False
        if live is not None:
            if len(live) != len(got):
                return False
            pairs += list(zip(live, got))
    if any(s is None or s.shape != d.shape or s.dtype != d.dtype
           for d, s in pairs):
        return False
    with torch.no_grad():
        for d, s in pairs:
            d.copy_(s)
    return True


class CheckpointManager:
    """best/latest checkpoint tracks under ``{ckpt_dir}/{name}``."""

    def __init__(self, ckpt_dir: str, name: str, save_period: int = 5,
                 async_commit: bool = False,
                 log: Callable[[str], None] = print) -> None:
        self.root = os.path.abspath(os.path.join(ckpt_dir, name))
        self.save_period = save_period
        self.log = log
        self._async_commit = bool(async_commit)
        self._commit_thread: Optional[threading.Thread] = None
        self._commit_error: Optional[BaseException] = None
        #: Host seconds and bytes of the last save: ``snapshot_s`` on the
        #: caller's thread, ``commit_s`` for write + manifest + rotation.
        self.last_save: Dict[str, Any] = {}
        #: Host seconds of the last restore (read, verify, copy in).
        self.last_restore_s: Optional[float] = None
        self.last_restore_rung: Optional[str] = None
        self.last_restore_loaded: Optional[Tuple[int, int]] = None
        self.last_restore_meta: Optional[Tuple[int, int]] = None
        self.last_restore_step_in_epoch: Optional[int] = None
        self.last_restore_geometry: Optional[Tuple[int, int, int]] = None
        os.makedirs(self.root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def wait(self) -> None:
        """Block until a background commit has landed; re-raise anything it
        hit.  Every reader and every save comes through here first, so a
        checkpoint becomes visible whole or not at all."""
        thread, self._commit_thread = self._commit_thread, None
        if thread is not None:
            thread.join()
            err, self._commit_error = self._commit_error, None
            if err is not None:
                raise err

    def _commit(self, track: str, payload: Dict[str, Any],
                pending: Dict[str, Any]) -> None:
        """Stage -> manifest -> rotate -> sidecar (``tpuic``'s
        ``_drain_and_commit``)."""
        t0 = time.perf_counter()
        path = os.path.join(self.root, track)
        new = path + ".new"
        for stale in (new, new + ".manifest.json"):
            _remove(stale)
        os.makedirs(new)
        torch.save(payload, os.path.join(new, PAYLOAD))
        manifest = {"version": _MANIFEST_VERSION, "epoch": pending["epoch"],
                    "step_in_epoch": pending["step_in_epoch"],
                    "step": pending["step"], "files": _dir_manifest(new)}
        _atomic_json(new + ".manifest.json", manifest)
        # The previous committed save survives as {track}.prev, the
        # ladder's last rung.  Plain renames; the window between the two
        # can leave only .prev on disk, which the ladder also reads.
        prev = path + ".prev"
        for suffix in ("", ".manifest.json", ".meta.json"):
            _remove(prev + suffix)
        if os.path.isdir(path):
            os.rename(path, prev)
            for suffix in (".manifest.json", ".meta.json"):
                if os.path.exists(path + suffix):
                    os.replace(path + suffix, prev + suffix)
        os.rename(new, path)
        os.replace(new + ".manifest.json", path + ".manifest.json")
        _atomic_json(path + ".meta.json",
                     {k: pending[k] for k in
                      ("epoch", "best_score") + RESUME_META_KEYS})
        self.last_save.update(
            bytes=sum(size for size, _ in manifest["files"].values()),
            commit_s=time.perf_counter() - t0)

    def _save(self, track: str, state, epoch: int, best_score: float,
              step_in_epoch: int = -1, global_batch: int = -1,
              data_seed: int = -1, data_len: int = -1) -> None:
        self.wait()  # one save in flight; also orders best and latest
        t0 = time.perf_counter()
        payload = snapshot(state)
        pending = {"epoch": int(epoch), "best_score": float(best_score),
                   "step_in_epoch": int(step_in_epoch),
                   "global_batch": int(global_batch),
                   "data_seed": int(data_seed), "data_len": int(data_len),
                   "step": int(payload["step"])}
        payload["meta"] = dict(pending)
        self.last_save = {"track": track,
                          "snapshot_s": time.perf_counter() - t0}
        if not self._async_commit:
            self._commit(track, payload, pending)
            return

        def _bg() -> None:
            try:
                self._commit(track, payload, pending)
            except BaseException as e:  # re-raised at the next wait()
                self._commit_error = e

        self._commit_thread = threading.Thread(
            target=_bg, name="tpuic-torch-ckpt-commit", daemon=True)
        self._commit_thread.start()

    def save_best(self, state, epoch: int, best_score: float) -> None:
        """Reference train.py:173-180: on a val-accuracy improvement."""
        self._save("best", state, epoch, best_score)
        self.log(f"[ckpt] best -> {self.root}/best (epoch {epoch}, score "
                 f"{best_score:.4f})")

    def maybe_save_latest(self, state, epoch: int, best_score: float) -> None:
        """Reference train.py:183-188: every ``save_period`` epochs
        (``epoch % period == 0``, so epoch 0 saves)."""
        if epoch % self.save_period == 0:
            self.save_latest(state, epoch, best_score)

    def save_latest(self, state, epoch: int, best_score: float,
                    step_in_epoch: int = -1, global_batch: int = -1,
                    data_seed: int = -1, data_len: int = -1) -> None:
        """Unconditional ``latest`` save.  ``step_in_epoch >= 0`` marks a
        partial epoch with that many completed steps (with the loader
        geometry it is valid for); resume then continues that epoch."""
        self._save("latest", state, epoch, best_score,
                   step_in_epoch=step_in_epoch, global_batch=global_batch,
                   data_seed=data_seed, data_len=data_len)
        at = (f"epoch {epoch}" if step_in_epoch < 0
              else f"epoch {epoch}, step {step_in_epoch}")
        self.log(f"[ckpt] latest -> {self.root}/latest ({at})")

    # -- restore ------------------------------------------------------------
    def _track_epoch(self, track: str) -> Optional[int]:
        """Saved epoch of a track; None when absent, -1 when its sidecar is
        unreadable (restorable, epoch unknown)."""
        if not os.path.isdir(os.path.join(self.root, track)):
            return None
        try:
            with open(os.path.join(self.root, f"{track}.meta.json")) as f:
                return int(json.load(f)["epoch"])
        except (OSError, ValueError, KeyError):
            return -1

    def newest_track(self) -> Optional[str]:
        """The restorable track with the highest saved epoch; ``latest``
        wins ties."""
        self.wait()
        candidates = [(e, t) for t in ("latest", "best")
                      if (e := self._track_epoch(t)) is not None]
        if not candidates:
            return None
        return max(candidates, key=lambda p: p[0])[1]

    def _manifest_step(self, rung: str) -> Optional[int]:
        """The optimizer step a rung's manifest records; None without one."""
        try:
            with open(os.path.join(self.root,
                                   rung + ".manifest.json")) as f:
                step = json.load(f).get("step")
            return int(step) if step is not None else None
        except (OSError, ValueError, TypeError):
            return None

    def _apply_resume_cap(self, rungs, cap: Optional[int] = None):
        """Fleet-consistent resume: with ``TPUIC_RESUME_STEP`` (or an
        explicit ``cap``), rungs whose manifest step is past it are
        refused and the rest ordered newest first below it (rungs without
        a manifest step last).  When every rung is past it, the oldest
        rung comes first."""
        if cap is None:
            raw = os.environ.get(ENV_RESUME_STEP, "")
            if not raw or not rungs:
                return rungs
            allowed = int(raw)  # a malformed supervisor env fails loud
        else:
            if not rungs:
                return rungs
            allowed = int(cap)
        steps = {r: self._manifest_step(r) for r in rungs}
        kept = [r for r in rungs if steps[r] is None or steps[r] <= allowed]
        skipped = [r for r in rungs if r not in kept]
        if not kept:
            self.log(f"[ckpt] fleet resume: EVERY rung is ahead of the "
                     f"fleet-agreed step {allowed} ({steps}); restoring the "
                     "oldest available rung instead")
            return sorted(rungs, key=lambda r: (steps[r] is None,
                                                steps[r] or 0))
        if skipped:
            self.log(f"[ckpt] fleet resume: skipping rung(s) ahead of the "
                     f"fleet-agreed step {allowed}: "
                     + ", ".join(f"{r}@{steps[r]}" for r in skipped))
        known = [r for r in kept if steps[r] is not None]
        unknown = [r for r in kept if steps[r] is None]
        return sorted(known, key=lambda r: -steps[r]) + unknown

    def verify_track(self, track: str) -> Tuple[bool, str]:
        """A track's bytes against its commit manifest: ``(ok, detail)``.
        No directory: not ok.  No manifest: ok, unverified.  An unreadable
        manifest, or a file added, missing, resized or failing its CRC:
        not ok."""
        path = os.path.join(self.root, track)
        mpath = path + ".manifest.json"
        if not os.path.isdir(path):
            return False, "missing"
        if not os.path.exists(mpath):
            return True, "no manifest (unverified)"
        try:
            with open(mpath) as f:
                expected = json.load(f)["files"]
        except (OSError, ValueError, KeyError, TypeError) as e:
            return False, f"unreadable manifest: {e}"
        live = _dir_manifest(path)
        if live == expected:
            return True, f"verified {len(live)} files"
        for rel in sorted(set(expected) | set(live)):
            if rel not in live:
                return False, f"missing file {rel}"
            if rel not in expected:
                return False, f"unexpected file {rel}"
            if live[rel] != expected[rel]:
                return False, (f"checksum mismatch in {rel} "
                               f"(expected {expected[rel]}, got {live[rel]})")
        return False, "manifest mismatch"

    def restore_into(self, state, track: Optional[str] = None,
                     resume_cap: Optional[int] = None):
        """Verified restore of ``state`` (in place) through the ladder.

        ``track=None`` starts at the newest of latest and best and falls
        back newest -> the other track -> their ``.prev`` on a failed
        manifest or read, logging each rung skipped; an explicit ``track``
        ladders through that track and its ``.prev`` only.  Returns
        ``(state, start_epoch, best_score)``: ``(state, 0, 0.0)`` when no
        checkpoint exists; raises ``RuntimeError`` when every rung
        fails."""
        self.wait()
        t0 = time.perf_counter()
        self.last_restore_rung = None
        self.last_restore_loaded = None
        self.last_restore_meta = None
        self.last_restore_step_in_epoch = None
        self.last_restore_geometry = None
        if track is None:
            primary = self.newest_track() or "latest"
            other = "best" if primary == "latest" else "latest"
            rungs = [primary, other, primary + ".prev", other + ".prev"]
        else:
            rungs = [track, track + ".prev"]
        rungs = [t for t in rungs
                 if os.path.isdir(os.path.join(self.root, t))]
        rungs = self._apply_resume_cap(rungs, cap=resume_cap)
        if not rungs:
            return state, 0, 0.0
        failures = []
        for i, rung in enumerate(rungs):
            ok, detail = self.verify_track(rung)
            if not ok:
                self.log(f"[ckpt] integrity: '{rung}' failed verification "
                         f"({detail}); trying next rung")
                failures.append(f"{rung}: {detail}")
                continue
            try:
                payload = torch.load(
                    os.path.join(self.root, rung, PAYLOAD),
                    map_location="cpu", weights_only=True)
            except (OSError, RuntimeError, ValueError, EOFError,
                    pickle.UnpicklingError) as e:
                self.log(f"[ckpt] restore of '{rung}' failed "
                         f"({type(e).__name__}: {e}); trying next rung")
                failures.append(f"{rung}: {type(e).__name__}: {e}")
                continue
            out = self._restore_payload(state, payload, rung)
            self.last_restore_rung = rung
            if i > 0:
                self.log(f"[ckpt] integrity ladder: restored from rung "
                         f"'{rung}' (skipped {i}: " + "; ".join(failures)
                         + ")")
            self.last_restore_s = time.perf_counter() - t0
            return out
        raise RuntimeError(
            "no restorable checkpoint: every integrity-ladder rung failed ("
            + "; ".join(failures) + ")")

    def restore_exact(self, state, track: str):
        """Restore ``state`` (in place) from ``track`` alone, with no
        ladder fallback: the hot-swap gate's read.  The caller verifies
        the track first (``verify_track``); any read failure here raises.
        Returns ``(state, start_epoch, best_score)`` and sets the same
        ``last_restore_*`` attributes as ``restore_into``."""
        self.wait()
        t0 = time.perf_counter()
        self.last_restore_loaded = None
        self.last_restore_meta = None
        self.last_restore_step_in_epoch = None
        self.last_restore_geometry = None
        self.last_restore_rung = track
        payload = torch.load(os.path.join(self.root, track, PAYLOAD),
                             map_location="cpu", weights_only=True)
        out = self._restore_payload(state, payload, track)
        self.last_restore_s = time.perf_counter() - t0
        return out

    def _restore_payload(self, state, payload: Mapping, rung: str):
        """Copy one read payload into ``state``: the model's tensors by
        key intersection; the optimizer state, ``step`` and ``skip_count``
        only on a full match.  Start epoch as ``tpuic``'s restore: the
        saved epoch + 1, the saved epoch itself for a mid-epoch save (to
        continue it when the restore was full, else to replay it), and 0
        when nothing matched."""
        meta = payload.get("meta", {})
        epoch = int(meta.get("epoch", 0))
        best = float(meta.get("best_score", 0.0))
        sie = int(meta.get("step_in_epoch", -1))
        self.last_restore_meta = (epoch, sie)
        self.last_restore_geometry = tuple(
            int(meta.get(k, -1)) for k in GEOMETRY_META_KEYS)
        model = state.model
        merged, n_loaded, n_total = lenient_restore(
            model.state_dict(), payload.get("model", {}))
        # Copies in place: the tensors keep their storage, so the K2 leaf
        # table stays valid; the folded conv+BN weights are rebuilt.
        model.load_state_dict(merged)
        _invalidate(model)
        self.last_restore_loaded = (n_loaded, n_total)
        full = False
        if n_loaded == n_total:
            full = _copy_opt_state(state.opt_state,
                                   payload.get("opt_state", {}))
            if full:
                with torch.no_grad():
                    state.step.copy_(payload["step"])
                    state.skip_count.copy_(payload["skip_count"])
            else:
                self.log("[ckpt] optimizer state does not match the "
                         "optimizer; it starts fresh")
        self.log(f"[ckpt] restored {n_loaded}/{n_total} model tensors from "
                 f"{self.root}/{rung} (epoch {epoch}, best {best:.4f})")
        if sie >= 0 and full:
            self.last_restore_step_in_epoch = sie
            return state, epoch, best
        if sie >= 0 and n_loaded:
            return state, epoch, best
        return state, (epoch + 1 if n_loaded else 0), best
