"""Deterministic fault injection (a copy of ``tpuic/runtime/faults.py``).

Every recovery path has an injection point registered here, so tests drive
each failure deterministically on the CPU instead of waiting for a real
one.  Injection is off by default and free: an unarmed ``fire()`` is one
dict lookup.

``REGISTERED_POINTS`` is ``tpuic``'s whole set, so a chaos spec parses the
same in both packages.  The port fires the serving points:

- ``flood``         — serve CLI (``serve/__main__.py``): a synthetic
                      low-priority request storm submitted from inside
                      the process at ``param`` requests/s (default 50)
                      for the life of the server.
- ``replica_crash`` — serve socket transport (``--listen``): SIGKILL this
                      process after accepting the Nth request (``step`` =
                      the accept counter).
- ``replica_wedge`` — serve socket transport: stop servicing the socket at
                      the Nth accepted request (sleep ``param`` seconds;
                      an hour without a payload): pings go unanswered and
                      the heartbeat goes stale, the shape the supervisor's
                      watchdog escalates through SIGQUIT, SIGTERM, SIGKILL.
- ``hang_device``   — ``InferenceEngine._dispatch`` (``serve/engine.py``):
                      sleep ``param`` seconds (default 1) after staging,
                      before the device call.
- ``canary_degrade``— ``InferenceEngine._dispatch``: sleep ``param``
                      seconds (default 0.05) per device batch, but only
                      while the engine serves weights other than the ones
                      it booted with; swapping the boot weights back stands
                      it down.
- ``swap_corrupt``  — the hot-swap gate (``checkpoint/loading.py``
                      ``load_candidate_variables``): flip bytes of the
                      candidate's largest payload file before its CRC
                      verification, which must then refuse it.

and the training points, in the ``Trainer``'s step loop
(``train/loop.py``; ``step`` is the global step index, ``epoch *
steps_per_epoch +`` the step in the epoch) unless said otherwise:

- ``nan_batch``     — multiply this step's prepared float images by NaN
                      on the device (same shapes and dtypes).
- ``sigterm``       — SIGTERM to this process before the step: the real
                      preemption latch, flush and exit 43.
- ``slow_step``     — sleep ``param`` seconds (default 0.05) before it.
- ``hard_crash``    — SIGKILL this process before it.
- ``hang_step``     — stop making progress (sleep ``param`` seconds;
                      forever without a payload).
- ``rank_crash``    — SIGKILL, only on the rank ``param`` names (default
                      0; ``TPUIC_FLEET_RANK``, else the process index).
- ``rank_hang``     — wedge forever, only on the rank ``param`` names.
- ``decode_error``  — ``ImageFolderDataset.load`` (``data/folder.py``):
                      raise ``OSError`` in place of the decode; ``step``
                      is the dataset index.
- ``ckpt_kill``     — ``CheckpointManager``'s commit
                      (``checkpoint/manager.py``): raise ``InjectedFault``
                      after the staged save is written, before rotation.
- ``bf16_master_truncate`` — ``make_train_step`` (``train/step.py``),
                      checked when the step is built: every applied update
                      rounds the float32 master weights through bf16.

and the bulk-scoring points (``python -m tpuic_torch.score``):

- ``scorer_crash``  — the shard commit (``score/commit.py``): SIGKILL
                      this process between the result file's link and its
                      manifest, at the life's ``step``-th commit, only on
                      the rank ``param`` names (default 0).
- ``shard_corrupt`` — ``score/driver.py``: quarantine the row at offset
                      ``param`` (default 0) of shard ``step`` as if its
                      packed CRC had failed.
- ``lease_skew``    — the lease layer (``score/work.py``): age every
                      observed lease by ``param`` seconds (default one
                      TTL), the clock drift that double-claims a shard.

``rank_rejoin_flap`` needs elastic membership (ROADMAP §1 item 13): the
port fires it nowhere.  Each CLI refuses a spec that arms a point its
path does not fire, by name (``check_fired``).

Arming: programmatic (tests) via ``arm()``/``disarm()``/``reset()``, or
the ``TPUIC_FAULTS`` env var for whole-process CLI runs, a comma list of
``point[@STEP|@LO-HI][*TIMES][#PARAM]`` directives, e.g.::

    TPUIC_FAULTS='flood#400' python -m tpuic_torch.serve ...
    TPUIC_FAULTS='replica_crash@20' python -m tpuic_torch.serve --listen ...

``#PARAM`` (a float) sets the point's payload.  Spec directives are
validated at parse time: naming an unregistered point (or a malformed
step/times field) raises ValueError listing the registered points, so a
typo'd chaos spec fails the run loudly.  Programmatic ``arm()`` stays
unchecked (unit tests may use ad-hoc points).

File-corruption helpers (``truncate_file``, ``corrupt_file``) live here
too: the test-side tools for at-rest faults that have no code injection
point.

This module imports only the stdlib.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Optional, Union

__all__ = ["InjectedFault", "FaultPlan", "plan", "arm", "disarm", "reset",
           "fire", "param", "fired", "truncate_file", "corrupt_file",
           "REGISTERED_POINTS", "FIRED_BY", "check_fired"]

# Every injection point a site actually calls fire() on. TPUIC_FAULTS
# directives must name one of these — the spec parser fails fast on
# anything else (a typo'd chaos directive that silently never fires would
# read as "the system survived the fault" when no fault happened).
REGISTERED_POINTS = frozenset({
    "nan_batch", "sigterm", "decode_error", "ckpt_kill", "hang_device",
    "slow_step", "hard_crash", "hang_step", "flood", "rank_crash",
    "rank_hang", "rank_rejoin_flap", "replica_crash", "replica_wedge",
    "swap_corrupt", "canary_degrade", "bf16_master_truncate",
    "scorer_crash", "shard_corrupt", "lease_skew",
})


# The points each of the port's entry points fires.  rank_rejoin_flap
# is not ported yet: it comes with elastic membership (ROADMAP §1 item
# 13).
FIRED_BY = {
    "serve": frozenset({"flood", "replica_crash", "replica_wedge",
                        "hang_device", "canary_degrade", "swap_corrupt"}),
    "train": frozenset({"nan_batch", "sigterm", "decode_error",
                        "ckpt_kill", "slow_step", "hard_crash", "hang_step",
                        "rank_crash", "rank_hang", "bf16_master_truncate"}),
    "score": frozenset({"scorer_crash", "shard_corrupt", "lease_skew"}),
}
# The points no entry point of the port fires yet, with the ROADMAP §1
# item that brings each.
_LATER = {"rank_rejoin_flap": 13}


class InjectedFault(RuntimeError):
    """Raised by injection points that simulate a hard kill mid-operation
    (distinct type so tests can assert it was THIS fault, and production
    except-clauses never swallow it by accident)."""


class _Arm:
    __slots__ = ("steps", "times", "param", "count")

    def __init__(self, steps, times, param):
        self.steps = steps      # None = any step; else a set of ints
        self.times = times      # None = unlimited; else max firings
        self.param = param      # free-form payload (e.g. hang seconds)
        self.count = 0          # firings so far


class FaultPlan:
    """A set of armed injection points. Thread-safe: fire() is called from
    producer threads, the serve batcher, and the train loop alike."""

    def __init__(self, spec: str = "") -> None:
        self._lock = threading.Lock()
        self._arms: Dict[str, _Arm] = {}
        self.fired: Dict[str, int] = {}
        if spec:
            self._parse(spec)

    def _parse(self, spec: str) -> None:
        for raw in spec.split(","):
            directive = raw.strip()
            if not directive:
                continue
            try:
                param = None
                if "#" in directive:
                    directive, pv = directive.rsplit("#", 1)
                    param = float(pv)
                times = None
                if "*" in directive:
                    directive, t = directive.rsplit("*", 1)
                    times = int(t)
                steps: Optional[Iterable[int]] = None
                if "@" in directive:
                    directive, s = directive.split("@", 1)
                    if "-" in s:
                        lo, hi = s.split("-", 1)
                        steps = range(int(lo), int(hi) + 1)
                    else:
                        steps = (int(s),)
            except ValueError:
                raise ValueError(
                    f"TPUIC_FAULTS: malformed directive {raw.strip()!r} "
                    "(expected point[@STEP|@LO-HI][*TIMES][#PARAM])"
                ) from None
            if directive not in REGISTERED_POINTS:
                raise ValueError(
                    f"TPUIC_FAULTS: unknown injection point {directive!r} "
                    f"(registered: {', '.join(sorted(REGISTERED_POINTS))}) "
                    "— refusing to run a chaos spec that would silently "
                    "never fire")
            self.arm(directive, steps=steps, times=times, param=param)

    def arm(self, point: str, *, steps: Union[int, Iterable[int], None] = None,
            times: Optional[int] = None, param=None) -> None:
        """Arm ``point``: fire at the given ``steps`` (int, iterable, or
        None = every call), at most ``times`` total firings."""
        if isinstance(steps, int):
            steps = (steps,)
        with self._lock:
            self._arms[point] = _Arm(
                None if steps is None else frozenset(int(s) for s in steps),
                times, param)

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._arms.clear()
            else:
                self._arms.pop(point, None)

    def reset(self) -> None:
        """Disarm everything and clear firing history (test isolation)."""
        with self._lock:
            self._arms.clear()
            self.fired.clear()

    def armed(self) -> frozenset:
        """The points armed now."""
        with self._lock:
            return frozenset(self._arms)

    def param(self, point: str):
        """The armed payload of ``point`` (None when unarmed or no payload)."""
        with self._lock:
            a = self._arms.get(point)
            return a.param if a is not None else None

    def fire(self, point: str, step: Optional[int] = None) -> bool:
        """True iff ``point`` is armed for this call — and records the
        firing. The injection SITE decides what a firing means."""
        with self._lock:
            a = self._arms.get(point)
            if a is None:
                return False
            if a.steps is not None and (step is None
                                        or int(step) not in a.steps):
                return False
            if a.times is not None and a.count >= a.times:
                return False
            a.count += 1
            self.fired[point] = self.fired.get(point, 0) + 1
            return True


# The process-global plan: sites call the module-level functions, tests and
# the TPUIC_FAULTS env var arm it.
plan = FaultPlan(os.environ.get("TPUIC_FAULTS", ""))


def arm(point: str, *, steps=None, times=None, param=None) -> None:
    plan.arm(point, steps=steps, times=times, param=param)


def disarm(point: Optional[str] = None) -> None:
    plan.disarm(point)


def reset() -> None:
    plan.reset()


def fire(point: str, step: Optional[int] = None) -> bool:
    return plan.fire(point, step)


def param(point: str):
    return plan.param(point)


def fired(point: str) -> int:
    return plan.fired.get(point, 0)


def check_fired(entry: str, spec: Optional[str] = None) -> None:
    """Raise ValueError naming every armed point that ``entry``'s path
    ("serve", "train" or "score") does not fire, in the process plan or in
    ``spec`` (a ``TPUIC_FAULTS`` string, parsed here: a malformed one
    raises too): a chaos spec the port would drop without a word must fail
    the run instead."""
    armed = plan.armed() | (FaultPlan(spec).armed() if spec else frozenset())
    missing = sorted(armed - FIRED_BY[entry])
    if not missing:
        return
    why = []
    for p in missing:
        other = [e for e, pts in sorted(FIRED_BY.items()) if p in pts]
        why.append(f"the {other[0]} path fires {p!r}" if other else
                   f"{p!r} comes with ROADMAP §1 item {_LATER[p]}")
    raise ValueError(
        f"TPUIC_FAULTS: {', '.join(map(repr, missing))} not fired by the "
        f"port's {entry} path ({'; '.join(why)}); it fires "
        f"{', '.join(sorted(FIRED_BY[entry])) or 'none'}")


# -- at-rest corruption helpers (test-side tools) --------------------------
def truncate_file(path: str, keep: int = 8) -> None:
    """Truncate ``path`` to its first ``keep`` bytes — the classic
    interrupted-copy / interrupted-write artifact (truncated JPEG, half a
    checkpoint shard)."""
    with open(path, "r+b") as f:
        f.truncate(keep)


def corrupt_file(path: str, offset: int = 0, nbytes: int = 16) -> None:
    """Flip ``nbytes`` bytes of ``path`` starting at ``offset`` (XOR 0xFF)
    — silent bit-rot that keeps the file size, so only content checksums
    (the checkpoint manifest) can catch it."""
    size = os.path.getsize(path)
    offset = min(offset, max(0, size - 1))
    n = min(nbytes, size - offset)
    with open(path, "r+b") as f:
        f.seek(offset)
        data = f.read(n)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in data))
