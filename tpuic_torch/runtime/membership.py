"""Elastic fleet membership (a copy of ``tpuic/runtime/membership.py``):
the file protocol between a gang's launcher and its ranks.

An elastic gang treats a lost rank as a *degrade* event, not a restart
event: survivors carry on without the dead rank, and a replacement
rejoins later.  The only channel wide enough for that, without the parent
importing torch or the ranks opening sockets, is a single atomically
rewritten JSON file, the heartbeat-file pattern in reverse:

- **Writer** (the launcher): :func:`write_membership` rewrites the file
  tmp + rename on every membership transition, with a strictly
  increasing ``version`` so readers order transitions without clocks.
- **Reader** (each rank): :func:`read_membership` reads the current view
  (the bulk scorer's lease layer, ``score/work.py`` ``active_ranks``);
  :class:`MembershipWatcher` polls it (one ``os.stat`` a poll; the file
  is re-read only when its mtime or size moved) and surfaces each *new*
  version exactly once.

The record (:class:`Membership`) carries the full fleet view: ``world``
(the configured replica count R), ``active`` (the rank ids currently in
the fleet), ``resume_step`` (the fleet-agreed checkpoint step survivors
re-form from), and ``reason`` (``init``/``degrade``/``rejoin``/
``restart``).

The port reads the file: ``python -m tpuic_torch.score``'s ranks steal a
lease whose owner left the active set at once, not a TTL later.  The gang
supervisor's writer side and the Trainer's re-form are ROADMAP §1 item
13.  This module imports only the stdlib.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

# Injected into every rank of an elastic gang; readers watch the file
# when (and only when) the env is present: zero cost otherwise.
ENV_MEMBERSHIP_FILE = "TPUIC_MEMBERSHIP_FILE"

REASONS = ("init", "degrade", "rejoin", "restart")


@dataclasses.dataclass(frozen=True)
class Membership:
    """One fleet-membership view, as the writer published it."""
    version: int                  # strictly increasing per transition
    world: int                    # configured replica count R
    active: List[int]             # rank ids currently in the fleet
    resume_step: Optional[int]    # fleet-agreed checkpoint step (cap)
    reason: str                   # one of REASONS
    rank: Optional[int] = None    # the rank the transition is about
    t: float = 0.0                # wall time of the write (informational)

    @property
    def replicas(self) -> int:
        """The data-parallel extent of this view: len(active)."""
        return len(self.active)


def write_membership(path: str, m: Membership) -> None:
    """Atomically publish ``m`` (tmp + rename: readers never see a torn
    record, and a SIGKILL mid-write leaves the previous view in force)."""
    if m.reason not in REASONS:
        raise ValueError(f"membership reason {m.reason!r} not in {REASONS}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(m), f)
    os.replace(tmp, path)


def read_membership(path: str) -> Optional[Membership]:
    """The current view, or None when absent, unreadable or torn (a
    reader mid-transition keeps its previous view rather than crashing)."""
    try:
        with open(path) as f:
            raw = json.load(f)
        return Membership(
            version=int(raw["version"]), world=int(raw["world"]),
            active=[int(r) for r in raw["active"]],
            resume_step=(None if raw.get("resume_step") is None
                         else int(raw["resume_step"])),
            reason=str(raw.get("reason", "init")),
            rank=(None if raw.get("rank") is None else int(raw["rank"])),
            t=float(raw.get("t", 0.0)))
    except (OSError, ValueError, KeyError, TypeError):
        return None


class MembershipWatcher:
    """Rank-side poller: surfaces each NEW membership version once.

    ``poll()`` suits a per-step cadence: one ``os.stat`` when nothing
    changed (no read, no parse).  The spawn-time view is swallowed (the
    world the rank was spawned into is not a transition), so only genuine
    mid-run changes reach the caller."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._stamp = None            # (mtime_ns, size) last parsed
        self._version = -1            # last version surfaced or swallowed
        self.current: Optional[Membership] = None
        # Versions that came and went between polls before the one
        # ``poll()`` just surfaced (the file holds only the latest view,
        # so a degrade overwritten by its rejoin can coalesce): a surfaced
        # record with ``skipped > 0`` may stand in for an unseen degrade.
        self.skipped = 0
        # Prime on the spawn-time view: a rank joining an already-degraded
        # fleet must not treat the standing view as a fresh transition.
        first = self._read_if_changed()
        if first is not None:
            self._version = first.version

    @classmethod
    def from_env(cls) -> Optional["MembershipWatcher"]:
        path = os.environ.get(ENV_MEMBERSHIP_FILE, "")
        return cls(path) if path else None

    def _read_if_changed(self) -> Optional[Membership]:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        stamp = (st.st_mtime_ns, st.st_size)
        if stamp == self._stamp:
            return None
        self._stamp = stamp
        m = read_membership(self.path)
        if m is not None:
            self.current = m
        return m

    def poll(self) -> Optional[Membership]:
        """The new view if the membership CHANGED since last surfaced
        (or since the spawn-time view), else None.  ``self.skipped``
        counts the versions that coalesced away between polls."""
        m = self._read_if_changed()
        if m is None or m.version <= self._version:
            return None
        self.skipped = (m.version - self._version - 1
                        if self._version >= 0 else 0)
        self._version = m.version
        return m
