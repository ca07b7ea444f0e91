"""Shard work queue and file leases (a copy of ``tpuic/score/work.py``):
who scores what, survivable by design.

The bulk scorer (``score/driver.py``) splits the packed corpus into
fixed-size shards and lets the elastic gang's ranks claim them through
two filesystem primitives: no coordinator process, no RPC, nothing that
can die and take the queue with it.

- **The plan** (``plan.json``): the shard table ``[(lo, hi), ...]`` plus
  a corpus token (n, image size, image-id CRC).  Written once, first
  worker wins (link of a complete tmp file); every later worker (and
  every resumed life) must read back an IDENTICAL plan or fail loudly:
  two workers scoring different shard geometries into one results dir
  would corrupt the exactly-once accounting silently.
- **Leases** (``leases/shard-NNNNN.lease``): a shard is claimed by
  ``O_CREAT | O_EXCL``-creating its lease file (atomic on POSIX: two
  racers get exactly one winner).  The lease carries the owner's rank
  and a random token; liveness is the file's **mtime** against the
  owner's declared TTL, renewed with ``os.utime`` between batches.  A
  dead rank stops renewing, the lease ages out, and any survivor
  **steals** it (tmp + rename, then a read-back of the token to detect a
  steal/steal race).  The membership file (``runtime/membership.py``)
  speeds the steal up: a lease whose owner is no longer in the active set
  is orphaned NOW, not a TTL from now.

The lease is a work-partitioning optimisation, not the correctness
boundary: clock skew (the ``lease_skew`` fault) or a steal/steal race can
make two live ranks score the same shard at once, and the commit layer
(``score/commit.py``, ``os.link`` first-wins) still keeps the results
exactly-once.  This module imports only the stdlib.
"""

from __future__ import annotations

import json
import os
import time
import uuid
import zlib
from typing import List, Optional, Sequence, Tuple

from tpuic_torch.runtime import faults

_PLAN_VERSION = 1

# Default lease TTL. Long enough that a healthy rank renewing once per
# device batch never ages out; short enough that a dead rank's shard is
# back in the queue within one human sigh. Membership-informed steals
# don't wait for it.
DEFAULT_TTL_S = 30.0


def plan_shards(n: int, shard_size: int) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` half-open row ranges covering ``0..n``."""
    if n <= 0:
        raise ValueError(f"plan_shards: empty corpus (n={n})")
    if shard_size <= 0:
        raise ValueError(f"plan_shards: shard_size must be > 0 "
                         f"(got {shard_size})")
    return [(lo, min(lo + shard_size, n)) for lo in range(0, n, shard_size)]


def corpus_token(n: int, size: int, image_ids: Sequence[str]) -> int:
    """Cheap corpus identity: CRC32 over (n, image size, every id), the
    guard against two workers scoring DIFFERENT corpora into one
    results directory (wrong --datadir, stale pack)."""
    crc = zlib.crc32(f"{n}:{size}".encode())
    for iid in image_ids:
        crc = zlib.crc32(str(iid).encode(), crc)
    return crc


def plan_path(workdir: str) -> str:
    return os.path.join(workdir, "plan.json")


def write_or_verify_plan(workdir: str, *, n: int, shard_size: int,
                         token: int, dtype: str) -> Tuple[dict, bool]:
    """Create ``plan.json`` first-wins, or verify the existing one.

    Returns ``(plan, created)``.  ``created`` is True only for the one
    worker whose O_EXCL create won; everyone else (including every
    resumed life) reads the winner's plan back and must find the same
    (n, shard_size, corpus token, dtype) — a geometry or corpus mismatch
    raises instead of silently interleaving two jobs' shards.
    """
    os.makedirs(workdir, exist_ok=True)
    path = plan_path(workdir)
    plan = {"version": _PLAN_VERSION, "n": int(n),
            "shard_size": int(shard_size), "corpus_token": int(token),
            "dtype": str(dtype),
            "shards": [[lo, hi] for lo, hi in plan_shards(n, shard_size)]}
    tmp = f"{path}.tmp.{uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        json.dump(plan, f)
    try:
        # Atomic first-wins claim of the plan slot: link the complete tmp
        # into place; EEXIST means another worker (or a prior life)
        # already planned — verify against it below.
        os.link(tmp, path)
        created = True
    except FileExistsError:
        created = False
    finally:
        os.unlink(tmp)
    with open(path) as f:
        existing = json.load(f)
    for key in ("version", "n", "shard_size", "corpus_token", "dtype"):
        if existing.get(key) != plan[key]:
            raise ValueError(
                f"score plan mismatch at {path}: {key}={existing.get(key)!r}"
                f" on disk vs {plan[key]!r} requested — this results dir "
                "belongs to a different job/corpus; refusing to mix")
    return existing, created


class LeaseDir:
    """The lease protocol over ``{workdir}/leases`` for one rank."""

    def __init__(self, workdir: str, rank: int,
                 ttl_s: float = DEFAULT_TTL_S) -> None:
        self.dir = os.path.join(workdir, "leases")
        os.makedirs(self.dir, exist_ok=True)
        self.rank = int(rank)
        self.ttl_s = float(ttl_s)
        self.token = uuid.uuid4().hex
        self.steals = 0

    def path(self, shard: int) -> str:
        return os.path.join(self.dir, f"shard-{int(shard):05d}.lease")

    def _payload(self) -> str:
        return json.dumps({"rank": self.rank, "token": self.token,
                           "ttl_s": self.ttl_s, "t": time.time()})

    def owner(self, shard: int) -> Optional[dict]:
        """The lease record on disk, or None (absent/torn — a torn lease
        reads as absent: it was mid-write, the writer owns the race)."""
        try:
            with open(self.path(shard)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _expired(self, shard: int,
                 active: Optional[Sequence[int]] = None) -> bool:
        """Whether the shard's lease is stealable: its owner left the
        membership's active set, or its mtime aged past the OWNER's
        declared TTL.  The ``lease_skew`` fault (param = skew seconds,
        default one full TTL) ages every observed lease — the
        clock-drift double-claim the commit layer must absorb."""
        p = self.path(shard)
        try:
            st = os.stat(p)
        except OSError:
            return False  # gone: release beat us; acquire, don't steal
        rec = self.owner(shard)
        if rec is None:
            # Mid-write by a live racer; let the TTL clock judge it.
            rec = {}
        if active is not None and rec.get("rank") is not None \
                and int(rec["rank"]) not in set(int(a) for a in active):
            return True
        ttl = float(rec.get("ttl_s", self.ttl_s))
        age = time.time() - st.st_mtime
        if faults.fire("lease_skew", step=int(shard)):
            skew = faults.param("lease_skew")
            age += float(skew) if skew is not None else ttl + 1.0
        return age > ttl

    def acquire(self, shard: int,
                active: Optional[Sequence[int]] = None) -> bool:
        """Claim ``shard``: O_EXCL create, else steal an expired lease.
        True iff this rank now holds it."""
        p = self.path(shard)
        try:
            fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if not self._expired(shard, active):
                return False
            return self._steal(shard)
        with os.fdopen(fd, "w") as f:
            f.write(self._payload())
        return True

    def _steal(self, shard: int) -> bool:
        """Replace an expired lease with our own (tmp + rename), then
        read back: if the surviving token is not ours, a concurrent
        stealer's rename landed after ours — they own it, we back off.
        The loser of the read-back race may still have scored a few
        rows; the commit layer dedups that work."""
        p = self.path(shard)
        tmp = f"{p}.tmp.{self.token}"
        with open(tmp, "w") as f:
            f.write(self._payload())
        os.replace(tmp, p)
        rec = self.owner(shard)
        if rec is not None and rec.get("token") == self.token:
            self.steals += 1
            return True
        return False

    def renew(self, shard: int) -> bool:
        """Refresh our lease's mtime (between batches).  False when the
        lease is no longer ours — the holder should abandon the shard
        (its work will be deduped at commit if it races the thief)."""
        rec = self.owner(shard)
        if rec is None or rec.get("token") != self.token:
            return False
        try:
            os.utime(self.path(shard))
            return True
        except OSError:
            return False

    def release(self, shard: int) -> None:
        """Drop our lease (only ours — never unlink a thief's)."""
        rec = self.owner(shard)
        if rec is not None and rec.get("token") == self.token:
            try:
                os.unlink(self.path(shard))
            except OSError:
                pass


def active_ranks(membership_file: str) -> Optional[List[int]]:
    """The membership file's current active set, or None when elastic
    membership isn't wired (no file configured / not yet written) — the
    lease layer then falls back to pure TTL expiry."""
    if not membership_file:
        return None
    from tpuic_torch.runtime.membership import read_membership
    m = read_membership(membership_file)
    if m is None:
        return None
    return [int(r) for r in m.active]
