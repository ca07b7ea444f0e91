"""Per-shard result commits (a copy of ``tpuic/score/commit.py``): stage,
link, CRC manifest, exactly once.

The checkpoint manager's integrity ladder (``checkpoint/manager.py``:
stage the complete artifact, fingerprint it, atomically rotate it into
place, verify before trusting) applied to shard results, with one twist:
a shard may be scored by TWO live ranks at once (an expired-lease steal,
``lease_skew`` clock drift), so the rotation step must also be the
arbitration step:

1. **Stage**: the shard's result lines are written to a token-unique tmp
   file, flushed and fsynced: the staged file is COMPLETE before step 2,
   so a result file, once visible, is never torn.
2. **Link** (the rotate rung): ``os.link(tmp, final)`` publishes it.
   Hard-link creation is atomic and fails with EEXIST if the name exists:
   of N concurrent committers exactly one wins; losers get a typed
   ``duplicate`` verdict (their bytes are identical anyway: result
   content is deterministic per shard).
3. **Manifest**: ``manifests/shard-NNNNN.json``: size + CRC32 of the
   published file plus the row accounting (scored/quarantined counts),
   written atomically.  A shard is *committed* iff its manifest exists
   AND the result file re-hashes to it: the exactly-once set is the
   lease-and-manifest intersection the driver resumes from.

Crash windows (who repairs what, always under the shard's lease):

- died between stage and link: an orphaned ``*.tmp.*`` nobody trusts;
  the next holder rescores.
- died between link and manifest (the ``scorer_crash`` fault's window):
  a result without a manifest; the next holder **adopts** it: the staged
  file was complete by construction, so it re-hashes the bytes and
  writes the missing manifest instead of rescoring.
- a manifest that no longer matches its file (at-rest bit-rot,
  ``corrupt_file``): ``discard()`` both under the lease and rescore.

This module imports only the stdlib.
"""

from __future__ import annotations

import json
import os
import signal
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

from tpuic_torch.runtime import faults


def _atomic_json(path: str, obj) -> None:
    """tmp + rename so readers never see a half-written manifest (the
    checkpoint manager's, copied: that module loads torch)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _file_crc(path: str) -> Tuple[int, int]:
    """(size, crc32) of ``path``: the manager's chunked fingerprint
    discipline (bit-rot and torn writes, not adversaries)."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, crc


def result_line(rec: Dict) -> str:
    """Canonical byte encoding of one result row: sorted keys, no
    whitespace, probabilities pre-formatted as %.6f STRINGS by the
    caller: identical row facts encode to identical bytes on every
    rank, which is what makes the link-arbitrated duplicate commit
    harmless and the soak's bitwise-equality assertion meaningful."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"


class ShardStore:
    """Results + manifests for one scoring job's workdir."""

    def __init__(self, workdir: str, rank: int) -> None:
        self.results_dir = os.path.join(workdir, "results")
        self.manifest_dir = os.path.join(workdir, "manifests")
        os.makedirs(self.results_dir, exist_ok=True)
        os.makedirs(self.manifest_dir, exist_ok=True)
        self.rank = int(rank)
        self.commits = 0      # shards THIS life linked (scorer_crash step)
        self.duplicates = 0   # commits we lost to a faster rank

    def result_path(self, shard: int) -> str:
        return os.path.join(self.results_dir,
                            f"shard-{int(shard):05d}.jsonl")

    def manifest_path(self, shard: int) -> str:
        return os.path.join(self.manifest_dir,
                            f"shard-{int(shard):05d}.json")

    def manifest(self, shard: int) -> Optional[dict]:
        try:
            with open(self.manifest_path(shard)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def state(self, shard: int) -> str:
        """``committed`` (manifest present and the result re-hashes to
        it), ``corrupt`` (manifest disagrees with the bytes: at-rest
        rot; discard + rescore), ``orphan`` (result published without a
        manifest: the winner died in the scorer_crash window; adopt),
        or ``missing``."""
        have_result = os.path.exists(self.result_path(shard))
        man = self.manifest(shard)
        if man is not None and have_result:
            size, crc = _file_crc(self.result_path(shard))
            if size == man.get("size") and crc == man.get("crc32"):
                return "committed"
            return "corrupt"
        if man is not None:  # manifest without bytes: equally untrusted
            return "corrupt"
        if have_result:
            return "orphan"
        return "missing"

    def discard(self, shard: int) -> None:
        """Drop a corrupt result + manifest pair (caller holds the
        lease) so the shard re-enters the queue as ``missing``."""
        for p in (self.manifest_path(shard), self.result_path(shard)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _write_manifest(self, shard: int, lo: int, hi: int, scored: int,
                        quarantined: int, *, adopted: bool) -> dict:
        size, crc = _file_crc(self.result_path(shard))
        man = {"shard": int(shard), "lo": int(lo), "hi": int(hi),
               "rows": int(hi - lo), "scored": int(scored),
               "quarantined": int(quarantined), "size": size,
               "crc32": crc, "rank": self.rank, "adopted": bool(adopted)}
        _atomic_json(self.manifest_path(shard), man)
        return man

    def commit(self, shard: int, lo: int, hi: int, lines: List[str],
               scored: int, quarantined: int) -> Tuple[str, dict]:
        """Stage + link + manifest for a freshly scored shard.

        Returns ``(verdict, manifest)`` with verdict ``committed`` (we
        won the link) or ``duplicate`` (another rank's identical result
        was already published; we adopt its manifest, writing it if the
        winner died inside the scorer_crash window)."""
        final = self.result_path(shard)
        tmp = os.path.join(self.results_dir,
                           f".shard-{int(shard):05d}.tmp.{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            f.writelines(lines)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, final)
            won = True
        except FileExistsError:
            won = False
        finally:
            os.unlink(tmp)
        if won:
            self.commits += 1
            # The SIGKILL-between-link-and-manifest window: step is this
            # life's 1-based shard-commit ordinal, #PARAM the victim rank
            # (default 0, the rank_crash convention).  The dead rank's
            # published-but-unmanifested result is what the adopt path
            # exists for.
            if faults.fire("scorer_crash", step=self.commits):
                target = faults.param("scorer_crash")
                if self.rank == int(target or 0):
                    os.kill(os.getpid(), signal.SIGKILL)
            man = self._write_manifest(shard, lo, hi, scored, quarantined,
                                       adopted=False)
            return "committed", man
        self.duplicates += 1
        man = self.manifest(shard)
        if man is None:
            # Winner died in the scorer_crash window; its bytes are
            # deterministic (== ours), so finish ITS commit.
            man = self._write_manifest(shard, lo, hi, scored, quarantined,
                                       adopted=True)
        return "duplicate", man

    def adopt(self, shard: int, lo: int, hi: int, scored: int,
              quarantined: int) -> dict:
        """Write the missing manifest for an orphaned (published,
        complete-by-construction) result file the caller re-derived the
        row accounting for.  Caller holds the shard's lease."""
        return self._write_manifest(shard, lo, hi, scored, quarantined,
                                    adopted=True)
