"""Gang supervisor: N ranks spawned, watched and restarted as one unit
(a copy of ``tpuic/runtime/gang.py``'s coordinated path).

The single-child supervisor (``runtime/supervisor.py``) covers one
process dying.  A data-parallel group fails partly: one dead or wedged
rank leaves every survivor blocked inside a collective that will never
complete, and a rank resuming from a checkpoint the others never
committed desynchronises the group.  ``python -m tpuic_torch.supervise
--gang N`` supervises the whole group as one failure domain:

- **Per-rank heartbeat watchdogs.**  Rank k gets its own heartbeat file
  (``heartbeat.json``, ``heartbeat.rank<k>.json``: the
  ``<stem>.rank<k>`` convention of ``telemetry/fleet.py``'s per-rank
  streams) and its own ``stackdump-<attempt>[.rank<k>].txt`` and
  ``flightdump-...jsonl``.  A stale rank is escalated as the single child
  is (SIGQUIT dumps, SIGTERM, SIGKILL: the shared ``_Child`` ladder), the
  hang attributed to its rank in the ledger, and it tears the gang down.
- **Coordinated restart.**  A rank exiting retryable (a crash, a signal
  death) or killed by its watchdog tears the whole gang down: every
  survivor gets SIGTERM and the ``--grace-s`` flush window, then SIGKILL,
  and all ranks restart together.  A flush of the whole gang (43)
  restarts free; poison (44) from any rank stops the gang; exit 0 from
  one rank waits for the rest.
- **Gang-wide crash-loop ledger**: the no-progress streak runs over the
  fleet-min best step, so one healthy rank cannot mask a peer stuck at
  step 0; a resumed rank whose first step jumps past its own best + 1
  is a ledger violation.
- **Restart-consistent resume.**  With ``--gang-ckpt`` naming the
  checkpoint model dirs (the ones holding ``*.manifest.json``), a
  restart reads every rank's committed manifests and picks the newest
  step every rank has (``fleet_resume_step``); it rides
  ``TPUIC_RESUME_STEP`` into each rank, where ``restore_into`` refuses
  rungs past it.  The port's trainer writes its checkpoints from process
  0 alone, into one directory every rank reads: ``--gang-ckpt`` without
  ``{rank}`` names that one shared directory (every rank agrees on its
  manifests by construction); with ``{rank}``, per-rank directories, as
  ``tpuic``'s ranks write them.  A survivor whose flush cannot complete
  (its ``agree`` all-reduce needs the dead peer: gloo raises, NCCL
  blocks) is SIGKILLed at the grace deadline; a save is staged and
  renamed, so it never leaves a torn ``latest``, and the fleet resumes
  from the last committed step.
- **Rank identity.**  Each rank gets ``TPUIC_FLEET_RANK`` /
  ``TPUIC_FLEET_RANKS`` (telemetry tags, per-rank streams, the
  rank-targeted fault points) and, with ``--coordinator``, the
  ``TPUIC_COORDINATOR_ADDRESS`` / ``TPUIC_NUM_PROCESSES`` /
  ``TPUIC_PROCESS_ID`` trio that ``runtime/distributed.py`` joins the
  process group from.  ``{rank}`` in the child command is substituted
  per rank.

``tpuic``'s elastic mode (degrade and rejoin without restarting the
survivors, ``--elastic``, ``--min-ranks``, ``--max-respawns``: the writer
side of ``runtime/membership.py``, whose reader the bulk scorer uses) is
ROADMAP §1 item 13.

Like the single supervisor, this module imports only the stdlib: the
parent must never initialise CUDA, and must outlive any wedge a rank
hits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from tpuic_torch.runtime.supervisor import (DONE, ENV_DOWN_SINCE,
                                            ENV_HEARTBEAT_INTERVAL,
                                            ENV_RESTART, ENV_RESUME_STEP,
                                            EXIT_CRASH_LOOP, EXIT_POISON,
                                            EXIT_PREEMPTED, POISON,
                                            PREEMPTED, RETRYABLE, _Child,
                                            classify_exit)
# Per-rank heartbeat, stack and flight dump paths follow the per-rank
# stream convention (``<stem>.rank<k><ext>``); ``telemetry.fleet`` is
# stdlib-only, so the parent stays free of torch.
from tpuic_torch.telemetry.fleet import (ENV_FLEET_RANK, ENV_FLEET_RANKS,
                                         rank_stream_path as rank_path)


# Committed-manifest sidecars a checkpoint dir may hold (checkpoint/
# manager.py's track rotation), newest first per track.
_MANIFEST_TRACKS = ("latest", "best", "latest.prev", "best.prev")


def committed_steps(ckpt_dir: str) -> Dict[str, int]:
    """{track: committed optimizer step} for every readable manifest
    sidecar under one rank's checkpoint model dir. Unreadable or
    step-less manifests are skipped (pre-ladder checkpoints carry no
    fleet-comparable step)."""
    out: Dict[str, int] = {}
    for track in _MANIFEST_TRACKS:
        try:
            with open(os.path.join(ckpt_dir,
                                   track + ".manifest.json")) as f:
                step = json.load(f).get("step")
            if step is not None:
                out[track] = int(step)
        except (OSError, ValueError, TypeError):
            continue
    return out


def fleet_resume_step(ckpt_dirs: Sequence[str]) -> Optional[int]:
    """The newest checkpoint step EVERY rank's committed manifests agree
    on — the step a coordinated restart resumes from.

    Per rank, the candidate set is every step with a committed manifest
    (latest/best and their ``.prev`` rotations). The fleet step is the
    max of the intersection; when no common step exists (pathological —
    ranks committing on the same save cadence always share one), the
    fallback is the slowest rank's newest commit, which every faster
    rank satisfies with an *older* rung (never a newer one — the child
    side's ``TPUIC_RESUME_STEP`` filter enforces ≤). None when any rank
    has no committed manifest at all (nothing to agree on: the run died
    before its first commit, every rank starts over together)."""
    per_rank: List[set] = []
    for d in ckpt_dirs:
        steps = set(committed_steps(d).values())
        if not steps:
            return None
        per_rank.append(steps)
    if not per_rank:
        return None
    common = set.intersection(*per_rank)
    if common:
        return max(common)
    return min(max(s) for s in per_rank)


@dataclasses.dataclass
class GangAttempt:
    """One gang life, as the supervisor observed it."""
    attempt: int
    codes: List[int]                    # per-rank exit codes
    hung_ranks: List[int]               # watchdog-escalated ranks
    first_steps: List[Optional[int]]
    last_steps: List[Optional[int]]
    fleet_step: Optional[int]           # min over ranks (None if any is)
    outcome: str                        # DONE/PREEMPTED/POISON/RETRYABLE
    duration_s: float


class GangSupervisor:
    """Run ``cmd`` (a template: ``{rank}`` substituted per rank) as a
    gang of ``ranks`` supervised children; module docstring has the
    protocol. Knobs mirror :class:`Supervisor` — one flush window, one
    watchdog, one restart budget for the whole gang.

    ``ckpt_dirs``: per-rank checkpoint MODEL dirs (the dirs holding the
    ``*.manifest.json`` sidecars) — a ``{rank}`` template string or an
    explicit per-rank sequence; enables the fleet-agreed resume step.
    ``coordinator``: when set, each rank additionally gets the full
    process-group rendezvous trio.  A ``{rank}``-free ``ckpt_dirs``
    string is one directory all ranks share (the port's process-0
    writer).  ``chaos`` gives attempt i's ``TPUIC_FAULTS`` (every rank
    gets it)."""

    def __init__(self, cmd: Sequence[str], state_dir: str, *, ranks: int,
                 watchdog_s: float = 300.0, startup_grace_s: float = 1800.0,
                 quit_wait_s: float = 3.0, grace_s: float = 30.0,
                 poll_s: float = 0.5, max_restarts: int = 16,
                 backoff_s: float = 1.0, backoff_max_s: float = 300.0,
                 crash_loop_k: int = 3, heartbeat_interval_s: float = 1.0,
                 chaos: Optional[Sequence[str]] = None,
                 ckpt_dirs: Union[str, Sequence[str], None] = None,
                 coordinator: str = "",
                 env: Optional[Dict[str, str]] = None,
                 log: Optional[Callable[[str], None]] = None) -> None:
        self.cmd = list(cmd)
        self.ranks = int(ranks)
        if self.ranks < 1:
            raise ValueError(f"gang needs >= 1 rank (got {ranks})")
        self.state_dir = os.path.abspath(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.ledger_file = os.path.join(self.state_dir, "ledger.jsonl")
        self.watchdog_s = float(watchdog_s)
        self.startup_grace_s = float(startup_grace_s)
        self.quit_wait_s = float(quit_wait_s)
        self.grace_s = float(grace_s)
        self.poll_s = float(poll_s)
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.crash_loop_k = int(crash_loop_k)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.chaos = list(chaos) if chaos else []
        if isinstance(ckpt_dirs, str):
            self.ckpt_dirs: Optional[List[str]] = [
                ckpt_dirs.replace("{rank}", str(k))
                for k in range(self.ranks)]
        elif ckpt_dirs is not None:
            self.ckpt_dirs = list(ckpt_dirs)
            if len(self.ckpt_dirs) != self.ranks:
                raise ValueError(
                    f"ckpt_dirs has {len(self.ckpt_dirs)} entries for "
                    f"{self.ranks} ranks")
        else:
            self.ckpt_dirs = None
        self.coordinator = coordinator
        self.extra_env = dict(env or {})
        self._log = log or (lambda msg: print(f"[gang] {msg}",
                                              file=sys.stderr, flush=True))
        self._children: List[_Child] = []
        self._shutdown = False
        self.restarts = 0        # total gang restarts (incl. flushes)
        self.crash_restarts = 0  # retryable gang failures — the budget
        self.attempts: List[GangAttempt] = []
        self.best_steps: List[Optional[int]] = [None] * self.ranks
        self.best_fleet_step: Optional[int] = None
        self.violations = 0
        self.last_resume_step: Optional[int] = None

    # -- plumbing -------------------------------------------------------
    def _ledger(self, event: str, **data) -> None:
        rec = {"event": event, "t": round(time.time(), 3), **data}
        with open(self.ledger_file, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _rank_cmd(self, rank: int) -> List[str]:
        return [a.replace("{rank}", str(rank)) for a in self.cmd]

    def _on_signal(self, signum, frame) -> None:
        # Shared eviction: forward ONE flush-window SIGTERM to every
        # live rank (the _Child.term() per-pid guard makes a repeated
        # external signal harmless — the single supervisor's flake fix).
        self._shutdown = True
        for c in self._children:
            c.term()

    def _spawn_env(self, attempt: int, rank: int, down_since: float,
                   resume_step: Optional[int]) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        env[ENV_HEARTBEAT_INTERVAL] = repr(self.heartbeat_interval_s)
        env[ENV_RESTART] = str(attempt)
        env[ENV_DOWN_SINCE] = repr(down_since)
        # One rank-identity source for everything downstream: telemetry
        # tagging + per-rank streams (fleet.py), rank-targeted fault
        # points (rank_crash/rank_hang), and — with a coordinator — the
        # process group itself.
        env[ENV_FLEET_RANK] = str(rank)
        env[ENV_FLEET_RANKS] = str(self.ranks)
        if self.coordinator:
            env["TPUIC_COORDINATOR_ADDRESS"] = self.coordinator
            env["TPUIC_NUM_PROCESSES"] = str(self.ranks)
            env["TPUIC_PROCESS_ID"] = str(rank)
        if resume_step is not None:
            env[ENV_RESUME_STEP] = str(resume_step)
        else:
            env.pop(ENV_RESUME_STEP, None)
        if self.chaos:
            spec = self.chaos[attempt] if attempt < len(self.chaos) else ""
            env["TPUIC_FAULTS"] = spec
        return env

    # -- one gang attempt ------------------------------------------------
    def _teardown(self, why: str, rank: Optional[int]) -> None:
        """Coordinated gang teardown: one SIGTERM per live rank (the
        flush window — a healthy survivor commits a step-exact
        checkpoint and exits 43), then SIGKILL any straggler after the
        shared grace deadline. Survivors blocked inside a collective
        cannot make progress once any member died, so this is recovery,
        not collateral damage."""
        survivors = [k for k, c in enumerate(self._children) if c.alive()]
        if survivors:
            at = f" (rank {rank})" if rank is not None else ""
            self._log(f"tearing down gang [{why}{at}]: SIGTERM flush "
                      f"window ({self.grace_s:.0f}s) for rank(s) "
                      f"{survivors}")
        for c in self._children:
            c.term()
        deadline = time.monotonic() + self.grace_s
        for c in self._children:
            if c.proc is None:
                continue
            remaining = max(0.0, deadline - time.monotonic())
            try:
                c.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                c.signal(signal.SIGKILL)
                c.proc.wait()
        self._ledger("teardown", why=why, rank=rank, survivors=survivors)

    def _monitor(self, attempt: int) -> Optional[Tuple[str, Optional[int]]]:
        """Poll the gang until it needs a coordinated action. Returns the
        teardown cause ``(why, rank)`` or None when every rank exited on
        its own."""
        children = self._children
        while True:
            if all(c.poll() is not None for c in children):
                return None
            time.sleep(self.poll_s)
            now = time.monotonic()
            for c in children:
                if c.alive():
                    c.observe(now)
            if self._shutdown:
                return ("shutdown", None)
            for k, c in enumerate(children):
                rc = c.poll()
                if rc is None:
                    continue
                outcome = classify_exit(rc)
                if outcome == DONE:
                    continue  # one rank finishing early just waits
                # 43 (a lone flush), 44 (poison), or a crash: the gang
                # cannot make progress with a member gone — tear down.
                return (outcome, k)
            for k, c in enumerate(children):
                if not c.alive():
                    continue
                window = c.window_s(self.watchdog_s, self.startup_grace_s)
                stale = c.stale_s(now)
                if stale > window:
                    self._log(f"attempt {attempt}: HANG on rank {k} — no "
                              f"heartbeat for {stale:.1f}s (window "
                              f"{window:.0f}s, last step {c.last_step}); "
                              f"SIGQUIT stack dump, then SIGTERM, then "
                              f"SIGKILL")
                    self._ledger("hang", attempt=attempt, rank=k,
                                 stale_s=round(stale, 1),
                                 last_step=c.last_step,
                                 stack_dump=c.stack_dump,
                                 flight_dump=c.flight_dump)
                    c.escalate(self.quit_wait_s, self.grace_s)
                    return ("hang", k)

    def _run_attempt(self, attempt: int, down_since: float) -> GangAttempt:
        resume_step = None
        if attempt > 0 and self.ckpt_dirs:
            resume_step = fleet_resume_step(self.ckpt_dirs)
            self.last_resume_step = resume_step
            if resume_step is not None:
                self._log(f"attempt {attempt}: fleet-agreed resume step "
                          f"{resume_step} (newest step every rank's "
                          "committed manifest covers)")
            else:
                self._log(f"attempt {attempt}: no fleet-agreed resume "
                          "step (some rank has no committed manifest) — "
                          "ranks resume independently")
            self._ledger("gang_resume", attempt=attempt, step=resume_step,
                         per_rank={str(k): sorted(set(
                             committed_steps(d).values()))
                             for k, d in enumerate(self.ckpt_dirs)})
        self._children = []
        t0 = time.monotonic()
        for k in range(self.ranks):
            child = _Child(
                self._rank_cmd(k),
                heartbeat_file=rank_path(
                    os.path.join(self.state_dir, "heartbeat.json"), k),
                stack_dump=rank_path(
                    os.path.join(self.state_dir,
                                 f"stackdump-{attempt}.txt"), k),
                flight_dump=rank_path(
                    os.path.join(self.state_dir,
                                 f"flightdump-{attempt}.jsonl"), k),
                label=f"rank {k}")
            child.spawn(self._spawn_env(attempt, k, down_since, resume_step))
            self._ledger("spawn", attempt=attempt, rank=k, pid=child.pid,
                         restart=attempt > 0,
                         faults=(self.chaos[attempt]
                                 if self.chaos and attempt < len(self.chaos)
                                 else ""))
            self._children.append(child)
        cause = self._monitor(attempt)
        if cause is not None:
            self._teardown(*cause)
        codes = [c.finalize() for c in self._children]
        hung = [k for k, c in enumerate(self._children) if c.hung]
        outcomes = [classify_exit(rc, self._shutdown) for rc in codes]
        if any(o == POISON for o in outcomes):
            # Poison wins even over a concurrent hang: a rank reporting
            # 44 during a hang-triggered teardown (e.g. its flush found
            # every checkpoint rung corrupt) is still a deterministic
            # failure the restart cannot fix — the documented contract
            # is "poison from ANY rank stops the gang".
            outcome = POISON
        elif hung:
            # A watchdog kill is a retryable failure even when the
            # SIGTERM half of the escalation produced a clean-looking 43.
            outcome = RETRYABLE
        elif any(o == RETRYABLE for o in outcomes):
            outcome = RETRYABLE
        elif any(o == PREEMPTED for o in outcomes):
            outcome = PREEMPTED
        else:
            outcome = DONE
        firsts = [c.first_step for c in self._children]
        lasts = [c.last_step for c in self._children]
        fleet = (min(lasts) if lasts and all(s is not None for s in lasts)
                 else None)
        res = GangAttempt(attempt=attempt, codes=codes, hung_ranks=hung,
                          first_steps=firsts, last_steps=lasts,
                          fleet_step=fleet, outcome=outcome,
                          duration_s=round(time.monotonic() - t0, 3))
        for k, c in enumerate(self._children):
            self._ledger("exit", attempt=attempt, rank=k, returncode=codes[k],
                         hung=c.hung, first_step=c.first_step,
                         last_step=c.last_step,
                         outcome=classify_exit(codes[k], self._shutdown))
        self._ledger("gang_exit", attempt=attempt, codes=codes,
                     hung_ranks=hung, fleet_step=fleet, outcome=outcome,
                     duration_s=res.duration_s)
        self._children = []
        return res

    def run(self) -> int:
        installed = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                installed[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # non-main thread (tests)
                pass
        try:
            return self._run()
        finally:
            for sig, prev in installed.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass

    def _give_up(self, reason: str, code: int) -> int:
        self._log(f"GIVING UP (non-retryable): {reason}")
        self._ledger("giveup", reason=reason, restarts=self.restarts,
                     best_fleet_step=self.best_fleet_step, returncode=code)
        return code

    def _book_progress(self, res: GangAttempt) -> bool:
        """Fold one attempt into the per-rank and fleet-min ledgers;
        returns whether the FLEET made progress (the crash-loop
        currency — one healthy rank cannot mask a stuck peer)."""
        for k in range(self.ranks):
            first, last = res.first_steps[k], res.last_steps[k]
            if (first is not None and self.best_steps[k] is not None
                    and first > self.best_steps[k] + 1):
                self.violations += 1
                self._log(f"LEDGER VIOLATION: attempt {res.attempt} rank "
                          f"{k} first step {first} skips past its best "
                          f"previous step {self.best_steps[k]}")
                self._ledger("violation", attempt=res.attempt, rank=k,
                             first_step=first,
                             best_step=self.best_steps[k])
            if last is not None and (self.best_steps[k] is None
                                     or last > self.best_steps[k]):
                self.best_steps[k] = last
        progressed = (res.fleet_step is not None
                      and (self.best_fleet_step is None
                           or res.fleet_step > self.best_fleet_step))
        if progressed:
            self.best_fleet_step = res.fleet_step
        return progressed

    def _run(self) -> int:
        attempt = 0
        no_progress = 0
        down_since = time.time()
        while True:
            res = self._run_attempt(attempt, down_since)
            self.attempts.append(res)
            down_since = time.time()
            progressed = self._book_progress(res)
            if self._shutdown:
                # Shared eviction / operator stop: mirror the single
                # supervisor — flushes and completions propagate, any
                # other code is reported as-is (128+N for signal death).
                bad = [rc for rc in res.codes
                       if classify_exit(rc, True) == POISON]
                if bad:
                    code = bad[0]
                    if code < 0:
                        code = 128 - code
                    return self._give_up(
                        f"rank exit code(s) {res.codes} during supervisor "
                        "shutdown", code)
                code = (EXIT_PREEMPTED if EXIT_PREEMPTED in res.codes
                        else 0)
                self._log(f"gang shut down (codes {res.codes}); exit "
                          f"{code}")
                self._ledger("done", attempts=attempt + 1,
                             restarts=self.restarts,
                             best_fleet_step=self.best_fleet_step,
                             returncode=code)
                return code
            if res.outcome == DONE:
                self._log(f"gang completed cleanly (codes {res.codes}) "
                          f"after {attempt + 1} attempt(s), best fleet "
                          f"step {self.best_fleet_step}")
                self._ledger("done", attempts=attempt + 1,
                             restarts=self.restarts,
                             best_fleet_step=self.best_fleet_step,
                             returncode=0)
                return 0
            if res.outcome == POISON:
                ranks = [k for k, rc in enumerate(res.codes)
                         if rc == EXIT_POISON]
                return self._give_up(
                    f"rank(s) {ranks} exited poison (codes {res.codes}): "
                    "restarting the gang cannot help", EXIT_POISON)
            # Retryable (a rank crashed/hung) or a clean gang-wide
            # preemption flush. Budget/backoff/crash-loop semantics
            # mirror the single supervisor, but progress is FLEET-MIN:
            # a peer stuck at step 0 keeps the streak alive no matter
            # how far the healthy ranks run ahead.
            if progressed:
                no_progress = 0
            elif (all(s is None for s in res.last_steps)
                  and not res.hung_ranks
                  and res.duration_s >= self.startup_grace_s
                  + self.watchdog_s):
                # Step-less gang (supervised serve replicas beat, never
                # step): a life that outlived startup grace + a full
                # watchdog window was demonstrably beating on every rank.
                no_progress = 0
            else:
                no_progress += 1
            if (res.outcome == RETRYABLE
                    and self.crash_restarts >= self.max_restarts):
                return self._give_up(
                    f"restart budget exhausted ({self.max_restarts} "
                    "retryable gang failures)", EXIT_CRASH_LOOP)
            if no_progress >= self.crash_loop_k:
                return self._give_up(
                    f"gang crash loop: {no_progress} consecutive attempts "
                    f"with no fleet-min step progress (stuck at "
                    f"{self.best_fleet_step}; per-rank best "
                    f"{self.best_steps}) — the failure is deterministic, "
                    "restarting cannot help", EXIT_CRASH_LOOP)
            self.restarts += 1
            if res.outcome == RETRYABLE:
                self.crash_restarts += 1
            why = (f"hang on rank(s) {res.hung_ranks}" if res.hung_ranks
                   else "gang preemption flush"
                   if res.outcome == PREEMPTED
                   else f"rank crash (codes {res.codes})")
            delay = 0.0
            if res.outcome == RETRYABLE:
                delay = min(self.backoff_max_s,
                            self.backoff_s
                            * (2.0 ** max(0, no_progress - 1)))
            budget = (f" (crash {self.crash_restarts}/{self.max_restarts})"
                      if res.outcome == RETRYABLE else "")
            self._log(f"attempt {attempt} ended ({why}); coordinated gang "
                      f"restart #{self.restarts} with resume{budget}"
                      + (f" after {delay:.1f}s backoff" if delay else ""))
            if delay:
                deadline = time.monotonic() + delay
                while time.monotonic() < deadline and not self._shutdown:
                    time.sleep(min(0.2, delay))
                if self._shutdown:
                    return self._give_up(
                        "shutdown requested during backoff", EXIT_PREEMPTED)
            attempt += 1
