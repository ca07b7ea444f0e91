"""Supervisor: heartbeat watchdog, hang detection, auto-restart (a copy
of ``tpuic/runtime/supervisor.py``).

The out-of-process half of fault tolerance (``python -m
tpuic_torch.supervise``): a hard crash, a wedged device call or a
deadlocked loop kills the process, and the supervisor restarts it.

- **Heartbeat protocol.** The train loop and the serving engine publish
  events on the telemetry bus anyway; when ``TPUIC_HEARTBEAT_FILE`` is set
  (the supervisor sets it for its child), a :class:`HeartbeatWriter` sink
  rewrites that file atomically (tmp + rename) with the last global step
  and wall time.  Host-side only: no device sync, no capture.
- **Liveness enforcement.** No heartbeat change within ``watchdog_s``
  (``startup_grace_s`` before the first beat: imports, the kernels' first
  builds and the engine's warmup are legitimately silent) and the child
  is declared hung: SIGQUIT first (the child registers a ``faulthandler``
  all-thread stack dump at startup, :func:`install_stack_dump_handler`,
  and the flight recorder's dump chained to it), then SIGTERM for the
  preemption flush, then SIGKILL after ``grace_s``.
- **Exit-code contract** (the branch table on child death):

  ====================  =====  ==========================================
  meaning               code   supervisor action
  ====================  =====  ==========================================
  clean completion      0      exit 0
  clean preemption      43     restart with resume (no backoff) — or
  flush                        exit 43 when the supervisor itself was
                               SIGTERMed (the eviction is shared)
  non-retryable poison  44     exit 44 with the child's diagnosis
  anything else         *      retryable crash: restart with resume
  (incl. signal death)         under an exponential-backoff restart
                               budget
  ====================  =====  ==========================================

- **Crash-loop policy.** A cross-restart progress ledger (JSONL): an
  attempt counts as useful only when the child's best global step passed
  the best of all earlier attempts; ``crash_loop_k`` consecutive attempts
  without progress end in exit 45 instead of restarting forever.  The
  ledger also flags a resumed attempt whose first step jumps past the
  previous attempt's last (skipped steps).

File formats and environment names are ``tpuic``'s, so a heartbeat file
or a ledger reads the same in either package.  This module imports only
the stdlib on purpose: the supervisor parent must never initialize CUDA
(its context would hold memory on the card the child needs, and a
supervisor must outlive any device wedge its child hits).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# -- exit-code contract ------------------------------------------------------
# Child codes (the entry points map their outcomes onto these; the supervisor
# branches on them). 43+ to stay clear of shell/python conventions
# (1 generic, 2 usage, 126-165 signal/permission ranges).
EXIT_OK = 0
EXIT_PREEMPTED = 43   # clean preemption flush: state is on disk, resume me
EXIT_POISON = 44      # non-retryable: restarting cannot help
EXIT_CRASH_LOOP = 45  # supervisor verdict: retries exhausted / no progress
EXIT_BELOW_MIN = 46   # elastic gang verdict (tpuic's): below min replicas

# Environment protocol between supervisor and child.
ENV_HEARTBEAT_FILE = "TPUIC_HEARTBEAT_FILE"
ENV_HEARTBEAT_INTERVAL = "TPUIC_HEARTBEAT_INTERVAL_S"
ENV_STACK_DUMP = "TPUIC_STACK_DUMP"
ENV_FLIGHT_DUMP = "TPUIC_FLIGHT_DUMP"  # telemetry/flight.py reads it
ENV_RESTART = "TPUIC_RESTART"
ENV_DOWN_SINCE = "TPUIC_DOWN_SINCE"
# The fleet-consistent resume cap the gang supervisor passes
# (runtime/gang.py); restore_into skips rungs past it.
ENV_RESUME_STEP = "TPUIC_RESUME_STEP"


class NonRetryableError(RuntimeError):
    """A failure restarting cannot fix (rollback budget exhausted, every
    checkpoint rung corrupt, bad config): an entry point maps it to
    ``EXIT_POISON`` so the supervisor reports instead of retrying.
    Subclasses RuntimeError — existing handlers and tests that match the
    message keep working."""


# -- heartbeat protocol ------------------------------------------------------
class HeartbeatWriter:
    """Telemetry-bus sink that mirrors liveness into an atomically
    rewritten file: ``{"step", "t", "pid", "beats"}``.

    Subscribes to every event kind (any bus activity proves the process
    is alive; ``step`` events additionally carry progress), throttled to
    one write per ``min_interval_s`` so millisecond steps don't turn the
    heartbeat into an I/O load. Each actual write publishes a
    ``heartbeat`` event back on the bus (guarded against self-echo), so
    supervised runs record their own beats in ``--metrics-jsonl``.

    Everything here is host-side file I/O on data the caller already
    has: no torch import, no device syncs, no captures.
    """

    def __init__(self, path: str, min_interval_s: float = 1.0,
                 publish: Optional[Callable] = None) -> None:
        self.path = path
        self.min_interval_s = max(0.0, float(min_interval_s))
        self._publish = publish
        self.first_step: Optional[int] = None
        self.last_step: Optional[int] = None
        self.beats = 0
        self._last_write = 0.0
        # Beats arrive from more than one thread (serve's batcher thread
        # publishes serve_batch events while the accept loop ticks
        # manually; data producer threads publish quarantine events):
        # without the lock, two beat() calls share one tmp path and can
        # rename torn JSON into place — which reads as a STALL to the
        # supervisor, the exact false positive a watchdog must not have.
        self._lock = threading.RLock()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    @classmethod
    def from_env(cls, publish: Optional[Callable] = None
                 ) -> Optional["HeartbeatWriter"]:
        """The child half of the supervision env protocol: a writer on
        ``$TPUIC_HEARTBEAT_FILE`` at the supervisor-chosen throttle, or
        None when this process is not supervised."""
        path = os.environ.get(ENV_HEARTBEAT_FILE, "")
        if not path:
            return None
        try:
            interval = float(os.environ.get(ENV_HEARTBEAT_INTERVAL, "1"))
        except ValueError:
            interval = 1.0
        return cls(path, min_interval_s=interval, publish=publish)

    def __call__(self, ev) -> None:
        if ev.kind == "heartbeat":
            return  # our own echo
        step = ev.data.get("step") if ev.kind == "step" else None
        with self._lock:
            if ev.kind == "checkpoint_commit":
                # A commit moves the resume point: the next life may
                # legally start right past the committed step, so the
                # file must never lag behind it (steps faster than the
                # write throttle would otherwise leave the supervisor's
                # best_step stale and flag a spurious accounting
                # violation after resume). Commits are save-period-rare;
                # forcing the write costs nothing.
                self._last_write = 0.0
            self._observe(step)

    def _observe(self, step) -> None:
        if step is not None:
            step = int(step)
            if self.first_step is None:
                # Exact, write-throttle-proof: every step EVENT passes
                # through here even when most of them don't WRITE, so
                # the supervisor's step-accounting check compares the
                # true first step of this life, not the first one a
                # throttled write + poll happened to sample.
                self.first_step = step
            self.last_step = step
        self.beat()

    def beat(self) -> bool:
        """Write the heartbeat file if the throttle allows; returns
        whether a write happened. Also the manual tick for loops with no
        bus traffic (an idle ``tpuic_torch.serve`` poll loop is alive even
        when no requests arrive)."""
        with self._lock:
            # Throttle/age on the monotonic clock: a backward NTP/VM-resume
            # wall-clock step must not suppress writes until the clock
            # re-passes the old timestamp — a stale file reads as a HANG
            # and the watchdog kills a healthy child. Wall time is only
            # ever payload data.
            now = time.monotonic()
            if (self._last_write
                    and now - self._last_write < self.min_interval_s):
                return False
            self.beats += 1
            payload = {"step": self.last_step, "first_step": self.first_step,
                       "t": round(time.time(), 3), "pid": os.getpid(),
                       "beats": self.beats}
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, self.path)
            except OSError:
                # A full/readonly disk must never take down the run the
                # heartbeat exists to protect; the supervisor sees
                # staleness and treats it as a hang, the honest signal.
                return False
            self._last_write = now
            step, beats = self.last_step, self.beats
        if self._publish is not None:
            self._publish("heartbeat", step=step, beats=beats)
        return True

    def age_s(self) -> Optional[float]:
        """Seconds since the last successful write (None before any)."""
        if not self._last_write:
            return None
        return max(0.0, time.monotonic() - self._last_write)


def read_heartbeat(path: str) -> Optional[dict]:
    """Parse a heartbeat file; None when absent or unreadable (the
    atomic rename makes torn reads impossible, but a crashed writer may
    have left nothing)."""
    try:
        with open(path) as f:
            out = json.load(f)
    except (OSError, ValueError):
        return None
    return out if isinstance(out, dict) else None


def restart_info() -> Optional[Tuple[int, float]]:
    """(restart_count, downtime_s) when this process is a supervisor
    restart, else None. ``downtime_s`` is measured from the previous
    child's death (supervisor-stamped env) to *now* — call it where the
    downtime ends (fit() start), so backoff + respawn + re-init + restore
    are all charged to the ``restart`` goodput bucket."""
    try:
        count = int(os.environ.get(ENV_RESTART, "0"))
    except ValueError:
        return None
    if count <= 0:
        return None
    try:
        since = float(os.environ.get(ENV_DOWN_SINCE, ""))
    except ValueError:
        since = time.time()
    return count, max(0.0, time.time() - since)


_DUMP_FILES: List = []  # keep registered faulthandler files alive


def install_stack_dump_handler(chain: bool = False) -> Optional[str]:
    """Register a ``faulthandler`` all-thread stack dump on SIGQUIT.

    The supervisor's hang escalation sends SIGQUIT first precisely so a
    wedged trainer explains *where* it is stuck before being killed.
    Dumps go to ``$TPUIC_STACK_DUMP`` when the supervisor set it (the
    captured artifact the chaos soak asserts on), else stderr. Returns
    the destination, or None when registration is impossible (no
    SIGQUIT on this platform, non-main thread).

    ``chain=True`` additionally invokes whatever Python-level SIGQUIT
    handler was installed *before* this call, after the C-level stack
    dump — how the flight recorder's event-timeline dump
    (telemetry/flight.py) rides the same signal: register the Python
    handler first, then call this with ``chain=True``, and a SIGQUIT
    yields stacks (always, C-level) plus the event history (when the
    main thread still executes bytecode)."""
    if not hasattr(signal, "SIGQUIT"):
        return None
    import faulthandler
    path = os.environ.get(ENV_STACK_DUMP, "")
    target = sys.stderr
    if path:
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            target = open(path, "w")
        except OSError:
            path, target = "", sys.stderr
    try:
        faulthandler.register(signal.SIGQUIT, file=target, all_threads=True,
                              chain=chain)
    except (ValueError, OSError, RuntimeError):
        return None
    if target is not sys.stderr:
        _DUMP_FILES.append(target)  # GC would close the fd under faulthandler
    return path or "<stderr>"


# -- exit classification -----------------------------------------------------
RETRYABLE = "retryable"
PREEMPTED = "preempted"
POISON = "poison"
DONE = "done"


def classify_exit(returncode: int, shutting_down: bool = False) -> str:
    """Map a child's exit code onto the contract table (module
    docstring). ``shutting_down``: the supervisor itself received
    SIGTERM/SIGINT — nothing restarts, a clean flush (or completion)
    propagates and anything else is reported as-is."""
    if returncode == EXIT_OK:
        return DONE
    if returncode == EXIT_POISON:
        return POISON
    if returncode == EXIT_PREEMPTED:
        return PREEMPTED if not shutting_down else DONE
    return POISON if shutting_down else RETRYABLE


@dataclasses.dataclass
class AttemptResult:
    """One child run, as the supervisor observed it."""
    attempt: int
    returncode: int
    hung: bool
    first_step: Optional[int]
    last_step: Optional[int]
    duration_s: float


class _Child:
    """One supervised OS process: the spawn-time artifact environment
    (heartbeat file, per-attempt stack/flight dump paths), heartbeat
    observation, and the escalation ladder (SIGQUIT stack+flight dump →
    SIGTERM flush window → SIGKILL).

    The escalation keeps *one SIGTERM per pid*: a second TERM can land
    inside the child's flush ``sys.exit(43)`` after interpreter
    finalization restored the default handler and kill it -15
    mid-exit."""

    def __init__(self, cmd: Sequence[str], *, heartbeat_file: str,
                 stack_dump: str, flight_dump: str, label: str = "") -> None:
        self.cmd = list(cmd)
        self.heartbeat_file = heartbeat_file
        self.stack_dump = stack_dump
        self.flight_dump = flight_dump
        self.label = label  # "" for the single child
        self.proc: Optional[subprocess.Popen] = None
        self._term_pid: Optional[int] = None  # pid already SIGTERMed
        self.hung = False
        self.first_step: Optional[int] = None
        self.last_step: Optional[int] = None
        self.last_beats = -1
        self.spawned_at = 0.0
        self.last_change = 0.0

    def spawn(self, env: Dict[str, str], stdout=None,
              stderr=None) -> subprocess.Popen:
        """Start the process with the artifact env injected. Heartbeat
        freshness is per-attempt: any stale file is removed first.
        ``stdout``/``stderr`` pass through to Popen (a caller may
        redirect a child's streams to log files); None inherits."""
        try:
            os.remove(self.heartbeat_file)
        except OSError:
            pass
        env = dict(env)
        env[ENV_HEARTBEAT_FILE] = self.heartbeat_file
        env[ENV_STACK_DUMP] = self.stack_dump
        env[ENV_FLIGHT_DUMP] = self.flight_dump
        self.hung = False
        self.first_step = self.last_step = None
        self.last_beats = -1
        self._term_pid = None
        self.spawned_at = self.last_change = time.monotonic()
        self.proc = subprocess.Popen(self.cmd, env=env, stdout=stdout,
                                     stderr=stderr)
        return self.proc

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def poll(self) -> Optional[int]:
        return self.proc.poll() if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def signal(self, sig: int) -> None:
        if self.alive():
            try:
                self.proc.send_signal(sig)
            except OSError:
                pass

    def term(self) -> bool:
        """SIGTERM (the preemption flush path), at most once per pid — callable
        from both the supervisor's signal handler and its poll loop
        without risking the double-TERM flake documented above. Returns
        whether a TERM was actually sent."""
        if self.proc is None or self._term_pid == self.proc.pid:
            return False
        self.signal(signal.SIGTERM)
        self._term_pid = self.proc.pid
        return True

    def observe(self, now: Optional[float] = None) -> None:
        """Fold the heartbeat file into the liveness view: beat-count
        changes move ``last_change``; the payload's exact ``first_step``
        wins over whichever step a throttled write + poll happened to
        sample first (the accounting check compares true first steps)."""
        now = time.monotonic() if now is None else now
        hb = read_heartbeat(self.heartbeat_file)
        if hb is None:
            return
        beats = int(hb.get("beats", 0))
        if beats != self.last_beats:
            self.last_beats = beats
            self.last_change = now
        fs = hb.get("first_step")
        if fs is not None:
            self.first_step = int(fs)
        step = hb.get("step")
        if step is not None:
            step = int(step)
            if self.first_step is None:
                self.first_step = step
            self.last_step = step

    def stale_s(self, now: Optional[float] = None) -> float:
        return (time.monotonic() if now is None else now) - self.last_change

    def window_s(self, watchdog_s: float, startup_grace_s: float) -> float:
        """The liveness window currently in force: startup grace before
        the first observed beat, the watchdog after."""
        return watchdog_s if self.last_beats >= 0 else startup_grace_s

    def escalate(self, quit_wait_s: float, grace_s: float) -> None:
        """The hang ladder: SIGQUIT (faulthandler stacks + flight-recorder
        timeline land in the per-attempt artifacts), a pause for the
        dumps, then SIGTERM with the flush grace window, then SIGKILL."""
        self.hung = True
        if hasattr(signal, "SIGQUIT"):
            self.signal(signal.SIGQUIT)
            try:  # let faulthandler finish writing the dump
                self.proc.wait(timeout=quit_wait_s)
            except subprocess.TimeoutExpired:
                pass
        self.term()
        self.wait_or_kill(grace_s)

    def wait_or_kill(self, grace_s: float) -> bool:
        """Wait up to ``grace_s`` for exit; SIGKILL on timeout. Returns
        whether the kill was needed."""
        try:
            self.proc.wait(timeout=grace_s)
            return False
        except subprocess.TimeoutExpired:
            self.signal(signal.SIGKILL)
            self.proc.wait()
            return True

    def finalize(self) -> int:
        """Reap the process and fold the FINAL heartbeat state (the last
        write may have landed after the last poll). Returns the exit
        code."""
        rc = self.proc.wait()
        hb = read_heartbeat(self.heartbeat_file)
        if hb is not None and hb.get("step") is not None:
            self.last_step = int(hb["step"])
            if hb.get("first_step") is not None:
                self.first_step = int(hb["first_step"])
            if self.first_step is None:
                self.first_step = self.last_step
        return rc


class Supervisor:
    """Run ``cmd`` as a supervised child; see the module docstring for
    the protocol. ``state_dir`` holds the heartbeat file, the progress
    ledger (``ledger.jsonl``), and per-attempt stack dumps.

    ``chaos``: optional per-attempt ``TPUIC_FAULTS`` specs (attempt i
    gets ``chaos[i]``; attempts past the end run fault-free): one
    deterministic fault per life of the child — a plain env spec would
    re-fire at the same step after every resume and crash-loop the run it
    is supposed to test.
    """

    def __init__(self, cmd: Sequence[str], state_dir: str, *,
                 watchdog_s: float = 300.0, startup_grace_s: float = 1800.0,
                 quit_wait_s: float = 3.0, grace_s: float = 30.0,
                 poll_s: float = 0.5, max_restarts: int = 16,
                 backoff_s: float = 1.0, backoff_max_s: float = 300.0,
                 crash_loop_k: int = 3, heartbeat_interval_s: float = 1.0,
                 chaos: Optional[Sequence[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 log: Optional[Callable[[str], None]] = None) -> None:
        self.cmd = list(cmd)
        self.state_dir = os.path.abspath(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.heartbeat_file = os.path.join(self.state_dir, "heartbeat.json")
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
        self.extra_env = dict(env or {})
        self._log = log or (lambda msg: print(f"[supervise] {msg}",
                                              file=sys.stderr, flush=True))
        self._child: Optional[_Child] = None
        self._shutdown = False
        self.restarts = 0        # total (incl. clean preemption flushes)
        self.crash_restarts = 0  # retryable failures only — the budget
        self.attempts: List[AttemptResult] = []
        self.best_step: Optional[int] = None
        self.violations = 0
        if "--no-resume" in self.cmd:
            # Restart-with-resume is the whole point; a child that starts
            # from scratch every life turns the restart budget into a
            # training-from-zero loop.
            self._log("WARNING: child command has --no-resume; restarts "
                      "will replay from scratch instead of resuming")

    # -- ledger ---------------------------------------------------------
    def _ledger(self, event: str, **data) -> None:
        rec = {"event": event, "t": round(time.time(), 3), **data}
        with open(self.ledger_file, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -- signals --------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        self._shutdown = True
        child = self._child
        # One SIGTERM per child, here too (the _Child.term() guard): a
        # repeated external SIGTERM (impatient orchestrator) must not
        # deliver a second TERM that can land inside the child's flush
        # sys.exit(43) after finalization restored the default handler
        # (see the shutdown branch in _run_attempt).
        if child is not None:
            child.term()  # the preemption flush path

    # -- one attempt ----------------------------------------------------
    def _spawn_env(self, attempt: int, down_since: float) -> Dict[str, str]:
        # Artifact paths (heartbeat file, per-attempt stack/flight dump)
        # are injected by _Child.spawn; this builds everything else.
        env = dict(os.environ)
        env.update(self.extra_env)
        env[ENV_HEARTBEAT_INTERVAL] = repr(self.heartbeat_interval_s)
        env[ENV_RESTART] = str(attempt)
        env[ENV_DOWN_SINCE] = repr(down_since)
        if self.chaos:
            spec = self.chaos[attempt] if attempt < len(self.chaos) else ""
            env["TPUIC_FAULTS"] = spec
        return env

    def _run_attempt(self, attempt: int, down_since: float) -> AttemptResult:
        env = self._spawn_env(attempt, down_since)
        child = _Child(
            self.cmd, heartbeat_file=self.heartbeat_file,
            stack_dump=os.path.join(self.state_dir,
                                    f"stackdump-{attempt}.txt"),
            # Flight recorder (telemetry/flight.py): the child dumps its
            # last-N-events ring here on SIGQUIT — the hang escalation
            # yields stacks AND the event timeline leading into the wedge.
            flight_dump=os.path.join(self.state_dir,
                                     f"flightdump-{attempt}.jsonl"))
        self._child = child
        t0 = time.monotonic()
        child.spawn(env)
        self._ledger("spawn", attempt=attempt, pid=child.pid,
                     restart=attempt > 0,
                     faults=env.get("TPUIC_FAULTS", "") if self.chaos else "")
        while child.poll() is None:
            time.sleep(self.poll_s)
            now = time.monotonic()
            child.observe(now)
            if self._shutdown:
                # Usually the handler already forwarded SIGTERM — but a
                # child spawned AFTER the flag was set (signal landed
                # between attempts, when _child was None) never got it;
                # term() here is a no-op in the forwarded case (one TERM
                # per pid — a SECOND SIGTERM can land inside the child's
                # flush sys.exit(43) after interpreter finalization
                # restored the default handler and kill it -15 mid-exit,
                # a ~1-in-12 flake). Then the full
                # grace window to flush, then make sure it dies.
                child.term()
                if child.wait_or_kill(self.grace_s):
                    self._log(f"attempt {attempt}: no exit "
                              f"{self.grace_s:.0f}s after forwarded "
                              "SIGTERM; killing")
                break
            window = child.window_s(self.watchdog_s, self.startup_grace_s)
            if child.stale_s(now) > window:
                stale = child.stale_s(now)
                self._log(f"attempt {attempt}: HANG — no heartbeat for "
                          f"{stale:.1f}s (window {window:.0f}s, last step "
                          f"{child.last_step}); SIGQUIT for a stack dump, "
                          f"then SIGTERM, then SIGKILL")
                self._ledger("hang", attempt=attempt, stale_s=round(stale, 1),
                             last_step=child.last_step,
                             stack_dump=child.stack_dump,
                             flight_dump=child.flight_dump)
                child.escalate(self.quit_wait_s, self.grace_s)
                break
        rc = child.finalize()
        res = AttemptResult(attempt=attempt, returncode=rc, hung=child.hung,
                            first_step=child.first_step,
                            last_step=child.last_step,
                            duration_s=round(time.monotonic() - t0, 3))
        self._child = None
        self._ledger("exit", attempt=attempt, returncode=rc, hung=child.hung,
                     first_step=child.first_step, last_step=child.last_step,
                     duration_s=res.duration_s,
                     outcome=classify_exit(rc, self._shutdown))
        return res

    # -- the supervision loop -------------------------------------------
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
                     best_step=self.best_step, returncode=code)
        return code

    def _run(self) -> int:
        attempt = 0
        no_progress = 0
        down_since = time.time()
        while True:
            res = self._run_attempt(attempt, down_since)
            self.attempts.append(res)
            down_since = time.time()
            # Step-accounting check: a resumed attempt may REPLAY steps
            # (resume from an older checkpoint) but must never START
            # past the best observed step + 1 — that would mean the
            # resume silently skipped training steps.
            if (res.first_step is not None and self.best_step is not None
                    and res.first_step > self.best_step + 1):
                self.violations += 1
                self._log(f"LEDGER VIOLATION: attempt {attempt} first step "
                          f"{res.first_step} skips past best previous step "
                          f"{self.best_step}")
                self._ledger("violation", attempt=attempt,
                             first_step=res.first_step,
                             best_step=self.best_step)
            progressed = (res.last_step is not None
                          and (self.best_step is None
                               or res.last_step > self.best_step))
            if progressed:
                self.best_step = res.last_step
            outcome = classify_exit(res.returncode, self._shutdown)
            if outcome == DONE:
                self._log(f"child exited cleanly (code {res.returncode}) "
                          f"after {attempt + 1} attempt(s), best step "
                          f"{self.best_step}")
                self._ledger("done", attempts=attempt + 1,
                             restarts=self.restarts, best_step=self.best_step,
                             returncode=res.returncode)
                return res.returncode
            if outcome == POISON:
                code = res.returncode
                if code < 0:
                    # Signal death surfaced while shutting down: report
                    # the shell convention (128+N) — sys.exit(-9) would
                    # become OS status 247, outside any contract.
                    code = 128 - code
                return self._give_up(
                    f"child exit code {res.returncode} "
                    f"({'supervisor shutdown' if self._shutdown else 'poison: restarting cannot help'})",
                    code)
            # Retryable (crash / hang) or a clean preemption flush to be
            # resumed. Only real failures consume the restart budget — a
            # flush is the preemptible fleet working as designed, and a
            # multi-day run may absorb hundreds of them — but the
            # no-progress streak counts EVERY outcome: a preemption that
            # deterministically re-fires before any step lands (a stale
            # TPUIC_FAULTS env spec, an instantly-evicting scheduler)
            # must trip the crash-loop verdict, not respawn forever at
            # full speed with no bound at all. Counters increment only
            # when a restart actually happens, so giveup records report
            # restarts that occurred, not one that never did.
            if progressed:
                no_progress = 0
            elif (res.last_step is None and not res.hung
                  and res.duration_s >= self.startup_grace_s + self.watchdog_s):
                # A step-less child (a supervised tpuic_torch.serve emits
                # beats, never steps) can't show step progress — but a
                # life that outlived startup grace plus a full watchdog
                # window without being hang-killed was demonstrably
                # alive and beating. Healthy crashes days apart must not
                # accumulate into a "deterministic failure" verdict.
                no_progress = 0
            else:
                no_progress += 1
            if (outcome == RETRYABLE
                    and self.crash_restarts >= self.max_restarts):
                return self._give_up(
                    f"restart budget exhausted ({self.max_restarts} "
                    "retryable failures)", EXIT_CRASH_LOOP)
            if no_progress >= self.crash_loop_k:
                return self._give_up(
                    f"crash loop: {no_progress} consecutive attempts "
                    f"with no step progress (stuck at step "
                    f"{self.best_step}) — the failure is deterministic, "
                    "restarting cannot help", EXIT_CRASH_LOOP)
            self.restarts += 1
            if outcome == RETRYABLE:
                self.crash_restarts += 1
            why = ("hang" if res.hung else
                   "preemption flush" if outcome == PREEMPTED else
                   f"crash (code {res.returncode})")
            delay = 0.0
            if outcome == RETRYABLE:
                # Exponential backoff on real failures — backoff_s for
                # the first no-progress retry, doubling per consecutive
                # one. A clean preemption flush resumes immediately; its
                # state is committed and waiting.
                delay = min(self.backoff_max_s,
                            self.backoff_s * (2.0 ** max(0, no_progress - 1)))
            budget = (f" (crash {self.crash_restarts}/{self.max_restarts})"
                      if outcome == RETRYABLE else "")
            self._log(f"attempt {attempt} ended ({why}); restart "
                      f"#{self.restarts} with resume{budget}"
                      + (f" after {delay:.1f}s backoff" if delay else ""))
            if delay:
                deadline = time.monotonic() + delay
                while time.monotonic() < deadline and not self._shutdown:
                    time.sleep(min(0.2, delay))
                if self._shutdown:
                    return self._give_up("shutdown requested during backoff",
                                         EXIT_PREEMPTED)
            attempt += 1
