"""``python -m tpuic_torch.supervise`` — run a child under the supervisor
(``tpuic/supervise.py``).

Everything after ``--`` is the child command, launched as-is with the
heartbeat, stack-dump and flight-dump environment injected
(``runtime/supervisor.py`` has the protocol)::

    python -m tpuic_torch.supervise --watchdog-s 30 --startup-grace-s 300 \\
        -- python -m tpuic_torch.serve --ckpt-dir dtmodel/cp \\
        --listen 127.0.0.1:8500 --ready-file ready.json --prom-port 9100

    python -m tpuic_torch.supervise -- python -m tpuic_torch.train \\
        --datadir /data/imagefolder --model resnet50 --ckpt-dir cp

A supervised server beats from its accept loop and its batcher, a trainer
from its step events.  The child is restarted on retryable failures
(crash, hang) under an exponential-backoff restart budget (a trainer
resumes from its latest checkpoint); it is not restarted on clean
completion, on a non-retryable poison exit (code 44), or when the
supervisor itself receives SIGTERM (the signal is forwarded and the
supervisor exits with the child's code).  A hang (no heartbeat change for
``--watchdog-s``; ``--startup-grace-s`` before the first beat) is
escalated SIGQUIT (stack dump and flight dump) -> SIGTERM -> SIGKILL.

``--chaos`` assigns a per-attempt ``TPUIC_FAULTS`` spec, ';'-separated:
attempt 0 gets the first spec, attempt 1 the second, ...; attempts past
the list run fault-free.

A child that exits 43 (a trainer's preemption flush) is restarted at
once with resume; SIGTERM to the supervisor reaches the child, which
flushes, and the supervisor exits 43 with it.

``--gang N`` supervises N ranks as one unit (``runtime/gang.py``):
per-rank watchdogs, a coordinated teardown (every survivor gets the
SIGTERM flush window) and restart of all ranks on any rank's failure,
poison from any rank stopping the gang, and with ``--gang-ckpt`` a
fleet-agreed resume step passed down as ``TPUIC_RESUME_STEP``.  The
port's trainer writes its checkpoints from process 0 into one directory,
so ``--gang-ckpt`` without ``{rank}`` names that shared model directory;
``{rank}`` in it, and in the child command, is substituted per rank.
``--coordinator HOST:PORT`` gives each rank the process-group trio::

    python -m tpuic_torch.supervise --gang 2 --coordinator localhost:29500 \
        --gang-ckpt cp/resnet50 -- python -m tpuic_torch.train \
        --datadir /data/imagefolder --model resnet50 --ckpt-dir cp

Elastic membership (``--elastic``, ``--min-ranks``, ``--max-respawns``)
is parsed and refused by name: it is ROADMAP §1 item 13.
"""

from __future__ import annotations

import argparse
import sys

from tpuic_torch.runtime.supervisor import Supervisor

_PROG = "python -m tpuic_torch.supervise"

#: ``tpuic``'s elastic-gang flags: (flag, argparse kwargs).  Not ported.
_ELASTIC = (
    ("--elastic", dict(action="store_true")),
    ("--min-ranks", dict(type=int, default=1, metavar="M")),
    ("--max-respawns", dict(type=int, default=None, metavar="N")),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=_PROG, description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--state-dir", default="tpuic-supervise",
                   help="heartbeat file, progress ledger (ledger.jsonl), "
                        "and per-attempt stack and flight dumps land here")
    p.add_argument("--watchdog-s", type=float, default=300.0,
                   help="no heartbeat change for this long after the first "
                        "beat => the child is hung (SIGQUIT stack dump, "
                        "SIGTERM grace, SIGKILL)")
    p.add_argument("--startup-grace-s", type=float, default=1800.0,
                   help="liveness window before the FIRST heartbeat of an "
                        "attempt (imports, kernel builds, checkpoint "
                        "restore and the engine's warmup are silent)")
    p.add_argument("--quit-wait-s", type=float, default=3.0,
                   help="pause after SIGQUIT for faulthandler and the "
                        "flight recorder to finish writing their dumps")
    p.add_argument("--grace-s", type=float, default=30.0,
                   help="SIGTERM -> SIGKILL grace (the preemption-flush "
                        "window)")
    p.add_argument("--poll-s", type=float, default=0.5,
                   help="heartbeat/child poll interval")
    p.add_argument("--max-restarts", type=int, default=16,
                   help="retryable-failure restart budget for one "
                        "supervised run (clean preemption flushes restart "
                        "free)")
    p.add_argument("--backoff-s", type=float, default=1.0,
                   help="initial restart backoff (doubles per consecutive "
                        "no-progress failure, capped at --backoff-max-s)")
    p.add_argument("--backoff-max-s", type=float, default=300.0)
    p.add_argument("--crash-loop-k", type=int, default=3,
                   help="consecutive restarts with no step progress before "
                        "declaring a crash loop and giving up (exit 45)")
    p.add_argument("--heartbeat-interval-s", type=float, default=1.0,
                   help="child-side heartbeat write throttle")
    p.add_argument("--chaos", default="",
                   help="per-attempt TPUIC_FAULTS specs, ';'-separated")
    p.add_argument("--gang", type=int, default=0, metavar="N",
                   help="supervise N ranks as one unit (runtime/gang.py): "
                        "coordinated teardown and restart on a partial "
                        "failure, per-rank watchdogs, fleet-agreed resume; "
                        "'{rank}' in the child command is substituted")
    p.add_argument("--gang-ckpt", default="", metavar="DIR",
                   help="the checkpoint model dir holding the "
                        "*.manifest.json sidecars (one shared dir, or a "
                        "'{rank}' template of per-rank dirs): a restart "
                        "passes the newest step every rank committed as "
                        "TPUIC_RESUME_STEP")
    p.add_argument("--coordinator", default="", metavar="HOST:PORT",
                   help="TPUIC_COORDINATOR_ADDRESS for the ranks (with "
                        "TPUIC_NUM_PROCESSES and TPUIC_PROCESS_ID: the "
                        "process group's rendezvous); omit for ranks "
                        "without collectives")
    for flag, kw in _ELASTIC:
        p.add_argument(flag, help="not yet ported to tpuic_torch (elastic "
                                  "membership, ROADMAP §1 item 13)", **kw)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the child command")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, _ in _ELASTIC:
        dest = flag.lstrip("-").replace("-", "_")
        if getattr(args, dest) != parser.get_default(dest):
            raise SystemExit(f"{_PROG}: error: {flag}: elastic membership "
                             "is not yet ported to tpuic_torch (ROADMAP §1 "
                             "item 13)")
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.print_usage(sys.stderr)
        print("supervise: no child command (everything after '--' is the "
              "command to supervise)", file=sys.stderr)
        return 2
    chaos = ([s.strip() for s in args.chaos.split(";")] if args.chaos
             else None)
    common = dict(
        watchdog_s=args.watchdog_s, startup_grace_s=args.startup_grace_s,
        quit_wait_s=args.quit_wait_s, grace_s=args.grace_s,
        poll_s=args.poll_s, max_restarts=args.max_restarts,
        backoff_s=args.backoff_s, backoff_max_s=args.backoff_max_s,
        crash_loop_k=args.crash_loop_k,
        heartbeat_interval_s=args.heartbeat_interval_s, chaos=chaos)
    if args.gang:
        from tpuic_torch.runtime.gang import GangSupervisor
        return GangSupervisor(
            cmd, args.state_dir, ranks=args.gang,
            ckpt_dirs=args.gang_ckpt or None,
            coordinator=args.coordinator, **common).run()
    return Supervisor(cmd, args.state_dir, **common).run()


if __name__ == "__main__":
    sys.exit(main())
