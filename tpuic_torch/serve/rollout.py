"""Canary rollout controller: staged traffic shift, SLO-burn auto-rollback
(a copy of ``tpuic/serve/rollout.py`` over the port's router).

Weights change **under load** without dropping a request.  This module
drives the replica router (``tpuic_torch/serve/router.py``) through a
complete model lifecycle (docs/serving.md, "Model lifecycle: hot-swap, canary,
rollback"):

1. **Gate** — the CANDIDATE is hot-swapped onto one canary replica via
   the router's control channel (``{"op": "swap", ...}`` —
   serve/__main__.py).  The replica's swap-time admission gates run
   *there*, pre-flip: the checkpoint CRC/manifest integrity ladder and
   the pinned-eval accuracy gate.  A typed refusal
   (:class:`~tpuic_torch.serve.admission.SwapRejected`, cause
   ``swap_corrupt``/``swap_accuracy``) ends the rollout before ONE
   request ever saw the candidate.
2. **Canary** — the router's traffic split shifts a staged fraction
   (e.g. 5% → 50% → 100%) onto the canary while the controller watches two
   signals: a named SLO objective's **error-budget burn rate** over the
   canary's resolved latencies (``telemetry/slo.py``, reused verbatim —
   the same attainment/burn arithmetic the serve tier reports), and the
   canary's **typed-error ledger** (untyped errors on the canary are an
   immediate rollback; typed sheds are normal overload behavior).
3. **Promote** — every stage held healthy: the remaining replicas swap
   to the candidate (traffic is 100% on the canary while they flip, so
   promotion is also zero-drain), the candidate digest becomes THE
   fleet digest, and the split clears.
4. **Auto-rollback on burn** — sustained burn at/over the threshold
   (``rollback_after`` consecutive polls — hysteresis, one bad sample
   must not flap a rollout), a canary error, or a stage that times out
   without evidence: the candidate digest is **disallowed first** (the
   router's identity gate refuses the canary even if the swap-back
   fails), the split clears, and the canary hot-swaps BACK to the
   incumbent — rollback is itself a zero-drain swap.

Like the router it drives, this module is **stdlib-only** (the
supervisor-parent rule): ``telemetry/slo.py`` and the pinned quantile
helper import neither torch nor numpy, so the controller can outlive any
CUDA wedge its replicas hit.  Verdicts, stages, and rollbacks land as
``rollout`` events in the router ledger JSONL and as ``tpuic_rollout_*``
rows in the prom exposition (telemetry/prom.py).

CLI::

    python -m tpuic_torch.serve.rollout \\
        --replica-cmd '...python -m tpuic_torch.serve --synthetic-init ...' \\
        --replicas 2 --candidate '{"ckpt_dir": "cp2", "track": "best"}' \\
        --incumbent '{"ckpt_dir": "cp", "track": "best"}' \\
        --slo 'serve_latency:p99<=250ms' --stages 0.05,0.5,1.0

Client traffic rides stdin exactly like ``python -m tpuic_torch.serve.router``
(the rollout needs live traffic: a stage without samples never
promotes — no evidence, no flip).  Exit code 0 = promoted; 2 = refused
/ rolled back / aborted (the verdict JSON lands on stdout either way).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Dict, List, Optional

from tpuic_torch.serve.admission import AdmissionError
from tpuic_torch.serve.router import UP, Router
from tpuic_torch.telemetry.events import Event
from tpuic_torch.telemetry.slo import SLOTracker, parse_objective

VERDICTS = ("promoted", "rolled_back", "refused", "aborted")


class CanaryRollout:
    """One staged rollout of ``candidate`` across ``router``'s fleet.

    ``candidate`` / ``incumbent`` are swap-line payloads (everything but
    ``op``/``id`` of a ``{"op": "swap"}`` control line — e.g.
    ``{"ckpt_dir": ..., "track": ...}`` or ``{"synthetic_seed": N}``);
    the incumbent payload is what a rollback swaps BACK to, so it must
    describe the weights the fleet is serving now.

    ``objective`` is a ``telemetry/slo.py`` spec over ``serve_latency``
    (e.g. ``serve_latency:p99<=250ms``) scored on the CANARY's resolved
    latencies only — a 5% canary serving garbage moves fleet-wide p99
    by epsilon, and canary-scoped burn is the signal operators canary
    for.  Rollback triggers on ``rollback_after`` consecutive polls at
    burn >= ``burn_rollback``.

    A stage advances once it has been held ``hold_s`` seconds with at
    least ``min_samples`` canary samples in the window and burn below
    the rollback threshold; a stage exceeding ``stage_timeout_s``
    without advancing rolls back (**no evidence, no promote** — an idle
    fleet must not wave a candidate through).
    """

    def __init__(self, router: Router, candidate: Dict,
                 incumbent: Dict, *,
                 objective: str = "serve_latency:p99<=250ms",
                 stages=(0.05, 0.5, 1.0), hold_s: float = 5.0,
                 min_samples: int = 40, burn_rollback: float = 2.0,
                 rollback_after: int = 2, poll_s: float = 0.25,
                 stage_timeout_s: float = 120.0,
                 swap_timeout_s: float = 300.0,
                 canary: Optional[str] = None,
                 log=None) -> None:
        self.router = router
        self.candidate = {k: v for k, v in dict(candidate).items()
                          if k not in ("op", "id")}
        self.incumbent = {k: v for k, v in dict(incumbent).items()
                         if k not in ("op", "id")}
        self.objective = parse_objective(objective,
                                         allowed=("serve_latency",))
        self.stages = tuple(float(s) for s in stages)
        if not self.stages or any(not 0.0 < s <= 1.0
                                  for s in self.stages):
            raise ValueError(f"stages must be fractions in (0, 1], got "
                             f"{self.stages}")
        self.hold_s = float(hold_s)
        self.min_samples = max(1, int(min_samples))
        self.burn_rollback = float(burn_rollback)
        self.rollback_after = max(1, int(rollback_after))
        self.poll_s = max(0.02, float(poll_s))
        self.stage_timeout_s = float(stage_timeout_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.canary_name = canary
        self._log = log or (lambda m: print(f"[rollout] {m}",
                                            file=sys.stderr, flush=True))
        self._lock = threading.Lock()
        self._watching = False
        self._canary: Optional[str] = None
        self._canary_errors = 0
        self._last_burn: Optional[float] = None
        self._phase = "idle"
        self._stage_idx = -1
        self._stage_frac = 0.0
        self._verdict: Optional[dict] = None
        # slo.py reused verbatim: the same SLOTracker the serve tier
        # runs, fed canary-scoped serve_span events from the router's
        # outcome hook.  publish=no-op — reports land in OUR ledger.
        self._tracker = SLOTracker([self.objective],
                                   publish=lambda *a, **k: None)
        self._prev_hook = None

    # -- telemetry -----------------------------------------------------
    def _publish(self, action: str, **data) -> None:
        self.router._publish("rollout", action=action, **data)

    def state(self) -> dict:
        """JSON-able live state — the ``tpuic_rollout_*`` prom rows."""
        with self._lock:
            rep = self._tracker.report()["objectives"][0]
            return {
                "phase": self._phase,
                "stage_index": self._stage_idx,
                "stage_fraction": self._stage_frac,
                "canary": self._canary,
                "objective": self.objective.name,
                "burn_rate": rep["burn_rate"],
                "canary_window_samples": rep["window_samples"],
                "canary_errors": self._canary_errors,
                "verdict": (self._verdict or {}).get("verdict"),
            }

    # -- canary-scoped SLO feed ----------------------------------------
    def _hook(self, replica: str, kind: str,
              latency_s: Optional[float]) -> None:
        with self._lock:
            watching = self._watching and replica == self._canary
        if not watching:
            pass
        elif kind == "resolved" and latency_s is not None:
            self._tracker.on_event(Event(
                kind="serve_span", time=time.time(),
                data={"total_ms": 1000.0 * latency_s}))
        elif kind == "error":
            with self._lock:
                self._canary_errors += 1
        if self._prev_hook is not None:
            self._prev_hook(replica, kind, latency_s)

    # -- the rollout ----------------------------------------------------
    def run(self) -> dict:
        """Drive the full lifecycle; returns the verdict dict
        (``verdict`` in :data:`VERDICTS` plus attribution fields)."""
        self._prev_hook = self.router.outcome_hook
        self.router.outcome_hook = self._hook
        try:
            return self._run()
        finally:
            self.router.outcome_hook = self._prev_hook

    def _finish(self, verdict: dict) -> dict:
        with self._lock:
            self._phase = verdict["verdict"]
            self._verdict = verdict
        self._publish("done", **{k: v for k, v in verdict.items()
                                 if isinstance(v, (str, int, float,
                                                   bool, type(None)))})
        self._log(f"verdict: {json.dumps(verdict)}")
        return verdict

    def _pick_canary(self) -> Optional[str]:
        if self.canary_name:
            return self.canary_name
        for rep in self.router.replicas:
            if rep.state == UP:
                return rep.name
        return None

    def _swap(self, replica: str, payload: Dict) -> dict:
        return self.router.control_request(
            replica, {"op": "swap", **payload},
            timeout_s=self.swap_timeout_s)

    def _run(self) -> dict:
        canary = self._pick_canary()
        if canary is None:
            return self._finish({"verdict": "aborted",
                                 "reason": "no_up_replica"})
        with self._lock:
            self._canary = canary
            self._phase = "gating"
        # The identity gate MUST know the incumbent digest before the
        # canary flips: adopt-first-seen would otherwise crown the
        # CANDIDATE as the fleet digest (flagging every incumbent), and
        # a later rollback's disallow would empty the allowed set —
        # total outage.  Pongs carry it within one ping interval; no
        # digest after the grace window = no rollout (abort is
        # zero-impact: nothing was swapped, nothing was shifted).
        deadline = time.monotonic() + 10.0
        while (self.router.fleet_digest is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        incumbent_digest = self.router.fleet_digest
        if incumbent_digest is None:
            self._publish("refused", canary=canary, cause=None,
                          error="fleet digest unknown")
            return self._finish({
                "verdict": "aborted", "canary": canary,
                "reason": "no_fleet_digest"})
        self._publish("start", canary=canary,
                      objective=self.objective.name,
                      stages=list(self.stages),
                      incumbent_digest=incumbent_digest)
        self._log(f"canary {canary}: gating candidate "
                  f"{json.dumps(self.candidate)}")
        try:
            resp = self._swap(canary, self.candidate)
        except AdmissionError as e:
            # Typed refusal (swap_corrupt / swap_accuracy / a dying
            # canary): the candidate never reached traffic.
            self._publish("refused", canary=canary,
                          cause=getattr(e, "cause", None), error=str(e))
            return self._finish({
                "verdict": "refused", "canary": canary,
                "cause": getattr(e, "cause", None), "error": str(e)})
        except Exception as e:  # noqa: BLE001 — transport/timeout
            self._publish("refused", canary=canary, cause=None,
                          error=str(e))
            return self._finish({
                "verdict": "aborted", "canary": canary,
                "reason": "swap_failed", "error": str(e)})
        new_digest = str(resp.get("digest", ""))
        self.router.allow_digest(new_digest)
        with self._lock:
            self._watching = True
            self._phase = "canary"
        self._log(f"canary {canary}: candidate live (generation "
                  f"{resp.get('generation')}, digest {new_digest}, "
                  f"reused_executables={resp.get('reused_executables')})")

        promoted: List[str] = []
        for i, frac in enumerate(self.stages):
            with self._lock:
                self._stage_idx, self._stage_frac = i, frac
            self.router.set_traffic_split({canary}, frac)
            self._publish("stage", index=i, fraction=frac,
                          canary=canary)
            self._log(f"stage {i}: {100 * frac:g}% of traffic -> "
                      f"{canary}")
            t_stage = time.monotonic()
            streak = 0
            while True:
                time.sleep(self.poll_s)
                rep = self._tracker.report()["objectives"][0]
                burn = rep["burn_rate"]
                samples = rep["window_samples"]
                with self._lock:
                    errors = self._canary_errors
                    self._last_burn = burn
                if errors:
                    return self._rollback(
                        canary, new_digest, incumbent_digest, promoted,
                        reason="canary_errors", burn=burn,
                        errors=errors)
                if burn is not None and burn >= self.burn_rollback:
                    streak += 1
                    if streak >= self.rollback_after:
                        return self._rollback(
                            canary, new_digest, incumbent_digest,
                            promoted, reason="slo_burn", burn=burn,
                            samples=samples)
                else:
                    streak = 0
                held = time.monotonic() - t_stage
                if (held >= self.hold_s and samples >= self.min_samples
                        and burn is not None
                        and burn < self.burn_rollback):
                    break  # stage healthy: advance
                if held > self.stage_timeout_s:
                    # No evidence, no promote: an idle fleet must not
                    # wave a candidate through to 100%.
                    return self._rollback(
                        canary, new_digest, incumbent_digest, promoted,
                        reason="stage_timeout", burn=burn,
                        samples=samples)

        # Promote: traffic is 100% on the canary, so the remaining
        # replicas flip idle — promotion is zero-drain too.
        with self._lock:
            self._phase = "promoting"
        skipped: List[str] = []
        for rep in self.router.replicas:
            if rep.name == canary:
                continue
            if rep.state != UP:
                # Down/respawning mid-rollout: it cannot take a swap
                # line now, and when it comes back it boots the
                # INCUMBENT weights — handled below.
                skipped.append(rep.name)
                continue
            try:
                self._swap(rep.name, self.candidate)
                promoted.append(rep.name)
                self._log(f"promoted {rep.name}")
            except Exception as e:  # noqa: BLE001 — typed or transport
                self._publish("promote_failed", replica=rep.name,
                              error=str(e))
                return self._rollback(
                    canary, new_digest, incumbent_digest, promoted,
                    reason="promote_failed", failed_replica=rep.name,
                    error=str(e))
        self.router.set_fleet_digest(new_digest)
        if skipped and incumbent_digest:
            # A replica skipped here respawns on the BOOT (incumbent)
            # weights; with only the candidate digest authorized it
            # would rejoin permanently unroutable — silent capacity
            # loss behind a "promoted" verdict.  Keep the incumbent
            # digest authorized too: the fleet is explicitly, VISIBLY
            # heterogeneous (per-replica model_info rows + this ledger
            # event) until the operator re-swaps or respawns it,
            # instead of silently smaller.
            self.router.allow_digest(incumbent_digest)
            self._publish("promote_partial", skipped=skipped,
                          incumbent_digest=incumbent_digest)
            self._log(f"partial promotion: {skipped} not promoted "
                      f"(not up) — incumbent digest "
                      f"{incumbent_digest} stays authorized so they "
                      "rejoin routable; re-run the rollout (or swap "
                      "them) to converge")
        self.router.clear_traffic_split()
        rep = self._tracker.report()["objectives"][0]
        self._publish("promote", canary=canary, digest=new_digest,
                      promoted=promoted, skipped=skipped,
                      burn_rate=rep["burn_rate"],
                      samples=rep["window_samples"])
        return self._finish({
            "verdict": "promoted", "canary": canary,
            "digest": new_digest, "promoted": promoted,
            "skipped": skipped,
            "burn_rate": rep["burn_rate"],
            "canary_samples": rep["window_samples"]})

    def _rollback(self, canary: str, new_digest: str,
                  incumbent_digest: Optional[str], promoted: List[str],
                  *, reason: str, **attrib) -> dict:
        """Zero-drain rollback: disallow the candidate digest FIRST
        (the identity gate refuses the canary even if the swap-back
        fails), clear the split, then hot-swap every candidate-serving
        replica back to the incumbent."""
        with self._lock:
            self._phase = "rolling_back"
            self._watching = False
        self._publish("rollback", canary=canary, reason=reason,
                      digest=new_digest, promoted=promoted, **attrib)
        self._log(f"ROLLBACK ({reason}): disallowing {new_digest}, "
                  f"swapping {[canary] + promoted} back")
        if new_digest and new_digest != incumbent_digest:
            self.router.disallow_digest(new_digest)
        self.router.clear_traffic_split()
        swap_back_failed = []
        for name in [canary] + promoted:
            try:
                self._swap(name, self.incumbent)
            except Exception as e:  # noqa: BLE001
                # The identity gate already refuses this replica; it
                # serves nothing until an operator (or respawn) fixes
                # it — degraded capacity, never degraded answers.
                swap_back_failed.append(name)
                self._publish("rollback_swap_failed", replica=name,
                              error=str(e))
                self._log(f"rollback swap-back FAILED on {name}: {e} "
                          "(digest gate keeps it out of traffic)")
        return self._finish({
            "verdict": "rolled_back", "reason": reason,
            "canary": canary, "digest": new_digest,
            "swap_back_failed": swap_back_failed, **attrib})


# -- CLI ---------------------------------------------------------------------
def _parse_line_payload(spec: str, what: str) -> Dict:
    try:
        out = json.loads(spec)
        if not isinstance(out, dict):
            raise ValueError("not an object")
        return out
    except ValueError as e:
        raise SystemExit(f"rollout: --{what} must be a JSON object "
                         f"(swap-line payload): {e}")


def main(argv=None) -> int:
    """``python -m tpuic_torch.serve.rollout`` — a router CLI that also
    drives one canary rollout (module docstring)."""
    import argparse
    import shlex

    p = argparse.ArgumentParser(
        description="Canary rollout controller over a replica fleet "
                    "(docs/serving.md, 'Model lifecycle')")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--replica-cmd", default="",
                   help="replica command template (see "
                        "python -m tpuic_torch.serve.router)")
    p.add_argument("--attach", action="append", default=[],
                   metavar="HOST:PORT[:PROMPORT]")
    p.add_argument("--state-dir", default="rollout-state")
    p.add_argument("--candidate", required=True,
                   help="swap-line payload JSON for the candidate, "
                        "e.g. '{\"ckpt_dir\": \"cp2\", \"track\": "
                        "\"best\"}' or '{\"synthetic_seed\": 1}'")
    p.add_argument("--incumbent", required=True,
                   help="swap-line payload JSON describing the weights "
                        "the fleet serves NOW — what a rollback swaps "
                        "back to")
    p.add_argument("--slo", default="serve_latency:p99<=250ms",
                   help="SLO objective spec scored on the canary's "
                        "resolved latencies (telemetry/slo.py grammar)")
    p.add_argument("--stages", default="0.05,0.5,1.0",
                   help="comma list of traffic fractions per stage")
    p.add_argument("--hold-s", type=float, default=5.0)
    p.add_argument("--min-samples", type=int, default=40)
    p.add_argument("--burn-rollback", type=float, default=2.0,
                   help="burn rate at/above which (for --rollback-after "
                        "consecutive polls) the rollout auto-rolls-back")
    p.add_argument("--rollback-after", type=int, default=2)
    p.add_argument("--poll-s", type=float, default=0.25)
    p.add_argument("--stage-timeout-s", type=float, default=120.0)
    p.add_argument("--canary", default="",
                   help="replica name to canary on (default: first up)")
    p.add_argument("--knee-rps", type=float, default=0.0)
    p.add_argument("--spill-inflight", type=int, default=0)
    p.add_argument("--spawn-timeout-s", type=float, default=300.0)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--prom-port", type=int, default=0)
    p.add_argument("--prom-host", default="127.0.0.1")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    candidate = _parse_line_payload(args.candidate, "candidate")
    incumbent = _parse_line_payload(args.incumbent, "incumbent")
    attach = []
    for spec in args.attach:
        parts = spec.split(":")
        if len(parts) < 2:
            raise SystemExit(f"rollout: bad --attach {spec!r}")
        attach.append((parts[0], int(parts[1]),
                       int(parts[2]) if len(parts) > 2 else None))
    cmd = shlex.split(args.replica_cmd) if args.replica_cmd else None
    if not cmd and not attach:
        raise SystemExit("rollout: need --replica-cmd and/or --attach")

    import signal

    from tpuic_torch.runtime.preemption import PreemptionGuard
    from tpuic_torch.runtime.supervisor import HeartbeatWriter
    from tpuic_torch.serve.router import make_line_handler, pump_stdin
    from tpuic_torch.telemetry.prom import PromServer, router_exposition
    guard = PreemptionGuard(signals=(signal.SIGTERM,)).install()
    heartbeat = HeartbeatWriter.from_env()

    router = Router(
        replica_cmd=cmd, n_replicas=args.replicas, attach=attach,
        state_dir=args.state_dir, knee_rps=args.knee_rps,
        spill_inflight=args.spill_inflight,
        spawn_timeout_s=args.spawn_timeout_s,
        drain_timeout_s=args.drain_timeout)
    router.start()
    rollout = CanaryRollout(
        router, candidate, incumbent, objective=args.slo,
        stages=[float(s) for s in args.stages.split(",") if s.strip()],
        hold_s=args.hold_s, min_samples=args.min_samples,
        burn_rollback=args.burn_rollback,
        rollback_after=args.rollback_after, poll_s=args.poll_s,
        stage_timeout_s=args.stage_timeout_s,
        canary=args.canary or None)

    prom_server = None
    if args.prom_port:
        prom_server = PromServer(
            args.prom_port,
            lambda: router_exposition(router.snapshot(),
                                      rollout=rollout.state()),
            host=args.prom_host)
        print(f"[rollout] prometheus /metrics on "
              f"{args.prom_host}:{prom_server.port}", file=sys.stderr)

    verdict_box: Dict = {}

    def _drive() -> None:
        try:
            verdict_box["verdict"] = rollout.run()
        except Exception as e:  # noqa: BLE001 — a crash is an abort
            verdict_box["verdict"] = {"verdict": "aborted",
                                      "reason": "driver_error",
                                      "error": str(e)}

    controller = threading.Thread(target=_drive, daemon=True,
                                  name="tpuic-rollout")
    controller.start()

    out = open(args.out, "w") if args.out else sys.stdout
    out_lock = threading.Lock()
    handle = make_line_handler(router, out, out_lock)
    try:
        pump_stdin(handle, guard,
                   beat=(heartbeat.beat if heartbeat is not None
                         else None))
        # stdin closed: the rollout may still be mid-stage — let it
        # finish against whatever traffic is still in flight.
        controller.join(timeout=args.stage_timeout_s
                        * (len(rollout.stages) + 2))
    except KeyboardInterrupt:
        pass
    finally:
        guard.uninstall()
        router.drain(args.drain_timeout)
        router.close(drain=False)
        if prom_server is not None:
            prom_server.close()
        verdict = verdict_box.get("verdict") or {
            "verdict": "aborted", "reason": "interrupted"}
        with out_lock:
            out.write(json.dumps({"op": "rollout_verdict",
                                  **verdict}) + "\n")
            out.flush()
        print(f"[rollout] done: {json.dumps(router.snapshot())}",
              file=sys.stderr)
        if out is not sys.stdout:
            out.close()
    return 0 if verdict.get("verdict") == "promoted" else 2


if __name__ == "__main__":
    sys.exit(main())
