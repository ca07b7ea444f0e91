"""Per-rank fleet view: rank-tagged event streams and straggler
attribution (a copy of ``tpuic/telemetry/fleet.py``).

- **Rank tagging** (:func:`tag_bus_with_rank`): on a multi-process run
  every event published on the bus gains ``rank``/``ranks`` fields; a
  single-process run leaves the tag unset.
- **Per-rank JSONL streams** (:func:`rank_stream_path`): rank 0 keeps the
  configured ``--metrics-jsonl`` path; rank k writes
  ``<stem>.rank<k>.jsonl`` next to it (the port's train CLI writes them,
  ``telemetry/wiring.py``).
- **Offline aggregator** (``python -m tpuic_torch.telemetry.fleet
  <dir>``): merges the streams and computes the skew ledger over the
  steps every rank reported: per-step cross-rank spread (max - min
  total_ms), the slowest-rank histogram, and each rank's estimated
  collective wait (its step time minus the fleet minimum for that step,
  summed).  The rank with the dominant share is the straggler verdict.
  ``--membership`` gates coverage on a gang ledger's timeline and
  ``--score-ledger`` audits a bulk-scoring ledger, as ``tpuic``'s do.

The per-step events are host-side walls: at ``--log-every-steps 1``
every host blocks on the step's metrics, so host step times equalize and
the skew hides in each rank's ``device_ms``; at the default cadence hosts
run free between drains and the skew shows.  Pure host code: the
aggregator reads files and launches nothing on a device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

_RANK_FILE_RE = re.compile(r"\.rank(\d+)\.[^.]+$")


# -- rank tagging ------------------------------------------------------------
# Launcher override: a fleet whose rank bookkeeping lives outside the
# process group (independent per-rank workers) declares itself via env.
# The live runtime (runtime/distributed.py) stays the default source.
ENV_FLEET_RANK = "TPUIC_FLEET_RANK"
ENV_FLEET_RANKS = "TPUIC_FLEET_RANKS"


def tag_bus_with_rank(bus=None, rank: Optional[int] = None,
                      ranks: Optional[int] = None) -> Tuple[int, int]:
    """Tag ``bus`` (default: the process-global one) with this process's
    (rank, world size): explicit arguments win, then the
    ``TPUIC_FLEET_RANK``/``TPUIC_FLEET_RANKS`` launcher override, then
    ``runtime/distributed.py``'s live process_index/process_count.
    Returns the pair.  Single-process runs (``ranks == 1``) leave the
    tag unset — the common path stays untouched and single-process
    JSONL schemas don't grow fleet fields."""
    if bus is None:
        from tpuic_torch.telemetry.events import bus as _bus
        bus = _bus
    if (rank is None) != (ranks is None):
        # Same rule as the env override below: half a fleet identity is
        # not an identity — silently rederiving both would drop the
        # caller's value and can collapse every worker to rank 0/1.
        raise ValueError(
            f"tag_bus_with_rank: pass both rank and ranks or neither "
            f"(got rank={rank!r}, ranks={ranks!r})")
    if rank is None:
        er = os.environ.get(ENV_FLEET_RANK)
        ew = os.environ.get(ENV_FLEET_RANKS)
        if (er is None) != (ew is None):
            # A half-set override would silently collapse every worker
            # to the runtime default (rank 0 of 1) — k processes then
            # append interleaved, untagged events into ONE stream,
            # exactly the corruption per-rank paths exist to prevent.
            raise ValueError(
                f"fleet launcher override is half-set: {ENV_FLEET_RANK}="
                f"{er!r}, {ENV_FLEET_RANKS}={ew!r} — set both or neither")
        if er is not None:
            rank, ranks = int(er), int(ew)
        else:
            from tpuic_torch.runtime.distributed import runtime_info
            info = runtime_info()
            rank, ranks = info.process_index, info.process_count
    rank, ranks = int(rank), int(ranks)
    bus.rank_tag = ({"rank": rank, "ranks": ranks} if ranks > 1 else None)
    return rank, ranks


def rank_stream_path(path: str, rank: int) -> str:
    """Per-rank stream path: rank 0 keeps ``path`` (back-compat with
    every single-process consumer); rank k gets ``<stem>.rank<k><ext>``
    (``events.jsonl`` -> ``events.rank3.jsonl``)."""
    if int(rank) == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{int(rank)}{ext or '.jsonl'}"


# -- stream loading ----------------------------------------------------------
def _infer_rank(path: str) -> Optional[int]:
    m = _RANK_FILE_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def load_streams(paths: Sequence[str]) -> Dict[int, List[dict]]:
    """Read JSONL event streams (files, or directories expanded to their
    ``*.jsonl``) and group records by rank: the record's own ``rank``
    field wins (the tagged streams), else the ``.rank<k>.`` filename
    convention, else rank 0 — so pre-fleet single-process streams load
    as a one-rank fleet instead of failing."""
    from tpuic_torch.telemetry.events import read_jsonl

    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(".jsonl")))
        else:
            files.append(p)
    streams: Dict[int, List[dict]] = {}
    for f in files:
        fallback = _infer_rank(f)
        for rec in read_jsonl(f):
            r = rec.get("rank", fallback)
            streams.setdefault(int(r) if r is not None else 0,
                               []).append(rec)
    return streams


# -- elastic membership timelines --------------------------------------------
def membership_timeline(ledger_path: str) -> dict:
    """Parse an elastic gang ledger (``tpuic``'s ``ledger.jsonl``)
    into the fleet's membership timeline: every ``membership`` record
    (init/degrade/rejoin/restart transitions with their active sets)
    plus the union of every rank that was EVER a member or spawned.

    The aggregator's coverage gate uses this for elastic runs: under
    ``--require-ranks N`` a degraded fleet looks like a dead rank's
    missing stream and a replacement looks like an unexpected one —
    both hard failures — but against the timeline a shrink/grow is
    LEGAL as long as the streams cover exactly the ranks the ledger
    says ever ran (a stream from a rank the ledger never admitted, or
    no stream from a rank it did, stays loud)."""
    from tpuic_torch.telemetry.events import read_jsonl

    ever: set = set()
    transitions: List[dict] = []
    for rec in read_jsonl(ledger_path):
        ev = rec.get("event")
        if ev == "membership":
            active = [int(r) for r in rec.get("active", [])]
            ever.update(active)
            transitions.append({
                "version": rec.get("version"),
                "reason": rec.get("reason"),
                "active": active, "rank": rec.get("rank"),
                "resume_step": rec.get("resume_step"),
                "t": rec.get("t")})
        elif ev in ("spawn", "respawn") and rec.get("rank") is not None:
            ever.add(int(rec["rank"]))
    return {"ever_ranks": sorted(ever), "transitions": transitions}


# -- bulk-score ledger audit -------------------------------------------------
def score_audit(streams: Dict[int, List[dict]]) -> dict:
    """Audit a bulk-scoring job's ledger streams (``tpuic``'s score tier):
    **scored + quarantined == corpus**, per shard and in total, with
    every violation named — the offline proof the elastic scorer's
    exactly-once machinery actually held.

    Checks, all loud:

    - a ``score_plan`` record exists and every worker's plan agrees
      (n, shard count, corpus token) — mixed-job streams fail here;
    - every planned shard has EXACTLY one ``score_commit`` record
      fleet-wide: missing shards are dropped work, >1 records are the
      double-count a ``lease_skew``-style race would smuggle in;
    - each commit's ``scored + quarantined`` equals its shard's row
      count, and the totals sum to the corpus size;
    - commits for shards the plan never defined fail (wrong workdir).

    ``score_duplicate`` events (double work the commit layer deduped)
    and ``recovered`` commits (records appended by a survivor for a
    dead winner) are REPORTED but are not violations — they are the
    recovery machinery working as designed.
    """
    recs = [r for rs in streams.values() for r in rs]
    plans = [r for r in recs if r.get("event") == "score_plan"]
    errors: List[str] = []
    if not plans:
        return {"ok": False, "errors":
                ["no score_plan record in any stream — not a scoring "
                 "ledger (or the planner's stream is missing)"]}
    plan = plans[0]
    for p in plans[1:]:
        for key in ("n", "shards", "shard_size", "corpus_token"):
            if p.get(key) != plan.get(key):
                errors.append(
                    f"score_plan disagreement: {key}={p.get(key)!r} vs "
                    f"{plan.get(key)!r} — streams from different jobs")
                break
    n = int(plan.get("n") or 0)
    table = {i: (int(lo), int(hi)) for i, (lo, hi)
             in enumerate(plan.get("shard_table") or [])}
    nshards = int(plan.get("shards") or len(table))

    by_shard: Dict[int, List[dict]] = {}
    for r in recs:
        if r.get("event") == "score_commit" and r.get("shard") is not None:
            by_shard.setdefault(int(r["shard"]), []).append(r)
    dup_events = sum(1 for r in recs if r.get("event") == "score_duplicate")

    missing = sorted(s for s in range(nshards) if s not in by_shard)
    duplicated = {s: len(v) for s, v in sorted(by_shard.items())
                  if len(v) > 1}
    unknown = sorted(s for s in by_shard if s < 0 or s >= nshards)
    if missing:
        errors.append(f"{len(missing)} shard(s) have NO commit record "
                      f"(dropped work): {missing[:10]}"
                      + ("..." if len(missing) > 10 else ""))
    for s, k in duplicated.items():
        errors.append(f"shard {s} committed {k} times — duplicate "
                      "records would double-count the corpus")
    if unknown:
        errors.append(f"commit record(s) for shard(s) the plan never "
                      f"defined: {unknown} — wrong workdir or torn plan")

    total_scored = total_quar = recovered = 0
    bad_rows: List[str] = []
    for s, commits in sorted(by_shard.items()):
        if s in unknown:
            continue
        c = commits[0]  # duplicates already failed above; audit the first
        scored = int(c.get("scored") or 0)
        quar = int(c.get("quarantined") or 0)
        total_scored += scored
        total_quar += quar
        recovered += sum(1 for x in commits if x.get("recovered"))
        lo, hi = table.get(s, (c.get("lo"), c.get("hi")))
        if lo is not None and hi is not None \
                and scored + quar != int(hi) - int(lo):
            bad_rows.append(
                f"shard {s}: scored {scored} + quarantined {quar} != "
                f"{int(hi) - int(lo)} rows [{lo}, {hi})")
    errors.extend(bad_rows)
    if not missing and not unknown and total_scored + total_quar != n:
        errors.append(f"totals: scored {total_scored} + quarantined "
                      f"{total_quar} != corpus {n}")
    return {"ok": not errors, "errors": errors, "n": n,
            "shards": nshards, "shards_committed": len(by_shard),
            "shards_missing": len(missing),
            "shards_duplicated": len(duplicated),
            "rows_scored": total_scored, "rows_quarantined": total_quar,
            "recovered_records": recovered,
            "duplicate_score_events": dup_events,
            "dtype": plan.get("dtype")}


def score_summary_lines(report: dict) -> List[str]:
    """Human rendering of :func:`score_audit` (the CLI's stdout)."""
    if "n" not in report:
        return [f"[fleet] score ledger: FAIL — {e}"
                for e in report.get("errors", ["unauditable"])]
    lines = [
        f"[fleet] score ledger: {report['shards_committed']}/"
        f"{report['shards']} shard(s) committed, "
        f"{report['rows_scored']} scored + "
        f"{report['rows_quarantined']} quarantined vs corpus "
        f"{report['n']}" + (f" (dtype {report['dtype']})"
                            if report.get("dtype") else "")]
    if report.get("recovered_records"):
        lines.append(f"[fleet] score ledger: "
                     f"{report['recovered_records']} commit record(s) "
                     "recovered by a survivor (crash-window repair)")
    if report.get("duplicate_score_events"):
        lines.append(f"[fleet] score ledger: "
                     f"{report['duplicate_score_events']} double-scored "
                     "shard attempt(s) deduped at commit (lease races "
                     "cost throughput, not correctness)")
    for e in report.get("errors", []):
        lines.append(f"[fleet] score ledger FAIL: {e}")
    if report["ok"]:
        lines.append("[fleet] score ledger: exact — zero duplicates, "
                     "zero drops")
    return lines


# -- the skew ledger ---------------------------------------------------------
def aggregate(streams: Dict[int, List[dict]], warmup: int = 0) -> dict:
    """Merge per-rank event streams into the straggler-attribution
    report (module docstring).  ``warmup`` drops the first N common
    steps (kernel builds and graph captures are per-rank noise, not
    skew signal).

    Only steps reported by EVERY rank enter the skew math: a partial
    step (one rank died mid-epoch) has no fleet-wide wall to compare.
    """
    from tpuic_torch.metrics.meters import quantiles

    ranks = sorted(streams)
    per_step: Dict[int, Dict[int, dict]] = {}
    step_counts = {r: 0 for r in ranks}
    duplicates = {r: 0 for r in ranks}
    for rank, recs in streams.items():
        for rec in recs:
            if rec.get("event") != "step":
                continue
            try:
                step, total = int(rec["step"]), float(rec["total_ms"])
            except (KeyError, TypeError, ValueError):
                continue
            step_counts[rank] += 1
            if rank in per_step.get(step, ()):
                # A supervised restart replays steps into the same
                # appended stream; last occurrence wins (the value that
                # stuck), but the collapse is COUNTED and surfaced —
                # mixed-attempt walls soften the skew math's meaning.
                duplicates[rank] += 1
            per_step.setdefault(step, {})[rank] = {
                "total_ms": total,
                "data_ms": float(rec.get("data_ms", 0.0) or 0.0),
                "dispatch_ms": float(rec.get("dispatch_ms", 0.0) or 0.0),
                "device_ms": float(rec.get("device_ms", 0.0) or 0.0),
            }
    common = sorted(s for s, by in per_step.items()
                    if len(by) == len(ranks))[warmup:]
    spreads: List[float] = []
    slowest = {r: 0 for r in ranks}
    excess = {r: 0.0 for r in ranks}
    for s in common:
        by = per_step[s]
        totals = {r: by[r]["total_ms"] for r in ranks}
        lo = min(totals.values())
        spreads.append(max(totals.values()) - lo)
        slowest[max(totals, key=totals.get)] += 1
        for r, v in totals.items():
            excess[r] += v - lo

    per_rank = {}
    for r in ranks:
        row = {"steps": step_counts[r], "common_steps": len(common)}
        totals = [per_step[s][r]["total_ms"] for s in common]
        if totals:
            q = quantiles(totals, (50, 99))
            row.update(
                mean_ms=round(sum(totals) / len(totals), 3),
                p50_ms=round(q["p50"], 3), p99_ms=round(q["p99"], 3),
                slowest_steps=slowest[r],
                est_collective_wait_ms=round(excess[r], 3))
            for phase in ("data_ms", "dispatch_ms", "device_ms"):
                vals = [per_step[s][r][phase] for s in common]
                row[f"mean_{phase}"] = round(sum(vals) / len(vals), 3)
        per_rank[str(r)] = row

    straggler = None
    if common and len(ranks) >= 2:
        worst = max(ranks, key=lambda r: excess[r])
        total_excess = sum(excess.values())
        straggler = {
            "rank": worst,
            "excess_share": (round(excess[worst] / total_excess, 4)
                             if total_excess > 0 else 0.0),
            "slowest_step_frac": round(slowest[worst] / len(common), 4),
            "est_collective_wait_ms": round(excess[worst], 3),
        }
    out = {"ranks": ranks, "steps_common": len(common), "warmup": warmup,
           "per_rank": per_rank, "straggler": straggler}
    if any(duplicates.values()):
        out["duplicate_steps"] = {str(r): n for r, n in duplicates.items()
                                  if n}
    if spreads:
        q = quantiles(spreads, (50, 99))
        out["spread_ms"] = {"p50": round(q["p50"], 3),
                            "p99": round(q["p99"], 3),
                            "max": round(max(spreads), 3)}
    return out


def summary_lines(report: dict) -> List[str]:
    """Human rendering of :func:`aggregate` (the CLI's stdout)."""
    lines = [f"[fleet] {len(report['ranks'])} rank(s), "
             f"{report['steps_common']} common step(s)"
             + (f" (warmup {report['warmup']} dropped)"
                if report.get("warmup") else "")]
    dup = report.get("duplicate_steps")
    if dup:
        lines.append(
            f"[fleet] WARNING: duplicate step records (restart replays?) "
            f"collapsed last-wins: {dup} — per-step walls may mix "
            f"attempts; prefer per-attempt stream dirs for exact skew")
    sp = report.get("spread_ms")
    if sp:
        lines.append(f"[fleet] per-step cross-rank spread: "
                     f"p50 {sp['p50']:g} ms, p99 {sp['p99']:g} ms, "
                     f"max {sp['max']:g} ms")
    for r in report["ranks"]:
        row = report["per_rank"][str(r)]
        if "mean_ms" not in row:
            lines.append(f"[fleet] rank {r}: {row['steps']} step event(s), "
                         "none fleet-common")
            continue
        lines.append(
            f"[fleet] rank {r}: p50 {row['p50_ms']:g} ms "
            f"(data {row['mean_data_ms']:g} / dispatch "
            f"{row['mean_dispatch_ms']:g} / device "
            f"{row['mean_device_ms']:g}), slowest in "
            f"{row['slowest_steps']}/{row['common_steps']} step(s), "
            f"est collective wait {row['est_collective_wait_ms']:g} ms")
    s = report.get("straggler")
    if s:
        lines.append(
            f"[fleet] straggler: rank {s['rank']} — slowest in "
            f"{100 * s['slowest_step_frac']:.0f}% of steps, "
            f"{100 * s['excess_share']:.0f}% of fleet excess, "
            f"~{s['est_collective_wait_ms']:g} ms exported stall")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpuic_torch.telemetry.fleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="+",
                   help="per-rank JSONL stream files, or directories "
                        "whose *.jsonl are the fleet's streams")
    p.add_argument("--warmup", type=int, default=0,
                   help="drop the first N common steps (build/capture "
                        "warmup is per-rank noise, not skew)")
    p.add_argument("--json", default="",
                   help="write the full report JSON here")
    p.add_argument("--expect-straggler", type=int, default=None,
                   help="exit 1 unless the straggler verdict names this "
                        "rank")
    p.add_argument("--require-ranks", type=int, default=0, metavar="N",
                   help="exit 1 unless the streams cover exactly ranks "
                        "0..N-1 — a fleet run missing a rank's stream "
                        "entirely (dead rank, wrong path) must fail "
                        "loudly, not have its skew silently computed "
                        "over whichever ranks showed up (a fleet run "
                        "passes its size here). "
                        "The STRICT gate — fixed-membership fleets; "
                        "elastic runs pass --membership instead")
    p.add_argument("--membership", default="", metavar="LEDGER",
                   help="elastic coverage gate: the gang ledger "
                        "(ledger.jsonl) whose membership timeline says "
                        "which ranks legally joined/left mid-run — the "
                        "streams must cover exactly the ranks that EVER "
                        "ran (a shrink/grow is legal; a stream the "
                        "ledger never admitted, or a missing member "
                        "stream, still fails). Mutually exclusive with "
                        "--require-ranks")
    p.add_argument("--score-ledger", action="store_true",
                   help="audit mode for bulk-scoring ledgers "
                        "(tpuic's score tier): scored + quarantined == corpus "
                        "per shard and in total, exactly one commit "
                        "record per shard, duplicates and drops loud — "
                        "exit 1 on any violation")
    p.add_argument("--prom-dump", default="", metavar="PATH",
                   help="with --score-ledger: write the tpuic_score_* "
                        "Prometheus exposition of the audit here")
    args = p.parse_args(argv)

    if args.score_ledger:
        streams = load_streams(args.paths)
        if not streams:
            print("[fleet] no event streams found", file=sys.stderr)
            return 2
        report = score_audit(streams)
        for line in score_summary_lines(report):
            print(line, file=sys.stdout if report["ok"] else sys.stderr)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=2)
            print(f"[fleet] report -> {args.json}")
        if args.prom_dump:
            from tpuic_torch.telemetry.prom import (render, score_rows,
                                                    write_exposition)
            write_exposition(args.prom_dump, render(score_rows(report)))
            print(f"[fleet] prom exposition -> {args.prom_dump}")
        return 0 if report["ok"] else 1

    if args.require_ranks and args.membership:
        print("[fleet] --require-ranks (strict) and --membership "
              "(elastic timeline) are mutually exclusive",
              file=sys.stderr)
        return 2
    streams = load_streams(args.paths)
    if not streams:
        print("[fleet] no event streams found", file=sys.stderr)
        return 2
    timeline = None
    if args.require_ranks:
        expected = set(range(args.require_ranks))
        missing = sorted(expected - set(streams))
        extra = sorted(set(streams) - expected)
        if missing or extra:
            print(f"[fleet] FAIL: --require-ranks {args.require_ranks}: "
                  + (f"missing rank stream(s) {missing}" if missing else "")
                  + (" and " if missing and extra else "")
                  + (f"unexpected rank(s) {extra}" if extra else "")
                  + f" (found ranks {sorted(streams)})", file=sys.stderr)
            return 1
    if args.membership:
        timeline = membership_timeline(args.membership)
        expected = set(timeline["ever_ranks"])
        if not expected:
            print(f"[fleet] FAIL: --membership {args.membership}: ledger "
                  "carries no membership/spawn records — nothing to "
                  "gate against", file=sys.stderr)
            return 2
        missing = sorted(expected - set(streams))
        extra = sorted(set(streams) - expected)
        if missing or extra:
            print(f"[fleet] FAIL: --membership: "
                  + (f"missing stream(s) for ledger member(s) {missing}"
                     if missing else "")
                  + (" and " if missing and extra else "")
                  + (f"stream(s) from rank(s) the ledger never admitted "
                     f"{extra}" if extra else "")
                  + f" (found ranks {sorted(streams)}, ever-members "
                  f"{sorted(expected)})", file=sys.stderr)
            return 1
        n_tr = len(timeline["transitions"])
        print(f"[fleet] membership timeline: {len(expected)} ever-"
              f"member(s), {n_tr} transition(s) — elastic coverage OK")
    report = aggregate(streams, warmup=max(0, args.warmup))
    if timeline is not None:
        report["membership"] = timeline
    for line in summary_lines(report):
        print(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[fleet] report -> {args.json}")
    if args.expect_straggler is not None:
        s = report.get("straggler")
        if s is None or int(s["rank"]) != args.expect_straggler:
            print(f"[fleet] FAIL: expected straggler rank "
                  f"{args.expect_straggler}, verdict is "
                  f"{s and s['rank']}", file=sys.stderr)
            return 1
        print(f"[fleet] straggler verdict matches expected rank "
              f"{args.expect_straggler}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
