"""Elastic bulk-scoring driver (``tpuic/score/driver.py``): the whole
corpus, exactly once, any deaths.

``python -m tpuic_torch.score`` re-scores a packed image corpus against a
trained checkpoint at burst throughput, as one member of an elastic gang
of independent worker processes sharing a results directory:

- the corpus is split into fixed shards (``score/work.py``'s plan);
- each worker leases shards (O_EXCL files, mtime-TTL liveness, steals
  sped up by the membership file), scores them through the serving
  engine's per-bucket CUDA graphs (zero captures after warmup; the int8
  rung by default, bf16 or fp32 on request), and commits each shard via
  the stage, link, CRC-manifest ladder (``score/commit.py``);
- every committed shard is recorded in an append-only JSONL ledger (one
  durable ``JsonlSink`` stream per rank) that ``python -m
  tpuic_torch.telemetry.fleet --score-ledger <dir>`` audits offline:
  scored + quarantined == corpus, per shard and in total.

The model is the one the serve CLI and predict serve
(``predict.serving_model_config``): float32 with the fused conv+BN+ReLU
kernel on every convolution of a ResNet (K3; the int8 rung runs it on its
widened weights, the bf16 rung on its sm90 build) and flash attention in
a ViT.  Rows go in as the packed cache's uint8 rows
(``PackedDataset.raw_batch``), normalised inside the graph.  It runs on
the card unless the caller asks for the CPU (``--device cpu``, the
tests).

Exactly-once = lease and committed manifest: a SIGKILL anywhere leaves
the shard either unpublished (rescored by the next lease holder),
published without a manifest (adopted: the bytes are complete and
deterministic), or committed without a ledger record (recovered: the
next holder rescans every rank's stream under the lease and appends the
missing ``score_commit`` with ``recovered: true``).  A committed shard is
never rescored; an uncommitted one is never dropped.  Ledger appends
happen only while holding the shard's lease, so without injected clock
skew (``lease_skew``) each shard gets exactly one ``score_commit`` record
fleet-wide; WITH skew the commit layer still keeps the results
exactly-once and the audit reports the duplicate record loudly instead of
double-counting silently.

Result rows are canonical bytes (``commit.result_line``: sorted keys,
%.6f probabilities) in corpus order, so a degraded-and-recovered run's
shard files are bitwise equal to an undisturbed single-worker run's.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from tpuic_torch.runtime import faults
from tpuic_torch.score import work
from tpuic_torch.score.commit import ShardStore, result_line
from tpuic_torch.score.work import DEFAULT_TTL_S


def _ledger_records(out_dir: str) -> List[dict]:
    """Every record in every rank's ledger stream (tolerant reader)."""
    from tpuic_torch.telemetry.events import read_jsonl
    recs: List[dict] = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.jsonl"))):
        recs.extend(read_jsonl(path))
    return recs


def _recorded_shards(out_dir: str) -> Set[int]:
    return {int(r["shard"]) for r in _ledger_records(out_dir)
            if r.get("event") == "score_commit" and "shard" in r}


def _counts_from_result(path: str) -> Tuple[int, int]:
    """(scored, quarantined) re-derived from a published result file: the
    adopt path's row accounting (the file is complete by construction;
    see commit.py)."""
    from tpuic_torch.telemetry.events import read_jsonl
    scored = quarantined = 0
    for rec in read_jsonl(path):
        if rec.get("quarantined"):
            quarantined += 1
        else:
            scored += 1
    return scored, quarantined


def _score_shard(packed, engine, shard: int, lo: int, hi: int,
                 batch_size: int, dtype: str, lease) -> Tuple[List[str],
                                                              int, int]:
    """Score rows [lo, hi) through the engine; returns (canonical lines
    in corpus order, scored, quarantined).

    Row integrity first: a packed row whose stored CRC32 no longer
    matches its bytes (at-rest bit-rot in the .bin) is quarantined into
    the ledger's accounting instead of being scored as garbage: the
    pack-time quarantine policy (``data/pack.py``) extended to read time.
    ``shard_corrupt`` (step = shard id, #PARAM = row offset in the shard,
    default 0) injects exactly that verdict deterministically."""
    recs: Dict[int, dict] = {}
    quarantined = 0
    injected_row = None
    if faults.fire("shard_corrupt", step=shard):
        off = faults.param("shard_corrupt")
        injected_row = lo + int(off or 0)
    ok_rows: List[int] = []
    for i in range(lo, hi):
        if i == injected_row or not packed.verify_row(i):
            recs[i] = {"index": i, "id": packed.image_id(i),
                       "quarantined": True,
                       "reason": ("injected" if i == injected_row
                                  else "row_crc")}
            quarantined += 1
        else:
            ok_rows.append(i)

    def consume(fut, chunk) -> None:
        probs, order = fut.result()  # numpy already: no copy
        for j, i in enumerate(chunk):
            top = int(order[j, 0])
            recs[i] = {"index": i, "id": packed.image_id(i),
                       "label": int(packed.label(i)), "pred": top,
                       "prob": f"{probs[j, top]:.6f}"}

    # At most 3 requests in flight: batch N+1's gather and staging overlap
    # batch N's device call.  The lease is renewed at each submit.
    pending = collections.deque()
    for k in range(0, len(ok_rows), batch_size):
        chunk = ok_rows[k:k + batch_size]
        imgs = packed.raw_batch(chunk)
        if dtype == "fp32":
            fut = engine.submit(imgs)
        else:
            fut = engine.submit(imgs, dtype=dtype)
        pending.append((fut, chunk))
        lease.renew(shard)
        while len(pending) >= 3:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    lines = [result_line(recs[i]) for i in range(lo, hi)]
    return lines, len(ok_rows), quarantined


def _engine(packed, dcfg, *, model_name: str, num_classes: int,
            resize: int, batch_size: int, dtype: str, ckpt_dir: str,
            init_from: str, track: str, device, _forward, log):
    """The scoring engine: a stub forward's (tests), or the checkpoint's
    model, served as the serve CLI serves it, with the ladder rung
    ``dtype`` beside the fp32 one."""
    from tpuic_torch.serve import InferenceEngine, default_buckets
    common = dict(image_size=resize, input_dtype=np.uint8,
                  buckets=default_buckets(batch_size), max_wait_ms=0.0,
                  queue_size=8, device=device)
    if _forward is not None:
        return InferenceEngine(forward_fn=_forward, **common)
    from tpuic_torch import quant
    from tpuic_torch.checkpoint.loading import load_inference_variables
    from tpuic_torch.config import Config, OptimConfig, RunConfig
    from tpuic_torch.predict import serving_model_config
    ncls = num_classes or packed.num_classes
    cfg = Config(data=dcfg, model=serving_model_config(model_name, ncls),
                 optim=OptimConfig(),
                 run=RunConfig(ckpt_dir=ckpt_dir, init_from=init_from))
    model = load_inference_variables(
        cfg, track=track, device=device,
        log=lambda *a: log("[score]", *a))
    variants = {}
    if dtype != "fp32":
        variants = {k: v for k, v in quant.serve_variants(
            model, (dtype,)).items() if k != "fp32"}
    return InferenceEngine(model, normalize=True, mean=dcfg.mean,
                           std=dcfg.std, variants=variants, **common)


def run_score(*, data_dir: str, out_dir: str, model_name: str = "",
              num_classes: int = 0, resize: int = 32,
              batch_size: int = 16, shard_size: int = 16,
              dtype: str = "int8", ckpt_dir: str = "", init_from: str = "",
              track: str = "best", fold: str = "val", cache_dir: str = "",
              ttl_s: float = DEFAULT_TTL_S, poll_s: float = 0.25,
              membership_file: Optional[str] = None, max_commits: int = 0,
              rank: Optional[int] = None, ranks: Optional[int] = None,
              device=None, _forward=None, log=print) -> dict:
    """One worker's whole life over the shared scoring job.

    Idempotent and elastic: run it once for a single-process job, run N
    with ``TPUIC_FLEET_RANK``/``TPUIC_FLEET_RANKS`` set for a gang, run
    it AGAIN after any kill to resume.  Returns the job summary (also
    published as the ``score_done`` ledger event), with ``tpuic``'s keys
    and ``kernel_launches``: each counted kernel's launches in the
    scoring loop.  ``max_commits`` bounds fresh commits this life (tests
    simulate a bounded life without a SIGKILL); ``_forward`` injects a
    stub forward in place of the checkpoint's model (tests).  ``device``
    None is the card, and raises when there is none."""
    from tpuic_torch.config import DataConfig
    from tpuic_torch.data.folder import ImageFolderDataset
    from tpuic_torch.data.pack import pack_dataset
    from tpuic_torch.device import resolve_device
    from tpuic_torch.kernels import counted_kernels
    from tpuic_torch.telemetry.events import EventBus, JsonlSink
    from tpuic_torch.telemetry.fleet import rank_stream_path, tag_bus_with_rank

    device = resolve_device(device)
    if membership_file is None:
        from tpuic_torch.runtime.membership import ENV_MEMBERSHIP_FILE
        membership_file = os.environ.get(ENV_MEMBERSHIP_FILE, "")
    os.makedirs(out_dir, exist_ok=True)

    # A PRIVATE bus: score events must not leak into a co-resident
    # trainer's stream, and tests run several ranks in one process.
    bus = EventBus()
    rank, ranks = tag_bus_with_rank(bus=bus, rank=rank, ranks=ranks)
    sink = JsonlSink(rank_stream_path(os.path.join(out_dir,
                                                   "ledger.jsonl"), rank))
    unsub = bus.subscribe(sink)

    dcfg = DataConfig(data_dir=data_dir, resize_size=resize,
                      batch_size=batch_size, val_batch_size=batch_size,
                      cache_dir=cache_dir)
    ds = ImageFolderDataset(data_dir, fold, resize, dcfg,
                            allow_unlabeled=True)
    packed = pack_dataset(ds, cache_dir or os.path.join(
        data_dir, ".tpuic_pack"), verbose=False)
    n = len(packed)

    plan, created = work.write_or_verify_plan(
        out_dir, n=n, shard_size=shard_size,
        token=work.corpus_token(n, resize, [packed.image_id(i)
                                            for i in range(n)]),
        dtype=dtype)
    shards = [(int(lo), int(hi)) for lo, hi in plan["shards"]]
    bus.publish("score_plan", n=n, shards=len(shards),
                shard_size=int(plan["shard_size"]), dtype=dtype,
                corpus_token=int(plan["corpus_token"]), created=created,
                shard_table=[[lo, hi] for lo, hi in shards])

    engine = _engine(packed, dcfg, model_name=model_name,
                     num_classes=num_classes, resize=resize,
                     batch_size=batch_size, dtype=dtype, ckpt_dir=ckpt_dir,
                     init_from=init_from, track=track, device=device,
                     _forward=_forward, log=log)
    engine.warmup()
    # Zero the capture counter AFTER warmup: every graph the steady loop
    # captures from here on is a contract violation the tests assert on.
    engine.stats.reset()
    counted = counted_kernels()
    launched = {fn: fn.launches for fn in counted}

    lease = work.LeaseDir(out_dir, rank, ttl_s=ttl_s)
    store = ShardStore(out_dir, rank)
    recorded: Set[int] = _recorded_shards(out_dir)
    recovered_records = 0
    # Ranks start their sweep at different offsets so a healthy gang
    # mostly avoids lease contention without any coordination.
    start = (rank * len(shards)) // max(ranks, 1)
    t0 = time.perf_counter()
    halted = False

    while not halted:
        progress = False
        outstanding = False
        active = work.active_ranks(membership_file)
        for k in range(len(shards)):
            s = (start + k) % len(shards)
            lo, hi = shards[s]
            if store.state(s) == "committed" and s in recorded:
                continue
            outstanding = True
            if not lease.acquire(s, active):
                continue
            try:
                st = store.state(s)  # re-judge under the lease
                if st == "corrupt":
                    # Manifest and bytes disagree (at-rest rot): the
                    # integrity ladder's refuse-and-redo rung.
                    bus.publish("score_shard", shard=s, lo=lo, hi=hi,
                                action="rescore_corrupt")
                    store.discard(s)
                    st = "missing"
                if st == "missing":
                    bus.publish("score_shard", shard=s, lo=lo, hi=hi,
                                action="score")
                    lines, scored, quar = _score_shard(
                        packed, engine, s, lo, hi, batch_size, dtype,
                        lease)
                    verdict, man = store.commit(s, lo, hi, lines, scored,
                                                quar)
                    if verdict == "committed":
                        bus.publish("score_commit", shard=s, lo=lo, hi=hi,
                                    scored=man["scored"],
                                    quarantined=man["quarantined"],
                                    size=man["size"], crc32=man["crc32"],
                                    recovered=False)
                        recorded.add(s)
                    else:
                        # Lost the link race (lease_skew / steal-steal):
                        # the winner's record is theirs to write; ours
                        # is only the loud evidence of double work.
                        bus.publish("score_duplicate", shard=s,
                                    lo=lo, hi=hi)
                    progress = True
                elif st == "orphan":
                    bus.publish("score_shard", shard=s, lo=lo, hi=hi,
                                action="adopt")
                    scored, quar = _counts_from_result(
                        store.result_path(s))
                    store.adopt(s, lo, hi, scored, quar)
                    progress = True
                if store.state(s) == "committed" and s not in recorded:
                    # Committed but unrecorded (crashed after manifest,
                    # or adopted just now): rescan EVERY rank's stream
                    # under the lease, then append the missing record.
                    recorded |= _recorded_shards(out_dir)
                    if s not in recorded:
                        man = store.manifest(s) or {}
                        bus.publish("score_commit", shard=s, lo=lo, hi=hi,
                                    scored=man.get("scored"),
                                    quarantined=man.get("quarantined"),
                                    size=man.get("size"),
                                    crc32=man.get("crc32"),
                                    recovered=True)
                        recorded.add(s)
                        recovered_records += 1
                        progress = True
            finally:
                lease.release(s)
            if max_commits and store.commits >= max_commits:
                halted = True
                break
        if halted or not outstanding:
            break
        if not progress:
            # Everything left is leased to peers: wait for them to
            # finish, die, or leave the membership, then resweep.
            time.sleep(poll_s)
            recorded |= _recorded_shards(out_dir)

    wall_s = time.perf_counter() - t0
    manifests = [store.manifest(s) for s in range(len(shards))]
    done = [m for m in manifests if m is not None]
    summary = {
        "n": n, "shards": len(shards),
        "shards_committed": sum(1 for s in range(len(shards))
                                if store.state(s) == "committed"),
        "rows_scored": sum(int(m["scored"]) for m in done),
        "rows_quarantined": sum(int(m["quarantined"]) for m in done),
        "commits_this_life": store.commits,
        "duplicates_this_life": store.duplicates,
        "steals_this_life": lease.steals,
        "recovered_records": recovered_records,
        "steady_compiles": int(engine.stats.snapshot()["compiles"]),
        "dtype": dtype, "halted": bool(halted),
        "wall_s": round(wall_s, 3),
        "kernel_launches": {fn.__name__: fn.launches - launched[fn]
                            for fn in counted},
    }
    bus.publish("score_done", **summary)
    engine.close()
    sink.close()
    unsub()
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpuic_torch.score", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datadir", required=True)
    p.add_argument("--out", required=True,
                   help="shared scoring workdir (plan, leases, results, "
                        "manifests, per-rank ledgers)")
    p.add_argument("--fold", default="val")
    p.add_argument("--model", default="auto",
                   help="backbone name, or 'auto' to read the single "
                        "trained model's config.json under --ckpt-dir")
    p.add_argument("--num-classes", type=int, default=0)
    p.add_argument("--resize", type=int, default=None)
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--shard-size", type=int, default=16,
                   help="corpus rows per shard (the lease/commit unit)")
    p.add_argument("--dtype", default="int8",
                   choices=("fp32", "bf16", "int8"),
                   help="ladder rung to score with")
    p.add_argument("--ckpt-dir", default="dtmodel/cp")
    p.add_argument("--track", default="best", choices=("best", "latest"))
    p.add_argument("--init-from", default="",
                   help="reference torch checkpoint instead of a port one")
    p.add_argument("--ttl", type=float, default=DEFAULT_TTL_S,
                   help="lease TTL seconds (liveness horizon for steals)")
    p.add_argument("--poll", type=float, default=0.25,
                   help="idle resweep interval while peers hold leases")
    p.add_argument("--prom-dump", default="",
                   help="write tpuic_score_* Prometheus exposition here "
                        "at exit")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on "
                        "the CPU)")
    args = p.parse_args(argv)
    faults.check_fired("score")
    from tpuic_torch.device import resolve_device
    resolve_device(args.device)  # no card and no --device cpu: raise now

    model, num_classes, resize = args.model, args.num_classes, args.resize
    if model == "auto":
        from tpuic_torch.predict import resolve_model_auto
        saved = resolve_model_auto(args.ckpt_dir)
        model = saved["name"]
        num_classes = num_classes or saved["num_classes"]
        if resize is None:
            resize = saved["resize_size"]
        print(f"[score] auto-resolved model '{model}' "
              f"(num_classes={num_classes}, resize={resize}) from "
              f"{args.ckpt_dir}")
    if resize is None:
        resize = 299  # the reference's hard-coded size (train.py:110)

    summary = run_score(
        data_dir=args.datadir, out_dir=args.out, model_name=model,
        num_classes=num_classes, resize=resize, batch_size=args.batchsize,
        shard_size=args.shard_size, dtype=args.dtype,
        ckpt_dir=args.ckpt_dir, init_from=args.init_from, track=args.track,
        fold=args.fold, ttl_s=args.ttl, poll_s=args.poll,
        device=args.device)
    print(json.dumps(summary))
    if args.prom_dump:
        from tpuic_torch.telemetry.prom import (render, score_rows,
                                                write_exposition)
        write_exposition(args.prom_dump, render(score_rows(summary)))
        print(f"[score] prom exposition -> {args.prom_dump}")
    ok = (summary["shards_committed"] == summary["shards"]
          and not summary["halted"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
