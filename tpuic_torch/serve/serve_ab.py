"""``[serve]`` and ``[vit-serve]`` of two checkouts on one card, in turns.

    python -m tpuic_torch.serve.serve_ab --tree <parent checkout> \\
        --tree . --order ABBA --repeats 2 --out serve_ab.json

Each turn is a process of its own, started in the checkout it names
(``A`` is the first ``--tree``, ``B`` the second), that imports that
checkout's ``chip_smoke`` and ``tpuic_torch`` and runs its ``[serve]``
phase (ResNet-50, fused K3) and its ``[vit-serve]`` phase (ViT-B/16,
K4f), ``--repeats`` times each, on weights drawn from ``--seed``: eight
closed-loop clients through the engine's per-bucket CUDA graphs, with
the phase's own checks.  Running both checkouts in one process tree on
one card keeps the host, the card and its power limit the same for
both, and the turns' order (ABBA) spreads drift over both.

Prints one JSON line per run (``"run"``), then a summary: per checkout
and phase, each run's images/s, latency p50/p99 and dispatch and device
span p50/p99.  Every turn's own output goes to ``<out>.turn<i>.log``
beside ``--out``.  Exits non-zero when a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Run in the checkout under test: its chip_smoke, its package.
_CHILD = r'''
import json, sys
import chip_smoke as cs
from tpuic_torch.checkpoint import init_synthetic
from tpuic_torch.models import create_model
repeats, requests, seed = (int(a) for a in sys.argv[1:4])
smi = cs.smi_line()
print("SMI " + smi, flush=True)
phases = (
    ("serve", lambda: create_model("resnet50", 1000, dtype="float32",
                                   fused_conv_bn=True), {}),
    ("vit-serve", lambda: create_model(cs.VIT_MODEL, 1000, dtype="float32",
                                       attention="flash",
                                       image_size=cs.IMAGE),
     dict(tag="vit-serve", counter="flash_attention_fwd",
          per_call=cs.VIT_LAYERS)))
for name, build, kw in phases:
    model = init_synthetic(build(), seed=seed).eval()
    for run in range(repeats):
        _, snap = cs.phase_serve(model, requests, seed, smi, **kw)
        print("RUN " + json.dumps({
            "phase": name, "run": run,
            "images_per_s": snap["throughput_images_per_sec"],
            "latency_ms": snap["latency_ms"],
            "span_ms": snap["span_ms"],
            "device_calls": snap["device_calls"]}), flush=True)
    del model
    cs.free()
'''


def run_turn(tree: str, label: str, args, log_path: str) -> list:
    """One process in ``tree``; its RUN rows, each tagged with
    ``label``."""
    cmd = [sys.executable, "-c", _CHILD, str(args.repeats),
           str(args.requests), str(args.seed)]
    rows, smi = [], None
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=tree, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            log.write(line)
            if line.startswith("RUN "):
                row = {"tree": label, **json.loads(line[4:])}
                print(json.dumps(row), flush=True)
                rows.append(row)
            elif line.startswith("SMI "):
                smi = line[4:].strip()
        rc = proc.wait()
    if rc != 0:
        raise SystemExit(f"turn in {tree} exited {rc}; see {log_path}")
    for row in rows:
        row["card"] = smi
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout holding chip_smoke.py (give two)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--requests", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="serve_ab.json")
    args = ap.parse_args(argv)
    if len(args.tree) != 2:
        ap.error("give --tree twice: A, then B")
    trees = dict(zip("AB", (os.path.abspath(t) for t in args.tree)))
    rows = []
    for i, label in enumerate(args.order):
        rows += run_turn(trees[label], label, args,
                         f"{args.out}.turn{i}.log")
    summary = {}
    for r in rows:
        spans = r["span_ms"]
        summary.setdefault(f"{r['tree']} {r['phase']}", []).append({
            "images_per_s": r["images_per_s"],
            "latency_p50_p99": [r["latency_ms"]["p50"],
                                r["latency_ms"]["p99"]],
            "dispatch_p50_p99": [spans["dispatch"]["p50"],
                                 spans["dispatch"]["p99"]],
            "device_p50_p99": [spans["device"]["p50"],
                               spans["device"]["p99"]]})
    out = {"trees": trees, "order": args.order, "card": rows[0]["card"],
           "summary": summary, "runs": rows}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": out["card"], "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
