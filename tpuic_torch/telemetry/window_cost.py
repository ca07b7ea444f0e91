"""Step ms before and after ``torch.profiler`` windows, with CUPTI torn
down at each window's stop (``TEARDOWN_CUPTI=1``, the port's default) and
left attached (``TEARDOWN_CUPTI=0``).

    python -m tpuic_torch.telemetry.window_cost [--model inceptionv3]
        [--batch 32] [--steps 8] [--order 0110] [--device cuda]

Each character of ``--order`` is one turn in a fresh process with that
``TEARDOWN_CUPTI``.  A turn builds the train CLI's default recipe for
``--model`` (bf16 compute, the plain loss and Adam) at ``--batch`` on
seeded random batches, times ``--steps`` steps, opens a window of two
steps through ``telemetry.tracing`` (its Chrome trace exported, as the
trainer's windows are), times ``--steps`` more, opens a second window
and times ``--steps`` more.  A step is timed from a synchronised card to
its loss on the host.  Prints a JSON line a turn, then the medians of
each phase by setting and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


def _turn(args) -> dict:
    import torch
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.telemetry import tracing
    from tpuic_torch.train import __main__ as cli
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    dev = torch.device(args.device)
    p = cli.build_parser()
    cfg = cli.config_from_args(p.parse_args(
        ["--datadir", ".", "--model", args.model, "--batchsize",
         str(args.batch), "--num-classes", "1000", "--no-class-weights"]), p)
    size = cfg.data.resize_size
    model = init_params(create_model_from_config(
        cfg.model, image_size=size, device=dev), args.seed, device=dev)
    state = create_train_state(model, make_optimizer(cfg.optim), ema=False)
    step = make_train_step(cfg.optim, cfg.model, lr_schedule=make_schedule(
        cfg.optim, 1, 1), device=dev, seed=args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    batches = [{"image": torch.randn(args.batch, size, size, 3, device=dev,
                                     generator=g),
                "label": torch.randint(0, 1000, (args.batch,), device=dev,
                                       generator=g).int(),
                "mask": torch.ones(args.batch, device=dev)}
               for _ in range(3)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(n: int) -> list:
        nonlocal state
        ms = []
        for i in range(n):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batches[i % len(batches)])
            float(m["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    def window() -> None:
        nonlocal state
        prof = tracing.start_profiler()
        for b in batches[:2]:
            state, m = step(state, b)
        float(m["loss"])
        with tempfile.TemporaryDirectory() as d:
            tracing.stop_profiler(prof, d)

    run(3)
    out = {"teardown_cupti": os.environ.get("TEARDOWN_CUPTI"),
           "before": run(args.steps)}
    window()
    out["after1"] = run(args.steps)
    window()
    out["after2"] = run(args.steps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="inceptionv3")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--order", default="0110")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(_turn(args)), flush=True)
        return 0
    phases = ("before", "after1", "after2")
    by = {}
    for t in args.order:
        env = dict(os.environ, TEARDOWN_CUPTI=t)
        r = subprocess.run(
            [sys.executable, "-m", "tpuic_torch.telemetry.window_cost",
             "--turn", *(argv if argv is not None else sys.argv[1:])],
            env=env, stdout=subprocess.PIPE, text=True, check=True)
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        for ph in phases:
            by.setdefault(t, {}).setdefault(ph, []).append(
                statistics.median(rec[ph]))
    card = None
    if shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({"card": card, "median_step_ms": by}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
