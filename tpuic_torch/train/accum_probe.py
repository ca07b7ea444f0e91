"""How far two LARS arms that differ only in their arithmetic's order drift
apart, update by update, with and without gradient accumulation.

    python -m tpuic_torch.train.accum_probe [--device cpu] [--model resnet50]
        [--image 32] [--batch 16] [--updates 4] [--seed 0]

Each arm starts from one state and takes the same seeded batches through
the train step with LARS at lr 0.48, wd 1e-4 and label smoothing 0.1
(chip_smoke's ``[accum]`` recipe): ``fused`` through the K1 and K2
wrappers (on the CPU their plain versions), ``plain`` through the plain
loss and the plain LARS.  ``accum`` takes ``--updates`` updates of two
micro-steps each (``grad_accum_steps`` 2); ``whole`` takes the same
updates as single steps on the two micro-batches joined.  After each
update it prints each pair of arms' largest parameter difference over the
tensor's largest magnitude (``[accum]``'s ``update_rel_diff``), and how
much it grew from one update to the next.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def _batches(n: int, batch: int, image: int, classes: int, seed: int):
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.standard_normal(
                (batch, image, image, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(
                 0, classes, batch).astype(np.int32)),
             "mask": torch.ones(batch)} for _ in range(n)]


def _run(mcfg, ocfg, image: int, batches, device, seed: int) -> list:
    """The parameters after each update, on the host."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    model = init_params(create_model_from_config(
        mcfg, device=device, image_size=image), seed, device=device)
    state = create_train_state(model, make_optimizer(ocfg))
    step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(ocfg, 1, 1),
                           device=device, seed=seed)
    k = ocfg.grad_accum_steps
    snaps = []
    for i, b in enumerate(batches):
        state, _ = step(state, {n: v.to(device) for n, v in b.items()})
        if (i + 1) % k == 0:
            snaps.append([p.detach().cpu().clone()
                          for p in model.parameters()])
    return snaps


def _rel(a: list, b: list) -> float:
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def main(argv=None) -> int:
    from tpuic_torch.config import ModelConfig, OptimConfig
    from tpuic_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--image", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16,
                    help="micro-batch; the whole arm's batch is twice it")
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--updates", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mcfg = ModelConfig(name=args.model, num_classes=args.classes,
                       dtype="float32")
    base = OptimConfig(optimizer="lars", learning_rate=0.48,
                       weight_decay=1e-4, label_smoothing=0.1,
                       class_weights=(), milestones=())
    micro = _batches(2 * args.updates, args.batch, args.image, args.classes,
                     args.seed)
    whole = [{n: torch.cat([micro[2 * i][n], micro[2 * i + 1][n]])
              for n in micro[0]} for i in range(args.updates)]
    out = {"model": args.model, "image": args.image,
           "micro_batch": args.batch, "device": str(device)}
    for name, k, batches in (("accum", 2, micro), ("whole", 1, whole)):
        snaps = {}
        for arm, fused in (("fused", True), ("plain", False)):
            ocfg = dataclasses.replace(base, grad_accum_steps=k,
                                       fused_loss=fused,
                                       fused_optimizer=fused)
            snaps[arm] = _run(mcfg, ocfg, args.image, batches, device,
                              args.seed)
        rel = [_rel(a, b) for a, b in zip(snaps["fused"], snaps["plain"])]
        out[name] = {"update_rel_diff": rel,
                     "growth": [b / max(a, 1e-30)
                                for a, b in zip(rel, rel[1:])]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
