"""CLI entry point of the port's training: ``python -m tpuic_torch.train``.

The counterpart of the repo's ``train.py``, with the same flag names for
what the port supports, plus ``--device`` (default: the card; ``cpu``
runs on the CPU).  Every other ``train.py`` flag is accepted by the
parser and, when set, exits with "not yet ported".  Like ``train.py``,
the defaults are the reference's (InceptionV3 with its aux head at 299
px, bfloat16 compute, Adam at 0.5e-5, MultiStepLR [50, 80], batch 4, the
reference's 7 class weights), and they run as they are::

  python -m tpuic_torch.train --datadir /data/folder

Other recipes name what they change, e.g.::

  python -m tpuic_torch.train --datadir /data/imagenet --model resnet50 \\
      --resize 224 --batchsize 128 --num-classes 1000 --optimizer lars \\
      --lr 4.8 --weight-decay 1e-4 --warmup-epochs 5 --epochs 90 \\
      --label-smoothing 0.1 --no-class-weights --milestones \\
      --fused-loss --fused-optimizer --dtype float32

ViT-B/16 through the flash-attention kernels (recipes/README.md, section
4: mixup, CutMix, random erasing, drop-path and EMA)::

  python -m tpuic_torch.train --datadir /data/imagenet --model vit-b16 \\
      --attention flash --resize 224 --batchsize 64 --epochs 300 \\
      --optimizer adam --lr 3e-4 --weight-decay 0.05 --warmup-epochs 10 \\
      --label-smoothing 0.1 --mixup 0.2 --cutmix 1.0 --random-erase 0.25 \\
      --drop-path 0.1 --clip-grad-norm 1.0 --ema-decay 0.9999 \\
      --no-class-weights --fused-loss

EfficientNet-B0 (section 3; stochastic depth 0.2 always, as in
``tpuic``)::

  python -m tpuic_torch.train --datadir /data/imagenet \\
      --model efficientnet-b0 --resize 224 --batchsize 128 --epochs 350 \\
      --optimizer sgd --lr 0.4 --no-class-weights

``--grad-accum-steps K`` accumulates K micro-steps' gradients before one
update (section 5 reaches a global batch of 4096 that way),
``--freeze-backbone`` trains the head alone, and ``--remat
[--remat-policy dots|attention|blocks|gelu]`` recomputes activations in
the backward.

The data path is ``tpuic``'s default: each fold is decoded once (the
native C++ core, or PIL where it does not build) into a uint8 cache
under ``--cache-dir`` (``{datadir}/.tpuic_pack``), and the augmentation
and normalisation run on the device.  A packed dataset within
``--device-cache-mb`` (4096 MiB) stays on the device, and a batch ships
its indices; a larger one (ImageNet-1k at 224 px is 193 GB) streams its
uint8 rows, a quarter of the float32 bytes.  ``--no-pack`` decodes every
epoch on host threads, ``--no-native`` with PIL and NumPy, and
``--no-quarantine`` lets a file that does not decode abort the run.

Data parallel, one process a card (the reference's ``python -m
torch.distributed.launch --nproc_per_node=4 train.py``): start one process
per card with the ``TPUIC_COORDINATOR_ADDRESS`` / ``TPUIC_NUM_PROCESSES``
/ ``TPUIC_PROCESS_ID`` trio that ``tpuic``'s ``train.py`` reads, and the
same flags.  ``--batchsize`` is per process (the global batch is it times
the processes, as in ``tpuic``); process 0 alone logs and writes the
checkpoints.  Two processes on two cards::

  for r in 0 1; do
    TPUIC_COORDINATOR_ADDRESS=localhost:29500 TPUIC_NUM_PROCESSES=2 \\
    TPUIC_PROCESS_ID=$r python -m tpuic_torch.train --datadir D \\
        --model resnet50 --resize 224 --batchsize 64 ... &
  done; wait

Each process joins NCCL on ``cuda:{rank % cards}``; with ``--device cpu``
they join gloo on the CPU instead.

Failures (``tpuic``'s exit-code contract, ``runtime/supervisor.py``):
SIGTERM latches; the run finishes its step, flushes a step-exact
``latest`` (no val pass) and exits 43, and the same command resumes at
that step and ends on the uninterrupted run's weights.  A streak of
``--skip-threshold`` (10) non-finite steps, which the step's guard skips,
rolls back to the last good checkpoint and goes on, the LR re-warming over
``--rewarm-steps`` when set (``--no-rollback`` keeps skipping); a rollback
past ``max_rollbacks`` (3), or with no checkpoint, exits 44.
``--init-from`` starts from a reference torch checkpoint (a
torchvision-layout ``state_dict``, merged leniently).  ``TPUIC_FAULTS`` is
parsed at start (``runtime/faults.py``): a spec that does not parse, or
that arms a point the training path does not fire (``rank_rejoin_flap``,
which needs elastic membership, ROADMAP §1 item 13), exits naming it::

  TPUIC_FAULTS=sigterm@5 python -m tpuic_torch.train ... ; echo $?  # 43
  python -m tpuic_torch.train ...   # "resuming epoch 0 at step 5"

Under ``python -m tpuic_torch.supervise`` (``--gang N`` for N processes)
the run writes the supervisor's heartbeat from its step events, installs
the flight recorder and the stack dump on SIGQUIT, and a restart resumes
from the latest checkpoint (capped at ``TPUIC_RESUME_STEP`` in a gang).

Telemetry (``tpuic_torch/telemetry``): ``--metrics-jsonl`` writes every
bus event (step breakdowns, epochs, evals, checkpoint commits, memory
samples, goodput reports), ``--trace-dir`` with ``--trace-threshold``
and ``--trace-steps`` opens ``torch.profiler`` windows on slow steps,
``--trace-analyze`` turns each into the kernel-class waterfall,
``--prom-dump`` writes the train Prometheus exposition, ``--slo`` tracks
``train_step`` objectives and ``--profile-dir`` traces the first epoch.
Each profiler session tears CUPTI down when it stops (``TEARDOWN_CUPTI``
defaults to 1), so the steps after a window run at full speed::

  python -m tpuic_torch.train --datadir D --model vit-s16-moe --resize 224 \\
      --attention flash --fused-loss --optimizer lamb --fused-optimizer \\
      --drop-path 0.1 --metrics-jsonl run/events.jsonl --trace-dir run/tr \\
      --trace-analyze --prom-dump run/train.prom --slo 'train_step:p99<=500ms'
"""

from __future__ import annotations

import argparse
import os
import sys

from tpuic_torch.config import (ATTENTION_IMPLS, Config, DataConfig,
                                MeshConfig, ModelConfig, OptimConfig,
                                RunConfig)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpuic_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datadir", required=True,
                   help="ImageFolder root with train/ and val/")
    p.add_argument("--batchsize", type=int, default=4,
                   help="train batch size (reference default 4)")
    p.add_argument("--local_rank", type=int, default=0,
                   help="accepted for launch-command compatibility; unused")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on "
                        "the CPU)")
    p.add_argument("--model", default="inceptionv3")
    p.add_argument("--num-classes", type=int, default=0,
                   help="0 = infer from the folder tree")
    p.add_argument("--resize", type=int, default=299)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.5e-5)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "lars", "lamb", "sgd"])
    p.add_argument("--milestones", type=int, nargs="*", default=[50, 80])
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip-grad-norm", type=float, default=0.0)
    p.add_argument("--mixup", type=float, default=0.0, metavar="ALPHA")
    p.add_argument("--cutmix", type=float, default=0.0, metavar="ALPHA")
    p.add_argument("--random-erase", type=float, default=0.0, metavar="P")
    p.add_argument("--warmup-epochs", type=int, default=0)
    p.add_argument("--base-batch", type=int, default=0, metavar="N")
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--class-weights", type=str, nargs="*",
                   default=["3", "3", "10", "1", "4", "4", "5"],
                   help="CE class weights, or 'auto' for inverse-frequency "
                        "weights from the train fold")
    p.add_argument("--no-class-weights", action="store_true")
    p.add_argument("--ckpt-dir", default="dtmodel/cp",
                   help="checkpoints go to {ckpt-dir}/{model}/best and "
                        "/latest")
    p.add_argument("--save-period", type=int, default=5,
                   help="save 'latest' every this many epochs")
    p.add_argument("--no-resume", action="store_true",
                   help="start fresh instead of restoring the newest "
                        "checkpoint")
    p.add_argument("--no-async-checkpoint", action="store_true",
                   help="commit each checkpoint before training goes on")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--val-batchsize", type=int, default=0)
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--log-every-steps", type=int, default=50)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--attention", default="dense",
                   choices=list(ATTENTION_IMPLS),
                   help="attention of ViT backbones: 'dense' or 'flash' (the "
                        "K4 kernels); the sequence-parallel impls are not "
                        "yet ported")
    p.add_argument("--fused-loss", action="store_true",
                   help="the fused weighted-CE kernel K1 "
                        "(tpuic_torch/kernels/cross_entropy.py)")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--no-native", action="store_true",
                   help="decode with PIL and augment with NumPy instead of "
                        "the native C++ core (the same PNG bits)")
    p.add_argument("--no-pack", action="store_true",
                   help="decode every epoch instead of packing each fold "
                        "once into a uint8 cache augmented on the device")
    p.add_argument("--cache-dir", default="",
                   help="where the packed folds go (default "
                        "{datadir}/.tpuic_pack)")
    p.add_argument("--device-cache-mb", type=int, default=4096,
                   help="keep a packed dataset that fits this budget (MiB "
                        "a process, train first, val the rest) resident "
                        "on the device; 0 streams every batch")
    p.add_argument("--no-quarantine", action="store_true",
                   help="let a sample that does not decode abort the run "
                        "instead of serving a same-class replacement")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="compute dtype of the model (parameters, optimizer "
                        "moments and checkpoints stay float32)")
    p.add_argument("--compute-dtype", default="", dest="compute_dtype",
                   choices=["", "bf16", "f32"],
                   help="training compute-dtype policy: 'bf16' casts the "
                        "batch to bfloat16 in the step and computes in bf16 "
                        "from float32 master weights; 'f32' forces float32; "
                        "'' leaves --dtype in charge")
    p.add_argument("--loss-scale", type=float, default=1.0,
                   help="static loss scaling (loss x N before backward, "
                        "grads / N after; 1.0 = off)")
    p.add_argument("--bn-bf16-stats", action="store_true",
                   help="accumulate BatchNorm batch statistics in the "
                        "compute dtype instead of float32 (ResNet family; "
                        "a bandwidth experiment)")
    p.add_argument("--fused-conv-bn", action="store_true",
                   help="validate through the fused conv+BN+ReLU kernel K3 "
                        "(ModelConfig.fused_conv_bn; ResNet family)")
    p.add_argument("--fused-optimizer", action="store_true",
                   help="the fused multi-tensor LARS/LAMB kernel K2 "
                        "(tpuic_torch/kernels/optimizer_update.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--seq-axis", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in the backward "
                        "(models/remat.py)")
    p.add_argument("--remat-policy", default="dots",
                   choices=["dots", "attention", "blocks", "gelu"],
                   help="what --remat recomputes: 'dots' all but the "
                        "matrix products' and convolutions' outputs; the "
                        "ViT's dense attention core, each encoder block, "
                        "or each mlp_up + GELU")
    p.add_argument("--drop-path", type=float, default=0.0,
                   help="stochastic-depth rate of a ViT's last block "
                        "(a linear ramp from 0)")
    p.add_argument("--no-skip-guard", action="store_true")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after this many optimizer steps (0 = no cap)")
    p.add_argument("--collect-misclassified", action="store_true",
                   help="name every misclassified val image each epoch "
                        "(gathered from every process)")
    p.add_argument("--per-class-metrics", action="store_true",
                   help="per-class val accuracy: the confusion matrix and "
                        "per_class.jsonl go under --log-dir")
    p.add_argument("--log-dir", default="",
                   help="metrics.jsonl, TensorBoard events (and the "
                        "per-class files) on process 0")
    # Telemetry (tpuic_torch/telemetry).
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler Chrome trace of the first epoch "
                        "under this dir")
    p.add_argument("--metrics-jsonl", default="",
                   help="telemetry event JSONL sink: per-step time "
                        "breakdown, skip/quarantine/checkpoint/compile/"
                        "memory events and the goodput reports")
    p.add_argument("--trace-dir", default="",
                   help="triggered torch.profiler windows land here when a "
                        "step regresses past --trace-threshold x the "
                        "rolling median (TPUIC_TRACE=dir forces one window "
                        "at once)")
    p.add_argument("--trace-threshold", type=float, default=3.0,
                   help="step-time regression multiple that opens a window "
                        "(0 disables the automatic trigger)")
    p.add_argument("--trace-steps", type=int, default=3,
                   help="steps each window covers")
    p.add_argument("--trace-analyze", action="store_true",
                   help="analyze each window into the per-op-class device "
                        "time waterfall ('profile' events; "
                        "device_time_ms{op_class} rows in --prom-dump)")
    p.add_argument("--prom-dump", default="",
                   help="write the train Prometheus exposition to this file "
                        "atomically at every goodput report")
    p.add_argument("--slo", default="",
                   help="step-time SLOs, a comma list of "
                        "'train_step:pQ<=Nms[@target]' specs")
    # Failures (runtime/preemption.py, the Trainer's rollback).
    p.add_argument("--init-from", default="",
                   help="start from this reference torch checkpoint "
                        "(a torchvision-layout state_dict, merged "
                        "leniently; a resumed checkpoint overrides it)")
    p.add_argument("--skip-threshold", type=int, default=10,
                   help="consecutive non-finite (skipped) steps before the "
                        "trainer rolls back to the last good checkpoint "
                        "(0 disables detection)")
    p.add_argument("--no-rollback", action="store_true",
                   help="never roll back on a non-finite streak (keep "
                        "skipping instead)")
    p.add_argument("--rewarm-steps", type=int, default=0,
                   help="after a rollback, ramp the LR linearly back to "
                        "its schedule over this many steps")
    return p


def _fail(msg: str):
    raise SystemExit(f"python -m tpuic_torch.train: error: {msg}")


def check_faults() -> None:
    """Parse ``TPUIC_FAULTS`` through ``runtime/faults.py`` and refuse,
    by name, a point the port's training path does not fire yet: a chaos
    spec must not be dropped without a word."""
    try:
        from tpuic_torch.runtime import faults
        faults.check_fired("train", os.environ.get("TPUIC_FAULTS"))
    except ValueError as e:
        _fail(str(e))


def config_from_args(args: argparse.Namespace,
                     parser: argparse.ArgumentParser) -> Config:
    check_faults()
    if args.slo:
        # A typo'd objective fails the command line, not the Trainer.
        from tpuic_torch.telemetry.slo import parse_objectives
        try:
            parse_objectives(args.slo, allowed=("train_step",))
        except ValueError as e:
            _fail(f"--slo: {e}")
    auto = (not args.no_class_weights and list(args.class_weights) == ["auto"])
    if args.no_class_weights or auto:
        weights = ()
    else:
        try:
            weights = tuple(float(w) for w in args.class_weights)
        except ValueError:
            _fail(f"--class-weights expects numbers or the single word "
                  f"'auto' (got {args.class_weights!r})")
    return Config(
        data=DataConfig(data_dir=args.datadir, resize_size=args.resize,
                        batch_size=args.batchsize, num_workers=args.workers,
                        val_batch_size=args.val_batchsize,
                        prefetch=args.prefetch, pack=not args.no_pack,
                        augment=not args.no_augment,
                        native=not args.no_native, cache_dir=args.cache_dir,
                        device_cache_mb=args.device_cache_mb,
                        quarantine=not args.no_quarantine),
        model=ModelConfig(name=args.model, num_classes=args.num_classes,
                          dtype=args.dtype, remat=args.remat,
                          remat_policy=args.remat_policy,
                          drop_path=args.drop_path,
                          attention=args.attention,
                          bn_f32_stats=not args.bn_bf16_stats,
                          fused_conv_bn=args.fused_conv_bn,
                          compute_dtype=args.compute_dtype),
        optim=OptimConfig(optimizer=args.optimizer, learning_rate=args.lr,
                          milestones=tuple(args.milestones), gamma=args.gamma,
                          class_weights=weights, auto_class_weights=auto,
                          weight_decay=args.weight_decay,
                          grad_clip_norm=args.clip_grad_norm,
                          mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
                          random_erase=args.random_erase,
                          warmup_epochs=args.warmup_epochs,
                          base_batch_size=args.base_batch,
                          grad_accum_steps=args.grad_accum_steps,
                          label_smoothing=args.label_smoothing,
                          ema_decay=args.ema_decay,
                          freeze_backbone=args.freeze_backbone,
                          fused_loss=args.fused_loss,
                          fused_optimizer=args.fused_optimizer,
                          loss_scale=args.loss_scale,
                          skip_nonfinite=not args.no_skip_guard),
        run=RunConfig(epochs=args.epochs, ckpt_dir=args.ckpt_dir,
                      save_period=args.save_period,
                      resume=not args.no_resume,
                      log_every_steps=args.log_every_steps, seed=args.seed,
                      max_steps=args.steps,
                      async_checkpoint=not args.no_async_checkpoint,
                      collect_misclassified=args.collect_misclassified,
                      per_class_metrics=args.per_class_metrics,
                      profile_dir=args.profile_dir,
                      metrics_jsonl=args.metrics_jsonl,
                      trace_dir=args.trace_dir,
                      trace_threshold=args.trace_threshold,
                      trace_steps=args.trace_steps,
                      trace_analyze=args.trace_analyze, slo=args.slo,
                      init_from=args.init_from,
                      skip_threshold=args.skip_threshold,
                      rollback=not args.no_rollback,
                      rollback_rewarm_steps=args.rewarm_steps),
        mesh=MeshConfig(model=args.model_axis, seq=args.seq_axis,
                        fsdp=args.fsdp, zero1=args.zero1),
    )


def _wire_prom_dump(trainer, path: str) -> None:
    """Rewrite the train exposition at ``path`` at every goodput report:
    one more host-side bus subscriber."""
    from tpuic_torch.telemetry.prom import train_exposition, write_exposition
    tm = trainer.telemetry

    def dump(ev) -> None:
        write_exposition(path, train_exposition(
            dict(ev.data), tm.steptime.summary(),
            heartbeat_age_s=(tm.heartbeat.age_s()
                             if tm.heartbeat is not None else None),
            slo=tm.slo.report() if tm.slo is not None else None,
            memory=tm.memory.snapshot(),
            profile=tm.profile.last if tm.profile is not None else None))

    tm.subscribe(dump, kinds=("goodput",))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = config_from_args(args, parser)
    from tpuic_torch.metrics.logging import host0_print
    from tpuic_torch.runtime.distributed import initialize, shutdown
    from tpuic_torch.runtime.supervisor import (ENV_HEARTBEAT_FILE,
                                                EXIT_POISON, EXIT_PREEMPTED,
                                                NonRetryableError,
                                                install_stack_dump_handler)
    from tpuic_torch.telemetry.flight import install_flight_recorder
    from tpuic_torch.train.loop import Trainer
    # Supervised liveness: the flight recorder's SIGQUIT dump first, the
    # faulthandler stack dump chained to it (the serve CLI's order).
    flight = install_flight_recorder()
    if flight is not None or os.environ.get(ENV_HEARTBEAT_FILE, ""):
        install_stack_dump_handler(chain=flight is not None)
    info = initialize(device=args.device)
    host0_print(f"[tpuic_torch] {info.process_count} process(es)")
    try:
        try:
            # Construction is in the poison scope too: a resume that finds
            # every checkpoint rung corrupt must not crash-loop.
            trainer = Trainer(cfg, device=args.device,
                              log_dir=args.log_dir or None)
        except NotImplementedError as e:
            _fail(str(e))
        except NonRetryableError as e:
            host0_print(f"[tpuic_torch] NON-RETRYABLE: {e}")
            return EXIT_POISON
        if args.prom_dump and info.process_index == 0:
            _wire_prom_dump(trainer, args.prom_dump)
        try:
            best = trainer.fit()
        except NonRetryableError as e:
            # A restart cannot fix it (rollbacks exhausted, no checkpoint
            # to roll back to): exit 44 so a supervisor reports.
            host0_print(f"[tpuic_torch] NON-RETRYABLE: {e}")
            return EXIT_POISON
        if cfg.run.handle_preemption and trainer.preemption.triggered:
            # The step-exact 'latest' is committed: exit 43, so that a
            # supervisor restarts with resume at once.
            host0_print(f"[tpuic_torch] preempted (flushed); best val "
                        f"accuracy {best:.4f}")
            return EXIT_PREEMPTED
        if trainer.telemetry.slo is not None:
            host0_print(f"[slo] {trainer.telemetry.slo.summary_line()}")
        host0_print(f"[tpuic_torch] done; best val accuracy {best:.4f}")
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
