"""CLI entry point of the port's training: ``python -m tpuic_torch.train``.

The counterpart of the repo's ``train.py``, with the same flag names for
what the port supports, plus ``--device`` (default: the card; ``cpu``
runs on the CPU).  Every other ``train.py`` flag is accepted by the
parser and, when set, exits with "not yet ported".  Like ``train.py``,
the defaults are the reference's (InceptionV3 with its aux head at 299
px, bfloat16 compute, Adam at 0.5e-5, MultiStepLR [50, 80], batch 4, the
reference's 7 class weights), and they run as they are::

  python -m tpuic_torch.train --datadir /data/folder --no-pack --no-native

Other recipes name what they change, e.g.::

  python -m tpuic_torch.train --datadir /data/imagenet --model resnet50 \\
      --resize 224 --batchsize 128 --num-classes 1000 --optimizer lars \\
      --lr 4.8 --weight-decay 1e-4 --warmup-epochs 5 --epochs 90 \\
      --label-smoothing 0.1 --no-class-weights --milestones \\
      --fused-loss --fused-optimizer --dtype float32 --no-pack --no-native

ViT-B/16 through the flash-attention kernels (recipes/README.md, section
4, without mixup, CutMix, random erasing, drop-path and EMA, which are not
ported)::

  python -m tpuic_torch.train --datadir /data/imagenet --model vit-b16 \\
      --attention flash --resize 224 --batchsize 64 --epochs 300 \\
      --optimizer adam --lr 3e-4 --weight-decay 0.05 --warmup-epochs 10 \\
      --label-smoothing 0.1 --clip-grad-norm 1.0 --no-class-weights \\
      --fused-loss --dtype float32 --no-pack --no-native
"""

from __future__ import annotations

import argparse
import sys

from tpuic_torch.config import (ATTENTION_IMPLS, Config, DataConfig,
                                MeshConfig, ModelConfig, OptimConfig,
                                RunConfig)

# train.py flags whose features are not ported: (flag, argparse kwargs).
_NOT_PORTED = (
    ("--init-from", dict(default="")),
    ("--device-cache-mb", dict(type=int, default=4096)),
    ("--cache-dir", dict(default="")),
    ("--collect-misclassified", dict(action="store_true")),
    ("--per-class-metrics", dict(action="store_true")),
    ("--remat-policy", dict(default="dots")),
    ("--drop-path", dict(type=float, default=0.0)),
    ("--profile-dir", dict(default="")),
    ("--log-dir", dict(default="")),
    ("--skip-threshold", dict(type=int, default=10)),
    ("--no-rollback", dict(action="store_true")),
    ("--rewarm-steps", dict(type=int, default=0)),
    ("--no-quarantine", dict(action="store_true")),
    ("--metrics-jsonl", dict(default="")),
    ("--trace-dir", dict(default="")),
    ("--trace-threshold", dict(type=float, default=3.0)),
    ("--trace-steps", dict(type=int, default=3)),
    ("--trace-analyze", dict(action="store_true")),
    ("--prom-dump", dict(default="")),
    ("--slo", dict(default="")),
)


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
                   help="required: the native decode core is not ported")
    p.add_argument("--no-pack", action="store_true",
                   help="required: the packed loader is not ported")
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
    p.add_argument("--fused-optimizer", action="store_true",
                   help="the fused multi-tensor LARS/LAMB kernel K2 "
                        "(tpuic_torch/kernels/optimizer_update.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--seq-axis", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no-skip-guard", action="store_true")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after this many optimizer steps (0 = no cap)")
    for flag, kw in _NOT_PORTED:
        p.add_argument(flag, help="not yet ported to tpuic_torch", **kw)
    return p


def _fail(msg: str):
    raise SystemExit(f"python -m tpuic_torch.train: error: {msg}")


def config_from_args(args: argparse.Namespace,
                     parser: argparse.ArgumentParser) -> Config:
    for flag, _ in _NOT_PORTED:
        dest = flag.lstrip("-").replace("-", "_")
        if getattr(args, dest) != parser.get_default(dest):
            _fail(f"{flag}: not yet ported to tpuic_torch")
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
                        native=not args.no_native),
        model=ModelConfig(name=args.model, num_classes=args.num_classes,
                          dtype=args.dtype, remat=args.remat,
                          attention=args.attention,
                          bn_f32_stats=not args.bn_bf16_stats,
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
                      async_checkpoint=not args.no_async_checkpoint),
        mesh=MeshConfig(model=args.model_axis, seq=args.seq_axis,
                        fsdp=args.fsdp, zero1=args.zero1),
    )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = config_from_args(args, parser)
    from tpuic_torch.train.loop import Trainer
    try:
        trainer = Trainer(cfg, device=args.device)
    except NotImplementedError as e:
        _fail(str(e))
    best = trainer.fit()
    print(f"[tpuic_torch] done; best val accuracy {best:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
