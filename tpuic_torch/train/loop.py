"""Epoch loop (``tpuic/train/loop.py``): ``Trainer`` on one device.

``Trainer(cfg, device=None)`` builds the train and val ``Loader``s, the
model (``create_model_from_config`` with flax's default initialisation
from ``cfg.run.seed``), the schedule, the optimizer, the train state and
the train/eval steps; ``fit()`` runs ``train_epoch`` then ``val_epoch``
per epoch and returns the best val accuracy.

- **Deferred metric reads.** The train step returns device tensors; the
  loop reads them once per ``log_every_steps`` and then the interval
  before the last (which the device has finished), never per step.
- **Numerics on the card.** The Trainer leaves PyTorch's defaults: cuDNN
  convolutions may use TF32 (``torch.backends.cudnn.allow_tf32`` is True
  by default) and matmuls run in full float32.  TF32 keeps about three
  decimal digits in the convolutions' products, as XLA's default
  precision does for float32 convolutions on a TPU.  A caller that wants
  full float32 sets both flags off around ``fit()``.
- **Validation** runs the eval forward, which goes through the K3 kernel
  when ``cfg.model.fused_conv_bn`` is set.
- **Checkpoints** (``tpuic_torch/checkpoint/manager.py``): the Trainer
  keeps ``best`` (on every val improvement) and ``latest`` (every
  ``run.save_period`` epochs) under ``{run.ckpt_dir}/{model name}``,
  beside the ``config.json`` and ``class_to_idx.json`` sidecars.  With
  ``run.resume`` it restores the newest track through the integrity ladder
  and ``fit()`` starts at the epoch after it, so a resumed run continues
  the uninterrupted one bit for bit (the batches and their augmentation
  are functions of the seed, the epoch and the index).
- ``self.stats`` keeps host-side timing of the last epoch: steps, wall
  seconds, seconds spent waiting for the loader, and ``drains``, the
  (step, host time) at which each deferred read returned: the device had
  finished that step then.

The model is built for ``data.resize_size`` images (the ViT's position
embedding depends on it) with ``model.attention``: a ViT trains through
the K4 flash-attention kernels with ``attention="flash"``.

- **Compute dtype** (``tpuic/train/loop.py:86-98``): a
  ``model.compute_dtype`` policy forces the model's ``dtype`` (``bf16``
  -> bfloat16, ``f32`` -> float32); without one, ``model.dtype`` rules,
  and its default is the reference's bfloat16.  Parameters, optimizer
  moments and checkpoints stay float32 (``train/step.py``).

Not ported, and refused with ``NotImplementedError`` naming the field:
mixup, CutMix, random erasing, EMA, ``freeze_backbone``, gradient
accumulation, ``remat``, the packed loader (``pack``), the native decode
core (``native``), mesh axes above 1 and EfficientNet training (its
stochastic depth needs the step's RNG plumbing, ROADMAP §1 item 8).  The
ViT family trains in bf16 as the others do: its flash attention runs K4's
bf16 kernels forward and backward.
The ViT itself refuses drop-path and the sequence-parallel attention
impls the same way.
Mid-epoch (preemption) saves, rollback, elastic membership, telemetry and
profiling are later items.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from tpuic_torch.checkpoint import CheckpointManager, init_params
from tpuic_torch.config import Config, resolve_compute_dtype
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.pipeline import Loader
from tpuic_torch.device import resolve_device
from tpuic_torch.metrics.meters import AverageMeter
from tpuic_torch.models import create_model_from_config
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_eval_step, make_train_step


def resolved_model_dtype(m) -> str:
    """The model's compute dtype after the ``compute_dtype`` policy."""
    policy = resolve_compute_dtype(m)
    if policy:
        return "bfloat16" if policy == "bf16" else "float32"
    return m.dtype


def unported_settings(cfg: Config) -> list:
    """``Config`` fields set to a feature the port does not have yet."""
    o, m, d, mesh = cfg.optim, cfg.model, cfg.data, cfg.mesh
    checks = [
        ("optim.mixup_alpha", o.mixup_alpha > 0),
        ("optim.cutmix_alpha", o.cutmix_alpha > 0),
        ("optim.random_erase", o.random_erase > 0),
        ("optim.ema_decay", o.ema_decay > 0),
        ("optim.freeze_backbone", o.freeze_backbone),
        ("optim.grad_accum_steps", o.grad_accum_steps > 1),
        ("model.name: EfficientNet training (stochastic depth needs the "
         "step's RNG plumbing, ROADMAP §1 item 8)",
         m.name.startswith("efficientnet")),
        ("model.remat", m.remat),
        ("data.pack", d.pack),
        ("data.native", d.native),
        ("mesh.data", mesh.data > 1),
        ("mesh.seq", mesh.seq > 1),
        ("mesh.model", mesh.model > 1),
        ("mesh.fsdp", mesh.fsdp),
        ("mesh.zero1", mesh.zero1),
        ("run.init_from", bool(cfg.run.init_from)),
    ]
    return [name for name, on in checks if on]


class Trainer:
    def __init__(self, cfg: Config, device=None,
                 log: Callable[[str], None] = print) -> None:
        bad = unported_settings(cfg)
        if bad:
            raise NotImplementedError(
                f"not yet ported to tpuic_torch: {', '.join(bad)}")
        self.device = resolve_device(device)
        self.log = log
        d = cfg.data
        self.train_ds = ImageFolderDataset(d.data_dir, "train", d.resize_size,
                                           d)
        self.val_ds = ImageFolderDataset(d.data_dir, "val", d.resize_size, d,
                                         class_to_idx=self.train_ds.class_to_idx)
        self.train_loader = Loader(self.train_ds, d.batch_size,
                                   seed=d.shuffle_seed,
                                   num_workers=d.num_workers,
                                   prefetch=d.prefetch, drop_last=True,
                                   augment=None if d.augment else False,
                                   device=self.device)
        if self.train_loader.steps_per_epoch() == 0:
            raise ValueError(
                f"train fold has {len(self.train_ds)} images but the batch "
                f"is {d.batch_size}: every epoch would train zero steps "
                "(the partial batch is dropped)")
        self.val_loader = Loader(self.val_ds, d.resolved_val_batch_size(),
                                 shuffle=False, num_workers=d.num_workers,
                                 prefetch=d.prefetch, device=self.device)
        num_classes = cfg.model.num_classes or self.train_ds.num_classes
        mcfg = dataclasses.replace(cfg.model, num_classes=num_classes,
                                   dtype=resolved_model_dtype(cfg.model))
        if cfg.optim.auto_class_weights:
            counts = self.train_ds.class_counts()
            if len(counts) > num_classes:
                raise ValueError(f"auto class weights: train fold has "
                                 f"{len(counts)} classes but the model head "
                                 f"is {num_classes} wide")
            counts = np.concatenate(
                [counts, np.zeros(num_classes - len(counts), np.int64)])
            w = np.ones(num_classes, np.float64)
            present = counts > 0
            w[present] = counts.sum() / (present.sum() * counts[present])
            cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
                cfg.optim, class_weights=tuple(round(float(x), 6)
                                               for x in w)))
        self.cfg, self.mcfg = cfg, mcfg
        self.model = init_params(
            create_model_from_config(mcfg, device=self.device,
                                     image_size=d.resize_size),
            cfg.run.seed, device=self.device)
        steps = max(1, self.train_loader.steps_per_epoch())
        self.schedule = make_schedule(cfg.optim, steps, cfg.run.epochs,
                                      global_batch=d.batch_size)
        tx = make_optimizer(cfg.optim, steps, cfg.run.epochs,
                            global_batch=d.batch_size)
        self.state = create_train_state(self.model, tx)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"[model] {mcfg.name}: {n_params / 1e6:.1f}M params, "
                 f"{num_classes} classes, batch {d.batch_size}, "
                 f"optimizer {tx.kind}, on {self.device}, {mcfg.dtype} "
                 "compute")
        self.train_step = make_train_step(cfg.optim, mcfg,
                                          lr_schedule=self.schedule,
                                          device=self.device)
        self.eval_step = make_eval_step(cfg.optim, mcfg, device=self.device)
        self.ckpt = CheckpointManager(cfg.run.ckpt_dir, mcfg.name,
                                      cfg.run.save_period,
                                      async_commit=cfg.run.async_checkpoint,
                                      log=self.log)
        # Sidecars: the resolved config (inferred class count, derived
        # class weights) and the class names, for loading and serving.
        with open(os.path.join(self.ckpt.root, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(dataclasses.replace(cfg, model=mcfg)),
                      f, indent=2, default=str)
        with open(os.path.join(self.ckpt.root, "class_to_idx.json"),
                  "w") as f:
            json.dump(self.train_ds.class_to_idx, f, indent=2)
        self.start_epoch = 0
        self.best_score = 0.0
        if cfg.run.resume:
            # The newest of latest and best: a crash after the last val
            # improvement resumes at the last periodic save.
            self.state, self.start_epoch, self.best_score = \
                self.ckpt.restore_into(self.state)
            if self.ckpt.last_restore_step_in_epoch is not None:
                self.log(f"[ckpt] a mid-epoch save: epoch "
                         f"{self.start_epoch} replays from its first step "
                         "(step-exact resume is not ported)")
        self.stats = {}
        self._steps_done = 0
        self._steps_exhausted = False

    def _drain(self, pending, losses: AverageMeter, epoch: int) -> None:
        """Read one deferred log interval back to the host and print it."""
        step_num, handles = pending
        vals = {k: float(v) for k, v in handles.items()}
        # The read returns once the device has finished step ``step_num``.
        self._drains.append((step_num, time.perf_counter()))
        losses.update(vals["loss"], 1)
        msg = (f"Epoch: {epoch}; step {step_num}; Loss {losses.val:.4f}|"
               f"({losses.avg:.4f}); acc {vals['accuracy']:.4f}; "
               f"lr {vals.get('lr', 0.0):.6g}")
        if vals.get("skip_count"):
            msg += f"; skipped streak {int(vals['skip_count'])}"
        self.log(msg)

    def train_epoch(self, epoch: int) -> float:
        """Reference train_epoch (train.py:36-73): the mean of the logged
        losses.  Honours ``run.max_steps``."""
        losses = AverageMeter()
        self._drains = []
        log_every = max(1, self.cfg.run.log_every_steps)
        n_steps = len(self.train_loader)
        pending = None
        metrics = None
        wait = 0.0
        t0 = time.perf_counter()
        it = iter(self.train_loader.epoch(epoch))
        step = 0
        while True:
            tw = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - tw
            if batch is None:
                break
            self.state, metrics = self.train_step(
                self.state, {k: batch[k] for k in ("image", "label", "mask")})
            step += 1
            self._steps_done += 1
            if step % log_every == 0 or step == n_steps:
                handles = {k: metrics[k] for k in
                           ("loss", "accuracy", "lr", "skip_count")
                           if k in metrics}
                if pending is not None:
                    self._drain(pending, losses, epoch)
                pending = (self._steps_done, handles)
            max_steps = self.cfg.run.max_steps
            if max_steps and self._steps_done >= max_steps:
                self._steps_exhausted = True
                break
        it.close()
        if metrics is not None and (pending is None
                                    or pending[0] != self._steps_done):
            if pending is not None:
                self._drain(pending, losses, epoch)
            pending = (self._steps_done, {"loss": metrics["loss"],
                                          "accuracy": metrics["accuracy"]})
        if pending is not None:
            self._drain(pending, losses, epoch)
        self.stats = {"steps": step, "wall_s": time.perf_counter() - t0,
                      "data_wait_s": wait, "drains": self._drains}
        return losses.avg

    def val_epoch(self, epoch: int) -> float:
        """Reference val_epoch (train.py:78-97): exact val accuracy x100 and
        the exact weighted val CE, from per-batch device sums read once at
        the end."""
        sums = None
        for batch in self.val_loader.epoch(epoch):
            m = self.eval_step(self.state, {k: batch[k] for k in
                                            ("image", "label", "mask")})
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        vals = {k: float(v) for k, v in sums.items()}
        score = 100.0 * vals["correct"] / max(vals["count"], 1.0)
        val_loss = vals["loss_num"] / max(vals["loss_den"], 1e-12)
        top5 = ""
        if "correct5" in vals:
            top5 = (f"; Top-5 "
                    f"{100.0 * vals['correct5'] / max(vals['count'], 1.0):.4f}")
        self.log(f"Epoch: {epoch}; Val Accuracy {score:.4f}{top5}; "
                 f"Val Loss {val_loss:.4f}")
        self.last_val = {"accuracy": score, "loss": val_loss, **vals}
        return score

    def fit(self, epochs: Optional[int] = None) -> float:
        """Train from ``start_epoch`` up to ``epochs`` (default
        ``run.epochs``), each epoch followed by a val pass and the
        checkpoint saves (``best`` on an improvement, ``latest`` every
        ``save_period`` epochs), and return the best val accuracy.  A
        ``max_steps`` budget reached mid-run stops before that epoch's val
        pass.  Every save has committed when ``fit`` returns."""
        epochs = self.cfg.run.epochs if epochs is None else epochs
        best = self.best_score
        self._steps_exhausted = False
        try:
            for epoch in range(self.start_epoch, epochs):
                t0 = time.perf_counter()
                self.train_epoch(epoch)
                if self._steps_exhausted:
                    self.log(f"[tpuic_torch] step budget "
                             f"({self.cfg.run.max_steps}) reached in epoch "
                             f"{epoch}; stopping")
                    break
                score = self.val_epoch(epoch)
                self.log(f"Epoch {epoch} took "
                         f"{time.perf_counter() - t0:.1f}s")
                if score > best:
                    best = score
                    self.ckpt.save_best(self.state, epoch, best)
                self.ckpt.maybe_save_latest(self.state, epoch, best)
        finally:
            # A save staged in the last epoch commits on every exit path.
            self.ckpt.wait()
        self.best_score = best
        return best

