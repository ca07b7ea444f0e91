"""Epoch loop (``tpuic/train/loop.py``): ``Trainer`` on one card, or on
one card per process of a process group.

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
- **Data parallel** (``tpuic/train/loop.py:276-314``): in a process
  group (``tpuic_torch.runtime.distributed.initialize``) of N processes
  the global batch is ``data.batch_size x N``; each process loads its
  shard of it (``data/pipeline.py``) and the train step is data-parallel
  (``train/step.py``).  ``mesh.data`` must be 0 (all processes) or N.
  Process 0 alone logs (``host0_print``), writes ``log_dir``'s
  ``metrics.jsonl`` (``metrics/logging.py``) and the checkpoints and
  their sidecars; every process restores the same track on resume.
- **Validation counts are global**: each process sums its shard's
  ``correct``, ``count``, ``loss_num`` and ``loss_den`` on the device
  and one all-reduce a val pass adds them up.  ``run.collect_misclassified``
  names every misclassified val image on every process: the per-row
  ``wrong`` vectors of the pass go through one ``all_gather`` and map to
  image ids through the global order (``batch.indices``), as ``tpuic``'s
  replicated ``wrong`` does (``tpuic/train/loop.py:817-905``).
  ``run.per_class_metrics`` all-reduces the [C, C] confusion matrix and
  logs ``val_balanced_acc`` and ``val_worst_class_acc``, and writes
  ``confusion_e{epoch}.npy`` and ``per_class.jsonl`` under the logger's
  root.
- ``self.stats`` keeps host-side timing of the last epoch: steps, wall
  seconds, seconds spent waiting for the loader (and for its first batch
  alone, which includes the loader's start), and ``drains``, the
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

- **The recipe features** (ROADMAP §1 item 8): mixup, CutMix, random
  erasing, drop-path and EfficientNet's stochastic depth draw from the
  train step's generator, reseeded from ``(run.seed, step)`` where
  ``step`` is the global micro-step ``epoch * steps_per_epoch + i``
  (``train/step.py``, ``train/augment.py``); parameter EMA
  (``optim.ema_decay``) is what the val pass scores and so what picks
  ``best`` (``TrainState.inference_weights``, whose folds K3 rebuilds
  from the EMA weights at every pass), and the checkpoints carry it;
  gradient accumulation, ``freeze_backbone`` and ``remat`` are the
  optimizer's and the model's (``train/optimizer.py``,
  ``models/remat.py``).  Every model family trains, EfficientNet
  included, in float32 and bf16.

- **The packed data path** (``tpuic/train/loop.py:69-81``, ``:275-314``;
  ``data.pack``, the default): both folds are packed once into
  ``data.cache_dir`` (``{data_dir}/.tpuic_pack`` by default) and every
  epoch is served from the cache, augmented and normalised on the
  device; the device-cache budget (``data.device_cache_mb``) is a
  per-process total, which the train loader claims first and the val
  loader gets the rest of.  Process 0 logs which decoder packed each
  fold and, when the native core did not build, the compiler's first
  error line.  A sample that does not decode is quarantined
  (``data/folder.py``), and each epoch that served replacements logs a
  ``[quarantine]`` line.

- **Telemetry** (``tpuic/train/loop.py:566-570``, ``:728``, ``:1098``,
  ``:1209-1234``; ``telemetry/wiring.py``): the loop publishes ``step``
  (the ``StepTimer``'s data / dispatch / device breakdown), ``drain``,
  ``skip``, ``epoch``, ``eval`` and ``goodput`` events (one a val pass
  and a final one) on the process-global bus, which the run's
  ``TrainTelemetry`` turns into the metrics JSONL, memory samples,
  goodput and MFU, SLOs and triggered ``torch.profiler`` windows.
  Everything it adds is ``perf_counter`` arithmetic and bus callbacks:
  no host sync and no device work.  ``run.profile_dir`` traces the first
  epoch with ``torch.profiler`` (a Chrome trace under
  ``{profile_dir}/epoch{e}``).

- **Preemption** (``tpuic/train/loop.py:169-175``, ``:593-617``,
  ``:1169-1195``; ``run.handle_preemption``): ``fit`` installs a SIGTERM
  latch (``runtime/preemption.py``; it chains to the handler that was
  there) for its span.  The step loop polls it before each step; with
  several processes it acts only on ``agree()``, a collective, every 16
  steps and at the epoch's end, so every process stops at the same step.
  A latched run skips the pending val pass and flushes ``latest`` with
  ``step_in_epoch`` (the steps done) and the loader geometry, committed
  before ``fit`` returns; the train CLI then exits 43.  A resume
  (``__init__``) continues that epoch at that step (``start_step``):
  the loader skips the done batches (``Loader.epoch(e, start_step)``)
  and the step's draws keep their global index, so the run ends on the
  uninterrupted run's bits.  A geometry that differs, or an offset past
  the epoch, replays the epoch from its start, with ``tpuic``'s
  messages.  A flush at the epoch's last step resumes into the pending
  val pass.
- **Rollback** (``tpuic/train/loop.py:774-814``, ``:915-995``): the
  deferred drain reads the step guard's ``skip_count``; at
  ``run.skip_threshold`` consecutive skipped steps (with
  ``run.rollback``) the epoch stops and ``fit`` restores the last good
  checkpoint through ``restore_into`` (after ``ckpt.wait()``), resets the
  streak and goes on from the restored epoch and step.  With
  ``run.rollback_rewarm_steps`` the LR re-enters its schedule on a
  linear ramp (``rewarm_scale`` composed onto the pristine schedule, in
  the optimizer and in the logged ``lr``).  More than
  ``run.max_rollbacks`` rollbacks, or a streak before any checkpoint,
  raises ``NonRetryableError`` (the train CLI exits 44).
- **Step numbers** are global and count every step run, a skipped one
  too.  Each save records the count (``loop_step``), and a resume or a
  rollback goes on from the restored one (from ``state.step``, the
  applied steps, for a checkpoint without it), so the log, the
  heartbeat, ``max_steps`` and the fault points name the same steps in
  a resumed run as in the uninterrupted one.  (``tpuic`` reads
  ``state.step`` at each epoch's start instead, so after a skipped step
  its numbers there fall behind the steps run.)
- **Fault points** (``runtime/faults.py``): ``sigterm``, ``nan_batch``
  (the prepared float images times NaN, on the device), ``slow_step``,
  ``hard_crash``, ``hang_step``, ``rank_crash`` and ``rank_hang`` (on
  the rank ``TPUIC_FLEET_RANK`` names, else the process index) fire at
  the step whose global number they name.
- ``run.init_from`` merges a reference torch checkpoint into the fresh
  weights (``checkpoint/torch_convert.init_from_torch``) before a
  resume, and reseeds the EMA there.  Under ``python -m
  tpuic_torch.supervise`` a restarted run publishes a ``restart`` event
  with its downtime and the supervisor's ``TPUIC_RESUME_STEP`` cap.
- **Events** of the failure story: ``preempt`` once the flush has
  committed (its ``flush_s`` from the signal), ``rollback`` (with
  whether the skipped steps left the parameters finite and the applied
  steps before the restore), and ``kernel_launches`` as ``fit`` returns:
  each counted kernel's launches in its span.

Not ported, and refused with ``NotImplementedError`` naming the field:
the ``seq`` and ``model`` axes above 1, ``fsdp`` and ``zero1`` (ROADMAP
§1 item 12).  The ViT refuses the sequence-parallel attention impls the
same way.  Elastic membership is item 13.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuic_torch.checkpoint import CheckpointManager, init_params
from tpuic_torch.config import Config, resolve_compute_dtype
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.pack import pack_folds
from tpuic_torch.data.pipeline import Loader
from tpuic_torch.device import resolve_device
from tpuic_torch.kernels import counted_kernels
from tpuic_torch.metrics.logging import MetricLogger, host0_print
from tpuic_torch.metrics.meters import AverageMeter
from tpuic_torch.models import create_model_from_config
from tpuic_torch.runtime import distributed, faults
from tpuic_torch.runtime.preemption import PreemptionGuard, agree
from tpuic_torch.runtime.supervisor import (ENV_RESUME_STEP,
                                            NonRetryableError, restart_info)
from tpuic_torch.telemetry.events import publish
from tpuic_torch.train.optimizer import (make_optimizer, make_schedule,
                                         rewarm_scale)
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
    mesh = cfg.mesh
    checks = [
        ("mesh.seq", mesh.seq > 1),
        ("mesh.model", mesh.model > 1),
        ("mesh.fsdp", mesh.fsdp),
        ("mesh.zero1", mesh.zero1),
    ]
    return [name for name, on in checks if on]


def _silent(msg: str) -> None:
    pass


#: Steps between two ``agree`` calls of the step loop with several
#: processes: well inside any grace window.
PREEMPT_SYNC = 16


def fleet_rank(default: int) -> int:
    """The rank the rank-targeted fault points name: ``TPUIC_FLEET_RANK``
    (the gang supervisor's), else ``default`` (the process index)."""
    from tpuic_torch.telemetry.fleet import ENV_FLEET_RANK
    return int(os.environ.get(ENV_FLEET_RANK, default))


def loader_mode(loader) -> str:
    """How a loader feeds its device, for the log."""
    if loader.resident:
        return f"resident ({loader.resident_bytes / 1e6:.2f} MB)"
    return "streaming" if loader.packed else "decode"


class Trainer:
    def __init__(self, cfg: Config, device=None,
                 log: Optional[Callable[[str], None]] = None,
                 log_dir: Optional[str] = None) -> None:
        """``log`` (default ``host0_print``) takes process 0's console
        lines; ``log_dir`` turns on ``MetricLogger`` there (``tpuic``'s
        ``Trainer(cfg, log_dir=...)``)."""
        bad = unported_settings(cfg)
        if bad:
            raise NotImplementedError(
                f"not yet ported to tpuic_torch: {', '.join(bad)}")
        self.rank = distributed.process_index()
        self.world = distributed.process_count()
        if cfg.mesh.data not in (0, self.world):
            raise ValueError(
                f"mesh.data is {cfg.mesh.data} but {self.world} process(es) "
                "train: the data axis is one process a card (0 = all)")
        self.device = resolve_device(device)
        self.log = (log or host0_print) if self.rank == 0 else _silent
        self.logger = MetricLogger(log_dir)
        d = cfg.data
        global_batch = d.batch_size * self.world
        shard = dict(process_index=self.rank, process_count=self.world)
        self.train_ds = ImageFolderDataset(d.data_dir, "train", d.resize_size,
                                           d)
        self.val_ds = ImageFolderDataset(d.data_dir, "val", d.resize_size, d,
                                         class_to_idx=self.train_ds.class_to_idx)
        if d.pack:
            self.train_ds, self.val_ds = pack_folds(
                (self.train_ds, self.val_ds), d, self.log)
        cache_total = int(d.device_cache_mb) << 20
        self.train_loader = Loader(self.train_ds, global_batch,
                                   seed=d.shuffle_seed,
                                   num_workers=d.num_workers,
                                   prefetch=d.prefetch, drop_last=True,
                                   augment=None if d.augment else False,
                                   device=self.device,
                                   device_cache_bytes=cache_total, **shard)
        if self.train_loader.steps_per_epoch() == 0:
            raise ValueError(
                f"train fold has {len(self.train_ds)} images but the "
                f"global batch is {global_batch} ({d.batch_size} x "
                f"{self.world} processes): every epoch would train zero "
                "steps (the partial batch is dropped)")
        self.val_loader = Loader(self.val_ds,
                                 d.resolved_val_batch_size() * self.world,
                                 shuffle=False, num_workers=d.num_workers,
                                 prefetch=d.prefetch, device=self.device,
                                 device_cache_bytes=max(
                                     0, cache_total
                                     - self.train_loader.resident_bytes),
                                 **shard)
        if d.pack:
            self.log("[data] " + ", ".join(
                f"{fold} {loader_mode(ld)}" for fold, ld in
                (("train", self.train_loader), ("val", self.val_loader))))
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
                                      global_batch=global_batch)
        tx = make_optimizer(cfg.optim, steps, cfg.run.epochs,
                            global_batch=global_batch)
        self.state = create_train_state(self.model, tx,
                                        ema=cfg.optim.ema_decay > 0)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"[model] {mcfg.name}: {n_params / 1e6:.1f}M params, "
                 f"{num_classes} classes, batch {d.batch_size}"
                 + (f" x {self.world} processes" if self.world > 1 else "")
                 + ", "
                 f"optimizer {tx.kind}, on {self.device}, {mcfg.dtype} "
                 "compute")
        self.train_step = make_train_step(cfg.optim, mcfg,
                                          lr_schedule=self.schedule,
                                          device=self.device,
                                          seed=cfg.run.seed)
        self.eval_step = make_eval_step(
            cfg.optim, mcfg, device=self.device,
            per_sample=cfg.run.collect_misclassified,
            per_class=cfg.run.per_class_metrics)
        self.ckpt = CheckpointManager(cfg.run.ckpt_dir, mcfg.name,
                                      cfg.run.save_period,
                                      async_commit=cfg.run.async_checkpoint,
                                      log=self.log)
        # Sidecars: the resolved config (inferred class count, derived
        # class weights) and the class names, for loading and serving.
        if self.rank == 0:
            with open(os.path.join(self.ckpt.root, "config.json"),
                      "w") as f:
                json.dump(dataclasses.asdict(
                    dataclasses.replace(cfg, model=mcfg)), f, indent=2,
                    default=str)
            with open(os.path.join(self.ckpt.root, "class_to_idx.json"),
                      "w") as f:
                json.dump(self.train_ds.class_to_idx, f, indent=2)
        # SIGTERM latch, installed for the span of fit().
        self.preemption = PreemptionGuard()
        self.start_epoch = 0
        # Steps of start_epoch already done (a mid-epoch flush's resume).
        self.start_step = 0
        self.last_epoch_steps = 0
        self.best_score = 0.0
        if cfg.run.init_from:
            self._init_from_torch(cfg.run.init_from)
        if cfg.run.resume:
            # The newest of latest and best: a crash after the last val
            # improvement resumes at the last periodic save.
            self.state, self.start_epoch, self.best_score = \
                self.ckpt.restore_into(self.state)
            self.start_step = self._validated_start_step()
            if self.start_step:
                self.log(f"[ckpt] a mid-epoch save: resuming epoch "
                         f"{self.start_epoch} at step {self.start_step}")
        # Telemetry: host-side subscribers on the process-global bus.
        from tpuic_torch.telemetry.wiring import TrainTelemetry
        self.telemetry = TrainTelemetry(
            cfg.run, model_name=mcfg.name, image_size=d.resize_size,
            global_batch=global_batch, n_devices=self.world,
            device=self.device, tb=self.logger.tb,
            compute_dtype="bf16" if mcfg.dtype == "bfloat16" else "f32",
            rank=self.rank, log=self.log)
        self._last_skip_streak = 0
        self.stats = {}
        self._quarantine_seen = 0
        # Global step number: the restored count (or 0).
        self._steps_done = self._restored_step_count()
        self._steps_exhausted = False
        self._rollback_pending = False
        self.rollbacks = 0

    def _init_from_torch(self, path: str) -> None:
        """Merge the reference torch checkpoint at ``path`` into the fresh
        model (``tpuic``'s ``_init_from_torch``): the family detected from
        its keys, an unmapped or mismatched tensor keeps its fresh value;
        an EMA restarts at the merged weights."""
        from tpuic_torch.checkpoint.convert import _invalidate
        from tpuic_torch.checkpoint.torch_convert import init_from_torch
        init_from_torch(self.state.model, path, self.mcfg.name,
                        log=self.log)
        _invalidate(self.state.model)
        if self.state.ema_params is not None:
            with torch.no_grad():
                torch._foreach_copy_(
                    self.state.ema_params,
                    [p.detach() for p in self.state.model.parameters()])

    def _restored_step_count(self) -> int:
        """The global step count to go on from after a restore: the one
        the checkpoint recorded, else its applied steps."""
        n = self.ckpt.last_restore_loop_step
        return int(self.state.step) if n is None else n

    def _loader_geometry(self):
        """``(global_batch, seed, n_samples)``: what the epoch order and its
        slicing into steps depend on; a mid-epoch flush records it and a
        resume needs it unchanged to reuse the step offset."""
        ld = self.train_loader
        return (ld.global_batch, ld.seed, len(ld.dataset))

    def _validated_start_step(self) -> int:
        """The step offset of the checkpoint just restored, when its loader
        geometry matches this run's (``tpuic/train/loop.py:522-552``;
        shared by the resume and the rollback), else 0: an offset under
        another geometry would skip other samples."""
        start_step = self.ckpt.last_restore_step_in_epoch or 0
        if not start_step:
            return 0
        saved = self.ckpt.last_restore_geometry
        live = self._loader_geometry()
        epoch = (self.ckpt.last_restore_meta or (0, 0))[0]
        if saved is not None and any(
                a not in (-1, b) for a, b in zip(saved, live)):
            self.log(
                f"[ckpt] mid-epoch checkpoint was flushed under "
                f"loader geometry (global_batch, seed, n_samples)="
                f"{saved} but this run has {live} — the step "
                f"offset would skip the wrong samples; replaying "
                f"epoch {epoch} from its start instead")
            return 0
        if start_step > len(self.train_loader):
            self.log(
                f"[ckpt] mid-epoch step {start_step} exceeds "
                f"this run's {len(self.train_loader)} steps/epoch "
                f"(dataset changed?) — replaying epoch "
                f"{epoch} from its start instead")
            return 0
        return start_step

    def _drain(self, pending, losses: AverageMeter, epoch: int) -> None:
        """Read one deferred log interval back to the host and print it."""
        step_num, handles = pending
        vals = {k: float(v) for k, v in handles.items()}
        # The read returns once the device has finished step ``step_num``.
        self._drains.append((step_num, time.perf_counter()))
        losses.update(vals["loss"], 1)
        self.logger.write(step_num, **vals)
        msg = (f"Epoch: {epoch}; step {step_num}; Loss {losses.val:.4f}|"
               f"({losses.avg:.4f}); acc {vals['accuracy']:.4f}; "
               f"lr {vals.get('lr', 0.0):.6g}")
        if "moe_aux" in vals:
            msg += f"; moe aux {vals['moe_aux']:.4f}"
        streak = int(vals.get("skip_count", 0))
        if streak:
            msg += f"; skipped streak {streak}"
            # The streak at this drain and its growth since the last one:
            # the goodput tracker charges that many steps to 'skip'.
            last = self._last_skip_streak
            publish("skip", step=step_num, streak=streak,
                    delta=streak - last if streak > last else streak)
        self._last_skip_streak = streak
        self.log(msg)
        thr = self.cfg.run.skip_threshold
        if (thr > 0 and streak >= thr and self.cfg.run.rollback
                and not self._rollback_pending):
            self.log(f"[rollback] {streak} consecutive non-finite steps "
                     f"(threshold {thr}) at step {step_num} — state is "
                     "still finite (guard skipped the updates); restoring "
                     "the last good checkpoint instead of grinding forward")
            self._rollback_pending = True

    def train_epoch(self, epoch: int, start_step: int = 0) -> float:
        """Reference train_epoch (train.py:36-73): the mean of the logged
        losses.  Honours ``run.max_steps``.  ``start_step`` continues a
        partly trained epoch at that step (the loader serves the same
        remainder); ``self.last_epoch_steps`` is the epoch's steps done
        when it returns: all of them, or fewer after a preemption, a
        rollback or the step budget."""
        losses = AverageMeter()
        self._drains = []
        run = self.cfg.run
        log_every = max(1, run.log_every_steps)
        remaining = len(self.train_loader) - start_step
        self.last_epoch_steps = start_step
        pending = None
        metrics = None
        wait, first_wait = 0.0, 0.0
        t0 = time.perf_counter()
        inner = iter(self.train_loader.epoch(epoch, start_step=start_step))
        # The step timer's wrapper times the loader's waits (data wait).
        steptime = self.telemetry.steptime
        steptime.epoch_start()
        it = steptime.wrap_epoch(inner)
        step = 0
        # The draws' index: the step's place in the schedule's epochs.
        first = epoch * self.train_loader.steps_per_epoch() + start_step
        preempt_on = run.handle_preemption
        multi = self.world > 1
        rank = fleet_rank(self.rank)
        while True:
            tw = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - tw
            if step == 0:
                first_wait = wait
            if batch is None:
                break
            # Fault points (runtime/faults.py; one dict lookup unarmed),
            # keyed by the global step number.  'sigterm' drives the real
            # latch, agreement and flush.
            at = self._steps_done
            if preempt_on and faults.fire("sigterm", step=at):
                os.kill(os.getpid(), signal.SIGTERM)
            trig = preempt_on and self.preemption.triggered
            if preempt_on and multi:
                # Only at a boundary every process reaches together.
                if step % PREEMPT_SYNC == 0:
                    trig = agree(trig)
                    if trig:
                        self.preemption.trigger()
                else:
                    trig = False
            if trig:
                break
            fbatch = {k: batch[k] for k in ("image", "label", "mask")}
            if faults.fire("nan_batch", step=at):
                # The prepared float images, poisoned on the device: the
                # same shapes and dtypes, so nothing new is built.
                fbatch["image"] = fbatch["image"] * float("nan")
            if faults.fire("slow_step", step=at):
                slow_s = faults.param("slow_step")
                time.sleep(0.05 if slow_s is None else float(slow_s))
            if faults.fire("hard_crash", step=at):
                # Death with no flush, no atexit: the supervisor's
                # retryable crash and resume.
                os.kill(os.getpid(), signal.SIGKILL)
            if faults.fire("hang_step", step=at):
                hang_s = faults.param("hang_step")
                deadline = (None if hang_s is None
                            else time.monotonic() + float(hang_s))
                while deadline is None or time.monotonic() < deadline:
                    time.sleep(0.5)
            if faults.fire("rank_crash", step=at):
                if rank == int(faults.param("rank_crash") or 0):
                    os.kill(os.getpid(), signal.SIGKILL)
            if faults.fire("rank_hang", step=at):
                if rank == int(faults.param("rank_hang") or 0):
                    while True:
                        time.sleep(0.5)
            # The step's draws are keyed by the global micro-step.
            steptime.dispatch_start()
            self.state, metrics = self.train_step(self.state, fbatch,
                                                  step=first + step)
            steptime.dispatch_end()
            step += 1
            self._steps_done += 1
            self.last_epoch_steps = start_step + step
            if step % log_every == 0 or step == remaining:
                handles = {k: metrics[k] for k in
                           ("loss", "accuracy", "lr", "skip_count",
                            "moe_aux") if k in metrics}
                if pending is not None:
                    self._drain(pending, losses, epoch)
                pending = (self._steps_done, handles)
            # The step's 'step' event, after the deferred drain: a
            # blocking read is charged to the step that made it.
            steptime.step_end(self._steps_done)
            if self._rollback_pending:
                # Guarded but unprogressing steps: hand back to fit().
                break
            max_steps = run.max_steps
            if max_steps and self._steps_done >= max_steps:
                self._steps_exhausted = True
                break
        it.close()
        inner.close()
        t_drain = time.perf_counter()
        if metrics is not None and (pending is None
                                    or pending[0] != self._steps_done):
            if pending is not None:
                self._drain(pending, losses, epoch)
            pending = (self._steps_done, {"loss": metrics["loss"],
                                          "accuracy": metrics["accuracy"]})
        if pending is not None:
            self._drain(pending, losses, epoch)
            # The last steps' device time, read after their step events
            # closed: productive time the goodput tracker books late.
            publish("drain",
                    duration_s=round(time.perf_counter() - t_drain, 3))
        self.stats = {"steps": step, "wall_s": time.perf_counter() - t0,
                      "data_wait_s": wait, "first_wait_s": first_wait,
                      "drains": self._drains}
        # Samples the data layer replaced this epoch (tpuic/train/
        # loop.py:761-768): a corrupt file is visible without being fatal.
        q = self.train_loader.quarantine_count
        if q > self._quarantine_seen:
            delta = q - self._quarantine_seen
            self._quarantine_seen = q
            self.log(f"[quarantine] epoch {epoch}: {delta} sample load(s) "
                     f"served a replacement (total {q})")
            self.logger.write(self._steps_done, quarantined=delta,
                              quarantined_total=q)
        publish("epoch", epoch=epoch, steps=step, loss=round(losses.avg, 6))
        return losses.avg

    def val_epoch(self, epoch: int) -> float:
        """Reference val_epoch (train.py:78-97): exact global val accuracy
        x100 and the exact global weighted val CE, from per-batch device
        sums read once at the end (module docstring)."""
        t_eval0 = time.perf_counter()
        collect = self.cfg.run.collect_misclassified
        per_class = self.cfg.run.per_class_metrics
        sums, wrongs, orders = None, [], []
        # The EMA weights when the recipe keeps them, with the current BN
        # statistics (tpuic's inference_params).
        with self.state.inference_weights():
            for batch in self.val_loader.epoch(epoch):
                m = self.eval_step(self.state, {k: batch[k] for k in
                                                ("image", "label", "mask")})
                if collect:
                    wrongs.append(m.pop("wrong"))
                    orders.append(batch.indices)
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        if self.world > 1:
            flat = torch.cat([v.reshape(-1).float() for v in sums.values()])
            dist.all_reduce(flat)
            sums = dict(zip(sums, (t.reshape(v.shape) for t, v in zip(
                flat.split([v.numel() for v in sums.values()]),
                sums.values()))))
        confusion = (sums.pop("confusion").double().cpu().numpy()
                     if per_class else None)
        vals = {k: float(v) for k, v in sums.items()}
        score = 100.0 * vals["correct"] / max(vals["count"], 1.0)
        val_loss = vals["loss_num"] / max(vals["loss_den"], 1e-12)
        extra = {}
        if collect:
            self.last_misclassified = self._misclassified(wrongs, orders)
            extra["n_misclassified"] = len(self.last_misclassified)
        top5 = ""
        if "correct5" in vals:
            extra["val_top5"] = 100.0 * vals["correct5"] / max(
                vals["count"], 1.0)
            top5 = f"; Top-5 {extra['val_top5']:.4f}"
        if per_class:
            extra.update(self._per_class(confusion, epoch))
        self.log(f"Epoch: {epoch}; Val Accuracy {score:.4f}{top5}; "
                 f"Val Loss {val_loss:.4f}")
        self.logger.write(int(self.state.step), val_accuracy=score,
                          val_loss=val_loss, **extra)
        self.last_val = {"accuracy": score, "loss": val_loss, **vals,
                         **extra}
        publish("eval", epoch=epoch, accuracy=round(score, 4),
                duration_s=round(time.perf_counter() - t_eval0, 3))
        return score

    def _misclassified(self, wrongs: list, orders: list) -> list:
        """Image ids of every misclassified val row of the pass, in the
        global order: the [steps, local batch] ``wrong`` of each process
        gathered into [steps, global batch], whose columns index the
        global batch's ``batch.indices``."""
        if not wrongs:
            return []
        wrong = torch.stack(wrongs)
        if self.world > 1:
            parts = [torch.empty_like(wrong) for _ in range(self.world)]
            dist.all_gather(parts, wrong)
            wrong = torch.stack(parts, dim=1).reshape(len(wrongs), -1)
        ds = self.val_loader.dataset
        return [ds.image_id(int(orders[b][pos])) for b, pos in
                zip(*np.nonzero(wrong.cpu().numpy() > 0.5))]

    def _per_class(self, confusion: np.ndarray, epoch: int) -> dict:
        """Balanced and worst-class val accuracy from the global confusion
        matrix, which goes with its per-class rows to the logger's root."""
        self.last_confusion = confusion
        support = confusion.sum(axis=1)
        cls_acc = np.divide(np.diag(confusion), support,
                            out=np.zeros_like(support), where=support > 0)
        present = support > 0
        out = {}
        if present.any():
            out["val_balanced_acc"] = 100.0 * cls_acc[present].mean()
            out["val_worst_class_acc"] = 100.0 * cls_acc[present].min()
        if self.logger.root is not None:
            np.save(os.path.join(self.logger.root,
                                 f"confusion_e{epoch}.npy"), confusion)
            with open(os.path.join(self.logger.root, "per_class.jsonl"),
                      "a") as f:
                f.write(json.dumps({
                    "epoch": epoch,
                    "acc": [round(100.0 * a, 2) for a in cls_acc],
                    "support": [int(s) for s in support]}) + "\n")
        return out

    def fit(self, epochs: Optional[int] = None) -> float:
        """Train from ``start_epoch`` (at ``start_step`` in it) up to
        ``epochs`` (default ``run.epochs``), each epoch followed by a val
        pass and the checkpoint saves (``best`` on an improvement,
        ``latest`` every ``save_period`` epochs), and return the best val
        accuracy.  A ``max_steps`` budget reached mid-run stops before
        that epoch's val pass; a preemption flushes ``latest`` in its
        place and returns (``self.preemption.triggered``); a non-finite
        streak rolls back and goes on.  Every save has committed when
        ``fit`` returns."""
        from tpuic_torch.telemetry import tracing
        epochs = self.cfg.run.epochs if epochs is None else epochs
        best = self.best_score
        self._steps_exhausted = False
        run = self.cfg.run
        if run.handle_preemption:
            self.preemption.install()
        tm = self.telemetry
        goodput = tm.goodput
        goodput.start()
        # A supervised restart: its downtime (the last life's death to
        # here) goes to the goodput 'restart' bucket.
        rinfo = restart_info()
        if rinfo is not None:
            count, downtime_s = rinfo
            self.log(f"[supervise] restart #{count}: resumed at epoch "
                     f"{self.start_epoch} step {self.start_step} after "
                     f"{downtime_s:.1f}s downtime")
            publish("restart", restart=count, downtime_s=round(downtime_s, 3),
                    epoch=self.start_epoch, step_in_epoch=self.start_step,
                    resume_step=os.environ.get(ENV_RESUME_STEP))
        profiler = None
        flushed = None
        counted = {fn.__name__: fn for fn in counted_kernels()}
        launched = {name: fn.launches for name, fn in counted.items()}
        try:
            epoch = self.start_epoch
            while epoch < epochs:
                if run.profile_dir and epoch == self.start_epoch \
                        and profiler is None:
                    profiler = (tracing.start_profiler(), epoch)
                t0 = time.perf_counter()
                self.train_epoch(
                    epoch, self.start_step if epoch == self.start_epoch
                    else 0)
                if self._rollback_pending:
                    # A non-finite streak: restore the last good
                    # checkpoint and go on from its epoch and step.
                    if profiler is not None:
                        self._stop_profiler(*profiler)
                        profiler = None
                    epoch = self._do_rollback()
                    best = self.best_score
                    continue
                if self._steps_exhausted:
                    self.log(f"[tpuic_torch] step budget "
                             f"({run.max_steps}) reached in epoch "
                             f"{epoch}; stopping")
                    break
                # The epoch's end is a common boundary: agree, so that a
                # process whose latch missed the last in-epoch agreement
                # does not go to val while the others flush.
                if run.handle_preemption and agree(
                        self.preemption.triggered):
                    self.preemption.trigger()
                    # Grace windows are short: no val pass, a flush of
                    # 'latest' with the steps done (all of them at the
                    # epoch's end: the resume runs the pending val).
                    done = self.last_epoch_steps
                    total = len(self.train_loader)
                    self.log(f"[preempt] signal received during epoch "
                             f"{epoch} (step {done}/{total}); flushing "
                             "latest and exiting")
                    gb, seed, n = self._loader_geometry()
                    self.ckpt.save_latest(
                        self.state, epoch, best, step_in_epoch=done,
                        global_batch=gb, data_seed=seed, data_len=n,
                        loop_step=self._steps_done)
                    flushed = (epoch, done)
                    break
                score = self.val_epoch(epoch)
                self.log(f"Epoch {epoch} took "
                         f"{time.perf_counter() - t0:.1f}s")
                if profiler is not None:
                    self._stop_profiler(*profiler)
                    profiler = None
                if score > best:
                    best = score
                    self.ckpt.save_best(self.state, epoch, best,
                                        loop_step=self._steps_done)
                self.ckpt.maybe_save_latest(self.state, epoch, best,
                                            loop_step=self._steps_done)
                self.log(f"[goodput] {goodput.summary_line()}")
                publish("goodput", step=tm.steptime.last_step,
                        **goodput.report())
                epoch += 1
        finally:
            self.preemption.uninstall()
            if profiler is not None:
                self._stop_profiler(*profiler)
            # A save staged in the last epoch, or the flush, commits on
            # every exit path.
            self.ckpt.wait()
            if flushed is not None:
                t_signal = self.preemption.triggered_at
                publish("preempt", epoch=flushed[0], step_in_epoch=flushed[1],
                        step=self._steps_done,
                        flush_s=None if t_signal is None
                        else round(time.time() - t_signal, 3))
            publish("kernel_launches", **{
                name: fn.launches - launched[name]
                for name, fn in counted.items()})
            if tm.tracer is not None:
                tm.tracer.finish()
            if tm.profile is not None:
                tm.profile.finalize()
            self.log(f"[goodput] {goodput.summary_line()}")
            publish("goodput", final=True, step=tm.steptime.last_step,
                    **goodput.report())
            tm.flush()
        self.best_score = best
        return best

    def _do_rollback(self) -> int:
        """Restore the last good checkpoint after a non-finite streak
        (``tpuic/train/loop.py:915-995``); returns the epoch to go on
        from, with ``self.start_step`` its step.  The restore goes
        through the integrity ladder, the skip streak restarts at 0, and
        with ``run.rollback_rewarm_steps`` the LR ramps back into its
        schedule (a new optimizer around the restored state and a step
        rebuilt around the composed schedule)."""
        self._rollback_pending = False
        self.rollbacks += 1
        t_rb0 = time.perf_counter()
        run = self.cfg.run
        if self.rollbacks > run.max_rollbacks:
            # A restart would resume, diverge and land here again: the
            # poison half of the exit-code contract.
            raise NonRetryableError(
                f"non-finite rollback #{self.rollbacks} exceeds "
                f"run.max_rollbacks={run.max_rollbacks}: the run keeps "
                "diverging after restore — fix the data/LR instead of "
                "looping restore->diverge forever")
        # What the skipped steps left: a NaN update the guard let through
        # would leave a non-finite parameter.  One read, on this rare path.
        applied = int(self.state.step)
        with torch.no_grad():
            params_finite = bool(torch.stack([
                torch.isfinite(p).all()
                for p in self.state.model.parameters()]).all())
        # A staged save commits first: the newest checkpoint may still sit
        # in '{track}.new'.
        self.ckpt.wait()
        if self.ckpt.newest_track() is None:
            raise NonRetryableError(
                f"{run.skip_threshold} consecutive non-finite steps before "
                "any checkpoint existed — nothing to roll back to (the "
                "guard kept the state finite; lower the LR or check the "
                "data)")
        self.state, epoch, restored_best = self.ckpt.restore_into(self.state)
        # 'best' on disk keeps its score: a rollback never lowers it.
        self.best_score = max(self.best_score, restored_best)
        with torch.no_grad():
            self.state.skip_count.zero_()
        if run.rollback_rewarm_steps > 0:
            steps = max(1, self.train_loader.steps_per_epoch())
            gb = self.train_loader.global_batch
            base_step = int(self.state.step)
            scale = rewarm_scale(base_step, run.rollback_rewarm_steps)
            self.state.tx = make_optimizer(self.cfg.optim, steps, run.epochs,
                                           global_batch=gb, lr_scale=scale)
            # The logged 'lr' is what the optimizer applies: the ramp
            # composed onto the pristine schedule (a second rollback inside
            # the first one's ramp must not stack the two).
            base = make_schedule(self.cfg.optim, steps, run.epochs,
                                 global_batch=gb)
            self.schedule = lambda t: base(t) * scale(t)
            self.train_step = make_train_step(
                self.cfg.optim, self.mcfg, lr_schedule=self.schedule,
                device=self.device, seed=run.seed)
            self.log(f"[rollback] LR re-warming over "
                     f"{run.rollback_rewarm_steps} steps from step "
                     f"{base_step}")
        self.start_epoch = epoch
        self.start_step = self._validated_start_step()
        self._steps_done = self._restored_step_count()
        self.log(f"[rollback] restored '{self.ckpt.last_restore_rung}' — "
                 f"continuing at epoch {epoch} step {self.start_step} "
                 f"(rollback {self.rollbacks}/{run.max_rollbacks})")
        self._last_skip_streak = 0
        publish("rollback", epoch=epoch, step_in_epoch=self.start_step,
                rollback=self.rollbacks, rung=self.ckpt.last_restore_rung,
                params_finite=params_finite, applied_steps=applied,
                duration_s=round(time.perf_counter() - t_rb0, 3))
        return epoch

    def _stop_profiler(self, prof, epoch: int) -> None:
        from tpuic_torch.telemetry import tracing
        name = f"epoch{epoch}" + (f".rank{self.rank}" if self.world > 1
                                  else "")
        path = tracing.stop_profiler(
            prof, os.path.join(self.cfg.run.profile_dir, name))
        self.log(f"[profile] {path}")

