"""Train and eval steps (``tpuic/train/step.py``).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: forward in train mode, ``classification_loss`` (+0.4 aux for
tuple outputs), backward, the global gradient norm, the non-finite skip
guard and the optimizer update, all in place on ``state``.  ``metrics``
holds 0-d device tensors (``loss``, ``accuracy``, ``grad_norm``,
``skipped``, ``skip_count``, ``lr``); the step itself never reads a value
back to the host: the caller drains metrics when it needs them.

The skip guard (``tpuic/train/step.py:427-458``) is a select on the
device.  ``finite = isfinite(loss) & isfinite(grad_norm)``; where it is
false the whole state passes through unchanged: parameters, optimizer
state (``count`` included), BN running statistics and ``step``.  Only
``skip_count`` changes.  The BN statistics are snapshotted before the
forward (one concatenation) and selected back after it; the optimizer
updates are gated by ``finite`` inside the update (the K2 kernels read
it on the device).

The bf16 tier (``ModelConfig.compute_dtype='bf16'``,
``tpuic/train/step.py:158-166``, ``:313-320``, ``:345-348``,
``:376-388``): the batch is cast once to bf16 after the step's own
augments (mixup, CutMix and erasing blend in float32 inside the step,
below; the ``Loader``'s rot90, flips and jitter come before it); the
model, which the Trainer built with ``dtype=bfloat16``, computes in
bf16 from its float32 master parameters, so autograd accumulates
float32 gradients; the outputs are cast to float32 before the loss, so
K1 sees float32 logits.  Optimizer moments and checkpoints stay
float32.  ``optim.loss_scale`` is static loss scaling: the backward
runs on ``loss * loss_scale`` and the gradients are divided by it before
the norm, the guard and the update.

**Data parallel** (``tpuic/train/step.py:1-23``: one program over the
sharded global batch).  When the step is built in a process group
(``tpuic_torch.runtime.distributed.initialize``), each process runs it on
its shard and the forward and backward go through
``DistributedDataParallel`` around ``state.model``, built at the first
step; ``state.model`` stays the bare module, so the weight carriers, the
checkpoint and the eval forward never see DDP's ``module.`` prefix.
- The loss is this rank's share of the global-batch loss
  (``classification_loss(..., data_parallel=True)``), so DDP's mean of
  the gradients is the global batch's gradient; BN takes global batch
  statistics (``models/layers.py``), so ``broadcast_buffers`` is off and
  the running buffers are equal on every rank by construction.
- ``loss`` and ``accuracy`` are the global batch's (one all-reduce a
  step); ``grad_norm`` is taken after DDP's all-reduce, so it too is
  global, and the skip guard takes the same decision on every rank.
- DDP copies each all-reduced bucket back into ``p.grad`` (no
  ``gradient_as_bucket_view``), and the step zeroes the gradients in
  place, so they keep their addresses from step to step and the K2
  kernels' leaf table is built once.

**The step's randomness** (``tpuic/train/step.py:196-311``;
``train/augment.py``).  ``train_step(state, batch, step=None)`` draws
everything random from a ``torch.Generator`` on the batch's device,
reseeded from ``(seed, step)``: ``step`` is the index the host knows,
the ``Trainer``'s global micro-step (``epoch * steps_per_epoch +`` the
step in the epoch, what a checkpoint saves), never the device's
``state.step``; without it the step counts its own calls.  Every draw
has the global batch's shape and a process takes its rows, so N
processes draw what one does.  One difference from ``tpuic``: after a
skipped (non-finite) step ``tpuic`` repeats that step's draws, because
its ``state.step`` did not advance; the port draws the next index's.
- Mixup / CutMix blend in float32 before the bf16 cast; the loss is
  ``lam * L(y) + (1 - lam) * L(y_perm)`` (K1 runs twice per output) and
  accuracy is taken against the original labels.  In a process group
  the partners live on other ranks: one ``all_gather`` of the batch a
  step (``tpuic``'s "one batch-sized exchange per step").
- Random erasing runs after the mix, drop-path masks go to the model's
  forward (``drop_masks``).

**Parameter EMA** (``:410-424``): after each applied update,
``e = d*e + (1-d)*p`` over every parameter (as ``e + (1-d)*(p - e)``,
through ``_foreach`` ops); the skip guard and, under gradient
accumulation, the micro-steps between real updates leave it as it was.

**The MoE load-balancing loss** (``tpuic/train/step.py:46-60``,
``:365-372``): a model with ``SwitchMoEMlp`` layers records each layer's
router ``(probs, onehot)`` in its forward, and the loss adds
``moe_aux_weight`` times the mean over the layers of
``switch_aux_loss(probs, onehot, mask)``, once, after the ``lam`` mix
(it is not mixed).  ``tpuic`` takes its means over the global batch; in a
process group each rank holds its shard, so one ``all_reduce`` a step
carries every layer's masked one-hot sums, masked probability sums
(values only) and masked token count, and each rank adds its share
``E * sum_e (F_e / T) * (p_local_e / T) * world`` (``models/moe.py``'s
``global_aux_term``), the classification loss's rule: DDP's mean of the
gradients is the global gradient, and the mean of the ranks' losses is
the global loss.  ``metrics["moe_aux"]`` is the mean of the ranks' terms,
which is the global aux loss only where each term is right.

**Fault point** ``bf16_master_truncate`` (``tpuic/train/step.py:400``,
``runtime/faults.py``): checked once, when the step is built; armed,
every applied update then rounds the float32 master weights through
bf16, the no-float32-master bug a convergence gate must catch.

**Remat** (``models/remat.py``) is the model's: ``resolve_remat_policy``
warns here where the policy has no effect, as ``tpuic``'s step does.

``batch`` is ``{"image": [B, H, W, 3] float32, "label": [B] int32,
"mask": [B] float32}`` on the model's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tpuic_torch.config import ModelConfig, OptimConfig, resolve_compute_dtype
from tpuic_torch.metrics.meters import accuracy, topk_accuracy
from tpuic_torch.models import moe as _moe
from tpuic_torch.models.remat import resolve_remat_policy
from tpuic_torch.runtime import faults
from tpuic_torch.telemetry.tracing import scope
from tpuic_torch.train import augment
from tpuic_torch.train.loss import classification_loss
from tpuic_torch.train.optimizer import global_norm
from tpuic_torch.train.state import TrainState


def _class_weights(optim_cfg: OptimConfig, device) -> Optional[torch.Tensor]:
    if not optim_cfg.class_weights:
        return None
    return torch.tensor(tuple(optim_cfg.class_weights), dtype=torch.float32,
                        device=device)


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return values.mean()
    m = mask.float()
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=1.0)


def _ddp(model: torch.nn.Module) -> DistributedDataParallel:
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False)


def _gather_pool(images, labels, mask, world: int):
    """The global batch's ``(images, labels, mask)`` on every rank: one
    ``all_gather`` of the images and one of the labels and mask."""
    imgs = [torch.empty_like(images) for _ in range(world)]
    dist.all_gather(imgs, images)
    m = (torch.ones_like(labels, dtype=torch.float32) if mask is None
         else mask.float())
    lm = torch.stack([labels.float(), m])
    lms = [torch.empty_like(lm) for _ in range(world)]
    dist.all_gather(lms, lm)
    lm = torch.cat(lms, dim=1)
    return (torch.cat(imgs), lm[0].to(labels.dtype),
            None if mask is None else lm[1].to(mask.dtype))


def _moe_aux(routers, mask, world: int):
    """This rank's loss term of the mean ``switch_aux_loss`` over the
    layers' ``routers`` (see the module docstring)."""
    if world == 1:
        return sum(_moe.switch_aux_loss(p, o, mask)
                   for p, o in routers) / len(routers)
    sums = torch.stack([_moe.router_sums(p, o, mask) for p, o in routers])
    dist.all_reduce(sums)
    return sum(_moe.global_aux_term(p, o, mask, sums[i], world)
               for i, (p, o) in enumerate(routers)) / len(routers)


def make_train_step(optim_cfg: OptimConfig, model_cfg: ModelConfig,
                    lr_schedule: Optional[Callable] = None,
                    device=None, seed: int = 0) -> Callable:
    """``train_step(state, batch, step=None) -> (state, metrics)``; see
    the module docstring.  ``device`` places the class-weight vector once,
    so the step makes no host-to-device copy of its own; ``seed`` seeds
    the step's draws.  Built in a process group, the step is
    data-parallel."""
    class_weights = _class_weights(optim_cfg, device)
    impl = "fused" if optim_cfg.fused_loss else "reference"
    guard = bool(optim_cfg.skip_nonfinite)
    bf16 = resolve_compute_dtype(model_cfg) == "bf16"
    loss_scale = float(optim_cfg.loss_scale or 1.0)
    parallel = dist.is_initialized()
    world = dist.get_world_size() if parallel else 1
    rank = dist.get_rank() if parallel else 0
    mixing = optim_cfg.mixup_alpha > 0 or optim_cfg.cutmix_alpha > 0
    ema_decay = float(optim_cfg.ema_decay)
    resolve_remat_policy(model_cfg)
    truncate = faults.fire("bf16_master_truncate")
    wrapper = {}
    rng = {"next": 0}
    moe_layers = {}

    def draws_for(model, dev, step: int, n: int):
        """This step's draws (``augment.draw_step``) over a global batch
        of ``n``, or None when the recipe draws nothing."""
        if rng.get("model") is not model:
            rates = getattr(model, "drop_path_rates", list)()
            rng.update(model=model, keep=augment.site_keep(rates, dev))
        keep = rng["keep"]
        if not (mixing or optim_cfg.random_erase > 0 or keep is not None):
            return None
        if rng.get("gen") is None or rng["gen"].device != dev:
            rng["gen"] = torch.Generator(device=dev)
        return augment.draw_step(
            rng["gen"], seed, step, n, mixup_alpha=optim_cfg.mixup_alpha,
            cutmix_alpha=optim_cfg.cutmix_alpha,
            random_erase=optim_cfg.random_erase, keep=keep, device=dev)

    def train_step(state: TrainState, batch, step: Optional[int] = None,
                   draws: Optional[augment.StepDraws] = None):
        """``draws`` (over the global batch) replaces this step's own:
        how a test feeds ``tpuic``'s draws to the port."""
        images, labels = batch["image"], batch["label"]
        mask = batch.get("mask")
        model = state.model
        params = state.params
        metrics = {}
        step = rng["next"] if step is None else int(step)
        rng["next"] = step + 1
        b = images.shape[0]
        offset = rank * b
        if draws is None:
            draws = draws_for(model, images.device, step, b * world)
        mix = None
        if draws is not None and draws.mix is not None:
            pool = (_gather_pool(images, labels, mask, world)
                    if world > 1 else None)
            images, labels_mix, lam = augment.mix_batch(
                images, labels, mask, draws.mix, offset, pool)
            mix = (labels_mix, lam)
        if draws is not None and draws.erase is not None:
            images = augment.erase_batch(images, draws.erase, offset)
        drop_masks = None
        if draws is not None and draws.drop_masks is not None:
            drop_masks = draws.drop_masks[:, offset:offset + b]
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.step)  # before the step
        bufs = state.bn_buffers()
        old_stats = torch.cat([b.reshape(-1) for b in bufs]) \
            if guard and bufs else None
        if not model.training:
            model.train()
        # Gradients stay allocated from step to step (zeroed, not freed):
        # the K2 kernels' leaf table is built once for their pointers.
        grads = [p.grad for p in params]
        if all(g is not None for g in grads):
            torch._foreach_zero_(grads)
        if bf16:
            images = images.to(torch.bfloat16)
        forward = model
        if parallel:
            if wrapper.get("module") is not model:
                wrapper.update(module=model, ddp=_ddp(model))
            forward = wrapper["ddp"]
        out = (forward(images) if drop_masks is None
               else forward(images, drop_masks=drop_masks))
        if bf16:  # the loss is taken on float32 logits
            out = (tuple(t.float() for t in out) if isinstance(out, tuple)
                   else out.float())
        with scope("loss"):
            loss = classification_loss(
                out, labels, class_weights=class_weights, mask=mask,
                aux_weight=model_cfg.aux_loss_weight,
                label_smoothing=optim_cfg.label_smoothing, impl=impl,
                data_parallel=parallel, mix=mix)
            if moe_layers.get("model") is not model:
                moe_layers.update(model=model,
                                  layers=_moe.moe_layers(model))
            if moe_layers["layers"]:
                routers = _moe.take_router_stats(moe_layers["layers"])
                if model_cfg.moe_aux_weight:
                    aux = _moe_aux(routers, mask, world)
                    metrics["moe_aux"] = aux.detach()
                    loss = loss + model_cfg.moe_aux_weight * aux
        (loss * loss_scale if loss_scale != 1.0 else loss).backward()
        logits = (out[0] if isinstance(out, tuple) else out).detach()
        loss = loss.detach()
        if world > 1:
            # The global batch's loss, accuracy and aux loss: the mean of
            # the ranks' shares, and the ratio of summed counts.
            m = (torch.ones_like(labels, dtype=torch.float32)
                 if mask is None else mask.float())
            sums = torch.stack([loss, torch.sum(accuracy(logits, labels)
                                                * m), torch.sum(m),
                                *([metrics["moe_aux"]]
                                  if "moe_aux" in metrics else [])])
            dist.all_reduce(sums)
            loss = sums[0] / world
            correct = sums[1] / torch.clamp(sums[2], min=1.0)
            if "moe_aux" in metrics:
                metrics["moe_aux"] = sums[3] / world
        else:
            correct = _masked_mean(accuracy(logits, labels), mask)
        grads = [p.grad for p in params]
        if loss_scale != 1.0:
            torch._foreach_mul_(grads, 1.0 / loss_scale)
        grad_norm = global_norm(grads)
        with torch.no_grad(), scope("optimizer"):
            if guard:
                finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
            else:
                finite = torch.ones((), dtype=torch.bool, device=loss.device)
            applied = finite & state.tx.emits(state.opt_state)
            state.tx.update(params, grads, state.opt_state, finite,
                            grad_norm=grad_norm)
            if truncate:
                for p in params:
                    p.copy_(torch.where(finite, p.to(torch.bfloat16).to(
                        p.dtype), p))
            if state.ema_params is not None:
                _ema_update(state, ema_decay, applied)
            if old_stats is not None:
                new_stats = torch.cat([b.reshape(-1) for b in bufs])
                kept = torch.where(finite, new_stats, old_stats)
                torch._foreach_copy_(bufs, list(kept.split(
                    [b.numel() for b in bufs])))
            state.step.add_(finite.to(torch.int32))
            if guard:
                state.skip_count.copy_(torch.where(
                    finite, torch.zeros_like(state.skip_count),
                    state.skip_count + 1))
                metrics["skipped"] = 1.0 - finite.float()
                metrics["skip_count"] = state.skip_count.clone()
            metrics["loss"] = loss
            metrics["accuracy"] = correct
            metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def _ema_update(state: TrainState, decay: float,
                applied: torch.Tensor) -> None:
    """``e += (1-d) * applied * (p - e)``: ``tpuic``'s ``d*e + (1-d)*p``
    where ``applied``, ``e`` bit for bit where not (``p - e`` is finite:
    a skipped step leaves the parameters as they were).  Three
    multi-tensor passes, whatever the number of parameters."""
    ema = state.ema_params
    step = torch._foreach_sub([p.detach() for p in state.model.parameters()],
                              ema)
    torch._foreach_mul_(step, applied.float() * (1.0 - decay))
    torch._foreach_add_(ema, step)


def make_eval_step(optim_cfg: OptimConfig, model_cfg: ModelConfig,
                   device=None, per_sample: bool = False,
                   per_class: bool = False) -> Callable:
    """``eval_step(state, batch) -> metrics``: 0-d device tensors
    ``correct`` (sum of 0/1 over valid rows), ``count`` (sum of the mask),
    ``loss_num`` (sum of w * nll), ``loss_den`` (sum of w), and ``correct5``
    when there are more than five classes.  Summed over batches and divided
    on the host they give the exact val accuracy and weighted CE.  The
    forward runs in eval mode, through the K3 kernel when the model was
    built with ``fused_conv_bn``.

    ``per_sample=True`` adds ``wrong``, the [B] 0/1 misclassification
    vector (0 on padded rows); ``per_class=True`` adds ``confusion``, the
    [C, C] count matrix (rows the true class, columns the predicted), as
    ``tpuic/train/step.py:492-557``.  Every value is this process's
    batch's: the Trainer sums them over the processes once a val pass
    (``train/loop.py``)."""
    class_weights = _class_weights(optim_cfg, device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        images, labels = batch["image"], batch["label"]
        mask = batch.get("mask")
        m = mask.float() if mask is not None else torch.ones(
            labels.shape, dtype=torch.float32, device=labels.device)
        model = state.model
        if model.training:
            model.eval()
        logits = model(images)
        acc = accuracy(logits, labels)
        loss = classification_loss(logits, labels,
                                   class_weights=class_weights, mask=m)
        if class_weights is not None:
            classes = torch.arange(logits.shape[-1], device=logits.device)
            onehot = (classes[None, :] == labels.long()[:, None]).float()
            w = torch.sum(onehot * class_weights[None, :], dim=-1) * m
        else:
            w = m
        loss_den = torch.sum(w)
        out = {"correct": torch.sum(acc * m), "count": torch.sum(m),
               "loss_num": loss * loss_den, "loss_den": loss_den}
        if logits.shape[-1] > 5:
            out["correct5"] = torch.sum(topk_accuracy(logits, labels, 5) * m)
        if per_sample:
            out["wrong"] = (1.0 - acc) * m
        if per_class:
            n_cls = logits.shape[-1]
            classes = torch.arange(n_cls, device=logits.device)
            oh_true = (classes[None, :] == labels.long()[:, None]).float() \
                * m[:, None]
            oh_pred = (classes[None, :]
                       == torch.argmax(logits, dim=-1)[:, None]).float()
            out["confusion"] = oh_true.T @ oh_pred
        return out

    return eval_step
