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
``:376-388``): the batch is cast once to bf16 at the step entry (the
port augments in the ``Loader``, before the step); the model, which the
Trainer built with ``dtype=bfloat16``, computes in bf16 from its float32
master parameters, so autograd accumulates float32 gradients; the
outputs are cast to float32 before the loss, so K1 sees float32 logits.
Optimizer moments and checkpoints stay float32.  ``optim.loss_scale`` is static
loss scaling: the backward runs on ``loss * loss_scale`` and the
gradients are divided by it before the norm, the guard and the update.

``batch`` is ``{"image": [B, H, W, 3] float32, "label": [B] int32,
"mask": [B] float32}`` on the model's device.  Mixup, CutMix, random
erasing and remat are not ported (the Trainer refuses them).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpuic_torch.config import ModelConfig, OptimConfig, resolve_compute_dtype
from tpuic_torch.metrics.meters import accuracy, topk_accuracy
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


def make_train_step(optim_cfg: OptimConfig, model_cfg: ModelConfig,
                    lr_schedule: Optional[Callable] = None,
                    device=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; see the module
    docstring.  ``device`` places the class-weight vector once, so the
    step makes no host-to-device copy of its own."""
    class_weights = _class_weights(optim_cfg, device)
    impl = "fused" if optim_cfg.fused_loss else "reference"
    guard = bool(optim_cfg.skip_nonfinite)
    bf16 = resolve_compute_dtype(model_cfg) == "bf16"
    loss_scale = float(optim_cfg.loss_scale or 1.0)

    def train_step(state: TrainState, batch):
        images, labels = batch["image"], batch["label"]
        mask = batch.get("mask")
        model = state.model
        params = state.params
        metrics = {}
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
        out = model(images)
        if bf16:  # the loss is taken on float32 logits
            out = (tuple(t.float() for t in out) if isinstance(out, tuple)
                   else out.float())
        loss = classification_loss(
            out, labels, class_weights=class_weights, mask=mask,
            aux_weight=model_cfg.aux_loss_weight,
            label_smoothing=optim_cfg.label_smoothing, impl=impl)
        (loss * loss_scale if loss_scale != 1.0 else loss).backward()
        logits = (out[0] if isinstance(out, tuple) else out).detach()
        grads = [p.grad for p in params]
        if loss_scale != 1.0:
            torch._foreach_mul_(grads, 1.0 / loss_scale)
        grad_norm = global_norm(grads)
        with torch.no_grad():
            if guard:
                finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
            else:
                finite = torch.ones((), dtype=torch.bool, device=loss.device)
            state.tx.update(params, grads, state.opt_state, finite,
                            grad_norm=grad_norm)
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
            metrics["loss"] = loss.detach()
            metrics["accuracy"] = _masked_mean(accuracy(logits, labels),
                                               mask)
            metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def make_eval_step(optim_cfg: OptimConfig, model_cfg: ModelConfig,
                   device=None) -> Callable:
    """``eval_step(state, batch) -> metrics``: 0-d device tensors
    ``correct`` (sum of 0/1 over valid rows), ``count`` (sum of the mask),
    ``loss_num`` (sum of w * nll), ``loss_den`` (sum of w), and ``correct5``
    when there are more than five classes.  Summed over batches and divided
    on the host they give the exact val accuracy and weighted CE.  The
    forward runs in eval mode, through the K3 kernel when the model was
    built with ``fused_conv_bn``."""
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
        return out

    return eval_step
