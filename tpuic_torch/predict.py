"""Batch inference CLI of the port (``tpuic/predict.py``): classify an
ImageFolder fold with a trained model.

The reference trains and validates but has no standalone prediction path:
its users run ``val_epoch`` (train.py:78-97) and read the printed
accuracy.  This is that capability as a tool: load a port checkpoint (or
a reference torch checkpoint through ``--init-from``), run the fold
through the serving engine and write per-image predictions to CSV.

    python -m tpuic_torch.predict --datadir /data/x --model resnet50 \\
        --ckpt-dir dtmodel/cp                      # best track by default
    python -m tpuic_torch.predict --datadir /data/x --model resnet50 \\
        --init-from best_model --fold val --out preds.csv --top-k 3

Output CSV columns: image_id, label (ground-truth class name, '' when the
fold carries none), pred (top-1 class name), prob (softmax of top-1), then
pred_2/prob_2..pred_k/prob_k when --top-k > 1.  When labels exist, the
accuracy over the labeled rows is printed: the same number ``val_epoch``
reports.

The fold goes through ``tpuic_torch.serve.InferenceEngine`` with
``default_buckets(batch size)`` and no coalescing wait: on the card each
bucket is one CUDA graph, full batches reach the engine as the
``Loader``'s tensors on the card (no host bounce), and the tail batch
submits only its valid rows.  ``--device cpu`` runs on the CPU.  The
fold is packed first (``tpuic/predict.py:95-98``: the uint8 cache under
``{datadir}/.tpuic_pack``, normalised on the device, the native decode
core when it builds), and the log names the decoder; ``--no-pack``
decodes each image on host threads instead.  Every checkpoint is scored
in float32 through the kernels, as the serve CLI serves it
(``serving_model_config``), a bf16 run's too.
"""

from __future__ import annotations

import argparse
import collections
import csv
import glob
import json
import os
import sys
from typing import Optional

import numpy as np


def resolve_model_auto(ckpt_dir: str) -> dict:
    """'--model auto': find the single trained model under ``ckpt_dir``.

    Each Trainer writes ``{ckpt_dir}/{model}/config.json`` (the resolved
    run config) next to its best/latest tracks; with exactly one such
    model dir, its name/num_classes/resize come from there.  Ambiguity
    (several models) or absence stays an explicit error rather than a
    guess."""
    hits = sorted(glob.glob(os.path.join(ckpt_dir, "*", "config.json")))
    if not hits:
        raise FileNotFoundError(
            f"--model auto: no <model>/config.json under {ckpt_dir} "
            "(pass --model explicitly)")
    if len(hits) > 1:
        names = [os.path.basename(os.path.dirname(h)) for h in hits]
        raise ValueError(
            f"--model auto: {len(hits)} trained models under {ckpt_dir} "
            f"({names}) — pass --model explicitly")
    with open(hits[0]) as f:
        saved = json.load(f)
    return {"name": saved["model"]["name"],
            "num_classes": int(saved["model"]["num_classes"]),
            "resize_size": int(saved["data"]["resize_size"]),
            "ema_decay": float(saved.get("optim", {}).get("ema_decay", 0.0))}


def sidecar_ema(ckpt_dir: str, model_name: str) -> float:
    """ema_decay from a checkpoint dir's config.json sidecar (0.0 when it
    is absent or unreadable)."""
    try:
        with open(os.path.join(ckpt_dir, model_name, "config.json")) as f:
            return float(json.load(f).get("optim", {}).get("ema_decay", 0.0))
    except (OSError, ValueError, TypeError):
        return 0.0


def run_predict(cfg, *, fold: str, track: str, top_k: int,
                out_path: Optional[str], limit: int = 0,
                device=None) -> dict:
    """Programmatic entry; returns summary stats (rows written, accuracy,
    the engine's counters and how many requests reached it on the
    device)."""
    import dataclasses

    import torch

    from tpuic_torch.checkpoint.loading import load_inference_variables
    from tpuic_torch.data.folder import ImageFolderDataset
    from tpuic_torch.data.pipeline import Loader
    from tpuic_torch.device import resolve_device
    from tpuic_torch.serve import InferenceEngine, default_buckets

    device = resolve_device(device)
    d = cfg.data
    # class_to_idx=None derives the canonical mapping from the train fold
    # when present (the order the checkpoint was trained with), else from
    # the requested fold.  A fold of images with NO class subdirectories
    # is scored unlabeled (label -1).
    ds = ImageFolderDataset(d.data_dir, fold, d.resize_size, d,
                            allow_unlabeled=True)
    has_labels = ds.labeled
    if d.pack:
        from tpuic_torch.data.pack import pack_folds
        ds, = pack_folds((ds,), d, lambda m: print("[predict]", m,
                                                   flush=True))
    num_classes = cfg.model.num_classes or ds.num_classes
    if num_classes <= 0:
        raise ValueError("--num-classes is required for an unlabeled fold "
                         "with no train/ tree to infer the classes from")
    mcfg = cfg.model
    if num_classes != mcfg.num_classes:
        mcfg = dataclasses.replace(mcfg, num_classes=num_classes)
    model = load_inference_variables(
        dataclasses.replace(cfg, model=mcfg), track=track, device=device,
        log=lambda *a: print("[predict]", *a))
    # Class names come from the fold tree; an unlabeled flat fold has none,
    # so predictions fall back to the raw class index as a string.
    idx_to_class = {i: c for c, i in ds.class_to_idx.items()}
    for i in range(num_classes):
        idx_to_class.setdefault(i, str(i))
    k = max(1, min(top_k, num_classes))

    # augment=False: a train fold is classified on clean images.
    batch_size = d.resolved_val_batch_size()
    loader = Loader(ds, batch_size, shuffle=False,
                    num_workers=d.num_workers, prefetch=d.prefetch,
                    augment=False, device=device)
    # Full batches take the one bucket == batch_size graph; the tail batch
    # submits only its valid rows, padded to the next bucket up.
    # max_wait_ms=0: offline requests are already batch-sized.
    engine = InferenceEngine(model, image_size=d.resize_size,
                             input_dtype=np.float32,
                             buckets=default_buckets(batch_size),
                             max_wait_ms=0.0, queue_size=8, device=device)
    engine.warmup()
    rows, correct, count = [], 0, 0
    done = False

    def consume(fut, ids, labels_v):
        nonlocal correct, count, done
        probs, order = fut.result()
        for i, image_id in enumerate(ids):
            if done:
                return
            row = {"image_id": image_id,
                   "label": idx_to_class.get(int(labels_v[i]), "")
                            if has_labels else "",
                   "pred": idx_to_class.get(int(order[i, 0]), ""),
                   "prob": f"{probs[i, order[i, 0]]:.6f}"}
            for j in range(1, k):
                row[f"pred_{j + 1}"] = idx_to_class.get(int(order[i, j]), "")
                row[f"prob_{j + 1}"] = f"{probs[i, order[i, j]]:.6f}"
            rows.append(row)
            if has_labels:
                correct += int(order[i, 0] == labels_v[i])
                count += 1
            if limit and len(rows) >= limit:
                done = True

    pending = collections.deque()
    full = 0
    try:
        for batch in loader.epoch(0):
            if done:
                break
            mask = batch["mask"].cpu().numpy() > 0  # epoch padding rows
            if not mask.any():
                continue
            # Full batches go in as the Loader's tensors, on the engine's
            # device; the tail batch keeps only its valid rows, still
            # there.
            imgs = batch["image"]
            labels_v = batch["label"].cpu().numpy()
            ids = batch.image_ids
            if mask.all():
                full += 1
            else:
                imgs = imgs[torch.from_numpy(mask).to(imgs.device)]
                labels_v = labels_v[mask]
                ids = [iid for iid, m in zip(ids, mask) if m]
            # ~2 requests in flight: batch N+1's load and copy overlap
            # batch N's device call.
            pending.append((engine.submit(imgs), ids, labels_v))
            while len(pending) >= 3:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
    finally:
        engine.close()

    if out_path:
        with open(out_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()) if rows
                               else ["image_id", "label", "pred", "prob"])
            w.writeheader()
            w.writerows(rows)
        print(f"[predict] wrote {len(rows)} rows -> {out_path}")
    summary = {"rows": len(rows), "fold": fold,
               "full_batches": full,
               "device_requests": engine.device_requests,
               "host_requests": engine.host_requests,
               "engine": engine.stats.snapshot()}
    if has_labels and count:
        summary["accuracy"] = 100.0 * correct / count
        print(f"[predict] accuracy over {count} labeled samples: "
              f"{summary['accuracy']:.2f}%")
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpuic_torch.predict",
        description="Classify an ImageFolder fold with a trained checkpoint")
    p.add_argument("--datadir", required=True)
    p.add_argument("--fold", default="val")
    p.add_argument("--model", default="auto",
                   help="backbone name, or 'auto' to read the single "
                        "trained model's config.json under --ckpt-dir")
    p.add_argument("--num-classes", type=int, default=0,
                   help="0 = infer from the folder tree")
    p.add_argument("--resize", type=int, default=None,
                   help="image size (default: the checkpoint config's size "
                        "under --model auto, else the reference's 299)")
    p.add_argument("--batchsize", type=int, default=64)
    p.add_argument("--ckpt-dir", default="dtmodel/cp")
    p.add_argument("--track", default="best", choices=("best", "latest"))
    p.add_argument("--init-from", default="",
                   help="reference torch checkpoint instead of a port one")
    p.add_argument("--out", default="", help="CSV output path")
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--limit", type=int, default=0,
                   help="stop after N rows (smoke runs)")
    p.add_argument("--no-pack", action="store_true",
                   help="decode each image on host threads instead of "
                        "packing the fold into the uint8 cache")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on "
                        "the CPU)")
    args = p.parse_args(argv)
    prog = "python -m tpuic_torch.predict"

    from tpuic_torch.config import Config, DataConfig, OptimConfig, RunConfig
    model, num_classes, resize = args.model, args.num_classes, args.resize
    ema_decay = 0.0
    if model == "auto":
        if args.init_from:
            raise SystemExit(f"{prog}: --model auto needs a port "
                             "--ckpt-dir; with --init-from pass --model "
                             "explicitly")
        saved = resolve_model_auto(args.ckpt_dir)
        model = saved["name"]
        num_classes = num_classes or saved["num_classes"]
        ema_decay = saved["ema_decay"]  # EMA checkpoints score with EMA
        if resize is None:  # explicit --resize always wins
            resize = saved["resize_size"]
        print(f"[predict] auto-resolved model '{model}' "
              f"(num_classes={num_classes}, resize={resize}) from "
              f"{args.ckpt_dir}")
    elif not args.init_from:
        # Explicit --model: this model's sidecar still says whether the
        # checkpoint scores its EMA weights (the ones 'best' was picked on).
        ema_decay = sidecar_ema(args.ckpt_dir, model)
    if resize is None:
        resize = 299  # the reference's hard-coded size (train.py:110)
    cfg = Config(
        data=DataConfig(data_dir=args.datadir, resize_size=resize,
                        batch_size=args.batchsize,
                        val_batch_size=args.batchsize,
                        pack=not args.no_pack),
        model=serving_model_config(model, num_classes),
        optim=OptimConfig(ema_decay=ema_decay),
        run=RunConfig(ckpt_dir=args.ckpt_dir, init_from=args.init_from),
    )
    summary = run_predict(cfg, fold=args.fold, track=args.track,
                          top_k=args.top_k, out_path=args.out or None,
                          limit=args.limit, device=args.device)
    print(json.dumps(summary))
    return 0


def serving_model_config(name: str, num_classes: int):
    """The ``ModelConfig`` the port serves and scores with, whatever dtype
    the run trained in: float32, the fused conv+BN+ReLU kernel for ResNets
    and flash attention for ViTs (the forwards that carry the kernels)."""
    from tpuic_torch.config import ModelConfig
    return ModelConfig(name=name, num_classes=num_classes, dtype="float32",
                       fused_conv_bn=True, attention="flash")


if __name__ == "__main__":
    sys.exit(main())
