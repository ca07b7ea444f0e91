"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--requests N] [--seed S] [--out smoke.json]

Drives ``tpuic_torch``'s serving and training paths on the card and exits
non-zero at the first phase that fails:

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions.
   Refuses to run without CUDA.
2. build  — every kernel source in ``tpuic_torch/kernels/csrc`` compiled
   by ``nvcc`` (one process per source, started together).
3. kernel — the fused conv+BN+ReLU kernel (K3) at every distinct conv
   shape a ResNet-50 forward at 224x224 launches, plus the space-to-depth
   stem, at batch 8 and at batch 32 (the engine's largest bucket): held
   against its plain PyTorch version (float32, TF32 off, atol/rtol 1e-4;
   bf16 x with float32 w at every shape, atol/rtol 1e-2, two bf16 ulps of
   the output), and timed per call from Python as every kernel is
   (``ms``), and on the card alone (``device_ms``: the card sleeps while
   the host enqueues the calls, so launch cost stays out), beside the
   plain version, one cuDNN call that
   computes the same float32 function (TF32 off; timed only, the port
   never calls it), the same call with TF32 on (a less exact function, for
   information), and the bound: FLOPs at the rate of the kernel's 3xTF32
   products (a third of the TF32 peak) or bytes over HBM bandwidth,
   whichever is larger, with the float32 CUDA-core bound beside it.  Each
   row names its plan (block height, K slices, gather).  Then the bits: a
   row at batch 1 must equal the same row inside batch 32 at a split-K
   shape, the bits must not move with the TF32 flags, and the plain
   version on TF32-rounded inputs must fall outside 1e-4 (so the check
   tells one TF32 pass from 3xTF32).  bf16 x (the serve ladder's bf16
   rung) is timed per shape too, beside its plain version and one cuDNN
   bf16 convolution of the same x with the folded weights in bf16 and the
   earlier bf16 design (the mma.sync build, at the shapes the wgmma build
   now runs), with bf16 w as the bf16 rung folds it (held too), its bound
   at the rate of its products (one bf16 wgmma product, or two TF32 MMAs
   in the mma.sync build), and summed per forward.
4. model  — ``create_model("resnet50", 1000, dtype="float32",
   fused_conv_bn=True)`` with seeded synthetic weights: its logits at
   batch 4 against the same weights through the unfused cuDNN branch (TF32
   off, atol/rtol 1e-3: float32 sums in another order through 53 layers),
   and exactly 53 kernel launches per forward.  Then the unfused branch
   through the engine's ``make_forward`` under torch's default flags: a
   row's probabilities at batch 1 and inside batch 32 agree within 1e-5.
5. serve  — ``InferenceEngine`` (uint8 in, normalized in the forward,
   buckets 1/8/32, one CUDA graph per bucket captured at warmup, the
   device memory the graphs hold reported) answering a few hundred
   requests of 1-8 images from eight closed-loop client threads: every
   future resolves with the right shape, a sample matches a direct
   forward (1e-5), and the kernel launches 53 times per device call
   during the run (each replay adds the launches its graph captured).
   Then at every bucket a graph replay against an eager forward of the
   same batch (the same bits, or within 1e-6, as reported), and a batch-8
   device call replayed and eager, timed from Python, on the card alone
   and as host cost per call.  The requests' numpy rows reach the card
   through two page-locked staging buffers a bucket (their bytes are in
   the graph-memory line).
6. swap   — the engine's hot swap through the graphs: ResNet-50 weights A
   (``[model]``'s) served to eight closed-loop clients and swapped to B
   (another seed) after a third of SWAP_REQUESTS; traffic goes on until
   a third more are submitted after the swap returned.  Every answer is A's
   or B's within 1e-5, every one submitted after the swap B's, and the
   kernel launches 53 times per device call and per standby capture.  Then
   three swaps with traffic stopped (A, B, A): each bucket's replay
   launches 53 kernels and equals an eager forward of the weights just
   swapped in bit for bit (K3's folded weights are refolded in place), and
   the graph memory and allocated bytes after the fourth swap equal those
   after the second.  Each swap's duration, captures and the host time it
   held the batcher, and the latency of requests that span the flip, are
   printed.
7. admission — priorities, quotas and deadline shedding: a ResNet-50
   engine with queue 32 and an ``AdmissionController`` quota on a flood
   tenant, four threads flooding ``low`` requests of 8 images and one
   thread sending ``high`` requests with ``deadline_ms`` (every fifth too
   tight to meet) for ADMISSION_S: accepted + rejected == offered, the
   causes queue_full, quota and deadline all seen, no ``high`` request
   evicted, ``high``'s p50 latency below ``low``'s.
8. xent   — the fused cross-entropy forward and backward kernels (K1) at
   [128, 1000] and [128, 7], label smoothing 0 and 0.1, against their
   plain versions (rtol 1e-5 / atol 1e-6: float32 row sums in another
   order), plus class-weighted, masked cases with an out-of-range label
   at C = 1, 7, 1000 and 21843 (w exact); the earlier design
   (``cross_entropy_bench``) within the same tolerance; the backward's
   bits for every row of a batch of 128 equal to that row's alone (C = 1,
   7, 1000, 21843: a row is one team of threads, whatever its alignment)
   and equal on two calls; timed per call from Python beside the plain
   versions, the bound and one ``F.cross_entropy`` call (forward for K1f,
   forward + backward for K1b), and on the card alone (the median of 5
   replays of a CUDA graph of 100 calls) for K1f, K1b, both their earlier
   designs and ``F.cross_entropy``'s forward and forward + backward (its
   backward alone reported as the difference of the two).
9. optim  — the fused LARS and LAMB update kernels (K2) over the whole
   ResNet-50 + head parameter list (167 leaves, flax-default init, so the
   zero BN biases take the trust = 1 branch), against their plain versions
   (rtol 1e-5 / atol 1e-7: the trust-ratio norms are summed in another
   order), the same bits on two runs, and LAMB's debias factors (computed
   by the kernel from the device count) within 1 ulp of the plain
   version's; timed per call from Python and on the card alone (the
   median of 5 replays of a CUDA graph of 100 back-to-back updates, with
   the replays' spread), and the wrappers' host cost per call (``host_ms``,
   the median of 5 windows of 20 calls enqueued without a synchronise),
   beside the plain versions and the bound (no single PyTorch call
   computes a LARS or LAMB update).  Each also through
   its earlier design (``optimizer_update_bench``), held and timed the
   same way.
10. train  — ``Trainer`` on a synthetic 224x224 ImageFolder written by
   ``tpuic_torch.data.synthetic``: ResNet-50, float32, batch 128, LARS lr
   4.8 / wd 1e-4 / 5 warmup epochs of a 90-epoch schedule, label smoothing
   0.1, no class weights, fused loss and fused optimizer, for 12 steps, then
   one val pass through the conv+BN+ReLU kernel.  Every launch count is set
   to 0 before the run and read after it: K1 forward and backward launch
   once per step, K2 LARS once per step, K3 53 times per val forward.
   Then 3 steps at a constant lr of 0.48 from one initial state on the
   same 3 batches, once through the kernels and once through the plain
   loss and plain LARS, TF32 off and cuDNN deterministic: the per-step
   losses agree within rtol 1e-3.  Last, a 3-step LAMB run at
   batch 32 through the Trainer, counted the same way, puts K2 LAMB on the
   path.
11. ckpt   — the checkpoint (``tpuic_torch/checkpoint/manager.py``) with
   ``train``'s configuration: a ``Trainer`` takes 3 steps and saves
   ``best`` and ``latest``; a fresh ``Trainer`` restores them, and every
   parameter, BN buffer and K2 optimizer-state tensor must equal the saved
   one bit for bit; the next step's loss on one batch, cuDNN
   deterministic, must equal the uninterrupted trainer's exactly; with one
   byte of ``latest``'s payload flipped the restore must fall back to
   ``best``, bit for bit.  The payload's bytes and the host and disk
   seconds to snapshot, commit and restore are reported.
12. serve-cli — ``python -m tpuic_torch.serve --model auto`` as a
   subprocess on ``ckpt``'s ResNet-50 checkpoint: 48 image files of the
   synthetic folder over stdin JSONL, each record's top-5 probabilities
   within 1e-5 of a direct forward of the same decoded pixels; then a
   ``--listen`` server: ready file, a ping answered with the model's
   digest, requests by path and by b64 array, a burst and SIGTERM, after
   which it exits 0 with every request answered.
13. swap-cli — ``{"op": "swap"}`` lines through a ``--listen`` server on
   that checkpoint: a swap to ``synthetic_seed`` 1 with requests in flight (a
   ``swap_result`` of generation 1; the next pong and the ready file carry
   its digest), a swap back to the checkpoint by ``ckpt_dir`` (answers
   equal a direct forward within 1e-5, the digest ``serve-cli``'s), a swap
   from a copy with one byte flipped (a typed ``swap_corrupt`` record, the
   digest and generation unchanged), then SIGTERM: exit 0, every request
   answered.
14. predict — ``python -m tpuic_torch.predict``'s ``main`` over the val
   fold from that checkpoint's ``best`` track at the ``Trainer``'s val
   batch: its accuracy equals the ``Trainer``'s val accuracy for the save
   exactly, every batch reaches the engine as a tensor on the card, and
   K3 launches 53 times per device call.
15. attn  — the flash-attention kernels (K4: forward, dq, dk/dv) at the
   ViT-B/16 shapes [8, 197, 12, 64] and [64, 197, 12, 64], on strided
   q/k/v views of one qkv projection, against their plain versions
   (float32, TF32 off, atol/rtol 1e-4; bfloat16 at 1e-2); in float32 the
   forward and the backward again with TF32 allowed, which must give the
   same bits (they are 3xTF32 whatever the flag says), and the plain
   forward and backward in single-pass TF32, which must each fall outside
   the 1e-4 tolerance (so the check tells TF32 from 3xTF32); plus a
   ``valid_len`` case (50 of 64 keys) and a
   fully masked case (o = 0, lse = the sentinel, for sentinels 0 and
   -1e30), in float32 and in bf16, plus [2, 300, 12, 64] (bf16's
   forward refills its key ring there).  bf16 at D = 64 runs K4f's TMA and
   wgmma build (``flash_fwd_sm90.cu``); the earlier mma.sync bf16 forward
   is held and timed beside it.  Each kernel is timed beside its plain
   version and one
   ``F.scaled_dot_product_attention`` call (timed only): the forward
   beside K4f; SDPA's backward alone (from one forward outside the timed
   calls) and its forward + backward beside the sum of dq and dk/dv, as
   no one call computes either alone; the forward and SDPA's also on the
   card alone.  The bound is at the rate of the products each kernel
   issues, 3xTF32 or bf16 MMAs (the float32 CUDA-core bound beside it).
16. vit   — ``create_model("vit-b16", 1000, dtype="float32",
   attention="flash")`` with seeded synthetic weights: its logits at batch
   4 against the same weights under ``attention="dense"`` (TF32 off,
   atol/rtol 1e-3), and exactly 12 K4 forward launches per forward.
17. vit-serve — the engine serving that model as ``serve`` serves
   ResNet-50 (graphs, their memory, graph against eager, the batch-8
   times), under torch's default flags: 12 K4 forward launches per device
   call.
18. vit-swap — ``swap``'s traffic and checks on that model (B another
   seed), with one stopped swap: 12 K4 forward launches per device call.
19. vit-train — ``Trainer`` on the ImageFolder of ``train``: ViT-B/16 with
   the repo's ViT recipe (recipes/README.md, section 4: AdamW lr 3e-4, wd
   0.05, 10 warmup epochs of 300, label smoothing 0.1, clipping at 1.0,
   batch 64), ``attention="flash"`` and the fused loss, for 12 steps, then
   one val pass, in float32 and in bf16 (``compute_dtype`` bf16: K4's bf16
   kernels forward and backward; a forward hook holds every attention
   block's input and output to bfloat16).  Launches per arm: K4 forward 12
   per step and 12 per val forward, dq and dk/dv 12 per step, K1 once per
   step.  The bf16 arm's logged losses (steps 4, 8, 12) lie within
   BF16_LOSS_RTOL (2e-2) of the float32 arm's.  Then 3 steps from one
   state through the kernels, through dense attention and the plain loss
   (TF32 off: the per-step losses agree within rtol 1e-3), and through the
   kernels in bf16 (within BF16_LOSS_RTOL of the float32 kernels').
20. ladder — the serve dtype ladder (``tpuic_torch.quant``: fp32, bf16,
   int8) for ResNet-50 (224 px, K3 on every rung), InceptionV3 (299 px,
   no kernel) and ViT-B/16 (224 px, K4f on every rung, its bf16 build on
   the bf16 rung), each at full width with synthetic weights: the accuracy
   gate (each rung's top-1 agreement with fp32 on
   ``quant.eval_images(128)`` at least 1 - DEFAULT_EPSILON, a corrupted
   int8 rung below it), each rung's batch-1 row against batch 32 within
   RUNG_ROW_TOL (stated before the first run: fp32 and int8 1e-5, bf16
   1e-2) wherever the engine runs the rung at every bucket (a bf16 rung
   on cuDNN's convolutions, InceptionV3's, runs at the largest bucket
   only: its rows are reported, and the same for EfficientNet-B3 and an
   unfused ResNet-50), each rung's weight bytes (int8's quantized leaves
   beside their float32 bytes), then one engine with a graph per (rung,
   bucket): per rung ``[serve]``'s client mix in LADDER_WINDOWS windows
   (images/s of each and their median and spread, p50/p99, spans, graph
   pool by rung, launches per device call, answers within RUNG_SERVE_TOL
   of the rung's direct forward) and LONE_REQUESTS one-image requests one
   at a time (the bucket they ride, latency, device span); the bf16
   rung's lone requests again at the serve CLI's default buckets (1, 8,
   32, 128); for ResNet-50 one swap of the whole ladder under mixed
   traffic, every answer the old or the new ladder's and every one
   submitted after the swap the new one's.
21. serve-cli-ladder — ``python -m tpuic_torch.serve --serve-dtypes
   fp32,bf16,int8`` on ``ckpt``'s checkpoint: its start gate's lines, and
   CLI_IMAGES image files over stdin naming the rungs in turn with
   ``serve_dtype``, each record within its rung's bound of the rung's
   direct forward.

22. inception — ``create_model("inceptionv3", 1000, dtype="float32")`` at
   299x299 with seeded synthetic weights, eval forward: a row's
   probabilities at batch 1 and inside batch 32 agree within 1e-5
   (``make_forward``, TF32 off), then ``serve``'s engine, clients and graph
   checks at 299 px.  No kernel lies on this forward (K3 is ResNet-only, as
   in ``tpuic``): every launch count must stay 0.
23. inception-train — the reference's recipe (InceptionV3 with its aux
   head, 299 px, Adam lr 0.5e-5, the 7 class weights) on a synthetic
   7-class ImageFolder at batch 32 with the fused loss, through
   ``Trainer``: 12 steps in float32 and 12 in bf16 (``compute_dtype``
   bf16), each launching K1 forward and backward twice a step (main and
   aux logits), master weights and Adam moments float32 after, and every
   convolution of the first step returning the arm's dtype (a forward
   hook); then 3 steps from one state through the kernels and through the
   plain loss (float32, TF32 off: loss rtol 1e-3), and through the
   kernels in bf16 (loss within BF16_LOSS_RTOL, 2e-2, of the float32
   kernels', every convolution's output bfloat16).
24. ref-cli — the reference's own command, ``python -m tpuic_torch.train
   --datadir D --epochs 1 --no-pack --no-native --ckpt-dir C``, as a
   subprocess with its defaults (InceptionV3, bfloat16, Adam, batch 4, the
   class weights; the plain loss, as ``--fused-loss`` is off) on 7 classes
   at 299 px, 8 train and 4 val images a class: exit 0, ``best`` and
   ``latest`` written.  Predict scores ``best`` in float32, as the serve
   CLI serves every checkpoint; the ``Trainer``'s own bf16 forward,
   through ``run_predict``, must score it as the ``Trainer`` did, and the
   two may disagree on at most REF_PREDICT_LIMIT (2) of the 28 images.
25. digits — the port's first real-data run: the
   handwritten digits written from ``tpuic_torch/data/digits_split.npz``
   (1,438 train, 359 val), the train CLI's ``main`` with the recipe of
   ``perf/convergence_digits.json`` (``resnet18-cifar``, 32 px, batch 128,
   SGD lr 0.05, 3 warmup epochs of a 40-epoch cosine, wd 5e-4, no
   augmentation, no class weights, the fused loss), once in float32 and
   once in bf16: per-epoch val top-1, each arm's best at least DIGITS_BOUND
   (350/359 = 97.49%, stated before the first run), K1 once forward and
   once backward a step, each convolution of the first step in the arm's
   dtype.  Predict scores each ``best`` in float32 through K3, as served:
   it may disagree with the ``Trainer``'s own forward on at most
   DIGITS_PREDICT_LIMIT (3) images, and in the float32 arm its accuracy
   equals the ``Trainer``'s.
26. effnet-serve — ``inception``'s checks and serving for EfficientNet-B3
   at 300x300, 1000 classes, seeded synthetic weights.

Every launch count is set to 0 just before a path runs and read just after
it.  Cuts: ResNet-50 trains in float32 (bf16 runs the ViT-B/16,
InceptionV3 and digits training phases); bf16 and int8 serving run in
``ladder``; no mixup, CutMix, random erasing, EMA or drop-path; one
card.  ``timing`` prints each new phase's
seconds and the run's total.

The second-to-last lines are the per-kernel JSON summary (K1's
``launches`` are ``[train]``'s; its ``launches_by_path`` gives each
training path's count; K3's and K4's bf16 builds have rows of their own,
with the launches of the bf16 paths) and the card's name and power
limit; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpuic_torch.kernels.conv_bn_relu_bench import (device_ms,
                                                    resnet50_launches,
                                                    s2d_stem_launch)

BATCH = 8
SERVE_BATCH = 32   # the engine's largest bucket, which carries most images
IMAGE = 224
F32_TOL = 1e-4
BF16_TOL = 1e-2
MODEL_TOL = 1e-3
SERVE_TOL = 1e-5
GRAPH_TOL = 1e-6   # a graph replay against an eager forward, when not bitwise
CLI_IMAGES = 48    # image files the serve CLI answers over stdin
SWAP_REQUESTS = 160  # closed-loop requests in each [swap] phase
FLOOD_RPS = 1000   # the [admission] flood tenant's quota, requests/s
ADMISSION_S = 3.0  # how long the [admission] flood runs
XENT_RTOL, XENT_ATOL = 1e-5, 1e-6
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
TRAIN_LOSS_RTOL = 1e-3
COMPARE_LR = 0.48
TRAIN_BATCH = 128
TRAIN_STEPS = 12
TRAIN_CLASSES = 8
LAMB_BATCH = 32
CKPT_STEPS = 3
INC_IMAGE = 299     # the reference's resize (train.py:110)
INC_BATCH = 32
EFF_MODEL = "efficientnet-b3"
EFF_IMAGE = 300     # EfficientNet-B3's published resolution
REF_WEIGHTS = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)  # train.py:157-158
BF16_LOSS_RTOL = 2e-2
DIGITS_EPOCHS = 40
DIGITS_BOUND = 100.0 * 350 / 359  # at most 3 val images below 98.33
# Val images on which predict (float32, as served) may score a run's best
# otherwise than its Trainer's own forward, stated before the first run.
DIGITS_PREDICT_LIMIT = 3  # of 359
REF_PREDICT_LIMIT = 2     # of 28
VIT_MODEL = "vit-b16"
VIT_BATCH = 64
VIT_LR = 3e-4
VIT_COMPARE_LR = 3e-5
VIT_LAYERS = 12
ATTN_N, ATTN_H, ATTN_D = 197, 12, 64
ATTN_BATCHES = (8, VIT_BATCH)
LADDER_REQUESTS = 320  # closed-loop requests a window in [ladder]
LADDER_WINDOWS = 3     # windows a rung; images/s is their median
LONE_REQUESTS = 20     # one-image requests a rung, one at a time
# Each rung's batch-1 row against its row of a batch-32 forward, the
# largest probability difference allowed, stated before the first run on
# the card: fp32 and int8 compute in float32 with TF32 off (int8 widens
# its weights first), rows independent of their bucket; bf16 rounds every
# layer's output to 8 mantissa bits, and cuDNN and cuBLAS may take other
# algorithms at another batch.
RUNG_ROW_TOL = {"fp32": SERVE_TOL, "bf16": 1e-2, "int8": SERVE_TOL}
# Served answers against the same rung's direct forward (another bucket).
RUNG_SERVE_TOL = RUNG_ROW_TOL

# Published dense peaks by card variant (NVIDIA data sheets): float32
# outside the tensor cores, and HBM bandwidth.  The name nvidia-smi reports
# picks the row; "H100 80GB HBM3" is the SXM part.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H200", 67.0e12, 4.8e12), ("H100", 67.0e12, 3.35e12))
# Dense TF32 and bf16 tensor-core peaks of the same parts: the rates of
# the backward flash kernels' 3xTF32 and bf16 MMAs.
TF32_PEAKS = (("H100 PCIe", 378e12), ("H100 NVL", 417.5e12),
              ("H200", 495e12), ("H100", 495e12))
BF16_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
              ("H200", 989e12), ("H100", 989e12))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail("device", f"nvidia-smi exited {out.returncode}: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return key, flops, bw
    fail("device", f"no published peak for {name!r}")


def tf32_peak(name: str) -> float:
    return next(p for key, p in TF32_PEAKS if key in name)


def bf16_peak(name: str) -> float:
    return next(p for key, p in BF16_PEAKS if key in name)


def host_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Host milliseconds per call to enqueue ``iters`` back-to-back calls
    (no synchronise inside a window, one between windows), the median of
    ``repeats`` windows: a wrapper's own cost.  A window is short enough
    that the card's launch queue never fills, and the median keeps one
    stall of the shared host out."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) / iters * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def work(xs, ws, stride, padding, dtype_bytes=4):
    """(FLOPs, bytes) one launch must do: 2*M*N*K multiply-adds, and each
    input read once (x, w, scale, bias) and the output written once."""
    from tpuic_torch.kernels.conv_bn_relu import norm_padding
    (pt, pb), (pl, pr) = norm_padding(padding)
    b, h, w, cin = xs
    kh, kw, _, cout = ws
    ho = (h + pt + pb - kh) // stride + 1
    wo = (w + pl + pr - kw) // stride + 1
    flops = 2.0 * b * ho * wo * cout * kh * kw * cin
    nbytes = dtype_bytes * (math.prod(xs) + b * ho * wo * cout) + \
        4 * (math.prod(ws) + 2 * cout)
    return flops, nbytes


def bound(ops: float, nbytes: float, peak_flops: float, hbm: float):
    """``(bound_ms, bound_by)``: the larger of operations over
    ``peak_flops`` and bytes over the HBM bandwidth."""
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / hbm * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def max_err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def library_call(x, w_folded_cl, bias, stride, padding, relu):
    """One cuDNN call computing conv + folded BN (+ ReLU) on channels_last
    data: the yardstick.  The s2d stem's (2, 1) padding runs as a
    symmetric 2 with the extra output row and column sliced off."""
    from tpuic_torch.kernels.conv_bn_relu import norm_padding
    (pt, _), (pl, _) = norm_padding(padding)
    xc = x.permute(0, 3, 1, 2)
    if relu:
        y = torch.cudnn_convolution_relu(xc, w_folded_cl, bias,
                                         (stride, stride), (pt, pl), (1, 1),
                                         1)
    else:
        y = F.conv2d(xc, w_folded_cl, bias, stride, (pt, pl))
    return y


def tf32_round(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero): the inputs of a single-pass TF32 product."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv_inputs(xs, ws, gen):
    k_red = ws[0] * ws[1] * ws[2]
    x = torch.randn(xs, generator=gen).cuda()
    w = (torch.randn(ws, generator=gen) / math.sqrt(k_red)).cuda()
    scale = (1.0 + 0.1 * torch.randn(ws[3], generator=gen)).cuda()
    bias = (0.1 * torch.randn(ws[3], generator=gen)).cuda()
    return x, w, scale, bias


def kernel_row(device_name, spec, per_fwd, gen, batch):
    """One K3 shape at ``batch``: held against its plain version (float32
    at F32_TOL; bf16 x with float32 w at BF16_TOL), then timed beside the
    plain version and one cuDNN call with TF32 off (``library_ms``, the same
    float32 function) and on (``library_tf32_ms``, a less exact one, for
    information).  ``ms`` and the ``library`` times are back-to-back calls
    from Python (``time_ms``, as every kernel's row); ``device_ms`` and the
    ``library`` ``device_ms`` times are the card's alone (``device_ms``).
    The bound is at the rate of the products the kernel
    issues, 3xTF32 (FLOPs over a third of the TF32 peak), or bytes over HBM
    bandwidth if larger; the float32 CUDA-core bound stands beside it."""
    from tpuic_torch.kernels.conv_bn_relu import (fused_conv_bn_relu,
                                                  fused_conv_bn_relu_plain,
                                                  no_tf32, plan, takes_sm90)
    from tpuic_torch.kernels.conv_bn_relu_bench import earlier_bf16_conv
    _, peak_flops, hbm = peaks(device_name)
    xs, ws, stride, padding, relu = spec
    xs = (batch,) + tuple(xs[1:])
    x, w, scale, bias = conv_inputs(xs, ws, gen)

    def kernel():
        return fused_conv_bn_relu(x, w, scale, bias, strides=stride,
                                  padding=padding, relu=relu)

    def plain():
        return fused_conv_bn_relu_plain(x, w, scale, bias, stride, padding,
                                        relu)

    w_folded = (w * scale).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def library():
        return library_call(x, w_folded, bias, stride, padding, relu)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL):
        fail("kernel", f"x {xs} w {ws} s{stride} p{padding}: max abs err "
                       f"{err} beyond atol/rtol {F32_TOL}")
    xb = x.to(torch.bfloat16)
    gotb = fused_conv_bn_relu(xb, w, scale, bias, strides=stride,
                              padding=padding, relu=relu).float()
    wantb = fused_conv_bn_relu_plain(xb, w, scale, bias, stride, padding,
                                     relu).float()
    bf16_err = float((gotb - wantb).abs().max())
    if not torch.allclose(gotb, wantb, rtol=BF16_TOL, atol=BF16_TOL):
        fail("kernel", f"bf16 x {xs} w {ws}: max abs err {bf16_err} beyond "
                       f"atol/rtol {BF16_TOL}")
    del gotb, wantb
    # bf16 x and bf16 w, as the serve ladder's bf16 rung folds them (the
    # check above held a float32 w, which the wgmma build takes as two bf16
    # parts), beside one cuDNN bf16 convolution of the same x with the
    # folded weights in bf16, and the earlier bf16 design (the mma.sync
    # build, with the same w widened to float32) where the wgmma build now
    # runs the shape.
    wb = w.to(torch.bfloat16)
    gotb = fused_conv_bn_relu(xb, wb, scale, bias, strides=stride,
                              padding=padding, relu=relu).float()
    wantb = fused_conv_bn_relu_plain(xb, wb, scale, bias, stride, padding,
                                     relu).float()
    bf16_err = max(bf16_err, float((gotb - wantb).abs().max()))
    if not torch.allclose(gotb, wantb, rtol=BF16_TOL, atol=BF16_TOL):
        fail("kernel", f"bf16 x, bf16 w {xs} w {ws}: max abs err "
                       f"{float((gotb - wantb).abs().max())} beyond atol/rtol "
                       f"{BF16_TOL}")
    del gotb, wantb
    w_folded_b = (wb.float() * scale).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).to(torch.bfloat16)
    bias_b = bias.to(torch.bfloat16)
    sm90 = takes_sm90(xs, ws, torch.bfloat16)

    def kernel_b():
        return fused_conv_bn_relu(xb, wb, scale, bias, strides=stride,
                                  padding=padding, relu=relu)

    def library_b():
        return library_call(xb, w_folded_b, bias_b, stride, padding, relu)

    def plain_b():
        return fused_conv_bn_relu_plain(xb, wb, scale, bias, stride, padding,
                                        relu)

    def earlier_b():
        return earlier_bf16_conv(xb, wb.float(), scale, bias, stride,
                                 padding, relu)

    flops_b, bytes_b = work(xs, ws, stride, padding, dtype_bytes=2)
    bf16 = {"ms": time_ms(kernel_b), "device_ms": device_ms(kernel_b),
            "plain_ms": time_ms(plain_b), "library_ms": time_ms(library_b),
            "library_device_ms": device_ms(library_b),
            "flops": flops_b, "bytes": bytes_b}
    if sm90:
        erb = earlier_b().float()
        bf16["earlier_max_abs_err"] = float((erb - kernel_b().float())
                                            .abs().max())
        bf16["earlier_ms"] = time_ms(earlier_b)
        bf16["earlier_device_ms"] = device_ms(earlier_b)
        del erb
    else:
        bf16["earlier_ms"], bf16["earlier_device_ms"] = (bf16["ms"],
                                                         bf16["device_ms"])
    # The bound at the card's bf16 peak for every shape.  The mma.sync
    # build (the stem) issues two TF32 MMAs a product: that rate's time
    # stands beside the bound, not as it.
    bf16["bound_ms"], bf16["bound_by"] = bound(
        flops_b, bytes_b, bf16_peak(device_name), hbm)
    bf16["issue_rate_ms"] = bound(
        flops_b, bytes_b, bf16_peak(device_name) if sm90
        else tf32_peak(device_name) / 2, hbm)[0]
    del xb, wb, w_folded_b, bias_b
    with no_tf32():
        lib = library().permute(0, 2, 3, 1)
        lib_err = float((lib[:, :want.shape[1], :want.shape[2]]
                         - want).abs().max())
        ms_lib = time_ms(library), device_ms(library)
    with tf32_on():
        ms_lib_tf32 = time_ms(library), device_ms(library)
    flops, nbytes = work(xs, ws, stride, padding)
    bound_ms, bound_by = bound(flops, nbytes, tf32_peak(device_name) / 3, hbm)
    core_ms, core_by = bound(flops, nbytes, peak_flops, hbm)
    pl = plan(xs, ws, stride, padding)
    row = {"x": list(xs), "w": list(ws), "stride": stride,
           "padding": padding, "relu": relu, "per_forward": per_fwd,
           "plan": {"bm": pl.bm, "splits": pl.splits, "gather": pl.gather},
           "max_abs_err": err, "bf16_max_abs_err": bf16_err,
           "library_max_abs_err": lib_err,
           "ms": time_ms(kernel), "device_ms": device_ms(kernel),
           "plain_ms": time_ms(plain), "library_ms": ms_lib[0],
           "library_device_ms": ms_lib[1], "library_tf32_ms": ms_lib_tf32[0],
           "library_tf32_device_ms": ms_lib_tf32[1],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "fp32_core_bound_ms": core_ms, "fp32_core_bound_by": core_by,
           "flops": flops, "bytes": nbytes, "bf16": bf16}
    row["share_of_bound"] = bound_ms / row["ms"]
    row["device_share_of_bound"] = bound_ms / row["device_ms"]
    log("kernel", json.dumps(row))
    return row


def kernel_bits(gen):
    """The float32 kernel's bits: a row at batch 1 equals the same row
    inside batch 32 (stage-4 3x3x512 at 7x7, a split-K shape), and the
    same under both TF32 flags; and the tolerance tells 3xTF32 from one
    TF32 pass (the plain version on TF32-rounded inputs must fall outside
    it).  Returns that control's max abs error."""
    from tpuic_torch.kernels.conv_bn_relu import (fused_conv_bn_relu,
                                                  fused_conv_bn_relu_plain,
                                                  no_tf32, plan)
    xs, ws, stride, padding, relu = resnet50_launches(32)[-2]
    x, w, scale, bias = conv_inputs(xs, ws, gen)
    kw = dict(strides=stride, padding=padding, relu=relu)
    with no_tf32():
        big = fused_conv_bn_relu(x, w, scale, bias, **kw)
        for row in (0, 13, 31):
            one = fused_conv_bn_relu(x[row:row + 1].contiguous(), w, scale,
                                     bias, **kw)
            if not torch.equal(one[0], big[row]):
                fail("kernel", f"x {xs} w {ws}: row {row} at batch 1 differs "
                               "from the same row in batch 32 (max abs "
                               f"{float((one[0] - big[row]).abs().max())})")
        want = fused_conv_bn_relu_plain(x, w, scale, bias, stride, padding,
                                        relu)
        single = fused_conv_bn_relu_plain(tf32_round(x), tf32_round(w),
                                          scale, bias, stride, padding, relu)
    with tf32_on():
        on = fused_conv_bn_relu(x, w, scale, bias, **kw)
    torch.cuda.synchronize()
    if not torch.equal(on, big):
        fail("kernel", f"x {xs} w {ws}: bits differ between allow_tf32 "
                       "False and True")
    err = float((single - want).abs().max())
    if torch.allclose(single, want, rtol=F32_TOL, atol=F32_TOL):
        fail("kernel", f"the plain version on TF32-rounded inputs is within "
                       f"atol/rtol {F32_TOL} of float32 (max abs err {err}), "
                       "so the check cannot tell one TF32 pass from 3xTF32")
    log("kernel", f"x {xs} w {ws} ({plan(xs, ws, stride, padding)}): rows "
                  "0, 13, 31 bitwise equal at batch 1 and in batch 32; "
                  "bitwise equal under allow_tf32 False and True; the plain "
                  f"version on TF32-rounded inputs is {err} off, outside "
                  f"atol/rtol {F32_TOL}")
    return err


def phase_kernel(device_name: str, gen: torch.Generator):
    """K3 at every distinct conv shape of a ResNet-50 forward at 224x224 and
    at the s2d stem, at batch 8 and 32; then its bits.  Returns the
    summary (per-forward sums at batch 8, and at batch 32 beside them),
    every row, and the TF32 control's error."""
    sums, rows = {}, []
    for batch in (BATCH, SERVE_BATCH):
        launches = resnet50_launches(batch)
        counts = {}
        for spec in launches:
            counts[spec] = counts.get(spec, 0) + 1
        shapes = list(counts.items()) + [(s2d_stem_launch(batch), 0)]
        log("kernel", f"{len(counts)} distinct ResNet-50 conv shapes "
                      f"({len(launches)} launches per forward) + the s2d "
                      f"stem, batch {batch}")
        part = [kernel_row(device_name, spec, n, gen, batch)
                for spec, n in shapes]
        rows += part
        fwd = [r for r in part if r["per_forward"]]
        # Per ResNet-50 forward: each shape's time times its launches per
        # forward, summed.
        sums[batch] = {k: sum(r[k] * r["per_forward"] for r in fwd)
                       for k in ("ms", "device_ms", "plain_ms",
                                 "library_ms", "library_device_ms",
                                 "library_tf32_ms", "library_tf32_device_ms",
                                 "bound_ms", "fp32_core_bound_ms")}
        sums[batch]["over_library"] = (sums[batch]["ms"]
                                       / sums[batch]["library_ms"])
        b16 = {k: sum(r["bf16"][k] * r["per_forward"] for r in fwd)
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_device_ms", "bound_ms", "issue_rate_ms",
                         "earlier_ms", "earlier_device_ms")}
        # What bounds most of the forward's bound time.
        by = {}
        for r in fwd:
            by[r["bf16"]["bound_by"]] = by.get(r["bf16"]["bound_by"], 0.0) \
                + r["bf16"]["bound_ms"] * r["per_forward"]
        b16["bound_by"] = max(by, key=by.get)
        b16["over_library"] = b16["ms"] / b16["library_ms"]
        b16["device_over_library"] = (b16["device_ms"]
                                      / b16["library_device_ms"])
        sums[batch]["bf16"] = b16
        sums[batch]["device_over_library"] = (
            sums[batch]["device_ms"] / sums[batch]["library_device_ms"])
        _, peak_flops, hbm = peaks(device_name)
        sums[batch]["bound_by"] = bound(
            sum(r["flops"] * r["per_forward"] for r in fwd),
            sum(r["bytes"] * r["per_forward"] for r in fwd),
            tf32_peak(device_name) / 3, hbm)[1]
        log("kernel", f"per forward at batch {batch}: "
                      f"{json.dumps(sums[batch])}")
        gc.collect()
        torch.cuda.empty_cache()
    tf32_err = kernel_bits(gen)
    summary = {
        "name": "conv_bn_relu", "route": "cuda",
        "source": "tpuic_torch/kernels/csrc/conv_bn_relu.cu",
        "replaces": "tpuic/kernels/conv_bn_relu.py:76",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in rows),
        "tf32_plain_max_abs_err": tf32_err,
        **sums[BATCH], f"batch{SERVE_BATCH}": sums[SERVE_BATCH],
    }
    log("kernel", "kernels " + json.dumps(
        [{"name": "conv_bn_relu", "max_abs_err": summary["max_abs_err"],
          "bf16_max_abs_err": summary["bf16_max_abs_err"],
          "status": "ok"}]))
    return summary, rows


def phase_model(gen: torch.Generator):
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.kernels import fused_conv_bn_relu, no_tf32
    from tpuic_torch.models import create_model
    model = create_model("resnet50", 1000, dtype="float32",
                         fused_conv_bn=True)
    init_synthetic(model, seed=0)
    model.eval()
    x = torch.randn((4, IMAGE, IMAGE, 3), generator=gen).cuda()
    with torch.inference_mode():
        model(x)  # folds the weights
        torch.cuda.synchronize()
        before = fused_conv_bn_relu.launches
        fused = model(x)
        torch.cuda.synchronize()
        per_forward = fused_conv_bn_relu.launches - before
        if per_forward != len(resnet50_launches(4)):
            fail("model", f"{per_forward} kernel launches per forward, "
                          f"expected {len(resnet50_launches(4))}")
        fused_ms = time_ms(lambda: model(x), iters=10)
        model.backbone.fused_inference = False
        with no_tf32():
            ref = model(x)
            unfused_ms = time_ms(lambda: model(x), iters=10)
        model.backbone.fused_inference = True
    err = float((fused - ref).abs().max())
    if not (torch.isfinite(fused).all() and fused.shape == (4, 1000)):
        fail("model", f"logits {tuple(fused.shape)} not finite")
    if not torch.allclose(fused, ref, rtol=MODEL_TOL, atol=MODEL_TOL):
        fail("model", f"fused vs unfused logits: max abs err {err} beyond "
                      f"atol/rtol {MODEL_TOL}")
    top1 = bool((fused.argmax(-1) == ref.argmax(-1)).all())
    bucket = unfused_bucket_check(model)
    log("model", json.dumps({
        "model": "resnet50", "classes": 1000, "image": IMAGE, "batch": 4,
        "dtype": "float32", "launches_per_forward": per_forward,
        "max_abs_err_vs_unfused": err, "logit_abs_max":
        float(ref.abs().max()), "top1_agree": top1,
        "fused_forward_ms": fused_ms, "unfused_cudnn_forward_ms":
        unfused_ms, "unfused_batch1_vs_batch32": bucket}))
    return model


def resnet50_b(seed: int):
    """[model]'s ResNet-50 with other seeded weights: [swap]'s B."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    return init_synthetic(create_model("resnet50", 1000, dtype="float32",
                                       fused_conv_bn=True), seed=seed).eval()


def vit_b(seed: int):
    """[vit]'s ViT-B/16 with other seeded weights."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    return init_synthetic(create_model(VIT_MODEL, 1000, dtype="float32",
                                       attention="flash", image_size=IMAGE),
                          seed=seed).eval()


def unfused_bucket_check(model) -> dict:
    """The unfused (cuDNN) ResNet-50 branch under torch's default flags:
    one image's row from a batch-1 forward against its row of a batch-32
    forward.  Served through the engine's ``make_forward`` the
    probabilities must agree within SERVE_TOL; the same forward called
    directly, where cuDNN's TF32 algorithms are chosen by batch size, is
    reported beside it."""
    from tpuic_torch.serve import make_forward
    if not torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        fail("model", "the bucket check needs torch's default TF32 flags")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)).cuda()
    rows = (0, 17, 31)
    model.backbone.fused_inference = False
    try:
        served = make_forward(model, normalize=True)
        big, _ = served(images)
        served_diff = max(float((served(images[r:r + 1])[0][0]
                                 - big[r]).abs().max()) for r in rows)
        with torch.inference_mode():
            x = images.float() / 255.0
            big = model(x)
            direct = [(model(x[r:r + 1])[0], big[r]) for r in rows]
    finally:
        model.backbone.fused_inference = True
    out = {"rows": list(rows), "served_probs_max_abs_diff": served_diff,
           "direct_logits_max_abs_diff": max(
               float((a - b).abs().max()) for a, b in direct),
           "direct_probs_max_abs_diff": max(
               float((a.softmax(-1) - b.softmax(-1)).abs().max())
               for a, b in direct)}
    if served_diff > SERVE_TOL:
        fail("model", f"unfused ResNet-50 served under the default flags: a "
                      f"row's probabilities at batch 1 and in batch "
                      f"{SERVE_BATCH} differ by {served_diff} > {SERVE_TOL}")
    return out


@contextlib.contextmanager
def gc_pauses():
    """Python's cyclic collections in the block, which stop every thread
    while they run: the yielded dict gets, on exit, their count by
    generation and the longest and total pause in ms."""
    started, pauses = {}, []

    def note(phase, info):
        if phase == "start":
            started[threading.get_ident()] = time.perf_counter()
        elif threading.get_ident() in started:
            pauses.append((info["generation"], time.perf_counter()
                           - started.pop(threading.get_ident())))

    out = {}
    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)
        out.update({"by_generation": {str(g): sum(1 for p in pauses
                                                   if p[0] == g)
                                      for g in (0, 1, 2)},
                    "max_ms": 1000.0 * max((p[1] for p in pauses),
                                           default=0.0),
                    "total_ms": 1000.0 * sum(p[1] for p in pauses)})


def phase_serve(model, n_requests: int, seed: int, smi: str,
                tag: str = "serve", counter: str = "conv_bn_relu",
                per_call: int = 0, image: int = IMAGE):
    """Serve ``model`` to eight closed-loop clients through one CUDA graph
    per bucket; ``counter``'s kernel must launch ``per_call`` times per
    device call (default: the 53 of a fused ResNet-50 forward; replays
    count the launches their graph captured) and no other kernel may
    launch (``counter=None``: no kernel at all).  Then the graphs against
    eager forwards (``graph_checks``)."""
    from tpuic_torch.serve import InferenceEngine, make_forward
    if counter is not None:
        per_call = per_call or len(resnet50_launches(1))
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, image, image, 3), dtype=np.uint8)
    eng = InferenceEngine(model, None, image_size=image,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32))
    warm = eng.warmup()
    log(tag, f"warmup (s per bucket: eager run, capture, one replay): "
             f"{json.dumps(warm)}")
    memory = eng.graph_memory()
    log(tag, "graph memory (bytes): " + json.dumps(memory))
    eng.stats.reset()
    reset_counts()
    results, errors, lock = [], [], threading.Lock()
    n_clients = 8

    def client(tid):
        # Closed loop: each client waits for its answer before it sends
        # the next request, so latency is service time, not a backlog.
        r = np.random.default_rng(seed + 1 + tid)
        try:
            for _ in range(n_requests // n_clients):
                n = int(r.integers(1, 9))
                lo = int(r.integers(0, pool.shape[0] - n + 1))
                out = eng.submit(pool[lo:lo + n]).result(timeout=600)
                with lock:
                    results.append((lo, n, out))
        except Exception as e:  # reported below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    with gc_pauses() as pauses:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts.get(counter, 0)
    eng.close()
    snap = eng.stats.snapshot()
    if errors or any(t.is_alive() for t in threads):
        fail(tag, f"client errors: {errors[:3]}")
    for lo, n, (probs, order) in results:
        if probs.shape != (n, 1000) or order.shape != (n, 1000) \
                or not np.isfinite(probs).all():
            fail(tag, f"request of {n}: probs {probs.shape}, order "
                      f"{order.shape}")
    direct = make_forward(model, normalize=True)
    worst = 0.0
    for lo, n, (probs, order) in results[::max(1, len(results) // 12)]:
        want_p, want_o = direct(torch.from_numpy(pool[lo:lo + n]).cuda())
        worst = max(worst, float(np.abs(probs - want_p.cpu().numpy()).max()))
        if not np.array_equal(order[:, 0], want_o[:, 0].cpu().numpy()):
            fail(tag, f"top-1 differs from a direct forward at {lo}:{n}")
    if worst > SERVE_TOL:
        fail(tag, f"probs differ from a direct forward by {worst} > "
                  f"{SERVE_TOL}")
    others = {k: v for k, v in counts.items() if k != counter and v}
    if (counter is not None and launches == 0) \
            or launches != per_call * snap["device_calls"] or others:
        fail(tag, f"{launches} {counter} launches for "
                  f"{snap['device_calls']} device calls (expected "
                  f"{per_call} each), other kernels {others}")
    graphs = graph_checks(eng, model, tag, image)
    log(tag, json.dumps({
        "requests": len(results), "images": snap["images"],
        "wall_s": wall, "device_calls": snap["device_calls"],
        "kernel": counter, "kernel_launches": launches,
        "latency_ms": snap["latency_ms"],
        "throughput_images_per_sec": snap["throughput_images_per_sec"],
        "images_per_s_wall": snap["images"] / wall,
        "pad_efficiency": snap["pad_efficiency"],
        "batch_hist": snap["batch_hist"], "span_ms": snap["span_ms"],
        "gc_during_traffic": pauses,
        "max_abs_err_vs_direct": worst, "graph_memory": memory,
        "graphs": graphs, "card": smi}))
    snap["graph_memory"], snap["graphs"] = memory, graphs
    return launches, snap


def graph_checks(eng, model, tag: str, image: int = IMAGE) -> dict:
    """Each bucket's graph replay against an eager forward of the same
    batch (``make_forward``, as the engine captured it): the same bits, or
    within GRAPH_TOL.  Then one batch-8 device call, replayed and eager,
    timed from Python (``ms``: back-to-back calls between two events),
    on the card alone (``device_ms``) and as host cost per call
    (``host_ms``).  Run after the served window's counts were read: these
    launches are comparisons, not the path."""
    from tpuic_torch.serve import make_forward
    eager = make_forward(model, normalize=True)
    rng = np.random.default_rng(7)
    rows = {}
    for b in eng.buckets:
        x = torch.from_numpy(rng.integers(0, 256, (b, image, image, 3),
                                          dtype=np.uint8)).cuda()
        want_p, want_o = eager(x)
        got_p, got_o = (t.clone() for t in eng.replay(b, x))
        torch.cuda.synchronize()
        bits = bool(torch.equal(got_p, want_p) and torch.equal(got_o, want_o))
        diff = float((got_p - want_p).abs().max())
        rows[str(b)] = {"bits_equal": bits, "max_abs_diff": diff,
                        "top1_equal": bool(torch.equal(got_o[:, 0],
                                                       want_o[:, 0]))}
        if not bits and diff > GRAPH_TOL:
            fail(tag, f"bucket {b}: graph replay differs from an eager "
                      f"forward by {diff} > {GRAPH_TOL}")
    x8 = torch.from_numpy(rng.integers(0, 256, (8, image, image, 3),
                                       dtype=np.uint8)).cuda()

    def replay():
        return eng.replay(8, x8)

    def direct():
        return eager(x8)

    times = {"replay": {"ms": time_ms(replay, iters=20),
                        "device_ms": device_ms(replay, iters=20),
                        "host_ms": host_ms(replay)},
             "eager": {"ms": time_ms(direct, iters=10),
                       "device_ms": device_ms(direct, iters=5),
                       "host_ms": host_ms(direct, iters=5)}}
    out = {"replay_vs_eager": rows, "batch8_forward": times}
    log(tag, "graphs: " + json.dumps(out))
    return out


def _pct(values, q) -> float:
    """Nearest-rank quantile in ms of ``values`` (seconds); None if empty."""
    if not values:
        return None
    v = sorted(values)
    return 1000.0 * v[max(0, min(len(v) - 1, math.ceil(q / 100 * len(v))
                                 - 1))]


def phase_swap(model, other, n_requests: int, seed: int, smi: str,
               tag: str = "swap", name: str = "resnet50",
               counter: str = "conv_bn_relu", per_call: int = 0,
               stopped: int = 3) -> dict:
    """Hot swap on the card through the per-bucket graphs.  ``model``
    holds weights A and ``other`` weights B (each a direct, eager
    reference); the engine serves a copy of A to eight closed-loop
    clients; once ``n_requests // 3`` are answered the main thread swaps
    to B, and the clients go on until ``n_requests // 3`` submitted after
    the swap returned are answered.  Every request must be answered, with
    A's or B's probabilities (SERVE_TOL), and every request submitted
    after ``swap_weights`` returned with B's; A's and B's answers to each
    request must lie more than 2 * SERVE_TOL apart, so that the nearer
    one names the weights that served it.  ``counter`` must launch
    ``per_call`` times per device call and per capture of the standby's
    graphs (the eager run before each).  Then, traffic stopped,
    ``stopped`` more swaps
    alternating A and B: after each, every bucket's replay must launch
    ``per_call`` kernels and equal bit for bit an eager forward of the
    weights just swapped in (K3's folded weights refolded in place), and
    the graph memory after the fourth swap must equal that after the
    second."""
    import copy

    from tpuic_torch.serve import InferenceEngine, make_forward
    per_call = per_call or len(resnet50_launches(1))
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    weights = {"A": model, "B": other}
    direct = {}
    for k, m in weights.items():
        fwd = make_forward(m, normalize=True)
        direct[k] = np.concatenate([
            fwd(torch.from_numpy(pool[i:i + SERVE_BATCH]).cuda())[0]
            .cpu().numpy() for i in range(0, pool.shape[0], SERVE_BATCH)])
    eng = InferenceEngine(copy.deepcopy(model), None, image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32))
    eng.warmup()
    eng.stats.reset()
    reset_counts()
    results, errors, lock = [], [], threading.Lock()
    stop, offered = threading.Event(), [0] * 8

    def client(tid):
        r = np.random.default_rng(seed + 1 + tid)
        try:
            while not stop.is_set():
                n = int(r.integers(1, 9))
                lo = int(r.integers(0, pool.shape[0] - n + 1))
                offered[tid] += 1
                t0 = time.perf_counter()
                out = eng.submit(pool[lo:lo + n]).result(timeout=600)
                with lock:
                    results.append((t0, time.perf_counter(), lo, n, out[0]))
        except Exception as e:  # reported below; the phase fails
            errors.append(repr(e))

    def answered(since=-math.inf):
        with lock:
            return sum(r[0] > since for r in results)

    # Traffic from eight closed-loop clients until n_requests // 3 are
    # answered, then the swap, then until n_requests // 3 more submitted
    # after the swap returned are answered.
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(len(offered))]
    for t in threads:
        t.start()
    while answered() < n_requests // 3 and not errors:
        time.sleep(0.001)
    t_swap0 = time.perf_counter()
    first = eng.swap_weights(other.state_dict())
    t_swap1 = time.perf_counter()
    while answered(t_swap1) < n_requests // 3 and not errors \
            and time.perf_counter() - t_swap1 < 300:
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    counts = read_counts()
    eng.close()
    snap = eng.stats.snapshot()
    if errors or any(t.is_alive() for t in threads) \
            or len(results) != sum(offered) \
            or answered(t_swap1) < n_requests // 3:
        fail(tag, f"{len(results)} of {sum(offered)} answered, "
                  f"{answered(t_swap1)} submitted after the swap; client "
                  f"errors: {errors[:3]}")
    worst, by_gen, spanning = {"A": 0.0, "B": 0.0}, {"A": 0, "B": 0}, []
    apart = math.inf  # the least max |A - B| over a request's rows
    for t0, t1, lo, n, probs in results:
        errs = {k: float(np.abs(probs - d[lo:lo + n]).max())
                for k, d in direct.items()}
        gen = min(errs, key=errs.get)
        # Only where A's and B's answers lie more than twice the
        # tolerance apart does "within SERVE_TOL of one" name which.
        dist = float(np.abs(direct["A"][lo:lo + n]
                            - direct["B"][lo:lo + n]).max())
        apart = min(apart, dist)
        if errs[gen] > SERVE_TOL or (t0 > t_swap1 and gen != "B") \
                or dist <= 2 * SERVE_TOL:
            fail(tag, f"request {lo}:{n} submitted at {t0 - t_swap1:+.4f} s "
                      f"from the swap's return: max abs err against A "
                      f"{errs['A']}, against B {errs['B']}, A and B "
                      f"{dist} apart (tolerance {SERVE_TOL}, after the "
                      f"swap only B, A and B more than twice it apart)")
        worst[gen] = max(worst[gen], errs[gen])
        by_gen[gen] += 1
        if t0 <= t_swap1 and t1 >= t_swap0:
            spanning.append(t1 - t0)
    want = per_call * (snap["device_calls"] + first["prewarmed"])
    others = {k: v for k, v in counts.items() if k != counter and v}
    if counts[counter] != want or others or first["generation"] != 1:
        fail(tag, f"{counts[counter]} {counter} launches for "
                  f"{snap['device_calls']} device calls and "
                  f"{first['prewarmed']} captures (expected {want}), "
                  f"other kernels {others}; swap {first}")
    swaps, memory = [first], []
    x = torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3),
                                      dtype=np.uint8)).cuda()
    # The eager references' device constants exist before the first
    # reading of the memory, so that the readings compare like with like.
    eagers = {k: make_forward(m, normalize=True) for k, m in weights.items()}
    for fwd in eagers.values():
        fwd(x[:1])
    for i in range(stopped):
        k = "A" if i % 2 == 0 else "B"
        res = eng.swap_weights(weights[k].state_dict())
        torch.cuda.synchronize()
        memory.append({**eng.graph_memory(),
                       "allocated": torch.cuda.memory_allocated()})
        eager = eagers[k]
        for b in eng.buckets:
            reset_counts()
            got = [t.clone() for t in eng.replay(b, x[:b])]
            launched = read_counts()
            ref = eager(x[:b])
            if launched != expect(**{counter: per_call}) or not (
                    torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                fail(tag, f"swap {res['generation']} to {k}, bucket {b}: "
                          f"launches {launched}, replay against an eager "
                          f"forward of {k}: max abs diff "
                          f"{float((got[0] - ref[0]).abs().max())} (must "
                          f"be bitwise equal)")
            del got, ref  # the next swap's memory reading must not see them
        swaps.append(res)
    if stopped >= 3 and memory[2] != memory[0]:
        fail(tag, f"graph memory after the fourth swap {memory[2]} differs "
                  f"from that after the second {memory[0]}")
    if any(not r["reused_executables"] for r in swaps[1:]):
        fail(tag, f"a swap after the first captured again: {swaps}")
    lat = [t1 - t0 for t0, t1, *_ in results]
    row = {"model": name, "requests": len(results),
           "submitted_after_the_swap": answered(t_swap1),
           "answered_by": by_gen,
           "max_abs_err_vs_direct": worst, "least_a_b_distance": apart, "device_calls":
           snap["device_calls"], "kernel": counter,
           "kernel_launches": counts[counter],
           "swaps": [{k: r[k] for k in ("generation", "duration_s",
                                        "reused_executables", "prewarmed",
                                        "batcher_hold_s")} for r in swaps],
           "latency_ms": {"p50": _pct(lat, 50), "p99": _pct(lat, 99)},
           "spanning_the_flip": {"requests": len(spanning),
                                 "p50_ms": _pct(spanning, 50),
                                 "p99_ms": _pct(spanning, 99)},
           "replay_vs_eager_after_each_stopped_swap": "bits_equal",
           "graph_memory_after_swaps_2_3_4": memory, "card": smi}
    log(tag, json.dumps(row))
    del eng
    free()
    return row


def phase_admission(model, seed: int, smi: str) -> dict:
    """Priorities, quotas and deadline shedding on the card: a
    ResNet-50 engine (queue 32) with an ``AdmissionController`` quota
    on the ``flood`` tenant, four threads flooding ``low`` requests of 8
    images, and one thread sending ``high`` requests of one image with
    ``deadline_ms`` (every fifth tight enough to be shed).  Accepted +
    rejected must equal offered, the causes ``queue_full``, ``quota``
    and ``deadline`` must all be seen, no ``high`` request may be
    evicted, and ``high``'s p50 latency must be below ``low``'s."""
    from tpuic_torch.serve import InferenceEngine
    from tpuic_torch.serve.admission import (AdmissionController,
                                             AdmissionError, parse_quotas)
    tag = "admission"
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    ctl = AdmissionController(parse_quotas([f"flood={FLOOD_RPS}"]))
    eng = InferenceEngine(model, None, image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32), queue_size=32, admission=ctl)
    eng.warmup()
    eng.stats.reset()
    reset_counts()
    outcomes, lock, stop = {"low": [], "high": []}, threading.Lock(), \
        threading.Event()

    def note(cls, out, secs):
        with lock:
            outcomes[cls].append((out, secs))

    def offer(cls, images, **sla):
        t0 = time.perf_counter()
        try:
            fut = eng.submit(images, timeout=0, priority=cls, **sla)
        except AdmissionError as e:
            note(cls, e.cause, None)
            return

        def done(f):
            try:
                f.result()
                out = "ok"
            except AdmissionError as e:
                out = e.cause
            except Exception as e:  # reported below; the phase fails
                out = repr(e)
            note(cls, out, time.perf_counter() - t0)

        fut.add_done_callback(done)

    def flood(tid):
        r = np.random.default_rng(seed + 10 + tid)
        while not stop.is_set():
            lo = int(r.integers(0, pool.shape[0] - 8))
            offer("low", pool[lo:lo + 8], tenant="flood")
            time.sleep(0.0005)

    def high():
        i = 0
        while not stop.is_set():
            offer("high", pool[i % 64:i % 64 + 1], tenant="app",
                  deadline_ms=0.5 if i % 5 == 4 else 2000.0)
            i += 1
            time.sleep(0.01)

    threads = [threading.Thread(target=flood, args=(t,)) for t in range(4)]
    threads.append(threading.Thread(target=high))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(ADMISSION_S)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    eng.close()
    wall = time.perf_counter() - t0
    counts = read_counts()
    snap = eng.stats.snapshot()
    offered = sum(len(v) for v in outcomes.values())
    causes = {c for v in outcomes.values() for c, _ in v if c != "ok"}
    lat = {cls: [s for c, s in v if c == "ok"] for cls, v in outcomes.items()}
    p50 = {cls: _pct(v, 50) for cls, v in lat.items()}
    bad = [c for v in outcomes.values() for c, _ in v
           if c not in ("ok", "queue_full", "quota", "deadline")]
    evicted_high = sum(c == "queue_full" for c, _ in outcomes["high"])
    per_call = len(resnet50_launches(1))
    if (bad or snap["requests"] + snap["rejected"] != offered
            or not {"queue_full", "quota", "deadline"} <= causes
            or evicted_high or None in p50.values()
            or not p50["high"] < p50["low"]
            or counts != expect(conv_bn_relu=per_call
                                * snap["device_calls"])):
        fail(tag, f"offered {offered}, accepted {snap['requests']}, "
                  f"rejected {snap['rejected']} {snap['rejected_by']}; "
                  f"causes seen {sorted(causes)}, unexpected {bad[:3]}; "
                  f"high evicted {evicted_high}; p50 ms {p50}; launches "
                  f"{counts} for {snap['device_calls']} device calls")
    row = {"seconds": wall, "offered": offered,
           "accepted": snap["requests"], "rejected": snap["rejected"],
           "rejected_by": snap["rejected_by"],
           "latency_ms": {cls: {"requests": len(v), "p50": _pct(v, 50),
                                "p99": _pct(v, 99)}
                          for cls, v in lat.items()},
           "images_per_s": snap["throughput_images_per_sec"],
           "device_calls": snap["device_calls"],
           "conv_bn_relu_launches": counts["conv_bn_relu"],
           "quota": ctl.state(), "card": smi}
    log(tag, json.dumps(row))
    return row


def xent_rows_ignore_batch(K1, gen: torch.Generator) -> dict:
    """K1b's dx for every row of a class-weighted, masked batch of 128 (one
    label out of range, smoothing 0.1) against the same row alone at batch
    1, bit for bit, at C = 1, 7, 1000 and 21843: in the batch a row of C =
    7 or 21843 is 16-byte aligned only every fourth row, alone always, so
    both load paths meet.  Returns the rows checked per C."""
    b, out = TRAIN_BATCH, {}
    for c in (1, 7, 1000, 21843):
        x = (3.0 * torch.randn((b, c), generator=gen)).cuda()
        y = torch.randint(0, c, (b,), generator=gen, dtype=torch.int32)
        y[5] = c
        y = y.cuda()
        cw = (0.5 + torch.rand(c, generator=gen)).cuda()
        mask = (torch.rand(b, generator=gen) > 0.2).float().cuda()
        scale = torch.tensor(0.37, device="cuda")
        whole = K1.cross_entropy_bwd(x, y, cw, mask, scale, 0.1)
        alone = torch.cat([K1.cross_entropy_bwd(
            x[r:r + 1].clone(), y[r:r + 1].clone(), cw,
            mask[r:r + 1].clone(), scale, 0.1) for r in range(b)])
        torch.cuda.synchronize()
        if not torch.equal(whole, alone):
            bad = [r for r in range(b) if not torch.equal(whole[r],
                                                          alone[r])]
            fail("xent", f"[{b}, {c}]: the backward's rows {bad[:8]} differ "
                         "from the same rows at batch 1")
        out[c] = b
    return out


def phase_xent(device_name: str, gen: torch.Generator):
    """K1 forward and backward against their plain versions, then timed.
    Returns the (K1f, K1b) summaries at the train path's shape, [128,
    1000] with smoothing 0.1 and no class weights."""
    from tpuic_torch.kernels import cross_entropy as K1
    from tpuic_torch.kernels import cross_entropy_bench as K1B
    from tpuic_torch.kernels.optimizer_update_bench import device_time
    _, peak_flops, hbm = peaks(device_name)
    earlier = K1B.build_earlier()
    # Class-weighted, masked batches with one out-of-range label (w = 0),
    # from a single class to a long row (C = 21843 rows are 16-byte
    # aligned only every fourth row: both load paths run).
    b = 37
    for c in (1, 7, 1000, 21843):
        x = (3.0 * torch.randn((b, c), generator=gen)).cuda()
        y = torch.randint(0, c, (b,), generator=gen, dtype=torch.int32)
        y[0] = c
        y = y.cuda()
        cw = (0.5 + torch.rand(c, generator=gen)).cuda()
        mask = (torch.rand(b, generator=gen) > 0.2).float().cuda()
        scale = torch.tensor(0.37, device="cuda")
        for ls in (0.0, 0.1):
            got = [*K1.cross_entropy_fwd(x, y, cw, mask, ls),
                   K1.cross_entropy_bwd(x, y, cw, mask, scale, ls)]
            torch.cuda.synchronize()
            want = [*K1.cross_entropy_fwd_plain(x, y, cw, mask, ls),
                    K1.cross_entropy_bwd_plain(x, y, cw, mask, scale, ls)]
            if not all(torch.allclose(g, w, rtol=XENT_RTOL, atol=XENT_ATOL)
                       for g, w in zip(got, want)) \
                    or not torch.equal(got[1], want[1]) \
                    or float(got[1][0]) != 0.0:
                fail("xent", f"weighted, masked [{b}, {c}] smoothing {ls}: "
                             f"max abs err {max_err(got, want)}")
    log("xent", f"weighted, masked [{b}, C] for C in 1, 7, 1000, 21843, "
                f"smoothing 0 and 0.1: within rtol {XENT_RTOL} / atol "
                f"{XENT_ATOL}, w exact")
    log("xent", "backward rows against their batch: " + json.dumps(
        xent_rows_ignore_batch(K1, gen)))
    rows, main = [], {}
    for b, c in ((TRAIN_BATCH, 1000), (TRAIN_BATCH, 7)):
        for ls in (0.0, 0.1):
            # The train path's inputs: no class weights, nothing masked.
            x, y, cw, mask, scale = K1B.train_inputs(b, c, gen)
            yl = y.long()
            fwd = (x, y, cw, mask)
            got = [*K1.cross_entropy_fwd(*fwd, ls),
                   K1.cross_entropy_bwd(*fwd, scale, ls)]
            old = [*K1B.fwd_with(earlier, *fwd, ls),
                   K1B.bwd_with(earlier, *fwd, scale, ls)]
            torch.cuda.synchronize()
            want = [*K1.cross_entropy_fwd_plain(*fwd, ls),
                    K1.cross_entropy_bwd_plain(*fwd, scale, ls)]
            err_f, err_b = max_err(got[:2], want[:2]), max_err(got[2:],
                                                               want[2:])
            if not all(torch.allclose(g, w, rtol=XENT_RTOL, atol=XENT_ATOL)
                       for g, w in zip(got + old, want + want)):
                fail("xent", f"[{b}, {c}] smoothing {ls}: max abs err "
                             f"fwd {err_f} bwd {err_b}, earlier design "
                             f"{max_err(old, want)}")
            again = K1.cross_entropy_bwd(*fwd, scale, ls)
            torch.cuda.synchronize()
            if not torch.equal(got[2], again):
                fail("xent", f"[{b}, {c}] smoothing {ls}: two backward "
                             "calls gave different bits")
            # One library call each: with all-one weights and smoothing,
            # F.cross_entropy's smoothed sum is the same function (its
            # smoothing differs from tpuic's only with class weights).
            kw = (dict(label_smoothing=ls) if ls
                  else dict(weight=cw))
            xr = x.clone().requires_grad_(True)

            def lib_fwd():
                return F.cross_entropy(x, yl, reduction="sum", **kw)

            def lib_fwd_bwd():
                return torch.autograd.grad(
                    F.cross_entropy(xr, yl, reduction="sum", **kw), xr)

            def k1f():
                return K1.cross_entropy_fwd(*fwd, ls)

            def k1b():
                return K1.cross_entropy_bwd(*fwd, scale, ls)

            def k1f_earlier():
                return K1B.fwd_with(earlier, *fwd, ls)

            def k1b_earlier():
                return K1B.bwd_with(earlier, *fwd, scale, ls)

            ms = {"fwd": time_ms(k1f, iters=200),
                  "fwd_plain": time_ms(
                      lambda: K1.cross_entropy_fwd_plain(*fwd, ls),
                      iters=200),
                  "fwd_lib": time_ms(lib_fwd, iters=200),
                  "bwd": time_ms(k1b, iters=200),
                  "bwd_plain": time_ms(
                      lambda: K1.cross_entropy_bwd_plain(*fwd, scale, ls),
                      iters=200),
                  "bwd_lib": time_ms(lib_fwd_bwd, iters=200)}
            # On the card alone: the median of 5 replays of a CUDA graph of
            # 100 calls.
            dev = {"fwd": device_time(k1f)["median"],
                   "fwd_earlier": device_time(k1f_earlier)["median"],
                   "bwd": device_time(k1b)["median"],
                   "bwd_earlier": device_time(k1b_earlier)["median"],
                   "fwd_lib": device_time(lib_fwd)["median"],
                   "fwd_bwd_lib": device_time(lib_fwd_bwd)["median"]}
            # F.cross_entropy's backward alone, on the card: its forward +
            # backward minus its forward.
            dev["bwd_lib_fwd_bwd_minus_fwd"] = (dev["fwd_bwd_lib"]
                                                - dev["fwd_lib"])
            # Bytes: each input read once, each output written once.  Ops
            # per logit: max, subtract + exp, sum (+ sum of x when
            # smoothing) forward; those plus exp, divide, subtract target
            # and scale backward.
            n = b * c
            fb = bound(n * (5 if ls else 4), K1B.fwd_bytes(b, c),
                       peak_flops, hbm)
            bb = bound(n * 9, K1B.bwd_bytes(b, c), peak_flops, hbm)
            row = {"b": b, "c": c, "label_smoothing": ls,
                   "fwd_max_abs_err": err_f, "bwd_max_abs_err": err_b,
                   "earlier_fwd_max_abs_err": max_err(old[:2], want[:2]),
                   "earlier_bwd_max_abs_err": max_err(old[2:], want[2:]),
                   "bwd_bits_equal_on_two_calls": True,
                   **ms, "device_ms": dev,
                   "fwd_earlier_over_shipped": dev["fwd_earlier"]
                   / dev["fwd"],
                   "bwd_over_earlier": dev["bwd"] / dev["bwd_earlier"],
                   "fwd_bound_ms": fb[0], "bwd_bound_ms": bb[0]}
            rows.append(row)
            log("xent", json.dumps(row))
            if (b, c, ls) == (TRAIN_BATCH, 1000, 0.1):
                main = {
                    "cross_entropy_fwd": {
                        "max_abs_err": err_f, "ms": ms["fwd"],
                        "device_ms": dev["fwd"],
                        "earlier_device_ms": dev["fwd_earlier"],
                        "plain_ms": ms["fwd_plain"], "bound_ms": fb[0],
                        "bound_by": fb[1], "library_ms": ms["fwd_lib"],
                        "library_device_ms": dev["fwd_lib"]},
                    "cross_entropy_bwd": {
                        "max_abs_err": err_b, "ms": ms["bwd"],
                        "device_ms": dev["bwd"],
                        "earlier_device_ms": dev["bwd_earlier"],
                        "plain_ms": ms["bwd_plain"], "bound_ms": bb[0],
                        "bound_by": bb[1], "library_ms": ms["bwd_lib"],
                        "library_device_ms": dev["fwd_bwd_lib"],
                        "library_bwd_device_ms_fwd_bwd_minus_fwd":
                            dev["bwd_lib_fwd_bwd_minus_fwd"]}}
    return main, rows


def phase_optim(device_name: str, seed: int):
    """K2 LARS and LAMB over the ResNet-50 + head parameter list against
    their plain versions, the same bits on a second run, then timed: per
    call from Python (``ms``, 100 back-to-back calls) and on the card alone
    (``device_ms``: the median of 5 replays of a CUDA graph of 100
    back-to-back updates, with their spread); each also through its
    earlier design (``optimizer_update_bench``), held and timed the same
    way.  LAMB's debias factors, computed by the kernel from the device
    count, are held to ``lamb_debias`` on the card within 1 ulp.  Returns
    their summaries."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import optimizer_update as K2
    from tpuic_torch.kernels import optimizer_update_bench as K2B
    from tpuic_torch.models import create_model
    _, peak_flops, hbm = peaks(device_name)
    model = init_params(create_model("resnet50", 1000, dtype="float32"),
                        seed, device="cuda")
    w = [p.detach() for p in model.parameters()]
    cg = torch.Generator(device="cuda").manual_seed(seed)
    g = [1e-3 * torch.randn(t.shape, generator=cg, device="cuda") for t in w]
    m = [1e-3 * torch.randn(t.shape, generator=cg, device="cuda") for t in w]
    v = [1e-6 * torch.rand(t.shape, generator=cg, device="cuda") for t in w]
    n = sum(t.numel() for t in w)
    zero = sum(1 for t in w if not bool(t.any()))
    # lr at step 1 of the recipe's warmup (4.8 over 5 epochs of 12 steps).
    lr = torch.tensor(4.8 / 60, device="cuda")
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    finite = torch.tensor(True, device="cuda")
    lars_kw = dict(weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
    lamb_kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-4)
    block_libs = K2B.build_earlier()
    out = {}
    for kind in ("lars", "lamb"):
        if kind == "lars":
            new_m = K2.lars_update_plain(w, g, m, lr, **lars_kw)
            want = [*[a + b for a, b in zip(w, new_m)], *new_m]
            state = (w, m)

            def update(ws, table):
                K2.lars_update(ws[0], g, ws[1], lr, finite, table=table,
                               **lars_kw)

            def earlier_update(ws, table):
                K2B.block_lars_update(block_libs["lars"], ws[0], g, ws[1],
                                      lr, finite, table=table, **lars_kw)

            def plain():
                return K2.lars_update_plain(w, g, m, lr, **lars_kw)
            # g, w, m read; m', w' written.  Ops per element: u = g +
            # wd*w, the two squares summed, the update and w + m'.  The
            # two passes read g and w twice: 7 tensors.
            ops, nbytes, two_pass = 10.0 * n, 4.0 * 5 * n, 4.0 * 7 * n
        else:
            upd, mus, nus = K2.lamb_update_plain(w, g, m, v, count, lr,
                                                 **lamb_kw)
            want = [*[a + b for a, b in zip(w, upd)], *mus, *nus]
            state = (w, m, v)

            def update(ws, table):
                K2.lamb_update(ws[0], g, ws[1], ws[2], count, lr, finite,
                               table=table, **lamb_kw)

            def earlier_update(ws, table):
                K2B.block_lamb_update(block_libs["lamb"], ws[0], g, ws[1],
                                      ws[2], count, lr, finite, table=table,
                                      **lamb_kw)

            def plain():
                return K2.lamb_update_plain(w, g, m, v, count, lr, **lamb_kw)
            # g, w, m, v read; m', v', w' written.  Ops per element: the
            # two moments, debias, sqrt, divide, decay, the two squares
            # summed, and the update.  Two passes: 10 tensors.
            ops, nbytes, two_pass = 20.0 * n, 4.0 * 7 * n, 4.0 * 10 * n
        # The shipped kernels twice from the same state, each on its own
        # copies and table, then the earlier design once.
        runs = []
        for _ in range(2):
            copies = [[t.clone() for t in ts] for ts in state]
            table = K2.LeafTable()
            update(copies, table)
            torch.cuda.synchronize()
            runs.append((copies, table))
        got = [t for ts in runs[0][0] for t in ts]
        err = max_err(got, want)
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not torch.allclose(a, b, rtol=OPT_RTOL, atol=OPT_ATOL)]
        if bad:
            fail("optim", f"{kind}: {len(bad)} tensors beyond rtol "
                          f"{OPT_RTOL} / atol {OPT_ATOL}, max abs err {err}")
        if not all(torch.equal(a, b) for a, b in zip(
                got, [t for ts in runs[1][0] for t in ts])):
            fail("optim", f"{kind}: two runs from one state differ")
        row = {"kind": kind, "leaves": len(w), "params": n,
               "zero_norm_leaves": zero, "max_abs_err": err,
               "bits_equal_on_two_runs": True}
        if kind == "lamb":
            # The c1, c2 the kernel's first pass computed, against the
            # plain version's on the card: within 1 ulp.
            got_c = runs[0][1].a[-2:]
            want_c = torch.stack(K2.lamb_debias(count, lamb_kw["b1"],
                                                lamb_kw["b2"]))
            ulps = (got_c.view(torch.int32).long()
                    - want_c.view(torch.int32).long()).abs().max()
            row["debias_ulps"] = int(ulps)
            if int(ulps) > 1:
                fail("optim", f"lamb: debias {got_c.tolist()} against "
                              f"{want_c.tolist()}, {int(ulps)} ulps apart")
        old_state = [[t.clone() for t in ts] for ts in state]
        old_table = K2.LeafTable()

        def earlier():
            earlier_update(old_state, old_table)
        earlier()
        torch.cuda.synchronize()
        row["earlier_max_abs_err"] = max_err(
            [t for ts in old_state for t in ts], want)
        copies, table = runs[0]

        def kernel():
            update(copies, table)
        row["earlier_device_ms"] = K2B.device_time(earlier)
        row["earlier_ms"] = time_ms(earlier, iters=100)
        row["earlier_host_ms"] = host_ms(earlier)
        dev = K2B.device_time(kernel)
        bms, by = bound(ops, nbytes, peak_flops, hbm)
        row.update(ms=time_ms(kernel, iters=100), host_ms=host_ms(kernel),
                   device_ms=dev,
                   plain_ms=time_ms(plain, iters=5, warmup=1), bound_ms=bms,
                   bound_by=by, two_pass_bound_ms=two_pass / hbm * 1e3,
                   device_share_of_bound=bms / dev["median"],
                   gb_per_s=nbytes / dev["median"] / 1e6)
        row["earlier_over_shipped"] = (row["earlier_device_ms"]["median"]
                                       / dev["median"])
        log("optim", json.dumps(row))
        out[f"{kind}_update"] = {
            "max_abs_err": err, "ms": row["ms"], "host_ms": row["host_ms"],
            "device_ms": dev["median"],
            "device_ms_spread": dev["spread"], "plain_ms": row["plain_ms"],
            "bound_ms": bms, "bound_by": by,
            "two_pass_bound_ms": row["two_pass_bound_ms"],
            "library_ms": None,
            "earlier_device_ms": row["earlier_device_ms"]["median"]}
    return out


def _counters():
    from tpuic_torch.kernels import (cross_entropy_bwd, cross_entropy_fwd,
                                     flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq,
                                     flash_attention_fwd, fused_conv_bn_relu,
                                     lamb_update, lars_update)
    return {"cross_entropy_fwd": cross_entropy_fwd,
            "cross_entropy_bwd": cross_entropy_bwd,
            "lars_update": lars_update, "lamb_update": lamb_update,
            "conv_bn_relu": fused_conv_bn_relu,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


def expect(**launches) -> dict:
    """Every counter at 0 except the ones named."""
    out = {k: 0 for k in _counters()}
    out.update(launches)
    return out


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in _counters().items()}


def train_config(root: str, seed: int):
    """The repo's large-batch ResNet-50 recipe (recipes/README.md,
    section 5) on one card, float32, with the fused loss and optimizer."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=IMAGE,
                        batch_size=TRAIN_BATCH, num_workers=8,
                        shuffle_seed=seed, native=False, pack=False),
        model=ModelConfig(name="resnet50", num_classes=1000,
                          dtype="float32", fused_conv_bn=True),
        optim=OptimConfig(optimizer="lars", learning_rate=4.8,
                          weight_decay=1e-4, warmup_epochs=5,
                          label_smoothing=0.1, class_weights=(),
                          fused_loss=True, fused_optimizer=True),
        run=RunConfig(epochs=90, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt")))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning, inside the block:
    the two arms of the comparison then differ only by the kernels."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def conv_dtypes(first: int = 64):
    """Yields a list that receives the output dtype of the first ``first``
    convolutions run inside the block: a global forward hook that removes
    itself after them, so the steps it does not see pay nothing."""
    seen = []

    def hook(module, args, out):
        if isinstance(module, torch.nn.Conv2d):
            seen.append(out.dtype)
            if len(seen) >= first:
                handle.remove()

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


@contextlib.contextmanager
def attn_dtypes(first: int = 48):
    """As ``conv_dtypes`` for the ViT: the dtype of each attention block's
    input and output (q, k and v are views of the projection of that
    input), for the first ``first`` blocks run inside the block."""
    from tpuic_torch.models.vit import MultiHeadAttention
    seen = []

    def hook(module, args, out):
        if isinstance(module, MultiHeadAttention):
            seen.extend((args[0].dtype, out.dtype))
            if len(seen) >= 2 * first:
                handle.remove()

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def check_conv_dtypes(tag: str, arm: str, seen: list, dtype: str) -> str:
    """Fails unless convolutions ran and every one returned ``dtype``: a
    bf16 arm that computes in float32 would pass every loss bound."""
    want = getattr(torch, dtype)
    if not seen or set(seen) != {want}:
        fail(tag, f"{arm}: convolution outputs "
                  f"{sorted(str(d) for d in set(seen))}, expected {want}")
    return dtype


def compare_plain(cfg, batches, seed: int, lr: float, plain_model=None,
                  bf16_model=None, probe=None):
    """3 steps from one initial state on ``batches``, through the kernels
    and through the plain versions (the plain loss, the plain optimizer
    and ``plain_model``, default ``cfg.model``), TF32 off: per-step loss
    and gradient norm of each arm, and the step times.  ``bf16_model``
    adds an arm through the kernels under that (bf16) model config, whose
    output dtypes ``probe`` (default ``conv_dtypes``) records."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    arms = {}
    todo = [("kernels", cfg.model, True),
            ("plain", plain_model or cfg.model, False)]
    if bf16_model is not None:
        todo.append(("bf16", bf16_model, True))
    for arm, mcfg, fused in todo:
        # Both arms start from the same numbers: init_params draws them
        # from a CPU generator seeded alike.
        model = init_params(create_model_from_config(
            mcfg, image_size=cfg.data.resize_size), seed, device="cuda")
        # A constant lr of a tenth of the peak, so every step moves the
        # weights (the recipe's warmup starts at lr 0) and 3 steps stay in
        # the tame early regime the warmup is there to give.
        ocfg = dataclasses.replace(cfg.optim, learning_rate=lr,
                                   warmup_epochs=0, milestones=(),
                                   fused_loss=fused, fused_optimizer=fused)
        state = create_train_state(model, make_optimizer(ocfg))
        step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(
            ocfg, 1, 1), device="cuda")
        metrics, times = [], []
        seen_by = ((probe or conv_dtypes)() if arm == "bf16"
                   else contextlib.nullcontext())
        with no_tf32(), deterministic_cudnn(), seen_by as seen:
            for batch in batches:
                t0 = time.perf_counter()
                state, mt = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(mt[k]) for k in ("loss",
                                                          "grad_norm",
                                                          "skipped")})
        arms[arm] = {"metrics": metrics, "step_ms": times}
        if arm == "bf16":
            arms[arm]["conv_dtypes"] = seen
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return arms


def write_folder(root: str, seed: int) -> None:
    """The synthetic 224x224 ImageFolder both training phases read."""
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    classes = tuple(f"class{i}" for i in range(TRAIN_CLASSES))
    t0 = time.perf_counter()
    make_synthetic_imagefolder(
        root, classes, per_class=TRAIN_BATCH * TRAIN_STEPS
        // TRAIN_CLASSES, size=IMAGE, folds=("train",), seed=seed)
    make_synthetic_imagefolder(
        root, classes, per_class=2 * TRAIN_BATCH // TRAIN_CLASSES,
        size=IMAGE, folds=("val",), seed=seed + 1)
    log("train", f"synthetic ImageFolder {IMAGE}x{IMAGE}: "
                 f"{TRAIN_BATCH * TRAIN_STEPS} train + "
                 f"{2 * TRAIN_BATCH} val images in "
                 f"{time.perf_counter() - t0:.3f} s")


def train_row(trainer, stats: dict, counts: dict, batch: int,
              smi: str) -> dict:
    """Step time, images/s and data-wait share of ``trainer``'s epoch: the
    step time between the first and last deferred metric read."""
    drains = stats["drains"]
    (s0, t_0), (s1, t_1) = drains[0], drains[-1]
    step_ms = (t_1 - t_0) / (s1 - s0) * 1e3
    return {"model": trainer.mcfg.name,
            "image": trainer.cfg.data.resize_size, "batch": batch,
            "dtype": trainer.mcfg.dtype, "optimizer": trainer.state.tx.kind,
            "steps": stats["steps"], "wall_s": stats["wall_s"],
            "step_ms": step_ms, "step_ms_window": [s0, s1],
            "images_per_s": batch / step_ms * 1e3,
            "data_wait_s": stats["data_wait_s"],
            "data_wait_share": stats["data_wait_s"] / stats["wall_s"],
            "launches": counts,
            "val_forwards": len(trainer.val_loader),
            "val": {k: trainer.last_val[k] for k in ("accuracy", "loss")},
            "card": smi}


def check_compare(tag: str, arms: dict) -> dict:
    rel = [abs(k["loss"] - p["loss"]) / abs(p["loss"])
           for k, p in zip(arms["kernels"]["metrics"],
                           arms["plain"]["metrics"])]
    row = {"steps": len(rel), "loss_rel_diff": rel,
           "loss_rtol": TRAIN_LOSS_RTOL, **arms}
    log(tag, "kernels vs plain, TF32 off: " + json.dumps(row))
    if any(m["skipped"] or not math.isfinite(m["loss"])
           for a in arms.values() for m in a["metrics"]):
        fail(tag, "a comparison step was skipped or not finite")
    if max(rel) > TRAIN_LOSS_RTOL:
        fail(tag, f"kernel and plain losses differ by {max(rel)} > rtol "
                  f"{TRAIN_LOSS_RTOL}")
    return row


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def first_batches(trainer, k: int = 3) -> list:
    """The first ``k`` batches of the trainer's epoch 1, on the card."""
    it = trainer.train_loader.epoch(1)
    batches = [{n: b[n] for n in ("image", "label", "mask")}
               for b, _ in zip(it, range(k))]
    it.close()
    return batches


def phase_train(root: str, seed: int, smi: str):
    """The training path through ``Trainer``, the kernel-vs-plain 3-step
    comparison and the LAMB run; returns launch counts and the row."""
    from tpuic_torch.train.loop import Trainer
    cfg = train_config(root, seed)
    trainer = Trainer(cfg, log=lambda msg: log("train", msg))
    reset_counts()
    trainer.fit()
    stats = dict(trainer.stats)
    t0 = time.perf_counter()
    trainer.val_epoch(0)
    val_s = time.perf_counter() - t0
    counts = read_counts()
    steps = stats["steps"]
    val_forwards = len(trainer.val_loader)
    want = expect(cross_entropy_fwd=steps, cross_entropy_bwd=steps,
                  lars_update=steps, conv_bn_relu=53 * val_forwards)
    if steps != TRAIN_STEPS or counts != want:
        fail("train", f"{steps} steps, launches {counts}, expected "
                      f"{TRAIN_STEPS} steps and {want}")
    if not all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters()) or not all(
            math.isfinite(v) for v in trainer.last_val.values()):
        fail("train", f"non-finite state after {steps} steps: val "
                      f"{trainer.last_val}")
    row = train_row(trainer, stats, counts, TRAIN_BATCH, smi)
    # The validation pass (its first call folds the BN into the weights),
    # and one validation forward (K3's 53 launches) on a batch on the card.
    it = trainer.val_loader.epoch(0)
    val_batch = {n: b[n] for b, _ in zip(it, range(1))
                 for n in ("image", "label", "mask")}
    it.close()
    row["val_pass_s"] = val_s
    row["val_forward_ms"] = time_ms(
        lambda: trainer.eval_step(trainer.state, val_batch), iters=5)
    log("train", json.dumps(row))
    batches = first_batches(trainer)
    del trainer
    free()
    row["compare"] = check_compare("train", compare_plain(cfg, batches, seed,
                                                          COMPARE_LR))
    del batches
    free()

    lcfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=LAMB_BATCH),
        optim=dataclasses.replace(cfg.optim, optimizer="lamb",
                                  learning_rate=1e-2, warmup_epochs=0,
                                  milestones=()),
        run=dataclasses.replace(cfg.run, max_steps=3, log_every_steps=1))
    lamb = Trainer(lcfg, log=lambda msg: log("train", msg))
    reset_counts()
    lamb.fit()
    lamb_counts = read_counts()
    lamb_want = expect(cross_entropy_fwd=3, cross_entropy_bwd=3,
                       lamb_update=3)
    if lamb_counts != lamb_want or not all(
            bool(torch.isfinite(p).all()) for p in lamb.model.parameters()):
        fail("train", f"LAMB run: launches {lamb_counts}, expected "
                      f"{lamb_want}, or non-finite parameters")
    log("train", "LAMB run: " + json.dumps({
        "batch": LAMB_BATCH, "steps": lamb.stats["steps"],
        "launches": lamb_counts, "wall_s": lamb.stats["wall_s"]}))
    del lamb
    free()
    return counts, lamb_counts, row


def _flip_byte(path: str, offset: int = 4096) -> None:
    """One byte of ``path`` XOR 0xFF, its size kept."""
    with open(path, "r+b") as f:
        f.seek(min(offset, os.path.getsize(path) - 1))
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _mismatches(got: dict, want: dict) -> list:
    """Names of the tensors of two ``snapshot``s whose bits differ."""
    def flat(snap):
        out = {f"model/{k}": v for k, v in snap["model"].items()}
        for k, v in snap["opt_state"].items():
            for i, t in enumerate(v if isinstance(v, list) else [v]):
                out[f"opt/{k}/{i}"] = t
        out["step"], out["skip_count"] = snap["step"], snap["skip_count"]
        return out
    g, w = flat(got), flat(want)
    if sorted(g) != sorted(w):
        return sorted(set(g) ^ set(w))
    return [k for k in w if not torch.equal(g[k], w[k])]


def phase_ckpt(root: str, seed: int, ckpt_dir: str) -> dict:
    """The checkpoint on the card with ``[train]``'s configuration: a
    ``Trainer`` takes CKPT_STEPS steps and saves ``best`` and ``latest``;
    a fresh ``Trainer`` restores them (``latest``, the newer on a tie);
    every parameter, BN buffer and K2 optimizer-state tensor must equal
    the saved one bit for bit; the next step on one batch, under
    ``deterministic_cudnn()``, must give the uninterrupted trainer's loss
    exactly; then one byte of ``latest``'s payload is flipped and the
    restore must fall back to ``best``, again bit for bit.  Reports the
    payload's bytes and the host and disk seconds to snapshot, commit and
    restore.  The checkpoint stays in ``ckpt_dir`` for ``serve-cli`` and
    ``predict``, with the ``Trainer``'s val accuracy of its ``best``
    save (``row["best_val_accuracy"]``)."""
    from tpuic_torch.checkpoint.manager import PAYLOAD, snapshot
    from tpuic_torch.train.loop import Trainer
    base = train_config(root, seed)
    cfg = dataclasses.replace(base, run=dataclasses.replace(
        base.run, max_steps=CKPT_STEPS, ckpt_dir=ckpt_dir))
    first = Trainer(cfg, log=lambda msg: log("ckpt", msg))
    if first.start_epoch != 0:
        fail("ckpt", f"an empty checkpoint directory resumed at epoch "
                     f"{first.start_epoch}")
    first.fit()
    first.ckpt.save_best(first.state, 0, 12.5)
    first.ckpt.wait()
    saves = {"best": dict(first.ckpt.last_save)}
    first.ckpt.save_latest(first.state, 0, 12.5)
    first.ckpt.wait()
    saves["latest"] = dict(first.ckpt.last_save)
    want = snapshot(first.state)
    second = Trainer(cfg, log=lambda msg: log("ckpt", msg))
    rung, restore_s = (second.ckpt.last_restore_rung,
                       second.ckpt.last_restore_s)
    bad = _mismatches(snapshot(second.state), want)
    if rung != "latest" or second.start_epoch != 1 or bad:
        fail("ckpt", f"restored rung {rung}, start epoch "
                     f"{second.start_epoch}, {len(bad)} tensors differ "
                     f"from the save: {bad[:5]}")
    batch = first_batches(first, 1)[0]
    with deterministic_cudnn():
        _, m1 = first.train_step(first.state, batch)
        _, m2 = second.train_step(second.state, batch)
        losses = [float(m1["loss"]), float(m2["loss"])]
    after = _mismatches(snapshot(second.state), snapshot(first.state))
    if losses[0] != losses[1] or not math.isfinite(losses[0]):
        fail("ckpt", f"the next step's loss after the restore, "
                     f"{losses[1]!r}, is not the uninterrupted run's "
                     f"{losses[0]!r}")
    _flip_byte(os.path.join(first.ckpt.root, "latest", PAYLOAD))
    _, start, _ = second.ckpt.restore_into(second.state)
    fallback, fallback_s = (second.ckpt.last_restore_rung,
                            second.ckpt.last_restore_s)
    bad = _mismatches(snapshot(second.state), want)
    if fallback != "best" or start != 1 or bad:
        fail("ckpt", f"with latest corrupt the restore took rung "
                     f"{fallback} (start epoch {start}), {len(bad)} "
                     f"tensors differ from the save: {bad[:5]}")
    best_val = second.val_epoch(0)  # the state is best's, bit for bit
    # The same model's top-1 per val image and its margin over the
    # runner-up, for ``predict``'s rows.
    second.model.eval()
    best_top1 = {}
    with torch.inference_mode():
        for batch in second.val_loader.epoch(0):
            top2 = second.model(batch["image"]).topk(2, dim=-1)
            idx = top2.indices[:, 0].cpu().numpy()
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            for iid, i, g, m in zip(batch.image_ids, idx, gap,
                                    batch["mask"].cpu().numpy()):
                if m > 0:
                    best_top1[iid] = (int(i), float(g))
    n_tensors = (len(want["model"]) + 3 + sum(
        len(v) for v in want["opt_state"].values()
        if isinstance(v, list)))
    row = {"model": first.mcfg.name, "optimizer": first.state.tx.kind,
           "steps_before_save": CKPT_STEPS, "tensors": n_tensors,
           "payload_bytes": saves["latest"]["bytes"],
           "host_and_disk_s": {
               "snapshot": {k: v["snapshot_s"] for k, v in saves.items()},
               "commit": {k: v["commit_s"] for k, v in saves.items()},
               "restore": restore_s, "restore_after_fallback": fallback_s},
           "restored_rung": rung, "restore_bits_equal": True,
           "next_step_loss": losses,
           "tensors_differing_after_next_step": len(after),
           "corrupt_latest_restored_rung": fallback,
           "fallback_bits_equal": True,
           "best_val_accuracy": best_val}
    log("ckpt", json.dumps(row))
    row["best_top1"] = best_top1
    del first, second
    free()
    return row


def _ckpt_model(ckpt_dir: str):
    """``[ckpt]``'s ``best`` ResNet-50 through the loading path the CLIs
    use, on the card, and its class names."""
    from tpuic_torch.checkpoint.loading import load_inference_variables
    from tpuic_torch.config import Config, DataConfig, RunConfig
    from tpuic_torch.predict import serving_model_config
    cfg = Config(data=DataConfig(data_dir=".", resize_size=IMAGE),
                 model=serving_model_config("resnet50", 1000),
                 run=RunConfig(ckpt_dir=ckpt_dir))
    model = load_inference_variables(cfg, track="best", log=lambda m: None)
    with open(os.path.join(ckpt_dir, "resnet50", "class_to_idx.json")) as f:
        names = {int(v): k for k, v in json.load(f).items()}
    return model, names


def _serve_cmd(ckpt_dir: str, *extra) -> list:
    return [sys.executable, "-m", "tpuic_torch.serve", "--ckpt-dir",
            ckpt_dir, "--model", "auto", "--buckets", "1,8,32", "--top-k",
            "5", *extra]


class _Records:
    """Newline-framed JSON records from a socket, the partial tail kept
    between reads."""

    def __init__(self, sock) -> None:
        self.sock, self.buf = sock, b""

    def read(self, done) -> list:
        """Records until ``done(records so far)`` holds or the peer
        closes."""
        out = []
        while not done(out):
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                break
            *recs, self.buf = (self.buf + chunk).split(b"\n")
            out.extend(json.loads(r) for r in recs if r.strip())
        return out


def phase_serve_cli(root: str, ckpt_dir: str, smi: str) -> dict:
    """``python -m tpuic_torch.serve`` as a user runs it, on ``[ckpt]``'s
    ResNet-50 checkpoint with ``--model auto``: CLI_IMAGES image files of
    the synthetic folder over stdin JSONL, each record's top-5
    probabilities held against a direct forward of the same decoded
    pixels (SERVE_TOL); then a ``--listen`` server: its ready file, a
    ping, requests by path and by b64 payload, a burst and SIGTERM, after
    which it must exit 0 with every request answered."""
    import glob
    import signal
    import socket

    from tpuic_torch.checkpoint.loading import variables_digest
    from tpuic_torch.serve import make_forward, wire
    from tpuic_torch.serve.__main__ import _load_image
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    paths = sorted(glob.glob(os.path.join(root, "val", "*", "*.png")))
    paths = paths[::max(1, len(paths) // CLI_IMAGES)][:CLI_IMAGES]
    t0 = time.perf_counter()
    out = subprocess.run(_serve_cmd(ckpt_dir), input="".join(
        json.dumps({"id": p, "path": p}) + "\n" for p in paths),
        capture_output=True, text=True, timeout=600, env=env, cwd=here)
    stdin_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail("serve-cli", f"stdin server exited {out.returncode}: "
                          f"{out.stderr[-3000:]}")
    recs = {r["id"]: r for r in map(json.loads, out.stdout.splitlines())}
    for line in out.stderr.splitlines():
        if "warmup" in line or "auto-resolved" in line:
            log("serve-cli", line)
    model, names = _ckpt_model(ckpt_dir)
    index = {v: k for k, v in names.items()}
    x = torch.from_numpy(np.stack([_load_image(p, IMAGE)
                                   for p in paths])).cuda()
    probs, order = (t.cpu().numpy() for t in make_forward(
        model, normalize=True)(x))
    worst, top1 = 0.0, 0
    for i, p in enumerate(paths):
        rec = recs.get(p)
        if rec is None or "pred" not in rec or len(rec["topk"]) != 5:
            fail("serve-cli", f"no answer for {p}: {rec}")
        for name, q in rec["topk"]:
            j = index.get(name, None if not name.isdigit() else int(name))
            worst = max(worst, abs(q - float(probs[i, j])))
        a, b = order[i, 0], order[i, 1]
        if rec["pred"] == names.get(int(a), str(a)):
            top1 += 1
        elif probs[i, a] - probs[i, b] > SERVE_TOL:
            fail("serve-cli", f"{p}: top-1 {rec['pred']} against the direct "
                              f"forward's {names.get(int(a), str(a))}")
    # Records carry probabilities rounded to 6 decimals (tpuic's format).
    if worst > SERVE_TOL:
        fail("serve-cli", f"served probabilities differ from a direct "
                          f"forward by {worst} > {SERVE_TOL}")
    digest = variables_digest(model)
    del model, x
    free()

    ready_file = os.path.join(root, "serve_cli_ready.json")
    err_path = os.path.join(root, "serve_cli_listen.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            _serve_cmd(ckpt_dir, "--listen", "127.0.0.1:0", "--ready-file",
                       ready_file), env=env, cwd=here,
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        while (ready := wire.read_ready_file(ready_file)) is None:
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                fail("serve-cli", f"--listen server never got ready: "
                                  f"{open(err_path).read()[-3000:]}")
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        img = _load_image(paths[0], IMAGE)[None]
        with socket.create_connection(("127.0.0.1", ready["port"]),
                                      timeout=300) as sock:
            lines = [{"op": "ping", "id": "ping"}]
            lines += [{"id": f"p{i}", "path": p}
                      for i, p in enumerate(paths[:8])]
            lines += [{"id": f"b{i}", **wire.encode_array(img)}
                      for i in range(8)]
            sock.sendall("".join(json.dumps(r) + "\n"
                                 for r in lines).encode())
            reader = _Records(sock)
            first = {r["id"]: r for r in reader.read(
                lambda got: len(got) >= len(lines))}
            # A burst, then a ping: the server reads a connection's lines
            # in order, so its pong means every burst line was accepted
            # (SIGTERM before that would close a socket holding unread
            # requests).  Then SIGTERM while the burst is in flight.
            burst = [{"id": f"s{i}", **wire.encode_array(img)}
                     for i in range(32)]
            sock.sendall("".join(json.dumps(r) + "\n" for r in burst
                                 + [{"op": "ping", "id": "ping2"}]).encode())
            rest = reader.read(lambda got: any(r.get("id") == "ping2"
                                               for r in got))
            proc.send_signal(signal.SIGTERM)
            rest += reader.read(lambda got: False)  # to the server's close
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    pong = first.get("ping", {})
    answered = [r for r in list(first.values()) + rest if "pred" in r]
    if (rc != 0 or pong.get("op") != "pong" or pong.get("digest") != digest
            or ready.get("digest") != digest or pong.get("generation") != 0
            or len(answered) != 16 + len(burst)):
        fail("serve-cli", f"--listen: exit {rc}, pong {pong}, ready "
                          f"{ready}, {len(answered)} of {16 + len(burst)} "
                          f"answered; {open(err_path).read()[-2000:]}")
    stats = [ln for ln in open(err_path).read().splitlines()
             if "served" in ln or "SIGTERM" in ln]
    row = {"images": len(paths), "stdin_wall_s": stdin_s,
           "max_abs_err_vs_direct": worst, "top1_equal": top1,
           "listen_ready_s": ready_s, "listen_exit": rc,
           "listen_answered": len(answered), "digest": digest,
           "listen_log": stats[-2:], "card": smi}
    log("serve-cli", json.dumps(row))
    return row


def phase_swap_cli(root: str, ckpt_dir: str, digest: str, smi: str) -> dict:
    """Swap lines through ``python -m tpuic_torch.serve --listen`` on
    ``[ckpt]``'s checkpoint: a ping; requests with ``{"op": "swap",
    "synthetic_seed": 1}`` among them, answered by a ``swap_result`` of
    generation 1 and then a pong and a ready file with its digest; a swap
    back to the checkpoint by ``ckpt_dir``, after which answers equal a
    direct forward of the checkpoint's model (SERVE_TOL) and the digest
    is ``[serve-cli]``'s again; a swap from a copy of the checkpoint with
    one byte flipped, refused with a typed ``swap_corrupt`` record while
    the digest and generation stay; then a burst, SIGTERM, exit 0 and
    every request answered."""
    import glob
    import shutil
    import signal
    import socket

    from tpuic_torch.checkpoint.manager import PAYLOAD
    from tpuic_torch.serve import make_forward, wire
    from tpuic_torch.serve.__main__ import _load_image
    tag = "swap-cli"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    paths = sorted(glob.glob(os.path.join(root, "val", "*", "*.png")))[:16]
    model, names = _ckpt_model(ckpt_dir)
    index = {v: k for k, v in names.items()}
    x = torch.from_numpy(np.stack([_load_image(p, IMAGE)
                                   for p in paths])).cuda()
    probs = make_forward(model, normalize=True)(x)[0].cpu().numpy()
    del model, x
    free()
    flipped = os.path.join(root, "ckpt_flipped")
    shutil.copytree(ckpt_dir, flipped)
    _flip_byte(os.path.join(flipped, "resnet50", "best", PAYLOAD))
    ready_file = os.path.join(root, "swap_cli_ready.json")
    err_path = os.path.join(root, "swap_cli_listen.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            _serve_cmd(ckpt_dir, "--listen", "127.0.0.1:0", "--ready-file",
                       ready_file), env=env, cwd=here,
            stdout=subprocess.DEVNULL, stderr=err)
    seen = {}
    try:
        t0 = time.perf_counter()
        while wire.read_ready_file(ready_file) is None:
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                fail(tag, f"--listen server never got ready: "
                          f"{open(err_path).read()[-3000:]}")
            time.sleep(0.1)
        port = wire.read_ready_file(ready_file)["port"]
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=300) as sock:
            reader = _Records(sock)

            def ask(lines, *ids):
                sock.sendall("".join(json.dumps(r) + "\n"
                                     for r in lines).encode())
                for r in reader.read(lambda got: all(
                        i in seen or any(g.get("id") == i for g in got)
                        for i in ids)):
                    seen[r.get("id")] = r
                return [seen[i] for i in ids]

            def req(prefix, n):
                return [{"id": f"{prefix}{i}", "path": paths[i % 16]}
                        for i in range(n)]

            (p0,) = ask([{"op": "ping", "id": "p0"}], "p0")
            t_swap = time.perf_counter()
            s1, p1 = ask(req("a", 8) + [{"op": "swap", "id": "s1",
                                         "synthetic_seed": 1}]
                         + req("b", 8) + [{"op": "ping", "id": "p1"}],
                         "s1", "p1")
            swap1_s = time.perf_counter() - t_swap
            *_, p2 = ask([{"op": "ping", "id": "p2"}],
                         *[f"{c}{i}" for c in "ab" for i in range(8)], "p2")
            ready = wire.read_ready_file(ready_file)
            s2, *_ = ask([{"op": "swap", "id": "s2", "ckpt_dir": ckpt_dir,
                           "track": "best"}], "s2")
            answers = ask(req("c", 16), *[f"c{i}" for i in range(16)])
            s3, p3 = ask([{"op": "swap", "id": "s3", "ckpt_dir": flipped,
                           "track": "best"}, {"op": "ping", "id": "p3"}],
                         "s3", "p3")
            (p4,) = ask([{"op": "ping", "id": "p4"}], "p4")
            burst = req("d", 16) + [{"op": "ping", "id": "p5"}]
            ask(burst, "p5")
            proc.send_signal(signal.SIGTERM)
            for r in reader.read(lambda got: False):  # to the server's close
                seen[r.get("id")] = r
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    worst = 0.0
    for i, rec in enumerate(answers):
        if "pred" not in rec:
            fail(tag, f"no answer after the swap back: {rec}")
        for name, q in rec["topk"]:
            j = index.get(name, None if not name.isdigit() else int(name))
            worst = max(worst, abs(q - float(probs[i % 16, j])))
    ids = [f"{c}{i}" for c in "ab" for i in range(8)] + \
        [f"c{i}" for i in range(16)] + [f"d{i}" for i in range(16)]
    answered = sum("pred" in seen.get(i, {}) for i in ids)
    new_digest = s1.get("digest")
    if (rc != 0 or p0.get("generation") != 0 or p0.get("digest") != digest
            or not s1.get("ok") or s1.get("generation") != 1
            or new_digest == digest
            or (p2.get("digest"), p2.get("generation")) != (new_digest, 1)
            or (ready.get("digest"), ready.get("generation"))
            != (new_digest, 1)
            or not s2.get("ok") or s2.get("generation") != 2
            or s2.get("digest") != digest or worst > SERVE_TOL
            or s3.get("cause") != "swap_corrupt"
            or (p4.get("digest"), p4.get("generation")) != (digest, 2)
            or answered != len(ids)):
        fail(tag, f"exit {rc}; pongs {p0} {p2} {p4}; ready {ready}; swaps "
                  f"{s1} {s2} {s3}; served against direct {worst}; "
                  f"{answered} of {len(ids)} answered; "
                  f"{open(err_path).read()[-2000:]}")
    row = {"answered": answered, "exit": rc,
           "swap_synthetic": {k: s1[k] for k in (
               "generation", "digest", "reused_executables", "prewarmed",
               "duration_s", "batcher_hold_s")},
           "swap_synthetic_line_to_result_s": swap1_s,
           "pong_after": {k: p2[k] for k in ("digest", "generation")},
           "swap_back": {k: s2[k] for k in ("generation", "digest",
                                            "reused_executables",
                                            "duration_s")},
           "max_abs_err_vs_direct_after_swap_back": worst,
           "corrupt": {k: s3.get(k) for k in ("cause", "error")},
           "pong_after_corrupt": {k: p4[k] for k in ("digest",
                                                     "generation")},
           "log": [ln for ln in open(err_path).read().splitlines()
                   if "hot-swap" in ln or "[swap]" in ln or "served" in ln
                   ][-6:], "card": smi}
    log(tag, json.dumps(row))
    return row


def phase_predict(root: str, ckpt_dir: str, val_accuracy: float,
                  best_top1: dict) -> dict:
    """``python -m tpuic_torch.predict`` (its ``main``) over the synthetic
    folder's val fold from ``[ckpt]``'s ``best`` track, at the
    ``Trainer``'s val batch: its accuracy must equal the ``Trainer``'s val
    accuracy for that save exactly; every batch must reach the engine as a
    tensor on the card (no host bounce); K3 launches 53 times per device
    call, the warmup's eager run and replay included; each row's top-1
    equals that of the ``Trainer``'s model called on the image wherever
    its top logit leads the next by more than MODEL_TOL."""
    import csv
    import io

    from tpuic_torch import predict
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = predict.main(["--datadir", root, "--ckpt-dir", ckpt_dir,
                           "--fold", "val", "--batchsize", str(TRAIN_BATCH),
                           "--no-pack", "--top-k", "5",
                           "--out", os.path.join(root, "predict.csv")])
    wall = time.perf_counter() - t0
    counts = read_counts()
    printed = buf.getvalue().strip().splitlines()
    for line in printed[:-1]:
        log("predict", line)
    summary = json.loads(printed[-1])
    eng = summary.pop("engine")
    n_buckets = eng["compiles"]
    batches = 2  # the val fold holds 2 x TRAIN_BATCH images
    want = expect(conv_bn_relu=53 * (eng["device_calls"] + 2 * n_buckets))
    if rc != 0 or summary.get("accuracy") != val_accuracy:
        fail("predict", f"accuracy {summary.get('accuracy')!r}, the "
                        f"Trainer's {val_accuracy!r} (exit {rc})")
    if (summary["device_requests"] != batches or summary["host_requests"]
            or summary["full_batches"] != batches or counts != want):
        fail("predict", f"{summary}: expected {batches} full batches, all "
                        f"on the card; launches {counts}, expected {want}")
    with open(os.path.join(ckpt_dir, "resnet50", "class_to_idx.json")) as f:
        index = json.load(f)
    with open(os.path.join(root, "predict.csv")) as f:
        rows = list(csv.DictReader(f))
    same, ties = 0, 0
    for r in rows:
        want, gap = best_top1[r["image_id"]]
        got = index.get(r["pred"], None if not r["pred"].isdigit()
                        else int(r["pred"]))
        if got == want:
            same += 1
        elif gap > MODEL_TOL:
            fail("predict", f"{r['image_id']}: predicted {got}, the "
                            f"Trainer's model {want} (logit gap {gap})")
        else:
            ties += 1
    if len(rows) != len(best_top1):
        fail("predict", f"{len(rows)} CSV rows for {len(best_top1)} images")
    row = {**summary, "trainer_val_accuracy": val_accuracy,
           "top1_equal_to_trainer_model": same, "near_ties": ties,
           "wall_s": wall, "launches": counts,
           "device_calls": eng["device_calls"], "buckets": n_buckets,
           "latency_ms": eng["latency_ms"], "span_ms": eng["span_ms"]}
    log("predict", json.dumps(row))
    return row


K4 = ("flash_attention_fwd", "flash_attention_bwd_dq",
      "flash_attention_bwd_dkv")


def attn_work(b: int, n: int = ATTN_N, h: int = ATTN_H, d: int = ATTN_D,
              itemsize: int = 4) -> dict:
    """(FLOPs, bytes) of each K4 kernel at [b, n, h, d]: the reference's
    CostEstimate FLOPs (4*B*H*N^2*D forward, 5*B*H*N^2*D per backward
    kernel, flash_attention.py:336, :465, :493) at the unpadded N; each
    input read once and each output written once (q/k/v/o/do/dq/dk/dv
    [B, N, H, D], lse and delta float32 [B, H, N])."""
    t = b * n * h * d * itemsize
    r = b * h * n * 4
    nnd = b * h * n * n * d
    return {"flash_attention_fwd": (4.0 * nnd, 3 * t + t + r),
            "flash_attention_bwd_dq": (5.0 * nnd, 5 * t + r + t + r),
            "flash_attention_bwd_dkv": (5.0 * nnd, 4 * t + 2 * r + 2 * t)}


@contextlib.contextmanager
def tf32_on():
    """TF32 allowed in cuBLAS matmuls and cuDNN convolutions in the block;
    restores both flags on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def phase_attn(device_name: str, gen: torch.Generator):
    """K4 against its plain versions at the ViT-B/16 shapes and the masked
    cases, then timed.  Returns the summaries at [64, 197, 12, 64] float32
    and every row."""
    from tpuic_torch.kernels import no_tf32
    FA = importlib.import_module("tpuic_torch.kernels.flash_attention")
    _, peak_flops, hbm = peaks(device_name)
    tc_peak = {torch.float32: tf32_peak(device_name) / 3,  # 3xTF32
               torch.bfloat16: bf16_peak(device_name)}

    def inputs(b, n, dtype=torch.float32):
        # q/k/v as the ViT makes them: strided views of one projection.
        qkv = torch.randn((b, n, 3 * ATTN_H * ATTN_D), generator=gen)
        q, k, v = (t.view(b, n, ATTN_H, ATTN_D)
                   for t in qkv.cuda().to(dtype).split(ATTN_H * ATTN_D, -1))
        do = torch.randn((b, n, ATTN_H, ATTN_D), generator=gen)
        return q, k, v, do.cuda().to(dtype)

    def check(label, q, k, v, do, tol, sentinel=0.0, backward=True, **mask):
        o, lse = FA.flash_attention_fwd(q, k, v, masked_sentinel=sentinel,
                                        **mask)
        dq, delta = FA.flash_attention_bwd_dq(q, k, v, o, lse, do, **mask)
        dk, dv = FA.flash_attention_bwd_dkv(q, k, v, lse, delta, do, **mask)
        torch.cuda.synchronize()
        want_o, want_lse = FA.flash_attention_fwd_plain(
            q, k, v, masked_sentinel=sentinel, **mask)
        wdq, wdk, wdv = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     **mask)
        want_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        pairs = {"flash_attention_fwd": ((o, lse), (want_o, want_lse)),
                 "flash_attention_bwd_dq": ((dq, delta), (wdq, want_delta)),
                 "flash_attention_bwd_dkv": ((dk, dv), (wdk, wdv))}
        if not backward:
            pairs = {"flash_attention_fwd": pairs["flash_attention_fwd"]}
        errs = {name: max_err([t.float() for t in got],
                              [t.float() for t in want])
                for name, (got, want) in pairs.items()}
        bad = [name for name, (got, want) in pairs.items()
               if not all(torch.allclose(a.float(), b.float(), rtol=tol,
                                         atol=tol)
                          for a, b in zip(got, want))]
        if bad:
            fail("attn", f"{label}: {bad} beyond atol/rtol {tol}; max abs "
                         f"err {errs}")
        log("attn", f"{label}: max abs err {json.dumps(errs)} (atol/rtol "
                    f"{tol})")
        return errs, (o, lse, delta), (dq, dk, dv)

    def tf32_checks(label, q, k, v, o, lse, do, grads):
        """The float32 kernels are 3xTF32 whatever the TF32 flags say: the
        forward's o and lse and the backward's dq, dk, dv have the same
        bits with TF32 allowed.  And the tolerance tells 3xTF32 from one
        TF32 pass: the plain forward and the plain backward with their
        products in TF32 must each fall outside it.  Returns the two
        controls' max abs errors (forward, backward)."""
        want_fwd = FA.flash_attention_fwd_plain(q, k, v)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
        with tf32_on():
            fwd = FA.flash_attention_fwd(q, k, v)
            dq, delta = FA.flash_attention_bwd_dq(q, k, v, o, lse, do)
            dk, dv = FA.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
            single_fwd = FA.flash_attention_fwd_plain(q, k, v)
            single = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        if not (torch.equal(fwd[0], o) and torch.equal(fwd[1], lse)):
            fail("attn", f"{label}: o/lse differ between allow_tf32 False "
                         "and True")
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), grads)):
            fail("attn", f"{label}: dq/dk/dv differ between allow_tf32 "
                         "False and True")
        errs = []
        for what, got, ref in (("forward", single_fwd, want_fwd),
                               ("backward", single, want)):
            err = max_err(got, ref)
            if all(torch.allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
                   for a, b in zip(got, ref)):
                fail("attn", f"{label}: the plain {what} in single-pass TF32 "
                             f"is within atol/rtol {F32_TOL} of float32 "
                             f"(max abs err {err}), so the check cannot tell "
                             "it from 3xTF32")
            errs.append(err)
        log("attn", f"{label}: o, lse, dq, dk, dv bitwise equal under "
                    "allow_tf32 False and True; the plain forward in TF32 "
                    f"is {errs[0]} off, the plain backward {errs[1]}, both "
                    f"outside atol/rtol {F32_TOL}")
        return errs

    from tpuic_torch.kernels.flash_attention_bench import earlier_bf16_fwd
    rows, main, main_bf16 = [], {}, {}
    with no_tf32():
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).replace("torch.", "")
            for b in ATTN_BATCHES:
                label = f"{dname} [{b}, {ATTN_N}, {ATTN_H}, {ATTN_D}]"
                q, k, v, do = inputs(b, ATTN_N, dtype)
                errs, (o, lse, delta), grads = check(label, q, k, v, do, tol)
                tf32_err = (tf32_checks(label, q, k, v, o, lse, do, grads)
                            if dtype == torch.float32 else None)
                del grads
                fwd_device = {"kernel": device_ms(
                                  lambda: FA.flash_attention_fwd(q, k, v)),
                              "sdpa": device_ms(
                                  lambda: F.scaled_dot_product_attention(
                                      *(t.transpose(1, 2)
                                        for t in (q, k, v))))}
                ms = {"flash_attention_fwd": time_ms(
                          lambda: FA.flash_attention_fwd(q, k, v)),
                      "flash_attention_bwd_dq": time_ms(
                          lambda: FA.flash_attention_bwd_dq(q, k, v, o, lse,
                                                            do)),
                      "flash_attention_bwd_dkv": time_ms(
                          lambda: FA.flash_attention_bwd_dkv(q, k, v, lse,
                                                             delta, do))}
                # The plain backward computes dq, dk and dv in one
                # function: its time stands beside each backward kernel.
                plain = {"fwd": time_ms(
                             lambda: FA.flash_attention_fwd_plain(q, k, v),
                             iters=10),
                         "bwd": time_ms(
                             lambda: FA.flash_attention_bwd_plain(
                                 q, k, v, o, lse, do),
                             iters=10)}
                # SDPA on [B, H, N, D] views of the same tensors, timed
                # only, never called by the port: the forward; the backward
                # alone (one forward outside the timed calls, then
                # autograd.grad with the graph kept); forward + backward.
                qh, kh, vh, gh = (t.transpose(1, 2) for t in (q, k, v, do))
                qr, kr, vr = (t.detach().requires_grad_(True)
                              for t in (qh, kh, vh))
                out = F.scaled_dot_product_attention(qr, kr, vr)

                def sdpa_fwd_bwd():
                    y = F.scaled_dot_product_attention(qr, kr, vr)
                    return torch.autograd.grad(y, (qr, kr, vr), gh)

                sdpa = {"fwd": time_ms(
                            lambda: F.scaled_dot_product_attention(qh, kh,
                                                                   vh)),
                        "bwd": time_ms(lambda: torch.autograd.grad(
                            out, (qr, kr, vr), gh, retain_graph=True)),
                        "fwd_bwd": time_ms(sdpa_fwd_bwd)}
                row = {"shape": [b, ATTN_N, ATTN_H, ATTN_D], "dtype": dname,
                       "max_abs_err": errs, "tf32_plain_max_abs_err": tf32_err,
                       "ms": ms, "plain_ms": plain, "sdpa_ms": sdpa,
                       "fwd_device_ms": fwd_device,
                       "fwd_over_sdpa_fwd": ms["flash_attention_fwd"]
                       / sdpa["fwd"],
                       "bound_ms": {}, "bound_by": {},
                       "fp32_core_bound_ms": {}, "fp32_core_bound_by": {},
                       "share_of_bound": {},
                       "bwd_sum_ms": ms["flash_attention_bwd_dq"]
                       + ms["flash_attention_bwd_dkv"]}
                row["bwd_sum_over_sdpa_bwd"] = row["bwd_sum_ms"] / sdpa["bwd"]
                if dtype == torch.bfloat16:
                    # The earlier bf16 forward (flash_attention.cu's
                    # mma.sync build, PR 7), held and timed beside.
                    eo, el = earlier_bf16_fwd(q, k, v)
                    torch.cuda.synchronize()
                    row["earlier_fwd"] = {
                        "max_abs_err": max_err((eo.float(), el),
                                               (o.float(), lse)),
                        "ms": time_ms(lambda: earlier_bf16_fwd(q, k, v)),
                        "device_ms": device_ms(
                            lambda: earlier_bf16_fwd(q, k, v))}
                    if row["earlier_fwd"]["max_abs_err"] > BF16_TOL:
                        fail("attn", f"{label}: the earlier bf16 forward "
                                     f"is {row['earlier_fwd']} off")
                    del eo, el
                for name, (ops, nbytes) in attn_work(
                        b, itemsize=dtype.itemsize).items():
                    core = bound(ops, nbytes, peak_flops, hbm)
                    # The bound at the rate of the products each kernel
                    # issues: 3xTF32 (float32) or bf16 tensor-core MMAs.
                    # The float32 CUDA-core bound is kept beside it.
                    bms, by = bound(ops, nbytes, tc_peak[dtype], hbm)
                    row["bound_ms"][name], row["bound_by"][name] = bms, by
                    (row["fp32_core_bound_ms"][name],
                     row["fp32_core_bound_by"][name]) = core
                    row["share_of_bound"][name] = bms / ms[name]
                rows.append(row)
                log("attn", json.dumps(row))
                if b == VIT_BATCH:
                    summary = main if dtype == torch.float32 else main_bf16
                    for name in K4:
                        fwd = name == "flash_attention_fwd"
                        summary[name] = {
                            "max_abs_err": errs[name], "ms": ms[name],
                            "plain_ms": plain["fwd" if fwd else "bwd"],
                            "bound_ms": row["bound_ms"][name],
                            "bound_by": row["bound_by"][name],
                            "fp32_core_bound_ms": row["fp32_core_bound_ms"][
                                name],
                            "library_ms": sdpa["fwd"] if fwd else None}
                        if fwd:
                            summary[name].update(
                                device_ms=fwd_device["kernel"],
                                library_device_ms=fwd_device["sdpa"],
                                over_library=row["fwd_over_sdpa_fwd"])
                            if tf32_err is not None:
                                summary[name]["tf32_plain_max_abs_err"] = \
                                    tf32_err[0]
                            if "earlier_fwd" in row:
                                summary[name]["earlier"] = row["earlier_fwd"]
                        else:
                            # No one PyTorch call computes dq alone or
                            # dk/dv alone: SDPA's backward (dq, dk and dv)
                            # stands beside the pair's sum.
                            summary[name].update(
                                sdpa_bwd_ms=sdpa["bwd"],
                                sdpa_fwd_bwd_ms=sdpa["fwd_bwd"],
                                bwd_sum_ms=row["bwd_sum_ms"],
                                bwd_sum_over_sdpa_bwd=row[
                                    "bwd_sum_over_sdpa_bwd"])
                del q, k, v, do, o, lse, delta, qh, kh, vh, gh, qr, kr, vr
                del out
                free()
        # The masks, in both builds of each dtype (bf16's forward is the
        # TMA and wgmma kernel; N = 300 refills its key ring).
        none = torch.zeros(1, dtype=torch.int32, device="cuda")
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).replace("torch.", "")
            q, k, v, do = inputs(4, 64, dtype)
            check(f"{dname} valid_len 50 of 64", q, k, v, do, tol,
                  valid_len=50)
            check(f"{dname} valid 50 of 64 (device count)", q, k, v, do,
                  tol, valid=torch.tensor([50], dtype=torch.int32,
                                          device="cuda"))
            for sentinel in (0.0, FA.NEG_INF):
                # A row whose lse is the -1e30 sentinel has p = 1 at every
                # key in the backward, so dq and dk/dv are sums of 64 ds
                # of a few units each: in bf16, ds rounded to 8 bits (as
                # the reference rounds it) lies outside 1e-2 of the float32
                # plain version there.  bf16 holds the forward of that case
                # (the masked rows' o and lse); float32 holds all of it.
                _, (o, lse, _), _ = check(
                    f"{dname} fully masked, sentinel {sentinel}", q, k, v,
                    do, tol, sentinel=sentinel, valid=none,
                    backward=dtype == torch.float32 or sentinel == 0.0)
                if not (bool((o == 0).all())
                        and bool((lse == sentinel).all())):
                    fail("attn", f"fully masked rows: o max "
                                 f"{o.abs().max()}, lse "
                                 f"{lse.unique().tolist()[:4]}, expected 0 "
                                 f"and {sentinel}")
            q, k, v, do = inputs(2, 300, dtype)
            check(f"{dname} [2, 300, 12, 64], valid_len 233", q, k, v, do,
                  tol, valid_len=233)
    return main, main_bf16, rows


def phase_vit(gen: torch.Generator, seed: int):
    """ViT-B/16 through K4 against the same weights under dense attention;
    returns the flash model for serving."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model
    model = init_synthetic(create_model(VIT_MODEL, 1000, dtype="float32",
                                        attention="flash",
                                        image_size=IMAGE), seed=seed)
    dense = create_model(VIT_MODEL, 1000, dtype="float32",
                         attention="dense", image_size=IMAGE)
    dense.load_state_dict(model.state_dict())
    model.eval()
    dense.eval()
    x = torch.randn((4, IMAGE, IMAGE, 3), generator=gen).cuda()
    with torch.inference_mode():
        model(x)
        with no_tf32():
            reset_counts()
            flash = model(x)
            counts = read_counts()
            ref = dense(x)
        flash_ms = time_ms(lambda: model(x), iters=10)
        dense_ms = time_ms(lambda: dense(x), iters=10)
    if counts != expect(flash_attention_fwd=VIT_LAYERS):
        fail("vit", f"launches per forward {counts}, expected "
                    f"{VIT_LAYERS} flash_attention_fwd")
    if not (torch.isfinite(flash).all() and flash.shape == (4, 1000)):
        fail("vit", f"logits {tuple(flash.shape)} not finite")
    err = float((flash - ref).abs().max())
    if not torch.allclose(flash, ref, rtol=MODEL_TOL, atol=MODEL_TOL):
        fail("vit", f"flash vs dense logits: max abs err {err} beyond "
                    f"atol/rtol {MODEL_TOL}")
    log("vit", json.dumps({
        "model": VIT_MODEL, "classes": 1000, "image": IMAGE, "batch": 4,
        "dtype": "float32", "params": sum(p.numel()
                                          for p in model.parameters()),
        "launches_per_forward": counts["flash_attention_fwd"],
        "max_abs_err_vs_dense": err,
        "logit_abs_max": float(ref.abs().max()),
        "top1_agree": bool((flash.argmax(-1) == ref.argmax(-1)).all()),
        "flash_forward_ms": flash_ms, "dense_forward_ms": dense_ms}))
    del dense
    free()
    return model


def vit_train_config(root: str, seed: int, dtype: str = "float32"):
    """The repo's ViT-B/16 recipe (recipes/README.md, section 4) on one
    card, in ``dtype`` (bfloat16: ``compute_dtype`` bf16, as the
    reference trains), through the flash kernels and the fused loss,
    without the regularisers the port does not have yet (mixup, CutMix,
    random erasing, drop-path, EMA)."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=IMAGE,
                        batch_size=VIT_BATCH, num_workers=8,
                        shuffle_seed=seed, native=False, pack=False),
        model=ModelConfig(name=VIT_MODEL, num_classes=1000, dtype=dtype,
                          compute_dtype="bf16" if dtype == "bfloat16"
                          else "", attention="flash"),
        optim=OptimConfig(optimizer="adam", learning_rate=VIT_LR,
                          weight_decay=0.05, warmup_epochs=10,
                          milestones=(), label_smoothing=0.1,
                          grad_clip_norm=1.0, class_weights=(),
                          fused_loss=True),
        run=RunConfig(epochs=300, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt")))


def _logged_losses(lines: list) -> dict:
    """``{step: loss}`` from a ``Trainer``'s log lines."""
    import re
    out = {}
    for line in lines:
        m = re.search(r"step (\d+); Loss ([-\d.e+]+)\|", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def phase_vit_train(root: str, seed: int, smi: str):
    """ViT-B/16 training through ``Trainer``, in float32 and in bf16 (K4's
    bf16 kernels forward and backward, every attention block's input and
    output bfloat16), launches counted per arm; the bf16 arm's logged
    losses within BF16_LOSS_RTOL of the float32 arm's at the same steps
    (one init, one data order); then the 3-step comparison of the kernels
    with dense attention and the plain loss, and a bf16 arm through the
    kernels held to BF16_LOSS_RTOL of the float32 kernels'."""
    from tpuic_torch.train.loop import Trainer
    counts, rows, losses = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = vit_train_config(root, seed, dtype)
        lines = []

        def note(msg, lines=lines):
            lines.append(msg)
            log("vit-train", msg)

        trainer = Trainer(cfg, log=note)
        reset_counts()
        probe = (attn_dtypes() if dtype == "bfloat16"
                 else contextlib.nullcontext())
        with probe as seen:
            trainer.fit()
        stats = dict(trainer.stats)
        trainer.val_epoch(0)
        counts[dtype] = read_counts()
        losses[dtype] = _logged_losses(lines)
        steps = stats["steps"]
        val_forwards = len(trainer.val_loader)
        want = expect(flash_attention_fwd=VIT_LAYERS * (steps
                                                        + val_forwards),
                      flash_attention_bwd_dq=VIT_LAYERS * steps,
                      flash_attention_bwd_dkv=VIT_LAYERS * steps,
                      cross_entropy_fwd=steps, cross_entropy_bwd=steps)
        if steps != TRAIN_STEPS or counts[dtype] != want:
            fail("vit-train", f"{dtype}: {steps} steps, launches "
                              f"{counts[dtype]}, expected {TRAIN_STEPS} "
                              f"steps and {want}")
        if not all(bool(torch.isfinite(p).all())
                   for p in trainer.model.parameters()) or not all(
                math.isfinite(v) for v in trainer.last_val.values()):
            fail("vit-train", f"{dtype}: non-finite state after {steps} "
                              f"steps: val {trainer.last_val}")
        rows[dtype] = train_row(trainer, stats, counts[dtype], VIT_BATCH,
                                smi)
        if dtype == "bfloat16":
            rows[dtype]["attn_dtypes"] = check_conv_dtypes(
                "vit-train", "bf16 arm's attention blocks", seen,
                "bfloat16")
            if not all(p.dtype == torch.float32
                       for p in trainer.model.parameters()):
                fail("vit-train", "bf16: master weights are not float32")
        log("vit-train", json.dumps(rows[dtype]))
        if dtype == "float32":
            batches = first_batches(trainer)
        del trainer
        free()
    logged = sorted(set(losses["float32"]) & set(losses["bfloat16"]))
    rel = {s_: abs(losses["bfloat16"][s_] - losses["float32"][s_])
           / abs(losses["float32"][s_]) for s_ in logged}
    log("vit-train", "bf16 vs float32 Trainer losses: " + json.dumps(
        {"steps": logged, "float32": losses["float32"],
         "bfloat16": losses["bfloat16"], "rel_diff": rel,
         "rtol": BF16_LOSS_RTOL}))
    if not rel or max(rel.values()) > BF16_LOSS_RTOL:
        fail("vit-train", f"bf16 and float32 Trainer losses differ by "
                          f"{rel} (rtol {BF16_LOSS_RTOL})")
    cfg = vit_train_config(root, seed)
    arms = compare_plain(
        cfg, batches, seed, VIT_COMPARE_LR,
        plain_model=dataclasses.replace(cfg.model, attention="dense"),
        bf16_model=vit_train_config(root, seed, "bfloat16").model,
        probe=attn_dtypes)
    bf16_rel = [abs(b["loss"] - k["loss"]) / abs(k["loss"])
                for b, k in zip(arms["bf16"]["metrics"],
                                arms["kernels"]["metrics"])]
    bf16_attn = check_conv_dtypes("vit-train", "3-step bf16 arm's attention",
                                  arms["bf16"].pop("conv_dtypes"),
                                  "bfloat16")
    row = check_compare("vit-train", arms)
    row["bf16_loss_rel_diff"] = bf16_rel
    row["bf16_attn_dtype"] = bf16_attn
    log("vit-train", "3-step bf16 vs float32 through the kernels: "
                     + json.dumps({"loss_rel_diff": bf16_rel,
                                   "rtol": BF16_LOSS_RTOL}))
    if max(bf16_rel) > BF16_LOSS_RTOL:
        fail("vit-train", f"3-step bf16 and float32 losses differ by "
                          f"{max(bf16_rel)} > {BF16_LOSS_RTOL}")
    del batches
    free()
    return counts, {**rows, "trainer_loss_rel_diff": rel, "compare": row}


def rows_check(model, tag: str, image: int) -> dict:
    """Rows served through the engine's ``make_forward`` (TF32 off for the
    call): one image's probabilities from a batch-1 forward against its row
    of a batch-32 forward, within SERVE_TOL."""
    from tpuic_torch.serve import make_forward
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, image, image, 3), dtype=np.uint8)).cuda()
    served = make_forward(model, normalize=True)
    big, _ = served(images)
    rows = (0, 17, 31)
    diff = max(float((served(images[r:r + 1])[0][0] - big[r]).abs().max())
               for r in rows)
    if not bool(torch.isfinite(big).all()):
        fail(tag, "non-finite probabilities")
    if diff > SERVE_TOL:
        fail(tag, f"a row's probabilities at batch 1 and in batch "
                  f"{SERVE_BATCH} differ by {diff} > {SERVE_TOL}")
    return {"rows": list(rows), "probs_max_abs_diff": diff,
            "batch32_forward_ms": time_ms(lambda: served(images), iters=5)}


def phase_cnn_serve(name: str, image: int, tag: str, n_requests: int,
                    seed: int, smi: str) -> dict:
    """``name`` at full width, 1000 classes, seeded synthetic weights, in
    eval mode: batch-1 rows against batch-32 rows, then ``phase_serve``'s
    engine, clients and graph checks.  No kernel lies on this forward (as
    in ``tpuic``, K3 is ResNet-only): every launch count must stay 0."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    model = init_synthetic(create_model(name, 1000, dtype="float32"),
                           seed=0).eval()
    params = sum(p.numel() for p in model.parameters())
    bucket = rows_check(model, tag, image)
    log(tag, json.dumps({"model": name, "image": image, "classes": 1000,
                         "params": params, "dtype": "float32",
                         "batch1_vs_batch32": bucket}))
    _, snap = phase_serve(model, n_requests, seed, smi, tag=tag,
                          counter=None, image=image)
    del model
    free()
    return {"model": name, "image": image, "params": params,
            "batch1_vs_batch32": bucket, "serve": snap}


def write_ref_folder(root: str, seed: int, per_train: int,
                     per_val: int) -> None:
    """A synthetic ImageFolder of the reference's 7 classes at 299 px."""
    from tpuic_torch.data.synthetic import make_synthetic_imagefolder
    classes = tuple(f"class{i}" for i in range(len(REF_WEIGHTS)))
    make_synthetic_imagefolder(root, classes, per_class=per_train,
                               size=INC_IMAGE, folds=("train",), seed=seed)
    make_synthetic_imagefolder(root, classes, per_class=per_val,
                               size=INC_IMAGE, folds=("val",), seed=seed + 1)


def inception_train_config(root: str, seed: int, dtype: str):
    """The reference program's recipe (train.py: InceptionV3 with its aux
    head at 299 px, Adam lr 0.5e-5, MultiStepLR [50, 80], the 7 class
    weights) at batch 32, with the fused loss K1."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=INC_IMAGE,
                        batch_size=INC_BATCH, num_workers=8,
                        shuffle_seed=seed, native=False, pack=False),
        model=ModelConfig(name="inceptionv3", dtype=dtype,
                          compute_dtype="bf16" if dtype == "bfloat16"
                          else ""),
        optim=OptimConfig(optimizer="adam", class_weights=REF_WEIGHTS,
                          fused_loss=True),
        run=RunConfig(epochs=100, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt"),
                      resume=False))


def phase_inception_train(root: str, seed: int, smi: str):
    """InceptionV3 training, the reference's own model and recipe, through
    ``Trainer``: 12 steps in float32 and 12 in bf16, each counting two K1
    forward and two K1 backward launches a step (main and aux logits);
    then 3 steps from one state through the kernels, through the plain
    loss (float32, TF32 off: loss rtol 1e-3) and through the kernels in
    bf16 (loss within BF16_LOSS_RTOL of the float32 kernels')."""
    from tpuic_torch.train.loop import Trainer
    t0 = time.perf_counter()
    write_ref_folder(root, seed, per_train=INC_BATCH * TRAIN_STEPS
                     // len(REF_WEIGHTS) + 1, per_val=4)
    log("inception-train", f"synthetic ImageFolder {INC_IMAGE}x{INC_IMAGE}, "
                           f"{len(REF_WEIGHTS)} classes, in "
                           f"{time.perf_counter() - t0:.3f} s")
    rows, counts = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = inception_train_config(root, seed, dtype)
        trainer = Trainer(cfg, log=lambda msg: log("inception-train", msg))
        reset_counts()
        with conv_dtypes() as seen:
            trainer.fit()
        stats = dict(trainer.stats)
        counts[dtype] = read_counts()
        conv_out = check_conv_dtypes("inception-train", dtype, seen, dtype)
        steps = stats["steps"]
        want = expect(cross_entropy_fwd=2 * steps,
                      cross_entropy_bwd=2 * steps)
        if steps != TRAIN_STEPS or counts[dtype] != want:
            fail("inception-train", f"{dtype}: {steps} steps, launches "
                                    f"{counts[dtype]}, expected "
                                    f"{TRAIN_STEPS} steps and {want}")
        if not all(bool(torch.isfinite(p).all())
                   for p in trainer.model.parameters()):
            fail("inception-train", f"{dtype}: non-finite parameters")
        if not all(p.dtype == torch.float32
                   for p in trainer.model.parameters()) or not all(
                t.dtype == torch.float32 for t in trainer.state.opt_state.mu):
            fail("inception-train", f"{dtype}: master weights or Adam "
                                    "moments are not float32")
        trainer.val_epoch(0)  # one val forward: no kernel on it
        rows[dtype] = train_row(trainer, stats, counts[dtype], INC_BATCH,
                                smi)
        rows[dtype]["conv_out_dtype"] = conv_out
        log("inception-train", json.dumps(rows[dtype]))
        if dtype == "float32":
            batches = first_batches(trainer)
        del trainer
        free()
    cfg = inception_train_config(root, seed, "float32")
    arms = compare_plain(cfg, batches, seed, cfg.optim.learning_rate,
                         bf16_model=inception_train_config(
                             root, seed, "bfloat16").model)
    bf16_rel = [abs(b["loss"] - k["loss"]) / abs(k["loss"])
                for b, k in zip(arms["bf16"]["metrics"],
                                arms["kernels"]["metrics"])]
    bf16_conv = check_conv_dtypes("inception-train", "3-step bf16 arm",
                                  arms["bf16"].pop("conv_dtypes"),
                                  "bfloat16")
    row = check_compare("inception-train", arms)
    row["bf16_loss_rel_diff"] = bf16_rel
    row["bf16_conv_out_dtype"] = bf16_conv
    log("inception-train", "bf16 vs float32 through the kernels: "
                           + json.dumps({"loss_rel_diff": bf16_rel,
                                         "rtol": BF16_LOSS_RTOL}))
    if max(bf16_rel) > BF16_LOSS_RTOL:
        fail("inception-train", f"bf16 and float32 losses differ by "
                                f"{max(bf16_rel)} > {BF16_LOSS_RTOL}")
    del batches
    free()
    return counts, {**rows, "compare": row}


def _train_cli(argv: list):
    """``python -m tpuic_torch.train``'s ``main`` in this process (so its
    kernel launches count), its printed lines kept."""
    import io

    from tpuic_torch.train import __main__ as train_cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def _rows(path: str) -> dict:
    import csv
    with open(path) as f:
        return {r["image_id"]: r["pred"] for r in csv.DictReader(f)}


def _predict(root: str, ckpt_dir: str, batch: int, tag: str,
             out: str) -> dict:
    """``python -m tpuic_torch.predict``'s ``main`` on the val fold of the
    single trained model under ``ckpt_dir`` (``--model auto``), its rows
    written to ``out``."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module("tpuic_torch.predict").main(
            ["--datadir", root, "--ckpt-dir", ckpt_dir, "--fold", "val",
             "--batchsize", str(batch), "--no-pack", "--out", out])
    printed = buf.getvalue().strip().splitlines()
    for line in printed[:-1]:
        log(tag, line)
    if rc != 0:
        fail(tag, f"predict exited {rc}")
    return json.loads(printed[-1])


def _trainer_forward(root: str, ckpt_dir: str, batch: int,
                     out: str) -> dict:
    """The val fold scored by the ``Trainer``'s own eval forward: the run's
    model config from its ``config.json`` (its dtype, no fused kernel),
    through ``run_predict``, its rows written to ``out``."""
    from tpuic_torch.config import Config, DataConfig, ModelConfig, RunConfig
    from tpuic_torch.predict import resolve_model_auto, run_predict
    name = resolve_model_auto(ckpt_dir)["name"]
    with open(os.path.join(ckpt_dir, name, "config.json")) as f:
        saved = json.load(f)
    model = dict(saved["model"], head_widths=tuple(
        saved["model"]["head_widths"]))
    cfg = Config(data=DataConfig(data_dir=root,
                                 resize_size=saved["data"]["resize_size"],
                                 batch_size=batch, val_batch_size=batch,
                                 pack=False, native=False),
                 model=ModelConfig(**model),
                 run=RunConfig(ckpt_dir=ckpt_dir))
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return run_predict(cfg, fold="val", track="best", top_k=1,
                           out_path=out)


def against_trainer(tag: str, arm: str, root: str, ckpt_dir: str,
                    batch: int, best: float, limit: int,
                    k3: bool) -> dict:
    """Predict's CLI on ``best`` (float32 through the kernels, as the serve
    CLI serves every checkpoint) against the ``Trainer``'s own forward,
    which must score ``best`` exactly: the two may disagree on at most
    ``limit`` val images, and their accuracies lie at most ``limit``
    images apart.  ``k3``: predict's forward launches K3 and nothing
    else (the ResNet family), else no kernel."""
    cli_out = os.path.join(root, f"predict_{arm}.csv")
    own_out = os.path.join(root, f"trainer_forward_{arm}.csv")
    reset_counts()
    summary = _predict(root, ckpt_dir, batch, tag, cli_out)
    launched = read_counts()
    want = expect(conv_bn_relu=launched["conv_bn_relu"]) if k3 else expect()
    if launched != want or (k3 and not launched["conv_bn_relu"]):
        fail(tag, f"{arm}: predict launched {launched}")
    own = _trainer_forward(root, ckpt_dir, batch, own_out)
    if round(own.get("accuracy", -1.0), 4) != best:
        fail(tag, f"{arm}: the Trainer's forward scores "
                  f"{own.get('accuracy')} on best, the Trainer {best}")
    got, ref = _rows(cli_out), _rows(own_out)
    if set(got) != set(ref):
        fail(tag, f"{arm}: predict wrote {len(got)} rows, the Trainer's "
                  f"forward {len(ref)}")
    n = len(got)
    disagree = sum(got[k] != ref[k] for k in got)
    gap = abs(round(summary["accuracy"] * n / 100) - round(best * n / 100))
    row = {"predict_accuracy": summary["accuracy"], "predict_rows": n,
           "trainer_forward_accuracy": own["accuracy"],
           "disagree_images": disagree, "accuracy_gap_images": gap,
           "limit_images": limit, "predict_launches": launched}
    if disagree > limit or gap > limit:
        fail(tag, f"{arm}: predict (float32) and the Trainer's forward "
                  f"disagree on {disagree} of {n} images, accuracies "
                  f"{gap} images apart; the limit is {limit}")
    return row


def phase_ref_cli(root: str, seed: int, smi: str) -> dict:
    """The reference program's own command on the port, with nothing
    added but its data, one epoch and a checkpoint directory:
    ``python -m tpuic_torch.train --datadir D --epochs 1 --no-pack
    --no-native --ckpt-dir C`` (InceptionV3 with its aux head, 299 px,
    bfloat16, Adam, batch 4, the 7 class weights), as a user starts it.
    It must exit 0 and write ``best`` and ``latest``; predict scores
    ``best`` in float32, as served, within REF_PREDICT_LIMIT images of the
    ``Trainer``'s bf16 forward (``against_trainer``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "ref")
    write_ref_folder(data, seed, per_train=8, per_val=4)
    ckpt = os.path.join(root, "ref_ckpt")
    cmd = [sys.executable, "-m", "tpuic_torch.train", "--datadir", data,
           "--epochs", "1", "--no-pack", "--no-native", "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=here), cwd=here)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        if line.startswith(("[model]", "[tpuic_torch]", "[ckpt]")) \
                or "Val Accuracy" in line:
            log("ref-cli", line)
    if out.returncode != 0:
        fail("ref-cli", f"exited {out.returncode}: {out.stderr[-3000:]}")
    model_dir = os.path.join(ckpt, "inceptionv3")
    missing = [t for t in ("best", "latest")
               if not os.path.isdir(os.path.join(model_dir, t))]
    if missing or not any("bfloat16 compute" in ln for ln in lines):
        fail("ref-cli", f"tracks missing {missing}, or not the bfloat16 "
                        f"defaults: {lines[:3]}")
    best = float(lines[-1].split("best val accuracy ")[1])
    scored = against_trainer("ref-cli", "bfloat16", data, ckpt, 4, best,
                             REF_PREDICT_LIMIT, k3=False)
    row = {"command": " ".join(cmd[1:]), "wall_s": wall,
           "trainer_best": best, **scored, "card": smi}
    log("ref-cli", json.dumps(row))
    return row


DIGITS_ARGS = ["--model", "resnet18-cifar", "--resize", "32", "--batchsize",
               "128", "--optimizer", "sgd", "--lr", "0.05",
               "--warmup-epochs", "3", "--weight-decay", "5e-4",
               "--milestones", "--epochs", str(DIGITS_EPOCHS),
               "--no-augment", "--no-class-weights", "--fused-loss",
               "--no-pack", "--no-native", "--log-every-steps", "11"]


def phase_digits(root: str, smi: str):
    """The port's first real-data run: sklearn's
    handwritten digits (``tpuic_torch.data.digits``, 1,438 train and 359
    val images) through the train CLI with the recipe of
    ``perf/convergence_digits.json``, once in float32 and once in
    bfloat16.  Each arm's best val top-1 must reach DIGITS_BOUND (350 of
    359, stated before the first run), K1 must launch once forward and
    once backward a step, and every convolution of the arm's first step
    must return its dtype.  Predict scores each ``best`` in float32
    through K3, as served, within DIGITS_PREDICT_LIMIT images of the
    ``Trainer``'s forward (``against_trainer``); in the float32 arm its
    accuracy also equals the ``Trainer``'s."""
    from tpuic_torch.data.digits import write_digits_folder
    data = os.path.join(root, "digits")
    counts_written = write_digits_folder(data)
    out, counts = {}, {}
    for dtype in ("float32", "bfloat16"):
        ckpt = os.path.join(root, f"digits_ckpt_{dtype}")
        reset_counts()
        with conv_dtypes() as seen:
            rc, lines, wall = _train_cli(["--datadir", data, "--ckpt-dir",
                                          ckpt, "--dtype", dtype,
                                          *DIGITS_ARGS])
        counts[dtype] = read_counts()
        conv_out = check_conv_dtypes("digits", dtype, seen, dtype)
        for line in lines:
            if line.startswith(("[model]", "[tpuic_torch]")):
                log("digits", f"{dtype}: {line}")
        curve = [float(ln.split("Val Accuracy ")[1].split(";")[0])
                 for ln in lines if "Val Accuracy" in ln]
        steps = max((int(ln.split("; step ")[1].split(";")[0])
                     for ln in lines if ln.startswith("Epoch: ")
                     and "; step " in ln), default=0)
        best = max(curve) if curve else 0.0
        want = expect(cross_entropy_fwd=steps, cross_entropy_bwd=steps)
        if rc != 0 or len(curve) != DIGITS_EPOCHS or counts[dtype] != want:
            fail("digits", f"{dtype}: exit {rc}, {len(curve)} val passes, "
                           f"launches {counts[dtype]}, expected {want}")
        scored = against_trainer("digits", dtype, data, ckpt, 128, best,
                                 DIGITS_PREDICT_LIMIT, k3=True)
        row = {"dtype": dtype, "val_top1_per_epoch": curve, "best": best,
               "bound": DIGITS_BOUND, "steps": steps, "wall_s": wall,
               "launches": counts[dtype], "conv_out_dtype": conv_out,
               **scored, "card": smi}
        log("digits", json.dumps(row))
        if best < DIGITS_BOUND:
            fail("digits", f"{dtype}: best val top-1 {best} < "
                           f"{DIGITS_BOUND}")
        if dtype == "float32" and round(scored["predict_accuracy"],
                                        4) != best:
            fail("digits", f"float32: predict's accuracy "
                           f"{scored['predict_accuracy']} on best, the "
                           f"Trainer's {best}")
        out[dtype] = row
    out["images"] = counts_written
    return counts, out


def _serve_rung(eng, pool, n_requests: int, seed: int, dtype=None,
                on_answer=None, keep_going=None):
    """Eight closed-loop clients sending ``n_requests`` requests of 1-8
    images of ``pool`` to ``eng`` (or, with ``keep_going``, as long as it
    returns true), each naming the rung ``dtype`` (a callable of the
    client's generator picks one a request).  Returns the answers
    ``(rung, lo, n, outputs, submitted)``, the errors, the wall seconds
    and Python's collections during the traffic."""
    results, errors, lock = [], [], threading.Lock()
    n_clients = 8

    def requests():
        if keep_going is None:
            return range(n_requests // n_clients)
        return iter(keep_going, False)

    def client(tid):
        r = np.random.default_rng(seed + 1 + tid)
        try:
            for _ in requests():
                n = int(r.integers(1, 9))
                lo = int(r.integers(0, pool.shape[0] - n + 1))
                tag = dtype(r) if callable(dtype) else dtype
                t_sub = time.perf_counter()
                out = eng.submit(pool[lo:lo + n], dtype=tag).result(
                    timeout=600)
                with lock:
                    results.append((tag, lo, n, out, t_sub))
                    if on_answer is not None:
                        on_answer(len(results))
        except Exception as e:  # reported by the caller; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    with gc_pauses() as pauses:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        errors.append("a client did not finish")
    return results, errors, time.perf_counter() - t0, pauses


def _pool_outputs(forward, pool) -> np.ndarray:
    """A rung's probabilities of every pool image, 32 at a time (the last
    chunk padded with zero images to 32, as the engine pads a bucket)."""
    out = []
    for lo in range(0, pool.shape[0], SERVE_BATCH):
        chunk = pool[lo:lo + SERVE_BATCH]
        x = np.zeros((SERVE_BATCH,) + chunk.shape[1:], chunk.dtype)
        x[:chunk.shape[0]] = chunk
        out.append(forward(torch.from_numpy(x).cuda())[0].cpu().numpy()[
            :chunk.shape[0]])
    return np.concatenate(out)


def ladder_model(name: str, image: int, seed: int):
    """``name`` at full width, 1000 classes, synthetic weights from
    ``seed``, float32, in eval mode: the fused ResNet-50 (K3), ViT-B/16
    with flash attention (K4), InceptionV3 as ``tpuic`` serves it."""
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    kw = {"resnet50": dict(fused_conv_bn=True),
          VIT_MODEL: dict(attention="flash", image_size=image)}.get(name, {})
    return init_synthetic(create_model(name, 1000, dtype="float32", **kw),
                          seed=seed).eval()


def phase_ladder(name: str, image: int, seed: int, smi: str,
                 counter=None, per_call: int = 0, swap: bool = False):
    """The serve ladder for ``name``: the gate (each rung's top-1
    agreement with fp32 on ``quant.eval_images(128)`` at least ``1 -
    DEFAULT_EPSILON``, the corruption arm below it), each rung's batch-1
    rows against batch-32 rows (RUNG_ROW_TOL), weight bytes on the card,
    then one engine serving all three rungs, a graph per (rung, bucket):
    per rung the client mix of ``[serve]`` (images/s, latency, spans,
    launches per device call, answers against the rung's direct forward
    within RUNG_SERVE_TOL).  ``swap``: one swap of the whole ladder under
    mixed traffic, every answer one generation's."""
    from tpuic_torch import quant
    from tpuic_torch.serve import (DEFAULT_BUCKETS, InferenceEngine,
                                   make_forward)
    tag, t0 = "ladder", time.perf_counter()
    model = ladder_model(name, image, seed)
    rungs = quant.serve_variants(model, quant.DTYPE_TAGS)
    fwd = {t: make_forward(m, normalize=True) for t, m in rungs.items()}
    floor = 1.0 - quant.DEFAULT_EPSILON
    imgs = quant.eval_images(128, image)
    agree = {t: quant.top1_agreement(fwd["fp32"], fwd[t], imgs,
                                     device="cuda")
             for t in quant.DTYPE_TAGS[1:]}
    bad = quant.quantized_forward(quant.corrupt_variables(model, seed=seed))
    corrupt = quant.top1_agreement(fwd["fp32"], make_forward(
        bad, normalize=True), imgs, device="cuda")
    del bad
    free()
    if min(agree.values()) < floor or corrupt >= floor:
        fail(tag, f"{name}: gate agreement {agree} (floor {floor}), the "
                  f"corruption arm {corrupt} (must fall below it)")
    # Each rung's own forward, a row at batch 1 against batch 32: held to
    # RUNG_ROW_TOL for every rung the engine runs at every bucket; for a
    # rung it pins to its largest bucket (rows_follow_batch) reported.
    rows = {t: _rung_rows(tag, name, t, rungs[t], f, image)
            for t, f in fwd.items()}
    leaves = set(quant.quantized_leaves(model))
    leaf_bytes = {
        "fp32": sum(p.numel() * p.element_size()
                    for n, p in model.named_parameters() if n in leaves),
        "int8": sum(b.numel() * b.element_size()
                    for n, b in rungs["int8"].named_buffers()
                    if n.endswith(("weight_q", "weight_scale")))}
    weight_bytes = {t: quant.weight_bytes(m) for t, m in rungs.items()}
    eng = InferenceEngine(rungs["fp32"], image_size=image,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32), variants={
                              t: m for t, m in rungs.items()
                              if t != "fp32"})
    warm = eng.warmup()
    memory = eng.graph_memory()
    buckets = {t: eng.bucket_for(1, t) for t in quant.DTYPE_TAGS}
    # Served rows: an image alone and inside a request of 32, through the
    # engine, against RUNG_ROW_TOL (0 by construction for a pinned rung:
    # both ride bucket 32).
    rng = np.random.default_rng(1)
    x32 = rng.integers(0, 256, (SERVE_BATCH, image, image, 3),
                       dtype=np.uint8)
    served_rows = {}
    for t in quant.DTYPE_TAGS:
        big = eng.submit(x32, dtype=t).result(timeout=600)[0]
        served_rows[t] = max(float(np.abs(eng.submit(
            x32[r:r + 1], dtype=t).result(timeout=600)[0][0] - big[r]).max())
            for r in (0, 17, 31))
        if served_rows[t] > RUNG_ROW_TOL[t]:
            fail(tag, f"{name} {t}: a served row alone and in a request of "
                      f"{SERVE_BATCH} differ by {served_rows[t]} (bound "
                      f"{RUNG_ROW_TOL[t]})")
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, image, image, 3), dtype=np.uint8)
    refs = {t: _pool_outputs(f, pool) for t, f in fwd.items()}
    served = {}
    for t in quant.DTYPE_TAGS:
        reset_counts()
        windows, calls = [], 0
        for _ in range(LADDER_WINDOWS):
            # The same requests each window: the windows differ by timing.
            eng.stats.reset()
            results, errors, wall, pauses = _serve_rung(
                eng, pool, LADDER_REQUESTS, seed, dtype=t)
            snap = eng.stats.snapshot()
            if errors:
                fail(tag, f"{name} {t}: client errors {errors[:3]}")
            worst = max(float(np.abs(out[0] - refs[t][lo:lo + n]).max())
                        for _, lo, n, out, _ in results)
            if worst > RUNG_SERVE_TOL[t]:
                fail(tag, f"{name} {t}: served probabilities {worst} from "
                          f"a direct forward (bound {RUNG_SERVE_TOL[t]})")
            calls += snap["device_calls"]
            windows.append({
                "requests": len(results), "images": snap["images"],
                "images_per_s": snap["throughput_images_per_sec"],
                "images_per_s_wall": snap["images"] / wall,
                "latency_ms": snap["latency_ms"], "span_ms": snap["span_ms"],
                "device_calls": snap["device_calls"],
                "max_abs_err_vs_direct": worst,
                "gc_during_traffic": pauses})
        counts = read_counts()
        launches = counts.get(counter, 0) if counter else 0
        others = {k: v for k, v in counts.items() if k != counter and v}
        if launches != per_call * calls or others:
            fail(tag, f"{name} {t}: {launches} {counter} launches for "
                      f"{calls} device calls (expected {per_call} each), "
                      f"other kernels {others}")
        rates = sorted(r["images_per_s"] for r in windows)
        served[t] = {
            "images_per_s": rates[len(rates) // 2],
            "images_per_s_spread": (rates[-1] - rates[0]) / rates[0],
            "windows": windows, "device_calls": calls, "kernel": counter,
            "kernel_launches": launches, "launch_counts": counts,
            "lone": _lone_requests(eng, pool, t)}
    out = {"model": name, "image": image, "gate_agreement": agree,
           "corruption_agreement": corrupt, "gate_floor": floor,
           "batch1_vs_batch32": rows, "bucket_of_one_image": buckets,
           "served_batch1_vs_batch32": served_rows,
           "row_bounds": RUNG_ROW_TOL,
           "weight_bytes": weight_bytes, "quantized_leaf_bytes": leaf_bytes,
           "warmup_s": warm, "graph_memory": memory, "served": served,
           "card": smi}
    if swap:
        out["swap"] = _ladder_swap(eng, name, image, seed, pool, refs, tag)
    eng.close()
    del eng
    free()
    # A lone bf16 request at the serve CLI's default buckets.
    cli = InferenceEngine(rungs["bf16"], image_size=image,
                          input_dtype=np.uint8, normalize=True,
                          buckets=DEFAULT_BUCKETS, default_variant="bf16")
    cli.warmup()
    out["bf16_lone_at_cli_buckets"] = {
        "buckets": list(DEFAULT_BUCKETS), **_lone_requests(cli, pool,
                                                           "bf16")}
    cli.close()
    out["seconds"] = time.perf_counter() - t0
    log(tag, json.dumps(out))
    del cli, rungs, fwd, model
    free()
    return out


def _rung_rows(tag: str, name: str, t: str, rung, f, image: int) -> dict:
    """Rung ``t``'s forward ``f``: the largest probability difference
    between a row at batch 1 and the same row in a batch of 32 (rows 0,
    17, 31).  The phase fails on a non-finite output, or where the engine
    runs the rung at every bucket and the rows differ beyond
    RUNG_ROW_TOL."""
    from tpuic_torch.serve.engine import rows_follow_batch
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, image, image, 3), dtype=np.uint8)).cuda()
    big = f(x)[0]
    diff = max(float((f(x[r:r + 1])[0][0] - big[r]).abs().max())
               for r in (0, 17, 31))
    pinned = rows_follow_batch(t, rung)
    if not bool(torch.isfinite(big).all()) or (
            not pinned and diff > RUNG_ROW_TOL[t]):
        fail(tag, f"{name} {t}: a row at batch 1 and in batch "
                  f"{SERVE_BATCH} differ by {diff} (bound "
                  f"{RUNG_ROW_TOL[t]}), served at every bucket")
    return {"diff": diff, "max_prob": float(big.max()),
            "largest_bucket_only": pinned}


def _lone_requests(eng, pool, t: str) -> dict:
    """LONE_REQUESTS one-image requests of rung ``t``, one at a time:
    the bucket they ride, their latency and device span (ms)."""
    eng.stats.reset()
    for i in range(LONE_REQUESTS):
        eng.submit(pool[i:i + 1], dtype=t).result(timeout=600)
    snap = eng.stats.snapshot()
    return {"bucket": eng.bucket_for(1, t), "batch_hist": snap["batch_hist"],
            "latency_ms": snap["latency_ms"],
            "device_span_ms": snap["span_ms"].get("device")}


def bf16_rows_by_family(smi: str) -> dict:
    """The bf16 rung's batch-1 rows against batch 32 (``_rung_rows``) of
    the families ``[ladder]`` does not serve: EfficientNet-B3 and
    ResNet-50 unfused (cuDNN's convolutions, pinned by the engine)."""
    from tpuic_torch import quant
    from tpuic_torch.checkpoint import init_synthetic
    from tpuic_torch.models import create_model
    from tpuic_torch.serve import make_forward
    out = {}
    for label, name, image, kw in (
            ("efficientnet-b3", EFF_MODEL, EFF_IMAGE, {}),
            ("resnet50 unfused", "resnet50", IMAGE, {})):
        model = init_synthetic(create_model(name, 1000, dtype="float32",
                                            **kw), seed=0).eval()
        rung = quant.bf16_variables(model)
        out[label] = _rung_rows("ladder", label, "bf16", rung,
                                make_forward(rung, normalize=True), image)
        del model, rung
        free()
    log("ladder", f"bf16 rows by family: {json.dumps(out)} | {smi}")
    return out


def _ladder_swap(eng, name, image, seed, pool, refs, tag) -> dict:
    """One swap of the whole ladder to another seed's weights while eight
    clients send requests of every rung: each answer must be the old
    ladder's or the new one's for its rung (within RUNG_SERVE_TOL, the two
    at least twice that apart), and every request submitted after the
    swap returned the new one's."""
    from tpuic_torch import quant
    from tpuic_torch.serve import make_forward
    new = quant.serve_variants(ladder_model(name, image, seed + 1),
                               quant.DTYPE_TAGS)
    refs_b = {t: _pool_outputs(make_forward(m, normalize=True), pool)
              for t, m in new.items()}
    half = threading.Event()
    swapped, sent = {}, {"all": 0, "after": 0}
    lock = threading.Lock()

    def answered(n):
        if n >= SWAP_REQUESTS // 3:
            half.set()

    def keep_going():
        # Until a third of SWAP_REQUESTS went in after the swap returned.
        with lock:
            sent["all"] += 1
            if "done" in swapped:
                sent["after"] += 1
            return (sent["after"] <= SWAP_REQUESTS // 3
                    and sent["all"] <= 20 * SWAP_REQUESTS)

    def swap_when_half():
        half.wait(timeout=600)
        swapped["t"] = time.perf_counter()
        swapped["res"] = eng.swap_weights(new["fp32"], variants={
            t: new[t] for t in quant.DTYPE_TAGS[1:]})
        swapped["done"] = time.perf_counter()

    worker = threading.Thread(target=swap_when_half)
    worker.start()
    results, errors, wall, _ = _serve_rung(
        eng, pool, SWAP_REQUESTS, seed + 7,
        dtype=lambda r: quant.DTYPE_TAGS[int(r.integers(0, 3))],
        on_answer=answered, keep_going=keep_going)
    worker.join(timeout=600)
    if errors or "res" not in swapped:
        fail(tag, f"{name} swap: errors {errors[:3]}, swap {swapped}")
    by_gen, gap = {"A": 0, "B": 0}, float("inf")
    for t, lo, n, out, t_sub in results:
        a = float(np.abs(out[0] - refs[t][lo:lo + n]).max())
        b = float(np.abs(out[0] - refs_b[t][lo:lo + n]).max())
        gap = min(gap, float(np.abs(refs[t][lo:lo + n]
                                    - refs_b[t][lo:lo + n]).max()))
        gen = "A" if a <= RUNG_SERVE_TOL[t] else (
            "B" if b <= RUNG_SERVE_TOL[t] else None)
        if gen is None or (t_sub > swapped["done"] and gen != "B"):
            fail(tag, f"{name} swap: a {t} request answered {a} from A and "
                      f"{b} from B (bound {RUNG_SERVE_TOL[t]}), submitted "
                      f"{'after' if t_sub > swapped['done'] else 'before'} "
                      "the swap returned")
        by_gen[gen] += 1
    if gap <= 2 * max(RUNG_SERVE_TOL.values()) or not by_gen["B"]:
        fail(tag, f"{name} swap: A and B lie {gap} apart, answers {by_gen}")
    row = {**swapped["res"], "answered_by": by_gen, "least_a_b_distance":
           gap, "requests": len(results), "wall_s": wall,
           "graph_memory": eng.graph_memory()}
    log(tag, f"{name} swap under traffic: " + json.dumps(row))
    return row


def phase_serve_cli_ladder(root: str, ckpt_dir: str, smi: str) -> dict:
    """``python -m tpuic_torch.serve --serve-dtypes fp32,bf16,int8`` on
    ``[ckpt]``'s checkpoint as a user runs it: CLI_IMAGES image files over
    stdin, each request naming a rung with ``serve_dtype`` in turn, every
    record's top-5 probabilities within that rung's RUNG_SERVE_TOL of the
    rung's direct forward of the same decoded pixels; the start gate's
    lines and the warmup's graph count printed."""
    import glob

    from tpuic_torch import quant
    from tpuic_torch.serve import make_forward
    from tpuic_torch.serve.__main__ import _load_image
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    paths = sorted(glob.glob(os.path.join(root, "val", "*", "*.png")))
    paths = paths[::max(1, len(paths) // CLI_IMAGES)][:CLI_IMAGES]
    tags = quant.DTYPE_TAGS
    t0 = time.perf_counter()
    out = subprocess.run(
        _serve_cmd(ckpt_dir, "--serve-dtypes", ",".join(tags)),
        input="".join(json.dumps({"id": p, "path": p,
                                  "serve_dtype": tags[i % 3]}) + "\n"
                      for i, p in enumerate(paths)),
        capture_output=True, text=True, timeout=600, env=env, cwd=here)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail("serve-cli-ladder", f"exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
    gate = [ln for ln in out.stderr.splitlines()
            if "accuracy gate" in ln or "warmup" in ln]
    for line in gate:
        log("serve-cli-ladder", line)
    recs = {r["id"]: r for r in map(json.loads, out.stdout.splitlines())}
    model, names = _ckpt_model(ckpt_dir)
    index = {v: k for k, v in names.items()}
    rungs = quant.serve_variants(model, tags)
    x = np.stack([_load_image(p, IMAGE) for p in paths])
    probs = {t: _pool_outputs(make_forward(m, normalize=True), x)
             for t, m in rungs.items()}
    worst = {t: 0.0 for t in tags}
    for i, p in enumerate(paths):
        t, rec = tags[i % 3], recs.get(p)
        if rec is None or "pred" not in rec or len(rec["topk"]) != 5:
            fail("serve-cli-ladder", f"no answer for {p} ({t}): {rec}")
        for name, q in rec["topk"]:
            j = index.get(name, None if not name.isdigit() else int(name))
            worst[t] = max(worst[t], abs(q - float(probs[t][i, j])))
    if any(worst[t] > RUNG_SERVE_TOL[t] for t in tags):
        fail("serve-cli-ladder", f"records against the rungs' direct "
                                 f"forwards: {worst} (bounds "
                                 f"{RUNG_SERVE_TOL})")
    row = {"images": len(paths), "wall_s": wall, "tags": list(tags),
           "max_abs_err_vs_direct": worst, "gate_lines": gate, "card": smi}
    log("serve-cli-ladder", json.dumps(row))
    del model, rungs
    free()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this smoke run "
                       "needs an NVIDIA GPU")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{smi} | torch {torch.__version__} CUDA "
                  f"{torch.version.cuda} | {kind} | peaks "
                  f"{peaks(kind)}")

    from tpuic_torch.kernels import _build
    t_start = t0 = time.perf_counter()
    built = _build.build()
    log("build", f"{json.dumps(built)} in {time.perf_counter() - t0:.3f} s")
    for name in _build.sources():
        for line in _build.ptxas_log(name).splitlines():
            if any(key in line for key in ("entry function", "Function "
                                           "properties", "registers",
                                           "spill")):
                log("build", f"{name}: {line.strip()}")

    gen = torch.Generator().manual_seed(args.seed)
    summary, rows = phase_kernel(kind, gen)
    model = phase_model(gen)
    launches, snap = phase_serve(model, args.requests, args.seed, smi)
    summary["launches"] = launches
    summary["status"] = "ok"
    swap = phase_swap(model, resnet50_b(args.seed + 1), SWAP_REQUESTS,
                      args.seed, smi)
    admission = phase_admission(model, args.seed, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    xent, xent_rows = phase_xent(kind, gen)
    optim = phase_optim(kind, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        write_folder(root, args.seed)
        counts, lamb_counts, train = phase_train(root, args.seed, smi)
        ckpt_dir = os.path.join(root, "ckpt_smoke")
        ckpt = phase_ckpt(root, args.seed, ckpt_dir)
        serve_cli = phase_serve_cli(root, ckpt_dir, smi)
        swap_cli = phase_swap_cli(root, ckpt_dir, serve_cli["digest"], smi)
        predicted = phase_predict(root, ckpt_dir, ckpt["best_val_accuracy"],
                                  ckpt.pop("best_top1"))
        attn, attn_bf16, attn_rows = phase_attn(kind, gen)
        vit = phase_vit(gen, args.seed)
        # Under torch's default flags: the engine's forward turns TF32 off
        # for its call, and the ViT's patch embedding is one matmul, which
        # cuBLAS runs in float32 by default.
        _, vit_snap = phase_serve(vit, args.requests, args.seed, smi,
                                  tag="vit-serve",
                                  counter="flash_attention_fwd",
                                  per_call=VIT_LAYERS)
        vit_swap = phase_swap(vit, vit_b(args.seed + 1), SWAP_REQUESTS,
                              args.seed, smi, tag="vit-swap",
                              name=VIT_MODEL,
                              counter="flash_attention_fwd",
                              per_call=VIT_LAYERS, stopped=1)
        del vit
        free()
        vit_counts, vit_train = phase_vit_train(root, args.seed, smi)
        took = {"to_vit_train": time.perf_counter() - t_start}
        t0 = time.perf_counter()
        ladder = {
            "resnet50": phase_ladder("resnet50", IMAGE, args.seed, smi,
                                     counter="conv_bn_relu",
                                     per_call=len(resnet50_launches(1)),
                                     swap=True),
            "inceptionv3": phase_ladder("inceptionv3", INC_IMAGE, args.seed,
                                        smi),
            VIT_MODEL: phase_ladder(VIT_MODEL, IMAGE, args.seed, smi,
                                    counter="flash_attention_fwd",
                                    per_call=VIT_LAYERS)}
        ladder["bf16_rows_by_family"] = bf16_rows_by_family(smi)
        took["ladder"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_ladder = phase_serve_cli_ladder(root, ckpt_dir, smi)
        took["serve-cli-ladder"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inception = phase_cnn_serve("inceptionv3", INC_IMAGE, "inception",
                                    args.requests, args.seed, smi)
        took["inception"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inc_counts, inc_train = phase_inception_train(
            os.path.join(root, "inception"), args.seed, smi)
        took["inception-train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_cli = phase_ref_cli(root, args.seed, smi)
        took["ref-cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        digits_counts, digits = phase_digits(root, smi)
        took["digits"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        effnet = phase_cnn_serve(EFF_MODEL, EFF_IMAGE, "effnet-serve",
                                 args.requests, args.seed, smi)
        took["effnet-serve"] = time.perf_counter() - t0
    took["total"] = time.perf_counter() - t_start
    log("timing", json.dumps(took))

    def k1(name):
        """K1's launches on each training path, each counted from 0 just
        before its path ran; ``launches`` stays ``[train]``'s."""
        return {"train": counts[name], **{
            f"{tag} {dtype}": c[name]
            for tag, per in (("inception-train", inc_counts),
                             ("digits", digits_counts))
            for dtype, c in per.items()}}

    csrc = "tpuic_torch/kernels/csrc/"
    kernels = [summary]
    for name, row, source, replaces, n in (
            ("cross_entropy_fwd", xent["cross_entropy_fwd"],
             csrc + "cross_entropy.cu", "tpuic/kernels/cross_entropy.py:50",
             counts["cross_entropy_fwd"]),
            ("cross_entropy_bwd", xent["cross_entropy_bwd"],
             csrc + "cross_entropy.cu", "tpuic/kernels/cross_entropy.py:64",
             counts["cross_entropy_bwd"]),
            ("lars_update", optim["lars_update"],
             csrc + "optimizer_update.cu",
             "tpuic/kernels/optimizer_update.py:94", counts["lars_update"]),
            ("lamb_update", optim["lamb_update"],
             csrc + "optimizer_update.cu",
             "tpuic/kernels/optimizer_update.py:146",
             lamb_counts["lamb_update"]),
            *((name, attn[name], csrc + "flash_attention.cu",
               f"tpuic/kernels/flash_attention.py:{line}",
               vit_counts["float32"][name])
              for name, line in zip(K4, (154, 346, 373))),
            # bf16 builds: K4f's TMA and wgmma kernel at D = 64, the
            # backward pair's and K3's bf16 builds; launches on the bf16
            # paths (the ladder's bf16 rungs, [vit-train]'s bf16 arm).
            *((f"{name} (bf16)", attn_bf16[name],
               csrc + ("flash_fwd_sm90.cu" if name == K4[0]
                       else "flash_attention.cu"),
               f"tpuic/kernels/flash_attention.py:{line}",
               vit_counts["bfloat16"][name] + (
                   ladder[VIT_MODEL]["served"]["bf16"]["kernel_launches"]
                   if name == K4[0] else 0))
              for name, line in zip(K4, (154, 346, 373))),
            ("conv_bn_relu (bf16 x)", {
                "max_abs_err": summary["bf16_max_abs_err"],
                **{k: summary["bf16"][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "issue_rate_ms", "library_ms", "library_device_ms",
                    "over_library")},
                f"batch{SERVE_BATCH}": summary[f"batch{SERVE_BATCH}"][
                    "bf16"]},
             csrc + "conv_bn_relu_sm90.cu",
             "tpuic/kernels/conv_bn_relu.py:76",
             ladder["resnet50"]["served"]["bf16"]["kernel_launches"])):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n, **row,
                        "status": "ok"})
        if name.startswith("cross_entropy"):
            kernels[-1]["launches_by_path"] = k1(name)
    # K3 on the ladder's int8 and bf16 ResNet-50 rungs beside [serve]'s.
    summary["launches_by_path"] = {
        "serve": launches, **{f"ladder {t}": r["kernel_launches"] for t, r
                              in ladder["resnet50"]["served"].items()}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kind": kind, "kernels": kernels,
                       "shapes": rows,
                       "serve": snap, "xent": xent_rows, "train": train,
                       "swap": swap, "admission": admission,
                       "ckpt": ckpt, "serve_cli": serve_cli,
                       "swap_cli": swap_cli, "predict": predicted,
                       "attn": attn_rows, "vit_serve": vit_snap,
                       "vit_swap": vit_swap, "vit_train": vit_train,
                       "inception": inception,
                       "inception_train": inc_train, "ref_cli": ref_cli,
                       "digits": digits, "effnet_serve": effnet,
                       "ladder": ladder, "serve_cli_ladder": cli_ladder,
                       "k1_launches": {"train": counts, "inception_train":
                                       inc_counts, "digits": digits_counts},
                       "seconds": took},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
