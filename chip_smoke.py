"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--requests N] [--seed S] [--out smoke.json]

Drives ``tpuic_torch``'s serving path on the card and exits non-zero at
the first phase that fails:

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
   tells one TF32 pass from 3xTF32).
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
   and as host cost per call.
6. xent   — the fused cross-entropy forward and backward kernels (K1) at
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
7. optim  — the fused LARS and LAMB update kernels (K2) over the whole
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
8. train  — ``Trainer`` on a synthetic 224x224 ImageFolder written by
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
9. ckpt   — the checkpoint (``tpuic_torch/checkpoint/manager.py``) with
   ``train``'s configuration: a ``Trainer`` takes 3 steps and saves
   ``best`` and ``latest``; a fresh ``Trainer`` restores them, and every
   parameter, BN buffer and K2 optimizer-state tensor must equal the saved
   one bit for bit; the next step's loss on one batch, cuDNN
   deterministic, must equal the uninterrupted trainer's exactly; with one
   byte of ``latest``'s payload flipped the restore must fall back to
   ``best``, bit for bit.  The payload's bytes and the host and disk
   seconds to snapshot, commit and restore are reported.
10. serve-cli — ``python -m tpuic_torch.serve --model auto`` as a
   subprocess on ``ckpt``'s ResNet-50 checkpoint: 48 image files of the
   synthetic folder over stdin JSONL, each record's top-5 probabilities
   within 1e-5 of a direct forward of the same decoded pixels; then a
   ``--listen`` server: ready file, a ping answered with the model's
   digest, requests by path and by b64 array, a burst and SIGTERM, after
   which it exits 0 with every request answered.
11. predict — ``python -m tpuic_torch.predict``'s ``main`` over the val
   fold from that checkpoint's ``best`` track at the ``Trainer``'s val
   batch: its accuracy equals the ``Trainer``'s val accuracy for the save
   exactly, every batch reaches the engine as a tensor on the card, and
   K3 launches 53 times per device call.
12. attn  — the flash-attention kernels (K4: forward, dq, dk/dv) at the
   ViT-B/16 shapes [8, 197, 12, 64] and [64, 197, 12, 64], on strided
   q/k/v views of one qkv projection, against their plain versions
   (float32, TF32 off, atol/rtol 1e-4; bfloat16 at 1e-2); in float32 the
   forward and the backward again with TF32 allowed, which must give the
   same bits (they are 3xTF32 whatever the flag says), and the plain
   forward and backward in single-pass TF32, which must each fall outside
   the 1e-4 tolerance (so the check tells TF32 from 3xTF32); plus a
   ``valid_len`` case (50 of 64 keys) and a
   fully masked case (o = 0, lse = the sentinel, for sentinels 0 and
   -1e30).  Each kernel is timed beside its plain version and one
   ``F.scaled_dot_product_attention`` call (timed only): the forward
   beside K4f; SDPA's backward alone (from one forward outside the timed
   calls) and its forward + backward beside the sum of dq and dk/dv, as
   no one call computes either alone; the forward and SDPA's also on the
   card alone.  The bound is at the rate of the products each kernel
   issues, 3xTF32 or bf16 MMAs (the float32 CUDA-core bound beside it).
13. vit   — ``create_model("vit-b16", 1000, dtype="float32",
   attention="flash")`` with seeded synthetic weights: its logits at batch
   4 against the same weights under ``attention="dense"`` (TF32 off,
   atol/rtol 1e-3), and exactly 12 K4 forward launches per forward.
14. vit-serve — the engine serving that model as ``serve`` serves
   ResNet-50 (graphs, their memory, graph against eager, the batch-8
   times), under torch's default flags: 12 K4 forward launches per device
   call.
15. vit-train — ``Trainer`` on the ImageFolder of ``train``: ViT-B/16 with
   the repo's ViT recipe (recipes/README.md, section 4: AdamW lr 3e-4, wd
   0.05, 10 warmup epochs of 300, label smoothing 0.1, clipping at 1.0,
   batch 64), ``attention="flash"`` and the fused loss, for 12 steps, then
   one val pass.  Launches: K4 forward 12 per step and 12 per val forward,
   dq and dk/dv 12 per step, K1 once per step.  Then 3 steps from one
   state through the kernels and 3 through dense attention and the plain
   loss, TF32 off: the per-step losses agree within rtol 1e-3.

Every launch count is set to 0 just before a path runs and read just after
it.  Cuts: float32, not bf16; no mixup, CutMix, random erasing, EMA or
drop-path; one card.

The second-to-last lines are the per-kernel JSON summary and the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
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
XENT_RTOL, XENT_ATOL = 1e-5, 1e-6
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
TRAIN_LOSS_RTOL = 1e-3
COMPARE_LR = 0.48
TRAIN_BATCH = 128
TRAIN_STEPS = 12
TRAIN_CLASSES = 8
LAMB_BATCH = 32
CKPT_STEPS = 3
VIT_MODEL = "vit-b16"
VIT_BATCH = 64
VIT_LR = 3e-4
VIT_COMPARE_LR = 3e-5
VIT_LAYERS = 12
ATTN_N, ATTN_H, ATTN_D = 197, 12, 64
ATTN_BATCHES = (8, VIT_BATCH)

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
                                                  no_tf32, plan)
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
    del xb, gotb, wantb
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
           "flops": flops, "bytes": nbytes}
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


def phase_serve(model, n_requests: int, seed: int, smi: str,
                tag: str = "serve", counter: str = "conv_bn_relu",
                per_call: int = 0):
    """Serve ``model`` to eight closed-loop clients through one CUDA graph
    per bucket; ``counter``'s kernel must launch ``per_call`` times per
    device call (default: the 53 of a fused ResNet-50 forward; replays
    count the launches their graph captured) and no other kernel may
    launch.  Then the graphs against eager forwards (``graph_checks``)."""
    from tpuic_torch.serve import InferenceEngine, make_forward
    per_call = per_call or len(resnet50_launches(1))
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    eng = InferenceEngine(model, None, image_size=IMAGE,
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
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts[counter]
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
    if launches == 0 or launches != per_call * snap["device_calls"] \
            or others:
        fail(tag, f"{launches} {counter} launches for "
                  f"{snap['device_calls']} device calls (expected "
                  f"{per_call} each), other kernels {others}")
    graphs = graph_checks(eng, model, tag)
    log(tag, json.dumps({
        "requests": len(results), "images": snap["images"],
        "wall_s": wall, "device_calls": snap["device_calls"],
        "kernel": counter, "kernel_launches": launches,
        "latency_ms": snap["latency_ms"],
        "throughput_images_per_sec": snap["throughput_images_per_sec"],
        "images_per_s_wall": snap["images"] / wall,
        "pad_efficiency": snap["pad_efficiency"],
        "batch_hist": snap["batch_hist"], "span_ms": snap["span_ms"],
        "max_abs_err_vs_direct": worst, "graph_memory": memory,
        "graphs": graphs, "card": smi}))
    snap["graph_memory"], snap["graphs"] = memory, graphs
    return launches, snap


def graph_checks(eng, model, tag: str) -> dict:
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
        x = torch.from_numpy(rng.integers(0, 256, (b, IMAGE, IMAGE, 3),
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
    x8 = torch.from_numpy(rng.integers(0, 256, (8, IMAGE, IMAGE, 3),
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


def compare_plain(cfg, batches, seed: int, lr: float, plain_model=None):
    """3 steps from one initial state on ``batches``, through the kernels
    and through the plain versions (the plain loss, the plain optimizer
    and ``plain_model``, default ``cfg.model``), TF32 off: per-step loss
    and gradient norm of each arm, and the step times."""
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model_from_config
    from tpuic_torch.train.optimizer import make_optimizer, make_schedule
    from tpuic_torch.train.state import create_train_state
    from tpuic_torch.train.step import make_train_step
    arms = {}
    for arm, mcfg, fused in (("kernels", cfg.model, True),
                             ("plain", plain_model or cfg.model, False)):
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
        step = make_train_step(ocfg, cfg.model, lr_schedule=make_schedule(
            ocfg, 1, 1), device="cuda")
        metrics, times = [], []
        with no_tf32(), deterministic_cudnn():
            for batch in batches:
                t0 = time.perf_counter()
                state, mt = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(mt[k]) for k in ("loss",
                                                          "grad_norm",
                                                          "skipped")})
        arms[arm] = {"metrics": metrics, "step_ms": times}
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
    return {"model": trainer.mcfg.name, "image": IMAGE, "batch": batch,
            "dtype": "float32", "optimizer": trainer.state.tx.kind,
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

    def check(label, q, k, v, do, tol, sentinel=0.0, **mask):
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

    rows, main = [], {}
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
                if b == VIT_BATCH and dtype == torch.float32:
                    for name in K4:
                        fwd = name == "flash_attention_fwd"
                        main[name] = {
                            "max_abs_err": errs[name], "ms": ms[name],
                            "plain_ms": plain["fwd" if fwd else "bwd"],
                            "bound_ms": row["bound_ms"][name],
                            "bound_by": row["bound_by"][name],
                            "fp32_core_bound_ms": row["fp32_core_bound_ms"][
                                name],
                            "library_ms": sdpa["fwd"] if fwd else None}
                        if fwd:
                            main[name].update(
                                device_ms=fwd_device["kernel"],
                                library_device_ms=fwd_device["sdpa"],
                                over_library=row["fwd_over_sdpa_fwd"],
                                tf32_plain_max_abs_err=tf32_err[0])
                        else:
                            # No one PyTorch call computes dq alone or
                            # dk/dv alone: SDPA's backward (dq, dk and dv)
                            # stands beside the pair's sum.
                            main[name].update(
                                sdpa_bwd_ms=sdpa["bwd"],
                                sdpa_fwd_bwd_ms=sdpa["fwd_bwd"],
                                bwd_sum_ms=row["bwd_sum_ms"],
                                bwd_sum_over_sdpa_bwd=row[
                                    "bwd_sum_over_sdpa_bwd"])
                del q, k, v, do, o, lse, delta, qh, kh, vh, gh, qr, kr, vr
                del out
                free()
        q, k, v, do = inputs(4, 64)
        check("valid_len 50 of 64", q, k, v, do, F32_TOL, valid_len=50)
        check("valid 50 of 64 (device count)", q, k, v, do, F32_TOL,
              valid=torch.tensor([50], dtype=torch.int32, device="cuda"))
        none = torch.zeros(1, dtype=torch.int32, device="cuda")
        for sentinel in (0.0, FA.NEG_INF):
            _, (o, lse, _), _ = check(f"fully masked, sentinel {sentinel}",
                                      q, k, v, do, F32_TOL,
                                      sentinel=sentinel, valid=none)
            if not (bool((o == 0).all()) and bool((lse == sentinel).all())):
                fail("attn", f"fully masked rows: o max {o.abs().max()}, "
                             f"lse {lse.unique().tolist()[:4]}, expected 0 "
                             f"and {sentinel}")
    return main, rows


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


def vit_train_config(root: str, seed: int):
    """The repo's ViT-B/16 recipe (recipes/README.md, section 4) on one
    card, float32, through the flash kernels and the fused loss, without
    the regularisers the port does not have yet (mixup, CutMix, random
    erasing, drop-path, EMA)."""
    from tpuic_torch.config import (Config, DataConfig, ModelConfig,
                                    OptimConfig, RunConfig)
    return Config(
        data=DataConfig(data_dir=root, resize_size=IMAGE,
                        batch_size=VIT_BATCH, num_workers=8,
                        shuffle_seed=seed, native=False, pack=False),
        model=ModelConfig(name=VIT_MODEL, num_classes=1000, dtype="float32",
                          attention="flash"),
        optim=OptimConfig(optimizer="adam", learning_rate=VIT_LR,
                          weight_decay=0.05, warmup_epochs=10,
                          milestones=(), label_smoothing=0.1,
                          grad_clip_norm=1.0, class_weights=(),
                          fused_loss=True),
        run=RunConfig(epochs=300, max_steps=TRAIN_STEPS, log_every_steps=4,
                      seed=seed, ckpt_dir=os.path.join(root, "ckpt")))


def phase_vit_train(root: str, seed: int, smi: str):
    """ViT-B/16 training through ``Trainer`` and the 3-step comparison of
    the kernels with dense attention and the plain loss."""
    from tpuic_torch.train.loop import Trainer
    cfg = vit_train_config(root, seed)
    trainer = Trainer(cfg, log=lambda msg: log("vit-train", msg))
    reset_counts()
    trainer.fit()
    stats = dict(trainer.stats)
    trainer.val_epoch(0)
    counts = read_counts()
    steps = stats["steps"]
    val_forwards = len(trainer.val_loader)
    want = expect(flash_attention_fwd=VIT_LAYERS * (steps + val_forwards),
                  flash_attention_bwd_dq=VIT_LAYERS * steps,
                  flash_attention_bwd_dkv=VIT_LAYERS * steps,
                  cross_entropy_fwd=steps, cross_entropy_bwd=steps)
    if steps != TRAIN_STEPS or counts != want:
        fail("vit-train", f"{steps} steps, launches {counts}, expected "
                          f"{TRAIN_STEPS} steps and {want}")
    if not all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters()) or not all(
            math.isfinite(v) for v in trainer.last_val.values()):
        fail("vit-train", f"non-finite state after {steps} steps: val "
                          f"{trainer.last_val}")
    row = train_row(trainer, stats, counts, VIT_BATCH, smi)
    log("vit-train", json.dumps(row))
    batches = first_batches(trainer)
    del trainer
    free()
    row["compare"] = check_compare("vit-train", compare_plain(
        cfg, batches, seed, VIT_COMPARE_LR,
        plain_model=dataclasses.replace(cfg.model, attention="dense")))
    del batches
    free()
    return counts, row


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
    t0 = time.perf_counter()
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
        predicted = phase_predict(root, ckpt_dir, ckpt["best_val_accuracy"],
                                  ckpt.pop("best_top1"))
        attn, attn_rows = phase_attn(kind, gen)
        vit = phase_vit(gen, args.seed)
        # Under torch's default flags: the engine's forward turns TF32 off
        # for its call, and the ViT's patch embedding is one matmul, which
        # cuBLAS runs in float32 by default.
        _, vit_snap = phase_serve(vit, args.requests, args.seed, smi,
                                  tag="vit-serve",
                                  counter="flash_attention_fwd",
                                  per_call=VIT_LAYERS)
        del vit
        free()
        vit_counts, vit_train = phase_vit_train(root, args.seed, smi)
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
               f"tpuic/kernels/flash_attention.py:{line}", vit_counts[name])
              for name, line in zip(K4, (154, 346, 373)))):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n, **row,
                        "status": "ok"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kind": kind, "kernels": kernels,
                       "shapes": rows,
                       "serve": snap, "xent": xent_rows, "train": train,
                       "ckpt": ckpt, "serve_cli": serve_cli,
                       "predict": predicted,
                       "attn": attn_rows, "vit_serve": vit_snap,
                       "vit_train": vit_train},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
