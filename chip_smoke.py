"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--requests N] [--seed S] [--out smoke.json]

Drives ``tpuic_torch``'s serving path on the card and exits non-zero at
the first phase that fails:

1. device — ``nvidia-smi`` name and power limit, torch/CUDA versions.
   Refuses to run without CUDA.
2. build  — every kernel source in ``tpuic_torch/kernels/csrc`` compiled
   by ``nvcc`` (one process per source, started together).
3. kernel — the fused conv+BN+ReLU kernel at every distinct conv shape a
   ResNet-50 forward at 224x224 launches, plus the space-to-depth stem,
   at batch 8: held against its plain PyTorch version (float32, TF32 off,
   atol/rtol 1e-4; one bfloat16 shape at atol/rtol 1e-2, two bf16 ulps of
   the output), and timed beside the plain version, one cuDNN call that
   computes the same function (timed only — the port never calls it) and
   the bound (FLOPs over the card's float32 non-tensor peak, or bytes over
   its HBM bandwidth, whichever is larger).
4. model  — ``create_model("resnet50", 1000, dtype="float32",
   fused_conv_bn=True)`` with seeded synthetic weights: its logits at
   batch 4 against the same weights through the unfused cuDNN branch (TF32
   off, atol/rtol 1e-3: float32 sums in another order through 53 layers),
   and exactly 53 kernel launches per forward.
5. serve  — ``InferenceEngine`` (uint8 in, normalized in the forward,
   buckets 1/8/32) answering a few hundred requests of 1-8 images from
   eight closed-loop client threads: every future resolves with the right
   shape, a sample matches a direct forward (1e-5), and the kernel
   launches 53 times per device call during the run.

The second-to-last lines are the per-kernel JSON summary and the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 8
IMAGE = 224
F32_TOL = 1e-4
BF16_TOL = 1e-2
MODEL_TOL = 1e-3
SERVE_TOL = 1e-5

# Published dense peaks by card variant (NVIDIA data sheets): float32
# outside the tensor cores, and HBM bandwidth.  The name nvidia-smi reports
# picks the row; "H100 80GB HBM3" is the SXM part.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H200", 67.0e12, 4.8e12), ("H100", 67.0e12, 3.35e12))


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


def resnet50_launches(batch: int, size: int = IMAGE):
    """``(x shape, w shape, strides, padding, relu)`` of every kernel launch
    of one fused ResNet-50 forward, in order: the stem, then per bottleneck
    conv1 (1x1), conv2 (3x3, the stride), conv3 (1x1) and the downsample
    conv of each stage's first block."""
    h = size
    out = [((batch, h, h, 3), (7, 7, 3, 64), 2, 3, True)]
    h = (h + 6 - 7) // 2 + 1          # stem conv
    h = (h + 2 - 3) // 2 + 1          # maxpool
    cin = 64
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for i in range(n_blocks):
            s = 2 if stage > 0 and i == 0 else 1
            ho = (h + 2 - 3) // s + 1
            out += [((batch, h, h, cin), (1, 1, cin, f), 1, 0, True),
                    ((batch, h, h, f), (3, 3, f, f), s, 1, True),
                    ((batch, ho, ho, f), (1, 1, f, 4 * f), 1, 0, False)]
            if s != 1 or cin != 4 * f:
                out.append(((batch, h, h, cin), (1, 1, cin, 4 * f), s, 0,
                            False))
            cin, h = 4 * f, ho
    return out


def s2d_stem_launch(batch: int, size: int = IMAGE):
    return ((batch, size // 2, size // 2, 12), (4, 4, 12, 64), 1,
            ((2, 1), (2, 1)), True)


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


def phase_kernel(device_name: str, gen: torch.Generator):
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.kernels.conv_bn_relu import (fused_conv_bn_relu,
                                                  fused_conv_bn_relu_plain)
    _, peak_flops, hbm = peaks(device_name)
    launches = resnet50_launches(BATCH)
    counts = {}
    for spec in launches:
        counts[spec] = counts.get(spec, 0) + 1
    shapes = list(counts.items()) + [(s2d_stem_launch(BATCH), 0)]
    log("kernel", f"{len(counts)} distinct ResNet-50 conv shapes "
                  f"({len(launches)} launches per forward) + the s2d stem, "
                  f"batch {BATCH}")
    rows, max_err = [], 0.0
    for (xs, ws, stride, padding, relu), per_fwd in shapes:
        k_red = ws[0] * ws[1] * ws[2]
        x = torch.randn(xs, generator=gen).cuda()
        w = (torch.randn(ws, generator=gen) / math.sqrt(k_red)).cuda()
        scale = (1.0 + 0.1 * torch.randn(ws[3], generator=gen)).cuda()
        bias = (0.1 * torch.randn(ws[3], generator=gen)).cuda()

        def kernel():
            return fused_conv_bn_relu(x, w, scale, bias, strides=stride,
                                      padding=padding, relu=relu)

        def plain():
            return fused_conv_bn_relu_plain(x, w, scale, bias, stride,
                                            padding, relu)

        w_folded = (w * scale).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return library_call(x, w_folded, bias, stride, padding, relu)

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL):
            fail("kernel", f"x {xs} w {ws} s{stride} p{padding}: max abs "
                           f"err {err} beyond atol/rtol {F32_TOL}")
        with no_tf32():
            lib = library().permute(0, 2, 3, 1)
            lib_err = float((lib[:, :want.shape[1], :want.shape[2]]
                             - want).abs().max())
            ms_lib = time_ms(library)
        ms_kernel = time_ms(kernel)
        ms_plain = time_ms(plain)
        flops, nbytes = work(xs, ws, stride, padding)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / hbm * 1e3
        row = {"x": list(xs), "w": list(ws), "stride": stride,
               "padding": padding, "relu": relu, "per_forward": per_fwd,
               "max_abs_err": err, "library_max_abs_err": lib_err,
               "ms": ms_kernel, "plain_ms": ms_plain, "library_ms": ms_lib,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes}
        row["share_of_bound"] = row["bound_ms"] / ms_kernel
        rows.append(row)
        max_err = max(max_err, err)
        log("kernel", json.dumps(row))
    # One bfloat16 shape: the same bf16-rounded inputs on both sides.
    xs, ws = (BATCH, 56, 56, 64), (3, 3, 64, 64)
    xb = torch.randn(xs, generator=gen).cuda().to(torch.bfloat16)
    w = (torch.randn(ws, generator=gen) / math.sqrt(9 * 64)).cuda()
    one, zero = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    got = fused_conv_bn_relu(xb, w, one, zero, padding=1).float()
    want = fused_conv_bn_relu_plain(xb, w, one, zero, 1, 1, True).float()
    bf16_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL):
        fail("kernel", f"bf16 x {xs}: max abs err {bf16_err} beyond "
                       f"atol/rtol {BF16_TOL}")
    log("kernel", f"bf16 x {xs} w {ws}: max abs err {bf16_err} "
                  f"(atol/rtol {BF16_TOL})")
    fwd = [r for r in rows if r["per_forward"]]
    summary = {
        "name": "conv_bn_relu", "route": "cuda",
        "source": "tpuic_torch/kernels/csrc/conv_bn_relu.cu",
        "replaces": "tpuic/kernels/conv_bn_relu.py:76",
        "max_abs_err": max_err,
        # Per ResNet-50 forward at batch 8: each shape's time times its
        # launches per forward, summed.
        **{k: sum(r[k] * r["per_forward"] for r in fwd)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
    }
    ops = sum(r["flops"] * r["per_forward"] for r in fwd) / peak_flops
    byt = sum(r["bytes"] * r["per_forward"] for r in fwd) / hbm
    summary["bound_by"] = "operations" if ops >= byt else "bytes"
    log("kernel", "kernels " + json.dumps(
        [{"name": "conv_bn_relu", "max_abs_err": max_err,
          "bf16_max_abs_err": bf16_err, "status": "ok"}]))
    return summary, rows, bf16_err


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
    log("model", json.dumps({
        "model": "resnet50", "classes": 1000, "image": IMAGE, "batch": 4,
        "dtype": "float32", "launches_per_forward": per_forward,
        "max_abs_err_vs_unfused": err, "logit_abs_max":
        float(ref.abs().max()), "top1_agree": top1,
        "fused_forward_ms": fused_ms, "unfused_cudnn_forward_ms":
        unfused_ms}))
    return model


def phase_serve(model, n_requests: int, seed: int, smi: str):
    from tpuic_torch.kernels import fused_conv_bn_relu
    from tpuic_torch.serve import InferenceEngine, make_forward
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    eng = InferenceEngine(model, None, image_size=IMAGE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32))
    warm = eng.warmup()
    log("serve", f"warmup (s per bucket): {json.dumps(warm)}")
    eng.stats.reset()
    fused_conv_bn_relu.launches = 0
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
    launches = fused_conv_bn_relu.launches
    eng.close()
    snap = eng.stats.snapshot()
    if errors or any(t.is_alive() for t in threads):
        fail("serve", f"client errors: {errors[:3]}")
    for lo, n, (probs, order) in results:
        if probs.shape != (n, 1000) or order.shape != (n, 1000) \
                or not np.isfinite(probs).all():
            fail("serve", f"request of {n}: probs {probs.shape}, order "
                          f"{order.shape}")
    direct = make_forward(model, normalize=True)
    worst = 0.0
    for lo, n, (probs, order) in results[::max(1, len(results) // 12)]:
        want_p, want_o = direct(torch.from_numpy(pool[lo:lo + n]).cuda())
        worst = max(worst, float(np.abs(probs - want_p.cpu().numpy()).max()))
        if not np.array_equal(order[:, 0], want_o[:, 0].cpu().numpy()):
            fail("serve", f"top-1 differs from a direct forward at {lo}:{n}")
    if worst > SERVE_TOL:
        fail("serve", f"probs differ from a direct forward by {worst} > "
                      f"{SERVE_TOL}")
    per_call = len(resnet50_launches(1))
    if launches == 0 or launches != per_call * snap["device_calls"]:
        fail("serve", f"{launches} kernel launches for "
                      f"{snap['device_calls']} device calls")
    log("serve", json.dumps({
        "requests": len(results), "images": snap["images"],
        "wall_s": wall, "device_calls": snap["device_calls"],
        "kernel_launches": launches, "latency_ms": snap["latency_ms"],
        "throughput_images_per_sec": snap["throughput_images_per_sec"],
        "images_per_s_wall": snap["images"] / wall,
        "pad_efficiency": snap["pad_efficiency"],
        "batch_hist": snap["batch_hist"], "span_ms": snap["span_ms"],
        "max_abs_err_vs_direct": worst, "card": smi}))
    return launches, snap


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
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    gen = torch.Generator().manual_seed(args.seed)
    summary, rows, bf16_err = phase_kernel(kind, gen)
    model = phase_model(gen)
    launches, snap = phase_serve(model, args.requests, args.seed, smi)
    summary["launches"] = launches
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kind": kind, "kernel": summary,
                       "shapes": rows, "bf16_max_abs_err": bf16_err,
                       "serve": snap}, f, indent=1)
    print(json.dumps({"kernels": [summary]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
