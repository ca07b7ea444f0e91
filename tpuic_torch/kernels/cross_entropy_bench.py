"""K1 (the fused cross-entropy, ``csrc/cross_entropy.cu``) on the card:
the shipped forward and backward against design variants and the design
they replaced, timed on the card alone.

Forward designs:

- ``shipped``: :func:`cross_entropy.cross_entropy_fwd` as it is: a warp per
  row, four rows a block, one read of the row with an online max and sum
  in each lane (8 float4 or 8 scalar loads in flight), and the lanes
  merged by a max tree, one rescale and a sum tree.
- ``online_merge``: the lanes merged by one tree of online (max, sum)
  pairs, two expf a level.
- ``one_warp_blocks``: one row a block.
- ``unroll_4``: four float4 loads in flight a lane.
- ``scalars_32``: 32 scalar loads in flight a lane.

Backward designs (:data:`BWD_DESIGNS`), each reading a row up to C = 1024
once into registers:

- ``shipped``: :func:`cross_entropy.cross_entropy_bwd` as it is: a
  128-thread block per row, 2 float4 groups a thread, the max and the sum
  each through one shared-memory exchange across the four warps; a long
  row streams 2 groups a batch, so the kernel fits 32 registers and 16
  blocks an SM.
- ``team_warp``: a warp per row, four rows a block, 8 float4 groups a
  lane, shuffle trees only (8 groups a batch on a long row, 56
  registers).
- ``stream_8``: the shipped block with 8 groups a batch on a long row
  (56 registers, 9 blocks an SM).

``earlier``: the design before both, kept here as source text
(:data:`EARLIER_SRC`): a 128-thread block per row for both kernels, each
reading the row twice (the backward three times) through block
reductions.

Each variant but ``earlier`` is the shipped source with a few text
substitutions, built into its own library.  ``chip_smoke.py`` takes
:func:`build_earlier`, :func:`fwd_with`, :func:`bwd_with`,
:func:`train_inputs`, :func:`fwd_bytes` and :func:`bwd_bytes` from here;
nothing on the port's paths imports this module.

Usage (needs an NVIDIA GPU and ``nvcc``)::

    python -m tpuic_torch.kernels.cross_entropy_bench [--seed 0]

prints, at [128, 1000] and [128, 7] with smoothing 0 and 0.1 and at
[8192, 1000] with smoothing 0.1, each forward's and each backward's max
abs error against the plain version and the device milliseconds per call
(``optimizer_update_bench.device_time``: a CUDA graph of 100 calls
replayed 5 times) of every forward and backward design (each twice, in
turns) and one ``F.cross_entropy`` forward, beside the bytes bounds at
3.35 TB/s and each shipped kernel's share of its bound.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (B, C, label smoothing): the train path's shapes, then a large batch.
SHAPES = ((128, 1000, 0.0), (128, 1000, 0.1), (128, 7, 0.0), (128, 7, 0.1),
          (8192, 1000, 0.1))
#: HBM bandwidth of the H100 SXM (NVIDIA's data sheet), bytes a second.
HBM = 3.35e12

_MERGE = """  float m = st.m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = st.m == m ? st.s : st.s * expf(st.m - m);  // a lane that saw
  float sx = st.sx;                                   // nothing adds 0
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
"""
_ONLINE_MERGE = """#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, st.m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, st.s, o);
    const float sx2 = __shfl_xor_sync(0xffffffffu, st.sx, o);
    const float mm = fmaxf(st.m, m2);
    st.s = st.s * (st.m == mm ? 1.f : expf(st.m - mm)) +
           s2 * (m2 == mm ? 1.f : expf(m2 - mm));
    st.m = mm;
    st.sx += sx2;
  }
  const float m = st.m, s = st.s, sx = st.sx;
"""

# name -> [(old, new), ...] on the shipped source: each old occurs once.
VARIANTS = {
    "shipped": [],
    "online_merge": [(_MERGE, _ONLINE_MERGE)],
    "one_warp_blocks": [("constexpr int FWD_WARPS = 4;",
                         "constexpr int FWD_WARPS = 1;")],
    "unroll_4": [("constexpr int FWD_UNROLL = 8;",
                  "constexpr int FWD_UNROLL = 4;")],
    "scalars_32": [("constexpr int FWD_SCALARS = 8;",
                    "constexpr int FWD_SCALARS = 32;")],
    "team_warp": [("constexpr int BWD_TEAM = THREADS; ",
                   "constexpr int BWD_TEAM = 32; "),
                  ("constexpr int BWD_STREAM = 2;",
                   "constexpr int BWD_STREAM = 8;"),
                  ("__launch_bounds__(THREADS, BWD_MIN_BLOCKS)\nxent_bwd",
                   "__launch_bounds__(THREADS)\nxent_bwd")],
    "stream_8": [("constexpr int BWD_STREAM = 2;",
                  "constexpr int BWD_STREAM = 8;"),
                 ("__launch_bounds__(THREADS, BWD_MIN_BLOCKS)\nxent_bwd",
                  "__launch_bounds__(THREADS)\nxent_bwd")],
}
#: The backward designs timed against each other: library names of
#: :data:`VARIANTS`, and ``earlier``.
BWD_DESIGNS = ("shipped", "team_warp", "stream_8", "earlier")
#: The forward designs (the backward-only variants build the shipped
#: forward).
FWD_DESIGNS = ("shipped", "online_merge", "one_warp_blocks", "unroll_4",
               "scalars_32", "earlier")

EARLIER_SRC = r'''
// K1's earlier design: a 128-thread block per row for both kernels; the
// forward reads the row twice (max, then sum of exp and of x) through up to
// three block reductions, and one thread finishes the row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = MAX ? fmaxf(r, scratch[i]) : r + scratch[i];
  __syncthreads();  // scratch is reused by the next reduction
  return r;
}

// Row statistics shared by both kernels: the max m and sum(exp(x - m)),
// and sum(x) when smoothing.
struct RowStats {
  float m, s, sx;
};

__device__ RowStats row_stats(const float* row, int C, bool smooth,
                              float* scratch) {
  float m = -INFINITY;
  for (int j = threadIdx.x; j < C; j += THREADS) m = fmaxf(m, row[j]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f, sx = 0.f;
  for (int j = threadIdx.x; j < C; j += THREADS) {
    const float v = row[j];
    s += expf(v - m);
    sx += v;
  }
  s = block_reduce<false>(s, scratch);
  if (smooth) sx = block_reduce<false>(sx, scratch);
  return {m, s, sx};
}

__global__ void __launch_bounds__(THREADS)
xent_fwd_kernel(const float* __restrict__ x, const int* __restrict__ y,
                const float* __restrict__ cw, const float* __restrict__ mask,
                float* __restrict__ wnll, float* __restrict__ w_out, int C,
                float ls) {
  __shared__ float scratch[WARPS];
  const int b = blockIdx.x;
  const float* row = x + (long long)b * C;
  const bool smooth = ls > 0.f;
  const RowStats st = row_stats(row, C, smooth, scratch);
  if (threadIdx.x != 0) return;
  const float lse = st.m + logf(st.s);
  const int label = y[b];
  const bool valid = label >= 0 && label < C;
  const float w = valid ? cw[label] * mask[b] : 0.f;
  float nll = valid ? -(1.f - ls) * (row[label] - lse) : 0.f;
  if (smooth) nll -= ls * (st.sx / (float)C - lse);
  wnll[b] = w * nll;
  w_out[b] = w;
}

__global__ void __launch_bounds__(THREADS)
xent_bwd_kernel(const float* __restrict__ x, const int* __restrict__ y,
                const float* __restrict__ cw, const float* __restrict__ mask,
                const float* __restrict__ scale, float* __restrict__ dx, int C,
                float ls) {
  __shared__ float scratch[WARPS];
  const int b = blockIdx.x;
  const float* row = x + (long long)b * C;
  float* drow = dx + (long long)b * C;
  const RowStats st = row_stats(row, C, false, scratch);
  const int label = y[b];
  const bool valid = label >= 0 && label < C;
  const float ws = (valid ? cw[label] * mask[b] : 0.f) * scale[0];
  const float off = ls > 0.f ? ls / (float)C : 0.f;
  const float on = ls > 0.f ? (1.f - ls) : 1.f;
  for (int j = threadIdx.x; j < C; j += THREADS) {
    const float p = expf(row[j] - st.m) / st.s;
    const float target = (j == label ? on : 0.f) + off;
    drow[j] = (p - target) * ws;
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 when it was accepted).
// They allocate nothing and do not synchronise: the caller owns every buffer
// and the stream.
extern "C" int tpuic_xent_fwd(const void* x, const void* y, const void* cw,
                              const void* mask, void* wnll, void* w, int B,
                              int C, float ls, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  xent_fwd_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(y),
      static_cast<const float*>(cw), static_cast<const float*>(mask),
      static_cast<float*>(wnll), static_cast<float*>(w), C, ls);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpuic_xent_bwd(const void* x, const void* y, const void* cw,
                              const void* mask, const void* scale, void* dx,
                              int B, int C, float ls, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  xent_bwd_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(y),
      static_cast<const float*>(cw), static_cast<const float*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(dx), C, ls);
  return static_cast<int>(cudaGetLastError());
}
'''


def build_earlier():
    """The earlier design (:data:`EARLIER_SRC`), built with the port's
    flags and bound like the shipped library."""
    from tpuic_torch.kernels import cross_entropy as K1
    from tpuic_torch.kernels.optimizer_update_bench import build_source
    return K1.bind(build_source("xent_earlier", EARLIER_SRC)())


def build_variants(names) -> dict:
    """``{name: library}``: each of :data:`VARIANTS` named, one ``nvcc``
    each, all started together."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels import cross_entropy as K1
    from tpuic_torch.kernels.conv_bn_relu_bench import variant_source
    from tpuic_torch.kernels.optimizer_update_bench import build_source
    src = (_build.CSRC / "cross_entropy.cu").read_text()
    waits = {n: build_source(f"k1_{n}", variant_source(src, VARIANTS[n]))
             for n in names}
    return {n: K1.bind(w()) for n, w in waits.items()}


def ptxas_summary(names) -> dict:
    """``{design: ptxas's entry, registers and spills lines}`` from
    the logs :func:`build_variants` and :func:`build_earlier` kept."""
    from tpuic_torch.kernels import _build
    out = {}
    for n in names:
        stem = "xent_earlier" if n == "earlier" else f"k1_{n}"
        log = _build.BUILD_DIR / "variants" / f"lib{stem}.log"
        lines = log.read_text().splitlines() if log.is_file() else []
        out[n] = [ln.split("ptxas info    :")[-1].strip() for ln in lines
                  if any(k in ln for k in ("entry function", "registers",
                                           "spill"))]
    return out


def _call(fn, name, logits, args) -> None:
    import torch
    with torch.cuda.device(logits.device):
        rc = fn(*args, torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def fwd_with(lib, logits, labels, cw, mask, label_smoothing: float):
    """Per-row ``(w * nll, w)`` through the forward of the build ``lib``,
    like :func:`cross_entropy.cross_entropy_fwd` (its launch counter
    untouched)."""
    import torch
    b, c = logits.shape
    wnll = torch.empty(b, dtype=torch.float32, device=logits.device)
    w = torch.empty(b, dtype=torch.float32, device=logits.device)
    _call(lib.tpuic_xent_fwd, "cross_entropy_fwd", logits,
          (logits.data_ptr(), labels.data_ptr(), cw.data_ptr(),
           mask.data_ptr(), wnll.data_ptr(), w.data_ptr(), b, c,
           float(label_smoothing)))
    return wnll, w


def bwd_with(lib, logits, labels, cw, mask, scale, label_smoothing: float):
    """``d loss / d logits`` through the backward of the build ``lib``."""
    import torch
    b, c = logits.shape
    dx = torch.empty_like(logits)
    _call(lib.tpuic_xent_bwd, "cross_entropy_bwd", logits,
          (logits.data_ptr(), labels.data_ptr(), cw.data_ptr(),
           mask.data_ptr(), scale.data_ptr(), dx.data_ptr(), b, c,
           float(label_smoothing)))
    return dx


def train_inputs(b: int, c: int, gen):
    """The train path's inputs at [b, c]: logits 3 * N(0, 1) from the CPU
    generator ``gen``, labels in [0, c), no class weights, nothing
    masked; ``scale`` is the step's 1 / b."""
    import torch
    x = (3.0 * torch.randn((b, c), generator=gen)).cuda()
    y = torch.randint(0, c, (b,), generator=gen, dtype=torch.int32).cuda()
    return (x, y, torch.ones(c, device="cuda"), torch.ones(b, device="cuda"),
            torch.tensor(1.0 / b, device="cuda"))


def fwd_bytes(b: int, c: int) -> int:
    """What the forward must move: logits, labels, class weights and mask
    read once, two per-row outputs written once."""
    return 4 * (b * c + b + c + b + 2 * b)


def bwd_bytes(b: int, c: int) -> int:
    """What the backward must move: logits, labels, class weights, mask and
    scale read once, dx written once."""
    return 4 * (2 * b * c + 2 * b + c + 1)


def in_turns(names, fn) -> dict:
    """``{name: [ms, ms]}``: ``fn(name)`` timed for every name, then again
    in the reverse order."""
    ms = {n: [] for n in names}
    for name in [*names, *reversed(names)]:
        ms[name].append(fn(name))
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpuic_torch.kernels import cross_entropy as K1
    from tpuic_torch.kernels.optimizer_update_bench import device_time
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = build_variants(VARIANTS)
    libs["earlier"] = build_earlier()
    print(json.dumps(ptxas_summary(BWD_DESIGNS)), flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    for b, c, ls in SHAPES:
        x, y, cw, mask, scale = train_inputs(b, c, gen)
        fwd = (x, y, cw, mask)
        want = K1.cross_entropy_fwd_plain(*fwd, ls)
        want_dx = K1.cross_entropy_bwd_plain(*fwd, scale, ls)
        errs = {n: max(float((g - w).abs().max()) for g, w in zip(
            fwd_with(libs[n], *fwd, ls), want)) for n in FWD_DESIGNS}
        bwd_errs = {n: float((bwd_with(libs[n], *fwd, scale, ls)
                              - want_dx).abs().max()) for n in BWD_DESIGNS}
        yl = y.long()
        kw = dict(label_smoothing=ls) if ls else dict(weight=cw)
        fwd_ms = in_turns(FWD_DESIGNS, lambda n: device_time(
            lambda: fwd_with(libs[n], *fwd, ls))["median"])
        bwd_ms = in_turns(BWD_DESIGNS, lambda n: device_time(
            lambda: bwd_with(libs[n], *fwd, scale, ls))["median"])
        row = {"b": b, "c": c, "label_smoothing": ls, "max_abs_err": errs,
               "bwd_max_abs_err": bwd_errs, "fwd_device_ms": fwd_ms,
               "bwd_device_ms": bwd_ms,
               "library_fwd_device_ms": device_time(
                   lambda: F.cross_entropy(x, yl, reduction="sum",
                                           **kw))["median"],
               "fwd_bound_ms": fwd_bytes(b, c) / HBM * 1e3,
               "bwd_bound_ms": bwd_bytes(b, c) / HBM * 1e3}
        best = {n: min(v) for n, v in fwd_ms.items()}
        bwd_best = {n: min(v) for n, v in bwd_ms.items()}
        row["shipped_share_of_bound"] = row["fwd_bound_ms"] / best["shipped"]
        row["over_earlier"] = {n: best[n] / best["earlier"]
                               for n in FWD_DESIGNS}
        row["bwd_share_of_bound"] = {n: row["bwd_bound_ms"] / v
                                     for n, v in bwd_best.items()}
        row["bwd_over_earlier"] = {n: v / bwd_best["earlier"]
                                   for n, v in bwd_best.items()}
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
