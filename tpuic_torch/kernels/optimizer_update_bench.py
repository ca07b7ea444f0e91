"""K2 (the LARS and LAMB updates, ``csrc/optimizer_update.cu``) on the
card: the shipped kernels against design variants and the designs they
replaced, timed on the card alone.

``chip_smoke.py`` takes :func:`device_time`, :func:`build_earlier`,
:func:`block_lars_update` and :func:`block_lamb_update` from here, and
``cross_entropy_bench`` :func:`device_time` and :func:`build_source`;
nothing on the port's paths imports this module.  Each variant but the
earlier designs is the shipped source with a few text substitutions;
every one is built into its own library under ``tpuic_torch/_build/
variants/``.

- ``shipped``: :func:`optimizer_update.lars_update` and
  :func:`optimizer_update.lamb_update` as they are: a warp per
  4,096-element chunk, 16-byte loads with four of each tensor in flight a
  lane, LAMB's debias factors computed on the card.
- ``unroll_1``: one load of each tensor in flight a lane.
- ``block``: K2a's design before it, kept here as source text
  (:data:`BLOCK_SRC`): a 256-thread block per 16,384-element chunk, one
  scalar load a thread at a time, a thread per leaf summing the partials.
- ``lamb_block``: K2b's design before it, as source text
  (:data:`LAMB_BLOCK_SRC`): the same block per chunk and scalar loads,
  with the debias factors computed by torch ops on every call.

Usage (needs an NVIDIA GPU and ``nvcc``)::

    python -m tpuic_torch.kernels.optimizer_update_bench [--seed 0]

prints, over the ResNet-50 + head parameter list (167 leaves), each
design's max abs error against the plain version and its device
milliseconds per update (:func:`device_time`), each design twice, in
turns, for LARS and for LAMB.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

# name -> [(old, new), ...] on the shipped source: each old occurs once.
VARIANTS = {
    "shipped": [],
    "unroll_1": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 1;")],
}

BLOCK_CHUNK = 16384

BLOCK_SRC = r'''
// K2a's earlier design: a 256-thread block per chunk, scalar loads.
#include <cuda_runtime.h>
#include <math.h>

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LEAF_FIELDS = 7;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ void block_sum2(float a, float b, float* out) {
  __shared__ float sa[WARPS], sb[WARPS];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ra = 0.f, rb = 0.f;
    for (int i = 0; i < WARPS; ++i) {
      ra += sa[i];
      rb += sb[i];
    }
    out[0] = ra;
    out[1] = rb;
  }
}

struct Span {
  float *g, *w, *m;
  long long lo, hi;
};

__device__ __forceinline__ Span span(const long long* leaves,
                                     const int* chunks, int chunk_size) {
  const long long* r = leaves + (long long)chunks[2 * blockIdx.x] * LEAF_FIELDS;
  const long long lo = chunks[2 * blockIdx.x + 1];
  const long long hi = lo + chunk_size < r[4] ? lo + chunk_size : r[4];
  return {reinterpret_cast<float*>(r[0]), reinterpret_cast<float*>(r[1]),
          reinterpret_cast<float*>(r[2]), lo, hi};
}

__global__ void __launch_bounds__(THREADS)
lars_norms(const long long* leaves, const int* chunks, int chunk_size,
           float wd, float* partials) {
  const Span s = span(leaves, chunks, chunk_size);
  float sw = 0.f, su = 0.f;
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += THREADS) {
    const float w = s.w[i];
    const float u = s.g[i] + wd * w;
    sw += w * w;
    su += u * u;
  }
  block_sum2(sw, su, partials + 2 * (long long)blockIdx.x);
}

__global__ void __launch_bounds__(THREADS)
lars_apply(const long long* leaves, const int* chunks, int chunk_size,
           float wd, float mu, const float* a, const bool* finite) {
  if (!finite[0]) return;
  const Span s = span(leaves, chunks, chunk_size);
  const float al = a[chunks[2 * blockIdx.x]];
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += THREADS) {
    const float w = s.w[i];
    const float upd = al * (s.g[i] + wd * w) + mu * s.m[i];
    s.m[i] = upd;
    s.w[i] = w + upd;
  }
}

__global__ void trust_ratio(const long long* leaves, int n_leaves,
                            const float* partials, float coeff,
                            const float* scal, float* a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n_leaves) return;
  const long long* r = leaves + (long long)l * LEAF_FIELDS;
  double sw = 0.0, su = 0.0;
  for (long long c = r[5]; c < r[5] + r[6]; ++c) {
    sw += partials[2 * c];
    su += partials[2 * c + 1];
  }
  const float pn = sqrtf((float)sw), un = sqrtf((float)su);
  a[l] = -scal[0] * ((pn == 0.f || un == 0.f) ? 1.f : coeff * pn / un);
}
}  // namespace

extern "C" int tpuic_lars_update(const void* leaves, const void* chunks,
                                 int n_leaves, int n_chunks, int chunk_size,
                                 const void* scal, const void* finite,
                                 void* partials, void* a, float wd, float tc,
                                 float mu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  const int* ch = static_cast<const int*>(chunks);
  lars_norms<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, wd,
                                           static_cast<float*>(partials));
  trust_ratio<<<(n_leaves + 127) / 128, 128, 0, st>>>(
      lv, n_leaves, static_cast<const float*>(partials), tc,
      static_cast<const float*>(scal), static_cast<float*>(a));
  lars_apply<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, wd, mu,
                                           static_cast<const float*>(a),
                                           static_cast<const bool*>(finite));
  return static_cast<int>(cudaGetLastError());
}
'''

LAMB_BLOCK_SRC = r'''
// K2b's earlier design: a 256-thread block per chunk, scalar loads, the
// debias factors c1, c2 read from scal[1], scal[2].
#include <cuda_runtime.h>
#include <math.h>

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LEAF_FIELDS = 7;

struct LeafRef {
  float *g, *w, *m, *v;
  long long n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ void block_sum2(float a, float b, float* out) {
  __shared__ float sa[WARPS], sb[WARPS];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ra = 0.f, rb = 0.f;
    for (int i = 0; i < WARPS; ++i) {
      ra += sa[i];
      rb += sb[i];
    }
    out[0] = ra;
    out[1] = rb;
  }
}

struct Chunk {
  LeafRef r;
  long long lo;
  int leaf, n;
};

__device__ __forceinline__ Chunk chunk_at(const long long* leaves,
                                          const int* chunks, int c,
                                          int chunk_size) {
  const int l = chunks[2 * c];
  const long long lo = chunks[2 * c + 1];
  const long long* q = leaves + (long long)l * LEAF_FIELDS;
  const LeafRef r{reinterpret_cast<float*>(q[0]), reinterpret_cast<float*>(q[1]),
                  reinterpret_cast<float*>(q[2]), reinterpret_cast<float*>(q[3]),
                  q[4]};
  const long long n = r.n - lo < chunk_size ? r.n - lo : chunk_size;
  return {r, lo, l, static_cast<int>(n)};
}

struct LambHyper {
  float b1, b2, omb1, omb2, eps, wd;
};

__global__ void __launch_bounds__(THREADS)
lamb_norms(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int chunk_size, LambHyper h, const float* __restrict__ scal,
           const bool* __restrict__ finite, float* __restrict__ partials) {
  const Chunk s = chunk_at(leaves, chunks, blockIdx.x, chunk_size);
  const float c1 = scal[1], c2 = scal[2];
  const bool write = finite[0];
  float sw = 0.f, su = 0.f;
  for (long long i = s.lo + threadIdx.x; i < s.lo + s.n; i += THREADS) {
    const float g = s.r.g[i];
    const float w = s.r.w[i];
    const float m = h.b1 * s.r.m[i] + h.omb1 * g;
    const float v = h.b2 * s.r.v[i] + h.omb2 * g * g;
    const float u = (m * c1) / (sqrtf(v * c2) + h.eps) + h.wd * w;
    if (write) {
      s.r.m[i] = m;
      s.r.v[i] = v;
    }
    sw += w * w;
    su += u * u;
  }
  block_sum2(sw, su, partials + 2 * (long long)blockIdx.x);
}

__global__ void __launch_bounds__(THREADS)
lamb_apply(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int chunk_size, LambHyper h, const float* __restrict__ scal,
           const float* __restrict__ a, const bool* __restrict__ finite) {
  if (!finite[0]) return;
  const Chunk s = chunk_at(leaves, chunks, blockIdx.x, chunk_size);
  const float c1 = scal[1], c2 = scal[2];
  const float al = a[s.leaf];
  for (long long i = s.lo + threadIdx.x; i < s.lo + s.n; i += THREADS) {
    const float w = s.r.w[i];
    const float u = (s.r.m[i] * c1) / (sqrtf(s.r.v[i] * c2) + h.eps) + h.wd * w;
    s.r.w[i] = w + al * u;
  }
}

__global__ void __launch_bounds__(THREADS)
trust_ratio(const long long* __restrict__ leaves, int n_leaves,
            const float* __restrict__ partials, float coeff,
            const float* __restrict__ scal, float* __restrict__ a) {
  const int l = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (l >= n_leaves) return;
  const int lane = threadIdx.x & 31;
  const long long* r = leaves + (long long)l * LEAF_FIELDS;
  const long long c0 = r[5], nc = r[6];
  double sw = 0.0, su = 0.0;
  for (long long c = c0 + lane; c < c0 + nc; c += 32) {
    sw += partials[2 * c];
    su += partials[2 * c + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sw += __shfl_xor_sync(0xffffffffu, sw, o);
    su += __shfl_xor_sync(0xffffffffu, su, o);
  }
  if (lane != 0) return;
  const float pn = sqrtf((float)sw);
  const float un = sqrtf((float)su);
  const float trust = (pn == 0.f || un == 0.f) ? 1.f : coeff * pn / un;
  a[l] = -scal[0] * trust;
}
}  // namespace

extern "C" int tpuic_lamb_update(const void* leaves, const void* chunks,
                                 int n_leaves, int n_chunks, int chunk_size,
                                 const void* scal, const void* finite,
                                 void* partials, void* a, float b1, float b2,
                                 float omb1, float omb2, float eps, float wd,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  const int* ch = static_cast<const int*>(chunks);
  const LambHyper h{b1, b2, omb1, omb2, eps, wd};
  const float* sc = static_cast<const float*>(scal);
  const bool* fin = static_cast<const bool*>(finite);
  lamb_norms<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, h, sc, fin,
                                           static_cast<float*>(partials));
  trust_ratio<<<(n_leaves + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      lv, n_leaves, static_cast<const float*>(partials), 1.f, sc,
      static_cast<float*>(a));
  lamb_apply<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, h, sc,
                                           static_cast<const float*>(a), fin);
  return static_cast<int>(cudaGetLastError());
}
'''


def device_time(fn, iters: int = 100, repeats: int = 5,
                warmup: int = 3) -> dict:
    """Device milliseconds per call of ``fn``: ``iters`` back-to-back calls
    captured once in a CUDA graph, the graph replayed ``repeats`` times,
    each replay between two CUDA events.  The card runs the calls back to
    back with nothing of the host between them (the wrappers' Python
    checks take longer than the update itself, and LAMB's enqueue more
    launches than the launch queue holds).  Returns the median, min, max
    and spread ((max - min) / median) of the repeats, and each repeat."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    del graph
    med = statistics.median(runs)
    return {"median": med, "min": min(runs), "max": max(runs),
            "spread": (max(runs) - min(runs)) / med, "repeats": runs,
            "iters": iters}


def build_source(stem: str, src: str):
    """Start ``nvcc`` on ``src`` with the port's flags, into
    ``variants/lib<stem>.so``; returns a function that waits for it and
    loads the library (raising with the compiler's output if it failed).
    The compiler's output is kept beside it as ``lib<stem>.log``."""
    from tpuic_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{stem}.cu"
    cu.write_text(src)
    so = out_dir / f"lib{stem}.so"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def wait() -> ctypes.CDLL:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}:\n{text}")
        so.with_suffix(".log").write_text(text)
        return ctypes.CDLL(str(so))
    return wait


def _bind_lamb_block(lib) -> ctypes.CDLL:
    fn = lib.tpuic_lamb_update
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build_earlier() -> dict:
    """``{"lars": library, "lamb": library}``: the earlier designs
    (:data:`BLOCK_SRC`, :data:`LAMB_BLOCK_SRC`), both built together with
    the port's flags."""
    from tpuic_torch.kernels import optimizer_update as K2
    lars = build_source("lars_block", BLOCK_SRC)
    lamb = build_source("lamb_block", LAMB_BLOCK_SRC)
    return {"lars": K2.bind(lars(), ("lars",)),
            "lamb": _bind_lamb_block(lamb())}


def build_variants(names) -> dict:
    """``{name: library}``: each of :data:`VARIANTS` named, one ``nvcc``
    each, all started together."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels import optimizer_update as K2
    from tpuic_torch.kernels.conv_bn_relu_bench import variant_source
    src = (_build.CSRC / "optimizer_update.cu").read_text()
    waits = {n: build_source(f"k2_{n}", variant_source(src, VARIANTS[n]))
             for n in names}
    return {n: K2.bind(w()) for n, w in waits.items()}


def block_lars_update(lib, params, grads, trace, lr, finite, *,
                      weight_decay: float, trust_coefficient: float,
                      momentum: float, table) -> None:
    """One LARS update through the earlier design's kernels, in place, like
    :func:`optimizer_update.lars_update` (its launch counter untouched)."""
    import torch
    tb = table.get((grads, params, trace), BLOCK_CHUNK)
    dev = params[0].device
    with torch.cuda.device(dev):
        rc = lib.tpuic_lars_update(
            tb.leaves.data_ptr(), tb.chunks.data_ptr(), tb.n_leaves,
            tb.n_chunks, tb.chunk, lr.data_ptr(), finite.data_ptr(),
            tb.partials.data_ptr(), tb.a.data_ptr(), float(weight_decay),
            float(trust_coefficient), float(momentum),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block lars_update failed: CUDA error {rc}")


def block_lamb_update(lib, params, grads, mu, nu, count, lr, finite, *,
                      b1: float, b2: float, eps: float, weight_decay: float,
                      table) -> None:
    """One LAMB update through the earlier design's kernels, in place, like
    :func:`optimizer_update.lamb_update` (its launch counter untouched):
    the debias factors by torch ops, then the three launches."""
    import torch
    from tpuic_torch.kernels import optimizer_update as K2
    tb = table.get((grads, params, mu, nu), BLOCK_CHUNK)
    c1, c2 = K2.lamb_debias(count, b1, b2)
    scal = torch.stack([lr.reshape(()), c1, c2])
    dev = params[0].device
    with torch.cuda.device(dev):
        rc = lib.tpuic_lamb_update(
            tb.leaves.data_ptr(), tb.chunks.data_ptr(), tb.n_leaves,
            tb.n_chunks, tb.chunk, scal.data_ptr(), finite.data_ptr(),
            tb.partials.data_ptr(), tb.a.data_ptr(), float(b1), float(b2),
            1.0 - b1, 1.0 - b2, float(eps), float(weight_decay),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block lamb_update failed: CUDA error {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpuic_torch.checkpoint import init_params
    from tpuic_torch.kernels import optimizer_update as K2
    from tpuic_torch.models import create_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = build_variants(VARIANTS)
    earlier = build_earlier()
    model = init_params(create_model("resnet50", 1000, dtype="float32"),
                        args.seed, device="cuda")
    w = [p.detach() for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    g = [1e-3 * torch.randn(t.shape, generator=gen, device="cuda") for t in w]
    m = [1e-3 * torch.randn(t.shape, generator=gen, device="cuda") for t in w]
    v = [1e-6 * torch.rand(t.shape, generator=gen, device="cuda") for t in w]
    lr = torch.tensor(0.08, device="cuda")
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    finite = torch.tensor(True, device="cuda")
    lars_kw = dict(weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
    lamb_kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-4)
    want = {"lars": K2.lars_update_plain(w, g, m, lr, **lars_kw),
            "lamb": K2.lamb_update_plain(w, g, m, v, count, lr,
                                         **lamb_kw)[1]}
    out = {}
    for kind in ("lars", "lamb"):
        names = [*VARIANTS, "block" if kind == "lars" else "lamb_block"]
        rows = {n: {"device_ms": []} for n in names}
        for name in [*names, *reversed(names)]:
            ws, ms, vs = ([t.clone() for t in ts] for ts in (w, m, v))
            table = K2.LeafTable()
            if name == "block":
                def fn():
                    block_lars_update(earlier["lars"], ws, g, ms, lr, finite,
                                      table=table, **lars_kw)
            elif name == "lamb_block":
                def fn():
                    block_lamb_update(earlier["lamb"], ws, g, ms, vs, count,
                                      lr, finite, table=table, **lamb_kw)
            elif kind == "lars":
                def fn():
                    K2._lib.cdll = libs[name]
                    K2.lars_update(ws, g, ms, lr, finite, table=table,
                                   **lars_kw)
            else:
                def fn():
                    K2._lib.cdll = libs[name]
                    K2.lamb_update(ws, g, ms, vs, count, lr, finite,
                                   table=table, **lamb_kw)
            fn()
            torch.cuda.synchronize()
            # The first update's new moment (the trace for LARS, m' for
            # LAMB) against the plain version's.
            rows[name]["max_abs_err"] = max(float((a - b).abs().max())
                                            for a, b in zip(ms, want[kind]))
            rows[name]["device_ms"].append(device_time(fn)["median"])
        out[kind] = rows
    K2._lib.cdll = None
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
