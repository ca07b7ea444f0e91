"""K2a (the LARS update, ``csrc/optimizer_update.cu``) on the card: the
shipped kernels against design variants and the design they replaced,
timed on the card alone.

``chip_smoke.py`` takes :func:`device_time`, :func:`build_block` and
:func:`block_lars_update` from here; nothing on the port's paths imports
this module.  Each variant but ``block`` is the shipped source with a few
text substitutions; every one is built into its own library under
``tpuic_torch/_build/variants/``.

- ``shipped``: :func:`optimizer_update.lars_update` as it is: a warp per
  4,096-element chunk, 16-byte loads with four of each tensor in flight a
  lane.
- ``reverse_walk``: the apply pass walks the chunks in reverse order, so
  that the g and w the norms pass read last may still be in the 50 MB L2.
- ``unroll_1``: one load of each tensor in flight a lane.
- ``block``: the design before it, kept here as source text
  (:data:`BLOCK_SRC`): a 256-thread block per 16,384-element chunk, one
  scalar load a thread at a time, a thread per leaf summing the partials.

Usage (needs an NVIDIA GPU and ``nvcc``)::

    python -m tpuic_torch.kernels.optimizer_update_bench [--seed 0]

prints, over the ResNet-50 + head parameter list (167 leaves), each
design's max abs error against the plain version and its device
milliseconds per update (:func:`device_time`), each design twice, in
turns.
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
    "reverse_walk": [
        ("chunk_at(leaves, chunks, c, chunk_size);\n    const float al",
         "chunk_at(leaves, chunks, n_chunks - 1 - c, chunk_size);\n"
         "    const float al")],
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


def _nvcc(name: str, src: str):
    """Start ``nvcc`` on ``src`` with the port's flags; returns ``(library
    path, process)``."""
    from tpuic_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"lars_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"liblars_{name}.so"
    return so, subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _load(name: str, so, proc) -> ctypes.CDLL:
    from tpuic_torch.kernels import optimizer_update as K2
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} LARS design:\n{text}")
    return K2.bind(ctypes.CDLL(str(so)), ("lars",))


def build_block() -> ctypes.CDLL:
    """The earlier LARS design (:data:`BLOCK_SRC`), built with the port's
    flags."""
    return _load("block", *_nvcc("block", BLOCK_SRC))


def build_variants(names) -> dict:
    """``{name: library}``: each of :data:`VARIANTS` named, one ``nvcc``
    each, all started together."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels.conv_bn_relu_bench import variant_source
    src = (_build.CSRC / "optimizer_update.cu").read_text()
    procs = {n: _nvcc(n, variant_source(src, VARIANTS[n])) for n in names}
    return {n: _load(n, *p) for n, p in procs.items()}


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
            tb.n_chunks, tb.chunk, lr.reshape(1).data_ptr(),
            finite.data_ptr(), tb.partials.data_ptr(), tb.a.data_ptr(),
            float(weight_decay), float(trust_coefficient), float(momentum),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block lars_update failed: CUDA error {rc}")


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
    block = build_block()
    model = init_params(create_model("resnet50", 1000, dtype="float32"),
                        args.seed, device="cuda")
    w = [p.detach() for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    g = [1e-3 * torch.randn(t.shape, generator=gen, device="cuda") for t in w]
    m = [1e-3 * torch.randn(t.shape, generator=gen, device="cuda") for t in w]
    lr = torch.tensor(0.08, device="cuda")
    finite = torch.tensor(True, device="cuda")
    kw = dict(weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
    want = K2.lars_update_plain(w, g, m, lr, **kw)
    names = [*VARIANTS, "block"]
    rows = {n: {"device_ms": []} for n in names}
    for name in [*names, *reversed(names)]:
        ws, ms = [t.clone() for t in w], [t.clone() for t in m]
        table = K2.LeafTable()
        if name == "block":
            def fn():
                block_lars_update(block, ws, g, ms, lr, finite, table=table,
                                  **kw)
        else:
            K2._lib.cdll = libs[name]

            def fn():
                K2.lars_update(ws, g, ms, lr, finite, table=table, **kw)
        fn()
        torch.cuda.synchronize()
        rows[name]["max_abs_err"] = max(float((a - b).abs().max())
                                        for a, b in zip(ms, want))
        rows[name]["device_ms"].append(device_time(fn)["median"])
    K2._lib.cdll = None
    print(json.dumps(rows), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
