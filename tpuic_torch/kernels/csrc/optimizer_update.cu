// Fused multi-tensor LARS and LAMB updates, for Hopper (sm_90a).
//
// Replaces the TPU kernels tpuic/kernels/optimizer_update.py:_lars_kernel and
// _lamb_kernel (each launched by pl.pallas_call once per parameter leaf), and
// the trust-ratio norms the JAX wrappers take outside them.  Over every leaf
// l of the parameter list at once, with float32 g (gradient), w (parameter),
// m and v (moments):
//
//   LARS: u = g + wd*w;  trust_l = tc*||w_l||/||u_l|| (1 if either norm is 0)
//         m' = (-lr*trust_l)*u + mu*m;  w' = w + m'
//         (optax.lars: the new momentum trace IS the update)
//   LAMB: m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g
//         u = (m'*c1)/(sqrt(v'*c2) + eps) + wd*w,  c1, c2 = 1/(1 - b^(count+1))
//         trust_l = ||w_l||/||u_l|| (1 if either norm is 0);  w' = w + (-lr*trust_l)*u
//
// m, v and w are updated in place: a copy of each would cost another ~95 MB
// write per tensor at ResNet-50 size.  Every write is gated by a device-side
// flag (the train step's finite = isfinite(loss) & isfinite(grad_norm)): on a
// non-finite step nothing changes, and the host never reads the flag.
//
// Design: one launch covers the whole list.  A device table, built once per
// parameter list by the wrapper, holds each leaf's pointers and size, and
// cuts every leaf into chunks of CHUNK elements; the grid runs over chunks.
// Per-leaf scalars come by pointer (lr, and LAMB's c1, c2, all computed on the
// device from the device step count).  Three kernels per update:
//   1. norms:  a block per chunk writes the chunk's sum of w^2 and of u^2
//              (LAMB: and writes m', v'); u is never stored;
//   2. trust:  a thread per leaf sums its chunks' partials in chunk order
//              (double, no atomics: two runs give the same bits) and writes
//              a_l = -lr * trust_l;
//   3. apply:  a block per chunk writes m' (LARS) and w'.  LAMB recomputes u
//              from the m', v' of pass 1, the same arithmetic, so u needs no
//              buffer.
//
// What bounds it: bytes.  The function must read g, w, m (, v) and write
// m (, v) and w once: 5 (LARS) or 7 (LAMB) float32 tensors.  At ResNet-50 +
// head (~23.8 M parameters, 95 MB a tensor) that is 0.142 ms and 0.199 ms at
// 3.35 TB/s.  Pass 1 and pass 3 both read g and w (and LAMB's m, v), so this
// simple version moves 7 (LARS) or 10 (LAMB) tensors; loads are scalar and
// coalesced.  167 per-leaf launches would make launch latency the cost; one
// multi-tensor launch per pass does not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Leaf table row, int64 fields: g, w, m, v pointers, numel, first chunk,
// number of chunks.  Chunk table row, int32 fields: leaf, start element.
constexpr int LEAF_FIELDS = 7;

struct LeafRef {
  float* g;
  float* w;
  float* m;
  float* v;
  long long n;
};

__device__ __forceinline__ LeafRef leaf_ref(const long long* leaves, int l) {
  const long long* r = leaves + (long long)l * LEAF_FIELDS;
  return {reinterpret_cast<float*>(r[0]), reinterpret_cast<float*>(r[1]),
          reinterpret_cast<float*>(r[2]), reinterpret_cast<float*>(r[3]), r[4]};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two block-wide sums, written by thread 0 to out[0], out[1].
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
  LeafRef r;
  long long lo, hi;
};

__device__ __forceinline__ Span chunk_span(const long long* leaves,
                                           const int* chunks, int chunk_size) {
  const int l = chunks[2 * blockIdx.x];
  const long long lo = chunks[2 * blockIdx.x + 1];
  const LeafRef r = leaf_ref(leaves, l);
  const long long hi = lo + chunk_size < r.n ? lo + chunk_size : r.n;
  return {r, lo, hi};
}

// ---- LARS ------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
lars_norms(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int chunk_size, float wd, float* __restrict__ partials) {
  const Span s = chunk_span(leaves, chunks, chunk_size);
  float sw = 0.f, su = 0.f;
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += THREADS) {
    const float w = s.r.w[i];
    const float u = s.r.g[i] + wd * w;
    sw += w * w;
    su += u * u;
  }
  block_sum2(sw, su, partials + 2 * (long long)blockIdx.x);
}

__global__ void __launch_bounds__(THREADS)
lars_apply(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int chunk_size, float wd, float mu, const float* __restrict__ a,
           const bool* __restrict__ finite) {
  if (!finite[0]) return;
  const Span s = chunk_span(leaves, chunks, chunk_size);
  const float al = a[chunks[2 * blockIdx.x]];
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += THREADS) {
    const float w = s.r.w[i];
    const float upd = al * (s.r.g[i] + wd * w) + mu * s.r.m[i];
    s.r.m[i] = upd;
    s.r.w[i] = w + upd;
  }
}

// ---- LAMB ------------------------------------------------------------------

// omb1 = 1 - b1 and omb2 = 1 - b2 come from the host, rounded once from
// double: 1.f - (float)0.999 is 1.3e-5 away from (float)0.001, which
// would put the second moment that far from the reference's.
struct LambHyper {
  float b1, b2, omb1, omb2, eps, wd;
};

__global__ void __launch_bounds__(THREADS)
lamb_norms(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int chunk_size, LambHyper h, const float* __restrict__ scal,
           const bool* __restrict__ finite, float* __restrict__ partials) {
  const Span s = chunk_span(leaves, chunks, chunk_size);
  const float c1 = scal[1], c2 = scal[2];
  const bool write = finite[0];
  float sw = 0.f, su = 0.f;
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += THREADS) {
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
  const Span s = chunk_span(leaves, chunks, chunk_size);
  const float c1 = scal[1], c2 = scal[2];
  const float al = a[chunks[2 * blockIdx.x]];
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += THREADS) {
    const float w = s.r.w[i];
    const float u = (s.r.m[i] * c1) / (sqrtf(s.r.v[i] * c2) + h.eps) + h.wd * w;
    s.r.w[i] = w + al * u;
  }
}

// ---- shared: per-leaf trust ratio --------------------------------------------

__global__ void trust_ratio(const long long* __restrict__ leaves, int n_leaves,
                            const float* __restrict__ partials, float coeff,
                            const float* __restrict__ scal, float* __restrict__ a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n_leaves) return;
  const long long* r = leaves + (long long)l * LEAF_FIELDS;
  const long long c0 = r[5], nc = r[6];
  double sw = 0.0, su = 0.0;
  for (long long c = c0; c < c0 + nc; ++c) {
    sw += partials[2 * c];
    su += partials[2 * c + 1];
  }
  const float pn = sqrtf((float)sw);
  const float un = sqrtf((float)su);
  const float trust = (pn == 0.f || un == 0.f) ? 1.f : coeff * pn / un;
  a[l] = -scal[0] * trust;
}

}  // namespace

// leaves: int64 [n_leaves, 7]; chunks: int32 [n_chunks, 2]; partials: float32
// [n_chunks, 2] scratch; a: float32 [n_leaves] scratch; scal: float32 [1]
// (LARS: lr) or [3] (LAMB: lr, c1, c2); finite: bool [1].  Each returns
// cudaGetLastError() after its three launches (0 when all were accepted).
// They allocate nothing and do not synchronise.
extern "C" int tpuic_lars_update(const void* leaves, const void* chunks,
                                 int n_leaves, int n_chunks, int chunk_size,
                                 const void* scal, const void* finite,
                                 void* partials, void* a, float wd, float tc,
                                 float mu, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  const int* ch = static_cast<const int*>(chunks);
  lars_norms<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, wd,
                                           static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trust_ratio<<<(n_leaves + 127) / 128, 128, 0, st>>>(
      lv, n_leaves, static_cast<const float*>(partials), tc,
      static_cast<const float*>(scal), static_cast<float*>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lars_apply<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, wd, mu,
                                           static_cast<const float*>(a),
                                           static_cast<const bool*>(finite));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpuic_lamb_update(const void* leaves, const void* chunks,
                                 int n_leaves, int n_chunks, int chunk_size,
                                 const void* scal, const void* finite,
                                 void* partials, void* a, float b1, float b2,
                                 float omb1, float omb2, float eps, float wd,
                                 void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  const int* ch = static_cast<const int*>(chunks);
  const LambHyper h{b1, b2, omb1, omb2, eps, wd};
  const float* sc = static_cast<const float*>(scal);
  const bool* fin = static_cast<const bool*>(finite);
  lamb_norms<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, h, sc, fin,
                                           static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trust_ratio<<<(n_leaves + 127) / 128, 128, 0, st>>>(
      lv, n_leaves, static_cast<const float*>(partials), 1.f, sc,
      static_cast<float*>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lamb_apply<<<n_chunks, THREADS, 0, st>>>(lv, ch, chunk_size, h, sc,
                                           static_cast<const float*>(a), fin);
  return static_cast<int>(cudaGetLastError());
}
