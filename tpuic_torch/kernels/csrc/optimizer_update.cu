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
// Design: one launch per pass covers the whole list.  A device table, built
// once per parameter list by the wrapper, holds each leaf's pointers and
// size, and cuts every leaf into chunks; the grid runs over chunks.  Per-leaf
// scalars come by pointer (lr, and the device step count from which LAMB's
// debias factors are computed).  Three kernels per update:
//   1. norms:  each chunk's sum of w^2 and of u^2 (LAMB: and writes m', v');
//              u is never stored;
//   2. trust:  a warp per leaf sums its chunks' partials in double, each
//              lane a fixed stride of them, then a fixed shuffle tree (no
//              atomics: two runs give the same bits), and writes a_l =
//              -lr * trust_l;
//   3. apply:  writes m' (LARS) and w'.  LAMB recomputes u from the m', v'
//              of pass 1, the same arithmetic, so u needs no buffer.
//
// What bounds it: bytes.  The function must read g, w, m (, v) and write
// m (, v) and w once: 5 (LARS) or 7 (LAMB) float32 tensors.  At ResNet-50 +
// head (~23.8 M parameters, 95 MB a tensor) that is 0.142 ms and 0.199 ms at
// 3.35 TB/s.  The apply pass needs every leaf's norms, and 190 MB of g and w
// do not fit in the card's 50 MB L2, so two passes read g and w twice: 7
// tensors for LARS (0.199 ms at 3.35 TB/s), 10 for LAMB (0.284 ms; storing
// u instead would move as many bytes and take a 95 MB buffer).  167
// per-leaf launches would make launch latency the cost; one multi-tensor
// launch per pass does not.
//
// Both updates are built to stream at HBM bandwidth:
//   - A chunk is CHUNK elements and belongs to one warp, not one block, so
//     the 64-2,048-element BN vectors take a warp each.  The warps of a
//     grid sized to the card (BLOCKS_PER_SM blocks an SM, fewer for a LAMB
//     pass if its registers allow fewer) walk the chunks with a grid
//     stride.
//   - Loads and stores are 16 bytes (float4) where a chunk's tensors are
//     16-byte aligned, with a scalar tail; each lane issues UNROLL loads of
//     each tensor before it uses any (LARS: 8 x 16 bytes in flight in pass
//     1, 12 in pass 3; LAMB: 16 in pass 1, 12 in pass 3).  A chunk whose
//     tensors are not aligned takes scalar loads, UNROLL of each tensor in
//     flight.
//   - A chunk's partial sums are each lane's in element order, then a fixed
//     xor-shuffle tree: the same bits on every run.
//   - LAMB's debias factors c1, c2 are computed at the start of every block
//     of both passes from the device count (two powf), so the host enqueues
//     nothing but the three launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;         // loads of each tensor in flight a lane
constexpr int BLOCKS_PER_SM = 4;  // resident blocks an SM, at most

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

// Chunk c of the table: its leaf and the elements [lo, lo + n) it covers.
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
  const LeafRef r = leaf_ref(leaves, l);
  const long long n = r.n - lo < chunk_size ? r.n - lo : chunk_size;
  return {r, lo, l, static_cast<int>(n)};
}

// ---- LARS ------------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float sq4(float4 a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Pass 1, a warp per chunk: the chunk's sum of w^2 and of u^2, u = g + wd*w.
__global__ void __launch_bounds__(THREADS)
lars_norms(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int n_chunks, int chunk_size, float wd,
           float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int c = blockIdx.x * WARPS + (threadIdx.x >> 5); c < n_chunks;
       c += stride) {
    const Chunk ch = chunk_at(leaves, chunks, c, chunk_size);
    const float* g = ch.r.g + ch.lo;
    const float* w = ch.r.w + ch.lo;
    float sw = 0.f, su = 0.f;
    int done = 0;
    if (aligned16(g) && aligned16(w)) {
      const int n4 = ch.n >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const float4* w4 = reinterpret_cast<const float4*>(w);
      for (int i = lane; i < n4; i += 32 * UNROLL) {
        float4 gv[UNROLL], wv[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int j = i + 32 * k;
          gv[k] = j < n4 ? g4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
          wv[k] = j < n4 ? w4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          sw += sq4(wv[k]);
          su += sq4(axpy4(wd, wv[k], gv[k]));
        }
      }
      done = n4 << 2;
    }
    for (int i = done + lane; i < ch.n; i += 32 * UNROLL) {
      float gv[UNROLL], wv[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int j = i + 32 * k;
        gv[k] = j < ch.n ? g[j] : 0.f;
        wv[k] = j < ch.n ? w[j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const float u = fmaf(wd, wv[k], gv[k]);
        sw += wv[k] * wv[k];
        su += u * u;
      }
    }
    sw = warp_sum(sw);
    su = warp_sum(su);
    if (lane == 0) {
      partials[2 * (long long)c] = sw;
      partials[2 * (long long)c + 1] = su;
    }
  }
}

// Pass 3, a warp per chunk: m' = a*u + mu*m and w' = w + m', where the
// device flag finite says so.
__global__ void __launch_bounds__(THREADS)
lars_apply(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int n_chunks, int chunk_size, float wd, float mu,
           const float* __restrict__ a, const bool* __restrict__ finite) {
  if (!finite[0]) return;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int c = blockIdx.x * WARPS + (threadIdx.x >> 5); c < n_chunks;
       c += stride) {
    const Chunk ch = chunk_at(leaves, chunks, c, chunk_size);
    const float al = a[ch.leaf];
    const float* g = ch.r.g + ch.lo;
    float* w = ch.r.w + ch.lo;
    float* m = ch.r.m + ch.lo;
    int done = 0;
    if (aligned16(g) && aligned16(w) && aligned16(m)) {
      const int n4 = ch.n >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* w4 = reinterpret_cast<float4*>(w);
      float4* m4 = reinterpret_cast<float4*>(m);
      for (int i = lane; i < n4; i += 32 * UNROLL) {
        float4 gv[UNROLL], wv[UNROLL], mv[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int j = i + 32 * k;
          if (j < n4) {
            gv[k] = g4[j];
            wv[k] = w4[j];
            mv[k] = m4[j];
          }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int j = i + 32 * k;
          if (j < n4) {
            const float4 u = axpy4(wd, wv[k], gv[k]);
            const float4 upd = make_float4(
                al * u.x + mu * mv[k].x, al * u.y + mu * mv[k].y,
                al * u.z + mu * mv[k].z, al * u.w + mu * mv[k].w);
            m4[j] = upd;
            w4[j] = make_float4(wv[k].x + upd.x, wv[k].y + upd.y,
                                wv[k].z + upd.z, wv[k].w + upd.w);
          }
        }
      }
      done = n4 << 2;
    }
    for (int i = done + lane; i < ch.n; i += 32 * UNROLL) {
      float gv[UNROLL], wv[UNROLL], mv[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int j = i + 32 * k;
        if (j < ch.n) {
          gv[k] = g[j];
          wv[k] = w[j];
          mv[k] = m[j];
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int j = i + 32 * k;
        if (j < ch.n) {
          const float upd = al * fmaf(wd, wv[k], gv[k]) + mu * mv[k];
          m[j] = upd;
          w[j] = wv[k] + upd;
        }
      }
    }
  }
}

// ---- LAMB ------------------------------------------------------------------

// omb1 = 1 - b1 and omb2 = 1 - b2 come from the host, rounded once from
// double: 1.f - (float)0.999 is 1.3e-5 away from (float)0.001, which
// would put the second moment that far from the reference's.
struct LambHyper {
  float b1, b2, omb1, omb2, eps, wd;
};

// c1, c2 = 1 / (1 - b^t), t = count + 1, in float32: lamb_debias's
// arithmetic (optimizer_update.py), from the device step count.
__device__ __forceinline__ float2 lamb_debias(const int* count,
                                             const LambHyper& h) {
  const float t = static_cast<float>(count[0] + 1);
  return make_float2(1.f / (1.f - powf(h.b1, t)), 1.f / (1.f - powf(h.b2, t)));
}

// u from the new moments m, v: pass 1's arithmetic and pass 3's
// recomputation alike.
__device__ __forceinline__ float lamb_u(float w, float m, float v, float2 c,
                                       const LambHyper& h) {
  return (m * c.x) / (sqrtf(v * c.y) + h.eps) + h.wd * w;
}

// One element of pass 1: the new moments m, v (in place of the old) and u.
__device__ __forceinline__ float lamb_moments(float g, float w, float& m,
                                             float& v, float2 c,
                                             const LambHyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  return lamb_u(w, m, v, c, h);
}

// Pass 1, a warp per chunk: m' and v' written where the device flag finite
// says so, and the chunk's sum of w^2 and of u^2.  Block 0 also leaves its
// c1, c2 in debias[0], debias[1].
__global__ void __launch_bounds__(THREADS)
lamb_norms(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int n_chunks, int chunk_size, LambHyper h,
           const int* __restrict__ count, const bool* __restrict__ finite,
           float* __restrict__ partials, float* __restrict__ debias) {
  const float2 c = lamb_debias(count, h);
  const bool write = finite[0];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    debias[0] = c.x;
    debias[1] = c.y;
  }
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int ci = blockIdx.x * WARPS + (threadIdx.x >> 5); ci < n_chunks;
       ci += stride) {
    const Chunk ch = chunk_at(leaves, chunks, ci, chunk_size);
    const float* g = ch.r.g + ch.lo;
    const float* w = ch.r.w + ch.lo;
    float* m = ch.r.m + ch.lo;
    float* v = ch.r.v + ch.lo;
    float sw = 0.f, su = 0.f;
    int done = 0;
    if (aligned16(g) && aligned16(w) && aligned16(m) && aligned16(v)) {
      const int n4 = ch.n >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const float4* w4 = reinterpret_cast<const float4*>(w);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (int i = lane; i < n4; i += 32 * UNROLL) {
        // Past the chunk every tensor reads as 0, and then so does u: the
        // sums take +0.
        float4 gv[UNROLL], wv[UNROLL], mv[UNROLL], vv[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int j = i + 32 * k;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          gv[k] = j < n4 ? g4[j] : z;
          wv[k] = j < n4 ? w4[j] : z;
          mv[k] = j < n4 ? m4[j] : z;
          vv[k] = j < n4 ? v4[j] : z;
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          float4 u;
          u.x = lamb_moments(gv[k].x, wv[k].x, mv[k].x, vv[k].x, c, h);
          u.y = lamb_moments(gv[k].y, wv[k].y, mv[k].y, vv[k].y, c, h);
          u.z = lamb_moments(gv[k].z, wv[k].z, mv[k].z, vv[k].z, c, h);
          u.w = lamb_moments(gv[k].w, wv[k].w, mv[k].w, vv[k].w, c, h);
          sw += sq4(wv[k]);
          su += sq4(u);
          const int j = i + 32 * k;
          if (write && j < n4) {
            m4[j] = mv[k];
            v4[j] = vv[k];
          }
        }
      }
      done = n4 << 2;
    }
    for (int i = done + lane; i < ch.n; i += 32 * UNROLL) {
      float gv[UNROLL], wv[UNROLL], mv[UNROLL], vv[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int j = i + 32 * k;
        gv[k] = j < ch.n ? g[j] : 0.f;
        wv[k] = j < ch.n ? w[j] : 0.f;
        mv[k] = j < ch.n ? m[j] : 0.f;
        vv[k] = j < ch.n ? v[j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const float u = lamb_moments(gv[k], wv[k], mv[k], vv[k], c, h);
        sw += wv[k] * wv[k];
        su += u * u;
        const int j = i + 32 * k;
        if (write && j < ch.n) {
          m[j] = mv[k];
          v[j] = vv[k];
        }
      }
    }
    sw = warp_sum(sw);
    su = warp_sum(su);
    if (lane == 0) {
      partials[2 * (long long)ci] = sw;
      partials[2 * (long long)ci + 1] = su;
    }
  }
}

// Pass 3, a warp per chunk: w' = w + a*u from pass 1's m', v', where the
// device flag finite says so.
__global__ void __launch_bounds__(THREADS)
lamb_apply(const long long* __restrict__ leaves, const int* __restrict__ chunks,
           int n_chunks, int chunk_size, LambHyper h,
           const int* __restrict__ count, const float* __restrict__ a,
           const bool* __restrict__ finite) {
  if (!finite[0]) return;
  const float2 c = lamb_debias(count, h);
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int ci = blockIdx.x * WARPS + (threadIdx.x >> 5); ci < n_chunks;
       ci += stride) {
    const Chunk ch = chunk_at(leaves, chunks, ci, chunk_size);
    const float al = a[ch.leaf];
    float* w = ch.r.w + ch.lo;
    const float* m = ch.r.m + ch.lo;
    const float* v = ch.r.v + ch.lo;
    int done = 0;
    if (aligned16(w) && aligned16(m) && aligned16(v)) {
      const int n4 = ch.n >> 2;
      float4* w4 = reinterpret_cast<float4*>(w);
      const float4* m4 = reinterpret_cast<const float4*>(m);
      const float4* v4 = reinterpret_cast<const float4*>(v);
      for (int i = lane; i < n4; i += 32 * UNROLL) {
        float4 wv[UNROLL], mv[UNROLL], vv[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int j = i + 32 * k;
          if (j < n4) {
            wv[k] = w4[j];
            mv[k] = m4[j];
            vv[k] = v4[j];
          }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int j = i + 32 * k;
          if (j < n4) {
            const float4 x = wv[k];
            w4[j] = make_float4(
                x.x + al * lamb_u(x.x, mv[k].x, vv[k].x, c, h),
                x.y + al * lamb_u(x.y, mv[k].y, vv[k].y, c, h),
                x.z + al * lamb_u(x.z, mv[k].z, vv[k].z, c, h),
                x.w + al * lamb_u(x.w, mv[k].w, vv[k].w, c, h));
          }
        }
      }
      done = n4 << 2;
    }
    for (int i = done + lane; i < ch.n; i += 32 * UNROLL) {
      float wv[UNROLL], mv[UNROLL], vv[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int j = i + 32 * k;
        if (j < ch.n) {
          wv[k] = w[j];
          mv[k] = m[j];
          vv[k] = v[j];
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int j = i + 32 * k;
        if (j < ch.n) w[j] = wv[k] + al * lamb_u(wv[k], mv[k], vv[k], c, h);
      }
    }
  }
}

// ---- shared: per-leaf trust ratio --------------------------------------------

// A warp per leaf: lane i sums partials i, i + 32, ... of the leaf's chunks
// in double, then a fixed shuffle tree; lane 0 writes a_l.
__global__ void __launch_bounds__(THREADS)
trust_ratio(const long long* __restrict__ leaves, int n_leaves,
            const float* __restrict__ partials, float coeff,
            const float* __restrict__ lr, float* __restrict__ a) {
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
  a[l] = -lr[0] * trust;
}

// The card's SM count, read once.
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached = n;
  }
  *sms = cached;
  return cudaSuccess;
}

// Blocks of THREADS a LAMB pass keeps resident on an SM: BLOCKS_PER_SM, or
// fewer where the kernel's registers allow fewer.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* per_sm) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
  *per_sm = n < 1 ? 1 : (n < BLOCKS_PER_SM ? n : BLOCKS_PER_SM);
  return e;
}

// A grid-stride pass's blocks: no more than its chunks need, no more than
// the card holds at once.
int pass_blocks(int n_chunks, int sms, int per_sm) {
  const int need = (n_chunks + WARPS - 1) / WARPS;
  return need < sms * per_sm ? need : sms * per_sm;
}

}  // namespace

// leaves: int64 [n_leaves, 7]; chunks: int32 [n_chunks, 2]; partials: float32
// [n_chunks, 2] scratch; a: float32 [n_leaves + 2] scratch (LAMB leaves the
// c1, c2 of its pass 1 in a[n_leaves], a[n_leaves + 1]); lr: float32 [1];
// count (LAMB): int32 [1], the number of previous updates; finite: bool
// [1].  chunk_size must be a multiple of 4.  Each returns
// cudaGetLastError() after its three launches (0 when all were accepted).
// They allocate nothing and do not synchronise.
extern "C" int tpuic_lars_update(const void* leaves, const void* chunks,
                                 int n_leaves, int n_chunks, int chunk_size,
                                 const void* lr, const void* finite,
                                 void* partials, void* a, float wd, float tc,
                                 float mu, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || chunk_size <= 0 || chunk_size % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  const int* ch = static_cast<const int*>(chunks);
  const int blocks = pass_blocks(n_chunks, sms, BLOCKS_PER_SM);
  lars_norms<<<blocks, THREADS, 0, st>>>(lv, ch, n_chunks, chunk_size, wd,
                                         static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trust_ratio<<<(n_leaves + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      lv, n_leaves, static_cast<const float*>(partials), tc,
      static_cast<const float*>(lr), static_cast<float*>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lars_apply<<<blocks, THREADS, 0, st>>>(lv, ch, n_chunks, chunk_size, wd, mu,
                                         static_cast<const float*>(a),
                                         static_cast<const bool*>(finite));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpuic_lamb_update(const void* leaves, const void* chunks,
                                 int n_leaves, int n_chunks, int chunk_size,
                                 const void* lr, const void* count,
                                 const void* finite, void* partials, void* a,
                                 float b1, float b2, float omb1, float omb2,
                                 float eps, float wd, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || chunk_size <= 0 || chunk_size % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  static int norms_per_sm = 0, apply_per_sm = 0;  // read once
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess && norms_per_sm == 0) {
    err = resident_blocks(lamb_norms, &norms_per_sm);
    if (err == cudaSuccess) err = resident_blocks(lamb_apply, &apply_per_sm);
    if (err != cudaSuccess) norms_per_sm = 0;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  const int* ch = static_cast<const int*>(chunks);
  const LambHyper h{b1, b2, omb1, omb2, eps, wd};
  const int* cnt = static_cast<const int*>(count);
  const bool* fin = static_cast<const bool*>(finite);
  float* av = static_cast<float*>(a);
  lamb_norms<<<pass_blocks(n_chunks, sms, norms_per_sm), THREADS, 0, st>>>(
      lv, ch, n_chunks, chunk_size, h, cnt, fin,
      static_cast<float*>(partials), av + n_leaves);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trust_ratio<<<(n_leaves + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      lv, n_leaves, static_cast<const float*>(partials), 1.f,
      static_cast<const float*>(lr), av);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lamb_apply<<<pass_blocks(n_chunks, sms, apply_per_sm), THREADS, 0, st>>>(
      lv, ch, n_chunks, chunk_size, h, cnt, av, fin);
  return static_cast<int>(cudaGetLastError());
}
