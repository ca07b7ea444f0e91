// Fused weighted cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels tpuic/kernels/cross_entropy.py:_fwd_kernel and
// _bwd_kernel (launched by pl.pallas_call in _fwd_persample and _bwd_grads).
// For logits x [B, C] float32, int32 labels y [B], class weights cw [C] and a
// validity mask [B], with label smoothing ls:
//
//   target_j = onehot_j * (1 - ls) + ls / C      (onehot_j = [j == y])
//   w        = cw[y] * mask   if 0 <= y < C, else 0  (the one-hot is empty)
//   forward:  wnll = w * nll, nll = -sum_j target_j * log_softmax(x)_j;
//             emits the per-row wnll and w (the normalisation
//             sum(wnll) / max(sum(w), 1e-12) stays a torch op outside)
//   backward: dx_j = (softmax(x)_j - target_j) * w * scale, where scale =
//             g / max(sum(w), 1e-12) is read from a device pointer, so the
//             step needs no host sync.
//
// The forward uses the algebraic form
//   nll = -(1 - ls) * (x[y] - lse) * valid - ls * (sum(x) / C - lse),
// which is the reference's sum over the smoothed target.  The label's logit
// x[y] is read directly: no one-hot is built.
//
// What bounds it: bytes.  At the main path's [128, 1000] float32 the forward
// reads 512 KB and the backward reads 512 KB and writes 512 KB: 0.15 us and
// 0.3 us at 3.35 TB/s, far below one launch.  What the card can give there is
// the launch plus one DRAM round trip for the row.
//
// Forward design: a warp per row, FWD_WARPS rows a block, one read of the
// row.  Each lane streams its elements (FWD_UNROLL float4 loads in flight
// where the row is 16-byte aligned, as at C = 1000; FWD_SCALARS scalar
// loads where it is not, as at C = 7) and carries an online (max, sum of
// exp(x - max), sum of x): a batch's max first, the running sum rescaled
// once, then an expf per element.  The lanes merge by fixed xor-shuffle
// trees, with no shared memory and no barrier: the max first, then each
// lane's sum rescaled to it once, then the sums (one tree of online pairs
// puts two expf on every level: 0.4 us more a call at [128, 1000] on an
// H100).  Lane 0's loads of x[y] and cw[y] are in flight while the trees
// run; it finishes the row.  At B = 128 a warp runs alone on its
// scheduler, so every unrolled instruction costs its latency, predicated
// off or not: the scalar path unrolls 8, not 32 (0.7 us a call at C = 7
// on an H100).
//
// Backward design: one read of the row, kept in registers.  A team of
// BWD_TEAM threads owns a row: the whole 128-thread block (a warp, four
// rows a block, is cross_entropy_bench's team_warp variant).  Group g of a
// row is its elements 4g..4g+3, and thread t of the team owns groups t,
// t + BWD_TEAM, ...: rows up to C = 1024 stay in registers (BWD_HOLD
// groups a thread), loaded as float4 where the row is 16-byte aligned and
// element by element where it is not.  The max comes from that copy by a
// team tree (xor shuffles, then one shared-memory exchange across the four
// warps), then each element's exp in place and the sum by the same tree,
// then dx = (e / s - target) * w * scale from the registers (a multiply by
// 1 / s).  Longer rows stream in two passes: an online max and sum
// (BWD_STREAM groups in flight a thread), then dx.  A thread owns the same
// elements and sums them in the same order whatever the row's alignment,
// and a row is one team, so a row's bits do not depend on its batch or its
// place in it.
//
// Why a block and not a warp (cross_entropy_bench on an H100 80GB HBM3 at
// 700 W, device time): at the train path's [128, 1000] the block takes
// 2.35 us and the warp 3.08 us (the design before, a block per row reading
// the row three times, 3.79 us).  At B = 128 a warp runs alone on its
// scheduler and pays its 32 expf and its shuffle levels in full; the block
// spreads a row's 1000 expf over four warps.  Where many rows share an SM
// the number of blocks in flight decides: with 8 groups in flight on a
// long row the kernel took 56 registers (9 blocks an SM) and 28.1 us at
// [8192, 1000] (bound 19.6); with 2 it fits 32 registers, 16 blocks an SM,
// and takes 25.0 us, the same 2.37 us at [128, 1000].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---- forward: a warp per row ------------------------------------------------

constexpr int FWD_WARPS = 4;    // rows a block
constexpr int FWD_UNROLL = 8;   // float4 loads in flight a lane
constexpr int FWD_SCALARS = 8;  // scalar loads in flight a lane

// A lane's online softmax statistics over the elements it has seen: the
// max m, sum(exp(x - m)) and sum(x).
struct Online {
  float m, s, sx;
};

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

// Folds the batch v (where ok) whose max is bm into st: the running sum
// rescaled once, then an expf each.
template <int N>
__device__ __forceinline__ void fold(Online& st, const float (&v)[N],
                                     const bool (&ok)[N], float bm) {
  if (bm > st.m) {
    st.s *= expf(st.m - bm);  // 0 while the lane has seen nothing
    st.m = bm;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (ok[k]) {
      st.s += expf(v[k] - st.m);
      st.sx += v[k];
    }
  }
}

__global__ void __launch_bounds__(FWD_WARPS * 32)
xent_fwd_kernel(const float* __restrict__ x, const int* __restrict__ y,
                const float* __restrict__ cw, const float* __restrict__ mask,
                float* __restrict__ wnll, float* __restrict__ w_out, int B,
                int C, float ls) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: the shuffles below stay full
  const float* row = x + (long long)b * C;
  const int label = y[b];
  const bool valid = label >= 0 && label < C;
  Online st{-INFINITY, 0.f, 0.f};
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15u) == 0) {
    const int n4 = C >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int i = lane; i < n4; i += 32 * FWD_UNROLL) {
      float4 q[FWD_UNROLL];
#pragma unroll
      for (int k = 0; k < FWD_UNROLL; ++k)
        if (i + 32 * k < n4) q[k] = r4[i + 32 * k];
      float v[4 * FWD_UNROLL];
      bool ok[4 * FWD_UNROLL];
      float bm = -INFINITY;
#pragma unroll
      for (int k = 0; k < FWD_UNROLL; ++k) {
        const bool in = i + 32 * k < n4;
        v[4 * k] = q[k].x;
        v[4 * k + 1] = q[k].y;
        v[4 * k + 2] = q[k].z;
        v[4 * k + 3] = q[k].w;
        ok[4 * k] = ok[4 * k + 1] = ok[4 * k + 2] = ok[4 * k + 3] = in;
        if (in) bm = fmaxf(bm, max4(q[k]));
      }
      fold(st, v, ok, bm);
    }
    done = n4 << 2;
  }
  for (int i = done + lane; i < C; i += 32 * FWD_SCALARS) {
    float v[FWD_SCALARS];
    bool ok[FWD_SCALARS];
    float bm = -INFINITY;
#pragma unroll
    for (int k = 0; k < FWD_SCALARS; ++k) {
      ok[k] = i + 32 * k < C;
      v[k] = ok[k] ? row[i + 32 * k] : -INFINITY;
      bm = fmaxf(bm, v[k]);
    }
    fold(st, v, ok, bm);
  }
  // Lane 0's loads of x[y], cw[y] and the mask, in flight while the trees
  // run (the row is in cache).
  float xy = 0.f, cwy = 0.f, mk = 0.f;
  if (lane == 0 && valid) {
    xy = row[label];
    cwy = cw[label];
    mk = mask[b];
  }
  // The warp's max by a fixed xor tree, each lane's sum rescaled to it
  // once, then the sums by the same tree.
  float m = st.m;
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
  if (lane != 0) return;
  const float lse = m + logf(s);
  const float w = valid ? cwy * mk : 0.f;
  float nll = valid ? -(1.f - ls) * (xy - lse) : 0.f;
  if (ls > 0.f) nll -= ls * (sx / (float)C - lse);
  wnll[b] = w * nll;
  w_out[b] = w;
}

// ---- backward: one read of the row -----------------------------------------

constexpr int BWD_TEAM = THREADS;              // threads a row: 32 or THREADS
constexpr int BWD_ROWS = THREADS / BWD_TEAM;   // rows a block
constexpr int BWD_HOLD = 1024 / (4 * BWD_TEAM);  // groups a thread holds
constexpr int BWD_STREAM = 2;  // groups in flight a thread on a long row
constexpr int BWD_MIN_BLOCKS = 16;  // blocks an SM: at most 32 registers
static_assert(BWD_TEAM == 32 || BWD_TEAM == THREADS, "a warp or the block");

__device__ __forceinline__ float4 neg_inf4() {
  return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
}

// Elements 4g..4g+3 of a row; -inf past its end.  ``vec``: the row is
// 16-byte aligned, so a whole group is one float4 load.
__device__ __forceinline__ float4 load_group(const float* row, int g, int C,
                                             bool vec) {
  const int j = 4 * g;
  if (vec && j + 3 < C) return reinterpret_cast<const float4*>(row)[g];
  float4 v = neg_inf4();
  if (j < C) v.x = row[j];
  if (j + 1 < C) v.y = row[j + 1];
  if (j + 2 < C) v.z = row[j + 2];
  if (j + 3 < C) v.w = row[j + 3];
  return v;
}

__device__ __forceinline__ void store_group(float* row, int g, int C,
                                            bool vec, float4 v) {
  const int j = 4 * g;
  if (vec && j + 3 < C) {
    reinterpret_cast<float4*>(row)[g] = v;
    return;
  }
  if (j < C) row[j] = v.x;
  if (j + 1 < C) row[j + 1] = v.y;
  if (j + 2 < C) row[j + 2] = v.z;
  if (j + 3 < C) row[j + 3] = v.w;
}

// The team's max / sum; every thread of the team gets it.  A block-wide
// team exchanges the warps' values once through ``xchg`` (one array per
// reduction, so no second barrier) and combines them in warp order.
template <bool MAX>
__device__ __forceinline__ float team_reduce(float v, float* xchg) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if (BWD_TEAM == 32) return v;
  if ((threadIdx.x & 31) == 0) xchg[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = xchg[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = MAX ? fmaxf(r, xchg[i]) : r + xchg[i];
  return r;
}

// dx of group g from e = exp(x - m): (e / s - target) * ws.
__device__ __forceinline__ float4 grad_group(float4 e, int g, float inv_s,
                                             int label, float on, float off,
                                             float ws) {
  const int j = 4 * g;
  float4 d;
  d.x = (e.x * inv_s - ((j == label ? on : 0.f) + off)) * ws;
  d.y = (e.y * inv_s - ((j + 1 == label ? on : 0.f) + off)) * ws;
  d.z = (e.z * inv_s - ((j + 2 == label ? on : 0.f) + off)) * ws;
  d.w = (e.w * inv_s - ((j + 3 == label ? on : 0.f) + off)) * ws;
  return d;
}

__device__ __forceinline__ float4 exp_shift(float4 v, float m) {
  return make_float4(expf(v.x - m), expf(v.y - m), expf(v.z - m),
                     expf(v.w - m));
}

__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
xent_bwd_kernel(const float* __restrict__ x, const int* __restrict__ y,
                const float* __restrict__ cw, const float* __restrict__ mask,
                const float* __restrict__ scale, float* __restrict__ dx,
                int B, int C, float ls) {
  __shared__ float xmax[WARPS], xsum[WARPS];
  const int t = threadIdx.x % BWD_TEAM;
  const int b = blockIdx.x * BWD_ROWS + threadIdx.x / BWD_TEAM;
  if (b >= B) return;  // a whole team: its shuffles stay full
  const float* row = x + (long long)b * C;
  float* drow = dx + (long long)b * C;
  // The row's scalars, in flight while the row loads.
  const int label = y[b];
  const float mk = mask[b], sc = scale[0];
  const bool valid = label >= 0 && label < C;
  const float ws = (valid ? cw[label] * mk : 0.f) * sc;
  const float off = ls > 0.f ? ls / (float)C : 0.f;
  const float on = ls > 0.f ? (1.f - ls) : 1.f;
  const bool xvec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
  const bool dvec = (reinterpret_cast<uintptr_t>(drow) & 15u) == 0;
  const int groups = (C + 3) >> 2;
  if (groups <= BWD_TEAM * BWD_HOLD) {
    float4 v[BWD_HOLD];
#pragma unroll
    for (int k = 0; k < BWD_HOLD; ++k) {
      const int g = t + BWD_TEAM * k;
      v[k] = g < groups ? load_group(row, g, C, xvec) : neg_inf4();
    }
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < BWD_HOLD; ++k) m = fmaxf(m, max4(v[k]));
    m = team_reduce<true>(m, xmax);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_HOLD; ++k) {
      v[k] = exp_shift(v[k], m);  // 0 past the row's end
      s += v[k].x;
      s += v[k].y;
      s += v[k].z;
      s += v[k].w;
    }
    const float inv_s = 1.f / team_reduce<false>(s, xsum);
#pragma unroll
    for (int k = 0; k < BWD_HOLD; ++k) {
      const int g = t + BWD_TEAM * k;
      if (g < groups)
        store_group(drow, g, C, dvec,
                    grad_group(v[k], g, inv_s, label, on, off, ws));
    }
    return;
  }
  // A long row: an online max and sum, BWD_STREAM groups a batch (the
  // batch's max first, the running sum rescaled once), then dx.
  float m = -INFINITY, s = 0.f;
  for (int g0 = t; g0 < groups; g0 += BWD_TEAM * BWD_STREAM) {
    float4 q[BWD_STREAM];
    float bm = -INFINITY;
#pragma unroll
    for (int k = 0; k < BWD_STREAM; ++k) {
      const int g = g0 + BWD_TEAM * k;
      q[k] = g < groups ? load_group(row, g, C, xvec) : neg_inf4();
      bm = fmaxf(bm, max4(q[k]));
    }
    if (bm > m) {
      s *= expf(m - bm);  // 0 while the thread has seen nothing
      m = bm;
    }
#pragma unroll
    for (int k = 0; k < BWD_STREAM; ++k) {
      const float4 e = exp_shift(q[k], m);
      s += e.x;
      s += e.y;
      s += e.z;
      s += e.w;
    }
  }
  const float tm = team_reduce<true>(m, xmax);
  s = m == tm ? s : s * expf(m - tm);  // a thread that saw nothing adds 0
  const float inv_s = 1.f / team_reduce<false>(s, xsum);
  for (int g = t; g < groups; g += BWD_TEAM)
    store_group(drow, g, C, dvec,
                grad_group(exp_shift(load_group(row, g, C, xvec), tm), g,
                           inv_s, label, on, off, ws));
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 when it was accepted).
// They allocate nothing and do not synchronise: the caller owns every buffer
// and the stream.
extern "C" int tpuic_xent_fwd(const void* x, const void* y, const void* cw,
                              const void* mask, void* wnll, void* w, int B,
                              int C, float ls, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = B / FWD_WARPS + (B % FWD_WARPS != 0);
  xent_fwd_kernel<<<blocks, FWD_WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(y),
      static_cast<const float*>(cw), static_cast<const float*>(mask),
      static_cast<float*>(wnll), static_cast<float*>(w), B, C, ls);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpuic_xent_bwd(const void* x, const void* y, const void* cw,
                              const void* mask, const void* scale, void* dx,
                              int B, int C, float ls, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = B / BWD_ROWS + (B % BWD_ROWS != 0);
  xent_bwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(y),
      static_cast<const float*>(cw), static_cast<const float*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(dx), B, C, ls);
  return static_cast<int>(cudaGetLastError());
}
