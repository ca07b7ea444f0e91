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
// Backward design: one 128-thread block per row.  Threads stride over C,
// then warp shuffles and one shared-memory pass across the four warps give
// the row's max and sum of exp.  A row per block keeps B = 128 blocks on the
// 132 SMs; nothing more is done for speed.

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

// The backward's row statistics: the max m and sum(exp(x - m)).
struct RowStats {
  float m, s;
};

__device__ RowStats row_stats(const float* row, int C, float* scratch) {
  float m = -INFINITY;
  for (int j = threadIdx.x; j < C; j += THREADS) m = fmaxf(m, row[j]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
  for (int j = threadIdx.x; j < C; j += THREADS) s += expf(row[j] - m);
  s = block_reduce<false>(s, scratch);
  return {m, s};
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

__global__ void __launch_bounds__(THREADS)
xent_bwd_kernel(const float* __restrict__ x, const int* __restrict__ y,
                const float* __restrict__ cw, const float* __restrict__ mask,
                const float* __restrict__ scale, float* __restrict__ dx, int C,
                float ls) {
  __shared__ float scratch[WARPS];
  const int b = blockIdx.x;
  const float* row = x + (long long)b * C;
  float* drow = dx + (long long)b * C;
  const RowStats st = row_stats(row, C, scratch);
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
  xent_bwd_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(y),
      static_cast<const float*>(cw), static_cast<const float*>(mask),
      static_cast<const float*>(scale), static_cast<float*>(dx), C, ls);
  return static_cast<int>(cudaGetLastError());
}
