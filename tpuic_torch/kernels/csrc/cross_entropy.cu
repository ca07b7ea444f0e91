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
// Design: one 128-thread block per row.  Threads stride over C, then warp
// shuffles and one shared-memory pass across the four warps give the row's
// max, sum of exp and (with smoothing) sum of x.  The label's logit x[y] is
// read directly: no one-hot is built.  The forward uses the algebraic form
//   nll = -(1 - ls) * (x[y] - lse) * valid - ls * (sum(x) / C - lse),
// which is the reference's sum over the smoothed target.
//
// What bounds it: bytes.  At the main path's [128, 1000] float32 the forward
// reads 512 KB and the backward reads 512 KB and writes 512 KB: 0.15 us and
// 0.3 us at 3.35 TB/s, far below one launch.  A row per block keeps B = 128
// blocks on the 132 SMs; nothing more is done for speed.

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
