// Flash attention (blockwise online softmax), forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tpuic/kernels/flash_attention.py:
//   _fwd_kernel     (:154, pallas_call :324)  -> flash_fwd_kernel
//   _bwd_dq_kernel  (:346, pallas_call :454)  -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (:373, pallas_call :480)  -> flash_bwd_dkv_kernel
// and their lane-packed variants (:541, :674, :708), which exist only for the
// TPU's 128-lane tiling.  Here every kernel reads q, k, v, o and do in the
// model's own [B, N, H, D] layout through (batch, token, head) strides, so a
// strided view of the qkv projection goes in with no copy, and N (197 for
// ViT-B/16 at 224) is bounds-checked, not padded.
//
// For one (b, h), with scale = 1/sqrt(D) and keys j >= valid masked to -1e30
// (not -inf: the row max stays finite and p = exp(s - lse) is 0 for them):
//   forward:  s = scale * q k^T; o = softmax(s) v; lse = m + log(l) per row,
//             and for a row with no valid key o = 0, lse = masked_sentinel.
//   dq:       delta = rowsum(do * o) (the kernel's prologue, written out for
//             the dk/dv kernel); p = exp(s - lse); ds = p * (do v^T - delta);
//             dq = scale * ds k.
//   dk/dv:    dk = scale * ds^T q; dv = p^T do.
// The backward reads lse; it never rebuilds the softmax normaliser.  dq is
// owned per q tile and dk/dv per k tile (the reference grids, :457 and :484),
// so no atomics are needed and two runs give the same bits.
//
// Design (simple first): one 128-thread block per (b*h, 64-row tile).  The
// block's own tile and the tiles it loops over are staged in shared memory
// as float32 (bf16 inputs are widened on load), 64 x 64 score tiles are
// computed on the CUDA cores with float32 accumulation, and each thread owns
// a 4 x 8 piece of the score tile (rows tr + 16i, columns tc + 8j) and a
// 4 x D/8 piece of its accumulators.  Row reductions of the online softmax
// are shuffles across the 8 lanes that share a row.  Shared-memory rows are
// padded (D + 1, 64 + 8 floats) so that the lanes of a warp hit distinct
// banks.
//
// What bounds it on an H100: operations.  At ViT-B/16's [64, 197, 12, 64]
// the forward needs 4*B*H*N^2*D = 7.6 GFLOP (0.114 ms at the 67 TFLOP/s
// float32 peak) against 19 MB of traffic (0.006 ms at 3.35 TB/s).  This
// version pads N to whole 64-row tiles (197 -> 256, 1.7x the work), feeds
// each FMA from shared memory, and does not use the tensor cores; a TF32 or
// bf16 wgmma version with TMA-fed tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;          // rows of every q, k and v tile
constexpr int THREADS = 128;
constexpr int LDP = BM + 8;     // row stride of a score tile in shared memory
constexpr float NEG = -1e30f;   // the reference's _NEG_INF

struct Strides {
  long long b, n, h;            // elements; the head dim has stride 1
};

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;                      // contiguous [B, N, H, D]
  float* lse;                   // contiguous [B, H, N]
  Strides sq, sk, sv;
  const int* valid;             // optional device count of valid keys
  int valid_len, B, N, H;
  float scale, sentinel;
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;             // contiguous [B, H, N]
  float* delta;                 // contiguous [B, H, N], written by dq
  void* dq;                     // contiguous [B, N, H, D]
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo;
  const int* valid;
  int valid_len, B, N, H;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// Rows [r0, r0 + BM) of one (b, h) slice into shared memory as float32 with
// row stride D + 1; rows at or past N become zeros, so nothing past the end
// of the sequence is read and no garbage reaches a product.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long sn, int r0, int N) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < BM * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < N ? ld(base + row * sn + c) : 0.f;
  }
}

__device__ __forceinline__ int valid_keys(const int* valid, int valid_len,
                                          int N) {
  const int vl = valid ? *valid : valid_len;
  return min(max(vl, 0), N);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FwdParams p) {
  constexpr int LD = D + 1, DC = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BM * LD;
  float* Ps = Vs + BM * LD;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * BM, N = p.N;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int vl = valid_keys(p.valid, p.valid_len, N);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  load_tile<T, D>(Qs, q, p.sq.n, q0, N);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += BM) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, D>(Ks, k, p.sk.n, k0, N);
    load_tile<T, D>(Vs, v, p.sv.n, k0, N);
    __syncthreads();
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = k0 + tc + 8 * j < vl ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], group8_max(mx));
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - mn);
        Ps[(tr + 16 * i) * LDP + tc + 8 * j] = e;
        ps += e;
      }
      l[i] = l[i] * alpha + group8_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BM; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * LD + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  T* o = static_cast<T*>(p.o) + (long long)b * N * p.H * D + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= N) continue;
    const bool masked = m[i] <= NEG * 0.5f;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = masked ? 0.f : 1.f / lc;
    T* orow = o + (long long)row * p.H * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 8 * c] = cvt<T>(acc[i][c] * inv);
    if (tc == 0)
      p.lse[(long long)bh * N + row] = masked ? p.sentinel : m[i] + logf(lc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int LD = D + 1, DC = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + BM * LD;   // do
  float* Ks = Gs + BM * LD;
  float* Vs = Ks + BM * LD;
  float* Ds = Vs + BM * LD;   // ds tile
  float* dls = Ds + BM * LDP; // delta of the tile's rows
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * BM, N = p.N;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int vl = valid_keys(p.valid, p.valid_len, N);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h;
  const T* g = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  load_tile<T, D>(Qs, q, p.sq.n, q0, N);
  load_tile<T, D>(Gs, g, p.sdo.n, q0, N);
  __syncthreads();
  {
    // Prologue: delta = rowsum(do * o), two threads per row.
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < N) {
      const T* orow = o + row * p.so.n;
#pragma unroll 8
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
        sum = fmaf(Gs[r * LD + c], ld(orow + c), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      dls[r] = sum;
      if (row < N) p.delta[(long long)bh * N + row] = sum;
    }
  }
  __syncthreads();
  float lse_r[4], dl_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    lse_r[i] = row < N ? p.lse[(long long)bh * N + row] : 0.f;
    dl_r[i] = dls[tr + 16 * i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += BM) {
    __syncthreads();
    load_tile<T, D>(Ks, k, p.sk.n, k0, N);
    load_tile<T, D>(Vs, v, p.sv.n, k0, N);
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr + 16 * i) * LD + d];
        gv[i] = Gs[(tr + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tc + 8 * j) * LD + d];
        vv[j] = Vs[(tc + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sv = k0 + tc + 8 * j < vl ? p.scale * s[i][j] : NEG;
        const float pij = expf(sv - lse_r[i]);
        Ds[(tr + 16 * i) * LDP + tc + 8 * j] = pij * (dp[i][j] - dl_r[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BM; ++j) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(tr + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * LD + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }
  T* dq = static_cast<T*>(p.dq) + (long long)b * N * p.H * D + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= N) continue;
    T* drow = dq + (long long)row * p.H * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) drow[tc + 8 * c] = cvt<T>(p.scale * acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int LD = D + 1, DC = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BM * LD;
  float* Qs = Vs + BM * LD;
  float* Gs = Qs + BM * LD;   // do
  float* Pt = Gs + BM * LD;   // p^T tile: [key][query]
  float* St = Pt + BM * LDP;  // ds^T tile
  float* lses = St + BM * LDP;
  float* dls = lses + BM;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.y * BM, N = p.N;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int vl = valid_keys(p.valid, p.valid_len, N);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* g = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  load_tile<T, D>(Ks, k, p.sk.n, k0, N);
  load_tile<T, D>(Vs, v, p.sv.n, k0, N);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int q0 = 0; q0 < N; q0 += BM) {
    __syncthreads();
    load_tile<T, D>(Qs, q, p.sq.n, q0, N);
    load_tile<T, D>(Gs, g, p.sdo.n, q0, N);
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const int row = q0 + r;
      lses[r] = row < N ? p.lse[(long long)bh * N + row] : 0.f;
      dls[r] = row < N ? p.delta[(long long)bh * N + row] : 0.f;
    }
    __syncthreads();
    // Score tile transposed: keys tr + 16i, queries tc + 8j.
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[8], gv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(tr + 16 * i) * LD + d];
        vv[i] = Vs[(tr + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = Qs[(tc + 8 * j) * LD + d];
        gv[j] = Gs[(tc + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool key_ok = k0 + tr + 16 * i < vl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const float sv = key_ok ? p.scale * s[i][j] : NEG;
        const float pij = q0 + c < N ? expf(sv - lses[c]) : 0.f;
        Pt[(tr + 16 * i) * LDP + c] = pij;
        St[(tr + 16 * i) * LDP + c] = pij * (dp[i][j] - dls[c]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float pv[4], sv[4], qv[DC], gv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(tr + 16 * i) * LDP + r];
        sv[i] = St[(tr + 16 * i) * LDP + r];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = Qs[r * LD + tc + 8 * c];
        gv[c] = Gs[r * LD + tc + 8 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
        }
    }
  }
  const long long off = (long long)b * N * p.H * D + h * D;
  T* dkp = static_cast<T*>(p.dk) + off;
  T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr + 16 * i;
    if (row >= N) continue;
    const long long r = (long long)row * p.H * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkp[r + tc + 8 * c] = cvt<T>(p.scale * dk[i][c]);
      dvp[r + tc + 8 * c] = cvt<T>(dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t fwd_smem() { return sizeof(float) * (3 * BM * (D + 1) + BM * LDP); }
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BM * (D + 1) + BM * LDP + BM);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * BM * (D + 1) + 2 * BM * LDP + 2 * BM);
}

// Launch one instantiation on its grid: (b*h, row tiles), 128 threads, with
// the dynamic shared memory it needs (above the 48 KB default from D = 64).
template <typename Kernel, typename Params>
int launch(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.N + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_dispatch(const FwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch(flash_fwd_kernel<T, 16>, fwd_smem<16>(), p, s);
    case 32: return launch(flash_fwd_kernel<T, 32>, fwd_smem<32>(), p, s);
    case 64: return launch(flash_fwd_kernel<T, 64>, fwd_smem<64>(), p, s);
    case 128: return launch(flash_fwd_kernel<T, 128>, fwd_smem<128>(), p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dq_dispatch(const BwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch(flash_bwd_dq_kernel<T, 16>, dq_smem<16>(), p, s);
    case 32: return launch(flash_bwd_dq_kernel<T, 32>, dq_smem<32>(), p, s);
    case 64: return launch(flash_bwd_dq_kernel<T, 64>, dq_smem<64>(), p, s);
    case 128: return launch(flash_bwd_dq_kernel<T, 128>, dq_smem<128>(), p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dkv_dispatch(const BwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch(flash_bwd_dkv_kernel<T, 16>, dkv_smem<16>(), p, s);
    case 32: return launch(flash_bwd_dkv_kernel<T, 32>, dkv_smem<32>(), p, s);
    case 64: return launch(flash_bwd_dkv_kernel<T, 64>, dkv_smem<64>(), p, s);
    case 128:
      return launch(flash_bwd_dkv_kernel<T, 128>, dkv_smem<128>(), p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

bool bad_shape(int B, int N, int H, int dtype) {
  return B <= 0 || N <= 0 || H <= 0 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 when it was accepted),
// allocates nothing and does not synchronise: the caller owns every buffer
// and the stream.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do and the
// gradients share it; lse and delta are float32).  strides holds
// (batch, token, head) element strides per tensor, in the order named.
// valid may be null; then valid_len keys are valid.

// strides: q, k, v.
extern "C" int tpuic_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const long long* strides,
                               const void* valid, int valid_len, int B, int N,
                               int H, int D, int dtype, float scale,
                               float sentinel, void* stream) {
  if (bad_shape(B, N, H, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{q, k, v, o, static_cast<float*>(lse), strides_at(strides, 0),
              strides_at(strides, 1), strides_at(strides, 2),
              static_cast<const int*>(valid), valid_len, B, N, H, scale,
              sentinel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fwd_dispatch<float>(p, D, s)
                    : fwd_dispatch<__nv_bfloat16>(p, D, s);
}

// strides: q, k, v, o, do.  Writes dq and delta.
extern "C" int tpuic_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  const long long* strides, const void* valid,
                                  int valid_len, int B, int N, int H, int D,
                                  int dtype, float scale, void* stream) {
  if (bad_shape(B, N, H, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),
              static_cast<float*>(delta), dq, nullptr, nullptr,
              strides_at(strides, 0), strides_at(strides, 1),
              strides_at(strides, 2), strides_at(strides, 3),
              strides_at(strides, 4), static_cast<const int*>(valid),
              valid_len, B, N, H, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dq_dispatch<float>(p, D, s)
                    : dq_dispatch<__nv_bfloat16>(p, D, s);
}

// strides: q, k, v, do.  Reads the delta the dq kernel wrote.
extern "C" int tpuic_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv,
                                   const long long* strides,
                                   const void* valid, int valid_len, int B,
                                   int N, int H, int D, int dtype, float scale,
                                   void* stream) {
  if (bad_shape(B, N, H, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides none{0, 0, 0};
  BwdParams p{q, k, v, nullptr, dout, static_cast<const float*>(lse),
              const_cast<float*>(static_cast<const float*>(delta)), nullptr,
              dk, dv, strides_at(strides, 0), strides_at(strides, 1),
              strides_at(strides, 2), none, strides_at(strides, 3),
              static_cast<const int*>(valid), valid_len, B, N, H, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dkv_dispatch<float>(p, D, s)
                    : dkv_dispatch<__nv_bfloat16>(p, D, s);
}
