// Flash attention (blockwise online softmax), forward and backward, for
// Hopper (sm_90a), on the tensor cores through mma.sync (mma_frag.cuh holds
// the fragment helpers).
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
// The backward reads lse; it never rebuilds the softmax normaliser.  o and dq
// are owned per q tile and dk/dv per k tile (the reference grids, :287, :457
// and :484), so no atomics are needed, two runs give the same bits, and a
// row's result does not depend on the batch it rides in.
//
// Common design.  One 128-thread block per (b*h, 64-row tile, column half):
// each warp owns 16 rows of the block's tile (query rows in the forward and
// dq, key rows in dk/dv) and loops over the other axis in 32-row stages of
// a two-stage cp.async ring.
//   - float32: 3xTF32.  Every operand is split into hi = rna(a) and lo =
//     rna(a - hi), rounded to TF32 as cvt.rna.tf32.f32 rounds but with an
//     integer add and mask (the conversion instruction issues at a
//     sixteenth of the integer rate), and each m16n8k8 step issues lo*hi,
//     hi*lo, then hi*hi (lo*lo dropped): float32 accuracy, whatever
//     torch's allow_tf32 says (the kernels read no flag).
//   - bfloat16: m16n8k16 bf16 MMAs; p (and ds) round to bf16 before the
//     second product, as the reference casts them (_f32_for).
//   - The rows a block loops over come in 32 at a time through 16-byte
//     cp.async.cg (4-byte for lse/delta): stage i+1 loads while stage i
//     multiplies.  Rows past N are zero-filled by the src-size operand, so
//     nothing past the sequence is read.  q/k/v/o/do must be 16-byte
//     aligned with strides that keep every row so (the wrappers copy a
//     tensor that is not).
//   - Shared tiles are rows of 32-bit words with a row stride of D words +
//     16 bytes (4 mod 8 words): whole 16-byte chunks for cp.async and
//     ldmatrix, fragment reads and ldmatrix phases free of bank conflicts
//     by construction (ncu does not run where these kernels were measured,
//     so it is not checked), and every fragment address a base plus a
//     constant, which an XOR swizzle does not give (mma_frag.cuh).
//   - A product's second operand comes from the first one's C fragments in
//     registers: a permuted contraction index makes the C layout the tf32 A
//     layout (accumulate_tf32); two bf16-rounded C tiles are one bf16 A.
//   - Ragged extent: a warp whose 16 rows lie wholly past N skips its MMAs,
//     and the inner loop stops at the last 8-row (tf32) or 16-row (bf16)
//     group that holds a row below N: at N = 197 the inner extent is 200,
//     not 256.  Full stages run a copy of the stage's code with the group
//     count a constant, with no branch between the MMAs; only the ragged
//     last stage checks each group.
//   - Registers: D = 128 splits the output columns over two blocks
//     (grid.z), each redoing the scores, so that no thread holds more than
//     64 accumulators and 32 score values, and ptxas spills nothing.
//
// Forward.  Per stage a warp computes S = Q K^T for its 16 rows against the
// stage's 32 keys, rescales the scores to log2 units (scale * log2 e, so p
// = exp2(s - m)), runs the online softmax in registers (a row of the C
// fragment lies across the 4 lanes of a quad: row max and row sum take two
// xor shuffles each; m and l stay in registers for the whole key loop), and
// accumulates O += P V with P fed from the S fragments.  In bf16 the
// warp's Q fragments are loaded once per block and held in registers over
// the key loop; in float32 they are read and split per stage (FwdTile
// says why).  The key loop stops at valid: every row masks the keys past
// it, so they add nothing; only the last stage masks.  52 KB of shared
// memory a block at D = 64 in float32, four blocks an SM.
// What bounds the forward on an H100: at [64, 197, 12, 64] float32 it needs
// 4*B*H*N^2*D = 7.63 GFLOP, in 3xTF32 3 x 7.63 G over the 495 TFLOP/s TF32
// peak = 0.046 ms (0.049 ms with the 200/197 key extent and 208/197 query
// rows), against 4 [B, N, H, D] tensors, 155 MB, in 0.046 ms at 3.35
// TB/s: operations and bytes are even.  It takes 0.218 ms on an H100 SXM
// at 700 W (flash_attention_bench), and more warps an SM made it faster
// (four blocks against three: 0.218 against 0.231 ms), so latency rather
// than the MMA rate holds it: each 3xTF32 step waits on shared-memory
// reads and five integer operations per split operand beside its three
// MMAs.  The last q tile of each (b, h) holds 5 of 64 rows at N = 197, so
// one block in four runs one busy warp.
// What bounds the backward: at [64, 197, 12, 64] float32 each kernel needs
// 5*B*H*N^2*D = 9.54 GFLOP, in 3xTF32 3 x 9.54 G over the 495 TFLOP/s TF32
// peak = 0.058 ms (0.075 ms with the 200/197 and 64-row tile padding), and
// moves six [B, N, H, D] tensors, 232 MB, in 0.069 ms at 3.35 TB/s: the
// two bounds are close, bytes slightly ahead.  In practice the instruction
// issue rate bounds it: the hi/lo splits are about half of the
// instructions a stage issues.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int BM = 64;          // rows of every q, k and v tile
constexpr int THREADS = 128;
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

__device__ __forceinline__ int valid_keys(const int* valid, int valid_len,
                                          int N) {
  const int vl = valid ? *valid : valid_len;
  return min(max(vl, 0), N);
}

// Every kernel loops over the other axis in stages of SUB rows, through a
// two-stage cp.async ring: small stages keep a block's shared memory at 68
// KB or less (three backward or four forward blocks an SM at D = 64 in
// float32) and the score fragments of a stage at 16 registers a product.
constexpr int SUB = 32;
constexpr float LOG2E = 1.4426950408889634f;  // p = 2^((s - lse) log2 e)

// The kernels' shared tiles: rows of KW 32-bit words (D floats or D
// bf16), row stride RS = KW + 4 (mma_frag.cuh says why).  A block
// writes DO output columns; D = 128 takes two blocks (grid.z).
template <typename T, int D>
struct Tile {
  static constexpr int KW = D * static_cast<int>(sizeof(T)) / 4;
  static constexpr int RS = KW + 4;
  static constexpr int OWN = BM * RS;     // words of the block's own tile
  static constexpr int STAGE = SUB * RS;  // words of a ring stage
  static constexpr int DO = D < 64 ? D : 64;
  static constexpr int NO = DO / 8;   // 8-column output tiles a warp
  static constexpr int NT = SUB / 8;  // 8-row groups of a stage
  // Blocks an SM the backward kernels should hold: three up to D = 64 (68
  // KB of shared memory or less each; ptxas keeps to 168 registers a
  // thread for it), one at D = 128 (132 KB in float32).  The forward's
  // are FwdTile's.
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;
};

// The 8-row groups of the stage at r0 that the products run over: up to
// the last one holding a row below n, rounded up to the MMA's contraction
// step (8 rows in tf32, 16 in bf16).  Rows past n are zero-filled.
template <typename T>
__device__ __forceinline__ int groups(int r0, int n) {
  constexpr int step = sizeof(T) == 4 ? 8 : 16;
  const int rows = min(SUB, n - r0);
  return (rows + step - 1) / step * (step / 8);
}

// s = A1 . B1^T and dp = A2 . B2^T for the warp's 16 rows (a0) against the
// stage's first 8*nt rows.
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[SUB / 8][4],
                                       const uint32_t* A1, const uint32_t* B1,
                                       float (&dp)[SUB / 8][4],
                                       const uint32_t* A2, const uint32_t* B2,
                                       int a0, int nt) {
  using L = Tile<T, D>;
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  if constexpr (sizeof(T) == 4)
    frag::scores_tf32<L::KW, L::RS, L::NT>(s, A1, B1, dp, A2, B2, a0, nt);
  else
    frag::scores_bf16<L::KW, L::RS, L::NT>(s, A1, B1, dp, A2, B2, a0, nt);
}

template <typename T, int D>
__device__ __forceinline__ void accumulate(
    float (&out)[Tile<T, D>::NO][4], const float (&P)[SUB / 8][4],
    const uint32_t* Xs, int col0, int nt) {
  using L = Tile<T, D>;
  if constexpr (sizeof(T) == 4)
    frag::accumulate_tf32<L::RS, L::NT, L::NO>(out, P, Xs, col0, nt);
  else
    frag::accumulate_bf16<L::RS, L::NT, L::NO>(out, P, Xs, col0, nt);
}

// The dot product of two 16-byte pieces of rows, in float32.
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 w = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    sum = fmaf(u.x, w.x, fmaf(u.y, w.y, sum));
  }
  return sum;
}

// ROWS rows from r0 of one (b, h) slice into a tile, by cp.async.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_async(uint32_t* dst, const T* base,
                                           long long sn, int r0, int N) {
  frag::load_tile_async<T, D, Tile<T, D>::RS, ROWS, THREADS>(dst, base, sn,
                                                                r0, N);
}

// One dq stage: keys k0 .. k0 + SUB.  FULL (every group below N) passes the
// group count as a constant, so the products compile to straight-line code.
template <typename T, int D, bool FULL>
__device__ __forceinline__ void dq_stage(
    float (&acc)[Tile<T, D>::NO][4], const uint32_t* Qs,
    const uint32_t* Gs, const uint32_t* Kt, const uint32_t* Vt, int r0,
    int k0, int nt_part, int vl, float scale, const float (&lse_r)[2],
    const float (&dl_r)[2], int col0) {
  using L = Tile<T, D>;
  const int nt = FULL ? L::NT : nt_part, t = threadIdx.x & 3;
  float s[L::NT][4], dp[L::NT][4];
  scores<T, D>(s, Qs, Kt, dp, Gs, Vt, r0, nt);
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      const float sv = key < vl ? scale * s[j][e] : NEG;
      const float pij = exp2f((sv - lse_r[e >> 1]) * LOG2E);
      s[j][e] = pij * (dp[j][e] - dl_r[e >> 1]);  // ds
    }
  accumulate<T, D>(acc, s, Kt, col0, nt);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Tile<T, D>::MIN_BLOCKS)
    flash_bwd_dq_kernel(BwdParams p) {
  using L = Tile<T, D>;
  extern __shared__ __align__(16) uint32_t bsm[];
  uint32_t* Qs = bsm;
  uint32_t* Gs = Qs + L::OWN;      // do
  uint32_t* Ks = Gs + L::OWN;      // two stages
  uint32_t* Vs = Ks + 2 * L::STAGE;  // two stages
  float* dls = reinterpret_cast<float*>(Vs + 2 * L::STAGE);
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * BM, col0 = blockIdx.z * L::DO, N = p.N;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's rows of the tile
  const int vl = valid_keys(p.valid, p.valid_len, N);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h;
  const T* gr = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  load_async<T, D, BM>(Qs, q, p.sq.n, q0, N);
  load_async<T, D, BM>(Gs, gr, p.sdo.n, q0, N);
  load_async<T, D, SUB>(Ks, k, p.sk.n, 0, N);
  load_async<T, D, SUB>(Vs, v, p.sv.n, 0, N);
  frag::cp_async_commit();
  {
    // Prologue, while the copies fly: delta = rowsum(do * o) from 16-byte
    // loads, the CPR lanes of a row adjacent, then a shuffle sum over them.
    constexpr int CPR = D * static_cast<int>(sizeof(T)) / 16;
    constexpr int EPC = 16 / static_cast<int>(sizeof(T));
    for (int idx = threadIdx.x; idx < BM * CPR; idx += THREADS) {
      const int r = idx / CPR, c = idx - r * CPR, row = q0 + r;
      float sum = 0.f;
      if (row < N)
        sum = dot16(o + row * p.so.n + c * EPC, gr + row * p.sdo.n + c * EPC);
#pragma unroll
      for (int off = CPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (c == 0) {
        dls[r] = sum;
        if (row < N && blockIdx.z == 0)
          p.delta[(long long)bh * N + row] = sum;
      }
    }
  }
  __syncthreads();
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    lse_r[i] = row < N ? p.lse[(long long)bh * N + row] : 0.f;
    dl_r[i] = dls[r0 + g + 8 * i];
  }
  float acc[L::NO][4];
#pragma unroll
  for (int c = 0; c < L::NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const bool active = q0 + r0 < N;
  const int stages = (N + SUB - 1) / SUB;
  for (int it = 0; it < stages; ++it) {
    frag::cp_async_wait<0>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + 1 < stages) {
      const int st = (it + 1) & 1;
      load_async<T, D, SUB>(Ks + st * L::STAGE, k, p.sk.n, (it + 1) * SUB, N);
      load_async<T, D, SUB>(Vs + st * L::STAGE, v, p.sv.n, (it + 1) * SUB, N);
    }
    frag::cp_async_commit();
    if (!active) continue;
    const int k0 = it * SUB, nt = groups<T>(k0, N);
    const uint32_t* Kt = Ks + (it & 1) * L::STAGE;
    const uint32_t* Vt = Vs + (it & 1) * L::STAGE;
    if (nt == L::NT)
      dq_stage<T, D, true>(acc, Qs, Gs, Kt, Vt, r0, k0, nt, vl, p.scale,
                           lse_r, dl_r, col0);
    else
      dq_stage<T, D, false>(acc, Qs, Gs, Kt, Vt, r0, k0, nt, vl, p.scale,
                            lse_r, dl_r, col0);
  }
  if (!active) return;
  const int t = lane & 3;
  T* dq = static_cast<T*>(p.dq) + (long long)b * N * p.H * D + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= N) continue;
    T* drow = dq + (long long)row * p.H * D + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < L::NO; ++c)
      frag::store_pair(drow + 8 * c, p.scale * acc[c][2 * i],
                       p.scale * acc[c][2 * i + 1]);
  }
}

// One dk/dv stage: queries of the stage tiles Qt/Gt (lse lt, delta dt).
template <typename T, int D, bool FULL>
__device__ __forceinline__ void dkv_stage(
    float (&dk)[Tile<T, D>::NO][4], float (&dv)[Tile<T, D>::NO][4],
    const uint32_t* Ks, const uint32_t* Vs, const uint32_t* Qt,
    const uint32_t* Gt, const float* lt, const float* dt, int r0,
    int nt_part, const bool (&key_ok)[2], float scale, int col0) {
  using L = Tile<T, D>;
  const int nt = FULL ? L::NT : nt_part, t = threadIdx.x & 3;
  // Transposed scores: the warp's keys by the stage's queries.
  float s[L::NT][4], dp[L::NT][4];
  scores<T, D>(s, Ks, Qt, dp, Vs, Gt, r0, nt);
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const float sv = key_ok[e >> 1] ? scale * s[j][e] : NEG;
      const float pij = exp2f((sv - lt[c]) * LOG2E);
      s[j][e] = pij;                        // p^T
      dp[j][e] = pij * (dp[j][e] - dt[c]);  // ds^T
    }
  accumulate<T, D>(dv, s, Gt, col0, nt);
  accumulate<T, D>(dk, dp, Qt, col0, nt);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Tile<T, D>::MIN_BLOCKS)
    flash_bwd_dkv_kernel(BwdParams p) {
  using L = Tile<T, D>;
  extern __shared__ __align__(16) uint32_t bsm[];
  uint32_t* Ks = bsm;
  uint32_t* Vs = Ks + L::OWN;
  uint32_t* Qs = Vs + L::OWN;        // two stages
  uint32_t* Gs = Qs + 2 * L::STAGE;  // do, two stages
  float* lses = reinterpret_cast<float*>(Gs + 2 * L::STAGE);  // two stages
  float* dls = lses + 2 * SUB;                                // two stages
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.y * BM, col0 = blockIdx.z * L::DO, N = p.N;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's keys of the tile
  const int vl = valid_keys(p.valid, p.valid_len, N);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* gr = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;
  // Stage st <- queries q0 .. q0 + SUB: q, do, lse and delta, zero past N.
  auto load_stage = [&](int st, int q0) {
    load_async<T, D, SUB>(Qs + st * L::STAGE, q, p.sq.n, q0, N);
    load_async<T, D, SUB>(Gs + st * L::STAGE, gr, p.sdo.n, q0, N);
    for (int r = threadIdx.x; r < SUB; r += THREADS) {
      const int row = q0 + r;
      const bool ok = row < N;
      frag::cp_async4(frag::smem_addr(lses + st * SUB + r),
                      lse + (ok ? row : 0), ok);
      frag::cp_async4(frag::smem_addr(dls + st * SUB + r),
                      delta + (ok ? row : 0), ok);
    }
  };
  load_async<T, D, BM>(Ks, k, p.sk.n, k0, N);
  load_async<T, D, BM>(Vs, v, p.sv.n, k0, N);
  load_stage(0, 0);
  frag::cp_async_commit();
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = k0 + r0 + g + 8 * i < vl;
  float dk[L::NO][4], dv[L::NO][4];
#pragma unroll
  for (int c = 0; c < L::NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;
  const bool active = k0 + r0 < N;
  const int stages = (N + SUB - 1) / SUB;
  for (int it = 0; it < stages; ++it) {
    frag::cp_async_wait<0>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + 1 < stages) load_stage((it + 1) & 1, (it + 1) * SUB);
    frag::cp_async_commit();
    if (!active) continue;
    const int st = it & 1, nt = groups<T>(it * SUB, N);
    const uint32_t* Qt = Qs + st * L::STAGE;
    const uint32_t* Gt = Gs + st * L::STAGE;
    if (nt == L::NT)
      dkv_stage<T, D, true>(dk, dv, Ks, Vs, Qt, Gt, lses + st * SUB,
                            dls + st * SUB, r0, nt, key_ok, p.scale, col0);
    else
      dkv_stage<T, D, false>(dk, dv, Ks, Vs, Qt, Gt, lses + st * SUB,
                             dls + st * SUB, r0, nt, key_ok, p.scale, col0);
  }
  if (!active) return;
  const int t = lane & 3;
  const long long off = (long long)b * N * p.H * D + h * D + col0 + 2 * t;
  T* dkp = static_cast<T*>(p.dk) + off;
  T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row >= N) continue;
    const long long r = (long long)row * p.H * D;
#pragma unroll
    for (int c = 0; c < L::NO; ++c) {
      frag::store_pair(dkp + r + 8 * c, p.scale * dk[c][2 * i],
                       p.scale * dk[c][2 * i + 1]);
      frag::store_pair(dvp + r + 8 * c, dv[c][2 * i], dv[c][2 * i + 1]);
    }
  }
}

// The forward's choices on top of Tile.  In bf16 the warp keeps its Q
// fragments in registers for the whole key loop (16 registers at D = 64);
// in float32 it reads and splits them from shared memory in every stage.
// Holding float32's hi/lo fragments takes 64 registers more at D = 64: two
// blocks an SM (at three, ptxas spills), which measured slower than
// splitting per stage (flash_attention_bench).  Without them a thread
// needs 125 registers at D = 64 in float32, so up to D = 64 four blocks
// share an SM (128 registers a thread, 52 KB of shared memory each).
template <typename T, int D>
struct FwdTile {
  static constexpr int KS = Tile<T, D>::KW / 8;  // contraction steps over D
  static constexpr bool QREG = sizeof(T) == 2;
  static constexpr int QF = QREG ? KS : 1;
  static constexpr int MIN_BLOCKS = D <= 64 ? 4 : 1;
};

constexpr float LN2 = 0.6931471805599453f;

// One forward stage: the warp's rows (r0) against keys k0 .. k0 + SUB.
// FULL (every key of the stage below kn) passes the group count as a
// constant and masks nothing; the ragged last stage masks keys at or past
// kn.  m and l are the running row max (log2 units) and row sum of rows g
// and g + 8; acc the output columns col0 .. col0 + DO.
template <typename T, int D, bool FULL>
__device__ __forceinline__ void fwd_stage(
    float (&acc)[Tile<T, D>::NO][4], float (&m)[2], float (&l)[2],
    const uint32_t (&qh)[FwdTile<T, D>::QF][4],
    const uint32_t (&ql)[FwdTile<T, D>::QF][4], const uint32_t* Qs,
    const uint32_t* Kt, const uint32_t* Vt, int r0, int k0, int nt_part,
    int kn, float scale_log2, int col0) {
  using L = Tile<T, D>;
  using F = FwdTile<T, D>;
  const int nt = FULL ? L::NT : nt_part, t = threadIdx.x & 3;
  float s[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < F::KS; ++kk) {
    uint32_t ah[4], al[4];
    if constexpr (F::QREG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = qh[kk][i];
        al[i] = ql[kk][i];
      }
    } else {
      frag::load_a<T, L::RS>(ah, al, Qs, r0, kk);
    }
    frag::scores_step<T, L::RS, L::NT>(s, ah, al, Kt, kk, nt);
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      const float sv = (FULL || key < kn) ? s[j][e] * scale_log2 : NEG;
      s[j][e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(s[j][e] - m[e >> 1]);
      s[j][e] = pe;
      rs[e >> 1] += pe;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
#pragma unroll
  for (int c = 0; c < L::NO; ++c) {
    acc[c][0] *= alpha[0];
    acc[c][1] *= alpha[0];
    acc[c][2] *= alpha[1];
    acc[c][3] *= alpha[1];
  }
  accumulate<T, D>(acc, s, Vt, col0, nt);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, FwdTile<T, D>::MIN_BLOCKS)
    flash_fwd_kernel(FwdParams p) {
  using L = Tile<T, D>;
  using F = FwdTile<T, D>;
  extern __shared__ __align__(16) uint32_t fsm[];
  uint32_t* Qs = fsm;
  uint32_t* Ks = Qs + L::OWN;        // two stages
  uint32_t* Vs = Ks + 2 * L::STAGE;  // two stages
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * BM, col0 = blockIdx.z * L::DO, N = p.N;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's rows of the tile
  // Keys at or past valid are masked in every row: the loop stops there.
  const int kn = valid_keys(p.valid, p.valid_len, N);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  load_async<T, D, BM>(Qs, q, p.sq.n, q0, N);
  load_async<T, D, SUB>(Ks, k, p.sk.n, 0, kn);
  load_async<T, D, SUB>(Vs, v, p.sv.n, 0, kn);
  frag::cp_async_commit();
  frag::cp_async_wait<0>();
  __syncthreads();  // Q and stage 0 have landed
  uint32_t qh[F::QF][4], ql[F::QF][4];
  if constexpr (F::QREG) {
#pragma unroll
    for (int kk = 0; kk < F::KS; ++kk)
      frag::load_a<T, L::RS>(qh[kk], ql[kk], Qs, r0, kk);
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[L::NO][4];
#pragma unroll
  for (int c = 0; c < L::NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const bool active = q0 + r0 < N;
  const float scale_log2 = p.scale * LOG2E;
  const int stages = (kn + SUB - 1) / SUB;
  for (int it = 0; it < stages; ++it) {
    if (it > 0) {
      frag::cp_async_wait<0>();
      __syncthreads();  // stage it has landed; stage it - 1 is consumed
    }
    if (it + 1 < stages) {
      const int st = (it + 1) & 1;
      load_async<T, D, SUB>(Ks + st * L::STAGE, k, p.sk.n, (it + 1) * SUB,
                            kn);
      load_async<T, D, SUB>(Vs + st * L::STAGE, v, p.sv.n, (it + 1) * SUB,
                            kn);
    }
    frag::cp_async_commit();
    if (!active) continue;
    const int k0 = it * SUB;
    const uint32_t* Kt = Ks + (it & 1) * L::STAGE;
    const uint32_t* Vt = Vs + (it & 1) * L::STAGE;
    if (k0 + SUB <= kn)
      fwd_stage<T, D, true>(acc, m, l, qh, ql, Qs, Kt, Vt, r0, k0, L::NT, kn,
                            scale_log2, col0);
    else
      fwd_stage<T, D, false>(acc, m, l, qh, ql, Qs, Kt, Vt, r0, k0,
                             groups<T>(k0, kn), kn, scale_log2, col0);
  }
  if (!active) return;
  T* o = static_cast<T*>(p.o) + (long long)b * N * p.H * D + h * D + col0 +
         2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= N) continue;
    const bool masked = m[i] <= NEG * 0.5f;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (long long)row * p.H * D;
#pragma unroll
    for (int c = 0; c < L::NO; ++c)
      frag::store_pair(orow + 8 * c, masked ? 0.f : acc[c][2 * i] / lc,
                       masked ? 0.f : acc[c][2 * i + 1] / lc);
    if (blockIdx.z == 0 && t == 0)
      p.lse[(long long)bh * N + row] =
          masked ? p.sentinel : m[i] * LN2 + logf(lc);
  }
}

// The forward: the block's q tile and two two-stage rings (k, v).
template <typename T, int D>
constexpr size_t fwd_smem() {
  return sizeof(uint32_t) * (Tile<T, D>::OWN + 4 * Tile<T, D>::STAGE);
}
// Both backward kernels: two own tiles, two two-stage rings, and per-row
// floats (delta of the own rows in dq; lse and delta, two stages, in
// dk/dv).
template <typename T, int D>
constexpr size_t bwd_smem(int row_floats) {
  using L = Tile<T, D>;
  return sizeof(uint32_t) * (2 * L::OWN + 4 * L::STAGE) +
         sizeof(float) * row_floats;
}

// Launch one instantiation on its grid: (b*h, row tiles, column splits),
// 128 threads, with the dynamic shared memory it needs (above the 48 KB
// default for most instantiations).
template <typename Kernel, typename Params>
int launch(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream,
           int splits = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.N + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fwd(const FwdParams& p, cudaStream_t s) {
  return launch(flash_fwd_kernel<T, D>, fwd_smem<T, D>(), p, s,
                D / Tile<T, D>::DO);
}

template <typename T>
int fwd_dispatch(const FwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_fwd<T, 16>(p, s);
    case 32: return launch_fwd<T, 32>(p, s);
    case 64: return launch_fwd<T, 64>(p, s);
    case 128: return launch_fwd<T, 128>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int launch_dq(const BwdParams& p, cudaStream_t s) {
  return launch(flash_bwd_dq_kernel<T, D>, bwd_smem<T, D>(BM), p, s,
                D / Tile<T, D>::DO);
}

template <typename T, int D>
int launch_dkv(const BwdParams& p, cudaStream_t s) {
  return launch(flash_bwd_dkv_kernel<T, D>, bwd_smem<T, D>(4 * SUB), p, s,
                D / Tile<T, D>::DO);
}

template <typename T>
int dq_dispatch(const BwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dq<T, 16>(p, s);
    case 32: return launch_dq<T, 32>(p, s);
    case 64: return launch_dq<T, 64>(p, s);
    case 128: return launch_dq<T, 128>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dkv_dispatch(const BwdParams& p, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dkv<T, 16>(p, s);
    case 32: return launch_dkv<T, 32>(p, s);
    case 64: return launch_dkv<T, 64>(p, s);
    case 128: return launch_dkv<T, 128>(p, s);
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
