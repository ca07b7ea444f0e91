// Fused convolution + folded-BN affine + optional ReLU for bfloat16
// activations, for Hopper (sm_90a): an implicit GEMM on wgmma.
//
// Replaces, for bf16 x with Cin and Cout multiples of 64 (every ResNet-50
// conv but the stem), the TPU kernel tpuic/kernels/conv_bn_relu.py:_kernel
// (pallas_call in _fused), as conv_bn_relu.cu's mma.sync kernel still does
// for float32 x and for the other shapes.  It computes the same function:
//
//     out[b, oh, ow, co] = act(sum_{ki,kj,ci} x[b, oh*sh-pt+ki, ow*sw-pl+kj, ci]
//                                * w[ki, kj, ci, co] * scale[co] + bias[co])
//
// with float32 w (the reference's jnp.dot promotes bf16 x to w's float32),
// taps outside the image reading as zero, float32 accumulation and one
// bf16 write of the output.  w comes as bf16 parts, w = hi + lo: a
// bf16-valued w (the serve ladder's bf16 rung folds bf16 weights) is its
// hi alone, and the wrapper splits any other float32 w into hi = rn(w) and
// lo = rn(w - hi), which keep 16 bits of it: x is exact in bf16, so a
// product errs by 2^-17 of itself.
//
// Design.  Output M x N with M = B*Ho*Wo pixels and N = Cout; K runs over
// (tap, 64-channel chunk) stages of 64 K values, so a stage's A rows are
// 128-byte runs of one pixel's channels at one tap.
// - A block of two warpgroups owns 128 pixels x 128 output channels (64
//   where a grid of 128-channel blocks would leave the card short of two
//   blocks an SM, and for a Cout of 64); each warpgroup 64 pixels, as one
//   m64n64 wgmma tile a 64-channel half, 64 float32 accumulators a
//   thread.
// - A tile (128 pixels x 64 channels, bf16): gathered from NHWC by
//   cp.async, 16 bytes a copy, into wgmma's 128-byte swizzle (chunk c of
//   row r at c ^ (r % 8)); taps in the padding and rows past M zero-filled
//   by src-size 0.  Each pixel's window origin and image offset are
//   computed once per block.
// - B (64 input channels x 128 output channels of one tap, bf16): w's
//   HWIO rows copied by cp.async, 16 bytes a copy, into the 128-byte
//   swizzle as two MN-major tiles of 64 output channels; lo the same when
//   given (a build of its own, LO: the ring of the other has no lo tiles).
//   Each 16-deep step is one wgmma a half against hi, and one against lo.
// - A ring of three stages: the copies of stages s + 1 and s + 2 are in
//   flight while stage s multiplies.
// - Split-K, as conv_bn_relu.cu: for the shapes whose grid would leave the
//   card short of two blocks an SM, grid.z slices of whole stages; each
//   slice writes its float32 partial tile to a workspace, a per-tile
//   counter taken with an atomic finds the last slice to arrive, and it
//   sums the partials in slice order 0..S-1, applies the epilogue, writes
//   once and resets the counter.  The block width and slice count come
//   from the shape at a nominal batch of 32, the engine's largest bucket
//   (kernels/conv_bn_relu.py:plan_sm90), where a partial tile round trip
//   costs more than the slices win: a row's bits do not depend on the
//   batch it rides in.
// - Epilogue: accumulators times scale plus bias, the ReLU, paired bf16
//   stores, masked on the ragged M edge.
// 97 KB of shared memory a block (145 KB with lo tiles), two blocks an SM
// (one with lo).
//
// What bounds it: for a ResNet-50 forward at batch 8 or more, the
// operations at the bf16 rate (one product each for a bf16-valued w, two
// for a split float32 w); the 1x1 convs at 56x56 by their activations'
// bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // pixels a block: two warpgroups of 64
constexpr int BN = 128;        // output channels a block: two halves of 64
constexpr int BK = 64;         // K values a stage: 64 channels of one tap
constexpr int THREADS = 256;
constexpr int RING = 3;
constexpr int A_BYTES = BM * BK * 2;      // 16 KB, 128-byte rows
constexpr int H_BYTES = BK * 64 * 2;      // 8 KB: one half of a B tile
constexpr int NACC = 32;                  // accumulators of one half
template <bool LO>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + (LO ? 4 : 2) * H_BYTES;
}
// Stages (each A, hi and lo halves; 1024-aligned), row facts, alignment.
template <bool LO>
__host__ __device__ constexpr int smem_bytes() {
  return RING * stage_bytes<LO>() + 3 * BM * 4 + 1024;
}

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo, SH, SW, PT, PL, relu;
};

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* whi;
  const __nv_bfloat16* wlo;  // null: w is its hi part
  const float* scale;
  const float* bias;
  __nv_bfloat16* out;
  float* ws;       // split-K partial tiles (splits > 1)
  int* counters;   // one per output tile, zero between launches
  Shape s;
  int M, stages, splits, per;  // per: stages a slice
  int nb;                      // output channels a block: 64 or 128
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async) made visible to
// wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  // 128-byte swizzle; 8-row groups 1024 bytes apart; the leading offset is
  // unused (K-major A, and MN-major B tiles of one 64-column atom).
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void reg_fence(float (&r)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d += A B for a 64 x 64 x 16 step: A (pixels x channels) K-major, B
// (channels x output channels) MN-major, both in shared memory.
__device__ __forceinline__ void wgmma_tn(float (&d)[NACC], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The copies of stage `st` (its tap and 64-channel chunk) into a ring
// slot: the A gather, and w's hi (and lo) rows, `halves` of 64 output
// channels, into MN-major tiles.
template <bool LO>
__device__ __forceinline__ void load_stage(uint8_t* slot, const int* ri,
                                           const Params& p, int st, int n0,
                                           int halves) {
  const Shape& s = p.s;
  const int chunks = s.Cin / BK, tap = st / chunks;
  const int ci0 = (st - tap * chunks) * BK;
  const int ki = tap / s.KW, kj = tap - ki * s.KW;
  const int c = threadIdx.x & 7;  // 16-byte chunk of a 128-byte row
#pragma unroll
  for (int i = 0; i < BM * 8 / THREADS; ++i) {
    const int r = (threadIdx.x >> 3) + i * (THREADS / 8);
    const int ih = ri[r] + ki, iw = ri[BM + r] + kj;
    const bool ok = (unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W;
    const __nv_bfloat16* src =
        ok ? p.x + ri[2 * BM + r] + (ih * s.W + iw) * s.Cin + ci0 + 8 * c
           : p.x;
    cp_async16(smem_u32(slot + r * 128 + ((c ^ (r & 7)) << 4)), src, ok);
  }
  // Row k of half h: input channel ci0 + k, output channels
  // n0 + 64h .. + 63.
  const size_t row0 = ((size_t)tap * s.Cin + ci0) * s.Cout + n0;
  const int k = threadIdx.x >> 3;
  for (int h = 0; h < halves; ++h) {
#pragma unroll
    for (int i = 0; i < BK * 8 / THREADS; ++i) {
      const int kr = k + i * (THREADS / 8);
      const size_t off = row0 + (size_t)kr * s.Cout + 64 * h + 8 * c;
      const int dst = A_BYTES + h * H_BYTES + kr * 128 + ((c ^ (kr & 7)) << 4);
      cp_async16(smem_u32(slot + dst), p.whi + off, true);
      if (LO) cp_async16(smem_u32(slot + dst + 2 * H_BYTES), p.wlo + off, true);
    }
  }
}

template <bool LO>
__global__ void __launch_bounds__(THREADS, LO ? 1 : 2)
    conv_bn_relu_sm90_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t raw[];
  __shared__ int last;
  constexpr int STAGE = stage_bytes<LO>();
  uint8_t* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  int* ri = reinterpret_cast<int*>(ring + RING * STAGE);
  const Shape& s = p.s;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * p.nb, z = blockIdx.z;
  const int halves = p.nb == BN && n0 + 64 < s.Cout ? 2 : 1;
  const int st0 = z * p.per, nst = min(p.per, p.stages - st0);
  // Per pixel of the block: window origin and image offset; rows past M
  // get a row far above the image, so every tap of theirs reads zero.
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = m0 + r;
    int ih0 = -(1 << 28), iw0 = 0, base = 0;
    if (m < p.M) {
      const int ow = m % s.Wo, t = m / s.Wo;
      const int oh = t % s.Ho, b = t / s.Ho;
      ih0 = oh * s.SH - s.PT;
      iw0 = ow * s.SW - s.PL;
      base = b * s.H * s.W * s.Cin;
    }
    ri[r] = ih0;
    ri[BM + r] = iw0;
    ri[2 * BM + r] = base;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < nst) load_stage<LO>(ring + i * STAGE, ri, p, st0 + i, n0, halves);
    cp_async_commit();
  }
  const int wg = threadIdx.x >> 7;
  float acc[2][NACC];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[h][i] = 0.f;
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<RING - 2>();
    fence_async_shared();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    const int nx = it + RING - 1;
    if (nx < nst)
      load_stage<LO>(ring + (nx % RING) * STAGE, ri, p, st0 + nx, n0, halves);
    cp_async_commit();
    const uint32_t base = smem_u32(ring + (it % RING) * STAGE);
    const uint32_t a = base + wg * 64 * 128, b = base + A_BYTES;
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
    // Descriptors advance 32 bytes a 16-deep step along A's rows and 2048
    // bytes (16 rows) along B's.
    const uint64_t da = desc_sw128(a), db = desc_sw128(b);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_tn(acc[0], da + 2 * kk, db + 128 * kk);
      if (LO) wgmma_tn(acc[0], da + 2 * kk, db + (2 * H_BYTES >> 4) + 128 * kk);
    }
    if (halves == 2) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_tn(acc[1], da + 2 * kk, db + (H_BYTES >> 4) + 128 * kk);
        if (LO)
          wgmma_tn(acc[1], da + 2 * kk, db + (3 * H_BYTES >> 4) + 128 * kk);
      }
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
  }
  cp_async_wait<0>();

  if (p.splits > 1) {
    // Partial tiles, [tile][slice][accumulator][thread]: each store and
    // load of a warp is one coalesced row.
    const int tile = blockIdx.x + gridDim.x * blockIdx.y;
    float* ws = p.ws + (size_t)tile * p.splits * 2 * NACC * THREADS +
                threadIdx.x;
    float* part = ws + (size_t)z * 2 * NACC * THREADS;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        part[(h * NACC + i) * THREADS] = acc[h][i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
      if (last) p.counters[tile] = 0;  // zero again for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // The last slice to arrive sums all partials in slice order 0..S-1,
    // whichever slice it is: the same bits on every run.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const float* q = ws + (h * NACC + i) * THREADS;
        float v = __ldcg(q);
        for (int zz = 1; zz < p.splits; ++zz)
          v += __ldcg(q + (size_t)zz * 2 * NACC * THREADS);
        acc[h][i] = v;
      }
  }

  // Accumulator d[4j + e] of half h: row 16w + g + 8 (e >> 1), column
  // 64h + 8j + 2c + (e & 1) of the warpgroup's tile (w its warp, g =
  // lane / 4, c = lane % 4).
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, c = lane & 3, N = s.Cout;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 64 * wg + 16 * warp + g + 8 * i;
    if (m >= p.M) continue;
    __nv_bfloat16* orow = p.out + (size_t)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && halves == 1) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 64 * h + 8 * j + 2 * c;
        float y0 = fmaf(acc[h][4 * j + 2 * i], p.scale[n], p.bias[n]);
        float y1 = fmaf(acc[h][4 * j + 2 * i + 1], p.scale[n + 1],
                        p.bias[n + 1]);
        if (s.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + n) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <bool LO>
int launch(const Params& p, cudaStream_t stream) {
  // Dynamic shared memory above the 48 KB default, allowed once a device.
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(conv_bn_relu_sm90_kernel<LO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<LO>());
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev] = true;
  }
  const dim3 grid((unsigned)((p.M + BM - 1) / BM),
                  (unsigned)((p.s.Cout + p.nb - 1) / p.nb),
                  (unsigned)p.splits);
  conv_bn_relu_sm90_kernel<LO><<<grid, THREADS, smem_bytes<LO>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, H, W, Cin, KH, KW, Cout, Ho, Wo, SH, SW, PT, PL, relu, splits,
// nb (kernels/conv_bn_relu.py:plan_sm90).  x bf16 NHWC and w's bf16 HWIO
// parts whi and wlo (wlo may be null), all 16-byte aligned, Cin and Cout
// multiples of 64; scale and bias float32 [Cout]; out bf16 NHWC.  ws holds
// splits partial tiles (128 x 128 float32, whatever nb) of every output
// tile and
// counters one zeroed int each when splits > 1.  A shape or plan the
// kernel cannot take returns cudaErrorInvalidValue and launches nothing;
// otherwise cudaGetLastError() after the launch.  Allocates nothing and
// does not synchronise.
extern "C" int tpuic_conv_bn_relu_sm90(const void* x, const void* whi,
                                       const void* wlo, const void* scale,
                                       const void* bias, void* out, void* ws,
                                       void* counters, const int* dims,
                                       void* stream) {
  const Shape s{dims[0], dims[1], dims[2],  dims[3],  dims[4],
                dims[5], dims[6], dims[7],  dims[8],  dims[9],
                dims[10], dims[11], dims[12], dims[13]};
  const int splits = dims[14], nb = dims[15];
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (s.Cin % BK != 0 || s.Cout % 64 != 0 || (nb != 64 && nb != BN))
    return bad;
  const int stages = s.KH * s.KW * s.Cin / BK;
  if (splits < 1 || splits > stages) return bad;
  const int per = (stages + splits - 1) / splits;
  if ((splits - 1) * per >= stages) return bad;  // an empty slice
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return bad;
  const Params p{static_cast<const __nv_bfloat16*>(x),
                 static_cast<const __nv_bfloat16*>(whi),
                 static_cast<const __nv_bfloat16*>(wlo),
                 static_cast<const float*>(scale),
                 static_cast<const float*>(bias),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
                 static_cast<int*>(counters), s, s.B * s.Ho * s.Wo, stages,
                 splits, per, nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wlo == nullptr ? launch<false>(p, st) : launch<true>(p, st);
}
