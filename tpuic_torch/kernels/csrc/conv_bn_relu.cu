// Fused convolution + folded-BN affine + optional ReLU, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuic/kernels/conv_bn_relu.py:_kernel (launched by
// pl.pallas_call in _fused).  Computes, for NHWC activations and HWIO weights,
//
//     out[b, oh, ow, co] = act(sum_{ki,kj,ci} x[b, oh*sh-pt+ki, ow*sw-pl+kj, ci]
//                                * w[ki, kj, ci, co] * scale[co] + bias[co])
//
// with taps outside the image reading as zero (the padding), float32
// accumulation whatever the input type, and one write of the output in the
// input's type.
//
// Design: an implicit GEMM.  The output is the M x N row-major matrix
// out[m, n] with M = B*Ho*Wo output pixels and N = Cout; the reduction runs
// over K = kh*kw*Cin in (ki, kj, ci) order, so the HWIO weight read row-major
// is already the K x N operand and needs no repacking.
//
// What bounds it: the operations, for a ResNet-50 forward at batch 8 or
// more and for each of its 3x3 convs and its 1x1 convs from 28x28 down.  A
// float32 product must keep float32 accuracy, so each one is three TF32
// tensor-core products (3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi), and the
// bound is 2*M*N*K FLOPs at a third of the card's TF32 rate.  The 1x1 convs
// at 56x56 are bound by their activations' bytes over HBM bandwidth, and at
// batch 1 the 1x1 convs at 7x7 by the weight's.  What the design does
// about it:
//
// - Products: mma.sync.m16n8k8 tf32 (csrc/mma_frag.cuh).  A block of
//   BM/32 x 2 warps owns BM (64 or 128) pixels x 64 channels; each warp a
//   32 x 32 tile, 2 x 4 MMA tiles, 24 MMAs per 8-deep K step.  Each stage's
//   products are summed in fresh accumulators and then added to the
//   running float32 sums (see the main loop).
// - A ring of three cp.async stages of 32 K values.  The A tile is gathered
//   straight from NHWC: 16-byte copies (4 float32 or 8 bf16 channels of one
//   tap of one pixel) when Cin allows, so a copy never straddles a tap, else
//   one element a copy (the 7x7x3 stem: K = 147, 12-byte pixel rows); taps in
//   the padding or past K are zero-filled by cp.async's src-size 0.  Each
//   pixel's window origin and image offset are computed once per block into
//   shared memory.  The B tile is copied row-major (N contiguous) in 16-byte
//   chunks when Cout % 4 == 0, else 4 bytes at a time.
// - Each fragment is split into TF32 hi and lo as it is read (an integer add
//   and mask, frag::split_tf32): A's by ldmatrix.x4 from the tile as copied,
//   B's by 32-bit reads of its K x N rows.  Splitting each landed stage once
//   into hi/lo tiles in shared memory instead (the split_per_stage variant
//   of kernels/conv_bn_relu_bench.py) was slower on the H100 at every
//   ResNet-50 shape, by 1.1x to 1.4x: the split pass costs a second barrier
//   a stage and 18 KB more shared memory a block (three blocks an SM instead
//   of four at 64 pixels), while each fragment it saves splitting is read by
//   two warps only.
//   bf16 activations are exact in TF32: they are staged as bf16, not split,
//   and widened when their fragment is read (a shift or a mask), so a
//   product is two MMAs (a*b_lo + a*b_hi).  The ldmatrix of a bf16 tile
//   hands thread (g, t) channels 2t and 2t+1 of an 8-deep step, so the B
//   fragment reads rows 2t and 2t+1 to match (position t holds k = 2t,
//   position t + 4 holds k = 2t + 1).
// - Row strides: 36 words for float32 A and 20 for bf16 A (16 bytes past
//   the data: ldmatrix's eight rows fall in distinct bank groups); 72 words
//   for B under float32 A, whose fragments read rows t and t + 4, and 68
//   under bf16 A, rows 2t and 2t + 1: either way the 32 lanes hit 32
//   distinct banks.  56 KB a block at 64 pixels in float32: four blocks an
//   SM.
// - Split-K for the shapes whose grid would leave the card short of two
//   blocks an SM (the stage-3 and stage-4 shapes at batch 8): grid.z slices
//   of whole stages; each slice writes its float32 partial tile to a workspace, a
//   per-tile counter taken with an atomic finds the last slice to arrive,
//   and that slice sums the partials in slice order 0..S-1, applies the
//   epilogue, writes once and resets the counter.  The slice count comes
//   from the shape without its batch (kernels/conv_bn_relu.py:plan), so a
//   row's sum runs in the same order whatever batch it rides in.
// - Epilogue: the C fragments times scale plus bias, the ReLU, and paired
//   stores (float2 or two bf16), masked on the ragged M and N edges.
//
// Weights are float32: bf16 weights (the serve ladder's bf16 rung) are
// widened once per fold, which is exact, so they compute the same function.
//
// The TPU kernel's grid of one image per step with whole-image VMEM blocks
// does not fit 227 KB of shared memory and would leave most of the 132 SMs
// idle; tiling the pixel dimension of all images together fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo, SH, SW, PT, PL, relu;
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int TBN = 64;   // output channels a block
constexpr int TBK = 32;   // K values a stage
constexpr int RING = 3;   // cp.async stages
constexpr int RSA = 36;   // float32 A rows: 32 words + 16 bytes
constexpr int RSH = 20;   // bf16 A rows: 16 words + 16 bytes
constexpr int NACC = 32;  // accumulators a thread: 2 x 4 MMA tiles x 4

struct TcParams {
  const void* x;
  const float* w;
  const float* scale;
  const float* bias;
  void* out;
  float* ws;       // split-K partial tiles (splits > 1)
  int* counters;   // one per output tile, zero between launches
  Shape s;
  int M, K, splits, per;  // per: stages a slice
  int vec_x, vec_w;       // 16-byte copies of x / w
};

template <typename TX, int BM>
struct TcTile {
  static constexpr bool F32 = sizeof(TX) == 4;
  static constexpr int WARPS_M = BM / 32;  // warps of 32 x 32
  static constexpr int THREADS = 32 * WARPS_M * (TBN / 32);
  static constexpr int RSX = F32 ? RSA : RSH;
  // B rows: 64 words + 32 bytes under float32 A, whose B fragments read
  // rows t and t + 4 (8t + g: 32 distinct banks); + 16 bytes under bf16 A,
  // whose fragments read rows 2t and 2t + 1 (likewise).
  static constexpr int RSB = F32 ? TBN + 8 : TBN + 4;
  static constexpr int A_WORDS = BM * RSX;
  static constexpr int SLOT = A_WORDS + TBK * RSB;
  static constexpr int ROWINFO = 3 * BM;
  static constexpr int WORDS = ROWINFO + RING * SLOT;
  // As many blocks an SM as shared memory allows (1 KB of it reserved a
  // block), but no fewer than 128 registers a thread.
  static constexpr int BY_SMEM = 233472 / (4 * WORDS + 1024);
  static constexpr int BY_REGS = 65536 / (THREADS * 128);
  static constexpr int MIN_BLOCKS = BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS;
};

// Per output pixel of the block: the window's first input row and column
// (padding subtracted) and the image's element offset.  Rows past M get a
// row far above the image, so every tap of theirs reads zero.
template <int BM, int THREADS>
__device__ __forceinline__ void row_info(int* ri, const TcParams& p, int m0) {
  const Shape& s = p.s;
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
}

// The A tile of the stage at K offset kbase: BM pixels x 32 K values.
template <typename TX, int BM>
__device__ __forceinline__ void load_a(uint32_t* As, const int* ri,
                                       const TcParams& p, int kbase) {
  using L = TcTile<TX, BM>;
  const TX* x = static_cast<const TX*>(p.x);
  const Shape& s = p.s;
  if (p.vec_x) {
    constexpr int EPC = 16 / static_cast<int>(sizeof(TX));
    constexpr int CPR = TBK / EPC;  // 16-byte chunks a row
    const int c = threadIdx.x % CPR, gk = kbase + c * EPC;
    const int tap = gk / s.Cin, ci = gk - tap * s.Cin;
    const int ki = tap / s.KW, kj = tap - ki * s.KW;
    const bool kok = gk < p.K;
    // The thread's R rows: their window facts first, then the copies (a
    // copy's memory clobber would otherwise serialise the reads).
    constexpr int R = BM * CPR / L::THREADS, STEP = L::THREADS / CPR;
    const int r0 = threadIdx.x / CPR;
    int ih[R], iw[R], base[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ih[i] = ri[r0 + i * STEP] + ki;
      iw[i] = ri[BM + r0 + i * STEP] + kj;
      base[i] = ri[2 * BM + r0 + i * STEP];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool ok = kok && (unsigned)ih[i] < (unsigned)s.H &&
                      (unsigned)iw[i] < (unsigned)s.W;
      const TX* src = ok ? x + base[i] + (ih[i] * s.W + iw[i]) * s.Cin + ci
                         : x;
      frag::cp_async16(
          frag::smem_addr(As + (r0 + i * STEP) * L::RSX + 4 * c), src, ok);
    }
  } else {
    const int c = threadIdx.x % TBK, gk = kbase + c;
    const int tap = gk / s.Cin, ci = gk - tap * s.Cin;
    const int ki = tap / s.KW, kj = tap - ki * s.KW;
    const bool kok = gk < p.K;
    for (int r = threadIdx.x / TBK; r < BM; r += L::THREADS / TBK) {
      const int ih = ri[r] + ki, iw = ri[BM + r] + kj;
      const bool ok = kok && (unsigned)ih < (unsigned)s.H &&
                      (unsigned)iw < (unsigned)s.W;
      const int off = ok ? ri[2 * BM + r] + (ih * s.W + iw) * s.Cin + ci : 0;
      if constexpr (L::F32) {
        frag::cp_async4(frag::smem_addr(As + r * RSA + c), x + off, ok);
      } else {
        // cp.async moves 4 bytes at least: a bf16 element is loaded and
        // stored by the thread (zero outside the image or past K).
        const uint16_t v =
            ok ? reinterpret_cast<const uint16_t*>(x)[off] : uint16_t(0);
        reinterpret_cast<uint16_t*>(As)[r * 2 * RSH + c] = v;
      }
    }
  }
}

// The B tile of the stage at K offset kbase: 32 K rows x 64 channels.
template <int THREADS, int RSB>
__device__ __forceinline__ void load_b(uint32_t* Bs, const TcParams& p,
                                       int kbase, int n0) {
  const float* w = p.w;
  const int N = p.s.Cout;
  if (p.vec_w) {
#pragma unroll
    for (int i = 0; i < TBK * (TBN / 4) / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int kr = idx / (TBN / 4), c = idx % (TBN / 4);
      const int gk = kbase + kr, gn = n0 + 4 * c;
      const bool ok = gk < p.K && gn < N;
      frag::cp_async16(frag::smem_addr(Bs + kr * RSB + 4 * c),
                       ok ? w + gk * N + gn : w, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < TBK * TBN; idx += THREADS) {
      const int kr = idx / TBN, c = idx % TBN;
      const int gk = kbase + kr, gn = n0 + c;
      const bool ok = gk < p.K && gn < N;
      frag::cp_async4(frag::smem_addr(Bs + kr * RSB + c),
                      ok ? w + gk * N + gn : w, ok);
    }
  }
}

template <typename TX, int BM>
__device__ __forceinline__ void load_stage(uint32_t* slot, const int* ri,
                                           const TcParams& p, int kbase,
                                           int n0) {
  using L = TcTile<TX, BM>;
  load_a<TX, BM>(slot, ri, p, kbase);
  load_b<L::THREADS, L::RSB>(slot + L::A_WORDS, p, kbase, n0);
}

// The warp's 32 x 32 tile += the stage's products, splitting each
// fragment as it is read from the tiles as copied.
template <typename TX, int BM>
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4],
                                             const uint32_t* As,
                                             const uint32_t* Bs, int wm,
                                             int wn) {
  using L = TcTile<TX, BM>;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const int g = lane >> 2, t = lane & 3;
  const int a_off = (32 * wm + (mi & 1) * 8 + r) * L::RSX + (mi >> 1) * 4;
  const float* B = reinterpret_cast<const float*>(Bs) + 32 * wn + g;
  // B fragments of the 8-deep step at row k0: rows k0 + t, k0 + t + 4
  // (float32 A) or k0 + 2t, k0 + 2t + 1 (bf16 A, see the header).
  auto b_frags = [&](uint32_t (&bh)[4][2], uint32_t (&bl)[4][2], int k0) {
    const int r0 = L::F32 ? k0 + t : k0 + 2 * t;
    const int r1 = L::F32 ? r0 + 4 : r0 + 1;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      frag::split_tf32(B[r0 * L::RSB + 8 * nt], bh[nt][0], bl[nt][0]);
      frag::split_tf32(B[r1 * L::RSB + 8 * nt], bh[nt][1], bl[nt][1]);
    }
  };
  if constexpr (L::F32) {
#pragma unroll
    for (int ks = 0; ks < TBK / 8; ++ks) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t raw[4];
        frag::ldmatrix_x4(raw, frag::smem_addr(As + a_off + 16 * mt * RSA +
                                               8 * ks));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          frag::split_tf32(__uint_as_float(raw[e]), ah[mt][e], al[mt][e]);
      }
      b_frags(bh, bl, 8 * ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          frag::mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
    }
  } else {
#pragma unroll
    for (int k16 = 0; k16 < TBK / 16; ++k16) {
      uint32_t raw[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        frag::ldmatrix_x4(raw[mt],
                          frag::smem_addr(As + a_off + 16 * mt * RSH +
                                          8 * k16));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t r0 = raw[mt][2 * half], r1 = raw[mt][2 * half + 1];
          a[mt][0] = r0 << 16;
          a[mt][1] = r1 << 16;
          a[mt][2] = r0 & 0xffff0000u;
          a[mt][3] = r1 & 0xffff0000u;
        }
        b_frags(bh, bl, 8 * (2 * k16 + half));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            frag::mma_tf32(acc[mt][nt], a[mt], bl[nt][0], bl[nt][1]);
            frag::mma_tf32(acc[mt][nt], a[mt], bh[nt][0], bh[nt][1]);
          }
      }
    }
  }
}

template <typename TX, int BM>
__global__ void __launch_bounds__(TcTile<TX, BM>::THREADS,
                                  TcTile<TX, BM>::MIN_BLOCKS)
    conv_bn_relu_tc_kernel(TcParams p) {
  using L = TcTile<TX, BM>;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int last;
  int* ri = reinterpret_cast<int*>(smem);
  uint32_t* ring = smem + L::ROWINFO;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * TBN, z = blockIdx.z;
  const int st0 = z * p.per;
  const int nst = min(p.per, (p.K + TBK - 1) / TBK - st0);
  row_info<BM, L::THREADS>(ri, p, m0);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < nst)
      load_stage<TX, BM>(ring + i * L::SLOT, ri, p, (st0 + i) * TBK, n0);
    frag::cp_async_commit();
  }
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % L::WARPS_M, wn = warp / L::WARPS_M;
  for (int it = 0; it < nst; ++it) {
    frag::cp_async_wait<RING - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    const int nx = it + RING - 1;
    if (nx < nst)
      load_stage<TX, BM>(ring + (nx % RING) * L::SLOT, ri, p,
                         (st0 + nx) * TBK, n0);
    frag::cp_async_commit();
    const uint32_t* As = ring + (it % RING) * L::SLOT;
    // A stage's products go to fresh accumulators, added to the running
    // sums with float32 adds: the error of a tensor-core accumulator grows
    // with the length of its chain of MMAs (on the H100, over the 4,608
    // taps of a 3x3x512 conv it was several times the float32 sum's), and
    // a chain of one stage keeps it near the float32 sum's.
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    mma_stage<TX, BM>(part, As, As + L::A_WORDS, wm, wn);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  frag::cp_async_wait<0>();

  if (p.splits > 1) {
    // Partial tiles, laid out [tile][slice][accumulator][thread] so that
    // each store and load of the warp is one coalesced row.
    const int tile = blockIdx.x + gridDim.x * blockIdx.y;
    float* ws = p.ws + (size_t)tile * p.splits * NACC * L::THREADS +
                threadIdx.x;
    float* mine = ws + (size_t)z * NACC * L::THREADS;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((mt * 4 + nt) * 4 + e) * L::THREADS] = acc[mt][nt][e];
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
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* q = ws + ((mt * 4 + nt) * 4 + e) * L::THREADS;
          float v = __ldcg(q);
          for (int zz = 1; zz < p.splits; ++zz)
            v += __ldcg(q + (size_t)zz * NACC * L::THREADS);
          acc[mt][nt][e] = v;
        }
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int N = p.s.Cout;
  TX* out = static_cast<TX*>(p.out);
  float sc[4][2], bi[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 32 * wn + 8 * nt + 2 * t + j;
      sc[nt][j] = n < N ? p.scale[n] : 0.f;
      bi[nt][j] = n < N ? p.bias[n] : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 32 * wm + 16 * mt + g + 8 * h;
      if (m >= p.M) continue;
      TX* orow = out + (size_t)m * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 32 * wn + 8 * nt + 2 * t;
        float y0 = fmaf(acc[mt][nt][2 * h], sc[nt][0], bi[nt][0]);
        float y1 = fmaf(acc[mt][nt][2 * h + 1], sc[nt][1], bi[nt][1]);
        if (p.s.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        if (n + 1 < N && (N & 1) == 0) {
          frag::store_pair(orow + n, y0, y1);
        } else {
          if (n < N) orow[n] = from_f32<TX>(y0);
          if (n + 1 < N) orow[n + 1] = from_f32<TX>(y1);
        }
      }
    }
}

template <typename TX, int BM>
int launch_tc(const TcParams& p, cudaStream_t stream) {
  using L = TcTile<TX, BM>;
  const size_t smem = sizeof(uint32_t) * L::WORDS;
  // Dynamic shared memory above the 48 KB default, allowed once a device:
  // the call costs host time on every launch otherwise.
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(conv_bn_relu_tc_kernel<TX, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev] = true;
  }
  const dim3 grid((unsigned)((p.M + BM - 1) / BM),
                  (unsigned)((p.s.Cout + TBN - 1) / TBN), (unsigned)p.splits);
  conv_bn_relu_tc_kernel<TX, BM><<<grid, L::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, H, W, Cin, KH, KW, Cout, Ho, Wo, SH, SW, PT, PL, relu, x_dtype
// (0 = float32, 1 = bfloat16; w is float32), bm, splits: the shape and the
// plan the caller chose (kernels/conv_bn_relu.py:plan), one array so that a
// call from Python passes few arguments.  bm is 64 or 128 pixels a block,
// splits the K slices (ws holds splits partial tiles of every output tile
// and counters one zeroed int each when splits > 1), vec_x / vec_w 16-byte
// copies of x / w (x: Cin % 4 == 0 in float32, % 8 in bf16; w: Cout % 4 ==
// 0; both 16-byte aligned).  A plan the shape cannot take returns
// cudaErrorInvalidValue and launches nothing.  Otherwise returns
// cudaGetLastError() after the launch (0 when the launch was accepted).
// Allocates nothing and does not synchronise: the caller owns every buffer
// and the stream.
extern "C" int tpuic_conv_bn_relu(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, void* ws, void* counters,
                                  const int* dims, int vec_x, int vec_w,
                                  void* stream) {
  const Shape s{dims[0], dims[1], dims[2],  dims[3],  dims[4],
                dims[5], dims[6], dims[7],  dims[8],  dims[9],
                dims[10], dims[11], dims[12], dims[13]};
  const int x_dtype = dims[14], bm = dims[15], splits = dims[16];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype != 0 && x_dtype != 1) return bad;
  const int K = s.KH * s.KW * s.Cin, stages = (K + TBK - 1) / TBK;
  if (splits < 1 || splits > stages) return bad;
  const int per = (stages + splits - 1) / splits;
  if ((splits - 1) * per >= stages) return bad;  // an empty slice
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return bad;
  if (vec_x && s.Cin % (x_dtype == 0 ? 4 : 8) != 0) return bad;
  if (vec_w && s.Cout % 4 != 0) return bad;
  const TcParams p{x, static_cast<const float*>(w),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(bias), out,
                   static_cast<float*>(ws), static_cast<int*>(counters), s,
                   s.B * s.Ho * s.Wo, K, splits, per, vec_x, vec_w};
  if (bm == 64)
    return x_dtype == 0 ? launch_tc<float, 64>(p, st)
                        : launch_tc<__nv_bfloat16, 64>(p, st);
  if (bm == 128)
    return x_dtype == 0 ? launch_tc<float, 128>(p, st)
                        : launch_tc<__nv_bfloat16, 128>(p, st);
  return bad;
}
