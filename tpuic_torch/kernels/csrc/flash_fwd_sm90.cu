// Flash attention forward in bfloat16 at head dim 64, for Hopper (sm_90a):
// TMA-fed key and value stages behind mbarriers, and wgmma.
//
// Replaces, for bfloat16 q/k/v with D = 64 (every ViT of the repo: ViT-S,
// ViT-B and ViT-L all have 64-wide heads), the TPU kernel
//   _fwd_kernel (tpuic/kernels/flash_attention.py:154, pallas_call :324)
// and its lane-packed variant (:541), as flash_attention.cu's mma.sync
// build still does for float32 and for the other head dims.  It computes
// what _fwd_kernel computes in bf16: s = scale * q k^T with keys j >= valid
// at -1e30, the online softmax in float32, p rounded to bf16 before p v
// (_f32_for, :78: the probabilities take v's type), o = acc / l, and
// lse = m + log(l) per row; a row with no valid key gets o = 0 and
// lse = masked_sentinel.
//
// Design.  A persistent kernel: one 512-thread block an SM walks over the
// (b*h, group of four 64-row q tiles) items, one warpgroup a q tile, so a
// (b, h) at N = 197 is one item and its keys and values come from memory
// once, for all four q tiles.
//   - Shared memory holds two sets of tiles, each the item's four q tiles
//     and a ring of STAGES = 4 stages of 64-key k and v tiles.  Thread 0
//     issues every copy through the Tensor Memory Accelerator, each q tile
//     and each stage completing on its own mbarrier: while the warpgroups
//     compute one item from one set, the next item's tiles stream into the
//     other, so the copies of the one overlap the products of the other.
//     Four 64-key stages hold N = 197 whole; a longer sequence refills a
//     stage once every warpgroup is done with it.  The tensor maps read q,
//     k and v as 4-D (D, H, N, B) arrays through their strides, so the
//     strided views of one qkv projection go in with no copy; rows past N
//     come in as zeros (TMA's out-of-bounds fill) and the copies swizzle
//     each 128-byte row as wgmma's 128-byte layout wants.
//   - S = Q K^T is four m64n64k16 wgmmas with both operands in shared
//     memory (K-major); O += P V four more, with P from registers (the S
//     accumulators, scaled, exponentiated and rounded to bf16, are already
//     in wgmma's A-fragment layout) and V read transposed (MN-major).
//   - The softmax runs on the accumulators in registers: a row's 16 values
//     of a thread lie with the other three lanes of its quad, so the row
//     max and row sum take two xor shuffles each.  Only the last key tile
//     masks (keys at or past valid).
//   - The ragged last q tile (5 of 64 rows at N = 197) is one warpgroup
//     product like every other tile: no warp of it idles while another
//     works, and rows past N are computed from zeros and not stored.
//   - O leaves through shared memory: each warpgroup writes its tile, in
//     the 128-byte swizzle (conflict-free), over its own q tile, and one
//     thread stores it with TMA, which drops the rows past N; the
//     fragments' own stores would write half-used 32-byte sectors.
// 193 KB of shared memory (two sets of four q, four k and four v tiles of
// 8 KB, 1024-byte aligned for the swizzle), one block an SM.
//
// What bounds it on an H100: at [64, 197, 12, 64] bf16 it reads q, k, v
// and writes o, 19.37 MB each, and lse, 0.61 MB: 78.1 MB in 0.0233 ms at
// 3.35 TB/s; its 4*B*H*N^2*D = 7.63 GFLOP take 0.0077 ms at the 989
// TFLOP/s bf16 peak (0.013 ms at the padded 256 x 256 extent).  Bytes
// bound it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int HD = 64;          // head dim: one 128-byte bf16 row
constexpr int BM = 64;          // q rows of a block: wgmma's M
constexpr int BN = 64;          // keys of a stage
constexpr int STAGES = 4;
constexpr int WG = 4;           // warpgroups a block, one q tile each
constexpr int THREADS = 128 * WG;
constexpr int SETS = 2;         // tile sets: one computed, one loading
constexpr int TILE = BM * HD * 2;  // bytes of a q, k or v tile
constexpr int SET_BYTES = (WG + 2 * STAGES) * TILE;
constexpr int SET_BARS = WG + STAGES;
constexpr int SMEM = SETS * SET_BYTES + 8 * SETS * SET_BARS + 1024;
constexpr float NEG = -1e30f;   // the reference's _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// wgmma shared-memory descriptors, 128-byte swizzle, byte offsets.  K-major
// (q, k): 8-row groups 1024 bytes apart; the leading offset is unused.
// MN-major (v): 8-key groups 1024 bytes apart along the contraction; the
// leading offset steps between 64-column atoms, of which D = 64 has one.
constexpr uint32_t QK_LBO = 16, QK_SBO = 1024;
constexpr uint32_t V_LBO = 16, V_SBO = 1024;
constexpr uint32_t V_KSTEP = 16 * 128;  // bytes between 16-key steps of v

struct Params {
  void* o;                      // contiguous [B, N, H, D]
  float* lse;                   // contiguous [B, H, N]
  const int* valid;             // optional device count of valid keys
  int valid_len, B, N, H;
  int qgroups, items;           // items: B * H * qgroups groups of q tiles
  float scale, sentinel;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the (D, H, N, B) tensor map: 64 rows of one (b, h) from row
// `row`, completing on `bar`.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h),
      "r"(row), "r"(b)
      : "memory");
}

// The 64 x 64 tile at `src` (the 128-byte swizzle) to rows from `row` of
// one (b, h); rows past N are not written.
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map,
                                               uint32_t src, int h, int row,
                                               int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
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

// Keep the compiler from moving reads or writes of a register that an
// asynchronous wgmma reads or writes across the fence and wait around it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B for a 64 x 64 x 16 step, A and B in shared memory (K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B for a 64 x 16 x 16 step, A and B in shared memory (K-major):
// the scores of a last key tile of at most 16 keys.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// 2^x in one MUFU operation (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += A B for a 64 x 64 x 16 step, A from registers (four bf16x2 a
// thread), B in shared memory read transposed (MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One key tile of one warpgroup's online softmax: NK keys from k0 (64, or
// 16 for a last tile of at most 16 keys, which then runs a quarter of the
// products), keys at or past kn masked when MASK (the last tile only).
// m is the running row max in log2 units and l the row sum, of rows g and
// g + 8; o the output accumulators.  Scores are scaled into log2 units
// inside the exponent's one multiply-add: the max is taken over the raw
// scores (scale > 0 keeps the order).
template <int NK, bool MASK>
__device__ __forceinline__ void key_tile(float (&o)[32], float (&m)[2],
                                         float (&l)[2], uint32_t q_addr,
                                         uint32_t k_addr, uint32_t v_addr,
                                         int k0, int kn, float scale_log2,
                                         int c) {
  float s[NK / 2];
  reg_fence(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(s, desc_sw128(q_addr + 32 * kk, QK_LBO, QK_SBO),
             desc_sw128(k_addr + 32 * kk, QK_LBO, QK_SBO), kk > 0);
  wg_commit();
  wg_wait0();
  reg_fence(s);
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && k0 + 8 * j + 2 * c + (e & 1) >= kn) s[4 * j + e] = NEG;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float alpha[2], nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // Every tile holds a valid key, so the row max is finite.
    const float mn = fmaxf(m[i], mx[i] * scale_log2);
    alpha[i] = ex2(m[i] - mn);
    m[i] = mn;
    nm[i] = -mn;
  }
  uint32_t pa[NK / 16][4];  // P as A fragments, one per 16-key step
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const float p0 = ex2(fmaf(s[4 * j], scale_log2, nm[0]));
    const float p1 = ex2(fmaf(s[4 * j + 1], scale_log2, nm[0]));
    const float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, nm[1]));
    const float p3 = ex2(fmaf(s[4 * j + 3], scale_log2, nm[1]));
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    pa[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  // O += P V over the tile's 16-key steps.
  reg_fence(o);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) reg_fence(pa[kk]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs(o, pa[kk], desc_sw128(v_addr + V_KSTEP * kk, V_LBO, V_SBO));
  wg_commit();
  wg_wait0();
  reg_fence(o);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) reg_fence(pa[kk]);
}

// Accumulator layout of an m64nNk16 wgmma (f32), thread t of the
// warpgroup, warp w = t / 32, g = (t % 32) / 4, c = t % 4: d[4j + e] holds
// row 16w + g + 8 (e >> 1), column 8j + 2c + (e & 1).  The A fragment of a
// 16-wide contraction step kk is d[8kk .. 8kk + 7] of that layout, packed
// in pairs: the S accumulators of keys 16kk .. 16kk + 15 become P's A.
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, Params p) {
  extern __shared__ __align__(16) uint8_t raw[];
  // 1024-byte alignment for the 128-byte swizzle's repeating pattern.
  uint8_t* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  // Set s: q tiles [WG], k tiles [STAGES], v tiles [STAGES]; its barriers:
  // one a q tile, then one a stage.
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + SETS * SET_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int warp = (tid >> 5) & 3;         // the warp of its warpgroup
  const int g = lane >> 2, c = lane & 3, N = p.N;
  const int vl = p.valid ? *p.valid : p.valid_len;
  const int kn = min(max(vl, 0), N);  // keys at or past kn are masked
  const int ntiles = (kn + BN - 1) / BN;
  // Thread 0: every copy of item `it` into set `set`.  A q tile wholly past
  // N (a short sequence's later warpgroups) comes in as zeros: its rows
  // are computed and never stored.
  auto load_item = [&](int it, int set) {
    const int bh = it / p.qgroups, qg = it - bh * p.qgroups;
    const int b = bh / p.H, h = bh - b * p.H;
    uint8_t* base = sm + set * SET_BYTES;
    uint64_t* sb = bars + set * SET_BARS;
    for (int w = 0; w < WG; ++w) {
      const uint32_t bar = smem_u32(sb + w);
      mbar_expect_tx(bar, TILE);
      tma_rows(smem_u32(base + w * TILE), &tq, bar, h, (qg * WG + w) * BM, b);
    }
    for (int t = 0; t < min(STAGES, ntiles); ++t) {
      const uint32_t bar = smem_u32(sb + WG + t);
      mbar_expect_tx(bar, 2 * TILE);
      tma_rows(smem_u32(base + (WG + t) * TILE), &tk, bar, h, t * BN, b);
      tma_rows(smem_u32(base + (WG + STAGES + t) * TILE), &tv, bar, h,
               t * BN, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < SETS * SET_BARS; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int set = 0; set < SETS; ++set)
      if (blockIdx.x + set * gridDim.x < p.items)
        load_item(blockIdx.x + set * gridDim.x, set);
  }
  __syncthreads();  // the barriers are initialised
  const float scale_log2 = p.scale * LOG2E;
  // Bit set * STAGES + stage: the parity the next wait on that stage's
  // barrier expects (every thread waits on every completion).
  uint32_t kv_parity = 0;
  int local = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++local) {
    const int set = local % SETS;
    const int bh = it / p.qgroups, qg = it - bh * p.qgroups;
    const int b = bh / p.H, h = bh - b * p.H, q0 = (qg * WG + wg) * BM;
    uint8_t* base = sm + set * SET_BYTES;
    uint8_t* my_q = base + wg * TILE;
    uint64_t* sb = bars + set * SET_BARS;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    const uint32_t q_addr = smem_u32(my_q);
    // Also when no key is valid: the copy must land before it is reused.
    mbar_wait(smem_u32(sb + wg), (local / SETS) & 1);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES, k0 = t * BN, bit = set * STAGES + st;
      mbar_wait(smem_u32(sb + WG + st), (kv_parity >> bit) & 1);
      kv_parity ^= 1u << bit;
      const uint32_t k_addr = smem_u32(base + (WG + st) * TILE);
      const uint32_t v_addr = smem_u32(base + (WG + STAGES + st) * TILE);
      if (k0 + BN <= kn)
        key_tile<64, false>(o, m, l, q_addr, k_addr, v_addr, k0, kn,
                            scale_log2, c);
      else if (kn - k0 <= 16)
        key_tile<16, true>(o, m, l, q_addr, k_addr, v_addr, k0, kn,
                           scale_log2, c);
      else
        key_tile<64, true>(o, m, l, q_addr, k_addr, v_addr, k0, kn,
                           scale_log2, c);
      if (t + STAGES < ntiles) {
        __syncthreads();  // every warpgroup is done with stage st
        if (tid == 0) {
          const uint32_t bar = smem_u32(sb + WG + st);
          const int r = (t + STAGES) * BN;
          mbar_expect_tx(bar, 2 * TILE);
          tma_rows(smem_u32(base + (WG + st) * TILE), &tk, bar, h, r, b);
          tma_rows(smem_u32(base + (WG + STAGES + st) * TILE), &tv, bar, h,
                   r, b);
        }
      }
    }
    // O / l into the warpgroup's own q tile, which no product reads any
    // more, in the 128-byte swizzle: 16-byte chunk j of row r sits at
    // chunk j ^ (r % 8), the layout the store's tensor map reads.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      const bool masked = m[i] <= NEG * 0.5f;
      const float inv = masked ? 0.f : 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            my_q + r * 128 + ((j ^ (r & 7)) << 4) + 4 * c) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
      const int row = q0 + r;
      if (c == 0 && row < N)
        p.lse[static_cast<long long>(bh) * N + row] =
            masked ? p.sentinel : m[i] * LN2 + logf(fmaxf(l[i], 1e-30f));
    }
    // The writes must reach the async proxy before TMA reads them.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((tid & 127) == 0 && q0 < N)
      tma_store_rows(&to, smem_u32(my_q), h, q0, b);  // waits for the read
    __syncthreads();  // every warpgroup is done with this set
    if (tid == 0 && it + SETS * gridDim.x < p.items)
      load_item(it + SETS * gridDim.x, set);
  }
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against the runtime alone.
Encode encoder() {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<Encode>(ptr);
  }
  return fn;
}

// The (D, H, N, B) map of one [B, N, H, 64] bf16 tensor with element
// strides sb, sn, sh (head dim contiguous), boxes of 64 rows of one (b, h),
// for loads and for the store of o.
// A dim of extent 1 takes the stride of a packed layout: it is never
// stepped, and TMA wants every stride a multiple of 16 bytes.
int make_map(CUtensorMap* map, const void* ptr, const long long* st, int B,
             int N, int H) {
  Encode enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long sh = H > 1 ? st[2] : HD;
  const long long sn = N > 1 ? st[1] : sh * H;
  const long long sb = B > 1 ? st[0] : sn * N;
  cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sn) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {HD, 1, BN, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // A refused map is reported apart from CUDA runtime errors.
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// The host side of a launch, kept off the steady state: tensor maps are
// pure functions of (pointer, shape, strides), so the last ones made are
// kept and reused (the caching allocator hands a training step's tensors
// the same addresses step after step); the kernel's shared-memory
// attribute is set once per device, and the SM count read once.  ctypes
// drops the GIL around the call, hence the lock.
struct MapKey {
  const void* ptr;
  long long st[3];
  int B, N, H;
};
constexpr int MAP_CACHE = 64;
struct MapEntry {
  MapKey key;
  CUtensorMap map;
  bool used;
};
std::mutex cache_lock;
MapEntry map_cache[MAP_CACHE];
int map_next = 0;
int device_sms[16];  // 0: not read yet

int cached_map(CUtensorMap* map, const void* ptr, const long long* st,
               int B, int N, int H) {
  MapKey key{ptr, {st[0], st[1], st[2]}, B, N, H};
  std::lock_guard<std::mutex> guard(cache_lock);
  for (const MapEntry& e : map_cache)
    if (e.used && e.key.ptr == ptr && e.key.st[0] == st[0] &&
        e.key.st[1] == st[1] && e.key.st[2] == st[2] && e.key.B == B &&
        e.key.N == N && e.key.H == H) {
      *map = e.map;
      return 0;
    }
  const int rc = make_map(map, ptr, st, B, N, H);
  if (rc == 0) {
    MapEntry& e = map_cache[map_next];
    map_next = (map_next + 1) % MAP_CACHE;
    e.key = key;
    e.map = *map;
    e.used = true;
  }
  return rc;
}

// The device's SM count, and the kernel's shared-memory attribute set on
// it, once per device.
int prepare_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> guard(cache_lock);
  if (device_sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_sm90_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    device_sms[dev] = n;
  }
  *sms = device_sms[dev];
  return 0;
}

}  // namespace

// o [B, N, H, 64] bf16 and lse float32 [B, H, N], both contiguous, from
// bf16 q, k, v [B, N, H, 64] read through (batch, token, head) element
// strides (9 values: q, k, v), each tensor 16-byte aligned with strides
// that are multiples of 8 elements.  Returns 0 when the launch was
// accepted, a CUDA error, or 10000 + the driver's error for a tensor map
// it refused.  Allocates nothing and does not synchronise.
extern "C" int tpuic_flash_fwd_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const long long* strides,
                                    const void* valid, int valid_len, int B,
                                    int N, int H, float scale, float sentinel,
                                    void* stream) {
  if (B <= 0 || N <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long so[3] = {static_cast<long long>(N) * H * HD, H * HD, HD};
  CUtensorMap tq, tk, tv, to;
  int rc = cached_map(&tq, q, strides, B, N, H);
  if (rc == 0) rc = cached_map(&tk, k, strides + 3, B, N, H);
  if (rc == 0) rc = cached_map(&tv, v, strides + 6, B, N, H);
  if (rc == 0) rc = cached_map(&to, o, so, B, N, H);
  if (rc != 0) return rc;
  const int qgroups = (N + WG * BM - 1) / (WG * BM);
  const long long items = static_cast<long long>(B) * H * qgroups;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  rc = prepare_device(&sms);
  if (rc != 0) return rc;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  Params p{o, static_cast<float*>(lse), static_cast<const int*>(valid),
           valid_len, B, N, H, qgroups, static_cast<int>(items), scale,
           sentinel};
  flash_fwd_sm90_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM,
                          static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, to,
                                                               p);
  return static_cast<int>(cudaGetLastError());
}
