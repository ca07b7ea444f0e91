// Tensor-core building blocks for sm_90a kernels written with mma.sync:
// cp.async copies into shared-memory tiles laid out for the fragments, the
// 3xTF32 split, the m16n8k8 tf32 and m16n8k16 bf16 MMA wrappers, and the
// fragment loads that read the tiles without bank conflicts.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16),
// with g = lane / 4 and t = lane % 4:
//   C (16 x 8, f32):    c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   A tf32 (16 x 8):    a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B tf32 (8 x 8):     b0 (k=t, n=g)             b1 (k=t+4, n=g)
//   A bf16 (16 x 16):   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                       a3 (g+8, 2t+8..), two bf16 per 32-bit register
//   B bf16 (16 x 8):    b0 (k=2t..2t+1, n=g)      b1 (k=2t+8..2t+9, n=g)
//
// Shared-memory tiles hold rows of 32-bit words (a float, or two bf16) with
// a row stride RS = 4k words, k odd (the data's width plus 16 bytes): rows
// of whole 16-byte chunks, so a 16-byte cp.async lands whole and ldmatrix
// reads aligned rows, and row r starts 4kr banks (mod 32) after row 0,
// with kr (mod 8) running through all eight values as r does.  Then the
// (row g, word t) reads of an A or B fragment hit 32 distinct banks, the
// (row 2t or 2t+1, word g) reads of a B fragment whose contraction runs
// over rows do too, and the eight rows of one ldmatrix phase hit eight
// distinct 16-byte bank groups: no fragment read conflicts.  Every
// fragment address is a per-thread base plus a constant, which an XOR
// swizzle does not give for the row-contraction reads (their offsets
// would be 8 (c ^ t) per output tile c, held in registers).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace frag {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Word w of row r of a tile with row stride RS words.
template <int RS>
__device__ __forceinline__ int word(int r, int w) {
  static_assert(RS % 8 == 4, "row stride must be 4 (mod 8) words");
  return r * RS + w;
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred (the
// src-size operand is 0, nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32, from an integer add and a mask.  The
// conversion instruction issues at the 16-a-clock conversion rate of an
// SM, and a 3xTF32 kernel splits every operand it loads; the add and mask
// issue at the full integer rate.  (Adding half of the 13 dropped bits to
// the magnitude and truncating rounds half away; a carry moves into the
// exponent as it should, and infinities stay infinite.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), hi = rna(x) and lo = rna(x - hi) in TF32.
// The 3xTF32 product a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi keeps float32
// accuracy; a_lo*b_lo is below it and is dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 matrices of 32-bit words (16 bytes a row): thread (g, t) gets
// word t of row g of matrix i in r[i].  Threads 8i..8i+7 give matrix i's
// row addresses.  On a row-major float32 tile this is a whole tf32 A
// fragment (rows r0 / r0 + 8, words k0 / k0 + 4), or the B fragments of
// two n8 tiles of a tile stored n-major.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8x8 b16 matrices, transposed: thread (g, t) gets rows 2t, 2t+1 of
// column g of matrix i in r[i].  Threads 8i..8i+7 give matrix i's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats as a bf16 pair: lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two adjacent outputs of a C fragment (c0/c1 or c2/c3) to global memory.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [r0, r0 + ROWS) of a row-major [*, D] slice (row stride sn elements,
// contiguous rows, 16-byte aligned) into a tile by cp.async; rows
// at or past n are zero-filled.  Every thread of the block takes part.
template <typename T, int D, int RS, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t* dst, const T* base,
                                                long long sn, int r0, int n) {
  constexpr int CPR = D * static_cast<int>(sizeof(T)) / 16;  // chunks a row
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));      // elements
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx - r * CPR, row = r0 + r;
    const bool ok = row < n;
    const T* src = base + (ok ? row : 0) * sn + c * EPC;
    cp_async16(smem_addr(dst + r * RS + (c << 2)), src, ok);
  }
}

// The two "scores" products of one warp, in one loop for two independent
// MMA chains: acc1[j] (16 x 8, C layout) += A1[a0 + 0..15, :] . B1[8j +
// 0..7, :]^T and acc2[j] += A2[a0 + 0..15, :] . B2[8j + 0..7, :]^T for j <
// nt, every operand a row-major tile of KW words a row, the contraction
// over those columns.  float32 tiles go through 3xTF32, bf16 tiles
// through one bf16 MMA a step.  a0 is a multiple of 16.  A caller that
// passes nt as a compile-time NT gets straight-line code with no branch.
template <int KW, int RS, int NT>
__device__ __forceinline__ void scores_tf32(
    float (&acc1)[NT][4], const uint32_t* A1s, const uint32_t* B1s,
    float (&acc2)[NT][4], const uint32_t* A2s, const uint32_t* B2s, int a0,
    int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* A1 = reinterpret_cast<const float*>(A1s);
  const float* B1 = reinterpret_cast<const float*>(B1s);
  const float* A2 = reinterpret_cast<const float*>(A2s);
  const float* B2 = reinterpret_cast<const float*>(B2s);
#pragma unroll 2
  for (int kk = 0; kk < KW / 8; ++kk) {
    const int w = 8 * kk + t;
    uint32_t h1[4], l1[4], h2[4], l2[4];
    split_tf32(A1[word<RS>(a0 + g, w)], h1[0], l1[0]);
    split_tf32(A1[word<RS>(a0 + g + 8, w)], h1[1], l1[1]);
    split_tf32(A1[word<RS>(a0 + g, w + 4)], h1[2], l1[2]);
    split_tf32(A1[word<RS>(a0 + g + 8, w + 4)], h1[3], l1[3]);
    split_tf32(A2[word<RS>(a0 + g, w)], h2[0], l2[0]);
    split_tf32(A2[word<RS>(a0 + g + 8, w)], h2[1], l2[1]);
    split_tf32(A2[word<RS>(a0 + g, w + 4)], h2[2], l2[2]);
    split_tf32(A2[word<RS>(a0 + g + 8, w + 4)], h2[3], l2[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int r = 8 * j + g;
        uint32_t bh1[2], bl1[2], bh2[2], bl2[2];
        split_tf32(B1[word<RS>(r, w)], bh1[0], bl1[0]);
        split_tf32(B1[word<RS>(r, w + 4)], bh1[1], bl1[1]);
        split_tf32(B2[word<RS>(r, w)], bh2[0], bl2[0]);
        split_tf32(B2[word<RS>(r, w + 4)], bh2[1], bl2[1]);
        mma_3xtf32(acc1[j], h1, l1, bh1, bl1);
        mma_3xtf32(acc2[j], h2, l2, bh2, bl2);
      }
    }
  }
}

template <int KW, int RS, int NT>
__device__ __forceinline__ void scores_bf16(
    float (&acc1)[NT][4], const uint32_t* A1, const uint32_t* B1,
    float (&acc2)[NT][4], const uint32_t* A2, const uint32_t* B2, int a0,
    int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < KW / 8; ++kk) {
    const int w = 8 * kk + t;
    const uint32_t a1[4] = {A1[word<RS>(a0 + g, w)], A1[word<RS>(a0 + g + 8, w)],
                            A1[word<RS>(a0 + g, w + 4)],
                            A1[word<RS>(a0 + g + 8, w + 4)]};
    const uint32_t a2[4] = {A2[word<RS>(a0 + g, w)], A2[word<RS>(a0 + g + 8, w)],
                            A2[word<RS>(a0 + g, w + 4)],
                            A2[word<RS>(a0 + g + 8, w + 4)]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int r = 8 * j + g;
        mma_bf16(acc1[j], a1, B1[word<RS>(r, w)], B1[word<RS>(r, w + 4)]);
        mma_bf16(acc2[j], a2, B2[word<RS>(r, w)], B2[word<RS>(r, w + 4)]);
      }
    }
  }
}

// The A fragment of contraction step kk of a row-major tile (rows a0 + g
// and a0 + g + 8, words 8 kk + t and + 4): float32 tiles split into tf32
// hi/lo, bf16 tiles (two to a word) as they stand in hi, lo zero.  A
// caller that multiplies one A operand by many B tiles loads it once.
template <typename T, int RS>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const uint32_t* As, int a0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = 8 * kk + t;
  const uint32_t x[4] = {As[word<RS>(a0 + g, w)], As[word<RS>(a0 + g + 8, w)],
                         As[word<RS>(a0 + g, w + 4)],
                         As[word<RS>(a0 + g + 8, w + 4)]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
    } else {
      hi[i] = x[i];
      lo[i] = 0u;
    }
  }
}

// One contraction step kk of a "scores" product whose A operand the caller
// holds in registers (load_a): acc[j] += A . B[8j + 0..7, step kk]^T for j
// < nt, B a row-major tile.  float32 through 3xTF32 with B split as it is
// read; bf16 through one bf16 MMA.
template <typename T, int RS, int NT>
__device__ __forceinline__ void scores_step(float (&acc)[NT][4],
                                            const uint32_t (&ahi)[4],
                                            const uint32_t (&alo)[4],
                                            const uint32_t* Bs, int kk,
                                            int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = 8 * kk + t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int r = 8 * j + g;
      if constexpr (sizeof(T) == 4) {
        const float* B = reinterpret_cast<const float*>(Bs);
        uint32_t bh[2], bl[2];
        split_tf32(B[word<RS>(r, w)], bh[0], bl[0]);
        split_tf32(B[word<RS>(r, w + 4)], bh[1], bl[1]);
        mma_3xtf32(acc[j], ahi, alo, bh, bl);
      } else {
        mma_bf16(acc[j], ahi, Bs[word<RS>(r, w)], Bs[word<RS>(r, w + 4)]);
      }
    }
  }
}

// The "accumulate" product of one warp: out[c] (16 x 8) += P . X[0..8*nt,
// col0 + 8c + 0..7] for c < NO, P (16 x 8*nt) held in registers in C
// layout (the output of a scores product), X a row-major float32 tile
// whose rows are the contraction.  tf32 cannot take C fragments as A directly, so the
// contraction index is permuted inside each 8-row step: MMA position t is
// row 2t, position t + 4 is row 2t + 1.  Then a = (c0, c2, c1, c3) and b
// reads rows 2t and 2t + 1 of column g.
template <int RS, int NT, int NO>
__device__ __forceinline__ void accumulate_tf32(float (&out)[NO][4],
                                                const float (&P)[NT][4],
                                                const uint32_t* Xs, int col0,
                                                int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* X = reinterpret_cast<const float*>(Xs);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      uint32_t ahi[4], alo[4];
      split_tf32(P[j][0], ahi[0], alo[0]);
      split_tf32(P[j][2], ahi[1], alo[1]);
      split_tf32(P[j][1], ahi[2], alo[2]);
      split_tf32(P[j][3], ahi[3], alo[3]);
      const int r = 8 * j + 2 * t;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const int w = col0 + 8 * c + g;
        uint32_t bhi[2], blo[2];
        split_tf32(X[word<RS>(r, w)], bhi[0], blo[0]);
        split_tf32(X[word<RS>(r + 1, w)], bhi[1], blo[1]);
        mma_3xtf32(out[c], ahi, alo, bhi, blo);
      }
    }
  }
}

// bf16: the C fragments of two 8-column tiles, rounded to bf16, are the A
// fragment of one k16 step as they stand; X's B fragments come from
// ldmatrix.trans (two output tiles a call).  nt is even here.
template <int RS, int NT, int NO>
__device__ __forceinline__ void accumulate_bf16(float (&out)[NO][4],
                                                const float (&P)[NT][4],
                                                const uint32_t* Xs, int col0,
                                                int nt) {
  static_assert(NT % 2 == 0 && NO % 2 == 0, "k16 steps, paired tiles");
  const int lane = threadIdx.x & 31, m = lane >> 3;
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    if (2 * jj < nt) {
      const uint32_t a[4] = {pack_bf16(P[2 * jj][0], P[2 * jj][1]),
                             pack_bf16(P[2 * jj][2], P[2 * jj][3]),
                             pack_bf16(P[2 * jj + 1][0], P[2 * jj + 1][1]),
                             pack_bf16(P[2 * jj + 1][2], P[2 * jj + 1][3])};
      const int r = 16 * jj + (m & 1) * 8 + (lane & 7);
#pragma unroll
      for (int c = 0; c < NO; c += 2) {
        const int chunk = (col0 + 8 * c) / 8 + (m >> 1);  // 8 bf16 a chunk
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(Xs + r * RS + (chunk << 2)));
        mma_bf16(out[c], a, b[0], b[1]);
        mma_bf16(out[c + 1], a, b[2], b[3]);
      }
    }
  }
}

}  // namespace frag
