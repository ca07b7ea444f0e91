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
// is already the K x N operand and needs no repacking.  Each 256-thread block
// owns one 64 x 64 output tile.  Per 16-deep K chunk it gathers the A tile
// (64 pixels x 16 taps) straight from NHWC into shared memory, zero for
// padding taps, stages the B tile (16 x 64 weights), and every thread then
// accumulates a 4 x 4 register tile with FMAs on the CUDA cores.  The
// epilogue applies the affine and the ReLU to the accumulators and stores
// once: the conv output never makes a round trip through device memory.
//
// The TPU kernel's grid of one image per step with whole-image VMEM blocks
// does not fit 227 KB of shared memory and would leave most of the 132 SMs
// idle; tiling the pixel dimension of all images together fills the card at
// every ResNet stage.
//
// What bounds it: in float32 this runs on the CUDA cores, so the bound is
// the FLOPs (2*M*N*K) over the card's float32 non-tensor peak (67 TFLOP/s on
// an H100 SXM), except for the 1x1 convs at 7x7 and small batches, where
// the bytes of the weight over HBM bandwidth dominate.  This first version
// keeps 16 FMAs per two shared-memory vector loads and single-buffers its
// stages; wgmma, TMA-fed multi-stage pipelines and a tensor-core bf16 path
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                              // output pixels per block
constexpr int BN = 64;                              // output channels per block
constexpr int BK = 16;                              // K depth per stage
constexpr int TM = 4;                               // pixels per thread
constexpr int TN = 4;                               // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);      // 256
constexpr int APAD = 4;                             // keeps float4 rows aligned

static_assert(THREADS == BM * BK / 4, "A loader: 4 taps per thread");
static_assert(THREADS == BK * BN / 4, "B loader: 4 channels per thread");

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo, SH, SW, PT, PL, relu;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
conv_bn_relu_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, TX* __restrict__ out,
                    Shape s) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int M = s.B * s.Ho * s.Wo;
  const int K = s.KH * s.KW * s.Cin;
  const int N = s.Cout;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A loader: one output pixel and 4 consecutive taps per thread, so
  // neighbouring threads read neighbouring input channels.
  const int a_m = tid / 4;
  const int a_k = (tid % 4) * 4;
  const int gm = m0 + a_m;
  const bool m_ok = gm < M;
  int ih0 = 0, iw0 = 0;
  long long x_img = 0;
  if (m_ok) {
    const int ow = gm % s.Wo;
    const int t = gm / s.Wo;
    const int oh = t % s.Ho;
    const int b = t / s.Ho;
    ih0 = oh * s.SH - s.PT;
    iw0 = ow * s.SW - s.PL;
    x_img = (long long)b * s.H * s.W * s.Cin;
  }
  // B loader: one K row and 4 consecutive output channels per thread.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  // Compute tile of this thread.
  const int tm = (tid / (BN / TN)) * TM;
  const int tn = (tid % (BN / TN)) * TN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_k + i;
      float v = 0.f;
      if (m_ok && gk < K) {
        const int tap = gk / s.Cin;
        const int ci = gk - tap * s.Cin;
        const int ki = tap / s.KW;
        const int kj = tap - ki * s.KW;
        const int ih = ih0 + ki;
        const int iw = iw0 + kj;
        if (ih >= 0 && ih < s.H && iw >= 0 && iw < s.W)
          v = to_f32(x[x_img + ((long long)ih * s.W + iw) * s.Cin + ci]);
      }
      As[a_k + i][a_m] = v;
    }
    {
      const int gk = k0 + b_k;
      const long long row = (long long)gk * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + b_n + j;
        Bs[b_k][b_n + j] = (gk < K && gn < N) ? to_f32(w[row + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tm]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float sc[TN], bi[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tn + j;
    sc[j] = gn < N ? scale[gn] : 0.f;
    bi[j] = gn < N ? bias[gn] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i;
    if (m >= M) continue;
    TX* orow = out + (long long)m * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tn + j;
      if (gn >= N) continue;
      float y = fmaf(acc[i][j], sc[j], bi[j]);
      if (s.relu) y = fmaxf(y, 0.f);
      orow[gn] = from_f32<TX>(y);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            void* out, const Shape& s, cudaStream_t stream) {
  const long long M = (long long)s.B * s.Ho * s.Wo;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((s.Cout + BN - 1) / BN));
  conv_bn_relu_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TX*>(out), s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 when the launch was accepted).  Allocates nothing and does
// not synchronise: the caller owns every buffer and the stream.
extern "C" int tpuic_conv_bn_relu(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int B, int H, int W, int Cin,
                                  int KH, int KW, int Cout, int Ho, int Wo,
                                  int SH, int SW, int PT, int PL, int relu,
                                  int x_dtype, int w_dtype, void* stream) {
  const Shape s{B, H, W, Cin, KH, KW, Cout, Ho, Wo, SH, SW, PT, PL, relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    launch<float, float>(x, w, scale, bias, out, s, st);
  else if (x_dtype == 1 && w_dtype == 0)
    launch<__nv_bfloat16, float>(x, w, scale, bias, out, s, st);
  else if (x_dtype == 1 && w_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, bias, out, s, st);
  else if (x_dtype == 0 && w_dtype == 1)
    launch<float, __nv_bfloat16>(x, w, scale, bias, out, s, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
