// Weight-only int8 matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/quant_matmul.py:
//   int8_matmul  <-  _qmm_kernel (quant_matmul.py:22), wrapper int8_matmul
//                    (quant_matmul.py:40)
//
// What it computes. out (M, N) = x (M, K) @ W, W[k, n] = w_q[k, n] *
// scale[k, n / (N / G)], with x bf16 or f32, w_q int8 (K, N), scale f32
// (K, G) and out bf16 or f32, all row-major and contiguous. The weight is
// dequantized to f32 (never rounded to x's type), every product is an f32
// FMA and each output is rounded once, to nearest even, to out's type.
// G = 1 is the TPU kernel's own (K, 1) row scale. G > 1 splits N into G
// equal column groups with a scale each: the per-(K row, head) scales of
// a (d, H, hd) projection quantized over its last axis come in as G = H
// in one launch, and each group computes exactly the TPU kernel's
// function. Any M, N, K: the ragged tiles are masked (the TPU wrapper
// instead halves its blocks until they divide).
//
// Design (simple and right first). Tiled SIMT GEMM on the f32 FMA pipes:
// a block of 256 threads computes a 128 x 128 output tile and walks K in
// tiles of 32. Each K tile is staged in shared memory as f32: x widened
// and stored transposed (k-major) and w dequantized with its row's scale
// on load, zero outside the matrix. Thread (ty, tx) = (tid / 16, tid % 16)
// keeps an 8 x 8 register tile of f32 accumulators, rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, columns likewise from tx, and reads its operands
// as float4 from shared memory. Each output sums its K products in index
// order; the result is written once.
//
// Bound on an H100 SXM at the fine-tuning step's shapes (M = 8192 tokens):
// (K, N) = (1024, 1024) is 17.2 GFLOP, 17.4 us at the 989 TFLOP/s bf16
// tensor-core rate, against 35-51 MB of traffic (bf16 or f32 out), 10-15
// us at 3.35 TB/s; the (1024, 2816) and (2816, 1024) products are 47.2
// GFLOP, 47.8 us each, against 112-128 MB, 33-38 us: bound by operations. This kernel runs them on the f32 FMA pipes (67
// TFLOP/s), where they alone take 15x the bound, and it does not overlap
// its loads with its math, so it cannot come near the bound. A
// tensor-core design has to face that the scale runs along K, so it
// cannot be factored out of the K sum (dequantize into the MMA's operand
// tile, or quantize x as well): later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBK = 32;                  // K per shared-memory tile
constexpr int kThreads = 256;            // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kBM + 4;             // padded row of a staged tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, TO* __restrict__ out, int M,
           int N, int K, int G) {
  __shared__ __align__(16) float xs[kBK][kLd];   // xs[k][m]
  __shared__ __align__(16) float ws[kBK][kLd];   // ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int group = N / G;                       // columns per scale
  // loaders: x row tid / 2, k (tid % 2) * 16 + j; w row tid / 8,
  // columns (tid % 8) * 16 + j, j < 16
  const int xr = tid >> 1, xk = (tid & 1) * 16;
  const int wr = tid >> 3, wc = (tid & 7) * 16;
  const int xm = m0 + xr;
  const TX* xrow = x + (size_t)(xm < M ? xm : 0) * K;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = k0 + xk + j;
      xs[xk + j][xr] = (xm < M && k < K) ? to_f32(xrow[k]) : 0.f;
    }
    {
      const int k = k0 + wr;
      const int8_t* wrow = wq + (size_t)(k < K ? k : 0) * N;
      const float* srow = scale + (size_t)(k < K ? k : 0) * G;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + wc + j;
        ws[wr][wc + j] = (k < K && n < N)
                             ? (float)wrow[n] * srow[n / group]
                             : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) store(out + (size_t)m * N + n, acc[i][j]);
    }
  }
}

template <typename TX, typename TO>
int launch(const void* x, const int8_t* wq, const float* scale, void* out,
           int M, int N, int K, int G, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_kernel<TX, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), wq, scale, static_cast<TO*>(out), M, N, K,
      G);
  return (int)cudaGetLastError();
}

}  // namespace

// x_kind / out_kind: 0 = f32, 1 = bf16. Returns a cudaError_t as int:
// cudaErrorInvalidValue for shapes the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int int8_matmul(const void* x, const int8_t* wq,
                           const float* scale, void* out, int M, int N,
                           int K, int G, int x_kind, int out_kind,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || N % G != 0 ||
      (M + kBM - 1) / kBM > 65535 || x_kind < 0 || x_kind > 1 ||
      out_kind < 0 || out_kind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0)
    return out_kind == 0
               ? launch<float, float>(x, wq, scale, out, M, N, K, G, s)
               : launch<float, __nv_bfloat16>(x, wq, scale, out, M, N, K,
                                              G, s);
  return out_kind == 0
             ? launch<__nv_bfloat16, float>(x, wq, scale, out, M, N, K, G,
                                            s)
             : launch<__nv_bfloat16, __nv_bfloat16>(x, wq, scale, out, M, N,
                                                    K, G, s);
}
