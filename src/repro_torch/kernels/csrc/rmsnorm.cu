// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/rmsnorm.py:
//   rmsnorm  <-  _rmsnorm_kernel (rmsnorm.py:17), wrapper rmsnorm
//                (rmsnorm.py:24)
//
// What it computes. out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps))
// * w, every step in f32, rounded once, to nearest even, to x's type. x is
// (rows, D) row-major and contiguous, bf16 or f32; w is (D,), bf16 or f32
// (the SSM block's gated norm feeds f32 x with a bf16 weight). Any row
// count and any D up to 8192: a warp past the last row exits, a lane past
// D reads nothing (the TPU wrapper instead halves its row block until it
// divides the row count).
//
// Design (simple and right first). One warp per row, 8 rows per block of
// 256 threads. Lane i reads elements i, i + 32, ... of its row, so each
// warp load is one coalesced run, and sums their squares in f32; a
// butterfly of warp shuffles gives every lane the row's sum. The lanes
// then read the row again (from L1/L2: a bf16 row of 1,024 is 2 KB) and
// write x * rstd * w. The mean is the sum over D and rstd is 1 / sqrt, two
// roundings, as torch.rsqrt computes it on the CPU.
//
// Bound on an H100 SXM: bytes. Each x element is read once and each output
// written once, plus w: at the training step's shape (8,192 rows of 1,024
// bf16) 33.6 MB, 10.0 us at 3.35 TB/s, against 4 operations an element,
// 0.5 us on the f32 pipes. At decode (8 rows) the launch itself is the
// cost. What this design does about the bound: one pass of x from device
// memory (the second read hits the caches), no intermediate written back;
// loads are 2- or 4-byte scalars, not 16-byte vectors (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // rows per block
constexpr int kMaxD = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int rows, int D, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;                       // ragged last block
  const TX* xr = x + row * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f32(xr[d]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));         // x*x rounded, as x*x is
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rstd = 1.0f / sqrtf(ss / (float)D + eps);
  TX* outr = out + row * D;
  for (int d = lane; d < D; d += 32)
    store(outr + d, __fmul_rn(__fmul_rn(to_f32(xr[d]), rstd),
                              to_f32(w[d])));
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int D,
           float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<TX, TW><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rows, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x_kind / w_kind: 0 = f32, 1 = bf16; out has x's type. Returns a
// cudaError_t as int: cudaErrorInvalidValue for shapes or types the kernel
// does not take, else cudaGetLastError() after the launch.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int rows,
                       int D, float eps, int x_kind, int w_kind,
                       void* stream) {
  if (rows <= 0 || D <= 0 || D > kMaxD || x_kind < 0 || x_kind > 1 ||
      w_kind < 0 || w_kind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0)
    return w_kind == 0
               ? launch<float, float>(x, w, out, rows, D, eps, s)
               : launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  return w_kind == 0
             ? launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, s)
             : launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps,
                                                     s);
}
