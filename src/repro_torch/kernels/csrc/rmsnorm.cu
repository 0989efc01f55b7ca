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
// count and any D up to 8192: rows past the last and elements past D are
// masked (the TPU wrapper instead halves its row block until it divides
// the row count).
//
// Design. A row is spread over tpr threads (a power of two, 32 to 1024);
// thread t holds the 16-byte vectors t, t + tpr, ... of its row (8 bf16 or
// 4 f32 each, NV of them at most) in registers, loaded back to back, so x
// is read once and the loads of a thread are all in flight together. Each
// thread sums its squares as a tree (independent partials, not one chain),
// a butterfly of warp shuffles sums the warp, and where tpr > 32 the warps
// of a row add their sums in order through shared memory. Then every
// thread writes x * rstd * w from the registers it holds (w read with
// the same 16-byte vectors). The mean is the sum over D and rstd is
// 1 / sqrt, two roundings, as torch.rsqrt computes it on the CPU. The
// shape follows the row count:
//   - few rows (under kSpreadRows: decode's 1 and 8): one row a block and
//     one vector a thread (tpr = D / 8 for bf16: 128 threads at D 1024),
//     so the time is one load, a short add tree and one store, and the
//     rows run on as many SMs;
//   - many rows (training's 8,192): up to four vectors a thread (one warp a
//     row at D 1024 bf16, 8 rows a block), fewer threads a row and no
//     block-wide barrier where a warp holds the row.
// Where D is not a multiple of the vector or a pointer is not 16-byte
// aligned, the same threads read and write their elements one by one.
//
// A row split over ranks (tensor parallelism: the Mamba-2 gated norm over
// d_inner, each rank holding its heads' channels) runs the same kernel
// twice around a cross-rank sum: rmsnorm_sumsq writes each row's f32 sum
// of squares of the part it holds (the loads and the sum above, nothing
// stored but the sum), the caller all-reduces those sums, and
// rmsnorm_scaled takes the summed row sums in place of its own and
// divides by the whole row's width n, not the D it holds.
//
// Bound on an H100 SXM (700 W): bytes. Each x element is read once and
// each output written once, plus w: at the training step's shape (8,192
// rows of 1,024 bf16) 33.6 MB, 10.0 us at 3.35 TB/s, against 4 operations
// an element, 0.5 us on the f32 pipes. At decode (8 rows, 33 KB) the bound
// is 0.01 us and the launch and one dependent chain of a load, a
// reduction and a store are the cost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 8192;
constexpr int kSpreadRows = 1024;     // below this, one row a block
constexpr int kRowThreads = 256;      // a block's threads with many rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements of type T (V * sizeof(T) in {8, 16, 32} bytes,
// aligned to that or to 16) -> f32
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[V]) {
  constexpr int kBytes = V * (int)sizeof(T);
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "vector size");
  alignas(16) T buf[V];
  if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(buf) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(buf)[i] =
          __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = to_f32(buf[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  static_assert(V * sizeof(T) == 16, "one 16-byte store");
  alignas(16) T buf[V];
#pragma unroll
  for (int j = 0; j < V; ++j) store(buf + j, v[j]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf);
}

// sum of V values as a balanced tree (V a power of two)
template <int V>
__device__ __forceinline__ float tree_sum(float (&s)[V]) {
#pragma unroll
  for (int w = V / 2; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) s[j] = __fadd_rn(s[j], s[j + w]);
  return s[0];
}

template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(NV == 4 ? 512 : 1024)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int rows, int D, float eps,
               int tpr_log2, int vec, const float* __restrict__ ss_in,
               float* __restrict__ ss_out, float n_mean) {
  constexpr int V = 16 / (int)sizeof(TX);
  __shared__ float red[32];
  const int tpr = 1 << tpr_log2;
  const int t = threadIdx.x & (tpr - 1);
  const int row_in_block = threadIdx.x >> tpr_log2;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> tpr_log2) + row_in_block;
  const bool live = row < rows;
  const TX* xr = x + (live ? row : 0) * (long long)D;

  float v[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = (i * tpr + t) * V;
    if (vec && live && e < D) {
      load_vec<TX, V>(xr + e, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[i][j] = (live && e + j < D) ? to_f32(xr[e + j]) : 0.f;
    }
  }
  float ss;
  if (ss_in != nullptr) {                   // the row's sum from outside
    ss = live ? ss_in[row] : 0.f;
  } else {
    float part[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float sq[V];
#pragma unroll
      for (int j = 0; j < V; ++j) sq[j] = __fmul_rn(v[i][j], v[i][j]);
      part[i] = tree_sum<V>(sq);
    }
    ss = tree_sum<NV>(part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (tpr > 32) {                         // the warps of a row, in order
      const int warps = tpr >> 5;
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
      __syncthreads();
      const float* r = red + row_in_block * warps;
      ss = r[0];
      for (int j = 1; j < warps; ++j) ss = __fadd_rn(ss, r[j]);
    }
    if (ss_out != nullptr) {                // the partial-sum pass
      if (live && t == 0) ss_out[row] = ss;
      return;
    }
  }
  if (!live) return;
  const float rstd = 1.0f / sqrtf(ss / n_mean + eps);
  TX* outr = out + row * (long long)D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = (i * tpr + t) * V;
    if (vec && e < D) {
      float wv[V], o[V];
      load_vec<TW, V>(w + e, wv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = __fmul_rn(__fmul_rn(v[i][j], rstd), wv[j]);
      store_vec<TX, V>(outr + e, o);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (e + j < D)
          store(outr + e + j,
                __fmul_rn(__fmul_rn(v[i][j], rstd), to_f32(w[e + j])));
    }
  }
}

// the launch's shape: threads a row (log2), vectors a thread, rows a block
struct Shape {
  int tpr_log2, nv, rpb;
};

Shape shape_for(int rows, int D, int x_kind) {
  const int per_vec = x_kind == 0 ? 4 : 8;
  const int nvec = (D + per_vec - 1) / per_vec;
  const bool spread = rows < kSpreadRows;
  const int want = spread ? nvec : (nvec + 3) / 4;    // threads a row
  int log2 = 5;
  while ((1 << log2) < want && log2 < 10) ++log2;
  const int tpr = 1 << log2;
  const int nv = (nvec + tpr - 1) / tpr;
  const int rpb = spread ? 1 : (tpr >= kRowThreads ? 1 : kRowThreads / tpr);
  return {log2, nv <= 1 ? 1 : (nv <= 2 ? 2 : 4), rpb};
}

// the row sums: ss_in (read instead of summing) or ss_out (the partial-sum
// pass: written, nothing else), both null for the whole-row norm; n_mean
// the width the sum is divided by
struct Sums {
  const float* in;
  float* out;
  float n_mean;
};

template <typename TX, typename TW, int NV>
int launch_nv(const void* x, const void* w, void* out, int rows, int D,
              float eps, Shape sh, int vec, Sums sums, cudaStream_t stream) {
  const int threads = (1 << sh.tpr_log2) * sh.rpb;
  const unsigned blocks = (unsigned)((rows + sh.rpb - 1) / sh.rpb);
  rmsnorm_kernel<TX, TW, NV><<<blocks, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rows, D, eps, sh.tpr_log2, vec, sums.in,
      sums.out, sums.n_mean);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int D,
           float eps, Shape sh, int vec, Sums sums, cudaStream_t s) {
  if (sh.nv == 1)
    return launch_nv<TX, TW, 1>(x, w, out, rows, D, eps, sh, vec, sums, s);
  if (sh.nv == 2)
    return launch_nv<TX, TW, 2>(x, w, out, rows, D, eps, sh, vec, sums, s);
  return launch_nv<TX, TW, 4>(x, w, out, rows, D, eps, sh, vec, sums, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the three entry points' launch: x_kind / w_kind 0 = f32, 1 = bf16
int dispatch(const void* x, const void* w, void* out, int rows, int D,
             float eps, int x_kind, int w_kind, Sums sums, void* stream) {
  if (rows <= 0 || D <= 0 || D > kMaxD || x_kind < 0 || x_kind > 1 ||
      w_kind < 0 || w_kind > 1 || !(sums.n_mean > 0.f))
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_for(rows, D, x_kind);
  const int vec = D % (x_kind == 0 ? 4 : 8) == 0 && aligned16(x) &&
                  (w == nullptr || aligned16(w)) &&
                  (out == nullptr || aligned16(out));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0)
    return w_kind == 0
               ? launch<float, float>(x, w, out, rows, D, eps, sh, vec, sums,
                                      s)
               : launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, sh,
                                              vec, sums, s);
  return w_kind == 0
             ? launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, sh, vec,
                                            sums, s)
             : launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps,
                                                    sh, vec, sums, s);
}

}  // namespace

// Rows a block of the launch for this shape (x_kind: 0 = f32, 1 = bf16),
// or -1 for a shape the kernel does not take.
extern "C" int rmsnorm_rows_per_block(int rows, int D, int x_kind) {
  if (rows <= 0 || D <= 0 || D > kMaxD || x_kind < 0 || x_kind > 1)
    return -1;
  return shape_for(rows, D, x_kind).rpb;
}

// x_kind / w_kind: 0 = f32, 1 = bf16; out has x's type. Returns a
// cudaError_t as int: cudaErrorInvalidValue for shapes or types the kernel
// does not take, else cudaGetLastError() after the launch.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int rows,
                       int D, float eps, int x_kind, int w_kind,
                       void* stream) {
  return dispatch(x, w, out, rows, D, eps, x_kind, w_kind,
                  {nullptr, nullptr, (float)D}, stream);
}

// The partial-sum pass of a split row: ss[r] = sum of x[r, :]^2 in f32 over
// the D elements held, summed as the whole-row kernel sums them.
extern "C" int rmsnorm_sumsq(const void* x, float* ss, int rows, int D,
                             int x_kind, void* stream) {
  if (ss == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(x, nullptr, nullptr, rows, D, 0.f, x_kind, 0,
                  {nullptr, ss, 1.f}, stream);
}

// The scale pass of a split row: out[r, :] = x[r, :] * rsqrt(ss[r] / n +
// eps) * w, with ss the row sums over every rank's part and n the whole
// row's width.
extern "C" int rmsnorm_scaled(const void* x, const void* w, const float* ss,
                              void* out, int rows, int D, int n, float eps,
                              int x_kind, int w_kind, void* stream) {
  if (ss == nullptr || n < D) return (int)cudaErrorInvalidValue;
  return dispatch(x, w, out, rows, D, eps, x_kind, w_kind,
                  {ss, nullptr, (float)n}, stream);
}
