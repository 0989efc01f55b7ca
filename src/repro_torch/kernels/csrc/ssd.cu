// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/ssd.py:
//   ssd_chunk_scan  <-  _ssd_kernel (ssd.py:31), wrapper ssd_chunked_kernel
//                       (ssd.py:75)
//
// What it computes. Per (batch b, head h), over T positions cut into
// chunks of Q (T a multiple of Q; the caller pads), all in f32:
//   xdt (B,H,T,P)  the dt-scaled input x*dt
//   b, c (B,G,T,N) shared by the H/G heads of group h / (H/G)
//   a (B,H,T)      the log decay dt*A (<= 0)
//   init (B,H,N,P) the state before the first chunk, or null for zero
// For each chunk, with S the state carried in from the chunk before and
// cums the inclusive cumulative sum of a within the chunk:
//   y = ((C B^T) o L) x + exp(cums) o (C S),  L[i,j] = exp(cums_i - cums_j)
//       for i >= j and 0 above the diagonal (exp is taken only where
//       i >= j: above it the exponent is positive and can overflow);
//   S = exp(total) S + (B o exp(total - cums))^T x,  total = cums[Q-1].
// Outputs y (B,H,T,P) and the final state (B,H,N,P).
//
// Design (simple and right first). One block of 512 threads per (b, h)
// walks the chunks in order and keeps the (N, P) state in shared memory:
// the TPU's sequential chunk grid axis becomes a loop inside the block.
// Each chunk starts with its cums: the first warp scans the chunk's a in
// shared memory (each lane sums a run of Q/32 positions in order, then the
// lanes' totals are scanned across the warp).
// Within a chunk it never holds a whole Q x Q or Q x N tile: it takes
// row tiles of 64 positions (C_i) and, for each, the column tiles j <= i
// (B_j, x_j), building one 64 x 64 decayed score tile at a time in
// shared memory. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 32a and columns tx + 16b of each register tile: scores (2 x 4),
// y (2 x PPT over P) and the chunk's state update (NPT x PPT over N x P),
// the last accumulated when the diagonal tile j = i has B_j and x_j in
// shared memory, so every column tile feeds it exactly once. Tiles are
// staged as f32, rows of B, C and the scores padded by 4 floats, so the
// contraction operands are read 4 at a time (float4) without bank
// conflicts. All products are FMA chains over shared memory in f32, each
// summed in index order.
//
// Bound on an H100 SXM at the serving shape (B=4, T=1024, H=24, P=64,
// N=128, G=1, Q=256): 58 MB of traffic, 17 us at 3.35 TB/s, against about
// 8.1e9 useful FLOPs (the causal half of the two Q x Q products, the
// inter-chunk product and the state update), 8 us at the 989 TFLOP/s
// tensor-core rate: bound by bytes. This kernel runs those FLOPs on the
// f32 FMA pipes instead (67 TFLOP/s, 120 us at best), so it cannot come
// near the bound. What this design does about it: little.
// 512 threads a block and float4 operand reads keep more FMAs in flight
// than a first 256-thread version, but B*H blocks (96 here) under-fill
// the 132 SMs, each block holds one SM's shared memory, loads are not
// overlapped with math, and the FMA pipes run at a fraction of their
// rate; wgmma/TMA tiles and chunk-parallel state passing are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                // positions per row / column tile
constexpr int kThreads = 512;
constexpr int kTy = kThreads / 16;       // (ty, tx) = (tid / 16, tid % 16)
constexpr int kRA = kRows / kTy;         // tile rows per thread
constexpr int kLdP = kRows + 4;          // score tile row, 16-byte aligned
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDim = 128;             // N and P

// rows [0, nr) of a (rows, width) global tile into shared memory with
// leading dimension ld; rows [nr, kRows) are zero. Element e = r * width
// + k walks in steps of kThreads, (r, k) advanced without a division.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int nr, int width, int ld) {
  const int dr = kThreads / width;
  const int dk = kThreads - dr * width;
  int r = threadIdx.x / width;
  int k = threadIdx.x - r * width;
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    dst[r * ld + k] = r < nr ? src[e] : 0.f;
    r += dr;
    k += dk;
    if (k >= width) {
      k -= width;
      ++r;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int NPT, int PPT>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_scan_kernel(const float* __restrict__ xdt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ am,
                          const float* __restrict__ init,
                          float* __restrict__ y, float* __restrict__ state,
                          int H, int G, int T, int Q, int N, int P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldn = N + 4;                   // N % 4 == 0: rows stay aligned
  float* s_st = smem;                      // (N, P) carried state
  float* s_c = s_st + N * P;               // (kRows, N+4) C row tile
  float* s_b = s_c + kRows * ldn;          // (kRows, N+4) B column tile
  float* s_x = s_b + kRows * ldn;          // (kRows, P) x column tile
  float* s_p = s_x + kRows * P;            // (kRows, kRows+4) decayed scores
  float* s_cum = s_p + kRows * kLdP;       // (Q) the chunk's cums
  float* s_w = s_cum + Q;                  // (kRows) exp(total - cums_j)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int grp = (bh % H) / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* xb = xdt + (size_t)bh * T * P;
  const float* ab = am + (size_t)bh * T;
  const float* bb = bm + ((size_t)b * G + grp) * T * N;
  const float* cb = cm + ((size_t)b * G + grp) * T * N;
  float* yb = y + (size_t)bh * T * P;

  for (int e = tid; e < N * P; e += kThreads)
    s_st[e] = init ? init[(size_t)bh * N * P + e] : 0.f;

  const int n_chunks = T / Q;
  const int n_tiles = (Q + kRows - 1) / kRows;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t t0 = (size_t)ch * Q;
    __syncthreads();                       // last chunk's state is written
    for (int i = tid; i < Q; i += kThreads) s_cum[i] = ab[t0 + i];
    __syncthreads();
    if (tid < 32) {                        // s_cum: a -> its inclusive scan
      const int per = (Q + 31) / 32;
      const int lo = min(Q, tid * per);
      const int hi = min(Q, lo + per);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += s_cum[i];
        s_cum[i] = run;
      }
      float inc = run;                     // lanes 0..tid's runs
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += v;
      }
      float base = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) base = 0.f;
      for (int i = lo; i < hi; ++i) s_cum[i] += base;
    }
    __syncthreads();
    const float total = s_cum[Q - 1];

    float sacc[NPT][PPT];
#pragma unroll
    for (int a = 0; a < NPT; ++a)
#pragma unroll
      for (int e = 0; e < PPT; ++e) sacc[a][e] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kRows;
      __syncthreads();                     // s_c is free
      load_rows(s_c, cb + (t0 + i0) * N, min(kRows, Q - i0), N, ldn);
      __syncthreads();

      // inter-chunk term: exp(cums_i) * (C_i S), C read 4 n at a time
      float yacc[kRA][PPT];
#pragma unroll
      for (int a = 0; a < kRA; ++a)
#pragma unroll
        for (int e = 0; e < PPT; ++e) yacc[a][e] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[kRA];
#pragma unroll
        for (int a = 0; a < kRA; ++a)
          cv[a] = ld4(&s_c[(ty + kTy * a) * ldn + n]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          float sv[PPT];
#pragma unroll
          for (int e = 0; e < PPT; ++e) {
            const int p = tx + 16 * e;
            sv[e] = p < P ? s_st[(n + nn) * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < kRA; ++a)
#pragma unroll
            for (int e = 0; e < PPT; ++e)
              yacc[a][e] += at(cv[a], nn) * sv[e];
        }
      }
#pragma unroll
      for (int a = 0; a < kRA; ++a) {
        const int i = i0 + ty + kTy * a;
        const float dec = i < Q ? expf(s_cum[i]) : 0.f;
#pragma unroll
        for (int e = 0; e < PPT; ++e) yacc[a][e] *= dec;
      }

      // intra-chunk term over the column tiles up to the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kRows;
        const int nj = min(kRows, Q - j0);
        __syncthreads();                   // s_b, s_x, s_p, s_w are free
        load_rows(s_b, bb + (t0 + j0) * N, nj, N, ldn);
        load_rows(s_x, xb + (t0 + j0) * P, nj, P, P);
        if (jt == it)
          for (int c = tid; c < kRows; c += kThreads)
            s_w[c] = c < nj ? expf(total - s_cum[j0 + c]) : 0.f;
        __syncthreads();

        // scores C_i B_j^T, both read 4 k at a time
        float sc[kRA][4];
#pragma unroll
        for (int a = 0; a < kRA; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[a][e] = 0.f;
        for (int k = 0; k < N; k += 4) {
          float4 cv[kRA], bv[4];
#pragma unroll
          for (int a = 0; a < kRA; ++a)
            cv[a] = ld4(&s_c[(ty + kTy * a) * ldn + k]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bv[e] = ld4(&s_b[(tx + 16 * e) * ldn + k]);
#pragma unroll
          for (int a = 0; a < kRA; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[a][e] += cv[a].x * bv[e].x;
              sc[a][e] += cv[a].y * bv[e].y;
              sc[a][e] += cv[a].z * bv[e].z;
              sc[a][e] += cv[a].w * bv[e].w;
            }
        }
#pragma unroll
        for (int a = 0; a < kRA; ++a) {
          const int i = i0 + ty + kTy * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + tx + 16 * e;
            s_p[(ty + kTy * a) * kLdP + tx + 16 * e] =
                (i >= j && i < Q) ? sc[a][e] * expf(s_cum[i] - s_cum[j])
                                  : 0.f;
          }
        }
        __syncthreads();

        // y_i += P x_j, P read 4 columns at a time (entries past the
        // tile's valid rows and x's zero rows contribute 0)
        for (int c = 0; c < nj; c += 4) {
          float4 pv[kRA];
#pragma unroll
          for (int a = 0; a < kRA; ++a)
            pv[a] = ld4(&s_p[(ty + kTy * a) * kLdP + c]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float xv[PPT];
#pragma unroll
            for (int e = 0; e < PPT; ++e) {
              const int p = tx + 16 * e;
              xv[e] = p < P ? s_x[(c + cc) * P + p] : 0.f;
            }
#pragma unroll
            for (int a = 0; a < kRA; ++a)
#pragma unroll
              for (int e = 0; e < PPT; ++e)
                yacc[a][e] += at(pv[a], cc) * xv[e];
          }
        }

        if (jt == it) {                    // this column tile's state update
#pragma unroll 4
          for (int c = 0; c < nj; ++c) {
            const float w = s_w[c];
            float bv[NPT], xv[PPT];
#pragma unroll
            for (int a = 0; a < NPT; ++a) {
              const int n = ty + kTy * a;
              bv[a] = n < N ? s_b[c * ldn + n] * w : 0.f;
            }
#pragma unroll
            for (int e = 0; e < PPT; ++e) {
              const int p = tx + 16 * e;
              xv[e] = p < P ? s_x[c * P + p] : 0.f;
            }
#pragma unroll
            for (int a = 0; a < NPT; ++a)
#pragma unroll
              for (int e = 0; e < PPT; ++e) sacc[a][e] += bv[a] * xv[e];
          }
        }
      }

#pragma unroll
      for (int a = 0; a < kRA; ++a) {
        const int i = i0 + ty + kTy * a;
        if (i < Q) {
#pragma unroll
          for (int e = 0; e < PPT; ++e) {
            const int p = tx + 16 * e;
            if (p < P) yb[(t0 + i) * P + p] = yacc[a][e];
          }
        }
      }
    }

    __syncthreads();                       // every read of S is done
    const float decay = expf(total);
#pragma unroll
    for (int a = 0; a < NPT; ++a) {
      const int n = ty + kTy * a;
#pragma unroll
      for (int e = 0; e < PPT; ++e) {
        const int p = tx + 16 * e;
        if (n < N && p < P)
          s_st[n * P + p] = decay * s_st[n * P + p] + sacc[a][e];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads)
    state[(size_t)bh * N * P + e] = s_st[e];
}

size_t smem_bytes(int Q, int N, int P) {
  return sizeof(float) *
         ((size_t)N * P + 2 * (size_t)kRows * (N + 4) + (size_t)kRows * P +
          (size_t)kRows * kLdP + Q + kRows);
}

template <int NPT, int PPT>
int launch(const float* xdt, const float* b, const float* c,
           const float* a, const float* init, float* y, float* state,
           int B, int H, int G, int T, int Q, int N, int P,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N, P);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_chunk_scan_kernel<NPT, PPT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * H, kThreads, smem, stream>>>(xdt, b, c, a, init, y, state,
                                            H, G, T, Q, N, P);
  return (int)cudaGetLastError();
}

// PPT: the smallest power of two with 16 * PPT >= P (and NPT with 32 * NPT
// >= N), as template arguments
#define SSD_DISPATCH_P(NPT)                                              \
  do {                                                                   \
    if (P <= 16) return launch<NPT, 1>(ARGS);                            \
    if (P <= 32) return launch<NPT, 2>(ARGS);                            \
    if (P <= 64) return launch<NPT, 4>(ARGS);                            \
    return launch<NPT, 8>(ARGS);                                         \
  } while (0)

}  // namespace

// All tensors f32 and contiguous, checked by the Python wrapper: xdt and y
// (B,H,T,P); b, c (B,G,T,N); a (B,H,T); init (B,H,N,P) or null; state
// (B,H,N,P). T is a multiple of Q, H of G, N of 4, and N, P <= 128. Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_chunk_scan(const float* xdt, const float* b,
                              const float* c, const float* a,
                              const float* init, float* y, float* state,
                              int B, int H, int G, int T, int Q, int N,
                              int P, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || T <= 0 || Q <= 0 ||
      T % Q != 0 || N <= 0 || N > kMaxDim || N % 4 != 0 || P <= 0 ||
      P > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS xdt, b, c, a, init, y, state, B, H, G, T, Q, N, P, st
  if (N <= 32) SSD_DISPATCH_P(1);
  if (N <= 64) SSD_DISPATCH_P(2);
  SSD_DISPATCH_P(4);
#undef ARGS
}
