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
// Outputs y (B,H,T,P) and the final state (B,H,N,P). Every block that
// needs a chunk's cums scans the chunk's a itself, with one rule
// (chunk_scan), so all of them agree bit for bit.
//
// Two bodies; the wrapper picks by shape (kernels/ssd.py::ssd_body).
//
// Tensor-core body (N and P multiples of 16: mamba2's N=128, P=64). The
// serial chunk walk of the TPU grid becomes three phases:
//   (a) a block per (b, h, chunk, 64 rows of N, slice of P) scans the
//       chunk's decay and forms its state contribution U_c = (B o
//       exp(total - cums))^T x into a scratch (B,H,nc,N,P), with the
//       chunk's total beside it;
//   (b) ssd_chunk_scan_pass_kernel, a thread per (b, h, 4 entries of the
//       state), walks the chunks: S_prev(c) = S, S = exp(total_c) S + U_c,
//       writing each chunk's S_prev over its U_c and the final state;
//   (c) a block per (b, h, chunk, 64-row tile, slice of P) writes its rows
//       of y: C S_prev first, then the column tiles up to the diagonal.
// With one chunk (nc = 1: the engine's chunk step, T <= chunk) S_prev is
// init itself, so (a), whose blocks then write the final state, and (c)
// run as one launch, the output blocks first. The P slices (p_split,
// chosen by the wrapper) add blocks where B*H is small: at the chunk step
// 24 (b, h) pairs become 96 output blocks.
// Every product runs on bf16 mma.sync.m16n8k16 with f32 accumulators. Its
// f32 operands are staged in shared memory as three bf16 parts, hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), whose sum is v
// exactly, and the six part products of weight >= 2^-16 run (hi.hi,
// hi.mid, mid.hi, hi.lo, lo.hi, mid.mid): each term is the f32 product to
// within about 2^-24. Two parts (hi.hi + hi.lo + lo.hi) leave 2^-16 a
// term, which at mamba2's chunk step moves y and the state further from
// the plain version than the FMA body lies from it, past the 2x this
// design allows itself (kernels/ssd.py::_ssd_split_torch models both
// splits on the CPU; tests/test_torch_ssd.py). Each 16-deep k step's
// part products go to a fresh accumulator that an f32 add carries into
// the sum (the tensor cores truncate as they accumulate). The masked,
// decayed score tile (C B^T o L) is formed in f32 in the accumulators and
// split into three parts as the A operand of the product with x: an
// accumulator's layout is the A operand's. A block of (c) holds its 16
// rows of C a warp as A fragments in registers for the whole tile, so its
// shared memory (B_j and x_j parts, or S_prev's) leaves room for two
// blocks an SM. Fragments are read with ldmatrix from part tiles whose
// rows are padded by 16 bytes (the eight rows of an ldmatrix fall in
// distinct banks).
//
// FMA body (other shapes, such as N = 4 or P = 8): one block of 512
// threads per (b, h) walks the chunks in order and keeps the (N, P) state
// in shared memory; 64-row tiles of C and, up to the diagonal, 64-column
// tiles of B and x are staged as f32, and every product is an FMA chain in
// index order.
//
// Bound on an H100 SXM (700 W) at mamba2-130m's whole prompt (B=4, T=1024,
// H=24, P=64, N=128, G=1, Q=256): 58 MB of traffic, 17.3 us at 3.35
// TB/s, against 8.07 GFLOP of useful work (the causal half of the two Q x
// Q products, the inter-chunk product and the state update), 8.2 us at
// the 989 TFLOP/s bf16 tensor-core rate: bound by bytes. As built, each
// useful product runs six part products: 48.4 GFLOP, 49.0 us, so the
// tensor-core body is bound by operations. The engine's chunk step (B=1,
// T=Q=64) moves 2.43 MB, 0.73 us, for 0.07 GFLOP (0.42 us as built):
// bound by bytes, and in practice by the latency of a few dependent
// phases in each of its blocks.
// What holds this design back is its staging, not its products: the
// build with -DSSD_TIME_NO_PRODUCTS (every part product left out; its
// results are wrong, chip_smoke.py phase 11 only times it) takes more
// than half of the full build's time at the whole prompt and at the chunk
// step. Each (b, h) block loads and splits C_i, S_prev, B_j and x_j
// itself, so at G = 1 the 24 heads of a group each stage the same B and
// C, and a block's loads are not overlapped with its own products (two
// blocks an SM overlap each other's). Next: share B_j, C_i and the scores
// C_i B_j^T across the heads of a group.
#include <cuda_bf16.h>
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

// s_cum[0, Q) holds a chunk's a; the first warp (the caller's threads 0-31)
// replaces it by its inclusive scan: lane l sums its run of ceil(Q / 32)
// positions in order, then the runs' totals are scanned across the warp
// and added back. Every body scans with this one rule.
__device__ __forceinline__ void chunk_scan(float* s_cum, int Q) {
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, lane * per);
  const int hi = min(Q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += s_cum[i];
    s_cum[i] = run;
  }
  float inc = run;                         // lanes 0..lane's runs
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  float base = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) base = 0.f;
  for (int i = lo; i < hi; ++i) s_cum[i] += base;
}

// ------------------------------------------------------------------------
// FMA body
// ------------------------------------------------------------------------

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
    if (tid < 32) chunk_scan(s_cum, Q);
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

int launch_fma(const float* xdt, const float* b, const float* c,
               const float* a, const float* init, float* y, float* state,
               int B, int H, int G, int T, int Q, int N, int P,
               cudaStream_t st) {
#define ARGS xdt, b, c, a, init, y, state, B, H, G, T, Q, N, P, st
  if (N <= 32) SSD_DISPATCH_P(1);
  if (N <= 64) SSD_DISPATCH_P(2);
  SSD_DISPATCH_P(4);
#undef ARGS
}

// ------------------------------------------------------------------------
// Tensor-core body: bf16 mma.sync on exact three-part splits
// ------------------------------------------------------------------------

constexpr int kMmaThreads = 128;          // 4 warps, 16 rows of a tile each
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col): bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// f32 x0, x1 -> bf16x2 parts hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid) (x0 in the low halves). Each remainder is exact in
// f32 and the last has at most 8 significant bits, so hi + mid + lo == x.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h);
  const float r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - __low2float(m),
                                    r1 - __high2float(m)));
}

// the A operand (16 rows x 16 k) of an f32 tile held as two n8
// accumulator tiles c0 (k 0-7) and c1 (k 8-15), as three parts a[part]
__device__ __forceinline__ void a_split3(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[3][4]) {
  split3(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// c += a * b over three-part operands (a[part], and b[part] as an ldmatrix
// x4 whose registers 2n, 2n+1 are n-tile n's): the six part products of
// weight >= 2^-16, the smallest first, into a fresh accumulator that an
// f32 add carries into c. The planted build SSD_PLANT_HI_ONLY keeps
// hi.hi alone; the timing build SSD_TIME_NO_PRODUCTS runs none.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a)[3][4],
                                     const uint32_t (&b)[3][4], int n) {
#ifdef SSD_TIME_NO_PRODUCTS
  c[0] += __uint_as_float(a[0][0] ^ b[0][2 * n]);   // operands kept live
  return;
#endif
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#ifndef SSD_PLANT_HI_ONLY
  mma_bf16(p, a[1], b[1][2 * n], b[1][2 * n + 1]);
  mma_bf16(p, a[2], b[0][2 * n], b[0][2 * n + 1]);
  mma_bf16(p, a[0], b[2][2 * n], b[2][2 * n + 1]);
  mma_bf16(p, a[1], b[0][2 * n], b[0][2 * n + 1]);
  mma_bf16(p, a[0], b[1][2 * n], b[1][2 * n + 1]);
#endif
  mma_bf16(p, a[0], b[0][2 * n], b[0][2 * n + 1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e];
}

// rows [0, ROWS) x columns [0, WIDTH) of three bf16 part tiles (hi, mid
// and lo at dst, dst + part, dst + 2 * part; leading dimension ld) from
// the f32 rows of src, stride floats apart: element (r, k) is src[r *
// stride + k], times rscale[r] where rscale is given, for r < nr and k <
// cols, else 0. cols is a multiple of 4 and src's rows 16-byte aligned.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void stage3(bf16* dst, int part, int ld,
                                       const float* __restrict__ src,
                                       int stride, int nr, int cols,
                                       const float* rscale) {
  constexpr int kV4 = WIDTH / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kV4; e += kMmaThreads) {
    const int r = e / kV4;
    const int k = (e - r * kV4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr && k < cols) {
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * stride +
                                                k));
      if (rscale != nullptr) {
        const float s = rscale[r];
        v.x *= s;
        v.y *= s;
        v.z *= s;
        v.w *= s;
      }
    }
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v.x, v.y, h0, m0, l0);
    split3(v.z, v.w, h1, m1, l1);
    bf16* d = dst + r * ld + k;
    *reinterpret_cast<uint2*>(d) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(d + part) = make_uint2(m0, m1);
    *reinterpret_cast<uint2*>(d + 2 * part) = make_uint2(l0, l1);
  }
}

struct MmaArgs {
  const float* xdt;
  const float* b;
  const float* c;
  const float* a;
  const float* init;   // (B,H,N,P) or null
  const float* sprev;  // (B*H, nc, N, P): the state before each chunk
  float* y;
  float* state;
  float* upd;          // (B*H, nc, N, P) scratch: U_c, then S_prev(c)
  float* totals;       // (B*H, nc) scratch: each chunk's total decay
  int BH, H, G, T, Q, N, P, nc, p_split;
  int n_out;           // blocks [0, n_out) write y, the rest U_c / state
};

// shared memory of an output block: one region that holds C's parts (read
// into registers), then S_prev's, then each column tile's B_j and x_j
// parts; the chunk's cums behind it
template <int NK, int PT>
__host__ __device__ constexpr int out_region() {
  constexpr int kLdn = NK * 16 + 8;
  constexpr int kLdp = PT * 8 + 8;
  return 3 * (NK * 16 * kLdp > kRows * (kLdn + kLdp)
                  ? NK * 16 * kLdp
                  : kRows * (kLdn + kLdp));
}

// shared memory of a state block: the B and x parts of a 64-position tile,
// its 64 decay weights; the chunk's cums behind them
template <int PT>
__host__ __device__ constexpr int state_region() {
  return 3 * kRows * (kRows + 8) + 3 * kRows * (PT * 8 + 8);
}

// (c): 64 rows i0.. of chunk ch of (b, h), columns p0..p0+PS of y. Warp w
// owns rows i0 + 16w ..; its C fragments (NK k steps x 3 parts) stay in
// registers. Blocks of the last row tile come first (they walk the most
// column tiles).
template <int NK, int PT>
__device__ __forceinline__ void out_tile(const MmaArgs& g, int item,
                                         unsigned char* raw) {
  constexpr int kLdn = NK * 16 + 8;       // bf16 row of a C or B tile
  constexpr int kLdp = PT * 8 + 8;        // bf16 row of an x or S tile
  constexpr int kPartC = kRows * kLdn;    // one part of a C or B tile
  constexpr int kPartS = NK * 16 * kLdp;  // one part of S_prev
  constexpr int kPartX = kRows * kLdp;    // one part of an x tile
  bf16* reg = reinterpret_cast<bf16*>(raw);
  bf16* xs = reg + 3 * kPartC;
  float* s_cum = reinterpret_cast<float*>(reg + out_region<NK, PT>());
  const int N = g.N, P = g.P, Q = g.Q;
  const int ps_w = P / g.p_split;
  const int n_rt = (Q + kRows - 1) / kRows;
  const int per_rt = g.BH * g.nc * g.p_split;
  const int rt = n_rt - 1 - item / per_rt;
  int rest = item - (n_rt - 1 - rt) * per_rt;
  const int ps = rest % g.p_split;
  rest /= g.p_split;
  const int ch = rest % g.nc;
  const int bh = rest / g.nc;
  const int b = bh / g.H;
  const int grp = (bh - b * g.H) / (g.H / g.G);
  const int i0 = rt * kRows;
  const int p0 = ps * ps_w;
  const size_t t0 = (size_t)ch * Q;
  const float* xb = g.xdt + ((size_t)bh * g.T + t0) * P + p0;
  const float* bb = g.b + (((size_t)b * g.G + grp) * g.T + t0) * N;
  const float* cb = g.c + (((size_t)b * g.G + grp) * g.T + t0) * N;
  const float* ab = g.a + (size_t)bh * g.T + t0;
  const float* sp = (g.sprev != nullptr && (ch > 0 || g.init != nullptr))
                        ? g.sprev + ((size_t)bh * g.nc + ch) * N * P + p0
                        : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lrow = lane & 15;             // ldmatrix: A rows, trans B k
  const int lcol = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);   // B from [n][k]
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int i = tid; i < Q; i += kMmaThreads) s_cum[i] = ab[i];
  stage3<kRows, NK * 16>(reg, kPartC, kLdn, cb + (size_t)i0 * N, N,
                         min(kRows, Q - i0), N, nullptr);
  __syncthreads();
  if (tid < 32) chunk_scan(s_cum, Q);
  uint32_t cf[NK][3][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int pt = 0; pt < 3; ++pt)
      ldsm_x4(cf[kk][pt],
              reg + pt * kPartC + (warp * 16 + lrow) * kLdn + kk * 16 + lcol);
  __syncthreads();                        // cums scanned, C read

  const int r0 = i0 + warp * 16 + (lane >> 2);   // rows r0 and r0 + 8
  float cum_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) cum_r[h] = s_cum[min(r0 + 8 * h, Q - 1)];
  float yacc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;

  if (sp != nullptr) {                    // exp(cums_i) (C_i S_prev)
    stage3<NK * 16, PT * 8>(reg, kPartS, kLdp, sp, P, N, ps_w, nullptr);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int np = 0; np < PT / 2; ++np) {
        uint32_t sf[3][4];
#pragma unroll
        for (int pt = 0; pt < 3; ++pt)
          ldsm_x4_t(sf[pt], reg + pt * kPartS + (kk * 16 + lrow) * kLdp +
                                np * 16 + lcol);
        mma3(yacc[2 * np], cf[kk], sf, 0);
        mma3(yacc[2 * np + 1], cf[kk], sf, 1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dec = r0 + 8 * h < Q ? expf(cum_r[h]) : 0.f;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        yacc[j][2 * h] *= dec;
        yacc[j][2 * h + 1] *= dec;
      }
    }
  }

  for (int jt = 0; jt <= rt; ++jt) {      // ((C_i B_j^T) o L) x_j
    const int j0 = jt * kRows;
    const int nj = min(kRows, Q - j0);
    __syncthreads();                      // the region's last parts read
    stage3<kRows, NK * 16>(reg, kPartC, kLdn, bb + (size_t)j0 * N, N, nj, N,
                           nullptr);
    stage3<kRows, PT * 8>(xs, kPartX, kLdp, xb + (size_t)j0 * P, P, nj, ps_w,
                          nullptr);
    __syncthreads();
    // on the diagonal tile, this warp's rows meet columns of the first
    // warp + 1 groups of 16 only
    const int live = jt == rt ? warp + 1 : 4;
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np)
        if (np < live) {
          uint32_t bf[3][4];
#pragma unroll
          for (int pt = 0; pt < 3; ++pt)
            ldsm_x4(bf[pt], reg + pt * kPartC + (np * 16 + b_row) * kLdn +
                                kk * 16 + b_col);
          mma3(sc[2 * np], cf[kk], bf, 0);
          mma3(sc[2 * np + 1], cf[kk], bf, 1);
        }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + (e >> 1) * 8;
        const int col = j0 + j * 8 + 2 * (lane & 3) + (e & 1);
        float v = 0.f;
        if (i < Q && col <= i)
          v = sc[j][e] * expf(cum_r[e >> 1] - s_cum[col]);
        sc[j][e] = v;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < live) {
        uint32_t pa[3][4];
        a_split3(sc[2 * kk], sc[2 * kk + 1], pa);
#pragma unroll
        for (int np = 0; np < PT / 2; ++np) {
          uint32_t xf[3][4];
#pragma unroll
          for (int pt = 0; pt < 3; ++pt)
            ldsm_x4_t(xf[pt], xs + pt * kPartX + (kk * 16 + lrow) * kLdp +
                                  np * 16 + lcol);
          mma3(yacc[2 * np], pa, xf, 0);
          mma3(yacc[2 * np + 1], pa, xf, 1);
        }
      }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    if (i < Q) {
      float* yr = g.y + ((size_t)bh * g.T + t0 + i) * P + p0;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int col = j * 8 + 2 * (lane & 3);
        if (col < ps_w)
          *reinterpret_cast<float2*>(yr + col) =
              make_float2(yacc[j][2 * h], yacc[j][2 * h + 1]);
      }
    }
  }
}

// (a): chunk ch of (b, h), state rows n0..n0+63, columns p0..p0+PS: U_c =
// sum over the chunk's positions t of (B[t] exp(total - cums_t))^T x[t],
// in 64-position tiles. Warp w owns state rows n0 + 16w ... With one chunk
// it writes the final state exp(total) init + U_c; else U_c and the total.
template <int PT>
__device__ __forceinline__ void state_tile(const MmaArgs& g, int item,
                                           unsigned char* raw) {
  constexpr int kLdb = kRows + 8;
  constexpr int kLdp = PT * 8 + 8;
  constexpr int kPartB = kRows * kLdb;
  constexpr int kPartX = kRows * kLdp;
  bf16* bs = reinterpret_cast<bf16*>(raw);
  bf16* xs = bs + 3 * kPartB;
  float* s_w = reinterpret_cast<float*>(bs + state_region<PT>());
  float* s_cum = s_w + kRows;
  const int N = g.N, P = g.P, Q = g.Q;
  const int ps_w = P / g.p_split;
  const int n_ns = (N + kRows - 1) / kRows;
  const int ns = item % n_ns;
  int rest = item / n_ns;
  const int ps = rest % g.p_split;
  rest /= g.p_split;
  const int ch = rest % g.nc;
  const int bh = rest / g.nc;
  const int b = bh / g.H;
  const int grp = (bh - b * g.H) / (g.H / g.G);
  const int n0 = ns * kRows;
  const int nn = min(kRows, N - n0);      // a multiple of 16
  const int p0 = ps * ps_w;
  const size_t t0 = (size_t)ch * Q;
  const float* xb = g.xdt + ((size_t)bh * g.T + t0) * P + p0;
  const float* bb = g.b + (((size_t)b * g.G + grp) * g.T + t0) * N + n0;
  const float* ab = g.a + (size_t)bh * g.T + t0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 8;
  const int a_k = (lane & 7) + ((lane >> 4) << 3);    // A from [k][m]
  const int a_m = ((lane >> 3) & 1) * 8;

  for (int i = tid; i < Q; i += kMmaThreads) s_cum[i] = ab[i];
  __syncthreads();
  if (tid < 32) chunk_scan(s_cum, Q);
  __syncthreads();
  const float total = s_cum[Q - 1];

  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int tt = 0; tt < Q; tt += kRows) {
    const int nt = min(kRows, Q - tt);
    __syncthreads();                      // the last tile's parts read
    for (int r = tid; r < kRows; r += kMmaThreads)
      s_w[r] = r < nt ? expf(total - s_cum[tt + r]) : 0.f;
    __syncthreads();
    stage3<kRows, kRows>(bs, kPartB, kLdb, bb + (size_t)tt * N, N, nt, nn,
                         s_w);
    stage3<kRows, PT * 8>(xs, kPartX, kLdp, xb + (size_t)tt * P, P, nt,
                          ps_w, nullptr);
    __syncthreads();
    if (warp * 16 < nn) {
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        uint32_t af[3][4];
#pragma unroll
        for (int pt = 0; pt < 3; ++pt)
          ldsm_x4_t(af[pt], bs + pt * kPartB + (kk * 16 + a_k) * kLdb +
                                warp * 16 + a_m);
#pragma unroll
        for (int np = 0; np < PT / 2; ++np) {
          uint32_t xf[3][4];
#pragma unroll
          for (int pt = 0; pt < 3; ++pt)
            ldsm_x4_t(xf[pt], xs + pt * kPartX + (kk * 16 + lrow) * kLdp +
                                  np * 16 + lcol);
          mma3(acc[2 * np], af, xf, 0);
          mma3(acc[2 * np + 1], af, xf, 1);
        }
      }
    }
  }

  if (warp * 16 < nn) {
    const float dec = expf(total);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int col = j * 8 + 2 * (lane & 3);
        if (col >= ps_w) continue;
        float2 v = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        if (g.nc == 1) {
          const size_t o = ((size_t)bh * N + n) * P + p0 + col;
          if (g.init != nullptr) {
            const float2 s = *reinterpret_cast<const float2*>(g.init + o);
            v.x = s.x * dec + v.x;
            v.y = s.y * dec + v.y;
          }
          *reinterpret_cast<float2*>(g.state + o) = v;
        } else {
          *reinterpret_cast<float2*>(
              g.upd + (((size_t)bh * g.nc + ch) * N + n) * P + p0 + col) = v;
        }
      }
    }
  }
  if (g.nc > 1 && ns == 0 && ps == 0 && tid == 0)
    g.totals[(size_t)bh * g.nc + ch] = total;
}

template <int NK, int PT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_chunk_scan_mma_kernel(const MmaArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < g.n_out)
    out_tile<NK, PT>(g, blockIdx.x, smem_raw);
  else
    state_tile<PT>(g, blockIdx.x - g.n_out, smem_raw);
}

// (b): a thread per 4 consecutive state entries of one (b, h): S_prev(c)
// = S over U_c, S = exp(total_c) S + U_c, and the final state. The planted
// build SSD_PLANT_PASS_SKIPS_U0 leaves the first chunk's U_c out.
__global__ void __launch_bounds__(256)
    ssd_chunk_scan_pass_kernel(float* __restrict__ upd,
                               const float* __restrict__ totals,
                               const float* __restrict__ init,
                               float* __restrict__ state, int BH, int nc,
                               int np4) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BH * np4) return;
  const int bh = e / np4;
  float4 s = init != nullptr ? reinterpret_cast<const float4*>(init)[e]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* u4 = reinterpret_cast<float4*>(upd) + (size_t)bh * nc * np4 +
               (e - bh * np4);
  for (int c = 0; c < nc; ++c) {
    float4 u = u4[(size_t)c * np4];
    u4[(size_t)c * np4] = s;
#ifdef SSD_PLANT_PASS_SKIPS_U0
    if (c == 0) u = make_float4(0.f, 0.f, 0.f, 0.f);
#endif
    const float d = expf(totals[(size_t)bh * nc + c]);
    s.x = s.x * d + u.x;
    s.y = s.y * d + u.y;
    s.z = s.z * d + u.z;
    s.w = s.w * d + u.w;
  }
  reinterpret_cast<float4*>(state)[e] = s;
}

template <int NK, int PT>
int launch_mma(MmaArgs g, cudaStream_t st) {
  const long units = (long)g.BH * g.nc * g.p_split;
  const long n_out = units * ((g.Q + kRows - 1) / kRows);
  const long n_state = units * ((g.N + kRows - 1) / kRows);
  const size_t out_bytes = 2 * (size_t)out_region<NK, PT>() + 4 * (size_t)g.Q;
  const size_t state_bytes =
      2 * (size_t)state_region<PT>() + 4 * ((size_t)kRows + g.Q);
  const size_t smem = out_bytes > state_bytes ? out_bytes : state_bytes;
  if (smem > (size_t)kMaxSmem || n_out + n_state > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  auto kernel = ssd_chunk_scan_mma_kernel<NK, PT>;
  // opt in once, for this instantiation, past the 48 KB a block gets by
  // default
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  cudaError_t err;
  if (g.nc == 1) {                        // S_prev is init: one launch
    g.sprev = g.init;
    g.n_out = (int)n_out;
    kernel<<<(int)(n_out + n_state), kMmaThreads, smem, st>>>(g);
    return (int)cudaGetLastError();
  }
  g.n_out = 0;
  kernel<<<(int)n_state, kMmaThreads, smem, st>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int np4 = g.N * g.P / 4;
  ssd_chunk_scan_pass_kernel<<<(g.BH * np4 + 255) / 256, 256, 0, st>>>(
      g.upd, g.totals, g.init, g.state, g.BH, g.nc, np4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g.sprev = g.upd;
  g.n_out = (int)n_out;
  kernel<<<(int)n_out, kMmaThreads, smem, st>>>(g);
  return (int)cudaGetLastError();
}

// PT: n8 tiles of a P slice (16, 32, 64 or 128 columns; the slice's last
// ones zero-filled); NK: 16-deep k steps over N (32, 64 or 128)
template <int NK>
int dispatch_pt(const MmaArgs& g, cudaStream_t st) {
  const int ps_w = g.P / g.p_split;
  if (ps_w <= 16) return launch_mma<NK, 2>(g, st);
  if (ps_w <= 32) return launch_mma<NK, 4>(g, st);
  if (ps_w <= 64) return launch_mma<NK, 8>(g, st);
  return launch_mma<NK, 16>(g, st);
}

}  // namespace

// All tensors f32, contiguous and 16-byte aligned, checked by the Python
// wrapper: xdt and y (B,H,T,P); b, c (B,G,T,N); a (B,H,T); init (B,H,N,P)
// or null; state (B,H,N,P). T is a multiple of Q, H of G, N of 4, and N, P
// <= 128. body 0 runs the FMA body (one launch). body 1 runs the
// tensor-core body (N and P multiples of 16, P / p_split too): one launch
// when T == Q, else three, which need scratch: B*H*(T/Q)*(N*P + 1) floats.
// Returns cudaGetLastError() after the launches (the first that fails).
extern "C" int ssd_chunk_scan(const float* xdt, const float* b,
                              const float* c, const float* a,
                              const float* init, float* y, float* state,
                              float* scratch, int B, int H, int G, int T,
                              int Q, int N, int P, int body, int p_split,
                              void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || T <= 0 || Q <= 0 ||
      T % Q != 0 || N <= 0 || N > kMaxDim || N % 4 != 0 || P <= 0 ||
      P > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0)
    return launch_fma(xdt, b, c, a, init, y, state, B, H, G, T, Q, N, P, st);
  const int nc = T / Q;
  if (body != 1 || N % 16 != 0 || P % 16 != 0 || p_split <= 0 ||
      P % p_split != 0 || (P / p_split) % 16 != 0 ||
      (nc > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  MmaArgs g;
  g.xdt = xdt;
  g.b = b;
  g.c = c;
  g.a = a;
  g.init = init;
  g.sprev = nullptr;
  g.y = y;
  g.state = state;
  g.upd = scratch;
  g.totals = scratch == nullptr ? nullptr
                                : scratch + (size_t)B * H * nc * N * P;
  g.BH = B * H;
  g.H = H;
  g.G = G;
  g.T = T;
  g.Q = Q;
  g.N = N;
  g.P = P;
  g.nc = nc;
  g.p_split = p_split;
  g.n_out = 0;
  if (N <= 32) return dispatch_pt<2>(g, st);
  if (N <= 64) return dispatch_pt<4>(g, st);
  return dispatch_pt<8>(g, st);
}
