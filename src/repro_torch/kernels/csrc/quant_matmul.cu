// Weight-only int8 matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/quant_matmul.py:
//   int8_matmul  <-  _qmm_kernel (quant_matmul.py:22), wrapper int8_matmul
//                    (quant_matmul.py:40)
//
// What it computes. out (M, N) = x (M, K) @ W, W[k, n] = w_q[k, n] *
// scale[k, n / (N / G)], with x bf16 or f32, w_q int8 (K, N), scale f32
// (K, G) and out bf16 or f32, all row-major and contiguous. The weight is
// dequantized to f32 (never rounded to x's type), every product is exact
// or rounded once in f32, sums are f32 and each output is rounded once, to
// nearest even, to out's type. G = 1 is the TPU kernel's own (K, 1) row
// scale. G > 1 splits N into G equal column groups with a scale each: the
// per-(K row, head) scales of a (d, H, hd) projection quantized over its
// last axis come in as G = H in one launch, and each group computes
// exactly the TPU kernel's function. Any M, N, K: ragged tiles are
// zero-filled (the TPU wrapper instead halves its blocks until they
// divide).
//
// Two bodies; int8_matmul_body() says which one a shape takes.
//
// Tensor-core body (qmm_mma_kernel). The scale runs along K, so it cannot
// be factored out of the K sum; instead every term reaches the tensor
// cores as bf16 parts that are exact. An f32 value v splits into three
// bf16 parts, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid),
// whose sum is v exactly (each remainder is exact in f32 and the last one
// has at most 8 significant bits), and an int8 code is exact in bf16.
//   - Scale on the weight (bf16 x, and f32 x with G > 1): as a K tile of
//     codes is staged, w = q * s is formed in f32, as the plain version
//     rounds it, and split into three parts. bf16 x enters as it is: 3
//     part products, each exact, summed in f32. f32 x is split in three
//     too and the six part products of weight >= 2^-16 run (hi.hi,
//     hi.mid, mid.hi, hi.lo, lo.hi, mid.mid); the three dropped ones are
//     below 2^-24 of the term, an f32 rounding.
//   - Scale on x (f32 x with G = 1; the down projection): s[k] is one
//     number per column of x, so x * s is formed in f32 and split in three,
//     and the codes enter as they are: 3 products.
// Either way each term is rounded at most once in f32, as in the plain
// version; the two differ in which product is rounded and in summation
// order. Blocks of 256 threads (8 warps as 2 x 4, 64 x 32 outputs each)
// compute 128 x 128 output tiles with mma.sync.m16n8k16 (bf16 in, f32
// accumulators) and walk K in tiles of 64 (bf16 x) or 32 (f32 x, whose raw
// tiles and parts take more shared memory: two blocks an SM either way).
// Each K tile's raw x, codes and scales arrive by cp.async into a double
// buffer, so the next tile lands while this one is converted and
// multiplied; the conversion (codes widened by a byte permute, one packed
// bf16 rounding a pair of values a part) writes the bf16 parts into padded
// shared tiles (rows 16 bytes longer, so the eight rows of an ldmatrix
// fall in distinct banks) and the warps read their fragments with
// ldmatrix. The part products of one 16-deep k step go to a fresh
// accumulator, which an f32 add rounded to nearest carries into the
// output's sum: the tensor cores' accumulation truncates, and on one
// accumulator across all of K its bias grows with K (at the down
// projection's K = 2,816 it put f32 outputs past the 2e-5 limit against
// the plain version). Rows, columns and K past the matrix are zero-filled
// in shared memory. It takes N % 16 == 0, K a multiple of 16 bytes of x
// (8 bf16 or 4 f32), 16-byte-aligned pointers, and column groups at least
// 19 wide (at most kMaxGroups scales a 128-column tile).
//
// SIMT body (qmm_kernel, every other shape): a 128 x 128 tile on the f32
// FMA pipes, K tiles of 32 staged in shared memory as f32 (x transposed,
// w dequantized), an 8 x 8 register tile of f32 accumulators a thread.
//
// Bound on an H100 SXM (700 W) at the fine-tuning step's shapes (M = 8192
// tokens): (K, N) = (1024, 1024) is 17.2 GFLOP, 17.37 us at the 989 TFLOP/s
// bf16 tensor-core rate, against 35-51 MB of traffic (bf16 or f32 out),
// 10-15 us at 3.35 TB/s; (1024, 2816) and (2816, 1024) are 47.2 GFLOP,
// 47.77 us each, against 112-128 MB, 33-38 us: bound by operations. A
// step weighs q/k/v, o, gate/up, down 3/1/2/1 per layer, 24 layers, twice
// (remat): 48 x 7 launches, 10.21 ms useful. As built, every useful
// product runs 3 part products (the down projection's f32 x with the scale
// on x included), so the as-built bound is 48 x (3 x 52.11 + 52.11 + 2 x
// 143.31 + 143.31) us = 30.6 ms a step (37.5 ms if down ran 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------------------
// SIMT body: f32 FMA tiles
// ------------------------------------------------------------------------

constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBK = 32;                  // K per shared-memory tile
constexpr int kThreads = 256;            // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kBM + 4;             // padded row of a staged tile

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

// ------------------------------------------------------------------------
// tensor-core body: bf16 mma.sync on exact three-part splits
// ------------------------------------------------------------------------

constexpr int kMmaBM = 128;              // output rows per block
constexpr int kMmaBN = 128;              // output columns per block
constexpr int kMmaThreads = 256;         // 8 warps, 2 (rows) x 4 (columns)
constexpr int kMaxGroups = 8;            // scale columns a tile may touch
constexpr int kBLd = kMmaBN + 8;         // bf16 row of a w operand tile
#ifdef QMM_PLANT_SPLIT_HI_ONLY           // a planted fault's build only:
constexpr int kMaxOrder = 0;             // the split operands' hi part alone
#else
constexpr int kMaxOrder = 2;             // part products i + j <= 2 run
#endif

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

// 16 (or 4) bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) rounded to bf16x2 (one conversion; a in the low half), and the
// two rounded values back in f32
__device__ __forceinline__ uint32_t round2(float a, float b, float& ra,
                                           float& rb) {
  const uint32_t h = pack_bf16(a, b);
  ra = __uint_as_float(h << 16);
  rb = __uint_as_float(h & 0xffff0000u);
  return h;
}

// eight f32 values -> three rows of eight bf16 parts (hi, mid, lo), whose
// sums are the values exactly
__device__ __forceinline__ void split3_store(const float (&v)[8],
                                             __nv_bfloat16* p0,
                                             __nv_bfloat16* p1,
                                             __nv_bfloat16* p2) {
  uint32_t h[4], m[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float ah, bh, am, bm;
    h[j] = round2(v[2 * j], v[2 * j + 1], ah, bh);
    const float ar = __fsub_rn(v[2 * j], ah);
    const float br = __fsub_rn(v[2 * j + 1], bh);
    m[j] = round2(ar, br, am, bm);
    l[j] = pack_bf16(__fsub_rn(ar, am), __fsub_rn(br, bm));
  }
  *reinterpret_cast<uint4*>(p0) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(p1) = make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(p2) = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}
// eight int8 codes -> f32, exactly: code + 128 as the low byte of the f32
// 2^23 + (code + 128), less 2^23 + 128 (a byte permute and an add, not
// the quarter-rate integer conversion)
__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = __fsub_rn(__uint_as_float(__byte_perm(w[j >> 2], 0x4b000000u,
                                                 0x7650 | (j & 3))),
                     8388736.0f);
}

template <typename TX, bool kScaleOnX>
struct MmaLayout {
  static constexpr bool kXF32 = std::is_same<TX, float>::value;
  // K per tile: 64 where x enters as it is (two blocks an SM fit in 110
  // KB each); 32 for f32 x, whose raw tiles and parts would otherwise
  // leave room for one block an SM
  static constexpr int kBK = kXF32 ? 32 : 64;
  static constexpr int kALd = kBK + 8;     // bf16 row of an x operand tile
  static constexpr int kXLdF = kBK + 4;    // f32 row of a raw x tile
  static constexpr int NA = (kScaleOnX || kXF32) ? 3 : 1;   // x parts
  static constexpr int NB = kScaleOnX ? 1 : 3;              // w parts
  // bf16 x under the scale on w is its own operand: staged in place
  static constexpr bool kXDirect = NA == 1;
  static constexpr int kXStage =
      kXF32 ? kMmaBM * kXLdF * 4 : kMmaBM * kALd * 2;       // bytes
  static constexpr int kQStage = kBK * kMmaBN;
  static constexpr int kSStage = kBK * kMaxGroups * 4;
  static constexpr int kAPart = kMmaBM * kALd * 2;
  static constexpr int kBPart = kBK * kBLd * 2;
  static constexpr int kX = 0;
  static constexpr int kQ = kX + 2 * kXStage;
  static constexpr int kS = kQ + 2 * kQStage;
  static constexpr int kA = kS + 2 * kSStage;
  static constexpr int kB = kA + (kXDirect ? 0 : NA * kAPart);
  static constexpr int kBytes = kB + NB * kBPart;
};

template <typename TX, typename TO, bool kScaleOnX>
__global__ void __launch_bounds__(kMmaThreads, 2)
qmm_mma_kernel(const TX* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale, TO* __restrict__ out, int M,
               int N, int K, int G) {
  using L = MmaLayout<TX, kScaleOnX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int gw = N / G;                          // columns per scale
  const int g0 = n0 / gw;                        // first group of the tile
  auto x_stage = [&](int st) {
    return reinterpret_cast<TX*>(smem + L::kX + st * L::kXStage);
  };
  auto q_stage = [&](int st) {
    return reinterpret_cast<int8_t*>(smem + L::kQ + st * L::kQStage);
  };
  auto s_stage = [&](int st) {
    return reinterpret_cast<float*>(smem + L::kS + st * L::kSStage);
  };
  __nv_bfloat16* a_part = reinterpret_cast<__nv_bfloat16*>(smem + L::kA);
  __nv_bfloat16* b_part = reinterpret_cast<__nv_bfloat16*>(smem + L::kB);

  // K tile kt -> stage st: x (rows past M, columns past K zero), codes
  // (rows past K, columns past N zero), scales (past K or G zero)
  auto load = [&](int kt, int st) {
    const int k0 = kt * L::kBK;
    constexpr int kPer = 16 / (int)sizeof(TX);   // x elements a chunk
    constexpr int kChunks = L::kBK / kPer;       // chunks a row
    constexpr int kLdX = L::kXF32 ? L::kXLdF : L::kALd;
    TX* xs = x_stage(st);
    for (int c = tid; c < kMmaBM * kChunks; c += kMmaThreads) {
      const int r = c / kChunks, col = (c % kChunks) * kPer;
      const bool in = m0 + r < M && k0 + col < K;
      cp_async16(xs + r * kLdX + col,
                 in ? x + (size_t)(m0 + r) * K + k0 + col : x, in);
    }
    for (int c = tid; c < L::kBK * kMmaBN / 16; c += kMmaThreads) {
      const int r = c / (kMmaBN / 16), col = (c % (kMmaBN / 16)) * 16;
      const bool in = k0 + r < K && n0 + col < N;
      cp_async16(q_stage(st) + r * kMmaBN + col,
                 in ? wq + (size_t)(k0 + r) * N + n0 + col : wq, in);
    }
    if constexpr (kScaleOnX) {
      for (int r = tid; r < L::kBK; r += kMmaThreads) {
        const bool in = k0 + r < K;
        cp_async4(s_stage(st) + r, in ? scale + k0 + r : scale, in);
      }
    } else {
      for (int c = tid; c < L::kBK * kMaxGroups; c += kMmaThreads) {
        const int r = c / kMaxGroups, j = c % kMaxGroups;
        const bool in = k0 + r < K && g0 + j < G;
        cp_async4(s_stage(st) + r * kMaxGroups + j,
                  in ? scale + (size_t)(k0 + r) * G + g0 + j : scale, in);
      }
    }
    cp_async_commit();
  };

  // the conversion's thread layout, in chunks of 8 elements: w rows
  // tid / 8 + 32 i, columns wc0 and wc0 + 64; x chunks tid + 256 i
  constexpr int kXC = L::kBK / 8;                // x chunks a row
  constexpr int kLdXs = L::kXF32 ? L::kXLdF : L::kALd; // raw x row
  const int wr0 = tid >> 3, wc0 = (tid & 7) * 8;
  // each 8-column chunk of w meets at most two scale groups (gw >= 19):
  // group gi[h] up to column jb[h] of the chunk, gi[h] + 1 from there
  int gi[2], jb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + wc0 + h * 64;
    gi[h] = n / gw - g0;
    jb[h] = (gi[h] + g0 + 1) * gw - n;
  }

  auto convert = [&](int st) {
    const float* ss = s_stage(st);
    if constexpr (!L::kXDirect) {
      // x split in three, after x * s in f32 where the scale is on x
#pragma unroll
      for (int c = tid; c < kMmaBM * kXC; c += kMmaThreads) {
        const int r = c / kXC, col = (c % kXC) * 8;
        float v[8];
        load8(x_stage(st) + r * kLdXs + col, v);
        if constexpr (kScaleOnX) {
          float s[8];
          load8(ss + col, s);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], s[j]);
        }
        split3_store(v, a_part + r * L::kALd + col,
                     a_part + L::kAPart / 2 + r * L::kALd + col,
                     a_part + L::kAPart + r * L::kALd + col);
      }
    }
#pragma unroll
    for (int wr = wr0; wr < L::kBK; wr += kMmaThreads / 8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = wc0 + h * 64;
        float v[8];
        load8(q_stage(st) + wr * kMmaBN + c, v);
        if constexpr (kScaleOnX) {               // the codes as bf16
          *reinterpret_cast<uint4*>(b_part + wr * kBLd + c) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else {
          // w = q * s in f32, as the plain version rounds it, in three
          const float s0 = ss[wr * kMaxGroups + gi[h]];
          const float s1 =
              ss[wr * kMaxGroups + min(gi[h] + 1, kMaxGroups - 1)];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __fmul_rn(v[j], j < jb[h] ? s0 : s1);
          split3_store(v, b_part + wr * kBLd + c,
                       b_part + L::kBPart / 2 + wr * kBLd + c,
                       b_part + L::kBPart + wr * kBLd + c);
        }
      }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;

  const int n_kt = (K + L::kBK - 1) / L::kBK;
  load(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();                 // tile kt landed; tile kt-1 consumed
    if (kt + 1 < n_kt) load(kt + 1, st ^ 1);
    convert(st);
    __syncthreads();
    const __nv_bfloat16* a_base =
        L::kXDirect ? reinterpret_cast<const __nv_bfloat16*>(x_stage(st))
                    : a_part;
#pragma unroll
    for (int ks = 0; ks < L::kBK / 16; ++ks) {
      uint32_t bf[L::NB][4][2];
#pragma unroll
      for (int j = 0; j < L::NB; ++j)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4_t(r, b_part + j * (L::kBPart / 2) +
                           (ks * 16 + a_row) * kBLd + wn + np * 16 + a_col);
          bf[j][2 * np][0] = r[0];
          bf[j][2 * np][1] = r[1];
          bf[j][2 * np + 1][0] = r[2];
          bf[j][2 * np + 1][1] = r[3];
        }
      // the part products of each 16-deep k step go to a fresh accumulator
      // first, which an f32 add (rounded to nearest) then carries into the
      // output's sum, so the tensor cores' truncating accumulation stays
      // within one k step's products (see the header)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[L::NA][4];
#pragma unroll
        for (int i = 0; i < L::NA; ++i)
          if (i <= kMaxOrder)
            ldsm_x4(af[i], a_base + i * (L::kAPart / 2) +
                               (wm + mt * 16 + a_row) * L::kALd + ks * 16 +
                               a_col);
        float part[4][4] = {};
#pragma unroll
        for (int i = 0; i < L::NA; ++i)
#pragma unroll
          for (int j = 0; j < L::NB; ++j)
            if (i + j <= kMaxOrder)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(part[nt], af[i], bf[j][nt][0], bf[j][nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[nt][e]);
      }
    }
  }

  // c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: row + 8
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mt * 16 + (lane >> 2) + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * (lane & 3);
        if (n >= N) continue;              // N % 16 == 0: n + 1 < N too
        TO* p = out + (size_t)m * N + n;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if constexpr (std::is_same<TO, float>::value) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

template <typename TX, typename TO>
int launch_simt(const void* x, const int8_t* wq, const float* scale,
                void* out, int M, int N, int K, int G, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_kernel<TX, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), wq, scale, static_cast<TO*>(out), M, N, K,
      G);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO, bool kScaleOnX>
int launch_mma(const void* x, const int8_t* wq, const float* scale,
               void* out, int M, int N, int K, int G, cudaStream_t stream) {
  constexpr int kBytes = MmaLayout<TX, kScaleOnX>::kBytes;
  static bool attr = false;                // set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_mma_kernel<TX, TO, kScaleOnX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
  qmm_mma_kernel<TX, TO, kScaleOnX><<<grid, kMmaThreads, kBytes, stream>>>(
      static_cast<const TX*>(x), wq, scale, static_cast<TO*>(out), M, N, K,
      G);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int launch(int body, const void* x, const int8_t* wq, const float* scale,
           void* out, int M, int N, int K, int G, cudaStream_t s) {
  if (body == 1)
    return launch_mma<TX, TO, false>(x, wq, scale, out, M, N, K, G, s);
  if constexpr (std::is_same<TX, float>::value)     // f32 x, G = 1
    if (body == 2)
      return launch_mma<TX, TO, true>(x, wq, scale, out, M, N, K, G, s);
  return launch_simt<TX, TO>(x, wq, scale, out, M, N, K, G, s);
}

bool valid(int M, int N, int K, int G, int x_kind) {
  return M > 0 && N > 0 && K > 0 && G > 0 && N % G == 0 &&
         (M + kBM - 1) / kBM <= 65535 && x_kind >= 0 && x_kind <= 1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Which body int8_matmul runs for 16-byte-aligned tensors (every fresh
// allocation) of this shape: 1 = tensor cores with the scale on the
// weight, 2 = tensor cores with the scale on x, 0 = the SIMT body, -1 =
// a shape the kernel does not take. x_kind: 0 = f32, 1 = bf16.
extern "C" int int8_matmul_body(int x_kind, int M, int N, int K, int G) {
  if (!valid(M, N, K, G, x_kind)) return -1;
  const int x_per_chunk = x_kind == 0 ? 4 : 8;
  if (N % 16 != 0 || K % x_per_chunk != 0) return 0;
  if (G > 1 && (kMmaBN - 1) / (N / G) + 2 > kMaxGroups) return 0;
  return (x_kind == 0 && G == 1) ? 2 : 1;
}

// The K tile of the body int8_matmul_body() names for this shape (-1 for a
// shape the kernel does not take).
extern "C" int int8_matmul_k_tile(int x_kind, int M, int N, int K, int G) {
  const int body = int8_matmul_body(x_kind, M, N, K, G);
  if (body <= 0) return body < 0 ? -1 : kBK;
  return x_kind == 0 ? MmaLayout<float, true>::kBK
                     : MmaLayout<__nv_bfloat16, false>::kBK;
}

// x_kind / out_kind: 0 = f32, 1 = bf16. Returns a cudaError_t as int:
// cudaErrorInvalidValue for shapes the kernel does not take, else
// cudaGetLastError() after the launch. A pointer off 16 bytes sends a
// tensor-core shape to the SIMT body.
extern "C" int int8_matmul(const void* x, const int8_t* wq,
                           const float* scale, void* out, int M, int N,
                           int K, int G, int x_kind, int out_kind,
                           void* stream) {
  if (!valid(M, N, K, G, x_kind) || out_kind < 0 || out_kind > 1)
    return (int)cudaErrorInvalidValue;
  int body = int8_matmul_body(x_kind, M, N, K, G);
  if (!(aligned16(x) && aligned16(wq) && aligned16(scale) &&
        aligned16(out)))
    body = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0)
    return out_kind == 0
               ? launch<float, float>(body, x, wq, scale, out, M, N, K, G, s)
               : launch<float, __nv_bfloat16>(body, x, wq, scale, out, M, N,
                                              K, G, s);
  return out_kind == 0
             ? launch<__nv_bfloat16, float>(body, x, wq, scale, out, M, N, K,
                                            G, s)
             : launch<__nv_bfloat16, __nv_bfloat16>(body, x, wq, scale, out,
                                                    M, N, K, G, s);
}
