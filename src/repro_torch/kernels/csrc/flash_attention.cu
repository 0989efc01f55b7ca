// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py:
//   flash_attention_fwd      <- _fwd_kernel      (flash_attention.py:35)
//   flash_attention_bwd_dkv  <- _bwd_dkv_kernel  (flash_attention.py:120)
//   flash_attention_bwd_dq   <- _bwd_dq_kernel   (flash_attention.py:165)
//
// What they compute. Layout q (B,H,T,D), k/v (B,K,S,D), H = K*G, query
// head h reads K/V head h / G; bf16 or f32 in, f32 arithmetic inside.
// Scores are (q*scale).k; causal masking writes -1e30, never -inf, and
// takes a query offset q_offset >= 0: row i sits at position i + q_offset
// and sees columns j <= i + q_offset (0 is top-left aligned; a rank that
// holds rows [r*T/tp, (r+1)*T/tp) of a sequence split over tp ranks reads
// the keys [0, (r+1)*T/tp) with q_offset = r*T/tp). Every row sees key 0,
// so no row is empty; key tiles no row of a block reaches are skipped,
// and keys no row reaches at all get dK = dV = 0.
//   fwd:     online softmax over key tiles up to the diagonal; writes
//            o = acc / max(l, 1e-30) in the input type and
//            lse = m + log(max(l, 1e-30)) in f32.
//   bwd_dkv: p = exp(s - lse), dp = dO.v, ds = p*(dp - delta)*scale with
//            delta = rowsum(dO*O) computed by the caller; dV += p^T dO and
//            dK += ds^T q, summed over the G query heads of the K/V head
//            inside the block (the reference sums its per-head f32
//            buffers outside), cast once to the input type, or on request
//            left in f32 (the sums before that rounding: a rank of a
//            sequence split adds its partials to the other ranks' in f32
//            and rounds once).
//   bwd_dq:  dQ += ds k over key tiles up to the diagonal.
//
// f32 inputs, or a head_dim other than 64 or 128 (the FMA body, forward
// and backward). Tiles of 64 query rows by 64 keys, 256 threads:
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of a score tile, and dims tx + 16 k (k < DPT =
// ceil(D / 16)) of an output row. Operand tiles are staged into shared
// memory as f32, row-major with one float of padding so the column-strided
// reads of K are conflict-free; every product is a plain FMA loop over
// shared memory, accumulating in f32 registers. The 16 threads that share
// a row sit in one half-warp, so row max and row sum are shuffles. Causal
// blocks walk only the tiles up to (fwd, dq) or from (dkv) the diagonal,
// and the grid hands out the longest rows first.
//
// Forward of bf16 inputs at D = 64 or 128 (the tensor-core body,
// fwd_mma_kernel below). A block owns 64 query rows of one (b, h), 16 a
// warp; each warp loads its Q fragments once by ldmatrix and keeps them in
// registers for the whole key loop. K/V tiles of 64 keys come in by
// cp.async into padded shared memory, double-buffered, so the next tile
// lands while this one is multiplied. S = Q K^T runs on mma.sync with the
// bf16 values as they are (exact products, f32 sums); the scale is applied
// to S, as the backward's recompute does: at D = 64 it is 2^-3, so S*scale
// is bitwise the TPU body's (q*scale).k up to the order of the sums; at
// D = 128 (scale 2^-3.5) the two differ by one f32 rounding a score. The
// online softmax keeps f32 m and l per row (quad shuffles on the
// accumulator layout), rescales O by corr each tile, and P stays f32, as in
// the TPU body: it is split into hi = bf16(p) and lo = bf16(p - hi) in
// registers (the accumulator layout of S is the A-operand layout of P V,
// so P never leaves them) and each half is multiplied by V (ldmatrix
// .trans), the two products summed in f32. Causal blocks walk only the key
// tiles up to the diagonal and mask only the diagonal (and the ragged last)
// tile; o is rounded once.
//
// Backward of bf16 inputs at D = 64 or 128 (the tensor-core body,
// bwd_dkv_mma_kernel and bwd_dq_mma_kernel below): mma.sync.m16n8k16 with
// bf16 operands and f32 accumulators, fragments loaded by ldmatrix from
// shared memory (rows padded by 16 bytes, so an ldmatrix's eight rows fall
// in distinct banks), and the next Q/dO tile (dK/dV) or K/V tile (dQ)
// loaded by cp.async while the current one is multiplied. S = Q K^T and
// dP = dO V^T take the bf16 inputs as they are: exact products, f32 sums.
// P = exp(S * scale - lse) and dS = P (dP - delta) scale stay f32, as in
// the TPU bodies; rounding them to bf16 would be another function
// (FlashAttention-2's), so each is split into bf16 parts and multiplied
// once a part. dQ += dS K takes hi = bf16(x) and lo = bf16(x - hi): hi +
// lo is x to within 2^-16, below a bf16 ulp of a sum over one head's keys.
// dV += P^T dO and dK += dS^T Q sum over G heads' rows (16,384 at G = 8,
// T = 2048), where 2^-16 a term left up to 24 bf16 ulps on outputs that
// cancel; they take three parts (hi, mid = bf16(x - hi), lo = bf16(x - hi
// - mid)), x to within 2^-24. The dK/dV kernel computes S^T and dP^T (keys as rows), so the
// accumulator layout of P^T and dS^T is the A-operand layout of its two
// products and P never leaves registers; the dQ kernel likewise for dS.
// The two kernels stay separate, each recomputing S and dP, and dQ takes
// no atomics: every sum runs in a fixed order, so a training step repeats
// bit for bit. A fused single-pass backward, wgmma and TMA are later work.
//
// Bound on an H100 SXM at the training shape (B=4, H=16, T=S=2048, D=64,
// causal, bf16): the forward's useful work is 2*B*H*T^2*D = 3.4e10 FLOPs,
// 34.7 us at the 989 TFLOP/s bf16 tensor-core rate, above its 20 us of
// q/k/v/o/lse traffic at 3.35 TB/s, so it is bound by operations; the
// backward's five products are 2.5 times that, 86.8 us. As built, the
// tensor-core backward issues twelve products (P and dS take three each in
// dK/dV and dS two in dQ, and S and dP are computed in both kernels): 209
// us at that rate; the
// tensor-core forward issues three (S, then P V twice): 52 us. The FMA
// body runs on the FP32 pipes (67 TFLOP/s at best), one shared-memory load
// per two FMAs, with no overlap of loads and math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kPLd = kTile + 1;           // padded row of a score tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reduce over the 16 lanes that share a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + kTile) of a (n, D) matrix into dst (stride D + 1), times
// mul; rows past n are zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int n, int D, float mul) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int gr = r0 + r;
    dst[r * ld + d] = gr < n ? to_f32(src[(size_t)gr * D + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r0 + r < n ? src[r0 + r] : 0.f;
}

// s[i][j] = sum_d a[row i][d] * b[col j][d] over one tile pair
__device__ __forceinline__ void tile_dot(float s[4][4], const float* a,
                                         const float* b, int D, int ty,
                                         int tx) {
  const int ld = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int H, int KH, int Tn, int S, int D,
           int causal, int q_off, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                 // kTile x ld, pre-scaled
  float* k_s = q_s + kTile * ld;
  float* v_s = k_s + kTile * ld;
  float* p_s = v_s + kTile * ld;     // kTile x kPLd
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kh = (bh - b * H) / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const T* kp = k + (size_t)(b * KH + kh) * S * D;
  const T* vp = v + (size_t)(b * KH + kh) * S * D;

  stage(q_s, q + (size_t)bh * Tn * D, q0, Tn, D, scale);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + kTile + q_off) : S;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage(k_s, kp, k0, S, D, 1.f);
    stage(v_s, vp, k0, S, D, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot(s, q_s, k_s, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= S || (causal && r + q_off < c)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = c < S ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + row_sum(psum);
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx + 16 * e;
        vv[e] = d < D ? v_s[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Tn) {
      const float lc = fmaxf(l[i], 1e-30f);
      const size_t row = (size_t)bh * Tn + r;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx + 16 * e;
        if (d < D) o[row * D + d] = from_f32<T>(acc[i][e] / lc);
      }
      if (tx == 0) lse[row] = m[i] + logf(lc);
    }
  }
}

// ------------------------------------------------------------------------
// backward: the (p, ds) tile of one (query tile, key tile) pair
// ------------------------------------------------------------------------

// q_s holds q unscaled, do_s dO; k_s, v_s the key tile. Writes p and ds
// to p_s / ds_s (either may be null).
__device__ __forceinline__ void p_ds_tile(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int q0,
    int k0, int Tn, int S, int D, int causal, int q_off, float scale, int ty,
    int tx) {
  const int ld = D + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = q_s[(ty + 16 * i) * ld + d] * scale;
      da[i] = do_s[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = k_s[(tx + 16 * j) * ld + d];
      vb[j] = v_s[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i;
    const int r = q0 + rr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      float sv = s[i][j];
      if (causal && r + q_off < c) sv = kNegInf;
      const float p = (r < Tn && c < S) ? expf(sv - lse_s[rr]) : 0.f;
      const int at = rr * kPLd + tx + 16 * j;
      if (p_s != nullptr) p_s[at] = p;
      ds_s[at] = p * (dp[i][j] - dl_s[rr]) * scale;
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ dk32,
               float* __restrict__ dv32, int H, int KH, int Tn, int S, int D,
               int causal, int q_off, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * ld;
  float* q_s = v_s + kTile * ld;
  float* do_s = q_s + kTile * ld;
  float* p_s = do_s + kTile * ld;    // kTile x kPLd
  float* ds_s = p_s + kTile * kPLd;
  float* lse_s = ds_s + kTile * kPLd;
  float* dl_s = lse_s + kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bkh = blockIdx.x;        // b * KH + kh
  const int b = bkh / KH;
  const int kh = bkh - b * KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * kTile;  // early key tiles see the most rows

  stage(k_s, k + (size_t)bkh * S * D, k0, S, D, 1.f);
  stage(v_s, v + (size_t)bkh * S * D, k0, S, D, 1.f);

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;

  // causal: query tiles whose last row reaches this key tile's first key
  // (row k0 - q_off is the first that sees key k0)
  const int qstart = causal ? (max(k0 - q_off, 0) / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kh * G + g;
    const size_t base = (size_t)bh * Tn;
    for (int q0 = qstart; q0 < Tn; q0 += kTile) {
      __syncthreads();  // the previous tile is consumed
      stage(q_s, q + base * D, q0, Tn, D, 1.f);
      stage(do_s, dout + base * D, q0, Tn, D, 1.f);
      stage_vec(lse_s, lse + base, q0, Tn);
      stage_vec(dl_s, delta + base, q0, Tn);
      __syncthreads();
      p_ds_tile(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, k0, Tn, S,
                D, causal, q_off, scale, ty, tx);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pc[4], dc[4], dov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = p_s[r * kPLd + ty + 16 * i];
          dc[i] = ds_s[r * kPLd + ty + 16 * i];
        }
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const int d = tx + 16 * e;
          dov[e] = d < D ? do_s[r * ld + d] : 0.f;
          qv[e] = d < D ? q_s[r * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            dva[i][e] = fmaf(pc[i], dov[e], dva[i][e]);
            dka[i][e] = fmaf(dc[i], qv[e], dka[i][e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c < S) {
      const size_t row = (size_t)bkh * S + c;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx + 16 * e;
        if (d < D && dk32 != nullptr) {   // the f32 sums, unrounded
          dk32[row * D + d] = dka[i][e];
          dv32[row * D + d] = dva[i][e];
        } else if (d < D) {
          dk[row * D + d] = from_f32<T>(dka[i][e]);
          dv[row * D + d] = from_f32<T>(dva[i][e]);
        }
      }
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int KH, int Tn, int S, int D,
              int causal, int q_off, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * ld;
  float* k_s = do_s + kTile * ld;
  float* v_s = k_s + kTile * ld;
  float* ds_s = v_s + kTile * ld;    // kTile x kPLd
  float* lse_s = ds_s + kTile * kPLd;
  float* dl_s = lse_s + kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kh = (bh - b * H) / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const size_t base = (size_t)bh * Tn;
  const T* kp = k + (size_t)(b * KH + kh) * S * D;
  const T* vp = v + (size_t)(b * KH + kh) * S * D;

  stage(q_s, q + base * D, q0, Tn, D, 1.f);
  stage(do_s, dout + base * D, q0, Tn, D, 1.f);
  stage_vec(lse_s, lse + base, q0, Tn);
  stage_vec(dl_s, delta + base, q0, Tn);

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  const int kend = causal ? min(S, q0 + kTile + q_off) : S;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage(k_s, kp, k0, S, D, 1.f);
    stage(v_s, vp, k0, S, D, 1.f);
    __syncthreads();
    p_ds_tile(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, q0, k0, Tn,
              S, D, causal, q_off, scale, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dc[4], kv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dc[i] = ds_s[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx + 16 * e;
        kv[e] = d < D ? k_s[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(dc[i], kv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Tn) {
      const size_t row = base + r;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx + 16 * e;
        if (d < D) dq[row * D + d] = from_f32<T>(acc[i][e]);
      }
    }
  }
}

// ------------------------------------------------------------------------
// backward on the tensor cores: bf16, D in {64, 128}
// ------------------------------------------------------------------------

constexpr int kMmaThreads = 128;          // 4 warps, 16 rows of a tile each
// blocks an SM must hold at once: three cap the registers at 168 (the
// dK/dV body spills a few bytes) and give each SM 12 warps to hide the
// latency of mma.sync, ldmatrix and cp.async behind
constexpr int kMmaMinBlocks = 3;
constexpr int kBc = 64;                   // keys a dK/dV block, a dQ key tile

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// f32 x0, x1 -> bf16x2 hi = bf16(x) and lo = bf16(x - hi) (x0 in the low
// half): hi + lo is x to within 2^-16 |x|
__device__ __forceinline__ void split_hi_lo(float x0, float x1,
                                            uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

// f32 x0, x1 -> bf16x2 hi, mid = bf16(x - hi), lo = bf16(x - hi - mid):
// hi + mid + lo is x to within 2^-24 |x| (every remainder is exact)
__device__ __forceinline__ void split_3(float x0, float x1, uint32_t& hi,
                                        uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - __low2float(m),
                                    r1 - __high2float(m)));
}

// the A operand (16 rows x 16 k) of an f32 tile held as two n8 C-fragments
// c0 (k 0-7) and c1 (k 8-15), split into hi and lo
__device__ __forceinline__ void a_hi_lo(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_hi_lo(c0[0], c0[1], hi[0], lo[0]);
  split_hi_lo(c0[2], c0[3], hi[1], lo[1]);
  split_hi_lo(c1[0], c1[1], hi[2], lo[2]);
  split_hi_lo(c1[2], c1[3], hi[3], lo[3]);
}

// the same A operand split into three parts (split_3)
__device__ __forceinline__ void a_split_3(const float (&c0)[4],
                                          const float (&c1)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&mid)[4],
                                          uint32_t (&lo)[4]) {
  split_3(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split_3(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split_3(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split_3(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

// rows [r0, r0 + R) of an (n, D) bf16 matrix -> dst (row stride D + 8, so
// the eight rows of an ldmatrix fall in distinct banks); rows past n zero
template <int R, int D>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int n) {
  constexpr int kChunks = D / 8;          // 16-byte chunks a row
  for (int c = threadIdx.x; c < R * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * (D + 8) + col,
               in ? src + (size_t)(r0 + r) * D + col : src, in);
  }
}
template <int R>
__device__ __forceinline__ void vec_async(float* dst, const float* src,
                                          int r0, int n) {
  for (int r = threadIdx.x; r < R; r += kMmaThreads) {
    const bool in = r0 + r < n;
    cp_async4(dst + r, in ? src + r0 + r : src, in);
  }
}

// The dK/dV body on the tensor cores. A block owns kBc = 64 keys of one
// (b, kh); warp w owns keys 16w..16w+15 and walks the G heads' query tiles
// of BR rows (from the diagonal's tile when causal), with the next tile's
// Q, dO, lse and delta loaded by cp.async while this one is multiplied.
// It computes S^T = K Q^T and dP^T = V dO^T (keys x queries, bf16 inputs
// as they are: exact products, f32 sums), P^T and dS^T in f32 registers,
// then dV += P^T dO and dK += dS^T Q with P^T and dS^T split into three
// bf16 parts: the accumulator layout of S^T is the A-operand layout of
// those products, so P never leaves registers.
//
// The tensor cores add a product into an f32 accumulator with its low
// bits truncated, not rounded: one running mma accumulator over all G
// heads' rows (16,384 at G = 8, T = 2048) drifted 189 bf16 ulps from the
// plain version where a sum cancels. So each k step's products go to a
// fresh mma accumulator that one ordinary f32 add puts into dK/dV, and
// with G > 1 each head's sums are formed as at G = 1: each thread adds
// them into its own entries of the f32 scratch `acc` (2 x (B,K,S,D): dK
// then dV) after each head but the last and restarts from zero; the last
// head's sums are added to the scratch's as the result is written. No
// two threads share an entry, so no atomics and no ordering. With f32_out
// the result is written into the scratch itself (dK then dV, f32), the
// sums before their one rounding, and dk/dv are not written.
template <int D, int DT>
__device__ __forceinline__ void dkv_flush(float (&dk_acc)[DT][4],
                                          float (&dv_acc)[DT][4],
                                          float* __restrict__ acc,
                                          size_t plane, size_t row0,
                                          int key_lo, int S, int lane,
                                          bool first) {
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_lo + half * 8;
      if (key < S) {
        float2* pk = reinterpret_cast<float2*>(acc + (row0 + key) * D + col);
        float2* pv = reinterpret_cast<float2*>(acc + plane +
                                               (row0 + key) * D + col);
        float2 sk = first ? make_float2(0.f, 0.f) : *pk;
        float2 sv = first ? make_float2(0.f, 0.f) : *pv;
        sk.x += dk_acc[j][2 * half];
        sk.y += dk_acc[j][2 * half + 1];
        sv.x += dv_acc[j][2 * half];
        sv.y += dv_acc[j][2 * half + 1];
        *pk = sk;
        *pv = sv;
      }
      dk_acc[j][2 * half] = dk_acc[j][2 * half + 1] = 0.f;
      dv_acc[j][2 * half] = dv_acc[j][2 * half + 1] = 0.f;
    }
  }
}

template <int D, int BR>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv,
                   float* __restrict__ acc, int B, int H, int KH, int Tn,
                   int S, int causal, int q_off, int f32_out, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BR / 8;              // query n-tiles of S^T
  constexpr int DT = D / 8;               // n-tiles of a dK/dV row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kBc * LD;
  __nv_bfloat16* q_s = v_s + kBc * LD;    // two stages of BR x LD
  __nv_bfloat16* do_s = q_s + 2 * BR * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BR * LD);
  float* dl_s = lse_s + 2 * BR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bkh = blockIdx.x;             // b * KH + kh
  const int b = bkh / KH;
  const int kh = bkh - b * KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * kBc;        // early key tiles see most rows

  tile_async<kBc, D>(k_s, k + (size_t)bkh * S * D, k0, S);
  tile_async<kBc, D>(v_s, v + (size_t)bkh * S * D, k0, S);
  // first tile reaching key k0 (row k0 - q_off is the first that sees it)
  const int qt0 = causal ? max(k0 - q_off, 0) / BR : 0;
  // query tiles from qt0 on (none where no row reaches this key tile)
  const int n_qt = max((Tn + BR - 1) / BR - qt0, 0);
  const int n_it = G * n_qt;
  auto stage = [&](int it, int st) {
    const size_t bh = (size_t)b * H + kh * G + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BR;
    tile_async<BR, D>(q_s + st * BR * LD, q + bh * Tn * D, q0, Tn);
    tile_async<BR, D>(do_s + st * BR * LD, dout + bh * Tn * D, q0, Tn);
    vec_async<BR>(lse_s + st * BR, lse + bh * Tn, q0, Tn);
    vec_async<BR>(dl_s + st * BR, delta + bh * Tn, q0, Tn);
  };
  if (n_it > 0) stage(0, 0);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int kw = warp * 16;
  const int a_row = kw + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int t_col = (lane >> 4) * 8;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) stage(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                   // stage `st` has landed
    __syncthreads();
    const int q0 = (qt0 + it % n_qt) * BR;
    const __nv_bfloat16* qs = q_s + st * BR * LD;
    const __nv_bfloat16* dos = do_s + st * BR * LD;
    const float* lss = lse_s + st * BR;
    const float* dls = dl_s + st * BR;

    float sT[NT][4], dpT[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, k_s + a_row * LD + kk * 16 + a_col);
      ldsm_x4(va, v_s + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qb[4], db[4];
        const int at = (np * 16 + b_row) * LD + kk * 16 + b_col;
        ldsm_x4(qb, qs + at);
        ldsm_x4(db, dos + at);
        mma_bf16(sT[2 * np], ka, qb[0], qb[1]);
        mma_bf16(sT[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16(dpT[2 * np], va, db[0], db[1]);
        mma_bf16(dpT[2 * np + 1], va, db[2], db[3]);
      }
    }
    // P^T -> sT, dS^T -> dpT, f32
    const int key_lo = k0 + kw + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + (e >> 1) * 8;
        const int qc = j * 8 + 2 * (lane & 3) + (e & 1);
        const int qr = q0 + qc;
        const bool live = qr < Tn && key < S && !(causal && qr + q_off < key);
        const float p = live ? expf(sT[j][e] * scale - lss[qc]) : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - dls[qc]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t ph[4], pm[4], pl[4], sh[4], sm[4], sl[4];
      a_split_3(sT[2 * kk], sT[2 * kk + 1], ph, pm, pl);
      a_split_3(dpT[2 * kk], dpT[2 * kk + 1], sh, sm, sl);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t ob[4], qb[4];
        const int at = (kk * 16 + t_row) * LD + dn * 16 + t_col;
        ldsm_x4_t(ob, dos + at);
        ldsm_x4_t(qb, qs + at);
        // this k step's products in fresh accumulators, then one f32 add
        // each into dV and dK (see dkv_flush: a running mma accumulator
        // truncates)
        float v0[4] = {0.f, 0.f, 0.f, 0.f}, v1[4] = {0.f, 0.f, 0.f, 0.f};
        float k0f[4] = {0.f, 0.f, 0.f, 0.f}, k1f[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(v0, ph, ob[0], ob[1]);
        mma_bf16(v1, ph, ob[2], ob[3]);
#ifndef FLASH_PLANT_P_HI_ONLY               // a planted fault's build only
        mma_bf16(v0, pm, ob[0], ob[1]);
        mma_bf16(v1, pm, ob[2], ob[3]);
        mma_bf16(v0, pl, ob[0], ob[1]);
        mma_bf16(v1, pl, ob[2], ob[3]);
#endif
        mma_bf16(k0f, sh, qb[0], qb[1]);
        mma_bf16(k0f, sm, qb[0], qb[1]);
        mma_bf16(k0f, sl, qb[0], qb[1]);
        mma_bf16(k1f, sh, qb[2], qb[3]);
        mma_bf16(k1f, sm, qb[2], qb[3]);
        mma_bf16(k1f, sl, qb[2], qb[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[2 * dn][e] += v0[e];
          dv_acc[2 * dn + 1][e] += v1[e];
          dk_acc[2 * dn][e] += k0f[e];
          dk_acc[2 * dn + 1][e] += k1f[e];
        }
      }
    }
    __syncthreads();                      // stage `st` is free again
    if (acc != nullptr && (it + 1) % n_qt == 0 && it + 1 < n_it)
      dkv_flush<D>(dk_acc, dv_acc, acc, (size_t)B * KH * S * D,
                   (size_t)bkh * S, k0 + kw + (lane >> 2), S, lane,
                   it + 1 == n_qt);
  }
  cp_async_wait<0>();

  const bool carried = acc != nullptr && n_it > n_qt;
  const size_t plane = (size_t)B * KH * S * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + kw + (lane >> 2) + half * 8;
      if (key < S) {
        const size_t at = ((size_t)bkh * S + key) * D + col;
        float k0v = dk_acc[j][2 * half], k1v = dk_acc[j][2 * half + 1];
        float v0v = dv_acc[j][2 * half], v1v = dv_acc[j][2 * half + 1];
        if (carried) {
          const float2 sk = *reinterpret_cast<const float2*>(acc + at);
          const float2 sv = *reinterpret_cast<const float2*>(acc + plane +
                                                             at);
          k0v = sk.x + k0v;
          k1v = sk.y + k1v;
          v0v = sv.x + v0v;
          v1v = sv.y + v1v;
        }
        if (f32_out) {
          *reinterpret_cast<float2*>(acc + at) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(acc + plane + at) = make_float2(v0v, v1v);
        } else {
          *reinterpret_cast<uint32_t*>(dk + at) =
              as_u32(__floats2bfloat162_rn(k0v, k1v));
          *reinterpret_cast<uint32_t*>(dv + at) =
              as_u32(__floats2bfloat162_rn(v0v, v1v));
        }
      }
    }
  }
}

// The dQ body on the tensor cores. A block owns 64 query rows of one
// (b, h), 16 a warp, and walks the key tiles of kBc = 64 (up to the
// diagonal when causal), the next tile's K and V loaded by cp.async while
// this one is multiplied: S = Q K^T and dP = dO V^T, then dS in f32
// registers and dQ += dS K with dS split into bf16 hi + lo.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const __nv_bfloat16* __restrict__ o,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int KH, int Tn,
                  int S, int causal, int q_off, float scale) {
  constexpr int BR = 64;
  constexpr int LD = D + 8;
  constexpr int NT = kBc / 8;             // key n-tiles of S
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + BR * LD;
  __nv_bfloat16* k_s = do_s + BR * LD;    // two stages of kBc x LD
  __nv_bfloat16* v_s = k_s + 2 * kBc * LD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kh = (bh - b * H) / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const size_t base = (size_t)bh * Tn;
  const __nv_bfloat16* kp = k + (size_t)(b * KH + kh) * S * D;
  const __nv_bfloat16* vp = v + (size_t)(b * KH + kh) * S * D;

  tile_async<BR, D>(q_s, q + base * D, q0, Tn);
  tile_async<BR, D>(do_s, dout + base * D, q0, Tn);
  const int kend = causal ? min(S, q0 + BR + q_off) : S;
  const int n_kt = (kend + kBc - 1) / kBc;
  if (n_kt > 0) {
    tile_async<kBc, D>(k_s, kp, 0, S);
    tile_async<kBc, D>(v_s, vp, 0, S);
  }
  cp_async_commit();

  const int qw = warp * 16;
  const int r_lo = q0 + qw + (lane >> 2);  // rows r_lo and r_lo + 8
  if (o != nullptr) {
    // delta = rowsum(dO * O) in f32 for this warp's 16 rows (two lanes a
    // row, D / 2 columns each), written for the dK/dV kernel, which runs
    // after this one
    constexpr int kVecs = D / 16;           // 16-byte loads a half row
    const int r = q0 + qw + (lane >> 1);
    float acc = 0.f;
    if (r < Tn) {
      const uint4* op = reinterpret_cast<const uint4*>(
          o + (base + r) * D + (lane & 1) * (D / 2));
      const uint4* dp = reinterpret_cast<const uint4*>(
          dout + (base + r) * D + (lane & 1) * (D / 2));
      uint4 ov[kVecs], dv[kVecs];
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {     // every load first
        ov[i] = __ldg(op + i);
        dv[i] = __ldg(dp + i);
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const __nv_bfloat162* a =
            reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
        const __nv_bfloat162* c =
            reinterpret_cast<const __nv_bfloat162*>(&dv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 af = __bfloat1622float2(a[j]);
          const float2 cf = __bfloat1622float2(c[j]);
          acc = fmaf(af.x, cf.x, acc);
          acc = fmaf(af.y, cf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && r < Tn) delta[base + r] = acc;
    __syncwarp();                         // the warp reads its rows back
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    lse_r[half] = r < Tn ? lse[base + r] : 0.f;
    dl_r[half] = r < Tn ? delta[base + r] : 0.f;
  }
  float dq_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const int a_row = qw + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int t_col = (lane >> 4) * 8;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {
      tile_async<kBc, D>(k_s + (st ^ 1) * kBc * LD, kp, (it + 1) * kBc, S);
      tile_async<kBc, D>(v_s + (st ^ 1) * kBc * LD, vp, (it + 1) * kBc, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * kBc;
    const __nv_bfloat16* ks = k_s + st * kBc * LD;
    const __nv_bfloat16* vs = v_s + st * kBc * LD;

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, q_s + a_row * LD + kk * 16 + a_col);
      ldsm_x4(da, do_s + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4], vb[4];
        const int at = (np * 16 + b_row) * LD + kk * 16 + b_col;
        ldsm_x4(kb, ks + at);
        ldsm_x4(vb, vs + at);
        mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    // dS -> sc, f32
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + (e >> 1) * 8;
        const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const bool live = r < Tn && key < S && !(causal && r + q_off < key);
        const float p =
            live ? expf(sc[j][e] * scale - lse_r[e >> 1]) : 0.f;
        sc[j][e] = p * (dp[j][e] - dl_r[e >> 1]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      uint32_t sh[4], sl[4];
      a_hi_lo(sc[2 * kk], sc[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t kb[4];
        ldsm_x4_t(kb, ks + (kk * 16 + t_row) * LD + dn * 16 + t_col);
        mma_bf16(dq_acc[2 * dn], sh, kb[0], kb[1]);
        mma_bf16(dq_acc[2 * dn], sl, kb[0], kb[1]);
        mma_bf16(dq_acc[2 * dn + 1], sh, kb[2], kb[3]);
        mma_bf16(dq_acc[2 * dn + 1], sl, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + half * 8;
      if (r < Tn)
        *reinterpret_cast<uint32_t*>(dq + (base + r) * D + col) =
            as_u32(__floats2bfloat162_rn(dq_acc[j][2 * half],
                                         dq_acc[j][2 * half + 1]));
    }
  }
}

// ------------------------------------------------------------------------
// forward on the tensor cores: bf16, D in {64, 128}
// ------------------------------------------------------------------------

// blocks an SM must hold at once: four at D = 64 (45 KB of shared memory
// each, registers capped at 128), two at D = 128 (85 KB)
template <int D>
constexpr int fwd_min_blocks() {
  return D <= 64 ? 4 : 2;
}

// A block owns 64 query rows of one (b, h), 16 a warp, and walks the key
// tiles of kBc = 64 (up to the diagonal when causal), the next tile's K
// and V loaded by cp.async while this one is multiplied. Row r_lo of the
// warp's accumulators is lane / 4 (and r_lo + 8); each lane holds two
// columns of every 8-key n-tile, so a row's max and sum are shuffles over
// the four lanes of a quad. l is kept per lane (its columns' share of the
// row sum, all under the row's common max) and summed over the quad once
// at the end.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, fwd_min_blocks<D>())
fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int H, int KH, int Tn, int S, int causal, int q_off,
               float scale) {
  constexpr int BR = 64;
  constexpr int LD = D + 8;
  constexpr int NT = kBc / 8;             // key n-tiles of S
  constexpr int DT = D / 8;               // n-tiles of an O row
  constexpr int KD = D / 16;              // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BR * LD;     // two stages of kBc x LD
  __nv_bfloat16* v_s = k_s + 2 * kBc * LD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kh = (bh - b * H) / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const size_t base = (size_t)bh * Tn;
  const __nv_bfloat16* kp = k + (size_t)(b * KH + kh) * S * D;
  const __nv_bfloat16* vp = v + (size_t)(b * KH + kh) * S * D;
  const int kend = causal ? min(S, q0 + BR + q_off) : S;
  const int n_kt = (kend + kBc - 1) / kBc;

  tile_async<BR, D>(q_s, q + base * D, q0, Tn);
  tile_async<kBc, D>(k_s, kp, 0, S);
  tile_async<kBc, D>(v_s, vp, 0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int qw = warp * 16;
  const int a_row = qw + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  uint32_t qa[KD][4];                     // this warp's Q, for every tile
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qa[kk], q_s + a_row * LD + kk * 16 + a_col);
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int t_col = (lane >> 4) * 8;
  const int r_lo = q0 + qw + (lane >> 2);  // rows r_lo and r_lo + 8

  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {
      tile_async<kBc, D>(k_s + (st ^ 1) * kBc * LD, kp, (it + 1) * kBc, S);
      tile_async<kBc, D>(v_s + (st ^ 1) * kBc * LD, vp, (it + 1) * kBc, S);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // stage `st` has landed
    __syncthreads();
    const int k0 = it * kBc;
    const __nv_bfloat16* ks = k_s + st * kBc * LD;
    const __nv_bfloat16* vs = v_s + st * kBc * LD;

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (np * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16(sc[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // scale; mask only a tile that holds keys past S or above a row's
    // diagonal (block-uniform)
    const bool edge = k0 + kBc > S || (causal && k0 + kBc - 1 > q0 + q_off);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * scale;
        if (edge) {
          const int r = r_lo + (e >> 1) * 8;
          const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
          if (key >= S || (causal && r + q_off < key)) s = kNegInf;
        }
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const float p = key < S ? expf(sc[j][e] - m_r[e >> 1]) : 0.f;
        sc[j][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = fmaf(l_r[h], corr[h], ps[h]);
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    // O += P V, P split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      uint32_t ph[4], pl[4];
      a_hi_lo(sc[2 * kk], sc[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (kk * 16 + t_row) * LD + dn * 16 + t_col);
        mma_bf16(acc[2 * dn], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], ph, vb[2], vb[3]);
#ifndef FLASH_PLANT_FWD_P_HI_ONLY           // a planted fault's build only
        mma_bf16(acc[2 * dn], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pl, vb[2], vb[3]);
#endif
      }
    }
    __syncthreads();                      // stage `st` is free again
  }
  cp_async_wait<0>();

  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lc[h] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + half * 8;
      if (r < Tn)
        *reinterpret_cast<uint32_t*>(o + (base + r) * D + col) =
            as_u32(__floats2bfloat162_rn(acc[j][2 * half] / lc[half],
                                         acc[j][2 * half + 1] / lc[half]));
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    if ((lane & 3) == 0 && r < Tn) lse[base + r] = m_r[half] + logf(lc[half]);
  }
}

// ------------------------------------------------------------------------
// launchers
// ------------------------------------------------------------------------

size_t fwd_smem(int D) {
  return sizeof(float) * ((size_t)3 * kTile * (D + 1) + kTile * kPLd);
}
size_t dkv_smem(int D) {
  return sizeof(float) *
         ((size_t)4 * kTile * (D + 1) + 2 * kTile * kPLd + 2 * kTile);
}
size_t dq_smem(int D) {
  return sizeof(float) *
         ((size_t)4 * kTile * (D + 1) + kTile * kPLd + 2 * kTile);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int n_tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T, int DPT>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KH, int Tn, int S, int D,
               int causal, int q_off, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  int rc = prepare(fwd_kernel<T, DPT>, smem);
  if (rc) return rc;
  const dim3 grid(B * H, n_tiles(Tn));
  fwd_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KH, Tn, S, D,
      causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DPT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               float* acc, int B, int H, int KH, int Tn, int S, int D,
               int causal, int q_off, int f32_out, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  int rc = prepare(bwd_dkv_kernel<T, DPT>, smem);
  if (rc) return rc;
  const dim3 grid(B * KH, n_tiles(S));
  float* dk32 = f32_out ? acc : nullptr;
  float* dv32 = f32_out ? acc + (size_t)B * KH * S * D : nullptr;
  bwd_dkv_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dk32, dv32, H, KH, Tn, S, D,
      causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DPT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int KH, int Tn, int S, int D, int causal, int q_off,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  int rc = prepare(bwd_dq_kernel<T, DPT>, smem);
  if (rc) return rc;
  const dim3 grid(B * H, n_tiles(Tn));
  bwd_dq_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, KH, Tn, S, D, causal, q_off, scale);
  return (int)cudaGetLastError();
}

// query rows a dK/dV block's tile takes: 64 at D = 64, 32 at D = 128 (the
// dK and dV accumulators of 16 keys x 128 columns fill the registers)
template <int D>
constexpr int dkv_rows() {
  return D <= 64 ? 64 : 32;
}
template <int D>
size_t dkv_mma_smem() {
  constexpr int BR = dkv_rows<D>();
  return sizeof(__nv_bfloat16) * (size_t)(2 * kBc + 4 * BR) * (D + 8) +
         sizeof(float) * 4 * BR;
}
template <int D>
size_t dq_mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * 64 + 4 * kBc) * (D + 8);
}

template <int D>
size_t fwd_mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(64 + 4 * kBc) * (D + 8);
}

template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KH, int Tn, int S,
                   int causal, int q_off, float scale, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<D>();
  int rc = prepare(fwd_mma_kernel<D>, smem);
  if (rc) return rc;
  const dim3 grid(B * H, (Tn + 63) / 64);
  using bf = __nv_bfloat16;
  fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<bf*>(o), lse, H, KH, Tn, S,
      causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, float* acc, int B, int H, int KH,
                   int Tn, int S, int causal, int q_off, int f32_out,
                   float scale, cudaStream_t stream) {
  constexpr int BR = dkv_rows<D>();
  const size_t smem = dkv_mma_smem<D>();
  int rc = prepare(bwd_dkv_mma_kernel<D, BR>, smem);
  if (rc) return rc;
  const dim3 grid(B * KH, (S + kBc - 1) / kBc);
  using bf = __nv_bfloat16;
  bwd_dkv_mma_kernel<D, BR><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv),
      H > KH || f32_out ? acc : nullptr, B, H, KH, Tn, S, causal, q_off,
      f32_out, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* o, const float* lse,
                  float* delta, void* dq, int B, int H, int KH, int Tn,
                  int S, int causal, int q_off, float scale,
                  cudaStream_t stream) {
  const size_t smem = dq_mma_smem<D>();
  int rc = prepare(bwd_dq_mma_kernel<D>, smem);
  if (rc) return rc;
  const dim3 grid(B * H, (Tn + 63) / 64);
  using bf = __nv_bfloat16;
  bwd_dq_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<const bf*>(o), lse, delta, static_cast<bf*>(dq), H, KH,
      Tn, S, causal, q_off, scale);
  return (int)cudaGetLastError();
}

// the body of the forward and of the backward for (kind, D): 1 = tensor
// cores (bf16, D 64 or 128), 0 = the f32 FMA body
int mma_body(int kind, int D) { return kind == 1 && (D == 64 || D == 128); }

bool bad_dims(int B, int H, int KH, int Tn, int S, int D) {
  return B <= 0 || KH <= 0 || H % KH != 0 || Tn <= 0 || S <= 0 || D <= 0 ||
         D > 128 || n_tiles(Tn) > 65535 || n_tiles(S) > 65535;
}

// Calls launcher<T, DPT>(args...) for the element type `kind` (0 = f32,
// 1 = bf16) and the smallest DPT with 16 * DPT >= D.
#define FA_DISPATCH(launcher, ...)                                      \
  do {                                                                  \
    if (kind == 0) {                                                    \
      if (D <= 16) return launcher<float, 1>(__VA_ARGS__);              \
      if (D <= 32) return launcher<float, 2>(__VA_ARGS__);              \
      if (D <= 64) return launcher<float, 4>(__VA_ARGS__);              \
      return launcher<float, 8>(__VA_ARGS__);                           \
    }                                                                   \
    if (kind == 1) {                                                    \
      if (D <= 16) return launcher<__nv_bfloat16, 1>(__VA_ARGS__);      \
      if (D <= 32) return launcher<__nv_bfloat16, 2>(__VA_ARGS__);      \
      if (D <= 64) return launcher<__nv_bfloat16, 4>(__VA_ARGS__);      \
      return launcher<__nv_bfloat16, 8>(__VA_ARGS__);                   \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

// All tensors contiguous: q, o, dout, dq (B,H,T,D); k, v, dk, dv
// (B,K,S,D); lse, delta (B,H,T,1) f32. kind: 0 = f32, 1 = bf16. Types and
// shapes are checked by the Python wrapper. Each returns
// cudaGetLastError() after its launch. The dQ entry takes o: given (the
// tensor-core body only), the dQ kernel computes delta = rowsum(dO * O)
// itself and writes it for the dK/dV kernel, launched after it; null, it
// reads delta. The dK/dV entry takes acc, an f32 scratch of 2 x (B,K,S,D)
// that the tensor-core body sums the G heads in when G > 1; with f32_out
// every body writes dK and dV there in f32 (its two planes), unrounded,
// and leaves dk/dv alone (acc is null when neither holds; the FMA body
// reads it only for f32_out). q_offset >= 0 is the causal mask's query
// offset (row i sees keys j <= i + q_offset).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int kind, int B, int H, int KH, int Tn,
                                   int S, int D, int causal, int q_offset,
                                   float scale, void* stream) {
  if (bad_dims(B, H, KH, Tn, S, D) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_body(kind, D))
    return D == 64 ? launch_fwd_mma<64>(q, k, v, o, lse, B, H, KH, Tn, S,
                                        causal, q_offset, scale, st)
                   : launch_fwd_mma<128>(q, k, v, o, lse, B, H, KH, Tn, S,
                                         causal, q_offset, scale, st);
  FA_DISPATCH(launch_fwd, q, k, v, o, lse, B, H, KH, Tn, S, D, causal,
              q_offset, scale, st);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, float* acc,
                                       int kind, int B, int H, int KH,
                                       int Tn, int S, int D, int causal,
                                       int q_offset, int f32_out,
                                       float scale, void* stream) {
  if (bad_dims(B, H, KH, Tn, S, D) || q_offset < 0 ||
      (f32_out && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_body(kind, D)) {
    if (H > KH && acc == nullptr) return (int)cudaErrorInvalidValue;
    return D == 64 ? launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv,
                                        acc, B, H, KH, Tn, S, causal,
                                        q_offset, f32_out, scale, st)
                   : launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv,
                                         acc, B, H, KH, Tn, S, causal,
                                         q_offset, f32_out, scale, st);
  }
  FA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, acc, B, H, KH,
              Tn, S, D, causal, q_offset, f32_out, scale, st);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* o, const float* lse,
                                      float* delta, void* dq, int kind,
                                      int B, int H, int KH, int Tn, int S,
                                      int D, int causal, int q_offset,
                                      float scale, void* stream) {
  if (bad_dims(B, H, KH, Tn, S, D) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_body(kind, D))
    return D == 64 ? launch_dq_mma<64>(q, k, v, dout, o, lse, delta, dq, B,
                                       H, KH, Tn, S, causal, q_offset, scale,
                                       st)
                   : launch_dq_mma<128>(q, k, v, dout, o, lse, delta, dq, B,
                                        H, KH, Tn, S, causal, q_offset, scale,
                                        st);
  if (o != nullptr) return (int)cudaErrorInvalidValue;
  FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, H, KH, Tn, S, D,
              causal, q_offset, scale, st);
}

// 1 when the forward (the backward) of (kind, D) runs on the tensor cores,
// 0 when it runs the f32 FMA body.
extern "C" int flash_attention_fwd_body(int kind, int D) {
  return mma_body(kind, D);
}
extern "C" int flash_attention_bwd_body(int kind, int D) {
  return mma_body(kind, D);
}
