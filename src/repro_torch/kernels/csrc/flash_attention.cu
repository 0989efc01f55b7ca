// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py:
//   flash_attention_fwd      <- _fwd_kernel      (flash_attention.py:35)
//   flash_attention_bwd_dkv  <- _bwd_dkv_kernel  (flash_attention.py:120)
//   flash_attention_bwd_dq   <- _bwd_dq_kernel   (flash_attention.py:165)
//
// What they compute. Layout q (B,H,T,D), k/v (B,K,S,D), H = K*G, query
// head h reads K/V head h / G; bf16 or f32 in, f32 arithmetic inside.
// Scores are (q*scale).k; causal masking is top-left aligned (row i sees
// columns j <= i) and writes -1e30, never -inf.
//   fwd:     online softmax over key tiles up to the diagonal; writes
//            o = acc / max(l, 1e-30) in the input type and
//            lse = m + log(max(l, 1e-30)) in f32.
//   bwd_dkv: p = exp(s - lse), dp = dO.v, ds = p*(dp - delta)*scale with
//            delta = rowsum(dO*O) computed by the caller; dV += p^T dO and
//            dK += ds^T q, summed over the G query heads of the K/V head
//            inside the block (the reference sums its per-head f32
//            buffers outside), cast once to the input type.
//   bwd_dq:  dQ += ds k over key tiles up to the diagonal.
//
// Design (simple and right first). Tiles of 64 query rows by 64 keys,
// 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of a score tile, and dims
// tx + 16 k (k < DPT = ceil(D / 16)) of an output row. Operand tiles are
// staged into shared memory as f32, row-major with one float of padding
// so the column-strided reads of K are conflict-free; every product is a
// plain FMA loop over shared memory, accumulating in f32 registers. The
// 16 threads that share a row sit in one half-warp, so row max and row
// sum are shuffles. Causal blocks walk only the tiles up to (fwd, dq) or
// from (dkv) the diagonal, and the grid hands out the longest rows first.
//
// Bound on an H100 SXM at the training shape (B=4, H=16, T=S=2048, D=64,
// causal, bf16): the forward's useful work is 2*B*H*T^2*D = 3.4e10 FLOPs,
// 34.7 us at the 989 TFLOP/s bf16 tensor-core rate, above its 20 us of
// q/k/v/o/lse traffic at 3.35 TB/s, so it is bound by operations; the
// backward's five products are 2.5 times that, 86.8 us. What this design
// does about that bound: nothing yet. It runs on the FP32 FMA pipes
// (67 TFLOP/s at best), not the tensor cores, its inner loops issue one
// shared-memory load per two FMAs, nothing overlaps the next tile's loads
// with the current tile's math, and the two backward kernels each
// recompute S and dP. mma/wgmma tiles, TMA pipelining and a fused
// backward are the next PRs' work.
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
           int causal, float scale) {
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

  const int kend = causal ? min(S, q0 + kTile) : S;
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
        if (c >= S || (causal && r < c)) s[i][j] = kNegInf;
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
    int k0, int Tn, int S, int D, int causal, float scale, int ty, int tx) {
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
      if (causal && r < c) sv = kNegInf;
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
               T* __restrict__ dv, int H, int KH, int Tn, int S, int D,
               int causal, float scale) {
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
  const int qstart = causal ? (k0 / kTile) * kTile : 0;
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
                D, causal, scale, ty, tx);
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
        if (d < D) {
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
              int causal, float scale) {
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

  const int kend = causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage(k_s, kp, k0, S, D, 1.f);
    stage(v_s, vp, k0, S, D, 1.f);
    __syncthreads();
    p_ds_tile(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, q0, k0, Tn,
              S, D, causal, scale, ty, tx);
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
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  int rc = prepare(fwd_kernel<T, DPT>, smem);
  if (rc) return rc;
  const dim3 grid(B * H, n_tiles(Tn));
  fwd_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KH, Tn, S, D,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DPT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int KH, int Tn, int S, int D, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  int rc = prepare(bwd_dkv_kernel<T, DPT>, smem);
  if (rc) return rc;
  const dim3 grid(B * KH, n_tiles(S));
  bwd_dkv_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, KH, Tn, S, D, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DPT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int KH, int Tn, int S, int D, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  int rc = prepare(bwd_dq_kernel<T, DPT>, smem);
  if (rc) return rc;
  const dim3 grid(B * H, n_tiles(Tn));
  bwd_dq_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, KH, Tn, S, D, causal, scale);
  return (int)cudaGetLastError();
}

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
// cudaGetLastError() after its launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int kind, int B, int H, int KH, int Tn,
                                   int S, int D, int causal, float scale,
                                   void* stream) {
  if (bad_dims(B, H, KH, Tn, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_fwd, q, k, v, o, lse, B, H, KH, Tn, S, D, causal, scale,
              st);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int kind, int B,
                                       int H, int KH, int Tn, int S, int D,
                                       int causal, float scale,
                                       void* stream) {
  if (bad_dims(B, H, KH, Tn, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, H, KH, Tn, S,
              D, causal, scale, st);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int kind, int B, int H,
                                      int KH, int Tn, int S, int D,
                                      int causal, float scale,
                                      void* stream) {
  if (bad_dims(B, H, KH, Tn, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, H, KH, Tn, S, D,
              causal, scale, st);
}
