// Paged multi-query attention partials for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_paged_mq_pallas
// (kernel body _paged_kernel). One kernel serves every window width T:
// fused decode (T=1), chunked prefill (T=chunk) and, in a later slice,
// speculative verify, so the T=1 read is the decode read by construction.
//
// What it computes, per (sequence b, KV head k): the T*G query rows of
// that head group (T-major, row r = t*G + g, as flash_decode.py packs
// them) attend the paged prefix [0, lengths[b]) read through the block
// table. It emits UNNORMALIZED online-softmax partials in the reference
// layout: o (B,T,H,D) f32, m and l (B,T,H,1) f32, with m = max scaled
// score, l = sum of exp(score - m), o = sum of exp(score - m) * v. A row
// with lengths[b] == 0 emits o = 0, l = 0, m = -1e30 (never -inf: the
// LSE merge computes exp(m - m_glob)). int8 pages are dequantized with
// their per-(block, position, head) f32 scale while they are staged.
//
// Design (simple and right first): one thread block of 4 warps per
// (b, k, tile of 16 packed rows); each warp owns 4 rows. The block walks
// the table columns j < ceil(lengths[b] / bs), reading table[b, j] itself,
// stages the (bs x D) K and V page tile of head k into shared memory as
// f32, and each warp then computes its rows' scores (one lane per page
// position, FMA over D), the per-page max, the exp weights and the
// weighted V sum (one lane per 32-wide slice of D) in f32 registers.
//
// Bound on an H100 SXM (3.35 TB/s): the read is bytes-bound. The least
// traffic is every live K/V page byte (plus int8 scales) once, plus q
// read once and o, m, l written once; at the decode shape of the served
// model (16 KV heads, D=64, bf16 pages) that is 4 KiB of K and V per
// cached token per layer; int8 pages halve it and add 128 bytes of scales. What this design does about that bound: nothing yet.
// Each row tile of a (b, k) pair re-reads the pages (T*G > 16 rows means
// several tiles), loads are scalar rather than 16-byte vectors, and there
// is no cp.async/TMA pipelining of the next page behind the current
// one's math. Those are the next PRs' work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxDChunks = 4;  // head_dim <= 128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kWarps * 32)
paged_mq_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                const KT* __restrict__ v_pages,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ table,
                const int* __restrict__ lengths, float* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ l_out, int T,
                int H, int K, int D, int bs, int max_blocks,
                float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int G = H / K;
  const int rows = T * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kstride = D + 1;  // pad: lane i reads K row i without conflicts
  float* k_s = smem;                       // bs * (D + 1)
  float* v_s = k_s + bs * kstride;         // bs * D
  float* q_s = v_s + bs * D;               // kRowsPerBlock * D
  float* p_w = q_s + kRowsPerBlock * D + warp * bs;  // this warp's bs

  // stage this tile's query rows, pre-scaled as the reference does
  for (int idx = threadIdx.x; idx < kRowsPerBlock * D; idx += blockDim.x) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int r = row0 + rr;
    float val = 0.f;
    if (r < rows) {
      const int t = r / G;
      const int h = kh * G + (r - t * G);
      val = to_f32(q[((size_t)(b * T + t) * H + h) * D + d]) * sm_scale;
    }
    q_s[idx] = val;
  }

  float acc[kRowsPerWarp][kMaxDChunks];
  float m_row[kRowsPerWarp];
  float l_row[kRowsPerWarp];
#pragma unroll
  for (int rw = 0; rw < kRowsPerWarp; ++rw) {
    m_row[rw] = kNegInf;
    l_row[rw] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) acc[rw][c] = 0.f;
  }

  const int len = lengths[b];
  int n_cols = (len + bs - 1) / bs;  // columns past this never hold a key
  if (n_cols > max_blocks) n_cols = max_blocks;

  for (int j = 0; j < n_cols; ++j) {
    const size_t blk = (size_t)table[(size_t)b * max_blocks + j];
    __syncthreads();  // the previous page is consumed (and q_s is staged)
    for (int idx = threadIdx.x; idx < bs * D; idx += blockDim.x) {
      const int i = idx / D;
      const int d = idx - i * D;
      const size_t tok = (blk * bs + i) * K + kh;
      float kv = to_f32(k_pages[tok * D + d]);
      float vv = to_f32(v_pages[tok * D + d]);
      if (k_scale != nullptr) {
        kv *= k_scale[tok];
        vv *= v_scale[tok];
      }
      k_s[i * kstride + d] = kv;
      v_s[i * D + d] = vv;
    }
    __syncthreads();
    const int base = j * bs;
#pragma unroll
    for (int rw = 0; rw < kRowsPerWarp; ++rw) {
      const int rr = warp * kRowsPerWarp + rw;
      if (row0 + rr < rows) {  // warp-uniform
        const float* q_row = q_s + rr * D;
        float pmax = kNegInf;
        for (int i = lane; i < bs; i += 32) {
          float s = kNegInf;
          if (base + i < len) {
            const float* k_row = k_s + i * kstride;
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot = fmaf(q_row[d], k_row[d], dot);
            s = dot;
          }
          p_w[i] = s;
          pmax = fmaxf(pmax, s);
        }
        pmax = warp_max(pmax);
        const float m_new = fmaxf(m_row[rw], pmax);
        const float corr = expf(m_row[rw] - m_new);
        float psum = 0.f;
        for (int i = lane; i < bs; i += 32) {
          const float p = (base + i < len) ? expf(p_w[i] - m_new) : 0.f;
          p_w[i] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        __syncwarp();  // every lane's p is in p_w
        l_row[rw] = l_row[rw] * corr + psum;
#pragma unroll
        for (int c = 0; c < kMaxDChunks; ++c) acc[rw][c] *= corr;
        for (int i = 0; i < bs; ++i) {
          const float p = p_w[i];
          const float* v_row = v_s + i * D;
#pragma unroll
          for (int c = 0; c < kMaxDChunks; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[rw][c] = fmaf(p, v_row[d], acc[rw][c]);
          }
        }
        m_row[rw] = m_new;
        __syncwarp();  // p_w is rewritten by the next row
      }
    }
  }

#pragma unroll
  for (int rw = 0; rw < kRowsPerWarp; ++rw) {
    const int r = row0 + warp * kRowsPerWarp + rw;
    if (r < rows) {
      const int t = r / G;
      const int h = kh * G + (r - t * G);
      const size_t out = (size_t)(b * T + t) * H + h;
#pragma unroll
      for (int c = 0; c < kMaxDChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o[out * D + d] = acc[rw][c];
      }
      if (lane == 0) {
        m_out[out] = m_row[rw];
        l_out[out] = l_row[rw];
      }
    }
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scale, const float* v_scale, const int* table,
           const int* lengths, float* o, float* m, float* l, int B, int T,
           int H, int K, int D, int bs, int max_blocks, float sm_scale,
           cudaStream_t stream) {
  const int rows = T * (H / K);
  const dim3 grid(B, K, (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem =
      sizeof(float) *
      ((size_t)bs * (D + 1) + (size_t)bs * D + (size_t)kRowsPerBlock * D +
       (size_t)kWarps * bs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_mq_kernel<QT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_mq_kernel<QT, KT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scale, v_scale, table, lengths, o,
      m, l, T, H, K, D, bs, max_blocks, sm_scale);
  return (int)cudaGetLastError();
}

int launch_kv(int kv_kind, const void* q, const void* k_pages,
              const void* v_pages, const float* k_scale,
              const float* v_scale, const int* table, const int* lengths,
              float* o, float* m, float* l, int B, int T, int H, int K,
              int D, int bs, int max_blocks, float sm_scale,
              cudaStream_t stream) {
  using QT = __nv_bfloat16;
  switch (kv_kind) {
    case 0:
      return launch<QT, __nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                       table, lengths, o, m, l, B, T, H, K, D,
                                       bs, max_blocks, sm_scale, stream);
    case 1:
      return launch<QT, int8_t>(q, k_pages, v_pages, k_scale, v_scale, table,
                                lengths, o, m, l, B, T, H, K, D, bs,
                                max_blocks, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q is bf16. kv_kind: 0 = bf16 pages, 1 = int8 pages (then k_scale/v_scale
// are (n_blocks, bs, K, 1) f32, else null). Shapes and types are checked by
// the Python wrapper. Returns cudaGetLastError().
extern "C" int paged_attention_partial(
    const void* q, const void* k_pages, const void* v_pages, int kv_kind,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, float* o, float* m, float* l, int B, int T, int H,
    int K, int D, int bs, int max_blocks, float sm_scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (K <= 0 || H % K != 0 || D <= 0 || D > 32 * kMaxDChunks || bs <= 0 ||
      max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_kv(kv_kind, q, k_pages, v_pages, k_scale, v_scale, table,
                   lengths, o, m, l, B, T, H, K, D, bs, max_blocks, sm_scale,
                   static_cast<cudaStream_t>(stream));
}
