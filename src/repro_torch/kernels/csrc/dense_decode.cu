// Dense-cache single-token decode partials for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/flash_decode.py:
//   flash_decode_partial  <-  _decode_kernel (flash_decode.py:54), wrapper
//                             flash_decode_partial (flash_decode.py:93)
//
// What it computes, per (sequence b, KV head kh): the G = H / K query heads
// of that group attend positions [0, min(lengths[b], S)) of k[b, kh] and
// v[b, kh] and emit UNNORMALIZED online-softmax partials: o (B, H, D) f32 =
// sum_s exp(score_s - m) v_s, m (B, H, 1) f32 = max_s score_s, l (B, H, 1)
// f32 = sum_s exp(score_s - m), with score_s = (q * sm_scale) . k_s in f32.
// Positions at or past lengths[b] are masked, and a row stops reading at
// its length. A zero-length row emits o = 0, l = 0, m = -1e30 (never
// -inf: a later LSE merge computes exp(m - m_glob)), as the TPU kernel and
// the paged read do. S need not divide any tile. q is (B, H, D) row-major;
// k and v are read as [b, kh, s, d] through element strides (d contiguous),
// so the models' (B, S, K, D) cache is read in place, without a transpose.
// q, k and v are all bf16 or all f32.
//
// Design (simple and right first). One block of 4 warps per (b, kh). The
// G query rows are staged in shared memory as f32, pre-scaled. Warp w walks
// the 32-position tiles w, w + 4, ...: lane i owns position tile * 32 + i,
// reads its key row and dots it with the G rows; the warp then takes each
// row's tile max, the exp weights and their sum with shuffles, and updates
// its own running (m, l, acc) in registers, lane i holding acc columns
// i + 32c. The four warps' partials LSE-merge in shared memory at the end.
// The TPU kernel instead walks the cache in order with one running state
// per (b, kh), one 256-position block per grid step.
//
// Bound on an H100 SXM: bytes. The least traffic is every live K and V
// element once (2 * K * D * elt per position: 4 KiB per cached token per
// layer at qwen1.5-0.5b's 16 KV heads of 64 in bf16), plus q, o, m, l and
// lengths once; the products are 4 * H * D operations a position, ~256x
// below the bf16 tensor-core rate at that traffic. What this design does
// about the bound: every live K and V element is read once from device
// memory and nothing past a row's length is read. It does not yet reach it:
// each lane reads its key row with scalar loads 2 KiB apart from its
// neighbours', and a (b, kh) pair gets one block, so at batch 1 only K
// blocks run (16 of 132 SMs at the draft model's shape). Splitting the
// positions over blocks, with a merge pass, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;
constexpr int kMaxDChunks = 4;          // head_dim <= 128
constexpr int kMaxD = 32 * kMaxDChunks;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int H, int K, int S, int D,
                    long long skb, long long skk, long long sks,
                    long long svb, long long svk, long long svs,
                    float sm_scale) {
  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float p_s[kWarps][kMaxG][32];
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];
  __shared__ float acc_s[kWarps][kMaxG][kMaxD];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx - g * D;
    q_s[g][d] =
        to_f32(q[((long long)b * H + kh * G + g) * D + d]) * sm_scale;
  }
  __syncthreads();

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n_tiles = (len + 31) / 32;
  const T* kb = k + b * skb + kh * skk;
  const T* vb = v + b * svb + kh * svk;

  float acc[kMaxG][kMaxDChunks];
  float m_r[kMaxG];
  float l_r[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m_r[g] = kNegInf;
    l_r[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) acc[g][c] = 0.f;
  }

  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    const int base = tile * 32;
    const bool live = base + lane < len;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kb + (long long)(base + lane) * sks;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kv = to_f32(kr[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s[g] = fmaf(q_s[g][d], kv, s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {                        // block-uniform
        const float sg = live ? s[g] : kNegInf;
        const float m_new = fmaxf(m_r[g], warp_max(sg));
        const float p = live ? expf(sg - m_new) : 0.f;
        const float corr = expf(m_r[g] - m_new);
        l_r[g] = l_r[g] * corr + warp_sum(p);
#pragma unroll
        for (int c = 0; c < kMaxDChunks; ++c) acc[g][c] *= corr;
        p_s[warp][g][lane] = p;
        m_r[g] = m_new;
      }
    }
    __syncwarp();                         // every lane's p is in p_s
    const int n_live = min(32, len - base);
#pragma unroll 8                          // 8 positions' V loads in flight
    for (int i = 0; i < n_live; ++i) {
      const T* vr = vb + (long long)(base + i) * svs;
#pragma unroll
      for (int c = 0; c < kMaxDChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float vv = to_f32(vr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][c] = fmaf(p_s[warp][g][i], vv, acc[g][c]);
        }
      }
    }
    __syncwarp();                         // p_s is rewritten next tile
  }

  // the four warps' partials -> one LSE merge per (query head, column)
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp][g] = m_r[g];
        l_s[warp][g] = l_r[g];
      }
#pragma unroll
      for (int c = 0; c < kMaxDChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc_s[warp][g][d] = acc[g][c];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mg = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mg = fmaxf(mg, m_s[w][g]);
    float ov = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // an idle warp holds m = -1e30, l = 0, acc = 0: its factor is 0
      // beside a live warp, and 1 (times zeros) when the row is empty
      const float f = expf(m_s[w][g] - mg);
      ov = fmaf(acc_s[w][g][d], f, ov);
      lv = fmaf(l_s[w][g], f, lv);
    }
    const long long out = (long long)b * H + kh * G + g;
    o[out * D + d] = ov;
    if (d == 0) {
      m_out[out] = mg;
      l_out[out] = lv;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* o, float* m, float* l, int B, int H, int K, int S, int D,
           const long long* ks, const long long* vs, float sm_scale,
           cudaStream_t stream) {
  const dim3 grid(B, K);
  dense_decode_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, o, m, l, H, K, S, D, ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 = f32, 1 = bf16 (q, k and v alike). k_strides / v_strides are
// the element strides of the (b, kh, s) axes; d is contiguous. Returns a
// cudaError_t as int: cudaErrorInvalidValue for shapes the kernel does not
// take, else cudaGetLastError() after the launch.
extern "C" int dense_decode_partial(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    float* o, float* m, float* l, int B,
                                    int H, int K, int S, int D,
                                    const long long* k_strides,
                                    const long long* v_strides,
                                    float sm_scale, int kind, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || K <= 0 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || D <= 0 || D > kMaxD || S < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float>(q, k, v, lengths, o, m, l, B, H, K, S, D,
                           k_strides, v_strides, sm_scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lengths, o, m, l, B, H, K, S,
                                   D, k_strides, v_strides, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
