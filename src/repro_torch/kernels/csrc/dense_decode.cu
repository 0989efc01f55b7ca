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
// Bound on an H100 SXM: bytes. The least traffic is every live K and V
// element once (2 * K * D * elt per position: 4 KiB per cached token per
// layer at qwen1.5-0.5b's 16 KV heads of 64 in bf16), plus q, o, m, l and
// lengths once; the products are 4 * H * D operations a position, ~256x
// below the bf16 tensor-core rate at that traffic.
//
// Design: flash-decoding. The TPU kernel walks the cache in order with one
// running state per (b, kh); here the positions of a row are split over
// n_split blocks (grid (n_split, K, B)), chosen by the wrapper from B * K
// and S so that about two blocks run on each of the 132 SMs: at the draft
// model's batch of 1 (K = 16) that is 16 splits of ~67 positions, where
// one block per (b, kh) left 116 SMs idle. Split i of row b covers
// positions [i * c, min((i + 1) * c, len)) with c = ceil(len / n_split), so
// every split of a row gets the same work and a split past the row's length
// reads nothing.
//   Loads: a key row of D = 64 bf16 is 128 contiguous bytes, so LPR = 8
// lanes share a row and each loads 16 bytes (one warp instruction covers
// 4 rows; D = 128 takes 16 lanes a row, f32 twice as many). A lane group
// of LPR lanes dots its row with the G query rows held in registers and
// sums the dot over its lanes with shuffles, then updates its own running
// (m, l, acc) in f32 registers; each group walks every (4 * 32 / LPR)-th
// position of the split, four positions per step with all eight 16-byte
// K and V loads issued before any math. The groups of a warp, then the
// four warps, LSE-merge their partials (shuffles, then shared memory).
//   Merge: each split writes its (o, m, l) to an f32 workspace the wrapper
// allocates; the last block of a (b, kh) pair to finish (a counter per
// pair, which that block resets to 0, so the kernel replays inside a CUDA
// graph) rescales the n_split partials to their common max and sums them
// in split order, so the result does not depend on which block finishes
// last. With one split the block writes the outputs directly. One call is
// one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
constexpr int kUnroll = 4;              // positions per lane group per step
constexpr float kNegInf = -1e30f;

// elements of T in one 16-byte load
template <typename T>
struct Elems {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// The 16 bytes of row `row` at element d0 (Elems<T>::n elements), zero past
// D. `vec`: the row and d0 are 16-byte aligned and D is a multiple of the
// vector, so one load; else element by element.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* row, int d0, int D,
                                        bool vec) {
  constexpr int n = Elems<T>::n;
  if (vec) {
    if (d0 >= D) return make_uint4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const uint4*>(row + d0));
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const uint32_t e = d0 + j < D ? bits(row[d0 + j]) : 0u;
    if (n == 4)
      w[j] = e;
    else
      w[j / 2] |= e << (16 * (j % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void unpack(uint4 u, float (&f)[Elems<T>::n]);
template <>
__device__ __forceinline__ void unpack<float>(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 u,
                                                      float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// T: element type; LPR: lanes per key row (LPR * Elems<T>::n >= D);
// GM: the query heads per KV head rounded up to a power of two (G <= GM).
template <typename T, int LPR, int GM>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ ws,
                    int* __restrict__ counters, int H, int K, int S, int D,
                    long long skb, long long skk, long long sks,
                    long long svb, long long svk, long long svs,
                    int n_split, int vec, float sm_scale) {
  constexpr int E = Elems<T>::n;
  constexpr int RPW = 32 / LPR;         // rows a warp covers per load
  constexpr int NS = kWarps * RPW;      // position slots of the block
  __shared__ float acc_s[kWarps][GM][kMaxD];
  __shared__ float m_s[kWarps][GM];
  __shared__ float l_s[kWarps][GM];
  __shared__ int last_s;
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPR;           // which 16 bytes of the row
  const int grp = lane / LPR;           // which row of the warp's RPW
  const int d0 = sub * E;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int chunk = (len + n_split - 1) / n_split;
  const int p0 = min(split * chunk, len);
  const int p1 = min(p0 + chunk, len);

  float qr[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int d = d0 + j;
      qr[g][j] = (g < G && d < D)
                     ? to_f32(q[((long long)b * H + kh * G + g) * D + d]) *
                           sm_scale
                     : 0.f;
    }
  }

  float acc[GM][E];
  float m_r[GM];
  float l_r[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m_r[g] = kNegInf;
    l_r[g] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[g][j] = 0.f;
  }

  const T* kb = k + b * skb + kh * skk;
  const T* vb = v + b * svb + kh * svk;
  const int slot = warp * RPW + grp;
  for (int base = p0; base < p1; base += NS * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the step first
      const int p = base + u * NS + slot;
      if (p < p1) {
        kraw[u] = load16(kb + (long long)p * sks, d0, D, vec);
        vraw[u] = load16(vb + (long long)p * svs, d0, D, vec);
      } else {
        kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + u * NS + slot < p1;  // uniform in a group
      float kf[E], vf[E];
      unpack<T>(kraw[u], kf);
      unpack<T>(vraw[u], vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {                    // block-uniform
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < E; ++j) s = fmaf(qr[g][j], kf[j], s);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (live) {
            const float m_new = fmaxf(m_r[g], s);
            const float corr = expf(m_r[g] - m_new);
            const float p = expf(s - m_new);
            l_r[g] = fmaf(l_r[g], corr, p);
#pragma unroll
            for (int j = 0; j < E; ++j)
              acc[g][j] = fmaf(acc[g][j], corr, p * vf[j]);
            m_r[g] = m_new;
          }
        }
      }
    }
  }

  // the RPW lane groups of a warp -> one partial (lanes sub, sub + LPR, ...
  // hold the same columns); an empty group holds m = -1e30, l = 0, acc = 0
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m_r[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l_r[g], off);
        const float m_new = fmaxf(m_r[g], mo);
        const float f1 = expf(m_r[g] - m_new);
        const float f2 = expf(mo - m_new);
        l_r[g] = l_r[g] * f1 + lo * f2;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
          acc[g][j] = acc[g][j] * f1 + ao * f2;
        }
        m_r[g] = m_new;
      }
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < E; ++j)
          if (d0 + j < D) acc_s[warp][g][d0 + j] = acc[g][j];
        if (sub == 0) {
          m_s[warp][g] = m_r[g];
          l_s[warp][g] = l_r[g];
        }
      }
    }
  }
  __syncthreads();

  // the four warps -> the block's partial: to the outputs (one split) or
  // to the workspace, laid out [b][kh][split][g] x (D + 2): o, then m, l
  const long long pair = (long long)b * K + kh;
  const int row = D + 2;
  float* part = n_split == 1 ? nullptr
                             : ws + (pair * n_split + split) * G * row;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mg = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mg = fmaxf(mg, m_s[w][g]);
    float ov = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][g] - mg);
      ov = fmaf(acc_s[w][g][d], f, ov);
      lv = fmaf(l_s[w][g], f, lv);
    }
    if (n_split == 1) {
      const long long out = pair * G + g;
      o[out * D + d] = ov;
      if (d == 0) {
        m_out[out] = mg;
        l_out[out] = lv;
      }
    } else {
      part[g * row + d] = ov;
      if (d == 0) {
        part[g * row + D] = mg;
        part[g * row + D + 1] = lv;
      }
    }
  }
  if (n_split == 1) return;

  // the last split of this (b, kh) to arrive merges all of them
  __threadfence();                      // this block's partial is visible
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = ws + pair * n_split * G * row;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mg = kNegInf;
    for (int i = 0; i < n_split; ++i)
      mg = fmaxf(mg, __ldcg(parts + (i * G + g) * row + D));
    float ov = 0.f, lv = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float* pi = parts + (i * G + g) * row;
      // an empty split holds m = -1e30, l = 0, o = 0: its factor is 0
      // beside a live one, and 1 (times zeros) when the row is empty
      const float f = expf(__ldcg(pi + D) - mg);
      ov = fmaf(__ldcg(pi + d), f, ov);
      lv = fmaf(__ldcg(pi + D + 1), f, lv);
    }
    const long long out = pair * G + g;
    o[out * D + d] = ov;
    if (d == 0) {
      m_out[out] = mg;
      l_out[out] = lv;
    }
  }
  if (threadIdx.x == 0) counters[pair] = 0;   // ready for the next call
}

template <typename T, int LPR, int GM>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* o, float* m, float* l, float* ws, int* counters, int B,
           int H, int K, int S, int D, const long long* ks,
           const long long* vs, int n_split, int vec, float sm_scale,
           cudaStream_t stream) {
  const dim3 grid(n_split, K, B);
  dense_decode_kernel<T, LPR, GM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, o, m, l, ws, counters, H, K, S, D,
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], n_split, vec, sm_scale);
  return (int)cudaGetLastError();
}

// the lanes a row takes (16 bytes each, at least 4) and the head group,
// both rounded up to a power of two
template <typename T, int GM>
int by_lanes(int lanes, const void* q, const void* k, const void* v,
             const int* lengths, float* o, float* m, float* l, float* ws,
             int* counters, int B, int H, int K, int S, int D,
             const long long* ks, const long long* vs, int n_split, int vec,
             float sm_scale, cudaStream_t st) {
  if (lanes <= 4)
    return launch<T, 4, GM>(q, k, v, lengths, o, m, l, ws, counters, B, H,
                            K, S, D, ks, vs, n_split, vec, sm_scale, st);
  if (lanes <= 8)
    return launch<T, 8, GM>(q, k, v, lengths, o, m, l, ws, counters, B, H,
                            K, S, D, ks, vs, n_split, vec, sm_scale, st);
  if (lanes <= 16)
    return launch<T, 16, GM>(q, k, v, lengths, o, m, l, ws, counters, B, H,
                             K, S, D, ks, vs, n_split, vec, sm_scale, st);
  return launch<T, 32, GM>(q, k, v, lengths, o, m, l, ws, counters, B, H,
                           K, S, D, ks, vs, n_split, vec, sm_scale, st);
}

template <typename T>
int by_groups(int G, int lanes, const void* q, const void* k, const void* v,
              const int* lengths, float* o, float* m, float* l, float* ws,
              int* counters, int B, int H, int K, int S, int D,
              const long long* ks, const long long* vs, int n_split, int vec,
              float sm_scale, cudaStream_t st) {
  if (G == 1)
    return by_lanes<T, 1>(lanes, q, k, v, lengths, o, m, l, ws, counters, B,
                          H, K, S, D, ks, vs, n_split, vec, sm_scale, st);
  if (G == 2)
    return by_lanes<T, 2>(lanes, q, k, v, lengths, o, m, l, ws, counters, B,
                          H, K, S, D, ks, vs, n_split, vec, sm_scale, st);
  if (G <= 4)
    return by_lanes<T, 4>(lanes, q, k, v, lengths, o, m, l, ws, counters, B,
                          H, K, S, D, ks, vs, n_split, vec, sm_scale, st);
  return by_lanes<T, 8>(lanes, q, k, v, lengths, o, m, l, ws, counters, B, H,
                        K, S, D, ks, vs, n_split, vec, sm_scale, st);
}

}  // namespace

// kind: 0 = f32, 1 = bf16 (q, k and v alike). k_strides / v_strides are
// the element strides of the (b, kh, s) axes; d is contiguous. ws holds
// B * K * n_split * G * (D + 2) floats (unused when n_split == 1);
// counters B * K ints, zero before the first call (each call leaves them
// zero). vec: k and v rows are 16-byte aligned and D a multiple of 16
// bytes. Returns a cudaError_t as int: cudaErrorInvalidValue for shapes the
// kernel does not take, else cudaGetLastError() after the launch.
extern "C" int dense_decode_partial(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    float* o, float* m, float* l, float* ws,
                                    int* counters, int B, int H, int K,
                                    int S, int D,
                                    const long long* k_strides,
                                    const long long* v_strides, int n_split,
                                    int vec, float sm_scale, int kind,
                                    void* stream) {
  if (B == 0) return 0;
  if (B < 0 || B > 65535 || K <= 0 || K > 65535 || H % K != 0 ||
      H / K > kMaxG || D <= 0 || D > kMaxD || S < 0 || n_split < 1 ||
      n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  switch (kind) {
    case 0:
      return by_groups<float>(G, (D + 3) / 4, q, k, v, lengths, o, m, l, ws,
                              counters, B, H, K, S, D, k_strides, v_strides,
                              n_split, vec, sm_scale, s);
    case 1:
      return by_groups<__nv_bfloat16>(G, (D + 7) / 8, q, k, v, lengths, o, m,
                                      l, ws, counters, B, H, K, S, D,
                                      k_strides, v_strides, n_split, vec,
                                      sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
