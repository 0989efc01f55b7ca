// Paged multi-query attention partials for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_paged_mq_pallas
// (kernel body _paged_kernel). One kernel serves every window width T:
// fused decode (T=1), chunked prefill (T=chunk) and speculative verify
// (T=depth+1), so the T=1 read is the decode read by construction.
//
// What it computes, per (sequence b, KV head k): the T*G query rows of
// that head group (T-major, row r = t*G + g, as flash_decode.py packs
// them) attend the paged prefix [0, lengths[b]) read through the block
// table. It emits UNNORMALIZED online-softmax partials in the reference
// layout: o (B,T,H,D) f32, m and l (B,T,H,1) f32, with m = max scaled
// score, l = sum of exp(score - m), o = sum of exp(score - m) * v, where
// score = (q * sm_scale) . k in f32. A row with lengths[b] == 0 emits
// o = 0, l = 0, m = -1e30 (never -inf: the LSE merge computes
// exp(m - m_glob)). int8 pages are dequantized in f32 with their
// per-(block, position, head) scale before the products, as the TPU body
// does.
//
// Bound on an H100 SXM (3.35 TB/s): the read is bytes-bound. The least
// traffic is every live K/V page byte (plus int8 scales) once, plus q read
// once and o, m, l written once; at the decode shape of the served model
// (16 KV heads, D=64, bf16 pages) that is 4 KiB of K and V per cached
// token per layer; int8 pages halve it and add 128 bytes of scales. The
// products, 4 * T * G * D operations a position and head, come to ~1
// operation a byte at decode and ~128 at a 64-token chunk of int8 pages,
// both below the ~295 at which the card's peak rate would bound them.
//
// Design: flash-decoding over pages, as dense_decode.cu does over
// positions. Grid (n_split, K, B). The live table columns of row b,
// n_cols = ceil(min(lengths[b], max_blocks * bs) / bs), are split over
// s = max(1, min(n_split, ceil(n_cols / kMinCols))) of the n_split blocks
// of its (b, kh) pair: split i takes columns [i * c, min((i + 1) * c,
// n_cols)) with c = ceil(n_cols / s), computed on the card from
// lengths[b], so a short row does not spread over dead columns and a split
// past its row's s reads nothing (it writes an empty partial). The
// wrapper picks n_split from B * K and the table width alone
// (flash_decode.paged_splits), never from T or a host read of lengths;
// it allows at most one split per kMinCols columns of the table, so s is
// min(n_split, ceil(n_cols / kMinCols)) whatever the table's width: a
// row's spans depend on its own length only, never on the table bucket,
// which the engine sizes by the batch's longest row.
//   Loads: a head's K or V row of a page is D contiguous elements (128
// bytes in bf16 at D = 64, 64 in int8), consecutive positions KS * D apart
// (KS the pool's heads a position: K, or more for a window of its heads).
// The block reads its span's block ids from the table once, then copies
// its pages (K, V and, for int8, the scales) with 16-byte cp.async into a
// ring of two granules in shared memory; a granule is up to 4 pages (64
// positions at block_size 16). The next granule's loads are issued before
// the block waits on this one's, so up to 8 pages are in flight at once
// (all of a span of up to two granules).
//   Rows: every T * G row of the pair is served by the same block, so a
// page is read from memory once per pair and split, whatever T is. Rows go
// in tiles of up to 64 rows (32 at D = 128: what the value phase's
// registers hold), shared memory sized to the rows there are, their
// q * scale staged in shared memory in f32;
// a longer window loops over row tiles with the span's pages still
// resident in the ring when they fit (two granules), else streamed in
// again (from L2). Each granule takes three phases, f32 throughout (the
// chunk shape's ~0.25 GFLOP is ~4 us at the FMA pipes' rate, and its
// q * scale operand is f32), so the online softmax steps a granule at a
// time, where the TPU body steps a page:
//   1. scores: threads take (row, position) pairs in tiles of 4 rows x 2
//      positions (1 x 1 when the tile has at most 4 rows, so a decode
//      row's 64 positions of a granule spread over 64 threads); each
//      pair's products are summed over d in 16-byte chunks taken in an
//      order rotated by the position (so a warp's K reads fall in
//      distinct banks);
//   2. softmax: 16 lanes a row take the granule's max, the correction and
//      the weights p = exp(s - m) in f32 (their sum by a fixed shuffle
//      tree);
//   3. values: o = o * corr + ((q0 + q1) + (q2 + q3)), q_k the sum of
//      p_i v_i over the granule's positions i = k mod 4, in order. In a
//      tile of at most 4 rows an item (row, 4 columns) takes 4 lanes, one
//      a quarter, summed by shuffles (a lone row's 16 column quads keep
//      64 threads busy, with chains a quarter as long); a larger tile
//      gives a thread whole 4 x 4 tiles, all four quarters in turn. Both
//      layouts round every element alike.
//   Merge: each split writes its (o, m, l) rows to an f32 workspace; the
// last block of a (b, kh) pair to arrive (a counter per pair, reset to 0
// by that block, so the kernel replays inside a CUDA graph) rescales the
// n_split partials to their common max and sums them in split order, so
// the result does not depend on which block finishes last: a warp per row
// takes the common max, each split's factor exp(m_i - m) (into shared
// memory) and l, a lane per split; then a thread per 4 columns sums o over
// the splits in split order, its 16-byte loads 16 at a time in flight.
// With one split the block writes the outputs directly. One call is one
// launch.
//   Row invariance: a row's arithmetic (its q, each score's products and
// shuffle tree, the granules and their softmax, the order of every sum
// and merge, the split spans) does not depend on T, on the other rows or
// on the table's width (empty splits add exact zeros to the merge, and
// the l tree's extra levels only add zero lanes), so row t of a T-wide
// read is bitwise the T=1 read of q[:, t], a verify step's rows are the
// decode read's, and a row's read is the same whichever rows share it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kE = 8;           // K/V elements a lane takes from a row
constexpr int kMaxD = 128;
// splits of a pair at most: the merge takes two a lane
constexpr int kMaxSplits = 64;
// live columns a split at least (flash_decode._PAGED_MIN_COLS)
constexpr int kMinCols = 4;
constexpr int kTblCache = 256;  // a span's block ids kept in shared memory
constexpr int kMaxDynSmem = 200 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the kE elements of a staged row at element d0, as f32
__device__ __forceinline__ void row_f32(const __nv_bfloat16* row, int d0,
                                        float (&f)[kE]) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + d0);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void row_f32(const int8_t* row, int d0,
                                        float (&f)[kE]) {
  const uint2 u = *reinterpret_cast<const uint2*>(row + d0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = static_cast<float>(static_cast<int8_t>((u.x >> (8 * i)) & 0xff));
    f[4 + i] =
        static_cast<float>(static_cast<int8_t>((u.y >> (8 * i)) & 0xff));
  }
}

// the 4 elements of a staged row at element d0, as f32
__device__ __forceinline__ void row4_f32(const __nv_bfloat16* row, int d0,
                                         float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(row + d0);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void row4_f32(const int8_t* row, int d0,
                                         float (&f)[4]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(row + d0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>((u >> (8 * i)) & 0xff));
}

// Shared memory of one ring slot: the K page, the V page (bs rows of D
// elements each, a row padded by 16 bytes so rows a few apart fall in
// other banks) and, for int8 pages, their bs + bs f32 scales; rounded up
// to 16 bytes, so every slot starts 16-byte aligned.
__host__ __device__ __forceinline__ int row_pitch(int D, int elt) {
  return D * elt + 16;
}
__host__ __device__ __forceinline__ int slot_bytes(int bs, int D, int elt,
                                                   int quant) {
  return (2 * bs * row_pitch(D, elt) + (quant ? 8 * bs : 0) + 15) & ~15;
}

// pages a granule takes: up to 4, and at most 64 positions unless a page
// alone is longer; the ring holds two granules
__host__ __device__ __forceinline__ int granule_pages(int bs) {
  return bs >= 64 ? 1 : min(4, 64 / bs);
}

// the score tile's floats: rt x (gp + 1), and at least kMaxSplits (the
// merge keeps a row's factors there)
__host__ __device__ __forceinline__ size_t score_floats(int rt, int gp) {
  return (size_t)max(rt * (gp + 1), kMaxSplits);
}

// dynamic shared memory: the ring (two granules of pages), then the row
// tile's scores (rt x (granule positions + 1)), its rows' m, l and
// correction, and its q
__host__ __device__ __forceinline__ size_t smem_bytes(int bs, int D,
                                                      int elt, int quant,
                                                      int rt) {
  const int gp = granule_pages(bs) * bs;
  return (size_t)2 * granule_pages(bs) * slot_bytes(bs, D, elt, quant) +
         sizeof(float) * (score_floats(rt, gp) + 3 * rt + (size_t)rt * (D + 4));
}

// KT: page element type. rt: rows of a row tile (at most tile_rows(D)).
template <typename KT>
__global__ void __launch_bounds__(kThreads, 4)
paged_mq_kernel(const __nv_bfloat16* __restrict__ q,
                const KT* __restrict__ k_pages,
                const KT* __restrict__ v_pages,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ table,
                const int* __restrict__ lengths, float* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ ws, int* __restrict__ counters, int T,
                int H, int K, int KS, int D, int bs, int max_blocks,
                int n_split, int rt, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tbl_s[kTblCache];
  __shared__ int last_s;
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int R = T * G;                    // rows of this (b, kh) pair
  const int lane = threadIdx.x & 31;
  const bool quant = k_scale != nullptr;
  const int row_b = D * (int)sizeof(KT);
  const int pitch = row_pitch(D, (int)sizeof(KT));
  const int sbytes = slot_bytes(bs, D, (int)sizeof(KT), quant);
  const int gpg = granule_pages(bs);      // pages a granule
  const int gp = gpg * bs;                // positions a granule
  const int nslot = 2 * gpg;              // ring slots
  // after the ring: the score / weight tile (rt x (gp + 1)), then each
  // row's running m and l and this granule's correction
  float* s_t = reinterpret_cast<float*>(smem + nslot * sbytes);
  const int s_ld = gp + 1;
  float* m_s = s_t + score_floats(rt, gp);
  float* l_s = m_s + rt;
  float* c_s = l_s + rt;
  float* q_t = c_s + rt;                  // the tile's q * scale, rt x q_ld
  const int q_ld = D + 4;

  // this split's columns [c0, c1); positions past len are masked
  int len = lengths[b];
  len = len < 0 ? 0 : min(len, max_blocks * bs);
  const int n_cols = (len + bs - 1) / bs;
  // the row's own split count: its spans follow its length alone
  const int n_row = max(1, min(n_split, (n_cols + kMinCols - 1) / kMinCols));
  const int chunk = (n_cols + n_row - 1) / n_row;
  const int c0 = min(split * chunk, n_cols);
  const int c1 = min(c0 + chunk, n_cols);
  const int span = c1 - c0;
  const int p_end = min(len, c1 * bs);    // this split's last position + 1
  const int n_gran = (span + gpg - 1) / gpg;

  // the workspace: o [pair][split][row][D], then m and l [pair][split][row]
  const long long pair = (long long)b * K + kh;
  const long long n_part = (long long)gridDim.y * gridDim.z * n_split * R;
  const long long part = (pair * n_split + split) * R;
  auto out_row = [&](int r) {            // row r's index in (B, T, H)
    const int t = r / G;
    return ((long long)b * T + t) * H + kh * G + (r - t * G);
  };
  // one row's partial -> the outputs (one split) or the workspace
  auto put = [&](int r, int d, float ov, float mv, float lv) {
    if (n_split == 1) {
      const long long out = out_row(r);
      o[out * D + d] = ov;
      if (d == 0) {
        m_out[out] = mv;
        l_out[out] = lv;
      }
    } else {
      ws[(part + r) * D + d] = ov;
      if (d == 0) {
        ws[n_part * D + part + r] = mv;
        ws[n_part * (D + 1) + part + r] = lv;
      }
    }
  };

  // the span's block ids, read once (the first kTblCache of them)
  for (int j = threadIdx.x; j < min(span, kTblCache); j += kThreads)
    tbl_s[j] = table[(long long)b * max_blocks + c0 + j];
  __syncthreads();
  // the pages of granule g (if any) -> their ring slots, one commit group
  auto issue = [&](int g) {
    const int j0 = g * gpg;
    const int np = max(0, min(gpg, span - j0));
    const int chunks = row_b / 16;        // 16-byte pieces of a row
    for (int e = threadIdx.x; e < bs * chunks; e += kThreads) {
      const int i = e / chunks;           // (row i, piece c) of every page
      const int c = e - i * chunks;
      for (int jj = 0; jj < np; ++jj) {
        const int j = j0 + jj;
        const long long blk = j < kTblCache
                                  ? tbl_s[j]
                                  : table[(long long)b * max_blocks + c0 + j];
        const long long at =
            ((blk * bs + i) * KS + kh) * D + c * (16 / sizeof(KT));
        unsigned char* dst =
            smem + ((g & 1) * gpg + jj) * sbytes + i * pitch + c * 16;
        cp_async16(dst, k_pages + at);
        cp_async16(dst + bs * pitch, v_pages + at);
      }
    }
    if (quant) {
      for (int idx = threadIdx.x; idx < np * 2 * bs; idx += kThreads) {
        const int jj = idx / (2 * bs);
        const int rest = idx - jj * 2 * bs;
        const int kv = rest / bs;
        const int i = rest - kv * bs;
        const int j = j0 + jj;
        const long long blk = j < kTblCache
                                  ? tbl_s[j]
                                  : table[(long long)b * max_blocks + c0 + j];
        float* sc = reinterpret_cast<float*>(
            smem + ((g & 1) * gpg + jj) * sbytes + 2 * bs * pitch);
        cp_async4(sc + rest,
                  (kv ? v_scale : k_scale) + (blk * bs + i) * KS + kh);
      }
    }
    cp_async_commit();
  };

  if (span == 0)                          // nothing to read: empty partials
    for (int idx = threadIdx.x; idx < R * D; idx += kThreads)
      put(idx / D, idx % D, 0.f, kNegInf, 0.f);
  const bool resident = n_gran <= 2;      // the whole span fits the ring
  for (int t0 = 0; span > 0 && t0 < R; t0 += rt) {
    const int nt = min(rt, R - t0);       // rows of this tile
    // the tile's q rows, scaled, into shared memory (f32)
    for (int idx = threadIdx.x; idx < nt * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      q_t[r * q_ld + d] =
          __bfloat162float(q[out_row(t0 + r) * D + d]) * sm_scale;
    }
    // values: o[r][d] = o * corr + ((q0 + q1) + (q2 + q3)), q_k the sum of
    // p_i v_i over the granule's positions i = k mod 4 (in order). Two
    // layouts of the same arithmetic: a tile of at most 4 rows gives each
    // item (row, column quad) 4 lanes, one a quarter, summed by shuffles
    // (a lone row's 16 column quads keep 64 threads busy); a larger tile
    // gives a thread whole 4-row x 4-column tiles, all four quarters in
    // turn. acc holds the running o: 4 items x 4 columns, or 2 tiles x 16.
    const bool small = nt <= 4;
    const int kq = lane & 3;              // the small layout's quarter
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int r = threadIdx.x; r < nt; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }

    // the first tile loads the span; later ones reload it only when it
    // does not fit in the ring
    const bool load = t0 == 0 || !resident;
    if (load) issue(0);
    for (int g = 0; g < n_gran; ++g) {
      if (load) {
        issue(g + 1);                     // into the other half of the ring
        cp_async_wait<1>();               // granule g has landed
      }
      __syncthreads();
      const int pos0 = (c0 + g * gpg) * bs;
      const int n_live = min(gp, p_end - pos0);  // >= 1
      // 1. s[r][i] = (q_r * scale) . k_i, the products summed over d in a
      // fixed order: thread tiles of 4 rows (1 in a small tile) x 2
      // positions, so a lone row's positions spread over 32 threads a
      // granule
      {
        const int rpt = small ? 1 : 4;    // rows a score tile
        const int ppt = small ? 1 : 2;    // positions a score tile
        const int nquad = (nt + rpt - 1) / rpt;
        const int npair = (n_live + ppt - 1) / ppt;
        for (int tt = threadIdx.x; tt < nquad * npair; tt += kThreads) {
          const int qd = tt / npair;
          const int i0 = (tt - qd * npair) * ppt;
          const KT* kr[2];
          float ksc[2];
#pragma unroll
          for (int pi = 0; pi < 2; ++pi) {
            const int i = min(i0 + pi, n_live - 1);
            const int jj = i / bs;
            const unsigned char* st = smem + ((g & 1) * gpg + jj) * sbytes;
            kr[pi] = reinterpret_cast<const KT*>(st + (i - jj * bs) * pitch);
            ksc[pi] = quant ? reinterpret_cast<const float*>(
                                  st + 2 * bs * pitch)[i - jj * bs]
                            : 1.f;
          }
          float sacc[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) sacc[u][0] = sacc[u][1] = 0.f;
          const float* qrow = q_t + qd * rpt * q_ld;
          const int nr = min(rpt, nt - qd * rpt);   // real rows, >= 1
          // the d chunks in an order rotated by the pair (a function of
          // the position alone), so the warp's K reads fall in distinct
          // banks
          const int nch = D / kE;
          int ch = (i0 / 2) % nch;        // i0 is even in the 2-wide tiles
          for (int n = 0; n < nch; ++n, ch = ch + 1 == nch ? 0 : ch + 1) {
            const int dc = ch * kE;
            float kf[2][kE];
#pragma unroll
            for (int pi = 0; pi < 2; ++pi) {
              if (pi >= ppt) break;
              row_f32(kr[pi], dc, kf[pi]);
              if (quant)
#pragma unroll
                for (int e = 0; e < kE; ++e) kf[pi][e] *= ksc[pi];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (u >= nr) break;             // uniform in the thread
              const int ru = u;
              const float4 qa =
                  *reinterpret_cast<const float4*>(qrow + ru * q_ld + dc);
              const float4 qb = *reinterpret_cast<const float4*>(
                  qrow + ru * q_ld + dc + 4);
              const float qv[kE] = {qa.x, qa.y, qa.z, qa.w,
                                    qb.x, qb.y, qb.z, qb.w};
#pragma unroll
              for (int pi = 0; pi < 2; ++pi) {
                if (pi >= ppt) break;
#pragma unroll
                for (int e = 0; e < kE; ++e)
                  sacc[u][pi] = fmaf(qv[e], kf[pi][e], sacc[u][pi]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int pi = 0; pi < 2; ++pi)
              if (u < nr && pi < ppt && i0 + pi < n_live)
                s_t[(qd * rpt + u) * s_ld + i0 + pi] = sacc[u][pi];
        }
      }
      __syncthreads();
      // 2. each row's online softmax over this granule's live positions:
      // 16 lanes a row, lane i taking positions i, i + 16, ...; the max,
      // and the sum of the weights by a fixed shuffle tree
      for (int k = 0; k < nt; k += kThreads / 16) {  // uniform trip count
        const int r = k + threadIdx.x / 16;
        const bool row = r < nt;
        float* sr = s_t + (row ? r : 0) * s_ld;
        const int li = threadIdx.x % 16;
        float mx = kNegInf;
        for (int i = li; i < n_live; i += 16) mx = fmaxf(mx, sr[i]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = row ? m_s[r] : 0.f;
        const float m_new = fmaxf(m_old, mx);
        float psum = 0.f;
        for (int i = li; i < n_live; i += 16) {
          const float pv = expf(sr[i] - m_new);
          if (row) sr[i] = pv;
          psum += pv;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        if (row && li == 0) {
          const float corr = expf(m_old - m_new);
          l_s[r] = fmaf(l_s[r], corr, psum);
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
      __syncthreads();
      // 3. the values (layouts above)
      {
        // q[u][e] += p[row u][i] v[i][c0 + e] over quarter k's live
        // positions i = k, k + 4, ... in order, for rows r0 .. r0 + nr - 1
        auto quarter = [&](int k, int r0, int nr, int c0,
                           float (&qs)[4][4]) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) qs[u][e] = 0.f;
          int jj = 0;                     // page and position of i
          int ip = k;
          while (ip >= bs) {
            ip -= bs;
            ++jj;
          }
          for (int i = k; i < n_live; i += 4) {
            const unsigned char* st = smem + ((g & 1) * gpg + jj) * sbytes;
            float vf[4];
            row4_f32(reinterpret_cast<const KT*>(st + (bs + ip) * pitch), c0,
                     vf);
            if (quant) {
              const float sc = reinterpret_cast<const float*>(
                  st + 2 * bs * pitch)[bs + ip];
#pragma unroll
              for (int e = 0; e < 4; ++e) vf[e] *= sc;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (u < nr) {
                const float pw = s_t[(r0 + u) * s_ld + i];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  qs[u][e] = fmaf(pw, vf[e], qs[u][e]);
              }
            }
            ip += 4;
            while (ip >= bs) {
              ip -= bs;
              ++jj;
            }
          }
        };
        if (small) {
          const int n_items = nt * (D / 4);
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            if (it * 32 + (threadIdx.x / 32) * 8 >= n_items) continue;  // warp
            const int item = (it * kThreads + threadIdx.x) / 4;
            const bool live = item < n_items;  // uniform in the item's lanes
            const int r = live ? item / (D / 4) : 0;
            const int c0 = (item - r * (D / 4)) * 4;
            float qs[4][4];
            quarter(kq, r, live ? 1 : 0, c0, qs);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              qs[0][e] += __shfl_xor_sync(0xffffffffu, qs[0][e], 1);
              qs[0][e] += __shfl_xor_sync(0xffffffffu, qs[0][e], 2);
            }
            if (live) {
              const float c = c_s[r];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[it * 4 + e] = fmaf(acc[it * 4 + e], c, qs[0][e]);
            }
          }
        } else {
          const int n_tiles = ((nt + 3) / 4) * (D / 4);
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const int tt = w * kThreads + threadIdx.x;
            if (tt < n_tiles) {
              const int r0 = (tt / (D / 4)) * 4;
              const int c0 = (tt - (r0 / 4) * (D / 4)) * 4;
              const int nr = min(4, nt - r0);
              float t01[4][4], qa[4][4], qb[4][4];
              quarter(0, r0, nr, c0, qa);
              quarter(1, r0, nr, c0, qb);
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) t01[u][e] = qa[u][e] + qb[u][e];
              quarter(2, r0, nr, c0, qa);
              quarter(3, r0, nr, c0, qb);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float c = u < nr ? c_s[r0 + u] : 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[w * 16 + u * 4 + e] = fmaf(
                      acc[w * 16 + u * 4 + e], c,
                      t01[u][e] + (qa[u][e] + qb[u][e]));
              }
            }
          }
        }
      }
      __syncthreads();                    // ring half and s_t free again
    }
    // this tile's partial
    if (small) {                          // lane k of an item: column k
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int item = (it * kThreads + threadIdx.x) / 4;
        if (item < nt * (D / 4)) {
          const int r = item / (D / 4);
          const int d = (item - r * (D / 4)) * 4 + kq;
          const float ov = kq == 0 ? acc[it * 4] : kq == 1 ? acc[it * 4 + 1]
                         : kq == 2 ? acc[it * 4 + 2] : acc[it * 4 + 3];
          put(t0 + r, d, ov, m_s[r], l_s[r]);
        }
      }
    } else {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int tt = w * kThreads + threadIdx.x;
        if (tt < ((nt + 3) / 4) * (D / 4)) {
          const int r0 = (tt / (D / 4)) * 4;
          const int c0 = (tt - (r0 / 4) * (D / 4)) * 4;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r0 + u < nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                put(t0 + r0 + u, c0 + e, acc[w * 16 + u * 4 + e],
                    m_s[r0 + u], l_s[r0 + u]);
        }
      }
    }
    __syncthreads();                      // m_s, l_s are reset next tile
  }
  cp_async_wait<0>();
  if (n_split == 1) return;

  // the last split of this (b, kh) to arrive merges all of them
  __threadfence();                        // this block's partial is visible
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // per row (a warp each): the common max m, each split's factor
  // exp(m_i - m) into shared memory (rows in chunks) and l, summed over
  // the splits by a fixed shuffle tree; then o summed over the splits in
  // split order, four columns a thread with 16-byte loads. An empty split
  // holds m = -1e30, l = 0, o = 0: its factor is 0 beside a live one, and
  // 1 (times zeros) when the row is empty.
  float* fac = s_t;                       // score_floats >= kMaxSplits
  const long long base = pair * n_split * R;  // split i, row r: base + i*R + r
  const int rows_per = (int)score_floats(rt, gp) / n_split;
  const int vecs = D / 4;
  const int warp = threadIdx.x >> 5;
  for (int q0 = 0; q0 < R; q0 += rows_per) {
    const int nq = min(rows_per, R - q0);
    // a segment of sw lanes a row (sw: n_split rounded up to a power of
    // two, at most 32), lane li taking splits li and li + 32
    const int sw = n_split <= 2 ? 2 : n_split <= 4 ? 4 : n_split <= 8 ? 8
                 : n_split <= 16 ? 16 : 32;
    const int li = lane % sw;
    const int rpp = kThreads / sw;        // rows a pass
    for (int k0 = 0; k0 < nq; k0 += 4 * rpp) {
      float mi[4][2], lj[4][2];
#pragma unroll
      for (int w = 0; w < 4; ++w) {       // every load of 4 passes first
        const int rr = k0 + w * rpp + threadIdx.x / sw;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = li + 32 * h;
          const bool in = rr < nq && i < n_split;
          const long long at = base + q0 + rr + (long long)i * R;
          mi[w][h] = in ? __ldcg(ws + n_part * D + at) : kNegInf;
          lj[w][h] = in ? __ldcg(ws + n_part * (D + 1) + at) : 0.f;
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int rr = k0 + w * rpp + threadIdx.x / sw;
        const bool row = rr < nq;
        float mg = fmaxf(mi[w][0], mi[w][1]);
        for (int off = sw / 2; off > 0; off >>= 1)
          mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
        float lv = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = li + 32 * h;
          const float f = expf(mi[w][h] - mg);
          if (row && i < n_split) {
            fac[rr * n_split + i] = f;
            lv = fmaf(lj[w][h], f, lv);
          }
        }
        for (int off = sw / 2; off > 0; off >>= 1)
          lv += __shfl_xor_sync(0xffffffffu, lv, off);
        if (row && li == 0) {
          const long long out = out_row(q0 + rr);
          m_out[out] = mg;
          l_out[out] = lv;
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * vecs; idx += kThreads) {
      const int rr = idx / vecs;
      const int d = (idx - rr * vecs) * 4;
      const float* src = ws + (base + q0 + rr) * D + d;
      const long long stride = (long long)R * D;   // split to split
      float4 ov = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i0 = 0; i0 < n_split; i0 += 16) {
        float4 oi[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)      // every load of the 16 first
          oi[u] = i0 + u < n_split
                      ? __ldcg(reinterpret_cast<const float4*>(
                            src + (i0 + u) * stride))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (i0 + u < n_split) {
            const float f = fac[rr * n_split + i0 + u];
            ov.x = fmaf(oi[u].x, f, ov.x);
            ov.y = fmaf(oi[u].y, f, ov.y);
            ov.z = fmaf(oi[u].z, f, ov.z);
            ov.w = fmaf(oi[u].w, f, ov.w);
          }
        }
      }
      *reinterpret_cast<float4*>(o + out_row(q0 + rr) * D + d) = ov;
    }
    __syncthreads();                      // fac is rewritten next chunk
  }
  if (threadIdx.x == 0) counters[pair] = 0;   // ready for the next call
}

template <typename KT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scale, const float* v_scale, const int* table,
           const int* lengths, float* o, float* m, float* l, float* ws,
           int* counters, int B, int T, int H, int K, int KS, int D, int bs,
           int max_blocks, int n_split, int rt, float sm_scale,
           cudaStream_t stream) {
  const size_t smem =
      smem_bytes(bs, D, (int)sizeof(KT), k_scale != nullptr, rt);
  // opt in once past the 48 KB a block gets by default
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      paged_mq_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(n_split, K, B);
  paged_mq_kernel<KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scale, v_scale, table, lengths, o,
      m, l, ws, counters, T, H, K, KS, D, bs, max_blocks, n_split, rt,
      sm_scale);
  return (int)cudaGetLastError();
}

// rows of a row tile: the value phase's 4 x 4 tiles, two a thread, cover
// it (rows / 4 x D / 4 <= 2 * 128)
int tile_rows(int D) { return D <= 64 ? 64 : 32; }

}  // namespace

// q is bf16 (B,T,H,D). kv_kind: 0 = bf16 pages, 1 = int8 pages (then
// k_scale/v_scale are (n_blocks, bs, K, 1) f32, else null). The pages
// may be a window of K heads of a pool KS heads wide (KS >= K: a rank
// that holds every KV head reads those its q heads map to, in place):
// a position's heads KS * D elements apart, its scales KS apart, and the
// pointers at the window's first head. ws holds
// B * K * n_split * T * (H / K) * (D + 2) floats (unused when n_split ==
// 1); counters B * K ints, zero before the first call (each call leaves
// them zero). Pages are 16-byte aligned, D a multiple of 16, and n_split
// at most kMaxSplits. Shapes and types are checked by the Python wrapper.
// Returns a cudaError_t as int: cudaErrorInvalidValue for shapes the
// kernel does not take, else cudaGetLastError() after the launch.
extern "C" int paged_attention_partial(
    const void* q, const void* k_pages, const void* v_pages, int kv_kind,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, float* o, float* m, float* l, float* ws,
    int* counters, int B, int T, int H, int K, int KS, int D, int bs,
    int max_blocks, int n_split, float sm_scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (B < 0 || B > 65535 || K <= 0 || K > 65535 || KS < K || H % K != 0 ||
      D <= 0 || D > kMaxD || D % 16 != 0 || bs <= 0 || max_blocks <= 0 ||
      n_split < 1 || n_split > kMaxSplits ||
      (kv_kind == 1) != (k_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elt = kv_kind == 1 ? 1 : 2;
  // a tile of the pair's rows (rounded up to 4), at most tile_rows(D):
  // shared memory for the rows there are
  const int rt = min(tile_rows(D), (T * (H / K) + 3) / 4 * 4);
  if (smem_bytes(bs, D, elt, kv_kind == 1, rt) > kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
  switch (kv_kind) {
    case 0:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                   table, lengths, o, m, l, ws, counters, B,
                                   T, H, K, KS, D, bs, max_blocks, n_split,
                                   rt, sm_scale, st);
    case 1:
      return launch<int8_t>(q, k_pages, v_pages, k_scale, v_scale, table,
                            lengths, o, m, l, ws, counters, B, T, H, K, KS, D,
                            bs, max_blocks, n_split, rt, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
