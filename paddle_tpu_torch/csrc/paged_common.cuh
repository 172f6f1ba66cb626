// Shared body of the paged attention kernels at fp32 queries: decode,
// multi-query verify and chunk prefill (their bf16 and fp16 queries take
// the split-KV body of paged_split.cuh).
//
// One thread block attends R query rows that share one KV head of one
// sequence slot: the G = H / Hkv query heads of a GQA group, times the
// query positions the block owns (1 for decode, a tile of the chunk for
// prefill, the T draft rows for verify).  The block walks the slot's block
// table itself, page by page, over the pages that can hold visible
// positions only, and folds each page into an online softmax (running max
// m, denominator l and fp32 accumulator per row).  On the TPU the page axis
// was a sequential grid dimension carrying m/l/acc in scratch; here it is a
// loop inside the block, and the scratch lives in shared memory.
//
// Visibility of key position `pos` to a row at query position `qpos`:
//   pos <= qpos  and, with a window W > 0,  pos > qpos - W.
// Decode rows sit at qpos = lengths[b] - 1, which is the reference's
// `pos < lengths[b]` (and `pos >= lengths[b] - W`).
//
// Page kinds (template parameter BITS):
//   0  fp32 pages, (P, Hkv, ps, D);
//   8  int8 values (P, Hkv, ps, D) with fp32 scales (P, Hkv, ps, 1): a
//      16-byte load brings 16 values, each dequantized as float(v) * scale;
//   4  int4 values packed two per byte, (P, Hkv, ps, D/2), split halves:
//      byte i of a row holds d = i in its low nibble and d = i + D/2 in its
//      high nibble, both sign-extended, with the int8 scale layout.
// The dequantized values are exact in fp32 (one rounding of one product,
// as in the reference's gather), so on fp32 queries the kernels differ
// from the plain versions only in summation order.
//
// Bound: device-memory bytes.  Each visited page is read once per block as
// contiguous 16-byte vectors, neighbouring threads on neighbouring
// addresses, and kept (or dequantized) as fp32 in shared memory; all query
// heads of a GQA group share that one read.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory carve-up of one block (fp32 unless noted).
struct Smem {
  float* q;      // [R][D]      the rows' queries
  float* acc;    // [R][D]      running weighted sum of V
  float* k;      // [ps][D + 1] current K page (padded: conflict-free rows)
  float* v;      // [ps][D]     current V page
  float* p;      // [R][ps]     scores, then probabilities, of the page
  float* m;      // [R]         running max
  float* l;      // [R]         running denominator
  float* alpha;  // [R]         rescale of this page's update
  int* qpos;     // [R]         each row's query position
};

__host__ __device__ inline size_t smem_bytes(int R, int ps, int D) {
  return sizeof(float) * (size_t(2) * R * D + size_t(ps) * (D + 1) +
                          size_t(ps) * D + size_t(R) * ps + 3 * size_t(R)) +
         sizeof(int) * size_t(R);
}

__device__ inline Smem carve(float* base, int R, int ps, int D) {
  Smem s;
  s.q = base;
  s.acc = s.q + R * D;
  s.k = s.acc + R * D;
  s.v = s.k + ps * (D + 1);
  s.p = s.v + ps * D;
  s.m = s.p + R * ps;
  s.l = s.m + R;
  s.alpha = s.l + R;
  s.qpos = reinterpret_cast<int*>(s.alpha + R);
  return s;
}

// Copy one contiguous (rows, D) slab of an fp32 page into shared memory,
// 16 bytes per load.  Needs D % 4 == 0 and a 16-byte aligned source (the
// wrapper checks both).
__device__ __forceinline__ void load_slab(const float* __restrict__ src, float* dst,
                                          int rows, int D, int dst_stride) {
  const int n_vec = rows * D / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const float4 v = __ldg(src4 + i);
    const int e = i * 4;
    const int r = e / D;
    float* out = dst + r * dst_stride + (e - r * D);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

// The same for an int8 slab: 16 values per load, each times its row's
// scale.  Needs D % 16 == 0.
__device__ __forceinline__ void load_slab_int8(const int8_t* __restrict__ src,
                                               const float* __restrict__ scl,
                                               float* dst, int rows, int D,
                                               int dst_stride) {
  const int n_vec = rows * D / 16;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const uint4 raw = __ldg(src4 + i);
    const int8_t* vals = reinterpret_cast<const int8_t*>(&raw);
    const int e = i * 16;
    const int r = e / D;
    const float sc = __ldg(scl + r);
    float* out = dst + r * dst_stride + (e - r * D);
#pragma unroll
    for (int k = 0; k < 16; ++k) out[k] = float(vals[k]) * sc;
  }
}

// A 4-bit two's-complement nibble (0..15) as its value -8..7.
__device__ __forceinline__ int sign_extend4(int n) { return n - ((n & 8) << 1); }

// The same for a packed int4 slab, rows of D/2 bytes: 16 bytes per load
// give 32 values, byte c of a row feeding d = c (low nibble) and
// d = c + D/2 (high nibble).  Needs D % 32 == 0.
__device__ __forceinline__ void load_slab_int4(const uint8_t* __restrict__ src,
                                               const float* __restrict__ scl,
                                               float* dst, int rows, int D,
                                               int dst_stride) {
  const int half = D / 2;
  const int n_vec = rows * half / 16;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const uint4 raw = __ldg(src4 + i);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    const int e = i * 16;
    const int r = e / half;
    const float sc = __ldg(scl + r);
    float* out = dst + r * dst_stride + (e - r * half);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int b = bytes[k];
      out[k] = float(sign_extend4(b & 0xF)) * sc;
      out[k + half] = float(sign_extend4(b >> 4)) * sc;
    }
  }
}

// Load the (ps, D) slab `slab` = page * Hkv + kv head of a page pool of
// kind BITS into shared memory as fp32 (`scales` unused for float pages).
template <int BITS>
__device__ __forceinline__ void load_page(const void* __restrict__ pages,
                                          const float* __restrict__ scales,
                                          size_t slab, int ps, int D,
                                          float* dst, int dst_stride) {
  if constexpr (BITS == 8) {
    load_slab_int8(static_cast<const int8_t*>(pages) + slab * ps * D,
                   scales + slab * ps, dst, ps, D, dst_stride);
  } else if constexpr (BITS == 4) {
    load_slab_int4(static_cast<const uint8_t*>(pages) + slab * ps * (D / 2),
                   scales + slab * ps, dst, ps, D, dst_stride);
  } else {
    load_slab(static_cast<const float*>(pages) + slab * ps * D, dst, ps, D,
              dst_stride);
  }
}

// Initialise the running statistics of R rows; q, acc and qpos are filled
// by the caller before the __syncthreads that precedes attend_pages.
__device__ inline void init_rows(const Smem& s, int R) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    s.m[r] = -INFINITY;
    s.l[r] = 0.f;
  }
}

// Fold pages [p_first, p_last] of `table` (one slot's block-table row)
// into the rows' online softmax.  Page ids outside [0, num_pages) are
// skipped.  Ends with acc holding the unnormalised sums and l the
// denominators.
template <int BITS>
__device__ void attend_pages(const void* __restrict__ k_pages,
                             const void* __restrict__ v_pages,
                             const float* __restrict__ k_scales,
                             const float* __restrict__ v_scales,
                             const int* __restrict__ table, int num_pages,
                             int kvh, int Hkv, int ps, int D, float scale,
                             int window, int R, int p_first, int p_last,
                             const Smem& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int pg = p_first; pg <= p_last; ++pg) {
    const int page = table[pg];
    if (page < 0 || page >= num_pages) continue;  // uniform over the block
    const size_t slab = size_t(page) * Hkv + kvh;
    load_page<BITS>(k_pages, k_scales, slab, ps, D, s.k, D + 1);
    load_page<BITS>(v_pages, v_scales, slab, ps, D, s.v, D);
    __syncthreads();

    // scores of every (row, key) pair of the page; invisible keys -inf
    const int pos0 = pg * ps;
    for (int i = threadIdx.x; i < R * ps; i += blockDim.x) {
      const int r = i / ps, j = i - r * ps;
      const int pos = pos0 + j, qp = s.qpos[r];
      float sc = -INFINITY;
      if (pos <= qp && (window <= 0 || pos > qp - window)) {
        const float* qr = s.q + r * D;
        const float* kj = s.k + j * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        sc = dot * scale;
      }
      s.p[i] = sc;
    }
    __syncthreads();

    // online-softmax update, one warp per row
    for (int r = warp; r < R; r += n_warps) {
      float* pr = s.p + r * ps;
      float mx = -INFINITY;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = s.m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float e = (m_new == -INFINITY) ? 0.f : expf(pr[j] - m_new);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
        s.alpha[r] = a;
        s.l[r] = s.l[r] * a + sum;
        s.m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V, one (row, d) element per thread step
    for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const float* pr = s.p + r * ps;
      float a = s.acc[i] * s.alpha[r];
      for (int j = 0; j < ps; ++j) a = fmaf(pr[j], s.v[j * D + d], a);
      s.acc[i] = a;
    }
    __syncthreads();
  }
}

// Pages that can hold a key visible to rows with query positions in
// [q_min, q_max]: [first, last], clamped to the block table.
__device__ inline void page_range(int q_min, int q_max, int window, int ps,
                                  int max_pages, int* first, int* last) {
  const int lo = window > 0 ? q_min - window + 1 : 0;
  *first = (lo > 0 ? lo : 0) / ps;
  *last = q_max < 0 ? -1 : min(q_max / ps, max_pages - 1);
}

// Host side: launch `kernel` with `smem` bytes of dynamic shared memory,
// raising the per-kernel limit first when it exceeds the default 48 KB.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem));
  return cudaSuccess;
}

}  // namespace ptt
