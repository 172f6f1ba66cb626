// Paged chunk-prefill attention for Hopper (sm_90a): bf16 or fp16 queries
// over pages of their type, int8 and nibble-packed int4 pages, and fp32
// queries over fp32, int8 and int4 pages.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_prefill.py:
// paged_prefill (bodies _prefill_kernel, _prefill_kernel_int8,
// _prefill_kernel_int4; recurrence _chunk_recurrence).
//
// One chunk of C prompt tokens of one slot, row i at position start + i,
// attends through the slot's block-table row to every key position j with
// j <= start + i (and j > start + i - W under a window W).  The chunk's own
// K/V are already scattered into the pages, so attention within the chunk
// arrives through the same page walk as the history.  That is the
// multi-query verify function of one slot with T = C rows at base
// position `start`.
//
// Two bodies, chosen by the query dtype (a choice of body by type, not a
// fallback: a failed launch raises in the wrapper):
// - bf16 and fp16 queries: the split-KV body of paged_split.cuh in its
//   row split:
//   blocks of 64 rows (four warps of m16 tiles: the chunk's rows times the
//   G query heads of a GQA group, which share every page read) over one
//   K/V tile ring, `pages_per_split` block-table entries per block from
//   the prefill plan (kernels/paged_prefill.py, host shapes only, the same
//   grid for every start of a bucket), splits merged by their lse (the
//   row split, the plan and the merge measured against their alternatives
//   on an H100: PERF.md).
// - fp32 queries: blocks over (query tile of the chunk, KV head) walk the
//   slot's pages up to the last one the tile can see, with exact fp32 FMA
//   products (attend_pages, paged_common.cuh), so that the kernel differs
//   from the plain version only in summation order.  A tile holds QT =
//   16 / G chunk rows (at least 1) times the G query heads of one KV head.

#include "paged_split.cuh"

namespace ptt {


__host__ __device__ inline int tile_rows(int G) { return G >= 16 ? 1 : 16 / G; }

template <int BITS>
__global__ void __launch_bounds__(kThreads)
paged_prefill_fp32_kernel(const float* __restrict__ q, const void* __restrict__ k_pages,
                          const void* __restrict__ v_pages,
                          const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ block_table, float* __restrict__ out,
                          int start, int C, int H, int Hkv, int ps, int D,
                          int max_pages, int num_pages, float scale, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.y;
  const int G = H / Hkv, QT = tile_rows(G);
  const int i0 = blockIdx.x * QT;
  const int n_rows = min(QT, C - i0);  // ragged last tile
  const int R = n_rows * G;
  const Smem s = carve(smem, QT * G, ps, D);

  // row r = (chunk row i0 + r / G, query head kvh * G + r % G)
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int i = i0 + r / G, h = kvh * G + r % G;
    s.q[e] = q[(size_t(i) * H + h) * D + d];
    s.acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.qpos[r] = start + i0 + r / G;
  init_rows(s, R);
  __syncthreads();

  int first, last;
  page_range(start + i0, start + i0 + n_rows - 1, window, ps, max_pages,
             &first, &last);
  attend_pages<BITS>(k_pages, v_pages, k_scales, v_scales, block_table,
                     num_pages, kvh, Hkv, ps, D, scale, window, R, first,
                     last, s);

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int i = i0 + r / G, h = kvh * G + r % G;
    const float l = s.l[r];
    out[(size_t(i) * H + h) * D + d] = l > 0.f ? s.acc[e] / l : 0.f;
  }
}

template <int BITS>
cudaError_t launch_prefill_fp32(const void* q, const void* k, const void* v,
                                const float* ks, const float* vs, const int* bt,
                                void* out, int start, int C, int H, int Hkv, int ps,
                                int D, int max_pages, int num_pages, float scale,
                                int window, cudaStream_t stream) {
  const int G = H / Hkv, QT = tile_rows(G);
  const size_t smem = smem_bytes(QT * G, ps, D);
  auto kern = paged_prefill_fp32_kernel<BITS>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + QT - 1) / QT, Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, ks, vs, bt, static_cast<float*>(out), start,
      C, H, Hkv, ps, D, max_pages, num_pages, scale, window);
  return cudaGetLastError();
}

cudaError_t dispatch_prefill_fp32(int kv_bits, const void* q, const void* k,
                                  const void* v, const float* ks, const float* vs,
                                  const int* bt, void* out, int start, int C, int H,
                                  int Hkv, int ps, int D, int max_pages,
                                  int num_pages, float scale, int window,
                                  cudaStream_t st) {
  switch (kv_bits) {
    case 0:
      return launch_prefill_fp32<0>(q, k, v, ks, vs, bt, out, start, C, H, Hkv, ps, D,
                                    max_pages, num_pages, scale, window, st);
    case 8:
      return launch_prefill_fp32<8>(q, k, v, ks, vs, bt, out, start, C, H, Hkv, ps, D,
                                    max_pages, num_pages, scale, window, st);
    case 4:
      return launch_prefill_fp32<4>(q, k, v, ks, vs, bt, out, start, C, H, Hkv, ps, D,
                                    max_pages, num_pages, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q/out (C, H, D); dtype (of q and out): 0 = fp32, 1 = bf16, 2 = fp16.
// kv_bits: 0 = float pages of q's dtype (scales unused, may be null), 8 =
// int8, 4 = packed int4 pages with fp32 scales (P, Hkv, ps, 1).  window <=
// 0 means no window.  bf16, fp16: `pages_per_split` block-table entries
// per split, and `ws` holds Hkv * n_split * C * H / Hkv * (D + 2) floats,
// n_split = ceil(max_pages / pages_per_split), when n_split > 1 (fp32
// uses neither).
// Returns the CUDA error code of the launches.
extern "C" int paged_prefill_fwd(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* block_table,
                                 void* out, void* ws, int start, int C, int H,
                                 int Hkv, int ps, int D, int max_pages,
                                 int num_pages, int pages_per_split, float scale,
                                 int window, int dtype, int kv_bits, void* stream) {
  const int* bt = static_cast<const int*>(block_table);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0)
    return int(ptt::split::launch<true>(  // the row split
        q, k_pages, v_pages, ks, vs, bt, nullptr, out, static_cast<float*>(ws), 1, C,
        start, H, Hkv, ps, D, max_pages, num_pages, pages_per_split, scale, window,
        kv_bits, dtype, st));
  return int(ptt::dispatch_prefill_fp32(kv_bits, q, k_pages, v_pages, ks, vs, bt,
                                        out, start, C, H, Hkv, ps, D, max_pages,
                                        num_pages, scale, window, st));
}
