// Paged chunk-prefill attention for Hopper (sm_90a): float pages (fp32 or
// bf16), int8 pages and nibble-packed int4 pages, each with fp32 or bf16
// queries.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_prefill.py:
// paged_prefill (bodies _prefill_kernel, _prefill_kernel_int8,
// _prefill_kernel_int4; recurrence _chunk_recurrence).
//
// One chunk of C prompt tokens of one slot, row i at position start + i,
// attends through the slot's block-table row to every key position j with
// j <= start + i (and j > start + i - W under a window W).  The chunk's own
// K/V are already scattered into the pages, so attention within the chunk
// arrives through the same page walk as the history.  Quantized pages
// dequantize right after the load (paged_common.cuh).
//
// Grid: (query tiles of the chunk, kv heads).  A tile holds QT = 16 / G
// chunk rows (at least 1) times the G query heads of one KV head, so the
// heads of a GQA group share each page read.  Each block loops over the
// slot's pages up to the last one its rows can see, (start + row_end - 1)
// / ps, from the first one the window leaves visible.  C is any width up to
// the engine's chunk: the ragged last tile just has fewer rows.
//
// Bound on this card: HBM bytes at the engine's shapes.  A chunk reads the
// (start + C) positions of K and V it can see, 2 * (start + C) * Hkv * (D *
// sizeof(page value) + scale bytes) per layer, against ~4 * C * H * (start
// + C) / 2 flops; the design reads every visible page once per tile, in
// 16-byte vectors, and skips the pages beyond the chunk's last row that the
// TPU kernel walked and masked.  (The tiles of one chunk re-read the same
// pages, which the 50 MB L2 absorbs; tensor-core tiles are later work.)

#include "paged_common.cuh"

namespace ptt {

__host__ __device__ inline int tile_rows(int G) { return G >= 16 ? 1 : 16 / G; }

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const void* __restrict__ k_pages,
                     const void* __restrict__ v_pages,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ block_table, T* __restrict__ out,
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
    s.q[e] = to_float(q[(size_t(i) * H + h) * D + d]);
    s.acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.qpos[r] = start + i0 + r / G;
  init_rows(s, R);
  __syncthreads();

  int first, last;
  page_range(start + i0, start + i0 + n_rows - 1, window, ps, max_pages,
             &first, &last);
  attend_pages<T, BITS>(k_pages, v_pages, k_scales, v_scales, block_table,
                        num_pages, kvh, Hkv, ps, D, scale, window, R, first,
                        last, s);

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int i = i0 + r / G, h = kvh * G + r % G;
    const float l = s.l[r];
    out[(size_t(i) * H + h) * D + d] = from_float<T>(l > 0.f ? s.acc[e] / l : 0.f);
  }
}

template <typename T, int BITS>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int* bt,
                           void* out, int start, int C, int H, int Hkv, int ps,
                           int D, int max_pages, int num_pages, float scale,
                           int window, cudaStream_t stream) {
  const int G = H / Hkv, QT = tile_rows(G);
  const size_t smem = smem_bytes(QT * G, ps, D);
  auto kern = paged_prefill_kernel<T, BITS>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + QT - 1) / QT, Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, ks, vs, bt, static_cast<T*>(out), start,
      C, H, Hkv, ps, D, max_pages, num_pages, scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_prefill(int kv_bits, const void* q, const void* k,
                             const void* v, const float* ks, const float* vs,
                             const int* bt, void* out, int start, int C, int H,
                             int Hkv, int ps, int D, int max_pages,
                             int num_pages, float scale, int window,
                             cudaStream_t st) {
  switch (kv_bits) {
    case 0:
      return launch_prefill<T, 0>(q, k, v, ks, vs, bt, out, start, C, H, Hkv,
                                  ps, D, max_pages, num_pages, scale, window,
                                  st);
    case 8:
      return launch_prefill<T, 8>(q, k, v, ks, vs, bt, out, start, C, H, Hkv,
                                  ps, D, max_pages, num_pages, scale, window,
                                  st);
    case 4:
      return launch_prefill<T, 4>(q, k, v, ks, vs, bt, out, start, C, H, Hkv,
                                  ps, D, max_pages, num_pages, scale, window,
                                  st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// dtype (of q and out): 0 = fp32, 1 = bf16.  kv_bits: 0 = float pages of
// q's dtype (scales unused, may be null), 8 = int8, 4 = packed int4 pages
// with fp32 scales (P, Hkv, ps, 1).  window <= 0 means no window.  Returns
// the CUDA error code of the launch.
extern "C" int paged_prefill_fwd(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* block_table,
                                 void* out, int start, int C, int H, int Hkv,
                                 int ps, int D, int max_pages, int num_pages,
                                 float scale, int window, int dtype,
                                 int kv_bits, void* stream) {
  const int* bt = static_cast<const int*>(block_table);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(ptt::dispatch_prefill<__nv_bfloat16>(
        kv_bits, q, k_pages, v_pages, ks, vs, bt, out, start, C, H, Hkv, ps,
        D, max_pages, num_pages, scale, window, st));
  if (dtype == 0)
    return int(ptt::dispatch_prefill<float>(
        kv_bits, q, k_pages, v_pages, ks, vs, bt, out, start, C, H, Hkv, ps,
        D, max_pages, num_pages, scale, window, st));
  return int(cudaErrorInvalidValue);
}
