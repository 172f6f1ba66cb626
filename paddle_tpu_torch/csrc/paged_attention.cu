// Paged decode attention for Hopper (sm_90a): bf16, fp16 or fp32 queries
// over float pages of their type, int8 pages and nibble-packed int4 pages.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py:
// paged_attention (bodies _paged_kernel, _paged_kernel_int8,
// _paged_kernel_int4; recurrence _page_recurrence).
//
// out[b, h] = softmax_j(q[b, h] . K[j] * scale) @ V over the positions j of
// slot b that its block-table row names, masked to j < lengths[b] and, with
// a window W, j >= lengths[b] - W; query heads are grouped G = H / Hkv over
// their shared KV head, so a group shares every page read.  The TPU kernel
// walks all max_pages pages of a slot as a sequential grid axis and masks
// them; here only the pages that hold visible positions are read.
//
// Bound on this card: HBM bytes.  A decode step reads B * len * 2 * Hkv *
// (D * value bytes + scale bytes) per layer and does ~4 flops per value
// read, far below the ~295 flops/byte at which the tensor cores would bind.
// What held the first design back was not the bytes but too little in
// flight: one block per (KV head, slot), 128 blocks for 132 SMs, each
// walking its slot's pages one at a time (load, barrier, compute), so the
// kernel took as long as the longest slot's serial walk.
//
// Two bodies, chosen by the query dtype (a choice of body by type, not a
// fallback: a failed launch raises in the wrapper):
// - bf16 and fp16 queries: the split-KV body of paged_split.cuh (one
//   template over the element type).  The slot's pages are cut into
//   splits of `pages_per_split` block-table entries, one block per (KV
//   head, slot, split); each warp streams its pages through
//   its own cp.async ring and multiplies on the tensor cores (mma.sync),
//   and a second kernel merges the splits by their lse.  Decode is its
//   T = 1 case, the row at position lengths[b] - 1.
// - fp32 queries: one block per (KV head, slot) walks the visible pages
//   with exact fp32 FMA products (attend_pages, paged_common.cuh), so that
//   the kernel differs from the plain version only in summation order.

#include "paged_split.cuh"

namespace ptt {

template <int BITS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int H, int Hkv, int ps, int D, int max_pages,
                    int num_pages, float scale, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv, R = G;
  const Smem s = carve(smem, R, ps, D);
  const int len = lengths[b];
  const size_t row0 = (size_t(b) * H + size_t(kvh) * G) * D;  // q/out offset

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    s.q[i] = q[row0 + i];
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.qpos[r] = len - 1;
  init_rows(s, R);
  __syncthreads();

  int first, last;
  page_range(len - 1, len - 1, window, ps, max_pages, &first, &last);
  attend_pages<BITS>(k_pages, v_pages, k_scales, v_scales,
                     block_tables + size_t(b) * max_pages, num_pages, kvh,
                     Hkv, ps, D, scale, window, R, first, last, s);

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const float l = s.l[i / D];
    out[row0 + i] = l > 0.f ? s.acc[i] / l : 0.f;
  }
}

template <int BITS>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const float* ks, const float* vs, const int* bt,
                          const int* lens, void* out, int B, int H, int Hkv,
                          int ps, int D, int max_pages, int num_pages,
                          float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, ps, D);
  auto kern = paged_decode_kernel<BITS>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, ks, vs, bt, lens,
      static_cast<float*>(out), H, Hkv, ps, D, max_pages, num_pages, scale, window);
  return cudaGetLastError();
}

cudaError_t dispatch_decode_fp32(int kv_bits, const void* q, const void* k,
                                 const void* v, const float* ks, const float* vs,
                                 const int* bt, const int* lens, void* out, int B,
                                 int H, int Hkv, int ps, int D, int max_pages,
                                 int num_pages, float scale, int window,
                                 cudaStream_t st) {
  switch (kv_bits) {
    case 0:
      return launch_decode<0>(q, k, v, ks, vs, bt, lens, out, B, H,
                                     Hkv, ps, D, max_pages, num_pages, scale,
                                     window, st);
    case 8:
      return launch_decode<8>(q, k, v, ks, vs, bt, lens, out, B, H,
                                     Hkv, ps, D, max_pages, num_pages, scale,
                                     window, st);
    case 4:
      return launch_decode<4>(q, k, v, ks, vs, bt, lens, out, B, H,
                                     Hkv, ps, D, max_pages, num_pages, scale,
                                     window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// dtype (of q and out): 0 = fp32, 1 = bf16, 2 = fp16.  kv_bits: 0 = float
// pages of q's dtype (scales unused, may be null), 8 = int8 pages, 4 =
// packed int4 pages, both with fp32 scales (P, Hkv, ps, 1).  window <= 0
// means no window.  bf16, fp16: `pages_per_split` block-table entries per
// split, and `ws` holds B * Hkv * n_split * H / Hkv * (D + 2) floats,
// n_split = ceil(max_pages / pages_per_split), when n_split > 1 (fp32
// uses neither).  Returns the CUDA error code of the launches.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales,
                                   const void* block_tables,
                                   const void* lengths, void* out, void* ws,
                                   int B, int H, int Hkv, int ps, int D,
                                   int max_pages, int num_pages,
                                   int pages_per_split, float scale,
                                   int window, int dtype, int kv_bits,
                                   void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0)
    return int(ptt::split::launch<false>(
        q, k_pages, v_pages, ks, vs, bt, lens, out, static_cast<float*>(ws), B,
        1, -1, H, Hkv, ps, D, max_pages, num_pages, pages_per_split, scale,
        window, kv_bits, dtype, st));
  return int(ptt::dispatch_decode_fp32(
      kv_bits, q, k_pages, v_pages, ks, vs, bt, lens, out, B, H, Hkv, ps,
      D, max_pages, num_pages, scale, window, st));
}
