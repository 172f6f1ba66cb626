// Multi-query (speculative verify) paged attention for Hopper (sm_90a):
// bf16, fp16 or fp32 queries over float pages of their type, int8 pages
// and nibble-packed int4 pages.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py:
// paged_attention_mq (bodies _mq_kernel, _mq_kernel_int8, _mq_kernel_int4;
// recurrence _mq_recurrence).
//
// Each slot b scores a block of T query rows, row t at position
// lengths[b] + t, where lengths[b] counts the positions valid BEFORE the
// block and the block's own K/V are already in the pages.  Row t sees page
// position j iff j <= lengths[b] + t (and j > lengths[b] + t - W under a
// window W): the history and, causally, the block's earlier rows.  T == 1
// never reaches this kernel: the wrapper sends it to the decode kernel with
// lengths + 1, as the reference does.  The TPU kernel pads T to 8 sublanes
// and walks all max_pages pages, masking them; here only the pages that
// hold visible positions are read, once for all T rows and G query heads.
//
// Bound on this card: HBM bytes, as for decode: the slot's (len + T)
// visible positions of K and V are read once for T rows instead of one,
// so verifying T positions costs about one decode step's page bytes.  The
// first design ran one block per (KV head, slot) over the slot's pages one
// at a time, with R = G * T rows of scalar fp32 dot products per page.
//
// Two bodies, chosen by the query dtype (not a fallback: a failed launch
// raises in the wrapper):
// - bf16 and fp16 queries: the split-KV body of paged_split.cuh with T
//   rows per slot (row r = draft row r / G of query head kvh * G + r % G),
//   up to 16 rows per block on the tensor cores, splits merged by their
//   lse;
// - fp32 queries: one block per (KV head, slot) with exact fp32 FMA
//   products over the visible pages (attend_pages, paged_common.cuh).

#include "paged_split.cuh"

namespace ptt {

template <int BITS>
__global__ void __launch_bounds__(kThreads)
paged_mq_kernel(const float* __restrict__ q, const void* __restrict__ k_pages,
                const void* __restrict__ v_pages,
                const float* __restrict__ k_scales,
                const float* __restrict__ v_scales,
                const int* __restrict__ block_tables,
                const int* __restrict__ lengths, float* __restrict__ out, int n_q,
                int H, int Hkv, int ps, int D, int max_pages, int num_pages,
                float scale, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv, R = G * n_q;
  const Smem s = carve(smem, R, ps, D);
  const int len = lengths[b];

  // q and out are (B, T, H, D): row r = (t = r / G, head kvh * G + r % G)
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t = r / G, h = kvh * G + r % G;
    s.q[e] = q[((size_t(b) * n_q + t) * H + h) * D + d];
    s.acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.qpos[r] = len + r / G;
  init_rows(s, R);
  __syncthreads();

  int first, last;
  page_range(len, len + n_q - 1, window, ps, max_pages, &first, &last);
  attend_pages<BITS>(k_pages, v_pages, k_scales, v_scales,
                     block_tables + size_t(b) * max_pages, num_pages, kvh,
                     Hkv, ps, D, scale, window, R, first, last, s);

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t = r / G, h = kvh * G + r % G;
    const float l = s.l[r];
    out[((size_t(b) * n_q + t) * H + h) * D + d] =
        l > 0.f ? s.acc[e] / l : 0.f;
  }
}

template <int BITS>
cudaError_t launch_mq(const void* q, const void* k, const void* v,
                      const float* ks, const float* vs, const int* bt,
                      const int* lens, void* out, int B, int n_q, int H,
                      int Hkv, int ps, int D, int max_pages, int num_pages,
                      float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv * n_q, ps, D);
  auto kern = paged_mq_kernel<BITS>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, ks, vs, bt, lens,
      static_cast<float*>(out), n_q, H, Hkv, ps, D, max_pages, num_pages, scale, window);
  return cudaGetLastError();
}

cudaError_t dispatch_mq_fp32(int kv_bits, const void* q, const void* k,
                             const void* v, const float* ks, const float* vs,
                             const int* bt, const int* lens, void* out, int B,
                             int n_q, int H, int Hkv, int ps, int D,
                             int max_pages, int num_pages, float scale,
                             int window, cudaStream_t st) {
  switch (kv_bits) {
    case 0:
      return launch_mq<0>(q, k, v, ks, vs, bt, lens, out, B, n_q, H,
                                 Hkv, ps, D, max_pages, num_pages, scale,
                                 window, st);
    case 8:
      return launch_mq<8>(q, k, v, ks, vs, bt, lens, out, B, n_q, H,
                                 Hkv, ps, D, max_pages, num_pages, scale,
                                 window, st);
    case 4:
      return launch_mq<4>(q, k, v, ks, vs, bt, lens, out, B, n_q, H,
                                 Hkv, ps, D, max_pages, num_pages, scale,
                                 window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q/out (B, T, H, D); dtype (of q and out): 0 = fp32, 1 = bf16, 2 = fp16.
// kv_bits: 0 = float pages of q's dtype (scales unused, may be null), 8 =
// int8, 4 = packed int4 pages with fp32 scales (P, Hkv, ps, 1).  window
// <= 0 means no window.  bf16, fp16: `pages_per_split` block-table entries
// per split, and `ws` holds B * Hkv * n_split * T * H / Hkv * (D + 2) floats,
// n_split = ceil(max_pages / pages_per_split), when n_split > 1 (fp32
// uses neither).  Returns the CUDA error code of the launches.
extern "C" int paged_attention_mq_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* lengths, void* out, void* ws, int B, int n_q, int H, int Hkv,
    int ps, int D, int max_pages, int num_pages, int pages_per_split,
    float scale, int window, int dtype, int kv_bits, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0)
    return int(ptt::split::launch<false>(
        q, k_pages, v_pages, ks, vs, bt, lens, out, static_cast<float*>(ws), B,
        n_q, 0, H, Hkv, ps, D, max_pages, num_pages, pages_per_split, scale,
        window, kv_bits, dtype, st));
  return int(ptt::dispatch_mq_fp32(
      kv_bits, q, k_pages, v_pages, ks, vs, bt, lens, out, B, n_q, H, Hkv,
      ps, D, max_pages, num_pages, scale, window, st));
}
