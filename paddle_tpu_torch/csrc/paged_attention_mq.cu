// Multi-query (speculative verify) paged attention for Hopper (sm_90a):
// float pages (fp32 or bf16), int8 pages and nibble-packed int4 pages, each
// with fp32 or bf16 queries.
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
// lengths + 1, as the reference does.
//
// Grid: one block per (kv head, slot) with R = G * T rows, row r = (draft
// row r / G, query head kvh * G + r % G), so the G query heads of a group
// and all T rows share every K/V page load.  The block walks the slot's
// pages from the first one the window leaves visible to the first row to
// (lengths[b] + T - 1) / ps; the TPU kernel pads T to 8 sublanes and walks
// all max_pages pages, masking them.
//
// Bound on this card: HBM bytes, as for decode: the block reads the slot's
// (len + T) visible positions of K and V once, for T rows instead of one,
// so verifying T positions costs about one decode step's page bytes.

#include "paged_common.cuh"

namespace ptt {

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
paged_mq_kernel(const T* __restrict__ q, const void* __restrict__ k_pages,
                const void* __restrict__ v_pages,
                const float* __restrict__ k_scales,
                const float* __restrict__ v_scales,
                const int* __restrict__ block_tables,
                const int* __restrict__ lengths, T* __restrict__ out, int n_q,
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
    s.q[e] = to_float(q[((size_t(b) * n_q + t) * H + h) * D + d]);
    s.acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.qpos[r] = len + r / G;
  init_rows(s, R);
  __syncthreads();

  int first, last;
  page_range(len, len + n_q - 1, window, ps, max_pages, &first, &last);
  attend_pages<T, BITS>(k_pages, v_pages, k_scales, v_scales,
                        block_tables + size_t(b) * max_pages, num_pages, kvh,
                        Hkv, ps, D, scale, window, R, first, last, s);

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t = r / G, h = kvh * G + r % G;
    const float l = s.l[r];
    out[((size_t(b) * n_q + t) * H + h) * D + d] =
        from_float<T>(l > 0.f ? s.acc[e] / l : 0.f);
  }
}

template <typename T, int BITS>
cudaError_t launch_mq(const void* q, const void* k, const void* v,
                      const float* ks, const float* vs, const int* bt,
                      const int* lens, void* out, int B, int n_q, int H,
                      int Hkv, int ps, int D, int max_pages, int num_pages,
                      float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv * n_q, ps, D);
  auto kern = paged_mq_kernel<T, BITS>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, ks, vs, bt, lens, static_cast<T*>(out),
      n_q, H, Hkv, ps, D, max_pages, num_pages, scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mq(int kv_bits, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        const int* bt, const int* lens, void* out, int B,
                        int n_q, int H, int Hkv, int ps, int D, int max_pages,
                        int num_pages, float scale, int window,
                        cudaStream_t st) {
  switch (kv_bits) {
    case 0:
      return launch_mq<T, 0>(q, k, v, ks, vs, bt, lens, out, B, n_q, H, Hkv,
                             ps, D, max_pages, num_pages, scale, window, st);
    case 8:
      return launch_mq<T, 8>(q, k, v, ks, vs, bt, lens, out, B, n_q, H, Hkv,
                             ps, D, max_pages, num_pages, scale, window, st);
    case 4:
      return launch_mq<T, 4>(q, k, v, ks, vs, bt, lens, out, B, n_q, H, Hkv,
                             ps, D, max_pages, num_pages, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// q/out (B, T, H, D); dtype (of q and out): 0 = fp32, 1 = bf16.  kv_bits:
// 0 = float pages of q's dtype (scales unused, may be null), 8 = int8,
// 4 = packed int4 pages with fp32 scales (P, Hkv, ps, 1).  window <= 0
// means no window.  Returns the CUDA error code of the launch.
extern "C" int paged_attention_mq_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* lengths, void* out, int B, int n_q, int H, int Hkv, int ps,
    int D, int max_pages, int num_pages, float scale, int window, int dtype,
    int kv_bits, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(ptt::dispatch_mq<__nv_bfloat16>(
        kv_bits, q, k_pages, v_pages, ks, vs, bt, lens, out, B, n_q, H, Hkv,
        ps, D, max_pages, num_pages, scale, window, st));
  if (dtype == 0)
    return int(ptt::dispatch_mq<float>(
        kv_bits, q, k_pages, v_pages, ks, vs, bt, lens, out, B, n_q, H, Hkv,
        ps, D, max_pages, num_pages, scale, window, st));
  return int(cudaErrorInvalidValue);
}
