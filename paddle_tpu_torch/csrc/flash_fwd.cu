// Flash-attention forward for Hopper (sm_90a): out and the row logsumexp,
// fp32 or bf16 q/k/v, causal or not, sliding window, GQA, any layout
// given by strides (see flash_common.cuh).
//
// Replaces the TPU kernel paddle_tpu/kernels/flash.py: _fwd_kernel, as
// launched by _fwd_call (bnsd) and _fwd_call_smajor (bsnd / sbnd, GQA).
//
// Grid: (query tiles, query heads, batch); the heaviest causal tiles
// (largest row index) are issued first.  One block of BQ query rows keeps
// its Q tile in shared memory and walks the k-tiles [lo, hi) that hold a
// visible position: per tile S = Q.K^T (fp32), the online softmax of the
// reference's recurrence (m_new = max(m, rowmax(s)), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l * alpha + rowsum(p), O = O * alpha +
// P.V with P cast to V's dtype first), then out = O / max(l, 1e-30) in q's
// dtype and lse = m + log(max(l, 1e-30)) in fp32, one row per (b * H + h).

#include "flash_common.cuh"

namespace fa {

struct FwdSmem {
  size_t q, k, v, s, p, o, m, l, alpha, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int BQ, int BK, int DP, int elt) {
  Carve c;
  FwdSmem t;
  const int ldt = tile_ld(DP, elt);
  t.q = c.take(size_t(BQ) * ldt * elt);
  t.k = c.take(size_t(BK) * ldt * elt);
  t.v = c.take(size_t(BK) * ldt * elt);
  t.s = c.take(size_t(BQ) * tile_ld(BK, 4) * 4);
  t.p = c.take(size_t(BQ) * tile_ld(BK, elt) * elt);
  t.o = c.take(size_t(BQ) * tile_ld(DP, 4) * 4);
  t.m = c.take(size_t(BQ) * 4);
  t.l = c.take(size_t(BQ) * 4);
  t.alpha = c.take(size_t(BQ) * 4);
  t.total = c.off;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP, elt = sizeof(T);
  const int ldt = tile_ld(DP, elt), lds = tile_ld(BK, 4);
  const int ldp = tile_ld(BK, elt), ldo = tile_ld(DP, 4);
  const FwdSmem L = fwd_smem(BQ, BK, DP, elt);
  T* sq = reinterpret_cast<T*>(smem + L.q);
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* sp = reinterpret_cast<T*>(smem + L.p);
  float* so = reinterpret_cast<float*>(smem + L.o);
  float* sm = reinterpret_cast<float*>(smem + L.m);
  float* sl = reinterpret_cast<float*>(smem + L.l);
  float* salpha = reinterpret_cast<float*>(smem + L.alpha);

  const int q0 = qt * BQ;
  load_rows(sq, ldt, slice<const T>(a.q, b, h), a.q.s, q0, BQ, a.S, a.D, DP);
  zero(so, BQ, DP, ldo);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  const T* kb = slice<const T>(a.k, b, kvh);
  const T* vb = slice<const T>(a.v, b, kvh);
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows(sk, ldt, kb, a.k.s, j * BK, BK, a.S, a.D, DP);
    load_rows(sv, ldt, vb, a.v.s, j * BK, BK, a.S, a.D, DP);
    __syncthreads();
    tile_mm<false, true>(ss, lds, sq, ldt, sk, ldt, BQ, BK, DP, false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qi = q0 + r;
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) {
        float s = ss[r * lds + c] * a.scale;
        if (!visible(a, qi, j * BK + c)) s = kNegInf;
        ss[r * lds + c] = s;
        mx = fmaxf(mx, s);
      }
      const float m_old = sm[r], m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(ss[r * lds + c] - m_new);
        sum += p;
        sp[r * ldp + c] = from_float<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * DP; e += blockDim.x) {
      const int r = e / DP;
      so[r * ldo + (e - r * DP)] *= salpha[r];
    }
    __syncthreads();
    tile_mm<false, false>(so, ldo, sp, ldp, sv, ldt, BQ, DP, BK, true);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) sl[r] = fmaxf(sl[r], 1e-30f);
  __syncthreads();
  store_rows(slice<T>(a.o, b, h), a.o.s, so, ldo, sl, q0, BQ, a.S, a.D);
  float* lse = a.lse + (size_t(b) * a.H + h) * a.S;
  for (int r = threadIdx.x; r < BQ; r += blockDim.x)
    if (q0 + r < a.S) lse[q0 + r] = sm[r] + logf(sl[r]);
}

template <typename T>
cudaError_t fwd(Args a, cudaStream_t st) {
  size_t smem = 0;
  const int elt = sizeof(T), DP = a.DP;
  const int t = pick_tile([&](int n) { return fwd_smem(n, n, DP, elt).total; },
                          64, &smem);
  if (t == 0) return cudaErrorInvalidValue;
  a.BQ = a.BK = t;
  const dim3 grid((a.S + t - 1) / t, a.H, a.B);
  return launch(flash_fwd_kernel<T>, grid, smem, st, a);
}

}  // namespace fa

// q, k, v: [B, S, H(kv), D] views given by `strides` (b, s, h of q, k, v,
// out in that order; d contiguous; every stride and D a multiple of one
// 16-byte vector).  out: q's view; lse: (B * H, S) fp32.  window <= 0:
// none.  dtype: 0 fp32, 1 bf16.  Returns the CUDA error code of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, const long long* strides,
                         int B, int H, int Hkv, int S, int D, float scale,
                         int causal, int window, int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), out, nullptr, nullptr, nullptr,
                   nullptr};
  fa::Args a{};
  const int elt = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) ||
      !fa::make_args(&a, ptrs, strides, B, H, Hkv, S, D, scale, causal,
                     window, elt))
    return int(cudaErrorInvalidValue);
  a.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 1 ? fa::fwd<fa::bf16>(a, st) : fa::fwd<float>(a, st));
}
