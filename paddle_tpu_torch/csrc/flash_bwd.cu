// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, from
// the forward's row logsumexp, fp32 or bf16, causal or not, sliding
// window, GQA, any layout given by strides (see flash_common.cuh).
//
// Replaces the TPU kernels paddle_tpu/kernels/flash.py: _bwd_dq_kernel and
// _bwd_dkv_kernel, as launched by _bwd_call (bnsd) and _bwd_call_smajor
// (bsnd / sbnd, GQA).  delta = rowsum(dO * O) in fp32 is an input, as in
// the reference, which computes it outside Pallas (the wrapper does here).
//
// dQ: grid (query tiles, query heads, batch), heaviest tiles first.  A
// block keeps its Q and dO tiles and walks the k-tiles [lo, hi): s = Q.K^T
// * scale, p = exp(s - lse) (0 where masked), dp = dO.V^T in fp32, ds = p *
// (dp - delta) * scale, dQ += ds.K with ds cast to K's dtype first.
//
// dK/dV: grid (key tiles, KV heads, batch).  A block keeps its K and V
// tiles and, for each of the G query heads of its KV head, walks the
// q-tiles [lo, hi) that see them, accumulating dV += P^T.dO and dK +=
// dS^T.Q in fp32 (ds cast to Q's dtype first).  GQA: where the reference
// writes per-query-head partials in K's dtype and sums each group in fp32
// afterwards (flash.py _bwd_call_smajor), this block loops over the group
// itself and accumulates all of it in fp32: no partial buffers.  The
// reference keeps P in fp32 for P^T.dO; with bf16 operands this kernel
// feeds P to the tensor cores in bf16 (as the forward does for P.V), a
// rounding the bf16 tolerance of the comparison covers.  fp32 operands
// keep P in fp32.

#include "flash_common.cuh"

namespace fa {

struct BwdSmem {
  size_t q, dout, k, v, s, dp, p, ds, acc1, acc2, lse, delta, total;
};

// dkv: the accumulators are dK and dV over key rows (BK); otherwise dQ
// over query rows (BQ) and no P tile.
__host__ __device__ inline BwdSmem bwd_smem(int BQ, int BK, int DP, int elt,
                                            bool dkv) {
  Carve c;
  BwdSmem t;
  const int ldt = tile_ld(DP, elt);
  const size_t sf = size_t(BQ) * tile_ld(BK, 4) * 4;
  const size_t st = size_t(BQ) * tile_ld(BK, elt) * elt;
  const size_t acc = size_t(dkv ? BK : BQ) * tile_ld(DP, 4) * 4;
  t.q = c.take(size_t(BQ) * ldt * elt);
  t.dout = c.take(size_t(BQ) * ldt * elt);
  t.k = c.take(size_t(BK) * ldt * elt);
  t.v = c.take(size_t(BK) * ldt * elt);
  t.s = c.take(sf);
  t.dp = c.take(sf);
  t.p = dkv ? c.take(st) : 0;
  t.ds = c.take(st);
  t.acc1 = c.take(acc);
  t.acc2 = dkv ? c.take(acc) : 0;
  t.lse = c.take(size_t(BQ) * 4);
  t.delta = c.take(size_t(BQ) * 4);
  t.total = c.off;
  return t;
}

// Q and dO rows [q0, q0 + BQ) of head h, with their lse and delta (0 on
// the ragged edge, whose rows every product masks out).
template <typename T>
__device__ void load_q_side(const Args& a, int b, int h, int q0, T* sq,
                            T* sdo, int ldt, float* slse, float* sdelta) {
  load_rows(sq, ldt, slice<const T>(a.q, b, h), a.q.s, q0, a.BQ, a.S, a.D, a.DP);
  load_rows(sdo, ldt, slice<const T>(a.dout, b, h), a.dout.s, q0, a.BQ, a.S,
            a.D, a.DP);
  const size_t row = (size_t(b) * a.H + h) * a.S;
  for (int r = threadIdx.x; r < a.BQ; r += blockDim.x) {
    const bool in = q0 + r < a.S;
    slse[r] = in ? a.lse[row + q0 + r] : 0.f;
    sdelta[r] = in ? a.delta[row + q0 + r] : 0.f;
  }
}

// p and ds of one (q-tile, k-tile) pair from S = Q.K^T and dP = dO.V^T;
// p is written only when sp is given (the dK/dV kernel).
template <typename T>
__device__ void probs_and_ds(const Args& a, int q0, int k0, const float* ss,
                             const float* sdp, int lds, const float* slse,
                             const float* sdelta, T* sp, T* sds, int ldp) {
  for (int e = threadIdx.x; e < a.BQ * a.BK; e += blockDim.x) {
    const int r = e / a.BK, c = e - r * a.BK;
    const float p = visible(a, q0 + r, k0 + c)
                        ? expf(ss[r * lds + c] * a.scale - slse[r])
                        : 0.f;
    if (sp) sp[r * ldp + c] = from_float<T>(p);
    sds[r * ldp + c] = from_float<T>(p * (sdp[r * lds + c] - sdelta[r]) * a.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP, elt = sizeof(T);
  const int ldt = tile_ld(DP, elt), lds = tile_ld(BK, 4);
  const int ldp = tile_ld(BK, elt), ldo = tile_ld(DP, 4);
  const BwdSmem L = bwd_smem(BQ, BK, DP, elt, false);
  T* sq = reinterpret_cast<T*>(smem + L.q);
  T* sdo = reinterpret_cast<T*>(smem + L.dout);
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* sdp = reinterpret_cast<float*>(smem + L.dp);
  T* sds = reinterpret_cast<T*>(smem + L.ds);
  float* sdq = reinterpret_cast<float*>(smem + L.acc1);
  float* slse = reinterpret_cast<float*>(smem + L.lse);
  float* sdelta = reinterpret_cast<float*>(smem + L.delta);

  const int q0 = qt * BQ;
  load_q_side(a, b, h, q0, sq, sdo, ldt, slse, sdelta);
  zero(sdq, BQ, DP, ldo);
  const T* kb = slice<const T>(a.k, b, kvh);
  const T* vb = slice<const T>(a.v, b, kvh);
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous tile's K and dS are consumed
    load_rows(sk, ldt, kb, a.k.s, j * BK, BK, a.S, a.D, DP);
    load_rows(sv, ldt, vb, a.v.s, j * BK, BK, a.S, a.D, DP);
    __syncthreads();
    tile_mm<false, true>(ss, lds, sq, ldt, sk, ldt, BQ, BK, DP, false);
    tile_mm<false, true>(sdp, lds, sdo, ldt, sv, ldt, BQ, BK, DP, false);
    __syncthreads();
    probs_and_ds<T>(a, q0, j * BK, ss, sdp, lds, slse, sdelta, nullptr, sds, ldp);
    __syncthreads();
    tile_mm<false, false>(sdq, ldo, sds, ldp, sk, ldt, BQ, DP, BK, true);
  }
  __syncthreads();
  store_rows(slice<T>(a.dq, b, h), a.dq.s, sdq, ldo, nullptr, q0, BQ, a.S, a.D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP, elt = sizeof(T);
  const int ldt = tile_ld(DP, elt), lds = tile_ld(BK, 4);
  const int ldp = tile_ld(BK, elt), ldo = tile_ld(DP, 4);
  const BwdSmem L = bwd_smem(BQ, BK, DP, elt, true);
  T* sq = reinterpret_cast<T*>(smem + L.q);
  T* sdo = reinterpret_cast<T*>(smem + L.dout);
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* sdp = reinterpret_cast<float*>(smem + L.dp);
  T* sp = reinterpret_cast<T*>(smem + L.p);
  T* sds = reinterpret_cast<T*>(smem + L.ds);
  float* sdk = reinterpret_cast<float*>(smem + L.acc1);
  float* sdv = reinterpret_cast<float*>(smem + L.acc2);
  float* slse = reinterpret_cast<float*>(smem + L.lse);
  float* sdelta = reinterpret_cast<float*>(smem + L.delta);

  const int k0 = kt * BK;
  load_rows(sk, ldt, slice<const T>(a.k, b, kvh), a.k.s, k0, BK, a.S, a.D, DP);
  load_rows(sv, ldt, slice<const T>(a.v, b, kvh), a.v.s, k0, BK, a.S, a.D, DP);
  zero(sdk, BK, DP, ldo);
  zero(sdv, BK, DP, ldo);
  int lo, hi;
  q_tiles(a, kt, &lo, &hi);
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int i = lo; i < hi; ++i) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_q_side(a, b, h, i * BQ, sq, sdo, ldt, slse, sdelta);
      __syncthreads();
      tile_mm<false, true>(ss, lds, sq, ldt, sk, ldt, BQ, BK, DP, false);
      tile_mm<false, true>(sdp, lds, sdo, ldt, sv, ldt, BQ, BK, DP, false);
      __syncthreads();
      probs_and_ds<T>(a, i * BQ, k0, ss, sdp, lds, slse, sdelta, sp, sds, ldp);
      __syncthreads();
      tile_mm<true, false>(sdv, ldo, sp, ldp, sdo, ldt, BK, DP, BQ, true);
      tile_mm<true, false>(sdk, ldo, sds, ldp, sq, ldt, BK, DP, BQ, true);
    }
  }
  __syncthreads();
  store_rows(slice<T>(a.dk, b, kvh), a.dk.s, sdk, ldo, nullptr, k0, BK, a.S, a.D);
  store_rows(slice<T>(a.dv, b, kvh), a.dv.s, sdv, ldo, nullptr, k0, BK, a.S, a.D);
}

template <typename T>
cudaError_t bwd(Args a, bool dkv, cudaStream_t st) {
  size_t smem = 0;
  const int elt = sizeof(T), DP = a.DP;
  // 32-row tiles: at 64 rows (D = 128, bf16) these kernels need 145 and
  // 187 KB of shared memory, one block per SM, and measured 1.2-1.5x
  // slower on an H100 than at 32
  const int t = pick_tile(
      [&](int n) { return bwd_smem(n, n, DP, elt, dkv).total; }, 32, &smem);
  if (t == 0) return cudaErrorInvalidValue;
  a.BQ = a.BK = t;
  const int tiles = (a.S + t - 1) / t;
  if (dkv)
    return launch(flash_bwd_dkv_kernel<T>, dim3(tiles, a.H / a.G, a.B), smem,
                  st, a);
  return launch(flash_bwd_dq_kernel<T>, dim3(tiles, a.H, a.B), smem, st, a);
}

inline int bwd_entry(void* const ptrs[8], const void* lse, const void* delta,
                     const long long* strides, int B, int H, int Hkv, int S,
                     int D, float scale, int causal, int window, int dtype,
                     void* stream, bool dkv) {
  Args a{};
  const int elt = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) ||
      !make_args(&a, ptrs, strides, B, H, Hkv, S, D, scale, causal, window,
                 elt))
    return int(cudaErrorInvalidValue);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 1 ? bwd<bf16>(a, dkv, st) : bwd<float>(a, dkv, st));
}

}  // namespace fa

// q, k, v, dout: [B, S, H(kv), D] views given by `strides` (b, s, h of q,
// k, v, dout, dq in that order; d contiguous; every stride and D a
// multiple of one 16-byte vector); lse, delta: (B * H, S) fp32.  dq: q's
// view.  dtype: 0 fp32, 1 bf16.  Returns the CUDA error code of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq,
                            const long long* strides, int B, int H, int Hkv,
                            int S, int D, float scale, int causal, int window,
                            int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), nullptr, const_cast<void*>(dout),
                   dq, nullptr, nullptr};
  return fa::bwd_entry(ptrs, lse, delta, strides, B, H, Hkv, S, D, scale,
                       causal, window, dtype, stream, false);
}

// As flash_bwd_dq, with the strides of q, k, v, dout, dk, dv; dk and dv
// are k's and v's views.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Hkv,
                             int S, int D, float scale, int causal,
                             int window, int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), nullptr, const_cast<void*>(dout),
                   nullptr, dk, dv};
  return fa::bwd_entry(ptrs, lse, delta, strides, B, H, Hkv, S, D, scale,
                       causal, window, dtype, stream, true);
}
