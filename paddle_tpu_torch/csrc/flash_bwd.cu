// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, from
// the forward's row logsumexp, fp32 or bf16, causal or not, sliding
// window, GQA, any layout given by strides (see flash_common.cuh).
//
// Replaces the TPU kernels paddle_tpu/kernels/flash.py: _bwd_dq_kernel and
// _bwd_dkv_kernel, as launched by _bwd_call (bnsd) and _bwd_call_smajor
// (bsnd / sbnd, GQA).  delta = rowsum(dO * O) in fp32 is an input, as in
// the reference, which computes it outside Pallas (the wrapper does here).
// Both kernels compute, per (query, key) pair, s = q.k * scale, p = exp(s
// - lse) (0 where masked), dp = dO.v in fp32, ds = p * (dp - delta) *
// scale.
//
// dQ (flash_bwd_dq_kernel, both dtypes): the shared-memory design of
// flash_common.cuh.  Grid (query tiles, query heads, batch), heaviest
// tiles first.  A block keeps its Q and dO tiles and walks the k-tiles
// [lo, hi): dQ += ds.K with ds cast to K's dtype first.
//
// dK/dV: grid (key tiles, KV heads, batch), the heaviest causal tiles
// (smallest key index) first.  A block keeps its K and V tiles and, for
// each of the G query heads of its KV head, walks the q-tiles [lo, hi)
// that see them, accumulating dV += P^T.dO and dK += dS^T.Q in fp32 (ds
// cast to Q's dtype first).  GQA: where the reference writes per-query-
// head partials in K's dtype and sums each group in fp32 afterwards
// (flash.py _bwd_call_smajor), the block loops over the group itself and
// accumulates all of it in fp32: no partial buffers.
//
// bf16 (flash_bwd_dkv_bf16): at the training shape its 8 B*H*S^2*D/2
// flops bound it (0.078 ms against 0.068 ms of bytes), and what stood
// between the old kernel and the tensor cores was shared-memory traffic.
// So a block of NW warps owns BK key rows; each warp owns 16 of them and
// DP / DSPLIT columns of their dK and dV, which accumulate in registers
// for the block's life (at D = 128: 4 warps, 64 key rows, 64-row query
// tiles, 255 registers a thread and no spill; 8 warps over 128 keys,
// 32-row query tiles or D split over two warps measured 7-69% slower on
// an H100).  K and V stay in shared memory.  Q, dO, lse and
// delta of BQ query rows stream through a 2-stage cp.async ring (the
// next (head, q-tile) pair in flight while this one is computed on).  With
// keys as rows, S^T = K.Q^T and dP^T = V.dO^T come out in the accumulator
// layout (Q's and dO's B fragments by ldmatrix), p and ds are formed in
// registers (each lane reads lse and delta of its own query columns), and
// P^T and dS^T, rounded to bf16, are the A operands of dV += P^T.dO and
// dK += dS^T.Q directly (dO's and Q's B fragments by ldmatrix.trans): no
// S, P or dS tile touches shared memory.  Per-element masks run only on a
// warp's tiles that cross the diagonal, the window's edge or row S.  The
// reference keeps P in fp32 for P^T.dO; this kernel feeds the tensor
// cores bf16 P (as the forward does for P.V), a rounding the bf16
// tolerance of the comparison covers.  At DP = 256 two warps share each
// 16 key rows (DSPLIT = 2), each recomputing S^T and dP^T, so that the
// accumulators fit in registers.
//
// fp32 (flash_bwd_dkv_fp32_kernel): the shared-memory design, fp32 FMAs;
// P stays fp32.

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

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fp32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP;
  const int ld = tile_ld(DP, 4), lds = tile_ld(BK, 4);
  const BwdSmem L = bwd_smem(BQ, BK, DP, 4, true);
  float* sq = reinterpret_cast<float*>(smem + L.q);
  float* sdo = reinterpret_cast<float*>(smem + L.dout);
  float* sk = reinterpret_cast<float*>(smem + L.k);
  float* sv = reinterpret_cast<float*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* sdp = reinterpret_cast<float*>(smem + L.dp);
  float* sp = reinterpret_cast<float*>(smem + L.p);
  float* sds = reinterpret_cast<float*>(smem + L.ds);
  float* sdk = reinterpret_cast<float*>(smem + L.acc1);
  float* sdv = reinterpret_cast<float*>(smem + L.acc2);
  float* slse = reinterpret_cast<float*>(smem + L.lse);
  float* sdelta = reinterpret_cast<float*>(smem + L.delta);

  const int k0 = kt * BK;
  load_rows(sk, ld, slice<const float>(a.k, b, kvh), a.k.s, k0, BK, a.S, a.D, DP);
  load_rows(sv, ld, slice<const float>(a.v, b, kvh), a.v.s, k0, BK, a.S, a.D, DP);
  zero(sdk, BK, DP, ld);
  zero(sdv, BK, DP, ld);
  int lo, hi;
  q_tiles(a, kt, &lo, &hi);
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int i = lo; i < hi; ++i) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_q_side(a, b, h, i * BQ, sq, sdo, ld, slse, sdelta);
      __syncthreads();
      tile_mm<false, true>(ss, lds, sq, ld, sk, ld, BQ, BK, DP, false);
      tile_mm<false, true>(sdp, lds, sdo, ld, sv, ld, BQ, BK, DP, false);
      __syncthreads();
      probs_and_ds(a, i * BQ, k0, ss, sdp, lds, slse, sdelta, sp, sds, lds);
      __syncthreads();
      tile_mm<true, false>(sdv, ld, sp, lds, sdo, ld, BK, DP, BQ, true);
      tile_mm<true, false>(sdk, ld, sds, lds, sq, ld, BK, DP, BQ, true);
    }
  }
  __syncthreads();
  store_rows(slice<float>(a.dk, b, kvh), a.dk.s, sdk, ld, nullptr, k0, BK, a.S, a.D);
  store_rows(slice<float>(a.dv, b, kvh), a.dv.s, sdv, ld, nullptr, k0, BK, a.S, a.D);
}

// Tiles of the bf16 dK/dV kernel: NW warps, DSPLIT of them over each 16
// key rows (BK = 16 NW / DSPLIT), BQ-row Q/dO tiles in a 2-stage ring.
template <int DP_, int NW_, int DSPLIT_, int BQ_>
struct DkvTile {
  static constexpr int DP = DP_, NW = NW_, DSPLIT = DSPLIT_, BQ = BQ_, STAGES = 2;
  static constexpr int NT = 32 * NW, RW = NW / DSPLIT, BK = 16 * RW, LD = tile_ld(DP, 2);
  static constexpr int DW = DP / DSPLIT;  // columns of dK/dV a warp owns
  static constexpr int KD = DP / 16;      // k16 steps over d (S^T, dP^T)
  static constexpr int NS = BQ / 8;       // n8 tiles of S^T
  static constexpr int NA = DW / 8;       // n8 tiles of dK, dV
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;
  static constexpr size_t Q_ELEMS = size_t(BQ) * LD;
  // one stage: Q, dO (bf16), lse, delta (fp32)
  static constexpr size_t STAGE_BYTES = 2 * Q_ELEMS * 2 + 2 * BQ * 4;
  static constexpr size_t SMEM = 2 * KV_ELEMS * 2 + STAGES * STAGE_BYTES;
};

template <typename C>
__global__ void __launch_bounds__(C::NT) flash_bwd_dkv_bf16(Args a) {
  constexpr int LD = C::LD, BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + C::KV_ELEMS;
  unsigned char* ring = smem + 2 * C::KV_ELEMS * 2;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = kt * C::BK, wr = (warp % C::RW) * 16, kr0 = k0 + wr;
  const int d0 = (warp / C::RW) * C::DW;
  int lo, hi;
  q_tiles(a, kt, &lo, &hi);
  const int nq = hi - lo, total = a.G * nq;

  cp_rows<C::BK, C::DP, C::NT>(sk, slice<const bf16>(a.k, b, kvh), a.k.s, k0, a.S, a.D);
  cp_rows<C::BK, C::DP, C::NT>(sv, slice<const bf16>(a.v, b, kvh), a.v.s, k0, a.S, a.D);
  cp_async_commit();
  // (head, q-tile) pair t of the walk: Q, dO, lse, delta into stage t % STAGES
  auto load_q = [&](int t) {
    const int h = kvh * a.G + t / nq, q0 = (lo + t % nq) * BQ;
    unsigned char* st = ring + size_t(t % STAGES) * C::STAGE_BYTES;
    bf16* sq = reinterpret_cast<bf16*>(st);
    cp_rows<BQ, C::DP, C::NT>(sq, slice<const bf16>(a.q, b, h), a.q.s, q0, a.S, a.D);
    cp_rows<BQ, C::DP, C::NT>(sq + C::Q_ELEMS, slice<const bf16>(a.dout, b, h), a.dout.s,
                              q0, a.S, a.D);
    float* sl = reinterpret_cast<float*>(st + 2 * C::Q_ELEMS * 2);
    const size_t row = (size_t(b) * a.H + h) * a.S;
    for (int r = threadIdx.x; r < BQ; r += C::NT) {
      const bool ok = q0 + r < a.S;
      const size_t at = row + (ok ? q0 + r : 0);
      cp_async4(sl + r, a.lse + at, ok);
      cp_async4(sl + BQ + r, a.delta + at, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < total) load_q(t);
    cp_async_commit();
  }

  float dk[C::NA][4], dv[C::NA][4];
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < total; ++t) {
    cp_async_wait<STAGES - 2>();  // pair t (and K, V) have landed
    __syncthreads();              // ... for every thread; pair t - 1 is consumed
    if (t + STAGES - 1 < total) load_q(t + STAGES - 1);
    cp_async_commit();
    const int q0 = (lo + t % nq) * BQ;
    if (none_visible(a, q0, BQ, kr0, 16)) continue;
    const unsigned char* st = ring + size_t(t % STAGES) * C::STAGE_BYTES;
    const bf16* sq = reinterpret_cast<const bf16*>(st);
    const bf16* sdo = sq + C::Q_ELEMS;
    const float* slse = reinterpret_cast<const float*>(st + 2 * C::Q_ELEMS * 2);
    const float* sdelta = slse + BQ;

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x BQ queries each
    float s[C::NS][4], dp[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, sk, wr, kk * 16);
      frag_a<LD>(va, sv, wr, kk * 16);
#pragma unroll
      for (int n = 0; n < C::NS; n += 2) {
        uint32_t qf[4], of[4];
        frag_b_rows<LD>(qf, sq, n * 8, kk * 16);
        mma16816(s[n], ka, qf[0], qf[1]);
        mma16816(s[n + 1], ka, qf[2], qf[3]);
        frag_b_rows<LD>(of, sdo, n * 8, kk * 16);
        mma16816(dp[n], va, of[0], of[1]);
        mma16816(dp[n + 1], va, of[2], of[3]);
      }
    }

    // p (in s) and ds (in dp); element e: key row g + (e / 2) * 8, query
    // column 2t + (e % 2) of tile n.  Masks only where the warp's tile
    // crosses an edge.
    const bool edge = !all_visible(a, q0, BQ, kr0, 16);
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      const float2 ls = *reinterpret_cast<const float2*>(slse + c);
      const float2 de = *reinterpret_cast<const float2*>(sdelta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = expf(s[n][e] * a.scale - ((e & 1) ? ls.y : ls.x));
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, q0 + c + (e & 1), kr0 + (lane >> 2) + (e >> 1) * 8)) s[n][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? de.y : de.x)) * a.scale;
    }

    // dV += P^T.dO and dK += dS^T.Q over the warp's columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::NA; n += 2) {
        uint32_t of[4], qf[4];
        frag_b_cols<LD>(of, sdo, kk * 16, d0 + n * 8);
        mma16816(dv[n], pa, of[0], of[1]);
        mma16816(dv[n + 1], pa, of[2], of[3]);
        frag_b_cols<LD>(qf, sq, kk * 16, d0 + n * 8);
        mma16816(dk[n], da, qf[0], qf[1]);
        mma16816(dk[n + 1], da, qf[2], qf[3]);
      }
    }
  }

  // epilogue: dK and dV through the K and V tiles, 16-byte stores
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with K and V
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int at = (wr + (lane >> 2) + hf * 8) * LD + d0 + n * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(sk + at) = pack_bf16(dk[n][2 * hf], dk[n][2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(sv + at) = pack_bf16(dv[n][2 * hf], dv[n][2 * hf + 1]);
    }
  __syncthreads();
  bf16* dkb = slice<bf16>(a.dk, b, kvh);
  bf16* dvb = slice<bf16>(a.dv, b, kvh);
  constexpr int VPR = C::DP / 8;
  for (int e = threadIdx.x; e < C::BK * VPR; e += C::NT) {
    const int r = e / VPR, c = (e - r * VPR) * 8;
    if (k0 + r < a.S && c < a.D) {
      *reinterpret_cast<uint4*>(dkb + (k0 + r) * a.dk.s + c) =
          *reinterpret_cast<const uint4*>(sk + r * LD + c);
      *reinterpret_cast<uint4*>(dvb + (k0 + r) * a.dv.s + c) =
          *reinterpret_cast<const uint4*>(sv + r * LD + c);
    }
  }
}

// The shared-memory kernels: dQ (both dtypes) and the fp32 dK/dV.
// 32-row tiles: at 64 rows (D = 128, bf16) they need 145 and 187 KB of
// shared memory, one block per SM, and measured 1.2-1.5x slower on an
// H100 than at 32.
template <typename T>
cudaError_t bwd_shared(Args a, bool dkv, cudaStream_t st) {
  size_t smem = 0;
  const int elt = sizeof(T), DP = a.DP;
  const int t = pick_tile(
      [&](int n) { return bwd_smem(n, n, DP, elt, dkv).total; }, 32, &smem);
  if (t == 0) return cudaErrorInvalidValue;
  a.BQ = a.BK = t;
  const int tiles = (a.S + t - 1) / t;
  if (dkv)
    return launch(flash_bwd_dkv_fp32_kernel, dim3(tiles, a.H / a.G, a.B),
                  kThreads, smem, st, a);
  return launch(flash_bwd_dq_kernel<T>, dim3(tiles, a.H, a.B), kThreads, smem,
                st, a);
}

template <typename C>
cudaError_t dkv_bf16(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.S + C::BK - 1) / C::BK, a.H / a.G, a.B);
  return launch(flash_bwd_dkv_bf16<C>, grid, C::NT, C::SMEM, st, a);
}

// The tiles by padded head dim (warps, warps per 16 key rows, Q/dO rows):
// 4 warps over 64 keys, 64-row Q tiles up to D = 128 (measured against its
// alternatives on an H100: PERF.md); at D = 256, 8 warps, two over each 16
// keys, 32-row Q tiles.
cudaError_t dkv_bf16(Args a, cudaStream_t st) {
  if (a.D <= 32) return dkv_bf16<DkvTile<32, 4, 1, 64>>(a, st);
  if (a.D <= 64) return dkv_bf16<DkvTile<64, 4, 1, 64>>(a, st);
  if (a.D <= 128) return dkv_bf16<DkvTile<128, 4, 1, 64>>(a, st);
  return dkv_bf16<DkvTile<256, 8, 2, 32>>(a, st);
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
  if (dkv) return int(dtype == 1 ? dkv_bf16(a, st) : bwd_shared<float>(a, true, st));
  return int(dtype == 1 ? bwd_shared<bf16>(a, false, st) : bwd_shared<float>(a, false, st));
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
