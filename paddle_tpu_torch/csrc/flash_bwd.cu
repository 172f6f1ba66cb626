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
// dQ: grid (query tiles, query heads, batch), heaviest tiles first.  A
// block keeps its Q and dO tiles and walks the k-tiles [lo, hi): dQ +=
// ds.K with ds cast to K's dtype first.
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
// bf16, both kernels: at the training shape their 6 (dQ) and 8 (dK/dV)
// B*H*S^2*D/2 flops bound them (0.059 and 0.078 ms against 0.057 and 0.068
// ms of bytes), and what stood between the first, shared-memory kernels and the
// tensor cores was shared-memory traffic (S, dP, dS and the accumulators
// as fp32 tiles, wmma, five block barriers a tile).  So both are register-
// fragment kernels on flash_common.cuh's toolkit.
//
// flash_bwd_dq_bf16: a block of NW warps owns BQ query rows; each warp owns
// 16 of them and DP / DSPLIT columns of their dQ, which accumulates in
// registers for the block's life.  Q and dO arrive once by cp.async into
// padded tiles (A fragments by ldmatrix); K and V stream through a 2-stage
// cp.async ring of BK-row tiles with zero-filled ragged rows.  S = Q.K^T
// and dP = dO.V^T come out in the accumulator layout, each lane keeps its
// two rows' lse and delta in registers, p and ds are formed in registers,
// and dS, rounded to bf16, is the A operand of dQ += dS.K directly (K's B
// fragments by ldmatrix.trans): no S, P or dS tile touches shared memory.
// Per-element masks run only on a warp's tiles that cross the diagonal,
// the window's edge or row S.  At DP = 256 two warps share each 16 query
// rows (DSPLIT = 2), each recomputing S and dP, so that dQ fits in
// registers.
//
// flash_bwd_dkv_bf16: a block of NW warps owns BK key rows; each warp owns
// 16 of them and DP / DSPLIT columns of their dK and dV, which accumulate
// in registers for the block's life (at D = 128: 4 warps, 64 key rows,
// 64-row query tiles, 255 registers a thread and no spill; 8 warps over
// 128 keys, 32-row query tiles or D split over two warps measured 7-69%
// slower on an H100).  K and V stay in shared memory.  Q, dO, lse and
// delta of BQ query rows stream through a 2-stage cp.async ring (the next
// (head, q-tile) pair in flight while this one is computed on).  With keys
// as rows, S^T = K.Q^T and dP^T = V.dO^T come out in the accumulator
// layout (Q's and dO's B fragments by ldmatrix), p and ds are formed in
// registers (each lane reads lse and delta of its own query columns), and
// P^T and dS^T, rounded to bf16, are the A operands of dV += P^T.dO and dK
// += dS^T.Q directly (dO's and Q's B fragments by ldmatrix.trans).  The
// reference keeps P in fp32 for P^T.dO; this kernel feeds the tensor cores
// bf16 P (as the forward does for P.V), a rounding the bf16 tolerance of
// the comparison covers.  At DP = 256 two warps share each 16 key rows.
//
// fp32 (flash_bwd_dq_fp32_kernel, flash_bwd_dkv_fp32_kernel): the shared-
// memory design of flash_common.cuh, fp32 FMAs; P stays fp32.  The dQ
// kernel forms dp - delta in fp64 from O itself (see there).

#include "flash_common.cuh"

namespace fa {

struct BwdSmem {
  size_t q, dout, k, v, s, dp, p, ds, acc1, acc2, lse, delta, total;
};

// Shared memory of the fp32 kernels.  dkv: the accumulators are dK and dV
// over key rows (BK), with P and dP tiles; otherwise dQ over query rows
// (BQ), whose tile first stages O, and fp64 delta.
__host__ __device__ inline BwdSmem bwd_smem(int BQ, int BK, int DP, bool dkv) {
  Carve c;
  BwdSmem t;
  const int ldt = tile_ld(DP, 4);
  const size_t sf = size_t(BQ) * tile_ld(BK, 4) * 4;
  const size_t acc = size_t(dkv ? BK : BQ) * ldt * 4;
  t.q = c.take(size_t(BQ) * ldt * 4);
  t.dout = c.take(size_t(BQ) * ldt * 4);
  t.k = c.take(size_t(BK) * ldt * 4);
  t.v = c.take(size_t(BK) * ldt * 4);
  t.s = c.take(sf);
  t.dp = dkv ? c.take(sf) : 0;
  t.p = dkv ? c.take(sf) : 0;
  t.ds = c.take(sf);
  t.acc1 = c.take(acc);
  t.acc2 = dkv ? c.take(acc) : 0;
  t.lse = c.take(size_t(BQ) * 4);
  t.delta = c.take(size_t(BQ) * 8);
  t.total = c.off;
  return t;
}

// Q and dO rows [q0, q0 + BQ) of head h, with their lse (0 on the ragged
// edge, whose rows every product masks out).
__device__ void load_q_side(const Args& a, int b, int h, int q0, float* sq, float* sdo,
                            int ldt, float* slse) {
  load_rows(sq, ldt, slice<const float>(a.q, b, h), a.q.s, q0, a.BQ, a.S, a.D, a.DP);
  load_rows(sdo, ldt, slice<const float>(a.dout, b, h), a.dout.s, q0, a.BQ, a.S, a.D,
            a.DP);
  const size_t row = (size_t(b) * a.H + h) * a.S;
  for (int r = threadIdx.x; r < a.BQ; r += blockDim.x)
    slse[r] = q0 + r < a.S ? a.lse[row + q0 + r] : 0.f;
}

// dQ, fp32: a block keeps its Q, dO (and O, for delta) tiles and walks the
// k-tiles [lo, hi): dQ += ds.K.  dp = dO.v and delta = rowsum(dO * O) are
// summed in fp64 and their difference rounded to fp32 once (the plain
// version does the same): where they cancel, as for a query that sees one
// key (its O is that key's V, so its dQ is 0 exactly, as the reference's
// autodiff gives), no fp32 summation noise is left.
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fp32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP;
  const int ld = tile_ld(DP, 4), lds = tile_ld(BK, 4);
  const BwdSmem L = bwd_smem(BQ, BK, DP, false);
  float* sq = reinterpret_cast<float*>(smem + L.q);
  float* sdo = reinterpret_cast<float*>(smem + L.dout);
  float* sk = reinterpret_cast<float*>(smem + L.k);
  float* sv = reinterpret_cast<float*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* sds = reinterpret_cast<float*>(smem + L.ds);
  float* sdq = reinterpret_cast<float*>(smem + L.acc1);
  float* slse = reinterpret_cast<float*>(smem + L.lse);
  double* sdelta = reinterpret_cast<double*>(smem + L.delta);

  const int q0 = qt * BQ;
  load_q_side(a, b, h, q0, sq, sdo, ld, slse);
  load_rows(sdq, ld, slice<const float>(a.o, b, h), a.o.s, q0, BQ, a.S, a.D, DP);
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    double acc = 0.0;
    for (int d = 0; d < DP; ++d) acc = fma(double(sdo[r * ld + d]), double(sdq[r * ld + d]), acc);
    sdelta[r] = acc;
  }
  __syncthreads();
  zero(sdq, BQ, DP, ld);
  const float* kb = slice<const float>(a.k, b, kvh);
  const float* vb = slice<const float>(a.v, b, kvh);
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous tile's K and dS are consumed
    load_rows(sk, ld, kb, a.k.s, j * BK, BK, a.S, a.D, DP);
    load_rows(sv, ld, vb, a.v.s, j * BK, BK, a.S, a.D, DP);
    __syncthreads();
    tile_mm<false, true>(ss, lds, sq, ld, sk, ld, BQ, BK, DP, false);
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * BK; e += blockDim.x) {
      const int r = e / BK, c = e - r * BK;
      float ds = 0.f;
      if (visible(a, q0 + r, j * BK + c)) {
        double dp = 0.0;
        for (int d = 0; d < DP; ++d) dp = fma(double(sdo[r * ld + d]), double(sv[c * ld + d]), dp);
        const float p = expf(ss[r * lds + c] * a.scale - slse[r]);
        ds = p * float(dp - sdelta[r]) * a.scale;
      }
      sds[r * lds + c] = ds;
    }
    __syncthreads();
    tile_mm<false, false>(sdq, ld, sds, lds, sk, ld, BQ, DP, BK, true);
  }
  __syncthreads();
  store_rows(slice<float>(a.dq, b, h), a.dq.s, sdq, ld, nullptr, q0, BQ, a.S, a.D);
}

// dK/dV, fp32: p and ds of one (q-tile, k-tile) pair from S = Q.K^T and
// dP = dO.V^T, delta from the wrapper.
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fp32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP;
  const int ld = tile_ld(DP, 4), lds = tile_ld(BK, 4);
  const BwdSmem L = bwd_smem(BQ, BK, DP, true);
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
    const size_t row = (size_t(b) * a.H + h) * a.S;
    for (int i = lo; i < hi; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_q_side(a, b, h, q0, sq, sdo, ld, slse);
      for (int r = threadIdx.x; r < BQ; r += blockDim.x)
        sdelta[r] = q0 + r < a.S ? a.delta[row + q0 + r] : 0.f;
      __syncthreads();
      tile_mm<false, true>(ss, lds, sq, ld, sk, ld, BQ, BK, DP, false);
      tile_mm<false, true>(sdp, lds, sdo, ld, sv, ld, BQ, BK, DP, false);
      __syncthreads();
      for (int e = threadIdx.x; e < BQ * BK; e += blockDim.x) {
        const int r = e / BK, c = e - r * BK;
        const float p = visible(a, q0 + r, k0 + c) ? expf(ss[r * lds + c] * a.scale - slse[r])
                                                   : 0.f;
        sp[r * lds + c] = p;
        sds[r * lds + c] = p * (sdp[r * lds + c] - sdelta[r]) * a.scale;
      }
      __syncthreads();
      tile_mm<true, false>(sdv, ld, sp, lds, sdo, ld, BK, DP, BQ, true);
      tile_mm<true, false>(sdk, ld, sds, lds, sq, ld, BK, DP, BQ, true);
    }
  }
  __syncthreads();
  store_rows(slice<float>(a.dk, b, kvh), a.dk.s, sdk, ld, nullptr, k0, BK, a.S, a.D);
  store_rows(slice<float>(a.dv, b, kvh), a.dv.s, sdv, ld, nullptr, k0, BK, a.S, a.D);
}

// Tiles of the bf16 dQ kernel: NW warps, DSPLIT of them over each 16
// query rows (BQ = 16 NW / DSPLIT), BK-row K/V tiles in a 2-stage ring.
template <int DP_, int NW_, int DSPLIT_, int BK_>
struct DqTile {
  static constexpr int DP = DP_, NW = NW_, DSPLIT = DSPLIT_, BK = BK_, STAGES = 2;
  static constexpr int NT = 32 * NW, RW = NW / DSPLIT, BQ = 16 * RW, LD = tile_ld(DP, 2);
  static constexpr int DW = DP / DSPLIT;  // columns of dQ a warp owns
  static constexpr int KD = DP / 16;      // k16 steps over d (S, dP)
  static constexpr int NS = BK / 8;       // n8 tiles of S and dP
  static constexpr int NA = DW / 8;       // n8 tiles of dQ
  static constexpr size_t Q_ELEMS = size_t(BQ) * LD;   // one of Q, dO
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;  // one of K, V
  static constexpr size_t SMEM = 2 * Q_ELEMS * 2 + size_t(STAGES) * 2 * KV_ELEMS * 2;
};

template <typename C>
__global__ void __launch_bounds__(C::NT) flash_bwd_dq_bf16(Args a) {
  constexpr int LD = C::LD, BK = C::BK, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + C::Q_ELEMS;
  bf16* skv = sdo + C::Q_ELEMS;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * C::BQ, wr = (warp % C::RW) * 16, r0 = q0 + wr;
  const int d0 = (warp / C::RW) * C::DW;
  const bf16* kb = slice<const bf16>(a.k, b, kvh);
  const bf16* vb = slice<const bf16>(a.v, b, kvh);
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);

  auto load_kv = [&](int j) {
    bf16* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    cp_rows<BK, C::DP, C::NT>(sk, kb, a.k.s, j * BK, a.S, a.D);
    cp_rows<BK, C::DP, C::NT>(sk + C::KV_ELEMS, vb, a.v.s, j * BK, a.S, a.D);
  };
  cp_rows<C::BQ, C::DP, C::NT>(sq, slice<const bf16>(a.q, b, h), a.q.s, q0, a.S, a.D);
  cp_rows<C::BQ, C::DP, C::NT>(sdo, slice<const bf16>(a.dout, b, h), a.dout.s, q0, a.S,
                               a.D);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (lo + s < hi) load_kv(lo + s);
    cp_async_commit();
  }

  // lse (base 2) and delta of this lane's rows g and g + 8 (0 past row S,
  // where every tile is an edge tile and p is masked to 0)
  const float scale2 = a.scale * kLog2e;
  const size_t row = (size_t(b) * a.H + h) * a.S;
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + (lane >> 2) + hf * 8;
    lse2[hf] = r < a.S ? a.lse[row + r] * kLog2e : 0.f;
    dl[hf] = r < a.S ? a.delta[row + r] : 0.f;
  }
  float dq[C::NA][4];
#pragma unroll
  for (int n = 0; n < C::NA; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q, dO) have landed
    __syncthreads();              // ... for every thread; tile j - 1 is consumed
    if (j + STAGES - 1 < hi) load_kv(j + STAGES - 1);
    cp_async_commit();
    const int k0 = j * BK;
    if (none_visible(a, r0, 16, k0, BK)) continue;
    const bf16* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    const bf16* sv = sk + C::KV_ELEMS;

    // S = Q.K^T and dP = dO.V^T: 16 queries x BK keys each
    float s[C::NS][4], dp[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a<LD>(qa, sq, wr, kk * 16);
      frag_a<LD>(oa, sdo, wr, kk * 16);
#pragma unroll
      for (int n = 0; n < C::NS; n += 2) {
        uint32_t kf[4], vf[4];
        frag_b_rows<LD>(kf, sk, n * 8, kk * 16);
        mma16816(s[n], qa, kf[0], kf[1]);
        mma16816(s[n + 1], qa, kf[2], kf[3]);
        frag_b_rows<LD>(vf, sv, n * 8, kk * 16);
        mma16816(dp[n], oa, vf[0], vf[1]);
        mma16816(dp[n + 1], oa, vf[2], vf[3]);
      }
    }

    // p = exp(s * scale - lse) and ds = p (dp - delta) scale (in dp);
    // element e: query row g + (e / 2) * 8, key column 2t + (e % 2) of
    // tile n.  Masks only where the warp's tile crosses an edge.
    const bool edge = !all_visible(a, r0, 16, k0, BK);
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * scale2 - lse2[e >> 1]);
        if (edge && !visible(a, r0 + (lane >> 2) + (e >> 1) * 8, k0 + n * 8 + 2 * (lane & 3) + (e & 1)))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * a.scale;
      }

    // dQ += dS.K over the warp's columns: dS, rounded to bf16 (K's dtype,
    // as the reference casts it), is the A operand; K's B fragments by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::NA; n += 2) {
        uint32_t kf[4];
        frag_b_cols<LD>(kf, sk, kk * 16, d0 + n * 8);
        mma16816(dq[n], da, kf[0], kf[1]);
        mma16816(dq[n + 1], da, kf[2], kf[3]);
      }
    }
  }

  // epilogue: dQ through the Q tile (every warp is done with it), 16-byte
  // stores
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int at = (wr + (lane >> 2) + hf * 8) * LD + d0 + n * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(sq + at) = pack_bf16(dq[n][2 * hf], dq[n][2 * hf + 1]);
    }
  __syncthreads();
  bf16* dqb = slice<bf16>(a.dq, b, h);
  constexpr int VPR = C::DP / 8;
  for (int e = threadIdx.x; e < C::BQ * VPR; e += C::NT) {
    const int r = e / VPR, c = (e - r * VPR) * 8;
    if (q0 + r < a.S && c < a.D)
      *reinterpret_cast<uint4*>(dqb + (q0 + r) * a.dq.s + c) =
          *reinterpret_cast<const uint4*>(sq + r * LD + c);
  }
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

// The fp32 kernels: 32-row tiles, or 16 where 32 do not fit.
cudaError_t bwd_fp32(Args a, bool dkv, cudaStream_t st) {
  size_t smem = 0;
  const int DP = a.DP;
  const int t = pick_tile([&](int n) { return bwd_smem(n, n, DP, dkv).total; }, 32, &smem);
  if (t == 0) return cudaErrorInvalidValue;
  a.BQ = a.BK = t;
  const int tiles = (a.S + t - 1) / t;
  if (dkv)
    return launch(flash_bwd_dkv_fp32_kernel, dim3(tiles, a.H / a.G, a.B), kThreads, smem,
                  st, a);
  return launch(flash_bwd_dq_fp32_kernel, dim3(tiles, a.H, a.B), kThreads, smem, st, a);
}

template <typename C>
cudaError_t dq_bf16(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  return launch(flash_bwd_dq_bf16<C>, grid, C::NT, C::SMEM, st, a);
}

// The dQ tiles by padded head dim (warps, warps per 16 query rows, K/V
// rows): 4 warps over 64 queries, 64-row K/V tiles up to D = 64 and
// 32-row above (the forward's); at D = 256, 8 warps, two over each 16
// queries.
cudaError_t dq_bf16(Args a, cudaStream_t st) {
  if (a.D <= 32) return dq_bf16<DqTile<32, 4, 1, 64>>(a, st);
  if (a.D <= 64) return dq_bf16<DqTile<64, 4, 1, 64>>(a, st);
  if (a.D <= 128) return dq_bf16<DqTile<128, 4, 1, 32>>(a, st);
  return dq_bf16<DqTile<256, 8, 2, 32>>(a, st);
}

template <typename C>
cudaError_t dkv_bf16(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.S + C::BK - 1) / C::BK, a.H / a.G, a.B);
  return launch(flash_bwd_dkv_bf16<C>, grid, C::NT, C::SMEM, st, a);
}

// The dK/dV tiles by padded head dim (warps, warps per 16 key rows, Q/dO
// rows): 4 warps over 64 keys, 64-row Q tiles up to D = 128 (measured
// against its alternatives on an H100: PERF.md); at D = 256, 8 warps, two
// over each 16 keys, 32-row Q tiles.
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
  if (dtype == 0) return int(bwd_fp32(a, dkv, st));
  return int(dkv ? dkv_bf16(a, st) : dq_bf16(a, st));
}

}  // namespace fa

// q, k, v, out, dout: [B, S, H(kv), D] views given by `strides` (b, s, h
// of q, k, v, out, dout, dq in that order; d contiguous; every stride and D
// a multiple of one 16-byte vector); lse, delta: (B * H, S) fp32.  dq: q's
// view.  out (the forward's output) is read by the fp32 kernel, which
// forms delta itself; the bf16 kernel reads delta.  dtype: 0 fp32, 1 bf16.
// Returns the CUDA error code of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            const void* delta, void* dq,
                            const long long* strides, int B, int H, int Hkv,
                            int S, int D, float scale, int causal, int window,
                            int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), const_cast<void*>(out),
                   const_cast<void*>(dout), dq, nullptr, nullptr};
  return fa::bwd_entry(ptrs, lse, delta, strides, B, H, Hkv, S, D, scale,
                       causal, window, dtype, stream, false);
}

// As flash_bwd_dq without out, with the strides of q, k, v, dout, dk, dv;
// dk and dv are k's and v's views.
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
