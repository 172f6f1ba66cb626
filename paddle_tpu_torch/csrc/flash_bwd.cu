// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, from
// the forward's row logsumexp, fp32 or bf16, causal or not, sliding
// window, GQA, any layout given by strides (see flash_common.cuh).
//
// Replaces the TPU kernels paddle_tpu/kernels/flash.py: _bwd_dq_kernel and
// _bwd_dkv_kernel, as launched by _bwd_call (bnsd) and _bwd_call_smajor
// (bsnd / sbnd, GQA).  delta = rowsum(dO * O) is an input, as in the
// reference, which computes it outside Pallas (the wrapper does here).
// Both kernels compute, per (query, key) pair, s = q.k * scale, p = exp(s
// - lse) (0 where masked), dp = dO.v, ds = p * (dp - delta) * scale.
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
// fp32 (flash_bwd_dq_fp32, flash_bwd_dkv_fp32): at BERT-base's attention
// (B*H = 384, S = 512, D = 64, not causal) their 6 and 8 B*H*S^2*D flops
// take 0.58 and 0.77 ms at the card's 67 TFLOP/s of fp32 FMAs, and 0.23
// and 0.31 ms as three TF32 products each at 495 TFLOP/s, against 0.08
// and 0.09 ms of bytes: operations bound them, and the tensor cores are
// the way to fp32-accurate operations at more than the FMA rate.  So both
// are the bf16 kernels above with fp32 tiles (row pitch DP + 4 floats) in
// the same cp.async rings and every product on mma.sync m16n8k8 in
// 3xTF32 (flash_common.cuh's toolkit): S, dP (S^T, dP^T), p and ds in
// registers, P in fp32 for dV += P^T.dO as in the reference, dQ or dK and
// dV accumulated in registers and stored from them as float2.  Where the
// bf16 kernels hand the accumulator to the next product as its A
// fragment, these permute the summation order instead (tf32_acc_a,
// tf32_b_cols).  Each k8 step's three products go into a fresh partial
// that an fp32 add takes into the accumulator: chained into one register
// across the reduction, the tensor cores' roundings (not to nearest)
// added up past FLASH_TOL's fp32 bound on an H100.  ds needs dp - delta
// where they cancel (see heavy_dp64); with it a query that sees
// one key gets dQ = 0 to fp64 rounding, as the reference's autodiff
// gives 0.  (No rule by key count: the ring hands a block the whole
// sequence's lse and delta, so a block's first query may see one of its
// keys and many others.)  The tiles (dq_tiles, dkv_tiles) were timed
// against 2- and 8-warp, 16- to 64-row and D-split alternatives on an
// H100; the fp32 ones stream 32-row tiles where the bf16 ones stream 64.

#include "flash_common.cuh"

namespace fa {

// Tiles of the dQ kernels, elements of T (bf16 or fp32): NW warps, DSPLIT
// of them over each 16 query rows (BQ = 16 NW / DSPLIT), BK-row K/V tiles
// in a 2-stage ring.
template <typename T_, int DP_, int NW_, int DSPLIT_, int BK_>
struct DqTile {
  using T = T_;
  static constexpr int ELT = sizeof(T), KSTEP = 32 / ELT;  // k of one mma: 16 or 8
  static constexpr int DP = DP_, NW = NW_, DSPLIT = DSPLIT_, BK = BK_, STAGES = 2;
  static constexpr int NT = 32 * NW, RW = NW / DSPLIT, BQ = 16 * RW, LD = tile_ld(DP, ELT);
  static constexpr int DW = DP / DSPLIT;  // columns of dQ a warp owns
  static constexpr int KD = DP / KSTEP;   // k steps over d (S, dP)
  static constexpr int NS = BK / 8;       // n8 tiles of S and dP
  static constexpr int NA = DW / 8;       // n8 tiles of dQ
  static constexpr size_t Q_ELEMS = size_t(BQ) * LD;   // one of Q, dO
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;  // one of K, V
  static constexpr size_t SMEM = (2 * Q_ELEMS + size_t(STAGES) * 2 * KV_ELEMS) * ELT;
};

template <typename C, bool BIAS>
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
  [[maybe_unused]] const float* bs = BIAS ? bias_slice(a, b, h) : nullptr;
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
    [[maybe_unused]] float bv[C::NS][4];
    if constexpr (BIAS)
      load_bias<C::NS>(bv, a, edge, [&](int n, int e, int* qi, int* kj) {
        *qi = r0 + (lane >> 2) + (e >> 1) * 8;
        *kj = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        return bs;
      });
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if constexpr (BIAS) x += kLog2e * bv[n][e];
        float p = exp2f(x - lse2[e >> 1]);
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

// Tiles of the dK/dV kernels, elements of T (bf16 or fp32): NW warps,
// DSPLIT of them over each 16 key rows (BK = 16 NW / DSPLIT), BQ-row Q/dO
// tiles in a 2-stage ring.
template <typename T_, int DP_, int NW_, int DSPLIT_, int BQ_>
struct DkvTile {
  using T = T_;
  static constexpr int ELT = sizeof(T), KSTEP = 32 / ELT;  // k of one mma: 16 or 8
  static constexpr int DP = DP_, NW = NW_, DSPLIT = DSPLIT_, BQ = BQ_, STAGES = 2;
  static constexpr int NT = 32 * NW, RW = NW / DSPLIT, BK = 16 * RW, LD = tile_ld(DP, ELT);
  static constexpr int DW = DP / DSPLIT;  // columns of dK/dV a warp owns
  static constexpr int KD = DP / KSTEP;   // k steps over d (S^T, dP^T)
  static constexpr int NS = BQ / 8;       // n8 tiles of S^T
  static constexpr int NA = DW / 8;       // n8 tiles of dK, dV
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;
  static constexpr size_t Q_ELEMS = size_t(BQ) * LD;
  static constexpr int DELT = ELT == 4 ? 8 : 4;  // delta: hi + lo for fp32 inputs
  // one stage: Q, dO (T), lse (fp32), delta
  static constexpr size_t STAGE_BYTES = 2 * Q_ELEMS * ELT + BQ * (4 + DELT);
  static constexpr size_t SMEM = 2 * KV_ELEMS * ELT + STAGES * STAGE_BYTES;
};

template <typename C, bool BIAS>
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
    [[maybe_unused]] const float* bs = BIAS ? bias_slice(a, b, kvh * a.G + t / nq) : nullptr;
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
    [[maybe_unused]] float bv[C::NS][4];
    if constexpr (BIAS)
      load_bias<C::NS>(bv, a, edge, [&](int n, int e, int* qi, int* kj) {
        *qi = q0 + n * 8 + 2 * (lane & 3) + (e & 1);
        *kj = kr0 + (lane >> 2) + (e >> 1) * 8;
        return bs;
      });
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      const float2 ls = *reinterpret_cast<const float2*>(slse + c);
      const float2 de = *reinterpret_cast<const float2*>(sdelta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if constexpr (BIAS) x += bv[n][e];
        s[n][e] = expf(x - ((e & 1) ? ls.y : ls.x));
      }
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

// ds = p (dp - delta) scale needs dp - delta to a small part of the
// smaller of the two where they cancel: where a query's probability sits
// on few keys, dp of each is close to delta (their p-weighted mean), and
// a 3xTF32 dp is off by a few units in the last place of |dO| |v|.  delta
// comes summed in fp64 (as fp32 hi + lo, so that dp - hi - lo keeps its
// low bits), and a pair that holds at least kHeavy of its query's
// probability (at most 16 a query) takes dp in fp64 from the fp32 rows,
// as flash_bwd_plain forms it.
constexpr float kHeavy = 1.f / 16;

// Row pair of one heavy (query, key) pair: dO's and V's fp32 rows in
// shared memory and the query's delta.
struct HeavyPair {
  const float* x;
  const float* y;
  float2 delta;
};

// d[n][e] = dp - delta in fp64 for every pair whose bit n * 4 + e is set
// in its lane's `heavy`.  The warp takes up to four pairs a round, one
// for each 8-lane group: each lane of a group sums every 8th term of the
// pair's D-long dot in fp64 and three shuffles sum the group, so a pair
// costs a few instructions a lane and no lane waits on another's D-long
// loop; a warp with no heavy pair pays one vote.  pair(l, n, e) gives
// lane l's pair of slot (n, e) (every lane calls it, with the lane its
// group serves).  A pair's sum order does not depend on the group or
// round that takes it: two launches agree bit for bit.
template <int NS, typename P>
__device__ __forceinline__ void heavy_dp64(float (&d)[NS][4], uint32_t heavy, int D, P&& pair) {
  static_assert(NS * 4 <= 32, "one bit a slot");
  const int lane = threadIdx.x & 31, grp = lane >> 3;
  for (;;) {
    const uint32_t lanes = __ballot_sync(~0u, heavy != 0);
    if (!lanes) return;
    // the owner of group grp's pair: the grp-th lane with one (if any)
    uint32_t m = lanes;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < grp) m &= m - 1;
    const int l = m ? __ffs(m) - 1 : 0;
    const int slot = max(__shfl_sync(~0u, __ffs(heavy) - 1, l), 0);
    const int rank = __popc(lanes & ((1u << lane) - 1));  // among the owners
    const bool owner = heavy != 0 && rank < 4;
    if (owner) heavy &= heavy - 1;
    const HeavyPair hp = pair(l, slot >> 2, slot & 3);
    double acc = 0.0;
    if (m)
      for (int i = lane & 7; i < D; i += 8) acc = fma(double(hp.x[i]), double(hp.y[i]), acc);
#pragma unroll
    for (int o = 4; o; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
    const float v = float(acc - double(hp.delta.x) - double(hp.delta.y));
    // each owner takes the value and slot of the group that served it
    const float got = __shfl_sync(~0u, v, 8 * (rank & 3));
    const int at = __shfl_sync(~0u, slot, 8 * (rank & 3));
    if (owner) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 4 + e == at) d[n][e] = got;
    }
  }
}

// dQ, fp32: flash_bwd_dq_bf16's walk with fp32 tiles and 3xTF32 products.
template <typename C, bool BIAS>
__global__ void __launch_bounds__(C::NT) flash_bwd_dq_fp32(Args a) {
  constexpr int LD = C::LD, BK = C::BK, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + C::Q_ELEMS;
  float* skv = sdo + C::Q_ELEMS;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * C::BQ, wr = (warp % C::RW) * 16, r0 = q0 + wr;
  const int d0 = (warp / C::RW) * C::DW;
  const float* kb = slice<const float>(a.k, b, kvh);
  const float* vb = slice<const float>(a.v, b, kvh);
  [[maybe_unused]] const float* bs = BIAS ? bias_slice(a, b, h) : nullptr;
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);

  auto load_kv = [&](int j) {
    float* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    cp_rows<BK, C::DP, C::NT>(sk, kb, a.k.s, j * BK, a.S, a.D);
    cp_rows<BK, C::DP, C::NT>(sk + C::KV_ELEMS, vb, a.v.s, j * BK, a.S, a.D);
  };
  cp_rows<C::BQ, C::DP, C::NT>(sq, slice<const float>(a.q, b, h), a.q.s, q0, a.S, a.D);
  cp_rows<C::BQ, C::DP, C::NT>(sdo, slice<const float>(a.dout, b, h), a.dout.s, q0, a.S,
                               a.D);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (lo + s < hi) load_kv(lo + s);
    cp_async_commit();
  }

  // lse and delta of this lane's rows g and g + 8 (0 past row S, where
  // every tile is an edge tile and p is masked to 0)
  const size_t row = (size_t(b) * a.H + h) * a.S;
  float lse[2];
  float2 dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + (lane >> 2) + hf * 8;
    lse[hf] = r < a.S ? a.lse[row + r] : 0.f;
    dl[hf] = r < a.S ? a.delta2[row + r] : make_float2(0.f, 0.f);
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
    const float* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    const float* sv = sk + C::KV_ELEMS;

    // S = Q.K^T and dP = dO.V^T: 16 queries x BK keys each
    float s[C::NS][4], dp[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      const Tf32A qa = tf32_a<LD>(sq, wr, kk * 8);
      const Tf32A oa = tf32_a<LD>(sdo, wr, kk * 8);
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        mma_3xtf32(s[n], qa, tf32_b_rows<LD>(sk, n * 8, kk * 8));
        mma_3xtf32(dp[n], oa, tf32_b_rows<LD>(sv, n * 8, kk * 8));
      }
    }

    // p = exp(s * scale - lse) and ds = p (dp - delta) scale (in dp);
    // element e: query row g + (e / 2) * 8, key column 2t + (e % 2) of
    // tile n.  Masks only where the warp's tile crosses an edge.
    const bool edge = !all_visible(a, r0, 16, k0, BK);
    [[maybe_unused]] float bv[C::NS][4];
    if constexpr (BIAS)
      load_bias<C::NS>(bv, a, edge, [&](int n, int e, int* qi, int* kj) {
        *qi = r0 + (lane >> 2) + (e >> 1) * 8;
        *kj = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        return bs;
      });
    uint32_t heavy = 0;
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (lane >> 2) + (e >> 1) * 8, c = n * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[n][e] * a.scale;
        if constexpr (BIAS) x += bv[n][e];
        float p = expf(x - lse[e >> 1]);
        if (edge && !visible(a, r0 + r, k0 + c)) p = 0.f;
        s[n][e] = p;
        dp[n][e] = (dp[n][e] - dl[e >> 1].x) - dl[e >> 1].y;
        if (p >= kHeavy) heavy |= 1u << (n * 4 + e);
      }
    heavy_dp64(dp, heavy, a.D, [&](int l, int n, int e) {
      const int hf = e >> 1;  // lane l's row g or g + 8: its delta from its registers
      const float2 d0 = make_float2(__shfl_sync(~0u, dl[0].x, l), __shfl_sync(~0u, dl[0].y, l));
      const float2 d1 = make_float2(__shfl_sync(~0u, dl[1].x, l), __shfl_sync(~0u, dl[1].y, l));
      return HeavyPair{sdo + (wr + (l >> 2) + hf * 8) * LD,
                       sv + (n * 8 + 2 * (l & 3) + (e & 1)) * LD, hf ? d1 : d0};
    });
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * dp[n][e] * a.scale;

    // dQ += dS.K over the warp's columns: dS tile kk is the A operand of
    // k8 step kk
#pragma unroll
    for (int kk = 0; kk < C::NS; ++kk) {
      const Tf32A da = tf32_acc_a(dp[kk]);
#pragma unroll
      for (int n = 0; n < C::NA; ++n)
        mma_3xtf32(dq[n], da, tf32_b_cols<LD>(sk, kk * 8, d0 + n * 8));
    }
  }
  cp_async_wait<0>();

  float* dqb = slice<float>(a.dq, b, h);
#pragma unroll
  for (int n = 0; n < C::NA; ++n) {
    const int c = d0 + n * 8 + 2 * (lane & 3);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + (lane >> 2) + hf * 8;
      if (r < a.S && c < a.D)
        *reinterpret_cast<float2*>(dqb + r * a.dq.s + c) =
            make_float2(dq[n][2 * hf], dq[n][2 * hf + 1]);
    }
  }
}

// dK/dV, fp32: flash_bwd_dkv_bf16's walk with fp32 tiles and 3xTF32
// products; P^T stays fp32 for dV += P^T.dO.
template <typename C, bool BIAS>
__global__ void __launch_bounds__(C::NT) flash_bwd_dkv_fp32(Args a) {
  constexpr int LD = C::LD, BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + C::KV_ELEMS;
  unsigned char* ring = smem + 2 * C::KV_ELEMS * 4;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = kt * C::BK, wr = (warp % C::RW) * 16, kr0 = k0 + wr;
  const int d0 = (warp / C::RW) * C::DW;
  int lo, hi;
  q_tiles(a, kt, &lo, &hi);
  const int nq = hi - lo, total = a.G * nq;

  cp_rows<C::BK, C::DP, C::NT>(sk, slice<const float>(a.k, b, kvh), a.k.s, k0, a.S, a.D);
  cp_rows<C::BK, C::DP, C::NT>(sv, slice<const float>(a.v, b, kvh), a.v.s, k0, a.S, a.D);
  cp_async_commit();
  // (head, q-tile) pair t of the walk: Q, dO, lse, delta into stage t % STAGES
  auto load_q = [&](int t) {
    const int h = kvh * a.G + t / nq, q0 = (lo + t % nq) * BQ;
    unsigned char* st = ring + size_t(t % STAGES) * C::STAGE_BYTES;
    float* sq = reinterpret_cast<float*>(st);
    cp_rows<BQ, C::DP, C::NT>(sq, slice<const float>(a.q, b, h), a.q.s, q0, a.S, a.D);
    cp_rows<BQ, C::DP, C::NT>(sq + C::Q_ELEMS, slice<const float>(a.dout, b, h), a.dout.s,
                              q0, a.S, a.D);
    float* sl = sq + 2 * C::Q_ELEMS;
    float2* sd = reinterpret_cast<float2*>(sl + BQ);
    const size_t row = (size_t(b) * a.H + h) * a.S;
    for (int r = threadIdx.x; r < BQ; r += C::NT) {
      const bool ok = q0 + r < a.S;
      const size_t at = row + (ok ? q0 + r : 0);
      cp_async4(sl + r, a.lse + at, ok);
      cp_async8(sd + r, a.delta2 + at, ok);
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
    [[maybe_unused]] const float* bs = BIAS ? bias_slice(a, b, kvh * a.G + t / nq) : nullptr;
    const float* sq = reinterpret_cast<const float*>(ring + size_t(t % STAGES) * C::STAGE_BYTES);
    const float* sdo = sq + C::Q_ELEMS;
    const float* slse = sdo + C::Q_ELEMS;
    const float2* sdelta = reinterpret_cast<const float2*>(slse + BQ);

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x BQ queries each
    float s[C::NS][4], dp[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      const Tf32A ka = tf32_a<LD>(sk, wr, kk * 8);
      const Tf32A va = tf32_a<LD>(sv, wr, kk * 8);
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        mma_3xtf32(s[n], ka, tf32_b_rows<LD>(sq, n * 8, kk * 8));
        mma_3xtf32(dp[n], va, tf32_b_rows<LD>(sdo, n * 8, kk * 8));
      }
    }

    // p (in s) and ds (in dp); element e: key row g + (e / 2) * 8, query
    // column 2t + (e % 2) of tile n.  Masks only where the warp's tile
    // crosses an edge.
    const bool edge = !all_visible(a, q0, BQ, kr0, 16);
    [[maybe_unused]] float bv[C::NS][4];
    if constexpr (BIAS)
      load_bias<C::NS>(bv, a, edge, [&](int n, int e, int* qi, int* kj) {
        *qi = q0 + n * 8 + 2 * (lane & 3) + (e & 1);
        *kj = kr0 + (lane >> 2) + (e >> 1) * 8;
        return bs;
      });
    uint32_t heavy = 0;
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      const float2 ls = *reinterpret_cast<const float2*>(slse + c);
      const float4 de = *reinterpret_cast<const float4*>(sdelta + c);  // hi, lo of c, c + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if constexpr (BIAS) x += bv[n][e];
        s[n][e] = expf(x - ((e & 1) ? ls.y : ls.x));
      }
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, q0 + c + (e & 1), kr0 + (lane >> 2) + (e >> 1) * 8)) s[n][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[n][e] = (e & 1) ? (dp[n][e] - de.z) - de.w : (dp[n][e] - de.x) - de.y;
        if (s[n][e] >= kHeavy) heavy |= 1u << (n * 4 + e);
      }
    }
    heavy_dp64(dp, heavy, a.D, [&](int l, int n, int e) {
      const int c = n * 8 + 2 * (l & 3) + (e & 1);
      return HeavyPair{sdo + c * LD, sv + (wr + (l >> 2) + (e >> 1) * 8) * LD, sdelta[c]};
    });
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * dp[n][e] * a.scale;

    // dV += P^T.dO and dK += dS^T.Q over the warp's columns: tile kk of
    // P^T and dS^T is the A operand of k8 step kk
#pragma unroll
    for (int kk = 0; kk < C::NS; ++kk) {
      const Tf32A pa = tf32_acc_a(s[kk]);
      const Tf32A da = tf32_acc_a(dp[kk]);
#pragma unroll
      for (int n = 0; n < C::NA; ++n) {
        mma_3xtf32(dv[n], pa, tf32_b_cols<LD>(sdo, kk * 8, d0 + n * 8));
        mma_3xtf32(dk[n], da, tf32_b_cols<LD>(sq, kk * 8, d0 + n * 8));
      }
    }
  }
  cp_async_wait<0>();

  float* dkb = slice<float>(a.dk, b, kvh);
  float* dvb = slice<float>(a.dv, b, kvh);
#pragma unroll
  for (int n = 0; n < C::NA; ++n) {
    const int c = d0 + n * 8 + 2 * (lane & 3);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = kr0 + (lane >> 2) + hf * 8;
      if (r < a.S && c < a.D) {
        *reinterpret_cast<float2*>(dkb + r * a.dk.s + c) =
            make_float2(dk[n][2 * hf], dk[n][2 * hf + 1]);
        *reinterpret_cast<float2*>(dvb + r * a.dv.s + c) =
            make_float2(dv[n][2 * hf], dv[n][2 * hf + 1]);
      }
    }
  }
}

template <typename C>
cudaError_t dq_launch(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  return with_bias(a, [&](auto bias) {
    constexpr bool B = decltype(bias)::value;
    if constexpr (C::ELT == 2) return launch(flash_bwd_dq_bf16<C, B>, grid, C::NT, C::SMEM, st, a);
    else return launch(flash_bwd_dq_fp32<C, B>, grid, C::NT, C::SMEM, st, a);
  });
}

// The dQ tiles by dtype (0 fp32, 1 bf16) and padded head dim (warps,
// warps per 16 query rows, K/V rows), handed to f as a value of their
// type.  bf16: 4 warps over 64 queries, 64-row K/V tiles up to D = 64
// and 32-row above (the forward's); at D = 256, 8 warps, two over each 16
// queries.  fp32 (twice the bytes a row): 4 warps over 64 queries and
// 32-row K/V tiles up to D = 64 (three blocks an SM); at D = 128, two
// warps over each 16 queries (dQ in 32 registers); at D = 256, 8 warps,
// 16-row K/V tiles (195 KB).
template <typename F>
cudaError_t dq_tiles(int dtype, int D, F&& f) {
  if (dtype == 1) {
    if (D <= 32) return f(DqTile<bf16, 32, 4, 1, 64>{});
    if (D <= 64) return f(DqTile<bf16, 64, 4, 1, 64>{});
    if (D <= 128) return f(DqTile<bf16, 128, 4, 1, 32>{});
    return f(DqTile<bf16, 256, 8, 2, 32>{});
  }
  if (D <= 32) return f(DqTile<float, 32, 4, 1, 32>{});
  if (D <= 64) return f(DqTile<float, 64, 4, 1, 32>{});
  if (D <= 128) return f(DqTile<float, 128, 4, 2, 32>{});
  return f(DqTile<float, 256, 8, 2, 16>{});
}

template <typename C>
cudaError_t dkv_launch(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.S + C::BK - 1) / C::BK, a.H / a.G, a.B);
  return with_bias(a, [&](auto bias) {
    constexpr bool B = decltype(bias)::value;
    if constexpr (C::ELT == 2) return launch(flash_bwd_dkv_bf16<C, B>, grid, C::NT, C::SMEM, st, a);
    else return launch(flash_bwd_dkv_fp32<C, B>, grid, C::NT, C::SMEM, st, a);
  });
}

// The dK/dV tiles by dtype and padded head dim (warps, warps per 16 key
// rows, Q/dO rows).  bf16: 4 warps over 64 keys, 64-row Q tiles up to D =
// 128 (measured against its alternatives on an H100: PERF.md); at D =
// 256, 8 warps, two over each 16 keys, 32-row Q tiles.  fp32: 32-row Q
// tiles; 4 warps over 64 keys at D = 32, 8 over 128 at D = 64; at D =
// 128, 4 warps, two over each 16 keys (dK and dV in 64 registers); at D =
// 256, 8 warps, four over each 16 keys (196 KB).
template <typename F>
cudaError_t dkv_tiles(int dtype, int D, F&& f) {
  if (dtype == 1) {
    if (D <= 32) return f(DkvTile<bf16, 32, 4, 1, 64>{});
    if (D <= 64) return f(DkvTile<bf16, 64, 4, 1, 64>{});
    if (D <= 128) return f(DkvTile<bf16, 128, 4, 1, 64>{});
    return f(DkvTile<bf16, 256, 8, 2, 32>{});
  }
  if (D <= 32) return f(DkvTile<float, 32, 4, 1, 32>{});
  if (D <= 64) return f(DkvTile<float, 64, 8, 1, 32>{});
  if (D <= 128) return f(DkvTile<float, 128, 4, 2, 32>{});
  return f(DkvTile<float, 256, 8, 4, 32>{});
}

inline int bwd_entry(void* const ptrs[8], const void* lse, const void* delta,
                     const long long* strides, const void* bias,
                     const long long* bias_strides, int B, int H, int Hkv,
                     int S, int D, float scale, int causal, int window,
                     int dtype, void* stream, bool dkv) {
  Args a{};
  const int elt = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) ||
      !make_args(&a, ptrs, strides, B, H, Hkv, S, D, scale, causal, window,
                 elt))
    return int(cudaErrorInvalidValue);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  set_bias(&a, bias, bias_strides);
  if (dtype == 0)
    a.delta2 = static_cast<const float2*>(delta);
  else
    a.delta = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dkv) return int(dkv_tiles(dtype, D, [&](auto c) { return dkv_launch<decltype(c)>(a, st); }));
  return int(dq_tiles(dtype, D, [&](auto c) { return dq_launch<decltype(c)>(a, st); }));
}

}  // namespace fa

// q, k, v, out, dout: [B, S, H(kv), D] views given by `strides` (b, s, h
// of q, k, v, out, dout, dq in that order; d contiguous; every stride and D
// a multiple of one 16-byte vector); lse: (B * H, S) fp32; delta =
// rowsum(dO * O): (B * H, S) fp32 for bf16 inputs, and for fp32 inputs
// (B * H, S, 2) fp32, the fp64 sum as hi + lo.  dq: q's view.  out (the
// forward's output) is read by neither kernel; it stays in the
// interface.  bias, bias_strides: as flash_fwd's.  dtype: 0 fp32, 1 bf16.
// Returns the CUDA error code of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            const void* delta, void* dq,
                            const long long* strides, const void* bias,
                            const long long* bias_strides, int B, int H, int Hkv,
                            int S, int D, float scale, int causal, int window,
                            int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), const_cast<void*>(out),
                   const_cast<void*>(dout), dq, nullptr, nullptr};
  return fa::bwd_entry(ptrs, lse, delta, strides, bias, bias_strides, B, H,
                       Hkv, S, D, scale, causal, window, dtype, stream, false);
}

// As flash_bwd_dq without out, with the strides of q, k, v, dout, dk, dv;
// dk and dv are k's and v's views.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const long long* strides, const void* bias,
                             const long long* bias_strides, int B, int H, int Hkv,
                             int S, int D, float scale, int causal,
                             int window, int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), nullptr, const_cast<void*>(dout),
                   nullptr, dk, dv};
  return fa::bwd_entry(ptrs, lse, delta, strides, bias, bias_strides, B, H,
                       Hkv, S, D, scale, causal, window, dtype, stream, true);
}

// The dynamic shared memory, in bytes, that the dQ (dkv 0) or dK/dV (dkv
// 1) kernel asks for at head dim D and dtype (0 fp32, 1 bf16); ptxas -v
// reports static shared memory only.
extern "C" int flash_bwd_smem(int D, int dtype, int dkv) {
  int bytes = 0;
  auto get = [&](auto c) {
    bytes = int(decltype(c)::SMEM);
    return cudaSuccess;
  };
  if (dkv)
    fa::dkv_tiles(dtype, D, get);
  else
    fa::dq_tiles(dtype, D, get);
  return bytes;
}
