// Flash-attention forward for Hopper (sm_90a): out and the row logsumexp,
// fp32, bf16 or fp16 q/k/v, causal or not (rows that see no key included),
// sliding window, GQA, any layout given by strides (see flash_common.cuh).
//
// Replaces the TPU kernel paddle_tpu/kernels/flash.py: _fwd_kernel, as
// launched by _fwd_call (bnsd) and _fwd_call_smajor (bsnd / sbnd, GQA).
// Both bodies compute the reference's recurrence: per k-tile s = Q.K^T *
// scale (-1e30 where masked), m_new = max(m, rowmax(s)), p = exp(s -
// m_new), alpha = exp(m - m_new), l = l * alpha + rowsum(p), O = O * alpha
// + P.V with P cast to V's dtype first; then out = O / max(l, 1e-30) in
// q's dtype and lse = m + log(max(l, 1e-30)) in fp32, one row per (b * H +
// h).  Grid: (query tiles, query heads, batch), the heaviest causal tiles
// (largest row index) issued first.
//
// bf16 and fp16 (flash_fwd_16, one body; fp16 swaps the mma's operand
// type and the roundings): at the training shape the forward's bytes bound
// it (0.045 ms for 4 operands against 0.039 ms of tensor-core work), so
// the design reads every operand once per query tile and keeps all
// intermediate state on chip.  A block of 4 warps owns 64 query rows,
// each warp 16 of them.  The Q tile arrives once by cp.async; a warp
// reloads its A fragments by ldmatrix at each step (held in registers
// instead, they cost 4-39 registers a thread and gained nothing
// measurable on an H100 at D = 32, 64 or 128).  K and V stream through a
// 2-stage ring of BK-row shared-memory tiles filled by cp.async (tile
// j + 1 in flight while tile j is computed on).
// S = Q.K^T accumulates in registers (K's B fragments by ldmatrix); the
// online softmax runs in registers (a row's values sit in the 4 lanes of
// a quad: two shuffles reduce them; l is kept per lane and summed once at
// the end; exp2 with log2(e) folded into the scale, lse = m ln 2 + log l
// in natural log); alpha rescales O in registers; and P, rounded to T
// against the running max as in the reference, is the A operand of P.V
// directly (V's B fragments by ldmatrix.trans).  The epilogue stages the
// warp's rows through its own rows of the Q tile and writes them with
// 16-byte stores.  The head dim is padded at compile time to DP = 32, 64,
// 128 or 256 (zero columns past D, never stored).  At D = 128: 32-row K/V
// tiles, 128 registers a thread and no spill; on an H100, 8 warps, 64-row
// K/V tiles or a third stage measured slower (PERF.md).
//
// fp32 (flash_fwd_fp32): at BERT-base's attention (B*H = 384, S = 512,
// D = 64, not causal) its 4 B*H*S^2*D flops take 0.385 ms at the card's
// 67 TFLOP/s of fp32 FMAs and 0.156 ms as three TF32 products each at 495
// TFLOP/s, against 0.06 ms of bytes: operations bound it.  So it is the
// 16-bit body above with fp32 tiles (row pitch DP + 4 floats) in the same
// cp.async ring and every product on mma.sync m16n8k8 in 3xTF32
// (flash_common.cuh's toolkit): S = Q.K^T and the online softmax in
// registers, P in fp32 (V's dtype, as the reference) the A operand of O
// += P.V through tf32_acc_a's permuted k order (V's B fragments by
// tf32_b_cols), each k8 step's products in a fresh partial that an fp32
// add takes into O, and O stored from registers as float2.  V is split in
// three parts and P.V takes four products (mma_4xtf32): a query that sees
// one key then gets that key's v to the last bit, as the plain version
// does, and the backward, whose delta comes from this out, finds dp -
// delta = 0 there (with two parts, 2^-22 of v was left, and the ring's
// fp32 dQ of such a query missed FLASH_TOL on the card).  What
// limits it is instructions beside the tensor cores: each fp32 operand
// value split into hi and lo (five integer and float operations), each
// step's partial added to its accumulator.  Three choices cut them, each
// a template argument of the tiles (FwdTile32) timed on an H100: a warp
// owns two m16 tiles where its registers allow (D <= 64), so that each
// K or V fragment, loaded and split once, feeds two products; the block
// splits each K/V tile once (split_rows) instead of every warp splitting
// its fragments; and Q is split once into hi and lo tiles where that
// left it faster (D = 32, 128).

#include "flash_common.cuh"

namespace fa {

// Tiles of the 16-bit forward (elements of T, bf16 or fp16): 4 warps of
// 16 query rows each, BK-row K/V tiles in a 2-stage ring.
template <typename T_, int DP_, int BK_>
struct FwdTile {
  using T = T_;
  static constexpr int DP = DP_, NW = 4, BK = BK_, STAGES = 2;
  static constexpr int NT = 32 * NW, BQ = 16 * NW, LD = tile_ld(DP, 2);
  static constexpr int KD = DP / 16;  // k16 steps over d (S = Q.K^T)
  static constexpr int NS = BK / 8;   // n8 tiles of S
  static constexpr int NO = DP / 8;   // n8 tiles of O
  static constexpr size_t Q_BYTES = size_t(BQ) * LD * 2;
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;  // one of K, V
  static constexpr size_t SMEM = Q_BYTES + size_t(STAGES) * 2 * KV_ELEMS * 2;
};

template <typename C, bool BIAS>
__global__ void __launch_bounds__(C::NT) flash_fwd_16(Args a) {
  using T = typename C::T;
  constexpr int LD = C::LD, BK = C::BK, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* skv = reinterpret_cast<T*>(smem + C::Q_BYTES);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * C::BQ, wr = warp * 16, r0 = q0 + wr;
  const T* kb = slice<const T>(a.k, b, kvh);
  const T* vb = slice<const T>(a.v, b, kvh);
  [[maybe_unused]] const float* bs = BIAS ? bias_slice(a, b, h) : nullptr;
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);

  auto load_kv = [&](int j) {
    T* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    cp_rows<BK, C::DP, C::NT>(sk, kb, a.k.s, j * BK, a.Sk, a.D);
    cp_rows<BK, C::DP, C::NT>(sk + C::KV_ELEMS, vb, a.v.s, j * BK, a.Sk, a.D);
  };
  cp_rows<C::BQ, C::DP, C::NT>(sq, slice<const T>(a.q, b, h), a.q.s, q0, a.Sq, a.D);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (lo + s < hi) load_kv(lo + s);
    cp_async_commit();
  }

  float o[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max (base 2: of s * log2(e)) and per-lane sum, rows g, g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    __syncthreads();              // ... for every thread; tile j - 1 is consumed
    if (j + STAGES - 1 < hi) load_kv(j + STAGES - 1);
    cp_async_commit();
    const int k0 = j * BK;
    if (none_visible(a, r0, 16, k0, BK)) continue;
    const T* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    const T* sv = sk + C::KV_ELEMS;
    const bool edge = !all_visible(a, r0, 16, k0, BK);
    // the tile's bias, its loads in flight during the product below
    [[maybe_unused]] float bv[C::NS][4];
    if constexpr (BIAS)
      load_bias<C::NS>(bv, a, edge, [&](int n, int e, int* qi, int* kj) {
        *qi = r0 + (lane >> 2) + (e >> 1) * 8;
        *kj = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        return bs;
      });

    // S = Q.K^T
    float s[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      uint32_t qa[4];
      frag_a<LD>(qa, sq, wr, kk * 16);
#pragma unroll
      for (int n = 0; n < C::NS; n += 2) {
        uint32_t kf[4];
        frag_b_rows<LD>(kf, sk, n * 8, kk * 16);
        mma16816<T>(s[n], qa, kf[0], kf[1]);
        mma16816<T>(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    // scale (to base 2), add the bias, and mask only where the warp's
    // tile crosses an edge (a row that sees no key takes the fill)
    if (!edge) {
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale2;
          if constexpr (BIAS) s[n][e] += kLog2e * bv[n][e];
        }
    } else {
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = r0 + (lane >> 2) + (e >> 1) * 8, kj = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          float bias = 0.f;
          if constexpr (BIAS) bias = bv[n][e];
          if (visible(a, qi, kj)) s[n][e] = s[n][e] * scale2 + kLog2e * bias;
          else if (qi < a.nokey && kj < a.Sk) s[n][e] = kLog2e * fill_logit<T>(bias);
          else s[n][e] = kNegInf;
        }
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < C::NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hf], s[n][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx), alpha = exp2f(m[hf] - m_new);
      m[hf] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - m_new);
          sum += s[n][e];
        }
      l[hf] = l[hf] * alpha + sum;
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        o[n][2 * hf] *= alpha;
        o[n][2 * hf + 1] *= alpha;
      }
    }

    // O += P.V, P from the S accumulator
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::NO; n += 2) {
        uint32_t vf[4];
        frag_b_cols<LD>(vf, sv, kk * 16, n * 8);
        mma16816<T>(o[n], pa, vf[0], vf[1]);
        mma16816<T>(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: out = O / max(l, 1e-30) through the warp's own Q rows, lse
  float* lse = a.lse + (size_t(b) * a.H + h) * a.Sq;
  T* stage = sq + wr * LD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int r = (lane >> 2) + hf * 8;
    if ((lane & 3) == 0 && r0 + r < a.Sq) lse[r0 + r] = m[hf] * kLn2 + logf(lt);
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      *reinterpret_cast<uint32_t*>(stage + r * LD + n * 8 + 2 * (lane & 3)) =
          pack2<T>(o[n][2 * hf] / lt, o[n][2 * hf + 1] / lt);
  }
  __syncwarp();
  T* ob = slice<T>(a.o, b, h);
  constexpr int VPR = C::DP / 8;
#pragma unroll
  for (int i = 0; i < 16 * VPR / 32; ++i) {
    const int e = lane + 32 * i, r = e / VPR, c = (e - r * VPR) * 8;
    if (r0 + r < a.Sq && c < a.D)
      *reinterpret_cast<uint4*>(ob + (r0 + r) * a.o.s + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// Where the fp32 forward splits Q into TF32 hi and lo: at every k8 step
// from the fp32 tile (as the backward kernels do), or once into hi and lo
// shared-memory tiles.
enum QSplit { kQEachStep, kQShared };

// Tiles of the fp32 forward: NW warps of MW m16 tiles (16 MW query rows)
// each, BK-row K/V tiles in a 2-stage ring; Q split as QSPLIT says;
// KVSPLIT: each K/V tile split once into hi (in place) and lo tiles (V:
// mid and lo) by the whole block, instead of each warp splitting its
// fragments.  A warp with MW = 2 loads and splits each B fragment once
// for two m16 tiles.
template <int DP_, int NW_, int MW_, int BK_, QSplit QSPLIT_, bool KVSPLIT_>
struct FwdTile32 {
  static constexpr int DP = DP_, NW = NW_, MW = MW_, BK = BK_, STAGES = 2;
  static constexpr QSplit QSPLIT = QSPLIT_;
  static constexpr bool KVSPLIT = KVSPLIT_;
  static constexpr int NT = 32 * NW, WR = 16 * MW, BQ = WR * NW, LD = tile_ld(DP, 4);
  static constexpr int KD = DP / 8;  // k8 steps over d (S = Q.K^T)
  static constexpr int NS = BK / 8;  // n8 tiles of S, k8 steps of P.V
  static constexpr int NO = DP / 8;  // n8 tiles of O
  static constexpr size_t Q_ELEMS = size_t(BQ) * LD;
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;  // one of K, V
  static constexpr size_t Q_TILES = QSPLIT == kQShared ? 2 : 1;
  static constexpr size_t KV_TILES = 2 * STAGES + (KVSPLIT ? 3 : 0);
  static constexpr size_t SMEM = (Q_TILES * Q_ELEMS + KV_TILES * KV_ELEMS) * 4;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

// One block an SM stated: ptxas then gives the body up to 255 registers a
// thread, and the dispatch's tiles ran as fast or faster so on an H100
// than with the count ptxas picks without it, or with room left for 3-4
// blocks an SM.
template <typename C, bool BIAS>
__global__ void __launch_bounds__(C::NT, 1) flash_fwd_fp32(Args a) {
  constexpr int LD = C::LD, BK = C::BK, STAGES = C::STAGES, MW = C::MW;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sql = sq + C::Q_ELEMS;                          // Q's lo (kQShared)
  float* skv = sq + C::Q_TILES * C::Q_ELEMS;             // the ring
  float* skvl = skv + size_t(STAGES) * 2 * C::KV_ELEMS;  // K's lo, V's mid, lo (KVSPLIT)
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * C::BQ, wr = warp * C::WR, r0 = q0 + wr;
  const float* kb = slice<const float>(a.k, b, kvh);
  const float* vb = slice<const float>(a.v, b, kvh);
  [[maybe_unused]] const float* bs = BIAS ? bias_slice(a, b, h) : nullptr;
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);

  auto load_kv = [&](int j) {
    float* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    cp_rows<BK, C::DP, C::NT>(sk, kb, a.k.s, j * BK, a.Sk, a.D);
    cp_rows<BK, C::DP, C::NT>(sk + C::KV_ELEMS, vb, a.v.s, j * BK, a.Sk, a.D);
  };
  cp_rows<C::BQ, C::DP, C::NT>(sq, slice<const float>(a.q, b, h), a.q.s, q0, a.Sq, a.D);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (lo + s < hi) load_kv(lo + s);
    cp_async_commit();
  }

  // Q split once into hi and lo tiles, where the tiles say so
  if constexpr (C::QSPLIT == kQShared) {
    cp_async_wait<STAGES - 1>();  // Q has landed
    __syncthreads();              // ... for every thread
    split_rows<C::WR, C::DP, 32, 2>(sq + wr * LD, sql + wr * LD, nullptr, lane);  // own rows
    __syncwarp();
  }

  float o[MW][C::NO][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < C::NO; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
  // running max (base 2: of s * log2(e)) and per-lane sum, rows g, g + 8
  // of each m16 tile
  float m[MW][2], l[MW][2];
#pragma unroll
  for (int i = 0; i < MW; ++i) m[i][0] = m[i][1] = kNegInf, l[i][0] = l[i][1] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    __syncthreads();              // ... for every thread; tile j - 1 is consumed
    if (j + STAGES - 1 < hi) load_kv(j + STAGES - 1);
    cp_async_commit();
    float* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    float* sv = sk + C::KV_ELEMS;
    if constexpr (C::KVSPLIT) {
      split_rows<BK, C::DP, C::NT, 2>(sk, skvl, nullptr, threadIdx.x);
      split_rows<BK, C::DP, C::NT, 3>(sv, skvl + C::KV_ELEMS, skvl + 2 * C::KV_ELEMS,
                                      threadIdx.x);
      __syncthreads();
    }
    const int k0 = j * BK;
    if (none_visible(a, r0, C::WR, k0, BK)) continue;
    const auto kf = [&] {
      if constexpr (C::KVSPLIT) return SplitTile{sk, skvl};
      else return static_cast<const float*>(sk);
    }();
    const auto vf = [&] {
      if constexpr (C::KVSPLIT) return SplitTile3{sv, skvl + C::KV_ELEMS, skvl + 2 * C::KV_ELEMS};
      else return static_cast<const float*>(sv);
    }();

    // S = Q.K^T, each B fragment for all MW m16 tiles
    float s[MW][C::NS][4];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int n = 0; n < C::NS; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      Tf32A qa[MW];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        if constexpr (C::QSPLIT == kQShared)
          qa[i] = tf32_a<LD>(SplitTile{sq, sql}, wr + 16 * i, kk * 8);
        else qa[i] = tf32_a<LD>(sq, wr + 16 * i, kk * 8);
      }
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        const Tf32B kb8 = tf32_b_rows<LD>(kf, n * 8, kk * 8);
#pragma unroll
        for (int i = 0; i < MW; ++i) mma_3xtf32(s[i][n], qa[i], kb8);
      }
    }

#pragma unroll
    for (int i = 0; i < MW; ++i) {
      const int ri = r0 + 16 * i;
      // scale (to base 2), add the bias, and mask only where the m16 tile
      // crosses an edge
      if (all_visible(a, ri, 16, k0, BK)) {
#pragma unroll
        for (int n = 0; n < C::NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[i][n][e] *= scale2;
            if constexpr (BIAS)
              s[i][n][e] += bias2(a, bs, ri + (lane >> 2) + (e >> 1) * 8,
                                  k0 + n * 8 + 2 * (lane & 3) + (e & 1));
          }
      } else {
#pragma unroll
        for (int n = 0; n < C::NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = ri + (lane >> 2) + (e >> 1) * 8, kj = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
            if (visible(a, qi, kj)) {
              s[i][n][e] *= scale2;
              if constexpr (BIAS) s[i][n][e] += bias2(a, bs, qi, kj);
            } else if (qi < a.nokey && kj < a.Sk) {
              float bias = 0.f;
              if constexpr (BIAS) bias = bias_e(a, bs, qi, kj);
              s[i][n][e] = kLog2e * fill_logit<float>(bias);
            } else {
              s[i][n][e] = kNegInf;
            }
          }
      }

      // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < C::NS; ++n) mx = fmaxf(mx, fmaxf(s[i][n][2 * hf], s[i][n][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i][hf], mx), alpha = exp2f(m[i][hf] - m_new);
        m[i][hf] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < C::NS; ++n)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            s[i][n][e] = exp2f(s[i][n][e] - m_new);
            sum += s[i][n][e];
          }
        l[i][hf] = l[i][hf] * alpha + sum;
#pragma unroll
        for (int n = 0; n < C::NO; ++n) {
          o[i][n][2 * hf] *= alpha;
          o[i][n][2 * hf + 1] *= alpha;
        }
      }
    }

    // O += P.V: P (fp32, V's dtype) from the S accumulator, tile kk the A
    // operand of k8 step kk; V in three parts (mma_4xtf32: a query whose
    // probability sits on one key gets its v exactly, as the plain
    // version's, so that the backward's dp - delta cancels to 0 there);
    // each B fragment for all MW m16 tiles
#pragma unroll
    for (int kk = 0; kk < C::NS; ++kk) {
      Tf32A pa[MW];
#pragma unroll
      for (int i = 0; i < MW; ++i) pa[i] = tf32_acc_a(s[i][kk]);
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        const Tf32B3 vb8 = tf32_b_cols3<LD>(vf, kk * 8, n * 8);
#pragma unroll
        for (int i = 0; i < MW; ++i) mma_4xtf32(o[i][n], pa[i], vb8);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: out = O / max(l, 1e-30) from registers, and lse
  float* lse = a.lse + (size_t(b) * a.H + h) * a.Sq;
  float* ob = slice<float>(a.o, b, h);
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[i][hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt = fmaxf(lt, 1e-30f);
      const int r = r0 + 16 * i + (lane >> 2) + hf * 8;
      if (r >= a.Sq) continue;
      if ((lane & 3) == 0) lse[r] = m[i][hf] * kLn2 + logf(lt);
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        const int c = n * 8 + 2 * (lane & 3);
        if (c < a.D)
          *reinterpret_cast<float2*>(ob + r * a.o.s + c) =
              make_float2(o[i][n][2 * hf] / lt, o[i][n][2 * hf + 1] / lt);
      }
    }
}

template <typename C>
cudaError_t fwd_fp32(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, a.B);
  return with_bias(a, [&](auto bias) {
    return launch(flash_fwd_fp32<C, decltype(bias)::value>, grid, C::NT, C::SMEM, st, a);
  });
}

// The tiles by padded head dim (warps, m16 tiles a warp, K/V rows, Q
// split, K/V split): D = 64 and 128 the fastest of their variants on an
// H100 at BERT-base's attention and at causal S = 512 and 1024 (PERF.md);
// D = 32 and 256 timed on no shape that a path of the port runs.
cudaError_t fwd_fp32(Args a, cudaStream_t st) {
  if (a.D <= 32) return fwd_fp32<FwdTile32<32, 4, 2, 32, kQShared, true>>(a, st);
  if (a.D <= 64) return fwd_fp32<FwdTile32<64, 8, 2, 32, kQEachStep, true>>(a, st);
  if (a.D <= 128) return fwd_fp32<FwdTile32<128, 4, 1, 16, kQShared, false>>(a, st);
  return fwd_fp32<FwdTile32<256, 8, 1, 16, kQEachStep, false>>(a, st);
}

template <typename C>
cudaError_t fwd_16_tiles(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, a.B);
  return with_bias(a, [&](auto bias) {
    return launch(flash_fwd_16<C, decltype(bias)::value>, grid, C::NT, C::SMEM, st, a);
  });
}

// The tiles by padded head dim, bf16 and fp16 alike: 64-row K/V tiles up
// to D = 64, 32-row above (measured against their alternatives on an
// H100 in bf16: PERF.md).
template <typename T>
cudaError_t fwd_16(Args a, cudaStream_t st) {
  if (a.D <= 32) return fwd_16_tiles<FwdTile<T, 32, 64>>(a, st);
  if (a.D <= 64) return fwd_16_tiles<FwdTile<T, 64, 64>>(a, st);
  if (a.D <= 128) return fwd_16_tiles<FwdTile<T, 128, 32>>(a, st);
  return fwd_16_tiles<FwdTile<T, 256, 32>>(a, st);
}

}  // namespace fa

// q, k, v: [B, S, H(kv), D] views given by `strides` (b, s, h of q, k, v,
// out in that order; d contiguous; every stride and D a multiple of one
// 16-byte vector); q has Sq rows, k and v Sk.  out: q's view; lse: (B *
// H, Sq) fp32.  bias: null, or an fp32 score bias of [B, H, Sq, Sk] read
// through bias_strides (b, h, q, k; 0 broadcasts).  window <= 0: none.
// dtype: 0 fp32, 1 bf16, 2 fp16.  Causal rows that see no key (Sq > Sk)
// add the bias to the reference's fill: a boolean mask's bias is 0 in
// those rows.  Returns the CUDA error code of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, const long long* strides,
                         const void* bias, const long long* bias_strides,
                         int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                         int causal, int window, int dtype, void* stream) {
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), out, nullptr, nullptr, nullptr,
                   nullptr};
  fa::Args a{};
  const int elt = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 ||
      !fa::make_args(&a, ptrs, strides, B, H, Hkv, Sq, Sk, D, scale, causal,
                     window, elt))
    return int(cudaErrorInvalidValue);
  a.lse = static_cast<float*>(lse);
  fa::set_bias(&a, bias, bias_strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return int(fa::fwd_16<fa::bf16>(a, st));
  if (dtype == 2) return int(fa::fwd_16<fa::f16>(a, st));
  return int(fa::fwd_fp32(a, st));
}
