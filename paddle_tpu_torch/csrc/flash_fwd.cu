// Flash-attention forward for Hopper (sm_90a): out and the row logsumexp,
// fp32 or bf16 q/k/v, causal or not, sliding window, GQA, any layout
// given by strides (see flash_common.cuh).
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
// bf16 (flash_fwd_bf16): at the training shape the forward's bytes bound
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
// in natural log); alpha rescales O in registers; and P, rounded to bf16
// against the running max as in the reference, is the A operand of P.V
// directly (V's B fragments by ldmatrix.trans).  The epilogue stages the
// warp's rows through its own rows of the Q tile and writes them with
// 16-byte stores.  The head dim is padded at compile time to DP = 32, 64,
// 128 or 256 (zero columns past D, never stored).  At D = 128: 32-row K/V
// tiles, 128 registers a thread and no spill; on an H100, 8 warps, 64-row
// K/V tiles or a third stage measured slower (PERF.md).
//
// fp32 (flash_fwd_fp32_kernel): the shared-memory design of
// flash_common.cuh, 8 warps, fp32 FMAs, decision for decision the fp32
// reference.

#include "flash_common.cuh"

namespace fa {

struct FwdSmem {
  size_t q, k, v, s, p, o, m, l, alpha, total;
};

// Shared memory of the fp32 kernel: Q, K, V, S, P and O tiles, and m, l,
// alpha per row.
__host__ __device__ inline FwdSmem fwd_smem(int BQ, int BK, int DP) {
  Carve c;
  FwdSmem t;
  const int ldt = tile_ld(DP, 4), lds = tile_ld(BK, 4);
  t.q = c.take(size_t(BQ) * ldt * 4);
  t.k = c.take(size_t(BK) * ldt * 4);
  t.v = c.take(size_t(BK) * ldt * 4);
  t.s = c.take(size_t(BQ) * lds * 4);
  t.p = c.take(size_t(BQ) * lds * 4);
  t.o = c.take(size_t(BQ) * ldt * 4);
  t.m = c.take(size_t(BQ) * 4);
  t.l = c.take(size_t(BQ) * 4);
  t.alpha = c.take(size_t(BQ) * 4);
  t.total = c.off;
  return t;
}

__global__ void __launch_bounds__(kThreads) flash_fwd_fp32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int BQ = a.BQ, BK = a.BK, DP = a.DP;
  const int ld = tile_ld(DP, 4), lds = tile_ld(BK, 4);
  const FwdSmem L = fwd_smem(BQ, BK, DP);
  float* sq = reinterpret_cast<float*>(smem + L.q);
  float* sk = reinterpret_cast<float*>(smem + L.k);
  float* sv = reinterpret_cast<float*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* sp = reinterpret_cast<float*>(smem + L.p);
  float* so = reinterpret_cast<float*>(smem + L.o);
  float* sm = reinterpret_cast<float*>(smem + L.m);
  float* sl = reinterpret_cast<float*>(smem + L.l);
  float* salpha = reinterpret_cast<float*>(smem + L.alpha);

  const int q0 = qt * BQ;
  load_rows(sq, ld, slice<const float>(a.q, b, h), a.q.s, q0, BQ, a.S, a.D, DP);
  zero(so, BQ, DP, ld);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  const float* kb = slice<const float>(a.k, b, kvh);
  const float* vb = slice<const float>(a.v, b, kvh);
  int lo, hi;
  k_tiles(a, qt, &lo, &hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows(sk, ld, kb, a.k.s, j * BK, BK, a.S, a.D, DP);
    load_rows(sv, ld, vb, a.v.s, j * BK, BK, a.S, a.D, DP);
    __syncthreads();
    tile_mm<false, true>(ss, lds, sq, ld, sk, ld, BQ, BK, DP, false);
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
        sp[r * lds + c] = p;
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
      so[r * ld + (e - r * DP)] *= salpha[r];
    }
    __syncthreads();
    tile_mm<false, false>(so, ld, sp, lds, sv, ld, BQ, DP, BK, true);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) sl[r] = fmaxf(sl[r], 1e-30f);
  __syncthreads();
  store_rows(slice<float>(a.o, b, h), a.o.s, so, ld, sl, q0, BQ, a.S, a.D);
  float* lse = a.lse + (size_t(b) * a.H + h) * a.S;
  for (int r = threadIdx.x; r < BQ; r += blockDim.x)
    if (q0 + r < a.S) lse[q0 + r] = sm[r] + logf(sl[r]);
}

// Tiles of the bf16 forward: 4 warps of 16 query rows each, BK-row K/V
// tiles in a 2-stage ring.
template <int DP_, int BK_>
struct FwdTile {
  static constexpr int DP = DP_, NW = 4, BK = BK_, STAGES = 2;
  static constexpr int NT = 32 * NW, BQ = 16 * NW, LD = tile_ld(DP, 2);
  static constexpr int KD = DP / 16;  // k16 steps over d (S = Q.K^T)
  static constexpr int NS = BK / 8;   // n8 tiles of S
  static constexpr int NO = DP / 8;   // n8 tiles of O
  static constexpr size_t Q_BYTES = size_t(BQ) * LD * 2;
  static constexpr size_t KV_ELEMS = size_t(BK) * LD;  // one of K, V
  static constexpr size_t SMEM = Q_BYTES + size_t(STAGES) * 2 * KV_ELEMS * 2;
};

template <typename C>
__global__ void __launch_bounds__(C::NT) flash_fwd_bf16(Args a) {
  constexpr int LD = C::LD, BK = C::BK, STAGES = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = reinterpret_cast<bf16*>(smem + C::Q_BYTES);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * C::BQ, wr = warp * 16, r0 = q0 + wr;
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
    const bf16* sk = skv + size_t((j - lo) % STAGES) * 2 * C::KV_ELEMS;
    const bf16* sv = sk + C::KV_ELEMS;

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
        mma16816(s[n], qa, kf[0], kf[1]);
        mma16816(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    // scale (to base 2), and mask only where the warp's tile crosses an edge
    if (all_visible(a, r0, 16, k0, BK)) {
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    } else {
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = visible(a, r0 + (lane >> 2) + (e >> 1) * 8, k0 + n * 8 + 2 * (lane & 3) + (e & 1))
                        ? s[n][e] * scale2
                        : kNegInf;
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
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::NO; n += 2) {
        uint32_t vf[4];
        frag_b_cols<LD>(vf, sv, kk * 16, n * 8);
        mma16816(o[n], pa, vf[0], vf[1]);
        mma16816(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: out = O / max(l, 1e-30) through the warp's own Q rows, lse
  float* lse = a.lse + (size_t(b) * a.H + h) * a.S;
  bf16* stage = sq + wr * LD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int r = (lane >> 2) + hf * 8;
    if ((lane & 3) == 0 && r0 + r < a.S) lse[r0 + r] = m[hf] * kLn2 + logf(lt);
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      *reinterpret_cast<uint32_t*>(stage + r * LD + n * 8 + 2 * (lane & 3)) =
          pack_bf16(o[n][2 * hf] / lt, o[n][2 * hf + 1] / lt);
  }
  __syncwarp();
  bf16* ob = slice<bf16>(a.o, b, h);
  constexpr int VPR = C::DP / 8;
#pragma unroll
  for (int i = 0; i < 16 * VPR / 32; ++i) {
    const int e = lane + 32 * i, r = e / VPR, c = (e - r * VPR) * 8;
    if (r0 + r < a.S && c < a.D)
      *reinterpret_cast<uint4*>(ob + (r0 + r) * a.o.s + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

cudaError_t fwd_fp32(Args a, cudaStream_t st) {
  size_t smem = 0;
  const int DP = a.DP;
  const int t = pick_tile([&](int n) { return fwd_smem(n, n, DP).total; },
                          64, &smem);
  if (t == 0) return cudaErrorInvalidValue;
  a.BQ = a.BK = t;
  const dim3 grid((a.S + t - 1) / t, a.H, a.B);
  return launch(flash_fwd_fp32_kernel, grid, kThreads, smem, st, a);
}

template <typename C>
cudaError_t fwd_bf16(Args a, cudaStream_t st) {
  a.BQ = C::BQ;
  a.BK = C::BK;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  return launch(flash_fwd_bf16<C>, grid, C::NT, C::SMEM, st, a);
}

// The tiles by padded head dim: 64-row K/V tiles up to D = 64, 32-row
// above (measured against their alternatives on an H100: PERF.md).
cudaError_t fwd_bf16(Args a, cudaStream_t st) {
  if (a.D <= 32) return fwd_bf16<FwdTile<32, 64>>(a, st);
  if (a.D <= 64) return fwd_bf16<FwdTile<64, 64>>(a, st);
  if (a.D <= 128) return fwd_bf16<FwdTile<128, 32>>(a, st);
  return fwd_bf16<FwdTile<256, 32>>(a, st);
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
  return int(dtype == 1 ? fa::fwd_bf16(a, st) : fa::fwd_fp32(a, st));
}
