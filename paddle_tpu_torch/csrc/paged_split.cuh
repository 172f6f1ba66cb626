// Split-KV body of the paged decode and verify kernels for bf16 queries
// (paged_attention.cu, paged_attention_mq.cu), over bf16, int8 and packed
// int4 pages.
//
// Replaces, for bf16 queries, the page walk the TPU kernels of
// paddle_tpu/kernels/paged_attention.py run as a sequential grid axis
// (_page_recurrence, _mq_recurrence: m / l / acc carried in VMEM scratch
// from one page to the next).  On Hopper the blocks run in parallel and
// carry nothing between them, so the page axis is cut across blocks and
// merged (the flash-decoding shape):
//
// - Grid (Hkv * row groups, B, n_split).  The rows of one (slot, KV head)
//   are R = G * T: the G query heads of a GQA group times the T query
//   positions (1 for decode, the draft rows for verify), row r = (t = r /
//   G, head kvh * G + r % G), at query position lengths[b] + q_off + t
//   (q_off = -1 for decode, 0 for verify).  A block owns 16 of them (one
//   m16 tile; a row group) and one split: `pps` consecutive block-table
//   entries, intersected with the pages its rows can see (page_range).  A
//   split with no such page writes an empty partial (l = 0) and exits.
//   The plan (pps) is a function of host-known shapes only; `lengths`
//   stays on the device.
// - A block has four warps in NG lane groups: one warp each (D <= 128),
//   or two warps that share each tile and own half of O's columns each
//   (D <= 256: O in registers would not fit one warp).  Each group takes
//   every NG-th 32-key tile of the split (one tile is one page of the
//   engine's page size 32; a larger page is several tiles, a smaller one
//   a zero-padded tile) and runs its own online softmax over them, with no
//   block-wide barrier in the loop.  Each group streams its tiles through
//   its own ring of STAGES shared-memory stages filled by cp.async 16-byte
//   copies, as the pages are stored (bf16, int8 or packed int4, plus the
//   fp32 scales): tile i + 1 is in flight while tile i is computed on.
//   The split's block-table entries are read once, into shared memory.
//   A tile whose every key every row of the block sees skips the
//   per-element mask.
// - Both products are mma.sync m16n8k16 (bf16 operands, fp32
//   accumulation) on the fragment toolkit of flash_common.cuh: Q and K by
//   ldmatrix, V by ldmatrix.trans, and the S accumulator, exponentiated,
//   becomes P's A operand in registers.  O (16 rows x D) stays in
//   registers for the block's life.
// - Quantized pages are widened to bf16 in a per-group staging tile right
//   before their fragments load (int8 values and int4 nibbles are exact in
//   bf16: a byte-permute builds the fp32 2^23 + v, one subtraction gives v
//   and its upper half is the bf16), never to fp32.  The K scale of key j
//   multiplies score column j after Q.K^T, since q.(s_j k_j) = s_j
//   (q.k_j); the V scale of key j multiplies probability column j before
//   P.V, and the denominator sums the unscaled probabilities.
// - The groups' (m, l, O) merge in shared memory in group order.  With one
//   split the block normalises and writes the output; otherwise it
//   writes the unnormalised O and (m, l) (m in log2 units) to the
//   workspace the wrapper allocates, and merge_kernel combines the splits
//   by their lse, in split order.  No floating-point atomics: a call is
//   bit-for-bit repeatable.  The merge is a programmatic dependent launch:
//   it is scheduled once every split block has started and waits on the
//   device for their results, so its launch overlaps their tail.
//
// Bound on this card: HBM bytes.  A decode call reads each visible K and V
// position once (D * value bytes + scale bytes per head and side) and
// does ~4 flops per value read; the tensor cores take the products (R is
// padded to 16 rows, free under that bound) so that the threads spend
// their issue slots on the copies, the widening and the softmax.  With
// bf16 pages the copies bind (a block's 143 KB of rings leave one block
// per SM); with quantized pages the widening does, a warp's dependent
// chain of byte-permutes, stores and ldmatrix per tile (see PERF.md).

#pragma once

#include "flash_common.cuh"
#include "paged_common.cuh"

namespace ptt {
namespace split {

using fa::bf16;

constexpr int KT = 32;        // keys per tile
constexpr int STAGES = 2;     // ring depth per lane group
constexpr int NW = 4;         // warps per block
constexpr int NT = 32 * NW;
constexpr int ROWS = 16;      // query rows per block (one m16 tile)

// Shared-memory layout of a block: Q tile, then per lane group its ring
// of stages (and, for quantized pages, a bf16 staging tile), then the
// split's block-table entries.  After the tiles, the group area holds the
// merge.
template <int DP, int BITS>
struct Layout {
  static constexpr int DSPLIT = DP > 128 ? 2 : 1;         // warps per group
  static constexpr int NG = NW / DSPLIT;                  // lane groups
  static constexpr int GT = 32 * DSPLIT;                  // threads per group
  static constexpr int DPO = DP / DSPLIT;                 // O columns per warp
  static constexpr int LD = DP + 8;                       // bf16 tile row
  static constexpr int ROWB = BITS == 0 ? 2 * LD : DP * BITS / 8;
  static constexpr int TILEB = KT * ROWB;                 // K or V of a stage
  static constexpr int STAGEB = 2 * TILEB + (BITS ? 2 * KT * 4 : 0);
  static constexpr int STAGINGB = BITS ? KT * LD * 2 : 0;
  static constexpr int GROUPB = STAGES * STAGEB + STAGINGB;
  static constexpr int QB = ROWS * LD * 2;
  static constexpr int LDO = DP + 4;                      // merge rows, fp32
  static constexpr int MERGEB = NG * ROWS * (LDO + 2) * 4;
  static_assert(MERGEB <= NG * GROUPB, "the merge fits in the group area");
  static_assert(QB % 128 == 0 && STAGEB % 16 == 0 && TILEB % 16 == 0,
                "16-byte aligned sections");
  static size_t bytes(int pps) { return size_t(QB) + size_t(NG) * GROUPB + 4 * size_t(pps); }
};

struct Args {
  const bf16* q;            // (B, T, H, D)
  const void* k;            // pages (P, Hkv, ps, D or D / 2)
  const void* v;
  const float* ks;          // scales (P, Hkv, ps, 1); null for bf16 pages
  const float* vs;
  const int* table;         // (B, max_pages)
  const int* lengths;       // (B,)
  bf16* out;                // (B, T, H, D)
  float* ws_acc;            // (B, Hkv, n_split, R, D) unnormalised O
  float2* ws_ml;            // (B, Hkv, n_split, R): (m in log2 units, l)
  int T, q_off, H, Hkv, G, R, n_rg, ps, D, max_pages, num_pages, pps,
      n_split, window;
  float scale2;             // the softmax scale times log2(e)
};

// Issue the cp.async copies of one tile (keys [j0, j0 + valid) of page
// `page`, zeros past them and past D) into a stage; one lane group, `gt`
// the thread's index in it.
template <int DP, int BITS>
__device__ __forceinline__ void issue_tile(const Args& a, char* stage, int page, int j0,
                                           int valid, int kvh, int gt) {
  using L = Layout<DP, BITS>;
  const size_t row0 = (size_t(valid > 0 ? page : 0) * a.Hkv + kvh) * a.ps + j0;
  if constexpr (BITS == 0) {
    constexpr int VPR = DP / 8;
    const bf16* kg = static_cast<const bf16*>(a.k) + row0 * a.D;
    const bf16* vg = static_cast<const bf16*>(a.v) + row0 * a.D;
    bf16* kt = reinterpret_cast<bf16*>(stage);
    bf16* vt = reinterpret_cast<bf16*>(stage + L::TILEB);
#pragma unroll 4
    for (int i = 0; i < KT * VPR / L::GT; ++i) {
      const int e = gt + L::GT * i, r = e / VPR, c = (e % VPR) * 8;
      const bool ok = r < valid && c < a.D;
      const int off = ok ? r * a.D + c : 0;
      fa::cp_async16(kt + r * L::LD + c, kg + off, ok);
      fa::cp_async16(vt + r * L::LD + c, vg + off, ok);
    }
  } else {
    constexpr int VPR = DP * BITS / 8 / 16;
    const int rb = a.D * BITS / 8;                      // bytes of a stored row
    const char* kg = static_cast<const char*>(a.k) + row0 * rb;
    const char* vg = static_cast<const char*>(a.v) + row0 * rb;
#pragma unroll
    for (int i = 0; i < (KT * VPR + L::GT - 1) / L::GT; ++i) {
      const int e = gt + L::GT * i, r = e / VPR, c = (e % VPR) * 16;
      if (KT * VPR % L::GT == 0 || e < KT * VPR) {
        const bool ok = r < valid && c < rb;
        const int off = ok ? r * rb + c : 0;
        fa::cp_async16(stage + r * L::ROWB + c, kg + off, ok);
        fa::cp_async16(stage + L::TILEB + r * L::ROWB + c, vg + off, ok);
      }
    }
    float* sc = reinterpret_cast<float*>(stage + 2 * L::TILEB);
    if (gt < KT) {
      const bool ok = gt < valid;
      fa::cp_async4(sc + gt, ok ? a.ks + row0 + gt : a.ks, ok);
      fa::cp_async4(sc + KT + gt, ok ? a.vs + row0 + gt : a.vs, ok);
    }
  }
}

// bf16 bits of the integer v held exactly in the fp32 2^23 + v + bias.
__device__ __forceinline__ uint32_t widen_pair(uint32_t u, int i0, float bias) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i0)) - bias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + i0)) - bias;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Four biased bytes (each 128 + v, or 8 + v) as four bf16 values v.
__device__ __forceinline__ uint2 widen4(uint32_t u, float bias) {
  return make_uint2(widen_pair(u, 0, bias), widen_pair(u, 2, bias));
}

// A quantized K or V tile of a stage (rows of D * BITS / 8 bytes) widened
// to the group's bf16 staging tile [KT][LD] (columns past D stay zero).
template <int DP, int BITS>
__device__ __forceinline__ void widen_tile(bf16* dst, const char* raw, int D, int gt) {
  using L = Layout<DP, BITS>;
  constexpr int VPR = DP * BITS / 8 / 16;
  const int rb = D * BITS / 8;
#pragma unroll
  for (int i = 0; i < (KT * VPR + L::GT - 1) / L::GT; ++i) {
    const int e = gt + L::GT * i, r = e / VPR, c = (e % VPR) * 16;
    if ((KT * VPR % L::GT != 0 && e >= KT * VPR) || c >= rb) continue;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * L::ROWB + c);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    bf16* row = dst + r * L::LD;
    if constexpr (BITS == 8) {
      uint2 o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = widen4(x[k] ^ 0x80808080u, 8388736.f);
      *reinterpret_cast<uint4*>(row + c) = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
      *reinterpret_cast<uint4*>(row + c + 8) = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
    } else {
      // byte c of a row: d = c in its low nibble, d = c + D / 2 in its high
      uint2 lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo[k] = widen4((x[k] & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f);
        hi[k] = widen4(((x[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f);
      }
      *reinterpret_cast<uint4*>(row + c) = make_uint4(lo[0].x, lo[0].y, lo[1].x, lo[1].y);
      *reinterpret_cast<uint4*>(row + c + 8) = make_uint4(lo[2].x, lo[2].y, lo[3].x, lo[3].y);
      *reinterpret_cast<uint4*>(row + c + D / 2) =
          make_uint4(hi[0].x, hi[0].y, hi[1].x, hi[1].y);
      *reinterpret_cast<uint4*>(row + c + D / 2 + 8) =
          make_uint4(hi[2].x, hi[2].y, hi[3].x, hi[3].y);
    }
  }
}

// 2^x by the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Barrier of one lane group: its warp, or its two warps (named barrier
// 1 + group; __syncthreads takes barrier 0).
template <int DSPLIT>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (DSPLIT == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * DSPLIT) : "memory");
  }
}

// Offset of row r of slot b in q / out: (b, t = r / G, head kvh * G + r % G).
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int kvh, int r) {
  return ((size_t(b) * a.T + r / a.G) * a.H + size_t(kvh) * a.G + r % a.G) * a.D;
}

template <int DP, int BITS>
__global__ void __launch_bounds__(NT)
split_kernel(const Args a) {
  using L = Layout<DP, BITS>;
  constexpr int NG = L::NG, LD = L::LD, DPO = L::DPO;
  extern __shared__ __align__(128) char split_smem[];
  bf16* qs = reinterpret_cast<bf16*>(split_smem);
  char* groups = split_smem + L::QB;
  int* tbl = reinterpret_cast<int*>(groups + NG * L::GROUPB);

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kvh = blockIdx.x / a.n_rg, r0 = (blockIdx.x % a.n_rg) * ROWS;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int nr = min(ROWS, a.R - r0);
  const int len = a.lengths[b] + a.q_off;      // query position of t = 0
  const int q_first = len + r0 / a.G, q_last = len + (r0 + nr - 1) / a.G;
  int first, last;
  page_range(q_first, q_last, a.window, a.ps, a.max_pages, &first, &last);
  const int p0 = max(first, sp * a.pps), p1 = min(last, sp * a.pps + a.pps - 1);
  const size_t part = (size_t(b) * a.Hkv + kvh) * a.n_split + sp;
  if (p0 > p1) {                                // no visible page: empty
    for (int e = threadIdx.x; e < nr * a.D; e += NT) {
      const int r = r0 + e / a.D, d = e % a.D;
      if (a.n_split == 1)
        a.out[row_offset(a, b, kvh, r) + d] = __float2bfloat16(0.f);
      else if (d == 0)
        a.ws_ml[part * a.R + r] = make_float2(-INFINITY, 0.f);
    }
    return;
  }

  // the rows' queries (zero past row nr and column D), in flight while
  // the split's block-table entries load
  for (int e = threadIdx.x; e < ROWS * DP / 8; e += NT) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
    const bool ok = r < nr && c < a.D;
    fa::cp_async16(qs + r * LD + c, ok ? a.q + row_offset(a, b, kvh, r0 + r) + c : a.q, ok);
  }
  fa::cp_async_commit();
  for (int i = threadIdx.x; i <= p1 - p0; i += NT)
    tbl[i] = a.table[size_t(b) * a.max_pages + p0 + i];
  fa::cp_async_wait<0>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / L::DSPLIT, half = warp % L::DSPLIT;
  const int gt = threadIdx.x % L::GT;          // thread index in the group
  const int g = lane / 4, t4 = lane % 4;
  char* ring = groups + grp * L::GROUPB;
  bf16* staging = reinterpret_cast<bf16*>(ring + STAGES * L::STAGEB);
  if constexpr (BITS != 0) {
    for (int e = gt; e < L::STAGINGB / 16; e += L::GT)
      reinterpret_cast<uint4*>(staging)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // this group's tiles: every NG-th of the split's (page, 32-key chunk)s
  const int tpp = (a.ps + KT - 1) / KT;
  const int n_tiles = (p1 - p0 + 1) * tpp;
  const int mine = n_tiles > grp ? (n_tiles - grp + NG - 1) / NG : 0;
  auto tile = [&](int i, int* page, int* pg, int* j0) {
    const int ti = grp + i * NG;
    *pg = p0 + ti / tpp;
    *j0 = (ti % tpp) * KT;
    *page = tbl[*pg - p0];
    const bool ok = *page >= 0 && *page < a.num_pages;
    return ok ? min(KT, a.ps - *j0) : 0;        // keys of the tile
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine) {
      int page, pg, j0;
      const int valid = tile(s, &page, &pg, &j0);
      issue_tile<DP, BITS>(a, ring + s * L::STAGEB, page, j0, valid, kvh, gt);
    }
    fa::cp_async_commit();
  }

  // query positions of this lane's two rows (g and g + 8; padding rows
  // take the last real row's)
  const int qp_lo = len + (r0 + min(g, nr - 1)) / a.G;
  const int qp_hi = len + (r0 + min(g + 8, nr - 1)) / a.G;
  float o[DPO / 8][4];                          // columns half * DPO + ...
#pragma unroll
  for (int n = 0; n < DPO / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < mine; ++i) {
    const int nxt = i + STAGES - 1;
    if (nxt < mine) {
      int page, pg, j0;
      const int valid = tile(nxt, &page, &pg, &j0);
      issue_tile<DP, BITS>(a, ring + (nxt % STAGES) * L::STAGEB, page, j0, valid, kvh, gt);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    group_sync<L::DSPLIT>(grp);
    char* st = ring + (i % STAGES) * L::STAGEB;
    int page, pg, j0;
    const int valid = tile(i, &page, &pg, &j0);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILEB);
    const bf16* kt = reinterpret_cast<const bf16*>(st);
    const bf16* vt = reinterpret_cast<const bf16*>(st + L::TILEB);
    if constexpr (BITS != 0) {
      widen_tile<DP, BITS>(staging, st, a.D, gt);
      group_sync<L::DSPLIT>(grp);
      kt = staging;
    }

    // S = Q . K^T over the tile's 32 keys (four n8 tiles), all of D in
    // each warp of the group; the even and odd k16 steps in two chains of
    // accumulators, which the tensor cores overlap
    float s[4][4], s2[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; kk += 2) {
      uint32_t qa[4], qb[4], kb[4], kc[4];
      fa::frag_a<LD>(qa, qs, 0, kk * 16);
      fa::frag_a<LD>(qb, qs, 0, kk * 16 + 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        fa::frag_b_rows<LD>(kb, kt, np * 16, kk * 16);
        fa::frag_b_rows<LD>(kc, kt, np * 16, kk * 16 + 16);
        fa::mma16816(s[2 * np], qa, kb[0], kb[1]);
        fa::mma16816(s[2 * np + 1], qa, kb[2], kb[3]);
        fa::mma16816(s2[2 * np], qb, kc[0], kc[1]);
        fa::mma16816(s2[2 * np + 1], qb, kc[2], kc[3]);
      }
    }

    // scale (and K scales), mask, online softmax in log2 units.  A tile
    // whose every key is visible to every row of the block (all of the
    // interior of a long context) skips the per-element mask.
    const int pos0 = pg * a.ps + j0;
    const bool full = valid == KT && pos0 + KT - 1 <= q_first &&
                      (a.window <= 0 || pos0 > q_last - a.window);
    float cs[4][2];                              // score factor of a column
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        cs[n][c] = BITS != 0 ? a.scale2 * ksc[n * 8 + 2 * t4 + c] : a.scale2;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = (s[n][e] + s2[n][e]) * cs[n][e & 1];
      if (!full) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * t4 + (e & 1), pos = pos0 + j;
          const int qp = e < 2 ? qp_lo : qp_hi;
          const bool ok = j < valid && pos <= qp && (a.window <= 0 || pos > qp - a.window);
          s[n][e] = ok ? s[n][e] : -INFINITY;
        }
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;   // nothing seen yet
    const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float al_lo = fast_exp2(m_lo - mu_lo), al_hi = fast_exp2(m_hi - mu_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[n][0] = fast_exp2(s[n][0] - mu_lo);
      s[n][1] = fast_exp2(s[n][1] - mu_lo);
      s[n][2] = fast_exp2(s[n][2] - mu_hi);
      s[n][3] = fast_exp2(s[n][3] - mu_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * al_lo + sum_lo;                // this lane's columns
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < DPO / 8; ++n) {
      o[n][0] *= al_lo;
      o[n][1] *= al_lo;
      o[n][2] *= al_hi;
      o[n][3] *= al_hi;
    }

    if constexpr (BITS != 0) {
      const float* vsc = ksc + KT;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float v0 = vsc[n * 8 + 2 * t4], v1 = vsc[n * 8 + 2 * t4 + 1];
        s[n][0] *= v0;
        s[n][1] *= v1;
        s[n][2] *= v0;
        s[n][3] *= v1;
      }
      group_sync<L::DSPLIT>(grp);                // K's fragments are read
      widen_tile<DP, BITS>(staging, st + L::TILEB, a.D, gt);
      group_sync<L::DSPLIT>(grp);
      vt = staging;
    }

    // O += P . V over this warp's columns: the probabilities, rounded to
    // bf16, are the A operand
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      fa::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DPO / 16; ++dn) {
        uint32_t vb[4];
        fa::frag_b_cols<LD>(vb, vt, kk * 16, half * DPO + dn * 16);
        fa::mma16816(o[2 * dn], pa, vb[0], vb[1]);
        fa::mma16816(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    group_sync<L::DSPLIT>(grp);                  // the stage is free again
  }
  fa::cp_async_wait<0>();

  // merge the groups in shared memory, in group order
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  __syncthreads();
  float* ro = reinterpret_cast<float*>(groups);  // [NG][ROWS][LDO]
  float* rm = ro + NG * ROWS * L::LDO;           // [NG][ROWS]
  float* rl = rm + NG * ROWS;
#pragma unroll
  for (int n = 0; n < DPO / 8; ++n) {
    const int col = half * DPO + n * 8 + 2 * t4;
    *reinterpret_cast<float2*>(ro + (grp * ROWS + g) * L::LDO + col) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(ro + (grp * ROWS + g + 8) * L::LDO + col) =
        make_float2(o[n][2], o[n][3]);
  }
  if (t4 == 0 && half == 0) {
    rm[grp * ROWS + g] = m_lo;
    rm[grp * ROWS + g + 8] = m_hi;
    rl[grp * ROWS + g] = l_lo;
    rl[grp * ROWS + g + 8] = l_hi;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * a.D; e += NT) {
    const int r = e / a.D, d = e % a.D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NG; ++w)
      if (rl[w * ROWS + r] > 0.f) mx = fmaxf(mx, rm[w * ROWS + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NG; ++w) {
      if (rl[w * ROWS + r] > 0.f) {
        const float f = exp2f(rm[w * ROWS + r] - mx);
        l += rl[w * ROWS + r] * f;
        acc += ro[(w * ROWS + r) * L::LDO + d] * f;
      }
    }
    if (a.n_split == 1) {
      a.out[row_offset(a, b, kvh, r0 + r) + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
    } else {
      a.ws_acc[(part * a.R + r0 + r) * a.D + d] = acc;
      if (d == 0) a.ws_ml[part * a.R + r0 + r] = make_float2(mx, l);
    }
  }
}

// Combine the n_split partials of one row by their lse, in split order:
// out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s, M = max_s m_s, over
// the splits with l_s > 0 (an empty split wrote no O).  Grid (Hkv * R, B).
__global__ void __launch_bounds__(128) merge_kernel(const Args a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  const int r = blockIdx.x % a.R, kvh = blockIdx.x / a.R, b = blockIdx.y;
  const size_t base = (size_t(b) * a.Hkv + kvh) * a.n_split;
  float mx = -INFINITY;
  for (int s = 0; s < a.n_split; ++s) {
    const float2 ml = a.ws_ml[(base + s) * a.R + r];
    if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
  }
  float l = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const float2 ml = a.ws_ml[(base + s) * a.R + r];
    if (ml.y > 0.f) l += ml.y * exp2f(ml.x - mx);
  }
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float2 ml = a.ws_ml[(base + s) * a.R + r];
      if (ml.y > 0.f) acc += exp2f(ml.x - mx) * a.ws_acc[((base + s) * a.R + r) * a.D + d];
    }
    a.out[row_offset(a, b, kvh, r) + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
  }
}

// The host side has internal linkage: each library that includes this
// header keeps its own per-kernel attribute flags (a function-local
// static of an inline function is one object across every library loaded
// into the process).
namespace {

constexpr int kMaxDevices = 64;

// Let `kernel` take up to the current card's opt-in limit of dynamic
// shared memory.  Done once per kernel and card, at the first launch
// there, so that later launches (a CUDA-graph capture included) make no
// attribute call.
template <typename K>
inline cudaError_t allow_smem(K kernel, bool ready[kMaxDevices]) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  ready[dev] = err == cudaSuccess;
  return err;
}

template <int DP, int BITS>
cudaError_t launch_t(const Args& a, int B, cudaStream_t st) {
  using L = Layout<DP, BITS>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(split_kernel<DP, BITS>, ready);
  if (err != cudaSuccess) return err;
  split_kernel<DP, BITS><<<dim3(a.Hkv * a.n_rg, B, a.n_split), NT, L::bytes(a.pps), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  // the merge may launch as soon as every split block has started (its
  // blocks wait in griddepcontrol.wait for the split kernel's results),
  // which hides its launch behind the split kernel's last blocks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * a.R, B);
  cfg.blockDim = dim3(128);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, merge_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 64) return launch_t<64, BITS>(a, B, st);
  if (a.D <= 128) return launch_t<128, BITS>(a, B, st);
  if (a.D <= 256) return launch_t<256, BITS>(a, B, st);
  return cudaErrorInvalidValue;
}

// bf16 q / out (B, T, H, D), row t at position lengths[b] + q_off + t;
// `ws` holds B * Hkv * n_split * R * (D + 2) floats when n_split > 1.
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, const int* bt, const int* lens, void* out,
                          float* ws, int B, int T, int q_off, int H, int Hkv, int ps,
                          int D, int max_pages, int num_pages, int pps, float scale,
                          int window, int kv_bits, cudaStream_t st) {
  if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || ps < 1 || max_pages < 1 || pps < 1 ||
      D % 8 != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = k;
  a.v = v;
  a.ks = ks;
  a.vs = vs;
  a.table = bt;
  a.lengths = lens;
  a.out = static_cast<bf16*>(out);
  a.T = T;
  a.q_off = q_off;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.R = a.G * T;
  a.n_rg = (a.R + ROWS - 1) / ROWS;
  a.ps = ps;
  a.D = D;
  a.max_pages = max_pages;
  a.num_pages = num_pages;
  a.pps = min(pps, max_pages);
  a.n_split = (max_pages + a.pps - 1) / a.pps;
  a.window = window;
  a.scale2 = scale * fa::kLog2e;
  a.ws_acc = ws;
  a.ws_ml = reinterpret_cast<float2*>(
      ws ? ws + size_t(B) * Hkv * a.n_split * a.R * D : nullptr);
  if (a.n_split > 1 && ws == nullptr) return cudaErrorInvalidValue;
  switch (kv_bits) {
    case 0: return launch_bits<0>(a, B, st);
    case 8: return launch_bits<8>(a, B, st);
    case 4: return launch_bits<4>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace split
}  // namespace ptt
