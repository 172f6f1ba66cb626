// Split-KV body of the paged attention kernels for 16-bit queries (bf16
// or fp16, the element type T of every template below): decode
// (paged_attention.cu), multi-query verify (paged_attention_mq.cu) and
// chunk prefill (paged_prefill.cu), over float pages of q's type, int8
// and packed int4 pages.
//
// Replaces, for 16-bit queries, the page walk the TPU kernels of
// paddle_tpu/kernels/paged_attention.py and paged_prefill.py run as a
// sequential grid axis (_page_recurrence, _mq_recurrence,
// _chunk_recurrence: m / l / acc carried in VMEM scratch from one page to
// the next).  On Hopper the blocks run in parallel and carry nothing
// between them, so the page axis is cut across blocks and merged (the
// flash-decoding shape):
//
// - Grid (Hkv * row groups, B, n_split).  The rows of one (slot, KV head)
//   are R = G * T: the G query heads of a GQA group times the T query
//   positions (1 for decode, the draft rows for verify, the chunk's C rows
//   for prefill), row r = (t = r / G, head kvh * G + r % G), at query
//   position base + t, base = lengths[b] + q_off (q_off = -1 for decode, 0
//   for verify) or, for prefill, the chunk's start (no lengths).  A block
//   owns ROWS of them (a row group) and one split: `pps` consecutive
//   block-table entries, intersected with the pages its rows can see
//   (page_range).  A block whose split holds no such page exits at once
//   (the merge reads, for each row, only the splits that hold a page the
//   row sees).  The plan (pps) is a function of host-known shapes only;
//   `lengths` stays on the device and `start` is an argument.
// - A block has four warps in NG lane groups: one warp each (D <= 128),
//   or two warps that share each tile and own half of O's columns each
//   (D <= 256: O in registers would not fit one warp).  Two ways to use
//   them, a template parameter:
//   - tile split (decode, verify: R <= 8 G rows): the block owns one m16
//     tile of rows (ROWS = 16) and each group takes every NG-th 32-key
//     tile of the split (one tile is one page of the engine's page size
//     32; a larger page is several tiles, a smaller one a zero-padded
//     tile) through its own ring of STAGES shared-memory stages, with its
//     own online softmax and no block-wide barrier in the loop; the groups
//     merge in shared memory at the end;
//   - row split (prefill: R = G * C rows, up to 128 G): each group owns an
//     m16 tile of its own (ROWS = 16 NG) and every group runs over every
//     tile of the split, which the whole block streams through one ring,
//     so that a tile is read once for 16 NG rows; each group writes its own
//     rows.
//   A ring is filled by cp.async 16-byte copies as the pages are stored
//   (T, int8 or packed int4, plus the fp32 scales): tile i + 1 is in
//   flight while tile i is computed on.  The split's block-table entries
//   are read once, into shared memory.  A tile whose every key every row
//   of the group sees skips the per-element mask; a tile none of them sees
//   is skipped.
// - Both products are mma.sync m16n8k16 (T operands, fp32 accumulation)
//   on the fragment toolkit of flash_common.cuh: Q and K by ldmatrix, V by
//   ldmatrix.trans, and the S accumulator, exponentiated and rounded to T
//   (the reference casts the probabilities to V's type before P.V), becomes
//   P's A operand in registers.  O (16 rows x D) stays in registers for
//   the block's life.
// - Quantized pages are widened to T in a staging tile of the ring right
//   before their fragments load, never to fp32.  int8 values and int4
//   nibbles are exact in both types, and a byte-permute puts each biased
//   byte b = v + bias (128 or 8) into the mantissa of a float that one
//   subtraction turns into v: for bf16 the fp32 2^23 + b, whose upper half
//   is then the bf16 v; for fp16 two fp16 1024 + b at once (0x64 over the
//   byte: the mantissa's unit at 2^10 is 1), minus 1024 + bias by one
//   __hsub2.
//   The K scale of key j multiplies score column j after Q.K^T, since
//   q.(s_j k_j) = s_j (q.k_j); the V scale of key j multiplies probability
//   column j before P.V, and the denominator sums the unscaled
//   probabilities.
// - Tile split: the groups' (m, l, O) merge in shared memory in group
//   order.  A row whose visible pages all lie in the block's split (every
//   row, with one split) is normalised and written by the block (row
//   split: by its group); for the other rows the block writes the
//   unnormalised O and (m, l) (m in log2 units) to the workspace the
//   wrapper allocates, and merge_kernel combines their splits by their
//   lse, in split order.  No floating-point atomics: a call is bit-for-bit
//   repeatable.  The merge is a programmatic dependent launch: it is
//   scheduled once every split block has started, works out each row's
//   splits from the inputs, and only then waits on the device for the
//   partials, so its launch overlaps their tail.
//
// Bound on this card: HBM bytes.  A decode call reads each visible K and V
// position once (D * value bytes + scale bytes per head and side) and
// does ~4 flops per value read; the tensor cores take the products (R is
// padded to 16 rows, free under that bound) so that the threads spend
// their issue slots on the copies, the widening and the softmax.  With
// 16-bit pages the copies bind (a block's 143 KB of rings leave one block
// per SM); with quantized pages the widening does, a warp's dependent
// chain of byte-permutes, stores and ldmatrix per tile (see PERF.md).  A
// prefill chunk reads its slot's (start + C) visible positions and does
// ~4 C G flops per value read, which the tensor cores take; at the
// engine's chunk of 128 its bytes take ~1 us, so its time is latency: the
// row split reads each tile once for 16 NG rows, the prefill plan
// (kernels/paged_prefill.py) spreads the chunk's pages over enough splits
// to fill the card, and quantized K and V widen together, one block
// barrier apart.

#pragma once

#include "flash_common.cuh"
#include "paged_common.cuh"

namespace ptt {
namespace split {

using fa::bf16;
using fa::f16;

constexpr int KT = 32;        // keys per tile
constexpr int STAGES = 2;     // ring depth
constexpr int NW = 4;         // warps per block
constexpr int NT = 32 * NW;

// Shared-memory layout of a block: Q tile, then its rings of stages (one
// per lane group for a tile split, one for a row split; for quantized
// pages each with a 16-bit staging tile), then the split's block-table
// entries.  After the tiles, the ring area of a tile split holds the merge.
template <int DP, int BITS, bool RS>
struct Layout {
  static constexpr int DSPLIT = DP > 128 ? 2 : 1;         // warps per group
  static constexpr int NG = NW / DSPLIT;                  // lane groups
  static constexpr int GT = 32 * DSPLIT;                  // threads per group
  static constexpr int DPO = DP / DSPLIT;                 // O columns per warp
  static constexpr int ROWS = RS ? 16 * NG : 16;          // query rows per block
  static constexpr int RINGS = RS ? 1 : NG;
  static constexpr int RT = RS ? NT : GT;                 // threads per ring
  static constexpr int LD = DP + 8;                       // 16-bit tile row
  static constexpr int ROWB = BITS == 0 ? 2 * LD : DP * BITS / 8;
  static constexpr int TILEB = KT * ROWB;                 // K or V of a stage
  static constexpr int STAGEB = 2 * TILEB + (BITS ? 2 * KT * 4 : 0);
  // 16-bit staging of quantized pages: K, then V in one tile (tile split),
  // or K and V side by side (row split, where a block barrier is dearer)
  static constexpr int STAGINGB = BITS ? (RS ? 2 : 1) * KT * LD * 2 : 0;
  static constexpr int RINGB = STAGES * STAGEB + STAGINGB;
  static constexpr int QB = ROWS * LD * 2;
  static constexpr int LDO = DP + 4;                      // merge rows, fp32
  static constexpr int MERGEB = RS ? 0 : NG * ROWS * (LDO + 2) * 4 + ROWS * 4;
  static_assert(MERGEB <= RINGS * RINGB, "the merge fits in the ring area");
  static_assert(QB % 128 == 0 && STAGEB % 16 == 0 && TILEB % 16 == 0,
                "16-byte aligned sections");
  static size_t bytes(int pps) { return size_t(QB) + size_t(RINGS) * RINGB + 4 * size_t(pps); }
};

// q, out and float pages hold the kernel's element type T (bf16 or fp16)
struct Args {
  const void* q;            // (B, T, H, D)
  const void* k;            // pages (P, Hkv, ps, D or D / 2)
  const void* v;
  const float* ks;          // scales (P, Hkv, ps, 1); null for float pages
  const float* vs;
  const int* table;         // (B, max_pages)
  const int* lengths;       // (B,), or null: row t at q_off + t
  void* out;                // (B, T, H, D)
  float* ws_acc;            // (B, Hkv, n_split, R, D) unnormalised O
  float2* ws_ml;            // (B, Hkv, n_split, R): (m in log2 units, l)
  int T, q_off, H, Hkv, G, R, n_rg, ps, D, max_pages, num_pages, pps,
      n_split, window;
  float scale2;             // the softmax scale times log2(e)
};

// Issue the cp.async copies of one tile (keys [j0, j0 + valid) of page
// `page`, zeros past them and past D) into a stage; the ring's RT
// threads, `tid` the thread's index among them.
template <int DP, int BITS, bool RS, typename T>
__device__ __forceinline__ void issue_tile(const Args& a, char* stage, int page, int j0,
                                           int valid, int kvh, int tid) {
  using L = Layout<DP, BITS, RS>;
  const size_t row0 = (size_t(valid > 0 ? page : 0) * a.Hkv + kvh) * a.ps + j0;
  if constexpr (BITS == 0) {
    constexpr int VPR = DP / 8;
    const T* kg = static_cast<const T*>(a.k) + row0 * a.D;
    const T* vg = static_cast<const T*>(a.v) + row0 * a.D;
    T* kt = reinterpret_cast<T*>(stage);
    T* vt = reinterpret_cast<T*>(stage + L::TILEB);
#pragma unroll 4
    for (int i = 0; i < KT * VPR / L::RT; ++i) {
      const int e = tid + L::RT * i, r = e / VPR, c = (e % VPR) * 8;
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
    for (int i = 0; i < (KT * VPR + L::RT - 1) / L::RT; ++i) {
      const int e = tid + L::RT * i, r = e / VPR, c = (e % VPR) * 16;
      if (KT * VPR % L::RT == 0 || e < KT * VPR) {
        const bool ok = r < valid && c < rb;
        const int off = ok ? r * rb + c : 0;
        fa::cp_async16(stage + r * L::ROWB + c, kg + off, ok);
        fa::cp_async16(stage + L::TILEB + r * L::ROWB + c, vg + off, ok);
      }
    }
    float* sc = reinterpret_cast<float*>(stage + 2 * L::TILEB);
    if (tid < KT) {
      const bool ok = tid < valid;
      fa::cp_async4(sc + tid, ok ? a.ks + row0 + tid : a.ks, ok);
      fa::cp_async4(sc + KT + tid, ok ? a.vs + row0 + tid : a.vs, ok);
    }
  }
}

// Biased bytes i0 and i0 + 1 of u (b = v + bias) as two T values v in
// one register, lo in the low half.  bf16: the fp32 2^23 + b less 2^23 +
// bias, exact, whose upper half is the bf16 v.  fp16: the fp16 1024 + b
// (bits 0x6400 | b) less 1024 + bias, both halves in one __hsub2, exact.
template <typename T>
__device__ __forceinline__ uint32_t widen_pair(uint32_t u, int i0, int bias) {
  if constexpr (std::is_same_v<T, f16>) {
    const uint32_t w = __byte_perm(u, 0x64646464u, 0x4140 + 0x0101 * i0);
    const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&w),
                              __half2half2(__ushort_as_half(
                                  static_cast<unsigned short>(0x6400 | bias))));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const float fb = 8388608.f + bias;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i0)) - fb;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + i0)) - fb;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  }
}

// Four biased bytes (each 128 + v, or 8 + v) as four T values v.
template <typename T>
__device__ __forceinline__ uint2 widen4(uint32_t u, int bias) {
  return make_uint2(widen_pair<T>(u, 0, bias), widen_pair<T>(u, 2, bias));
}

// x rounded to T (to nearest even).
template <typename T>
__device__ __forceinline__ T to_elt(float x) {
  if constexpr (std::is_same_v<T, f16>) return __float2half_rn(x);
  else return __float2bfloat16_rn(x);
}

// A quantized K or V tile of a stage (rows of D * BITS / 8 bytes) widened
// to the ring's T staging tile [KT][LD] (columns past D stay zero).
template <int DP, int BITS, bool RS, typename T>
__device__ __forceinline__ void widen_tile(T* dst, const char* raw, int D, int tid) {
  using L = Layout<DP, BITS, RS>;
  constexpr int VPR = DP * BITS / 8 / 16;
  const int rb = D * BITS / 8;
#pragma unroll
  for (int i = 0; i < (KT * VPR + L::RT - 1) / L::RT; ++i) {
    const int e = tid + L::RT * i, r = e / VPR, c = (e % VPR) * 16;
    if ((KT * VPR % L::RT != 0 && e >= KT * VPR) || c >= rb) continue;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * L::ROWB + c);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    T* row = dst + r * L::LD;
    if constexpr (BITS == 8) {
      uint2 o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = widen4<T>(x[k] ^ 0x80808080u, 128);
      *reinterpret_cast<uint4*>(row + c) = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
      *reinterpret_cast<uint4*>(row + c + 8) = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
    } else {
      // byte c of a row: d = c in its low nibble, d = c + D / 2 in its high
      uint2 lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo[k] = widen4<T>((x[k] & 0x0F0F0F0Fu) ^ 0x08080808u, 8);
        hi[k] = widen4<T>(((x[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8);
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

// Barrier of the threads that share a ring: the block (row split), or a
// lane group: its warp, or its two warps (named barrier 1 + group;
// __syncthreads takes barrier 0).
template <int DSPLIT, bool RS>
__device__ __forceinline__ void ring_sync(int group) {
  if constexpr (RS) {
    __syncthreads();
  } else if constexpr (DSPLIT == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * DSPLIT) : "memory");
  }
}

// Offset of row r of slot b in q / out: (b, t = r / G, head kvh * G + r % G).
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int kvh, int r) {
  return ((size_t(b) * a.T + r / a.G) * a.H + size_t(kvh) * a.G + r % a.G) * a.D;
}

// The splits [*s0, *s1] that hold a page a row at query position qp sees
// (none when *s1 < *s0).  A row whose pages all lie in one split gets its
// output from that split's block; the merge passes it by.
__device__ __forceinline__ void row_splits(const Args& a, int qp, int* s0, int* s1) {
  int first, last;
  page_range(qp, qp, a.window, a.ps, a.max_pages, &first, &last);
  *s0 = first / a.pps;
  *s1 = last < first ? -1 : min(last / a.pps, a.n_split - 1);
}

template <int DP, int BITS, bool RS, typename T>
__global__ void __launch_bounds__(NT)
split_kernel(const Args a) {
  using L = Layout<DP, BITS, RS>;
  constexpr int NG = L::NG, LD = L::LD, DPO = L::DPO, ROWS = L::ROWS;
  extern __shared__ __align__(128) char split_smem[];
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  T* qs = reinterpret_cast<T*>(split_smem);
  char* rings = split_smem + L::QB;
  int* tbl = reinterpret_cast<int*>(rings + L::RINGS * L::RINGB);

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kvh = blockIdx.x / a.n_rg, r0 = (blockIdx.x % a.n_rg) * ROWS;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int nr = min(ROWS, a.R - r0);
  const int len = (a.lengths ? a.lengths[b] : 0) + a.q_off;  // position of t = 0
  const int q_first = len + r0 / a.G, q_last = len + (r0 + nr - 1) / a.G;
  int first, last;
  page_range(q_first, q_last, a.window, a.ps, a.max_pages, &first, &last);
  const int p0 = max(first, sp * a.pps), p1 = min(last, sp * a.pps + a.pps - 1);
  const size_t part = (size_t(b) * a.Hkv + kvh) * a.n_split + sp;
  if (p0 > p1) {          // no visible page: nothing to write but zeros
    if (a.n_split == 1)     // (the merge reads only its row's splits)
      for (int e = threadIdx.x; e < nr * a.D; e += NT)
        out[row_offset(a, b, kvh, r0 + e / a.D) + e % a.D] = to_elt<T>(0.f);
    return;
  }

  // the rows' queries (zero past row nr and column D), in flight while
  // the split's block-table entries load
  for (int e = threadIdx.x; e < ROWS * DP / 8; e += NT) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
    const bool ok = r < nr && c < a.D;
    fa::cp_async16(qs + r * LD + c, ok ? q + row_offset(a, b, kvh, r0 + r) + c : q, ok);
  }
  fa::cp_async_commit();
  for (int i = threadIdx.x; i <= p1 - p0; i += NT)
    tbl[i] = a.table[size_t(b) * a.max_pages + p0 + i];
  fa::cp_async_wait<0>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / L::DSPLIT, half = warp % L::DSPLIT;
  const int tid = threadIdx.x % L::RT;         // thread index at its ring
  const int g = lane / 4, t4 = lane % 4;
  char* ring = rings + (RS ? 0 : grp) * L::RINGB;
  T* staging = reinterpret_cast<T*>(ring + STAGES * L::STAGEB);
  if constexpr (BITS != 0) {
    for (int e = tid; e < L::STAGINGB / 16; e += L::RT)
      reinterpret_cast<uint4*>(staging)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // the ring's tiles: every (page, 32-key chunk) of the split (row split),
  // or every NG-th of them (tile split)
  const int tpp = (a.ps + KT - 1) / KT;
  const int n_tiles = (p1 - p0 + 1) * tpp;
  const int mine = RS ? n_tiles : n_tiles > grp ? (n_tiles - grp + NG - 1) / NG : 0;
  auto tile = [&](int i, int* page, int* pg, int* j0) {
    const int ti = RS ? i : grp + i * NG;
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
      issue_tile<DP, BITS, RS, T>(a, ring + s * L::STAGEB, page, j0, valid, kvh, tid);
    }
    fa::cp_async_commit();
  }

  // this group's rows [gr, gr + gn) of the block (a row split gives each
  // group its own m16 tile), their query positions, and those of this
  // lane's two rows g and g + 8 (padding rows take the last real row's)
  const int gr = RS ? grp * 16 : 0;
  const int gn = RS ? max(0, min(16, nr - gr)) : nr;
  const int gl = max(gn, 1) - 1;
  const T* gq = qs + gr * LD;
  const int g_first = len + (r0 + gr) / a.G, g_last = len + (r0 + gr + gl) / a.G;
  const int qp_lo = len + (r0 + gr + min(g, gl)) / a.G;
  const int qp_hi = len + (r0 + gr + min(g + 8, gl)) / a.G;
  float o[DPO / 8][4];                          // columns half * DPO + ...
#pragma unroll
  for (int n = 0; n < DPO / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < mine; ++i) {
    const int nxt = i + STAGES - 1;
    if (nxt < mine) {
      int page, pg, j0;
      const int valid = tile(nxt, &page, &pg, &j0);
      issue_tile<DP, BITS, RS, T>(a, ring + (nxt % STAGES) * L::STAGEB, page, j0, valid,
                                  kvh, tid);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    ring_sync<L::DSPLIT, RS>(grp);
    char* st = ring + (i % STAGES) * L::STAGEB;
    int page, pg, j0;
    const int valid = tile(i, &page, &pg, &j0);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILEB);
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + L::TILEB);
    if constexpr (BITS != 0) {
      widen_tile<DP, BITS, RS, T>(staging, st, a.D, tid);
      if constexpr (RS) widen_tile<DP, BITS, RS, T>(staging + KT * LD, st + L::TILEB, a.D, tid);
      ring_sync<L::DSPLIT, RS>(grp);
      kt = staging;
      if constexpr (RS) vt = staging + KT * LD;
    }
    // row split: a tile none of the group's rows sees changes nothing
    // (every score masked), so the group skips its math, not the ring's
    // barriers (a tile split's tiles all hold pages its rows see)
    const int pos0 = pg * a.ps + j0;
    const bool seen = !RS || (gn > 0 && pos0 <= g_last &&
                              (a.window <= 0 || pos0 + KT - 1 > g_first - a.window));

    // S = Q . K^T over the tile's 32 keys (four n8 tiles), all of D in
    // each warp of the group; the even and odd k16 steps in two chains of
    // accumulators, which the tensor cores overlap
    float s[4][4], s2[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
    if (seen) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; kk += 2) {
        uint32_t qa[4], qb[4], kb[4], kc[4];
        fa::frag_a<LD>(qa, gq, 0, kk * 16);
        fa::frag_a<LD>(qb, gq, 0, kk * 16 + 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          fa::frag_b_rows<LD>(kb, kt, np * 16, kk * 16);
          fa::frag_b_rows<LD>(kc, kt, np * 16, kk * 16 + 16);
          fa::mma16816<T>(s[2 * np], qa, kb[0], kb[1]);
          fa::mma16816<T>(s[2 * np + 1], qa, kb[2], kb[3]);
          fa::mma16816<T>(s2[2 * np], qb, kc[0], kc[1]);
          fa::mma16816<T>(s2[2 * np + 1], qb, kc[2], kc[3]);
        }
      }

      // scale (and K scales), mask, online softmax in log2 units.  A tile
      // whose every key is visible to every row of the group (all of the
      // interior of a long context) skips the per-element mask.
      const bool full = valid == KT && pos0 + KT - 1 <= g_first &&
                        (a.window <= 0 || pos0 > g_last - a.window);
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
      }
    }

    if constexpr (BITS != 0 && !RS) {
      ring_sync<L::DSPLIT, RS>(grp);               // K's fragments are read
      widen_tile<DP, BITS, RS, T>(staging, st + L::TILEB, a.D, tid);
      ring_sync<L::DSPLIT, RS>(grp);
      vt = staging;
    }

    // O += P . V over this warp's columns: the probabilities, rounded to
    // T, are the A operand
    if (seen) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4];
        fa::acc_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DPO / 16; ++dn) {
          uint32_t vb[4];
          fa::frag_b_cols<LD>(vb, vt, kk * 16, half * DPO + dn * 16);
          fa::mma16816<T>(o[2 * dn], pa, vb[0], vb[1]);
          fa::mma16816<T>(o[2 * dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
    ring_sync<L::DSPLIT, RS>(grp);                 // the stage is free again
  }
  fa::cp_async_wait<0>();
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);

  if constexpr (RS) {
    // each group writes its own rows: normalised where this split holds
    // all the row's pages, else the partial (O, m, l) to the workspace
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = g + 8 * hf;
      if (r >= gn) continue;
      const int row = r0 + gr + r;
      const float m = hf ? m_hi : m_lo, l = hf ? l_hi : l_lo;
      int s0, s1;
      row_splits(a, len + row / a.G, &s0, &s1);
      if (a.n_split == 1 || (s0 == sp && s1 == sp)) {
        T* dst = out + row_offset(a, b, kvh, row);
        const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
        for (int n = 0; n < DPO / 8; ++n) {
          const int col = half * DPO + n * 8 + 2 * t4;
          if (col < a.D)
            *reinterpret_cast<uint32_t*>(dst + col) =
                fa::pack2<T>(o[n][2 * hf] * inv, o[n][2 * hf + 1] * inv);
        }
      } else {
        float* dst = a.ws_acc + (part * a.R + row) * a.D;
#pragma unroll
        for (int n = 0; n < DPO / 8; ++n) {
          const int col = half * DPO + n * 8 + 2 * t4;
          if (col < a.D)
            *reinterpret_cast<float2*>(dst + col) = make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
        }
        if (t4 == 0 && half == 0) a.ws_ml[part * a.R + row] = make_float2(m, l);
      }
    }
    return;
  }

  // tile split: merge the groups in shared memory, in group order
  __syncthreads();
  float* ro = reinterpret_cast<float*>(rings);   // [NG][ROWS][LDO]
  float* rm = ro + NG * ROWS * L::LDO;           // [NG][ROWS]
  float* rl = rm + NG * ROWS;
  int* own = reinterpret_cast<int*>(rl + NG * ROWS);   // [ROWS]
  for (int r = threadIdx.x; r < nr; r += NT) {
    int s0, s1;
    row_splits(a, len + (r0 + r) / a.G, &s0, &s1);
    own[r] = a.n_split == 1 || (s0 == sp && s1 == sp);
  }
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
    if (own[r]) {
      out[row_offset(a, b, kvh, r0 + r) + d] = to_elt<T>(l > 0.f ? acc / l : 0.f);
    } else {
      a.ws_acc[(part * a.R + r0 + r) * a.D + d] = acc;
      if (d == 0) a.ws_ml[part * a.R + r0 + r] = make_float2(mx, l);
    }
  }
}

// Combine the partials of each row whose pages span several splits by
// their lse, in split order: out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s -
// M) l_s, M = max_s m_s, over the splits that hold a page the row sees
// (their blocks wrote a partial: the row's pages are among its block's)
// with l_s > 0.  Grid (Hkv * R, B): a block per row, its threads over D.
// (RS names the split kernel it follows: the same body, two names in a
// profile.)
template <bool RS, typename T>
__global__ void __launch_bounds__(128) merge_kernel(const Args a) {
  const int r = blockIdx.x % a.R, kvh = blockIdx.x / a.R, b = blockIdx.y;
  const size_t base = (size_t(b) * a.Hkv + kvh) * a.n_split;
  int s0, s1;   // from the inputs, while the split kernel runs
  row_splits(a, (a.lengths ? a.lengths[b] : 0) + a.q_off + r / a.G, &s0, &s1);
  if (s0 == s1) return;                          // its split's block wrote it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  float mx = -INFINITY;
  for (int s = s0; s <= s1; ++s) {
    const float2 ml = a.ws_ml[(base + s) * a.R + r];
    if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
  }
  float l = 0.f;
  for (int s = s0; s <= s1; ++s) {
    const float2 ml = a.ws_ml[(base + s) * a.R + r];
    if (ml.y > 0.f) l += ml.y * exp2f(ml.x - mx);
  }
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = s0; s <= s1; ++s) {
      const float2 ml = a.ws_ml[(base + s) * a.R + r];
      if (ml.y > 0.f) acc += exp2f(ml.x - mx) * a.ws_acc[((base + s) * a.R + r) * a.D + d];
    }
    static_cast<T*>(a.out)[row_offset(a, b, kvh, r) + d] = to_elt<T>(l > 0.f ? acc / l : 0.f);
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

template <int DP, int BITS, bool RS, typename T>
cudaError_t launch_t(Args a, int B, cudaStream_t st) {
  using L = Layout<DP, BITS, RS>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(split_kernel<DP, BITS, RS, T>, ready);
  if (err != cudaSuccess) return err;
  a.n_rg = (a.R + L::ROWS - 1) / L::ROWS;
  split_kernel<DP, BITS, RS, T>
      <<<dim3(a.Hkv * a.n_rg, B, a.n_split), NT, L::bytes(a.pps), st>>>(a);
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
  err = cudaLaunchKernelEx(&cfg, merge_kernel<RS, T>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BITS, bool RS, typename T>
cudaError_t launch_bits(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 64) return launch_t<64, BITS, RS, T>(a, B, st);
  if (a.D <= 128) return launch_t<128, BITS, RS, T>(a, B, st);
  if (a.D <= 256) return launch_t<256, BITS, RS, T>(a, B, st);
  return cudaErrorInvalidValue;
}

template <bool RS, typename T>
cudaError_t launch_kind(const Args& a, int B, int kv_bits, cudaStream_t st) {
  switch (kv_bits) {
    case 0: return launch_bits<0, RS, T>(a, B, st);
    case 8: return launch_bits<8, RS, T>(a, B, st);
    case 4: return launch_bits<4, RS, T>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// q / out (B, T, H, D) of the kernels' dtype code (1 = bf16, 2 = fp16; any
// other is refused), row t at position
// lengths[b] + q_off + t (at q_off + t where lens is null); `ws` holds B *
// Hkv * n_split * R * (D + 2) floats when n_split > 1.  RS: the row split
// (see the note above).
template <bool RS>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* bt, const int* lens, void* out, float* ws,
                   int B, int T, int q_off, int H, int Hkv, int ps, int D, int max_pages,
                   int num_pages, int pps, float scale, int window, int kv_bits,
                   int dtype, cudaStream_t st) {
  if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || ps < 1 || max_pages < 1 || pps < 1 ||
      D % 8 != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = ks;
  a.vs = vs;
  a.table = bt;
  a.lengths = lens;
  a.out = out;
  a.T = T;
  a.q_off = q_off;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.R = a.G * T;
  a.n_rg = 0;                                   // set by launch_t
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
  switch (dtype) {
    case 1: return launch_kind<RS, bf16>(a, B, kv_bits, st);
    case 2: return launch_kind<RS, f16>(a, B, kv_bits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace split
}  // namespace ptt
