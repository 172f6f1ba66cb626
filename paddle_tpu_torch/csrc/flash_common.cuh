// Shared body of the flash-attention kernels: the forward (flash_fwd.cu),
// and the dQ and dK/dV kernels of the backward (flash_bwd.cu).
//
// Replaces the bodies of the TPU kernels in paddle_tpu/kernels/flash.py:
// _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel, and all six pallas_call
// sites that run them (_fwd_call, _bwd_call, _fwd_call_smajor,
// _bwd_call_smajor).  The sites differ only in their BlockSpecs: the
// layout of q/k/v and the GQA head map.  Here one kernel serves them all:
// every operand is read through element strides of a [B, S, H, D] view
// (batch, sequence, head; d contiguous), so "bnsd" (B*H, S, D) arrays,
// "bsnd" [B, S, H, D] and "sbnd" [S, B, H, D] activations, and the
// strided Q/K/V slices of a fused QKV projection are all read in place,
// with no transposes or copies.  Query head h reads KV head h / G.
//
// On the TPU a (b, h) pair kept its whole K/V in VMEM and a sequential
// loop over k-blocks carried m/l/acc in registers.  Here a block owns one
// tile of BQ query rows (or BK key rows in dK/dV) and streams the other
// side's tiles through shared memory.  Tiles of fully masked positions are
// skipped by the loop bounds (causal, and the window's first visible
// tile), re-derived for the CUDA tile sizes.  Queries and keys have
// lengths of their own, Sq and Sk (cross-attention over a memory, a chunk
// or one decode step against a longer cache); a causal band is aligned at
// the bottom right, query qi at position qi + Sk - Sq, as the reference's
// _sdpa_reference places it.  A length that is not a multiple of the tile
// leaves a ragged last tile: its rows load as zeros, are masked out of
// every product, and are never stored.  Masking follows the reference: a
// position outside the causal band (or the window) has its scaled score
// replaced by -1e30 before the running max; in the backward its
// probability is 0.
//
// An additive fp32 score bias (the reference's float attention mask, or a
// boolean one turned into 0 / -1e9 by the wrapper) is one more operand,
// read as bias[b * bias_b + h * bias_h + qi * bias_q + kj * bias_k] with
// element strides in which 0 broadcasts a dimension: a [B, 1, 1, S] pad
// mask, an [Sq, Sk] decoder mask and a full [B, H, Sq, Sk] mask are each
// read in place.  It is added to the scaled score of every visible position
// before the running max, and again where the backward recomputes p from
// lse (so that lse, which holds it, cancels it).  Each kernel is a template
// over BIAS: the instantiation without one reads nothing more and compiles
// to the same code as without the operand.  Its values come from global
// memory through the read-only path: a pad mask is one row of Sk floats a
// batch, which every query tile reads again from L1 / L2.
//
// Bound on this card: at the training shape (B*H = 144, S = 1024, D = 128,
// causal) the work is 4 (forward), 6 (dQ) and 8 (dK/dV) x B*H*S^2*D/2
// flops against 4-6 operands of B*H*S*D bf16 values.  By the card's rates
// (3.35 TB/s, 989 TFLOP/s) the forward's bytes take slightly longer than
// its flops, and dK/dV's flops longer than its bytes; either way the time
// that can be won lies in feeding the tensor cores.
//
// Causal attention with Sq > Sk leaves the first Sq - Sk queries (qi +
// off < 0) no visible key.  The reference fills every logit of such a row
// with -1e9 in q's dtype, adds a float mask (rounded to q's dtype) after
// that, and softmaxes the row in fp32: every key of the row is present,
// with the logit fill_logit() gives, and neither q nor k gets a gradient
// from it (the fill does not depend on them), while v and the mask do.
// The tile bounds (k_tiles, q_tiles) and the skip test (none_visible)
// keep every key of such rows.
//
// The dQ kernels also give the gradient of the score bias when asked
// (Args::dbias): d(logit) = p (dp - delta) at every present position,
// summed by fp32 atomics into a buffer of the bias's own broadcast shape
// (element strides with 0 on a broadcast dimension, as the bias is read),
// after a sum over the warp's 16 rows where the bias broadcasts over
// queries.  The order of the atomics varies from run to run, so dBias is
// not bit-reproducible (the other outputs are).
//
// The designs below are chosen by dtype (a choice of body by type, not a
// fallback: a failed build or launch raises in the wrapper).
//
// 16-bit forward, dQ and dK/dV (flash_fwd_16, flash_bwd_dq_16,
// flash_bwd_dkv_16), one body for bf16 and fp16 (the element type T is a
// template argument of the tiles): register-fragment kernels.  Every
// product is mma.sync m16n8k16 (bf16 or fp16 operands, fp32 accumulation;
// the product of two such values is exact in fp32, as the reference's
// preferred_element_type=float32) with operands loaded by
// ldmatrix (.trans for the operand whose reduction runs along rows) from
// shared-memory tiles whose rows are padded by one 16-byte vector, which
// makes every ldmatrix phase conflict-free.  Each warp owns 16 rows of the
// output side for the block's life, and its accumulators (O, or dK and
// dV) stay in registers.  The accumulator layout of m16n8k16 is the A
// operand layout of the next product (two adjacent n8 tiles are one k16
// fragment), so P (forward), dS (dQ) and P^T, dS^T (dK/dV) go from one
// product to the next in registers, rounded to T, and no score tile is written to
// shared memory.  The streamed side comes through a ring of shared-memory
// stages filled by cp.async 16-byte copies: tile j + 1 is in flight while
// tile j is computed on.  Only a warp's tile that crosses the causal
// diagonal, the window's edge or the last row evaluates per-element masks; a
// warp skips a tile it cannot see at all.  mma.sync is used rather than
// wgmma: its accumulator-as-operand layout is what keeps P in registers,
// it needs no shared-memory descriptors, and the file still builds in
// seconds.
//
// fp32 forward, dQ and dK/dV (flash_fwd_fp32, flash_bwd_dq_fp32,
// flash_bwd_dkv_fp32): the 16-bit kernels' register-fragment structure on
// mma.sync m16n8k8 with TF32 operands, each product split into three
// ("3xTF32", see the toolkit below), so that the tensor cores give
// fp32-accurate sums: fp32 tiles in the same cp.async rings, fragments by
// 32-bit shared loads, the accumulators and S/P/dS in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>


namespace fa {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One operand: base pointer and element strides of batch, sequence and head.
struct Operand {
  void* ptr;
  long long b, s, h;
};

// Everything a launch needs; operands a kernel does not use are null.
struct Args {
  Operand q, k, v, o, dout, dq, dk, dv;
  float* lse;           // (B * H, Sq) fp32, row b * H + h
  const float* delta;   // (B * H, Sq) fp32: rowsum(dO * O) (16-bit kernels)
  const float2* delta2;  // the same summed in fp64, as fp32 hi + lo (fp32 kernels)
  int B, H, G, D;       // G = H / Hkv query heads per KV head
  int Sq, Sk;           // query and key lengths
  int off;              // Sk - Sq: the causal band's offset (bottom-right aligned)
  int DP;               // D rounded up to 16 (the tiles' width)
  int BQ, BK;           // query and key rows per tile
  float scale;
  int causal, window;   // window <= 0: none
  const float* bias;    // additive score bias (fp32), or null
  long long bias_b, bias_h, bias_q, bias_k;  // its element strides; 0 broadcasts
  int nokey;            // rows with no visible key: Sq - Sk when causal and Sq > Sk, else 0
  float* dbias;         // the bias's gradient (fp32, zeroed by the caller), or null (dQ kernels)
  long long dbias_b, dbias_h, dbias_q, dbias_k;  // its element strides; 0 sums a dimension
};

template <typename T>
__device__ __forceinline__ T* slice(const Operand& o, int b, int h) {
  return static_cast<T*>(o.ptr) + b * o.b + h * o.h;
}

// The bias of query head h of batch b: add qi * bias_q + kj * bias_k.
__device__ __forceinline__ const float* bias_slice(const Args& a, int b, int h) {
  return a.bias + b * a.bias_b + h * a.bias_h;
}

// The bias of (qi, kj) in base 2 (times log2(e)), for the kernels that
// keep their scores in base 2.
__device__ __forceinline__ float bias2(const Args& a, const float* bs, int qi, int kj) {
  return kLog2e * __ldg(bs + qi * a.bias_q + kj * a.bias_k);
}

// The bias of (qi, kj), base e.
__device__ __forceinline__ float bias_e(const Args& a, const float* bs, int qi, int kj) {
  return __ldg(bs + qi * a.bias_q + kj * a.bias_k);
}

// Leading dimension of a tile of `cols` values of `elt` bytes: one 16-byte
// vector of padding staggers the rows across shared-memory banks and keeps
// every row 16-byte (and every 16-row fragment 32-byte) aligned.
__host__ __device__ constexpr int tile_ld(int cols, int elt) { return cols + 16 / elt; }

// Key position kj is visible to query position qi.  Causal bands align
// the last query with the last key, as the reference's _sdpa_reference
// places its queries at positions Sk - Sq .. Sk - 1: query qi sees keys
// up to qi + off.
__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  if (qi >= a.Sq || kj >= a.Sk) return false;
  if (!a.causal) return true;
  const int p = qi + a.off;
  return kj <= p && (a.window <= 0 || kj > p - a.window);
}

// Key kj takes part in query qi's softmax: visible, or any key of a row
// that sees none (see the top of the file).
__device__ __forceinline__ bool present(const Args& a, int qi, int kj) {
  return visible(a, qi, kj) || (qi < a.nokey && kj < a.Sk);
}

// x rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, bf16>) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (std::is_same_v<T, f16>) return __half2float(__float2half_rn(x));
  else return x;
}

// The logit (base e) of a key in a row with no visible key, whose bias
// there is b: the reference's fill, -1e9 in q's dtype T, plus the mask in
// T, rounded to T; then less the fill, which
// moves the row's softmax nowhere and leaves its lse the log of its sum
// (at -1e9 an fp32 lse would round log l away: its spacing there is 64).
// The difference is exact (Sterbenz).  fp16 has no finite -1e9 (the
// reference's fill is -inf there, and its row NaN): the kernels keep the
// fill in fp32 for fp16, a recorded choice.
template <typename T>
__device__ __forceinline__ float fill_logit(float b) {
  if constexpr (std::is_same_v<T, f16>) {
    return (-1e9f + round_to<f16>(b)) + 1e9f;
  } else {
    const float fill = round_to<T>(-1e9f);
    return round_to<T>(fill + round_to<T>(b)) - fill;
  }
}

// The bias (base e) of a warp's accumulator tile of NS n8 tiles into
// bv: pos(n, e, &qi, &kj) names element (n, e)'s query and key and
// returns the slice to read.  Off an edge every element is read without
// a test, so the loads issue together and their latency is paid once a
// tile; on an edge a position that is not present (past row Sq among
// them) reads nothing and gets 0, its probability being masked anyway.
template <int NS, typename P>
__device__ __forceinline__ void load_bias(float (&bv)[NS][4], const Args& a, bool edge,
                                          P&& pos) {
  if (!edge) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int qi, kj;
        const float* bs = pos(n, e, &qi, &kj);
        bv[n][e] = bias_e(a, bs, qi, kj);
      }
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int qi, kj;
        const float* bs = pos(n, e, &qi, &kj);
        bv[n][e] = present(a, qi, kj) ? bias_e(a, bs, qi, kj) : 0.f;
      }
  }
}

// The k-tiles [lo, hi) that hold a position present to some row of query
// tile qt (reference: _fwd_kernel / _bwd_dq_kernel's lo and hi): all of
// them for a tile with a row that sees no key.
__device__ __forceinline__ void k_tiles(const Args& a, int qt, int* lo, int* hi) {
  const int nk = (a.Sk + a.BK - 1) / a.BK;
  *lo = 0;
  *hi = nk;
  if (a.causal && qt * a.BQ >= a.nokey) {
    *hi = min(max(((qt + 1) * a.BQ + a.off + a.BK - 1) / a.BK, 0), nk);
    if (a.window > 0) *lo = max((qt * a.BQ + a.off - (a.window - 1)) / a.BK, 0);
  }
}

// The q-tiles [lo, hi) with a row to which some key of k-tile kt is
// present (reference: _bwd_dkv_kernel's lo and hi): from the first when
// rows see no key (they lead, and hi covers them).
__device__ __forceinline__ void q_tiles(const Args& a, int kt, int* lo, int* hi) {
  const int nq = (a.Sq + a.BQ - 1) / a.BQ;
  *lo = 0;
  *hi = nq;
  if (a.causal) {
    *lo = a.nokey > 0 ? 0 : min(max((kt * a.BK - a.off) / a.BQ, 0), nq);
    if (a.window > 0)
      *hi = max(min(((kt + 1) * a.BK - a.off + a.window - 1 + a.BQ - 1) / a.BQ, nq), *lo);
  }
}

template <typename K>
inline cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t st, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// Args from the C entry points' flat arguments; strides hold (b, s, h) of
// each non-null operand in the order q, k, v, o, dout, dq, dk, dv.
inline bool make_args(Args* a, void* const ptrs[8], const long long* strides,
                      int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                      int causal, int window, int elt) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || D < 16 || D > 256 ||
      D % (16 / elt) != 0)
    return false;
  Operand* ops[8] = {&a->q, &a->k, &a->v, &a->o, &a->dout, &a->dq, &a->dk, &a->dv};
  int j = 0;
  for (int i = 0; i < 8; ++i) {
    *ops[i] = Operand{ptrs[i], 0, 0, 0};
    if (ptrs[i]) {
      ops[i]->b = strides[3 * j];
      ops[i]->s = strides[3 * j + 1];
      ops[i]->h = strides[3 * j + 2];
      ++j;
    }
  }
  a->B = B;
  a->H = H;
  a->G = H / Hkv;
  a->Sq = Sq;
  a->Sk = Sk;
  a->off = Sk - Sq;
  a->D = D;
  a->DP = (D + 15) / 16 * 16;
  a->scale = scale;
  a->causal = causal;
  a->window = causal ? window : 0;
  a->nokey = causal && Sq > Sk ? Sq - Sk : 0;
  return true;
}

// The bias operand of the C entry points: null, or a pointer with its four
// element strides (b, h, q, k).
inline void set_bias(Args* a, const void* bias, const long long* strides) {
  a->bias = static_cast<const float*>(bias);
  if (bias) {
    a->bias_b = strides[0];
    a->bias_h = strides[1];
    a->bias_q = strides[2];
    a->bias_k = strides[3];
  }
}

// The bias's gradient operand of the dQ entry point: null, or a zeroed
// fp32 buffer with its four element strides (b, h, q, k; 0 sums).
inline void set_dbias(Args* a, void* dbias, const long long* strides) {
  a->dbias = static_cast<float*>(dbias);
  if (dbias) {
    a->dbias_b = strides[0];
    a->dbias_h = strides[1];
    a->dbias_q = strides[2];
    a->dbias_k = strides[3];
  }
}

// d(logit) g of one accumulator tile's elements into dbias (db: the
// slice of batch b, query head h): element e at query qi0 + (e / 2) * 8,
// key kj0 + e % 2, as the m16n8 accumulator lays them out (row g, column
// 2t).  Every lane of the warp calls it.  Where the bias broadcasts over
// queries the warp sums its 16 rows first (shuffles over g), and 4 lanes
// add 8 columns; else each present element adds its own.
__device__ __forceinline__ void emit_dbias(const Args& a, float* db, const float g[4], int qi0,
                                           int kj0) {
  if (a.dbias_q == 0) {
    float v0 = g[0] + g[2], v1 = g[1] + g[3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if ((threadIdx.x & 31) < 4) {
      if (kj0 < a.Sk) atomicAdd(db + kj0 * a.dbias_k, v0);
      if (kj0 + 1 < a.Sk) atomicAdd(db + (kj0 + 1) * a.dbias_k, v1);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qi0 + (e >> 1) * 8, kj = kj0 + (e & 1);
      if (g[e] != 0.f && qi < a.Sq && kj < a.Sk)
        atomicAdd(db + qi * a.dbias_q + kj * a.dbias_k, g[e]);
    }
  }
}

// Launch `f(std::bool_constant<BIAS>)` with BIAS = whether the launch has a
// score bias: the two instantiations of each kernel.
template <typename F>
inline cudaError_t with_bias(const Args& a, F&& f) {
  if (a.bias) return f(std::true_type{});
  return f(std::false_type{});
}

// -- register-fragment toolkit of the 16-bit kernels (bf16, fp16) -----------
//
// mma.sync m16n8k16 fragments, lane = 4 * g + t (g = lane / 4, t = lane % 4):
// A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..); B (16 x 8): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// C (16 x 8, fp32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 8 bytes global -> shared, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + R) of one (b, h) slice into a tile of T (bf16, fp16
// or fp32) [R][tile_ld]: DP columns, zero past D and past row S, by cp.async
// 16-byte copies from all NT threads of the block (D and the strides are
// multiples of one vector, which the wrapper checks).
template <int R, int DP, int NT, typename T>
__device__ __forceinline__ void cp_rows(T* tile, const T* src, long long stride, int row0,
                                        int S, int D) {
  constexpr int V = 16 / sizeof(T), VPR = DP / V, N = R * VPR;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if (N % NT == 0 || e < N) {
      const int r = e / VPR, c = (e - r * VPR) * V;
      const bool ok = row0 + r < S && c < D;
      cp_async16(tile + r * tile_ld(DP, sizeof(T)) + c, ok ? src + (row0 + r) * stride + c : src,
                 ok);
    }
  }
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 and receives (row lane / 4, cols 2 (lane % 4),
// +1) of matrix j in r[j] (.trans: of its transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major
// tile.
template <int LD, typename T>
__device__ __forceinline__ void frag_a(uint32_t r[4], const T* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles where B(k, n) = tile[n][k] (the rows are
// B's columns, as K's rows in Q.K^T): n = n0..n0+15, k = k0..k0+15;
// {r[0], r[1]} for n0, {r[2], r[3]} for n0 + 8.
template <int LD, typename T>
__device__ __forceinline__ void frag_b_rows(uint32_t r[4], const T* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles where B(k, n) = tile[k][n] (as V's rows in
// P.V): k = k0..k0+15, n = n0..n0+15; {r[0], r[1]} for n0, {r[2], r[3]}
// for n0 + 8.
template <int LD, typename T>
__device__ __forceinline__ void frag_b_cols(uint32_t r[4], const T* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, tile + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8);
}

// c += a . b, m16n8k16, T (bf16 or fp16) operands, fp32 accumulator
// (bf16 by default: the paged kernels' split body calls it so).
template <typename T = bf16>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same_v<T, f16>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats rounded to fp16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats rounded to T (bf16 or fp16) in one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>) return pack_f16(lo, hi);
  else return pack_bf16(lo, hi);
}

// The A fragment of k16 step kk from an fp32 accumulator of n8 tiles c[]:
// tiles 2 kk and 2 kk + 1, rounded to T.
template <typename T = bf16>
__device__ __forceinline__ void acc_to_a(uint32_t r[4], const float c0[4], const float c1[4]) {
  r[0] = pack2<T>(c0[0], c0[1]);
  r[1] = pack2<T>(c0[2], c0[3]);
  r[2] = pack2<T>(c1[0], c1[1]);
  r[3] = pack2<T>(c1[2], c1[3]);
}

// -- split-TF32 toolkit of the fp32 kernels ----------------------------------
//
// mma.sync m16n8k8 with .tf32 operands (19-bit values in 32-bit registers),
// lane = 4 * g + t: A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
// (g+8, t+4); B (8 x 8): b0 (k t, n g), b1 (k t+4, n g); C (16 x 8, fp32)
// as m16n8k16's.  Every fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (to nearest, ties away, as cvt.rna), which together keep ~22
// of its 24 bits, and a product accumulates lo.hi and hi.lo first, then
// hi.hi, into fp32 (CUTLASS's OpMultiplyAddFastF32, the scheme of
// PyTorch's fp32 memory-efficient attention): the dropped lo.lo term is
// 2^-22 of the product.  A single TF32 product would keep 11 bits.
//
// Fragments come from fp32 shared-memory tiles by 32-bit loads (ldmatrix
// moves 16-bit matrices, and the transposed operands cannot use it).
// With rows padded by one 16-byte vector (tile_ld(DP, 4) = DP + 4, DP a
// multiple of 32), both patterns below touch 32 distinct banks.  The
// accumulator's column pair (2t, 2t + 1) is not the A fragment's (t,
// t + 4), so where S, P or dS is the A operand of the next product, the
// order of the summation index k is permuted instead of the values: A's k
// t and t + 4 are the accumulator's columns 2t and 2t + 1, and B's rows
// are read in the same order (tf32_b_cols).

struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

// tf32(x) rounded as cvt.rna.tf32.f32 rounds a finite x: half a unit of
// the 13 dropped bits added to the magnitude's bit pattern, then masked.
// (ptxas expands the cvt itself into a compare-and-select sequence on
// sm_90a, some twice the instructions.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a . b, m16n8k8, tf32 operands, fp32 accumulator.
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: lo.hi + hi.lo, then hi.hi, into a partial that
// starts at 0, which is then added to c by an fp32 add (round to
// nearest).  Chained into c itself, the three products of every step
// would add as many tensor-core roundings to c as the reduction has
// steps.
__device__ __forceinline__ void mma_3xtf32(float c[4], const Tf32A& a, const Tf32B& b) {
  float t[4];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a.lo[0]), "r"(a.lo[1]), "r"(a.lo[2]), "r"(a.lo[3]), "r"(b.hi[0]), "r"(b.hi[1]),
        "f"(0.f));
  mma1688(t, a.hi, b.lo[0], b.lo[1]);
  mma1688(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// B in three TF32 parts: hi, mid = tf32(x - hi), lo = tf32(x - hi - mid)
// hold every bit of an fp32 x (11 + 11 + 11 >= 24), where hi and lo keep
// ~22.
struct Tf32B3 {
  uint32_t hi[2], mid[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = tf32_rna(x);
  const float r = x - __uint_as_float(hi);
  mid = tf32_rna(r);
  lo = tf32_rna(r - __uint_as_float(mid));
}

// c += a . b with b in three parts: lo.hi + hi.lo + hi.mid, then hi.hi,
// into a fresh partial added to c.  Where a's row holds one 1 and zeros
// (a query whose probability sits on one key), the row gets b's values
// to the last bit, as an fp32 product does; two parts of b would miss
// them by ~2^-22.
__device__ __forceinline__ void mma_4xtf32(float c[4], const Tf32A& a, const Tf32B3& b) {
  float t[4];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a.lo[0]), "r"(a.lo[1]), "r"(a.lo[2]), "r"(a.lo[3]), "r"(b.hi[0]), "r"(b.hi[1]),
        "f"(0.f));
  mma1688(t, a.hi, b.lo[0], b.lo[1]);
  mma1688(t, a.hi, b.mid[0], b.mid[1]);
  mma1688(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// The A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 8) of a row-major
// fp32 tile.
template <int LD>
__device__ __forceinline__ Tf32A tf32_a(const float* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (r0 + (lane >> 2)) * LD + c0 + (lane & 3);
  Tf32A f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * LD], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * LD + 4], f.hi[3], f.lo[3]);
  return f;
}

// The B fragment of one n8 tile where B(k, n) = tile[n][k] (K's rows in
// Q.K^T): n = n0..n0+7, k = k0..k0+7.
template <int LD>
__device__ __forceinline__ Tf32B tf32_b_rows(const float* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  Tf32B f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}

// The B fragment of one n8 tile where B(k, n) = tile[k][n] (K's rows in
// dS.K), k = k0..k0+7 in tf32_acc_a's order: k t is row k0 + 2t, k t + 4
// row k0 + 2t + 1.
template <int LD>
__device__ __forceinline__ Tf32B tf32_b_cols(const float* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  Tf32B f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[LD], f.hi[1], f.lo[1]);
  return f;
}

// tf32_b_cols's fragment in three parts.
template <int LD>
__device__ __forceinline__ Tf32B3 tf32_b_cols3(const float* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  Tf32B3 f;
  split_tf32(p[0], f.hi[0], f.mid[0], f.lo[0]);
  split_tf32(p[LD], f.hi[1], f.mid[1], f.lo[1]);
  return f;
}

// The A fragment whose 8 k columns are the columns of accumulator n8 tile
// c, in tf32_b_cols's order: every value stays in its lane.
__device__ __forceinline__ Tf32A tf32_acc_a(const float c[4]) {
  Tf32A f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}

// A tile split ahead of its products: hi and lo of every value, as TF32
// bit patterns in two fp32 tiles of one shape.  The loaders below read
// fragments from it as their fp32 namesakes do, with no split per load.
struct SplitTile {
  const float* hi;
  const float* lo;
};

template <int LD>
__device__ __forceinline__ Tf32A tf32_a(SplitTile t, int r0, int c0) {
  const int lane = threadIdx.x & 31, at = (r0 + (lane >> 2)) * LD + c0 + (lane & 3);
  const int off[4] = {0, 8 * LD, 4, 8 * LD + 4};
  Tf32A f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(t.hi[at + off[i]]);
    f.lo[i] = __float_as_uint(t.lo[at + off[i]]);
  }
  return f;
}

template <int LD>
__device__ __forceinline__ Tf32B tf32_b_rows(SplitTile t, int n0, int k0) {
  const int lane = threadIdx.x & 31, at = (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  return Tf32B{{__float_as_uint(t.hi[at]), __float_as_uint(t.hi[at + 4])},
               {__float_as_uint(t.lo[at]), __float_as_uint(t.lo[at + 4])}};
}

// A tile split ahead in three parts (hi, mid, lo).
struct SplitTile3 {
  const float* hi;
  const float* mid;
  const float* lo;
};

template <int LD>
__device__ __forceinline__ Tf32B3 tf32_b_cols3(SplitTile3 t, int k0, int n0) {
  const int lane = threadIdx.x & 31, at = (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  return Tf32B3{{__float_as_uint(t.hi[at]), __float_as_uint(t.hi[at + LD])},
                {__float_as_uint(t.mid[at]), __float_as_uint(t.mid[at + LD])},
                {__float_as_uint(t.lo[at]), __float_as_uint(t.lo[at + LD])}};
}

// Rows [0, R) x DP of an fp32 tile (pitch tile_ld(DP, 4)) split in place
// into PARTS (2 or 3) TF32 parts: hi over the value, the rest into the
// same place of p1 (lo; for three parts mid, and lo into p2), by the NT
// threads numbered from tid, a 16-byte vector at a time.
template <int R, int DP, int NT, int PARTS>
__device__ __forceinline__ void split_rows(float* tile, float* p1, float* p2, int tid) {
  constexpr int LD = tile_ld(DP, 4), VPR = DP / 4, N = R * VPR;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (N % NT == 0 || e < N) {
      const int at = (e / VPR) * LD + (e % VPR) * 4;
      float x[4], part[3][4];
      *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(tile + at);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t h, m, l;
        if constexpr (PARTS == 2) split_tf32(x[j], h, m);
        else split_tf32(x[j], h, m, l);
        part[0][j] = __uint_as_float(h);
        part[1][j] = __uint_as_float(m);
        if constexpr (PARTS == 3) part[2][j] = __uint_as_float(l);
      }
      *reinterpret_cast<float4*>(tile + at) = *reinterpret_cast<const float4*>(part[0]);
      *reinterpret_cast<float4*>(p1 + at) = *reinterpret_cast<const float4*>(part[1]);
      if constexpr (PARTS == 3)
        *reinterpret_cast<float4*>(p2 + at) = *reinterpret_cast<const float4*>(part[2]);
    }
  }
}

// The edge-tile test.  Every key of [k0, k0 + nk) is visible to every
// query of [q0, q0 + nq): the tile needs no per-element mask.
__device__ __forceinline__ bool all_visible(const Args& a, int q0, int nq, int k0, int nk) {
  if (q0 + nq > a.Sq || k0 + nk > a.Sk) return false;
  if (!a.causal) return true;
  return k0 + nk - 1 <= q0 + a.off && (a.window <= 0 || k0 > q0 + nq - 1 + a.off - a.window);
}

// No key of [k0, k0 + nk) is visible to any query of [q0, q0 + nq): the
// tile can be skipped.  (A row whose keys are all masked in a tile it
// does compute gets p = exp(-1e30 - (-1e30)) = 1 there, as in the
// reference; its first visible key then scales that by exp(-1e30 - m) =
// 0, so skipping such a tile gives the same result.)
__device__ __forceinline__ bool none_visible(const Args& a, int q0, int nq, int k0, int nk) {
  if (q0 >= a.Sq || k0 >= a.Sk) return true;
  if (!a.causal || q0 < a.nokey) return false;  // a row that sees no key has every key
  return k0 > q0 + nq - 1 + a.off || (a.window > 0 && k0 + nk - 1 <= q0 + a.off - a.window);
}

}  // namespace fa
