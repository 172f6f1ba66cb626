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
// loop over k-blocks carried m/l/acc in registers.  Here a block of 8
// warps owns one tile of BQ query rows (or BK key rows in dK/dV) and
// streams the other side's tiles through shared memory; the running max
// m, denominator l and every accumulator (O, dQ, dK, dV) live in shared
// memory in fp32.  Tiles of fully masked positions are skipped by the loop
// bounds (causal, and the window's first visible tile), re-derived for the
// CUDA tile sizes; the remaining masks are per element.  A sequence length
// that is not a multiple of the tile leaves a ragged last tile: its rows
// load as zeros, are masked out of every product, and are never stored.
//
// Products of two tiles (tile_mm): bf16 operands go through the tensor
// cores with wmma 16x16x16 fragments loaded from shared memory and fp32
// accumulation.  The product of two bf16 values is exact in fp32, so such
// a product is the reference's jnp.dot(..., preferred_element_type=
// float32) up to summation order.  fp32 operands go through fp32 FMAs (no
// TF32), decision for decision the fp32 reference.
//
// Masking follows the reference: a position outside the causal band (or
// the window) has its scaled score replaced by -1e30 before the running
// max; in the backward its probability is 0.
//
// Bound on this card: at training shapes (S = 1024, D = 128) the work is
// 4 (forward), 6 (dQ) and 8 (dK/dV) x B*H*S^2*D/2 flops against a few
// bytes per element, far above the H100's ~295 flops per byte, so tensor
// core time bounds them.  This first version keeps every intermediate in
// shared memory and moves fragments between shared memory and registers
// for each 16x16 product, so shared-memory bandwidth, not the tensor
// cores, limits it; wgmma with register-resident accumulators and TMA
// loads are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // measured 1.6-1.7x faster than 4 on an H100
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
  float* lse;           // (B * H, S) fp32, row b * H + h
  const float* delta;   // (B * H, S) fp32: rowsum(dO * O)
  int B, H, G, S, D;    // G = H / Hkv query heads per KV head
  int DP;               // D rounded up to 16 (the tiles' width)
  int BQ, BK;           // query and key rows per tile
  float scale;
  int causal, window;   // window <= 0: none
};

template <typename T>
__device__ __forceinline__ T* slice(const Operand& o, int b, int h) {
  return static_cast<T*>(o.ptr) + b * o.b + h * o.h;
}

// Leading dimension of a tile of `cols` values of `elt` bytes: one 16-byte
// vector of padding staggers the rows across shared-memory banks and keeps
// every row 16-byte (and every 16-row fragment 32-byte) aligned.
__host__ __device__ inline int tile_ld(int cols, int elt) { return cols + 16 / elt; }

// Shared-memory carve-up: 128-byte aligned sections, the same arithmetic
// on the host (sizing) and the device (addresses).
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off += (bytes + 127) & ~size_t(127);
    return o;
  }
};

// Rows [row0, row0 + R) of one (b, h) slice into a tile [R][ld] of T: DP
// columns, zero past D and past row S, in 16-byte vectors (D and the
// strides are multiples of the vector, which the wrapper checks).
template <typename T>
__device__ void load_rows(T* tile, int ld, const T* src, long long s_stride,
                          int row0, int R, int S, int D, int DP) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = DP / V;
  for (int e = threadIdx.x; e < R * vpr; e += blockDim.x) {
    const int r = e / vpr, c = (e - r * vpr) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c < D)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(tile + r * ld + c) = val;
  }
}

// fp32 rows of `acc` [R][lda] (each divided by div[r] when div is given)
// to rows [row0, row0 + R) of one (b, h) slice, in T, rows < S only.
template <typename T>
__device__ void store_rows(T* dst, long long s_stride, const float* acc,
                           int lda, const float* div, int row0, int R, int S,
                           int D) {
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    if (row0 + r >= S) continue;
    const float x = div ? acc[r * lda + d] / div[r] : acc[r * lda + d];
    dst[(row0 + r) * s_stride + d] = from_float<T>(x);
  }
}

__device__ __forceinline__ void zero(float* buf, int rows, int cols, int ld) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols;
    buf[r * ld + (e - r * cols)] = 0.f;
  }
}

// C[M][N] (fp32, ldc) = (accumulate ? C : 0) + A[M][K] . B[K][N], all in
// shared memory.  A_T: A is stored transposed (A(m, k) at a[k * lda + m]);
// B_T: B is stored transposed (B(k, n) at b[n * ldb + k]).  M, N, K are
// multiples of 16.  bf16: wmma on the tensor cores, each warp owning whole
// 16x16 output tiles; fp32: FMAs in k order, one output per thread at a
// time.  Callers synchronise around it.
template <bool A_T, bool B_T>
__device__ void tile_mm(float* c, int ldc, const bf16* a, int lda,
                        const bf16* b, int ldb, int M, int N, int K,
                        bool accumulate) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int m0 = (t / tn) * 16, n0 = (t - (t / tn) * tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* cp = c + m0 * ldc + n0;
    if (accumulate)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fa, A_T ? a + k0 * lda + m0 : a + m0 * lda + k0, lda);
      wmma::load_matrix_sync(fb, B_T ? b + n0 * ldb + k0 : b + k0 * ldb + n0, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

template <bool A_T, bool B_T>
__device__ void tile_mm(float* c, int ldc, const float* a, int lda,
                        const float* b, int ldb, int M, int N, int K,
                        bool accumulate) {
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int m = e / N, n = e - m * N;
    float s = accumulate ? c[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k)
      s = fmaf(A_T ? a[k * lda + m] : a[m * lda + k],
               B_T ? b[n * ldb + k] : b[k * ldb + n], s);
    c[m * ldc + n] = s;
  }
}

// Key position kj is visible to query position qi.
__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  if (qi >= a.S || kj >= a.S) return false;
  if (!a.causal) return true;
  return kj <= qi && (a.window <= 0 || kj > qi - a.window);
}

// The k-tiles [lo, hi) that hold a position visible to some row of query
// tile qt (reference: _fwd_kernel / _bwd_dq_kernel's lo and hi).
__device__ __forceinline__ void k_tiles(const Args& a, int qt, int* lo, int* hi) {
  const int nk = (a.S + a.BK - 1) / a.BK;
  *lo = 0;
  *hi = nk;
  if (a.causal) {
    *hi = min(((qt + 1) * a.BQ + a.BK - 1) / a.BK, nk);
    if (a.window > 0) *lo = max((qt * a.BQ - (a.window - 1)) / a.BK, 0);
  }
}

// The q-tiles [lo, hi) with a row that sees some key of k-tile kt
// (reference: _bwd_dkv_kernel's lo and hi).
__device__ __forceinline__ void q_tiles(const Args& a, int kt, int* lo, int* hi) {
  const int nq = (a.S + a.BQ - 1) / a.BQ;
  *lo = 0;
  *hi = nq;
  if (a.causal) {
    *lo = (kt * a.BK) / a.BQ;
    if (a.window > 0)
      *hi = min(((kt + 1) * a.BK + a.window - 1 + a.BQ - 1) / a.BQ, nq);
  }
}

// The largest square tile of at most `most` rows (64, 32 or 16) whose
// shared memory, bytes(tile), fits the card's opt-in limit; 0 if none does.
template <typename F>
inline int pick_tile(F bytes, int most, size_t* smem) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  for (int t = most; t >= 16; t /= 2) {
    const size_t n = bytes(t);
    if (n <= size_t(limit)) {
      *smem = n;
      return t;
    }
  }
  return 0;
}

template <typename K>
inline cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                          const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Args from the C entry points' flat arguments; strides hold (b, s, h) of
// each non-null operand in the order q, k, v, o, dout, dq, dk, dv.
inline bool make_args(Args* a, void* const ptrs[8], const long long* strides,
                      int B, int H, int Hkv, int S, int D, float scale,
                      int causal, int window, int elt) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || D < 16 || D > 256 ||
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
  a->S = S;
  a->D = D;
  a->DP = (D + 15) / 16 * 16;
  a->scale = scale;
  a->causal = causal;
  a->window = causal ? window : 0;
  return true;
}

}  // namespace fa
