// W8A8 GEMM for Hopper (sm_90a): per-row dynamic int8 quantization of the
// activations, an int8 x int8 -> int32 tensor-core product against a
// pre-quantized per-output-channel int8 weight, and the rescale
// float(acc) * sx[row] * ws[col] in the epilogue.
//
// Replaces the TPU kernel paddle_tpu/kernels/int8_gemm.py: w8a8_gemm (body
// _w8a8_kernel), and computes what it computes, in the same order: row
// quantize, int8 product, rescale, cast to x's dtype.  Every output equals
// the plain version (w8a8_gemm_plain) bit for bit: the row absmax is a max
// and the int32 sums are exact, in any order, and the quantize and the
// epilogue round as it does:
//   sx = max(absmax, 1e-8) / 127,  xq = clip(rint(x / sx), +-127),
//   out = (float(acc) * sx[row]) * ws[col], cast to x's dtype.
// The division is IEEE (this file is built without fast math), rintf
// rounds half to even, the clamp is the double 1e-8 rounded to float, and
// __int2float_rn rounds |acc| <= 127^2 K (which can pass 2^24) to nearest
// even, as the reference's astype does; the two products round one at a
// time (a precomputed sx[row] * ws[col] would round differently).
//
// The TPU kernel keeps a whole [bm, K] activation slab per program in VMEM
// and quantizes it there; at K = 8192 a Hopper block has no room for that.
// So a call is two launches: quant_kernel, then one of two GEMM bodies
// that the wrapper's gemm_plan picks from the shapes alone.
//
// quant_kernel: TPR threads per row (32-512), max(1, 256 / TPR) rows a
//   block; a thread reads its 16-value chunks with 16-byte loads and holds
//   two of them in registers (a longer row is read again), and writes xq
//   with 16-byte stores.  Few rows get one chunk a thread (their latency
//   is the call's), many rows two.  It lets the GEMM launch at once
//   (griddepcontrol.launch_dependents); the GEMM is a programmatic
//   dependent launch, which starts its weight copies and then waits
//   (griddepcontrol.wait) for xq and sx.
//
// w8a8_gemm_prequant runs either GEMM body alone, on xq and sx the caller
//   filled (the int8 inference ops quantize per tensor, not per row): a
//   plain launch, whose griddepcontrol.wait returns at once.
//
// split_kernel, for few rows (decode).  Bound by the weight bytes: 2 M N K
//   operations at 1979 TOP/s take less time than N K bytes at 3.35 TB/s
//   for M below ~295, and at the decode rows a projection reads its 4-17
//   MB of weight in a few microseconds, so fixed latencies count as much
//   as the stream.  A block of 4 warps owns 32 output columns (8 a warp),
//   16 rows and a range of K; the n_split blocks that share a tile and
//   split its K form a thread-block cluster.  A block walks its range in
//   64-byte chunks through a ring of STAGES shared-memory stages filled by
//   cp.async 16-byte copies (the weight's 32 rows and xq's 16 rows a
//   stage); the first STAGES - 1 weight chunks are in flight before it
//   waits for the quantize.  The product is
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, which is enough under
//   that bound: the weight is stored (N, K), K contiguous, the tensor
//   core's ".col" B operand.  A thread (g = lane / 4, t = lane % 4) takes
//   bytes [16 t, 16 t + 16) of a chunk of its A rows (g, g + 8) and its B
//   row (n = g), and feeds them to two mma's; that permutes k inside the
//   chunk, identically for A and B, which an exact integer sum does not
//   see.  Each block stores its int32 partial sums of row r into the
//   shared memory of block r % n_split of the cluster (distributed shared
//   memory), and after one cluster barrier each block sums its rows over
//   the splits, converts and stores them: no workspace, atomics or
//   counters, and a call is bit-for-bit repeatable.  The rows' scales and
//   the columns' are read before the loop, so that no global load waits
//   at the end.
//
// wgmma_kernel, for more rows (verify, prefill, training).  Bound by the
//   operations once M passes ~295.  Persistent: one block per SM walks the
//   128 x BN output tiles, N fastest (consecutive tiles share A in L2).
//   One producer warpgroup, of which one thread issues TMA copies of A
//   (xq, 128 rows x 128 bytes) and B (wq, BN rows x 128 bytes) into a ring
//   of STAGES stages with the 128-byte swizzle and mbarrier completion,
//   running on into the next tile while the consumers store the last one;
//   two consumer warpgroups of m64 each run
//   wgmma.mma_async.m64nBNk32.s32.s8.s8 four times a stage, both operands
//   K-major from shared memory (8-bit wgmma takes no transpose; xq is (M,
//   K) and wq (N, K), so neither needs a copy).  setmaxnreg moves
//   registers from the producer to the consumers, whose s32 accumulators
//   (BN / 2 a thread) feed the epilogue straight from registers; for
//   16-bit output a quad of threads transposes its words so that each
//   thread stores 16 contiguous bytes of a row.  TMA fills rows and
//   columns past M, N and K with zeros, so ragged shapes need no padding
//   copy; only the epilogue's stores are masked.  The tensor maps are
//   encoded on the host for each call (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint so that nothing links libcuda) and
//   passed by value as __grid_constant__ parameters.
//
// x and out are fp32, bf16 or fp16 (the activations' type, a template
// argument of every kernel).  A 16-bit x widens to fp32 exactly, and the
// output is the fp32 (float(acc) * sx) * ws rounded once to its type, as
// the plain version's cast rounds it, so every type is bit-exact.

#include <cuda.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace w8a8 {

using fa::bf16;
using fa::f16;
using fa::cp_async16;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::smem_addr;

constexpr int kChunk = 16;         // quantize: values a thread converts at once
constexpr int kQuantThreads = 256;  // a quantize block's threads, at least (TPR at most 512)
constexpr int kKC = 64;            // split path: K bytes per ring stage
constexpr int kSplitBN = 32;       // split path: output columns per block
constexpr int kSplitThreads = 128;
constexpr int kSplitStages = 8;    // split path: ring depth (8 and 16 measured)
constexpr int kMaxCluster = 8;     // split path: splits of K (a portable cluster)
constexpr int kBM = 128;           // wgmma path: output rows per tile
constexpr int kBK = 128;           // wgmma path: K bytes per ring stage
constexpr int kWgmmaStages = 4;    // wgmma path: ring depth (3 and 4 measured)
constexpr int kMaxDevices = 64;

// ---- shared pieces -------------------------------------------------------------

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// 16 consecutive values of a row, widened to fp32 (bf16 and fp16 -> fp32
// are exact)
__device__ __forceinline__ void load16(const float* p, float (&v)[kChunk]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = q[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[kChunk]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = q[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void load16(const f16* p, float (&v)[kChunk]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = q[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float absmax16(const float (&v)[kChunk], float m) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) m = fmaxf(m, fabsf(v[i]));
  return m;
}

// the row scale from the row's absmax; the clamp constant is the double
// 1e-8 rounded to float, as the plain version and the reference obtain it
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax, static_cast<float>(1e-8)) / 127.f;
}

// xq of 16 values, packed for one 16-byte store.  A zero quantizes to 0
// without the division: 0 / s sends the IEEE division down its slow path,
// and an all-zero row (a padded decode slot) would make its block the
// call's slowest.
__device__ __forceinline__ uint4 quant16(const float (&v)[kChunk], float s) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool zero = v[i] == 0.f;
    const float d = rintf((zero ? 1.f : v[i]) / s);
    const float q = zero ? 0.f : fminf(fmaxf(d, -127.f), 127.f);
    w[i / 4] |= (static_cast<uint32_t>(__float2int_rn(q)) & 0xffu) << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// out[i], out[i + 1] = (float(acc) * s) * w, cast
template <typename TO>
__device__ __forceinline__ void store2(TO* out, size_t i, int a0, int a1, float s,
                                       float2 w) {
  const float v0 = (__int2float_rn(a0) * s) * w.x;
  const float v1 = (__int2float_rn(a1) * s) * w.y;
  if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<uint32_t*>(out + i) = fa::pack2<TO>(v0, v1);
  }
}

// ---- quantize -------------------------------------------------------------------

// TPR threads per row, max(TPR, kQuantThreads) threads and max(1,
// kQuantThreads / TPR) rows a block.
template <typename T, int TPR>
__global__ void __launch_bounds__(TPR > kQuantThreads ? TPR : kQuantThreads)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
             int M, int K) {
  griddep_launch();   // the GEMM may be scheduled now
  constexpr int kThreads = TPR > kQuantThreads ? TPR : kQuantThreads;
  constexpr int kRows = kThreads / TPR, kCached = 2;
  __shared__ float red[kThreads / 32];
  const int tid = threadIdx.x, lt = tid % TPR;
  const int row = blockIdx.x * kRows + tid / TPR;
  const bool live = row < M;
  const T* xr = x + size_t(live ? row : 0) * K;
  int8_t* qr = xq + size_t(live ? row : 0) * K;
  const int n_chunks = live ? K / kChunk : 0;
  float v[kCached][kChunk], amax = 0.f;
#pragma unroll
  for (int c = 0; c < kCached; ++c)
    if (lt + c * TPR < n_chunks) {
      load16(xr + (lt + c * TPR) * kChunk, v[c]);
      amax = absmax16(v[c], amax);
    }
  for (int c = lt + kCached * TPR; c < n_chunks; c += TPR) {   // K > 32 TPR
    float u[kChunk];
    load16(xr + c * kChunk, u);
    amax = absmax16(u, amax);
  }
  amax = fa::warp_max(amax);
  if constexpr (TPR > 32) {
    if (tid % 32 == 0) red[tid / 32] = amax;
    __syncthreads();
    const int w0 = (tid / TPR) * (TPR / 32);
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) amax = fmaxf(amax, red[w0 + w]);   // exact in any order
  }
  const float s = row_scale(amax);
  if (live && lt == 0) sx[row] = s;
#pragma unroll
  for (int c = 0; c < kCached; ++c)
    if (lt + c * TPR < n_chunks)
      *reinterpret_cast<uint4*>(qr + (lt + c * TPR) * kChunk) = quant16(v[c], s);
  for (int c = lt + kCached * TPR; c < n_chunks; c += TPR) {
    float u[kChunk];
    load16(xr + c * kChunk, u);
    *reinterpret_cast<uint4*>(qr + c * kChunk) = quant16(u, s);
  }
}

// ---- split path: one cluster of blocks per output tile ------------------------

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// every thread of the cluster: writes before it are seen by reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this block's shared `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster2(uint32_t addr, int a, int b) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b)
               : "memory");
}

struct SplitArgs {
  const int8_t* xq;
  const float* sx;
  const int8_t* wq;
  const float* ws;
  void* out;
  int M, N, K;
  int cps;   // 64-byte K chunks per split; the splits are gridDim.x
};

// Shared memory of a split block: the ring (STAGES stages of the weight's
// 32 rows and xq's 16 rows, 64 bytes each, unpadded: a quarter warp's
// 16-byte fragment reads cover two whole rows, 128 contiguous bytes, so
// they meet no bank conflict), then the partial sums the cluster pushes
// to the block ([n_split][ceil(16 / n_split)][32] int32, fewer than 16 +
// kMaxCluster rows of 32), then the rows' scales.
template <int STAGES>
struct SplitSmem {
  static constexpr int BM = 16;
  static constexpr int kStage = (kSplitBN + BM) * kKC;
  static constexpr int kRed = STAGES * kStage;
  static constexpr int kScale = kRed + (BM + kMaxCluster) * kSplitBN * 4;
  static constexpr int kBytes = kScale + BM * 4;
};

// Grid (n_split, ceil(N / 32), ceil(M / 16)) in clusters of (n_split, 1,
// 1): block `rank` = blockIdx.x of a cluster takes K chunks [rank cps,
// (rank + 1) cps) of a 16-row tile.
template <int STAGES, typename TO>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const SplitArgs a) {
  using L = SplitSmem<STAGES>;
  constexpr int BM = L::BM;
  extern __shared__ __align__(16) uint8_t smem[];
  int* red = reinterpret_cast<int*>(smem + L::kRed);
  float* srow = reinterpret_cast<float*>(smem + L::kScale);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = blockIdx.x, n_split = gridDim.x;
  const int n0 = blockIdx.y * kSplitBN, m0 = blockIdx.z * BM;
  const int c_begin = rank * a.cps;
  const int nk = min(a.cps, a.K / kKC - c_begin);
  const int rows = min(BM, a.M - m0), slots = (BM + n_split - 1) / n_split;
  // the epilogue's column pair (2 (p % 16) for every p it takes) and its
  // scales, read now so that no load of the weight's scales waits at the
  // end
  const int cpair = 2 * (tid % (kSplitBN / 2));
  const float2 wpair = n0 + cpair < a.N ? *reinterpret_cast<const float2*>(a.ws + n0 + cpair)
                                        : make_float2(0.f, 0.f);

  // chunk i of the block's range into stage i % STAGES: the weight's rows,
  // then xq's (zeros past N and M)
  auto load_w = [&](int i) {
    uint8_t* st = smem + (i % STAGES) * L::kStage;
    const int k = (c_begin + i) * kKC;
#pragma unroll
    for (int j = 0; j < kSplitBN * 4 / kSplitThreads; ++j) {
      const int p = tid + j * kSplitThreads, n = n0 + p / 4;
      cp_async16(st + p * 16, a.wq + size_t(n < a.N ? n : 0) * a.K + k + (p % 4) * 16,
                 n < a.N);
    }
  };
  auto load_x = [&](int i) {
    uint8_t* st = smem + (i % STAGES) * L::kStage + kSplitBN * kKC;
    const int k = (c_begin + i) * kKC;
    for (int p = tid; p < BM * 4; p += kSplitThreads) {
      const int m = m0 + p / 4;
      cp_async16(st + p * 16, a.xq + size_t(m < a.M ? m : 0) * a.K + k + (p % 4) * 16,
                 m < a.M);
    }
  };

  // the weight's first chunks go out before the wait for the quantize,
  // then xq's: one commit group each, so that at step i the wait for all
  // but the newest STAGES - 1 groups covers both halves of chunk i
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load_w(i);
    cp_async_commit();
  }
  griddep_wait();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load_x(i);
    cp_async_commit();
  }
  if (tid < rows) srow[tid] = a.sx[m0 + tid];   // seen after the loop's first barrier

  int acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < nk; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < nk) {
      load_w(nx);
      load_x(nx);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const uint8_t* st = smem + (i % STAGES) * L::kStage;
    const uint4 b = *reinterpret_cast<const uint4*>(st + (warp * 8 + g) * kKC + t * 16);
    const uint8_t* pa = st + (kSplitBN + g) * kKC + t * 16;
    const uint4 lo = *reinterpret_cast<const uint4*>(pa);
    const uint4 hi = *reinterpret_cast<const uint4*>(pa + 8 * kKC);
    // bytes 0..7 of the thread's 16 feed the first mma, 8..15 the second
    mma_s8(acc, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
    mma_s8(acc, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
    __syncthreads();   // the stage is refilled by the next step's copies
  }

  // each row's partial sums go to the block that owns the row (row r:
  // block r % n_split, slot r / n_split), which sums them over the
  // cluster after the barrier, converts and stores them.  Fragment: rows
  // g (+ 8), columns 8 warp + 2 t (+ 1).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r < rows) {
      const uint32_t at =
          smem_addr(red + (rank * slots + r / n_split) * kSplitBN + warp * 8 + 2 * t);
      st_cluster2(map_rank(at, r % n_split), acc[2 * h], acc[2 * h + 1]);
    }
  }
  cluster_sync();   // the last cluster access: a block may leave after it
  TO* out = static_cast<TO*>(a.out);
  const int mine = (rows - rank + n_split - 1) / n_split;
  for (int p = tid; p < mine * (kSplitBN / 2); p += kSplitThreads) {
    const int sl = p / (kSplitBN / 2), r = rank + sl * n_split;
    if (n0 + cpair >= a.N) continue;
    int s0 = 0, s1 = 0;
    for (int q = 0; q < n_split; ++q) {   // exact in any order
      const int2 pq = *reinterpret_cast<const int2*>(red + (q * slots + sl) * kSplitBN + cpair);
      s0 += pq.x;
      s1 += pq.y;
    }
    store2(out, size_t(m0 + r) * a.N + n0 + cpair, s0, s1, srow[r], wpair);
  }
}

// ---- wgmma path: TMA ring, one producer and two consumer warpgroups ----------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// box (128 bytes of K, rows) at (k, row) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle, as TMA writes it: start address >> 4, leading byte
// offset 1 (unused for this layout), stride byte offset 1024 >> 4 (from one
// 8-row core matrix to the next), layout type 1 (128B swizzle).  The tile
// is 1024-byte aligned; a k32 step inside it adds 32 bytes to the start.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// v[i] of a 4-word array by a runtime index, as selects (no local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}
// two outputs (float(acc) * s) * w as one word of two 16-bit TO values
template <typename TO>
__device__ __forceinline__ uint32_t pair16(int a0, int a1, float s, float2 w) {
  return fa::pack2<TO>((__int2float_rn(a0) * s) * w.x, (__int2float_rn(a1) * s) * w.y);
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

template <int BN>
__host__ __device__ constexpr int wgmma_stage() { return (kBM + BN) * kBK; }
template <int BN>
__host__ __device__ constexpr int wgmma_smem(int stages) {
  return stages * wgmma_stage<BN>() + 1024 + 2 * stages * 8;   // + alignment, barriers
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of the
// ceil(M / 128) x ceil(N / BN) grid, N fastest.  384 threads: warpgroup 0
// produces, warpgroups 1 and 2 compute rows [0, 64) and [64, 128) of each
// tile.  The ring's stage and phase run on across tiles.
template <int BN, int STAGES, typename TO>
__global__ void __launch_bounds__(384, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
             const __grid_constant__ CUtensorMap tma_w, const float* __restrict__ sx,
             const float* __restrict__ ws, TO* __restrict__ out, int M, int N, int K) {
  constexpr int A_BYTES = kBM * kBK, STAGE = wgmma_stage<BN>();
  extern __shared__ uint8_t raw[];
  const uint32_t base = (smem_addr(raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BN - 1) / BN, tiles = n_tiles * ((M + kBM - 1) / kBM);
  const int nk = (K + kBK - 1) / kBK;   // TMA zero-fills a half last step
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_w)) : "memory");
    griddep_wait();   // xq is the quantize's
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) + 1) & 1);
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load(base + s * STAGE + A_BYTES, &tma_w, full + 8 * s, kb * kBK, n0);
        tma_load(base + s * STAGE, &tma_x, full + 8 * s, kb * kBK, m0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  griddep_wait();   // sx is the quantize's
  const int c = wg - 1, lane = threadIdx.x % 32;
  const int w = (threadIdx.x % 128) / 32, g = lane / 4, t = lane % 4;
  int acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t xa = base + s * STAGE + c * (kBM / 2) * kBK, wa = base + s * STAGE + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_k32<BN>(acc, sw128_desc(xa + 32 * kk), sw128_desc(wa + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done: free it
      fence_acc(acc);
      if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

    // accumulator fragment of warp w: acc[4 i + 2 h + e] is row 16 w + g +
    // 8 h, column 8 i + 2 t + e of the warpgroup's 64 x BN
    const int r0 = m0 + c * (kBM / 2) + 16 * w + g;
    const float s0 = r0 < M ? sx[r0] : 0.f, s1 = r0 + 8 < M ? sx[r0 + 8] : 0.f;
    if constexpr (sizeof(TO) == 4) {
      // a quad's float2 pairs fill whole 32-byte sectors of a row
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (col >= N) continue;   // N % 16 == 0: col + 1 < N too
        const float2 wc = *reinterpret_cast<const float2*>(ws + col);
        if (r0 < M) store2(out, size_t(r0) * N + col, acc[4 * i], acc[4 * i + 1], s0, wc);
        if (r0 + 8 < M)
          store2(out, size_t(r0 + 8) * N + col, acc[4 * i + 2], acc[4 * i + 3], s1, wc);
      }
    } else {
      // 16-bit: the quad transposes its 4 x 4 words of four 8-column
      // groups, so that each thread stores one group's 16 bytes of a row
#pragma unroll
      for (int j = 0; j < BN / 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * j + q, col = min(n0 + 8 * i + 2 * t, N - 2);
            v[q] = pair16<TO>(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1], h ? s1 : s0,
                              *reinterpret_cast<const float2*>(ws + col));
          }
          uint32_t r[4];   // r[k]: lane t ^ k's word for group t
#pragma unroll
          for (int k = 0; k < 4; ++k)
            r[k] = k ? __shfl_xor_sync(0xffffffffu, pick4(v, t ^ k), k) : pick4(v, t);
          const int row = r0 + 8 * h, col = n0 + 8 * (4 * j + t);
          if (row < M && col < N)
            *reinterpret_cast<uint4*>(out + size_t(row) * N + col) =
                make_uint4(pick4(r, t), pick4(r, t ^ 1), pick4(r, t ^ 2), pick4(r, t ^ 3));
        }
    }
  }
}

}  // namespace w8a8

// ---- host ---------------------------------------------------------------------

// Internal linkage: the per-kernel attribute flags, the SM counts and the
// driver entry point belong to this library alone.
namespace {

using namespace w8a8;

// Let `kernel` take `bytes` of dynamic shared memory, once per kernel and
// card, at its first launch there (a CUDA-graph capture later makes no
// attribute call).
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes, bool ready[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  ready[dev] = err == cudaSuccess;
  return err;
}

int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <typename Kern, typename... Args>
cudaError_t launch_ex(Kern kernel, dim3 grid, int threads, int smem, cudaStream_t st,
                      cudaLaunchAttribute* attrs, int n_attrs, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = n_attrs;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the GEMM is a programmatic dependent launch of the quantize: scheduled as
// soon as every quantize block has started, it waits on the device for xq
// and sx
cudaLaunchAttribute dependent() {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  return attr;
}

// pdl: launched as the quantize's programmatic dependent (else the
// griddepcontrol.wait of the bodies returns at once)
template <typename T>
cudaError_t launch_split(const SplitArgs& a, int n_split, bool pdl, cudaStream_t st) {
  using L = SplitSmem<kSplitStages>;
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = allow_smem(split_kernel<kSplitStages, T>, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2] = {{}, dependent()};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  const dim3 grid(n_split, (a.N + kSplitBN - 1) / kSplitBN, (a.M + L::BM - 1) / L::BM);
  return launch_ex(split_kernel<kSplitStages, T>, grid, kSplitThreads, L::kBytes, st, attr,
                   pdl ? 2 : 1, a);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, K) int8, K contiguous, in boxes of 128 bytes x box_rows with the
// 128-byte swizzle; out-of-bounds elements read as zero
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, typename T>
cudaError_t launch_wgmma(const int8_t* xq, const float* sx, const int8_t* wq, const float* ws,
                         T* out, int M, int N, int K, bool pdl, cudaStream_t st) {
  constexpr int STAGES = kWgmmaStages;
  static bool ready[kMaxDevices] = {};
  CUtensorMap tx, tw;
  cudaError_t err = tensor_map(&tx, xq, M, K, kBM);
  if (err == cudaSuccess) err = tensor_map(&tw, wq, N, K, BN);
  if (err == cudaSuccess)
    err = allow_smem(wgmma_kernel<BN, STAGES, T>, wgmma_smem<BN>(STAGES), ready);
  if (err != cudaSuccess) return err;
  const int tiles = ((N + BN - 1) / BN) * ((M + kBM - 1) / kBM);
  cudaLaunchAttribute attr = dependent();
  return launch_ex(wgmma_kernel<BN, STAGES, T>, dim3(max(1, min(tiles, sm_count()))), 384,
                   wgmma_smem<BN>(STAGES), st, &attr, pdl ? 1 : 0, tx, tw, sx, ws, out, M, N,
                   K);
}

template <typename T, int TPR>
cudaError_t launch_quant(const T* x, int8_t* xq, float* sx, int M, int K, cudaStream_t st) {
  constexpr int threads = TPR > kQuantThreads ? TPR : kQuantThreads, rows = threads / TPR;
  quant_kernel<T, TPR><<<(M + rows - 1) / rows, threads, 0, st>>>(x, xq, sx, M, K);
  return cudaGetLastError();
}

// the plan's GEMM body over xq (M, K) int8 and sx (M,) fp32 into out (M, N)
// of T; pdl as for launch_split
template <typename T>
cudaError_t launch_gemm(const int8_t* q, const float* s, const void* wq, const void* ws,
                        void* out, int M, int N, int K, int bn, int cps, bool split, bool pdl,
                        cudaStream_t st) {
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* c = static_cast<const float*>(ws);
  if (split) {
    const SplitArgs a = {q, s, w, c, out, M, N, K, cps};
    return launch_split<T>(a, (K / kKC + cps - 1) / cps, pdl, st);
  }
  T* o = static_cast<T*>(out);
  if (bn == 128) return launch_wgmma<128, T>(q, s, w, c, o, M, N, K, pdl, st);
  return launch_wgmma<256, T>(q, s, w, c, o, M, N, K, pdl, st);
}

// 0 for a plan the kernel cannot take, 1 for the split path, 2 for wgmma
int plan_kind(int M, int N, int K, int path, int bm, int bn, int cps) {
  if (M < 1 || K < kKC || K % kKC || N < 16 || N % 16) return 0;
  const int n_split = (K / kKC + cps - 1) / max(cps, 1);
  if (path == 0 && bm == 16 && bn == kSplitBN && cps >= 1 && n_split <= kMaxCluster) return 1;
  if (path == 1 && bm == kBM && (bn == 128 || bn == 256)) return 2;
  return 0;
}

template <typename T>
cudaError_t launch(const void* x, void* xq, void* sx, const void* wq, const void* ws,
                   void* out, int M, int N, int K, int path, int bm, int bn, int cps,
                   cudaStream_t st) {
  const int kind = plan_kind(M, N, K, path, bm, bn, cps);
  if (kind == 0) return cudaErrorInvalidValue;
  // the quantize: TPR threads a row, one 16-value chunk each for few rows
  // (their latency is the call's), up to two for many (K <= 32 TPR)
  const T* xt = static_cast<const T*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  const int need = M <= 1024 ? K / kChunk : K / 32;
  const cudaError_t err = need <= 32    ? launch_quant<T, 32>(xt, q, s, M, K, st)
                          : need <= 64  ? launch_quant<T, 64>(xt, q, s, M, K, st)
                          : need <= 128 ? launch_quant<T, 128>(xt, q, s, M, K, st)
                          : need <= 256 || M > 1024 ? launch_quant<T, 256>(xt, q, s, M, K, st)
                                                    : launch_quant<T, 512>(xt, q, s, M, K, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(q, s, wq, ws, out, M, N, K, bn, cps, kind == 1, true, st);
}

}  // namespace

// x (M, K) of dtype (0 = fp32, 1 = bf16, 2 = fp16); xq (M, K) int8 and sx
// (M,) fp32, scratch the wrapper allocates (written here, returned to it);
// wq (N, K) int8; ws (N,) fp32; out (M, N) of x's dtype.  The plan,
// gemm_plan's (kernels/int8_gemm.py): path 0 (split; bm 16, bn 32, cps
// 64-byte K chunks per split, at most 8 splits) or 1 (wgmma; bm 128, bn
// 128 or 256).  Needs K % 64 == 0 and N % 16 == 0, x, xq and wq 16-byte
// aligned; M is any positive count.  Returns the CUDA error code of the
// launches.
extern "C" int w8a8_gemm_fwd(const void* x, void* xq, void* sx, const void* wq,
                             const void* ws, void* out, int M, int N, int K, int dtype,
                             int path, int bm, int bn, int cps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(launch<bf16>(x, xq, sx, wq, ws, out, M, N, K, path, bm, bn, cps, st));
  if (dtype == 2)
    return int(launch<f16>(x, xq, sx, wq, ws, out, M, N, K, path, bm, bn, cps, st));
  if (dtype == 0)
    return int(launch<float>(x, xq, sx, wq, ws, out, M, N, K, path, bm, bn, cps, st));
  return int(cudaErrorInvalidValue);
}

// The GEMM alone, on rows the caller quantized: xq (M, K) int8 and sx (M,)
// fp32 in, out (M, N) of out_dtype (0 = fp32, 1 = bf16, 2 = fp16) =
// float(acc) * sx[row] * ws[col], by the plan's body as w8a8_gemm_fwd runs
// it (no quantize before it, so not a dependent launch).  Same
// requirements.
extern "C" int w8a8_gemm_prequant(const void* xq, const void* sx, const void* wq,
                                  const void* ws, void* out, int M, int N, int K,
                                  int out_dtype, int path, int bm, int bn, int cps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kind = plan_kind(M, N, K, path, bm, bn, cps);
  if (kind == 0 || out_dtype < 0 || out_dtype > 2) return int(cudaErrorInvalidValue);
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  const bool split = kind == 1;
  if (out_dtype == 1)
    return int(launch_gemm<bf16>(q, s, wq, ws, out, M, N, K, bn, cps, split, false, st));
  if (out_dtype == 2)
    return int(launch_gemm<f16>(q, s, wq, ws, out, M, N, K, bn, cps, split, false, st));
  return int(launch_gemm<float>(q, s, wq, ws, out, M, N, K, bn, cps, split, false, st));
}
