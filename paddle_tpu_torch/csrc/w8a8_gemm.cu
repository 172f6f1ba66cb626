// W8A8 GEMM for Hopper (sm_90a): per-row dynamic int8 quantization of the
// activations, an int8 x int8 -> int32 tensor-core product against a
// pre-quantized per-output-channel int8 weight, and the rescale
// float(acc) * sx[row] * ws[col] in the epilogue.
//
// Replaces the TPU kernel paddle_tpu/kernels/int8_gemm.py: w8a8_gemm (body
// _w8a8_kernel), and computes what it computes, in the same order: row
// quantize, int8 product, rescale, cast to x's dtype.
//
// The TPU kernel keeps a whole [bm, K] fp32 activation slab per program in
// VMEM; at K = 8192 that is 32 KB per row, far past a Hopper block's
// shared memory for any useful bm.  So the work is two launches behind one
// wrapper:
//   1. row_quant_kernel: one block per row reads x once and writes
//      xq (M, K) int8 and sx (M,) fp32:
//        sx = max(absmax, 1e-8) / 127,  xq = clip(rint(x / sx), +-127).
//      The division is IEEE (this file is built without fast math) and
//      rintf rounds half to even, so xq and sx equal the reference's bit
//      for bit.
//   2. gemm_kernel: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  The
//      weight is stored (N, K), K contiguous, which is the tensor core's
//      ".col" B operand.  A block of 4 warps owns a (16 * MT) x 16 output
//      tile and splits K between its warps (64-wide chunks, round robin);
//      the int32 partial sums meet in shared memory, exactly, and the
//      epilogue converts with __int2float_rn (|acc| <= 127^2 * K can pass
//      2^24, so the conversion rounds, to nearest even as the reference's
//      astype does) and multiplies by sx[row], then by ws[col].
//
// Fragments load straight from global memory as 16-byte vectors: a thread
// (group g = lane / 4, t = lane % 4) takes bytes [16 t, 16 t + 16) of a
// 64-wide K chunk of its A rows (g, g + 8) and of its B row (n = g), and
// feeds them to two mma's.  That permutes k inside the chunk, identically
// for A and B, which an exact integer sum does not see.
//
// Bound on this card: at the serving shapes (M = 8 decode rows, M <= 128
// prefill rows, K x N of 2048 x 6144 up to 8192 x 2048) the weight bytes
// dominate: 2 * M * N * K int8 operations at 1979 TOP/s take less time
// than N * K bytes at 3.35 TB/s for M below ~295.  The design reads each
// weight byte once per M tile, coalesced (four threads cover 64 contiguous
// bytes of a row), with many warps in flight: N / 16 blocks of 4 warps.
// (wgmma with TMA-fed shared-memory tiles and a pipelined K loop is later
// work.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace w8a8 {

constexpr int kQuantThreads = 256;
constexpr int kWarps = 4;    // split-K warps per GEMM block
constexpr int kBN = 16;      // output columns per block: two n8 tiles
constexpr int kKC = 64;      // K per chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                 float* __restrict__ sx, int K) {
  __shared__ float red[kQuantThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + size_t(row) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(to_float(xr[k])));
  amax = warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kQuantThreads / 32 ? red[threadIdx.x] : 0.f;
    v = warp_max(v);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  // the clamp constant is the double 1e-8 rounded to float, as the plain
  // version and the reference obtain it
  const float s = fmaxf(red[0], static_cast<float>(1e-8)) / 127.f;
  if (threadIdx.x == 0) sx[row] = s;
  int8_t* qr = xq + size_t(row) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = fminf(fmaxf(rintf(to_float(xr[k]) / s), -127.f), 127.f);
    qr[k] = static_cast<int8_t>(__float2int_rn(v));
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One (16 * MT) x 16 output tile per block; needs K % 64 == 0, N % 16 == 0.
template <int MT, typename TO>
__global__ void __launch_bounds__(kWarps * 32)
gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ wq, const float* __restrict__ ws,
            TO* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 16 * MT;
  __shared__ int part[kWarps][BM][kBN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;

  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int8_t* brow[2] = {wq + size_t(n0 + g) * K,
                           wq + size_t(n0 + 8 + g) * K};
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int n_chunks = K / kKC;
#pragma unroll 2
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int k = c * kKC + t * 16;
    const uint4 b0 = ldg16(brow[0] + k), b1 = ldg16(brow[1] + k);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = m0 + i * 16 + g, r1 = r0 + 8;
      const uint4 a0 = r0 < M ? ldg16(xq + size_t(r0) * K + k) : zero;
      const uint4 a1 = r1 < M ? ldg16(xq + size_t(r1) * K + k) : zero;
      // bytes 0..7 of the thread's 16 feed the first mma, 8..15 the second
      mma_s8(acc[i][0], a0.x, a1.x, a0.y, a1.y, b0.x, b0.y);
      mma_s8(acc[i][0], a0.z, a1.z, a0.w, a1.w, b0.z, b0.w);
      mma_s8(acc[i][1], a0.x, a1.x, a0.y, a1.y, b1.x, b1.y);
      mma_s8(acc[i][1], a0.z, a1.z, a0.w, a1.w, b1.z, b1.w);
    }
  }

  // accumulator fragment: rows g and g + 8, columns 2t and 2t + 1
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = i * 16 + g, cc = j * 8 + 2 * t;
      part[warp][r][cc] = acc[i][j][0];
      part[warp][r][cc + 1] = acc[i][j][1];
      part[warp][r + 8][cc] = acc[i][j][2];
      part[warp][r + 8][cc + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * kBN; e += blockDim.x) {
    const int r = e / kBN, cc = e % kBN;
    const int row = m0 + r, col = n0 + cc;
    if (row >= M) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][r][cc];
    float v = __int2float_rn(sum) * sx[row];
    v = v * ws[col];
    out[size_t(row) * N + col] = from_float<TO>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* xq, void* sx, const void* wq,
                   const void* ws, void* out, int M, int N, int K,
                   cudaStream_t st) {
  row_quant_kernel<T><<<M, kQuantThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int8_t* a = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(sx);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* c = static_cast<const float*>(ws);
  T* o = static_cast<T*>(out);
  const int mt = M <= 16 ? 1 : (M <= 32 ? 2 : 4);
  const dim3 grid(N / kBN, (M + 16 * mt - 1) / (16 * mt));
  if (mt == 1)
    gemm_kernel<1, T><<<grid, kWarps * 32, 0, st>>>(a, s, w, c, o, M, N, K);
  else if (mt == 2)
    gemm_kernel<2, T><<<grid, kWarps * 32, 0, st>>>(a, s, w, c, o, M, N, K);
  else
    gemm_kernel<4, T><<<grid, kWarps * 32, 0, st>>>(a, s, w, c, o, M, N, K);
  return cudaGetLastError();
}

}  // namespace w8a8

// x (M, K) of dtype (0 = fp32, 1 = bf16); xq (M, K) int8 and sx (M,) fp32
// scratch the wrapper allocates (written here, returned to it); wq (N, K)
// int8; ws (N,) fp32; out (M, N) of x's dtype.  Needs K % 64 == 0 and
// N % 16 == 0; M is any positive count.  Returns the CUDA error code of
// the launches.
extern "C" int w8a8_gemm_fwd(const void* x, void* xq, void* sx, const void* wq,
                             const void* ws, void* out, int M, int N, int K,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(w8a8::launch<__nv_bfloat16>(x, xq, sx, wq, ws, out, M, N, K, st));
  if (dtype == 0)
    return int(w8a8::launch<float>(x, xq, sx, wq, ws, out, M, N, K, st));
  return int(cudaErrorInvalidValue);
}
