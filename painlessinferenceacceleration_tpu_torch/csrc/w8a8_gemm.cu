// W8A8 GEMM with per-output-channel weight scales for Hopper (sm_90a):
// both operands already quantized, int8 x int8 or e4m3 x e4m3.
//
//   out[m, n] = ((sum_k xq[m, k] * q[k, n]) * xs[m]) * s[n]
//
// Replaces the Pallas bodies _w8a8_kernel and _w8a8_stacked_kernel
// (painlessinferenceacceleration_tpu/ops/w8a8.py). A stacked weight
// [L, K, N] is passed as the pointer of layer l, so one kernel serves both.
// Both scales are applied here in fp32, in the order of the plain version
// (w8a8_gemm_plain), with one rounding at the end. (The Pallas kernel rounds
// to bf16 before its wrapper multiplies by xs; this kernel follows the
// oracle, not that double rounding.)
//
// Layout read directly: q is [K, N] with N contiguous, xq is [M, K] with K
// contiguous, xs fp32 [M], s fp32 [N]. Any K, any N that is a multiple of 4.
//
// int8 operands: exact s32 accumulation with __dp4a. __dp4a wants four
// consecutive k of one column in a 32-bit register, the weight has four
// consecutive columns of one k there: each thread loads a 4 (k) x 4 (n) byte
// tile as four words and transposes it in registers with eight __byte_perm.
// Integer sums do not depend on their order, so the result equals the
// oracle's integer product bit for bit at every M.
// e4m3 operands: widened to fp32 (exact; the products of two e4m3 values are
// exact in fp32 too) and accumulated with fmaf in a fixed order: k ascending
// within a warp's chunks, then over the warps, then over the K splits. The
// order is a function of (K, N) only, so a row's result does not depend on M.
//
// What bounds it on the H100: at decode (M = 1, 17) the weight bytes K*N
// (~60 us per 7B layer at 3.35 TB/s); at prefill the multiply-adds, done
// here on CUDA cores (the 8-bit tensor-core path is later work). Design as
// the int4 / int8 weight-only kernels: 4 adjacent columns per thread, 8 warps
// taking 128-row chunks of K in turn with their x slice staged in shared
// memory, a fixed-order reduction over warps and K splits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 32 * 4;  // 4 columns per thread
constexpr int kChunk = 128;      // K rows a warp takes at a time

__device__ __forceinline__ float e4m3_to_float(uint8_t b) {
  const __half_raw h =
      __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
  return __half2float(__half(h));
}

// four e4m3 bytes of a word -> four floats, byte 0 first
__device__ __forceinline__ void e4m3x4_to_float(uint32_t word, float* w) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(word & 0xFFFFu), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(word >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(lo));
  const float2 b = __half22float2(__half2(hi));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// ((v * xs[m]) * s[n]) rounded once into the output
__device__ __forceinline__ void store_scaled(void* out, int out_f32, size_t i,
                                             float v, float xs_m, float s_n) {
  const float y = __fmul_rn(__fmul_rn(v, xs_m), s_n);
  if (out_f32)
    static_cast<float*>(out)[i] = y;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(y);
}

// ACC is int (int8 operands) or float (e4m3 operands); the block's
// fixed-order reduction over its warps and the epilogue are shared.
template <int MT, typename ACC>
__device__ __forceinline__ void reduce_and_store(
    ACC (&acc)[MT][4], ACC* red, ACC* part, void* out, int out_f32,
    const float* xs, const float* s, int M, int N, int m0, int ks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(warp * MT + r) * kBlockN + lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * kBlockN; e += kThreads) {
    const int r = e / kBlockN;
    const int col = e % kBlockN;
    const int m = m0 + r;
    const int n = blockIdx.x * kBlockN + col;
    if (m >= M || n >= N) continue;
    ACC v = 0;
    for (int w = 0; w < kWarps; ++w) v += red[(w * MT + r) * kBlockN + col];
    if (part != nullptr)
      part[((size_t)ks * M + m) * N + n] = v;
    else
      store_scaled(out, out_f32, (size_t)m * N + n, (float)v, xs[m], s[n]);
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads) w8a8_int8_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ q, const float* __restrict__ s,
    int* __restrict__ part, void* __restrict__ out, int out_f32, int M, int K,
    int N, int n_chunks, int chunks_per_split) {
  extern __shared__ __align__(16) int smem_i[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBlockN + lane * 4;
  const int m0 = blockIdx.y * MT;
  const int ks = blockIdx.z;
  const int c_begin = ks * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const bool col_ok = n0 < N;
  // whole words of x can be loaded when every row starts on a 4-byte boundary
  const bool x_words =
      (K & 3) == 0 && (reinterpret_cast<uintptr_t>(xq) & 3) == 0;

  int acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  // this warp's x slice: [MT][32] words, word i = x[k0 + 4i .. k0 + 4i + 3]
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem_i) + warp * MT * 32;
  for (int ch = c_begin + warp; ch < c_end; ch += kWarps) {
    const int k0 = ch * kChunk;
    const int len = min(kChunk, K - k0);
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      uint32_t word = 0;
      if (m < M) {
        const int8_t* xp = xq + (size_t)m * K + (size_t)k0 + 4 * lane;
        if (x_words && 4 * lane + 4 <= len) {
          word = *reinterpret_cast<const uint32_t*>(xp);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (4 * lane + b < len)
              word |= (uint32_t)(uint8_t)xp[b] << (8 * b);
        }
      }
      xw[r * 32 + lane] = word;
    }
    __syncwarp();
    if (col_ok) {
      const int8_t* qg = q + (size_t)k0 * N + n0;
      for (int j = 0; j < len; j += 4) {
        // rows j..j+3 of this thread's 4 columns; rows past K are zero
        const uint32_t a = *reinterpret_cast<const uint32_t*>(qg + (size_t)j * N);
        const uint32_t b = j + 1 < len
            ? *reinterpret_cast<const uint32_t*>(qg + (size_t)(j + 1) * N) : 0u;
        const uint32_t c = j + 2 < len
            ? *reinterpret_cast<const uint32_t*>(qg + (size_t)(j + 2) * N) : 0u;
        const uint32_t d = j + 3 < len
            ? *reinterpret_cast<const uint32_t*>(qg + (size_t)(j + 3) * N) : 0u;
        // 4x4 byte transpose: col[n] = {a.n, b.n, c.n, d.n}
        const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
        const uint32_t t1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
        const uint32_t t2 = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
        const uint32_t t3 = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
        uint32_t col[4];
        col[0] = __byte_perm(t0, t2, 0x5410);
        col[1] = __byte_perm(t0, t2, 0x7632);
        col[2] = __byte_perm(t1, t3, 0x5410);
        col[3] = __byte_perm(t1, t3, 0x7632);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int xv = (int)xw[r * 32 + (j >> 2)];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            acc[r][n] = __dp4a(xv, (int)col[n], acc[r][n]);
        }
      }
    }
    __syncwarp();
  }
  reduce_and_store<MT, int>(acc, smem_i, part, out, out_f32, xs, s, M, N, m0,
                            ks);
}

template <int MT>
__global__ void __launch_bounds__(kThreads) w8a8_fp8_kernel(
    const uint8_t* __restrict__ xq, const float* __restrict__ xs,
    const uint8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, void* __restrict__ out, int out_f32, int M,
    int K, int N, int n_chunks, int chunks_per_split) {
  extern __shared__ __align__(16) float smem_f[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBlockN + lane * 4;
  const int m0 = blockIdx.y * MT;
  const int ks = blockIdx.z;
  const int c_begin = ks * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const bool col_ok = n0 < N;

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  float* xf = smem_f + warp * MT * kChunk;  // this warp's x slice [MT][kChunk]
  for (int ch = c_begin + warp; ch < c_end; ch += kWarps) {
    const int k0 = ch * kChunk;
    const int len = min(kChunk, K - k0);
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      for (int i = lane; i < kChunk; i += 32)
        xf[r * kChunk + i] =
            (m < M && i < len)
                ? e4m3_to_float(xq[(size_t)m * K + (size_t)k0 + i])
                : 0.f;
    }
    __syncwarp();
    if (col_ok) {
      const uint8_t* qg = q + (size_t)k0 * N + n0;
      int j = 0;
      for (; j + 4 <= len; j += 4) {
        float w[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          e4m3x4_to_float(
              *reinterpret_cast<const uint32_t*>(qg + (size_t)(j + jj) * N),
              w[jj]);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xf + r * kChunk + j);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(xv.x, w[0][c], acc[r][c]);
            acc[r][c] = fmaf(xv.y, w[1][c], acc[r][c]);
            acc[r][c] = fmaf(xv.z, w[2][c], acc[r][c]);
            acc[r][c] = fmaf(xv.w, w[3][c], acc[r][c]);
          }
        }
      }
      for (; j < len; ++j) {
        float w[4];
        e4m3x4_to_float(*reinterpret_cast<const uint32_t*>(qg + (size_t)j * N),
                        w);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xf[r * kChunk + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv, w[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
  }
  reduce_and_store<MT, float>(acc, smem_f, part, out, out_f32, xs, s, M, N,
                              m0, ks);
}

template <typename ACC>
__global__ void splitk_reduce_kernel(const ACC* __restrict__ part,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ s,
                                     void* __restrict__ out, int out_f32,
                                     int M, int N, int ksplit) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    ACC v = 0;
    for (int k = 0; k < ksplit; ++k) v += part[(size_t)k * mn + i];
    store_scaled(out, out_f32, i, (float)v, xs[i / N], s[i % N]);
  }
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xq int8 or e4m3 [M, K]; xs fp32 [M]; q of xq's type [K, N]; s fp32 [N];
// out bf16 or fp32 [M, N]; work 4 bytes x [ksplit, M, N] (used when
// ksplit > 1: s32 partial sums for int8, fp32 for e4m3). Requires N % 4 == 0.
extern "C" int w8a8_gemm(const void* xq, const void* xs, const void* q,
                         const void* s, void* out, void* work, int M, int K,
                         int N, int fp8, int out_f32, int ksplit,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  void* part = ksplit > 1 ? work : nullptr;
  const auto* xsf = static_cast<const float*>(xs);
  const auto* sf = static_cast<const float*>(s);
  const int mt = M == 1 ? 1 : 8;
  dim3 grid((N + kBlockN - 1) / kBlockN, (M + mt - 1) / mt, ksplit);
  const size_t smem = (size_t)kWarps * mt * kBlockN * 4;
  if (fp8) {
    const auto* xb = static_cast<const uint8_t*>(xq);
    const auto* qb = static_cast<const uint8_t*>(q);
    float* pf = static_cast<float*>(part);
    if (mt == 1)
      w8a8_fp8_kernel<1><<<grid, kThreads, smem, st>>>(
          xb, xsf, qb, sf, pf, out, out_f32, M, K, N, n_chunks, cps);
    else
      w8a8_fp8_kernel<8><<<grid, kThreads, smem, st>>>(
          xb, xsf, qb, sf, pf, out, out_f32, M, K, N, n_chunks, cps);
  } else {
    const auto* xb = static_cast<const int8_t*>(xq);
    const auto* qb = static_cast<const int8_t*>(q);
    int* pi = static_cast<int*>(part);
    if (mt == 1)
      w8a8_int8_kernel<1><<<grid, kThreads, smem, st>>>(
          xb, xsf, qb, sf, pi, out, out_f32, M, K, N, n_chunks, cps);
    else
      w8a8_int8_kernel<8><<<grid, kThreads, smem, st>>>(
          xb, xsf, qb, sf, pi, out, out_f32, M, K, N, n_chunks, cps);
  }
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
    if (fp8)
      splitk_reduce_kernel<float><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(part), xsf, sf, out, out_f32, M, N, ksplit);
    else
      splitk_reduce_kernel<int><<<blocks, 256, 0, st>>>(
          static_cast<const int*>(part), xsf, sf, out, out_f32, M, N, ksplit);
  }
  return static_cast<int>(cudaGetLastError());
}
