// 128x128-block fp8 GEMM for Hopper (sm_90a): e4m3 x e4m3 with one fp32
// weight scale per 128x128 block and one fp32 activation scale per
// (token, 128-deep K block), the DeepSeek-V3 checkpoint format.
//
//   out[m, n] = sum_kb ((sum_{k in kb} xq[m, k] * q[k, n]) * xs[m, kb])
//                      * s[kb, n / 128]
//
// Replaces the Pallas bodies _block_fp8_kernel and _block_fp8_stacked_kernel
// (painlessinferenceacceleration_tpu/ops/w8a8.py). A stacked weight
// [L, K, N] is passed as the pointer of layer l, so one kernel serves both;
// the token-block variant (power-of-two activation scales) differs only in
// how xs was made. The [K/128, N/128] scales are read as they are stored
// (the TPU wrapper expands them to [K/128, N] first), and each 128-deep
// partial is scaled by xs then s, the order of the plain version
// (block_fp8_gemm_plain).
//
// Layout read directly: q e4m3 [K, N] with N contiguous, xq e4m3 [M, K],
// xs fp32 [M, ceil(K/128)], s fp32 [ceil(K/128), ceil(N/128)]. The last K
// block and the last column block may be partial: x is taken as zero past K
// and columns past N are not computed. N must be a multiple of 4.
//
// e4m3 values are widened to fp32 (exact; their products are exact in fp32
// too) and accumulated with fmaf, so every 128-deep partial is a full-fp32
// sum. The partials are added in a fixed order: kb ascending within a warp
// (warp w takes blocks w, w + 8, ...), then over the warps, then over the K
// splits. The order is a function of (K, N) only, so a row's result does not
// depend on M.
//
// What bounds it on the H100: at decode (M = 1, 17) the weight bytes K*N
// (~60 us per 7B layer at 3.35 TB/s); at prefill the multiply-adds, done
// here on CUDA cores (the fp8 tensor-core path, with this per-128 promotion
// to fp32, is later work). Design as the other GEMM kernels of this
// directory: 4 adjacent columns per thread, so a block's 128 columns are one
// column block of the scales; 8 warps taking K blocks in turn with their x
// slice staged in shared memory as fp32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 32 * 4;  // 4 columns per thread = one scale block
constexpr int kBlock = 128;      // the format's block edge

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

template <int MT>
__global__ void __launch_bounds__(kThreads) block_fp8_gemm_kernel(
    const uint8_t* __restrict__ xq, const float* __restrict__ xs,
    const uint8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, void* __restrict__ out, int out_f32, int M,
    int K, int N, int nkb, int nnb, int blocks_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBlockN + lane * 4;
  const int m0 = blockIdx.y * MT;
  const int ks = blockIdx.z;
  const int b_begin = ks * blocks_per_split;
  const int b_end = min(nkb, b_begin + blocks_per_split);
  const bool col_ok = n0 < N;

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  float* xf = smem + warp * MT * kBlock;  // this warp's x slice [MT][kBlock]
  for (int kb = b_begin + warp; kb < b_end; kb += kWarps) {
    const int k0 = kb * kBlock;
    const int len = min(kBlock, K - k0);
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      for (int i = lane; i < kBlock; i += 32)
        xf[r * kBlock + i] =
            (m < M && i < len)
                ? e4m3_to_float(xq[(size_t)m * K + (size_t)k0 + i])
                : 0.f;
    }
    __syncwarp();
    if (col_ok) {
      float p[MT][4];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
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
              *reinterpret_cast<const float4*>(xf + r * kBlock + j);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p[r][c] = fmaf(xv.x, w[0][c], p[r][c]);
            p[r][c] = fmaf(xv.y, w[1][c], p[r][c]);
            p[r][c] = fmaf(xv.z, w[2][c], p[r][c]);
            p[r][c] = fmaf(xv.w, w[3][c], p[r][c]);
          }
        }
      }
      for (; j < len; ++j) {
        float w[4];
        e4m3x4_to_float(*reinterpret_cast<const uint32_t*>(qg + (size_t)j * N),
                        w);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xf[r * kBlock + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) p[r][c] = fmaf(xv, w[c], p[r][c]);
        }
      }
      // (partial * xs[m, kb]) * s[kb, column block], then the running sum
      const float sn = s[(size_t)kb * nnb + blockIdx.x];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const int m = m0 + r;
        const float xsv = m < M ? xs[(size_t)m * nkb + kb] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] =
              __fadd_rn(acc[r][c], __fmul_rn(__fmul_rn(p[r][c], xsv), sn));
      }
    }
    __syncwarp();
  }

  // fixed-order reduction over the warps of the block
  __syncthreads();
  float* red = smem;  // [kWarps][MT][kBlockN]
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
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[(w * MT + r) * kBlockN + col];
    if (part != nullptr)
      part[((size_t)ks * M + m) * N + n] = v;
    else if (out_f32)
      static_cast<float*>(out)[(size_t)m * N + n] = v;
    else
      static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16(v);
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     void* __restrict__ out, int out_f32,
                                     size_t mn, int ksplit) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < ksplit; ++k) v += part[(size_t)k * mn + i];
    if (out_f32)
      static_cast<float*>(out)[i] = v;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xq e4m3 [M, K]; xs fp32 [M, ceil(K/128)]; q e4m3 [K, N]; s fp32
// [ceil(K/128), ceil(N/128)]; out bf16 or fp32 [M, N]; work fp32
// [ksplit, M, N] (used when ksplit > 1). Requires N % 4 == 0.
extern "C" int block_fp8_gemm(const void* xq, const void* xs, const void* q,
                              const void* s, void* out, void* work, int M,
                              int K, int N, int out_f32, int ksplit,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nkb = (K + kBlock - 1) / kBlock;
  const int nnb = (N + kBlock - 1) / kBlock;
  const int bps = (nkb + ksplit - 1) / ksplit;
  float* part = ksplit > 1 ? static_cast<float*>(work) : nullptr;
  const auto* xb = static_cast<const uint8_t*>(xq);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* xsf = static_cast<const float*>(xs);
  const auto* sf = static_cast<const float*>(s);
  if (M == 1) {
    dim3 grid(nnb, 1, ksplit);
    block_fp8_gemm_kernel<1><<<grid, kThreads, kWarps * 1 * kBlockN * 4, st>>>(
        xb, xsf, qb, sf, part, out, out_f32, M, K, N, nkb, nnb, bps);
  } else {
    dim3 grid(nnb, (M + 7) / 8, ksplit);
    block_fp8_gemm_kernel<8><<<grid, kThreads, kWarps * 8 * kBlockN * 4, st>>>(
        xb, xsf, qb, sf, part, out, out_f32, M, K, N, nkb, nnb, bps);
  }
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
    splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, out_f32, mn,
                                                ksplit);
  }
  return static_cast<int>(cudaGetLastError());
}
