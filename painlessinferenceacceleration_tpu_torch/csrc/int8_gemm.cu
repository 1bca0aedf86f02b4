// int8 weight-only GEMM for Hopper (sm_90a), CUDA cores, fp32 accumulation.
//
//   out[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * q[k, n]
//
// Replaces the Pallas bodies _qmm_kernel and _qmm8_stacked_kernel
// (painlessinferenceacceleration_tpu/ops/quant_matmul.py). A stacked weight
// [L, K, N] is passed as the pointer of layer l, so one kernel serves both.
//
// Layout read directly (layers/linear.py quantize): q is int8 [K, N], N
// contiguous; scales s are bf16 [K/g, N], one per (group, column). Any group
// size that divides K is taken (a group longer than 128 rows is walked in
// chunks of at most 128 rows, each chunk's partial sum scaled by its group's
// scale), any K, and any N that is a multiple of 4.
//
// What bounds it on the H100: at decode (M = 1, 17) the weight bytes
// (K*N + K*N/g*2), so ~61 us per 7B layer at 3.35 TB/s; at prefill (M = 512)
// the multiply-adds, which this kernel does on CUDA cores (the tensor-core
// path is later work). Design, as the int4 kernel's: each thread owns 4
// adjacent columns (one 32-bit load per weight row, neighbouring threads on
// neighbouring columns); the 8 warps of a block take the chunks of the
// block's K range in turn, each staging its chunk's x slice in shared
// memory as fp32 and reading it back four k at a time; a fixed-order
// reduction over warps, then over K splits (a second kernel), keeps every
// row's sum independent of M and of the other rows, so results are
// deterministic and the same at every batch width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 32 * 4;  // 4 columns per thread
constexpr int kChunk = 128;      // K rows a warp takes at a time

__device__ __forceinline__ void unpack4(uint32_t word, float* w) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    w[c] = (float)(int)(int8_t)((word >> (8 * c)) & 0xFFu);
}

template <int MT>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N, int group,
    int chunks_per_group, int n_chunks, int chunks_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBlockN + lane * 4;
  const int m0 = blockIdx.y * MT;
  const int ks = blockIdx.z;
  const int c_begin = ks * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const bool col_ok = n0 < N;  // N % 4 == 0: a thread's 4 columns agree

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  float* xs = smem + warp * MT * kChunk;  // this warp's x slice [MT][kChunk]
  for (int ch = c_begin + warp; ch < c_end; ch += kWarps) {
    const int g = ch / chunks_per_group;
    const int k0 = g * group + (ch - g * chunks_per_group) * kChunk;
    const int len = min(kChunk, (g + 1) * group - k0);
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      for (int i = lane; i < kChunk; i += 32)
        xs[r * kChunk + i] =
            (m < M && i < len)
                ? __bfloat162float(x[(size_t)m * K + (size_t)k0 + i])
                : 0.f;
    }
    __syncwarp();
    if (col_ok) {
      float p[MT][4];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
      const int8_t* qg = q + (size_t)k0 * N + n0;
      int j = 0;
      for (; j + 4 <= len; j += 4) {
        float w[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          unpack4(*reinterpret_cast<const uint32_t*>(qg + (size_t)(j + jj) * N),
                  w[jj]);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + r * kChunk + j);
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
        unpack4(*reinterpret_cast<const uint32_t*>(qg + (size_t)j * N), w);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xs[r * kChunk + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) p[r][c] = fmaf(xv, w[c], p[r][c]);
        }
      }
      const __nv_bfloat16* sg = s + (size_t)g * N + n0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float sc = __bfloat162float(sg[c]);
#pragma unroll
        for (int r = 0; r < MT; ++r) acc[r][c] = fmaf(p[r][c], sc, acc[r][c]);
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

// x bf16 [M, K]; q int8 [K, N]; s bf16 [K/group, N]; out bf16 or fp32
// [M, N]; work fp32 [ksplit, M, N] (used when ksplit > 1). Requires
// N % 4 == 0 and K % group == 0.
extern "C" int int8_gemm(const void* x, const void* q, const void* s,
                         void* out, void* work, int M, int K, int N,
                         int group, int out_f32, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cpg = (group + kChunk - 1) / kChunk;
  const int n_chunks = (K / group) * cpg;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  float* part = ksplit > 1 ? static_cast<float*>(work) : nullptr;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  if (M == 1) {
    dim3 grid((N + kBlockN - 1) / kBlockN, 1, ksplit);
    int8_gemm_kernel<1><<<grid, kThreads, kWarps * 1 * kBlockN * 4, st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, cpg, n_chunks, cps);
  } else {
    dim3 grid((N + kBlockN - 1) / kBlockN, (M + 7) / 8, ksplit);
    int8_gemm_kernel<8><<<grid, kThreads, kWarps * 8 * kBlockN * 4, st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, cpg, n_chunks, cps);
  }
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
    splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, out_f32, mn,
                                                ksplit);
  }
  return static_cast<int>(cudaGetLastError());
}
