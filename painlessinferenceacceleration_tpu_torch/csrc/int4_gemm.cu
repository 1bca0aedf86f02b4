// int4 weight-only GEMM for Hopper (sm_90a), CUDA cores, fp32 accumulation.
//
//   out[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * (nibble[k, n] - 8)
//
// Replaces the Pallas bodies _qmm4_kernel_v3 and _qmm4_stacked_kernel_v3
// (painlessinferenceacceleration_tpu/ops/quant_matmul.py). A stacked weight
// [L, K/2, N] is passed as the pointer of layer l, so one kernel serves both.
//
// Layout read directly (layers/linear.py quantize): q is uint8 [K/2, N],
// N contiguous; byte j of a group holds row losrc[j] in its low nibble and
// row losrc[j] + g/2 in its high nibble, losrc = j/2 + (j%2)*(g/4); nibbles
// are biased by +8. Scales s are bf16 [K/g, N].
//
// What bounds it on the H100: at decode (M = 1, 17) the weight bytes
// (K*N/2 + K*N/g*2), so ~31 us per 7B layer at 3.35 TB/s; at prefill
// (M = 512) the multiply-adds, which this kernel does on CUDA cores (the
// tensor-core path is later work). Design: each thread owns 4 adjacent
// columns (one 32-bit load per packed row, neighbouring threads on
// neighbouring columns); the 8 warps of a block take the groups of the
// block's K range in turn, each staging its group's x slice in shared memory
// (x for M = 17, K = 11008 does not fit whole); a fixed-order reduction over
// warps, then over K splits (a second kernel), keeps every row's sum
// independent of M and of the other rows, so results are deterministic and
// the same at every batch width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 32 * 4;  // 4 columns per thread
constexpr int kMaxGroup = 128;

template <int MT>
__global__ void __launch_bounds__(kThreads) int4_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N, int group,
    int groups_per_split) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBlockN + lane * 4;
  const int m0 = blockIdx.y * MT;
  const int ks = blockIdx.z;
  const int n_groups = K / group;
  const int g_begin = ks * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  const int half = group / 2;
  const int quarter = group / 4;
  const bool col_ok = n0 < N;  // N % 4 == 0: a thread's 4 columns agree

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  float* xs = smem + warp * MT * kMaxGroup;  // this warp's x slice [MT][g]
  for (int g = g_begin + warp; g < g_end; g += kWarps) {
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      for (int c = lane; c < group; c += 32)
        xs[r * kMaxGroup + c] =
            m < M ? __bfloat162float(x[(size_t)m * K + (size_t)g * group + c])
                  : 0.f;
    }
    __syncwarp();
    if (col_ok) {
      float p[MT][4];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
      const uint8_t* qg = q + (size_t)g * half * N + n0;
      for (int j = 0; j < half; ++j) {
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(qg + (size_t)j * N);
        const int lo_row = (j >> 1) + (j & 1) * quarter;
        const int hi_row = lo_row + half;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (word >> (8 * c)) & 0xFFu;
          const float wl = (float)((int)(byte & 0xFu) - 8);
          const float wh = (float)((int)(byte >> 4) - 8);
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            p[r][c] = fmaf(xs[r * kMaxGroup + lo_row], wl, p[r][c]);
            p[r][c] = fmaf(xs[r * kMaxGroup + hi_row], wh, p[r][c]);
          }
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

// x bf16 [M, K]; q uint8 [K/2, N]; s bf16 [K/group, N]; out bf16 or fp32
// [M, N]; work fp32 [ksplit, M, N] (used when ksplit > 1). Requires
// N % 4 == 0, group % 8 == 0, group <= 128, K % group == 0.
extern "C" int int4_gemm(const void* x, const void* q, const void* s,
                         void* out, void* work, int M, int K, int N,
                         int group, int out_f32, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_groups = K / group;
  const int gps = (n_groups + ksplit - 1) / ksplit;
  float* part = ksplit > 1 ? static_cast<float*>(work) : nullptr;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  if (M == 1) {
    dim3 grid((N + kBlockN - 1) / kBlockN, 1, ksplit);
    int4_gemm_kernel<1><<<grid, kThreads, kWarps * 1 * kMaxGroup * 4, st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, gps);
  } else {
    dim3 grid((N + kBlockN - 1) / kBlockN, (M + 7) / 8, ksplit);
    int4_gemm_kernel<8><<<grid, kThreads, kWarps * 8 * kMaxGroup * 4, st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, gps);
  }
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
    splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, out_f32, mn,
                                                ksplit);
  }
  return static_cast<int>(cudaGetLastError());
}
