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
// the same at every batch width. The body is int4_tile in gemm_tiles.cuh,
// which the grouped (per-expert) kernel shares.

#include "gemm_tiles.cuh"

namespace {

using namespace pia;

template <int MT>
__global__ void __launch_bounds__(kThreads) int4_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N, int group,
    int groups_per_split) {
  extern __shared__ __align__(16) float smem[];
  int4_tile<MT>(x, q, s, part, out, out_f32, M, K, N, group, groups_per_split,
                blockIdx.y * MT, blockIdx.z, smem);
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
    int4_gemm_kernel<1><<<grid, kThreads, tile_smem_bytes(1), st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, gps);
  } else {
    dim3 grid((N + kBlockN - 1) / kBlockN, (M + 7) / 8, ksplit);
    int4_gemm_kernel<8><<<grid, kThreads, tile_smem_bytes(8), st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, gps);
  }
  if (ksplit > 1)
    launch_splitk_reduce(part, out, out_f32, (size_t)M * N, ksplit, st);
  return static_cast<int>(cudaGetLastError());
}
