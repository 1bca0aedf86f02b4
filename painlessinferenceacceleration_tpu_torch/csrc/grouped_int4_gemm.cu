// Grouped (per-expert) int4 weight-only GEMM for Hopper (sm_90a), CUDA
// cores, fp32 accumulation.
//
//   out[r, n] = sum_g s[e, g, n] * sum_{k in g} x[r, k] * (nibble[e, k, n] - 8)
//   with e = block_expert[r / 128], for the rows of used blocks.
//
// Replaces the Pallas body _gqmm4_kernel
// (painlessinferenceacceleration_tpu/ops/moe_matmul.py), which the
// expert-parallel per-shard path reaches. The expert's packed weight
// [K/2, N] and scales [K/g, N] are read in the JAX layout (see
// int4_gemm.cu); the thread block reads block_expert[b], n_used[0] and
// block_rows[b] from device memory and offsets the pointers itself. Blocks
// past n_used, and row tiles that hold only padding, write zeros.
//
// What bounds it on the H100: at decode the weight bytes of the experts
// touched, at prefill the multiply-adds (CUDA cores here). The arithmetic
// is int4_tile of gemm_tiles.cuh, the dense kernel's own: same K order, same
// dealing of groups to warps, same K split, so a routed row's bits equal
// int4_gemm's on that expert's weights, at any row count.

#include "gemm_tiles.cuh"

namespace {

using namespace pia;

__global__ void __launch_bounds__(kThreads) grouped_int4_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int R, int K, int N, int group,
    int groups_per_split, GroupedRows rows) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kGroupedMT;
  const int expert = grouped_tile_expert(rows);
  if (expert < 0) {
    if (part == nullptr) zero_tile<kGroupedMT>(out, out_f32, R, N, m0);
    return;
  }
  int4_tile<kGroupedMT>(x, q + (size_t)expert * (K / 2) * N,
                        s + (size_t)expert * (K / group) * N, part, out,
                        out_f32, R, K, N, group, groups_per_split, m0,
                        blockIdx.z, smem);
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x bf16 [R, K], R = NB * 128; q uint8 [X, K/2, N]; s bf16 [X, K/group, N];
// block_expert i32 [NB], n_used i32 [1], block_rows i32 [NB] on the device;
// out bf16 or fp32 [R, N]; work fp32 [ksplit, R, N] (ksplit > 1). Requires
// N % 4 == 0, group % 8 == 0, group <= 128, K % group == 0.
extern "C" int grouped_int4_gemm(const void* x, const void* q, const void* s,
                                 const void* block_expert, const void* n_used,
                                 const void* block_rows, void* out, void* work,
                                 int R, int K, int N, int group, int out_f32,
                                 int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_groups = K / group;
  const int gps = (n_groups + ksplit - 1) / ksplit;
  float* part = ksplit > 1 ? static_cast<float*>(work) : nullptr;
  GroupedRows rows{static_cast<const int*>(block_expert),
                   static_cast<const int*>(n_used),
                   static_cast<const int*>(block_rows)};
  dim3 grid((N + kBlockN - 1) / kBlockN, R / kGroupedMT, ksplit);
  grouped_int4_gemm_kernel<<<grid, kThreads, tile_smem_bytes(kGroupedMT), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), part, out, out_f32, R, K, N, group,
      gps, rows);
  if (ksplit > 1)
    launch_grouped_splitk_reduce(part, out, out_f32, R, N, ksplit, rows, st);
  return static_cast<int>(cudaGetLastError());
}
