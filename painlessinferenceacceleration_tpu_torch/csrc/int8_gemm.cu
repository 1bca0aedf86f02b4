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
// deterministic and the same at every batch width. The body is int8_tile in
// gemm_tiles.cuh, which the grouped (per-expert) kernel shares.

#include "gemm_tiles.cuh"

namespace {

using namespace pia;

template <int MT>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N, int group,
    int chunks_per_group, int n_chunks, int chunks_per_split) {
  extern __shared__ __align__(16) float smem[];
  int8_tile<MT>(x, q, s, part, out, out_f32, M, K, N, group, chunks_per_group,
                n_chunks, chunks_per_split, blockIdx.y * MT, blockIdx.z, smem);
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
    int8_gemm_kernel<1><<<grid, kThreads, tile_smem_bytes(1), st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, cpg, n_chunks, cps);
  } else {
    dim3 grid((N + kBlockN - 1) / kBlockN, (M + 7) / 8, ksplit);
    int8_gemm_kernel<8><<<grid, kThreads, tile_smem_bytes(8), st>>>(
        xb, qb, sb, part, out, out_f32, M, K, N, group, cpg, n_chunks, cps);
  }
  if (ksplit > 1)
    launch_splitk_reduce(part, out, out_f32, (size_t)M * N, ksplit, st);
  return static_cast<int>(cudaGetLastError());
}
