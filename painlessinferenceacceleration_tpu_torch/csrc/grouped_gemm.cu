// Grouped (per-expert) bf16 GEMM, and the dense bf16 GEMM, for Hopper
// (sm_90a), CUDA cores, fp32 accumulation.
//
//   grouped: out[r, :] = x[r, :] @ w[block_expert[r / 128]]   (r in a used block)
//   dense:   out[m, :] = x[m, :] @ w        (or @ w^T for a [N, K] table)
//
// Replaces the Pallas body _gmm_kernel
// (painlessinferenceacceleration_tpu/ops/moe_matmul.py). There the weight
// BlockSpec's index map reads the block -> expert table from scalar prefetch;
// here every thread block reads block_expert[b], n_used[0] and block_rows[b]
// from device memory and offsets the weight pointer itself, so the host
// never waits for the routing and the grid is the static worst case. Blocks
// past n_used, and the row tiles of a used block that hold only padding,
// write zeros without touching the weights.
//
// The dense entry is the same body with the one weight: the native bf16
// linears, the router product and the LM head go through it, so a bf16
// model has one GEMM arithmetic, and a token's expert output is the same
// bits whether it was routed (grouped path) or swept (scan path). The
// batched entry runs that body once per head on a head's own weight: MLA's
// weight absorption (q_nope . W_uk^T and out . W_uv, computed by XLA
// outside Pallas in the JAX package), so their rows too do not depend on M.
//
// What bounds it on the H100: at decode the weight bytes (2*K*N per expert
// touched); at prefill the multiply-adds, on CUDA cores here (the
// tensor-core path is later work). Design: bf16_tile in gemm_tiles.cuh: a
// thread owns 4 adjacent columns (one 8-byte load per weight row), the 8
// warps take 128-row chunks of K in turn, k ascending inside a chunk, then a
// fixed-order sum over warps and K splits: a row's bits do not depend on
// the row count, on the row's place, on its block or on how many blocks are
// used.

#include "gemm_tiles.cuh"

namespace {

using namespace pia;

template <int MT, bool WT>
__global__ void __launch_bounds__(kThreads) bf16_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ part, void* __restrict__ out, int out_f32, int M,
    int K, int N, int n_chunks, int chunks_per_split) {
  extern __shared__ __align__(16) float smem[];
  bf16_tile<MT, WT>(x, w, part, out, out_f32, M, K, N, n_chunks,
                    chunks_per_split, blockIdx.y * MT, blockIdx.z, smem);
}

// One weight per blockIdx.z (a head of MLA's absorption products): x, w
// and out advance by one [M, K], [K, N], [M, N] plane per batch entry. No K
// split: the products it serves have K <= 512, under the 8 chunks a split
// needs (chunk_ksplit).
template <int MT>
__global__ void __launch_bounds__(kThreads) bf16_gemm_batched_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    void* __restrict__ out, int out_f32, int M, int K, int N, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const size_t g = blockIdx.z;
  char* o = static_cast<char*>(out) + g * M * N * (out_f32 ? 4 : 2);
  bf16_tile<MT, false>(x + g * M * K, w + g * K * N, nullptr, o, out_f32, M, K, N,
                       n_chunks, n_chunks, blockIdx.y * MT, 0, smem);
}

__global__ void __launch_bounds__(kThreads) grouped_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ part, void* __restrict__ out, int out_f32, int R,
    int K, int N, int n_chunks, int chunks_per_split, GroupedRows rows) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kGroupedMT;
  const int expert = grouped_tile_expert(rows);
  if (expert < 0) {
    if (part == nullptr) zero_tile<kGroupedMT>(out, out_f32, R, N, m0);
    return;
  }
  bf16_tile<kGroupedMT, false>(x, w + (size_t)expert * K * N, part, out,
                               out_f32, R, K, N, n_chunks, chunks_per_split,
                               m0, blockIdx.z, smem);
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x bf16 [M, K]; w bf16 [K, N], or [N, K] when transposed; out bf16 or fp32
// [M, N]; work fp32 [ksplit, M, N] (used when ksplit > 1). Requires
// N % 4 == 0 (and K % 4 == 0 when transposed), w on an 8-byte boundary.
extern "C" int bf16_gemm(const void* x, const void* w, void* out, void* work,
                         int M, int K, int N, int transposed, int out_f32,
                         int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  float* part = ksplit > 1 ? static_cast<float*>(work) : nullptr;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const int col_blocks = (N + kBlockN - 1) / kBlockN;
  if (M == 1) {
    dim3 grid(col_blocks, 1, ksplit);
    if (transposed)
      bf16_gemm_kernel<1, true><<<grid, kThreads, tile_smem_bytes(1), st>>>(
          xb, wb, part, out, out_f32, M, K, N, n_chunks, cps);
    else
      bf16_gemm_kernel<1, false><<<grid, kThreads, tile_smem_bytes(1), st>>>(
          xb, wb, part, out, out_f32, M, K, N, n_chunks, cps);
  } else {
    dim3 grid(col_blocks, (M + 7) / 8, ksplit);
    if (transposed)
      bf16_gemm_kernel<8, true><<<grid, kThreads, tile_smem_bytes(8), st>>>(
          xb, wb, part, out, out_f32, M, K, N, n_chunks, cps);
    else
      bf16_gemm_kernel<8, false><<<grid, kThreads, tile_smem_bytes(8), st>>>(
          xb, wb, part, out, out_f32, M, K, N, n_chunks, cps);
  }
  if (ksplit > 1)
    launch_splitk_reduce(part, out, out_f32, (size_t)M * N, ksplit, st);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [G, M, K]; w bf16 [G, K, N]; out bf16 or fp32 [G, M, N]:
// out[g] = x[g] @ w[g], each plane by the dense entry's body without a K
// split. Requires N % 4 == 0, w on an 8-byte boundary, G <= 65535.
extern "C" int bf16_gemm_batched(const void* x, const void* w, void* out, int G,
                                 int M, int K, int N, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const int col_blocks = (N + kBlockN - 1) / kBlockN;
  if (M == 1) {
    dim3 grid(col_blocks, 1, G);
    bf16_gemm_batched_kernel<1><<<grid, kThreads, tile_smem_bytes(1), st>>>(
        xb, wb, out, out_f32, M, K, N, n_chunks);
  } else {
    dim3 grid(col_blocks, (M + 7) / 8, G);
    bf16_gemm_batched_kernel<8><<<grid, kThreads, tile_smem_bytes(8), st>>>(
        xb, wb, out, out_f32, M, K, N, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [R, K], R = NB * 128 rows grouped by expert; w bf16 [X, K, N];
// block_expert i32 [NB], n_used i32 [1], block_rows i32 [NB], all on the
// device; out bf16 or fp32 [R, N]; work fp32 [ksplit, R, N] (ksplit > 1).
// Requires N % 4 == 0.
extern "C" int grouped_gemm(const void* x, const void* w,
                            const void* block_expert, const void* n_used,
                            const void* block_rows, void* out, void* work,
                            int R, int K, int N, int out_f32, int ksplit,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int cps = (n_chunks + ksplit - 1) / ksplit;
  float* part = ksplit > 1 ? static_cast<float*>(work) : nullptr;
  GroupedRows rows{static_cast<const int*>(block_expert),
                   static_cast<const int*>(n_used),
                   static_cast<const int*>(block_rows)};
  dim3 grid((N + kBlockN - 1) / kBlockN, R / kGroupedMT, ksplit);
  grouped_gemm_kernel<<<grid, kThreads, tile_smem_bytes(kGroupedMT), st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), part, out, out_f32, R, K, N,
      n_chunks, cps, rows);
  if (ksplit > 1)
    launch_grouped_splitk_reduce(part, out, out_f32, R, N, ksplit, rows, st);
  return static_cast<int>(cudaGetLastError());
}
