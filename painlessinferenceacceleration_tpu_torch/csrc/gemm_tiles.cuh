// The split-k reductions and the grouped-row tables of the tensor-core
// GEMMs: the weight-only kernels (weight_only_wgmma.cuh: int4 K1 / K11,
// int8 K7 / K12) and the bf16 kernels (bf16_wgmma.cuh: K10's dense,
// head-batched and grouped entries).
//
// A K split launched as blocks writes an fp32 plane of its partial sums;
// the reduction adds the planes in split order, total = 0 + p0 + p1 + ...,
// the order in which a block that runs every split of its tile adds them,
// so a row's bits do not depend on how the splits were launched.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pia {

constexpr int kBlockM = 128;  // rows of one expert block (moe_align)

// Sum of the K splits' partial planes in split order, for a dense GEMM.
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

inline void launch_splitk_reduce(const float* part, void* out, int out_f32,
                                 size_t mn, int ksplit, cudaStream_t st) {
  const size_t want = (mn + 255) / 256;
  const int blocks = (int)(want < 8192 ? want : 8192);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, out_f32, mn, ksplit);
}

// ---------------------------------------------------------------------------
// Grouped (per-expert) launches: rows come in blocks of kBlockM, block b
// belongs to expert block_expert[b]; blocks b >= n_used[0] hold no routed row
// and give zeros, as do the rows of a used block past block_rows[b] (the
// expert run's padding, whose x rows are zero). All three tables are read on
// the device, so nothing waits for the host: the grouped kernels bound their
// grids by the routing's pair count and reduce their splits here over the
// blocks they launched.
// ---------------------------------------------------------------------------

struct GroupedRows {
  const int* block_expert;  // [NB]
  const int* n_used;        // [1]
  const int* block_rows;    // [NB] routed rows at the head of each block
};

// The K splits' sum for grouped rows: blocks that were skipped (no routed
// row) have no partials and get zeros. A launched block writes zeros past
// its routed rows, so testing the rows in groups of 8 gives the same sums.
__global__ void grouped_splitk_reduce_kernel(const float* __restrict__ part,
                                             void* __restrict__ out,
                                             int out_f32, int R, int N,
                                             int ksplit, GroupedRows g) {
  const size_t mn = (size_t)R * N;
  const int n_used = g.n_used[0];
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / N);
    const int b = m / kBlockM;
    const int tile_row = (m - b * kBlockM) / 8 * 8;
    float v = 0.f;
    if (b < n_used && tile_row < g.block_rows[b])
      for (int k = 0; k < ksplit; ++k) v += part[(size_t)k * mn + i];
    if (out_f32)
      static_cast<float*>(out)[i] = v;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
}

inline void launch_grouped_splitk_reduce(const float* part, void* out,
                                         int out_f32, int R, int N, int ksplit,
                                         GroupedRows g, cudaStream_t st) {
  const size_t want = ((size_t)R * N + 255) / 256;
  const int blocks = (int)(want < 8192 ? want : 8192);
  grouped_splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, out_f32, R, N,
                                                      ksplit, g);
}

}  // namespace pia
