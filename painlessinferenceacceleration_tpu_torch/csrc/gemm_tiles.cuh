// The row-tile GEMM body of the bf16 kernels (grouped_gemm.cu: the dense,
// head-batched and grouped entries), on CUDA cores with fp32 accumulation,
// and the split-k reductions and grouped-row tables that the tensor-core
// weight-only kernels (weight_only_wgmma.cuh: int4 and int8) use too.
//
// One thread block computes MT rows x 128 columns over one K split. Each
// thread owns 4 adjacent columns; the 8 warps take the 128-row chunks of
// the split's K range in turn, each staging its chunk's x slice in shared
// memory as fp32; then a fixed-order sum over the warps, and over the K
// splits in a second kernel. A row's sum therefore depends on (K, N, the
// split) only: not on MT, not on the row's place in its tile, not on the
// other rows, not on which weight pointer (expert) the block was given. The
// dense and the grouped entries call the same body, so a routed row's bits
// equal the dense entry's on the same expert's weights.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pia {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 32 * 4;  // 4 columns per thread
constexpr int kChunk = 128;      // K rows a warp takes at a time
constexpr int kGroupedMT = 8;    // row-tile height of the grouped bf16 kernel
constexpr int kBlockM = 128;     // rows of one expert block (moe_align)

// Bytes of dynamic shared memory a tile of MT rows needs: the x slices
// [kWarps][MT][128] and, after them in time, the warp partials
// [kWarps][MT][kBlockN].
constexpr int tile_smem_bytes(int mt) { return kWarps * mt * 128 * 4; }

// Fixed-order reduction over the warps of the block, then the store: to the
// K split's partial plane when there is one, else to the output.
template <int MT>
__device__ __forceinline__ void reduce_store(float (&acc)[MT][4], float* smem,
                                             float* __restrict__ part,
                                             void* __restrict__ out, int out_f32,
                                             int M, int N, int m0, int ks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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

// Zeros for the MT x 128 output tile of a row tile that holds no routed row.
template <int MT>
__device__ __forceinline__ void zero_tile(void* __restrict__ out, int out_f32,
                                          int M, int N, int m0) {
  for (int e = threadIdx.x; e < MT * kBlockN; e += kThreads) {
    const int m = m0 + e / kBlockN;
    const int n = blockIdx.x * kBlockN + e % kBlockN;
    if (m >= M || n >= N) continue;
    if (out_f32)
      static_cast<float*>(out)[(size_t)m * N + n] = 0.f;
    else
      static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void unpack_bf16x4(uint2 v, float* w) {
  // a bf16 is the high half of the fp32 with the same value
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xFFFF0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

// bf16: w [K, N] with N contiguous, or (WT) the transpose [N, K] with K
// contiguous, as a tied LM head reads the embedding table. Chunks of 128 K
// rows, k ascending inside a chunk, straight into the accumulator.
template <int MT, bool WT>
__device__ __forceinline__ void bf16_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ part, void* __restrict__ out, int out_f32, int M,
    int K, int N, int n_chunks, int chunks_per_split, int m0, int ks,
    float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBlockN + lane * 4;
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
    const int k0 = ch * kChunk;
    const int len = min(kChunk, K - k0);
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
      int j = 0;
      for (; j + 4 <= len; j += 4) {
        float wv[4][4];  // [k][column]
        if (WT) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float col[4];  // 4 consecutive k of column n0 + c (K % 4 == 0)
            unpack_bf16x4(*reinterpret_cast<const uint2*>(
                              w + (size_t)(n0 + c) * K + (size_t)(k0 + j)),
                          col);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) wv[jj][c] = col[jj];
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            unpack_bf16x4(*reinterpret_cast<const uint2*>(
                              w + (size_t)(k0 + j + jj) * N + n0),
                          wv[jj]);
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + r * kChunk + j);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(xv.x, wv[0][c], acc[r][c]);
            acc[r][c] = fmaf(xv.y, wv[1][c], acc[r][c]);
            acc[r][c] = fmaf(xv.z, wv[2][c], acc[r][c]);
            acc[r][c] = fmaf(xv.w, wv[3][c], acc[r][c]);
          }
        }
      }
      for (; j < len; ++j) {
        float wv[4];
        if (WT) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wv[c] = __bfloat162float(w[(size_t)(n0 + c) * K + (size_t)(k0 + j)]);
        } else {
          unpack_bf16x4(*reinterpret_cast<const uint2*>(
                            w + (size_t)(k0 + j) * N + n0),
                        wv);
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = xs[r * kChunk + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
  }
  reduce_store<MT>(acc, smem, part, out, out_f32, M, N, m0, ks);
}

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
// the device, so nothing waits for the host: the bf16 kernel's grid is the
// static worst case (the int4 and int8 kernels bound theirs by the routing's
// pair count and reduce their splits here over the blocks they launched).
// ---------------------------------------------------------------------------

struct GroupedRows {
  const int* block_expert;  // [NB]
  const int* n_used;        // [1]
  const int* block_rows;    // [NB] routed rows at the head of each block
};

// The expert of this block's row tile, or -1 where the tile holds no routed
// row. blockIdx.y counts row tiles of kGroupedMT rows.
__device__ __forceinline__ int grouped_tile_expert(const GroupedRows& g) {
  const int m0 = blockIdx.y * kGroupedMT;
  const int b = m0 / kBlockM;
  if (b >= g.n_used[0] || m0 - b * kBlockM >= g.block_rows[b]) return -1;
  return g.block_expert[b];
}

// The K splits' sum for grouped rows: row tiles that were skipped have no
// partials and get zeros.
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
    const int tile_row = (m - b * kBlockM) / kGroupedMT * kGroupedMT;
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
