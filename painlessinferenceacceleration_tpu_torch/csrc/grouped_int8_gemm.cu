// Grouped (per-expert) int8 weight-only GEMM for Hopper (sm_90a) on the
// tensor cores (wgmma).
//
//   out[r, n] = sum_g s[e, g, n] * sum_{k in g} x[r, k] * q[e, k, n]
//   with e = block_expert[r / 128], for the routed rows of used blocks.
//
// Replaces the Pallas body _gqmm8_kernel
// (painlessinferenceacceleration_tpu/ops/moe_matmul.py), which the
// expert-parallel per-shard path reaches. The expert's weight [K, N] and
// scales [K/g, N] are read in the JAX layout (see int8_gemm.cu); a thread
// block reads block_expert[b], n_used[0] and block_rows[b] from device
// memory and offsets the pointers itself.
//
// What bounds it on the H100: at decode the weight bytes of the experts
// touched, at prefill the products (2 x routed rows x K x N at 989 TFLOP/s).
// The design, as grouped_int4_gemm.cu's: one expert block (128 rows) is the
// token tile of weight_only_wgmma.cuh, the dense int8 kernel's body with two
// multiplying warpgroups: the same stages, k16 steps, instruction and K
// split (run in one block or across blocks, as the dense kernel's plan
// decides from the grid), so a routed row's bits equal int8_gemm's on that
// expert's weights at any row count. The column blocks of one row block are
// launched next to each other, as grouped_int4_gemm.cu does: int8_gemm.cu's
// order (the row blocks of a column block together) was slower here, at
// Mixtral-8x7B's and Qwen3-30B-A3B's routings (tools/k7_variants.py). The grid's row extent is bounded by the
// blocks a routing of n_pairs (token, expert) pairs can use, min(NB, min(X,
// n_pairs) + ceil(n_pairs / 128)), which the host knows from shapes; the
// rows past the bound are zeroed by a memset. Blocks past n_used and rows of
// a block past block_rows[b] read nothing and give exact zeros.

#include "gemm_tiles.cuh"
#include "weight_only_wgmma.cuh"

namespace {

using pia::GroupedRows;
using pia::kBlockM;
using piawo::kCols;
using piawo::kThreads;
using piawo::Tile;

template <int C, bool kSeq>
__global__ void __launch_bounds__(kThreads, 1) grouped_int8_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap qm,
    const __grid_constant__ CUtensorMap sm, float* __restrict__ part,
    int part_rows, void* __restrict__ out, int out_f32, int R, int K, int N,
    int group, int stages_per_split, GroupedRows rows) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int b = blockIdx.y;
  const int m0 = b * kBlockM;
  const int n0 = blockIdx.x * kCols;
  int valid = 0;
  int expert = 0;
  if (b < rows.n_used[0]) {
    valid = min(rows.block_rows[b], kBlockM);
    expert = rows.block_expert[b];
  }
  if (valid <= 0) {  // no routed row: zeros (with a split, the reduction's)
    if (part != nullptr) return;
    for (int e = threadIdx.x; e < kBlockM * kCols; e += kThreads) {
      const int m = m0 + e / kCols;
      const int n = n0 + e % kCols;
      if (m >= R || n >= N) continue;
      if (out_f32)
        static_cast<float*>(out)[(size_t)m * N + n] = 0.f;
      else
        static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16(0.f);
    }
    return;
  }
  // one split a block, or every split in this block
  const int g_begin = kSeq ? 0 : blockIdx.z * stages_per_split;
  const int g_end = kSeq ? K / C : min(K / C, g_begin + stages_per_split);
  const piawo::Maps maps{&xm, &qm, &sm, expert * K, expert * (K / group), group / C};
  piawo::wgmma_tile<true, C, 2, kSeq>(maps, part, part_rows, out, out_f32, R, N, m0, n0,
                                      valid, g_begin, g_end, stages_per_split,
                                      blockIdx.z, smem);
}

template <int C, bool kSeq>
cudaError_t launch(const void* x, const void* q, const void* s, float* part,
                   void* out, int out_f32, int R, int K, int N, int X, int group,
                   int split_blocks, int sps, int row_blocks, GroupedRows rows,
                   cudaStream_t st) {
  using T = Tile<true, C, 2>;
  static bool done[64] = {};
  cudaError_t err =
      piawo::allow_smem(grouped_int8_gemm_kernel<C, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, qm, sm;
  if (!piawo::make_maps<true, C, 2>(&xm, &qm, &sm, x, q, s, R, K, X * K,
                                    X * (K / group), N))
    return cudaErrorInvalidValue;
  dim3 grid((N + kCols - 1) / kCols, row_blocks, split_blocks);
  grouped_int8_gemm_kernel<C, kSeq><<<grid, kThreads, T::kSmem, st>>>(
      xm, qm, sm, part, row_blocks * kBlockM, out, out_f32, R, K, N, group, sps, rows);
  return cudaSuccess;
}

using Launch = decltype(&launch<128, false>);

template <bool kSeq>
Launch pick(int stage) {
  return stage == 128 ? launch<128, kSeq> : stage == 64 ? launch<64, kSeq>
         : stage == 32 ? launch<32, kSeq> : nullptr;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x bf16 [R, K], R = NB * 128; q int8 [X, K, N]; s bf16 [X, K/group, N];
// block_expert i32 [NB], n_used i32 [1], block_rows i32 [NB] on the device;
// out bf16 or fp32 [R, N]; work fp32 [split_blocks, row_blocks * 128, N]
// (split_blocks > 1). The wrapper's plan (ops/moe_matmul.py
// grouped_int8_plan) gives stages_per_split (the dense kernel's),
// split_blocks (the splits launched one a block, or 1: each block runs them
// all in order) and row_blocks <= NB; it requires group % 32 == 0, K %
// group == 0, N % 16 == 0 and 16-byte aligned operands.
extern "C" int grouped_int8_gemm(const void* x, const void* q, const void* s,
                                 const void* block_expert, const void* n_used,
                                 const void* block_rows, void* out, void* work,
                                 int R, int K, int N, int X, int group,
                                 int out_f32, int split_blocks, int stages_per_split,
                                 int row_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = split_blocks > 1 ? static_cast<float*>(work) : nullptr;
  GroupedRows rows{static_cast<const int*>(block_expert),
                   static_cast<const int*>(n_used),
                   static_cast<const int*>(block_rows)};
  if (group <= 0 || K % group) return static_cast<int>(cudaErrorInvalidValue);
  const size_t elt = out_f32 ? 4 : 2;
  const size_t bounded = (size_t)row_blocks * kBlockM;
  if (bounded < (size_t)R) {
    cudaError_t err = cudaMemsetAsync(static_cast<char*>(out) + bounded * N * elt,
                                      0, ((size_t)R - bounded) * N * elt, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (row_blocks > 0) {
    const int stage = piawo::int8_stage(group);
    // several splits in one block
    const bool seq = split_blocks == 1 && (long long)stages_per_split * stage < K;
    Launch fn = seq ? pick<true>(stage) : pick<false>(stage);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = fn(x, q, s, part, out, out_f32, R, K, N, X, group, split_blocks,
                         stages_per_split, row_blocks, rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (split_blocks > 1)  // the first row_blocks blocks, planes of as many rows
      pia::launch_grouped_splitk_reduce(part, out, out_f32, (int)bounded, N,
                                        split_blocks, rows, st);
  }
  return static_cast<int>(cudaGetLastError());
}
