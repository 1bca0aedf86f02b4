// The bf16 GEMM for Hopper (sm_90a) on the tensor cores (wgmma), fp32
// accumulation, in three entries over one body (bf16_wgmma.cuh):
//
//   dense:   out[m, :] = x[m, :] @ w        (or @ w^T for a [N, K] table)
//   batched: out[g, m, :] = x[g, m, :] @ w[g]           (one weight a head)
//   grouped: out[r, :] = x[r, :] @ w[block_expert[r / 128]]  (r in a used block)
//
// Replaces the Pallas body _gmm_kernel
// (painlessinferenceacceleration_tpu/ops/moe_matmul.py). There the weight
// BlockSpec's index map reads the block -> expert table from scalar prefetch;
// here every thread block reads block_expert[b], n_used[0] and block_rows[b]
// from device memory and offsets its weight plane itself, so the host never
// waits for the routing. The grid's row extent is bounded by the blocks a
// routing of n_pairs (token, expert) pairs can use, min(NB, min(X, n_pairs)
// + ceil(n_pairs / 128)), which the host knows from shapes; the rows past the
// bound are zeroed by a memset, blocks past n_used and the rows of a block
// past block_rows[b] read nothing and give exact zeros.
//
// The dense entry is the same body with the one weight: the native bf16
// linears, the router product and the LM head go through it, so a bf16
// model has one GEMM arithmetic, and a token's expert output is the same
// bits whether it was routed (grouped path) or swept (scan path). The
// batched entry runs that body once per head on a head's own weight: MLA's
// weight absorption (q_nope . W_uk^T and out . W_uv, computed by XLA
// outside Pallas in the JAX package), so their rows too do not depend on M.
//
// What bounds it on the H100: at decode the weight bytes (2 K N per weight
// or expert touched: 15 us for a 4096 x 6144 wqkv at 3.35 TB/s); at prefill
// the products, 2 M K N at 989 TFLOP/s. The design: the products on the
// tensor cores straight from the bf16 weight as TMA lands it (no conversion
// pass, so the shared memory a weight-only kernel spends on its unpacked
// operand holds ring stages here: 7-8 stages of 64 k), a producer warp that
// keeps the ring full against per-slot mbarriers, a weight stage fetched
// once per 64 or 128 token rows, and a K split chosen from (K, N) alone to
// fill the 132 SMs at decode. Where the splits run as blocks, the last
// block of each tile sums their planes: one launch a call, as the
// wrapper's host time at decode is as long as the kernel's. The row tiles
// of one column block are launched next to each other, so that at prefill
// they share the column block's weight stages through L2; the grouped
// entry walks its grid in bands of row blocks, so that the blocks in flight
// share a band's x rows and its experts' weight columns (tools/
// k10_variants.py times the other orders).

#include "bf16_wgmma.cuh"
#include "gemm_tiles.cuh"

namespace {

using namespace piabf;
using pia::GroupedRows;
using pia::kBlockM;

__host__ __device__ inline int n_stages(int K) { return (K + kStage - 1) / kStage; }

// part: the splits' planes [gridDim.z, M, N] and count: a counter a tile,
// where the splits are launched as blocks (gridDim.z > 1)
template <int W, bool kKMajor, bool kSeq>
__global__ void __launch_bounds__(Tile<W>::kThreads, 1) bf16_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
    float* __restrict__ part, int* __restrict__ count, void* __restrict__ out, int out_f32,
    int M, int K, int N, int stages_per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  // the row tiles of one column block are launched next to each other
  const int m0 = blockIdx.x * Tile<W>::kRows;
  // one split a block, or every split in this block
  const int g_begin = kSeq ? 0 : blockIdx.z * stages_per_split;
  const int g_end = kSeq ? n_stages(K) : min(n_stages(K), g_begin + stages_per_split);
  const Splits sp{part, M, (int)blockIdx.z, (int)gridDim.z,
                  count + blockIdx.y * gridDim.x + blockIdx.x};
  gemm_tile<W, kKMajor, kSeq>(Operands{&xm, &wm, 0, 0}, sp, out, out_f32, M, N, m0,
                              blockIdx.y * kCols, min(M - m0, Tile<W>::kRows), g_begin,
                              g_end, stages_per_split, smem);
}

// head blockIdx.z: x, w and out planes [M, K], [K, N], [M, N]; every split
// of the head's K in this block
template <int W, bool kSeq>
__global__ void __launch_bounds__(Tile<W>::kThreads, 1) bf16_gemm_batched_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
    void* __restrict__ out, int out_f32, int M, int K, int N, int stages_per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * Tile<W>::kRows;
  char* o = static_cast<char*>(out) + (size_t)g * M * N * (out_f32 ? 4 : 2);
  gemm_tile<W, false, kSeq>(Operands{&xm, &wm, g, g}, Splits{}, o, out_f32, M, N, m0,
                            blockIdx.y * kCols, min(M - m0, Tile<W>::kRows), 0,
                            n_stages(K), stages_per_split, smem);
}

// The grid is one line of row_blocks x column blocks (x the splits in z),
// walked in bands of kBand row blocks: the blocks in flight share a band's
// x rows and its experts' weight columns through L2.
constexpr int kBand = 8;

template <bool kSeq>
__global__ void __launch_bounds__(Tile<2>::kThreads, 1) grouped_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
    float* __restrict__ part, int* __restrict__ count, void* __restrict__ out, int out_f32,
    int R, int K, int N, int row_blocks, int stages_per_split, GroupedRows rows) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int cols = (N + kCols - 1) / kCols;
  const int band = blockIdx.x / (kBand * cols);
  const int in_band = min(kBand, row_blocks - band * kBand);
  const int i = blockIdx.x - band * kBand * cols;
  const int b = band * kBand + i % in_band;
  const int m0 = b * kBlockM;
  const int n0 = (i / in_band) * kCols;
  int valid = 0;
  int expert = 0;
  if (b < rows.n_used[0]) {
    valid = min(rows.block_rows[b], kBlockM);
    expert = rows.block_expert[b];
  }
  if (valid <= 0) {  // no routed row: zeros, written by the first split's block
    if (blockIdx.z > 0) return;
    for (int e = threadIdx.x; e < kBlockM * kCols; e += blockDim.x) {
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
  const int g_begin = kSeq ? 0 : blockIdx.z * stages_per_split;
  const int g_end = kSeq ? n_stages(K) : min(n_stages(K), g_begin + stages_per_split);
  const Splits sp{part, row_blocks * kBlockM, (int)blockIdx.z, (int)gridDim.z,
                  count + blockIdx.x};
  gemm_tile<2, false, kSeq>(Operands{&xm, &wm, 0, expert}, sp, out, out_f32, R, N, m0, n0,
                            valid, g_begin, g_end, stages_per_split, smem);
}

template <int W, bool kKMajor, bool kSeq>
cudaError_t launch_dense(const void* x, const void* w, float* part, int* count, void* out,
                         int out_f32, int M, int K, int N, int split_blocks, int sps,
                         cudaStream_t st) {
  using T = Tile<W>;
  static bool done[64] = {};
  cudaError_t err = piawg::allow_smem(bf16_gemm_kernel<W, kKMajor, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, wm;
  if (!make_maps<W>(&xm, &wm, x, w, 1, M, K, 1, N, kKMajor)) return cudaErrorInvalidValue;
  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);
  bf16_gemm_kernel<W, kKMajor, kSeq><<<grid, T::kThreads, T::kSmem, st>>>(
      xm, wm, part, count, out, out_f32, M, K, N, sps);
  return cudaSuccess;
}

using DenseLaunch = decltype(&launch_dense<1, false, false>);

template <bool kSeq>
DenseLaunch pick_dense(int warpgroups, bool k_major) {
  if (warpgroups == 1)
    return k_major ? launch_dense<1, true, kSeq> : launch_dense<1, false, kSeq>;
  if (warpgroups == 2)
    return k_major ? launch_dense<2, true, kSeq> : launch_dense<2, false, kSeq>;
  return nullptr;
}

template <int W, bool kSeq>
cudaError_t launch_batched(const void* x, const void* w, void* out, int out_f32, int G,
                           int M, int K, int N, int sps, cudaStream_t st) {
  using T = Tile<W>;
  static bool done[64] = {};
  cudaError_t err = piawg::allow_smem(bf16_gemm_batched_kernel<W, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, wm;
  if (!make_maps<W>(&xm, &wm, x, w, G, M, K, G, N, false)) return cudaErrorInvalidValue;
  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, G);
  bf16_gemm_batched_kernel<W, kSeq><<<grid, T::kThreads, T::kSmem, st>>>(
      xm, wm, out, out_f32, M, K, N, sps);
  return cudaSuccess;
}

template <bool kSeq>
cudaError_t launch_grouped(const void* x, const void* w, float* part, int* count, void* out,
                           int out_f32, int R, int K, int N, int X, int split_blocks,
                           int sps, int row_blocks, GroupedRows rows, cudaStream_t st) {
  using T = Tile<2>;
  static bool done[64] = {};
  cudaError_t err = piawg::allow_smem(grouped_gemm_kernel<kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, wm;
  if (!make_maps<2>(&xm, &wm, x, w, 1, R, K, X, N, false)) return cudaErrorInvalidValue;
  dim3 grid(row_blocks * ((N + kCols - 1) / kCols), 1, split_blocks);
  grouped_gemm_kernel<kSeq><<<grid, T::kThreads, T::kSmem, st>>>(
      xm, wm, part, count, out, out_f32, R, K, N, row_blocks, sps, rows);
  return cudaSuccess;
}

// several splits in one block
inline bool sequential(int split_blocks, int sps, int K) {
  return split_blocks == 1 && (long long)sps * kStage < K;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (the ring and its barriers), for the
// build report; -1 for a configuration that does not exist.
extern "C" int bf16_gemm_smem_bytes(int warpgroups) {
  return warpgroups == 1 ? Tile<1>::kSmem : warpgroups == 2 ? Tile<2>::kSmem : -1;
}

// x bf16 [M, K]; w bf16 [K, N], or [N, K] when transposed; out bf16 or fp32
// [M, N]; where split_blocks > 1, work fp32 [split_blocks, M, N] and count
// i32 [row tiles x column blocks], zeros (each call leaves them so). The
// wrapper's plan (ops/moe_matmul.py bf16_plan) gives stages_per_split
// (every split non-empty), split_blocks (the splits, launched one a block,
// or 1: each block runs them all in order) and warpgroups; it requires K %
// 8 == 0, N % 8 == 0 and 16-byte aligned operands.
extern "C" int bf16_gemm(const void* x, const void* w, void* out, void* work, void* count,
                         int M, int K, int N, int transposed, int out_f32, int split_blocks,
                         int stages_per_split, int warpgroups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = split_blocks > 1 ? static_cast<float*>(work) : nullptr;
  DenseLaunch fn = sequential(split_blocks, stages_per_split, K)
                       ? pick_dense<true>(warpgroups, transposed != 0)
                       : pick_dense<false>(warpgroups, transposed != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fn(x, w, part, static_cast<int*>(count), out, out_f32, M, K, N,
                       split_blocks, stages_per_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [G, M, K]; w bf16 [G, K, N]; out bf16 or fp32 [G, M, N]: out[g] =
// x[g] @ w[g], each head by the dense entry's body and split (bf16_plan's
// stages_per_split and warpgroups), the splits in one block. Requires K % 8
// == 0, N % 8 == 0, 16-byte aligned operands and G <= 65535.
extern "C" int bf16_gemm_batched(const void* x, const void* w, void* out, int G, int M,
                                 int K, int N, int out_f32, int stages_per_split,
                                 int warpgroups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool seq = sequential(1, stages_per_split, K);
  cudaError_t err;
  if (warpgroups == 1)
    err = seq ? launch_batched<1, true>(x, w, out, out_f32, G, M, K, N, stages_per_split, st)
              : launch_batched<1, false>(x, w, out, out_f32, G, M, K, N, stages_per_split, st);
  else if (warpgroups == 2)
    err = seq ? launch_batched<2, true>(x, w, out, out_f32, G, M, K, N, stages_per_split, st)
              : launch_batched<2, false>(x, w, out, out_f32, G, M, K, N, stages_per_split, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [R, K], R = NB * 128 rows grouped by expert; w bf16 [X, K, N];
// block_expert i32 [NB], n_used i32 [1], block_rows i32 [NB], all on the
// device; out bf16 or fp32 [R, N]; where split_blocks > 1, work fp32
// [split_blocks, row_blocks * 128, N] and count i32 [row_blocks x column
// blocks], zeros. The wrapper's plan (ops/moe_matmul.py grouped_bf16_plan)
// gives stages_per_split (the dense entry's), split_blocks and row_blocks
// <= NB; it requires K % 8 == 0, N % 8 == 0 and 16-byte aligned operands.
extern "C" int grouped_gemm(const void* x, const void* w, const void* block_expert,
                            const void* n_used, const void* block_rows, void* out,
                            void* work, void* count, int R, int K, int N, int X,
                            int out_f32, int split_blocks, int stages_per_split,
                            int row_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = split_blocks > 1 ? static_cast<float*>(work) : nullptr;
  GroupedRows rows{static_cast<const int*>(block_expert), static_cast<const int*>(n_used),
                   static_cast<const int*>(block_rows)};
  const size_t elt = out_f32 ? 4 : 2;
  const size_t bounded = (size_t)row_blocks * kBlockM;
  if (bounded < (size_t)R) {
    cudaError_t err = cudaMemsetAsync(static_cast<char*>(out) + bounded * N * elt, 0,
                                      ((size_t)R - bounded) * N * elt, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (row_blocks > 0) {
    const bool seq = sequential(split_blocks, stages_per_split, K);
    cudaError_t err =
        seq ? launch_grouped<true>(x, w, part, static_cast<int*>(count), out, out_f32, R, K,
                                   N, X, split_blocks, stages_per_split, row_blocks, rows, st)
            : launch_grouped<false>(x, w, part, static_cast<int*>(count), out, out_f32, R, K,
                                    N, X, split_blocks, stages_per_split, row_blocks, rows,
                                    st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
