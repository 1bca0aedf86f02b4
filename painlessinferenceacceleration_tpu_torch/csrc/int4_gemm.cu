// int4 weight-only GEMM for Hopper (sm_90a) on the tensor cores (wgmma).
//
//   out[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * (nibble[k, n] - 8)
//
// Replaces the Pallas bodies _qmm4_kernel_v3 and _qmm4_stacked_kernel_v3
// (painlessinferenceacceleration_tpu/ops/quant_matmul.py). A stacked weight
// [L, K/2, N] is passed as the pointer of layer l, so one kernel serves both.
// The weight is read in the JAX layout (layers/linear.py quantize); see
// weight_only_wgmma.cuh for the layout and the body, which the grouped
// (per-expert) kernel and the int8 kernels share.
//
// What bounds it on the H100: at decode (M = 1 .. 64) the weight bytes
// (K N / 2 + K N / g * 2: 14 us for a 7B gate/up weight at 3.35 TB/s); at
// prefill (M = 512, 4096) the products, 2 M K N at 989 TFLOP/s in bf16. The
// design: the products on the tensor cores (wgmma m64n128k16 on the
// dequantized bf16 operand), a ring of 4-6 stages filled by TMA (one thread
// issues a stage's copies) so that a block keeps 16-40 KB of packed weight in
// flight, a weight byte fetched and unpacked once per 64 or 128 token rows,
// one or two multiplying warpgroups (W) by M, and a K split chosen from
// (K, N, g) alone to fill the 132 SMs at decode. Launched one a block, each
// split writes an fp32 plane that a second kernel reads and sums in split
// order: 8 bytes a row and column, which at 3.35 TB/s take 2.3 times as long
// as the 1024 products of a 512-row split at 989 TFLOP/s. So where the row
// tiles alone fill the card (prefill), one block runs every split of its
// tile in the same order and writes no plane: the same bits.

#include "gemm_tiles.cuh"
#include "weight_only_wgmma.cuh"

namespace {

using namespace piawo;

template <int G, int W, bool kSeq>
__global__ void __launch_bounds__(kThreads, 1) int4_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap qm,
    const __grid_constant__ CUtensorMap sm, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N,
    int groups_per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int m0 = blockIdx.y * Tile<false, G, W>::kRows;
  // one split a block, or every split in this block
  const int g_begin = kSeq ? 0 : blockIdx.z * groups_per_split;
  const int g_end = kSeq ? K / G : min(K / G, g_begin + groups_per_split);
  const Maps maps{&xm, &qm, &sm, 0, 0};
  wgmma_tile<false, G, W, kSeq>(maps, part, M, out, out_f32, M, N, m0,
                                blockIdx.x * kCols, min(M - m0, Tile<false, G, W>::kRows),
                                g_begin, g_end, groups_per_split, blockIdx.z, smem);
}

template <int G, int W, bool kSeq>
cudaError_t launch(const void* x, const void* q, const void* s, float* part,
                   void* out, int out_f32, int M, int K, int N, int split_blocks,
                   int gps, cudaStream_t st) {
  using T = Tile<false, G, W>;
  static bool done[64] = {};
  cudaError_t err = piawo::allow_smem(int4_gemm_kernel<G, W, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, qm, sm;
  if (!make_maps<false, G, W>(&xm, &qm, &sm, x, q, s, M, K, K / 2, K / G, N))
    return cudaErrorInvalidValue;
  dim3 grid((N + kCols - 1) / kCols, (M + T::kRows - 1) / T::kRows, split_blocks);
  int4_gemm_kernel<G, W, kSeq><<<grid, kThreads, T::kSmem, st>>>(
      xm, qm, sm, part, out, out_f32, M, K, N, gps);
  return cudaSuccess;
}

using Launch = decltype(&launch<128, 1, false>);

template <bool kSeq>
Launch pick(int group, int warpgroups) {
  if (warpgroups == 1)
    return group == 128 ? launch<128, 1, kSeq> : group == 64 ? launch<64, 1, kSeq>
           : group == 32 ? launch<32, 1, kSeq> : nullptr;
  if (warpgroups == 2)
    return group == 128 ? launch<128, 2, kSeq> : group == 64 ? launch<64, 2, kSeq>
           : group == 32 ? launch<32, 2, kSeq> : nullptr;
  return nullptr;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (the ring, the two operands, the
// barriers), for the build report; -1 for a configuration that does not
// exist.
extern "C" int int4_gemm_smem_bytes(int group, int warpgroups) {
  const bool one = warpgroups == 1;
  if (group == 128) return one ? Tile<false, 128, 1>::kSmem : Tile<false, 128, 2>::kSmem;
  if (group == 64) return one ? Tile<false, 64, 1>::kSmem : Tile<false, 64, 2>::kSmem;
  if (group == 32) return one ? Tile<false, 32, 1>::kSmem : Tile<false, 32, 2>::kSmem;
  return -1;
}

// x bf16 [M, K]; q uint8 [K/2, N]; s bf16 [K/group, N]; out bf16 or fp32
// [M, N]; work fp32 [split_blocks, M, N] (split_blocks > 1). The wrapper's
// plan (ops/quant_matmul.py int4_plan) gives groups_per_split (every split
// non-empty), split_blocks (the splits, launched one a block, or 1: each
// block runs them all in order) and warpgroups; it requires group in
// {32, 64, 128}, K % group == 0, N % 16 == 0 and 16-byte aligned operands.
extern "C" int int4_gemm(const void* x, const void* q, const void* s, void* out,
                         void* work, int M, int K, int N, int group, int out_f32,
                         int split_blocks, int groups_per_split, int warpgroups,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = split_blocks > 1 ? static_cast<float*>(work) : nullptr;
  // several splits in one block
  const bool seq = split_blocks == 1 && (long long)groups_per_split * group < K;
  Launch fn = seq ? pick<true>(group, warpgroups) : pick<false>(group, warpgroups);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fn(x, q, s, part, out, out_f32, M, K, N, split_blocks,
                       groups_per_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_blocks > 1)
    pia::launch_splitk_reduce(part, out, out_f32, (size_t)M * N, split_blocks, st);
  return static_cast<int>(cudaGetLastError());
}
