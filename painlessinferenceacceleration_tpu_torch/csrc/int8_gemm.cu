// int8 weight-only GEMM for Hopper (sm_90a) on the tensor cores (wgmma).
//
//   out[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * q[k, n]
//
// Replaces the Pallas bodies _qmm_kernel and _qmm8_stacked_kernel
// (painlessinferenceacceleration_tpu/ops/quant_matmul.py). A stacked weight
// [L, K, N] is passed as the pointer of layer l, so one kernel serves both.
// The weight is read in the JAX layout (layers/linear.py quantize: q int8
// [K, N], N contiguous; s bf16 [K/g, N]); the body is the int4 kernels'
// (weight_only_wgmma.cuh), with the stage's bytes widened to bf16 in place
// of the nibbles unpacked, and a stage of C k rows of one group (C the
// largest of 128, 64, 32 that divides g), whose fp32 partial is scaled by
// its group's scale and folded in k order.
//
// What bounds it on the H100: at decode (M = 1 .. 64) the weight bytes
// (K N + K N / g * 2: 27 us for a 7B gate/up weight at 3.35 TB/s); at
// prefill (M = 512, 4096) the products, 2 M K N at 989 TFLOP/s in bf16. The
// design, as int4_gemm.cu's: the products on the tensor cores, a ring of 3-5
// stages filled by TMA (a 128-k stage holds 16 KB of weight, twice int4's,
// so two warpgroups' 128-row tiles leave room for 3), a weight byte fetched
// and widened once per 64 or 128 token rows, one or two multiplying
// warpgroups by M, and a K split chosen from (K, N, C) alone to fill the
// 132 SMs at decode, run in one block where the row tiles alone fill the
// card (no fp32 planes at prefill). Unlike int4_gemm.cu, the row tiles of a
// column block are launched next to each other, so that at prefill the
// tiles of one column block share its weight stages through L2. What still
// holds it on an H100 (tools/k7_variants.py): the widening sits on the
// critical path (23-28 % of the time at M = 1 .. 4096), and at decode the
// ring does not hide HBM: a stage costs about a microsecond whatever it
// holds, so 7B gate/up at M = 1 reaches 44 % of its bound; asking stages
// into L2 ahead of the ring made decode slower.

#include "gemm_tiles.cuh"
#include "weight_only_wgmma.cuh"

namespace {

using namespace piawo;

template <int C, int W, bool kSeq>
__global__ void __launch_bounds__(kThreads, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap qm,
    const __grid_constant__ CUtensorMap sm, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N, int stages_per_group,
    int stages_per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  // the row tiles of one column block are launched next to each other
  const int m0 = blockIdx.x * Tile<true, C, W>::kRows;
  // one split a block, or every split in this block
  const int g_begin = kSeq ? 0 : blockIdx.z * stages_per_split;
  const int g_end = kSeq ? K / C : min(K / C, g_begin + stages_per_split);
  const Maps maps{&xm, &qm, &sm, 0, 0, stages_per_group};
  wgmma_tile<true, C, W, kSeq>(maps, part, M, out, out_f32, M, N, m0, blockIdx.y * kCols,
                               min(M - m0, Tile<true, C, W>::kRows), g_begin, g_end,
                               stages_per_split, blockIdx.z, smem);
}

template <int C, int W, bool kSeq>
cudaError_t launch(const void* x, const void* q, const void* s, float* part,
                   void* out, int out_f32, int M, int K, int N, int group,
                   int split_blocks, int sps, cudaStream_t st) {
  using T = Tile<true, C, W>;
  static bool done[64] = {};
  cudaError_t err = piawo::allow_smem(int8_gemm_kernel<C, W, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, qm, sm;
  if (!make_maps<true, C, W>(&xm, &qm, &sm, x, q, s, M, K, K, K / group, N))
    return cudaErrorInvalidValue;
  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);
  int8_gemm_kernel<C, W, kSeq><<<grid, kThreads, T::kSmem, st>>>(
      xm, qm, sm, part, out, out_f32, M, K, N, group / C, sps);
  return cudaSuccess;
}

using Launch = decltype(&launch<128, 1, false>);

template <bool kSeq>
Launch pick(int stage, int warpgroups) {
  if (warpgroups == 1)
    return stage == 128 ? launch<128, 1, kSeq> : stage == 64 ? launch<64, 1, kSeq>
           : stage == 32 ? launch<32, 1, kSeq> : nullptr;
  if (warpgroups == 2)
    return stage == 128 ? launch<128, 2, kSeq> : stage == 64 ? launch<64, 2, kSeq>
           : stage == 32 ? launch<32, 2, kSeq> : nullptr;
  return nullptr;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (the ring, the two operands, the
// barriers), for the build report; -1 for a configuration that does not
// exist.
extern "C" int int8_gemm_smem_bytes(int stage, int warpgroups) {
  const bool one = warpgroups == 1;
  if (stage == 128) return one ? Tile<true, 128, 1>::kSmem : Tile<true, 128, 2>::kSmem;
  if (stage == 64) return one ? Tile<true, 64, 1>::kSmem : Tile<true, 64, 2>::kSmem;
  if (stage == 32) return one ? Tile<true, 32, 1>::kSmem : Tile<true, 32, 2>::kSmem;
  return -1;
}

// x bf16 [M, K]; q int8 [K, N]; s bf16 [K/group, N]; out bf16 or fp32
// [M, N]; work fp32 [split_blocks, M, N] (split_blocks > 1). The wrapper's
// plan (ops/quant_matmul.py int8_plan) gives stages_per_split (every split
// non-empty), split_blocks (the splits, launched one a block, or 1: each
// block runs them all in order) and warpgroups; it requires group % 32 ==
// 0, K % group == 0, N % 16 == 0 and 16-byte aligned operands.
extern "C" int int8_gemm(const void* x, const void* q, const void* s, void* out,
                         void* work, int M, int K, int N, int group, int out_f32,
                         int split_blocks, int stages_per_split, int warpgroups,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = split_blocks > 1 ? static_cast<float*>(work) : nullptr;
  if (group <= 0 || K % group) return static_cast<int>(cudaErrorInvalidValue);
  const int stage = int8_stage(group);
  // several splits in one block
  const bool seq = split_blocks == 1 && (long long)stages_per_split * stage < K;
  Launch fn = seq ? pick<true>(stage, warpgroups) : pick<false>(stage, warpgroups);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fn(x, q, s, part, out, out_f32, M, K, N, group, split_blocks,
                       stages_per_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_blocks > 1)
    pia::launch_splitk_reduce(part, out, out_f32, (size_t)M * N, split_blocks, st);
  return static_cast<int>(cudaGetLastError());
}
