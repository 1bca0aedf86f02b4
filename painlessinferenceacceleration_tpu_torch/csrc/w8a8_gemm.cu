// W8A8 GEMM with per-output-channel weight scales for Hopper (sm_90a) on the
// 8-bit tensor cores (wgmma): both operands already quantized, int8 x int8
// or e4m3 x e4m3.
//
//   out[m, n] = ((sum_k xq[m, k] * q[k, n]) * xs[m]) * s[n]
//
// Replaces the Pallas bodies _w8a8_kernel and _w8a8_stacked_kernel
// (painlessinferenceacceleration_tpu/ops/w8a8.py). A stacked weight
// [L, K, N] is passed as the pointer of layer l, so one kernel serves both.
// Both scales are applied here in fp32, in the order of the plain version
// (w8a8_gemm_plain), with one rounding at the end. (The Pallas kernel rounds
// to bf16 before its wrapper multiplies by xs; this kernel follows the
// oracle, not that double rounding.) The body, its layouts and why a row's
// bits do not depend on the batch are in w8a8_wgmma.cuh.
//
// What bounds it on the H100: at decode (M = 1 .. 64) the weight's bytes
// (K N: 27 us for a 7B gate/up weight at 3.35 TB/s); at prefill the
// products, 2 M K N at 1979 TOPS. The design: the products on the 8-bit
// tensor cores (wgmma m64n128k32, int8 with an exact s32 sum, e4m3 folded
// into fp32 after every instruction), a ring of 6 stages filled by TMA, a
// weight byte fetched and transposed once per 64 or 128 token rows, one or
// two multiplying warpgroups by M, and a K split chosen from (K, N) alone to
// fill the 132 SMs at decode. Launched one a block, each split writes a
// 4-byte plane (s32 or fp32) that a second kernel sums in split order and
// scales; where the row tiles alone fill the card (prefill), one block runs
// every split of its tile and writes no plane: the same bits.

#include "w8a8_wgmma.cuh"

namespace {

using namespace pia8;

template <bool kFp8, int W, bool kSeq>
__global__ void __launch_bounds__(kThreads, 1) w8a8_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap qm,
    const float* __restrict__ xs, const float* __restrict__ s,
    void* __restrict__ part, void* __restrict__ out, int out_f32, int M, int K,
    int N, int stages_per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int n_stages = (K + kStageK - 1) / kStageK;
  // one split a block, or every split in this block
  const bool all = gridDim.z == 1;
  const int st_begin = all ? 0 : blockIdx.z * stages_per_split;
  const int st_end = all ? n_stages : min(n_stages, st_begin + stages_per_split);
  // the row tiles of one column block are neighbours in the launch order, so
  // that the blocks running at once share their weight columns in L2
  w8a8_wgmma_tile<kFp8, W, kSeq>(&xm, &qm, xs, s, all ? nullptr : part, out, out_f32,
                                 M, N, blockIdx.x * Tile<W>::kRows, blockIdx.y * kCols,
                                 st_begin, st_end, stages_per_split, blockIdx.z, smem);
}

// The splits' planes [ksplit, M, N] summed in split order, then scaled and
// rounded once into out.
template <typename ACC>
__global__ void splitk_reduce_kernel(const ACC* __restrict__ part,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ s,
                                     void* __restrict__ out, int out_f32,
                                     int M, int N, int ksplit) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    ACC v = 0;
    for (int k = 0; k < ksplit; ++k) v += part[(size_t)k * mn + i];
    const float y = __fmul_rn(__fmul_rn((float)v, xs[i / N]), s[i % N]);
    if (out_f32)
      static_cast<float*>(out)[i] = y;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(y);
  }
}

template <bool kFp8, int W, bool kSeq>
cudaError_t launch(const void* xq, const float* xs, const void* q, const float* s,
                   void* part, void* out, int out_f32, int M, int K, int N,
                   int split_blocks, int sps, cudaStream_t st) {
  using T = Tile<W>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(w8a8_gemm_kernel<kFp8, W, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, qm;
  if (!make_map(&xm, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kStageK, T::kRows,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kCols, kStageK,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);
  w8a8_gemm_kernel<kFp8, W, kSeq><<<grid, kThreads, T::kSmem, st>>>(
      xm, qm, xs, s, part, out, out_f32, M, K, N, sps);
  return cudaSuccess;
}

using Launch = decltype(&launch<false, 1, false>);

Launch pick(bool fp8, int warpgroups, bool seq) {
  if (warpgroups != 1 && warpgroups != 2) return nullptr;
  const bool one = warpgroups == 1;
  if (!fp8) return one ? launch<false, 1, false> : launch<false, 2, false>;
  if (seq) return one ? launch<true, 1, true> : launch<true, 2, true>;
  return one ? launch<true, 1, false> : launch<true, 2, false>;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (the ring, the two transposed
// operands, the barriers), for the build report; -1 for a configuration
// that does not exist.
extern "C" int w8a8_gemm_smem_bytes(int warpgroups) {
  return warpgroups == 1 ? Tile<1>::kSmem : warpgroups == 2 ? Tile<2>::kSmem : -1;
}

// xq int8 or e4m3 [M, K]; xs fp32 [M]; q of xq's type [K, N]; s fp32 [N];
// out bf16 or fp32 [M, N]; work 4 bytes x [split_blocks, M, N] (used when
// split_blocks > 1: s32 partial sums for int8, fp32 for e4m3). The
// wrapper's plan (ops/w8a8.py w8a8_plan) gives stages_per_split (128-k
// stages, every split non-empty), split_blocks (the splits, launched one a
// block, or 1: each block runs them all in order) and warpgroups; it
// requires K % 16 == 0, N % 16 == 0 and xq and q on 16-byte boundaries.
extern "C" int w8a8_gemm(const void* xq, const void* xs, const void* q,
                         const void* s, void* out, void* work, int M, int K,
                         int N, int fp8, int out_f32, int split_blocks,
                         int stages_per_split, int warpgroups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xsf = static_cast<const float*>(xs);
  const auto* sf = static_cast<const float*>(s);
  void* part = split_blocks > 1 ? work : nullptr;
  // several e4m3 splits in one block
  const bool seq = split_blocks == 1 && (long long)stages_per_split * kStageK < K;
  Launch fn = pick(fp8 != 0, warpgroups, fp8 && seq);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = fn(xq, xsf, q, sf, part, out, out_f32, M, K, N, split_blocks,
                       stages_per_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_blocks > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
    if (fp8)
      splitk_reduce_kernel<float><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(part), xsf, sf, out, out_f32, M, N, split_blocks);
    else
      splitk_reduce_kernel<int><<<blocks, 256, 0, st>>>(
          static_cast<const int*>(part), xsf, sf, out, out_f32, M, N, split_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
