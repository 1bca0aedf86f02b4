// The tied LM head over an e4m3 embedding table for Hopper (sm_90a) on the
// tensor cores (wgmma):
//
//   out[m, v] = s[v] * sum_e x[m, e] * q[v, e]      (fp32 out)
//
// x bf16 [M, E] (the final hidden rows), q e4m3 [V, E] (the table, one row a
// vocab entry, E contiguous), s f32 [V] (each row's scale). Replaces no
// Pallas body: the JAX package multiplies by the table widened to bf16 and
// scales each vocab column after the product in XLA
// (painlessinferenceacceleration_tpu/layers/embedding.py:50-59,
// embed_logits), the port's plain version in torch
// (ops/quant_matmul.py fp8_head_matmul_plain); on the card the engine may
// not run plain torch, and the bf16 GEMM (K10) would need the table widened
// to bf16 in device memory, twice its bytes.
//
// What bounds it on the H100: at decode and verify (M = 1 .. 64) the
// table's bytes, V E (1.03 GB at BLOOM-7b1's 250880 x 4096: 0.31 ms at 3.35
// TB/s); at a prefill's last rows the same (the head takes one row a
// request). The design, as the weight-only GEMMs' (weight_only_wgmma.cuh):
// - A block takes 128 vocab columns (the wgmma's N) and a token tile of 64
//   rows a multiplying warpgroup (W = 1 up to M = 64, else 2), over E in
//   stages of 64. The table is row-major [V, E], so its rows are already
//   the K-major B operand: a stage is one TMA box of 64 bytes x 128 rows
//   (rows past V read as zeros), x one box of 64 columns x 64 W rows in the
//   128-byte swizzle. A ring of stages, thread 0 the producer.
// - Both warpgroups widen a stage's e4m3 bytes to bf16 (exact: e4m3 fits
//   bf16) into the swizzled operand wgmma reads, double-buffered: the next
//   stage is widened while the tensor cores multiply this one.
// - Each multiplying warpgroup runs four wgmma m64n128k16 a stage into one
//   fp32 sum a thread; the epilogue multiplies each vocab column's sum once
//   by s[v], as the JAX package does, and stores fp32. A row's sum runs the
//   same stages and instructions at every M: its bits do not depend on the
//   batch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "weight_only_wgmma.cuh"

namespace {

using namespace piawg;
using piawo::wgmma_m64n128k16;

constexpr int kCols = 128;     // vocab columns of a block: the wgmma's N
constexpr int kC = 64;         // E of a stage: one 128-byte swizzle row of bf16
constexpr int kThreads = 256;  // two warpgroups: both widen
constexpr int kMaxStages = 6;

template <int W>
struct HeadTile {
  static_assert(W == 1 || W == 2, "one or two multiplying warpgroups");
  static constexpr int kRows = 64 * W;            // token rows of a block
  static constexpr int kXBytes = kRows * kC * 2;  // the x tile of a stage
  static constexpr int kQBytes = kCols * kC;      // the table's bytes of a stage
  static constexpr int kBBytes = kCols * kC * 2;  // one widened operand
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kFit =
      (kSmemLimit - 1024 - 8 * kMaxStages - 2 * kBBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + 2 * kBBytes + kStages * kStageBytes + 8 * kMaxStages;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// Two e4m3 values -> two bf16 values (exact: e4m3 fits bf16).
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The stage's table rows [128][64 e4m3] -> the bf16 operand [128][64]
// (K-major, 128-byte swizzle). Item i takes row i / 4 and its 16 values 16
// (i % 4) .. +15: a 16-byte read, neighbouring items on neighbouring bytes,
// and two 16-byte stores, the 8 of a phase on 8 different bank groups (rows
// n and n + 1 take the even and the odd slots).
__device__ __forceinline__ void widen_stage(const uint8_t* __restrict__ qs,
                                            uint8_t* __restrict__ bs) {
#pragma unroll
  for (int i0 = 0; i0 < kCols * 4; i0 += kThreads) {
    const int i = i0 + (int)threadIdx.x;
    const int n = i >> 2, u = i & 3;
    const uint4 w = *reinterpret_cast<const uint4*>(qs + n * kC + 16 * u);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = e4m3x2_to_bf16x2(ws[j] & 0xffffu);
      o[2 * j + 1] = e4m3x2_to_bf16x2(ws[j] >> 16);
    }
    *reinterpret_cast<uint4*>(bs + sw_offset<128>(2 * u, n, kCols)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(bs + sw_offset<128>(2 * u + 1, n, kCols)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) fp8_head_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap qm,
    const float* __restrict__ s, float* __restrict__ out, int M, int K, int N) {
  using T = HeadTile<W>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  uint8_t* base = smem + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* bop = base;                          // [2][kBBytes]
  uint8_t* xs = base + 2 * T::kBBytes;          // [S][kXBytes]
  uint8_t* qs = xs + S * T::kXBytes;            // [S][kQBytes]
  const uint32_t bars = smem_u32(qs + S * T::kQBytes);  // [S] mbarriers

  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * T::kRows;
  const int n_g = K / kC;
  const int valid = min(M - m0, T::kRows);
  // warpgroup-uniform, broadcast so that the compiler sees it so (a wgmma
  // on a path it takes for divergent would be serialized)
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const bool mma = __shfl_sync(0xffffffffu, (int)(wg < W && 64 * wg < valid), 0);

  auto load = [&](int g) {
    const int slot = g % S;
    mbar_expect(bars + 8 * slot, T::kStageBytes);
    tma_load(smem_u32(xs + slot * T::kXBytes), &xm, g * kC, m0, bars + 8 * slot);
    tma_load(smem_u32(qs + slot * T::kQBytes), &qm, g * kC, n0, bars + 8 * slot);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + 8 * i);
    fence_mbar_init();
    for (int g = 0; g < S - 1 && g < n_g; ++g) load(g);
  }
  __syncthreads();
  mbar_wait(bars, 0);
  widen_stage(qs, bop);
  fence_async_smem();
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int it = 0; it < n_g; ++it) {
    const int slot = it % S;
    // refill the slot that stage it - 1 left (its reads ended before the
    // barrier closing the previous iteration)
    const int nx = it + S - 1;
    if (threadIdx.x == 0 && nx < n_g) load(nx);
    if (mma) {
      const uint32_t xa = smem_u32(xs + slot * T::kXBytes) + wg * 64 * 128;
      const uint32_t ba = smem_u32(bop + (it & 1) * T::kBBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kC / 16; ++t)
        wgmma_m64n128k16(acc, sw_desc<128>(xa + 32 * t), sw_desc<128>(ba + 32 * t), 1);
      wgmma_commit();
    }
    if (it + 1 < n_g) {  // the next stage's operand, while this one multiplies
      mbar_wait(bars + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      widen_stage(qs + ((it + 1) % S) * T::kQBytes, bop + ((it + 1) & 1) * T::kBBytes);
      fence_async_smem();
    }
    if (mma) {
      wgmma_wait0();
      fence_regs(acc);
    }
    __syncthreads();
  }

  if (!mma) return;
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * h;
    if (r >= valid) continue;
    float* dst = out + (size_t)(m0 + r) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n < N) dst[n] = acc[4 * j + 2 * h] * s[n];
      if (n + 1 < N) dst[n + 1] = acc[4 * j + 2 * h + 1] * s[n + 1];
    }
  }
}

template <int W>
cudaError_t launch(const void* x, const void* q, const float* s, float* out, int M, int K,
                   int N, cudaStream_t st) {
  using T = HeadTile<W>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(fp8_head_kernel<W>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, qm;
  if (!make_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kC, T::kRows,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kC, kCols,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  dim3 grid((N + kCols - 1) / kCols, (M + T::kRows - 1) / T::kRows);
  fp8_head_kernel<W><<<grid, kThreads, T::kSmem, st>>>(xm, qm, s, out, M, K, N);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block, for the build report; -1 for a
// configuration that does not exist.
extern "C" int fp8_head_gemm_smem_bytes(int warpgroups) {
  return warpgroups == 1 ? HeadTile<1>::kSmem : warpgroups == 2 ? HeadTile<2>::kSmem : -1;
}

// x bf16 [M, K]; q e4m3 [N, K] (the table); s f32 [N]; out f32 [M, N]. The
// wrapper (ops/quant_matmul.py fp8_head_matmul) requires K % 64 == 0, M, N
// >= 1, 16-byte aligned x and q, and gives warpgroups 1 (M <= 64) or 2.
extern "C" int fp8_head_gemm(const void* x, const void* q, const void* s, void* out, int M,
                             int K, int N, int warpgroups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < kC || K % kC) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (warpgroups == 1)
    err = launch<1>(x, q, sc, o, M, K, N, st);
  else if (warpgroups == 2)
    err = launch<2>(x, q, sc, o, M, K, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
