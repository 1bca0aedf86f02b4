// 128x128-block fp8 GEMM for Hopper (sm_90a) on the 8-bit tensor cores
// (wgmma): e4m3 x e4m3 with one fp32 weight scale per 128x128 block and one
// fp32 activation scale per (token, 128-deep K block), the DeepSeek-V3
// checkpoint format.
//
//   out[m, n] = sum_kb ((sum_{k in kb} xq[m, k] * q[k, n]) * xs[m, kb])
//                      * s[kb, n / 128]
//
// Replaces the Pallas bodies _block_fp8_kernel and _block_fp8_stacked_kernel
// (painlessinferenceacceleration_tpu/ops/w8a8.py). A stacked weight
// [L, K, N] is passed as the pointer of layer l, so one kernel serves both;
// the token-block variant (power-of-two activation scales) differs only in
// how xs was made. The [K/128, N/128] scales are read as they are stored
// (the TPU wrapper expands them to [K/128, N] first).
//
// Layout read directly: xq e4m3 [M, K] (K contiguous), q e4m3 [K, N] (N
// contiguous), xs fp32 [M, ceil(K/128)], s fp32 [ceil(K/128), ceil(N/128)];
// K % 16 == 0 and N % 16 == 0 (TMA's 16-byte row strides). The last K block
// and the last column block may be partial: TMA brings zeros past K and
// past N, and columns past N are not written.
//
// The body is the W8A8 kernel's (w8a8_wgmma.cuh): a block of 128 weight
// columns x 64 W token rows, a ring of 128-k stages brought by TMA, each
// stage's weight bytes transposed in shared memory into the K-major operand
// 8-bit wgmma reads, and 4 wgmma m64n128k32 .f32.e4m3.e4m3 a stage. A
// stage is one scale block and a block's 128 columns are one scale column
// block, so a stage's scale of row m is one number, c = xs[m, kb] *
// s[kb, n0 / 128]: two xs loads a thread a stage (its two rows) and one s,
// issued a stage ahead.
// Every instruction starts a fresh sum (the tensor cores keep fewer bits
// than fp32 while they accumulate: tools/k8_variants.py), which is folded
// into the split's fp32 sum on the CUDA cores with one fmaf(pa, c, acc), the
// cost of K8's fadd. The splits are added in order, total = 0 + p0 + p1 +
// ..., by a block that runs them all (kSeq: a third accumulator) or by a
// second kernel from the fp32 planes of splits launched as blocks: the same
// bits. (Summing the planes in the last split block of each tile, as the
// bf16 GEMM does, measured slower at M = 1 and 17 on an H100.) Against the
// plain version (block_fp8_gemm_plain: a 128-deep fp32 partial, times xs,
// times s, added) only the rounding differs; the tolerance is 1e-4 of the
// largest output in fp32, 2e-2 in bf16 (tools/k9_variants.py measures the
// error of folds carried over 1, 2 and 4 instructions).
//
// A row's bits do not depend on the batch: every row of every tile runs the
// same instructions over the same stages in the same order, with the split
// a function of (K, N) alone (ops/w8a8.py block_fp8_plan), its c the same
// product of its own scales; rows past M are not written.
//
// What bounds it on the H100: at decode (M = 1 .. 64) the weight's bytes
// (K N: 27 us for a 7B gate/up weight at 3.35 TB/s); at prefill the
// products, 2 M K N at 1979 TFLOP/s. The K split fills the 132 SMs at
// decode (stage_split); where the row tiles alone fill the card, one block
// runs every split of its tile and writes no fp32 plane.

#include "w8a8_wgmma.cuh"

namespace {

using namespace pia8;

// two adjacent outputs, bf16 or fp32
__device__ __forceinline__ void store2(void* out, int out_f32, size_t i, float a, float b) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
        __floats2bfloat162_rn(a, b);
}

// One block's tile: rows [m0, m0 + 64 W) of the M rows, columns
// [n0, n0 + 128) of N, stages [st_begin, st_end) (at least one), each stage
// scale block kb = its stage. part == nullptr: the block writes out (bf16
// or fp32). Otherwise it runs split ks alone and writes its fp32 sums to
// part[ks][m][n], planes of M rows. kSeq: the stages are those of several
// splits of sps stages from st_begin, added split by split.
template <int W, bool kSeq>
__device__ __forceinline__ void block_fp8_tile(
    const CUtensorMap* xm, const CUtensorMap* qm, const float* __restrict__ xs,
    const float* __restrict__ s, float* __restrict__ part, void* __restrict__ out,
    int out_f32, int M, int N, int nkb, int nnb, int m0, int n0, int st_begin, int st_end,
    int sps, int ks, uint8_t* smem_raw) {
  using T = Tile<W>;
  constexpr int S = T::kStages;
  const int n_st = st_end - st_begin;
  // warpgroup-uniform values, broadcast so that the compiler sees them so:
  // wgmma and its accumulator in a path it takes for divergent would be
  // serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const bool mma = __shfl_sync(0xffffffffu, (int)(wg < W && m0 + 64 * wg < M), 0);
  const int wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  // the ring, from a 1024-byte boundary (the swizzle reads address bits 7-9)
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* bop = base;                          // [2][kBBytes]
  uint8_t* xsm = base + 2 * T::kBBytes;         // [S][kXBytes]
  uint8_t* qsm = xsm + S * T::kXBytes;          // [S][kQBytes]
  const uint32_t bars = smem_u32(qsm + S * T::kQBytes);  // [S] mbarriers

  // this thread's two accumulator rows (r, r + 8; rows past M read row
  // M - 1's scales and are not written) and the tile's scale column; a
  // stage's scales are loaded one stage ahead, so that their latency hides
  // behind a stage's products
  const int r = m0 + 64 * wg + 16 * wi + (lane >> 2);
  const float* xs0 = xs + (size_t)min(r, M - 1) * nkb + st_begin;
  const float* xs1 = xs + (size_t)min(r + 8, M - 1) * nkb + st_begin;
  const float* sc = s + (size_t)st_begin * nnb + n0 / kCols;
  float x0 = 0.f, x1 = 0.f, sn = 0.f;  // the next stage's xs[r], xs[r + 8], s
  if (mma) {
    x0 = __ldg(xs0);
    x1 = __ldg(xs1);
    sn = __ldg(sc);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + 8 * i);
    fence_mbar_init();
    for (int st = 0; st < S - 1 && st < n_st; ++st)
      load_stage<W>(xsm + st * T::kXBytes, qsm + st * T::kQBytes, bars + 8 * st, xm,
                    qm, m0, n0, st_begin + st);
  }
  __syncthreads();
  mbar_wait(bars, 0);
  transpose_stage(qsm, bop);
  fence_async_smem();
  __syncthreads();

  float acc[64];  // this split's scaled sum
  float pa[64];   // one instruction's sum
  float tot[64];  // kSeq: the splits' sum
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    pa[i] = 0.f;
    tot[i] = 0.f;
  }

#pragma unroll 1
  for (int it = 0; it < n_st; ++it) {
    const int slot = it % S;
    // refill the slot that stage it - 1 left (its reads ended before the
    // barrier closing the previous iteration)
    const int nx = it + S - 1;
    if (threadIdx.x == 0 && nx < n_st) {
      const int ns = nx % S;
      load_stage<W>(xsm + ns * T::kXBytes, qsm + ns * T::kQBytes, bars + 8 * ns, xm, qm,
                    m0, n0, st_begin + nx);
    }
    const uint32_t xa = smem_u32(xsm + slot * T::kXBytes) + wg * 64 * kStageK;
    const uint32_t ba = smem_u32(bop + (it & 1) * T::kBBytes);
    // this stage's scale of each row, c = xs[m, kb] * s[kb, n0 / 128]
    const float c0 = __fmul_rn(x0, sn), c1 = __fmul_rn(x1, sn);
    if (mma) {  // k step 0, and the next stage's scales while it runs
      fence_regs(pa);
      wgmma_fence();
      wgmma_k32(pa, sw_desc<128>(xa), sw_desc<128>(ba), 0);
      wgmma_commit();
      if (it + 1 < n_st) {
        x0 = __ldg(xs0 + it + 1);
        x1 = __ldg(xs1 + it + 1);
        sn = __ldg(sc + (size_t)(it + 1) * nnb);
      }
    }
    if (it + 1 < n_st) {  // the next stage's operand, while this one multiplies
      mbar_wait(bars + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      transpose_stage(qsm + ((it + 1) % S) * T::kQBytes, bop + ((it + 1) & 1) * T::kBBytes);
      fence_async_smem();
    }
    if (mma) {
      // fold each k step's sum, scaled, and start the next
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k > 0) {
          fence_regs(pa);
          wgmma_fence();
          wgmma_k32(pa, sw_desc<128>(xa + 32 * k), sw_desc<128>(ba + 32 * k), 0);
          wgmma_commit();
        }
        wgmma_wait0();
        fence_regs(pa);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = fmaf(pa[i], (i & 2) ? c1 : c0, acc[i]);
      }
      if (kSeq && ((it + 1) % sps == 0 || it + 1 == n_st)) {  // a split ends
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          tot[i] += acc[i];
          acc[i] = 0.f;
        }
      }
    }
    __syncthreads();
  }

  if (wg >= W) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
      const float y0 = kSeq ? tot[4 * j + 2 * h] : acc[4 * j + 2 * h];
      const float y1 = kSeq ? tot[4 * j + 2 * h + 1] : acc[4 * j + 2 * h + 1];
      const size_t i = (size_t)m * N + n;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + (size_t)ks * M * N + i) = make_float2(y0, y1);
      else
        store2(out, out_f32, i, y0, y1);
    }
  }
}

template <int W, bool kSeq>
__global__ void __launch_bounds__(kThreads, 1) block_fp8_gemm_kernel(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap qm,
    const float* __restrict__ xs, const float* __restrict__ s, float* __restrict__ part,
    void* __restrict__ out, int out_f32, int M, int K, int N, int stages_per_split) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int n_stages = (K + kStageK - 1) / kStageK;
  // one split a block, or every split in this block
  const bool all = gridDim.z == 1;
  const int st_begin = all ? 0 : blockIdx.z * stages_per_split;
  const int st_end = all ? n_stages : min(n_stages, st_begin + stages_per_split);
  // the row tiles of one column block are neighbours in the launch order, so
  // that the blocks running at once share their weight columns in L2
  block_fp8_tile<W, kSeq>(&xm, &qm, xs, s, all ? nullptr : part, out, out_f32, M, N,
                          n_stages, (N + kCols - 1) / kCols, blockIdx.x * Tile<W>::kRows,
                          blockIdx.y * kCols, st_begin, st_end, stages_per_split,
                          blockIdx.z, smem);
}

// The splits' fp32 planes [ksplit, M, N] summed in split order, 0 + p0 + p1
// + ..., and rounded once into out.
__global__ void splitk_reduce_kernel(const float* __restrict__ part, void* __restrict__ out,
                                     int out_f32, size_t mn, int ksplit) {
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

template <int W, bool kSeq>
cudaError_t launch(const void* xq, const float* xs, const void* q, const float* s,
                   float* part, void* out, int out_f32, int M, int K, int N,
                   int split_blocks, int sps, cudaStream_t st) {
  using T = Tile<W>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(block_fp8_gemm_kernel<W, kSeq>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, qm;
  if (!make_map(&xm, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kStageK, T::kRows,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kCols, kStageK,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);
  block_fp8_gemm_kernel<W, kSeq><<<grid, kThreads, T::kSmem, st>>>(
      xm, qm, xs, s, part, out, out_f32, M, K, N, sps);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xq e4m3 [M, K]; xs fp32 [M, ceil(K/128)]; q e4m3 [K, N]; s fp32
// [ceil(K/128), ceil(N/128)]; out bf16 or fp32 [M, N]; work fp32
// [split_blocks, M, N] (used when split_blocks > 1). The wrapper's plan (ops/w8a8.py
// block_fp8_plan) gives stages_per_split (128-k stages, every split
// non-empty), split_blocks (the splits, launched one a block, or 1: each
// block runs them all in order) and warpgroups; it requires K % 16 == 0,
// N % 16 == 0 and xq and q on 16-byte boundaries.
extern "C" int block_fp8_gemm(const void* xq, const void* xs, const void* q, const void* s,
                              void* out, void* work, int M, int K, int N, int out_f32,
                              int split_blocks, int stages_per_split, int warpgroups,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = split_blocks > 1 ? static_cast<float*>(work) : nullptr;
  const bool seq = split_blocks == 1 && (long long)stages_per_split * kStageK < K;
  if (warpgroups != 1 && warpgroups != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool one = warpgroups == 1;
  auto fn = seq ? (one ? launch<1, true> : launch<2, true>)
                : (one ? launch<1, false> : launch<2, false>);
  cudaError_t err = fn(xq, static_cast<const float*>(xs), q, static_cast<const float*>(s),
                       part, out, out_f32, M, K, N, split_blocks, stages_per_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_blocks > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
    splitk_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, out_f32, mn, split_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block, for the build report; -1 for a
// configuration that does not exist.
extern "C" int block_fp8_gemm_smem_bytes(int warpgroups) {
  return warpgroups == 1 ? Tile<1>::kSmem : warpgroups == 2 ? Tile<2>::kSmem : -1;
}
