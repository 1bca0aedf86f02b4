// The W8A8 GEMM body on Hopper's 8-bit tensor cores (wgmma), for int8 and
// e4m3 operands:
//
//   out[m, n] = ((sum_k xq[m, k] * q[k, n]) * xs[m]) * s[n]
//
// xq is [M, K] (K contiguous), q [K, N] in the JAX layout (N contiguous),
// xs fp32 [M], s fp32 [N]; K % 16 == 0 and N % 16 == 0 (TMA's 16-byte row
// strides).
//
// One block: 128 weight columns x a token tile of 64 rows per multiplying
// warpgroup (W = 1 or 2), over the 128-k stages of its K split. A stage of
// the ring holds the x tile [64 W rows][128 k] and the weight's
// [128 k][128 n] bytes, both brought by the tensor memory accelerator (TMA:
// one thread issues a stage's two copies, an mbarrier counts their bytes; x
// lands in the 128-byte swizzle the tensor cores read, bytes past the
// matrix as zeros). For 8-bit types wgmma reads both shared-memory
// operands K-major only, and the weight lies N-major: both warpgroups
// transpose the stage into a K-major operand [128 n][128 k] in the same
// swizzle (4 x 4 byte blocks with __byte_perm), double-buffered, so that
// the next stage is transposed while the tensor cores multiply this one.
// Each multiplying warpgroup then runs 4 wgmma m64n128k32 (both operands in
// shared memory):
// - int8 (.s32.s8.s8): into one s32 accumulator over the block's whole K
//   range. Integer sums do not depend on their order, so splits run in one
//   block or as blocks give the exact product; |sum| <= K 127^2 fits s32 up
//   to K = 133 000.
// - e4m3 (.f32.e4m3.e4m3): the tensor cores keep fewer bits than fp32 while
//   they accumulate (on an H100 a sum carried over 4 instructions was
//   1.2-2.4e-4 of the largest output away from the fp32 product, over 2
//   0.65-1.2e-4, over 1 0.42-0.51e-4: tools/k8_variants.py; the tolerance
//   is 1e-4), so every instruction starts a fresh sum, which is added to an
//   fp32 running sum on CUDA cores, k ascending. (Folding one 64-column
//   half while the other half's instruction runs made ptxas serialize the
//   wgmma, C7514.) Over K splits the
//   split sums are added in order, total = 0 + p0 + p1 + ..., the order in
//   which the reduction adds the planes of splits run as separate blocks,
//   so a block that runs every split (kSeq: a third accumulator) gives the
//   same bits.
// The epilogue computes ((v * xs[m]) * s[n]) in fp32 and rounds once.
//
// A row's bits do not depend on the batch: every row of every tile runs the
// same instruction over the same stages in the same order, with the split
// a function of (K, N) alone (ops/w8a8.py w8a8_plan); the tensor cores'
// products and sums of row m depend on row m of the operand only; the tile
// height W leaves them alone; rows past M are not written.

#pragma once

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace pia8 {

using namespace piawg;

constexpr int kCols = 128;     // weight columns of a block: the wgmma's N
constexpr int kThreads = 256;  // two warpgroups: both transpose
constexpr int kStageK = 128;   // k of a stage: one 128-byte swizzle row
constexpr int kMaxStages = 6;

template <int W>
struct Tile {
  static_assert(W == 1 || W == 2, "one or two multiplying warpgroups");
  static constexpr int kRows = 64 * W;           // token rows of a block
  static constexpr int kXBytes = kRows * kStageK;  // the x tile of a stage
  static constexpr int kQBytes = kStageK * kCols;  // the weight's bytes of a stage
  static constexpr int kBBytes = kCols * kStageK;  // one transposed operand
  static constexpr int kStageBytes = kXBytes + kQBytes;  // an mbarrier's count
  static constexpr int kFit =
      (kSmemLimit - 1024 - 8 * kMaxStages - 2 * kBBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + 2 * kBBytes + kStages * kStageBytes + 8 * kMaxStages;
  static_assert(kStages >= 2, "a ring needs two stages");
};

template <bool kFp8>
struct Acc {
  using T = int;
};
template <>
struct Acc<true> {
  using T = float;
};

// d[64 x 128] (+)= A[64 x 32] * B[32 x 128], 8-bit operands K-major in
// shared memory; accumulate = 0 starts a fresh sum. Thread t of the
// warpgroup holds rows 16 (t/32) + (t%32)/4 (+8) and columns 8 j + 2 (t%4)
// (+1): d[4 j + 2 h + c] is row +8h, column +c.
#define PIA8_D64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "         \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "         \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "         \
  "%58, %59, %60, %61, %62, %63}"
#define PIA8_OUT64(c)                                                              \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),         \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),         \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),       \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),       \
      c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),       \
      c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),       \
      c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),       \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),       \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define PIA8_F(x) "+f"(x)
#define PIA8_R(x) "+r"(x)

__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PIA8_D64
      ", %64, %65, p;\n}\n"
      : PIA8_OUT64(PIA8_R)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_k32(float (&d)[64], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " PIA8_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : PIA8_OUT64(PIA8_F)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef PIA8_D64
#undef PIA8_OUT64
#undef PIA8_F
#undef PIA8_R

// The stage's weight bytes [128 k][128 n] (N contiguous, as the leaf lies)
// -> the K-major operand [128 n][128 k] in the 128-byte swizzle. Warp w
// takes k rows 16 w .. 16 w + 15 (chunk w of every operand row), lane l
// columns 4 l .. 4 l + 3: 16 word loads (a warp reads a row's 128 bytes at
// once), then for each column the bytes of its 16 rows gathered by
// __byte_perm into one 16-byte chunk.
__device__ __forceinline__ void transpose_stage(const uint8_t* __restrict__ qs,
                                                uint8_t* __restrict__ bs) {
  const int u = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t w[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    w[r] = *reinterpret_cast<const uint32_t*>(qs + (16 * u + r) * kCols + 4 * lane);
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    // the column of this step, rotated so that 8 neighbouring lanes store to
    // 8 different 16-byte bank groups
    const int c = (step + (lane >> 1)) & 3;
    const int n = 4 * lane + c;
    const uint32_t sel = (uint32_t)c | ((uint32_t)(c + 4) << 4);  // byte c of x, of y
    uint32_t v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t a = __byte_perm(w[4 * h], w[4 * h + 1], sel);
      const uint32_t b = __byte_perm(w[4 * h + 2], w[4 * h + 3], sel);
      v[h] = __byte_perm(a, b, 0x5410);  // rows 4h .. 4h + 3, ascending
    }
    *reinterpret_cast<uint4*>(bs + sw_offset<128>(u, n, kCols)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Thread 0 issues the copies of stage st into one ring slot.
template <int W>
__device__ __forceinline__ void load_stage(uint8_t* xd, uint8_t* qd, uint32_t bar,
                                           const CUtensorMap* xm, const CUtensorMap* qm,
                                           int m0, int n0, int st) {
  mbar_expect(bar, Tile<W>::kStageBytes);
  tma_load(smem_u32(xd), xm, st * kStageK, m0, bar);
  tma_load(smem_u32(qd), qm, n0, st * kStageK, bar);
}

// One block's tile: rows [m0, m0 + 64 W) of the M rows, columns
// [n0, n0 + 128) of N, stages [st_begin, st_end) (at least one).
// part == nullptr: the block writes out (bf16 or fp32) with both scales.
// Otherwise it runs split ks alone and writes its raw sums (s32 or fp32) to
// part[ks][m][n], planes of M rows. kSeq (e4m3): the stages are those of
// several splits of sps stages from st_begin, added split by split.
template <bool kFp8, int W, bool kSeq>
__device__ __forceinline__ void w8a8_wgmma_tile(
    const CUtensorMap* xm, const CUtensorMap* qm, const float* __restrict__ xs,
    const float* __restrict__ s, void* __restrict__ part, void* __restrict__ out,
    int out_f32, int M, int N, int m0, int n0, int st_begin, int st_end, int sps,
    int ks, uint8_t* smem_raw) {
  static_assert(kFp8 || !kSeq, "int8 splits in one block share one s32 sum");
  using T = Tile<W>;
  using A = typename Acc<kFp8>::T;
  constexpr int S = T::kStages;
  const int n_st = st_end - st_begin;
  // warpgroup-uniform values, broadcast so that the compiler sees them so:
  // wgmma and its accumulator in a path it takes for divergent would be
  // serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const bool mma = __shfl_sync(0xffffffffu, (int)(wg < W && m0 + 64 * wg < M), 0);

  // the ring, from a 1024-byte boundary (the swizzle reads address bits 7-9)
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* bop = base;                          // [2][kBBytes]
  uint8_t* xsm = base + 2 * T::kBBytes;         // [S][kXBytes]
  uint8_t* qsm = xsm + S * T::kXBytes;          // [S][kQBytes]
  const uint32_t bars = smem_u32(qsm + S * T::kQBytes);  // [S] mbarriers

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

  A acc[64];      // the sum (int8: of every stage; e4m3: of this split)
  float pa[64];   // e4m3: one instruction's sum
  float tot[64];  // e4m3 kSeq: the splits' sum
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
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
    if (mma) {
      if constexpr (kFp8) {  // k step 0
        fence_regs(pa);
        wgmma_fence();
        wgmma_k32(pa, sw_desc<128>(xa), sw_desc<128>(ba), 0);
        wgmma_commit();
      } else {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_k32(acc, sw_desc<128>(xa + 32 * k), sw_desc<128>(ba + 32 * k), 1);
        wgmma_commit();
      }
    }
    if (it + 1 < n_st) {  // the next stage's operand, while this one multiplies
      mbar_wait(bars + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      transpose_stage(qsm + ((it + 1) % S) * T::kQBytes, bop + ((it + 1) & 1) * T::kBBytes);
      fence_async_smem();
    }
    if (mma) {
      if constexpr (kFp8) {
        // fold each k step's sum and start the next
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
          for (int i = 0; i < 64; ++i) acc[i] += pa[i];
        }
        if (kSeq && ((it + 1) % sps == 0 || it + 1 == n_st)) {  // a split ends
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            tot[i] += acc[i];
            acc[i] = 0.f;
          }
        }
      } else {
        wgmma_wait0();
        fence_regs(acc);
      }
    }
    __syncthreads();
  }

  if (wg >= W) return;
  const int wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * wi + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    const float xs_m = part == nullptr ? xs[m] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
      A a0, a1;
      if constexpr (kSeq) {
        a0 = tot[4 * j + 2 * h];
        a1 = tot[4 * j + 2 * h + 1];
      } else {
        a0 = acc[4 * j + 2 * h];
        a1 = acc[4 * j + 2 * h + 1];
      }
      const size_t i = (size_t)m * N + n;
      if (part != nullptr) {
        A* p = static_cast<A*>(part) + (size_t)ks * M * N + i;
        p[0] = a0;
        p[1] = a1;
        continue;
      }
      const float y0 = __fmul_rn(__fmul_rn((float)a0, xs_m), s[n]);
      const float y1 = __fmul_rn(__fmul_rn((float)a1, xs_m), s[n + 1]);
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(y0, y1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
            __floats2bfloat162_rn(y0, y1);
    }
  }
}

}  // namespace pia8
