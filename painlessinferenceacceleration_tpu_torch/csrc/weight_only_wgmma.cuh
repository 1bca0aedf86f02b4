// The weight-only GEMM body on Hopper's tensor cores (wgmma), shared by the
// int4 kernels (int4_gemm.cu, grouped_int4_gemm.cu) and the int8 kernels
// (int8_gemm.cu, grouped_int8_gemm.cu):
//
//   out[m, n] = sum_g s[g, n] * ( sum_{k in g} x[m, k] * w[k, n] )
//
// the bracketed partial in fp32, the scale on the partial (the Pallas
// bodies' _qmm4_v3_acc; the int8 bodies scale the bf16 weight instead, see
// ROADMAP's reference caveats). x is bf16 [M, K], s bf16 [K/g, N], and the
// weight is read in the JAX layout, N contiguous:
// - int4 (kInt8 = false): q uint8 [K/2, N]; byte j of a group holds row
//   losrc[j] = j/2 + (j%2)*(g/4) in its low nibble and row losrc[j] + g/2 in
//   its high nibble, biased by +8. A ring stage is one group (g = C = 32, 64
//   or 128).
// - int8 (kInt8 = true): q int8 [K, N]. A ring stage is C k rows of one
//   group, C the largest of 128, 64 and 32 that divides g (any g % 32 == 0:
//   a model's whole-K group of 10944 rows runs in stages of 64); a group
//   folds g / C times.
//
// One block: 128 weight columns x a token tile of 64 rows per multiplying
// warpgroup (W = 1 or 2), over the stages of its K split. One stage of a
// ring in shared memory holds the stage's weight rows x 128 columns, their
// 128 scales and the x tile [64 W, C], brought by the tensor memory
// accelerator (TMA: one thread issues a stage's copies against tensor maps
// made on the host, an mbarrier counts their bytes; x lands in the swizzle
// the tensor cores read, rows past the matrix as zeros). Both warpgroups
// turn the stage's weight into a bf16 operand [128 columns][C] (K-major,
// swizzled, each value at its logical k row, so x is copied as it lies),
// exactly:
// - int4: (nibble | 0x4300) read as bf16 is 128 + nibble, and 128 + nibble
//   - 136 = nibble - 8.
// - int8: (b & 0x7F) | 0x4300 is 128 + (b & 0x7F), (b & 0x80) | 0xC300 is
//   -128 or (sign bit set) -256, and their sum is the byte's value; a byte
//   pair takes one prmt, two lop3 and one bf16x2 fma. (bf16 holds 8
//   significant bits, so no single bias covers 256 values as the int4 trick
//   does; the fp16 bias 0x6400 does, but fp16 -> bf16 then costs a
//   conversion through fp32 for every value.) The operand is K-major, as
//   int4's, rather than N-major with the instruction's transpose flag: the
//   same descriptors, and the rotated 16-byte stores of int4's unpacking
//   hit 8 bank groups per phase in either (tests/test_torch_int8_plan.py).
// Then each multiplying warpgroup runs C/16 wgmma m64n128k16 (fp32 += bf16 x
// bf16, both operands in shared memory) into a fresh fp32 stage accumulator
// and folds it into the running sum on CUDA cores: acc = fma(part, s[g, n],
// acc). The operand is double-buffered: the next stage is unpacked while the
// tensor cores multiply this one. Stages of 64 and 128 k use the 128-byte
// swizzle (64 k a row of an atom); a stage of 32 fills 64-byte rows and uses
// the 64-byte swizzle.
//
// A row's bits do not depend on the batch: every row of every tile, in the
// dense or the grouped kernel, runs the same stages in the same order, the
// same k16 steps of the same instruction, and (over K splits) the same
// fixed-order sum, whether the splits run in one block or in separate blocks
// and a reduction; the split count is a function of (K, N, C) alone, chosen
// by the wrapper (ops/quant_matmul.py stage_split), which launches the splits
// as blocks only where the row tiles alone would not fill the card. The
// tensor cores' products of row m depend on row m of the operand only; rows
// of a tile past its valid rows are written as zeros or not at all.

#pragma once

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace piawo {

using namespace piawg;

constexpr int kCols = 128;            // weight columns of a block: the wgmma's N
constexpr int kThreads = 256;         // two warpgroups: both unpack
constexpr int kMaxStages = 6;

template <bool kInt8, int C, int W>
struct Tile {
  static_assert(C == 32 || C == 64 || C == 128, "stages of 32, 64 or 128 k rows");
  static_assert(W == 1 || W == 2, "one or two multiplying warpgroups");
  static constexpr int kSpan = C < 64 ? C : 64;  // k of a swizzle atom's row
  static constexpr int kRowBytes = 2 * kSpan;    // 128 or 64: the swizzle's width
  static constexpr int kRows = 64 * W;          // token rows of a block
  static constexpr int kXBytes = kRows * C * 2;  // the x tile of a stage
  static constexpr int kQRows = kInt8 ? C : C / 2;  // weight rows of a stage
  static constexpr int kQBytes = kQRows * kCols;
  static constexpr int kSBytes = kCols * 2;      // the stage's scales
  static constexpr int kBBytes = kCols * C * 2;  // one bf16 operand
  static constexpr int kStageBytes = kXBytes + kQBytes + kSBytes;
  static constexpr int kFit =
      (kSmemLimit - 1024 - 8 * kMaxStages - 2 * kBBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytesPerStage = kStageBytes;  // an mbarrier's count
  static constexpr int kSmem = 1024 + 2 * kBBytes + kStages * kStageBytes + 8 * kMaxStages;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], both K-major in shared memory;
// accumulate = 0 starts a fresh sum. Thread t of the warpgroup holds rows
// 16 (t/32) + (t%32)/4 (+8) and columns 8 j + 2 (t%4) (+1): d[4 j + 2 h + c]
// is row +8h, column +c.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// two biased nibbles at bits 0-3 and 16-19 -> bf16x2 of (nibble - 8), exact
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) | 0x43004300u;  // 128 + nibble
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1 - 136
  return r;
}

// two int8 at bits 0-7 and 16-23 -> bf16x2 of their values, exact:
// (128 + (b & 0x7F)) * 1 + (-128 or, with the sign bit, -256)
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t v) {
  const uint32_t low7 = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t bias = (v & 0x00800080u) | 0xC300C300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(low7), "r"(0x3F803F80u), "r"(bias));
  return r;
}

// int4: the stage's packed rows [C/2][128] -> the bf16 operand [128
// columns][C]. Warp w < C/16 takes the packed rows 16 v + 2 e + p (e =
// 0..7) of band v = w/2, parity p = w%2; lane l takes columns 4 l .. 4 l +
// 3. Byte 16 v + 2 e + p holds k = 8 v + e + p C/4 (low nibble) and that +
// C/2 (high): chunks u = v + p C/32 and u + C/16 of the band, element e.
template <int G, int RB>
__device__ __forceinline__ void dequant_stage(const uint8_t* __restrict__ qs,
                                              uint8_t* __restrict__ bs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= G / 16) return;
  const int v = warp >> 1;
  const int p = warp & 1;
  uint32_t w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e] = *reinterpret_cast<const uint32_t*>(qs + (16 * v + 2 * e + p) * kCols +
                                              4 * lane);
  const int u_lo = v + p * (G / 32);
  const int u_hi = u_lo + G / 16;
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    // the column of this step, rotated so that 8 neighbouring lanes store to
    // 8 different 16-byte bank groups (in either swizzle)
    const int c = (step + (lane >> 1)) & 3;
    const int n = 4 * lane + c;
    const uint32_t sel = (uint32_t)c | ((uint32_t)(c + 4) << 8);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      // byte c of rows e = 2h and 2h + 1 at bits 0-7 and 16-23
      const uint32_t d = __byte_perm(w[2 * h], w[2 * h + 1], sel);
      lo[h] = nibbles_to_bf16x2(d);
      hi[h] = nibbles_to_bf16x2(d >> 4);
    }
    *reinterpret_cast<uint4*>(bs + sw_offset<RB>(u_lo, n, kCols)) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(bs + sw_offset<RB>(u_hi, n, kCols)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// int8: the stage's rows [C][128] -> the bf16 operand [128 columns][C].
// Item i (thread t, then t + 256) takes band u = i / 32 (k rows 8 u .. 8 u
// + 7, one 16-byte operand chunk) and lane l = i % 32's columns 4 l .. 4 l
// + 3: one word of each of the 8 rows, then for each column the chunk of
// operand row 4 l + c, k ascending. C = 32 has 128 items: half the threads.
template <int C, int RB>
__device__ __forceinline__ void widen_stage(const uint8_t* __restrict__ qs,
                                            uint8_t* __restrict__ bs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i0 = 0; i0 < 4 * C; i0 += kThreads) {
    const int i = i0 + (int)threadIdx.x;
    if (4 * C < kThreads && i >= 4 * C) return;
    const int u = i >> 5;
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = *reinterpret_cast<const uint32_t*>(qs + (8 * u + e) * kCols + 4 * lane);
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int c = (step + (lane >> 1)) & 3;  // rotated as in dequant_stage
      const int n = 4 * lane + c;
      const uint32_t sel = (uint32_t)c | ((uint32_t)(c + 4) << 8);
      uint32_t h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte c of rows 2j and 2j + 1: k and k + 1
        h[j] = s8x2_to_bf16x2(__byte_perm(w[2 * j], w[2 * j + 1], sel));
      *reinterpret_cast<uint4*>(bs + sw_offset<RB>(u, n, kCols)) =
          make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
}

template <bool kInt8, int C, int RB>
__device__ __forceinline__ void unpack_stage(const uint8_t* __restrict__ qs,
                                             uint8_t* __restrict__ bs) {
  if constexpr (kInt8)
    widen_stage<C, RB>(qs, bs);
  else
    dequant_stage<C, RB>(qs, bs);
}

// The tensor maps of one call (made on the host, passed as __grid_constant__
// kernel parameters): x bf16 [rows, K] in boxes of min(C, 64) k x 64 W rows
// in the operand's swizzle; the weight rows uint8 [rows, N] in boxes of 128
// columns x a stage's rows; the scales bf16 [rows, N] in boxes of 128 x 1.
// A grouped call's maps span all experts; q_row0 / s_row0 are this block's
// expert's first rows. int8: stage st reads scale row st / stages_per_group.
struct Maps {
  const CUtensorMap* x;
  const CUtensorMap* q;
  const CUtensorMap* s;
  int q_row0;
  int s_row0;
  int stages_per_group;
};

// Thread 0 issues the copies of stage g into ring slot `slot`.
template <bool kInt8, int C, int W>
__device__ __forceinline__ void load_stage(uint8_t* xs, uint8_t* qs, uint8_t* ss,
                                           uint32_t bar, const Maps& maps,
                                           int m0, int n0, int g) {
  using T = Tile<kInt8, C, W>;
  mbar_expect(bar, T::kBytesPerStage);
#pragma unroll
  for (int a = 0; a < C / T::kSpan; ++a)
    tma_load(smem_u32(xs + a * T::kRows * T::kRowBytes), maps.x,
             g * C + a * T::kSpan, m0, bar);
  tma_load(smem_u32(qs), maps.q, n0, maps.q_row0 + g * T::kQRows, bar);
  if constexpr (kInt8)
    tma_load(smem_u32(ss), maps.s, n0, maps.s_row0 + g / maps.stages_per_group, bar);
  else
    tma_load(smem_u32(ss), maps.s, n0, maps.s_row0 + g, bar);
}

// One block's tile. rows_total: the rows of x and out; the tile covers rows
// [m0, m0 + 64 W) and columns [n0, n0 + 128), of which the first `valid`
// rows carry data (valid >= 1); rows
// past them inside rows_total get zeros in out. Stages [g_begin, g_end)
// (at least one), in K splits of gps stages from g_begin: each split's sum
// starts from zero and the splits are added in order, total = 0 + p0 + p1 +
// ..., the order in which splitk_reduce_kernel adds the planes of splits run
// by separate blocks. So a block that runs every split (kSeq: a third
// accumulator, 64 registers more) gives the bits of one split a block and
// the reduction, without the planes. Otherwise the block runs one split
// (the only one, or split ks with part != nullptr: its sums go to
// part[ks][m][n], planes of part_rows rows, zeros included).
template <bool kInt8, int C, int W, bool kSeq>
__device__ __forceinline__ void wgmma_tile(
    const Maps& maps, float* __restrict__ part, int part_rows,
    void* __restrict__ out, int out_f32, int rows_total, int N, int m0, int n0,
    int valid, int g_begin, int g_end, int gps, int ks, uint8_t* smem_raw) {
  using T = Tile<kInt8, C, W>;
  constexpr int S = T::kStages;
  const int n_g = g_end - g_begin;
  // warpgroup-uniform values, broadcast so that the compiler sees them so:
  // wgmma and its accumulator in a path it takes for divergent would be
  // serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const bool mma = __shfl_sync(0xffffffffu, (int)(wg < W && 64 * wg < valid), 0);

  constexpr int RB = T::kRowBytes;
  constexpr int kSteps = T::kSpan / 16;  // k16 steps in an atom's row
  // the ring, from a 1024-byte boundary (the swizzle reads address bits 7-9)
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* bop = base;                              // [2][kBBytes]
  uint8_t* xs = base + 2 * T::kBBytes;              // [S][kXBytes]
  uint8_t* qs = xs + S * T::kXBytes;                // [S][kQBytes]
  uint8_t* ss = qs + S * T::kQBytes;                // [S][kSBytes]
  const uint32_t bars = smem_u32(ss + S * T::kSBytes);  // [S] mbarriers

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + 8 * i);
    fence_mbar_init();
    for (int st = 0; st < S - 1 && st < n_g; ++st)
      load_stage<kInt8, C, W>(xs + st * T::kXBytes, qs + st * T::kQBytes,
                              ss + st * T::kSBytes, bars + 8 * st, maps, m0, n0,
                              g_begin + st);
  }
  __syncthreads();
  mbar_wait(bars, 0);
  unpack_stage<kInt8, C, RB>(qs, bop);
  fence_async_smem();
  __syncthreads();

  float acc[64];  // this split's sum
  float pa[64];   // this stage's partial
  float tot[64];  // the splits' sum (kSeq)
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    pa[i] = 0.f;
    tot[i] = 0.f;
  }
  const int lane = threadIdx.x & 31;

#pragma unroll 1
  for (int it = 0; it < n_g; ++it) {
    const int slot = it % S;
    // refill the slot that stage it - 1 left (its reads ended before the
    // barrier closing the previous iteration)
    const int nx = it + S - 1;
    if (threadIdx.x == 0 && nx < n_g) {
      const int ns = nx % S;
      load_stage<kInt8, C, W>(xs + ns * T::kXBytes, qs + ns * T::kQBytes,
                              ss + ns * T::kSBytes, bars + 8 * ns, maps, m0, n0,
                              g_begin + nx);
    }
    if (mma) {
      const uint32_t xa = smem_u32(xs + slot * T::kXBytes) + wg * 64 * RB;
      const uint32_t ba = smem_u32(bop + (it & 1) * T::kBBytes);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < C / 16; ++t)
        wgmma_m64n128k16(
            pa,
            sw_desc<RB>(xa + (t / kSteps) * (T::kRows * RB) + (t % kSteps) * 32),
            sw_desc<RB>(ba + (t / kSteps) * (kCols * RB) + (t % kSteps) * 32), t > 0);
      wgmma_commit();
    }
    if (it + 1 < n_g) {  // the next stage's operand, while this one multiplies
      mbar_wait(bars + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      unpack_stage<kInt8, C, RB>(qs + ((it + 1) % S) * T::kQBytes,
                                 bop + ((it + 1) & 1) * T::kBBytes);
      fence_async_smem();
    }
    if (mma) {
      wgmma_wait0();
      fence_regs(pa);
      const __nv_bfloat16* sc =
          reinterpret_cast<const __nv_bfloat16*>(ss + slot * T::kSBytes);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 sv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sc + 8 * j + 2 * (lane & 3)));
        acc[4 * j + 0] = fmaf(pa[4 * j + 0], sv.x, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(pa[4 * j + 1], sv.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(pa[4 * j + 2], sv.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(pa[4 * j + 3], sv.y, acc[4 * j + 3]);
      }
      if (kSeq && ((it + 1) % gps == 0 || it + 1 == n_g)) {  // a split ends
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
  const int wi = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * h;
    const int m = m0 + r;
    const bool ok = r < valid;
    if (m >= rows_total) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
      const float v0 = ok ? (kSeq ? tot : acc)[4 * j + 2 * h] : 0.f;
      const float v1 = ok ? (kSeq ? tot : acc)[4 * j + 2 * h + 1] : 0.f;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + ((size_t)ks * part_rows + m) * N + n) =
            make_float2(v0, v1);
      else if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)m * N + n) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           (size_t)m * N + n) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The three maps of a call: x [x_rows, K], q [q_rows, N], s [s_rows, N].
template <bool kInt8, int C, int W>
inline bool make_maps(CUtensorMap* xm, CUtensorMap* qm, CUtensorMap* sm,
                      const void* x, const void* q, const void* s, int x_rows,
                      int K, int q_rows, int s_rows, int N) {
  using T = Tile<kInt8, C, W>;
  return make_map(xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x_rows, K, T::kSpan,
                  T::kRows,
                  T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B) &&
         make_map(qm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q_rows, N, kCols, T::kQRows,
                  CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map(sm, s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, s_rows, N, kCols, 1,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The int8 stage of a scale group (> 0): the largest of 128, 64 and 32
// that divides it (0: none, a group the kernels do not take).
inline int int8_stage(int group) {
  return group % 128 == 0 ? 128 : group % 64 == 0 ? 64 : group % 32 == 0 ? 32 : 0;
}

}  // namespace piawo
