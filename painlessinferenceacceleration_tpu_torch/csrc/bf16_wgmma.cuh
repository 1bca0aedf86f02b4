// The bf16 GEMM body on Hopper's tensor cores (wgmma), shared by the three
// entries of grouped_gemm.cu (dense, head-batched and grouped):
//
//   out[m, n] = sum_k x[m, k] * w[k, n]     (fp32 sums, bf16 or fp32 out)
//
// x is bf16 [rows, K] (a plane of [planes, rows, K]); the weight is bf16
// [K, N] with N contiguous (a plane of [planes, K, N]: a head or an expert),
// or [N, K] with K contiguous (kKMajor: an embedding table read as the tied
// LM head). Nothing is converted: the tensor memory accelerator (TMA) copies
// each ring stage of both straight into the 128-byte swizzle that wgmma
// reads.
// - x: boxes of 64 k x 64 W rows, a K-major A operand (as K1's x).
// - w [K, N]: two boxes of 64 columns x 64 k rows, an MN-major B operand
//   read with the instruction's transpose bit (16-bit wgmma takes it; 8-bit
//   wgmma does not, which is why K8 transposes in shared memory). In the
//   descriptor, the leading offset steps between the two 64-column boxes and
//   the stride offset between groups of 8 k rows.
// - w [N, K]: one box of 64 k x 128 rows, a K-major B operand (as K1's
//   unpacked weight).
// Rows and columns past the arrays, and k past K, land as zeros, so K and N
// need only be multiples of 8 (TMA's 16-byte rows).
//
// One block: 128 weight columns x a token tile of 64 rows per multiplying
// warpgroup (W = 1 or 2), over the ring stages (64 k each) of its K split,
// and one producer warp after the warpgroups. The producer keeps the ring
// full: it waits for a slot's "empty" mbarrier (the multiplying warps'
// arrivals), announces the stage's bytes on its "full" mbarrier and issues
// the stage's copies. Each multiplying warpgroup waits for "full", issues
// the stage's 4 wgmma m64n128k16 into its running fp32 sum, commits, and
// waits for the previous stage's group only (so the tensor cores always hold
// the next stage's work), then releases that stage's slot. No block barrier
// inside the loop.
//
// A row's bits do not depend on the batch: every row of every tile, in any
// of the three entries, runs the same stages in the same order, the same
// k16 steps of the same instruction, and (over K splits) the same
// fixed-order sum, whether the splits run in one block (kSeq: a second
// register sum, total = 0 + p0 + p1 + ...) or in separate blocks, of which
// the last to finish adds their fp32 planes in the same order (one launch,
// no reduction kernel). The split is a function of (K, N) alone
// (ops/moe_matmul.py bf16_split); how it is launched is chosen by the
// wrapper from the grid (bf16_plan) and changes no bit. The tensor
// cores' products of row m depend on row m of x only; rows of a tile past
// its valid rows are written as zeros or not at all.

#pragma once

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace piabf {

using namespace piawg;

constexpr int kCols = 128;      // weight columns of a block: the wgmma's N
constexpr int kStage = 64;      // k rows of a ring stage: one 128-byte swizzle row
constexpr int kMaxStages = 8;
constexpr int kMnBox = 64 * kStage * 2;  // one 64-column box of an MN-major stage

template <int W>
struct Tile {
  static_assert(W == 1 || W == 2, "one or two multiplying warpgroups");
  static constexpr int kThreads = 128 * W + 32;  // the warpgroups, then the producer warp
  static constexpr int kRows = 64 * W;           // token rows of a block
  static constexpr int kXBytes = kRows * kStage * 2;
  static constexpr int kWBytes = kCols * kStage * 2;
  static constexpr int kStageBytes = kXBytes + kWBytes;  // a "full" mbarrier's count
  static constexpr int kFit = (kSmemLimit - 1024 - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kMaxStages;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A K-major, B K-major
// (kTransB = 0) or MN-major (kTransB = 1), both in shared memory;
// accumulate = 0 starts a fresh sum. Thread t of the warpgroup holds rows
// 16 (t/32) + (t%32)/4 (+8) and columns 8 j + 2 (t%4) (+1): d[4 j + 2 h + c]
// is row +8h, column +c.
template <int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// Descriptor of an MN-major B operand in the 128-byte swizzle: rows of 64
// columns (128 bytes) per k, 8 k rows an atom (1024 bytes); the leading
// offset is the second 64-column box, the stride offset the next 8 k rows.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kMnBox >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The tensor maps of a call (made on the host, passed as __grid_constant__
// kernel parameters) and this block's planes of them: x [planes, rows, K];
// w [planes, K, N] or (kKMajor) [1, N, K]. A head-batched call reads x and
// w plane g for head g; a grouped call reads w plane e for expert e.
struct Operands {
  const CUtensorMap* x;
  const CUtensorMap* w;
  int x_plane;
  int w_plane;
};

// The splits of one tile launched as blocks: split ks of n_splits writes
// its sums to its fp32 plane part[ks] (planes of part_rows rows); the last
// block of the tile to finish (counted on *count, which it sets back to 0)
// adds the planes in split order, total = 0 + p0 + p1 + ..., the order of a
// block that runs every split (kSeq), and writes out.
struct Splits {
  float* part;
  int part_rows;
  int ks;
  int n_splits;
  int* count;
};

// the multiplying and storing threads (every warpgroup, not the producer
// warp, which has left)
template <int W>
__device__ __forceinline__ void sync_warpgroups() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * W) : "memory");
}

// One block's tile: rows [m0, m0 + 64 W) of x's plane and out (rows_total
// rows, of which the first `valid` >= 1 from m0 carry data; rows past them
// inside rows_total get zeros), columns [n0, n0 + 128) of N. Stages
// [g_begin, g_end) (at least one), in K splits of sps stages from g_begin:
// each split's sum starts from zero and the splits are added in order
// (kSeq), or the block runs one split (the only one, or split sp.ks of
// sp.n_splits with sp.part != nullptr). out is the plane of this block's
// head.
template <int W, bool kKMajor, bool kSeq>
__device__ __forceinline__ void gemm_tile(const Operands& op, const Splits& sp,
                                          void* __restrict__ out, int out_f32,
                                          int rows_total, int N, int m0, int n0, int valid,
                                          int g_begin, int g_end, int sps,
                                          uint8_t* smem_raw) {
  using T = Tile<W>;
  constexpr int S = T::kStages;
  const int n_g = g_end - g_begin;
  const int lane = threadIdx.x & 31;
  // warpgroup-uniform values, broadcast so that the compiler sees them so:
  // wgmma and its accumulator in a path it takes for divergent would be
  // serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int n_mma = min(W, (valid + 63) / 64);  // warpgroups with a valid row

  // the ring, from a 1024-byte boundary (the swizzle reads address bits 7-9)
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* xs = base;                     // [S][kXBytes]
  uint8_t* ws = xs + S * T::kXBytes;      // [S][kWBytes]
  const uint32_t full = smem_u32(ws + S * T::kWBytes);  // [S] mbarriers
  const uint32_t empty = full + 8 * S;                  // [S] mbarriers

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init_count(full + 8 * i, 1);
      mbar_init_count(empty + 8 * i, 4 * n_mma);  // lane 0 of each multiplying warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == W) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      for (int it = 0; it < n_g; ++it) {
        const int slot = it % S;
        if (it >= S) mbar_wait(empty + 8 * slot, ((it / S) + 1) & 1);
        const uint32_t bar = full + 8 * slot;
        const int k0 = (g_begin + it) * kStage;
        uint8_t* wdst = ws + slot * T::kWBytes;
        mbar_expect(bar, T::kStageBytes);
        tma_load_3d(smem_u32(xs + slot * T::kXBytes), op.x, k0, m0, op.x_plane, bar);
        if (kKMajor) {
          tma_load_3d(smem_u32(wdst), op.w, k0, n0, op.w_plane, bar);
        } else {
          tma_load_3d(smem_u32(wdst), op.w, n0, k0, op.w_plane, bar);
          tma_load_3d(smem_u32(wdst + kMnBox), op.w, n0 + 64, k0, op.w_plane, bar);
        }
      }
    }
    return;
  }

  float acc[64];  // this split's sum
  float tot[64];  // the splits' sum (kSeq)
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    tot[i] = 0.f;
  }

  if (wg < n_mma) {
    const uint32_t xa0 = smem_u32(xs) + wg * 64 * 128;
    const uint32_t wa0 = smem_u32(ws);
#pragma unroll 1
    for (int it = 0; it < n_g; ++it) {
      const int slot = it % S;
      mbar_wait(full + 8 * slot, (it / S) & 1);
      const int fresh = kSeq ? (it % sps == 0) : (it == 0);
      const uint32_t xa = xa0 + slot * T::kXBytes;
      const uint32_t wa = wa0 + slot * T::kWBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kStage / 16; ++t)
        wgmma_bf16<kKMajor ? 0 : 1>(
            acc, sw_desc<128>(xa + 32 * t),
            kKMajor ? sw_desc<128>(wa + 32 * t) : mn_desc(wa + 16 * 128 * t),
            t > 0 || !fresh);
      wgmma_commit();
      wgmma_wait1();  // the previous stage's products are done: free its slot
      if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      if (kSeq && ((it + 1) % sps == 0 || it + 1 == n_g)) {  // a split ends
        wgmma_wait0();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      }
    }
    wgmma_wait0();
    fence_regs(acc);
  }

  // the block's sums: to out, or to its split's plane
  float* plane = sp.part == nullptr ? nullptr : sp.part + (size_t)sp.ks * sp.part_rows * N;
  const int wi = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * h;
    const int m = m0 + r;
    const bool ok = r < valid;
    if (m >= rows_total || (plane != nullptr && !ok)) continue;  // no plane rows past valid
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
      const float v0 = ok ? (kSeq ? tot : acc)[4 * j + 2 * h] : 0.f;
      const float v1 = ok ? (kSeq ? tot : acc)[4 * j + 2 * h + 1] : 0.f;
      if (plane != nullptr)
        *reinterpret_cast<float2*>(plane + (size_t)m * N + n) = make_float2(v0, v1);
      else if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)m * N + n) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           (size_t)m * N + n) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
  if (plane == nullptr) return;

  // the last split block of the tile adds the planes
  __shared__ int last;
  __threadfence();
  sync_warpgroups<W>();
  if (threadIdx.x == 0) last = atomicAdd(sp.count, 1) == sp.n_splits - 1;
  sync_warpgroups<W>();
  if (!last) return;
  __threadfence();
  // the tile's valid rows x 128 columns in float2 units, kUnits a thread
  // at a time, the planes kPlanes at a time: their loads all in flight
  // before the adds, which run in split order, v = 0 + p0 + p1 + ...; the
  // rows past `valid` (zeros in every plane) are written as zeros
  constexpr int kUnits = 2;
  constexpr int kPlanes = 8;
  const int rows = min(rows_total - m0, 64 * W);
  const int units = min(valid, rows) * (kCols / 2);
  for (int u = units + threadIdx.x; u < rows * (kCols / 2); u += 128 * W) {
    const int m = m0 + u / (kCols / 2);
    const int n = n0 + 2 * (u % (kCols / 2));
    if (n >= N) continue;
    if (out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)m * N + n) =
          make_float2(0.f, 0.f);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + (size_t)m * N +
                                         n) = __floats2bfloat162_rn(0.f, 0.f);
  }
  for (int u0 = threadIdx.x; u0 < units; u0 += kUnits * 128 * W) {
    float2 v[kUnits];
#pragma unroll
    for (int i = 0; i < kUnits; ++i) v[i] = make_float2(0.f, 0.f);
    for (int k0 = 0; k0 < sp.n_splits; k0 += kPlanes) {
      float2 p[kUnits][kPlanes] = {};
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int u = u0 + i * 128 * W;
        const int m = m0 + u / (kCols / 2);
        const int n = n0 + 2 * (u % (kCols / 2));
#pragma unroll
        for (int k = 0; k < kPlanes; ++k)
          if (u < units && n < N && k0 + k < sp.n_splits)
            p[i][k] = __ldcg(reinterpret_cast<const float2*>(
                sp.part + ((size_t)(k0 + k) * sp.part_rows + m) * N + n));
      }
#pragma unroll
      for (int i = 0; i < kUnits; ++i)
#pragma unroll
        for (int k = 0; k < kPlanes; ++k)
          if (k0 + k < sp.n_splits) {
            v[i].x += p[i][k].x;
            v[i].y += p[i][k].y;
          }
    }
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = u0 + i * 128 * W;
      const int m = m0 + u / (kCols / 2);
      const int n = n0 + 2 * (u % (kCols / 2));
      if (u >= units || n >= N) continue;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)m * N + n) = v[i];
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           (size_t)m * N + n) =
            __floats2bfloat162_rn(v[i].x, v[i].y);
    }
  }
  if (threadIdx.x == 0) *sp.count = 0;  // ready for the next call
}

// The two maps of a call: x [planes, rows, K]; w [planes, K, N] or
// (k_major) [1, N, K]; all bf16, in the 128-byte swizzle.
template <int W>
inline bool make_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* w,
                      int x_planes, int rows, int K, int w_planes, int N, bool k_major) {
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  return make_map_3d(xm, x, bf16, 2, K, rows, x_planes, kStage, Tile<W>::kRows, sw) &&
         (k_major ? make_map_3d(wm, w, bf16, 2, K, N, 1, kStage, kCols, sw)
                  : make_map_3d(wm, w, bf16, 2, N, K, w_planes, 64, kStage, sw));
}

}  // namespace piabf
