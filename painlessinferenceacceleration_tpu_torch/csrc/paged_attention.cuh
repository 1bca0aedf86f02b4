// Paged attention over the KV arena for Hopper (sm_90a) on the tensor cores
// (wgmma): decode, tree verify and causal prefill in one body, over a bf16
// arena or an e4m3 one.
//
// Replaces the Pallas bodies _attn_decode_kernel (Q = 1),
// _attn_verify_kernel (1 < Q <= 128) and _attn_prefill_kernel (Q > 128,
// causal) of painlessinferenceacceleration_tpu/ops/paged_attention.py, and
// _attn_decode_tok_kernel (the per-token-scale e4m3 arena). Decode is the
// verify rule with a one-entry mask; prefill is the same walk with the
// causal rule in place of the mask. The mask rule takes any Q: a tree
// verify past 128 rows (which the JAX package leaves to XLA) runs as many
// tiles as prefill would, each walking the keys up to the step's last.
// Three arena modes (template MODE):
//   0  bf16 arena;
//   1  e4m3 arena with static per-(layer, kv head) scales: the K scale folds
//      into the score factor and the V scale into the output, as the Pallas
//      wrappers fold them into q and the output;
//   2  e4m3 arena with per-(token, kv head) f32 scales [n_pages, ps, Hkv]:
//      the K scale multiplies each score before the softmax and the V scale
//      each probability before it is rounded to bf16 for P @ V (the
//      normaliser keeps the unscaled probabilities), which equals attending
//      over the dequantized rows.
//
// ALiBi (template ALIBI, the bloom / baichuan-13b families): each score
// gains slope[qh] * pos before the row max, in fp32, as the plain version
// (ops/attention.py mha_reference) adds it, where pos is the key's
// position: its slot j for a committed key (j < ctx), and kpos[b, j - ctx]
// for the step's own keys when kpos is given under the mask rule (a tree
// verify's node sits at ctx + its depth, not at its slot; without kpos, and
// under the causal rule, which puts a chunk's key s at ctx + s, at its
// slot). A thread takes its 16 columns' positions once a key block, and
// reads kpos only in the blocks that hold the step's keys. The bias is
// added in the log2 units the softmax runs in (slope * log2(e) * pos after
// the score factor), so in every mode the ALiBi scores are scaled in place
// and the softmax's factor left is 1. The expression depends on the row's
// head, the key's position and its product only: a prefill row stays
// bit-equal to its decode. The ALiBi build moves
// registers from the loader warpgroup to the consumers (setmaxnreg: 56 and
// 224 a thread; the launch bound leaves 168 to each) so that its softmax
// does not spill. Without ALIBI the body is the slope-free one,
// instruction for instruction.
//
// Context parallelism (template RANGED, the bf16 arena without ALiBi): a
// rank walks only the key blocks whose page id lies in its [page_lo,
// page_hi); a skipped block is neither loaded nor multiplied, and the walked
// ones keep their absolute order, so the full range gives the bits of the
// call without one. Every build can also write each row's log-sum-exp of
// its scaled scores (lse, natural log; -inf for a row that saw no key, whose
// output is 0), which ops/cp_attention.py merges across the ranks. Without
// RANGED the walk is the one of before, block for block.
//
// Visibility (ops/attention.py): key slot j is visible to query row t iff
// j < ctx, or s = j - ctx lies in [0, Q) and qmask[b, t, s] (causal: s <= t).
// A masked score is the sentinel -1e30 and its probability exactly 0, so a
// fully masked row stays finite (its output is 0). The causal rule takes an
// optional prefix-LM window[b] (AntGLM's prompt length, JAX
// engine/step.py:75-78): key s of the chunk is also visible to every row
// where ctx + s < window[b]; the walk then reaches the later of the causal
// bound and the window, in the same absolute block order.
//
// Head dims (template DK, DV: the K and Q rows' lanes, the V and output
// rows'): (64, 64), (128, 128), (256, 256) (GPT-J) and (192, 128) (DeepSeek's
// MLA in expanded mode: nope + rope lanes of K beside 128 of V). The K and V
// arenas are [n_pages * 64, Hkv * dk] and [.., Hkv * dv], each with its own
// tensor map, where dk <= DK and dv <= DV are the heads' own widths (run
// time): OPT's 80 and BLOOM's 96 lanes run the (128, 128) build. The tile's
// Q is zero past dk lanes; head h's K and V are read as the build's 64-lane
// boxes from column h * dk (h * dv), so the lanes past the head's width are
// the next head's (finite: the arena starts as zeros and its e4m3 writes
// clip to +-448) or, past the last head, TMA's out-of-bounds zeros. Q's zero
// lanes add exact zeros to the fp32 scores, and O's lanes past dv are
// dropped at the store. Each head starts on a 16-byte boundary (160 h or
// 192 h bytes in bf16, 80 h or 96 h in e4m3), as TMA's row strides need.
// This reads 128 / dk times the heads' K / V bytes (1.6x at 80, 1.33x at
// 96) and adds no instantiation.
// At DV = 256 a consumer thread holds 128 fp32 of O: the build moves
// registers from the loader as ALiBi's does (setmaxnreg 56 / 224) and
// runs each key block's S and P V one after the other (the same operations
// in the same order as the pipelined walk, so the same bits), so that the
// scores and the P fragments are not live beside O. The e4m3 modes keep as
// many raw stages (4 down to 1) as leave two bf16 stages.
//
// What bounds it on the H100: at decode the K/V bytes, 2 * ctx * D * (2 or 1)
// B per (request, kv head) and layer; at prefill the two products, 4 D FLOP
// per visible (row, key) pair at 989 TFLOP/s. The design:
// - A block takes (kv head, request, query tile). A tile is 128 rows: the G
//   query heads of the kv head (any G from 1 to 128) times 128 / G
//   positions, rounded down (fewer where Q is shorter), row r -> head
//   h * G + r / nt, position t0 + r % nt; the rows past G * nt are zero
//   padding (2 rows at G = 7: 18 positions). Two consumer warpgroups take
//   64 rows each; a warpgroup whose rows are all padding takes no part.
//   Decode and verify with Q * G <= 128 are one tile a kv head. Causal
//   tiles are launched heaviest (last) first.
// - Keys are walked in blocks of 64 at absolute key positions, one page
//   (page size 64), from key 0 to the tile's last visible key. A producer
//   thread reads each page id from page_tables and issues TMA loads of the
//   page's K and V rows of this kv head ([n_pages * 64, Hkv * D] 2-d views)
//   into a ring of stages released by mbarriers. bf16 K and V land straight
//   in the 128-byte swizzle wgmma reads. e4m3 K and V land raw in a ring of
//   their own; three converter warps widen them to bf16 (exact) into the
//   swizzled ring, with the per-token scales beside them.
// - S = Q K^T: wgmma m64n64k16, Q and K K-major from shared memory. The
//   softmax runs in registers, online over the key blocks; P (bf16) is the
//   A operand of O += P V straight from registers (wgmma m64nDk16, the
//   accumulator layout of S is the A fragment layout), V read MN-major
//   through the transpose bit, two 64-column boxes apart.
// - A row's bits depend only on the keys it sees: every row runs the same
//   key blocks from key 0 in the same order, the same instructions on its
//   own row of Q, the same fixed-order reductions (a thread's own columns in
//   order, then the quad's shuffles); a key block with no visible key for a
//   row leaves its m, l and O unchanged (alpha is exactly 1, P exactly 0).
//   So a row is the same at every Q, in every route (decode, verify,
//   prefill), at every place in the tile and in either warpgroup.

//
// This header holds the body and its launch templates; each source that
// includes it instantiates its own (DK, DV) pairs (pa_dispatch,
// pa_smem_bytes) and so is its own library: paged_attention.cu the 64- and
// 128-lane pairs, paged_attention_wide.cu GPT-J's (256, 256) and
// DeepSeek's (192, 128), compiled side by side (each pair is 7
// instantiations: three arenas with and without ALiBi, and the page range).

#pragma once

#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "wgmma_common.cuh"

namespace {

using namespace piawg;

constexpr int kRows = 128;       // query rows of a tile
constexpr int kKeys = 64;        // keys of a block: one page
constexpr int kThreads = 384;    // two consumer warpgroups, then the loader warpgroup
constexpr int kLoader = 256;     // the first loader thread (issues the TMA copies)
constexpr int kConverters = 96;  // loader warps 1-3: the e4m3 widening
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kBf16 = 0;       // bf16 arena
constexpr int kFp8Head = 1;    // e4m3 arena, static per-head scales
constexpr int kFp8Token = 2;   // e4m3 arena, per-token scales

// Shared memory of one block: the tile's Q (K-major, 128-byte swizzle, in
// 64-column chunks of 128 rows), a ring of bf16 K+V stages (each K and V
// in 64-column boxes of 64 keys, the layout TMA's 128-byte swizzle lands),
// for e4m3 a ring of raw K+V stages, for per-token scales 2 x 64 floats a
// bf16 stage, then the mbarriers.
template <int DK, int DV, int MODE>
struct Smem {
  static constexpr int kQBytes = kRows * DK * 2;
  static constexpr int kKHalf = kKeys * DK * 2;    // K of a bf16 stage
  static constexpr int kVHalf = kKeys * DV * 2;    // V of a bf16 stage
  static constexpr int kStage = kKHalf + kVHalf;
  static constexpr int kRawK = kKeys * DK;         // K of a raw e4m3 stage
  static constexpr int kRaw = MODE == kBf16 ? 0 : kKeys * (DK + DV);
  static constexpr int kScales = MODE == kFp8Token ? 2 * kKeys * 4 : 0;
  // the most raw stages (4 down to 1) that leave room for two bf16 stages
  static constexpr int kPer = kStage + kScales;
  static constexpr int kRest = kSmemLimit - 1024 - kQBytes - 256;
  static constexpr int kRawStages =
      MODE == kBf16 ? 0
      : (kRest - 4 * kRaw) / kPer >= 2 ? 4
      : (kRest - 3 * kRaw) / kPer >= 2 ? 3
      : (kRest - 2 * kRaw) / kPer >= 2 ? 2 : 1;
  static constexpr int kFixed = 1024 + kQBytes + kRawStages * kRaw + 256;
  static constexpr int kFit = (kSmemLimit - kFixed) / (kStage + kScales);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kBytes = kFixed + kStages * (kStage + kScales);
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

// 2^x in one instruction (results below 2^-126 flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// s[64 x 64] = A[64 x 16] * B[16 x 64], both K-major in shared memory;
// accumulate = 0 starts a fresh sum. Thread t of the warpgroup holds rows
// 16 (t/32) + (t%32)/4 (+8) and columns 8 j + 2 (t%4) (+1): s[4 j + 2 h + c]
// is row +8h, column +c.
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t a, uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// o[64 x 64] += P[64 x 16] * V[16 x 64]: P from registers (the A fragment:
// a[i] holds row +8 (i % 2), columns +8 (i / 2) + 2 (t%4) (+1)), V MN-major
// in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// o[64 x 128] += P[64 x 16] * V[16 x 128], as wgmma_pv.
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Descriptor of the MN-major V operand in the 128-byte swizzle: rows of 64
// columns (128 bytes) a key, 8 keys an atom (1024 bytes); the leading offset
// is the second 64-column box, the stride offset the next 8 keys.
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((kKeys * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int DK, int DV, int MODE, bool ALIBI, bool RANGED>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap km, const __grid_constant__ CUtensorMap vm,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ page_tables,
    const int* __restrict__ ctx_lens, const uint8_t* __restrict__ qmask,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ alibi, const int* __restrict__ kpos,
    const int* __restrict__ window, __nv_bfloat16* __restrict__ out, int Q, int Hq,
    int Hkv, int dk, int dv, int P, int QT, int n_tiles, float scale, int causal,
    int page_lo, int page_hi, float* __restrict__ lse) {
  using L = Smem<DK, DV, MODE>;
  constexpr int S = L::kStages;
  constexpr int R = L::kRawStages > 0 ? L::kRawStages : 1;  // (no raw ring in bf16)
  // DV = 256: registers moved to the consumers, and no P V behind the scores
  constexpr bool kWide = DV > 128;
  constexpr bool kMoveRegs = ALIBI || kWide;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  uint8_t* q_s = base;                                   // [kChunks][kRows][128 B]
  uint8_t* ring = q_s + L::kQBytes;                      // [S][K, V]
  uint8_t* raw = ring + S * L::kStage;                   // [R][K, V] e4m3
  float* sc_s = reinterpret_cast<float*>(raw + R * L::kRaw);  // [S][ks 64, vs 64]
  const uint32_t bars = smem_u32(reinterpret_cast<uint8_t*>(sc_s) + S * L::kScales);
  const uint32_t full = bars, empty = bars + 8 * S;      // the bf16 ring's
  const uint32_t rfull = bars + 16 * S, rempty = rfull + 8 * R;  // the raw ring's

  const int lane = threadIdx.x & 31;
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int G = Hq / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // heaviest first: under the causal rule the last tile walks the most keys
  const int tile = causal ? n_tiles - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int t0 = tile * QT;
  const int nt = min(QT, Q - t0);
  const int n_rows = G * nt;
  const int n_mma = min(2, (n_rows + 63) / 64);  // warpgroups with a valid row
  const int ctx = ctx_lens[b];
  // the prefix-LM window: keys below win are visible to every row (causal only)
  const int win = causal && window != nullptr ? min(window[b], ctx + Q) : 0;
  const int last_key = causal ? max(ctx + t0 + nt - 1, win - 1) : ctx + Q - 1;
  const int n_blocks = min(last_key / kKeys + 1, P);
  const int* pt = page_tables + (size_t)b * P;
  // the key blocks walked, in ascending order: every one, or (RANGED) those
  // whose page lies in [page_lo, page_hi); ring slot i holds the i-th of them
  auto next_block = [&](int kb) {
    int k = kb + 1;
    if constexpr (RANGED) {
      while (k < n_blocks && (unsigned)(pt[k] - page_lo) >= (unsigned)(page_hi - page_lo)) ++k;
    }
    return k;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init_count(full + 8 * i, MODE == kBf16 ? 1 : kConverters / 32);
      mbar_init_count(empty + 8 * i, 4 * n_mma);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < R; ++i) {
      mbar_init_count(rfull + 8 * i, 1);
      mbar_init_count(rempty + 8 * i, kConverters / 32);
    }
    fence_mbar_init();
  }
  // the tile's q rows, zeros past n_rows and past the head's dk lanes, in
  // the swizzle wgmma reads
  if (threadIdx.x < kLoader) {
    constexpr int kUnits = DK / 8;  // 16-byte units of a row
    for (int e = threadIdx.x; e < kRows * kUnits; e += kLoader) {
      const int r = e / kUnits, u = e % kUnits;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < n_rows && 8 * u < dk) {
        const int t = t0 + r % nt, qh = h * G + r / nt;
        v = *reinterpret_cast<const uint4*>(q + (((size_t)b * Q + t) * Hq + qh) * dk + 8 * u);
      }
      *reinterpret_cast<uint4*>(q_s + (u / 8) * (kRows * 128) + r * 128 +
                                (((u % 8) ^ (r & 7)) << 4)) = v;
    }
    fence_async_smem();
  }
  __syncthreads();

  if (threadIdx.x >= kLoader) {
    // ---- the loader warpgroup ----
    // (ALiBi's consumers and DV = 256's need more than the 168 registers a
    // thread the launch bound gives: the loader hands them its share)
    if constexpr (kMoveRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int lt = threadIdx.x - kLoader;
    if (MODE == kBf16) {
      if (lt != 0) return;
      for (int kb = next_block(-1), i = 0; kb < n_blocks; kb = next_block(kb), ++i) {
        const int slot = i % S;
        if (i >= S) mbar_wait(empty + 8 * slot, ((i / S) + 1) & 1);
        const int row = pt[kb] * kKeys;
        uint8_t* dst = ring + slot * L::kStage;
        mbar_expect(full + 8 * slot, L::kStage);
#pragma unroll
        for (int c = 0; c < DK / 64; ++c)
          tma_load(smem_u32(dst + c * kKeys * 128), &km, h * dk + 64 * c, row, full + 8 * slot);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(smem_u32(dst + L::kKHalf + c * kKeys * 128), &vm, h * dv + 64 * c, row,
                   full + 8 * slot);
      }
      return;
    }
    if (lt == 0) {  // the raw ring's producer
      for (int kb = next_block(-1), i = 0; kb < n_blocks; kb = next_block(kb), ++i) {
        const int slot = i % R;
        if (i >= R) mbar_wait(rempty + 8 * slot, ((i / R) + 1) & 1);
        const int row = pt[kb] * kKeys;
        uint8_t* dst = raw + slot * L::kRaw;
        mbar_expect(rfull + 8 * slot, L::kRaw);
        tma_load(smem_u32(dst), &km, h * dk, row, rfull + 8 * slot);
        tma_load(smem_u32(dst + L::kRawK), &vm, h * dv, row, rfull + 8 * slot);
      }
      return;
    }
    if (lt < 32) return;
    // the converters: raw e4m3 stage -> swizzled bf16 stage (and the
    // per-token scales beside it)
    const int ct = lt - 32;
    for (int kb = next_block(-1), i = 0; kb < n_blocks; kb = next_block(kb), ++i) {
      const int rs = i % R, slot = i % S;
      mbar_wait(rfull + 8 * rs, (i / R) & 1);
      if (i >= S) mbar_wait(empty + 8 * slot, ((i / S) + 1) & 1);
      const uint8_t* src = raw + rs * L::kRaw;
      uint8_t* dst = ring + slot * L::kStage;
      constexpr int kKU = DK / 16, kVU = DV / 16;  // 16-byte units of a raw K / V row
      for (int e = ct; e < kKeys * (kKU + kVU); e += kConverters) {
        const int which = e >= kKeys * kKU;  // K or V
        const int ev = which ? e - kKeys * kKU : e;
        const int units = which ? kVU : kKU;
        const int k = ev / units, u = ev % units;
        const uint4 w = *reinterpret_cast<const uint4*>(
            src + (which ? L::kRawK + k * DV : k * DK) + 16 * u);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[2 * i] = e4m3x2_to_bf16x2(ws[i] & 0xffffu);
          o[2 * i + 1] = e4m3x2_to_bf16x2(ws[i] >> 16);
        }
        // 16 values = the 16-byte units 2 (u % 4), +1 of the chunk u / 4
        uint8_t* row = dst + (which ? L::kKHalf : 0) + (u / 4) * (kKeys * 128) + k * 128;
        const int u0 = 2 * (u % 4);
        *reinterpret_cast<uint4*>(row + ((u0 ^ (k & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(row + (((u0 + 1) ^ (k & 7)) << 4)) =
            make_uint4(o[4], o[5], o[6], o[7]);
      }
      if (MODE == kFp8Token) {
        const int page = pt[kb];
        for (int e = ct; e < 2 * kKeys; e += kConverters) {
          const size_t so = ((size_t)page * kKeys + (e % kKeys)) * Hkv + h;
          sc_s[slot * 2 * kKeys + e] = e < kKeys ? k_scale[so] : v_scale[so];
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(full + 8 * slot);
        mbar_arrive(rempty + 8 * rs);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  if constexpr (kMoveRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  if (wg >= n_mma) return;  // all 64 rows are padding
  const int wi = (threadIdx.x >> 5) & 3;
  const int quad = lane & 3;
  // this thread's two rows (h2 = 0, 1): their positions, or -1 for padding
  int tpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * h2;
    tpos[h2] = r < n_rows ? t0 + r % nt : -1;
  }
  // score factor with log2(e) folded in. The bf16 and static e4m3 modes
  // keep the scores (and the running max m) as the products give them and
  // take p = 2^(s kfac - m kfac) in one fma; the per-token mode scales each
  // score column first (by kfac and the key's scale), and so does ALiBi
  // (by kfac, then the bias), so their factor left is 1.
  constexpr bool kScaled = MODE == kFp8Token || ALIBI;
  const float kfac = (MODE == kFp8Head ? scale * k_scale[h] : scale) * kLog2e;
  const float sfac = kScaled ? 1.f : kfac;
  // each row's slope in log2 units (its query head's; 0 for padding)
  float slope2[2] = {0.f, 0.f};
  if (ALIBI) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * h2;
      if (tpos[h2] >= 0) slope2[h2] = alibi[h * G + r / nt] * kLog2e;
    }
  }
  const uint8_t* qm = qmask + (size_t)b * Q * Q;
  const int* kp = kpos != nullptr && !causal ? kpos + (size_t)b * Q : nullptr;  // the step's keys

  constexpr int kO = DV / 2;  // accumulator floats a thread
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns' share of each row's sum
  float s[32];              // the block's scores, then its probabilities
  uint32_t pa[16];          // the previous block's P: the A fragments of P V
  const uint32_t qa = smem_u32(q_s) + wg * 64 * 128;

  // S = Q K^T of the key block in ring slot i, issued (one commit group)
  auto issue_s = [&](int i) {
    const uint32_t ka = smem_u32(ring + (i % S) * L::kStage);
#pragma unroll
    for (int t = 0; t < DK / 16; ++t)
      wgmma_s(s, sw_desc<128>(qa + (t / 4) * (kRows * 128) + 32 * (t % 4)),
              sw_desc<128>(ka + (t / 4) * (kKeys * 128) + 32 * (t % 4)), t > 0);
    wgmma_commit();
  };
  // O += P V of the key block in ring slot i, P from pa, issued (one commit group)
  auto issue_pv = [&](int i) {
    const uint32_t va = smem_u32(ring + (i % S) * L::kStage + L::kKHalf);
#pragma unroll
    for (int t = 0; t < kKeys / 16; ++t) {
      const uint32_t a[4] = {pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3]};
      if constexpr (kWide) {  // two 128-column halves: boxes 0-1 and 2-3
        wgmma_pv(*reinterpret_cast<float(*)[64]>(&o[0]), a, v_desc(va + 16 * 128 * t));
        wgmma_pv(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                 v_desc(va + 2 * kKeys * 128 + 16 * 128 * t));
      } else {
        wgmma_pv(o, a, v_desc(va + 16 * 128 * t));
      }
    }
    wgmma_commit();
  };
  // the scores of key block kb (ring slot i) in s: masked, and the online
  // softmax; leaves the probabilities in s and each row's rescale factor
  auto softmax = [&](int kb, int i, float (&alpha)[2]) {
    const float* ks = sc_s + (i % S) * 2 * kKeys;
    // ALiBi: the step's keys' positions come from kpos in a block that holds
    // some of them (the others sit at their slots)
    const bool step_keys = ALIBI && kp != nullptr && (kb + 1) * kKeys > ctx;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int t = tpos[h2];
      // causal: the block's columns up to lim are visible, and those below
      // wlim (the prefix-LM window); the mask rule: the columns below pre
      // are committed keys, the next Q the step's
      const int lim = t < 0 ? -1 : ctx + t - kb * kKeys;
      const int wlim = win - kb * kKeys;
      const int pre = ctx - kb * kKeys;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * quad + c;
          bool vis;
          if (causal)
            vis = col <= lim || col < wlim;
          else
            vis = t >= 0 &&
                  (col < pre || (col - pre < Q && qm[(size_t)t * Q + col - pre] != 0));
          float v = s[4 * j + 2 * h2 + c];
          if (MODE == kFp8Token)
            v = v * kfac * ks[col];
          else if (ALIBI)
            v = v * kfac;
          if constexpr (ALIBI) {
            float pos = (float)(kb * kKeys + col);
            if (step_keys && col - pre >= 0 && col - pre < Q) pos = (float)kp[col - pre];
            v = fmaf(slope2[h2], pos, v);
          }
          v = vis ? v : kNegInf;
          s[4 * j + 2 * h2 + c] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      alpha[h2] = fast_exp2((m[h2] - m_new) * sfac);
      m[h2] = m_new;
      const float mk = -m_new * sfac;
      float p[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float v = s[4 * (i / 2) + 2 * h2 + i % 2];
        p[i] = v == kNegInf ? 0.f : fast_exp2(fmaf(v, sfac, mk));
      }
      // the thread's share of the row's sum, in a fixed tree
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = p[2 * j] + p[2 * j + 1];
      const float psum = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
      l[h2] = l[h2] * alpha[h2] + psum;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s[4 * (i / 2) + 2 * h2 + i % 2] =
            MODE == kFp8Token ? p[i] * ks[kKeys + 8 * (i / 2) + 2 * quad + i % 2] : p[i];
    }
  };
  // DV = 256: softmax's arithmetic, element for element and in the same
  // order, with a column's two rows side by side and the probabilities in
  // place of the scores, so that neither a probability array nor a block's
  // key scales and positions stay live beside O's 128 registers
  auto softmax_wide = [&](int kb, int i, float (&alpha)[2]) {
    const float* ks = sc_s + (i % S) * 2 * kKeys;
    const bool step_keys = ALIBI && kp != nullptr && (kb + 1) * kKeys > ctx;
    const int pre = ctx - kb * kKeys, wlim = win - kb * kKeys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * quad + c;
        float pos = 0.f;
        if constexpr (ALIBI) {
          pos = (float)(kb * kKeys + col);
          if (step_keys && col - pre >= 0 && col - pre < Q) pos = (float)kp[col - pre];
        }
        const float kscale = MODE == kFp8Token ? ks[col] : 1.f;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int t = tpos[h2];
          const int lim = t < 0 ? -1 : ctx + t - kb * kKeys;
          bool vis;
          if (causal)
            vis = col <= lim || col < wlim;
          else
            vis = t >= 0 &&
                  (col < pre || (col - pre < Q && qm[(size_t)t * Q + col - pre] != 0));
          float v = s[4 * j + 2 * h2 + c];
          if (MODE == kFp8Token)
            v = v * kfac * kscale;
          else if (ALIBI)
            v = v * kfac;
          if constexpr (ALIBI) v = fmaf(slope2[h2], pos, v);
          v = vis ? v : kNegInf;
          s[4 * j + 2 * h2 + c] = v;
          mx[h2] = fmaxf(mx[h2], v);
        }
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mr = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      const float m_new = fmaxf(m[h2], mr);
      alpha[h2] = fast_exp2((m[h2] - m_new) * sfac);
      m[h2] = m_new;
      const float mk = -m_new * sfac;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float& v = s[4 * (e / 2) + 2 * h2 + e % 2];
        v = v == kNegInf ? 0.f : fast_exp2(fmaf(v, sfac, mk));
      }
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = s[4 * j + 2 * h2] + s[4 * j + 2 * h2 + 1];
      const float psum = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
      l[h2] = l[h2] * alpha[h2] + psum;
    }
    if (MODE == kFp8Token) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float vscale = ks[kKeys + 8 * j + 2 * quad + c];
          s[4 * j + c] *= vscale;
          s[4 * j + 2 + c] *= vscale;
        }
    }
  };
  // O rescaled by alpha, and this block's P into the A fragments
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        o[4 * j + 2 * h2] *= alpha[h2];
        o[4 * j + 2 * h2 + 1] *= alpha[h2];
      }
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
  };

  // Block kb's scores are issued with block kb - 1's P V behind them: the
  // softmax of kb runs while the tensor cores finish P V of kb - 1.
  // (With a page range no block may be walked: the row keeps O = 0, l = 0.)
  float alpha[2];
  int kb = next_block(-1);
  if constexpr (kWide) {
    // DV = 256: each block's S, softmax and P V in turn (O after block i is
    // O * alpha_i + P_i V_i, as in the pipelined walk below)
#pragma unroll 1
    for (int i = 0; kb < n_blocks; kb = next_block(kb), ++i) {
      mbar_wait(full + 8 * (i % S), (i / S) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_s(i);
      wgmma_wait0();
      fence_regs(s);
      softmax_wide(kb, i, alpha);
      rescale_and_pack(alpha);
      fence_regs(o);
      wgmma_fence();
      issue_pv(i);
      wgmma_wait0();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + 8 * (i % S));
    }
  } else if (kb < n_blocks) {
    mbar_wait(full, 0);
    fence_regs(s);
    wgmma_fence();
    issue_s(0);
    wgmma_wait0();
    fence_regs(s);
    softmax(kb, 0, alpha);
    rescale_and_pack(alpha);
    int i = 1;
#pragma unroll 1
    for (kb = next_block(kb); kb < n_blocks; kb = next_block(kb), ++i) {
      mbar_wait(full + 8 * (i % S), (i / S) & 1);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      issue_s(i);
      issue_pv(i - 1);
      // block i's scores are done (in the per-token mode, whose scale
      // columns need the registers, block i - 1's P V too)
      if (MODE == kFp8Token)
        wgmma_wait0();
      else
        wgmma_wait1();
      fence_regs(s);
      softmax(kb, i, alpha);
      wgmma_wait0();  // block i - 1's P V is done
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % S));  // this warp is done with it
      rescale_and_pack(alpha);
    }
    fence_regs(o);
    wgmma_fence();
    issue_pv(i - 1);
    wgmma_wait0();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % S));
  }

  // the epilogue: O / l (times the static V scale), bf16
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int t = tpos[h2];
    if (t < 0) continue;
    const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * h2;
    const int qh = h * G + r / nt;
    float inv = 1.f / (lt > 0.f ? lt : 1.f);
    if (MODE == kFp8Head) inv *= v_scale[h];
    // the row's log-sum-exp of its scaled scores (natural log; -inf for a
    // row that saw no key): m is in the scores' units, sfac takes them to
    // log2 units, as the probabilities are 2^(s sfac - m sfac)
    if (lse != nullptr && quad == 0)
      lse[((size_t)b * Q + t) * Hq + qh] =
          lt > 0.f ? (m[h2] * sfac + log2f(lt)) * kLn2 : __int_as_float(0xff800000);
    __nv_bfloat16* dst = out + (((size_t)b * Q + t) * Hq + qh) * dv;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      if (8 * j < dv)  // the head's own lanes
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * quad) =
            pack_bf16x2(o[4 * j + 2 * h2] * inv, o[4 * j + 2 * h2 + 1] * inv);
  }
}

template <int DK, int DV, int MODE, bool ALIBI, bool RANGED>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* page_tables, const int* ctx_lens, const uint8_t* qmask,
                   const float* k_scale, const float* v_scale, const float* alibi,
                   const int* kpos, const int* window, void* out,
                   int B, int Q, int Hq, int Hkv, int dk, int dv, int n_pages, int P, int QT,
                   float scale, int causal, int page_lo, int page_hi, float* lse,
                   cudaStream_t st) {
  using L = Smem<DK, DV, MODE>;
  static bool done[64] = {};
  cudaError_t err =
      allow_smem(paged_attention_wgmma_kernel<DK, DV, MODE, ALIBI, RANGED>, L::kBytes, done);
  if (err != cudaSuccess) return err;
  // the heads' own widths: at most the build's, whole 16-byte q units
  if (dk < 1 || dk > DK || dv < 1 || dv > DV || dk % 8 || dv % 8) return cudaErrorInvalidValue;
  CUtensorMap km, vm;
  const uint64_t rows = (uint64_t)n_pages * kKeys;
  const uint64_t kcols = (uint64_t)Hkv * dk, vcols = (uint64_t)Hkv * dv;
  const bool ok =
      MODE == kBf16
          ? make_map(&km, k_pages, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, kcols, 64, kKeys,
                     CU_TENSOR_MAP_SWIZZLE_128B) &&
                make_map(&vm, v_pages, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, vcols, 64,
                         kKeys, CU_TENSOR_MAP_SWIZZLE_128B)
          : make_map(&km, k_pages, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, kcols, DK, kKeys,
                     CU_TENSOR_MAP_SWIZZLE_NONE) &&
                make_map(&vm, v_pages, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, vcols, DV, kKeys,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  if (QT < 1 || (Hq / Hkv) * QT > kRows) return cudaErrorInvalidValue;
  const int n_tiles = (Q + QT - 1) / QT;
  dim3 grid(Hkv, B, n_tiles);
  paged_attention_wgmma_kernel<DK, DV, MODE, ALIBI, RANGED><<<grid, kThreads, L::kBytes, st>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), page_tables, ctx_lens, qmask, k_scale,
      v_scale, alibi, kpos, window, static_cast<__nv_bfloat16*>(out), Q, Hq, Hkv, dk, dv, P,
      QT, n_tiles, scale, causal, page_lo, page_hi, lse);
  return cudaSuccess;
}

// The arguments every instantiation takes, after its template flags.
#define PA_ARGS                                                                            \
  q, k_pages, v_pages, pt, cl, qm, ksc, vsc, alibi, kpos, window, out, B, Q, Hq, Hkv, dk, \
      dv, n_pages, P, QT, scale, causal, lo, hi, lse, st
#define PA_PARAMS                                                                          \
  const void *q, const void *k_pages, const void *v_pages, const int *pt, const int *cl,   \
      const uint8_t *qm, const float *ksc, const float *vsc, const float *alibi,           \
      const int *kpos, const int *window, void *out, int B, int Q, int Hq, int Hkv,        \
      int dk, int dv, int n_pages, int P, int QT, float scale, int causal, int lo, int hi, \
      float *lse, cudaStream_t st

template <int DK, int DV, bool ALIBI>
cudaError_t launch_mode(int mode, PA_PARAMS) {
  if (mode == kBf16) return launch<DK, DV, kBf16, ALIBI, false>(PA_ARGS);
  if (mode == kFp8Head) return launch<DK, DV, kFp8Head, ALIBI, false>(PA_ARGS);
  if (mode == kFp8Token) return launch<DK, DV, kFp8Token, ALIBI, false>(PA_ARGS);
  return cudaErrorInvalidValue;
}

template <int DK, int DV>
cudaError_t launch_alibi(int mode, PA_PARAMS) {
  if (lo != 0 || hi != INT_MAX) {  // a page range: the bf16 arena, no ALiBi
    if (mode != kBf16 || alibi != nullptr) return cudaErrorInvalidValue;
    return launch<DK, DV, kBf16, false, true>(PA_ARGS);
  }
  if (alibi != nullptr) return launch_mode<DK, DV, true>(mode, PA_ARGS);
  return launch_mode<DK, DV, false>(mode, PA_ARGS);
}

template <int DK, int DV>
int smem_bytes(int mode) {
  return mode == kBf16 ? Smem<DK, DV, kBf16>::kBytes
         : mode == kFp8Head ? Smem<DK, DV, kFp8Head>::kBytes
         : mode == kFp8Token ? Smem<DK, DV, kFp8Token>::kBytes : -1;
}

// Each source defines these over its pairs (dk, dv in PA_PARAMS: the heads'
// own widths, which pick the build).
cudaError_t pa_dispatch(int mode, PA_PARAMS);
int pa_smem_bytes(int DK, int DV, int mode);

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block, for the build report; -1 for a
// configuration that does not exist (or that another source builds).
extern "C" int paged_attention_smem_bytes(int DK, int DV, int mode) {
  return pa_smem_bytes(DK, DV, mode);
}

// q bf16 [B, Q, Hq, DK]; k_pages [n_pages, 64, Hkv*DK], v_pages [n_pages, 64,
// Hkv*DV] (one layer), bf16 (mode 0) or e4m3 (modes 1, 2); page_tables int32
// [B, P]; ctx_lens int32 [B]; qmask uint8 [B, Q, Q] (ignored when causal);
// k_scale/v_scale f32 [Hkv] (mode 1) or [n_pages, 64, Hkv] (mode 2), null in
// mode 0; alibi f32 [Hq] slopes, or null for none; alibi_pos int32 [B, Q] the
// positions of the step's own keys, or null for their slots (read only with
// alibi); window int32 [B] the prefix-LM window of the causal rule, or null;
// out bf16 [B, Q, Hq, DV]; positions: the query positions of a tile
// (128 / G rounded down);
// page_lo / page_hi: walk only the key blocks whose page id lies in
// [page_lo, page_hi) (0 / INT_MAX: all of them; a range takes the bf16 arena
// without ALiBi, in the RANGED instantiation); lse f32 [B, Q, Hq], the rows'
// log-sum-exp, or null. The wrapper's plan (ops/paged_attention.py
// attention_check, attention_plan) gives positions = 128 // (Hq / Hkv),
// 1 <= Hq / Hkv <= 128, and requires (DK, DV) in {(64, 64), (80, 80),
// (96, 96), (128, 128)} (paged_attention.cu) or {(256, 256), (192, 128)}
// (paged_attention_wide.cu), page size 64, B <= 65535 and 16-byte aligned
// operands.
extern "C" int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                               const void* page_tables, const void* ctx_lens,
                               const void* qmask, const void* k_scale, const void* v_scale,
                               const void* alibi_slopes, const void* alibi_pos,
                               const void* prefix_window, void* out, int B, int Q, int Hq,
                               int Hkv, int DK, int DV, int n_pages, int P, int positions,
                               float scale, int causal, int mode, int lo, int hi,
                               void* lse_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const uint8_t* qm = static_cast<const uint8_t*>(qmask);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const float* alibi = static_cast<const float*>(alibi_slopes);
  const int* kpos = static_cast<const int*>(alibi_pos);
  const int* window = static_cast<const int*>(prefix_window);
  float* lse = static_cast<float*>(lse_out);
  const int QT = positions;
  const int dk = DK, dv = DV;
  const cudaError_t err = pa_dispatch(mode, PA_ARGS);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
