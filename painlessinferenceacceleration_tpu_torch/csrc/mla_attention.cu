// Multi-head Latent Attention over the fused [latent | roped k_pe] page
// arena, for Hopper (sm_90a) on the tensor cores (wgmma): decode, tree
// verify and causal prefill in one body.
//
// Replaces the Pallas body _mla_kernel of
// painlessinferenceacceleration_tpu/ops/mla_attention.py. MLA in latent mode
// is MQA: every query row (request b, in-step position t, head h; row
// r = t * H + h) attends the same single-"head" K rows of 576 lanes, and the
// value of a key is the first 512 lanes of its K row (the latent), so only
// the K arena is read:
//
//   out[b, r] = sum_j p_j * K[j, :512] / sum_j p_j,  p_j = exp(s_j - m),
//   s_j = scale * q[b, r] . K[j]   over the visible keys j:
//     j < ctx, or s = j - ctx in [0, Q) and qmask[b, t, s] (causal: s <= t;
//     Q = 1: j <= ctx).
//
// The scale multiplies the fp32 scores (the Pallas wrapper rounds q * scale
// to bf16 first; the port's kernel and plain version both scale the fp32
// scores). A row with no visible key gives zeros.
//
// What bounds it on the H100: at decode and verify the K bytes, (ctx + Q) *
// 576 * 2 B per request and layer; at prefill the two products, 2 * (576 +
// 512) FLOP per visible (row, key) pair at 989 TFLOP/s. The design:
// - A tile is 64 query rows of one request (r0 .. r0 + 63, padding past
//   Q * H). Two consumer warpgroups each own 256 of the 512 lanes of O
//   (wgmma m64n256k16, V the K stage's first 512 lanes read MN-major
//   through the transpose bit; O is 128 registers a thread). Warpgroup 0
//   computes S = Q K^T (m64n64k16, Q and K K-major from shared memory, 36
//   steps over 576 lanes) and the softmax, keeps P in registers as the A
//   operand of its P V, and hands P (bf16, in the 128-byte swizzle) and
//   the rows' rescale factors to warpgroup 1 through shared memory, whose
//   P V reads P from there (named barriers: P is there; P has been read).
//   A third warpgroup's first thread is the producer; setmaxnreg gives the
//   consumers 240 registers and the producer 24.
// - Keys are walked in blocks of one 64-key page from key 0: the producer
//   reads each page id from page_tables and TMA lands the page's 576-lane
//   rows (nine 64-lane boxes) in the 128-byte swizzle, into a ring of two
//   72 KB stages beside the tile's 72 KB of Q, released by mbarriers once
//   both warpgroups' P V of the block is done. Warpgroup 0 issues a
//   block's S behind the previous block's P V, so its stage is released
//   early.
// - The context is cut into chunks of C keys at absolute positions (chunk c
//   holds keys [cC, (c + 1)C)). A chunk's partial (m, l, unnormalised O) is
//   the online softmax over its key blocks from (-1e30, 0, 0), and a row's
//   result is always the fold of its chunks' partials in ascending c
//   (fold_coeffs / fold_val), divided at the end (final_inv / final_val).
//   Decode and verify run one block a (chunk, request, tile): a block past
//   its tile's last key exits; where the tile sees one chunk the block
//   writes the output, else its partial goes to a workspace and
//   mla_combine_kernel folds them. Prefill runs one block a tile (heaviest
//   first) that walks every chunk and folds at each chunk edge into its own
//   rows of a global fp32 scratch (the running M and L stay in registers).
// - A row's bits depend only on the keys it sees: every row runs the same
//   key blocks from key 0 in the same chunks, the same instructions on its
//   own row of Q, the same fixed-order reductions (each lane of O always in
//   the same warpgroup's form); a key block with no
//   visible key leaves its m, l and O unchanged (alpha is exactly 1, P
//   exactly 0), a chunk with none leaves the fold unchanged, and the fold of
//   one chunk is that chunk's partial bit for bit. The fold and the final
//   division use explicit round-to-nearest intrinsics (no contraction that
//   could differ between the two kernels). So a row is the same at every Q,
//   B and H, in every route, and at every place in the tile.
//
// Context parallelism (template RANGED): a rank walks only the key blocks
// whose page id lies in its [page_lo, page_hi); a skipped block is neither
// loaded nor multiplied. The chunks stay the absolute ones and the walked
// blocks keep their order inside them, so the full range gives the bits of
// the call without one. A chunk with no block in the range is the partial
// (-1e30, 0, 0), which every fold leaves out exactly (its O is not written:
// the ranged combine reads no O of a chunk whose sum is 0). Every route can
// also write each row's log-sum-exp of its scaled scores (lse, natural log,
// from the same (M, L) the division uses; -inf for a row that saw no key,
// whose output is 0), which ops/cp_attention.py merges across the ranks.

#include <climits>

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

namespace {

using namespace piawg;

constexpr int kRows = 64;            // query rows of a tile
constexpr int kKeys = 64;            // keys of a block: one page
constexpr int kDk = 576;             // a K row: latent + rope lanes
constexpr int kDv = 512;             // V: a K row's first lanes
constexpr int kBoxes = kDk / 64;     // 64-lane boxes of a row
constexpr int kBox = kKeys * 128;    // one box of 64 rows: 8192 bytes
constexpr int kTileBytes = kBoxes * kBox;  // the Q tile, or one key stage
constexpr int kStages = 2;
constexpr int kThreads = 384;        // two consumer warpgroups, then the loader's
constexpr int kConsumers = 256;
constexpr int kPBytes = kRows * kKeys * 2;  // a block's P in bf16
constexpr int kSmemBytes = 1024 + (1 + kStages) * kTileBytes + kPBytes + kRows * 12 + 64;
static_assert(kSmemBytes <= kSmemLimit, "the tile and its ring fit a block");
constexpr float kNegInf = -1e30f;

// 2^x in one instruction (results below 2^-126 flush to zero; 2^0 is 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The fold of a chunk's partial (mc, lc, oc) into the running (M, L, A):
// M' = max(M, mc), A' = A 2^((M - M') f) + oc 2^((mc - M') f), L' likewise.
// From (-1e30, 0, 0) it gives the partial back exactly (a = 0, b = 1); a
// chunk with no visible key (mc = -1e30, lc = oc = 0) leaves the state
// exactly (a = 1, b = 0).
__device__ __forceinline__ void fold_coeffs(float M, float mc, float sfac, float& Mn,
                                            float& a, float& b) {
  Mn = fmaxf(M, mc);
  a = fast_exp2(__fmul_rn(__fsub_rn(M, Mn), sfac));
  b = fast_exp2(__fmul_rn(__fsub_rn(mc, Mn), sfac));
}
__device__ __forceinline__ float fold_val(float A, float a, float oc, float b) {
  return __fmaf_rn(oc, b, __fmul_rn(A, a));
}
// the final division: out = A / L (0 where no key is visible)
__device__ __forceinline__ float final_inv(float L) {
  return __fdiv_rn(1.f, L > 0.f ? L : 1.f);
}
__device__ __forceinline__ float final_val(float A, float inv) { return __fmul_rn(A, inv); }

// A row's log-sum-exp of its scaled scores from its max M (score units) and
// sum L (of 2^((s - M) sfac)): natural log, -inf where no key was seen.
__device__ __forceinline__ float row_lse(float M, float L, float sfac) {
  return L > 0.f ? (M * sfac + log2f(L)) * 0.69314718055994531f : __int_as_float(0xff800000);
}

// The last key a tile's rows can see, within the page table's window.
__device__ __forceinline__ int tile_last_key(int ctx, int Q, int H, int r0, int nr, int P,
                                             int causal) {
  const int last = causal ? ctx + (r0 + nr - 1) / H : ctx + Q - 1;
  return min(last, P * kKeys - 1);
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

// o[64 x 256] += P[64 x 16] * V[16 x 256]: P from registers (the A
// fragment: a[i] holds row +8 (i % 2), columns +8 (i / 2) + 2 (t%4) (+1)),
// V MN-major in shared memory (the transpose bit): four 64-lane boxes, the
// descriptor's leading offset apart.
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// o[64 x 256] += P[64 x 16] * V[16 x 256]: P K-major in shared memory (the
// 128-byte swizzle), V as in the register form.
__device__ __forceinline__ void wgmma_pv_ss(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Descriptor of the MN-major V operand in the 128-byte swizzle: rows of 64
// lanes (128 bytes) a key, 8 keys an atom (1024 bytes); the leading offset
// is the next 64-lane box, the stride offset the next 8 keys.
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kBox >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// One block: the chunks [c_begin, c_end) of one (request, tile); every chunk
// of the tile when `walk`, else chunk blockIdx.x. RANGED: only the key
// blocks whose page lies in [page_lo, page_hi).
template <bool RANGED>
__global__ void __launch_bounds__(kThreads, 1) mla_attention_kernel(
    const __grid_constant__ CUtensorMap km, const __nv_bfloat16* __restrict__ q,
    const int* __restrict__ page_tables, const int* __restrict__ ctx_lens,
    const uint8_t* __restrict__ qmask, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws_o, float2* __restrict__ ws_ml, float* __restrict__ scratch,
    float* __restrict__ lse, int Q, int H, int P, int n_tiles, int n_chunks,
    int chunk_blocks, float sfac, int causal, int walk, int page_lo, int page_hi) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  uint8_t* q_s = base;                      // [9 boxes][64 rows][128 B]
  uint8_t* ring = q_s + kTileBytes;         // [kStages][9 boxes][64 keys][128 B]
  uint8_t* p_s = ring + kStages * kTileBytes;  // a block's P: [64 rows][128 B], swizzled
  float* a_s = reinterpret_cast<float*>(p_s + kPBytes);  // its rows' rescale factors
  float2* ml_s = reinterpret_cast<float2*>(a_s + kRows);  // a chunk's (m, l) a row
  const uint32_t bars = smem_u32(ml_s + kRows);
  const uint32_t full = bars, empty = bars + 8 * kStages;

  const int R = Q * H;
  const int b = blockIdx.y;
  // heaviest first: under the causal rule the last tile walks the most keys
  const int tile = causal ? n_tiles - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int r0 = tile * kRows;
  const int nr = min(kRows, R - r0);
  const int ctx = ctx_lens[b];
  const int last = tile_last_key(ctx, Q, H, r0, nr, P, causal);
  const int n_blocks = last / kKeys + 1;
  const int nct = last / (chunk_blocks * kKeys) + 1;  // the chunks the tile sees
  const int c_begin = walk ? 0 : (int)blockIdx.x;
  const int c_end = walk ? nct : c_begin + 1;
  if (c_begin >= nct) return;  // a chunk past the tile's last key
  const int* pt = page_tables + (size_t)b * P;
  // whether key block kb is walked (every block without a range)
  auto walked = [&](int kb) {
    if constexpr (RANGED)
      return (unsigned)(pt[kb] - page_lo) < (unsigned)(page_hi - page_lo);
    else
      return true;
  };
  // the blocks of chunk c walked
  auto chunk_count = [&](int c) {
    const int kb_end = min((c + 1) * chunk_blocks, n_blocks);
    if constexpr (RANGED) {
      int n = 0;
      for (int kb = c * chunk_blocks; kb < kb_end; ++kb) n += walked(kb);
      return n;
    } else {
      return kb_end - c * chunk_blocks;
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init_count(full + 8 * i, 1);
      mbar_init_count(empty + 8 * i, kConsumers / 32);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- the loader warpgroup: its first thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != kConsumers) return;
    int g = 0;
    for (int c = c_begin; c < c_end; ++c) {
      const int kb_end = min((c + 1) * chunk_blocks, n_blocks);
      for (int kb = c * chunk_blocks; kb < kb_end; ++kb) {
        if (!walked(kb)) continue;
        const int slot = g % kStages;
        if (g >= kStages) mbar_wait(empty + 8 * slot, ((g / kStages) + 1) & 1);
        const int row = pt[kb] * kKeys;
        uint8_t* dst = ring + slot * kTileBytes;
        mbar_expect(full + 8 * slot, kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(smem_u32(dst + x * kBox), &km, 64 * x, row, full + 8 * slot);
        ++g;
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  {  // the tile's q rows, zeros past nr, in the swizzle wgmma reads
    constexpr int kUnits = kDk / 8;  // 16-byte units of a row
    const __nv_bfloat16* qt = q + ((size_t)b * R + r0) * kDk;
    for (int e = threadIdx.x; e < kRows * kUnits; e += kConsumers) {
      const int r = e / kUnits, u = e % kUnits;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < nr) v = *reinterpret_cast<const uint4*>(qt + (size_t)r * kDk + 8 * u);
      *reinterpret_cast<uint4*>(q_s + (u / 8) * kBox + r * 128 + (((u % 8) ^ (r & 7)) << 4)) =
          v;
    }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }
  const int lane = threadIdx.x & 31;
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int wi = (threadIdx.x >> 5) & 3;
  const int quad = lane & 3;
  // this thread's two rows (h2 = 0, 1) of the tile: their positions, or -1
  // for padding (both warpgroups hold the same rows of their lanes)
  int rr[2], tpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    rr[h2] = 16 * wi + (lane >> 2) + 8 * h2;
    tpos[h2] = rr[h2] < nr ? (r0 + rr[h2]) / H : -1;
  }
  const uint8_t* qm = qmask == nullptr ? nullptr : qmask + (size_t)b * Q * Q;
  const uint32_t qa = smem_u32(q_s);
  const uint32_t pa_s = smem_u32(p_s);

  float o[128];  // this warpgroup's 256 lanes of O
  float M[2] = {kNegInf, kNegInf}, L[2] = {0.f, 0.f};  // the walk's fold
  // Warpgroup 0 computes S and the softmax and hands each block's P and
  // rescale factors to warpgroup 1 in shared memory: named barrier 2 says
  // they are there, 3 that warpgroup 1's P V has read them. Warpgroup 1
  // frees the buffer after each block but the last one this block walks.
  int total = 0;  // the key blocks this block walks
  for (int c = c_begin; c < c_end; ++c) total += chunk_count(c);

  // S = Q K^T of ring entry g, issued (one commit group)
  auto issue_s = [&](float (&s)[32], int g) {
    const uint32_t ka = smem_u32(ring + (g % kStages) * kTileBytes);
#pragma unroll
    for (int t = 0; t < kDk / 16; ++t)
      wgmma_s(s, sw_desc<128>(qa + (t / 4) * kBox + 32 * (t % 4)),
              sw_desc<128>(ka + (t / 4) * kBox + 32 * (t % 4)), t > 0);
    wgmma_commit();
  };
  // O += P V of ring entry g over this warpgroup's four 64-lane boxes; P
  // from registers (warpgroup 0) or from shared memory (warpgroup 1)
  auto issue_pv = [&](const uint32_t (&pa)[16], int g) {
    const uint32_t va = smem_u32(ring + (g % kStages) * kTileBytes) + wg * 4 * kBox;
#pragma unroll
    for (int t = 0; t < kKeys / 16; ++t) {
      const uint32_t a[4] = {pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3]};
      wgmma_pv(o, a, v_desc(va + 16 * 128 * t));
    }
    wgmma_commit();
  };
  auto issue_pv_ss = [&](int g) {
    const uint32_t va = smem_u32(ring + (g % kStages) * kTileBytes) + 4 * kBox;
#pragma unroll
    for (int t = 0; t < kKeys / 16; ++t)
      wgmma_pv_ss(o, sw_desc<128>(pa_s + 32 * t), v_desc(va + 16 * 128 * t));
    wgmma_commit();
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        o[4 * j + 2 * h2] = __fmul_rn(o[4 * j + 2 * h2], alpha[h2]);
        o[4 * j + 2 * h2 + 1] = __fmul_rn(o[4 * j + 2 * h2 + 1], alpha[h2]);
      }
  };

  int g = 0;  // ring entries consumed
  for (int c = c_begin; c < c_end; ++c) {
    const int kb0 = c * chunk_blocks;
    const int nb = chunk_count(c);  // 0 only under a range
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    // the chunk's partial: each row's max and whole sum ((-1e30, 0) for a
    // chunk with no block walked)
    float mc[2] = {kNegInf, kNegInf}, lc[2] = {0.f, 0.f};
    if (wg == 0) {
      float s[32];      // the block's scores, then its probabilities
      uint32_t pa[16];  // the previous block's P: the A fragments of P V
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      // the scores of key block kb in s: masked, and the online softmax;
      // leaves the probabilities in s and each row's rescale factor
      auto softmax = [&](int kb, float (&alpha)[2]) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int t = tpos[h2];
          // causal: the block's columns up to lim are visible; the mask
          // rule: the columns below pre are committed keys, the next Q the
          // step's
          const int lim = t < 0 ? -1 : ctx + t - kb * kKeys;
          const int pre = ctx - kb * kKeys;
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int col = 8 * j + 2 * quad + cc;
              bool vis;
              if (causal)
                vis = col <= lim;
              else
                vis = t >= 0 && (col < pre ||
                                 (col - pre < Q &&
                                  (qm == nullptr || qm[(size_t)t * Q + col - pre])));
              const float v = vis ? s[4 * j + 2 * h2 + cc] : kNegInf;
              s[4 * j + 2 * h2 + cc] = v;
              mx = fmaxf(mx, v);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[h2], mx);
          alpha[h2] = fast_exp2(__fmul_rn(__fsub_rn(m[h2], m_new), sfac));
          m[h2] = m_new;
          const float mk = __fmul_rn(-m_new, sfac);
          float p[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float v = s[4 * (i / 2) + 2 * h2 + i % 2];
            p[i] = v == kNegInf ? 0.f : fast_exp2(__fmaf_rn(v, sfac, mk));
          }
          // the thread's share of the row's sum, in a fixed tree
          float a[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] = __fadd_rn(p[2 * j], p[2 * j + 1]);
          const float psum =
              __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                        __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
          l[h2] = __fmaf_rn(l[h2], alpha[h2], psum);
#pragma unroll
          for (int i = 0; i < 16; ++i) s[4 * (i / 2) + 2 * h2 + i % 2] = p[i];
        }
      };
      // Block i's scores are issued behind block i - 1's P V, whose stage
      // is released as soon as that product is done.
      int kb = kb0;  // the key block of step i
#pragma unroll 1
      for (int i = 0; i < nb; ++i, ++kb) {
        if constexpr (RANGED) {
          while (!walked(kb)) ++kb;
        }
        const int gi = g + i;
        mbar_wait(full + 8 * (gi % kStages), (gi / kStages) & 1);
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();
        if (i > 0) issue_pv(pa, gi - 1);
        issue_s(s, gi);
        if (i > 0) {
          wgmma_wait1();  // block i - 1's P V is done
          if (lane == 0) mbar_arrive(empty + 8 * ((gi - 1) % kStages));
        }
        wgmma_wait0();
        fence_regs(s);
        fence_regs(o);
        float alpha[2];
        softmax(kb, alpha);
        rescale(alpha);
#pragma unroll
        for (int k = 0; k < 16; ++k) pa[k] = pack_bf16x2(s[2 * k], s[2 * k + 1]);
        if (i == nb - 1) {  // the chunk's partial: each row's max and whole sum
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float lt = l[h2];
            lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
            lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
            lc[h2] = lt;
            mc[h2] = m[h2];
          }
        }
        // hand block i's P and rescale factors (and at the chunk's last
        // block its partial's max and sum) to warpgroup 1
        if (gi > 0) asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            *reinterpret_cast<uint32_t*>(p_s + rr[h2] * 128 + ((j ^ (rr[h2] & 7)) << 4) +
                                         4 * quad) = pa[2 * j + h2];
        if (quad == 0) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            a_s[rr[h2]] = alpha[h2];
            if (i == nb - 1) ml_s[rr[h2]] = make_float2(mc[h2], lc[h2]);
          }
        }
        fence_async_smem();  // P, for warpgroup 1's wgmma
        __threadfence_block();
        asm volatile("bar.arrive 2, %0;\n" ::"n"(kConsumers) : "memory");
      }
      if (nb > 0) {
        fence_regs(o);
        wgmma_fence();
        issue_pv(pa, g + nb - 1);
        wgmma_wait0();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty + 8 * ((g + nb - 1) % kStages));
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < nb; ++i) {
        const int gi = g + i;
        mbar_wait(full + 8 * (gi % kStages), (gi / kStages) & 1);
        asm volatile("bar.sync 2, %0;\n" ::"n"(kConsumers) : "memory");
        const float alpha[2] = {a_s[rr[0]], a_s[rr[1]]};
        if (i == nb - 1) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 v = ml_s[rr[h2]];
            mc[h2] = v.x;
            lc[h2] = v.y;
          }
        }
        rescale(alpha);
        fence_regs(o);
        wgmma_fence();
        issue_pv_ss(gi);
        wgmma_wait0();
        fence_regs(o);
        if (gi + 1 < total) asm volatile("bar.arrive 3, %0;\n" ::"n"(kConsumers) : "memory");
        if (lane == 0) mbar_arrive(empty + 8 * (gi % kStages));
      }
    }
    g += nb;
    if (nct == 1) {  // the tile sees one chunk: its partial is the result
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        if (rr[h2] >= nr) continue;
        const float inv = final_inv(lc[h2]);
        if (lse != nullptr && wg == 0 && quad == 0)
          lse[(size_t)b * R + r0 + rr[h2]] = row_lse(mc[h2], lc[h2], sfac);
        __nv_bfloat16* dst = out + ((size_t)b * R + r0 + rr[h2]) * kDv + 256 * wg + 2 * quad;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16x2(final_val(o[4 * j + 2 * h2], inv), final_val(o[4 * j + 2 * h2 + 1], inv));
      }
    } else if (!walk) {  // the partial, for mla_combine_kernel
      const size_t e = ((size_t)b * n_tiles + tile) * n_chunks + c;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        if (rr[h2] >= nr) continue;
        if (RANGED && nb == 0) {  // the combine reads no O where the sum is 0
          if (wg == 0 && quad == 0) ws_ml[e * kRows + rr[h2]] = make_float2(kNegInf, 0.f);
          continue;
        }
        float* dst = ws_o + (e * kRows + rr[h2]) * kDv + 256 * wg + 2 * quad;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(o[4 * j + 2 * h2], o[4 * j + 2 * h2 + 1]);
        if (wg == 0 && quad == 0) ws_ml[e * kRows + rr[h2]] = make_float2(mc[h2], lc[h2]);
      }
    } else {  // the walk: fold into the running state at the chunk's edge
      float2* sc = reinterpret_cast<float2*>(scratch) +
                   ((size_t)b * n_tiles + tile) * (kRows * kDv / 2) + threadIdx.x;
      const bool fin = c == nct - 1;
      float fa[2], fb[2], inv[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float Mn;
        fold_coeffs(M[h2], mc[h2], sfac, Mn, fa[h2], fb[h2]);
        L[h2] = fold_val(L[h2], fa[h2], lc[h2], fb[h2]);
        M[h2] = Mn;
        inv[h2] = final_inv(L[h2]);
        if (fin && lse != nullptr && wg == 0 && quad == 0 && rr[h2] < nr)
          lse[(size_t)b * R + r0 + rr[h2]] = row_lse(M[h2], L[h2], sfac);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float2* cell = sc + (2 * j + h2) * kConsumers;  // this thread's own cells
          float2 A = c == 0 ? make_float2(0.f, 0.f) : *cell;
          A.x = fold_val(A.x, fa[h2], o[4 * j + 2 * h2], fb[h2]);
          A.y = fold_val(A.y, fa[h2], o[4 * j + 2 * h2 + 1], fb[h2]);
          if (!fin) {
            *cell = A;
          } else if (rr[h2] < nr) {
            __nv_bfloat16* dst =
                out + ((size_t)b * R + r0 + rr[h2]) * kDv + 256 * wg + 2 * quad + 8 * j;
            *reinterpret_cast<uint32_t*>(dst) =
                pack_bf16x2(final_val(A.x, inv[h2]), final_val(A.y, inv[h2]));
          }
        }
    }
  }
}

// The fold of a row's chunk partials in ascending chunk order, then the
// division: one block of 128 threads a (row, request), four lanes a thread.
// A row whose tile sees one chunk was written by that chunk's block.
// RANGED: a chunk whose sum is 0 (no block walked) adds nothing and its O,
// never written, is not read.
template <bool RANGED>
__global__ void __launch_bounds__(128) mla_combine_kernel(
    const float* __restrict__ ws_o, const float2* __restrict__ ws_ml,
    const int* __restrict__ ctx_lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Q, int H, int P, int n_tiles, int n_chunks,
    int chunk_blocks, float sfac, int causal) {
  const int r = blockIdx.x, b = blockIdx.y;
  const int R = Q * H;
  const int tile = r / kRows, rr = r % kRows, r0 = tile * kRows;
  const int nr = min(kRows, R - r0);
  const int last = tile_last_key(ctx_lens[b], Q, H, r0, nr, P, causal);
  const int nct = last / (chunk_blocks * kKeys) + 1;
  if (nct <= 1) return;
  const size_t e0 = ((size_t)b * n_tiles + tile) * n_chunks;
  float M = kNegInf, L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nct; ++c) {
    const size_t e = (e0 + c) * kRows + rr;
    const float2 ml = ws_ml[e];
    float Mn, fa, fb;
    fold_coeffs(M, ml.x, sfac, Mn, fa, fb);
    L = fold_val(L, fa, ml.y, fb);
    M = Mn;
    if (RANGED && ml.y == 0.f) continue;
    const float4 oc = reinterpret_cast<const float4*>(ws_o + e * kDv)[threadIdx.x];
    A.x = fold_val(A.x, fa, oc.x, fb);
    A.y = fold_val(A.y, fa, oc.y, fb);
    A.z = fold_val(A.z, fa, oc.z, fb);
    A.w = fold_val(A.w, fa, oc.w, fb);
  }
  const float inv = final_inv(L);
  if (lse != nullptr && threadIdx.x == 0) lse[(size_t)b * R + r] = row_lse(M, L, sfac);
  reinterpret_cast<uint2*>(out + ((size_t)b * R + r) * kDv)[threadIdx.x] =
      make_uint2(pack_bf16x2(final_val(A.x, inv), final_val(A.y, inv)),
                 pack_bf16x2(final_val(A.z, inv), final_val(A.w, inv)));
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block, for the build report.
extern "C" int mla_attention_smem_bytes() { return kSmemBytes; }

template <bool RANGED>
cudaError_t launch(const CUtensorMap& km, const void* q, const void* page_tables,
                   const void* ctx_lens, const void* qmask, void* out, void* ws_o, void* ws_ml,
                   void* scratch, void* lse, int B, int Q, int H, int P, int n_tiles,
                   int n_chunks, int chunk_blocks, float sfac, int causal, int walk,
                   int page_lo, int page_hi, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(mla_attention_kernel<RANGED>, kSmemBytes, done);
  if (err != cudaSuccess) return err;
  const int R = Q * H;
  dim3 grid(walk ? 1 : n_chunks, B, n_tiles);
  mla_attention_kernel<RANGED><<<grid, kThreads, kSmemBytes, st>>>(
      km, static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(page_tables),
      static_cast<const int*>(ctx_lens), static_cast<const uint8_t*>(qmask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_o),
      static_cast<float2*>(ws_ml), static_cast<float*>(scratch), static_cast<float*>(lse), Q,
      H, P, n_tiles, n_chunks, chunk_blocks, sfac, causal, walk, page_lo, page_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || walk || n_chunks == 1) return err;
  mla_combine_kernel<RANGED><<<dim3(R, B), 128, 0, st>>>(
      static_cast<const float*>(ws_o), static_cast<const float2*>(ws_ml),
      static_cast<const int*>(ctx_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Q, H, P, n_tiles, n_chunks, chunk_blocks, sfac, causal);
  return cudaGetLastError();
}

// q bf16 [B, Q, H, 576] (rows r = t * H + h contiguous); k_pages bf16
// [n_pages, 64, 576] (one layer, one shared head); page_tables int32 [B, P];
// ctx_lens int32 [B]; qmask uint8 [B, Q, Q], null when causal or Q = 1;
// out bf16 [B, Q, H, 512]. With n_tiles = ceil(Q H / 64) and n_chunks =
// ceil(P 64 / chunk_keys), when n_chunks > 1: the split route (walk = 0)
// takes the workspace ws_o f32 [B, n_tiles, n_chunks, 64, 512] and ws_ml
// f32 pairs [B, n_tiles, n_chunks, 64], the walk route scratch f32
// [B, n_tiles, 64 * 512]. sfac = scale * log2(e). page_lo / page_hi: walk
// only the key blocks whose page id lies in [page_lo, page_hi) (0 /
// INT_MAX: all of them); lse f32 [B, Q, H] (null: not written), the rows'
// log-sum-exp. The wrapper's plan (ops/mla_attention.py mla_check,
// mla_plan) gives these and requires 16-byte aligned operands and
// chunk_keys a multiple of 64.
extern "C" int mla_attention(const void* q, const void* k_pages, const void* page_tables,
                             const void* ctx_lens, const void* qmask, void* out, void* ws_o,
                             void* ws_ml, void* scratch, void* lse, int B, int Q, int H,
                             int n_pages, int P, int chunk_keys, float sfac, int causal,
                             int walk, int page_lo, int page_hi, void* stream) {
  if (B < 1 || B > 65535 || Q < 1 || H < 1 || P < 1 || chunk_keys < kKeys ||
      chunk_keys % kKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (Q * H + kRows - 1) / kRows;
  const int chunk_blocks = chunk_keys / kKeys;
  const int n_chunks = (P + chunk_blocks - 1) / chunk_blocks;
  if (n_tiles > 65535 ||
      (n_chunks > 1 && (walk ? scratch == nullptr : ws_o == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap km;
  if (!make_map(&km, k_pages, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (uint64_t)n_pages * kKeys,
                kDk, 64, kKeys, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_lo != 0 || page_hi != INT_MAX)
    return static_cast<int>(launch<true>(km, q, page_tables, ctx_lens, qmask, out, ws_o,
                                         ws_ml, scratch, lse, B, Q, H, P, n_tiles, n_chunks,
                                         chunk_blocks, sfac, causal, walk, page_lo, page_hi,
                                         st));
  return static_cast<int>(launch<false>(km, q, page_tables, ctx_lens, qmask, out, ws_o, ws_ml,
                                        scratch, lse, B, Q, H, P, n_tiles, n_chunks,
                                        chunk_blocks, sfac, causal, walk, 0, INT_MAX, st));
}
