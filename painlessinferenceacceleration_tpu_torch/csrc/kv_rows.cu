// KV row write and KV row move for Hopper (sm_90a).
//
// K16 has two entries over the same job, the row write that ends
// write_kv_pages (engine/cache.py): every layer of every forward writes its
// new K/V rows through it. Both replace the Pallas body _write_kernel
// (kv_write_rows) of painlessinferenceacceleration_tpu/ops/kv_update.py.
//
// kv_write_step, the entry on every path: one launch a write_kv_pages call,
// for K and V (and in fp8_tok mode their per-token scale arenas), with the
// step's own tensors as the models pass them: new_k [B, Q, H, D] and new_v
// [B, Q, H, Dv] (strided views whose last axis is contiguous, bf16 or
// fp32), page_tables [B, P], start_lens [B] (int32 or int64), valid [B, Q]
// (bool) or none. Block i takes token (b, q) = (i / Q, i % Q): slot
// start_lens[b] + q, page page_tables[b, min(slot / ps, P - 1)], row
// slot % ps, and converts the token's rows as engine/cache.py does:
// - bf16 / fp32 arena: a cast (round to nearest even);
// - static e4m3 arena: clamp(x / scale[h], +-448), then e4m3;
// - per-token e4m3 (fp8_tok): s = max(amax |x|, 1e-8) / 448 per (token,
//   head), x / s in e4m3, and s to the scale arenas.
// Each step is the arithmetic torch does on the card (x / scale an IEEE
// divide, __fdiv_rn; / 448 a multiply by its reciprocal, kInvFp8Max; the
// e4m3 cast torch's rounding on the range the callers reach, e4m3x4), so a
// row's bytes equal the eager route's. An invalid token writes nothing (the eager route sends it
// to the null page 0, whose rows are undefined in both packages). Valid
// tokens name distinct slots, so there is no "later wins" search, but for
// one case: past the end of its page table a token's page index is clamped
// to P - 1, where token q + k ps (k >= 1, valid) names the same row; the
// later one writes, as in the eager route.
//
// kv_write_rows, the JAX contract (no caller on a path):
//
//   pages_a[layer, page_idx[i], row_idx[i]] = rows_a[i]    for i < N
//
// for up to four arenas a at once, which share the indices (int32 or int64,
// read as they come). Rows are opaque bytes; when two rows name one
// destination the later one is kept, as the Pallas DMAs land in order.
//
// kv_move_rows (K17):
//
//   pages[l, dst_page[i], dst_row[i]] = pages[l, src_page[i], src_row[i]]
//
// for every layer l and i < N, every source read before any destination is
// written (the gather-then-set semantics of move_kv_rows in the JAX
// package's engine/cache.py). Replaces the Pallas body _move_kernel
// (kv_move_rows_pallas) of the same file. When two moves name one
// destination the later one is kept; in practice only the null page 0 is
// named twice (masked moves). No path of either package calls it.
//
// What bounds all three on the H100: the bytes moved, each source row read
// once and each destination row written once, plus the indices; at decode
// widths a launch and one round trip to memory. The fixed fields of a
// launch are built and checked once a shape on the host (KvStepStatic,
// KvRowsStatic), so a call passes pointers. Designs: kv_write_step gives
// each token one block of 256 threads, each thread 8 lanes of a head at a
// time (16-byte loads of bf16 input where the pointers and strides allow);
// in fp8_tok mode the block first takes each head's amax in shared memory.
// (A variant that gave a block up to eight tokens of narrow rows, four
// groups a thread loaded before any store, was slower on an H100 in every
// case measured.)
// kv_write_rows gives each row one warp, which copies it with 16-byte
// vectors where the row's byte width and pointers allow (else 4-byte
// words, else bytes) for every arena; a block of 8 warps first stages the
// indices of the later rows in shared memory, 256 at a time, to find the
// rows that a later row overwrites (those write nothing). K17 cuts the
// rows into units of (column slice, layer) by a plan built once a shape on
// the host (KvMoveStatic, ops/kv_update.py move_plan: a unit's N slices
// within 32 KB, 264 units or more where the rows allow). Within a unit
// every source slice is staged in shared memory before any destination is
// written, so a chain (one move's destination another's source) needs no
// second launch; units are disjoint bytes. A block first loads the moves'
// rows and enters each destination row in a shared-memory hash table that
// keeps the highest move index (atomicMax), so "does a later move name this
// destination?" is O(N) for the block, not O(N^2), and it is answered once
// a block. Rows and a base of 16-byte units: a persistent grid whose blocks
// walk their units through a ring of two stages, every thread issuing bulk
// asynchronous copies (bulk_copy.cuh) of its moves' slices against the
// stage's mbarrier, the next unit's copies in flight while this unit is
// written by 16-byte stores from its stage (the first copies fly while the
// table is built). Rows of 4- or 1-byte units: a block a unit, a loop with
// four loads in flight a thread. tools/row_kernel_variants.py --variants
// k17 times the ring's depth and plan against that loop at 16 bytes; a
// first design (one warp issuing the copies, bulk stores, a block a unit)
// was slower at every N measured.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"

// What a kv_write_step launch fixes for a shape of its operands
// (ops/kv_update.py _StepStatic, field for field).
struct KvStepStatic {
  long long k_stride[3];  // new_k's strides over b, q, h (elements)
  long long v_stride[3];  // new_v's
  long long pt_stride;    // page_tables' row stride (elements)
  long long valid_stride; // valid's row stride (elements; unused without valid)
  int pt_wide, start_wide;  // int64 (1) or int32 (0) indices
  int B, Q, H, D, Dv, P, ps, n_pages, L;
  int in_f32;  // new_k / new_v in fp32 (else bf16)
  int mode;    // 0 bf16 arena, 1 fp32 arena, 2 static e4m3, 3 per-token e4m3
};

// What a kv_write_rows launch fixes (ops/kv_update.py _RowsStatic).
struct KvRowsStatic {
  long long row_bytes[4];
  long long rows_stride[4];  // bytes between rows i and i + 1
  int n_arenas, pi_wide, ri_wide, N, L, n_pages, ps;
};

// What a kv_move_rows launch fixes (ops/kv_update.py _MoveStatic and
// move_plan).
struct KvMoveStatic {
  long long row_bytes;
  int N, L, n_pages, ps;
  int slice;   // column slice bytes of a unit, a multiple of unit
  int unit;    // 16: bulk copies through a ring of stages; 4 or 1: a loop
  int grid_x;  // slices a row; units (slice, layer) = grid_x * L
  int table;   // slots of the later-destination table, a power of two >= 2N
  int stages;  // the ring's stages (16-byte units), else 1
  int blocks;  // blocks: a persistent grid (16-byte units), else one a unit
  int smem;    // dynamic shared memory a block: move_smem_bytes
};

namespace {

constexpr int kMaxArenas = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyChunk = kThreads;  // later rows' indices staged per round
constexpr int kMaxMoves = 1024;      // K17's moves per launch
constexpr int kMoveLoads = 4;        // K17's loads in flight a thread (the loop)
constexpr int kMaxStages = 4;        // K17's ring
constexpr int kStepThreads = 256;
constexpr int kMaxHeads = 256;       // kv_write_step's heads (fp8_tok's amax)
constexpr float kFp8Max = 448.f;
// fp8_tok's scale is amax * (1 / 448) in fp32: the eager route divides a CUDA
// tensor by the Python number 448, which torch computes as a multiply by the
// number's fp32 reciprocal
constexpr float kInvFp8Max = 1.f / 448.f;

__host__ __device__ constexpr size_t move_index_bytes(int N) {
  return ((size_t)N * 8 + 15) / 16 * 16;
}

// K17's block: the source and destination rows, the table's keys and
// highest move indices, then the stages of N slices each
__host__ __device__ constexpr size_t move_smem_bytes(int N, int table, int slice,
                                                     int stages) {
  return move_index_bytes(N) + (size_t)table * 8 + (size_t)stages * N * slice;
}

// element i of an int32 (wide = 0) or int64 (wide = 1) index tensor
__device__ __forceinline__ long long ld_index(const void* p, int wide, long long i) {
  return wide ? __ldg(static_cast<const long long*>(p) + i)
              : (long long)__ldg(static_cast<const int*>(p) + i);
}

// four fp32 values in [-448, 448] (and NaN) -> their e4m3 bytes, value 0 in
// the low byte: the hardware's round to nearest even, subnormals included,
// which is torch's cast on this range (c10's fp8e4m3fn_from_fp32_value; past
// it torch releases differ: a NaN or a saturation). The callers stay inside
// it: static mode clamps to +-448, and a per-token row divided by its amax /
// 448 reaches 448 (1 + 2^-23) at most, which both round to 448.
__device__ __forceinline__ uint32_t e4m3x4(const float (&v)[4]) {
  const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(v[0], v[1]), __NV_SATFINITE,
                                               __NV_E4M3);
  const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(v[2], v[3]), __NV_SATFINITE,
                                               __NV_E4M3);
  return lo | (hi << 16);
}

template <typename T>
__device__ __forceinline__ void copy_row(unsigned char* dst, const unsigned char* src,
                                         long long nbytes, int lane) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const long long n = nbytes / (long long)sizeof(T);
  for (long long e = lane; e < n; e += 32) d[e] = s[e];
}

struct RowsArgs {
  unsigned char* pages[kMaxArenas];
  const unsigned char* rows[kMaxArenas];
  int vec[kMaxArenas];  // 16, 4 or 1 bytes per copy
};

__global__ void __launch_bounds__(kThreads) kv_write_rows_kernel(
    KvRowsStatic st, RowsArgs a, const void* __restrict__ page_idx,
    const void* __restrict__ row_idx, int layer) {
  __shared__ long long keys[kKeyChunk];  // destination rows (page * ps + row)
  const int N = st.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * kWarps;
  const int i = i0 + warp;
  const long long my_key =
      i < N ? ld_index(page_idx, st.pi_wide, i) * st.ps + ld_index(row_idx, st.ri_wide, i)
            : -1;
  // does a later row name this row's destination? (block-uniform loop)
  bool later = false;
  for (int c = i0 + 1; c < N; c += kKeyChunk) {
    __syncthreads();
    const int j = c + threadIdx.x;
    if (j < N)
      keys[threadIdx.x] =
          ld_index(page_idx, st.pi_wide, j) * st.ps + ld_index(row_idx, st.ri_wide, j);
    __syncthreads();
    if (i < N && !later) {  // warp-uniform
      const int n = min(kKeyChunk, N - c);
      bool hit = false;
      for (int t = lane; t < n; t += 32) hit |= c + t > i && keys[t] == my_key;
      later = __any_sync(0xffffffffu, hit);
    }
  }
  if (i >= N || later) return;
  const long long slot = (long long)layer * st.n_pages * st.ps + my_key;
#pragma unroll
  for (int k = 0; k < kMaxArenas; ++k) {
    if (k >= st.n_arenas) break;
    unsigned char* dst = a.pages[k] + slot * st.row_bytes[k];
    const unsigned char* src = a.rows[k] + (long long)i * st.rows_stride[k];
    if (a.vec[k] == 16)
      copy_row<uint4>(dst, src, st.row_bytes[k], lane);
    else if (a.vec[k] == 4)
      copy_row<uint32_t>(dst, src, st.row_bytes[k], lane);
    else
      copy_row<unsigned char>(dst, src, st.row_bytes[k], lane);
  }
}

struct StepArgs {
  void* pages[2];          // K, V
  const void* rows[2];     // new_k, new_v
  const void* page_tables;
  const void* start_lens;
  const bool* valid;       // nullptr: every token valid
  const float* scale[2];   // static e4m3: [H] each
  float* tok[2];           // fp8_tok: [L, n_pages, ps, H] each
  int vec;  // new_k / new_v read 8 lanes at a time in 16-byte loads
};

// fp8_tok's per-(token, head) scale from the head's amax
__device__ __forceinline__ float tok_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), kInvFp8Max);
}

// 8 lanes from a row of bf16 or fp32, as fp32
template <typename TIn>
__device__ __forceinline__ void load8(const TIn* __restrict__ p, bool vec, float (&x)[8]) {
  if constexpr (sizeof(TIn) == 2) {
    if (vec) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[2 * j] = __uint_as_float(w[j] << 16);
        x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(p[j]);
    }
  } else {
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = p[j];
    }
  }
}

// One arena's row of token (b, q): H heads of D lanes from src (strides
// s[0..2] over b, q, h), 8 lanes a thread at a time, converted by kMode and
// stored at row `dst` of the arena; amax (fp8_tok): the heads' amax.
template <typename TIn, int kMode>
__device__ __forceinline__ void write_row(const TIn* __restrict__ src, const long long* s,
                                          int b, int q, int H, int D, bool vec, void* pages,
                                          long long dst, const float* __restrict__ scale,
                                          const float* amax) {
  const int groups = H * D / 8;
  const long long row0 = dst * H * D;
  src += b * s[0] + q * s[1];
  for (int g = threadIdx.x; g < groups; g += kStepThreads) {
    const int e = 8 * g, h = e / D, d = e - h * D;
    float x[8];
    load8<TIn>(src + h * s[2] + d, vec, x);
    if constexpr (kMode == 0) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&t);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(pages) + row0 + e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kMode == 1) {
      float* o = static_cast<float*>(pages) + row0 + e;
      *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(x[4], x[5], x[6], x[7]);
    } else {
      // static: x / scale[h] clamped to +-448; per token: x / s[h]
      const float sc = kMode == 2 ? __ldg(scale + h) : tok_scale(amax[h]);
      uint32_t w[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = __fdiv_rn(x[4 * c + u], sc);
          if (kMode == 2) v[u] = v[u] < -kFp8Max ? -kFp8Max : (v[u] > kFp8Max ? kFp8Max : v[u]);
        }
        w[c] = e4m3x4(v);
      }
      *reinterpret_cast<uint2*>(static_cast<uint8_t*>(pages) + row0 + e) =
          make_uint2(w[0], w[1]);
    }
  }
}

// fp8_tok: the heads' amax of one row into amax[H] (zeroed before)
template <typename TIn>
__device__ __forceinline__ void row_amax(const TIn* __restrict__ src, const long long* s, int b,
                                         int q, int H, int D, bool vec, float* amax) {
  src += b * s[0] + q * s[1];
  for (int g = threadIdx.x; g < H * D / 8; g += kStepThreads) {
    const int e = 8 * g, h = e / D, d = e - h * D;
    float x[8];
    load8<TIn>(src + h * s[2] + d, vec, x);
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(x[j]));
    // non-negative floats order as their bits
    atomicMax(reinterpret_cast<int*>(amax + h), __float_as_int(m));
  }
}

template <typename TIn, int kMode>
__global__ void __launch_bounds__(kStepThreads) kv_write_step_kernel(KvStepStatic st,
                                                                     StepArgs a, int layer) {
  __shared__ float amax[2][kMaxHeads];
  const int b = blockIdx.x / st.Q, q = blockIdx.x % st.Q;
  const bool* valid = a.valid;
  if (valid != nullptr && !valid[b * st.valid_stride + q]) return;
  const long long slot = ld_index(a.start_lens, st.start_wide, b) + q;
  long long pidx = slot / st.ps;
  if (pidx >= st.P - 1) {
    // clamped to the table's last page, where token q + k ps names this row
    // too: the last valid one writes
    for (int q2 = q + st.ps; q2 < st.Q; q2 += st.ps)
      if (valid == nullptr || valid[b * st.valid_stride + q2]) return;
    pidx = st.P - 1;
  }
  const long long page = ld_index(a.page_tables, st.pt_wide, b * st.pt_stride + pidx);
  const long long dst = ((long long)layer * st.n_pages + page) * st.ps + slot % st.ps;
  const TIn* nk = static_cast<const TIn*>(a.rows[0]);
  const TIn* nv = static_cast<const TIn*>(a.rows[1]);
  const bool vec = a.vec != 0;
  if constexpr (kMode == 3) {
    for (int h = threadIdx.x; h < st.H; h += kStepThreads) amax[0][h] = amax[1][h] = 0.f;
    __syncthreads();
    row_amax<TIn>(nk, st.k_stride, b, q, st.H, st.D, vec, amax[0]);
    row_amax<TIn>(nv, st.v_stride, b, q, st.H, st.Dv, vec, amax[1]);
    __syncthreads();
    for (int h = threadIdx.x; h < st.H; h += kStepThreads) {
      a.tok[0][dst * st.H + h] = tok_scale(amax[0][h]);
      a.tok[1][dst * st.H + h] = tok_scale(amax[1][h]);
    }
  }
  write_row<TIn, kMode>(nk, st.k_stride, b, q, st.H, st.D, vec, a.pages[0], dst, a.scale[0],
                        amax[0]);
  write_row<TIn, kMode>(nv, st.v_stride, b, q, st.H, st.Dv, vec, a.pages[1], dst, a.scale[1],
                        amax[1]);
}

template <typename TIn>
cudaError_t launch_step(const KvStepStatic& st, const StepArgs& a, int layer,
                        cudaStream_t stream) {
  const unsigned blocks = (unsigned)(st.B * st.Q);
  switch (st.mode) {
    case 0:
      kv_write_step_kernel<TIn, 0><<<blocks, kStepThreads, 0, stream>>>(st, a, layer);
      break;
    case 1:
      kv_write_step_kernel<TIn, 1><<<blocks, kStepThreads, 0, stream>>>(st, a, layer);
      break;
    case 2:
      kv_write_step_kernel<TIn, 2><<<blocks, kStepThreads, 0, stream>>>(st, a, layer);
      break;
    case 3:
      kv_write_step_kernel<TIn, 3><<<blocks, kStepThreads, 0, stream>>>(st, a, layer);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the table slot where a destination row's probe starts
__device__ __forceinline__ int table_slot(int key, int mask) {
  return static_cast<int>((static_cast<uint32_t>(key) * 2654435761u) >> 11) & mask;
}

// K17's shared memory: the moves' rows, the table, the stages
struct MoveSmem {
  int* src;  // [N] source rows (page * ps + row)
  int* dst;  // [N] destination rows, -1: not written
  unsigned char* stage;  // [stages][N][slice]
};

// The moves' rows into shared memory, each destination row's highest move
// index into a hash table (atomicMax), and dst[i] = -1 where a later move
// names dst[i] again (that one keeps the row): O(N) for the block. Ends
// synchronised. `overlap` runs after the rows are loaded and before the
// table is built (the 16-byte route issues its first copies there).
template <typename F>
__device__ __forceinline__ MoveSmem move_prologue(const KvMoveStatic& st,
                                                  const int* __restrict__ src_page,
                                                  const int* __restrict__ src_row,
                                                  const int* __restrict__ dst_page,
                                                  const int* __restrict__ dst_row,
                                                  unsigned char* smem, F overlap) {
  const int N = st.N, mask = st.table - 1, tid = threadIdx.x;
  MoveSmem m;
  m.src = reinterpret_cast<int*>(smem);
  m.dst = m.src + N;
  int* keys = reinterpret_cast<int*>(smem + move_index_bytes(N));  // [table] rows, -1: empty
  int* last = keys + st.table;  // [table] the highest move naming the key
  m.stage = smem + move_index_bytes(N) + (size_t)st.table * 8;
  for (int i = tid; i < N; i += kThreads) {
    m.src[i] = __ldg(src_page + i) * st.ps + __ldg(src_row + i);
    m.dst[i] = __ldg(dst_page + i) * st.ps + __ldg(dst_row + i);
  }
  for (int h = tid; h < st.table; h += kThreads) keys[h] = last[h] = -1;
  __syncthreads();
  overlap();
  for (int i = tid; i < N; i += kThreads) {
    const int key = m.dst[i];
    for (int h = table_slot(key, mask);; h = (h + 1) & mask) {
      const int prev = atomicCAS(&keys[h], -1, key);
      if (prev == -1 || prev == key) {
        atomicMax(&last[h], i);
        break;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    const int key = m.dst[i];
    int h = table_slot(key, mask);
    while (keys[h] != key) h = (h + 1) & mask;
    if (last[h] != i) m.dst[i] = -1;
  }
  __syncthreads();
  return m;
}

// The writes of one unit from its stage: 16-byte (or T-sized) stores of the
// kept moves' slices.
template <typename T>
__device__ __forceinline__ void move_store(const KvMoveStatic& st, const MoveSmem& m,
                                           const unsigned char* stage, unsigned char* base,
                                           int nb) {
  const int nv = nb / (int)sizeof(T), per = st.slice / (int)sizeof(T), total = st.N * nv;
  const T* stv = reinterpret_cast<const T*>(stage);
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int i = e / nv;
    if (m.dst[i] >= 0)
      reinterpret_cast<T*>(base + (long long)m.dst[i] * st.row_bytes)[e % nv] =
          stv[i * per + e % nv];
  }
}

// the (slice, layer) unit u's first byte, and its slice's bytes
__device__ __forceinline__ unsigned char* move_unit(const KvMoveStatic& st,
                                                    unsigned char* pages, int u, int& nb) {
  const long long c0 = (long long)(u % st.grid_x) * st.slice;
  nb = (int)min((long long)st.slice, st.row_bytes - c0);
  return pages + (long long)(u / st.grid_x) * st.n_pages * st.ps * st.row_bytes + c0;
}

// Rows of 4- or 1-byte units (and, as a variant, 16): block b walks units
// b, b + blocks, ... (the plan gives them a block each); stage a unit's
// sources by a loop of T-sized loads, kMoveLoads in flight a thread,
// synchronise, write.
template <int kUnit>
__global__ void __launch_bounds__(kThreads) kv_move_rows_kernel(
    const KvMoveStatic st, unsigned char* __restrict__ pages, const int* __restrict__ src_page,
    const int* __restrict__ src_row, const int* __restrict__ dst_page,
    const int* __restrict__ dst_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = typename std::conditional<
      kUnit == 16, uint4,
      typename std::conditional<kUnit == 4, uint32_t, unsigned char>::type>::type;
  const MoveSmem m = move_prologue(st, src_page, src_row, dst_page, dst_row, smem, [] {});
  T* stv = reinterpret_cast<T*>(m.stage);
  for (int u = blockIdx.x; u < st.grid_x * st.L; u += gridDim.x) {
    int nb;
    unsigned char* base = move_unit(st, pages, u, nb);
    const int nv = nb / kUnit, per = st.slice / kUnit, total = st.N * nv;
    for (int e0 = threadIdx.x; e0 < total; e0 += kMoveLoads * kThreads) {
      T r[kMoveLoads];
#pragma unroll
      for (int j = 0; j < kMoveLoads; ++j) {
        const int e = e0 + j * kThreads;
        if (e < total)
          r[j] = reinterpret_cast<const T*>(base + (long long)m.src[e / nv] * st.row_bytes)
              [e % nv];
      }
#pragma unroll
      for (int j = 0; j < kMoveLoads; ++j) {
        const int e = e0 + j * kThreads;
        if (e < total) stv[(e / nv) * per + e % nv] = r[j];
      }
    }
    __syncthreads();  // every read of this (layer, slice) before any write
    move_store<T>(st, m, m.stage, base, nb);
    __syncthreads();  // the stage is free for the next unit
  }
}

// Rows of 16-byte units: a persistent grid, block b walking units b, b +
// blocks, ... through a ring of st.stages stages. Every thread issues the
// bulk copies of its moves' source slices of a unit (complete on the stage's
// mbarrier), st.stages - 1 units ahead of the one being written; a unit's
// writes are 16-byte stores from its stage once every copy of it has landed,
// so within a (layer, slice) every read precedes every write, and one unit's
// writes overlap the next units' reads. The moves' rows and the table are
// built once a block.
__global__ void __launch_bounds__(kThreads) kv_move_rows_ring(
    const KvMoveStatic st, unsigned char* __restrict__ pages, const int* __restrict__ src_page,
    const int* __restrict__ src_row, const int* __restrict__ dst_page,
    const int* __restrict__ dst_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kMaxStages];
  const int N = st.N, S = st.stages, tid = threadIdx.x;
  const int units = st.grid_x * st.L;
  const int mine = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  unsigned char* stages = smem + move_index_bytes(N) + (size_t)st.table * 8;
  const int* src = reinterpret_cast<const int*>(smem);
  // the k-th unit of this block goes through stage k % S: one arrival on its
  // mbarrier announces the unit's bytes (thread 0, before the barrier that
  // precedes the copies), then every thread copies its moves' slices
  auto expect = [&](int k) {
    int nb;
    move_unit(st, pages, blockIdx.x + k * gridDim.x, nb);
    piawg::mbar_expect(piawg::smem_u32(&bars[k % S]), static_cast<uint32_t>(N) * nb);
  };
  auto copy = [&](int k) {
    int nb;
    const unsigned char* base = move_unit(st, pages, blockIdx.x + k * gridDim.x, nb);
    const uint32_t bar = piawg::smem_u32(&bars[k % S]);
    unsigned char* stage = stages + (size_t)(k % S) * N * st.slice;
    for (int i = tid; i < N; i += kThreads)
      pia_bulk::load(piawg::smem_u32(stage + (size_t)i * st.slice),
                     base + (long long)src[i] * st.row_bytes, nb, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) piawg::mbar_init(piawg::smem_u32(&bars[s]));
    piawg::fence_mbar_init();
    for (int k = 0; k < S && k < mine; ++k) expect(k);  // units 0 .. S - 1
  }
  const MoveSmem m = move_prologue(st, src_page, src_row, dst_page, dst_row, smem, [&] {
    for (int k = 0; k < S - 1 && k < mine; ++k) copy(k);
  });
  for (int k = 0; k < mine; ++k) {
    if (k + S - 1 < mine) {
      piawg::fence_async_smem();  // the stage's last reads (generic) before its next copies
      copy(k + S - 1);
    }
    int nb;
    unsigned char* base = move_unit(st, pages, blockIdx.x + k * gridDim.x, nb);
    piawg::mbar_wait(piawg::smem_u32(&bars[k % S]), (k / S) & 1);
    move_store<uint4>(st, m, m.stage + (size_t)(k % S) * N * st.slice, base, nb);
    // unit k + S takes this stage (its copies at step k + 1): the phase for
    // unit k has completed
    if (tid == 0 && k + S < mine) expect(k + S);
    __syncthreads();  // the stage is free for unit k + S
  }
}

int vec_of(const void* a, const void* b, long long n, long long stride) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a), pb = reinterpret_cast<uintptr_t>(b);
  if (n % 16 == 0 && stride % 16 == 0 && pa % 16 == 0 && pb % 16 == 0) return 16;
  if (n % 4 == 0 && stride % 4 == 0 && pa % 4 == 0 && pb % 4 == 0) return 4;
  return 1;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// st: the shape's fixed fields (checked by the wrapper); pages[k] [L,
// n_pages, ps, row_bytes[k]] and rows[k] (rows_stride[k] bytes apart) for
// k < st->n_arenas, the others null; page_idx, row_idx [N] int32 or int64
// on the device.
extern "C" int kv_write_rows(const KvRowsStatic* st, void* p0, void* p1, void* p2, void* p3,
                             const void* r0, const void* r1, const void* r2, const void* r3,
                             const void* page_idx, const void* row_idx, int layer,
                             void* stream) {
  if (st->N == 0 || st->n_arenas == 0) return 0;
  if (st->n_arenas > kMaxArenas) return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a;
  void* pages[kMaxArenas] = {p0, p1, p2, p3};
  const void* rows[kMaxArenas] = {r0, r1, r2, r3};
  for (int k = 0; k < kMaxArenas; ++k) {
    a.pages[k] = static_cast<unsigned char*>(pages[k]);
    a.rows[k] = static_cast<const unsigned char*>(rows[k]);
    a.vec[k] = k < st->n_arenas ? vec_of(pages[k], rows[k], st->row_bytes[k],
                                         st->rows_stride[k])
                                : 1;
  }
  const int blocks = (st->N + kWarps - 1) / kWarps;
  kv_write_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *st, a, page_idx, row_idx, layer);
  return static_cast<int>(cudaGetLastError());
}

// st: the shape's fixed fields (checked by the wrapper). The arenas start on
// 16-byte boundaries (checked: cudaErrorMisalignedAddress); the scale
// pointers are null where the mode takes none, valid null for all valid.
extern "C" int kv_write_step(const KvStepStatic* st, void* k_pages, void* v_pages,
                             const void* new_k, const void* new_v, const void* page_tables,
                             const void* start_lens, const void* valid, const void* k_scale,
                             const void* v_scale, void* k_tok, void* v_tok, int layer,
                             void* stream) {
  if (st->B == 0 || st->Q == 0) return 0;
  if (!aligned16(k_pages) || !aligned16(v_pages) || (k_tok && !aligned16(k_tok)) ||
      (v_tok && !aligned16(v_tok)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  StepArgs a;
  a.pages[0] = k_pages;
  a.pages[1] = v_pages;
  a.rows[0] = new_k;
  a.rows[1] = new_v;
  a.page_tables = page_tables;
  a.start_lens = start_lens;
  a.valid = static_cast<const bool*>(valid);
  a.scale[0] = static_cast<const float*>(k_scale);
  a.scale[1] = static_cast<const float*>(v_scale);
  a.tok[0] = static_cast<float*>(k_tok);
  a.tok[1] = static_cast<float*>(v_tok);
  // 16-byte loads where every 8-lane group of both inputs starts on a
  // 16-byte boundary (bf16: the strides in elements multiples of 8; fp32:
  // of 4, and a group is two loads)
  const long long unit = st->in_f32 ? 4 : 8;
  bool vec = aligned16(new_k) && aligned16(new_v);
  for (int i = 0; i < 3; ++i)
    vec = vec && st->k_stride[i] % unit == 0 && st->v_stride[i] % unit == 0;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = st->in_f32 ? launch_step<float>(*st, a, layer, s)
                                     : launch_step<__nv_bfloat16>(*st, a, layer, s);
  return static_cast<int>(err);
}

// The shared memory one block of kv_move_rows may take on the current device
// (the wrapper asks once a device).
extern "C" int kv_move_rows_smem_limit(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

namespace {

// the dynamic shared memory a kernel may take, raised once a size
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename K>
int launch_move(K kernel, int& allowed, const KvMoveStatic& st, void* pages, const void* sp,
                const void* sr, const void* dp, const void* dr, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, st.smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<st.blocks, kThreads, st.smem, stream>>>(
      st, static_cast<unsigned char*>(pages), static_cast<const int*>(sp),
      static_cast<const int*>(sr), static_cast<const int*>(dp), static_cast<const int*>(dr));
  return static_cast<int>(cudaGetLastError());
}

int ring_smem = 48 * 1024, loop4_smem = 48 * 1024, loop1_smem = 48 * 1024;

}  // namespace

// st: the shape's plan (built and checked by the wrapper); pages [L, n_pages,
// ps, row_bytes] bytes, its base a multiple of st->unit; the four index
// arrays int32 [N] on the device, 1 <= N <= 1024 (checked:
// cudaErrorInvalidValue, and cudaErrorMisalignedAddress for the base).
extern "C" int kv_move_rows(const KvMoveStatic* st, void* pages, const void* src_page,
                            const void* src_row, const void* dst_page, const void* dst_row,
                            void* stream) {
  if (st->L == 0) return 0;
  const int u = st->unit;
  const long long units = (long long)st->grid_x * st->L;
  if (st->N < 1 || st->N > kMaxMoves || (u != 16 && u != 4 && u != 1) || st->slice % u ||
      st->row_bytes % u || st->table < 2 * st->N || (st->table & (st->table - 1)) ||
      st->stages < 1 || st->stages > kMaxStages || (u != 16 && st->stages != 1) ||
      (size_t)st->smem != move_smem_bytes(st->N, st->table, st->slice, st->stages) ||
      (long long)st->grid_x * st->slice < st->row_bytes || st->blocks < 1 ||
      st->blocks > units)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(pages) % u) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u == 16)
    return launch_move(kv_move_rows_ring, ring_smem, *st, pages, src_page, src_row, dst_page,
                       dst_row, s);
  if (u == 4)
    return launch_move(kv_move_rows_kernel<4>, loop4_smem, *st, pages, src_page, src_row,
                       dst_page, dst_row, s);
  return launch_move(kv_move_rows_kernel<1>, loop1_smem, *st, pages, src_page, src_row,
                     dst_page, dst_row, s);
}
