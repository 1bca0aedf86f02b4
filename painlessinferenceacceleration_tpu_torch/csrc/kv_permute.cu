// Tail-window KV compaction for Hopper (sm_90a), in place over all layers
// (K4). One device body, two entries:
//
// kv_permute_pages, the JAX contract (kv_permute_pages_pallas):
//
//   pages[l, page_ids[b, w / ps], w % ps] = win[b, l][src_rel[b, w]]
//
// where win[b, l] is request b's window as it was before the call;
//
// kv_compact_tail, the verify step's compaction of up to four arenas of one
// [L, n_pages, ps] geometry (K, V, and in fp8_tok mode their per-token scale
// arenas; each with its own row width, any element type) in one launch: each
// block derives its request's window from the step's own tensors, as
// compact_kv_tail (engine/cache.py) composes it on the CPU,
//
//   p0 = ctx // ps,  page_ids[t] = active ? page_tables[clamp(p0 + t, 0, P-1)] : 0,
//   node ctx + path[i] moves to slot ctx + 1 + i for i < n_edges,
//
// the source slot clamped to the window as src_rel is. The index tensors are
// read as they come (int32 or int64, path and page_tables with a row
// stride), so nothing runs on the card before the launch. Replaces the
// Pallas body _permute_kernel of painlessinferenceacceleration_tpu/ops/
// kv_update.py, which compact_kv_tail (JAX engine/cache.py) calls after
// every verify step on a bf16 arena; for e4m3 and scale arenas the JAX
// package gathers the window and writes its pages back whole
// (_page_write_kernel, K6 here), which leaves the same bytes: every slot of a
// window page outside the moves is its own source.
//
// What bounds it on the H100: the bytes of the rows that move, each source
// read once and each destination written once over all layers, plus the
// indices. A slot whose source is itself costs nothing, so the compaction of
// a one-branch verify step (the accepted path is a prefix of the draft: the
// identity) moves no row bytes; there the launch and one read of the
// indices are the whole cost.
//
// Design. The work is sized by the moves, not the window. A block takes one
// request (blockIdx.y) and walks units of (arena, layer, column chunk of cb
// bytes), blockIdx.x, blockIdx.x + gridDim.x, ... First, in one round of
// loads, it reads the request's moves and its window's page ids (for the
// compaction, the whole page-table row into shared memory, before the
// context length that picks the window has arrived): a request none of whose
// moves moves a row exits there, before it touches the arena. Otherwise it
// marks each window page that a later slot of the window also names (the
// page-table clip near the end of a table: only the later slot writes, the
// order in which the Pallas kernel's DMAs land), once, in shared memory, and
// lists its moving rows (source and destination arena rows). For each unit it
// stages the chunk of every listed source row in shared memory, then writes
// the listed destinations, so a move whose destination is a later move's
// source reads the row as it was. An arena whose rows are a multiple of 16
// bytes and whose base is 16-byte aligned stages by one cp.async.bulk copy a
// row completed on an mbarrier (against 16-byte loads by every thread:
// tools/row_kernel_variants.py --variants) and writes 16-byte vectors; any
// other (rows a multiple of 4 bytes: fp8_tok's scale rows of 4 Hkv bytes)
// stages and writes 4-byte words, four loads in flight a thread. At most
// max_moves rows are staged (the path's width, Q - 1, for the compaction;
// the window for the JAX contract); the wrapper's plan (ops/kv_update.py
// permute_plan) picks cb so that they fit the staging budget.
//
// Two requests share no page but the null page 0. Where two requests' moves
// name one row of page 0, or one reads a row of page 0 that another writes,
// that row's contents are not defined (as in the plain version's scatter).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

// What a wrapper fixes for a shape of its operands (ops/kv_update.py
// _Static mirrors it field for field); the pointers come with each call.
struct KvPermuteStatic {
  long long row_bytes[4];  // the arenas' rows (0 past the last arena)
  long long idx_stride;    // page_ids' / page_tables' row stride, elements
  long long src_stride;    // src_rel's / path's row stride, elements
  int idx_wide, src_wide, ctx_wide, ne_wide;  // int64 (1) or int32 (0) indices
  int L, B, n_pages, ps, TPP;
  int P;  // page_tables' columns (kv_compact_tail)
  int M;  // path's columns (kv_compact_tail); the moving rows staged at most
  int cb, grid_x;  // column chunk bytes, blocks a request
};

namespace {

using Static = KvPermuteStatic;

constexpr int kThreads = 256;
constexpr int kMaxTPP = 32;  // window pages
constexpr int kMaxArenas = 4;

struct Args {
  Static s;
  unsigned char* arena[kMaxArenas];
  int chunks[kMaxArenas];  // column chunks of cb bytes a row (the last may be narrower)
  int unit0[kMaxArenas + 1];  // each arena's first unit; unit0[n_arenas] = units
  int vec16[kMaxArenas];  // 16-byte rows and base: bulk copies; else 4-byte words
  int n_arenas, units;
  int max_moves;
  const void* ids;  // page_ids / page_tables
  const void* src;  // src_rel / path
  const void* ctx_lens;
  const void* n_edges;
  const unsigned char* active;  // bool [B], or null
};

// element i of an int32 (wide = 0) or int64 (wide = 1) index tensor
__device__ __forceinline__ long long ld_index(const void* p, int wide, long long i) {
  return wide ? __ldg(static_cast<const long long*>(p) + i)
              : static_cast<long long>(__ldg(static_cast<const int*>(p) + i));
}

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) / 16 * 16; }

template <bool kDerive>
__global__ void __launch_bounds__(kThreads) kv_permute_kernel(const Args a) {
  // dynamic: [src rows][dst rows], the request's page-table row
  // (kv_compact_tail), then the stage
  extern __shared__ uint4 smem[];
  __shared__ int s_ids[kMaxTPP];
  __shared__ int s_keep[kMaxTPP];
  __shared__ int s_n;
  __shared__ long long s_ctx;
  __shared__ int s_ne, s_act;
  __shared__ uint64_t s_bar;
  const Static& st = a.s;
  int* lst_src = reinterpret_cast<int*>(smem);
  int* lst_dst = lst_src + a.max_moves;
  int* s_pt = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) +
                                     round16(2 * a.max_moves * 4));
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(s_pt) + round16(kDerive ? st.P * 4 : 0);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int ps = st.ps, W = st.TPP * ps;

  // 1. one round of loads: the moves and the window's pages; does a row
  // move? (nothing of the arena is touched otherwise)
  long long ctx = 0, base = 0, my_src = 0;
  int any = 0;
  if (kDerive) {
    if (tid == 0) {
      s_ctx = ld_index(a.ctx_lens, st.ctx_wide, b);
      const long long ne = ld_index(a.n_edges, st.ne_wide, b);
      s_ne = static_cast<int>(ne < 0 ? 0 : (ne > st.M ? st.M : ne));
      s_act = a.active == nullptr ? 1 : a.active[b] != 0;
      s_n = 0;
    }
    if (tid < st.M) my_src = ld_index(a.src, st.src_wide, b * st.src_stride + tid);
    for (int j = tid; j < st.P; j += kThreads)
      s_pt[j] = static_cast<int>(ld_index(a.ids, st.idx_wide, b * st.idx_stride + j));
    __syncthreads();
    ctx = s_ctx;
    base = ctx / ps * ps;
    for (int i = tid; i < s_ne; i += kThreads) {
      const long long p =
          i == tid ? my_src : ld_index(a.src, st.src_wide, b * st.src_stride + i);
      any |= p != i + 1;
    }
    if (tid < st.TPP) {
      long long pos = ctx / ps + tid;
      pos = pos < 0 ? 0 : (pos > st.P - 1 ? st.P - 1 : pos);
      s_ids[tid] = s_act ? s_pt[pos] : 0;
    }
  } else {
    if (tid == 0) s_n = 0;
    if (tid < st.TPP)
      s_ids[tid] = static_cast<int>(ld_index(a.ids, st.idx_wide, b * st.idx_stride + tid));
    for (int w = tid; w < W; w += kThreads) {
      const long long p = ld_index(a.src, st.src_wide, b * st.src_stride + w);
      if (w == tid) my_src = p;
      any |= p != w;
    }
  }
  if (tid == 0) {
    piawg::mbar_init(piawg::smem_u32(&s_bar));
    piawg::fence_mbar_init();
  }
  if (!__syncthreads_or(any)) return;

  // 2. a window page that a later slot also names is not written
  if (tid < st.TPP) {
    int keep = 1;
    for (int t2 = tid + 1; t2 < st.TPP; ++t2) keep &= s_ids[t2] != s_ids[tid];
    s_keep[tid] = keep;
  }
  __syncthreads();

  // 3. the moving rows: (source, destination) arena rows, in any order
  const int n_cand = kDerive ? s_ne : W;
  for (int i = tid; i < n_cand; i += kThreads) {
    long long wd, src;
    const long long p =
        i == tid ? my_src : ld_index(a.src, st.src_wide, b * st.src_stride + i);
    if (kDerive) {
      wd = ctx + 1 + i - base;
      if (wd >= W) continue;  // past the window: dropped, as JAX drops it
      src = ctx + p - base;
    } else {
      wd = i;
      src = p;
    }
    src = src < 0 ? 0 : (src > W - 1 ? W - 1 : src);
    if (src == wd || !s_keep[wd / ps]) continue;
    const int k = atomicAdd(&s_n, 1);
    lst_src[k] = s_ids[src / ps] * ps + static_cast<int>(src % ps);
    lst_dst[k] = s_ids[wd / ps] * ps + static_cast<int>(wd % ps);
  }
  __syncthreads();
  const int n = s_n;
  if (n == 0) return;

  // 4. each unit: stage the chunks of the source rows, then write them
  const uint32_t bar = piawg::smem_u32(&s_bar);
  uint32_t phase = 0;
  const int warp = tid >> 5, lane = tid & 31;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    int ai = 0;
    while (ai + 1 < a.n_arenas && u >= a.unit0[ai + 1]) ++ai;
    const long long row_bytes = st.row_bytes[ai];
    const int uu = u - a.unit0[ai];
    const int l = uu / a.chunks[ai];
    const long long c0 = static_cast<long long>(uu % a.chunks[ai]) * st.cb;
    const int nb = static_cast<int>(row_bytes - c0 < st.cb ? row_bytes - c0 : st.cb);
    unsigned char* layer =
        a.arena[ai] + static_cast<size_t>(l) * st.n_pages * ps * row_bytes + c0;
    if (a.vec16[ai]) {
      const int nv = nb / 16, cv = st.cb / 16;  // 16-byte vectors a row, a staged row
      const int total = n * nv;
      const uint4* stv = reinterpret_cast<const uint4*>(stage);
      if (warp == 0) {
        piawg::fence_async_smem();
        if (lane == 0) piawg::mbar_expect(bar, static_cast<uint32_t>(total * 16));
        __syncwarp();
        for (int k = lane; k < n; k += 32)
          pia_bulk::load(piawg::smem_u32(stage + static_cast<size_t>(k) * st.cb),
                         layer + static_cast<size_t>(lst_src[k]) * row_bytes, nb, bar);
      }
      piawg::mbar_wait(bar, phase);
      phase ^= 1;
      for (int e = tid; e < total; e += kThreads)
        reinterpret_cast<uint4*>(layer + static_cast<size_t>(lst_dst[e / nv]) * row_bytes)
            [e % nv] = stv[(e / nv) * cv + e % nv];
    } else {
      const int nw = nb / 4, cw = st.cb / 4;  // 4-byte words a row, a staged row
      const int total = n * nw;
      uint32_t* stw = reinterpret_cast<uint32_t*>(stage);
      for (int e0 = tid; e0 < total; e0 += 4 * kThreads) {
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + j * kThreads;
          if (e < total)
            r[j] = reinterpret_cast<const uint32_t*>(
                layer + static_cast<size_t>(lst_src[e / nw]) * row_bytes)[e % nw];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + j * kThreads;
          if (e < total) stw[(e / nw) * cw + e % nw] = r[j];
        }
      }
      __syncthreads();  // every source word staged before any write
      for (int e = tid; e < total; e += kThreads)
        reinterpret_cast<uint32_t*>(layer + static_cast<size_t>(lst_dst[e / nw]) * row_bytes)
            [e % nw] = stw[(e / nw) * cw + e % nw];
    }
    __syncthreads();  // the stage is free for the next unit
  }
}

// dynamic shared memory: the move lists, the page-table row, the stage
size_t smem_bytes(int max_moves, int P, int cb) {
  return static_cast<size_t>(round16(2 * max_moves * 4)) + round16(P * 4) +
         static_cast<size_t>(max_moves) * cb;
}

template <bool kDerive>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.max_moves, kDerive ? a.s.P : 0, a.s.cb);
  auto kernel = kv_permute_kernel<kDerive>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.s.grid_x, a.s.B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDerive>
int dispatch(const Static* s, void* const* arenas, int n_arenas, const void* ids,
             const void* src, const void* ctx_lens, const void* n_edges, const void* active,
             void* stream) {
  Args a = {};
  a.s = *s;
  a.n_arenas = n_arenas;
  if (n_arenas < 1 || n_arenas > kMaxArenas || s->TPP > kMaxTPP || s->cb <= 0 ||
      s->cb % 16 || s->grid_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_arenas; ++i) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(arenas[i]);
    if (s->row_bytes[i] <= 0 || s->row_bytes[i] % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    if (p % 4) return static_cast<int>(cudaErrorMisalignedAddress);
    a.arena[i] = static_cast<unsigned char*>(arenas[i]);
    a.chunks[i] = static_cast<int>((s->row_bytes[i] + s->cb - 1) / s->cb);
    a.unit0[i + 1] = a.unit0[i] + s->L * a.chunks[i];
    a.vec16[i] = s->row_bytes[i] % 16 == 0 && p % 16 == 0;
  }
  a.units = a.unit0[n_arenas];
  a.max_moves = kDerive ? s->M : s->TPP * s->ps;
  a.ids = ids, a.src = src, a.ctx_lens = ctx_lens, a.n_edges = n_edges;
  a.active = static_cast<const unsigned char*>(active);
  if (a.units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kDerive>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pages [L, n_pages, ps, row_bytes[0]] (any element type, rows of a
// multiple of 4 bytes, 4-byte aligned); page_ids [B, TPP] and src_rel
// [B, TPP*ps] (values in [0, TPP*ps)), int32 or int64 as s says, rows
// idx_stride / src_stride elements apart.
extern "C" int kv_permute_pages(const KvPermuteStatic* s, void* pages, const void* page_ids,
                                const void* src_rel, void* stream) {
  void* arenas[1] = {pages};
  return dispatch<false>(s, arenas, 1, page_ids, src_rel, nullptr, nullptr, nullptr, stream);
}

// arena k [L, n_pages, ps, row_bytes[k]] for k < n_arenas (1-4; rows of a
// multiple of 4 bytes, 4-byte aligned), the others null; page_tables [B, P],
// ctx_lens [B], path [B, M], n_edges [B], int32 or int64 as s says,
// page_tables' and path's rows idx_stride / src_stride elements apart;
// active bool [B] or null.
extern "C" int kv_compact_tail(const KvPermuteStatic* s, void* a0, void* a1, void* a2,
                               void* a3, int n_arenas, const void* page_tables,
                               const void* ctx_lens, const void* path, const void* n_edges,
                               const void* active, void* stream) {
  void* arenas[kMaxArenas] = {a0, a1, a2, a3};
  return dispatch<true>(s, arenas, n_arenas, page_tables, path, ctx_lens, n_edges, active,
                        stream);
}
