// Whole-page KV write-back for Hopper (sm_90a), over all layers (K6).
//
//   pages[l, page_ids[w]] = windows[l, w]    for every layer l, window page w
//
// Replaces the Pallas body _page_write_kernel of
// painlessinferenceacceleration_tpu/ops/kv_update.py (kv_write_pages_pallas),
// by which the JAX package writes back the gathered tail windows of an e4m3
// arena and of the per-token scale arenas after a verify step. The port
// compacts those arenas in place through K4 (kv_permute.cu), which leaves
// the same bytes, so this kernel is the JAX contract and no path calls it.
// Pages are opaque bytes: one kernel serves any element type.
//
// What bounds it on the H100: the bytes moved, each kept window page read
// once and each destination page written once, 2 * L * W_kept * page_bytes,
// plus the W page ids. When two window pages name the same destination (the
// page-table clip, or the null page 0 that inactive rows write), only the
// later one writes it, as the Pallas kernel's DMAs land in order, so the
// result is defined; each block decides this once from the W ids.
//
// Design. The pages are cut into pieces of 16 KB (the last of a page may be
// shorter), numbered layer-major, window page, then piece. A persistent grid
// of one-warp blocks (the wrapper's plan, ops/kv_update.py page_write_plan:
// three blocks an SM) walks them, block b taking pieces b, b + grid, ...,
// with bulk asynchronous copies (bulk_copy.cuh): one thread keeps kStages - 1
// pieces loading from device memory into a ring of shared-memory stages,
// each on its own mbarrier, and as each lands issues a bulk store of it to
// its destination page; a stage is loaded again once its store has read it.
// So reads and writes stream without waves of blocks, and no thread holds
// the bytes in registers. Pages or pointers that are not 16-byte aligned
// take a vector loop (4-byte words, or bytes), four loads in flight per
// thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

// What a wrapper fixes for a shape of its operands (ops/kv_update.py
// _PageWriteStatic mirrors it field for field).
struct KvPageWriteStatic {
  long long page_bytes;  // ps * row bytes
  int L, W, n_pages;
  int ids_wide;  // page_ids int64 (1) or int32 (0)
  int pieces;    // pieces of kPiece bytes a page (the bulk route)
  int grid;      // blocks of the bulk route
};

namespace {

using Static = KvPageWriteStatic;

constexpr int kPiece = 16384;  // bytes of one bulk copy
constexpr int kStages = 4;     // the ring: kStages - 1 loads in flight a block
constexpr int kThreads = 256;  // the vector route
constexpr int kUnroll = 4;

__device__ __forceinline__ long long ld_index(const void* p, int wide, long long i) {
  return wide ? __ldg(static_cast<const long long*>(p) + i)
              : static_cast<long long>(__ldg(static_cast<const int*>(p) + i));
}

// the destination page of window page w, or -1 where a later window page
// names it too (that one writes it)
__device__ __forceinline__ long long dest_page(const Static& st, const void* ids, int w) {
  const long long dst = ld_index(ids, st.ids_wide, w);
  for (int w2 = w + 1; w2 < st.W; ++w2)
    if (ld_index(ids, st.ids_wide, w2) == dst) return -1;
  return dst;
}

// a persistent grid of one warp a block: lane 0 moves the block's pieces
__global__ void __launch_bounds__(32) kv_page_write_bulk(const Static st,
                                                         unsigned char* __restrict__ pages,
                                                         const unsigned char* __restrict__ windows,
                                                         const void* __restrict__ ids) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ uint64_t bars[kStages];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kStages; ++s) piawg::mbar_init(piawg::smem_u32(&bars[s]));
  piawg::fence_mbar_init();
  const long long total = static_cast<long long>(st.L) * st.W * st.pieces;
  long long next = blockIdx.x;  // the next piece of this block to look at
  unsigned char* out[kStages];  // each stage's destination and bytes
  int bytes[kStages];
  int issued = 0, done = 0;  // pieces loaded, and stored, by this block
  // loads the block's next kept piece into stage issued % kStages
  auto load_next = [&]() -> bool {
    for (; next < total; next += gridDim.x) {
      const int c = static_cast<int>(next % st.pieces);
      const long long wl = next / st.pieces;
      const int w = static_cast<int>(wl % st.W), l = static_cast<int>(wl / st.W);
      const long long dst = dest_page(st, ids, w);
      if (dst < 0) continue;
      const long long off = static_cast<long long>(c) * kPiece;
      const long long rest = st.page_bytes - off;
      const int n = static_cast<int>(rest < kPiece ? rest : kPiece);
      const int s = issued % kStages;
      const uint32_t bar = piawg::smem_u32(&bars[s]);
      piawg::mbar_expect(bar, static_cast<uint32_t>(n));
      pia_bulk::load(piawg::smem_u32(stage + s * kPiece),
                     windows + (static_cast<long long>(l) * st.W + w) * st.page_bytes + off, n,
                     bar);
      out[s] = pages + (static_cast<long long>(l) * st.n_pages + dst) * st.page_bytes + off;
      bytes[s] = n;
      ++issued;
      next += gridDim.x;
      return true;
    }
    return false;
  };
  while (issued < kStages - 1 && load_next()) {
  }
  while (done < issued) {
    const int s = done % kStages;
    piawg::mbar_wait(piawg::smem_u32(&bars[s]), (done / kStages) & 1);
    piawg::fence_async_smem();
    pia_bulk::store(out[s], piawg::smem_u32(stage + s * kPiece), bytes[s]);
    pia_bulk::commit();
    ++done;
    // every store but the newest has read its stage, so the stage of piece
    // issued - kStages (<= done - 2) is free for the next load
    pia_bulk::wait_read1();
    load_next();
  }
  pia_bulk::wait_read();  // the stages stay until the stores have read them
}

// grid (1, W, L): the page in units of T, kUnroll loads in flight a thread
template <typename T>
__global__ void __launch_bounds__(kThreads) kv_page_write_vec(const Static st,
                                                              unsigned char* __restrict__ pages,
                                                              const unsigned char* __restrict__ windows,
                                                              const void* __restrict__ ids) {
  const int w = blockIdx.y, l = blockIdx.z;
  const long long dst = dest_page(st, ids, w);
  if (dst < 0) return;
  const T* s = reinterpret_cast<const T*>(windows + (static_cast<long long>(l) * st.W + w) *
                                                        st.page_bytes);
  T* o = reinterpret_cast<T*>(pages + (static_cast<long long>(l) * st.n_pages + dst) *
                                          st.page_bytes);
  const long long n = st.page_bytes / static_cast<long long>(sizeof(T));
  for (long long e = threadIdx.x; e < n; e += kUnroll * kThreads) {
    T r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = e + static_cast<long long>(u) * kThreads;
      if (i < n) r[u] = s[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = e + static_cast<long long>(u) * kThreads;
      if (i < n) o[i] = r[u];
    }
  }
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// st: the shape's fixed fields (checked by the wrapper); pages [L, n_pages,
// page_bytes] and windows [L, W, page_bytes] as bytes (any element type);
// page_ids [W] int32 or int64 with values in [0, n_pages). The bulk route
// where page_bytes and both pointers are multiples of 16, else the vector
// route.
extern "C" int kv_page_write(const KvPageWriteStatic* st, void* pages, const void* windows,
                             const void* page_ids, void* stream) {
  if (st->W == 0 || st->L == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<unsigned char*>(pages);
  auto* win = static_cast<const unsigned char*>(windows);
  const uintptr_t pp = reinterpret_cast<uintptr_t>(pages), pw = reinterpret_cast<uintptr_t>(windows);
  if (st->page_bytes % 16 == 0 && pp % 16 == 0 && pw % 16 == 0) {
    if (st->pieces <= 0 || st->grid <= 0 ||
        static_cast<long long>(st->pieces) * kPiece < st->page_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    constexpr int smem = kPiece * kStages;
    static bool smem_set = false;  // the attribute, set once
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          kv_page_write_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = true;
    }
    kv_page_write_bulk<<<st->grid, 32, smem, s>>>(*st, out, win, page_ids);
  } else if (st->page_bytes % 4 == 0 && pp % 4 == 0 && pw % 4 == 0) {
    kv_page_write_vec<uint32_t><<<dim3(1, st->W, st->L), kThreads, 0, s>>>(*st, out, win,
                                                                          page_ids);
  } else {
    kv_page_write_vec<unsigned char><<<dim3(1, st->W, st->L), kThreads, 0, s>>>(*st, out, win,
                                                                               page_ids);
  }
  return static_cast<int>(cudaGetLastError());
}
