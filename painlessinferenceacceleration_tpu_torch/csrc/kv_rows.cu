// KV row write and KV row move for Hopper (sm_90a).
//
// kv_write_rows (K16):
//
//   pages_a[layer, page_idx[i], row_idx[i]] = rows_a[i]    for i < N
//
// for up to four arenas a at once (K and V, and in fp8_tok mode their
// per-token scale arenas), which share the indices. Replaces the Pallas
// body _write_kernel (kv_write_rows) of
// painlessinferenceacceleration_tpu/ops/kv_update.py, the row scatter that
// ends write_kv_pages (engine/cache.py): every layer of every forward writes
// its new K/V rows through it, in one launch a layer.
//
// kv_move_rows (K17):
//
//   pages[l, dst_page[i], dst_row[i]] = pages[l, src_page[i], src_row[i]]
//
// for every layer l and i < N, every source read before any destination is
// written (the gather-then-set semantics of move_kv_rows in the JAX
// package's engine/cache.py). Replaces the Pallas body _move_kernel
// (kv_move_rows_pallas) of the same file.
//
// Rows are opaque bytes, so both serve bf16 / fp32 rows, e4m3 rows and f32
// scale rows alike. When two rows (K16) or two moves (K17) name one
// destination, the later one is kept, as the Pallas DMAs land in order; in
// practice only the null page 0 is named twice (invalid rows, masked moves).
//
// What bounds both on the H100: the bytes moved, each source row read once
// and each destination row written once, plus the int32 indices. Designs:
// K16 gives each row one warp, which copies it with 16-byte vectors where
// the row's byte width and pointers allow (else 4-byte words, else bytes)
// for every arena; a block of 8 warps first stages the indices of the later
// rows in shared memory, 256 at a time, to find the rows that a later row
// overwrites (those write nothing). K17 gives each block one (layer, column
// slice): the block stages the slice of all N source rows in shared memory,
// synchronises, then writes every destination that no later move names, so
// within a layer and column every read precedes every write and a chain
// (one move's destination another's source) needs no second launch. N times
// the slice must fit the block's shared memory; the wrapper picks the slice
// and raises past the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxArenas = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyChunk = kThreads;  // later rows' indices staged per round
constexpr int kMaxMoves = 1024;      // K17's moves per launch

__host__ __device__ constexpr size_t move_index_bytes(int N) {
  return ((size_t)N * 8 + 15) / 16 * 16;
}

struct Arena {
  unsigned char* pages;       // [L, n_pages, ps, row_bytes]
  const unsigned char* rows;  // [N] rows, rows_stride bytes apart
  long long row_bytes;
  long long rows_stride;
  int vec;                    // 16, 4 or 1 bytes per copy
};

struct Arenas {
  Arena a[kMaxArenas];
  int n;
};

template <typename T>
__device__ __forceinline__ void copy_row(unsigned char* dst, const unsigned char* src,
                                         long long nbytes, int lane) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const long long n = nbytes / (long long)sizeof(T);
  for (long long e = lane; e < n; e += 32) d[e] = s[e];
}

__global__ void __launch_bounds__(kThreads) kv_write_rows_kernel(
    Arenas arenas, const int* __restrict__ page_idx, const int* __restrict__ row_idx,
    int N, int layer, int n_pages, int ps) {
  __shared__ int keys[kKeyChunk];  // destination rows (page * ps + row)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * kWarps;
  const int i = i0 + warp;
  const int my_key = i < N ? page_idx[i] * ps + row_idx[i] : -1;
  // does a later row name this row's destination? (block-uniform loop)
  bool later = false;
  for (int c = i0 + 1; c < N; c += kKeyChunk) {
    __syncthreads();
    const int j = c + threadIdx.x;
    if (j < N) keys[threadIdx.x] = page_idx[j] * ps + row_idx[j];
    __syncthreads();
    if (i < N && !later) {  // warp-uniform
      const int n = min(kKeyChunk, N - c);
      bool hit = false;
      for (int t = lane; t < n; t += 32) hit |= c + t > i && keys[t] == my_key;
      later = __any_sync(0xffffffffu, hit);
    }
  }
  if (i >= N || later) return;
  const long long slot = (long long)layer * n_pages * ps + my_key;
#pragma unroll
  for (int k = 0; k < kMaxArenas; ++k) {
    if (k >= arenas.n) break;
    const Arena ar = arenas.a[k];
    unsigned char* dst = ar.pages + slot * ar.row_bytes;
    const unsigned char* src = ar.rows + (long long)i * ar.rows_stride;
    if (ar.vec == 16)
      copy_row<uint4>(dst, src, ar.row_bytes, lane);
    else if (ar.vec == 4)
      copy_row<uint32_t>(dst, src, ar.row_bytes, lane);
    else
      copy_row<unsigned char>(dst, src, ar.row_bytes, lane);
  }
}

// One block per (column slice, layer): stage, synchronise, write.
template <typename T>
__global__ void __launch_bounds__(kThreads) kv_move_rows_kernel(
    unsigned char* __restrict__ pages, const int* __restrict__ src_page,
    const int* __restrict__ src_row, const int* __restrict__ dst_page,
    const int* __restrict__ dst_row, int N, int n_pages, int ps, long long row_bytes,
    int slice_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* src = reinterpret_cast<int*>(smem);  // [N] source rows (page * ps + row)
  int* dst = src + N;                       // [N] destination rows, -1: not written
  T* stage = reinterpret_cast<T*>(smem + move_index_bytes(N));  // [N][slice]
  const int l = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * slice_bytes;
  const int nv = (int)(min((long long)slice_bytes, row_bytes - c0) / (long long)sizeof(T));
  const int per_row = slice_bytes / (int)sizeof(T);
  unsigned char* layer_base = pages + (long long)l * n_pages * ps * row_bytes + c0;

  for (int i = threadIdx.x; i < N; i += kThreads) {
    src[i] = src_page[i] * ps + src_row[i];
    dst[i] = dst_page[i] * ps + dst_row[i];
  }
  __syncthreads();
  // a destination that a later move names again keeps the later move's row
  int later[(kMaxMoves + kThreads - 1) / kThreads];
#pragma unroll
  for (int u = 0; u < (kMaxMoves + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    later[u] = 0;
    if (i < N)
      for (int j = i + 1; j < N; ++j)
        if (dst[j] == dst[i]) {
          later[u] = 1;
          break;
        }
  }
  for (int e = threadIdx.x; e < N * per_row; e += kThreads) {
    const int i = e / per_row, v = e % per_row;
    if (v < nv) stage[e] = reinterpret_cast<const T*>(layer_base + src[i] * row_bytes)[v];
  }
  __syncthreads();  // every read of this (layer, slice) before any write
#pragma unroll
  for (int u = 0; u < (kMaxMoves + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < N && later[u]) dst[i] = -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * per_row; e += kThreads) {
    const int i = e / per_row, v = e % per_row;
    if (v < nv && dst[i] >= 0)
      reinterpret_cast<T*>(layer_base + dst[i] * row_bytes)[v] = stage[e];
  }
}

int vec_of(const void* a, const void* b, long long n, long long stride) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a), pb = reinterpret_cast<uintptr_t>(b);
  if (n % 16 == 0 && stride % 16 == 0 && pa % 16 == 0 && pb % 16 == 0) return 16;
  if (n % 4 == 0 && stride % 4 == 0 && pa % 4 == 0 && pb % 4 == 0) return 4;
  return 1;
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n_arenas <= 4; pages[k] [L, n_pages, ps, row_bytes[k]] and rows[k]
// [N] rows rows_stride[k] bytes apart (host arrays of device pointers);
// page_idx, row_idx int32 [N] on the device.
extern "C" int kv_write_rows(int n_arenas, void* const* pages, const void* const* rows,
                             const long long* row_bytes, const long long* rows_stride,
                             const void* page_idx, const void* row_idx, int N, int layer,
                             int n_pages, int ps, void* stream) {
  if (N == 0 || n_arenas == 0) return 0;
  if (n_arenas > kMaxArenas) return static_cast<int>(cudaErrorInvalidValue);
  Arenas ar;
  ar.n = n_arenas;
  for (int k = 0; k < n_arenas; ++k) {
    ar.a[k].pages = static_cast<unsigned char*>(pages[k]);
    ar.a[k].rows = static_cast<const unsigned char*>(rows[k]);
    ar.a[k].row_bytes = row_bytes[k];
    ar.a[k].rows_stride = rows_stride[k];
    ar.a[k].vec = vec_of(pages[k], rows[k], row_bytes[k], rows_stride[k]);
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  kv_write_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ar, static_cast<const int*>(page_idx), static_cast<const int*>(row_idx), N, layer,
      n_pages, ps);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one block of kv_move_rows may take on the current device.
extern "C" int kv_move_rows_smem_limit(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// pages [L, n_pages, ps, row_bytes] bytes; the four index arrays int32 [N] on
// the device, N <= 1024. unit (16, 4 or 1) divides row_bytes and slice_bytes;
// the block's shared memory, the 2N int32 row numbers (padded to 16 bytes)
// and N * slice_bytes, must not pass kv_move_rows_smem_limit (checked, as N:
// cudaErrorInvalidValue).
extern "C" int kv_move_rows(void* pages, const void* src_page, const void* src_row,
                            const void* dst_page, const void* dst_row, int N, int L,
                            int n_pages, int ps, long long row_bytes, int slice_bytes,
                            int unit, void* stream) {
  if (N == 0 || L == 0) return 0;
  const size_t smem = move_index_bytes(N) + (size_t)N * slice_bytes;
  const int limit = kv_move_rows_smem_limit();
  if (N > kMaxMoves || limit < 0 || smem > (size_t)limit || slice_bytes % unit ||
      row_bytes % unit ||
      reinterpret_cast<uintptr_t>(pages) % unit)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)((row_bytes + slice_bytes - 1) / slice_bytes), L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<unsigned char*>(pages);
  auto* sp = static_cast<const int*>(src_page);
  auto* sr = static_cast<const int*>(src_row);
  auto* dp = static_cast<const int*>(dst_page);
  auto* dr = static_cast<const int*>(dst_row);
#define PIA_MOVE(T)                                                                  \
  do {                                                                               \
    cudaError_t e = cudaFuncSetAttribute(kv_move_rows_kernel<T>,                      \
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                         (int)smem);                                 \
    if (e != cudaSuccess) return static_cast<int>(e);                                \
    kv_move_rows_kernel<T><<<grid, kThreads, smem, st>>>(base, sp, sr, dp, dr, N,     \
                                                         n_pages, ps, row_bytes,     \
                                                         slice_bytes);               \
  } while (0)
  if (unit == 16)
    PIA_MOVE(uint4);
  else if (unit == 4)
    PIA_MOVE(uint32_t);
  else
    PIA_MOVE(unsigned char);
#undef PIA_MOVE
  return static_cast<int>(cudaGetLastError());
}
