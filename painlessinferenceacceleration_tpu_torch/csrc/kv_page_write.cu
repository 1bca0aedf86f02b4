// Whole-page KV write-back for Hopper (sm_90a), over all layers.
//
//   pages[l, page_ids[w]] = windows[l, w]    for every layer l, window page w
//
// Replaces the Pallas body _page_write_kernel of
// painlessinferenceacceleration_tpu/ops/kv_update.py (kv_write_pages_pallas).
// Lookahead compaction of an e4m3 arena and of the per-token scale arenas
// gathers each request's tail-window rows into a separate tensor and writes
// the window's pages back through this kernel (engine/cache.py). Pages are
// opaque bytes, so one kernel serves e4m3 K/V rows and f32 scale rows.
//
// What bounds it on the H100: the bytes moved, each window page read once
// and each destination page written once, 2 * L * W * ps * row_bytes, plus
// the W page ids. Design: one block per (window page, layer) copies the
// page's ps * row_bytes contiguous bytes with 16-byte loads and stores,
// four loads in flight per thread (a byte loop where the page or a pointer
// is not 16-byte aligned). When two window pages name the same destination
// (the page-table clip, or the null page 0 that inactive rows write), only
// the later one writes it, as the Pallas kernel's DMAs land in order, so
// the result is defined.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads) kv_page_write_kernel(
    unsigned char* __restrict__ pages, const unsigned char* __restrict__ windows,
    const int* __restrict__ page_ids, int n_pages, int W, size_t page_bytes,
    int vec) {
  const int w = blockIdx.x;
  const int l = blockIdx.y;
  const int dst = page_ids[w];
  for (int w2 = w + 1; w2 < W; ++w2)
    if (page_ids[w2] == dst) return;  // a later window page owns dst
  const unsigned char* src = windows + ((size_t)l * W + w) * page_bytes;
  unsigned char* out = pages + ((size_t)l * n_pages + dst) * page_bytes;
  if (vec) {
    // kUnroll loads in flight per thread before their stores
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    const size_t n4 = page_bytes / 16;
    for (size_t e = threadIdx.x; e < n4; e += kUnroll * kThreads) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = e + (size_t)u * kThreads;
        if (i < n4) r[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = e + (size_t)u * kThreads;
        if (i < n4) o4[i] = r[u];
      }
    }
  } else {
    for (size_t e = threadIdx.x; e < page_bytes; e += kThreads) out[e] = src[e];
  }
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pages [L, n_pages, page_bytes] and windows [L, W, page_bytes] as bytes
// (any element type); page_ids int32 [W] with values in [0, n_pages).
extern "C" int kv_page_write(void* pages, const void* windows,
                             const void* page_ids, int L, int W, int n_pages,
                             long long page_bytes, void* stream) {
  if (W == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = page_bytes % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(pages) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(windows) % 16 == 0;
  dim3 grid(W, L);
  kv_page_write_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<unsigned char*>(pages),
      static_cast<const unsigned char*>(windows),
      static_cast<const int*>(page_ids), n_pages, W, (size_t)page_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}
