// In-place tail-window KV compaction for Hopper (sm_90a), over all layers.
//
//   pages[l, page_ids[b, w / ps], w % ps] = win[b, l][src_rel[b, w]]
//
// where win[b, l] is the window as it was before the call. Replaces the
// Pallas body _permute_kernel of
// painlessinferenceacceleration_tpu/ops/kv_update.py; it is called once for
// K and once for V after every verify step.
//
// What bounds it on the H100: the bytes of the rows that move, each source
// read once and each destination written once (2 * L * moved rows of
// Hkv*D elements), plus the indices. Rows whose source is themselves cost
// nothing, so the identity permute of a one-branch verify step moves no row
// bytes. One layer's window (~1 MB at 7B) does not fit shared memory, so
// each block owns one (request, layer, 256-byte column chunk): it stages the
// source of every moving row of its chunk with 16-byte loads, synchronises,
// then writes those rows. When the page-table clip makes two window slots
// name the same page, only the later slot writes it (the order in which the
// Pallas kernel's DMAs land), so the result is defined.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // bytes of a row per block
constexpr int kVecs = kChunk / 16;

// Window slot w is written iff its row moves and no later slot names the
// same page. An unmoved row's bytes are already in place; an aliased page
// keeps the later slot's rows.
__device__ __forceinline__ bool writes_row(const int* ids, const int* srcs,
                                           int w, int ps, int TPP) {
  if (srcs[w] == w) return false;
  const int t = w / ps;
  for (int t2 = t + 1; t2 < TPP; ++t2)
    if (ids[t2] == ids[t]) return false;
  return true;
}

__global__ void __launch_bounds__(kThreads) kv_permute_kernel(
    unsigned char* __restrict__ pages, const int* __restrict__ page_ids,
    const int* __restrict__ src_rel, int n_pages, int ps, int row_bytes,
    int TPP) {
  extern __shared__ uint4 stage[];  // [W][kVecs], slot w holds w's source
  const int W = TPP * ps;
  const int b = blockIdx.z;
  const int l = blockIdx.y;
  const int c0 = blockIdx.x * kChunk;
  const int nv = min(kChunk, row_bytes - c0) / 16;
  const size_t layer_off = (size_t)l * n_pages * ps * row_bytes;
  const int* ids = page_ids + (size_t)b * TPP;
  const int* srcs = src_rel + (size_t)b * W;

  for (int e = threadIdx.x; e < W * kVecs; e += kThreads) {
    const int w = e / kVecs, v = e % kVecs;
    if (v >= nv || !writes_row(ids, srcs, w, ps, TPP)) continue;
    const int src = srcs[w];
    const size_t row = (size_t)ids[src / ps] * ps + src % ps;
    stage[e] = reinterpret_cast<const uint4*>(pages + layer_off +
                                              row * row_bytes + c0)[v];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < W * kVecs; e += kThreads) {
    const int w = e / kVecs, v = e % kVecs;
    if (v >= nv || !writes_row(ids, srcs, w, ps, TPP)) continue;
    const size_t row = (size_t)ids[w / ps] * ps + w % ps;
    reinterpret_cast<uint4*>(pages + layer_off + row * row_bytes + c0)[v] =
        stage[e];
  }
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pages [L, n_pages, ps, row_bytes] (any element type, row_bytes % 16 == 0);
// page_ids int32 [B, TPP]; src_rel int32 [B, TPP*ps] with values in
// [0, TPP*ps).
extern "C" int kv_permute_pages(void* pages, const void* page_ids,
                                const void* src_rel, int L, int B,
                                int n_pages, int ps, int row_bytes, int TPP,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)TPP * ps * kChunk;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kv_permute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((row_bytes + kChunk - 1) / kChunk, L, B);
  kv_permute_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<unsigned char*>(pages), static_cast<const int*>(page_ids),
      static_cast<const int*>(src_rel), n_pages, ps, row_bytes, TPP);
  return static_cast<int>(cudaGetLastError());
}
