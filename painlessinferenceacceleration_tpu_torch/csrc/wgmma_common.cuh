// What the tensor-core GEMM bodies share on Hopper (sm_90a): mbarriers with
// a watchdog, TMA copies of 2-d boxes against tensor maps made on the host,
// the fences between the generic and the async proxy, wgmma's shared-memory
// operand descriptors and group fences, the swizzled K-major operand layout,
// and the host side (the driver's tensor-map encoder reached through the
// runtime, the dynamic shared-memory limit). Included by the weight-only
// body (weight_only_wgmma.cuh: int4, int8), the W8A8 body (w8a8_wgmma.cuh)
// and the bf16 body (bf16_wgmma.cuh), which also takes the 3-d maps and
// copies, the counted mbarriers and the one-group wait below.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no driver library is linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace piawg {

constexpr int kSmemLimit = 232448;  // shared memory a block may use (227 KB)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// makes the initialised mbarriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces the bytes the stage's copies will bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A copy that
// never lands (a fault) traps after 4 seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
  }
}

// an mbarrier whose phase completes after `count` arrivals
__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival without bytes (a consumer releasing a ring slot)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a 3-d box of a tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// a 2-d box of a tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// this thread's shared-memory writes made visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma operand descriptor: K-major rows of RB = 128 (or 64) bytes in the
// RB-byte swizzle, 8-row groups 8 RB bytes apart (the leading offset is
// unused in these modes)
template <int RB>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * RB >> 4) << 32) | ((uint64_t)(RB == 128 ? 1 : 2) << 62);
}

// keeps the compiler from moving accesses of the accumulator across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// every committed group but the newest has completed
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Byte offset of the 16-byte chunk u of operand row `row` in a K-major tile
// of `rows` rows in the RB-byte swizzle: atoms of rows x RB bytes, each
// RB / 16 chunks wide; the chunk's slot is XORed with address bits 7-9
// (128-byte swizzle: row % 8) or 7-8 (64-byte: row / 2 % 4).
template <int RB>
__device__ __forceinline__ int sw_offset(int u, int row, int rows) {
  constexpr int kChunks = RB / 16;
  const int slot = RB == 128 ? (row & 7) : ((row >> 1) & 3);
  return (u / kChunks) * (rows * RB) + row * RB + (((u % kChunks) ^ slot) << 4);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-d map of a row-major matrix [rows, cols] of `elt`-byte elements, read
// in boxes of box_cols x box_rows; out-of-range elements read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                     int elt, uint64_t rows, uint64_t cols, uint32_t box_cols,
                     uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elt};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-d map of a row-major array [d2, d1, d0] of `elt`-byte elements, read
// in boxes of b0 x b1 x 1; out-of-range elements read as zeros.
inline bool make_map_3d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                        int elt, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t b0,
                        uint32_t b1, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * (uint64_t)elt, d0 * d1 * (uint64_t)elt};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets a kernel's dynamic shared memory limit once per device.
template <typename F>
inline cudaError_t allow_smem(F* kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace piawg
