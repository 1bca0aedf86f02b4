// One-dimensional bulk asynchronous copies on Hopper (sm_90a): the Tensor
// Memory Accelerator moving a contiguous run of bytes between device memory
// and shared memory without a tensor map. A load lands in shared memory and
// counts its bytes on an mbarrier (wgmma_common.cuh); a store reads shared
// memory and is tracked by the issuing thread's bulk groups. Addresses on
// both sides start on 16-byte boundaries and sizes are multiples of 16
// bytes. Used by the KV row kernels (kv_permute.cu, kv_page_write.cu,
// kv_rows.cu).

#pragma once

#include "wgmma_common.cuh"

namespace pia_bulk {

// `bytes` from device memory at `src` to shared memory at `dst`, counted on
// the mbarrier `bar`
__device__ __forceinline__ void load(uint32_t dst, const void* src, uint32_t bytes,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from shared memory at `src` to device memory at `dst`, in this
// thread's open bulk group
__device__ __forceinline__ void store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
               : "memory");
}

// closes this thread's open bulk group
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until this thread's bulk stores have read their shared memory (the
// block may then reuse it or exit; the device writes finish with the grid)
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the same for all but this thread's newest bulk group
__device__ __forceinline__ void wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

}  // namespace pia_bulk
