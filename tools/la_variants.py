#!/usr/bin/env python3
"""K14 chunk mode's products on the card: 3xTF32 on the tensor cores (the
kernel's choice), plain TF32, and fp32 on the CUDA cores, on one card:

    python3 tools/la_variants.py [--json PATH]

Each variant computes what the chunk mode's output pass spends most of its
products on, q [64, 128] times the state a tile enters with [128, 128], for
the 1536 tiles of a B = 2 (4096 + 2048 tokens), H = 16 chunk: both operands
staged in shared memory by cp.async as ``csrc/linear_attention.cu`` stages
them (rows padded by 4 and 8 floats), 8 warps a block, the product written
out. Variants: ``tf32x3`` (mma.sync m16n8k8, each operand split into a TF32
high part and residual, three products; the kernel's fragments and split),
``tf32`` (one product of the high parts: ~3 decimal digits), ``fp32`` (a
register tile of 4 x 8 outputs a thread, fma on the CUDA cores). Prints,
for each, ms under CUDA events (the median of 5 windows of 20 launches, in
turns, the L2 warm) and the largest error against an fp64 product
relative to the largest value; and the card's name and power limit. The
source is built by nvcc into ``build/la_variants/``. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
TILES, M, K, N = 1536, 64, 128, 128

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int QS = K_ + 4, VS = N_ + 8;
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}
__device__ void stage(float* as, float* bs, const float* a, const float* b) {
  for (int p = threadIdx.x; p < M_ * K_ / 4; p += 256) {
    const int i = p / (K_ / 4), c = (p % (K_ / 4)) * 4;
    cp16(as + i * QS + c, a + i * K_ + c);
  }
  for (int p = threadIdx.x; p < K_ * N_ / 4; p += 256) {
    const int i = p / (N_ / 4), c = (p % (N_ / 4)) * 4;
    cp16(bs + i * VS + c, b + i * N_ + c);
  }
  asm volatile("cp.async.commit_group;");
  asm volatile("cp.async.wait_group 0;");
  __syncthreads();
}
template <int kProducts>
__global__ void __launch_bounds__(256) prod_mma(const float* a, const float* b, float* c) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = as + M_ * QS;
  const long long t = blockIdx.x;
  stage(as, bs, a + t * M_ * K_, b + t * K_ * N_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int i0 = (warp & 3) * 16, n0 = (warp >> 2) * (N_ / 2);
  float acc[N_ / 16][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < K_; k0 += 8) {
    uint32_t ah[4], al[4];
    const float* ap = as + i0 * QS + k0;
    split(ap[g * QS + t4], ah[0], al[0]);
    split(ap[(g + 8) * QS + t4], ah[1], al[1]);
    split(ap[g * QS + t4 + 4], ah[2], al[2]);
    split(ap[(g + 8) * QS + t4 + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < N_ / 16; ++j) {
      const float* bp = bs + k0 * VS + n0 + j * 8;
      uint32_t bh[2], bl[2];
      split(bp[t4 * VS + g], bh[0], bl[0]);
      split(bp[(t4 + 4) * VS + g], bh[1], bl[1]);
      if (kProducts == 3) {
        mma(acc[j], al, bh);
        mma(acc[j], ah, bl);
      }
      mma(acc[j], ah, bh);
    }
  }
  float* cp = c + t * M_ * N_;
#pragma unroll
  for (int j = 0; j < N_ / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(cp + (i0 + g + 8 * h) * N_ + n0 + j * 8 + 2 * t4) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
}
__global__ void __launch_bounds__(256) prod_fp32(const float* a, const float* b, float* c) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = as + M_ * QS;
  const long long t = blockIdx.x;
  stage(as, bs, a + t * M_ * K_, b + t * K_ * N_);
  const int r0 = (threadIdx.x / 16) * 4, c0 = (threadIdx.x % 16) * 8;
  float acc[4][8] = {};
#pragma unroll 4
  for (int k = 0; k < K_; ++k) {
    float av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = as[(r0 + i) * QS + k];
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * VS + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * VS + c0 + 4);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  float* cp = c + t * M_ * N_;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(cp + (r0 + i) * N_ + c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(cp + (r0 + i) * N_ + c0 + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}
}  // namespace
extern "C" int run(int variant, const void* a, const void* b, void* c, int tiles, void* stream) {
  const int smem = (M_ * QS + K_ * VS) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pc = static_cast<float*>(c);
  if (variant == 0) {
    cudaFuncSetAttribute(prod_mma<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    prod_mma<3><<<tiles, 256, smem, s>>>(pa, pb, pc);
  } else if (variant == 1) {
    cudaFuncSetAttribute(prod_mma<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    prod_mma<1><<<tiles, 256, smem, s>>>(pa, pb, pc);
  } else {
    cudaFuncSetAttribute(prod_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    prod_fp32<<<tiles, 256, smem, s>>>(pa, pb, pc);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

VARIANTS = ("tf32x3", "tf32", "fp32")


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(HERE))
    from painlessinferenceacceleration_tpu_torch import _build

    out = HERE / "build" / "la_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "la_products.cu"
    src.write_text(f"#define M_ {M}\n#define K_ {K}\n#define N_ {N}\n" + SOURCE)
    lib = out / "libla_products.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   timeout=600)
    dll = ctypes.CDLL(str(lib))
    dll.run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    return dll


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write the results here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/la_variants.py needs a CUDA card")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    dll = build()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    a = torch.nn.functional.silu(torch.randn(TILES, M, K, generator=g, device="cuda") * 0.5)
    b = torch.randn(TILES, K, N, generator=g, device="cuda") * 0.1
    ref = torch.bmm(a.double(), b.double())
    outs = {v: torch.empty(TILES, M, N, device="cuda") for v in VARIANTS}
    stream = torch.cuda.current_stream().cuda_stream

    def call(i, v):
        err = dll.run(i, a.data_ptr(), b.data_ptr(), outs[v].data_ptr(), TILES, stream)
        if err:
            raise RuntimeError(f"{v}: CUDA error {err}")

    times = {v: [] for v in VARIANTS}
    for _ in range(5):
        for i, v in enumerate(VARIANTS):
            times[v].append(cs.time_ms(lambda i=i, v=v: call(i, v), reps=20))
    res = dict(card=cs.smi_line(), tiles=TILES, shape=[M, K, N], variants={})
    for v in VARIANTS:
        err = ((outs[v].double() - ref).abs().max() / ref.abs().max()).item()
        res["variants"][v] = dict(ms=statistics.median(times[v]), max_rel_err=err)
        print(json.dumps(dict(variant=v, **res["variants"][v])))
    print(res["card"])
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
