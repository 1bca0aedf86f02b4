// RMSNorm over rows, plain, grouped or gated, for Hopper (sm_90a) (K15).
//
//   y[r, g*gw + i] = x[r, g*gw + i] * rsqrt(mean_i(x[r, g*gw + i]^2) + eps)
//                    * w[g*gw + i]
//
// in fp32, cast to x's type; with a gate, y is then multiplied in fp32 by
// sigmoid(gate[r, g*gw + i]) and cast again (the JAX package's
// rms_group_norm_sigmoid rounds the normed value to x's type first).
// Replaces the Pallas body _rmsnorm_kernel of
// painlessinferenceacceleration_tpu/ops/rmsnorm.py, and serves its jnp forms
// rms_norm, rms_group_norm and rms_group_norm_sigmoid on the model path: the
// hidden norms (width 2048 to 7168), the per-head q/k norms and the grouped
// output norm of the linear-attention layers (width 128).
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (the gate read once more), a few operations each, far below the
// 295 operations a byte at which the tensor cores, let alone the CUDA
// cores, would be the limit.
//
// Design. One warp per (row, group). Lane l sums the squares of elements l,
// l + 32, l + 64, ... in ascending order, then the 32 partial sums meet in a
// fixed xor butterfly (16, 8, 4, 2, 1). The order depends on the group's
// width alone, never on the number of rows, so a row's norm has the same
// bits at every batch width: the batch invariance that lookahead's
// lossless check needs, with no exception. Every operation is an explicit
// round-to-nearest intrinsic, so the compiler cannot contract differently
// in different builds; the reciprocal square root is a correctly rounded
// square root and division, as torch computes rsqrt on the CPU. The second
// pass re-reads the row (from L1) to scale and store it: lanes touch
// consecutive elements, so loads and stores coalesce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kWarps * 32) rms_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ gate,
    T* __restrict__ out, int n_items, int groups, int gw, long long ldx, float eps) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int row = item / groups, g = item % groups;
  const T* xr = x + (long long)row * ldx + (long long)g * gw;
  float s = 0.f;
  for (int i = lane; i < gw; i += 32) {
    const float v = to_f(xr[i]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  s = __shfl_sync(kFull, s, 0);
  const float mean = __fdiv_rn(s, (float)gw);
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, eps)));
  const long long o = (long long)row * groups * gw + (long long)g * gw;
  const W* wg = w + (long long)g * gw;
  for (int i = lane; i < gw; i += 32) {
    const float y = __fmul_rn(__fmul_rn(to_f(xr[i]), r), to_f(wg[i]));
    T yt = from_f<T>(y);
    if (gate != nullptr) {
      const float gt = to_f(gate[o + i]);
      const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gt)));
      yt = from_f<T>(__fmul_rn(to_f(yt), sg));
    }
    out[o + i] = yt;
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* gate, void* out, int rows,
           int groups, int gw, long long ldx, float eps, cudaStream_t st) {
  const int n_items = rows * groups;
  const int blocks = (n_items + kWarps - 1) / kWarps;
  rms_norm_kernel<T, W><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(gate),
      static_cast<T*>(out), n_items, groups, gw, ldx, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [rows, groups*gw] with row stride ldx (elements; the last axis
// contiguous), w [groups*gw], gate (may be null) and out [rows, groups*gw]
// contiguous; dtype / w_dtype 0 = fp32, 1 = bf16 (gate in x's type).
extern "C" int rms_norm(const void* x, const void* w, const void* gate, void* out,
                        int rows, int groups, int gw, long long ldx, float eps,
                        int dtype, int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, gate, out, rows, groups, gw, ldx, eps, st);
  if (dtype == 0)
    return launch<float, __nv_bfloat16>(x, w, gate, out, rows, groups, gw, ldx, eps, st);
  if (w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, gate, out, rows, groups, gw, ldx, eps, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, gate, out, rows, groups, gw, ldx,
                                               eps, st);
}
