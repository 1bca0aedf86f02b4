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
// Design. A (row, group) is cut into chunks of 16 bytes (8 bf16 or 4 fp32
// elements). `lanes` threads share it, a number fixed by the group's width
// and the element type alone (ops/rmsnorm.py norm_plan): 16 lanes for 128
// bf16 elements (two rows a warp), one warp up to 256 chunks (2048 bf16),
// then as many warps as keep a lane at 8 chunks or fewer. Lane l holds
// chunks l, l + lanes, l + 2 lanes, ... in registers between the sum of
// squares and the scaling (a kernel is built for 1, 2, 4 and 8 chunks a lane,
// so a narrow group keeps few registers), so each element comes from memory
// once; it loads and stores each chunk in 16-byte vectors where the
// pointers, the row stride and the group width allow, else one element at a
// time (a launch argument), which changes no sum. Each lane sums the squares of its own
// elements in ascending order (a zero past the group's end adds nothing);
// the lanes of a warp meet in a fixed xor butterfly (lanes / 2, ..., 1), and
// the warps of a wider row add their sums in warp order. The order depends
// on the group's width and type alone, never on the number of rows, the
// alignment or the load width, so a row's norm has the same bits at every
// batch width: the batch invariance that lookahead's lossless check needs.
// Every operation is an explicit round-to-nearest intrinsic, so the compiler
// cannot contract differently in different builds; the reciprocal square
// root is a correctly rounded square root and division
// (ops/rmsnorm.py rms_norm_replay repeats the order in torch ops on the CPU,
// bit for bit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// What a wrapper fixes for a type, width, grouping and weight
// (ops/rmsnorm.py _Static mirrors it field for field): dtype / w_dtype 0 =
// fp32, 1 = bf16; lanes (a power of two up to 32, or a multiple of 32 up
// to 512), n_chunks (chunks a lane, at most 8) and per_block (items a
// block) from norm_plan.
struct RmsNormStatic {
  int groups, gw, dtype, w_dtype, lanes, n_chunks, per_block;
  float eps;
};

namespace {

constexpr int kMaxChunks = 8;  // chunks a lane holds
constexpr int kMaxLanes = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int kBytes> struct Piece;
template <> struct Piece<16> { using type = uint4; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<4> { using type = uint32_t; };
template <> struct Piece<2> { using type = uint16_t; };

// kN elements of type T at p (kBytes-aligned) into v, in kBytes pieces; the
// pieces at or past `bytes` (the group's end) are zeros
template <typename T, int kN, int kBytes>
__device__ __forceinline__ void load_chunk(const T* p, T (&v)[kN], int bytes) {
  constexpr int kTotal = kN * static_cast<int>(sizeof(T));
  constexpr int kB = kBytes < kTotal ? kBytes : kTotal;
  using V = typename Piece<kB>::type;
  V* dst = reinterpret_cast<V*>(v);
  const V* src = reinterpret_cast<const V*>(p);
#pragma unroll
  for (int i = 0; i < kTotal / kB; ++i) dst[i] = i * kB < bytes ? src[i] : V{};
}

template <typename T, int kN, int kBytes>
__device__ __forceinline__ void store_chunk(T* p, const T (&v)[kN], int bytes) {
  constexpr int kTotal = kN * static_cast<int>(sizeof(T));
  constexpr int kB = kBytes < kTotal ? kBytes : kTotal;
  using V = typename Piece<kB>::type;
  const V* src = reinterpret_cast<const V*>(v);
  V* dst = reinterpret_cast<V*>(p);
#pragma unroll
  for (int i = 0; i < kTotal / kB; ++i)
    if (i * kB < bytes) dst[i] = src[i];
}

struct Params {
  const void* x;
  const void* w;
  const void* gate;
  void* out;
  int n_items, groups, gw;
  long long ldx;
  float eps;
  int lanes, n_chunks, per_block;
};

// kVec: bytes a piece of x, gate and out (16, or one element); kChunks: the
// chunks a lane holds at most (registers are allocated for that many)
template <typename T, typename W, int kVec, bool kGate, int kChunks>
__global__ void __launch_bounds__(kMaxLanes) rms_norm_kernel(const Params p) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  // the weight's pieces: as aligned as x's at the same element offsets
  constexpr int kWVec0 = kVec * static_cast<int>(sizeof(W)) / static_cast<int>(sizeof(T));
  constexpr int kWVec = kWVec0 < 16 ? kWVec0 : 16;
  __shared__ float part[32];  // a wider row's warp sums

  const T* x = static_cast<const T*>(p.x);
  const T* gate = static_cast<const T*>(p.gate);
  const int lanes = p.lanes, gw = p.gw, groups = p.groups;
  const int item_in_block = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int item = blockIdx.x * p.per_block + item_in_block;
  const bool valid = item < p.n_items;
  const int row = valid ? item / groups : 0, g = valid ? item % groups : 0;
  const T* xr = x + row * p.ldx + static_cast<long long>(g) * gw;
  const long long o = (static_cast<long long>(row) * groups + g) * gw;
  const int gbytes = gw * static_cast<int>(sizeof(T));

  // the gate is loaded with x where a lane holds few chunks (the gated
  // norms' groups of 128), else chunk by chunk at the scaling
  constexpr bool kGateFirst = kGate && kChunks <= 2;
  alignas(16) T xv[kChunks][kE];
  alignas(16) T gv[kGateFirst ? kChunks : 1][kE];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int e0 = (lane + k * lanes) * kE;
    const int bytes = valid && k < p.n_chunks ? gbytes - e0 * static_cast<int>(sizeof(T)) : 0;
    load_chunk<T, kE, kVec>(xr + e0, xv[k], bytes);
    if constexpr (kGateFirst) load_chunk<T, kE, kVec>(gate + o + e0, gv[k], bytes);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float v = to_f(xv[k][e]);
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
  const int warp_lanes = lanes < 32 ? lanes : 32;
  for (int off = warp_lanes / 2; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  if (lanes > 32) {
    const int warps = lanes / 32;
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = s;
    __syncthreads();
    const float* mine = part + item_in_block * warps;
    s = mine[0];
    for (int j = 1; j < warps; ++j) s = __fadd_rn(s, mine[j]);
  }
  if (!valid) return;
  const float mean = __fdiv_rn(s, static_cast<float>(gw));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, p.eps)));
  const W* wg = static_cast<const W*>(p.w) + static_cast<long long>(g) * gw;
  T* out = static_cast<T*>(p.out) + o;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int e0 = (lane + k * lanes) * kE;
    const int bytes = k < p.n_chunks ? gbytes - e0 * static_cast<int>(sizeof(T)) : 0;
    if (bytes <= 0) break;
    alignas(16) W wv[kE];
    load_chunk<W, kE, kWVec>(wg + e0, wv, bytes / static_cast<int>(sizeof(T)) *
                                              static_cast<int>(sizeof(W)));
    alignas(16) T gk[kE];
    if constexpr (kGate && !kGateFirst) load_chunk<T, kE, kVec>(gate + o + e0, gk, bytes);
    alignas(16) T y[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      T yt = from_f<T>(__fmul_rn(__fmul_rn(to_f(xv[k][e]), r), to_f(wv[e])));
      if constexpr (kGate) {
        const float gt = to_f(kGateFirst ? gv[k][e] : gk[e]);
        const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gt)));
        yt = from_f<T>(__fmul_rn(to_f(yt), sg));
      }
      y[e] = yt;
    }
    store_chunk<T, kE, kVec>(out + e0, y, bytes);
  }
}

template <typename T, typename W, int kVec, bool kGate, int kChunks>
int launch(const Params& p, cudaStream_t st) {
  const int blocks = (p.n_items + p.per_block - 1) / p.per_block;
  rms_norm_kernel<T, W, kVec, kGate, kChunks><<<blocks, p.per_block * p.lanes, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W, int kVec, bool kGate>
int by_chunks(const Params& p, cudaStream_t st) {
  if (p.n_chunks <= 1) return launch<T, W, kVec, kGate, 1>(p, st);
  if (p.n_chunks <= 2) return launch<T, W, kVec, kGate, 2>(p, st);
  if (p.n_chunks <= 4) return launch<T, W, kVec, kGate, 4>(p, st);
  return launch<T, W, kVec, kGate, kMaxChunks>(p, st);
}

template <typename T, typename W>
int by_vec(int vec, const Params& p, cudaStream_t st) {
  constexpr int kElt = static_cast<int>(sizeof(T));
  if (vec == 16)
    return p.gate ? by_chunks<T, W, 16, true>(p, st) : by_chunks<T, W, 16, false>(p, st);
  if (vec == kElt)
    return p.gate ? by_chunks<T, W, kElt, true>(p, st) : by_chunks<T, W, kElt, false>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [rows, groups*gw] with row stride ldx (elements; the last axis
// contiguous), w [groups*gw], gate (may be null; in x's type) and out
// [rows, groups*gw] contiguous; vec: bytes a load or store of x, gate and
// out, 16 where their pointers, row strides and gw's bytes (and the
// weight's pointer) allow, else one element.
extern "C" int rms_norm(const RmsNormStatic* s, const void* x, const void* w, const void* gate,
                        void* out, int rows, long long ldx, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = s->lanes, per_block = s->per_block;
  const bool pow2 = lanes > 0 && (lanes & (lanes - 1)) == 0;
  if (!(lanes <= 32 ? pow2 : lanes % 32 == 0 && lanes <= kMaxLanes) || s->n_chunks < 1 ||
      s->n_chunks > kMaxChunks || per_block < 1 || per_block * lanes > kMaxLanes ||
      (per_block * lanes) % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = {x,   w,     gate,  out,         rows * s->groups, s->groups, s->gw,
                    ldx, s->eps, lanes, s->n_chunks, per_block};
  if (s->dtype == 0 && s->w_dtype == 0) return by_vec<float, float>(vec, p, st);
  if (s->dtype == 0) return by_vec<float, __nv_bfloat16>(vec, p, st);
  if (s->w_dtype == 0) return by_vec<__nv_bfloat16, float>(vec, p, st);
  return by_vec<__nv_bfloat16, __nv_bfloat16>(vec, p, st);
}
