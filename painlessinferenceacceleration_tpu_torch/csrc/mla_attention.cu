// Multi-head Latent Attention over the fused [latent | roped k_pe] page
// arena, for Hopper (sm_90a): decode, tree verify and causal prefill.
//
// Replaces the Pallas body _mla_kernel of
// painlessinferenceacceleration_tpu/ops/mla_attention.py. MLA in latent mode
// is MQA: every query row (request b, in-step position t, head h; row
// r = t * H + h) attends the same single-"head" K rows of Dk lanes, and the
// value of a key is the first Dv lanes of its K row (the latent), so only
// the K arena is read:
//
//   out[b, r] = sum_j p_j * K[j, :Dv] / sum_j p_j,  p_j = exp(s_j - m),
//   s_j = scale * q[b, r] . K[j]   over the visible keys j:
//     j < ctx, or s = j - ctx in [0, Q) and qmask[b, t, s] (causal: s <= t;
//     Q = 1: j <= ctx).
//
// The scale multiplies the fp32 scores (the Pallas wrapper rounds q * scale
// to bf16 first; the port's kernel and plain version both scale the fp32
// scores). A row with no visible key gives zeros. Keys past the request's
// window (j >= ctx + Q) are never read: their staged rows are zeros.
//
// What bounds it on the H100: at decode and verify the K bytes read,
// (ctx + Q) * Dk * 2 B per request and layer (each row tile re-reads them,
// from L2 after the first); at prefill the multiply-adds, 2 * rows * keys *
// (Dk + Dv) per request, on CUDA cores here (wgmma, TMA and splitting the
// context across blocks are later work: at B = 1 decode the 16 rows of one
// request are one block on one of 132 SMs).
//
// Design: one block per (row tile of 16 rows, request). The block walks the
// keys in tiles of 64 (absolute positions: tile i holds keys 64i..64i+63,
// whatever the page size), staging each tile's K rows in shared memory once
// for all 16 rows (rows padded to an odd number of words, so a warp reading
// 32 keys hits 32 banks). Scores: a thread owns one key and 4 rows, the dot
// over Dk in ascending lane order. Softmax: a warp owns 2 rows, fp32 online
// max and sum over the tile by fixed butterflies. P @ V: a thread owns 2
// adjacent V lanes of all 16 rows (the fp32 accumulator, 512 lanes a row),
// keys in ascending order. A row's arithmetic depends only on its own q row
// and the keys it sees: not on Q, B, the row tile it falls in, or how many
// tiles the block walks (a tile with no visible key leaves m, l and the
// accumulator unchanged bit for bit: its probabilities are exactly 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;   // query rows per block
constexpr int kKeyTile = 64;   // keys staged at a time
constexpr int kRowsPerThread = kRowTile * kKeyTile / kThreads;  // scores: 4
constexpr int kMaxDv = 2 * kThreads;  // P @ V: 2 lanes a thread

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int padded_words(int Dk) { return Dk / 2 + 1; }

size_t smem_bytes(int Dk) {
  return (size_t)kKeyTile * padded_words(Dk) * 4 + (size_t)kRowTile * (Dk / 2) * 4 +
         (size_t)kKeyTile * kRowTile * 4 + 3 * kRowTile * 4;
}

__global__ void __launch_bounds__(kThreads) mla_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const int* __restrict__ page_tables, const int* __restrict__ ctx_lens,
    const uint8_t* __restrict__ qmask, __nv_bfloat16* __restrict__ out, int Q,
    int H, int Dk, int Dv, int ps, int P, float scale, int causal) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int KW = padded_words(Dk);  // odd: conflict-free key-parallel reads
  const int DW = Dk / 2;
  uint32_t* k_s = smem;                    // [kKeyTile][KW] bf16 pairs
  uint32_t* q_s = k_s + kKeyTile * KW;     // [kRowTile][DW] bf16 pairs
  float* p_s = reinterpret_cast<float*>(q_s + kRowTile * DW);  // [key][row]
  float* m_s = p_s + kKeyTile * kRowTile;  // [kRowTile] running max
  float* l_s = m_s + kRowTile;             // [kRowTile] running sum
  float* a_s = l_s + kRowTile;             // [kRowTile] this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int R = Q * H;
  const int r0 = blockIdx.x * kRowTile;
  const int nr = min(kRowTile, R - r0);
  const int ctx = ctx_lens[b];
  const int n_keys = ctx + Q;  // the request's window: keys 0 .. ctx+Q-1
  const int t_last = (r0 + nr - 1) / H;
  const int last_key = causal ? ctx + t_last : n_keys - 1;
  const int n_tiles = last_key / kKeyTile + 1;

  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + ((size_t)b * R + r0) * Dk);
  for (int e = tid; e < kRowTile * DW; e += kThreads)
    q_s[e] = e / DW < nr ? qw[e] : 0u;
  if (tid < kRowTile) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // scores: key sj of the tile, rows 4 * sg .. 4 * sg + 3 (one row group a warp pair)
  const int sj = tid % kKeyTile;
  const int sg = tid / kKeyTile;
  // P @ V: V lanes 2 * tid, 2 * tid + 1
  const bool pv_on = 2 * tid < Dv;
  float acc[kRowTile][2];
#pragma unroll
  for (int i = 0; i < kRowTile; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int VPR = Dk / 8;  // 16-byte loads per K row
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = tile * kKeyTile;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kKeyTile * VPR; e += kThreads) {
      const int jj = e / VPR, v = e % VPR;
      const int j = j0 + jj;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < n_keys) {
        const int page = page_tables[(size_t)b * P + min(j / ps, P - 1)];
        val = reinterpret_cast<const uint4*>(
            k_pages + ((size_t)page * ps + j % ps) * Dk)[v];
      }
      uint32_t* d = k_s + jj * KW + v * 4;
      d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
    }
    __syncthreads();

    {  // scores of key sj against the group's 4 rows, masked
      const uint32_t* kr = k_s + sj * KW;
      const uint32_t* qr = q_s + sg * kRowsPerThread * DW;
      float s[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) s[i] = 0.f;
      for (int w = 0; w < DW; ++w) {
        const float2 kf = bf16x2_to_float2(kr[w]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float2 qf = bf16x2_to_float2(qr[i * DW + w]);
          s[i] = fmaf(qf.x, kf.x, s[i]);
          s[i] = fmaf(qf.y, kf.y, s[i]);
        }
      }
      const int j = j0 + sj;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = sg * kRowsPerThread + i;
        const int t = (r0 + row) / H;
        bool vis = false;
        if (row < nr && j < n_keys) {
          const int sidx = j - ctx;
          if (sidx < 0)
            vis = true;
          else if (Q == 1)
            vis = sidx == 0;
          else if (causal)
            vis = sidx <= t;
          else
            vis = qmask[((size_t)b * Q + t) * Q + sidx] != 0;
        }
        p_s[sj * kRowTile + row] = vis ? s[i] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 2w and 2w + 1
#pragma unroll
    for (int i = 0; i < kRowTile / kWarps; ++i) {
      const int row = warp * (kRowTile / kWarps) + i;
      const float s0 = p_s[lane * kRowTile + row];
      const float s1 = p_s[(lane + 32) * kRowTile + row];
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      p_s[lane * kRowTile + row] = p0;
      p_s[(lane + 32) * kRowTile + row] = p1;
      if (lane == 0) {
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    if (pv_on) {  // acc = acc * alpha + sum_j p_j V[j], keys ascending
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) {
        const float al = a_s[i];
        acc[i][0] *= al;
        acc[i][1] *= al;
      }
      const int n_jj = min(kKeyTile, last_key - j0 + 1);
      for (int jj = 0; jj < n_jj; ++jj) {
        const float2 v = bf16x2_to_float2(k_s[jj * KW + tid]);
        const float4* pr = reinterpret_cast<const float4*>(p_s + jj * kRowTile);
#pragma unroll
        for (int g = 0; g < kRowTile / 4; ++g) {
          const float4 p4 = pr[g];
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[4 * g + u][0] = fmaf(pp[u], v.x, acc[4 * g + u][0]);
            acc[4 * g + u][1] = fmaf(pp[u], v.y, acc[4 * g + u][1]);
          }
        }
      }
    }
  }

  if (pv_on) {
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      if (i >= nr) break;
      const float l = l_s[i];
      const float o0 = l > 0.f ? acc[i][0] / l : 0.f;
      const float o1 = l > 0.f ? acc[i][1] / l : 0.f;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)b * R + r0 + i) * Dv);
      o[tid] = __floats2bfloat162_rn(o0, o1);
    }
  }
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q bf16 [B, Q, H, Dk] (rows r = t * H + h contiguous); k_pages bf16
// [n_pages, ps, Dk] (one layer, one shared head); page_tables int32 [B, P];
// ctx_lens int32 [B]; qmask uint8 [B, Q, Q] (ignored when causal or Q = 1);
// out bf16 [B, Q, H, Dv], Dv = the leading K lanes that are V. Requires
// Dk % 8 == 0, Dv even, Dv <= min(Dk, 512), k_pages on a 16-byte boundary.
extern "C" int mla_attention(const void* q, const void* k_pages, const void* page_tables,
                             const void* ctx_lens, const void* qmask, void* out, int B,
                             int Q, int H, int Dk, int Dv, int ps, int P, float scale,
                             int causal, void* stream) {
  if (Dk % 8 || Dv % 2 || Dv > Dk || Dv > kMaxDv || B < 1 || Q < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Dk);
  cudaError_t err = cudaFuncSetAttribute(
      mla_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = Q * H;
  dim3 grid((R + kRowTile - 1) / kRowTile, B);
  mla_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const int*>(page_tables), static_cast<const int*>(ctx_lens),
      static_cast<const uint8_t*>(qmask), static_cast<__nv_bfloat16*>(out), Q, H, Dk,
      Dv, ps, P, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
