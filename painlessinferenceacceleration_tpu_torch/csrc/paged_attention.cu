// Paged attention over the bf16 KV arena for Hopper (sm_90a): decode,
// tree verify and causal prefill in one kernel.
//
// Replaces the Pallas bodies _attn_decode_kernel (Q = 1),
// _attn_verify_kernel (1 < Q <= 128) and _attn_prefill_kernel (Q > 128,
// causal) of painlessinferenceacceleration_tpu/ops/paged_attention.py, for
// the bf16 arena. Decode is the verify rule with a one-entry mask; prefill
// is the same walk with the causal rule in place of the mask.
//
// Visibility (ops/attention.py): key slot j is visible to query row t iff
// j < ctx, or s = j - ctx lies in [0, Q) and qmask[b, t, s] (causal: s <= t).
// Masked scores take -1e30 (not -inf), so a fully masked row stays finite.
//
// What bounds it on the H100: the K/V bytes read, 2 * ctx * D * 2 B per
// (request, kv head) and layer. Design: one block per (query tile, kv head,
// request); its rows are the G query heads of that kv head times the tile's
// positions (at most 64). The block walks only the pages that hold visible
// keys, staging one page of K and V in shared memory (K rows padded by one
// word, so lanes reading different keys hit different banks); each warp
// keeps an fp32 online softmax for its rows, a lane per key for the scores
// and a lane per 4 head dims for P @ V. Each row's result depends only on
// the keys it sees, in slot order, so it is the same at every Q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxPage = 128;            // keys per staged page
constexpr int kKeysPerLane = kMaxPage / 32;
constexpr float kNegInf = -1e30f;

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

template <int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_tables,
    const int* __restrict__ ctx_lens, const uint8_t* __restrict__ qmask,
    __nv_bfloat16* __restrict__ out, int Q, int Hq, int Hkv, int ps, int P,
    int QT, float scale, int causal) {
  constexpr int KST = D + 2;  // padded K row stride in bf16 elements
  constexpr int DPL = D / 32;  // head dims per lane in P @ V
  extern __shared__ float smem[];
  float* q_s = smem;                                              // [kRows][D]
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(q_s + kRows * D);  // [ps][KST]
  __nv_bfloat16* v_s = k_s + ps * KST;                            // [ps][D]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = Hq / Hkv;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * QT;
  const int nt = min(QT, Q - t0);
  const int n_rows = G * nt;
  const int ctx = ctx_lens[b];
  const int HD = Hkv * D;

  // q rows of the tile: row r -> head h*G + r/nt, position t0 + r%nt
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int t = t0 + r % nt, qh = h * G + r / nt;
    q_s[r * D + d] = __bfloat162float(q[(((size_t)b * Q + t) * Hq + qh) * D + d]);
  }

  const int last_key = causal ? ctx + t0 + nt - 1 : ctx + Q - 1;
  const int n_pages = min((last_key + ps) / ps, P);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  for (int c = 0; c < n_pages; ++c) {
    const int page = page_tables[(size_t)b * P + c];
    // stage this kv head's K and V rows of the page (16-byte loads)
    constexpr int VPR = D / 8;  // uint4 per row
    for (int e = threadIdx.x; e < ps * VPR; e += kThreads) {
      const int row = e / VPR, v = e % VPR;
      const size_t off = ((size_t)page * ps + row) * HD + (size_t)h * D + v * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(k_pages + off);
      const uint4 vv = *reinterpret_cast<const uint4*>(v_pages + off);
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * KST + v * 8);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(v_s + row * D + v * 8) = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_rows) continue;  // warp-uniform
      const int t = t0 + r % nt;
      const float* qr = q_s + r * D;
      float sc[kKeysPerLane];
      float cmax = kNegInf;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int kk = lane + 32 * u;
        float sv = kNegInf;
        if (kk < ps) {
          const int j = c * ps + kk;
          bool vis = j < ctx;
          if (!vis) {
            const int s = j - ctx;
            if (s >= 0 && s < Q)
              vis = causal ? (s <= t) : (qmask[((size_t)b * Q + t) * Q + s] != 0);
          }
          if (vis) {
            const __nv_bfloat162* kr =
                reinterpret_cast<const __nv_bfloat162*>(k_s + kk * KST);
            float dot = 0.f;
#pragma unroll 8
            for (int d2 = 0; d2 < D / 2; ++d2) {
              const float2 kf = __bfloat1622float2(kr[d2]);
              dot = fmaf(qr[2 * d2], kf.x, dot);
              dot = fmaf(qr[2 * d2 + 1], kf.y, dot);
            }
            sv = dot * scale;
          }
        }
        sc[u] = sv;
        cmax = fmaxf(cmax, sv);
      }
      cmax = warp_max(cmax);
      const float m_new = fmaxf(m[i], cmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const float p = (lane + 32 * u < ps) ? expf(sc[u] - m_new) : 0.f;
        sc[u] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        if (32 * u >= ps) break;  // ps is uniform: sc[] keeps static indices
        for (int k2 = 0; k2 < 32 && 32 * u + k2 < ps; ++k2) {
          const float p = __shfl_sync(0xffffffffu, sc[u], k2);
          const __nv_bfloat16* vr = v_s + (32 * u + k2) * D;
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[i][e] = fmaf(p, __bfloat162float(vr[lane + 32 * e]), acc[i][e]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= n_rows) continue;  // warp-uniform
    const int t = t0 + r % nt, qh = h * G + r / nt;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    __nv_bfloat16* o = out + (((size_t)b * Q + t) * Hq + qh) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[lane + 32 * e] = __float2bfloat16(acc[i][e] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_tables, const int* ctx_lens, const uint8_t* qmask,
           void* out, int B, int Q, int Hq, int Hkv, int ps, int P,
           float scale, int causal, cudaStream_t st) {
  const int G = Hq / Hkv;
  const int QT = kRows / G;
  const size_t smem = (size_t)kRows * D * 4 + (size_t)ps * (D + 2) * 2 +
                      (size_t)ps * D * 2;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + QT - 1) / QT, Hkv, B);
  paged_attention_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), page_tables, ctx_lens, qmask,
      static_cast<__nv_bfloat16*>(out), Q, Hq, Hkv, ps, P, QT, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q bf16 [B, Q, Hq, D]; k_pages/v_pages bf16 [n_pages, ps, Hkv*D] (one
// layer); page_tables int32 [B, P]; ctx_lens int32 [B]; qmask uint8
// [B, Q, Q] (ignored when causal); out bf16 [B, Q, Hq, D].
// Requires D in {64, 128}, ps % 8 == 0, ps <= 128, Hq % Hkv == 0 and
// Hq / Hkv dividing 64.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_tables,
                               const void* ctx_lens, const void* qmask,
                               void* out, int B, int Q, int Hq, int Hkv, int D,
                               int ps, int P, float scale, int causal,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const uint8_t* qm = static_cast<const uint8_t*>(qmask);
  if (D == 128)
    return launch<128>(q, k_pages, v_pages, pt, cl, qm, out, B, Q, Hq, Hkv, ps,
                       P, scale, causal, st);
  if (D == 64)
    return launch<64>(q, k_pages, v_pages, pt, cl, qm, out, B, Q, Hq, Hkv, ps,
                      P, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
