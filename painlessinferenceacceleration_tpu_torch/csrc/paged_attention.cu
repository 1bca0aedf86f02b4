// Paged attention over the KV arena for Hopper (sm_90a): decode, tree
// verify and causal prefill in one kernel, over a bf16 arena or an e4m3 one.
//
// Replaces the Pallas bodies _attn_decode_kernel (Q = 1),
// _attn_verify_kernel (1 < Q <= 128) and _attn_prefill_kernel (Q > 128,
// causal) of painlessinferenceacceleration_tpu/ops/paged_attention.py, and
// _attn_decode_tok_kernel (the per-token-scale e4m3 arena). Decode is the
// verify rule with a one-entry mask; prefill is the same walk with the
// causal rule in place of the mask. Three arena modes (template MODE):
//   0  bf16 arena;
//   1  e4m3 arena with static per-(layer, kv head) scales: the K scale folds
//      into the score factor and the V scale into the output, as the Pallas
//      wrappers fold them into q and the output;
//   2  e4m3 arena with per-(token, kv head) f32 scales [n_pages, ps, Hkv]:
//      the K scale multiplies each score before the softmax and the V scale
//      each probability before P @ V (the normaliser keeps the unscaled
//      probabilities), which equals attending over the dequantized rows.
// e4m3 is exact in bf16, so e4m3 rows are widened to bf16 as they are
// staged in shared memory and the compute loop is the bf16 one; the TPU's
// SWAR decode and its even/odd row permutation do not carry over.
//
// Visibility (ops/attention.py): key slot j is visible to query row t iff
// j < ctx, or s = j - ctx lies in [0, Q) and qmask[b, t, s] (causal: s <= t).
// Masked scores take -1e30 (not -inf), so a fully masked row stays finite.
//
// What bounds it on the H100: the K/V bytes read, 2 * ctx * D * (2 or 1) B
// per (request, kv head) and layer, plus 2 * ctx * 4 B of per-token scales.
// Design: one block per (query tile, kv head,
// request); its rows are the G query heads of that kv head times the tile's
// positions (at most 64). The block walks only the pages that hold visible
// keys, staging one page of K and V in shared memory (K rows padded by one
// word, so lanes reading different keys hit different banks); each warp
// keeps an fp32 online softmax for its rows, a lane per key for the scores
// and a lane per 4 head dims for P @ V. Each row's result depends only on
// the keys it sees, in slot order, so it is the same at every Q: a page
// with no visible key for a row leaves its state unchanged bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

constexpr int kBf16 = 0;       // bf16 arena
constexpr int kFp8Head = 1;    // e4m3 arena, static per-head scales
constexpr int kFp8Token = 2;   // e4m3 arena, per-token scales

// Two e4m3 values -> two bf16 values (exact: e4m3 fits bf16).
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
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

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const int* __restrict__ page_tables,
    const int* __restrict__ ctx_lens, const uint8_t* __restrict__ qmask,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    __nv_bfloat16* __restrict__ out, int Q, int Hq, int Hkv, int ps, int P,
    int QT, float scale, int causal) {
  constexpr int KST = D + 2;  // padded K row stride in bf16 elements
  constexpr int DPL = D / 32;  // head dims per lane in P @ V
  extern __shared__ float smem[];
  float* q_s = smem;                                              // [kRows][D]
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(q_s + kRows * D);  // [ps][KST]
  __nv_bfloat16* v_s = k_s + ps * KST;                            // [ps][D]
  float* ks_s = reinterpret_cast<float*>(v_s + ps * D);  // [ps] (MODE 2)
  float* vs_s = ks_s + ps;                                // [ps] (MODE 2)

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
  // static K scale folds into the score factor, V scale into the output
  const float kfac = MODE == kFp8Head ? scale * k_scale[h] : scale;

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
    if (MODE == kBf16) {
      constexpr int VPR = D / 8;  // uint4 per row
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_pages);
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_pages);
      for (int e = threadIdx.x; e < ps * VPR; e += kThreads) {
        const int row = e / VPR, v = e % VPR;
        const size_t off = ((size_t)page * ps + row) * HD + (size_t)h * D + v * 8;
        const uint4 kv = *reinterpret_cast<const uint4*>(kp + off);
        const uint4 vv = *reinterpret_cast<const uint4*>(vp + off);
        uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * KST + v * 8);
        kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
        *reinterpret_cast<uint4*>(v_s + row * D + v * 8) = vv;
      }
    } else {
      constexpr int VPR = D / 16;  // uint4 (16 e4m3 values) per row
      const uint8_t* kp = static_cast<const uint8_t*>(k_pages);
      const uint8_t* vp = static_cast<const uint8_t*>(v_pages);
      for (int e = threadIdx.x; e < ps * VPR; e += kThreads) {
        const int row = e / VPR, v = e % VPR;
        const size_t off = ((size_t)page * ps + row) * HD + (size_t)h * D + v * 16;
        const uint4 kv = *reinterpret_cast<const uint4*>(kp + off);
        const uint4 vv = *reinterpret_cast<const uint4*>(vp + off);
        const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
        const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
        uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * KST + v * 16);
        uint32_t vb[8];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          kd[2 * w] = e4m3x2_to_bf16x2(kw[w] & 0xffffu);
          kd[2 * w + 1] = e4m3x2_to_bf16x2(kw[w] >> 16);
          vb[2 * w] = e4m3x2_to_bf16x2(vw[w] & 0xffffu);
          vb[2 * w + 1] = e4m3x2_to_bf16x2(vw[w] >> 16);
        }
        uint4* vd = reinterpret_cast<uint4*>(v_s + row * D + v * 16);
        vd[0] = make_uint4(vb[0], vb[1], vb[2], vb[3]);
        vd[1] = make_uint4(vb[4], vb[5], vb[6], vb[7]);
      }
      if (MODE == kFp8Token) {
        for (int row = threadIdx.x; row < ps; row += kThreads) {
          const size_t so = ((size_t)page * ps + row) * Hkv + h;
          ks_s[row] = k_scale[so];
          vs_s[row] = v_scale[so];
        }
      }
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
            sv = dot * kfac;
            if (MODE == kFp8Token) sv *= ks_s[kk];
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
          float p = __shfl_sync(0xffffffffu, sc[u], k2);
          if (MODE == kFp8Token) p *= vs_s[32 * u + k2];
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
    float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    if (MODE == kFp8Head) inv *= v_scale[h];
    __nv_bfloat16* o = out + (((size_t)b * Q + t) * Hq + qh) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[lane + 32 * e] = __float2bfloat16(acc[i][e] * inv);
  }
}

template <int D, int MODE>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_tables, const int* ctx_lens, const uint8_t* qmask,
           const float* k_scale, const float* v_scale, void* out, int B, int Q,
           int Hq, int Hkv, int ps, int P, float scale, int causal,
           cudaStream_t st) {
  const int G = Hq / Hkv;
  const int QT = kRows / G;
  const size_t smem = (size_t)kRows * D * 4 + (size_t)ps * (D + 2) * 2 +
                      (size_t)ps * D * 2 + (MODE == kFp8Token ? 2 * ps * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<D, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + QT - 1) / QT, Hkv, B);
  paged_attention_kernel<D, MODE><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), k_pages, v_pages, page_tables,
      ctx_lens, qmask, k_scale, v_scale, static_cast<__nv_bfloat16*>(out), Q,
      Hq, Hkv, ps, P, QT, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(int mode, const void* q, const void* k_pages,
                const void* v_pages, const int* pt, const int* cl,
                const uint8_t* qm, const float* ksc, const float* vsc,
                void* out, int B, int Q, int Hq, int Hkv, int ps, int P,
                float scale, int causal, cudaStream_t st) {
  if (mode == kBf16)
    return launch<D, kBf16>(q, k_pages, v_pages, pt, cl, qm, ksc, vsc, out, B,
                            Q, Hq, Hkv, ps, P, scale, causal, st);
  if (mode == kFp8Head)
    return launch<D, kFp8Head>(q, k_pages, v_pages, pt, cl, qm, ksc, vsc, out,
                               B, Q, Hq, Hkv, ps, P, scale, causal, st);
  if (mode == kFp8Token)
    return launch<D, kFp8Token>(q, k_pages, v_pages, pt, cl, qm, ksc, vsc, out,
                                B, Q, Hq, Hkv, ps, P, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q bf16 [B, Q, Hq, D]; k_pages/v_pages [n_pages, ps, Hkv*D] (one layer),
// bf16 (mode 0) or e4m3 (modes 1, 2); page_tables int32 [B, P]; ctx_lens
// int32 [B]; qmask uint8 [B, Q, Q] (ignored when causal); k_scale/v_scale
// f32 [Hkv] (mode 1) or [n_pages, ps, Hkv] (mode 2), null in mode 0;
// out bf16 [B, Q, Hq, D]. Requires D in {64, 128}, ps % 8 == 0,
// ps <= 128, Hq % Hkv == 0 and Hq / Hkv dividing 64.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_tables,
                               const void* ctx_lens, const void* qmask,
                               const void* k_scale, const void* v_scale,
                               void* out, int B, int Q, int Hq, int Hkv, int D,
                               int ps, int P, float scale, int causal, int mode,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  const uint8_t* qm = static_cast<const uint8_t*>(qmask);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  if (D == 128)
    return launch_mode<128>(mode, q, k_pages, v_pages, pt, cl, qm, ksc, vsc,
                            out, B, Q, Hq, Hkv, ps, P, scale, causal, st);
  if (D == 64)
    return launch_mode<64>(mode, q, k_pages, v_pages, pt, cl, qm, ksc, vsc,
                           out, B, Q, Hq, Hkv, ps, P, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
