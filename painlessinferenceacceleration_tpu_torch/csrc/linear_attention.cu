// Decayed linear attention for Hopper (sm_90a) (K14): the chunked prefill,
// the per-token decode and tree verify, and the commit of an accepted chain.
//
// Per (batch row, head) with decay l = exp(loglam[h]) and a state S [D, D]
// (key dim d, value dim e) kept per engine slot, fp32 throughout.
//
// Chunk mode replaces the Pallas body _la_kernel of
// painlessinferenceacceleration_tpu/ops/linear_attention.py, the chunkwise
// form over the n = chunk_lens[b] valid tokens of a chunk:
//   out_i = sum_{j<=i, j<n} l^(i-j) (q_i.k_j) v_j + l^(i+1) q_i S
//   S'    = l^n S + sum_{j<n} l^(n-1-j) k_j^T v_j
// It walks the chunk in sub-tiles of kTile tokens and carries S between
// them in shared memory, which equals the one-chunk form in exact
// arithmetic; the TPU kernel holds the whole chunk in VMEM, which a
// 4096-token chunk would not fit here. The tile size is a constant, so a
// row's bits depend on its own tokens only, never on the batch or on the
// chunk's padded width.
//
// Decode, tree and commit modes share one per-token step, written once
// (la_step) with explicit round-to-nearest operations:
//   S <- l * S + k (x) v        (elementwise: two products, one sum)
//   out = sum_d q[d] S[d, :]    (d ascending, a product and a sum each)
// Decode (Q = 1) is a step and its readout, written back to the slot. Tree
// mode replaces _la_tree_kernel (the ancestor-path closed form
// l^(depth_i - depth_j) ... + l^(depth_i+1) q_i S) by the same step walked
// from the committed state down each node's ancestor path; it writes no
// state. The commit (jnp in models/linear_attn.py commit_linear_states of
// the JAX package) replays the accepted chain from the verify window's k
// and v with the same step. So a verified row has the bits of the AR row at
// its position, and after n accepted tokens the state has the bits of n AR
// steps: lookahead is lossless over these layers.
//
// What bounds it on the H100. Chunk mode: bytes at decode-like widths,
// operations on CUDA cores at prefill widths (~3 D^2 multiply-adds a token
// and head: 4096 tokens x 16 heads at D = 128 is ~1.6 G, ~40 us of fp32
// at the card's peak against ~40 us of bytes for q, k, v and out). The
// recurrent modes: the state's bytes (64 KB a head at D = 128) and the
// latency of the readout's serial sum. This design takes neither bound:
// one block per (row, head, 32 value columns) gives 64 blocks for B = 1 at
// H = 16, D = 128, on CUDA cores, without tensor cores. Columns are
// independent in both the step and the readout, so splitting them over
// blocks changes no bit; each block reads and writes only its own columns
// of the slot's state, which lets chunk and decode update the arena in
// place. Rows with nothing to do (chunk_lens 0, an inactive row, a commit
// of 0) write nothing, so padding rows that alias slot 0 never race a real
// row on its state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;      // value columns per block (one warp's lanes)
constexpr int kTile = 64;      // chunk mode: tokens per sub-tile
constexpr int kChunkThreads = 256;

// One step of the recurrence for the value column this lane owns: dst[d] =
// l * src[d] + k[d] * v for every d, and (with q) the readout of the new
// column, summed over d ascending. src and dst may alias (in place).
__device__ __forceinline__ float la_step(const float* src, long long lds, float* dst,
                                         long long ldd, const float* k, const float* q,
                                         float v, float lam, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const float s = __fadd_rn(__fmul_rn(lam, src[d * lds]), __fmul_rn(k[d], v));
    dst[d * ldd] = s;
    if (q != nullptr) acc = __fadd_rn(acc, __fmul_rn(q[d], s));
  }
  return acc;
}

// ---------------------------------------------------------------------------
// chunk mode
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kChunkThreads) la_chunk_kernel(
    const float* __restrict__ xq, const float* __restrict__ xk,
    const float* __restrict__ xv, float* __restrict__ state,
    const int* __restrict__ slot_ids, const int* __restrict__ chunk_lens,
    const float* __restrict__ loglam, float* __restrict__ out, int H, int C, int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, e0 = blockIdx.z * kCols;
  const int n_tot = chunk_lens[b];
  if (n_tot <= 0) return;
  const int DP = D + 1;  // padded rows: lanes reading k[j][d] over j avoid bank conflicts
  float* S = smem;                       // [D][kCols]
  float* qs = S + D * kCols;             // [kTile][DP]
  float* ks = qs + kTile * DP;           // [kTile][DP]
  float* vs = ks + kTile * DP;           // [kTile][kCols]
  float* A = vs + kTile * kCols;         // [kTile][kTile + 1]
  float* pd = A + kTile * (kTile + 1);   // [kTile + 1]: l^m
  const int tid = threadIdx.x;
  const float ll = loglam[h];
  const long long head = ((long long)b * H + h) * C;
  float* Sg = state + ((long long)slot_ids[b] * H + h) * D * D;
  const int ncol = min(kCols, D - e0);

  for (int p = tid; p <= kTile; p += kChunkThreads) pd[p] = expf(ll * (float)p);
  for (int p = tid; p < D * kCols; p += kChunkThreads) {
    const int d = p / kCols, e = p % kCols;
    S[p] = e < ncol ? Sg[(long long)d * D + e0 + e] : 0.f;
  }
  for (int t0 = 0; t0 < n_tot; t0 += kTile) {
    const int n = min(kTile, n_tot - t0);
    __syncthreads();  // S written, pd ready; the previous tile's reads done
    for (int p = tid; p < kTile * D; p += kChunkThreads) {
      const int i = p / D, d = p % D;
      const bool ok = i < n;
      const long long g = (head + t0 + i) * D + d;
      qs[i * DP + d] = ok ? xq[g] : 0.f;
      ks[i * DP + d] = ok ? xk[g] : 0.f;
    }
    for (int p = tid; p < kTile * kCols; p += kChunkThreads) {
      const int i = p / kCols, e = p % kCols;
      vs[p] = (i < n && e < ncol) ? xv[(head + t0 + i) * D + e0 + e] : 0.f;
    }
    __syncthreads();
    // decay-masked scores A[i][j] = l^(i-j) q_i.k_j for j <= i < n
    for (int p = tid; p < kTile * kTile; p += kChunkThreads) {
      const int i = p / kTile, j = p % kTile;
      float a = 0.f;
      if (j <= i && i < n) {
        const float* qi = qs + i * DP;
        const float* kj = ks + j * DP;
        for (int d = 0; d < D; ++d) a = __fadd_rn(a, __fmul_rn(qi[d], kj[d]));
        a = __fmul_rn(a, pd[i - j]);
      }
      A[i * (kTile + 1) + j] = a;
    }
    __syncthreads();
    // out_i = sum_j A[i][j] v_j + l^(i+1) q_i S  (the carried state)
    for (int p = tid; p < kTile * kCols; p += kChunkThreads) {
      const int i = p / kCols, e = p % kCols;
      if (i >= n || e >= ncol) continue;
      const float* qi = qs + i * DP;
      float inter = 0.f;
      for (int d = 0; d < D; ++d) inter = __fadd_rn(inter, __fmul_rn(qi[d], S[d * kCols + e]));
      float intra = 0.f;
      const float* Ai = A + i * (kTile + 1);
      for (int j = 0; j <= i; ++j) intra = __fadd_rn(intra, __fmul_rn(Ai[j], vs[j * kCols + e]));
      out[(head + t0 + i) * D + e0 + e] = __fadd_rn(intra, __fmul_rn(pd[i + 1], inter));
    }
    __syncthreads();  // every read of S done before it moves on
    // S' = l^n S + sum_{j<n} (l^(n-1-j) k_j)^T v_j
    for (int p = tid; p < D * kCols; p += kChunkThreads) {
      const int d = p / kCols, e = p % kCols;
      float add = 0.f;
      for (int j = 0; j < n; ++j)
        add = __fadd_rn(add, __fmul_rn(__fmul_rn(pd[n - 1 - j], ks[j * DP + d]),
                                       vs[j * kCols + e]));
      S[p] = __fadd_rn(__fmul_rn(pd[n], S[p]), add);
    }
  }
  __syncthreads();
  for (int p = tid; p < D * kCols; p += kChunkThreads) {
    const int d = p / kCols, e = p % kCols;
    if (e < ncol) Sg[(long long)d * D + e0 + e] = S[p];
  }
}

// ---------------------------------------------------------------------------
// decode and tree verify: one warp per (row, head, 32 value columns)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32) la_recurrent_kernel(
    const float* __restrict__ xq, const float* __restrict__ xk,
    const float* __restrict__ xv, float* __restrict__ state,
    const int* __restrict__ slot_ids, const int* __restrict__ parents,
    const unsigned char* __restrict__ valid, const float* __restrict__ lam_h,
    float* __restrict__ out, int H, int Q, int D, int write_state) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, e0 = blockIdx.z * kCols;
  const int lane = threadIdx.x;
  const unsigned char* vb = valid + (long long)b * Q;
  if (!vb[0]) return;  // an inactive row: no output, no state
  const int e = e0 + lane;
  const bool col = e < D;
  const float lam = lam_h[h];
  const long long head = ((long long)b * H + h) * Q;
  float* Sg = state + ((long long)slot_ids[b] * H + h) * D * D + (col ? e : 0);
  float* Sr = smem;                // [D][kCols]: the root's state
  float* W = Sr + D * kCols;       // [D][kCols]: the walk's state
  int* path = reinterpret_cast<int*>(W + D * kCols);  // [Q]
  auto node = [&](int i, const float* src, long long lds, float* dst, long long ldd) {
    const float* q = xq + (head + i) * D;
    const float* k = xk + (head + i) * D;
    const float v = col ? xv[(head + i) * D + e] : 0.f;
    const float o = la_step(src, lds, dst, ldd, k, q, v, lam, D);
    if (col) out[(head + i) * D + e] = o;
  };
  if (write_state) {  // decode: the step in place on the slot's column
    if (col) node(0, Sg, D, Sg, D);
    return;
  }
  float* sr = Sr + lane;
  float* w = W + lane;
  node(0, Sg, D, sr, kCols);
  int prev = -1;  // the node whose state W holds
  for (int i = 1; i < Q; ++i) {
    const int par = parents[(long long)b * Q + i];
    if (!vb[i] || par < 0 || par >= i) continue;  // dead node: no output
    if (par != prev) {
      // W <- the state of par: replay its ancestor path from the root (a
      // parent index below its child's bounds the walk)
      int n = 0;
      for (int a = par; a > 0;) {
        if (lane == 0) path[n] = a;
        ++n;
        const int up = parents[(long long)b * Q + a];
        if (up >= a) break;
        a = up;
      }
      __syncwarp();
      for (int s = n - 1; s >= 0; --s) {
        const int a = path[s];
        const float va = col ? xv[(head + a) * D + e] : 0.f;
        la_step(s == n - 1 ? sr : w, kCols, w, kCols, xk + (head + a) * D, nullptr, va,
                lam, D);
      }
      __syncwarp();
      if (n == 0) {  // a child of the root
        node(i, sr, kCols, w, kCols);
        prev = i;
        continue;
      }
    }
    node(i, w, kCols, w, kCols);
    prev = i;
  }
}

// ---------------------------------------------------------------------------
// commit: replay each row's accepted chain into its slot's state
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32) la_commit_kernel(
    float* __restrict__ state, const float* __restrict__ win_k,
    const float* __restrict__ win_v, const int* __restrict__ slot_ids,
    const int* __restrict__ chain, const int* __restrict__ n_commit,
    const float* __restrict__ lam_lh, int B, int H, int Q, int D, int M,
    long long layer_stride) {
  const int lb = blockIdx.x, h = blockIdx.y;
  const int l = lb / B, b = lb % B;
  const int n = min(n_commit[b], M);
  const int e = blockIdx.z * kCols + threadIdx.x;
  if (n <= 0 || e >= D) return;
  const float lam = lam_lh[(long long)l * H + h];
  float* Sg = state + l * layer_stride + ((long long)slot_ids[b] * H + h) * D * D + e;
  const long long head = (((long long)l * B + b) * H + h) * Q;
  for (int p = 0; p < n; ++p) {
    const int c = chain[(long long)b * M + p];
    la_step(Sg, D, Sg, D, win_k + (head + c) * D, nullptr, win_v[(head + c) * D + e], lam,
            D);
  }
}

int cols_blocks(int D) { return (D + kCols - 1) / kCols; }

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xq, xk, xv, out [B, H, C, D] fp32 contiguous; state [slots, H, D, D] fp32
// (one layer's arena, read and written at slot_ids[b]); chunk_lens [B],
// slot_ids [B] int32; loglam [H] fp32. D <= 128.
extern "C" int la_chunk(const void* xq, const void* xk, const void* xv, void* state,
                        const void* slot_ids, const void* chunk_lens, const void* loglam,
                        void* out, int B, int H, int C, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)D * kCols + 2 * (size_t)kTile * (D + 1) +
                                       (size_t)kTile * kCols + (size_t)kTile * (kTile + 1) +
                                       kTile + 1);
  cudaError_t err = cudaFuncSetAttribute(
      la_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, H, cols_blocks(D));
  la_chunk_kernel<<<grid, kChunkThreads, smem, st>>>(
      static_cast<const float*>(xq), static_cast<const float*>(xk),
      static_cast<const float*>(xv), static_cast<float*>(state),
      static_cast<const int*>(slot_ids), static_cast<const int*>(chunk_lens),
      static_cast<const float*>(loglam), static_cast<float*>(out), H, C, D);
  return static_cast<int>(cudaGetLastError());
}

// xq, xk, xv, out [B, H, Q, D] fp32; parents [B, Q] int32 (-1 the root, -2
// a dead node, else an earlier node); valid [B, Q] uint8; lam [H] fp32 (the
// decay itself). write_state 1 (decode, Q = 1): the step is written back to
// the slot; 0 (tree verify): no state is written.
extern "C" int la_recurrent(const void* xq, const void* xk, const void* xv, void* state,
                            const void* slot_ids, const void* parents, const void* valid,
                            const void* lam, void* out, int B, int H, int Q, int D,
                            int write_state, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = write_state ? 0 : sizeof(float) * 2 * (size_t)D * kCols +
                                          sizeof(int) * (size_t)Q;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        la_recurrent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(B, H, cols_blocks(D));
  la_recurrent_kernel<<<grid, 32, smem, st>>>(
      static_cast<const float*>(xq), static_cast<const float*>(xk),
      static_cast<const float*>(xv), static_cast<float*>(state),
      static_cast<const int*>(slot_ids), static_cast<const int*>(parents),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(lam),
      static_cast<float*>(out), H, Q, D, write_state);
  return static_cast<int>(cudaGetLastError());
}

// state [n_lin, slots, H, D, D] fp32 (layer_stride = slots*H*D*D); win_k,
// win_v [n_lin, B, H, Q, D] fp32; chain [B, M] int32 window columns of the
// committed nodes in order; n_commit [B]; lam [n_lin, H] fp32.
extern "C" int la_commit(void* state, const void* win_k, const void* win_v,
                         const void* slot_ids, const void* chain, const void* n_commit,
                         const void* lam, int n_lin, int B, int H, int Q, int D, int M,
                         long long layer_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(n_lin * B, H, cols_blocks(D));
  la_commit_kernel<<<grid, 32, 0, st>>>(
      static_cast<float*>(state), static_cast<const float*>(win_k),
      static_cast<const float*>(win_v), static_cast<const int*>(slot_ids),
      static_cast<const int*>(chain), static_cast<const int*>(n_commit),
      static_cast<const float*>(lam), B, H, Q, D, M, layer_stride);
  return static_cast<int>(cudaGetLastError());
}
