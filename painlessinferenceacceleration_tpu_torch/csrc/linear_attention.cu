// Decayed linear attention for Hopper (sm_90a) (K14): the chunked prefill,
// the per-token decode and tree verify, and the commit of an accepted chain.
//
// Per (batch row, head) with decay l = exp(loglam[h]) and a state S [D, D]
// (key dim d, value dim e) kept per engine slot, fp32 throughout.
//
// Chunk mode replaces the Pallas body _la_kernel of
// painlessinferenceacceleration_tpu/ops/linear_attention.py, the chunkwise
// form over the n = chunk_lens[b] valid tokens of a chunk, taken in
// sub-tiles of kTile tokens counted from the chunk's start (the TPU kernel
// holds the whole chunk in VMEM, which a 4096-token chunk would not fit
// here). A tile of n tokens entered with state S:
//   out_i = sum_{j<=i<n} l^(i-j) (q_i.k_j) v_j + l^(i+1) (q_i S)
//   S'    = l^n S + sum_{j<n} (l^(n-1-j) k_j)^T v_j
// Three kernels, in this order on the stream, with a workspace of two
// [D, D] states a (row, head, tile):
//   la_chunk_delta_kernel, one block per (row, head, tile), all in
//     parallel: the tile's increment dS = (w k)^T v, w_j = l^(n-1-j), on
//     the tensor cores, into the tile's slot of the workspace;
//   la_chunk_scan_kernel, one thread per (row, head, 4 state elements):
//     S <- l^n S + dS over the row's tiles in order, elementwise, each
//     tile's entering state into its second slot, the last into the
//     engine slot's state;
//   la_chunk_out_kernel, one block per (row, head, tile), all in parallel:
//     the decay-masked scores A = (q k^T) * l^(i-j), j <= i < n, once a
//     tile, then out = A v + l^(i+1) (q S_enter), the products on the
//     tensor cores; every element of out is written, zeros past a row's n.
// The products are 3xTF32 (mma.sync m16n8k8): each fp32 operand split into
// a TF32 high part and a TF32 residual, and lo.hi + hi.lo + hi.hi summed in
// the fp32 accumulator, which keeps the chunk within 1e-5 of the fp32 plain
// version (plain TF32 keeps ~3 decimal digits). A row's bits depend on its
// own tokens only: a tile's operands sit at the same places whatever the
// batch, the other rows or the padded width C (rows past n read as zeros),
// so a prefill resumed at a multiple of kTile equals the whole prefill.
//
// Decode, tree and commit share one per-token step (la_step), with explicit
// round-to-nearest operations:
//   S <- l * S + k (x) v        (elementwise: two products, one sum)
// and decode and tree one readout in a fixed order (readout):
//   out = sum_d q[d] S[d, :]    d cut into kSplit ranges of D / kSplit; each
//                               range summed in ascending d, a product and a
//                               sum each; the kSplit partials added in a
//                               fixed tree: (0+4, 1+5, 2+6, 3+7), then
//                               (0+2, 1+3), then (0+1)
// ops/linear_attention.py la_readout repeats that order (READOUT_SPLIT =
// kSplit). Decode (Q = 1) is a step and its readout, written back to the
// slot. Tree mode replaces _la_tree_kernel (the ancestor-path closed form)
// by the same step from the committed state down each node's ancestor path;
// it writes no state. The commit (jnp in models/linear_attn.py
// commit_linear_states of the JAX package) replays the accepted chain from
// the verify window's k and v with the same step. So a verified row has the
// bits of the AR row at its position, and after n accepted tokens the state
// has the bits of n AR steps: lookahead is lossless over these layers.
//
// What bounds it on the H100. Chunk mode: bytes (q, k and v read, out
// written, and the workspace's two states a tile and head each written and
// read once: 4 x 64 KB at D = 128, against 4 x 32 KB of q, k, v and out),
// then operations (~4 D^2 + 2 D n multiply-adds a token and head, three
// TF32 products each). The recurrent modes: the state's bytes
// (64 KB a head at D = 128), read once and (decode, commit) written once.
// They run one block of kSplit x kSlab threads per (row, head, kSlab value
// columns), 128 blocks at B = 1, H = 16, D = 128: a thread holds D / kSplit
// state elements of one column in registers, all its loads in flight before
// the first use, and writes them back once. Tree mode stages the window's q
// and k rows and the slab's v columns in shared memory and keeps the root's
// and the walk's state in registers (a branch switch replays the ancestor
// path from the root's registers); the commit steps every accepted node of
// every layer between one load and one store of the slab. Columns are
// independent in the step and the readout, so the split over blocks changes
// no bit. Rows with nothing to do (chunk_lens 0, an invalid decode row, a
// commit of 0) write no state, so padding rows that alias slot 0 never race
// a real row on its state.
//
// Each entry takes the launch's fixed fields (LaStatic, built once a shape
// by the wrapper), loglam (the kernel takes the decay's exp itself), valid
// as bool and the indices as int32 or int64, and launches one kernel (chunk
// mode three).

#include <cuda_runtime.h>
#include <stdint.h>

// What a launch fixes for a shape of its operands (ops/linear_attention.py
// _Static, field for field); checked by the wrapper. Outside the
// anonymous namespace: the C entries take it, and keep external linkage.
struct LaStatic {
  long long xs[3][3];          // q, k, v (stash k, v in commit) strides over (b, h, token)
  long long valid_stride[2];   // valid [B, Q] bool, over (b, q)
  long long idx_stride[2];     // parents [B, Q] (tree) / chain [B, M] (commit)
  long long slot_stride;       // slot_ids [B]
  long long lens_stride;       // chunk_lens / n_commit [B]
  long long layer_stride;      // commit: the arena's elements a layer
  long long win_layer;         // commit: the stash's elements a layer
  int B, H, Q, D, n_lin, M;    // Q: tokens a row (C in chunk mode); M: the chain's width
  int slot_wide, lens_wide, idx_wide;  // int64 (1) or int32 (0) indices
  int slabs, tiles;            // D / kSlab; chunk mode: C / kTile rounded up
  int smem, smem2;             // dynamic shared bytes: the mode's kernel (chunk: pass 1),
                               // chunk pass 3
};

namespace {

constexpr int kTile = 64;    // chunk mode: tokens a sub-tile
constexpr int kSlab = 16;    // value columns a block of the recurrent modes
constexpr int kSplit = 8;    // the readout's d-ranges (ops/linear_attention.py READOUT_SPLIT)
constexpr int kMaxD = 128;
constexpr int kRange = kMaxD / kSplit;       // state elements a thread holds at most
constexpr int kRecThreads = kSlab * kSplit;  // thread (range r, column c) = r * kSlab + c
constexpr int kChunkThreads = 256;           // chunk passes 1 and 3: 8 warps
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kScanThreads = 256;            // chunk pass 2: 4 state elements a thread
constexpr int kScanAhead = 16;               // pass 2: tiles whose loads are in flight
constexpr int kQPad = 4, kVPad = 8;          // smem row padding (floats): no bank conflicts
constexpr int kAPad = kTile + 4;

__device__ __forceinline__ long long ld_index(const void* p, int wide, long long i) {
  return wide ? __ldg(static_cast<const long long*>(p) + i)
              : (long long)__ldg(static_cast<const int*>(p) + i);
}

__device__ __forceinline__ long long slot_of(const LaStatic& st, const void* slot_ids, int b) {
  return slot_ids ? ld_index(slot_ids, st.slot_wide, b * st.slot_stride) : b;
}

// One step of the recurrence for one state element.
__device__ __forceinline__ float la_step(float s, float lam, float k, float v) {
  return __fadd_rn(__fmul_rn(lam, s), __fmul_rn(k, v));
}

// The kSplit partials of column c (part [kSplit][kSlab]) in the fixed tree.
__device__ __forceinline__ float combine(const float* part, int c) {
  static_assert(kSplit == 8, "the combine tree is written for 8 ranges");
  const float a0 = __fadd_rn(part[0 * kSlab + c], part[4 * kSlab + c]);
  const float a1 = __fadd_rn(part[1 * kSlab + c], part[5 * kSlab + c]);
  const float a2 = __fadd_rn(part[2 * kSlab + c], part[6 * kSlab + c]);
  const float a3 = __fadd_rn(part[3 * kSlab + c], part[7 * kSlab + c]);
  return __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
}

// This thread's partial of the readout: q[d] s[d] over its range, ascending
// (q a pointer into shared memory or a register array).
template <typename QT>
__device__ __forceinline__ float partial(const QT& q, const float (&s)[kRange], int rl) {
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < kRange; ++j)
    if (j < rl) p = __fadd_rn(p, __fmul_rn(q[j], s[j]));
  return p;
}

template <typename KT>
__device__ __forceinline__ void step_all(float (&s)[kRange], float lam, const KT& k, float v,
                                         int rl) {
#pragma unroll
  for (int j = 0; j < kRange; ++j)
    if (j < rl) s[j] = la_step(s[j], lam, k[j], v);
}

// cp.async of one float (staging from any address) and of 16 bytes (bytes
// 0 fills them with zeros)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// rows [0, n) of w floats into dst (w floats a row); row i from src +
// (idx ? idx[i] : i) * ld. 16-byte copies where src, ld and w allow them,
// else 4-byte ones; every copy in flight before the caller waits.
__device__ __forceinline__ void stage_window(float* dst, const float* src, long long ld,
                                             const int* idx, int n, int w, int tid,
                                             int threads) {
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)ld | (uintptr_t)w) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int cpr = w / 4;
    for (int p = tid; p < n * cpr; p += threads) {
      const int i = p / cpr, c4 = (p - i * cpr) * 4;
      cp_async16(dst + i * w + c4, src + (idx ? idx[i] : i) * ld + c4, 16);
    }
  } else {
    for (int p = tid; p < n * w; p += threads) {
      const int i = p / w, c = p - i * w;
      cp_async4(dst + p, src + (idx ? idx[i] : i) * ld + c);
    }
  }
}

// ---------------------------------------------------------------------------
// decode: one block per (row, head, slab), the slab's state in registers
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRecThreads) la_decode_kernel(
    LaStatic st, const float* __restrict__ xq, const float* __restrict__ xk,
    const float* __restrict__ xv, float* __restrict__ state, const void* __restrict__ slot_ids,
    const bool* __restrict__ valid, const float* __restrict__ loglam,
    float* __restrict__ out) {
  __shared__ float part[kSplit * kSlab];
  const int b = blockIdx.z, h = blockIdx.y, D = st.D, rl = D / kSplit;
  const int c = threadIdx.x % kSlab, r = threadIdx.x / kSlab, e = blockIdx.x * kSlab + c;
  float* o = out + ((long long)b * st.H + h) * D;
  if (!valid[b * st.valid_stride[0]]) {  // an inactive row: zeros, no state
    if (r == 0) o[e] = 0.f;
    return;
  }
  const long long slot = slot_of(st, slot_ids, b);
  float* S = state + ((slot * st.H + h) * D + (long long)r * rl) * D + e;
  const float* q = xq + b * st.xs[0][0] + h * st.xs[0][1] + r * rl;
  const float* k = xk + b * st.xs[1][0] + h * st.xs[1][1] + r * rl;
  const float v = xv[b * st.xs[2][0] + h * st.xs[2][1] + e];
  float s[kRange], kk[kRange], qq[kRange];
#pragma unroll
  for (int j = 0; j < kRange; ++j) {
    if (j < rl) {
      s[j] = S[(long long)j * D];
      kk[j] = __ldg(k + j);
      qq[j] = __ldg(q + j);
    }
  }
  const float lam = expf(loglam[h]);
  step_all(s, lam, kk, v, rl);
  part[r * kSlab + c] = partial(qq, s, rl);
  __syncthreads();
  if (r == 0) o[e] = combine(part, c);
#pragma unroll
  for (int j = 0; j < kRange; ++j)
    if (j < rl) S[(long long)j * D] = s[j];
}

// ---------------------------------------------------------------------------
// tree verify: the window staged in shared memory, root and walk states in
// registers
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRecThreads) la_tree_kernel(
    LaStatic st, const float* __restrict__ xq, const float* __restrict__ xk,
    const float* __restrict__ xv, const float* __restrict__ state,
    const void* __restrict__ slot_ids, const void* __restrict__ parents,
    const bool* __restrict__ valid, const float* __restrict__ loglam,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int Q = st.Q, D = st.D, rl = D / kSplit;
  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int c = tid % kSlab, r = tid / kSlab, e0 = blockIdx.x * kSlab, e = e0 + c;
  float* o = out + ((long long)b * st.H + h) * Q * D;
  if (!valid[b * st.valid_stride[0]]) {  // an inactive row: zeros
    for (int p = tid; p < Q * kSlab; p += kRecThreads)
      o[(long long)(p / kSlab) * D + e0 + p % kSlab] = 0.f;
    return;
  }
  float* qs = smem;                      // [Q][D]
  float* ks = qs + Q * D;                // [Q][D]
  float* vs = ks + Q * D;                // [Q][kSlab]
  float* part = vs + Q * kSlab;          // [2][kSplit][kSlab]
  int* par = reinterpret_cast<int*>(part + 2 * kSplit * kSlab);  // [Q]
  int* live = par + Q;                   // [Q]
  int* path = live + Q;                  // [Q + 1]: an ancestor path, its length last

  // the committed state first: its loads in flight while the window stages
  const long long slot = slot_of(st, slot_ids, b);
  const float* S = state + ((slot * st.H + h) * D + (long long)r * rl) * D + e;
  float sr[kRange], w[kRange];
#pragma unroll
  for (int j = 0; j < kRange; ++j)
    if (j < rl) sr[j] = S[(long long)j * D];
  for (int t = tid; t < Q; t += kRecThreads) {
    par[t] = (int)ld_index(parents, st.idx_wide, b * st.idx_stride[0] + t * st.idx_stride[1]);
    live[t] = valid[b * st.valid_stride[0] + t * st.valid_stride[1]];
  }
  const float* qb = xq + b * st.xs[0][0] + h * st.xs[0][1];
  const float* kb = xk + b * st.xs[1][0] + h * st.xs[1][1];
  const float* vb = xv + b * st.xs[2][0] + h * st.xs[2][1] + e0;
  stage_window(qs, qb, st.xs[0][2], nullptr, Q, D, tid, kRecThreads);
  stage_window(ks, kb, st.xs[1][2], nullptr, Q, D, tid, kRecThreads);
  stage_window(vs, vb, st.xs[2][2], nullptr, Q, kSlab, tid, kRecThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float lam = expf(loglam[h]);
  const int off = r * rl;
  int nr = 0;  // readouts so far: the parity of the partials' buffer
  auto readout = [&](int i, const float (&s)[kRange]) {
    float* pb = part + (nr & 1) * kSplit * kSlab;
    pb[r * kSlab + c] = partial(qs + i * D + off, s, rl);
    __syncthreads();
    if (r == 0) o[(long long)i * D + e] = combine(pb, c);
    ++nr;
  };
  step_all(sr, lam, ks + off, vs[c], rl);  // the root
  readout(0, sr);
#pragma unroll
  for (int j = 0; j < kRange; ++j) w[j] = sr[j];
  int prev = 0;  // the node whose state w holds
  for (int i = 1; i < Q; ++i) {
    const int p = par[i];
    if (!live[i] || p < 0 || p >= i) {  // a dead node: zeros
      if (r == 0) o[(long long)i * D + e] = 0.f;
      continue;
    }
    if (p != prev) {
      // w <- the state of p: its ancestor path (below the root) replayed
      // from the root's registers; a parent index below its child's bounds
      // the walk
      if (tid == 0) {
        int n = 0;
        for (int a = p; a > 0;) {
          path[n++] = a;
          const int up = par[a];
          if (up >= a) break;
          a = up;
        }
        path[Q] = n;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRange; ++j) w[j] = sr[j];
      for (int s = path[Q] - 1; s >= 0; --s) {
        const int a = path[s];
        step_all(w, lam, ks + a * D + off, vs[a * kSlab + c], rl);
      }
    }
    step_all(w, lam, ks + i * D + off, vs[i * kSlab + c], rl);
    readout(i, w);
    prev = i;
  }
}

// ---------------------------------------------------------------------------
// commit: each row's accepted chain into its slot's state, every layer
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRecThreads) la_commit_kernel(
    LaStatic st, float* __restrict__ state, const float* __restrict__ win_k,
    const float* __restrict__ win_v, const void* __restrict__ slot_ids,
    const void* __restrict__ chain, const void* __restrict__ n_commit,
    const float* __restrict__ loglam) {
  extern __shared__ __align__(16) float smem[];
  const int l = blockIdx.z / st.B, b = blockIdx.z % st.B, h = blockIdx.y, tid = threadIdx.x;
  const int D = st.D, rl = D / kSplit, M = st.M;
  const long long nc = ld_index(n_commit, st.lens_wide, b * st.lens_stride);
  const int n = (int)min(nc, (long long)M);
  if (n <= 0) return;
  const int c = tid % kSlab, r = tid / kSlab, e0 = blockIdx.x * kSlab, e = e0 + c;
  float* ks = smem;                                        // [M][D]
  float* vs = ks + M * D;                                  // [M][kSlab]
  int* cols = reinterpret_cast<int*>(vs + M * kSlab);      // [M]
  const long long slot = slot_of(st, slot_ids, b);
  float* S = state + l * st.layer_stride + ((slot * st.H + h) * D + (long long)r * rl) * D + e;
  float s[kRange];
#pragma unroll
  for (int j = 0; j < kRange; ++j)
    if (j < rl) s[j] = S[(long long)j * D];
  for (int p = tid; p < n; p += kRecThreads)
    cols[p] = (int)ld_index(chain, st.idx_wide, b * st.idx_stride[0] + p * st.idx_stride[1]);
  __syncthreads();
  const long long head = l * st.win_layer + b * st.xs[1][0] + h * st.xs[1][1];
  stage_window(ks, win_k + head, st.xs[1][2], cols, n, D, tid, kRecThreads);
  stage_window(vs, win_v + head + e0, st.xs[1][2], cols, n, kSlab, tid, kRecThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float lam = expf(loglam[l * st.H + h]);
  for (int i = 0; i < n; ++i) step_all(s, lam, ks + i * D + r * rl, vs[i * kSlab + c], rl);
#pragma unroll
  for (int j = 0; j < kRange; ++j)
    if (j < rl) S[(long long)j * D] = s[j];
}

// ---------------------------------------------------------------------------
// chunk mode: 3xTF32 tensor-core products
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32's result for a finite x, in two integer operations (the
// conversion unit that cvt takes runs at a quarter of their rate)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (the residual x - hi is exact in fp32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the two small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// An m16n8k8 A fragment (row-major, lda floats a row) at (row0, col0), split.
__device__ __forceinline__ void frag_a(const float* a, int lda, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(a[g * lda + t], hi[0], lo[0]);
  split(a[(g + 8) * lda + t], hi[1], lo[1]);
  split(a[g * lda + t + 4], hi[2], lo[2]);
  split(a[(g + 8) * lda + t + 4], hi[3], lo[3]);
}

// A B fragment whose element (k, n) sits at b[k * ldk + n * ldn], split.
__device__ __forceinline__ void frag_b(const float* b, int ldk, int ldn, int g, int t,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split(b[t * ldk + g * ldn], hi[0], lo[0]);
  split(b[(t + 4) * ldk + g * ldn], hi[1], lo[1]);
}

// The valid tokens of row b (chunk_lens[b], at most C), and of its tile
// (at most kTile; 0 or less past the row's end).
__device__ __forceinline__ int row_tokens(const LaStatic& st, const void* chunk_lens, int b,
                                          int C) {
  return (int)min(ld_index(chunk_lens, st.lens_wide, b * st.lens_stride), (long long)C);
}
__device__ __forceinline__ int tile_tokens(const LaStatic& st, const void* chunk_lens, int b,
                                           int tile, int C) {
  return min(kTile, row_tokens(st, chunk_lens, b, C) - tile * kTile);
}

// pd[p] = l^p = exp(loglam * p) for p in [0, kTile]
__device__ __forceinline__ void decay_table(float* pd, float ll, int tid, int threads) {
  for (int p = tid; p <= kTile; p += threads) pd[p] = expf(ll * (float)p);
}

// rows [0, kTile) of a tile, D floats each from src + i * ld, into dst
// (dst_ld floats a row); rows at or past n are zero-filled
__device__ __forceinline__ void stage_rows(float* dst, int dst_ld, const float* src,
                                           long long ld, int n, int cols, int tid,
                                           int threads) {
  const int cpr = cols / 4;
  for (int p = tid; p < kTile * cpr; p += threads) {
    const int i = p / cpr, c4 = (p - i * cpr) * 4;
    const bool ok = i < n;
    cp_async16(dst + i * dst_ld + c4, ok ? src + i * ld + c4 : src, ok ? 16 : 0);
  }
}

// Pass 1, per (row, head, tile), all in parallel: the tile's state increment
// dS = (w k)^T v, w_j = l^(n-1-j), into its slot of the workspace. Warps
// split dS [D, D] into 16 x 8 tiles: warp w takes d-tile w % (D / 16) and
// every (8 / (D / 16))-th 8-column tile from w / (D / 16).
template <int D>
__global__ void __launch_bounds__(kChunkThreads) la_chunk_delta_kernel(
    LaStatic st, const float* __restrict__ xk, const float* __restrict__ xv,
    const void* __restrict__ chunk_lens, const float* __restrict__ loglam,
    float* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VS = D + kVPad;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, C = st.Q;
  const int n = tile_tokens(st, chunk_lens, b, tile, C);
  if (n <= 0) return;
  const int t0 = tile * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  float* ksm = smem;                 // [kTile][VS]
  float* vsm = ksm + kTile * VS;     // [kTile][VS]
  float* pd = vsm + kTile * VS;      // [kTile + 4]: l^p
  stage_rows(ksm, VS, xk + b * st.xs[1][0] + h * st.xs[1][1] + t0 * st.xs[1][2], st.xs[1][2],
             n, D, tid, kChunkThreads);
  stage_rows(vsm, VS, xv + b * st.xs[2][0] + h * st.xs[2][1] + t0 * st.xs[2][2], st.xs[2][2],
             n, D, tid, kChunkThreads);
  cp_async_commit();
  decay_table(pd, loglam[h], tid, kChunkThreads);
  cp_async_wait<0>();
  __syncthreads();

  constexpr int mtiles = D / 16, ntiles = D / 8, groups = kChunkWarps / mtiles;
  if (warp >= groups * mtiles) return;
  const int d0 = (warp % mtiles) * 16, grp = warp / mtiles;
  constexpr int per = (ntiles + groups - 1) / groups;  // 8-column tiles a warp
  float acc[per][4] = {};
  for (int s = 0; s * 8 < n; ++s) {
    const int ja = s * 8 + t4, jb = ja + 4;
    const float wa = ja < n ? pd[n - 1 - ja] : 0.f;
    const float wb = jb < n ? pd[n - 1 - jb] : 0.f;
    uint32_t ah[4], al[4];
    split(__fmul_rn(ksm[ja * VS + d0 + g], wa), ah[0], al[0]);
    split(__fmul_rn(ksm[ja * VS + d0 + g + 8], wa), ah[1], al[1]);
    split(__fmul_rn(ksm[jb * VS + d0 + g], wb), ah[2], al[2]);
    split(__fmul_rn(ksm[jb * VS + d0 + g + 8], wb), ah[3], al[3]);
#pragma unroll
    for (int jj = 0; jj < per; ++jj) {
      const int nt = grp + jj * groups;
      if (nt < ntiles) {
        uint32_t bh[2], bl[2];
        frag_b(vsm + s * 8 * VS + nt * 8, VS, 1, g, t4, bh, bl);
        mma3(acc[jj], ah, al, bh, bl);
      }
    }
  }
  float* wt = work + ((((long long)b * st.H + h) * st.tiles + tile) * D + d0) * D;
#pragma unroll
  for (int jj = 0; jj < per; ++jj) {
    const int nt = grp + jj * groups;
    if (nt < ntiles) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(wt + (g + 8 * half) * D + nt * 8 + 2 * t4) =
            make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
    }
  }
}

// Pass 2, per (row, head, 4 x kScanThreads state elements): the state
// carried over the row's tiles in order, elementwise, S <- l^n S + dS; the
// state each tile enters with goes to its slot of the second half of the
// workspace (written over its dS, the pass ran slower), the last state to
// the engine slot. Loads run kScanAhead tiles ahead.
__global__ void __launch_bounds__(kScanThreads) la_chunk_scan_kernel(
    LaStatic st, float* __restrict__ state, const void* __restrict__ slot_ids,
    const void* __restrict__ chunk_lens, const float* __restrict__ loglam,
    const float* __restrict__ delta, float* __restrict__ enter) {
  const int h = blockIdx.y, b = blockIdx.z, D = st.D;
  const int n_tot = row_tokens(st, chunk_lens, b, st.Q);
  const int e = (blockIdx.x * kScanThreads + threadIdx.x) * 4;
  if (n_tot <= 0 || e >= D * D) return;  // no tokens: no state
  const long long slot = slot_of(st, slot_ids, b);
  float4* sp = reinterpret_cast<float4*>(state + (slot * st.H + h) * D * D + e);
  const long long head = ((long long)b * st.H + h) * st.tiles * D * D + e;
  const float4* wp = reinterpret_cast<const float4*>(delta + head);
  float4* ep = reinterpret_cast<float4*>(enter + head);
  const long long step = (long long)D * D / 4;  // float4s a tile
  const float ll = loglam[h];
  const float l_full = expf(ll * (float)kTile);
  const int T = (n_tot + kTile - 1) / kTile;
  float4 s = *sp;
  for (int t0 = 0; t0 < T; t0 += kScanAhead) {
    float4 d[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u)
      if (t0 + u < T) d[u] = wp[(t0 + u) * step];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const int t = t0 + u;
      if (t < T) {
        const int n = min(kTile, n_tot - t * kTile);
        const float ln = n == kTile ? l_full : expf(ll * (float)n);
        ep[t * step] = s;
        s = make_float4(__fadd_rn(__fmul_rn(ln, s.x), d[u].x), __fadd_rn(__fmul_rn(ln, s.y), d[u].y),
                        __fadd_rn(__fmul_rn(ln, s.z), d[u].z), __fadd_rn(__fmul_rn(ln, s.w), d[u].w));
      }
    }
  }
  *sp = s;
}

// Pass 3, per (row, head, tile), all in parallel: out = A v + l^(i+1) q S,
// with A = (q k^T) * l^(i-j) masked to j <= i < n and S the state the tile
// enters with (pass 2); zeros past n. Warp w takes the 16 rows of w % 4
// and the value columns of half w / 4, for q S and A v alike.
// (Two blocks a tile, each with half of the value columns and the tile's
// scores, three an SM, ran slower.)
template <int D>
__global__ void __launch_bounds__(kChunkThreads) la_chunk_out_kernel(
    LaStatic st, const float* __restrict__ xq, const float* __restrict__ xk,
    const float* __restrict__ xv, const void* __restrict__ chunk_lens,
    const float* __restrict__ loglam, const float* __restrict__ enter,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QS = D + kQPad, VS = D + kVPad, nper = D / 16;  // 8-column tiles a warp
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = st.Q, t0 = tile * kTile, rows = min(kTile, C - t0);
  const int n = max(0, tile_tokens(st, chunk_lens, b, tile, C));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  float* ob = out + (((long long)b * st.H + h) * C + t0) * D;
  if (n == 0) {  // past the row's tokens: zeros
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = tid; p < rows * D / 4; p += kChunkThreads) reinterpret_cast<float4*>(ob)[p] = z;
    return;
  }
  // two regions, each refilled as the block moves on: q, then the scores
  // (R1); S, then k, then v (R2). About 100 KB: two blocks an SM at D = 128
  constexpr int R1 = kTile * (QS > kAPad ? QS : kAPad);
  constexpr int R2 = (D > kTile ? D : kTile) * VS;
  float* r1 = smem;
  float* r2 = r1 + R1;
  float* pd = r2 + R2;  // [kTile + 4]: l^p
  stage_rows(r1, QS, xq + b * st.xs[0][0] + h * st.xs[0][1] + t0 * st.xs[0][2], st.xs[0][2],
             n, D, tid, kChunkThreads);
  const float* sg = enter + (((long long)b * st.H + h) * st.tiles + tile) * D * D;
  for (int p = tid; p < D * (D / 4); p += kChunkThreads) {  // S: D rows of D
    const int d = p / (D / 4), c4 = (p % (D / 4)) * 4;
    cp_async16(r2 + d * VS + c4, sg + (long long)d * D + c4, 16);
  }
  cp_async_commit();
  decay_table(pd, loglam[h], tid, kChunkThreads);
  cp_async_wait<0>();
  __syncthreads();

  const int mt = warp & 3, sub = warp >> 2, i0 = mt * 16;
  const bool live_rows = i0 < n;
  float inter[nper][4] = {}, sc[4][4] = {};
  if (live_rows) {  // q S
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a(r1 + i0 * QS + k0, QS, g, t4, ah, al);
#pragma unroll
      for (int jj = 0; jj < nper; ++jj) {
        uint32_t bh[2], bl[2];
        frag_b(r2 + k0 * VS + (sub * nper + jj) * 8, VS, 1, g, t4, bh, bl);
        mma3(inter[jj], ah, al, bh, bl);
      }
    }
  }
  __syncthreads();  // every read of S done: k takes its place
  stage_rows(r2, QS, xk + b * st.xs[1][0] + h * st.xs[1][1] + t0 * st.xs[1][2], st.xs[1][2],
             n, D, tid, kChunkThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (live_rows) {  // q k^T: the 16 x 8 tiles on or below the diagonal
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a(r1 + i0 * QS + k0, QS, g, t4, ah, al);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j0 = (sub + 2 * jj) * 8;
        if (j0 <= i0 + 15 && j0 < n) {
          uint32_t bh[2], bl[2];
          frag_b(r2 + j0 * QS + k0, 1, QS, g, t4, bh, bl);
          mma3(sc[jj], ah, al, bh, bl);
        }
      }
    }
  }
  __syncthreads();  // every read of q and k done: the scores and v take their places
  stage_rows(r2, VS, xv + b * st.xs[2][0] + h * st.xs[2][1] + t0 * st.xs[2][2], st.xs[2][2],
             n, D, tid, kChunkThreads);
  cp_async_commit();
  float* As = r1;
  if (live_rows) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j0 = (sub + 2 * jj) * 8;
      if (j0 <= i0 + 15 && j0 < n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + g + 8 * half;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int j = j0 + 2 * t4 + cc;
            As[i * kAPad + j] =
                (j <= i && i < n) ? __fmul_rn(sc[jj][2 * half + cc], pd[i - j]) : 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float intra[nper][4] = {};
  if (live_rows) {
    for (int j0 = 0; j0 <= i0 + 15 && j0 < n; j0 += 8) {  // A v
      uint32_t ah[4], al[4];
      frag_a(As + i0 * kAPad + j0, kAPad, g, t4, ah, al);
#pragma unroll
      for (int jj = 0; jj < nper; ++jj) {
        uint32_t bh[2], bl[2];
        frag_b(r2 + j0 * VS + (sub * nper + jj) * 8, VS, 1, g, t4, bh, bl);
        mma3(intra[jj], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < nper; ++jj) {
    const int e = (sub * nper + jj) * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + g + 8 * half;
      if (i < rows) {
        float2 val = make_float2(0.f, 0.f);
        if (i < n) {
          const float li = pd[i + 1];
          val = make_float2(__fadd_rn(intra[jj][2 * half], __fmul_rn(li, inter[jj][2 * half])),
                            __fadd_rn(intra[jj][2 * half + 1],
                                      __fmul_rn(li, inter[jj][2 * half + 1])));
        }
        *reinterpret_cast<float2*>(ob + (long long)i * D + e) = val;
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Chunk mode's three passes at head dim D.
template <int D>
cudaError_t launch_chunk(const LaStatic& st, const float* q, const float* k, const float* v,
                         float* state, const void* slot_ids, const void* chunk_lens,
                         const float* ll, float* work, float* out, cudaStream_t s) {
  cudaError_t err = allow_smem(la_chunk_delta_kernel<D>, st.smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(la_chunk_out_kernel<D>, st.smem2);
  if (err != cudaSuccess) return err;
  const dim3 tiles(st.tiles, st.H, st.B);
  const int scan_blocks = (D * D / 4 + kScanThreads - 1) / kScanThreads;
  float* enter = work + (long long)st.B * st.H * st.tiles * D * D;
  la_chunk_delta_kernel<D><<<tiles, kChunkThreads, st.smem, s>>>(st, k, v, chunk_lens, ll, work);
  la_chunk_scan_kernel<<<dim3(scan_blocks, st.H, st.B), kScanThreads, 0, s>>>(
      st, state, slot_ids, chunk_lens, ll, work, enter);
  la_chunk_out_kernel<D><<<tiles, kChunkThreads, st.smem2, s>>>(st, q, k, v, chunk_lens, ll,
                                                                 enter, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* pia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xq, xk, xv [B, H, C, D] fp32 (strides in st, last axis contiguous, rows
// on 16-byte boundaries); out [B, H, C, D] contiguous; state [slots, H, D,
// D] contiguous (one layer's arena, read and written at slot_ids[b], or
// row b with slot_ids null); chunk_lens, slot_ids [B] int32 / int64; loglam
// [H] fp32; work: 2 * B * H * st->tiles * D * D fp32 of workspace. Three
// kernels: the tiles' increments, the carry over the tiles, the outputs.
extern "C" int la_chunk(const LaStatic* st, const void* xq, const void* xk, const void* xv,
                        void* state, const void* slot_ids, const void* chunk_lens,
                        const void* loglam, void* work, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(xq);
  const auto* k = static_cast<const float*>(xk);
  const auto* v = static_cast<const float*>(xv);
  const auto* ll = static_cast<const float*>(loglam);
  auto* w = static_cast<float*>(work);
  auto* S = static_cast<float*>(state);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  switch (st->D) {  // the head dims the plan takes: multiples of 16 up to kMaxD
#define PIA_LA_CHUNK(DD) \
    case DD: err = launch_chunk<DD>(*st, q, k, v, S, slot_ids, chunk_lens, ll, w, o, s); break;
    PIA_LA_CHUNK(16) PIA_LA_CHUNK(32) PIA_LA_CHUNK(48) PIA_LA_CHUNK(64)
    PIA_LA_CHUNK(80) PIA_LA_CHUNK(96) PIA_LA_CHUNK(112) PIA_LA_CHUNK(128)
#undef PIA_LA_CHUNK
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// xq, xk, xv [B, H, 1, D] fp32 (strides in st); out [B, H, 1, D]
// contiguous; valid [B, 1] bool; the step written back to the slot.
extern "C" int la_decode(const LaStatic* st, const void* xq, const void* xk, const void* xv,
                         void* state, const void* slot_ids, const void* valid,
                         const void* loglam, void* out, void* stream) {
  la_decode_kernel<<<dim3(st->slabs, st->H, st->B), kRecThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      *st, static_cast<const float*>(xq), static_cast<const float*>(xk),
      static_cast<const float*>(xv), static_cast<float*>(state), slot_ids,
      static_cast<const bool*>(valid), static_cast<const float*>(loglam),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// xq, xk, xv [B, H, Q, D] fp32; parents [B, Q] int32 / int64 (-1 the root,
// -2 a dead node, else an earlier node); valid [B, Q] bool; out [B, H, Q,
// D] contiguous; the state is only read.
extern "C" int la_tree(const LaStatic* st, const void* xq, const void* xk, const void* xv,
                       const void* state, const void* slot_ids, const void* parents,
                       const void* valid, const void* loglam, void* out, void* stream) {
  cudaError_t err = allow_smem(la_tree_kernel, st->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  la_tree_kernel<<<dim3(st->slabs, st->H, st->B), kRecThreads, st->smem,
                   static_cast<cudaStream_t>(stream)>>>(
      *st, static_cast<const float*>(xq), static_cast<const float*>(xk),
      static_cast<const float*>(xv), static_cast<const float*>(state), slot_ids, parents,
      static_cast<const bool*>(valid), static_cast<const float*>(loglam),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// state [n_lin, slots, H, D, D] fp32 contiguous; win_k, win_v [n_lin, B, H,
// Q, D] fp32 (strides in st); chain [B, M] window columns of the committed
// nodes in order, n_commit [B], slot_ids [B] int32 / int64; loglam [n_lin,
// H] fp32 contiguous.
extern "C" int la_commit(const LaStatic* st, void* state, const void* win_k,
                         const void* win_v, const void* slot_ids, const void* chain,
                         const void* n_commit, const void* loglam, void* stream) {
  cudaError_t err = allow_smem(la_commit_kernel, st->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  la_commit_kernel<<<dim3(st->slabs, st->H, st->n_lin * st->B), kRecThreads, st->smem,
                     static_cast<cudaStream_t>(stream)>>>(
      *st, static_cast<float*>(state), static_cast<const float*>(win_k),
      static_cast<const float*>(win_v), slot_ids, chain, n_commit,
      static_cast<const float*>(loglam));
  return static_cast<int>(cudaGetLastError());
}
