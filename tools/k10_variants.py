#!/usr/bin/env python3
"""Build variants of the bf16 GEMM (K10: csrc/grouped_gemm.cu over the body
csrc/bf16_wgmma.cuh) from this checkout's sources and time each beside the
kernel as it is, on one card:

    python3 tools/k10_variants.py [--json PATH] [--split-only]

Variants try a choice, kept or not:
- block barrier: no producer warp past the first ring fill: after each
  stage the multiplying warps meet at a barrier and thread 0 refills the
  slot they left (the weight-only body's ring, less its unpacking);
- wait0: each stage's products are waited for before the next stage is
  issued (no wgmma in flight across stages);
- cols first: the column blocks of one row tile are launched next to each
  other, instead of the row tiles of one column block (dense and batched);
- map cache: the tensor maps made are kept in a table keyed by their
  arguments, and a call whose maps are there copies them instead of
  encoding two (not kept: no host time saved);
Two take a piece away (wrong results by design; only their times count):
- no plane sum: the last block of a tile reads no split plane;
- no fences: the split blocks' memory fences;
and two more try a choice:
- grouped rows first / grouped cols first: the grouped entry walks its
  grid by whole columns of row blocks, or by whole rows of column blocks,
  instead of in bands of 8 row blocks.

The host: one tensor-map encode (cuTensorMapEncodeTiled through ctypes, less
a no-op driver call through ctypes), and per variant the host-clock time
of the dense entry's C call alone at M = 1 (3000 calls back to back, no
Python wrapper), which the map cache would change.

The split launch: at W = 2 (M > 64) the dense entry's K splits launched as
blocks (fp32 planes, summed by the last block of each tile) against every
split in one block, at M = 128 to 1024 over the shapes of the card's
models, and the grouped entry's likewise over the expert shapes of the
card's MoE models whose split count is above 1 (Mixtral-8x7B's down
projection, DeepSeek-V2-Lite's, Ring-mini-linear-2.0's, Qwen3-30B-A3B's and
DeepSeek-V3's gate/up or down) at 1 to 512 routed tokens; each row names
the launch that ops/moe_matmul.py bf16_split_blocks picks (the plan's) and
the one the other tensor-core GEMMs' rule, split_blocks, would pick.
``--split-only`` times these alone, without the variants.

Times are the kernels' device time in a CUDA graph of 10 calls, replayed 3
times between CUDA events, the variants in turns (as is, variants, as is),
and at decode widths also the host-clock time a call of 400 back to back
(the wrapper's host time included): the dense entry at M = 1, 17, 512 and 4096
(a 4096 x 6144 wqkv), Mixtral's router (4096 x 8, fp32 out) at M = 1 and
the fp32 LM head (4096 x 32000) at M = 512, the batched entry at 16 heads and M
= 4096 (K = 128, N = 512 and K = 512, N = 128), and the grouped entry over
2 and 8192 routed rows of Mixtral-8x7B (8 experts, top 2, gate/up K = 4096,
N = 28672). Sources and libraries go to build/k10_variants/ beside the
package. Needs a card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from k7_variants import graph_ms  # noqa: E402

BODY = "bf16_wgmma.cuh"
ENTRY = "grouped_gemm.cu"
PLAIN_MAPS = """// The two maps of a call: x [planes, rows, K]; w [planes, K, N] or
// (k_major) [1, N, K]; all bf16, in the 128-byte swizzle.
template <int W>
inline bool make_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* w,
                      int x_planes, int rows, int K, int w_planes, int N, bool k_major) {
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  return make_map_3d(xm, x, bf16, 2, K, rows, x_planes, kStage, Tile<W>::kRows, sw) &&
         (k_major ? make_map_3d(wm, w, bf16, 2, K, N, 1, kStage, kCols, sw)
                  : make_map_3d(wm, w, bf16, 2, N, K, w_planes, 64, kStage, sw));
}
"""
MAP_CACHE = """// the maps made, kept in a table of kMapSlots keyed by their arguments
struct MapArgs {
  const void* ptr;
  uint64_t d0, d1, d2;
  uint32_t b0, b1;
  bool operator==(const MapArgs& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 && b0 == o.b0 && b1 == o.b1;
  }
};

constexpr int kMapSlots = 1024;

inline bool bf16_map(CUtensorMap* map, const MapArgs& a) {
  static std::mutex mu;
  static MapArgs keys[kMapSlots];
  static CUtensorMap maps[kMapSlots];
  static bool used[kMapSlots];
  const uint64_t h = (reinterpret_cast<uint64_t>(a.ptr) >> 4) * 0x9E3779B97F4A7C15ull ^
                     (a.d0 * 31 + a.d1) * 0xC2B2AE3D27D4EB4Full ^ (a.d2 * 131 + a.b1);
  const int slot = (int)((h ^ (h >> 29)) % kMapSlots);
  std::lock_guard<std::mutex> lock(mu);
  if (used[slot] && keys[slot] == a) {
    *map = maps[slot];
    return true;
  }
  if (!make_map_3d(map, a.ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.d0, a.d1, a.d2, a.b0,
                   a.b1, CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  keys[slot] = a;
  maps[slot] = *map;
  used[slot] = true;
  return true;
}

// The two maps of a call: x [planes, rows, K]; w [planes, K, N] or
// (k_major) [1, N, K].
template <int W>
inline bool make_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* w,
                      int x_planes, int rows, int K, int w_planes, int N, bool k_major) {
  const MapArgs xa{x, (uint64_t)K, (uint64_t)rows, (uint64_t)x_planes, kStage, Tile<W>::kRows};
  const MapArgs wa = k_major ? MapArgs{w, (uint64_t)K, (uint64_t)N, 1, kStage, kCols}
                             : MapArgs{w, (uint64_t)N, (uint64_t)K, (uint64_t)w_planes, 64, kStage};
  return bf16_map(xm, xa) && bf16_map(wm, wa);
}
"""
VARIANTS = {
    "block barrier": [
        (BODY, "      for (int it = 0; it < n_g; ++it) {\n        const int slot = it % S;\n"
               "        if (it >= S)",
         "      for (int it = 0; it < n_g && it < S; ++it) {\n        const int slot = it % S;\n"
         "        if (it >= S)"),
        (BODY, "      wgmma_wait1();  // the previous stage's products are done: free its slot\n"
               "      if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));",
         "      wgmma_wait0();\n"
         "      asm volatile(\"bar.sync 1, %0;\" ::\"r\"(128 * n_mma) : \"memory\");\n"
         "      if (threadIdx.x == 0 && it + S < n_g) {\n"
         "        const uint32_t bar = full + 8 * slot;\n"
         "        const int k0 = (g_begin + it + S) * kStage;\n"
         "        uint8_t* wdst = ws + slot * T::kWBytes;\n"
         "        mbar_expect(bar, T::kStageBytes);\n"
         "        tma_load_3d(smem_u32(xs + slot * T::kXBytes), op.x, k0, m0, op.x_plane, bar);\n"
         "        if (kKMajor) {\n"
         "          tma_load_3d(smem_u32(wdst), op.w, k0, n0, op.w_plane, bar);\n"
         "        } else {\n"
         "          tma_load_3d(smem_u32(wdst), op.w, n0, k0, op.w_plane, bar);\n"
         "          tma_load_3d(smem_u32(wdst + kMnBox), op.w, n0 + 64, k0, op.w_plane, bar);\n"
         "        }\n"
         "      }")],
    "wait0": [
        (BODY, "      wgmma_wait1();  // the previous stage's products are done: free its slot",
         "      wgmma_wait0();")],
    "cols first": [
        (ENTRY, "  const int m0 = blockIdx.x * Tile<W>::kRows;\n  // one split",
         "  const int m0 = blockIdx.y * Tile<W>::kRows;\n  // one split"),
        (ENTRY, "  const Splits sp{part, M, (int)blockIdx.z, (int)gridDim.z,\n"
                "                  count + blockIdx.y * gridDim.x + blockIdx.x};\n"
                "  gemm_tile<W, kKMajor, kSeq>(Operands{&xm, &wm, 0, 0}, sp, out, out_f32, M, N, m0,\n"
                "                              blockIdx.y * kCols,",
         "  const Splits sp{part, M, (int)blockIdx.z, (int)gridDim.z,\n"
         "                  count + blockIdx.y * gridDim.x + blockIdx.x};\n"
         "  gemm_tile<W, kKMajor, kSeq>(Operands{&xm, &wm, 0, 0}, sp, out, out_f32, M, N, m0,\n"
         "                              blockIdx.x * kCols,"),
        (ENTRY, "  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);",
         "  dim3 grid((N + kCols - 1) / kCols, (M + T::kRows - 1) / T::kRows, split_blocks);"),
        (ENTRY, "  const int g = blockIdx.z;\n  const int m0 = blockIdx.x * Tile<W>::kRows;",
         "  const int g = blockIdx.z;\n  const int m0 = blockIdx.y * Tile<W>::kRows;"),
        (ENTRY, "                            blockIdx.y * kCols, min(M - m0, Tile<W>::kRows), 0,",
         "                            blockIdx.x * kCols, min(M - m0, Tile<W>::kRows), 0,"),
        (ENTRY, "  dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, G);",
         "  dim3 grid((N + kCols - 1) / kCols, (M + T::kRows - 1) / T::kRows, G);")],
    "no plane sum": [
        (BODY, "if (u < units && n < N && k0 + k < sp.n_splits)", "if (false)")],
    "no fences": [
        (BODY, "  __threadfence();\n  sync_warpgroups<W>();", "  sync_warpgroups<W>();"),
        (BODY, "  if (!last) return;\n  __threadfence();", "  if (!last) return;")],
    "map cache": [(BODY, PLAIN_MAPS, MAP_CACHE),
                  (BODY, "#include <cuda_bf16.h>\n", "#include <cuda_bf16.h>\n#include <mutex>\n")],
    "grouped rows first": [
        (ENTRY, "constexpr int kBand = 8;", "constexpr int kBand = 1 << 20;")],
    "grouped cols first": [
        (ENTRY, "constexpr int kBand = 8;", "constexpr int kBand = 1;")],
}
SPLIT_SHAPES = ((4096, 6144), (4096, 4096), (4096, 14336), (14336, 4096), (11008, 4096),
                (2048, 576), (2048, 2816), (1408, 2048))
# (model, projection): (K, N, experts, top-k) of the grouped entry
GROUPED_SPLIT_SHAPES = {"mixtral down": (14336, 4096, 8, 2),
                        "v2-lite gate/up": (2048, 2816, 64, 6),
                        "v2-lite down": (1408, 2048, 64, 6),
                        "ring gate/up": (2048, 1024, 256, 8),
                        "qwen3 gate/up": (2048, 1536, 128, 8),
                        "deepseek-v3 gate/up": (7168, 4096, 256, 8),
                        "deepseek-v3 down": (2048, 7168, 256, 8)}
GROUPED_SPLIT_TOKENS = (1, 2, 4, 8, 17, 136, 512)


def host_us(fn, calls: int = 3000) -> float:
    """Host-clock microseconds a call of ``calls`` back to back, the queue
    drained after the clock stops: the host's cost of a call."""
    import time

    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def encode_us(w) -> float:
    """Host microseconds of one cuTensorMapEncodeTiled of a bf16 [K, N]
    weight's MN-major map, less a no-op driver call through ctypes."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    enc = cuda.cuTensorMapEncodeTiled
    enc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 4
    K, N = w.shape
    m = (ctypes.c_uint8 * 128)()
    dims = (ctypes.c_uint64 * 3)(N, K, 1)
    strides = (ctypes.c_uint64 * 2)(N * 2, N * K * 2)
    box, unit = (ctypes.c_uint32 * 3)(64, 64, 1), (ctypes.c_uint32 * 3)(1, 1, 1)
    bf16, swizzle_128b, l2_256b = 9, 3, 3  # the CUtensorMap enums' values
    ptr = ctypes.c_void_p(w.data_ptr())
    if enc(m, bf16, 3, ptr, dims, strides, box, unit, 0, swizzle_128b, l2_256b, 0):
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    version = ctypes.c_int()
    noop = host_us(lambda: cuda.cuDriverGetVersion(ctypes.byref(version)), 20000)
    return host_us(lambda: enc(m, bf16, 3, ptr, dims, strides, box, unit, 0, swizzle_128b,
                               l2_256b, 0), 20000) - noop


def wall_ms(fn, calls: int = 400) -> float:
    """Host-clock time a call of ``calls`` back to back, ended by a
    synchronize: the wrapper's host time where it is longer than the
    kernel's."""
    import time

    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def variant(b, name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` ((file, old, new), ...) applied."""
    import shutil

    root = b.PKG_DIR.parent / "build" / "k10_variants" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(b.PKG_DIR / "csrc", root / "csrc")
    for file, old, new in edits:
        path = root / "csrc" / file
        src = path.read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not once in {file}")
        path.write_text(src.replace(old, new))
    return root


def use(b, root) -> None:
    """Point the build at the sources under ``root`` (None: as they are)."""
    b.CSRC_DIR = b.PKG_DIR / "csrc" if root is None else root / "csrc"
    b.BUILD_DIR = (b.PKG_DIR.parent / "build" / "torch_kernels" if root is None
                   else root / "lib")
    b._LIBS.clear()
    b._FNS.clear()
    b.build_all()


def split_launches(b, mm, g) -> dict:
    """Device ms of the dense entry at W = 2 with its K splits launched as
    blocks and with every split in one block."""
    import torch

    from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import split_blocks

    out = {}
    for M in (128, 256, 512, 1024):
        for K, N in SPLIT_SHAPES:
            plan = mm.bf16_plan(M, K, N)
            if plan.ksplit == 1:
                continue
            x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
            w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
            o = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            work = torch.empty(plan.ksplit, M, N, dtype=torch.float32, device="cuda")
            count = torch.zeros(plan.grid[0] * plan.grid[1], dtype=torch.int32, device="cuda")
            lib, fn = b.function("grouped_gemm", "bf16_gemm", mm._DENSE_BF16_ARGS)
            row = {}
            for sb in (plan.ksplit, 1):
                row[f"split_blocks={sb}"] = graph_ms(lambda: b.check(lib, fn(
                    x.data_ptr(), w.data_ptr(), o.data_ptr(), work.data_ptr(),
                    count.data_ptr(), M, K, N, 0, 0, sb, plan.stages_per_split, 2,
                    b.stream_of(x)), "bf16_gemm"))
            shared = split_blocks(plan.ksplit, plan.grid[0], plan.grid[1])
            key = (f"M={M} K={K} N={N} ksplit={plan.ksplit} plan_split_blocks={plan.grid[2]} "
                   f"shared_rule={shared}")
            out[key] = row
            print(key, row, flush=True)
    return out


def grouped_split_launches(b, mm, g) -> dict:
    """Device ms of the grouped entry with its K splits launched as blocks
    and with every split in one block, over routings of T tokens."""
    import torch

    from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import split_blocks

    out = {}
    lib, fn = b.function("grouped_gemm", "grouped_gemm", mm._GROUPED_BF16_ARGS)
    for name, (K, N, X, k) in GROUPED_SPLIT_SHAPES.items():
        w = torch.randn(X, K, N, generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
        for T in GROUPED_SPLIT_TOKENS:
            topi = torch.rand(T, X, generator=g, device="cuda").argsort(dim=1)[:, :k]
            dest_tok, _, be, nu = mm.moe_align(topi.to(torch.int32),
                                               torch.rand(T, k, generator=g, device="cuda"),
                                               X, T)
            rows = mm._block_rows(dest_tok, T)
            x = torch.randn(T + 1, K, generator=g, device="cuda", dtype=torch.bfloat16)
            x[T] = 0  # the row that padding rows read
            xg = x[dest_tok.long()]
            R = xg.shape[0]
            plan = mm.grouped_bf16_plan(R, K, N, X, T * k)
            cols, row_blocks = plan.grid[:2]
            o = torch.empty(R, N, dtype=torch.bfloat16, device="cuda")
            work = torch.empty(plan.ksplit, row_blocks * mm.BLOCK_M, N, dtype=torch.float32,
                               device="cuda")
            count = torch.zeros(cols * row_blocks, dtype=torch.int32, device="cuda")
            res = {}
            for sb in (plan.ksplit, 1):
                res[f"split_blocks={sb}"] = graph_ms(lambda: b.check(lib, fn(
                    xg.data_ptr(), w.data_ptr(), be.data_ptr(), nu.data_ptr(),
                    rows.data_ptr(), o.data_ptr(), work.data_ptr(), count.data_ptr(),
                    R, K, N, X, 0, sb, plan.stages_per_split, row_blocks,
                    b.stream_of(x)), "grouped_gemm"))
            shared = split_blocks(plan.ksplit, cols, row_blocks)
            key = (f"{name} K={K} N={N} T={T} pairs={T * k} row_blocks={row_blocks} "
                   f"ksplit={plan.ksplit} plan_split_blocks={plan.grid[2]} shared_rule={shared}")
            out[key] = res
            print(key, res, flush=True)
        del w
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write the results here")
    ap.add_argument("--split-only", action="store_true",
                    help="time the split launches alone, without the variants")
    cli = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k10_variants: torch.cuda is not available")
    from painlessinferenceacceleration_tpu_torch import _build as b
    from painlessinferenceacceleration_tpu_torch.ops import moe_matmul as mm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    b.SOURCES = ("grouped_gemm",)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = dict(card=card)
    if cli.split_only:
        use(b, None)
        out.update(split_launch_ms=split_launches(b, mm, g),
                   grouped_split_launch_ms=grouped_split_launches(b, mm, g))
        write(cli.json, out)
        return

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    wqkv, head = bf16(4096, 6144, scale=0.02), bf16(4096, 32000, scale=0.02)
    xs = {M: bf16(M, 4096) for M in (1, 17, 512, 4096)}
    cases = {f"dense M={M} 4096x6144": (lambda x=x: mm.dense_matmul(x, wqkv))
             for M, x in xs.items()}
    cases["dense M=512 LM head 4096x32000 fp32"] = lambda: mm.dense_matmul(
        xs[512], head, torch.float32)
    router = bf16(4096, 8, scale=0.02)
    cases["router M=1 4096x8 fp32"] = lambda: mm.dense_matmul(xs[1], router, torch.float32)
    walls = ("dense M=1 4096x6144", "dense M=17 4096x6144", "router M=1 4096x8 fp32")
    for K, N in ((128, 512), (512, 128)):
        xb, wb = bf16(16, 4096, K), bf16(16, K, N, scale=0.05)
        cases[f"batched 16 heads M=4096 K={K} N={N}"] = (
            lambda xb=xb, wb=wb: mm.dense_matmul_batched(xb, wb))
    X, k, K, N = 8, 2, 4096, 28672
    we = bf16(X, K, N, scale=0.02)
    for T in (1, 4096):
        topi = torch.rand(T, X, generator=g, device="cuda").argsort(dim=1)[:, :k]
        dest_tok, _, be, nu = mm.moe_align(topi.to(torch.int32),
                                           torch.rand(T, k, generator=g, device="cuda"), X, T)
        xg = torch.cat([bf16(T, K), torch.zeros(1, K, dtype=torch.bfloat16,
                                                device="cuda")])[dest_tok.long()]
        rows = mm._block_rows(dest_tok, T)
        cases[f"grouped mixtral routed_rows={T * k}"] = (
            lambda xg=xg, be=be, nu=nu, rows=rows, n=T * k:
            mm.grouped_matmul(xg, be, nu, we, rows, n_pairs=n))
    roots = {name: variant(b, name, edits) for name, edits in VARIANTS.items()}
    out.update(ms={}, host_us={"one tensor-map encode": encode_us(wqkv)})
    print("host us", out["host_us"], flush=True)
    x1, o1 = xs[1], torch.empty(1, 6144, dtype=torch.bfloat16, device="cuda")
    plan1 = mm.bf16_plan(1, 4096, 6144)
    work1 = torch.empty(plan1.grid[2], 1, 6144, dtype=torch.float32, device="cuda")
    count1 = torch.zeros(plan1.grid[0] * plan1.grid[1], dtype=torch.int32, device="cuda")
    for name in ("as is", *VARIANTS, "as is"):
        use(b, roots.get(name))
        lib, call = b.function("grouped_gemm", "bf16_gemm", mm._DENSE_BF16_ARGS)
        args = (x1.data_ptr(), wqkv.data_ptr(), o1.data_ptr(), work1.data_ptr(),
                count1.data_ptr(), 1, 4096, 6144, 0, 0, plan1.grid[2],
                plan1.stages_per_split, plan1.warpgroups, b.stream_of(x1))
        key = f"{name}: dense M=1 4096x6144 C call"
        out["host_us"].setdefault(key, []).append(host_us(lambda: call(*args)))
        print(key, out["host_us"][key], flush=True)
        for case, fn in cases.items():
            key = f"{name}: {case}"
            out["ms"].setdefault(key, []).append(graph_ms(fn))
            if case in walls:
                out["ms"].setdefault(key + " wall", []).append(wall_ms(fn))
                print(key + " wall", out["ms"][key + " wall"], flush=True)
            print(key, out["ms"][key], flush=True)
    use(b, None)
    out.update(split_launch_ms=split_launches(b, mm, g),
               grouped_split_launch_ms=grouped_split_launches(b, mm, g))
    write(cli.json, out)


def write(path, out: dict) -> None:
    if path:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
