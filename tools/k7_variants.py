#!/usr/bin/env python3
"""Build variants of the int8 weight-only GEMM (K7: csrc/int8_gemm.cu over
the body csrc/weight_only_wgmma.cuh, which K1 shares) from this checkout's
sources and time each beside the kernel as it is, on one card:

    python3 tools/k7_variants.py [--json PATH]

Two variants try a choice, kept or not:
- cols first: the column blocks of one row tile are launched next to each
  other (K1's order) instead of the row tiles of one column block (K7's
  order);
- grouped rows first: K12 launches the row blocks of one column block next
  to each other (K7's order) instead of the column blocks of one row block
  (K11's and K12's order);
- prefetch: thread 0 also asks for the weight box 8 stages ahead of each
  ring copy into L2 (cp.async.bulk.prefetch.tensor), so that more stages
  are in flight than the ring's 3-5 (not kept).
Three take a piece away, to show what a ring stage costs (their results
are wrong by design; only their times count):
- no widen: the int8 stage is not widened to bf16;
- no mma: no warpgroup multiplies or folds: the ring, the widening and the
  barriers alone;
- no x: the x tile is not copied (the wgmma reads a stale one).

Times are the kernels' device time in a CUDA graph of 10 calls, replayed 3
times between CUDA events, the variants in turns (as is, variants, as is),
for K7 and K1 (int4, which the body changes touch too) at Llama-2-7B's
gate/up shape (K = 4096, N = 22016, group 128) at M = 1, 17, 64, 512 and
4096, and for K12 over 8192 routed rows of Mixtral-8x7B (8 experts, top 2,
gate/up K = 4096, N = 28672) and Qwen3-30B-A3B (128 experts, top 8, K =
2048, N = 1536). Sources and libraries go to build/k7_variants/ beside the package.
Needs a card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

BODY = "weight_only_wgmma.cuh"
DENSE = "int8_gemm.cu"
GROUPED = "grouped_int8_gemm.cu"
PREFETCH = """
// the weight box of stage g (if it exists) asked into L2
template <bool kInt8, int C, int W>
__device__ __forceinline__ void prefetch_stage(const Maps& maps, int n0, int g, int g_end) {
  if (kInt8 && g < g_end)
    asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];"
                 ::"l"(reinterpret_cast<uint64_t>(maps.q)), "r"(n0),
                 "r"(maps.q_row0 + g * Tile<kInt8, C, W>::kQRows) : "memory");
}

// Thread 0 issues the copies of stage g into ring slot `slot`."""
VARIANTS = {
    "prefetch": [
        (BODY, "\n// Thread 0 issues the copies of stage g into ring slot `slot`.", PREFETCH),
        (BODY, "                              g_begin + st);\n  }",
         "                              g_begin + st);\n    for (int st = S - 1; st < S + 7; ++st)\n"
         "      prefetch_stage<kInt8, C, W>(maps, n0, g_begin + st, g_end);\n  }"),
        (BODY, "                              g_begin + nx);\n    }",
         "                              g_begin + nx);\n"
         "      prefetch_stage<kInt8, C, W>(maps, n0, g_begin + nx + 8, g_end);\n    }")],
    "cols first": [
        (DENSE, "const int m0 = blockIdx.x * Tile<true, C, W>::kRows;",
         "const int m0 = blockIdx.y * Tile<true, C, W>::kRows;"),
        (DENSE, "m0, blockIdx.y * kCols,", "m0, blockIdx.x * kCols,"),
        (DENSE, "dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);",
         "dim3 grid((N + kCols - 1) / kCols, (M + T::kRows - 1) / T::kRows, split_blocks);")],
    "grouped rows first": [
        (GROUPED, "  const int b = blockIdx.y;", "  const int b = blockIdx.x;"),
        (GROUPED, "  const int n0 = blockIdx.x * kCols;", "  const int n0 = blockIdx.y * kCols;"),
        (GROUPED, "  dim3 grid((N + kCols - 1) / kCols, row_blocks, split_blocks);",
         "  dim3 grid(row_blocks, (N + kCols - 1) / kCols, split_blocks);")],
    "no widen": [(BODY, "  const int lane = threadIdx.x & 31;\n#pragma unroll\n  for (int i0 = 0;",
                  "  if (C > 0) return;\n  const int lane = threadIdx.x & 31;\n#pragma unroll\n"
                  "  for (int i0 = 0;")],
    "no mma": [(BODY, "(int)(wg < W && 64 * wg < valid), 0);",
                "(int)(wg < W && 64 * wg < valid && C < 0), 0);")],
    "no x": [(BODY, "mbar_expect(bar, T::kBytesPerStage);",
              "mbar_expect(bar, T::kBytesPerStage - T::kXBytes);"),
             (BODY, "for (int a = 0; a < C / T::kSpan; ++a)",
              "for (int a = 0; a < 0 * (C / T::kSpan); ++a)")],
}


def variant(b, name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` ((file, old, new), ...) applied."""
    root = b.PKG_DIR.parent / "build" / "k7_variants" / name.replace(" ", "_")
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


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write the results here")
    cli = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k7_variants: torch.cuda is not available")
    from painlessinferenceacceleration_tpu_torch import _build as b
    from painlessinferenceacceleration_tpu_torch.ops import moe_matmul as mm
    from painlessinferenceacceleration_tpu_torch.ops import quant_matmul as qm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    b.SOURCES = ("int8_gemm", "int4_gemm", "grouped_int8_gemm")
    g = torch.Generator(device="cuda").manual_seed(0)
    K, N = 4096, 22016
    q8 = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    q4 = torch.randint(0, 256, (K // 2, N), generator=g, device="cuda", dtype=torch.uint8)
    s = (torch.rand(K // 128, N, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    xs = {M: torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
          for M in (1, 17, 64, 512, 4096)}
    routings = {}
    for family, T, k, X, Kg, Ng in (("mixtral-8x7b", 4096, 2, 8, 4096, 28672),
                                    ("qwen3-30b-a3b", 1024, 8, 128, 2048, 1536)):
        topi = torch.rand(T, X, generator=g, device="cuda").argsort(dim=1)[:, :k]
        dest_tok, _, be, nu = mm.moe_align(topi.to(torch.int32),
                                           torch.rand(T, k, generator=g, device="cuda"), X, T)
        xg = torch.cat([torch.randn(T, Kg, generator=g, device="cuda"),
                        torch.zeros(1, Kg, device="cuda")]).to(torch.bfloat16)[dest_tok.long()]
        p = {"q": torch.randint(-127, 128, (X, Kg, Ng), generator=g, device="cuda",
                                dtype=torch.int8),
             "s": (torch.rand(X, Kg // 128, Ng, generator=g, device="cuda") * 1e-3
                   ).to(torch.bfloat16)}
        routings[family] = (xg, be, nu, p, mm._block_rows(dest_tok, T), T * k)
    roots = {name: variant(b, name, edits) for name, edits in VARIANTS.items()}
    out = dict(card=card, shape=f"K={K} N={N} group=128", ms={})
    for name in ("as is", *VARIANTS, "as is"):
        use(b, roots.get(name))
        for M, x in xs.items():
            for fmt, fn, q in (("int8", qm.int8_matmul, q8), ("int4", qm.int4_matmul, q4)):
                key = f"{name} {fmt} M={M}"
                out["ms"].setdefault(key, []).append(graph_ms(lambda: fn(x, q, s)))
                print(key, out["ms"][key], flush=True)
        for family, (xg, be, nu, p, rows, pairs) in routings.items():
            key = f"{name} grouped int8 {family} routed_rows={pairs}"
            out["ms"].setdefault(key, []).append(graph_ms(
                lambda: mm.grouped_quant_matmul(xg, be, nu, p, 8, rows, n_pairs=pairs)))
            print(key, out["ms"][key], flush=True)
    if cli.json:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
