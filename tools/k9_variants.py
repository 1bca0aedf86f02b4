#!/usr/bin/env python3
"""Build variants of the block-fp8 GEMM kernel (K9, csrc/block_fp8_gemm.cu on
the body of csrc/w8a8_wgmma.cuh) from this checkout's sources and measure
each beside the kernel as it is, on one card:

    python3 tools/k9_variants.py [--root DIR] [--json PATH]

- fold F (F = 1 as the kernel is, 2, 4): e4m3 sums carried over F k32
  instructions before each scaled fold into the split's fp32 sum.
  Reported: the largest fp32 error against ``block_fp8_gemm_plain``
  relative to the largest output (the tolerance ``chip_smoke.py`` and the
  GPU tests hold is 1e-4), and the time;
- ring S (S = 6 as the kernel is, 4, 3): the stages of the TMA ring, the
  depth of the weight bytes in flight a block.

At gate/up (K = 4096, N = 22016) at M = 1, 17 and 512, and the LM head
(N = 32000) at M = 512. Times are CUDA events over 20 back-to-back calls
after 3 warm-up calls, the variants timed in turns (as is, variant,
variant, as is); the kernel as it is also gets ``device_ms`` (a CUDA graph
of the calls) and ``cold_ms`` (the L2 cold: a graph of (256 MB read,
call) pairs less one of the reads alone). ``--root DIR`` times another
tree's kernel as it is (for instance a parent commit unpacked under
``build/``: wall, ``device_ms``, ``cold_ms``), no variants. The variants'
sources and libraries go to build/k9_variants/ beside the package. Needs a
card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

FOLD_AS_IS = """      for (int k = 0; k < 4; ++k) {
        if (k > 0) {
          fence_regs(pa);
          wgmma_fence();
          wgmma_k32(pa, sw_desc<128>(xa + 32 * k), sw_desc<128>(ba + 32 * k), 0);
          wgmma_commit();
        }
        wgmma_wait0();
        fence_regs(pa);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = fmaf(pa[i], (i & 2) ? c1 : c0, acc[i]);
      }"""
FOLD_EVERY = """      for (int k = 0; k < 4; ++k) {
        if (k > 0) {
          fence_regs(pa);
          wgmma_fence();
          wgmma_k32(pa, sw_desc<128>(xa + 32 * k), sw_desc<128>(ba + 32 * k), k % %F%);
          wgmma_commit();
        }
        if ((k + 1) % %F% == 0) {
          wgmma_wait0();
          fence_regs(pa);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = fmaf(pa[i], (i & 2) ? c1 : c0, acc[i]);
        }
      }"""
RING_AS_IS = "constexpr int kMaxStages = 6;"

CASES = [(1, 4096, 22016), (17, 4096, 22016), (512, 4096, 22016), (512, 4096, 32000)]


def variant(b, name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` ((file, old, new), ...) applied."""
    root = b.PKG_DIR.parent / "build" / "k9_variants" / name
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write the results here")
    ap.add_argument("--root", type=Path, default=HERE,
                    help="root of the tree whose kernel is timed (variants: this tree only)")
    cli = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k9_variants: torch.cuda is not available")
    sys.path.insert(0, str(cli.root.resolve()))
    from painlessinferenceacceleration_tpu_torch import _build as b
    from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
    from painlessinferenceacceleration_tpu_torch.ops import w8a8

    if not str(b.PKG_DIR).startswith(str(cli.root.resolve())):
        sys.exit(f"imported the port from {b.PKG_DIR}, not {cli.root}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    b.SOURCES = ("block_fp8_gemm",)
    g = torch.Generator(device="cuda").manual_seed(0)

    def operands(M, K, N):
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        xq, xs = w8a8.quant_act(x, QuantSpec.from_mode("fp8_block"))
        q = torch.randn(K, N, generator=g, device="cuda").to(torch.float8_e4m3fn)
        s = torch.rand(-(-K // 128), -(-N // 128), generator=g, device="cuda") * 1e-4 + 2e-5
        return xq, xs, q, s

    def ms(args):
        fn = lambda: w8a8.block_fp8_gemm(*args, torch.bfloat16)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    def device_ms(args):
        fn = lambda: w8a8.block_fp8_gemm(*args, torch.bfloat16)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
            stream.synchronize()
            with torch.cuda.graph(graph, stream=stream):
                for _ in range(10):
                    fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 30

    flush = []

    def cold_ms(args, reps=20, rounds=5):
        import statistics

        fn = lambda: w8a8.block_fp8_gemm(*args, torch.bfloat16)  # noqa: E731
        if not flush:
            flush.append(torch.ones((256 << 20) // 4, device="cuda"))
        buf = flush[0]

        def capture(body):
            body()
            torch.cuda.synchronize()
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                body()
                stream.synchronize()
                with torch.cuda.graph(graph, stream=stream):
                    body()
            torch.cuda.current_stream().wait_stream(stream)
            torch.cuda.synchronize()
            return graph

        def replay(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)
        both = capture(lambda: [(buf.sum(), fn()) for _ in range(reps)])
        alone = capture(lambda: [buf.sum() for _ in range(reps)])
        a, c = [], []
        for _ in range(rounds):
            a.append(replay(both))
            c.append(replay(alone))
        return (statistics.median(a) - statistics.median(c)) / reps

    def rel(args):
        got = w8a8.block_fp8_gemm(*args, torch.float32)
        ref = w8a8.block_fp8_gemm_plain(*args, torch.float32)
        return ((got - ref).abs().max() / ref.abs().max()).item()

    ops = {c: operands(*c) for c in CASES}
    out = dict(card=card, root=str(cli.root), as_is={}, fold={}, ring={})
    use(b, None)
    for c, args in ops.items():
        key = f"M={c[0]} K={c[1]} N={c[2]}"
        out["as_is"][key] = dict(ms=ms(args), device_ms=device_ms(args), cold_ms=cold_ms(args),
                                 rel_err=rel(args))
        print("as is " + key, json.dumps(out["as_is"][key]), flush=True)
    if cli.root.resolve() != HERE:
        runs_of = ()  # another tree: its kernel as it is only
    else:
        runs_of = (
            ("fold", [("1", None)] + [(str(F), variant(b, f"fold{F}", [(
                "block_fp8_gemm.cu", FOLD_AS_IS, FOLD_EVERY.replace("%F%", str(F)))]))
                for F in (2, 4)] + [("1", None)]),
            ("ring", [("6", None)] + [(str(S), variant(b, f"ring{S}", [(
                "w8a8_wgmma.cuh", RING_AS_IS, f"constexpr int kMaxStages = {S};")]))
                for S in (4, 3)] + [("6", None)]))
    for kind, runs in runs_of:
        for name, root in runs:
            use(b, root)
            for c, args in ops.items():
                key = f"{kind} {name} M={c[0]} K={c[1]} N={c[2]}"
                res = out[kind].setdefault(key, dict(rel_err=rel(args), ms=[]))
                res["ms"].append(ms(args))
                print(key, json.dumps(res), flush=True)
    use(b, None)
    if cli.json:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
