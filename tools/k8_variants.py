#!/usr/bin/env python3
"""Build variants of the W8A8 GEMM kernel (K8, csrc/w8a8_wgmma.cuh) from
this checkout's sources and measure each beside the kernel as it is, on one
card:

    python3 tools/k8_variants.py [--json PATH]

- fold F (F = 1 as the kernel is, 2, 4): e4m3 sums carried over F k32
  instructions before each fp32 fold. Reported: the largest fp32 error
  against ``w8a8_gemm_plain`` relative to the largest output (the
  tolerance ``chip_smoke.py`` and the GPU tests hold is 1e-4), and the
  time, at 7B shapes;
- order: the row tiles of one column block launched next to each other (as
  the kernel is) or the column blocks first; both formats' times at M = 512
  and 4096.

Times are CUDA events over 20 back-to-back calls after 3 warm-up calls; the
variants are timed in turns (as is, variant, variant, as is). The variants'
sources and libraries go to build/k8_variants/ beside the package. Needs a
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
sys.path.insert(0, str(HERE))

FOLD_AS_IS = """        for (int k = 0; k < 4; ++k) {
          if (k > 0) {
            fence_regs(pa);
            wgmma_fence();
            wgmma_k32(pa, sw_desc<128>(xa + 32 * k), sw_desc<128>(ba + 32 * k), 0);
            wgmma_commit();
          }
          wgmma_wait0();
          fence_regs(pa);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += pa[i];
        }"""
FOLD_EVERY = """        for (int k = 0; k < 4; ++k) {
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
            for (int i = 0; i < 64; ++i) acc[i] += pa[i];
          }
        }"""
ORDER_AS_IS = ("M, N, blockIdx.x * Tile<W>::kRows, blockIdx.y * kCols,",
               "dim3 grid((M + T::kRows - 1) / T::kRows, (N + kCols - 1) / kCols, split_blocks);")
ORDER_COLS_FIRST = ("M, N, blockIdx.y * Tile<W>::kRows, blockIdx.x * kCols,",
                    "dim3 grid((N + kCols - 1) / kCols, (M + T::kRows - 1) / T::kRows, split_blocks);")


def variant(b, name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` ((file, old, new), ...) applied."""
    root = b.PKG_DIR.parent / "build" / "k8_variants" / name
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
    cli = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k8_variants: torch.cuda is not available")
    from painlessinferenceacceleration_tpu_torch import _build as b
    from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
    from painlessinferenceacceleration_tpu_torch.ops import w8a8

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    b.SOURCES = ("w8a8_gemm",)
    g = torch.Generator(device="cuda").manual_seed(0)

    def operands(M, K, N, mode):
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        xq, xs = w8a8.quant_act(x, QuantSpec.from_mode(mode))
        if mode == "w8a8_fp8":
            q = torch.randn(K, N, generator=g, device="cuda").to(torch.float8_e4m3fn)
        else:
            q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        return xq, xs, q, torch.rand(N, generator=g, device="cuda") * 1e-4 + 1e-5

    def ms(args):
        fn = lambda: w8a8.w8a8_gemm(*args, torch.bfloat16)  # noqa: E731
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

    def rel(args):
        got = w8a8.w8a8_gemm(*args, torch.float32)
        ref = w8a8.w8a8_gemm_plain(*args, torch.float32)
        return ((got - ref).abs().max() / ref.abs().max()).item()

    out = dict(card=card, fold={}, order={})
    fold_cases = [(512, 4096, 22016), (512, 11008, 4096), (300, 14336, 4096), (17, 4096, 4096),
                  (70, 256, 384), (17, 336, 272)]
    fold_ops = {c: operands(*c, "w8a8_fp8") for c in fold_cases}
    runs = [("1", None)]
    for F in (2, 4):
        runs.append((str(F), variant(b, f"fold{F}", [
            ("w8a8_wgmma.cuh", FOLD_AS_IS, FOLD_EVERY.replace("%F%", str(F)))])))
    runs.append(("1", None))
    for F, root in runs:
        use(b, root)
        for c, args in fold_ops.items():
            key = f"fold {F} M={c[0]} K={c[1]} N={c[2]}"
            res = out["fold"].setdefault(key, dict(rel_err=rel(args), ms=[]))
            res["ms"].append(ms(args))
            print(key, json.dumps(res), flush=True)
    cols = variant(b, "cols_first", [("w8a8_gemm.cu", o, n)
                                      for o, n in zip(ORDER_AS_IS, ORDER_COLS_FIRST)])
    order_ops = {(c, m): operands(*c, m) for c in [(512, 4096, 22016), (4096, 4096, 22016),
                                                   (4096, 11008, 4096)]
                 for m in ("w8a8_int8", "w8a8_fp8")}
    for name, root in (("rows first", None), ("cols first", cols), ("cols first", cols),
                       ("rows first", None)):
        use(b, root)
        for (c, m), args in order_ops.items():
            key = f"{name} {m} M={c[0]} K={c[1]} N={c[2]}"
            out["order"].setdefault(key, []).append(ms(args))
            print(key, out["order"][key], flush=True)
    if cli.json:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
