#!/usr/bin/env python3
"""K2 / K3 (paged attention) without a page range, and with one where the
tree has it, at Llama-2-7B's attention shape, on one card:

    python3 tools/attention_range.py [--root DIR] [--json PATH]

``--root`` imports the port from another tree (for instance a parent commit
unpacked under ``build/``), which builds its own kernels; run the script
once per tree, in turns (parent, change, change, parent), to compare the
call without a range across two trees on one card.

Cases (B = 1, Hq = Hkv = 32, head dim 128, pages of 64 keys, a bf16
arena, seed 0): decode (Q = 1) and a 17-wide verify at ctx 4096, a causal
prefill chunk of 512 rows at ctx 3584. Each call is timed under CUDA events
(``ms``, 20 calls) and as a CUDA graph of 10 calls replayed 3 times
(``device_ms``: the kernel without the wrapper's host time, the inputs in
L2 where they fit). A tree with the page range also times the call over
half of the request's pages with the rows' log-sum-exp (``range_*``).
Prints one JSON line per case, one with ptxas's registers and spills for
each instantiation of the tree's kernel (``ptxas``), and the card's name
and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def load(root: Path):
    sys.path.insert(0, str(root))
    import importlib

    pa = importlib.import_module("painlessinferenceacceleration_tpu_torch.ops.paged_attention")
    attn = importlib.import_module("painlessinferenceacceleration_tpu_torch.ops.attention")
    if not str(Path(pa.__file__).resolve()).startswith(str(root.resolve())):
        raise SystemExit(f"imported the port from {pa.__file__}, not {root}")
    return pa, attn


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * reps)


def case(pa, attn, g, kind: str, ctx: int, Q: int) -> dict:
    import torch

    Hq = Hkv = 32
    D, ps = 128, 64
    P = -(-(ctx + Q) // ps)
    n_pages = 2 * P + 2
    k = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda")[:P] + 1)[None].to(torch.int32)
    ctx_t = torch.full((1,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(1, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    qm = attn.causal_qmask(Q, "cuda")[None].contiguous()
    scale = D ** -0.5

    def call(**kw):
        if kind == "prefill":
            return pa.paged_attention_prefill(q, k, v, pt, ctx_t, scale, **kw)
        return pa.paged_attention(q, k, v, pt, ctx_t, qm, scale, **kw)

    out = dict(kind=kind, ctx=ctx, Q=Q, ms=time_ms(call), device_ms=graph_ms(call))
    if hasattr(pa, "ALL_PAGES"):  # a tree with the page range
        def ranged():
            return call(page_range=(1, n_pages // 2), return_lse=True)
        out.update(range_ms=time_ms(ranged), range_device_ms=graph_ms(ranged))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="root of the tree whose port is measured")
    ap.add_argument("--json", type=Path, default=None, help="also write the rows here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    pa, attn = load(args.root)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [case(pa, attn, g, "decode", 4096, 1), case(pa, attn, g, "verify", 4096, 17),
            case(pa, attn, g, "prefill", 3584, 512)]
    for r in rows:
        r["root"] = str(args.root)
        print(json.dumps(r))
    ptxas = {",".join(map(str, k)): v for k, v in sorted(pa.ptxas_registers().items())}
    print("ptxas: " + json.dumps(ptxas))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(rows=rows, ptxas=ptxas), indent=1))
    print(smi_line())


if __name__ == "__main__":
    main()
