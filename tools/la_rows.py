#!/usr/bin/env python3
"""K14 (decayed linear attention: chunk, decode, tree and commit) at
Ring-mini-linear-2.0's shapes, for this tree or another, on one card:

    python3 tools/la_rows.py [--root DIR] [--json PATH] [--kernels]

``--root`` imports the port from another tree (for instance a parent commit
unpacked under ``build/``), which builds its own kernels; run the script
once per tree, in turns (parent, change, change, parent), to compare two
trees on one card. The rows are ``chip_smoke.py``'s ``la_rows`` (PERF.md
rows 22-23), measured by ``chip_smoke.py``'s ``la_row`` of this script's
tree: each mode against the tree's own plain version (chunk within 1e-5,
the others bit for bit), the wall ms under CUDA events, ``device_ms`` with
the L2 cold, the CUDA kernels a call (a CUDA graph's kernel nodes), the
bound and the plain version's ms; ``--kernels`` adds each chunk pass's
device ms. Prints one JSON line per row and the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load(root: Path) -> dict:
    """The port's modules that ``la_rows`` reads, from ``root``."""
    sys.path.insert(0, str(root))
    import importlib

    base = "painlessinferenceacceleration_tpu_torch."
    names = dict(_build="_build", linear_attention="ops.linear_attention",
                 linear_attn="models.linear_attn", device_tables="lookahead.device_tables")
    pkg = {k: importlib.import_module(base + v) for k, v in names.items()}
    if not str(pkg["_build"].PKG_DIR).startswith(str(root.resolve())):
        raise SystemExit(f"imported the port from {pkg['_build'].PKG_DIR}, not {root}")
    return pkg


def by_kernel(pkg, g, cs) -> list:
    """Each CUDA kernel's device ms a call (torch.profiler, 10 calls, the L2
    warm) of chunk mode at B = 2 (row 1 half padded) and C = 512 / 4096,
    and of decode at B = 1 / 8."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    la = pkg["linear_attention"]
    H, D = cs.LIN_H, cs.LIN_D
    ll = cs.la_loglam(pkg, H)
    rows = []
    for C in (512, cs.LIN_PROMPT_LEN):
        q, k, v = cs.la_features(g, 2, H, C, D)
        st = torch.randn(2, H, D, D, generator=g, device="cuda") * 0.1
        lens = torch.tensor([C, C // 2], dtype=torch.int32, device="cuda")
        rows.append((f"chunk B=2 C={C}", lambda q=q, k=k, v=v, st=st, lens=lens:
                     la.linear_attention_chunk(q, k, v, st, lens, ll)))
    for B in (1, 8):
        q, k, v = cs.la_features(g, B, H, 1, D)
        st = torch.randn(B, H, D, D, generator=g, device="cuda") * 0.1
        ok = torch.ones(B, 1, dtype=torch.bool, device="cuda")
        rows.append((f"decode B={B}", lambda q=q, k=k, v=v, st=st, ok=ok:
                     la.linear_attention_decode(q, k, v, st, ok, ll)))
    out = []
    for case, fn in rows:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        ms = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                ms[e.key[:60]] = t / 1e3 / 10
        out.append(dict(root=str(pkg["_build"].PKG_DIR.parent), case=case, kernel_ms=ms))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="root of the tree whose port is measured")
    ap.add_argument("--json", type=Path, default=None, help="also write the rows here")
    ap.add_argument("--kernels", action="store_true",
                    help="also each CUDA kernel's device ms a call, by name (torch.profiler)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/la_rows.py needs a CUDA card")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # the harness of this tree: the same cases and clocks

    t0 = time.perf_counter()
    pkg = load(args.root)
    pkg["_build"].build_all()
    pkg["_build"].library("linear_attention")
    out = dict(root=str(args.root), card=cs.smi_line(), build_s=time.perf_counter() - t0)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out["rows"] = cs.la_rows(pkg, g)
    for r in out["rows"]:
        print(json.dumps(dict(root=str(args.root), **r)))
    if args.kernels:
        out["kernels"] = by_kernel(pkg, g, cs)
        for r in out["kernels"]:
            print(json.dumps(r))
    print(out["card"])
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
