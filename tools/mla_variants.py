#!/usr/bin/env python3
"""Time K13, the MLA attention kernel (csrc/mla_attention.cu), at the rows
of chip_smoke.py's phase_mla_kernels under its launch choices and body
variants, on one card:

    python3 tools/mla_variants.py [--json PATH] [--launch-only]

Launch choices (arguments of the one kernel, no rebuild):
- the chunk C of the fixed key partition: 256, 512 (the wrapper's
  CHUNK_KEYS) and 1024 keys (each C gives other bits, the same in every
  route);
- the prefill route: the walk (one block a tile that folds at each chunk
  edge into its scratch; the wrapper's) against the split route (one block
  a chunk, fp32 partials in a workspace, then the combine kernel).
Body variants (a copy of csrc/ with edits, built beside; same bits):
- S in both warpgroups: each consumer warpgroup computes S and the
  softmax itself and takes P from its own registers (no hand-over through
  shared memory; the kernel's first design);
- scores first: warpgroup 0 issues a block's S before the previous
  block's P V, so its softmax runs under that P V, and releases the stage
  after both;
and three take a piece away (wrong results by design; only their time
counts, to show what holds a key block): no S (S = Q K^T not issued), no
P V (neither warpgroup's P V issued), no softmax (P = the raw scores, the
rescale 1).
No cluster-multicast variant was built.

Times are device ms: a CUDA graph of 10 calls (5 at 4096 rows and more),
replayed 3 times between CUDA events, in turns: the kernel as it is, each
launch choice and variant, the kernel as it is again. Each choice's largest
difference from the kernel as it is, and each build's ptxas registers and
spills, are printed too. Sources and libraries of the variants go to
build/mla_variants/. Needs a card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from k7_variants import graph_ms  # noqa: E402

SRC = "mla_attention.cu"
SEED = 0
DK, DV = 576, 512

VARIANTS = {
    "S in both warpgroups": [
        ("    if (wg == 0) {\n      float s[32];", "    if (true) {\n      float s[32];"),
        ("""        // hand block i's P and rescale factors (and at the chunk's last
        // block its partial's max and sum) to warpgroup 1
""", "        /*"),
        ("""        asm volatile("bar.arrive 2, %0;\\n" ::"n"(kConsumers) : "memory");
""", "        */\n")],
    "scores first": [(
        """        if (i > 0) issue_pv(pa, gi - 1);
        issue_s(s, gi);
        if (i > 0) {
          wgmma_wait1();  // block i - 1's P V is done
          if (lane == 0) mbar_arrive(empty + 8 * ((gi - 1) % kStages));
        }
        wgmma_wait0();
        fence_regs(s);
        fence_regs(o);
        float alpha[2];
        softmax(kb0 + i, alpha);
""",
        """        issue_s(s, gi);
        if (i > 0) issue_pv(pa, gi - 1);
        if (i > 0)
          wgmma_wait1();
        else
          wgmma_wait0();
        fence_regs(s);
        float alpha[2];
        softmax(kb0 + i, alpha);
        wgmma_wait0();
        fence_regs(o);
        if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((gi - 1) % kStages));
""")],
    "no S": [("""      wgmma_s(s, sw_desc<128>(qa + (t / 4) * kBox + 32 * (t % 4)),""",
               """      if (t < 0) wgmma_s(s, sw_desc<128>(qa + (t / 4) * kBox + 32 * (t % 4)),""")],
    "no P V": [("      wgmma_pv(o, a, v_desc(va + 16 * 128 * t));",
                "      if (t < 0) wgmma_pv(o, a, v_desc(va + 16 * 128 * t));"),
               ("      wgmma_pv_ss(o, sw_desc<128>(pa_s + 32 * t), v_desc(va + 16 * 128 * t));",
                "      if (t < 0) wgmma_pv_ss(o, sw_desc<128>(pa_s + 32 * t),"
                " v_desc(va + 16 * 128 * t));")],
    "no softmax": [("        softmax(kb0 + i, alpha);",
                    "        alpha[0] = alpha[1] = 1.f;")],
}
WRONG = ("no S", "no P V", "no softmax")  # results wrong by design
# the launch choices: (name, chunk keys, walk for the prefill rows)
LAUNCHES = (("C=256", 256, None), ("C=1024", 1024, None),
            ("prefill split", 512, False))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def variant(b, name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` ((old, new), ...) applied to SRC in
    order."""
    root = b.PKG_DIR.parent / "build" / "mla_variants" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(b.PKG_DIR / "csrc", root / "csrc")
    path = root / "csrc" / SRC
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not once in {SRC}")
        src = src.replace(old, new)
    path.write_text(src)
    return root


def use(b, root) -> None:
    """Point the build at the sources under ``root`` (None: as they are) and
    build the MLA library alone."""
    b.CSRC_DIR = b.PKG_DIR / "csrc" if root is None else root / "csrc"
    b.BUILD_DIR = (b.PKG_DIR.parent / "build" / "torch_kernels" if root is None
                   else root / "lib")
    b.SOURCES = ("mla_attention",)
    b._LIBS.clear()
    b._FNS.clear()
    b.build_all()


def ptxas(b) -> list:
    out = []
    for line in b.ptxas_report("mla_attention").splitlines():
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(dict(registers=int(m.group(1))))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.append(dict(spill_stores=int(m.group(1)), spill_loads=int(m.group(2))))
    return out


def cases(g):
    """phase_mla_kernels' rows: (label, causal, inputs)."""
    import torch

    from painlessinferenceacceleration_tpu_torch.ops.attention import causal_qmask

    def make(label, kind, H, ctx, Q):
        B = len(ctx)
        P = -(-(max(ctx) + Q) // 64) + 1
        n = B * P + 1
        k = torch.randn(n, 64, DK, generator=g, device="cuda").to(torch.bfloat16)
        pt = (torch.randperm(n - 1, generator=g, device="cuda")[: B * P] + 1).reshape(B, P)
        q = torch.randn(B, Q, H, DK, generator=g, device="cuda").to(torch.bfloat16)
        if kind == "verify":
            qm = torch.rand(B, Q, Q, generator=g, device="cuda") < 0.5
            qm = (qm | torch.eye(Q, dtype=torch.bool, device="cuda")).tril()
        else:
            qm = causal_qmask(Q, "cuda")[None].expand(B, Q, Q)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        return label, kind == "prefill", (q, k, pt.to(torch.int32), ctx_t, qm)

    return [make("decode H=16 ctx=640", "decode", 16, [640], 1),
            make("decode H=16 ctx=4096", "decode", 16, [4096], 1),
            make("decode H=128 ctx=4096", "decode", 128, [4096], 1),
            make("decode H=16 B=4 ctx=63/64/65/4095", "decode", 16, [63, 64, 65, 4095], 1),
            make("verify H=16 Q=17 ctx=4096", "verify", 16, [4096], 17),
            make("verify H=128 Q=17 ctx=4096", "verify", 128, [4096], 17),
            make("prefill Q=512 ctx=0", "prefill", 16, [0], 512),
            make("prefill Q=512 ctx=512", "prefill", 16, [512], 512),
            make("prefill Q=4096 ctx=0", "prefill", 16, [0], 4096)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write the numbers here")
    ap.add_argument("--launch-only", action="store_true", help="skip the body variants")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mla_variants: torch.cuda is not available")
    from painlessinferenceacceleration_tpu_torch import _build as b
    from painlessinferenceacceleration_tpu_torch.ops import mla_attention as ma

    variants = {} if args.launch_only else VARIANTS
    roots = {name: variant(b, name, edits) for name, edits in variants.items()}
    regs = {}
    for name, root in [("as is", None), *roots.items()]:
        use(b, root)
        regs[name] = ptxas(b)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = cases(g)
    out = dict(card=smi_line(), ptxas=regs, rows=[])

    def timed(root, case, chunk=ma.CHUNK_KEYS, walk=None):
        use(b, root)
        label, causal, (q, k, pt, ctx, qm) = case

        def run():
            return ma._launch(q, k, pt, ctx, qm, 0.0417, DV, causal, chunk=chunk, walk=walk)
        got = run()
        reps = 5 if q.shape[1] * q.shape[2] >= 4096 else 10
        return graph_ms(run, reps=reps), got

    for case in rows:
        label, causal = case[0], case[1]
        row = dict(case=label)
        row["as is"], ref = timed(None, case)
        for name, chunk, walk in LAUNCHES:
            if walk is not None and not causal:
                continue
            ms, got = timed(None, case, chunk, walk)
            row[name] = ms
            row[f"{name} max_abs_diff"] = (got.float() - ref.float()).abs().max().item()
        for name, root in roots.items():
            ms, got = timed(root, case)
            row[name] = ms
            if name not in WRONG:
                row[f"{name} max_abs_diff"] = (got.float() - ref.float()).abs().max().item()
        row["as is again"], _ = timed(None, case)
        out["rows"].append(row)
        print("row: " + json.dumps(row), flush=True)
    print("ptxas: " + json.dumps(regs))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(out["card"])


if __name__ == "__main__":
    main()
