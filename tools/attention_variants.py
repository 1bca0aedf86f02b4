#!/usr/bin/env python3
"""Build variants of the paged attention kernel (csrc/paged_attention.cuh,
the body that csrc/paged_attention.cu builds at head dims 64 and 128)
from this checkout's source and time each beside the kernel as it is, on
one card:

    python3 tools/attention_variants.py [--json PATH]

Variants try a choice, kept or not:
- serial: a block's softmax waits for the previous block's P V as well as
  for its own scores (no softmax under the tensor cores' P V), in every
  mode (the per-token e4m3 mode always waits so);
- accurate exp2: exp2f (a few instructions) in place of one ex2.approx;
- rescale where needed: O is rescaled only where a row of the warp has a
  new max (a vote a block), not after every block;
- widening in the consumers: the two consumer warpgroups widen each e4m3
  stage themselves (half each, then a barrier of the two; the three
  converter warps idle), with the previous block's P V issued before the
  pass and the block's scores after it;
- P in shared memory: P is stored bf16 in the 128-byte swizzle (a
  warpgroup's 64 rows, 8 KB) and read by wgmma as a shared-memory A
  operand, after a warpgroup barrier, in place of the register fragments;
- ascending tiles: causal tiles launched first to last, not heaviest first;
and one takes a piece away (wrong results by design; only its time counts):
- no widening: the converter warps of the e4m3 arenas skip the e4m3 ->
  bf16 pass (they still release each stage), so its cost on the critical
  path shows.

Times are the kernel's device time in a CUDA graph of 10 calls (5 at 2048
query rows and more), replayed 3 times between CUDA events, the variants
in turns (as is, variants, as is), at the rows of PERF.md: Q = 512 over 512
cached keys (32 heads, bf16 / static e4m3 / per-token e4m3), Mixtral-8x7B's
prefill (Q = 2048, 32 heads over 8; bf16 and per-token e4m3),
Ring-mini-linear-2.0's (Q = 4096, 16 over 4), a decode (Q = 1 over 640
keys) and a verify (Q = 17 over 768, 32 heads over 8). Each variant's
largest difference from the kernel as it is, and ptxas's registers and
spills of its build, are printed too. Sources and
libraries go to build/attention_variants/. Needs a card and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from k7_variants import graph_ms  # noqa: E402

SRC = "paged_attention.cuh"  # the body; the variants build paged_attention.cu


def _ss_pv(n: int) -> str:
    """wgmma m64n{n}k16 with A and B (transposed) from shared memory."""
    outs = ", ".join(f"%{i}" for i in range(n // 2))
    regs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    return (f"__device__ __forceinline__ void wgmma_pv_ss(float (&d)[{n // 2}], uint64_t a, "
            f"uint64_t b) {{\n  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n // 2 + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{outs}}}, %{n // 2}, %{n // 2 + 1}, p, 1, 1, 0, 1;\\n}}\\n"\n'
            f'      : {regs}\n      : "l"(a), "l"(b), "r"(1));\n}}\n\n')


STAGE_READY = r"""  // (variant) the consumer warpgroups widen block kb themselves
  auto stage_ready = [&](int kb) {
    if (MODE == kBf16) {
      mbar_wait(full + 8 * (kb % S), (kb / S) & 1);
      return;
    }
    const int rs = kb % R, slot = kb % S;
    mbar_wait(rfull + 8 * rs, (kb / R) & 1);
    const uint8_t* src = raw + rs * L::kRaw;
    uint8_t* dst = ring + slot * L::kStage;
    constexpr int kUnits = D / 16;
    for (int e = threadIdx.x; e < 2 * kKeys * kUnits; e += 128 * n_mma) {
      const int which = e / (kKeys * kUnits);
      const int k = (e / kUnits) % kKeys, u = e % kUnits;
      const uint4 w = *reinterpret_cast<const uint4*>(src + which * L::kRawHalf + k * D +
                                                      16 * u);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      uint32_t ob[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ob[2 * i] = e4m3x2_to_bf16x2(ws[i] & 0xffffu);
        ob[2 * i + 1] = e4m3x2_to_bf16x2(ws[i] >> 16);
      }
      uint8_t* row = dst + which * L::kHalf + (u / 4) * (kKeys * 128) + k * 128;
      const int u0 = 2 * (u % 4);
      *reinterpret_cast<uint4*>(row + ((u0 ^ (k & 7)) << 4)) =
          make_uint4(ob[0], ob[1], ob[2], ob[3]);
      *reinterpret_cast<uint4*>(row + (((u0 + 1) ^ (k & 7)) << 4)) =
          make_uint4(ob[4], ob[5], ob[6], ob[7]);
    }
    if (MODE == kFp8Token) {
      const int page = pt[kb];
      for (int e = threadIdx.x; e < 2 * kKeys; e += 128 * n_mma) {
        const size_t so = ((size_t)page * kKeys + (e % kKeys)) * Hkv + h;
        sc_s[slot * 2 * kKeys + e] = e < kKeys ? k_scale[so] : v_scale[so];
      }
    }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;" ::"r"(128 * n_mma) : "memory");
    if (threadIdx.x == 0) mbar_arrive(rempty + 8 * rs);
  };

"""

VARIANTS = {
    "serial": [
        ("    if (MODE == kFp8Token)\n      wgmma_wait0();\n    else\n      wgmma_wait1();\n",
         "    wgmma_wait0();\n")],
    "accurate exp2": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;',
         "  (void)y;\n  return exp2f(x);")],
    "rescale where needed": [
        ("  auto rescale_and_pack = [&](const float (&alpha)[2]) {\n#pragma unroll\n"
         "    for (int j = 0; j < DV / 8; ++j)\n#pragma unroll\n"
         "      for (int h2 = 0; h2 < 2; ++h2) {\n"
         "        o[4 * j + 2 * h2] *= alpha[h2];\n"
         "        o[4 * j + 2 * h2 + 1] *= alpha[h2];\n      }\n",
         "  auto rescale_and_pack = [&](const float (&alpha)[2]) {\n"
         "    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < DV / 8; ++j)\n#pragma unroll\n"
         "      for (int h2 = 0; h2 < 2; ++h2) {\n"
         "        o[4 * j + 2 * h2] *= alpha[h2];\n"
         "        o[4 * j + 2 * h2 + 1] *= alpha[h2];\n      }\n    }\n")],
    "P in shared memory": [
        ("  static constexpr int kFixed = 1024 + kQBytes + kRawStages * kRaw + 256;",
         "  static constexpr int kFixed = 1024 + kQBytes + kRawStages * kRaw + 256 + 1024 +"
         " 2 * 64 * 128;"),
        ("  const uint32_t rfull = bars + 16 * S, rempty = rfull + 8 * R;  // the raw ring's\n",
         "  const uint32_t rfull = bars + 16 * S, rempty = rfull + 8 * R;  // the raw ring's\n"
         "  uint8_t* p_s = base + ((uint32_t)(reinterpret_cast<uint8_t*>(sc_s) + S * L::kScales"
         " + 256 - base + 1023) & ~1023u);\n"),
        ("template <int D, int MODE>\n__global__", _ss_pv(64) + _ss_pv(128)
         + "template <int D, int MODE>\n__global__"),
        ("  const uint32_t qa = smem_u32(q_s) + wg * 64 * 128;\n",
         "  const uint32_t qa = smem_u32(q_s) + wg * 64 * 128;\n"
         "  const uint32_t pa_s = smem_u32(p_s) + wg * 64 * 128;\n"),
        ("    for (int t = 0; t < kKeys / 16; ++t) {\n"
         "      const uint32_t a[4] = {pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3]};\n"
         "      wgmma_pv(o, a, v_desc(va + 16 * 128 * t));\n    }\n",
         "    for (int t = 0; t < kKeys / 16; ++t)\n"
         "      wgmma_pv_ss(o, sw_desc<128>(pa_s + 32 * t), v_desc(va + 16 * 128 * t));\n"),
        ("    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);\n",
         "    for (int j = 0; j < 8; ++j)\n      for (int h2 = 0; h2 < 2; ++h2) {\n"
         "        const int r = 16 * wi + (lane >> 2) + 8 * h2;\n"
         "        *reinterpret_cast<uint32_t*>(p_s + wg * 64 * 128 + r * 128 +\n"
         "            ((j ^ (r & 7)) << 4) + 4 * quad) =\n"
         "            pack_bf16x2(s[4 * j + 2 * h2], s[4 * j + 2 * h2 + 1]);\n      }\n"
         "    fence_async_smem();\n"
         "    asm volatile(\"bar.sync %0, 128;\" ::\"r\"(2 + wg) : \"memory\");\n")],
    "widening in the consumers": [
        ("    if (lt < 32) return;\n", "    return;\n"),
        ("      mbar_init_count(rempty + 8 * i, kConverters / 32);",
         "      mbar_init_count(rempty + 8 * i, 1);"),
        ("  // Block kb's scores are issued with block kb - 1's P V behind them: the",
         STAGE_READY + "  // Block kb's scores are issued with block kb - 1's P V behind them: the"),
        ("  mbar_wait(full, 0);\n  fence_regs(s);", "  stage_ready(0);\n  fence_regs(s);"),
        ("    mbar_wait(full + 8 * (kb % S), (kb / S) & 1);\n    fence_regs(s);\n"
         "    fence_regs(o);\n    wgmma_fence();\n    issue_s(kb);\n    issue_pv(kb - 1);\n",
         "    if (MODE == kBf16) {\n      stage_ready(kb);\n      fence_regs(s);\n"
         "      fence_regs(o);\n      wgmma_fence();\n      issue_s(kb);\n"
         "      issue_pv(kb - 1);\n    } else {  // P V under the widening, then S\n"
         "      fence_regs(o);\n      wgmma_fence();\n      issue_pv(kb - 1);\n"
         "      stage_ready(kb);\n      fence_regs(s);\n      wgmma_fence();\n"
         "      issue_s(kb);\n      wgmma_wait0();\n    }\n")],
    "ascending tiles": [
        ("  const int tile = causal ? n_tiles - 1 - (int)blockIdx.z : (int)blockIdx.z;",
         "  const int tile = (int)blockIdx.z;")],
    "no widening": [
        ("      for (int e = ct; e < kKeys * (kKU + kVU); e += kConverters) {",
         "      for (int e = ct; e < 0; e += kConverters) {")],
}
WRONG_BY_DESIGN = ("no widening",)


def variant(b, name: str, edits) -> Path:
    """A copy of csrc/ with ``edits`` ((old, new), ...) applied to the source."""
    import shutil

    root = b.PKG_DIR.parent / "build" / "attention_variants" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(b.PKG_DIR / "csrc", root / "csrc")
    path = root / "csrc" / SRC
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not once in {SRC}: {old!r}")
        src = src.replace(old, new)
    path.write_text(src)
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
        sys.exit("attention_variants: torch.cuda is not available")
    from painlessinferenceacceleration_tpu_torch import _build as b
    from painlessinferenceacceleration_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    b.SOURCES = ("paged_attention",)
    g = torch.Generator(device="cuda").manual_seed(0)
    D, ps = 128, 64

    def arena(ctx, Q, Hkv, kind):
        P = -(-(ctx + Q) // ps) + 1
        k = torch.randn(P + 1, ps, Hkv * D, generator=g, device="cuda")
        v = torch.randn(P + 1, ps, Hkv * D, generator=g, device="cuda")
        pt = (torch.randperm(P, generator=g, device="cuda") + 1)[None].to(torch.int32)
        if kind == "bf16":
            return k.to(torch.bfloat16), v.to(torch.bfloat16), pt, None
        tok = kind == "fp8_tok"
        out = []
        for x in (k, v):
            xh = x.reshape(P + 1, ps, Hkv, D)
            amax = xh.abs().amax(-1) if tok else xh.abs().amax(dim=(0, 1, 3))
            s = (amax / 448.0).clamp(min=1e-8).contiguous()
            y = xh / (s[..., None] if tok else s[:, None])
            out.append((y.to(torch.float8_e4m3fn).reshape(x.shape), s))
        return out[0][0], out[1][0], pt, (out[0][1], out[1][1])

    cases = {}
    for name, kind, Q, Hq, Hkv, ctx in (
            ("Q=512 ctx=512 32/32", "bf16", 512, 32, 32, 512),
            ("Q=512 ctx=512 32/32", "fp8", 512, 32, 32, 512),
            ("Q=512 ctx=512 32/32", "fp8_tok", 512, 32, 32, 512),
            ("Mixtral Q=2048 32/8", "bf16", 2048, 32, 8, 0),
            ("Mixtral Q=2048 32/8", "fp8_tok", 2048, 32, 8, 0),
            ("Ring Q=4096 16/4", "bf16", 4096, 16, 4, 0),
            ("decode Q=1 ctx=640 32/32", "bf16", 1, 32, 32, 640),
            ("verify Q=17 ctx=768 32/8", "bf16", 17, 32, 8, 768)):
        k, v, pt, sc = arena(ctx, Q, Hkv, kind)
        q = torch.randn(1, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
        c = torch.tensor([ctx], dtype=torch.int32, device="cuda")
        if Q == 1 or Q == 17:
            m = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device="cuda"))[None]
            fn = (lambda q=q, k=k, v=v, pt=pt, c=c, m=m, sc=sc:
                  pa.paged_attention(q, k, v, pt, c, m, D ** -0.5, sc))
        elif kind == "fp8_tok":
            fn = (lambda q=q, k=k, v=v, pt=pt, c=c, sc=sc:
                  pa.paged_attention_tok(q, k, v, sc[0], sc[1], pt, c, D ** -0.5))
        else:
            fn = (lambda q=q, k=k, v=v, pt=pt, c=c, sc=sc:
                  pa.paged_attention_prefill(q, k, v, pt, c, D ** -0.5, sc))
        cases[f"{name} {kind}"] = (fn, Q)
    roots = {name: variant(b, name, edits) for name, edits in VARIANTS.items()}
    out = dict(card=card, ms={}, max_abs_diff={})
    use(b, None)
    ref = {case: fn().float() for case, (fn, _) in cases.items()}
    for name in ("as is", *VARIANTS, "as is"):
        use(b, roots.get(name))
        spills = re.findall(r"(\d+) bytes spill stores", b.ptxas_report("paged_attention"))
        regs = re.findall(r"Used (\d+) registers", b.ptxas_report("paged_attention"))
        out.setdefault("ptxas", {})[name] = dict(registers=regs, spill_stores=spills)
        print(f"{name}: ptxas registers {regs}, spill stores {spills}", flush=True)
        for case, (fn, Q) in cases.items():
            key = f"{name}: {case}"
            got = fn().float()
            if name not in WRONG_BY_DESIGN:
                out["max_abs_diff"][key] = (got - ref[case]).abs().max().item()
            out["ms"].setdefault(key, []).append(graph_ms(fn, reps=5 if Q >= 2048 else 10))
            print(key, out["ms"][key], out["max_abs_diff"].get(key), flush=True)
    if cli.json:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
