#!/usr/bin/env python3
"""Prefill time and attention's share of it at four models, and the
attention kernels at those models' own shapes, on one card:

    python3 tools/attention_profile.py [--root DIR] [--json PATH] [--rows-only]
        [--models NAME,...] [--rows paged,mla]

``--root`` imports the port from another tree (for instance a parent commit
unpacked under ``build/``), which builds its own kernels; run the script
once per tree, in turns (parent, change, change, parent), to compare two
trees on one card.

Models (``--models``, default all), random weights from seed 0, B = 1,
page 64, as ``chip_smoke.py`` runs them: Llama-2-7B with int4 group-128
linears (32 layers, a 512-token prompt), Mixtral-8x7B in bf16 (16 of 32
layers, 2048 tokens), Ring-mini-linear-2.0 in bf16 (all 20 layers, experts
in 2 expert shards, 4096 tokens) and DeepSeek-V2-Lite in bf16 (all 27
layers, 4096 tokens; its attention is K13, the MLA kernel). Each prefill
runs once to warm up, three times under the host clock (median wall ms),
and once under ``torch.profiler``: the device time of the kernels
(operators' rows left out: their time is their kernels'), and that of the
attention kernels (names holding ``paged_attention``; for the MLA model
``mla_attention`` or ``mla_combine``) as a share of it.

Rows (``--rows``): ``paged``, the paged attention wrappers at each model's
prefill shape (causal, no cached keys; bf16 and per-token e4m3 arenas);
``mla``, K13 at the cases of ``chip_smoke.py``'s phase_mla_kernels
(DeepSeek-V2-Lite's 16 heads and V3's 128: decode, a 17-wide tree verify,
prefills of 512 and 4096 tokens). Each is held against its plain version
(rel <= 2e-2), with its time under CUDA events (``ms``), its device time in
a CUDA graph of the calls (``device_ms``), the plain version's time, the
bound and SDPA's time on the K/V gathered beforehand (``library_ms``).
Prints one JSON line per model and row and the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
SEED = 0
# (model, layers, quant, prompt tokens, expert shards)
MODELS = (("llama2_7b", 32, "int4", 512, 1),
          ("mixtral_8x7b", 16, "bf16", 2048, 1),
          ("ring_mini_linear_2", 20, "bf16", 4096, 2),
          ("deepseek_v2_lite", 27, "bf16", 4096, 1))
MLA_DK, MLA_DV = 576, 512


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 5, replays: int = 3) -> float:
    """Device time of one call: ``reps`` calls in a CUDA graph, replayed."""
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


def load(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import importlib

    base = "painlessinferenceacceleration_tpu_torch."
    names = dict(_build="_build", config="config", linear="layers.linear",
                 models="models.base", moe="models.moe", cache="engine.cache",
                 step="engine.step", pa="ops.paged_attention", attention="ops.attention",
                 ma="ops.mla_attention")
    pkg = {k: importlib.import_module(base + v) for k, v in names.items()}
    if not str(pkg["_build"].PKG_DIR).startswith(str(root.resolve())):
        raise SystemExit(f"imported the port from {pkg['_build'].PKG_DIR}, not {root}")
    return pkg


def profile_prefill(pkg, name, layers, quant, prompt_len, shards) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = getattr(pkg["config"].ModelConfig, name)()
    cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    if shards > 1:
        cfg = dataclasses.replace(cfg, expert_parallel=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    spec = None
    if quant == "int4":
        spec = pkg["linear"].QuantSpec(bits=4, group=128)
        params = pkg["models"].init_params_quantized(cfg, spec, gen)
    else:
        params = pkg["models"].init_params(cfg, gen, dtype=torch.bfloat16)
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=prompt_len + 512,
                                      max_concurrency=1)
    prompt = np.random.default_rng(SEED).integers(10, cfg.vocab_size - 10, prompt_len)
    prompt_t = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    ctx0 = torch.tensor([prompt_len], dtype=torch.int32, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")

    def prefill():
        kv = pkg["cache"].init_kv_cache(cfg, ecfg)
        out = pkg["step"].prefill_step(params, kv, cfg, prompt_t, zero, ctx0, pt, spec)
        torch.cuda.synchronize()
        return out

    with pkg["moe"].expert_shards(shards):
        prefill()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, _, logits = prefill()
            walls.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits).all():
            raise SystemExit(f"{name}: prefill logits are not finite")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill()
            prof_wall = (time.perf_counter() - t0) * 1e3
    rows = []  # kernels only: an operator's device time is its kernels'
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    keys = ("mla_attention", "mla_combine") if cfg.is_mla else ("paged_attention",)
    att = [r for r in rows if any(k in r[1] for k in keys)]
    att_ms = sum(r[0] for r in att) / 1e3
    del params
    torch.cuda.empty_cache()
    return dict(model=name, layers=layers, quant=quant, prompt_len=prompt_len,
                expert_shards=shards, prefill_ms=statistics.median(walls),
                prefill_walls_ms=walls, profiled_wall_ms=prof_wall, device_ms=dev_ms,
                attention_device_ms=att_ms,
                attention_launches=sum(r[2] for r in att),
                attention_share_of_device=att_ms / dev_ms if dev_ms else None,
                attention_share_of_wall=att_ms / prof_wall,
                top=[dict(kernel=k[:70], ms=us / 1e3, calls=c) for us, k, c in rows[:6]])


def attention_row(pkg, g, arena, Q, Hq, Hkv, D=128, ps=64, ctx=0) -> dict:
    import torch
    import torch.nn.functional as F

    pa, ref = pkg["pa"], pkg["attention"]
    P = -(-(ctx + Q) // ps) + 1
    n_pages = P + 1
    k = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda")
    v = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda")
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda")[:P] + 1)[None]
    pt = pt.to(torch.int32)
    ks = vs = None
    if arena == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:  # per-token e4m3: scale = amax / 448 per (token, kv head)
        out = []
        for t in (k, v):
            th = t.reshape(n_pages, ps, Hkv, D)
            s = (th.abs().amax(-1) / 448.0).clamp(min=1e-8).contiguous()
            out.append(((th / s[..., None]).to(torch.float8_e4m3fn).reshape(t.shape), s))
        (k, ks), (v, vs) = out
    q = torch.randn(1, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    ctx_t = torch.tensor([ctx], dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    qmask = ref.causal_qmask(Q, "cuda")[None]
    if arena == "bf16":
        def run():
            return pa.paged_attention_prefill(q, k, v, pt, ctx_t, scale)
    else:
        def run():
            return pa.paged_attention_tok(q, k, v, ks, vs, pt, ctx_t, scale, None)
    got = run()
    want = ref.paged_attention_ref(q, k, v, pt, ctx_t, qmask, scale, ks, vs)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / (want.float().abs().max().item() + 1e-12)
    if not rel <= 2e-2:
        raise SystemExit(f"attention {arena} Q={Q} Hq={Hq} Hkv={Hkv}: rel err {rel}")
    ms = time_ms(run)
    dev_ms = graph_ms(run)
    G = Hq // Hkv
    cache = pkg["cache"]
    gk = cache.gather_kv_pages(k, pt, D, ks, torch.bfloat16).repeat_interleave(G, dim=1)
    gv = cache.gather_kv_pages(v, pt, D, vs, torch.bfloat16).repeat_interleave(G, dim=1)
    mask = ref.attention_mask(ctx_t, qmask, gk.shape[2])[:, None]
    qt = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, gk, gv, attn_mask=mask,
                                                            scale=scale))
    vis = int(mask[:, 0].sum().item()) * Hq
    kv_elem = 2 if arena == "bf16" else 1
    nbytes = 2 * (ctx + Q) * Hkv * D * kv_elem + 2 * q.numel() * 2
    if arena == "fp8_tok":
        nbytes += 2 * (ctx + Q) * Hkv * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 4.0 * vis * D / BF16_FLOPS * 1e3
    return dict(arena=arena, Q=Q, Hq=Hq, Hkv=Hkv, ctx=ctx, max_rel_err=rel, ms=ms,
                device_ms=dev_ms, library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def mla_row(pkg, g, kind, H, ctx, Q) -> dict:
    """K13 on unit-normal latent pages (permuted page tables) against its
    plain version: 'decode', 'verify' (a random tree-like causal mask) or
    'prefill' (the causal flag)."""
    import torch
    import torch.nn.functional as F

    ma, ref = pkg["ma"], pkg["attention"]
    B = len(ctx)
    P = -(-(max(ctx) + Q) // 64) + 1
    n = B * P + 1
    k = torch.randn(n, 64, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n - 1, generator=g, device="cuda")[: B * P] + 1).reshape(B, P)
    pt = pt.to(torch.int32)
    q = torch.randn(B, Q, H, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    causal = kind == "prefill"
    if kind == "verify":
        qm = torch.rand(B, Q, Q, generator=g, device="cuda") < 0.5
        qm = (qm | torch.eye(Q, dtype=torch.bool, device="cuda")).tril()
    else:
        qm = ref.causal_qmask(Q, "cuda")[None].expand(B, Q, Q)
    scale = (128 + 64) ** -0.5

    def run():
        return ma.mla_paged_attention(q, k, pt, ctx_t, qm, scale, MLA_DV, causal=causal)

    def plain():
        return ma.mla_paged_attention_plain(q, k, pt, ctx_t, qm, scale, MLA_DV)
    got, want = run(), plain()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / (want.float().abs().max().item() + 1e-12)
    if not rel <= 2e-2:
        raise SystemExit(f"mla_attention {kind} H={H} Q={Q} ctx={ctx}: rel err {rel}")
    big = B * Q * H >= 4096
    ms = time_ms(run, reps=5 if big else 10)
    dev_ms = graph_ms(run)
    plain_ms = time_ms(plain, reps=2, warmup=1)
    gk = pkg["cache"].gather_kv_pages(k, pt, MLA_DK, None, torch.bfloat16)
    mask = ref.attention_mask(ctx_t, qm, gk.shape[2])[:, None]
    qt = q.transpose(1, 2)
    kx, vx = gk.expand(B, H, -1, MLA_DK), gk[..., :MLA_DV].expand(B, H, -1, MLA_DV)
    try:
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask,
                                                                scale=scale))
    except RuntimeError:
        lib_ms = None
    vis = int(mask.sum().item()) * H
    keys = int((ctx_t.long() + Q).sum().item())
    nbytes = keys * MLA_DK * 2 + q.numel() * 2 + got.numel() * 2 + pt.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * vis * (MLA_DK + MLA_DV) / BF16_FLOPS * 1e3
    return dict(kernel="mla_attention", kind=kind, H=H, Q=Q, ctx=ctx, max_rel_err=rel,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


MLA_ROWS = (("decode", 16, [640], 1), ("decode", 16, [4096], 1),
            ("verify", 16, [4096], 17), ("prefill", 16, [0], 512),
            ("prefill", 16, [512], 512), ("prefill", 16, [0], 4096),
            ("decode", 128, [4096], 1), ("verify", 128, [4096], 17),
            ("decode", 16, [63, 64, 65, 4095], 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="root of the tree whose port is measured")
    ap.add_argument("--json", type=Path, default=None, help="also write the numbers here")
    ap.add_argument("--rows-only", action="store_true", help="skip the models' prefills")
    ap.add_argument("--models", default="all",
                    help="comma-separated model names of MODELS, or all")
    ap.add_argument("--rows", default="paged", help="comma-separated: paged, mla (or none)")
    args = ap.parse_args()
    rows = set(args.rows.split(","))
    models = [m for m in MODELS if args.models == "all" or m[0] in args.models.split(",")]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_profile: torch.cuda is not available")
    pkg = load(args.root)
    t0 = time.perf_counter()
    pkg["_build"].build_all()
    out = dict(root=str(args.root), card=smi_line(), build_s=time.perf_counter() - t0,
               rows=[], models=[])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    if "paged" in rows:
        for arena in ("bf16", "fp8_tok"):
            for Q, Hq, Hkv in ((512, 32, 32), (2048, 32, 8), (4096, 16, 4)):
                out["rows"].append(attention_row(pkg, g, arena, Q, Hq, Hkv))
                print("row: " + json.dumps(out["rows"][-1]), flush=True)
    if "mla" in rows:
        for case in MLA_ROWS:
            out["rows"].append(mla_row(pkg, g, *case))
            print("row: " + json.dumps(out["rows"][-1]), flush=True)
    if not args.rows_only:
        for m in models:
            out["models"].append(profile_prefill(pkg, *m))
            print("model: " + json.dumps(out["models"][-1]), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(out["card"])


if __name__ == "__main__":
    main()
