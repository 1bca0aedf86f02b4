#!/usr/bin/env python3
"""Drive the PyTorch port (painlessinferenceacceleration_tpu_torch) on one GPU.

    python3 chip_smoke.py [--json PATH]

Phases, one line each (any failure exits non-zero and prints no result):

1. environment: the card, CUDA, nvcc, triton, and the kernels' build time;
2. every CUDA kernel of the main path against its plain torch version at the
   main path's shapes (bf16), with its time, the plain version's time, the
   bound the card could reach and a PyTorch library call as a yardstick;
3. the main path at full width: Llama-2-7B, int4 group-128 weights (random,
   from a fixed torch.Generator seed), a bf16 paged arena (page 64, 4096
   tokens), a 512-token prefill, 128 greedy AR tokens, lookahead decode
   (branch 16, one branch, Q = 17) for ~256 tokens, and the strict lossless
   check: the lookahead stream must equal, token for token, the same program
   run from a fresh prefill with empty frozen tables;
4. the launch count of every kernel during phase 3 (all must be > 0), and
   the ``kernels`` JSON line.

The last two lines are the card's name and power limit (as nvidia-smi gives
them) and ``{"ok": true, "device": {...}}``. ``--json PATH`` also writes
every number to PATH. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
SEED = 0
PROMPT_LEN = 512
AR_TOKENS = 128
SPEC_TOKENS = 256
SPEC_CHUNK = 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment(pkg) -> dict:
    import torch

    nvcc = pkg["_build"]._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    t0 = time.perf_counter()
    pkg["_build"].build_all()
    for name in pkg["_build"].SOURCES:
        pkg["_build"].library(name)
    build_s = time.perf_counter() - t0
    env = dict(card=smi_line(), torch=torch.__version__, cuda=torch.version.cuda,
               nvcc=ver, triton=has_triton, build_s=round(build_s, 3))
    print("phase 1 environment: " + json.dumps(env))
    return env


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

QMM = "painlessinferenceacceleration_tpu/ops/quant_matmul.py"
PAT = "painlessinferenceacceleration_tpu/ops/paged_attention.py"
KVU = "painlessinferenceacceleration_tpu/ops/kv_update.py"
SRC = "painlessinferenceacceleration_tpu_torch/csrc/"


def _case(name, source, replaces, err, rel, ms, plain_ms, bnd, lib_ms, case):
    b, by = bnd
    return dict(name=name, route="cuda", source=SRC + source, replaces=replaces,
                case=case, max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms)


def _errs(got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / (ref.float().abs().max().item() + 1e-12)


def check_int4_gemm(pkg, g, M, K, N, out_dtype, replaces):
    import torch

    qm = pkg["quant_matmul"]
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (K // 2, N), generator=g, device="cuda", dtype=torch.uint8)
    s = (torch.rand(K // 128, N, generator=g, device="cuda") * 0.004 + 0.001).to(torch.bfloat16)
    got = qm.int4_matmul(x, q, s, out_dtype)
    ref = qm.int4_matmul_plain(x, q, s, out_dtype)
    err, rel = _errs(got, ref)
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-4
    if not rel <= tol:
        fail(f"int4_gemm M={M} K={K} N={N}: rel err {rel} > {tol}")
    w = pkg["linear"].dequantize({"q": q, "s": s}, dtype=torch.bfloat16)
    ms = time_ms(lambda: qm.int4_matmul(x, q, s, out_dtype))
    plain_ms = time_ms(lambda: qm.int4_matmul_plain(x, q, s, out_dtype), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(x, w))
    osz = 2 if out_dtype == torch.bfloat16 else 4
    nbytes = M * K * 2 + K * N // 2 + (K // 128) * N * 2 + M * N * osz
    return _case("int4_gemm", "int4_gemm.cu", replaces, err, rel, ms, plain_ms,
                 bound_ms(nbytes, 2.0 * M * K * N), lib_ms,
                 f"M={M} K={K} N={N} out={str(out_dtype).split('.')[-1]}")


def _arena(g, B, ctx_max, Q, Hkv, D, ps):
    import torch

    P = -(-(ctx_max + Q) // ps) + 1
    n_pages = B * P + 1
    k = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")[: B * P] + 1
    return k, v, perm.reshape(B, P).to(torch.int32)


def check_attention(pkg, g, kind, B, Q, Hq, Hkv, ctx, qmask, replaces):
    """kind: 'decode' / 'verify' (paged_attention) or 'prefill' (causal)."""
    import torch
    import torch.nn.functional as F

    D, ps = 128, 64
    pa, ref_mod = pkg["paged_attention"], pkg["attention"]
    k, v, pt = _arena(g, B, ctx, Q, Hkv, D, ps)
    ctx_t = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(B, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    scale = D ** -0.5
    if kind == "prefill":
        qmask = ref_mod.causal_qmask(Q, "cuda")[None].expand(B, Q, Q)

        def run():
            return pa.paged_attention_prefill(q, k, v, pt, ctx_t, scale)
    else:
        def run():
            return pa.paged_attention(q, k, v, pt, ctx_t, qmask, scale)
    got = run()
    ref = ref_mod.paged_attention_ref(q, k, v, pt, ctx_t, qmask, scale)
    err, rel = _errs(got, ref)
    if not rel <= 2e-2:
        fail(f"paged attention {kind} B={B} Q={Q} Hq={Hq} Hkv={Hkv}: rel err {rel}")
    ms = time_ms(run)
    plain_ms = time_ms(lambda: ref_mod.paged_attention_ref(q, k, v, pt, ctx_t, qmask, scale), reps=5)
    # yardstick: SDPA over the K/V gathered (outside the timing) with the mask
    G = Hq // Hkv
    gk = pkg["cache"].gather_kv_pages(k, pt, D).repeat_interleave(G, dim=1)
    gv = pkg["cache"].gather_kv_pages(v, pt, D).repeat_interleave(G, dim=1)
    mask = ref_mod.attention_mask(ctx_t, qmask, gk.shape[2])[:, None]
    qt = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, gk, gv, attn_mask=mask, scale=scale))
    vis = int(mask[:, 0].sum().item()) * Hq  # visible (row, key) pairs
    nbytes = 2 * B * (ctx + Q) * Hkv * D * 2 + 2 * q.numel() * 2
    name = "paged_attention_prefill" if kind == "prefill" else f"paged_attention[{kind}]"
    return _case(name, "paged_attention.cu", replaces, err, rel, ms, plain_ms,
                 bound_ms(nbytes, 4.0 * vis * D), lib_ms,
                 f"B={B} Q={Q} Hq={Hq} Hkv={Hkv} ctx={ctx} ps={ps}")


def check_kv_permute(pkg, g, L, n_pages, ps, HD, B, TPP, moves: bool):
    import torch

    ku = pkg["kv_update"]
    W = TPP * ps
    pages = torch.randn(L, n_pages, ps, HD, generator=g, device="cuda").to(torch.bfloat16)
    ids = (torch.randperm(n_pages - 1, generator=g, device="cuda")[: B * TPP] + 1)
    ids = ids.reshape(B, TPP).to(torch.int32)
    if moves:
        src = torch.stack([torch.randperm(W, generator=g, device="cuda") for _ in range(B)])
    else:
        src = torch.arange(W, device="cuda")[None].expand(B, W)
    src = src.to(torch.int32).contiguous()
    got = ku.kv_permute_pages(pages.clone(), ids, src)
    ref = ku.kv_permute_pages_plain(pages.clone(), ids, src)
    if not torch.equal(got, ref):
        fail("kv_permute_pages differs from its plain version")
    err, rel = _errs(got, ref)
    work = pages.clone()
    ms = time_ms(lambda: ku.kv_permute_pages(work, ids, src))
    plain_ms = time_ms(lambda: ku.kv_permute_pages_plain(work, ids, src), reps=5)
    moved = int((src != torch.arange(W, device="cuda")[None]).sum().item())
    # each moved row: its source read once, its destination written once
    nbytes = L * 2 * moved * HD * pages.element_size() + (ids.numel() + src.numel()) * 4
    return _case("kv_permute_pages", "kv_permute.cu", f"{KVU}:144 _permute_kernel",
                 err, rel, ms, plain_ms, bound_ms(nbytes, 0.0), None,
                 f"L={L} B={B} TPP={TPP} ps={ps} HD={HD} moved_rows={moved}")


def phase_kernels(pkg, cfg) -> list:
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_key_value_heads * cfg.head_dim
    layer_shapes = [(E, E + 2 * HD), (E, E), (E, 2 * I), (I, E)]
    rows = []
    for M in (1, 17, 512):
        for K, N in layer_shapes:
            rows.append(check_int4_gemm(pkg, g, M, K, N, torch.bfloat16,
                                        f"{QMM}:147 _qmm4_stacked_kernel_v3"))
    for M in (1, 17):
        rows.append(check_int4_gemm(pkg, g, M, E, V, torch.float32,
                                    f"{QMM}:142 _qmm4_kernel_v3"))
    dt = pkg["device_tables"]
    branches = torch.randint(3, V, (2, 8), generator=g, device="cuda")
    _, _, tree, _ = dt.build_tree_inputs(torch.tensor(1, device="cuda"), branches)
    tree = tree[None]  # [1, 17, 17], R=2 L=8 tree mask
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    H = cfg.num_attention_heads
    for Hkv in (H, 8):  # the model's MHA, and one GQA geometry
        rows.append(check_attention(pkg, g, "decode", 1, 1, H, Hkv, 640, one,
                                    f"{PAT}:236 _attn_decode_kernel"))
        rows.append(check_attention(pkg, g, "verify", 1, 17, H, Hkv, 768, tree,
                                    f"{PAT}:54 _attn_verify_kernel"))
    for ctx in (0, 512):
        rows.append(check_attention(pkg, g, "prefill", 1, 512, H, H, ctx, None,
                                    f"{PAT}:851 _attn_prefill_kernel"))
    L = cfg.num_hidden_layers
    for moves in (True, False):
        rows.append(check_kv_permute(pkg, g, L, 65, 64, HD, 1, 2, moves))
    torch.cuda.synchronize()
    for r in rows:
        print("phase 2 kernel: " + json.dumps(r))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_main_path(pkg, cfg, spec) -> dict:
    import numpy as np
    import torch

    counted = (pkg["quant_matmul"].int4_matmul, pkg["paged_attention"].paged_attention,
               pkg["paged_attention"].paged_attention_prefill,
               pkg["kv_update"].kv_permute_pages)

    def reset():
        for f in counted:
            f.launches = 0

    def counts():
        return [f.launches for f in counted]

    step, ms_mod, dt = pkg["step"], pkg["multistep"], pkg["device_tables"]
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=4096, max_concurrency=1)
    tcfg = dt.DraftTableConfig(buckets=16384, ways=8, branch_length=16, retrieve_count=1)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pkg["base"].init_params_quantized(cfg, spec, gen)
    prompt = np.random.default_rng(SEED).integers(10, cfg.vocab_size - 10, PROMPT_LEN)
    prompt_t = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    ctx0 = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    TAIL = tcfg.branch_length + 2

    def prefill():
        kv = pkg["cache"].init_kv_cache(cfg, ecfg)
        kv, nxt, logits = step.prefill_step(params, kv, cfg, prompt_t,
                                            torch.zeros(1, dtype=torch.int32, device="cuda"),
                                            ctx0, pt, spec)
        return kv, nxt, logits

    def spec_run(empty_tables: bool, update: bool, max_steps: int):
        kv, nxt, _ = prefill()
        tables = dt.init_draft_tables(tcfg)
        seed = prompt.tolist() + [int(nxt[0])]
        if not empty_tables:
            dt.update_tables_seq(tables, tcfg, torch.tensor(seed, dtype=torch.int32,
                                                            device="cuda"), len(seed))
        tail = torch.tensor([seed[-TAIL:]], dtype=torch.int32, device="cuda")
        stream, n_steps, last, ctx, act = [int(nxt[0])], 0, nxt, ctx0, one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while len(stream) < SPEC_TOKENS and n_steps < max_steps:
            kv, tables, out, acc, last, ctx, act, tail, _ = ms_mod.multistep_spec_decode(
                params, kv, tables, cfg, tcfg, last, ctx, act, tail, pt,
                n_steps=SPEC_CHUNK, spec=spec, update_tables=update)
            out, acc = out[0].tolist(), acc[0].tolist()
            for si in range(SPEC_CHUNK):
                stream.extend(out[si][: acc[si]])
            n_steps += SPEC_CHUNK
        torch.cuda.synchronize()
        return stream, n_steps, time.perf_counter() - t0, tables

    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv, nxt, logits = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    c_prefill = counts()
    if not (torch.isfinite(logits).all() and logits.shape == (1, cfg.vocab_size)):
        fail("prefill logits are not finite or have the wrong shape")
    t0 = time.perf_counter()
    kv, toks, _, ctx, _, _ = ms_mod.multistep_decode(
        params, kv, cfg, nxt, ctx0, one, pt, n_steps=AR_TOKENS - 1, spec=spec)
    ar_stream = [int(nxt[0])] + toks[0].tolist()
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    c_ar = counts()
    if int(ctx[0]) != PROMPT_LEN + AR_TOKENS - 1 or min(ar_stream) < 0:
        fail("AR decode did not advance one token per step")
    del kv
    spec_stream, spec_steps, spec_s, tables = spec_run(False, True, SPEC_TOKENS)
    c_spec = counts()
    launches = dict(zip(("int4_gemm", "paged_attention", "paged_attention_prefill",
                         "kv_permute_pages"), c_spec))
    launches["paged_attention[decode]"] = c_ar[1] - c_prefill[1]
    launches["paged_attention[verify]"] = c_spec[1] - c_ar[1]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    replay, replay_steps, _, _ = spec_run(True, False, 4 * SPEC_TOKENS)
    n = min(len(spec_stream), len(replay))
    div = next((i for i in range(n) if spec_stream[i] != replay[i]), n)
    n_ar = min(len(spec_stream), len(ar_stream))
    ar_div = next((i for i in range(n_ar) if spec_stream[i] != ar_stream[i]), n_ar)
    res = dict(
        table_ms=table_costs(pkg, tcfg, tables, spec_stream, TAIL),
        profile=profile_steps(pkg, cfg, spec, params, ecfg, tcfg, prompt_t, pt, ctx0),
        prefill_ms=prefill_ms, ar_tok_s=(AR_TOKENS - 1) / ar_s,
        spec_tok_s=(len(spec_stream) - 1) / spec_s,
        accepted_per_step=(len(spec_stream) - 1) / spec_steps,
        spec_tokens=len(spec_stream), spec_steps=spec_steps,
        lossless_strict=div == n, lossless_compared=n, first_divergence=div,
        spec_vs_ar_first_divergence=ar_div, spec_vs_ar_compared=n_ar,
        peak_mem_gb=peak_gb, launches=launches,
    )
    print("phase 3 main path: " + json.dumps(res))
    if div != n or n < SPEC_TOKENS // 2:
        fail(f"lossless check failed: first divergence {div} of {n}")
    return res


def _host_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def table_costs(pkg, tcfg, tables, stream, TAIL) -> dict:
    """Host-clock cost of one decode step's eager draft-table work on the
    populated tables: retrieval + tree inputs, and the streamed update for
    1 and for 17 newly accepted tokens."""
    import torch

    dt = pkg["device_tables"]
    tail = torch.tensor([stream[-TAIL - 17: -17]], dtype=torch.int32, device="cuda")
    last = tail[:, -1]

    def retrieve():
        branches, _ = dt.retrieve_drafts(tables, tcfg, tail[:, -2], last)
        dt.build_tree_inputs(last, branches)

    out = dict(retrieve_and_tree=_host_ms(retrieve))
    for n in (1, 17):
        buf = torch.tensor(stream[-TAIL - n:] + [-1] * (17 - n), dtype=torch.int32,
                           device="cuda")
        out[f"update_{n}_new"] = _host_ms(
            lambda: dt.update_tables_seq(tables, tcfg, buf, TAIL + n, win_lo=TAIL,
                                         win_hi=TAIL + n))
    return out


def profile_steps(pkg, cfg, spec, params, ecfg, tcfg, prompt_t, pt, ctx0) -> dict:
    """torch.profiler over 16 AR decode steps and 4 lookahead steps: the
    device's busy share of the wall time and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step, ms_mod, dt = pkg["step"], pkg["multistep"], pkg["device_tables"]
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    res = {}
    for mode in ("ar", "spec"):
        kv = pkg["cache"].init_kv_cache(cfg, ecfg)
        kv, nxt, _ = step.prefill_step(params, kv, cfg, prompt_t,
                                       torch.zeros(1, dtype=torch.int32, device="cuda"),
                                       ctx0, pt, spec)
        tables = dt.init_draft_tables(tcfg)
        tail = torch.full((1, tcfg.branch_length + 2), -1, dtype=torch.int32, device="cuda")

        def run():
            if mode == "ar":
                ms_mod.multistep_decode(params, kv, cfg, nxt, ctx0, one, pt,
                                        n_steps=16, spec=spec)
            else:
                ms_mod.multistep_spec_decode(params, kv, tables, cfg, tcfg, nxt, ctx0,
                                             one, tail, pt, n_steps=4, spec=spec)
            torch.cuda.synchronize()

        run()  # warm
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        res[mode] = dict(
            wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
            device_busy_share=busy / wall_us if busy else None,
            top=[dict(kernel=k[:60], ms=us / 1e3, calls=c) for us, k, c in rows[:6]])
        del kv
    return res


def load_port():
    if not (HERE / "painlessinferenceacceleration_tpu_torch" / "__init__.py").exists():
        fail("the port package is not beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    import importlib

    base = "painlessinferenceacceleration_tpu_torch."
    names = dict(_build="_build", config="config", linear="layers.linear",
                 quant_matmul="ops.quant_matmul", paged_attention="ops.paged_attention",
                 attention="ops.attention", kv_update="ops.kv_update",
                 cache="engine.cache", step="engine.step", multistep="engine.multistep",
                 device_tables="lookahead.device_tables", base="models.base")
    return {k: importlib.import_module(base + v) for k, v in names.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write all numbers here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda is not available")
    pkg = load_port()
    env = phase_environment(pkg)
    cfg = pkg["config"].ModelConfig.llama2_7b()
    spec = pkg["linear"].QuantSpec(bits=4, group=128)
    rows = phase_kernels(pkg, cfg)
    main_res = phase_main_path(pkg, cfg, spec)
    launches = main_res["launches"]
    for r in rows:
        key = r["name"] if r["name"] in launches else r["name"].split("[")[0]
        r["launches"] = launches[key]
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched on the main path")
    print("phase 4 launches: " + json.dumps(launches))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                             main_path=main_res), indent=1))
    print(json.dumps({"kernels": rows}))
    print(env["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
