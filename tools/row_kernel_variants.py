#!/usr/bin/env python3
"""K16 (the KV row write), K4 (the KV compaction), K6 (the page
write-back), K17 (the row move) and K15 (RMSNorm) at the main paths'
shapes, and K4's staging variants, on one card:

    python3 tools/row_kernel_variants.py [--root DIR] [--json PATH]
                                         [--variants [k4|k6|k17]] [--rows all|write|kv]

``--root`` imports the port from another tree (for instance a parent commit
unpacked under ``build/``), which builds its own kernels; run the script
once per tree, in turns (parent, change, change, parent), to compare two
trees on one card. Imports nothing of JAX.

Rows, each tree:
- ``write_kv_pages``: the KV row write of every layer of every forward
  (``engine/cache.py``), in the bf16, static e4m3, per-token e4m3 and MLA
  latent arenas at B = 1 Q = 1, Q = 17 and an 8 x 512 prefill chunk: wall,
  ``device_ms`` (L2 cold), ``device_warm_ms``, the CUDA kernels a call
  (this tree's K16 step entry, or a tree's eager route and row scatter),
  the bound and ``index_put_`` of prepared rows (see ``write_rows``).
- ``compaction``: the verify step's compaction of a Llama-2-7B arena pair
  (32 layers, 8192-byte K and V rows, page 64) through
  ``engine/step.py _commit_and_compact``, as the main paths call it: B = 1
  at Q = 17 with the one-branch path (nothing moves), R = 2 L = 8 (8 rows
  move), the generator's Q = 64 (12 rows), Q = 128 (120 rows), serving's
  B = 8 at Q = 17 (half the rows one-branch); the moved rows are those the
  first call changes (random rows). Wall ms: the median of 5 windows of
  40 back-to-back calls under CUDA events, in turns with the yardstick;
  ``device_ms`` with the L2 cold (``cold_ms``: each call in a CUDA graph
  behind a read of 256 MB, less the reads alone), ``device_warm_ms`` in a
  CUDA graph of the calls on the same rows; ``kernel_ms`` and
  ``kernels_per_call`` from torch.profiler (every CUDA kernel of the call,
  eager index ops included);
  the bound of the moved rows (each read once and written once, both
  arenas, all layers, plus the indices); ``library_ms``: ``index_copy_`` of
  the moving K rows and of the V rows, gathered beforehand (two calls).
  With ``--rows kv`` the same cases run in the bf16, static e4m3 and
  per-token e4m3 arenas (K, V and 32 heads' f32 scale rows), each with
  ``graph_kernels``, the CUDA kernels a call counted from a CUDA graph's
  kernel nodes.
- ``kv_write_pages`` (``--rows kv``): K6 at L = 32 on e4m3 pages of
  4096-byte rows and f32 scale pages of 32 heads, W = 2 and 16 window
  pages (B = 1 and 8, two pages a window), the last naming the first's
  destination: wall (in turns with ``index_copy_`` of the windows' bytes),
  device ms with the L2 cold and warm, the bound; and one ``copy_`` of W =
  16's kept bytes, the card's practical rate for a copy of that size.
- ``kv_move_rows`` (``--rows kv``): K17 at L = 32 on 8192-byte bf16 rows,
  B requests' chained accepted paths of M moves, each request's last move
  masked to the null page 0: N = 12 / 63 (B = 1) and 252 (B = 4); wall (in
  turns with ``index_put_`` of the gathered rows), device ms with the L2
  cold and warm, the bound.
- ``kv_permute_pages``: K4's general entry at L = 32, a 2-page window of
  8192-byte rows, 127 rows moving and none (the rows of PERF.md), with
  ``device_ms`` (L2 cold), ``device_warm_ms`` and ``index_copy_``.
- ``rms_norm``: K15 at the cases of PERF.md's row 13 (bf16 hidden rows of
  2048 and 4096, per-head rows of 128, the gated group norm of 16 groups of
  128, MLA's kv_a rows, 512 of 576), with ``device_ms`` (L2 cold),
  ``device_warm_ms`` and ``F.rms_norm`` for the plain kind.

``--variants`` (this tree only) times K4's compaction and general entry in
each staging route (the tree's cp.async.bulk copies, or 16-byte loads in a
copy of its source under ``build/row_kernel_variants/``), staging budget
and block count, device ms with the L2 cold, in two turns. ``--variants
k17`` times K17 at the ``kv_move_rows`` cases in each route at 16-byte
rows (the tree's ring of bulk copies, or the loop of 16-byte loads and
stores from an edited copy) over its plan's stage budget
(``MOVE_STAGE_BYTES``), unit target (``MOVE_MIN_UNITS``) and ring depth
(``MOVE_STAGES``), each plan first held against the plain version;
``--variants k6`` times K6 at the
``kv_write_pages`` cases over its ring (piece bytes and stages, edited
copies) and blocks an SM (``PAGE_BLOCKS_PER_SM``); both in two turns.
Prints one JSON line per row and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
SEED = 0
L, PS, HD = 32, 64, 4096  # Llama-2-7B's arena: 32 layers, 32 kv heads x 128


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def _capture(body):
    """A CUDA graph of ``body()`` (run once before, outside the graph)."""
    import torch

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
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device time of one call, the L2 warm: ``reps`` calls in a CUDA graph,
    replayed on the same inputs."""
    graph = _capture(lambda: [fn() for _ in range(reps)])
    return sum(_replay_ms(graph) for _ in range(replays)) / (replays * reps)


FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
_FLUSH = []


def cold_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call, the L2 cold: a CUDA graph of ``reps``
    (flush, call) pairs less a graph of ``reps`` flushes, the median of
    ``rounds`` replays each, in turns. A flush sums a 256 MB buffer, so a
    call reads its inputs from HBM, and the rows it wrote drain to HBM
    inside the next flush (the first graph's, not the second's)."""
    import statistics

    import torch

    if not _FLUSH:
        _FLUSH.append(torch.ones(FLUSH_BYTES // 4, device="cuda"))
    buf = _FLUSH[0]

    def flush():
        return buf.sum()
    both = _capture(lambda: [(flush(), fn()) for _ in range(reps)])
    alone = _capture(lambda: [flush() for _ in range(reps)])
    a, b = [], []
    for _ in range(rounds):
        a.append(_replay_ms(both))
        b.append(_replay_ms(alone))
    return (statistics.median(a) - statistics.median(b)) / reps


def paired_ms(*fns, windows: int = 5, reps: int = 40) -> list:
    """Wall ms of a call of each of ``fns``: the median of ``windows``
    windows of ``reps`` back-to-back calls, taken in turns."""
    runs = [[] for _ in fns]
    for _ in range(windows):
        for fn, r in zip(fns, runs):
            r.append(time_ms(fn, reps=reps))
    return [statistics.median(r) for r in runs]


def kernel_profile(fn, calls: int = 20) -> tuple:
    """(kernel ms, CUDA kernels) a call, from torch.profiler: the kernel rows
    (an operator's device time is its kernels'), the most of two windows (a
    window's trace may lose events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0.0, 0)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                us += t
                n += e.count
        best = max(best, (us, n), key=lambda b: b[1])
    return best[0] / 1e3 / calls, best[1] / calls


def graph_kernels(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches: the kernel nodes of a
    CUDA graph captured around it (``cuGraphGetNodes``)."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(keep_graph=True), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def bound(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def load(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import importlib

    base = "painlessinferenceacceleration_tpu_torch."
    names = dict(_build="_build", step="engine.step", kv_update="ops.kv_update",
                 rmsnorm="ops.rmsnorm", cache="engine.cache")
    pkg = {k: importlib.import_module(base + v) for k, v in names.items()}
    if not str(pkg["_build"].PKG_DIR).startswith(str(root.resolve())):
        raise SystemExit(f"imported the port from {pkg['_build'].PKG_DIR}, not {root}")
    return pkg


# (case, B, Q, rows of the batch on the one-branch path, edges of the others)
COMPACTIONS = (("main path B=1 Q=17 one branch", 1, 17, 1, 0),
               ("R=2 L=8 B=1 Q=17", 1, 17, 0, 8),
               ("generator Q=64", 1, 64, 0, 12),
               ("Q=128", 1, 128, 0, 120),
               ("serving B=8 Q=17", 8, 17, 4, 8))


def compaction_case(B, Q, n_identity, n_moves, rng):
    """numpy page tables [B, P], ctx, path [B, Q-1], n_edges for this case:
    the first n_identity rows accept 14 nodes of one branch (1, 2, ..., 14),
    the others n_moves nodes of a random increasing path."""
    import numpy as np

    P = (600 + Q) // PS + 2
    pt = (rng.permutation(B * P) + 1).reshape(B, P).astype(np.int32)
    ctx = rng.integers(540, 600, B).astype(np.int32)
    path = np.zeros((B, Q - 1), np.int32)
    ne = np.zeros(B, np.int32)
    for b in range(B):
        if b < n_identity:
            ne[b] = min(14, Q - 1)
            path[b, : ne[b]] = np.arange(1, ne[b] + 1)
        else:
            ne[b] = n_moves
            path[b, :n_moves] = np.sort(rng.choice(np.arange(1, Q), n_moves, replace=False))
    return pt, ctx, path, ne


def compaction_arenas(kind: str, n_pages: int, g) -> dict:
    """The arenas ``_commit_and_compact`` compacts, Llama-2-7B's geometry:
    bf16 K / V, e4m3 K / V (static scales: nothing else moves) or e4m3 K /
    V with 32 heads' f32 scale rows (fp8_tok)."""
    import torch

    shape = (L, n_pages, PS, HD)
    if kind == "bf16":
        return {n: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                for n in ("k", "v")}
    kv = {n: torch.randint(0, 256, shape, generator=g, device="cuda",
                           dtype=torch.uint8).view(torch.float8_e4m3fn) for n in ("k", "v")}
    if kind == "fp8_tok":
        kv.update({n: torch.rand(L, n_pages, PS, HD // 128, generator=g, device="cuda")
                   for n in ("k_tok_scale", "v_tok_scale")})
    return kv


def compaction_rows(pkg, g, kinds=("bf16",)) -> list:
    import numpy as np
    import torch

    step = pkg["step"]
    cfg = types.SimpleNamespace(linear_attention=False)
    rows = []
    rng = np.random.default_rng(SEED)
    cases = [(kind,) + c for c in COMPACTIONS for kind in kinds]
    tables = {c[0]: compaction_case(*c[1:], rng) for c in COMPACTIONS}
    for kind, case, B, Q, n_ident, n_moves in cases:
        pt, ctx, path, ne = tables[case]
        n_pages = int(pt.max()) + 1
        kv = compaction_arenas(kind, n_pages, g)
        dev = [torch.from_numpy(a).to("cuda") for a in (pt, ctx, path, ne)]
        active = torch.ones(B, dtype=torch.bool, device="cuda")

        def run():
            step._commit_and_compact(kv, cfg, dev[0], dev[1], active, None, None, None,
                                     dev[2], dev[3], Q)
        # the moved rows: those the first call changes (the rows are random)
        before = kv["k"].view(torch.uint8).clone()
        run()
        dst = (kv["k"].view(torch.uint8) != before).any(-1).any(0).reshape(-1).nonzero()
        dst = dst.flatten()
        del before
        kernel_ms, kernels = kernel_profile(run)
        n_moved = int(dst.numel())
        row_bytes = sum(a.shape[-1] * a.element_size() for a in kv.values())
        nbytes = 2 * L * n_moved * row_bytes + sum(a.nbytes for a in (pt, ctx, path, ne))
        lib_ms = None
        if n_moved:
            flat = {n: a.view(torch.uint8).view(L, n_pages * PS, -1) for n, a in kv.items()}
            src = {n: flat[n][:, dst].clone() for n in kv}
            ms, lib_ms = paired_ms(run, lambda: [flat[n].index_copy_(1, dst, src[n])
                                                 for n in kv])
        else:
            ms, = paired_ms(run)
        rows.append(dict(row="compaction", kind=kind, case=case, B=B, Q=Q, moved_rows=n_moved,
                         ms=ms, device_ms=cold_ms(run), device_warm_ms=graph_ms(run),
                         kernel_ms=kernel_ms, kernels_per_call=kernels,
                         graph_kernels=graph_kernels(run), bound_ms=bound(nbytes),
                         library_ms=lib_ms))
        print("row: " + json.dumps(rows[-1]), flush=True)
        del kv
        torch.cuda.empty_cache()
    return rows


def permute_rows(pkg, g) -> list:
    import torch

    ku = pkg["kv_update"]
    rows = []
    pages = torch.randn(L, 65, PS, HD, generator=g, device="cuda").to(torch.bfloat16)
    ids = (torch.randperm(64, generator=g, device="cuda")[:2] + 1).reshape(1, 2).int()
    W = 2 * PS
    for moves in (True, False):
        src = (torch.randperm(W, generator=g, device="cuda") if moves
               else torch.arange(W, device="cuda"))[None].int().contiguous()
        w = torch.arange(W, device="cuda")
        mv = src[0] != w
        dev = cold_ms(lambda: ku.kv_permute_pages(pages, ids, src))
        warm = graph_ms(lambda: ku.kv_permute_pages(pages, ids, src))
        flat = pages.view(L, -1, HD)
        row_of = ids.long()[0, w // PS] * PS + w % PS
        dst, srcs = row_of[mv], flat[:, row_of[src[0].long()][mv]].clone()
        ms, lib = paired_ms(lambda: ku.kv_permute_pages(pages, ids, src),
                            lambda: flat.index_copy_(1, dst, srcs))
        n = int(mv.sum())
        rows.append(dict(row="kv_permute_pages", case=f"L={L} TPP=2 moved_rows={n}", ms=ms,
                         device_ms=dev, device_warm_ms=warm, bound_ms=bound(2 * L * n * HD * 2 + W * 4 + 8),
                         library_ms=lib))
        print("row: " + json.dumps(rows[-1]), flush=True)
    return rows


def page_cases(ku, g) -> list:
    """K6 (``ku.kv_write_pages``) at PERF.md row 10's cases: (case, call,
    bound ms, yardstick: ``index_copy_`` of the windows' bytes)."""
    import torch

    out = []
    for B in (1, 8):
        W = 2 * B
        for dtype, row in ((torch.float8_e4m3fn, HD), (torch.float32, HD // 128)):
            n_pages = 2 * 8 * B + 1
            if dtype == torch.float32:
                pages = torch.randn(L, n_pages, PS, row, generator=g, device="cuda")
                windows = torch.randn(L, W, PS, row, generator=g, device="cuda")
            else:
                pages, windows = (torch.randint(0, 256, (L, n, PS, row), generator=g,
                                                device="cuda", dtype=torch.uint8).view(dtype)
                                  for n in (n_pages, W))
            ids = torch.randperm(n_pages - 1, generator=g, device="cuda")[:W] + 1
            ids[-1] = ids[0]
            ids = ids.to(torch.int32)
            raw, wraw = pages.view(torch.uint8), windows.view(torch.uint8)
            page_bytes = PS * row * pages.element_size()
            case = (f"L={L} W={W} row_bytes={row * pages.element_size()} "
                    f"{str(dtype).split('.')[-1]}")
            out.append((case, lambda p=pages, w=windows, i=ids: ku.kv_write_pages(p, w, i),
                        bound(2 * L * (W - 1) * page_bytes + W * 4),
                        lambda r=raw, i=ids, w=wraw: r.index_copy_(1, i.long(), w)))
    return out


def page_write_rows(pkg, g) -> list:
    """K6 at PERF.md row 10's cases (see the module's docstring), and one
    contiguous ``copy_`` of W = 16's kept bytes (15 pages of 32 layers), the
    card's practical rate for a copy of that size."""
    import torch

    rows = []
    for case, run, bnd, lib_fn in page_cases(pkg["kv_update"], g):
        ms, lib = paired_ms(run, lib_fn)
        rows.append(dict(row="kv_write_pages", case=case, ms=ms, device_ms=cold_ms(run),
                         device_warm_ms=graph_ms(run), bound_ms=bnd, library_ms=lib))
        print("row: " + json.dumps(rows[-1]), flush=True)
    n = L * 15 * PS * HD
    src, dst = (torch.empty(n, dtype=torch.uint8, device="cuda") for _ in range(2))
    rows.append(dict(row="copy_", case=f"{n} bytes", device_ms=cold_ms(lambda: dst.copy_(src)),
                     bound_ms=bound(2 * n)))
    print("row: " + json.dumps(rows[-1]), flush=True)
    return rows


def move_cases(ku, g, check: bool = False) -> list:
    """K17 (``ku.kv_move_rows``) at PERF.md row 12's cases: (case, call,
    bound ms, yardstick: ``index_put_`` of the gathered rows); with
    ``check``, (case, a call on a fresh copy, the plain version's result)."""
    import torch

    out = []
    for B, M in ((1, 12), (1, 63), (4, 63)):
        P = 17
        n_pages = 1 + B * P
        pages = torch.randn(L, n_pages, PS, HD, generator=g, device="cuda").to(torch.bfloat16)
        sp, sr, dp, dr = [], [], [], []
        for b in range(B):
            pt = torch.arange(1 + b * P, 1 + (b + 1) * P, device="cuda")
            ctx = int(torch.randint(0, (P - 2) * PS, (1,), generator=g, device="cuda"))
            path = torch.sort(torch.randperm(2 * M, generator=g, device="cuda")[:M] + 1)[0]
            src, dst = ctx + path, ctx + 1 + torch.arange(M, device="cuda")
            dpage = pt[dst // PS].clone()
            dpage[-1] = 0
            sp.append(pt[src // PS])
            sr.append(src % PS)
            dp.append(dpage)
            dr.append(dst % PS)
        idx = tuple(torch.cat(x).to(torch.int32) for x in (sp, sr, dp, dr))
        flat = pages.view(torch.uint8).view(L, n_pages * PS, -1)
        moved = flat[:, idx[0].long() * PS + idx[1].long()].clone()
        N = idx[0].shape[0]
        lidx = torch.arange(L, device="cuda")[:, None].expand(L, N)
        didx = (idx[2].long() * PS + idx[3].long())[None].expand(L, N)
        kept = int(torch.unique(didx[0]).numel())
        if check:
            want = ku.kv_move_rows_plain(pages.clone(), *idx)
            out.append((f"L={L} N={N} B={B}",
                        lambda p=pages, i=idx: ku.kv_move_rows(p.clone(), *i), want))
            continue
        out.append((f"L={L} N={N} row_bytes={HD * 2} B={B}",
                    lambda p=pages, i=idx: ku.kv_move_rows(p, *i),
                    bound(2 * L * kept * HD * 2 + N * 16),
                    lambda f=flat, li=lidx, di=didx, m=moved: f.index_put_((li, di), m)))
    return out


def move_rows(pkg, g) -> list:
    """K17 at PERF.md row 12's cases (see the module's docstring)."""
    rows = []
    for case, run, bnd, lib_fn in move_cases(pkg["kv_update"], g):
        ms, lib = paired_ms(run, lib_fn)
        rows.append(dict(row="kv_move_rows", case=case, ms=ms, device_ms=cold_ms(run),
                         device_warm_ms=graph_ms(run), bound_ms=bnd, library_ms=lib))
        print("row: " + json.dumps(rows[-1]), flush=True)
    return rows


# (kind, rows, width, groups, row stride)
NORMS = ([("plain", r, 2048, 1, None) for r in (1, 17, 4096)]
         + [("plain", 16 * r, 128, 1, None) for r in (1, 17, 4096)]
         + [("gated", r, 2048, 16, None) for r in (1, 17, 4096)]
         + [("plain", r, 4096, 1, None) for r in (1, 512, 2048)]
         + [("plain", r, 512, 1, 576) for r in (1, 4096)])


# write_kv_pages' cases: (arena kind, B, Q, holes in valid)
WRITES = tuple((kind, B, Q, B * Q > 1) for kind in ("bf16", "fp8", "fp8_tok", "mla")
               for B, Q in ((1, 1), (1, 17), (8, 512)))


def write_rows(pkg, g) -> list:
    """``write_kv_pages`` (engine/cache.py), as every layer of every forward
    calls it, at Llama-2-7B's rows (32 kv heads of 128 lanes) in the bf16,
    static e4m3 and per-token e4m3 arenas and at DeepSeek-V2-Lite's latent
    rows (576 + 512 lanes), at B = 1 Q = 1, B = 1 Q = 17 and an 8 x 512
    prefill chunk (every fifth token invalid where Q > 1); arenas of 4
    layers (a call writes one). Each row: wall (in turns with the
    yardstick), device ms with the L2 cold and warm, the CUDA kernels a
    call and their device ms (torch.profiler: this tree's step entry, or
    the eager route and the row scatter of a tree without it), the bound
    (the written tokens' K / V rows read once, their arena and scale rows
    written once) and ``index_put_`` of rows prepared beforehand, one call
    an arena."""
    import torch

    write_kv_pages = pkg["cache"].write_kv_pages
    rows = []
    for kind, B, Q, holes in WRITES:
        H, D, Dv = (1, 576, 512) if kind == "mla" else (32, 128, 128)
        P = (540 + Q) // PS + 2
        n_pages = B * P + 1
        fp8 = kind in ("fp8", "fp8_tok")
        dt = torch.float8_e4m3fn if fp8 else torch.bfloat16
        arenas = [torch.zeros(4, n_pages, PS, H * w, device="cuda").to(dt) for w in (D, Dv)]
        scales = [None, None]
        toks = [None, None]
        if kind == "fp8":
            scales = [torch.full((H,), 0.01, device="cuda") for _ in range(2)]
        if kind == "fp8_tok":
            toks = [torch.zeros(4, n_pages, PS, H, device="cuda") for _ in range(2)]
        nk = (torch.randn(B, Q, H, D, generator=g, device="cuda") * 3).to(torch.bfloat16)
        fused = torch.randn(B, Q, H * (D + Dv), generator=g, device="cuda").to(torch.bfloat16)
        nv = fused[..., H * D:].reshape(B, Q, H, Dv)
        pt = (torch.randperm(B * P, generator=g, device="cuda") + 1).reshape(B, P).int()
        start = torch.randint(0, 540, (B,), generator=g, device="cuda")
        valid = torch.ones(B, Q, dtype=torch.bool, device="cuda")
        if holes:
            valid[:, 2::5] = False

        def run():
            return write_kv_pages(*arenas, nk, nv, pt, start, valid, 1, *scales, *toks)
        kernel_ms, kernels = kernel_profile(run)
        # the yardstick: the same rows' bytes, prepared, scattered by index_put_
        slots = start[:, None] + torch.arange(Q, device="cuda")[None]
        pi = torch.gather(pt.long(), 1, (slots // PS).clamp(max=P - 1)).reshape(-1)
        ri = (slots % PS).reshape(-1)
        outs = [a for a in arenas] + [t for t in toks if t is not None]
        prep = [torch.randint(0, 256, (B * Q, a.shape[-1] * a.element_size()), generator=g,
                              device="cuda", dtype=torch.uint8) for a in outs]
        raws = [(a.view(torch.uint8)[1], r) for a, r in zip(outs, prep)]
        ms, lib_ms = paired_ms(run, lambda: [a.index_put_((pi, ri), r) for a, r in raws])
        n_w = int(valid.sum())
        out_row = sum(a.shape[-1] * a.element_size() for a in outs)
        nbytes = n_w * (H * (D + Dv) * 2 + out_row + 4) + B * 8 + B * Q
        rows.append(dict(row="write_kv_pages", case=f"{kind} B={B} Q={Q}", B=B, Q=Q,
                         written_rows=n_w, ms=ms, device_ms=cold_ms(run),
                         device_warm_ms=graph_ms(run), kernel_ms=kernel_ms,
                         kernels_per_call=kernels, bound_ms=bound(nbytes), library_ms=lib_ms))
        print("row: " + json.dumps(rows[-1]), flush=True)
        del arenas, toks, prep, raws
        torch.cuda.empty_cache()
    return rows


def norm_rows(pkg, g) -> list:
    import torch
    import torch.nn.functional as F

    rn = pkg["rmsnorm"]
    rows = []
    for kind, n, width, groups, stride in NORMS:
        x = (torch.randn(n, stride or width, generator=g, device="cuda") * 2)
        x = x.to(torch.bfloat16)[:, :width]
        w = (1 + 0.2 * torch.randn(width, generator=g, device="cuda")).to(torch.bfloat16)
        gate = torch.randn(n, width, generator=g, device="cuda").to(torch.bfloat16)
        if kind == "plain":
            def run():
                return rn.rms_norm(x, w, 1e-6)
            ms, lib = paired_ms(run, lambda: F.rms_norm(x, (width,), w, 1e-6))
        else:
            def run():
                return rn.rms_group_norm_sigmoid(x, gate, w, 1e-6, groups)
            (ms,), lib = paired_ms(run), None
        nbytes = (2 + (kind == "gated")) * n * width * 2 + width * 2
        t_ops = 4.0 * n * width / FP32_FLOPS * 1e3
        rows.append(dict(row=f"rms_norm[{kind}]", case=f"rows={n} width={width} "
                         f"groups={groups}" + (f" stride={stride}" if stride else ""),
                         ms=ms, device_ms=cold_ms(run), device_warm_ms=graph_ms(run),
                         bound_ms=max(bound(nbytes), t_ops), library_ms=lib))
        print("row: " + json.dumps(rows[-1]), flush=True)
    return rows


# K4's staging by 16-byte loads of every thread, in place of one
# cp.async.bulk copy a row completed on the mbarrier
LOADS16 = ((
    """      if (warp == 0) {
        piawg::fence_async_smem();
        if (lane == 0) piawg::mbar_expect(bar, static_cast<uint32_t>(total * 16));
        __syncwarp();
        for (int k = lane; k < n; k += 32)
          pia_bulk::load(piawg::smem_u32(stage + static_cast<size_t>(k) * st.cb),
                         layer + static_cast<size_t>(lst_src[k]) * row_bytes, nb, bar);
      }
      piawg::mbar_wait(bar, phase);
      phase ^= 1;
""",
    """      for (int e0 = tid; e0 < total; e0 += 4 * kThreads) {
        uint4 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + j * kThreads;
          if (e < total)
            r[j] = reinterpret_cast<const uint4*>(
                layer + static_cast<size_t>(lst_src[e / nv]) * row_bytes)[e % nv];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + j * kThreads;
          if (e < total) const_cast<uint4*>(stv)[(e / nv) * cv + e % nv] = r[j];
        }
      }
      __syncthreads();
"""),)


def variant_source(b, name: str, source: str, edits) -> tuple:
    """(csrc, build) directories of a copy of the tree's csrc/ with
    ``edits`` ((old, new), ...) applied to ``source``.cu."""
    import shutil

    root = b.PKG_DIR.parent / "build" / "row_kernel_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(b.PKG_DIR / "csrc", root / "csrc")
    path = root / "csrc" / f"{source}.cu"
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not once in {source}.cu")
        src = src.replace(old, new)
    path.write_text(src)
    return root / "csrc", root / "lib"


def use_source(b, source: str, csrc: Path, build: Path) -> None:
    """Point the build at ``source``.cu in ``csrc`` and build it alone."""
    b.CSRC_DIR, b.BUILD_DIR = csrc, build
    b._LIBS.pop(source, None)
    sources, b.SOURCES = b.SOURCES, (source,)
    try:
        b.library(source)
    finally:
        b.SOURCES = sources


def k4_source(b, name: str, edits) -> tuple:
    return variant_source(b, name, "kv_permute", edits)


def use_k4(b, csrc: Path, build: Path) -> None:
    use_source(b, "kv_permute", csrc, build)


def variant_rows(pkg, g) -> list:
    """K4's staging route (the tree's cp.async.bulk copies, or a copy of
    the source with 16-byte loads), budget (``STAGE_BYTES``) and block
    count (``GRID_BLOCKS``), device ms with the L2 cold, two turns."""
    import numpy as np
    import torch

    b, ku = pkg["_build"], pkg["kv_update"]
    routes = dict(bulk=(b.CSRC_DIR, b.BUILD_DIR),
                  loads16=k4_source(b, "loads16", LOADS16))
    rng = np.random.default_rng(SEED + 1)
    cases = []
    for case, B, Q, n_ident, n_moves in COMPACTIONS:
        pt, ctx, path, ne = compaction_case(B, Q, n_ident, n_moves, rng)
        n_pages = int(pt.max()) + 1
        arenas = tuple(torch.randn(L, n_pages, PS, HD, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(2))
        dev = [torch.from_numpy(a).to("cuda") for a in (pt, ctx, path, ne)]
        cases.append((case, lambda a=arenas, d=dev, q=Q: ku.kv_compact_tail(
            a, d[0], d[1], d[2], d[3], q)))
    pages = torch.randn(L, 65, PS, HD, generator=g, device="cuda").to(torch.bfloat16)
    ids = (torch.randperm(64, generator=g, device="cuda")[:2] + 1).reshape(1, 2).int()
    for moves in (True, False):
        src = (torch.randperm(2 * PS, generator=g, device="cuda") if moves
               else torch.arange(2 * PS, device="cuda"))[None].int().contiguous()
        cases.append((f"kv_permute_pages moves={moves}",
                      lambda s=src: ku.kv_permute_pages(pages, ids, s)))
    plans = [(sb, gb) for sb in (16384, 32768, 65536) for gb in (264, 528, 1056, 2112, 1 << 20)]
    kept = ku.STAGE_BYTES, ku.GRID_BLOCKS
    rows = []
    for turn in range(2):
        for route, dirs in routes.items():
            use_k4(b, *dirs)
            for sb, gb in plans:
                ku.STAGE_BYTES, ku.GRID_BLOCKS = sb, gb
                ku.permute_plan.cache_clear()
                ku._STATICS.clear()
                out = dict(row="variant", turn=turn, route=route, stage_bytes=sb,
                           grid_blocks=gb)
                for case, fn in cases:
                    out[case] = cold_ms(fn)
                rows.append(out)
                print("row: " + json.dumps(out), flush=True)
    ku.STAGE_BYTES, ku.GRID_BLOCKS = kept
    ku.permute_plan.cache_clear()
    ku._STATICS.clear()
    use_k4(b, *routes["bulk"])
    return rows


# K17 at 16-byte rows by the loop of 16-byte loads and stores (the route of
# 4- and 1-byte rows), an edit of csrc/kv_rows.cu, in place of the ring of
# bulk copies
K17_LOOP16 = (("    return launch_move(kv_move_rows_ring, ring_smem,",
               "    return launch_move(kv_move_rows_kernel<16>, ring_smem,"),)


def k17_variant_rows(pkg, g) -> list:
    """K17's route at 16-byte rows and plan (see ``--variants k17``), device
    ms with the L2 cold at the ``kv_move_rows`` cases, each plan first held
    against the plain version, two turns."""
    import torch

    b, ku = pkg["_build"], pkg["kv_update"]
    routes = dict(ring=(b.CSRC_DIR, b.BUILD_DIR),
                  loop16=variant_source(b, "k17_loop16", "kv_rows", K17_LOOP16))
    cases = [(c, fn) for c, fn, _, _ in move_cases(ku, g)]
    checks = move_cases(ku, g, check=True)
    plans = [(sb, mu, st) for sb in (16 * 1024, 32 * 1024, 64 * 1024) for mu in (264, 528, 1056)
             for st in (2, 3)]
    kept = ku.MOVE_STAGE_BYTES, ku.MOVE_MIN_UNITS, ku.MOVE_STAGES
    rows = []
    for turn in range(2):
        for route, dirs in routes.items():
            use_source(b, "kv_rows", *dirs)
            for sb, mu, st in plans:
                if route == "loop16" and st != 2:
                    continue  # the loop stages once
                ku.MOVE_STAGE_BYTES, ku.MOVE_MIN_UNITS, ku.MOVE_STAGES = sb, mu, st
                ku.move_plan.cache_clear()
                ku._STATICS.clear()
                for case, run, want in checks:
                    if not torch.equal(run(), want):
                        raise RuntimeError(f"k17 variant {route} {sb} {mu} {st}: {case} "
                                           "differs from the plain version")
                out = dict(row="k17 variant", turn=turn, route=route, stage_bytes=sb,
                           min_units=mu, stages=st)
                for case, fn in cases:
                    out[case] = cold_ms(fn)
                rows.append(out)
                print("row: " + json.dumps(out), flush=True)
    ku.MOVE_STAGE_BYTES, ku.MOVE_MIN_UNITS, ku.MOVE_STAGES = kept
    ku.move_plan.cache_clear()
    ku._STATICS.clear()
    use_source(b, "kv_rows", *routes["ring"])
    return rows


def k6_variant_rows(pkg, g) -> list:
    """K6's ring and blocks an SM (see ``--variants k6``), device ms with the
    L2 cold at the ``kv_write_pages`` cases, two turns."""
    b, ku = pkg["_build"], pkg["kv_update"]
    rings = {(16384, 4): (b.CSRC_DIR, b.BUILD_DIR)}
    for piece, stages in ((8192, 8), (16384, 3), (32768, 3)):
        rings[(piece, stages)] = variant_source(
            b, f"k6_p{piece}_s{stages}", "kv_page_write",
            (("constexpr int kPiece = 16384;", f"constexpr int kPiece = {piece};"),
             ("constexpr int kStages = 4;", f"constexpr int kStages = {stages};")))
    cases = [(c, fn) for c, fn, _, _ in page_cases(ku, g)]
    kept = ku.PAGE_PIECE, ku.PAGE_BLOCKS_PER_SM
    rows = []
    for turn in range(2):
        for (piece, stages), dirs in rings.items():
            use_source(b, "kv_page_write", *dirs)
            fits = 227 * 1024 // (piece * stages + 1024)
            for per_sm in sorted({1, 2, fits}):
                ku.PAGE_PIECE, ku.PAGE_BLOCKS_PER_SM = piece, per_sm
                ku._STATICS.clear()
                out = dict(row="k6 variant", turn=turn, piece=piece, stages=stages,
                           blocks_per_sm=per_sm)
                for case, fn in cases:
                    out[case] = cold_ms(fn)
                rows.append(out)
                print("row: " + json.dumps(out), flush=True)
    ku.PAGE_PIECE, ku.PAGE_BLOCKS_PER_SM = kept
    ku._STATICS.clear()
    use_source(b, "kv_page_write", *rings[(16384, 4)])
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="root of the tree whose port is measured")
    ap.add_argument("--json", type=Path, default=None, help="also write the numbers here")
    ap.add_argument("--variants", nargs="?", const="k4", choices=("k4", "k6", "k17"),
                    help="time K4's staging, K6's ring or K17's route and plan variants "
                         "(this tree's port only)")
    ap.add_argument("--rows", choices=("all", "write", "kv"), default="all",
                    help="write: the write_kv_pages rows only; kv: the compaction in "
                         "every arena kind, K6 and K17")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("row_kernel_variants: torch.cuda is not available")
    pkg = load(args.root)
    t0 = time.perf_counter()
    pkg["_build"].build_all()
    out = dict(root=str(args.root), card=smi_line(), build_s=time.perf_counter() - t0)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    if args.variants:
        out["rows"] = dict(k4=variant_rows, k6=k6_variant_rows,
                           k17=k17_variant_rows)[args.variants](pkg, g)
    elif args.rows == "write":
        out["rows"] = write_rows(pkg, g)
    elif args.rows == "kv":
        out["rows"] = (compaction_rows(pkg, g, ("bf16", "fp8", "fp8_tok"))
                       + page_write_rows(pkg, g) + move_rows(pkg, g))
    else:
        out["rows"] = (write_rows(pkg, g) + compaction_rows(pkg, g) + permute_rows(pkg, g)
                       + norm_rows(pkg, g))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(out["card"])


if __name__ == "__main__":
    main()
