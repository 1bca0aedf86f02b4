#!/usr/bin/env python3
"""Drive the PyTorch port (painlessinferenceacceleration_tpu_torch) on one GPU.

    python3 chip_smoke.py [--json PATH]

(``--moe-only``, ``--mla-only``, ``--linear-only``, ``--generator-only``,
``--w8a8-only``, ``--int8-only``, ``--attention-only``, ``--sampling-only``,
``--hf-only``, ``--families-only``, ``--ipad-only``, ``--dist-only`` and
``--moe-tp-only`` run parts of it:
partial runs that print no kernels line and no result line.)

Phases, one line each (any failure exits non-zero and prints no result):

1. environment: the card, CUDA, nvcc, triton, and the kernels' build time
   (the tensor-core sources' own); ptxas's registers and spills of the
   tensor-core kernels (int4 K1 / K11, int8 K7 / K12, W8A8 K8, block fp8
   K9, bf16 K10, paged attention K2 / K3 / K5 at each (K, V) head-dim pair
   with and without ALiBi, the e4m3 tied head K18) and
   their shared memory (a spill or a serialized wgmma fails the run), the
   slope-free attention kernels' registers beside their count before the
   ALiBi template flag;
2. every CUDA kernel and arena mode against its plain torch version at the
   7B shapes (bf16 and e4m3 arenas, static and per-token scales, the page
   write-back), with its time, the plain version's time, the bound the card
   could reach and a PyTorch library call as a yardstick: the int4 GEMM
   (every layer shape and the LM head at M = 1, 17, 64, 512 and 4096, with
   its device time), the three 8-bit GEMMs (int8 weight-only, W8A8 per
   channel with int8 and e4m3 operands and 128x128-block fp8, each at M =
   1, 17, 64, 512 and 4096 with its device time, on off-grid shapes, and
   its refusal of shapes off its grid), attention (every arena and route at the 7B shapes, and
   prefill at Mixtral-8x7B's and Ring-mini-linear-2.0's prefill shapes,
   with its device time; with ALiBi slopes at BLOOM-7b1's shape, each beside
   the same call without slopes), the KV kernels (the tail-window compaction, K4:
   its general entry with 127 rows moving and none, its compaction entry,
   K and V in one launch, at the main paths' compactions, Q = 17 one
   branch and R = 2, the generator's Q = 64 and MLA's latent rows, with
   the CUDA kernels a compaction launches; the page write-back; the row
   write K16: its step entry, one CUDA kernel a write_kv_pages call, in
   the bf16, static e4m3, per-token e4m3 and MLA arenas from decode to an
   8 x 512 prefill chunk with holes in the valid mask, byte for byte
   outside the null page, and its general entry at every row kind the
   arenas hold; and the row move K17 over chained compaction paths);
   then the batch invariance the
   lossless check rests on (every GEMM, the norm and attention rows
   bit-identical at every width, the GEMMs up to M = 4096, an int4, a
   W8A8 and a block-fp8 row alone equal to itself at every place of a
   4096-row call; every
   row of a causal prefill chunk equal to the decode of its token, in the
   three arenas; attention against its plain version at its tile edges);
3. the B = 1 main path at full width: Llama-2-7B, int4 group-128 weights
   (random, from a fixed torch.Generator seed), a bf16 paged arena (page 64,
   4096 tokens), a 512-token prefill, 128 greedy AR tokens, lookahead
   decode (branch 16, one branch, Q = 17) for ~256 tokens, and the strict
   lossless check: the lookahead stream must equal, token for token, the
   same program run from a fresh prefill with empty frozen tables;
   serving: the ``LLM`` engine on the same weights serves 16 requests
   (prompts of 64-384 tokens, half behind one shared 128-token prefix,
   48 new tokens each) with AR and with lookahead, over each KV arena
   (bf16, static fp8 after calibration, per-token fp8); every request's
   lookahead output must equal its AR output; then every kernel and arena
   mode against its plain version again, on the inputs of real serving
   calls kept during those runs (decode and verify at B = 8 with ragged
   contexts, batched prefill with prefix-resumed rows, K1 at M = 8 x 512,
   K4's compaction at B = 8 in the bf16, static e4m3 and per-token e4m3
   arenas on the same tables, one CUDA kernel a compaction, and the e4m3
   ones held against the JAX package's route, a window gather and K6's
   whole-page write-back, on copies; K16's step entry on the widest and
   narrowest writes of each arena kind, as on phase 3's writes);
   the host-trie generator: LookaheadGenerator on the same weights and
   prompt (native trie), hier lookahead at decoding length 63 (Q = 64) and
   the same call without lookahead over 256 tokens, equal to each other and
   over 128 tokens to phase 3's AR stream; stream_generate equal to
   generate, with K4's compaction entry held bit for bit against K17
   (move_kv_rows) and K4's general entry (kv_permute_pages) on clones of
   the arenas at every verify step, and K16's step entry against its
   general entry (kv_write_rows) at every layer-0 write; par and one modes
   equal to AR; batch_generate over 4 prompts, every row equal to its solo
   stream;
   sampling (ops/sample.py, on the same weights): 136 rows of the card's own
   LM-head logits (a verify step at B = 8, Q = 17) whose filtered logits and
   drawn tokens are the same bits alone, inside 17 rows and inside 136 at
   six (temperature, top_k, top_p, min_p) settings; the verify root's fp32
   logits row equal to the AR step's at 32 layers; sampled AR over 128
   tokens (temperature 0.8, top-k 50, top-p 0.95) and sampled lookahead (Q =
   17) from a fresh prefill with the tables seeded with that stream, equal
   token for token with drafts accepted; the 16 serving requests at 8
   layers (half sampled with their own seeds, two under a repetition
   penalty, two scoring 64 target tokens, arriving while others decode)
   under the pingpong, mix and timely policies, each with AR and with
   lookahead, every stream the same in all six runs and every score equal
   to a direct score_step call bit for bit; and the stdlib HTTP server on an
   ephemeral local port, four concurrent streaming clients (two greedy, two
   sampled) equal to llm.generate;
   quant modes: the same B = 1 path (512-token prefill, 32 greedy tokens,
   lookahead over 64 tokens with the strict lossless check) with the
   linears as int8, w8a8_int8, w8a8_fp8 and fp8_block at full depth, and as
   w8a8_int8_static, w8a8_fp8_static, fp8_tb and w8a8_fp8 with the fp8
   embedding at 8 layers; int8, w8a8_fp8 and fp8_block also serve the 16
   requests (bf16 arena, AR and lookahead, outputs must be identical), and
   the 8-bit GEMMs are held against their plain versions on inputs kept
   from those runs;
   Mixture-of-Experts: the grouped (per-expert) GEMMs for bf16, int4 and
   int8 experts and the dense bf16 GEMM against their plain versions at
   Mixtral-8x7B and Qwen3-30B-A3B expert shapes over seeded random routings
   (2 to 8192 routed rows, decode included, some pairs dropped; each
   kernel's grid bounded by the pair count), rows past ``n_used`` exactly
   zero, every routed row bit-equal to the dense kernel on its expert's
   weights and to itself at every batch width; Mixtral-8x7B at full width
   in bf16 (8 of 32 layers: 23.5 GB of weights) through a 2048-token
   prefill (grouped route), 32 AR and 64 lookahead tokens (scan route),
   strictly lossless, one layer's grouped output bit-equal to its scan
   output; the same model with int4 experts in 2 expert shards and with
   int8 experts (8 layers each); and the bf16 model (4 layers) serving the
   16 requests, lookahead equal to AR; the bf16 GEMM's (K10) launches by
   entry on one prefill, one decode and one verify step of Mixtral,
   DeepSeek-V2-Lite and Ring-mini-linear-2.0 in bf16;
   Multi-head Latent Attention: the MLA attention kernel and the
   head-batched absorption GEMM against their plain versions with their
   bit identities (an MLA row the same at every width and in every route,
   at the edges of its context chunks too), DeepSeek-V2-Lite bf16 at all 27 layers (4096-token
   prefill, AR and lookahead strictly lossless) and its 4 layers serving,
   K16 on both runs' latent writes;
   linear-attention hybrids: the linear-attention kernel (chunk, decode,
   tree and commit modes, with its CUDA kernels a call) and the RMSNorm
   kernel (hidden, per-head and gated group norms) against their plain
   versions at Ring-mini-linear-2.0 shapes, with the bit identities
   lookahead rests on (a verify row equals the AR row, a commit of n nodes
   equals n AR steps, norm rows at every batch width) and chunk rows' bits
   alone, in a batch, at a wider padded width and resumed at a tile edge;
   Ring-mini-linear-2.0 in bf16 at all 20 layers (~33 GB of
   random weights, experts in 2 expert shards): a 4096-token prefill, 32
   AR and 64 lookahead tokens strictly lossless and equal to AR, a
   teacher-forced lookahead / AR pair whose states and KV rows must be
   bit-equal, the host-trie generator's 64 lookahead tokens (trie trees
   through K14's tree mode) equal to AR, one MoE layer's scan and sharded
   times; its first 5 layers
   serving the 16 requests (lookahead equal to AR, no prefix hits, two
   requests equal served alone), and both kernels against their plain
   versions on serving's inputs;
   hf: two local checkpoints at published widths and 2 layers, written with
   the port's own safetensors writer in 2 shards and an index (random bf16
   weights from the seed, drawn on the card): Llama-2-7B's LlamaForCausalLM keys loaded
   as int4 and bigscience/bloom-7b1's BloomForCausalLM keys (ALiBi, the
   embedding LayerNorm, biases, the tied head) in bf16, each through
   LLM(model_path=...) and served with 16 text prompts cut from
   benchmarks/corpus.txt (the repository's BPE tokenizer), AR and
   lookahead, the outputs equal token for token; the reader's tensors and
   the loaded leaves byte-equal to the arrays written; every ALiBi launch of
   a BLOOM AR and lookahead pass held against its plain version; load time and
   GB/s, a 512-token prefill's ms and the (random-weight) rates;
   families: every family the loader maps, at published widths and 2
   layers, served by LLM(model_path=...) on 4 corpus prompts of 160+
   tokens, AR and lookahead equal token for token: EleutherAI/gpt-j-6b
   (head dim 256: K2 / K3 / K5 at (256, 256) over the bf16, static e4m3
   and per-token e4m3 arenas), deepseek-ai/DeepSeek-V2-Lite in expanded
   MLA mode ((192, 128)), THUDM/glm-10b at prefill_chunk 512 (K3's
   prefix-LM window), openai-community/gpt2-xl (the 50257-column tied head
   padded to 50264 rows) and bigscience/bloom-7b1 under quant_embed (the
   e4m3 tied head kernel); then those builds against their plain versions
   at the families' shapes (GPT-J 16 heads, V2-Lite 16 heads, GLM-10B's 64
   heads with a 300-key window, BLOOM's 250880 x 4096 head at M = 1 / 17 /
   512), timed beside SDPA and torch.matmul;
   ipad: prune and distill (``ipad.DistillPipe``: mlp 0.5, head 0.25, depth
   0.25, dim 0.25 and an ``upper`` finetune, 4 steps each) of an fp32
   student of Llama-2-7B's widths at 4 layers (random bf16 teacher, B x T =
   4 x 512 numpy tokens, fp32 products); the reparam'd model (3 layers, E
   3072, 24 heads, I 5504) equal to the masked student within 2e-4, the
   finetune's frozen leaves bit-unchanged, and the pruned model served by
   LLM in bf16 (K10) and int4 (K1) beside the unpruned 4 layers (16
   requests, lookahead equal to AR), its prefill logits against
   forward_logits on the same bf16 weights; train step, teacher forward,
   AdamW ms, tokens/s, peak memory, reparam s;
   dist: the parallel modules (``engine/dist_llm.py``, ``parallel/``,
   ``ops/cp_attention.py``): K2 / K3 and K13 with a page range and the
   rows' log-sum-exp against their plain twin at Llama-2-7B's and
   DeepSeek-V2-Lite's latent shapes (the full range equal to the call
   without one, timed beside it), K2 / K3 ranged at the expanded MLA's
   (192, 128) and, as ``cp_partial`` calls them, at G = 7 and heads of 80
   lanes (tree verifies of 17 and 129 rows, a causal 300); then two
   groups of child processes that share the card over gloo, started
   together. Two ranks serve Llama-2-7B int4 at full
   width and 32 layers under tensor parallelism (16 heads, I 5504 and
   16000 head columns a rank; 512-token prefill, 64 AR and 64 lookahead
   tokens, lookahead == AR, the first-step logits against the one-process
   run), under context parallelism (a 4096-token prompt whose pages
   straddle the ranks; lookahead == AR, the one-process oracle's tokens and
   arena bit for bit, the merged attention against one K2 / K3 call) and
   under data parallelism with a multimodal request (mesh (2, 1), the
   one-process LLM's tokens); a 2-layer Mixtral-8x7B stack under expert
   parallelism with int4 and with W8A8 e4m3 experts (the MoE block
   bit-equal to one process's ``expert_shards(2)``, lookahead == AR) and
   under tensor parallelism with W8A8 int8 experts (each rank's int8
   activations, taken from the serving path, one process's columns bit
   for bit; the first-step logits' gap to one process recorded);
   DeepSeek-V2-Lite (2 of 27 layers, latent MLA: K13 over each rank's
   pages) and Ring-mini-linear-2.0 (5 of 20 layers) under context
   parallelism with the same checks (a hybrid's states equal to the
   oracle's), the hybrid also under data parallelism (its states bit-equal
   on both ranks after every step, the one-process LLM's tokens); and TP
   served over ``DistLLM.launch`` (rank 0 binds the stdlib HTTP server on
   a local port and serves an async stream and one HTTP request while rank
   1 follows; their tokens equal ``DistLLM.generate``'s). Four ranks serve
   Llama-2-7B int4 (8 of 32 layers) at mesh (2, 2), context parallelism
   over the model axis beside the data axis (the oracle's tokens and pages
   bit for bit, lookahead == AR). Every rank on the same tokens, each
   rank's step ms and the collectives' share of it (gloo through the host,
   not NCCL); the depth cuts on a line of their own;
4. the launch count of every kernel and mode during phase 3, serving, the
   generator phase (and apart from it, its checks: K17 and K4's and K16's
   general entries have no caller on any path), the hf and families phases, the ipad phase, the quant
   modes, the MoE, MLA and linear-attention phases and phase dist (its
   ranks' DistLLM runs), each counted from 0 (all must be > 0), the script's wall time, and the
   ``kernels`` JSON line.

The last two lines are the card's name and power limit (as nvidia-smi gives
them) and ``{"ok": true, "device": {...}}``. ``--json PATH`` also writes
every number to PATH. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
INT8_FP8_OPS = 1979e12  # H100 SXM data sheet, dense int8 / fp8 tensor cores
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


def paired_ms(*fns, windows: int = 5, reps: int = 40) -> list:
    """Wall ms of a call of each of ``fns`` (CUDA events over ``reps``
    back-to-back calls), the median of ``windows`` windows taken in turns:
    a short kernel's wall is its wrapper's host time, which moves from
    window to window on a shared host."""
    import statistics

    runs = [[] for _ in fns]
    for _ in range(windows):
        for fn, r in zip(fns, runs):
            r.append(time_ms(fn, reps=reps))
    return [statistics.median(r) for r in runs]


def _capture(body):
    """A CUDA graph of ``body()``, run once outside it first."""
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


def _replay_ms(graph, replays: int = 1) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so that the wrapper's
    host time (which ``time_ms`` of back-to-back calls includes when a
    kernel is short) drops out. The calls read the same inputs: what fits
    the 50 MB L2 is read from it."""
    graph = _capture(lambda: [fn() for _ in range(reps)])
    ms = _replay_ms(graph, replays) / (replays * reps)
    del graph
    return ms


FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
_FLUSH = []


def cold_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call with the L2 cold: a CUDA graph of ``reps``
    (flush, call) pairs less a graph of ``reps`` flushes, the median of
    ``rounds`` replays each, in turns. A flush sums a 256 MB buffer, so
    each call reads its inputs from HBM, and the rows it wrote drain to
    HBM in the next flush (the first graph's, not the second's)."""
    import statistics

    import torch

    if not _FLUSH:
        _FLUSH.append(torch.ones(FLUSH_BYTES // 4, device="cuda"))
    buf = _FLUSH[0]
    both = _capture(lambda: [(buf.sum(), fn()) for _ in range(reps)])
    alone = _capture(lambda: [buf.sum() for _ in range(reps)])
    a, b = [], []
    for _ in range(rounds):
        a.append(_replay_ms(both))
        b.append(_replay_ms(alone))
    del both, alone
    return (statistics.median(a) - statistics.median(b)) / reps


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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
    b = pkg["_build"]
    tc_build = {n: round(b.BUILD_SECONDS[n], 3) for n in b.VERBOSE_SOURCES
                if n in b.BUILD_SECONDS}
    env = dict(card=smi_line(), torch=torch.__version__, cuda=torch.version.cuda,
               nvcc=ver, triton=has_triton, build_s=round(build_s, 3),
               tensor_core_build_s=tc_build)
    print("phase 1 environment: " + json.dumps(env))
    print("phase 1 ptxas (tensor-core kernels): " + json.dumps(ptxas_summary(pkg)))
    return env


def _ptxas_label(entry: str) -> str:
    """A tensor-core kernel's template arguments from its mangled name:
    int4 <group[, warpgroups]>, int8 <stage[, warpgroups]>, W8A8 <int8|e4m3,
    warpgroups>, block fp8 <warpgroups>, bf16 <warpgroups[, the weight's
    major]>; "seq" where a block runs every split."""
    import re

    t = re.search(r"((?:grouped_)?int[48]_gemm_kernel)ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?",
                  entry)
    if t:
        return (f"{t.group(1)}<{','.join(v for v in t.groups()[1:3] if v)}>"
                + (" seq" if t.group(4) == "1" else ""))
    t = re.search(r"(bf16_gemm_kernel)ILi(\d)ELb([01])ELb([01])E", entry)
    if t:
        return (f"{t.group(1)}<{t.group(2)},{'K' if t.group(3) == '1' else 'N'}-major>"
                + (" seq" if t.group(4) == "1" else ""))
    t = re.search(r"(bf16_gemm_batched_kernel)ILi(\d)ELb([01])E", entry)
    if t:
        return f"{t.group(1)}<{t.group(2)}>" + (" seq" if t.group(3) == "1" else "")
    t = re.search(r"(grouped_gemm_kernel)ILb([01])E", entry)
    if t:
        return f"{t.group(1)}<2>" + (" seq" if t.group(2) == "1" else "")
    t = re.search(r"(paged_attention_wgmma_kernel)ILi(\d+)ELi(\d+)ELi(\d)E(?:Lb([01])E)?"
                  r"(?:Lb([01])E)?", entry)
    if t:
        return (f"{t.group(1)}<D={t.group(2)}x{t.group(3)},"
                f"{('bf16', 'fp8', 'fp8_tok')[int(t.group(4))]}"
                + (",alibi" if t.group(5) == "1" else "")
                + (",range>" if t.group(6) == "1" else ">"))
    t = re.search(r"(fp8_head_kernel)ILi(\d)E", entry)
    if t:
        return f"{t.group(1)}<{t.group(2)}>"
    t = re.search(r"(mla_attention_kernel|mla_combine_kernel)", entry)
    if t:
        return t.group(1)
    t = re.search(r"(la_\w+?_kernel)(?:ILi(\d+)E)?", entry)
    if t:  # K14's chunk passes carry their head dim
        return t.group(1) + (f"<D={t.group(2)}>" if t.group(2) else "")
    t = re.search(r"(rms_norm_kernel|kv_permute_kernel)I(\w+?)EEvN", entry)
    if t:  # the template arguments as mangled
        return f"{t.group(1)}<{t.group(2)}>"
    t = re.search(r"(block_fp8_gemm_kernel)ILi(\d)ELb([01])E", entry)
    if t:
        return f"{t.group(1)}<{t.group(2)}>" + (" seq" if t.group(3) == "1" else "")
    t = re.search(r"(w8a8_gemm_kernel)ILb([01])ELi(\d)ELb([01])E", entry)
    if t:
        return (f"{t.group(1)}<{'e4m3' if t.group(2) == '1' else 'int8'},{t.group(3)}>"
                + (" seq" if t.group(4) == "1" else ""))
    return entry[-48:]


def ptxas_summary(pkg) -> dict:
    """Registers, spills and the ptxas notes of the tensor-core kernels
    (int4 K1 / K11, int8 K7 / K12, W8A8 K8, block fp8 K9, bf16 K10, paged attention K2 /
    K3 / K5, MLA attention K13, linear attention K14; built with -Xptxas -v), and each
    configuration's dynamic shared
    memory. Fails the run on a spill, on a wgmma that ptxas serialized, and
    where a source's report is missing or names none of its kernels with
    their registers."""
    import re

    b = pkg["_build"]
    out = {}
    for name in b.VERBOSE_SOURCES:
        kernels, cur, notes = [], None, []
        for line in b.ptxas_report(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = dict(kernel=_ptxas_label(m.group(1)))
                kernels.append(cur)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
            if "Performance Loss" in line or "injected" in line:
                notes.append(line.split("ptxas info    : ")[-1][:120])
        out[name] = dict(kernels=[k for k in kernels if "reduce" not in k["kernel"]],
                         notes=notes)
        entry = {"paged_attention": "attention_wgmma_kernel",
                 "mla_attention": "mla_attention_kernel", "rmsnorm": "rms_norm_kernel",
                 "kv_permute": "kv_permute_kernel",
                 "linear_attention": "la_chunk_out_kernel",
                 "paged_attention_wide": "attention_wgmma_kernel",
                 "fp8_head_gemm": "fp8_head_kernel"}.get(name, "gemm_kernel")
        main = [k for k in kernels if entry in k["kernel"]]
        if not main or any("registers" not in k for k in main):
            fail(f"{name}: no ptxas report of its kernels and their registers: {kernels}")
        if any(k.get("spill_stores", 0) or k.get("spill_loads", 0) for k in kernels):
            fail(f"{name}: ptxas reports spills: {kernels}")
        if any("serialized" in n for n in notes):
            fail(f"{name}: ptxas serialized the wgmma instructions: {notes}")
    lib = b.library("int4_gemm")
    out["smem_bytes"] = {f"int4 group={g} warpgroups={w}": lib.int4_gemm_smem_bytes(g, w)
                         for g in (32, 64, 128) for w in (1, 2)}
    lib = b.library("int8_gemm")
    out["smem_bytes"].update({f"int8 stage={c} warpgroups={w}": lib.int8_gemm_smem_bytes(c, w)
                              for c in (128, 64, 32) for w in (1, 2)})
    lib = b.library("w8a8_gemm")
    out["smem_bytes"].update({f"w8a8 warpgroups={w}": lib.w8a8_gemm_smem_bytes(w)
                              for w in (1, 2)})
    lib = b.library("block_fp8_gemm")
    out["smem_bytes"].update({f"block fp8 warpgroups={w}": lib.block_fp8_gemm_smem_bytes(w)
                              for w in (1, 2)})
    lib = b.library("grouped_gemm")
    out["smem_bytes"].update({f"bf16 warpgroups={w}": lib.bf16_gemm_smem_bytes(w)
                              for w in (1, 2)})
    out["smem_bytes"].update({f"attention D={dk}x{dv} {a}":
                              b.library(lib).paged_attention_smem_bytes(dk, dv, m)
                              for (dk, dv), lib in pkg["paged_attention"].LIBRARY.items()
                              for m, a in enumerate(("bf16", "fp8", "fp8_tok"))})
    lib = b.library("fp8_head_gemm")
    out["smem_bytes"].update({f"e4m3 head warpgroups={w}": lib.fp8_head_gemm_smem_bytes(w)
                              for w in (1, 2)})
    out["smem_bytes"]["mla attention"] = b.library("mla_attention").mla_attention_smem_bytes()
    # the slope-free attention kernels beside their registers as built
    # before the ALiBi template flag existed: unchanged means the flag costs
    # the other models nothing
    pa = pkg["paged_attention"]
    now = pa.ptxas_registers()
    out["attention_slope_free_registers"] = {
        f"D={dk}x{dv},{a}": dict(now=now.get((dk, dv, a, False), {}).get("registers"),
                                 before=r)
        for (dk, dv, a), r in pa.SLOPE_FREE_REGISTERS.items()}
    out["attention_slope_free_unchanged"] = all(
        now.get((dk, dv, a, False), {}).get("registers") == r
        for (dk, dv, a), r in pa.SLOPE_FREE_REGISTERS.items())
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

QMM = "painlessinferenceacceleration_tpu/ops/quant_matmul.py"
W8A8 = "painlessinferenceacceleration_tpu/ops/w8a8.py"
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


def gemm_row(pkg, x, q, s, out_dtype, case):
    """K1 on these inputs against int4_matmul_plain, timed."""
    import torch

    qm = pkg["quant_matmul"]
    (M, K), N = x.shape, q.shape[1]
    got = qm.int4_matmul(x, q, s, out_dtype)
    ref = qm.int4_matmul_plain(x, q, s, out_dtype)
    err, rel = _errs(got, ref)
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-4
    if not rel <= tol:
        fail(f"int4_gemm {case}: rel err {rel} > {tol}")
    w = pkg["linear"].dequantize({"q": q, "s": s}, pkg["linear"].QuantSpec(bits=4),
                                 torch.bfloat16)
    ms = time_ms(lambda: qm.int4_matmul(x, q, s, out_dtype), reps=10 if M >= 4096 else 20)
    dev_ms = graph_ms(lambda: qm.int4_matmul(x, q, s, out_dtype), reps=5 if M >= 4096 else 10)
    plain_ms = time_ms(lambda: qm.int4_matmul_plain(x, q, s, out_dtype),
                       reps=2 if M >= 4096 else 5, warmup=1)
    lib_ms = time_ms(lambda: torch.matmul(x, w), reps=10 if M >= 4096 else 20)
    osz = 2 if out_dtype == torch.bfloat16 else 4
    nbytes = M * K * 2 + K * N // 2 + s.numel() * 2 + M * N * osz
    replaces = (f"{QMM}:142 _qmm4_kernel_v3" if out_dtype == torch.float32
                else f"{QMM}:147 _qmm4_stacked_kernel_v3")
    row = _case("int4_gemm", "int4_gemm.cu", replaces, err, rel, ms, plain_ms,
                bound_ms(nbytes, 2.0 * M * K * N), lib_ms,
                f"{case}M={M} K={K} N={N} out={str(out_dtype).split('.')[-1]}")
    row["device_ms"] = dev_ms  # the kernels alone (a CUDA graph): ms is the wrapper's rate
    return row


def check_int4_gemm(pkg, g, M, K, N, out_dtype, group=128):
    import torch

    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (K // 2, N), generator=g, device="cuda", dtype=torch.uint8)
    s = (torch.rand(K // group, N, generator=g, device="cuda") * 0.004 + 0.001).to(torch.bfloat16)
    return gemm_row(pkg, x, q, s, out_dtype, "" if group == 128 else f"group={group} ")


# the 8-bit GEMMs: row name -> (source, Pallas body it replaces for a stacked
# layer weight, and for an unstacked weight such as the LM head)
GEMM8 = {
    "int8_gemm": ("int8_gemm.cu", f"{QMM}:184 _qmm8_stacked_kernel", f"{QMM}:81 _qmm_kernel"),
    "w8a8_gemm[int8]": ("w8a8_gemm.cu", f"{W8A8}:189 _w8a8_stacked_kernel",
                        f"{W8A8}:170 _w8a8_kernel"),
    "w8a8_gemm[fp8]": ("w8a8_gemm.cu", f"{W8A8}:189 _w8a8_stacked_kernel",
                       f"{W8A8}:170 _w8a8_kernel"),
    "block_fp8_gemm": ("block_fp8_gemm.cu", f"{W8A8}:224 _block_fp8_stacked_kernel",
                       f"{W8A8}:206 _block_fp8_kernel"),
}
# quant mode -> the 8-bit GEMM row its linears launch
MODE_KERNEL = {"int8": "int8_gemm", "w8a8_int8": "w8a8_gemm[int8]",
               "w8a8_int8_static": "w8a8_gemm[int8]", "w8a8_fp8": "w8a8_gemm[fp8]",
               "w8a8_fp8_static": "w8a8_gemm[fp8]", "fp8_block": "block_fp8_gemm",
               "fp8_tb": "block_fp8_gemm"}


def library_ms(fn):
    """Time of a PyTorch library call kept as a yardstick only; None where
    the installed torch does not take this call at this shape."""
    try:
        fn()
    except (RuntimeError, AttributeError, TypeError):
        return None
    return time_ms(fn)


def gemm8_row(pkg, name, args, out_dtype, case, unstacked=False):
    """One 8-bit GEMM (``name`` of GEMM8) on these operands against its plain
    version, timed. ``args`` is (x, q, s) for the weight-only int8 kernel
    and (xq, xs, q, s) for the activation-quantized ones. Tolerance: the
    int8 W8A8 kernel sums in s32 and must equal its plain version bit for
    bit; the others sum fp32 in another order (2e-2 of the largest value in
    bf16, 1e-4 in fp32). The tensor-core kernels' rows (K7, K8) also carry
    ``device_ms`` (a CUDA graph of the calls: the kernels without the
    wrapper's host time)."""
    import torch

    qm, w8 = pkg["quant_matmul"], pkg["w8a8"]
    fn, plain = {"int8_gemm": (qm.int8_matmul, qm.int8_matmul_plain),
                 "block_fp8_gemm": (w8.block_fp8_gemm, w8.block_fp8_gemm_plain)
                 }.get(name, (w8.w8a8_gemm, w8.w8a8_gemm_plain))
    x, q = args[0], args[-2]
    (M, K), N = x.shape, q.shape[1]
    got, ref = fn(*args, out_dtype), plain(*args, out_dtype)
    err, rel = _errs(got, ref)
    if name == "w8a8_gemm[int8]":
        if not torch.equal(got, ref):
            fail(f"{name} {case}M={M} K={K} N={N}: differs from the exact integer product")
    elif not rel <= (2e-2 if out_dtype == torch.bfloat16 else 1e-4):
        fail(f"{name} {case}M={M} K={K} N={N}: rel err {rel}")
    big = M >= 4096
    ms = time_ms(lambda: fn(*args, out_dtype), reps=10 if big else 20)
    dev_ms = graph_ms(lambda: fn(*args, out_dtype), reps=5 if big else 10)
    plain_ms = time_ms(lambda: plain(*args, out_dtype), reps=2 if big else 5,
                       warmup=1 if big else 3)
    if name == "int8_gemm":
        w = pkg["linear"].dequantize({"q": q, "s": args[2]}, pkg["linear"].QuantSpec(bits=8),
                                     torch.bfloat16)
        lib_ms = library_ms(lambda: torch.matmul(x, w))
        del w
    elif name == "w8a8_gemm[int8]":
        lib_ms = library_ms(lambda: torch._int_mm(x, q))
    elif name == "w8a8_gemm[fp8]":
        qt = q.t().contiguous().t()  # _scaled_mm takes the weight column-major
        xs2, s2 = args[1][:, None].contiguous(), args[3][None, :].contiguous()
        lib_ms = library_ms(lambda: torch._scaled_mm(x, qt, scale_a=xs2, scale_b=s2,
                                                     out_dtype=torch.bfloat16))
        del qt
    else:
        lib_ms = None
    nbytes = sum(t.numel() * t.element_size() for t in args) + M * N * got.element_size()
    peak = BF16_FLOPS if name == "int8_gemm" else INT8_FP8_OPS
    source, stacked_body, plain_body = GEMM8[name]
    row = _case(name, source, plain_body if unstacked else stacked_body, err, rel, ms,
                plain_ms, bound_ms(nbytes, 2.0 * M * K * N, peak), lib_ms,
                f"{case}M={M} K={K} N={N} out={str(out_dtype).split('.')[-1]}")
    row["device_ms"] = dev_ms
    return row


def gemm8_operands(pkg, g, name, M, K, N, group=128):
    """Random operands of one 8-bit GEMM: unit-normal bf16 activations
    (quantized by quant_act for the W8A8 kinds), weights as
    init_params_quantized draws them, scales around 0.02 / qmax."""
    import torch

    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    if name == "int8_gemm":
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        s = (torch.rand(K // group, N, generator=g, device="cuda") * 2e-4 + 5e-5)
        return x, q, s.to(torch.bfloat16)
    mode = {"w8a8_gemm[int8]": "w8a8_int8", "w8a8_gemm[fp8]": "w8a8_fp8",
            "block_fp8_gemm": "fp8_block"}[name]
    spec = pkg["linear"].QuantSpec.from_mode(mode)
    xq, xs = pkg["w8a8"].quant_act(x, spec)
    if spec.wfmt == "fp8":
        q = torch.randn(K, N, generator=g, device="cuda").to(torch.float8_e4m3fn)
    else:
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    shape = (-(-K // 128), -(-N // 128)) if spec.block else (N,)
    s = torch.rand(shape, generator=g, device="cuda") * 1e-4 + 2e-5
    return xq, xs, q, s


def check_gemm8(pkg, g, name, M, K, N, out_dtype, case="", group=128, unstacked=False):
    args = gemm8_operands(pkg, g, name, M, K, N, group)
    return gemm8_row(pkg, name, args, out_dtype, case, unstacked)


def quant_act_costs(pkg) -> dict:
    """What the activation quantization (plain torch, outside the kernels)
    costs before one GEMM: CUDA kernels launched and ms per call under CUDA
    events over back-to-back calls, per quant mode, at the decode and the
    verify height."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode in ("w8a8_int8", "w8a8_int8_static", "w8a8_fp8", "fp8_block", "fp8_tb"):
        spec = pkg["linear"].QuantSpec.from_mode(mode)
        xs_static = torch.ones((), device="cuda") if spec.act == "static" else None
        for M in (1, 17):
            x = torch.randn(M, 4096, device="cuda").to(torch.bfloat16)

            def run():
                return pkg["w8a8"].quant_act(x, spec, xs_static)
            ms = time_ms(run, reps=50)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if (getattr(e, "self_device_time_total", 0) or 0) > 0)
            out[f"{mode} M={M}"] = dict(ms=ms, kernels=kernels / 10)
    return out


def quantize_e4m3(x, Hkv: int, per_token: bool):
    """x [n_pages, ps, Hkv*D] quantized as the arena's writes do: scale =
    amax/448 per kv head over the whole arena (static), or per (token, kv
    head); clip to +-448, then cast. The dequantized rows keep x's spread,
    so the softmax over them is not flat."""
    import torch

    xh = x.reshape(*x.shape[:2], Hkv, -1)
    amax = xh.abs().amax(-1) if per_token else xh.abs().amax(dim=(0, 1, 3))
    s = (amax / 448.0).clamp(min=1e-8).contiguous()
    q = (xh / (s[..., None] if per_token else s[:, None])).clamp(-448.0, 448.0)
    return q.to(torch.float8_e4m3fn).reshape(x.shape), s


def _arena(g, B, ctx_max, Q, Hkv, D, ps, arena="bf16", Dv=None):
    """Unit-normal K/V pages for B requests (permuted page tables) of the
    arena kind: bf16, or e4m3 with static [Hkv] or per-token
    [n_pages, ps, Hkv] scales; V rows of ``Dv`` lanes a head (default D)."""
    import torch

    P = -(-(ctx_max + Q) // ps) + 1
    n_pages = B * P + 1
    k = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda")
    v = torch.randn(n_pages, ps, Hkv * (Dv or D), generator=g, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")[: B * P] + 1
    pt = perm.reshape(B, P).to(torch.int32)
    if arena == "bf16":
        return k.to(torch.bfloat16), v.to(torch.bfloat16), pt, None, None
    (k8, ks), (v8, vs) = (quantize_e4m3(t, Hkv, arena == "fp8_tok") for t in (k, v))
    return k8, v8, pt, ks, vs


def _attn_name(kind: str, arena: str, alibi: bool = False) -> str:
    if alibi:  # ALiBi rows: the bf16 arena, as BLOOM serves
        return ("paged_attention_prefill[alibi]" if kind == "prefill"
                else f"paged_attention[{kind},alibi]")
    if arena == "fp8_tok":
        return f"paged_attention_tok[{kind}]"
    fp8 = arena == "fp8"
    if kind == "prefill":
        return "paged_attention_prefill" + ("[fp8]" if fp8 else "")
    return f"paged_attention[{kind}" + (",fp8]" if fp8 else "]")


PAIR_DIMS = ("256x256", "192x128")  # the (K, V) head dims past 128 lanes
NARROW_DIMS = ("80x80", "96x96")  # heads of 80 / 96 lanes, in the 128-lane build
NEW_GROUPS = (5, 6, 7)  # query heads a kv head that do not divide 128


def _pair_name(kind: str, arena: str, dims: str) -> str:
    """The kernels-line name of a head-dim pair's row: the 128-lane row's
    name with the pair inside its brackets."""
    base = _attn_name(kind, arena)
    return base[:-1] + f",{dims}]" if base.endswith("]") else base + f"[{dims}]"


def _attn_replaces(kind: str, arena: str) -> str:
    if arena == "fp8_tok":
        return f"{PAT}:380 _attn_decode_tok_kernel"
    return {"decode": f"{PAT}:236 _attn_decode_kernel",
            "verify": f"{PAT}:54 _attn_verify_kernel",
            "prefill": f"{PAT}:851 _attn_prefill_kernel"}[kind]


def attention_row(pkg, kind, arena, q, k, v, pt, ctx_t, qmask, ks, vs, scale, case,
                  alibi=None, alibi_pos=None, window=None, name=None):
    """One attention call (kind: 'decode' / 'verify' under the mask rule,
    'prefill' causal; arena: 'bf16', 'fp8' static scales, 'fp8_tok'
    per-token scales; ``alibi`` [Hq] slopes or None, ``alibi_pos`` the
    step's key positions or None for their slots; ``window`` [B] int32 a
    prefill's prefix-LM window or None) against paged_attention_ref on the
    same inputs, timed; V's head dim is the V arena's (K's where they
    agree). ``name``: the kernels-line name (default ``_attn_name``)."""
    import torch
    import torch.nn.functional as F

    pa, ref_mod = pkg["paged_attention"], pkg["attention"]
    B, Q, Hq, D = q.shape
    ps, Hkv = k.shape[1], k.shape[2] // D
    Dv = v.shape[2] // Hkv
    scales = None if arena == "bf16" else (ks, vs)
    if kind == "prefill":
        qmask = pa.window_qmask(B, Q, ctx_t, window, "cuda")
    if arena == "fp8_tok":
        mask_arg = None if kind == "prefill" else qmask

        def run():
            return pa.paged_attention_tok(q, k, v, ks, vs, pt, ctx_t, scale, mask_arg, alibi,
                                          alibi_pos, window)
    elif kind == "prefill":
        def run():
            return pa.paged_attention_prefill(q, k, v, pt, ctx_t, scale, scales, alibi,
                                              window=window)
    else:
        def run():
            return pa.paged_attention(q, k, v, pt, ctx_t, qmask, scale, scales, alibi,
                                      alibi_pos)

    def plain():
        return ref_mod.paged_attention_ref(q, k, v, pt, ctx_t, qmask, scale, ks, vs,
                                           alibi=alibi, alibi_pos=alibi_pos)
    got = run()
    err, rel = _errs(got, plain())
    if not rel <= 2e-2:
        fail(f"paged attention {kind} {arena} {case}: rel err {rel}")
    big = Q >= 2048
    ms = time_ms(run, reps=5 if big else 20)
    dev_ms = graph_ms(run, reps=5 if big else 10)
    plain_ms = time_ms(plain, reps=2 if big else 5, warmup=1)
    # yardstick: SDPA over the K/V gathered and dequantized (outside the
    # timing) with the same mask
    G = Hq // Hkv
    cache = pkg["cache"]
    gk = cache.gather_kv_pages(k, pt, D, ks, torch.bfloat16).repeat_interleave(G, dim=1)
    gv = cache.gather_kv_pages(v, pt, Dv, vs, torch.bfloat16).repeat_interleave(G, dim=1)
    mask = ref_mod.attention_mask(ctx_t, qmask, gk.shape[2])[:, None]
    qt = q.transpose(1, 2)
    lib_mask = mask
    if alibi is not None:  # the same function: the slopes as an additive float mask
        j = torch.arange(gk.shape[2], device="cuda")[None]
        if alibi_pos is not None:
            j = ref_mod.alibi_key_positions(ctx_t, alibi_pos, gk.shape[2])
        bias = alibi[None, :, None, None] * j.to(torch.float32)[:, None, None, :]
        lib_mask = torch.where(mask, bias.to(torch.bfloat16),
                               float("-inf")).to(torch.bfloat16)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, gk, gv, attn_mask=lib_mask,
                                                            scale=scale), reps=5 if big else 20)
    vis = int(mask[:, 0].sum().item()) * Hq  # visible (row, key) pairs
    # keys each request reads: its context and the step's own Q rows
    kv_rows = int((ctx_t.long() + Q).clamp(max=pt.shape[1] * ps).sum().item())
    kv_elem = 2 if arena == "bf16" else 1
    nbytes = kv_rows * Hkv * (D + Dv) * kv_elem + q.numel() * 2 + B * Q * Hq * Dv * 2
    if arena == "fp8":
        nbytes += 2 * Hkv * 4
    elif arena == "fp8_tok":
        nbytes += 2 * kv_rows * Hkv * 4
    if alibi is not None:
        nbytes += Hq * 4 + (0 if alibi_pos is None else alibi_pos.numel() * 4)
    row = _case(name or _attn_name(kind, arena, alibi is not None), "paged_attention.cu",
                _attn_replaces(kind, arena), err, rel, ms, plain_ms,
                bound_ms(nbytes, 2.0 * vis * (D + Dv)), lib_ms,
                f"{case}B={B} Q={Q} Hq={Hq} Hkv={Hkv} ps={ps} arena={arena}"
                + (f" D={D}x{Dv}" if (D, Dv) != (128, 128) else "")
                + (" alibi" if alibi is not None else "")
                + (f" window={window.tolist()}" if window is not None else ""))
    row["device_ms"] = dev_ms  # the kernel alone (a CUDA graph)
    return row


def check_attention(pkg, g, kind, B, Q, Hq, Hkv, ctx, qmask, arena="bf16", D=128,
                    Dv=None, window=None, name=None, case=""):
    import torch

    ps = 64
    k, v, pt, ks, vs = _arena(g, B, ctx, Q, Hkv, D, ps, arena, Dv)
    ctx_t = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(B, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    win = None if window is None else torch.full((B,), window, dtype=torch.int32,
                                                 device="cuda")
    return attention_row(pkg, kind, arena, q, k, v, pt, ctx_t, qmask, ks, vs,
                         D ** -0.5, f"{case}ctx={ctx} ", window=win, name=name)


def attention_rows(pkg, g, cfg) -> list:
    """Paged attention against its plain version at the 7B shapes (decode,
    verify and prefill in each arena), with one GQA geometry, and at the
    prefill shapes of Mixtral-8x7B (Q = 2048, 32 heads over 8) and
    Ring-mini-linear-2.0 (Q = 4096, 16 heads over 4)."""
    import torch

    dt = pkg["device_tables"]
    branches = torch.randint(3, cfg.vocab_size, (2, 8), generator=g, device="cuda")
    _, _, tree, _ = dt.build_tree_inputs(torch.tensor(1, device="cuda"), branches)
    tree = tree[None]  # [1, 17, 17], R=2 L=8 tree mask
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    H = cfg.num_attention_heads
    rows = []
    for Hkv in (H, 8):  # the model's MHA, and one GQA geometry
        rows.append(check_attention(pkg, g, "decode", 1, 1, H, Hkv, 640, one))
        rows.append(check_attention(pkg, g, "verify", 1, 17, H, Hkv, 768, tree))
    for ctx in (0, 512):
        rows.append(check_attention(pkg, g, "prefill", 1, 512, H, H, ctx, None))
    # the e4m3 arenas at the model's shapes (static scales, per-token scales)
    for arena in ("fp8", "fp8_tok"):
        rows.append(check_attention(pkg, g, "decode", 1, 1, H, H, 640, one, arena))
        rows.append(check_attention(pkg, g, "verify", 1, 17, H, H, 768, tree, arena))
        for ctx in (0, 512):
            rows.append(check_attention(pkg, g, "prefill", 1, 512, H, H, ctx, None, arena))
    rows.append(check_attention(pkg, g, "prefill", 1, 2048, 32, 8, 0, None))  # Mixtral
    rows.append(check_attention(pkg, g, "prefill", 1, 4096, 16, 4, 0, None))  # Ring
    torch.cuda.empty_cache()
    return rows


def alibi_attention_rows(pkg, g) -> list:
    """Paged attention with ALiBi slopes against its plain version at
    BLOOM-7b1's attention shape (32 heads of 128, bf16 arena): decode at ctx
    640, a Q = 17 tree verify at ctx 768 (its nodes at ctx + their depth)
    and a 512-token prefill at ctx 0, each with the same call's time without
    slopes beside it (``slope_free_ms``, ``slope_free_device_ms``)."""
    import torch

    dt = pkg["device_tables"]
    branches = torch.randint(3, 32000, (2, 8), generator=g, device="cuda")
    _, _, tree, depth = dt.build_tree_inputs(torch.tensor(1, device="cuda"), branches)
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    H, D = 32, 128
    al = pkg["attention"].alibi_slopes(H, "cuda")
    rows = []
    for kind, Q, ctx, qmask in (("decode", 1, 640, one), ("verify", 17, 768, tree[None]),
                                ("prefill", 512, 0, None)):
        pos = None  # prefill: the causal rule puts key s at ctx + s
        if kind != "prefill":
            pos = (ctx + (depth if kind == "verify" else torch.zeros(1, device="cuda")))
            pos = pos.to(torch.int32)[None].contiguous()
        k, v, pt, ks, vs = _arena(g, 1, ctx, Q, H, D, 64)
        ctx_t = torch.full((1,), ctx, dtype=torch.int32, device="cuda")
        q = torch.randn(1, Q, H, D, generator=g, device="cuda").to(torch.bfloat16)
        free = attention_row(pkg, kind, "bf16", q, k, v, pt, ctx_t, qmask, ks, vs,
                             D ** -0.5, f"BLOOM-7b1 ctx={ctx} ")
        row = attention_row(pkg, kind, "bf16", q, k, v, pt, ctx_t, qmask, ks, vs,
                            D ** -0.5, f"BLOOM-7b1 ctx={ctx} ", alibi=al, alibi_pos=pos)
        row.update(slope_free_ms=free["ms"], slope_free_device_ms=free["device_ms"])
        rows.append(row)
    return rows


def _attend(pkg, arena, k, v, pt, ks, vs):
    """attend(q, qmask or None for the causal rule, ctx) by the wrapper
    that serves the arena, and plain(q, qmask, ctx)."""
    pa, paged_attention_ref = pkg["paged_attention"], pkg["attention"].paged_attention_ref
    scales = None if arena == "bf16" else (ks, vs)

    def attend(q, qm, ctx):
        D = q.shape[-1]
        if arena == "fp8_tok":
            return pa.paged_attention_tok(q, k, v, ks, vs, pt, ctx, D ** -0.5, qm)
        if qm is None:
            return pa.paged_attention_prefill(q, k, v, pt, ctx, D ** -0.5, scales)
        return pa.paged_attention(q, k, v, pt, ctx, qm, D ** -0.5, scales)

    def plain(q, qm, ctx):
        return paged_attention_ref(q, k, v, pt, ctx, qm, q.shape[-1] ** -0.5, ks, vs)
    return attend, plain


def check_attention_routes(pkg, g) -> None:
    """A token's attention is the same in every route: every row t of a
    causal prefill chunk (Q = 129 and 512, over 0 and 333 cached keys)
    equals, bit for bit, a Q = 1 decode of that token over ctx + t keys, in
    the three arenas at G = 1 and 4 (8 kv heads), and over 333 keys at G = 7
    (126 rows a tile) and at heads of 80 lanes. Fails the run otherwise."""
    import torch

    Hkv = 8
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    n = 0
    for arena in ("bf16", "fp8", "fp8_tok"):
        for G, D, ctxs in ((1, 128, (0, 333)), (4, 128, (0, 333)), (7, 128, (333,)),
                           (1, 80, (333,))):
            for Q in (129, 512):
                for ctx in ctxs:
                    k, v, pt, ks, vs = _arena(g, 1, ctx, Q, Hkv, D, 64, arena)
                    attend, _ = _attend(pkg, arena, k, v, pt, ks, vs)
                    q = torch.randn(1, Q, G * Hkv, D, generator=g,
                                    device="cuda").to(torch.bfloat16)
                    ctx_t = torch.tensor([ctx], dtype=torch.int32, device="cuda")
                    pre = attend(q, None, ctx_t)
                    for t in range(Q):
                        row = attend(q[:, t:t + 1].contiguous(), one, ctx_t + t)
                        if not torch.equal(row[:, 0], pre[:, t]):
                            fail(f"paged attention ({arena}, G={G}, D={D}): row {t} of a "
                                 f"causal prefill (Q={Q}, ctx={ctx}) differs from its decode")
                        n += 1
    print(f"phase 2 attention routes: {n} prefill rows (three arenas, G = 1 and 4 at D = "
          "128, Q = 129 / 512, ctx 0 / 333; G = 7 at D = 128 and G = 1 at D = 80, ctx 333) "
          "bit-identical to their Q = 1 decodes")


def check_attention_tile_edges(pkg, g) -> None:
    """The kernel against its plain version (rel <= 2e-2) where Q * G sits at
    a tile edge (63, 64, 65: one warpgroup's rows and a second all padding;
    127, 128, 129: one tile full or a second tile), at contexts off the page
    grid (70 and 333 in one batch), by the mask rule and the causal rule, in
    the three arenas; at G = 7 the edges of its 126-row tile (Q = 9 / 10: 63 /
    70 rows; 18 / 19: 126 / 133; 36 / 37), and at heads of 80 lanes; the
    mask rule past 128 rows too (Q = 129 and 200 at G = 1, 19 and 37 at
    G = 7). Fails the run otherwise."""
    import torch

    Hkv = 4
    n = 0
    for arena in ("bf16", "fp8", "fp8_tok"):
        for Q, G, D in ((63, 1, 128), (64, 1, 128), (65, 1, 128), (127, 1, 128),
                        (128, 1, 128), (129, 1, 128), (200, 1, 128), (16, 4, 128),
                        (17, 4, 128), (32, 4, 128), (33, 4, 128), (16, 8, 128), (17, 8, 128),
                        (9, 7, 128), (10, 7, 128), (18, 7, 128), (19, 7, 128), (36, 7, 128),
                        (37, 7, 128), (64, 1, 80), (129, 1, 80), (17, 4, 80)):
            k, v, pt, ks, vs = _arena(g, 2, 333, Q, Hkv, D, 64, arena)
            attend, plain = _attend(pkg, arena, k, v, pt, ks, vs)
            ctx = torch.tensor([70, 333], dtype=torch.int32, device="cuda")
            q = torch.randn(2, Q, G * Hkv, D, generator=g, device="cuda").to(torch.bfloat16)
            qm = torch.rand(2, Q, Q, generator=g, device="cuda") < 0.5
            masks = [None, qm | torch.eye(Q, dtype=torch.bool, device="cuda")]
            for qm in masks:
                ref_qm = qm if qm is not None else \
                    pkg["attention"].causal_qmask(Q, "cuda")[None].expand(2, Q, Q)
                _, rel = _errs(attend(q, qm, ctx), plain(q, ref_qm, ctx))
                if not rel <= 2e-2:
                    fail(f"paged attention ({arena}) at Q={Q} G={G} D={D} "
                         f"({'causal' if qm is None else 'mask'}): rel err {rel}")
                n += 1
    print(f"phase 2 attention tile edges: {n} cases within rel 2e-2 of the plain version")


def kv_permute_row(pkg, pages, ids, src, case):
    """K4 on these pages and index tables against its plain version (bit
    for bit), timed; the device time with the L2 cold (``cold_ms``) beside
    it."""
    import torch

    ku = pkg["kv_update"]
    L, _, ps, HD = pages.shape
    B, TPP = ids.shape
    W = TPP * ps
    got = ku.kv_permute_pages(pages.clone(), ids, src)
    ref = ku.kv_permute_pages_plain(pages.clone(), ids, src)
    if not torch.equal(got, ref):
        fail(f"kv_permute_pages differs from its plain version ({case})")
    err, rel = _errs(got, ref)
    work = pages.clone()
    plain_ms = time_ms(lambda: ku.kv_permute_pages_plain(work, ids, src), reps=5)
    # yardstick: one index_copy_ of the moving rows, gathered beforehand
    flat = work.view(L, -1, HD)
    w = torch.arange(W, device="cuda")
    row_of = ids.long()[:, w // ps] * ps + w % ps  # [B, W] arena row of each slot
    mv = src != w[None]
    dst = row_of[mv]
    srcs = flat[:, row_of.gather(1, src.long())[mv]]
    ms, lib_ms = paired_ms(lambda: ku.kv_permute_pages(work, ids, src),
                           lambda: flat.index_copy_(1, dst, srcs))
    moved = int(mv.sum().item())
    # each moved row: its source read once, its destination written once
    nbytes = L * 2 * moved * HD * pages.element_size() + (ids.numel() + src.numel()) * 4
    row = _case("kv_permute_pages", "kv_permute.cu", f"{KVU}:144 _permute_kernel",
                err, rel, ms, plain_ms, bound_ms(nbytes, 0.0), lib_ms,
                f"{case}L={L} B={B} TPP={TPP} ps={ps} HD={HD} moved_rows={moved}")
    row["device_ms"] = cold_ms(lambda: ku.kv_permute_pages(work, ids, src))
    return row


def check_kv_permute(pkg, g, L, n_pages, ps, HD, B, TPP, moves: bool):
    import torch

    W = TPP * ps
    pages = torch.randn(L, n_pages, ps, HD, generator=g, device="cuda").to(torch.bfloat16)
    ids = (torch.randperm(n_pages - 1, generator=g, device="cuda")[: B * TPP] + 1)
    ids = ids.reshape(B, TPP).to(torch.int32)
    if moves:
        src = torch.stack([torch.randperm(W, generator=g, device="cuda") for _ in range(B)])
    else:
        src = torch.arange(W, device="cuda")[None].expand(B, W)
    return kv_permute_row(pkg, pages, ids, src.to(torch.int32).contiguous(), "")


def graph_kernels(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches: the kernel nodes of a
    CUDA graph captured around it, counted through the driver
    (``cuGraphGetNodes``; a profiler trace deep into a run has been seen to
    lose events)."""
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
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def kv_compact_row(pkg, arenas, pt, ctx, path, ne, Q, active, case):
    """K4's compaction entry (K and V in one launch) on these arenas and
    the verify step's tensors against its plain version (the composed
    route: tail_window and kv_permute_pages_plain), byte for byte over the
    whole arenas, page 0 included; timed: wall (``paired_ms``, in turns with
    the yardstick), device ms with the L2 cold (``cold_ms``), the CUDA kernels
    a compaction launches (``graph_kernels``), the bound of the rows it moves
    (``compaction_moves``: each read once and written once, in every arena
    and layer, plus the indices) and, as the yardstick, index_copy_ of the
    moving rows gathered beforehand, one call an arena."""
    import torch

    ku = pkg["kv_update"]
    arenas = tuple(arenas)
    got = ku.kv_compact_tail(tuple(a.clone() for a in arenas), pt, ctx, path, ne, Q, active)
    ref = ku.kv_compact_tail_plain(tuple(a.clone() for a in arenas), pt, ctx, path, ne, Q,
                                   active)
    err = 0.0
    for a, b in zip(got, ref):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            fail(f"kv_compact_tail differs from its plain version ({case})")
        err = max(err, _errs(a.view(torch.uint8), b.view(torch.uint8))[0])
    del got, ref
    work = tuple(a.clone() for a in arenas)

    def run():
        return ku.kv_compact_tail(work, pt, ctx, path, ne, Q, active)
    plain_ms = time_ms(lambda: ku.kv_compact_tail_plain(work, pt, ctx, path, ne, Q, active),
                       reps=5)
    kernels = graph_kernels(run)
    L, _, ps = arenas[0].shape[:3]
    moves = [m for r in ku.compaction_moves(pt.cpu(), ctx.cpu(), path.cpu(), ne.cpu(), Q, ps,
                                            None if active is None else active.cpu())
             for m in r]
    rbs = [a.shape[-1] * a.element_size() for a in arenas]
    nbytes = 2 * L * len(moves) * sum(rbs) + sum(t.numel() * t.element_size()
                                                 for t in (pt, ctx, path, ne))
    lib_ms = None
    if moves:
        dst = torch.tensor([d for _, d in moves], device="cuda")
        flat = [w.view(torch.uint8).view(L, -1, rb) for w, rb in zip(work, rbs)]
        srcs = [f[:, [s_ for s_, _ in moves]].clone() for f in flat]
        ms, lib_ms = paired_ms(run, lambda: [f.index_copy_(1, dst, s_)
                                             for f, s_ in zip(flat, srcs)])
        del srcs
    else:
        ms, = paired_ms(run)
    B = path.shape[0]
    row = _case("kv_compact_tail", "kv_permute.cu", f"{KVU}:144 _permute_kernel", err, err,
                ms, plain_ms, bound_ms(nbytes, 0.0), lib_ms,
                f"{case}L={L} B={B} Q={Q} row_bytes={'+'.join(map(str, rbs))} "
                f"{str(arenas[0].dtype).split('.')[-1]} moved_rows={len(moves)}")
    row.update(device_ms=cold_ms(run), kernels_per_call=kernels)
    del work
    return row


# K4's compaction cases: (case, B, Q, rows of the batch on a one-branch path,
# accepted edges of the others)
COMPACTIONS = (("main path one branch ", 1, 17, 1, 0), ("R=2 L=8 ", 1, 17, 0, 8),
               ("generator Q=64 ", 1, 64, 0, 12), ("generator Q=64 all moving ", 1, 64, 0, 62))


def kv_arenas(g, kind, shape, heads):
    """Random arenas of ``kind`` for K4 on [L, n_pages, ps, lanes]: bf16 K
    and V; e4m3 K and V (random bytes); or those and fp8_tok's f32 scale
    arenas of ``heads`` heads."""
    import torch

    if kind == "bf16":
        return [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2)]
    arenas = [torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
              .view(torch.float8_e4m3fn) for _ in range(2)]
    if kind == "fp8_tok":
        arenas += [torch.rand(shape[:3] + (heads,), generator=g, device="cuda")
                   for _ in range(2)]
    return arenas


def check_kv_compact(pkg, g, L, lanes, B, Q, n_identity, n_moves, case, kind="bf16",
                     heads=0):
    """K4's compaction entry on arenas of ``kind`` (``kv_arenas``; K and V
    rows of these lanes) and a verify step's tensors: B requests with
    contexts of 540-599 tokens (their windows across a page edge), the first
    n_identity accepting 14 nodes of one branch (the identity), the others
    n_moves nodes of a random increasing path. The e4m3 kinds are also held
    against the JAX package's route (``compaction_vs_jax``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + Q + n_moves)
    P = (600 + Q) // 64 + 2
    pt = (rng.permutation(B * P) + 1).reshape(B, P).astype(np.int32)
    ctx = rng.integers(540, 600, B).astype(np.int32)
    path = np.zeros((B, Q - 1), np.int32)
    ne = np.zeros(B, np.int32)
    for b in range(B):
        ne[b] = min(14, Q - 1) if b < n_identity else n_moves
        path[b, : ne[b]] = (np.arange(1, ne[b] + 1) if b < n_identity else
                            np.sort(rng.choice(np.arange(1, Q), n_moves, replace=False)))
    if kind == "bf16":
        arenas = [torch.randn(L, B * P + 1, 64, w, generator=g, device="cuda")
                  .to(torch.bfloat16) for w in lanes]
    else:
        arenas = kv_arenas(g, kind, (L, B * P + 1, 64, lanes[0]), heads)
    dev = [torch.from_numpy(a).to("cuda") for a in (pt, ctx, path, ne)]
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    row = kv_compact_row(pkg, arenas, *dev, Q, active, case)
    if kind != "bf16":
        compaction_vs_jax(pkg, arenas, (*dev, active, Q))
    del arenas
    return row


def kv_write_row(pkg, pages, windows, ids, case):
    """K6 on these pages, windows and page ids against its plain version
    (bit for bit), timed: wall (``paired_ms``, in turns with the
    yardstick, index_copy_ of the windows' bytes), device ms with the L2
    cold (``cold_ms``)."""
    import torch

    ku = pkg["kv_update"]
    L, _, ps = pages.shape[:3]
    W = windows.shape[1]
    got = ku.kv_write_pages(pages.clone(), windows, ids)
    ref = ku.kv_write_pages_plain(pages.clone(), windows, ids)
    if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
        fail(f"kv_write_pages ({pages.dtype}, {case}) differs from its plain version")
    err, rel = _errs(got.view(torch.uint8), ref.view(torch.uint8))
    del got, ref
    work = pages.clone()

    def run():
        return ku.kv_write_pages(work, windows, ids)
    plain_ms = time_ms(lambda: ku.kv_write_pages_plain(work, windows, ids), reps=5)
    raw, wraw = work.view(torch.uint8), windows.view(torch.uint8)
    ms, lib_ms = paired_ms(run, lambda: raw.index_copy_(1, ids.long(), wraw))
    row_bytes = pages[0, 0, 0].numel() * pages.element_size()
    n_unique = int(torch.unique(ids).numel())
    nbytes = 2 * L * n_unique * ps * row_bytes + W * ids.element_size()
    row = _case("kv_write_pages", "kv_page_write.cu", f"{KVU}:261 _page_write_kernel",
                err, rel, ms, plain_ms, bound_ms(nbytes, 0.0), lib_ms,
                f"{case}L={L} W={W} ps={ps} row_bytes={row_bytes} "
                f"{str(pages.dtype).split('.')[-1]} aliased={W - n_unique}")
    row["device_ms"] = cold_ms(run)
    del work
    return row


def check_kv_write_pages(pkg, g, L, n_pages, ps, HD, B, TPP, dtype):
    """K6 over W = B*TPP window pages (the compaction's write-back), one
    destination named twice (the page-table clip)."""
    import torch

    W = B * TPP
    pages = torch.randn(L, n_pages, ps, HD, generator=g, device="cuda").to(dtype)
    windows = torch.randn(L, W, ps, HD, generator=g, device="cuda").to(dtype)
    ids = torch.randperm(n_pages - 1, generator=g, device="cuda")[:W] + 1
    ids[-1] = ids[0]  # aliased: the later window page must win
    return kv_write_row(pkg, pages, windows, ids.to(torch.int32), f"B={B} ")


def _random_like(shape, dtype, g):
    """Random bytes of ``shape`` and ``dtype`` (row kernels copy bytes)."""
    import torch

    n = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (*shape[:-1], shape[-1] * n), generator=g, device="cuda",
                        dtype=torch.uint8)
    return raw.view(dtype)


def _n_kept(pages_idx, rows_idx, ps):
    """Destinations written: distinct (page, row) pairs."""
    import torch

    return int(torch.unique(pages_idx.long() * ps + rows_idx.long()).numel())


def kv_rows_write_row(pkg, pages, rows, pi, ri, layer, case):
    """K16 on these arenas, rows and indices against its plain version (byte
    for byte), timed. The bound: each written row read once and written
    once, plus the two int32 indices a row; the yardstick is index_put_ of
    the same rows, one call per arena."""
    import torch

    ku = pkg["kv_update"]
    pages, rows = tuple(pages), tuple(rows)
    got = ku.kv_write_rows(tuple(p.clone() for p in pages), rows, pi, ri, layer)
    ref = ku.kv_write_rows_plain(tuple(p.clone() for p in pages), rows, pi, ri, layer)
    for a, b in zip(got, ref):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            fail(f"kv_write_rows differs from its plain version ({case})")
    err = max(_errs(a.view(torch.uint8), b.view(torch.uint8))[0] for a, b in zip(got, ref))
    del got, ref
    work = tuple(p.clone() for p in pages)
    ms = time_ms(lambda: ku.kv_write_rows(work, rows, pi, ri, layer))
    plain_ms = time_ms(lambda: ku.kv_write_rows_plain(work, rows, pi, ri, layer), reps=5)
    raws = [(w.view(torch.uint8)[layer], r.view(torch.uint8)) for w, r in zip(work, rows)]
    idx = (pi.long(), ri.long())
    lib_ms = time_ms(lambda: [a.index_put_(idx, r) for a, r in raws])
    N, ps = pi.shape[0], pages[0].shape[2]
    row_bytes = sum(r.shape[1] * r.element_size() for r in rows)
    nbytes = 2 * _n_kept(pi, ri, ps) * row_bytes + N * 8
    kinds = "+".join(f"{str(r.dtype).split('.')[-1]}x{r.shape[1]}" for r in rows)
    del work
    return _case("kv_write_rows", "kv_rows.cu", f"{KVU}:27 _write_kernel", err, err, ms,
                 plain_ms, bound_ms(nbytes, 0.0), lib_ms,
                 f"{case}N={N} rows {kinds} L={pages[0].shape[0]} "
                 f"null_page_rows={int((pi == 0).sum())}")


def check_kv_write_rows(pkg, g, L, widths, dtypes, N, n_pages, ps=64, layer=1):
    """K16 over arenas of these row widths and types, N rows (every fourth
    aimed at the null page 0, as padded tokens are)."""
    import torch

    pages = [_random_like((L, n_pages, ps, w), dt, g) for w, dt in zip(widths, dtypes)]
    rows = [_random_like((N, w), dt, g) for w, dt in zip(widths, dtypes)]
    slot = torch.randperm((n_pages - 1) * ps, generator=g, device="cuda")[:N]
    pi, ri = (slot // ps + 1).to(torch.int32), (slot % ps).to(torch.int32)
    pi[::4] = 0
    return kv_rows_write_row(pkg, pages, rows, pi, ri, layer, "")


def kv_step_row(pkg, arenas, nk, nv, pt, start, valid, layer, ks, vs, case):
    """K16's step entry (``kv_write_step``: K, V and the fp8_tok scale rows
    in one launch, from the step's own tensors) on these arenas against its
    plain version (``kv_write_step_plain``: the eager route, ``kv_step_rows``
    then ``kv_write_rows_plain``), byte for byte outside the null page 0
    (where only the plain version writes the invalid tokens); it must be
    one CUDA kernel a call (``graph_kernels``). Timed: wall (``paired_ms``, in
    turns with the yardstick), device ms with the L2 cold (``cold_ms``),
    the plain version; the bound: the written tokens' input rows read once,
    their arena rows (and scale rows) written once, the indices and scales;
    the yardstick: index_put_ of the rows the eager route prepares, one call
    an arena."""
    import torch

    ku = pkg["kv_update"]
    arenas = tuple(arenas)
    got = ku.kv_write_step(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid,
                           layer, ks, vs)
    ref = ku.kv_write_step_plain(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid,
                                 layer, ks, vs)
    err = 0.0
    for a, b in zip(got, ref):
        ga, gb = a[:, 1:].view(torch.uint8), b[:, 1:].view(torch.uint8)
        if not torch.equal(ga, gb):
            fail(f"kv_write_step differs from its plain version outside page 0 ({case}: "
                 f"{int((ga != gb).sum())} bytes of a {a.dtype} arena)")
        err = max(err, _errs(ga, gb)[0])
    del got, ref
    work = tuple(a.clone() for a in arenas)

    def run():
        return ku.kv_write_step(work, nk, nv, pt, start, valid, layer, ks, vs)
    plain_ms = time_ms(lambda: ku.kv_write_step_plain(work, nk, nv, pt, start, valid, layer,
                                                      ks, vs), reps=5)
    kernels = graph_kernels(run)
    if kernels > 1:
        fail(f"kv_write_step launched {kernels} CUDA kernels a call ({case})")
    rows, fp, fr = ku.kv_step_rows(arenas, nk, nv, pt, start, valid, ks, vs)
    raws = [(w.view(torch.uint8)[layer], r.view(torch.uint8)) for w, r in zip(work, rows)]
    ms, lib_ms = paired_ms(run, lambda: [a.index_put_((fp, fr), r) for a, r in raws])
    B, Q, H, D = nk.shape
    Dv = nv.shape[-1]
    ps = arenas[0].shape[2]
    n_w = len(ku.step_writes(pt.cpu(), start.cpu(), None if valid is None else valid.cpu(),
                             Q, ps))
    out_row = sum(a.shape[-1] * a.element_size() for a in arenas)
    nbytes = (n_w * (H * (D + Dv) * nk.element_size() + out_row + pt.element_size())
              + start.numel() * start.element_size() + (0 if valid is None else B * Q)
              + sum(0 if t is None else t.numel() * 4 for t in (ks, vs)))
    mode = ku.STEP_MODES[ku.step_static(arenas, nk, nv, pt, start, valid, ks, vs)[0].mode]
    row = _case("kv_write_step", "kv_rows.cu", f"{KVU}:27 _write_kernel", err, err, ms,
                plain_ms, bound_ms(nbytes, 0.0), lib_ms,
                f"{case}{mode} B={B} Q={Q} H={H} D={D}+{Dv} "
                f"{str(nk.dtype).split('.')[-1]} in, written_rows={n_w} of {B * Q}, "
                f"L={arenas[0].shape[0]}")
    row.update(device_ms=cold_ms(run), kernels_per_call=kernels)
    del work
    return row


# K16's step-entry cases: (B, Q, holes in valid)
STEP_SHAPES = ((1, 1, False), (1, 17, True), (1, 64, True), (8, 17, True), (8, 512, True))


def step_operands(g, kind, B, Q, holes, L=4, ps=64):
    """Arenas of ``kind`` (bf16, fp8: static e4m3, fp8_tok, mla: latent
    576 + 512 lanes) at Llama-2-7B's / DeepSeek-V2-Lite's row widths (L
    layers: the rows do not depend on depth), and a step's tensors as the
    models pass them: K a contiguous [B, Q, H, D], V a view into a fused
    projection output; contexts of 0-539 tokens, every fifth token invalid
    where ``holes``."""
    import torch

    H, D, Dv = (1, 576, 512) if kind == "mla" else (32, 128, 128)
    P = (540 + Q) // ps + 2
    n_pages = B * P + 1
    dt = torch.float8_e4m3fn if kind in ("fp8", "fp8_tok") else torch.bfloat16
    arenas = tuple(_random_like((L, n_pages, ps, H * w), dt, g) for w in (D, Dv))
    if kind == "fp8_tok":
        arenas += tuple(torch.rand(L, n_pages, ps, H, generator=g, device="cuda")
                        for _ in range(2))
    nk = (torch.randn(B, Q, H, D, generator=g, device="cuda") * 3).to(torch.bfloat16)
    fused = (torch.randn(B, Q, H * (D + Dv), generator=g, device="cuda") * 3).to(torch.bfloat16)
    nv = fused[..., H * D:].reshape(B, Q, H, Dv)
    pt = (torch.randperm(B * P, generator=g, device="cuda") + 1).reshape(B, P).to(torch.int32)
    start = torch.randint(0, 540, (B,), generator=g, device="cuda")
    valid = torch.ones(B, Q, dtype=torch.bool, device="cuda")
    if holes:
        valid[:, 2::5] = False
    ks = vs = None
    if kind == "fp8":
        ks, vs = (torch.rand(H, generator=g, device="cuda") * 0.01 + 0.002 for _ in range(2))
    return arenas, nk, nv, pt, start, valid, ks, vs


def step_rows(pkg, g) -> list:
    """K16's step entry in every arena kind at decode (B = 1 Q = 1), a
    verify (Q = 17), the generator's Q = 64, a B = 8 verify and an 8 x 512
    prefill chunk, with holes in ``valid``."""
    import torch

    rows = []
    for kind in ("bf16", "fp8", "fp8_tok", "mla"):
        for B, Q, holes in STEP_SHAPES:
            ops = step_operands(g, kind, B, Q, holes)
            rows.append(kv_step_row(pkg, ops[0], *ops[1:6], 1, *ops[6:], ""))
            del ops
        torch.cuda.empty_cache()
    return rows


def kv_move_row(pkg, pages, sp, sr, dp, dr, case):
    """K17 on these pages and moves against its plain version (byte for
    byte), timed: wall (``paired_ms``, in turns with the yardstick), device
    ms with the L2 cold (``cold_ms``). The bound: each kept move's row read
    once and written once over all layers, plus the four int32 indices a
    move; the yardstick is index_put_ of the rows gathered beforehand."""
    import torch

    ku = pkg["kv_update"]
    got = ku.kv_move_rows(pages.clone(), sp, sr, dp, dr)
    ref = ku.kv_move_rows_plain(pages.clone(), sp, sr, dp, dr)
    if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
        fail(f"kv_move_rows differs from its plain version ({case})")
    err = _errs(got.view(torch.uint8), ref.view(torch.uint8))[0]
    del got, ref
    work = pages.clone()

    def run():
        return ku.kv_move_rows(work, sp, sr, dp, dr)
    plain_ms = time_ms(lambda: ku.kv_move_rows_plain(work, sp, sr, dp, dr), reps=5)
    L, n_pages, ps = pages.shape[:3]
    flat = work.view(torch.uint8).view(L, n_pages * ps, -1)
    moved = flat[:, sp.long() * ps + sr.long()].clone()
    N = sp.shape[0]
    lidx = torch.arange(L, device="cuda")[:, None].expand(L, N)
    didx = (dp.long() * ps + dr.long())[None].expand(L, N)
    ms, lib_ms = paired_ms(run, lambda: flat.index_put_((lidx, didx), moved))
    row_bytes = flat.shape[-1]
    nbytes = 2 * L * _n_kept(dp, dr, ps) * row_bytes + N * 16
    row = _case("kv_move_rows", "kv_rows.cu", f"{KVU}:86 _move_kernel", err, err, ms,
                plain_ms, bound_ms(nbytes, 0.0), lib_ms,
                f"{case}L={L} N={N} row_bytes={row_bytes} "
                f"{str(pages.dtype).split('.')[-1]}")
    row["device_ms"] = cold_ms(run)
    del work, moved
    return row


def check_kv_move_rows(pkg, g, L, n_pages, ps, row, B, M):
    """K17 over B requests' accepted paths of M moves each (node ctx +
    path[i] to ctx + 1 + i, path increasing): rows shift down, so an earlier
    move's source is often a later move's destination (chains), and the last
    move of each request is masked to the null page 0, so page 0 is named B
    times."""
    import torch

    pages = torch.randn(L, n_pages, ps, row, generator=g, device="cuda").to(torch.bfloat16)
    P = (n_pages - 1) // B
    sp, sr, dp, dr = [], [], [], []
    for b in range(B):
        pt = torch.arange(1 + b * P, 1 + (b + 1) * P, device="cuda")
        ctx = int(torch.randint(0, (P - 2) * ps, (1,), generator=g, device="cuda"))
        path = torch.sort(torch.randperm(2 * M, generator=g, device="cuda")[:M] + 1)[0]
        src, dst = ctx + path, ctx + 1 + torch.arange(M, device="cuda")
        dpage = pt[dst // ps].clone()
        dpage[-1] = 0
        sp.append(pt[src // ps])
        sr.append(src % ps)
        dp.append(dpage)
        dr.append(dst % ps)
    sp, sr, dp, dr = (torch.cat(x).to(torch.int32) for x in (sp, sr, dp, dr))
    return kv_move_row(pkg, pages, sp, sr, dp, dr, f"B={B} M={M} chained ")


def row_kernel_rows(pkg, g, cfg) -> list:
    """K16 and K17 against their plain versions. K16's step entry in every
    arena kind (``step_rows``); its general entry (the JAX contract): bf16
    K and V rows at every width the main paths write (decode to an 8 x 512
    prefill), e4m3 rows, fp8_tok's e4m3 rows with their f32 scale rows of
    32 heads, scale rows of 4 heads, MLA's 576 + 512 lanes. K17: the
    generator's compactions (one request, 12 and 63 moves) and a batch of
    four."""
    import torch

    L, HD, Hkv = cfg.num_hidden_layers, cfg.num_key_value_heads * cfg.head_dim, \
        cfg.num_key_value_heads
    bf, e4, f32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32
    rows = step_rows(pkg, g)
    rows += [check_kv_write_rows(pkg, g, L, (HD, HD), (bf, bf), N, 66)
             for N in (1, 64, 256, 512, 4096)]
    for N in (64, 512):
        rows.append(check_kv_write_rows(pkg, g, L, (HD, HD), (e4, e4), N, 66))
        rows.append(check_kv_write_rows(pkg, g, L, (HD, HD, Hkv, Hkv), (e4, e4, f32, f32),
                                        N, 66))
    rows.append(check_kv_write_rows(pkg, g, L, (4, 4), (f32, f32), 64, 66))
    for N in (1, 64, 4096):
        rows.append(check_kv_write_rows(pkg, g, 27, (576, 512), (bf, bf), N, 66))
    for B, M in ((1, 12), (1, 63), (4, 63)):
        rows.append(check_kv_move_rows(pkg, g, L, 1 + 4 * 17, 64, HD, B, M))
    torch.cuda.empty_cache()
    return rows


def k4_rows(pkg, g, cfg) -> list:
    """K4 against its plain versions: the general entry with 127 rows
    moving and none; the compaction entry (K and V in one launch) at the
    main paths' compactions (Q = 17 one branch and R = 2 L = 8, the
    generator's Q = 64) and at DeepSeek-V2-Lite's latent rows; and in the
    static and per-token e4m3 arenas (R = 2 L = 8, Q = 64 with 62 rows
    moving), also against the JAX package's route."""
    import torch

    L, HD = cfg.num_hidden_layers, cfg.num_key_value_heads * cfg.head_dim
    rows = [check_kv_permute(pkg, g, L, 65, 64, HD, 1, 2, moves) for moves in (True, False)]
    for case, B, Q, n_identity, n_moves in COMPACTIONS:
        rows.append(check_kv_compact(pkg, g, L, (HD, HD), B, Q, n_identity, n_moves, case))
    # DeepSeek-V2-Lite's latent rows: 576-lane K, 512-lane V, 27 layers
    rows.append(check_kv_compact(pkg, g, 27, (576, 512), 1, 17, 0, 8, "MLA R=2 L=8 "))
    # the e4m3 arenas, static and per-token (K, V and the scale rows in one
    # launch), with rows moving
    for kind in ("fp8", "fp8_tok"):
        for case, B, Q, n_identity, n_moves in COMPACTIONS[1::2]:
            rows.append(check_kv_compact(pkg, g, L, (HD,), B, Q, n_identity, n_moves,
                                         f"{kind} {case}", kind, cfg.num_key_value_heads))
    torch.cuda.empty_cache()
    return rows


def phase_kernels(pkg, cfg) -> list:
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_key_value_heads * cfg.head_dim
    layer_shapes = [(E, E + 2 * HD), (E, E), (E, 2 * I), (I, E)]
    rows = []
    # K1 at decode (1), lookahead (17), the generator's Q = 64, prefill (512)
    # and serving's 8 x 512 prefill (4096)
    for M in (1, 17, 64, 512, 4096):
        for K, N in layer_shapes:
            rows.append(check_int4_gemm(pkg, g, M, K, N, torch.bfloat16))
        rows.append(check_int4_gemm(pkg, g, M, E, V, torch.float32))
    for group in (64, 32):  # the other groups the kernel takes, on gate/up
        for M in (17, 512):
            rows.append(check_int4_gemm(pkg, g, M, E, 2 * I, torch.bfloat16, group))
    torch.cuda.empty_cache()
    rows += k9_rows(pkg, g, cfg)
    rows += int8_rows(pkg, g, cfg)
    rows += w8a8_rows(pkg, g, cfg)
    rows += attention_rows(pkg, g, cfg)
    # a generator of their own: the rows after them keep their inputs
    rows += alibi_attention_rows(pkg, torch.Generator(device="cuda").manual_seed(SEED + 19))
    L = cfg.num_hidden_layers
    rows += k4_rows(pkg, g, cfg)
    Hkv = cfg.num_key_value_heads
    for B in (1, 8):
        rows.append(check_kv_write_pages(pkg, g, L, 2 * 8 * B + 1, 64, HD, B, 2,
                                         torch.float8_e4m3fn))
        rows.append(check_kv_write_pages(pkg, g, L, 2 * 8 * B + 1, 64, Hkv, B, 2,
                                         torch.float32))
    rows += row_kernel_rows(pkg, g, cfg)
    rows.extend(check_batch_invariance(pkg, g, cfg))
    check_attention_routes(pkg, g)
    check_attention_tile_edges(pkg, g)
    torch.cuda.synchronize()
    for r in rows:
        print("phase 2 kernel: " + json.dumps(r))
    return rows


def int8_rows(pkg, g, cfg) -> list:
    """K7 (the int8 weight-only GEMM) at decode (1), lookahead (17), the
    generator's Q = 64, prefill (512) and serving's 8 x 512 prefill (4096)
    over the 7B layer shapes and the fp32 LM head; at group 64 (gate/up);
    at DeepSeek-V2-Lite's dense down projection (one group of all 10944
    rows, stages of 64); on off-grid shapes it takes (a whole-K group that
    is a multiple of 32, N a multiple of 16); and its refusal of a group
    that is not a multiple of 32 and of N off the 16 grid."""
    import torch

    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_key_value_heads * cfg.head_dim
    name, rows = "int8_gemm", []
    for M in (1, 17, 64, 512, 4096):
        for K, N in [(E, E + 2 * HD), (E, E), (E, 2 * I), (I, E)]:
            rows.append(check_gemm8(pkg, g, name, M, K, N, torch.bfloat16))
        rows.append(check_gemm8(pkg, g, name, M, E, V, torch.float32, unstacked=True))
        torch.cuda.empty_cache()
    for M in (17, 512):
        rows.append(check_gemm8(pkg, g, name, M, E, 2 * I, torch.bfloat16, "group=64 ",
                                group=64))
        rows.append(check_gemm8(pkg, g, name, M, 10944, 2048, torch.bfloat16,
                                "group=10944 ", group=10944))
    rows.append(check_gemm8(pkg, g, name, 17, 352, 272, torch.bfloat16, "off-grid ",
                            group=352))
    rows.append(check_gemm8(pkg, g, name, 9, 192, 144, torch.float32, "off-grid ",
                            group=192))
    for K, N, group in ((333, 256, 333), (4096, 260, 128)):
        x, q, s = gemm8_operands(pkg, g, name, 17, K, N, group)
        try:
            pkg["quant_matmul"].int8_matmul(x, q, s)
        except ValueError:
            pass
        else:
            fail(f"{name} took K = {K}, N = {N}, group = {group} (groups must be "
                 "multiples of 32, N of 16)")
    return rows


def check_int8_tile_edges(pkg, g, E) -> None:
    """K7 at groups 128 and 64, both output types: a row alone equals
    itself at rows 0, 63, 64, 127, 128, 511 and 4095 of a 4096-row call
    (the edges of the 64-row warpgroup tiles and 128-row blocks), and the
    first m rows equal the 4096-row call's at m = 1 .. 512, bit for bit."""
    import torch

    fn = pkg["quant_matmul"].int8_matmul
    for group in (128, 64):
        x, q, s = gemm8_operands(pkg, g, "int8_gemm", 4096, E, E, group)
        for out in (torch.bfloat16, torch.float32):
            full = fn(x, q, s, out)
            for r in (0, 63, 64, 127, 128, 511, 4095):
                if not torch.equal(fn(x[r:r + 1], q, s, out), full[r:r + 1]):
                    fail(f"int8_gemm row {r} of 4096 differs from the row alone "
                         f"(group={group}, out={out})")
            for m in (1, 2, 8, 17, 64, 65, 136, 512):
                if not torch.equal(fn(x[:m], q, s, out), full[:m]):
                    fail(f"int8_gemm rows change with the batch width (M={m}, "
                         f"group={group}, out={out})")


def w8a8_rows(pkg, g, cfg) -> list:
    """K8 in both formats at decode (1), lookahead (17), the generator's Q =
    64, prefill (512) and serving's 8 x 512 prefill (4096) over the 7B layer
    shapes and the fp32 LM head; on off-grid shapes it takes (K, N multiples
    of 16, not of 128); and its refusal of K or N off the 16 grid."""
    import torch

    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_key_value_heads * cfg.head_dim
    rows = []
    for name in ("w8a8_gemm[int8]", "w8a8_gemm[fp8]"):
        for M in (1, 17, 64, 512, 4096):
            for K, N in [(E, E + 2 * HD), (E, E), (E, 2 * I), (I, E)]:
                rows.append(check_gemm8(pkg, g, name, M, K, N, torch.bfloat16))
            rows.append(check_gemm8(pkg, g, name, M, E, V, torch.float32, unstacked=True))
            torch.cuda.empty_cache()
        rows.append(check_gemm8(pkg, g, name, 17, 336, 272, torch.bfloat16, "off-grid "))
        rows.append(check_gemm8(pkg, g, name, 9, 208, 144, torch.float32, "off-grid "))
        xq, xs, q, s = gemm8_operands(pkg, g, name, 17, 333, 260)
        try:
            pkg["w8a8"].w8a8_gemm(xq, xs, q, s)
        except ValueError:
            pass
        else:
            fail(f"{name} took K = 333, N = 260 (K and N must be multiples of 16)")
    return rows


def k9_rows(pkg, g, cfg) -> list:
    """K9 (the block-fp8 GEMM, on the 8-bit tensor cores) at decode (1),
    lookahead (17), the generator's Q = 64, prefill (512) and serving's 8 x
    512 prefill (4096) over the 7B layer shapes and the fp32 LM head, with
    its device time; on off-grid shapes it takes (K, N multiples of 16, not
    of 128: partial K and column blocks); and its refusal of K or N off the
    16 grid."""
    import torch

    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_key_value_heads * cfg.head_dim
    name, rows = "block_fp8_gemm", []
    for M in (1, 17, 64, 512, 4096):
        for K, N in [(E, E + 2 * HD), (E, E), (E, 2 * I), (I, E)]:
            rows.append(check_gemm8(pkg, g, name, M, K, N, torch.bfloat16))
        rows.append(check_gemm8(pkg, g, name, M, E, V, torch.float32, unstacked=True))
        torch.cuda.empty_cache()
    rows.append(check_gemm8(pkg, g, name, 17, 336, 272, torch.bfloat16, "off-grid "))
    rows.append(check_gemm8(pkg, g, name, 9, 208, 144, torch.float32, "off-grid "))
    for K, N in ((333, 256), (336, 260)):
        xq, xs, q, s = gemm8_operands(pkg, g, name, 17, K, N)
        try:
            pkg["w8a8"].block_fp8_gemm(xq, xs, q, s)
        except ValueError:
            pass
        else:
            fail(f"{name} took K = {K}, N = {N} (K and N must be multiples of 16)")
    return rows


def check_w8a8_tile_edges(pkg, g, E) -> None:
    """K8 in both formats and K9, both output types: a row alone equals
    itself at rows 0, 63, 64, 127, 128, 511 and 4095 of a 4096-row call
    (the edges of the 64-row warpgroup tiles and 128-row blocks), and the
    first m rows equal the 4096-row call's at m = 1 .. 512, bit for bit."""
    import torch

    for name in ("w8a8_gemm[int8]", "w8a8_gemm[fp8]", "block_fp8_gemm"):
        fn = pkg["w8a8"].block_fp8_gemm if name == "block_fp8_gemm" else pkg["w8a8"].w8a8_gemm
        xq, xs, q, s = gemm8_operands(pkg, g, name, 4096, E, E)
        for out in (torch.bfloat16, torch.float32):
            full = fn(xq, xs, q, s, out)
            for r in (0, 63, 64, 127, 128, 511, 4095):
                if not torch.equal(fn(xq[r:r + 1], xs[r:r + 1], q, s, out), full[r:r + 1]):
                    fail(f"{name} row {r} of 4096 differs from the row alone (out={out})")
            for m in (1, 2, 8, 17, 64, 65, 136, 512):
                if not torch.equal(fn(xq[:m], xs[:m], q, s, out), full[:m]):
                    fail(f"{name} rows change with the batch width (M={m}, out={out})")


def check_batch_invariance(pkg, g, cfg) -> list:
    """Lossless serving needs every row's result to be the same at every
    batch width: K1 rows at M = 1..4096 and at every place in a tile (a row
    alone equals itself at rows 63, 64, 127, 128, 511 and 4095 of a
    4096-row call, bf16 and fp32 out, groups of 128, 64 and 32), the 8-bit
    GEMMs' rows at M = 1..4096 (K7's and K8's also at every place in a
    tile, both output types, K7 at groups 128 and 64, K8 in both formats,
    K9),
    the activation quantization and the norm at
    every row count, and an attention row at Q = 1 and inside a 17-wide
    verify, bit for bit. Fails the run otherwise; returns no kernel rows."""
    import torch

    E = cfg.hidden_size
    x = torch.randn(4096, E, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randint(0, 256, (E // 2, E), generator=g, device="cuda", dtype=torch.uint8)
    qm_mod, norm_mod = pkg["quant_matmul"], pkg["rmsnorm"]
    for group in (128, 64, 32):
        s = (torch.rand(E // group, E, generator=g, device="cuda") * 0.004).to(torch.bfloat16)
        for out in (torch.bfloat16, torch.float32):
            full = qm_mod.int4_matmul(x, q, s, out)
            for m in (1, 2, 4, 8, 17, 64, 65, 136, 512):
                if not torch.equal(qm_mod.int4_matmul(x[:m], q, s, out), full[:m]):
                    fail(f"int4_gemm rows change with the batch width (M={m}, "
                         f"group={group}, out={out})")
            for r in (63, 64, 127, 128, 511, 4095):
                if not torch.equal(qm_mod.int4_matmul(x[r:r + 1], q, s, out), full[r:r + 1]):
                    fail(f"int4_gemm row {r} of 4096 differs from the row alone "
                         f"(group={group}, out={out})")
    w = torch.ones(E, dtype=torch.bfloat16, device="cuda")
    nfull = norm_mod.rms_norm(x[:512], w)
    for m in (1, 2, 4, 8, 17, 136):
        if not torch.equal(norm_mod.rms_norm(x[:m], w), nfull[:m]):
            fail(f"rms_norm rows change with the batch width (M={m})")
    I = cfg.intermediate_size
    for name in GEMM8:
        for K in (E, I):
            args = gemm8_operands(pkg, g, name, 4096, K, E)
            fn = {"int8_gemm": qm_mod.int8_matmul,
                  "block_fp8_gemm": pkg["w8a8"].block_fp8_gemm}.get(name, pkg["w8a8"].w8a8_gemm)
            rest = args[-2:]  # the weight and its scales; the rest is per row
            full = fn(*args, torch.bfloat16)
            for m in (1, 8, 17, 136):
                part = fn(*(a[:m] for a in args[:-2]), *rest, torch.bfloat16)
                if not torch.equal(part, full[:m]):
                    fail(f"{name} rows change with the batch width (M={m}, K={K})")
            del args, full
    check_int8_tile_edges(pkg, g, E)
    check_w8a8_tile_edges(pkg, g, E)
    xa = torch.randn(136, E, generator=g, device="cuda").to(torch.bfloat16)
    for mode in ("w8a8_int8", "w8a8_fp8", "fp8_block", "fp8_tb"):
        qspec = pkg["linear"].QuantSpec.from_mode(mode)
        xq, xs = pkg["w8a8"].quant_act(xa, qspec)
        for m in (1, 8, 17):
            xq_m, xs_m = pkg["w8a8"].quant_act(xa[:m], qspec)
            if not (torch.equal(xq_m.view(torch.uint8), xq[:m].view(torch.uint8))
                    and torch.equal(xs_m, xs[:m])):
                fail(f"quant_act ({mode}) rows change with the batch width (M={m})")
    check_attention_width(pkg, g, cfg)
    print("phase 2 batch invariance: int4_gemm (M = 1..4096 and rows 63, 64, 127, 128, "
          "511, 4095 alone, bf16 / fp32 out, groups 128 / 64 / 32), int8_gemm (also rows "
          "0, 63, 64, 127, 128, 511, 4095 alone, bf16 / fp32 out, groups 128 / 64), "
          "w8a8_gemm (int8, fp8) and block_fp8_gemm (also rows 0, 63, 64, 127, 128, 511, "
          "4095 alone, bf16 / fp32 out), quant_act, rms_norm and attention rows "
          "bit-identical at every width")
    return []


def check_attention_width(pkg, g, cfg) -> None:
    """Row 0 of a 17-wide tree verify equals a Q = 1 decode of that token,
    bit for bit, in every arena. Fails the run otherwise."""
    import torch

    pa, H, D = pkg["paged_attention"], cfg.num_attention_heads, cfg.head_dim
    for arena in ("bf16", "fp8", "fp8_tok"):
        k, v, pt, ks, vs = _arena(g, 2, 700, 17, H, D, 64, arena)
        ctx = torch.tensor([700, 333], dtype=torch.int32, device="cuda")
        qq = torch.randn(2, 17, H, D, generator=g, device="cuda").to(torch.bfloat16)
        tree = torch.rand(2, 17, 17, generator=g, device="cuda") < 0.5
        tree[:, 0] = False
        tree[:, :, 0] = True
        one = torch.ones(2, 1, 1, dtype=torch.bool, device="cuda")

        def att(qx, m):
            if arena == "fp8_tok":
                return pa.paged_attention_tok(qx, k, v, ks, vs, pt, ctx, D ** -0.5, m)
            return pa.paged_attention(qx, k, v, pt, ctx, m, D ** -0.5,
                                      None if ks is None else (ks, vs))
        if not torch.equal(att(qq, tree)[:, :1], att(qq[:, :1].contiguous(), one)):
            fail(f"paged_attention ({arena}) row 0 changes with the verify width")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


class Launches:
    """The kernels' launch counters: each wrapper's ``launches`` and, for
    the attention wrappers, its ``modes`` (width kind, arena)."""

    def __init__(self, pkg):
        pa, ku = pkg["paged_attention"], pkg["kv_update"]
        self.attn = (pa.paged_attention, pa.paged_attention_prefill, pa.paged_attention_tok)
        self.w8a8 = pkg["w8a8"].w8a8_gemm
        self.gquant = pkg["moe_matmul"].grouped_quant_matmul
        self.mla = pkg["mla_attention"].mla_paged_attention
        self.plain = {"grouped_gemm": pkg["moe_matmul"].grouped_matmul,
                      "dense_bf16_gemm": pkg["moe_matmul"].dense_matmul,
                      "batched_bf16_gemm": pkg["moe_matmul"].dense_matmul_batched,
                      "int4_gemm": pkg["quant_matmul"].int4_matmul,
                      "int8_gemm": pkg["quant_matmul"].int8_matmul,
                      "block_fp8_gemm": pkg["w8a8"].block_fp8_gemm,
                      "kv_permute_pages": ku.kv_permute_pages,
                      "kv_compact_tail": ku.kv_compact_tail,
                      "kv_write_pages": ku.kv_write_pages,
                      "kv_write_step": ku.kv_write_step,
                      "kv_write_rows": ku.kv_write_rows,
                      "kv_move_rows": ku.kv_move_rows,
                      "fp8_head_gemm": pkg["quant_matmul"].fp8_head_matmul}
        la, rn = pkg["linear_attention"], pkg["rmsnorm"]
        for mode in ("chunk", "decode", "tree", "commit"):
            self.plain[f"linear_attention[{mode}]"] = getattr(la, f"linear_attention_{mode}")
        for kind, fn in (("plain", rn.rms_norm), ("grouped", rn.rms_group_norm),
                         ("gated", rn.rms_group_norm_sigmoid)):
            self.plain[f"rms_norm[{kind}]"] = fn

    def reset(self):
        for f in (*self.attn, self.w8a8, self.gquant, self.mla, *self.plain.values()):
            f.launches = 0
        for f in (*self.attn, self.w8a8, self.mla):
            f.modes.clear()
        for f in self.attn:
            f.dims.clear()
            f.groups.clear()
        for fmt in self.gquant.modes:
            self.gquant.modes[fmt] = 0

    def read(self) -> dict:
        """Counts by kernels-line row name."""
        out = {name: f.launches for name, f in self.plain.items()}
        for fmt in ("int8", "fp8"):
            out[f"w8a8_gemm[{fmt}]"] = self.w8a8.modes[fmt]
        for fmt in ("int4", "int8"):
            out[f"grouped_{fmt}_gemm"] = self.gquant.modes[fmt]
        pa, pre, tok = self.attn
        for kind in ("decode", "verify"):
            out[f"paged_attention[{kind}]"] = pa.modes[f"{kind},bf16"]
            out[f"paged_attention[{kind},fp8]"] = pa.modes[f"{kind},fp8"]
        out["paged_attention_prefill"] = pre.modes["prefill,bf16"]
        out["paged_attention_prefill[fp8]"] = pre.modes["prefill,fp8"]
        for kind in ("decode", "verify"):
            out[f"paged_attention[{kind},alibi]"] = pa.modes[f"{kind},bf16,alibi"]
        out["paged_attention_prefill[alibi]"] = pre.modes["prefill,bf16,alibi"]
        for kind in ("decode", "verify"):
            out[f"paged_attention[{kind},range]"] = pa.modes[f"{kind},bf16,range"]
        out["paged_attention_prefill[range]"] = pre.modes["prefill,bf16,range"]
        for kind in ("decode", "verify", "prefill"):
            out[f"paged_attention_tok[{kind}]"] = tok.modes[f"{kind},fp8_tok"]
            out[f"mla_attention[{kind}]"] = self.mla.modes[kind]
            out[f"mla_attention[{kind},range]"] = self.mla.modes[f"{kind},range"]
        # the head-dim pairs past 128 (GPT-J's 256, DeepSeek's expanded MLA),
        # the heads of 80 and 96 lanes (OPT, BLOOM), and the query heads a kv
        # head that do not divide 128 (Qwen2 / Qwen2.5 / Qwen3)
        for kind in ("decode", "verify", "prefill"):
            for arena in ("bf16", "fp8", "fp8_tok"):
                for dims in PAIR_DIMS + NARROW_DIMS:
                    out[_pair_name(kind, arena, dims)] = sum(
                        f.dims[f"{dims},{kind},{arena}"] for f in self.attn)
                for G in NEW_GROUPS:
                    out[_pair_name(kind, arena, f"G{G}")] = sum(
                        f.groups[f"{G},{kind},{arena}"] for f in self.attn)
        out["paged_attention_prefill[window]"] = pre.modes["prefill,bf16,window"]
        return out


K10_ENTRIES = ("dense_bf16_gemm", "batched_bf16_gemm", "grouped_gemm")


def k10_per_step(at_prefill: dict, at_ar: dict, at_spec: dict, ar_steps: int,
                 spec_steps: int) -> dict:
    """Each entry of the bf16 GEMM (K10) launched a step of the main path's
    own run, from its counts read after the prefill, after the AR decode and
    after the lookahead run (which starts with a prefill of its own): the
    prefill's, and the AR and verify steps' counts over the steps taken."""
    def per(n, steps):
        return n // steps if n % steps == 0 else n / steps

    return {k: {"prefill": at_prefill[k],
                "decode": per(at_ar[k] - at_prefill[k], ar_steps),
                "verify": per(at_spec[k] - at_ar[k] - at_prefill[k], spec_steps)}
            for k in K10_ENTRIES}


def phase_main_path(pkg, cfg, spec, params, ar_tokens=AR_TOKENS,
                    spec_tokens=SPEC_TOKENS, label="phase 3 main path",
                    extras=True, prompt_len=PROMPT_LEN, max_seq_len=4096,
                    k10_steps=False) -> dict:
    """Prefill, greedy AR decode and lookahead decode at B = 1 with the
    strict lossless check, the kernels' launches counted from 0. ``extras``
    adds the draft-table costs and the profiled steps; ``k10_steps`` prints
    the bf16 GEMM's launches a step of each kind on a line of its own."""
    import numpy as np
    import torch

    launches = Launches(pkg)
    step, ms_mod, dt = pkg["step"], pkg["multistep"], pkg["device_tables"]
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=max_seq_len,
                                      max_concurrency=1)
    tcfg = dt.DraftTableConfig(buckets=16384, ways=8, branch_length=16, retrieve_count=1)
    torch.cuda.reset_peak_memory_stats()
    prompt = np.random.default_rng(SEED).integers(10, cfg.vocab_size - 10, prompt_len)
    prompt_t = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    ctx0 = torch.tensor([prompt_len], dtype=torch.int32, device="cuda")
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
        while len(stream) < spec_tokens and n_steps < max_steps:
            kv, tables, out, acc, last, ctx, act, tail, _ = ms_mod.multistep_spec_decode(
                params, kv, tables, cfg, tcfg, last, ctx, act, tail, pt,
                n_steps=SPEC_CHUNK, spec=spec, update_tables=update)
            out, acc = out[0].tolist(), acc[0].tolist()
            for si in range(SPEC_CHUNK):
                stream.extend(out[si][: acc[si]])
            n_steps += SPEC_CHUNK
        torch.cuda.synchronize()
        return stream, n_steps, time.perf_counter() - t0, tables

    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv, nxt, logits = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = launches.read()
    if not (torch.isfinite(logits).all() and logits.shape == (1, cfg.vocab_size)):
        fail(f"{label}: prefill logits are not finite or have the wrong shape")
    t0 = time.perf_counter()
    kv, toks, _, ctx, _, _ = ms_mod.multistep_decode(
        params, kv, cfg, nxt, ctx0, one, pt, n_steps=ar_tokens - 1, spec=spec)
    ar_stream = [int(nxt[0])] + toks[0].tolist()
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    if int(ctx[0]) != prompt_len + ar_tokens - 1 or min(ar_stream) < 0:
        fail(f"{label}: AR decode did not advance one token per step")
    at_ar = launches.read()
    del kv
    spec_stream, spec_steps, spec_s, tables = spec_run(False, True, spec_tokens)
    counts = launches.read()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    replay, replay_steps, _, _ = spec_run(True, False, 4 * spec_tokens)
    n = min(len(spec_stream), len(replay))
    div = next((i for i in range(n) if spec_stream[i] != replay[i]), n)
    n_ar = min(len(spec_stream), len(ar_stream))
    ar_div = next((i for i in range(n_ar) if spec_stream[i] != ar_stream[i]), n_ar)
    res = {}
    if extras:
        res.update(
            table_ms=table_costs(pkg, tcfg, tables, spec_stream, TAIL),
            profile=profile_steps(pkg, cfg, spec, params, ecfg, tcfg, prompt_t, pt, ctx0))
    res.update(
        k10_launches_per_step=k10_per_step(at_prefill, at_ar, counts, ar_tokens - 1,
                                           spec_steps),
        prefill_ms=prefill_ms, ar_tok_s=(ar_tokens - 1) / ar_s,
        spec_tok_s=(len(spec_stream) - 1) / spec_s,
        accepted_per_step=(len(spec_stream) - 1) / spec_steps,
        spec_tokens=len(spec_stream), spec_steps=spec_steps,
        lossless_strict=div == n, lossless_compared=n, first_divergence=div,
        spec_vs_ar_first_divergence=ar_div, spec_vs_ar_compared=n_ar,
        peak_mem_gb=peak_gb, launches=counts,
    )
    print(f"{label}: " + json.dumps(res))
    if k10_steps:
        print(f"{label}: K10 launches per step: " + json.dumps(res["k10_launches_per_step"]))
    if div != n or n < spec_tokens // 2:
        fail(f"{label}: lossless check failed: first divergence {div} of {n}")
    res["ar_stream"] = ar_stream
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


# ---------------------------------------------------------------------------
# the serving phase: LLM over the three KV arenas, AR and lookahead
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = 48
SERVE_PREFIX = 128  # two 64-token pages shared by half of the requests
SERVE_LAYERS = 8  # the dense models serve at a cut depth (host-bound: ~linear in layers)


def first_layers(cfg, params, n: int):
    """A dense model cut to its first n layers: views of the stacked
    weights, no copy."""
    import dataclasses

    def cut(leaf):
        return {k: v[:n] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[:n]

    out = dict(params, layers={k: cut(v) for k, v in params["layers"].items()})
    return dataclasses.replace(cfg, num_hidden_layers=n), out


def serving_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(SEED)
    prefix = rng.integers(10, vocab - 10, SERVE_PREFIX).tolist()
    out = []
    for i in range(SERVE_REQUESTS):
        n = int(rng.integers(64, 385))
        if i % 2 == 0:
            out.append(prefix + rng.integers(10, vocab - 10, n - SERVE_PREFIX).tolist()
                       if n > SERVE_PREFIX else prefix[:n])
        else:
            out.append(rng.integers(10, vocab - 10, n).tolist())
    return out


def serve_once(pkg, cfg, params, prompts, kv_quant, lookahead, quant="int4") -> tuple:
    """One ``LLM.generate`` over the 16 requests; ``quant`` is the linears'
    format ("none": native bf16 weights)."""
    import torch

    config, llm_mod = pkg["config"], pkg["llm"]
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=8, prefill_chunk=512,
              quant=quant, eos_token_id=-2, prefix_cache=True, decode_burst=8,
              decode_burst_idle=32, kv_quant=kv_quant)
    if lookahead:
        kw.update(use_lookahead=True, decoding_length=16, branch_length=16,
                  use_spec_min_batch_size=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    llm = llm_mod.LLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw))
    cal_s = 0.0
    if kv_quant == "fp8":
        t0 = time.perf_counter()
        llm.calibrate_kv_scales(prompts[:4])
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reqs = llm.generate(prompts, pkg["request"].SamplingParams(
        max_new_tokens=SERVE_NEW_TOKENS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = llm.metrics
    outs = [r.output_ids for r in reqs]
    if any(len(o) != SERVE_NEW_TOKENS for o in outs):
        fail(f"serving {quant} {kv_quant} lookahead={lookahead}: a request stopped early")
    res = dict(
        quant=quant, kv_quant=kv_quant, lookahead=lookahead,
        layers=cfg.num_hidden_layers, wall_s=wall,
        tok_s=m.generated_tokens / wall, generated_tokens=m.generated_tokens,
        p50_ttft_s=m.p50_ttft, prefix_hit_tokens=m.prefix_hit_tokens,
        chained_bursts=m.chained_bursts, decode_steps=m.decode_steps,
        spec_steps=m.spec_steps, spec_accepted=m.spec_accepted,
        prefill_s=m.prefill_time, decode_s=m.decode_time, drain_s=m.drain_time,
        table_updates=m.table_updates,
        table_update_ms_per_drain=(1e3 * m.table_update_time / m.table_updates
                                   if m.table_updates else None),
        preempted=m.preempted, calibrate_s=cal_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    tables = llm.tables
    del llm, reqs
    return res, outs, tables


def drain_table_cost(pkg, tables, tcfg, prompts) -> dict:
    """Host-clock cost of one drain's table update at the serving batch:
    8 rows of 18 tail tokens plus K newly decoded tokens each (K = 8, 32),
    on the populated tables of a lookahead run."""
    import numpy as np
    import torch

    dt = pkg["device_tables"]
    out = {}
    TAIL = tcfg.branch_length + 2
    for K in (8, 32):
        bufs = np.full((8, TAIL + 32), -1, np.int32)
        for b in range(8):
            seq = prompts[b][-(TAIL + K):]
            bufs[b, : len(seq)] = seq
        n = np.full(8, TAIL + K)
        lo, hi = np.full(8, TAIL), np.full(8, TAIL + K)
        buf_t = torch.tensor(bufs, device="cuda")
        out[f"update_batch_8rows_{K}_new"] = _host_ms(
            lambda: dt.update_tables_batch(tables, tcfg, buf_t, n, lo, hi), reps=3)
    return out


class LaunchHooks:
    """The capture classes' common part: ``_wrap`` replaces launch functions
    of the port's ops modules by hooks made from the originals, ``remove``
    puts the originals back."""

    def __init__(self, pkg):
        self.pkg = pkg
        self._saved = []

    def _wrap(self, hooks):
        """hooks: (module, function name, make), make(original) -> hook."""
        for mod, name, make in hooks:
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, make(orig))

    def remove(self):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        self._saved.clear()

    @staticmethod
    def _first_layer(t) -> bool:
        """True for a view at the start of its storage: a stacked arena's or
        weight's layer 0."""
        return t.data_ptr() == t.untyped_storage().data_ptr()

    @staticmethod
    def _clone(t):
        return None if t is None else t.clone()


class RowWriteCapture(LaunchHooks):
    """K16's inputs in real runs, for holding its step entry against its
    plain version on the writes the models make. For each arena signature
    (the arenas' types and row widths) it keeps the call with the most
    tokens and the one with the fewest: the step's K and V (copied with
    their strides), page tables, start lengths, valid mask, layer, static
    scales and arena shapes. The arenas' contents do not steer K16, so
    ``rows`` replays each kept call on random arenas of its shapes through
    ``kv_step_row``, after the run's counts are read."""

    def __init__(self, pkg):
        super().__init__(pkg)
        self.kept = {}

    def install(self):
        self._wrap([(self.pkg["kv_update"], "_kv_write_step_cuda", self._hook)])

    @staticmethod
    def _copy(t):
        """A copy of ``t`` with its strides (a view's gaps kept)."""
        import torch

        if t is None:
            return None
        out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
        return out.copy_(t)

    def _hook(self, orig):
        def hook(arenas, new_k, new_v, page_tables, start_lens, valid, layer, k_scale,
                 v_scale):
            sig = tuple((str(a.dtype).split(".")[-1], a.shape[-1]) for a in arenas)
            N = new_k.shape[0] * new_k.shape[1]
            for which in ("most", "fewest"):
                old = self.kept.get((sig, which))
                if old is None or (N > old["N"] if which == "most" else N < old["N"]):
                    self.kept[(sig, which)] = dict(
                        N=N, layer=layer, shapes=[(tuple(a.shape), a.dtype) for a in arenas],
                        ops=[self._copy(t) for t in (new_k, new_v, page_tables, start_lens,
                                                     valid, k_scale, v_scale)])
            return orig(arenas, new_k, new_v, page_tables, start_lens, valid, layer, k_scale,
                        v_scale)
        return hook

    def rows(self, case: str) -> list:
        import torch

        if not self.kept:
            fail(f"{case}: K16 made no call")
        g = torch.Generator(device="cuda").manual_seed(SEED)
        out = []
        for (sig, which), c in sorted(self.kept.items(), key=lambda kv: str(kv[0])):
            if which == "fewest" and self.kept[(sig, "most")]["N"] == c["N"]:
                continue  # one call size only
            arenas = [_random_like(shape, dt, g) for shape, dt in c["shapes"]]
            nk, nv, pt, start, valid, ks, vs = c["ops"]
            out.append(kv_step_row(self.pkg, arenas, nk, nv, pt, start, valid, c["layer"], ks,
                                   vs, f"{case} "))
            del arenas
        self.kept = {}
        torch.cuda.empty_cache()
        return out


class ServingCapture(LaunchHooks):
    """The inputs of real serving calls into the kernels, for holding each
    kernel against its plain version at the shapes serving gives it.

    While installed it wraps the ops modules' launch functions and keeps,
    cloned in stream order at the call (the arena moves on afterwards):
    attention at layer 0, the widest decode and verify batch of each arena
    and every prefill batch of B >= 2 (``trim`` keeps the one with the most
    rows resumed from the prefix cache, then the widest); K1 and the 8-bit
    GEMMs at layer 0 (and the LM head), the largest M of each weight shape; K4's
    compaction entry, the verify step's tables of up to 512 compactions in
    each arena kind (bf16; static e4m3; per-token e4m3, whose scale arenas
    move in the same launch); ``rows`` compacts arenas of each kind's shapes
    on the widest call's tables, and holds the e4m3 kinds against the JAX
    package's route (``compaction_vs_jax``, the only launches of K6, which
    no path calls) on the call that moves the most rows. Choosing reads shapes
    and pointers only, so the runs are not synchronised. The wrapped
    launches are the runs' own; ``rows`` launches afresh on the kept inputs
    after the run's counts are read."""

    def __init__(self, pkg):
        super().__init__(pkg)
        self.attn, self.prefill, self.gemm, self.compact = {}, {}, {}, {}
        self.gemm8 = {}
        self.check_launches = 0  # K6's, in the checks against the JAX route

    def install(self, gemm8_only: bool = False):
        """Wrap the launch functions; ``gemm8_only`` leaves attention, K1 and
        the KV kernels alone (the quant modes hold only the 8-bit GEMMs
        again, and kept attention inputs would count in their peak memory)."""
        pa, qm, ku, w8 = (self.pkg[m] for m in ("paged_attention", "quant_matmul",
                                                "kv_update", "w8a8"))
        hooks = [(qm, "_int8_matmul_cuda", self._gemm8_hook),
                 (w8, "_w8a8_gemm_cuda", self._gemm8_hook),
                 (w8, "_block_fp8_gemm_cuda", self._gemm8_hook)]
        if not gemm8_only:
            hooks += [(pa, "_launch", self._attn_hook),
                      (qm, "_int4_matmul_cuda", self._gemm_hook),
                      (ku, "_kv_compact_cuda", self._compact_hook)]
        self._wrap(hooks)

    def _attn_hook(self, orig):
        def hook(wrapper, q, k, v, pt, ctx, qmask, scale, causal, arena, ks=None, vs=None,
                 alibi=None, alibi_pos=None, page_range=None, return_lse=False, window=None):
            if self._first_layer(k) and page_range is None and window is None:
                B, Q = q.shape[:2]
                kind = "decode" if Q == 1 else ("prefill" if causal else "verify")
                old = self.attn.get((kind, arena))
                keep = (B >= 2 and len(self.prefill.setdefault(arena, [])) < 8
                        if kind == "prefill" else old is None or B > old["q"].shape[0])
                if keep:
                    c = dict(q=q.clone(), k=k.clone(), v=v.clone(), pt=pt.clone(),
                             ctx=ctx.clone(), scale=scale,
                             qmask=None if qmask is None else qmask.clone(),
                             ks=None if ks is None else ks.clone(),
                             vs=None if vs is None else vs.clone())
                    if kind == "prefill":
                        self.prefill[arena].append(c)
                    else:
                        self.attn[(kind, arena)] = c
            return orig(wrapper, q, k, v, pt, ctx, qmask, scale, causal, arena, ks, vs, alibi,
                        alibi_pos, page_range, return_lse, window)
        return hook

    def _gemm_hook(self, orig):
        def hook(x, q, s, out_dtype):
            if self._first_layer(q):
                key = (x.shape[1], q.shape[1], str(out_dtype))
                old = self.gemm.get(key)
                if old is None or x.shape[0] > old["x"].shape[0]:
                    # the weights are not written during serving: no copy
                    self.gemm[key] = dict(x=x.clone(), q=q, s=s, out_dtype=out_dtype)
            return orig(x, q, s, out_dtype)
        return hook

    def _gemm8_hook(self, orig):
        """For the three 8-bit launch functions alike: the operands are
        (activations..., weight, weight scales, out_dtype)."""
        def hook(*args):
            *acts, q, s, out_dtype = args
            if self._first_layer(q):
                if len(acts) == 1:
                    name = "int8_gemm"
                elif s.dim() == 2:
                    name = "block_fp8_gemm"
                else:
                    name = "w8a8_gemm[int8]" if str(q.dtype) == "torch.int8" \
                        else "w8a8_gemm[fp8]"
                key = (name, q.shape[0], q.shape[1], str(out_dtype))
                old = self.gemm8.get(key)
                if old is None or acts[0].shape[0] > old["args"][0].shape[0]:
                    # the weights are not written during the runs: no copy
                    self.gemm8[key] = dict(args=(*(a.clone() for a in acts), q, s),
                                           out_dtype=out_dtype, unstacked=q.dim() == 2
                                           and q.untyped_storage().nbytes() == q.numel())
            return orig(*args)
        return hook

    def gemm8_rows(self, case: str) -> list:
        """The kept 8-bit GEMM calls against their plain versions; forgets
        them afterwards (their weights are about to be freed)."""
        out = [gemm8_row(self.pkg, key[0], c["args"], c["out_dtype"], case, c["unstacked"])
               for key, c in self.gemm8.items()]
        self.gemm8 = {}
        return out

    def _compact_hook(self, orig):
        def hook(arenas, page_tables, ctx_lens, path, n_edges, q_width, active):
            import torch

            kind = ("bf16" if arenas[0].dtype != torch.float8_e4m3fn
                    else "fp8_tok" if len(arenas) == 4 else "fp8")
            c = self.compact.setdefault(kind, dict(
                shapes=[(tuple(a.shape), a.dtype) for a in arenas], calls=[]))
            if len(c["calls"]) < 512:  # a few KB each
                c["calls"].append(tuple(self._clone(t) for t in (
                    page_tables, ctx_lens, path, n_edges, active)) + (q_width,))
            return orig(arenas, page_tables, ctx_lens, path, n_edges, q_width, active)
        return hook

    def trim(self):
        """Keep, of each arena's prefill batches, the one with the most rows
        resumed from the prefix cache (start > 0), then the widest."""
        for arena, cands in self.prefill.items():
            if cands:
                best = max(cands, key=lambda c: (int((c["ctx"] > 0).sum().item()),
                                                 c["q"].shape[0]))
                self.prefill[arena] = [best]

    def rows(self, arenas) -> list:
        self.trim()
        pkg, out = self.pkg, []
        want = [(kind, a) for a in arenas for kind in ("decode", "verify", "prefill")]
        for kind, arena in want:
            c = (self.prefill.get(arena) or [None])[0] if kind == "prefill" \
                else self.attn.get((kind, arena))
            if c is None:
                fail(f"serving made no {kind} attention call of B >= 2 ({arena})")
            ctx = c["ctx"]
            case = f"serving ctx={int(ctx.min())}-{int(ctx.max())} "
            if kind == "prefill":
                case += f"resumed_rows={int((ctx > 0).sum())} "
            out.append(attention_row(pkg, kind, arena, c["q"], c["k"], c["v"], c["pt"],
                                     ctx, c["qmask"], c["ks"], c["vs"], c["scale"], case))
        if not self.gemm:
            fail("serving made no int4_gemm call")
        for c in self.gemm.values():
            out.append(gemm_row(pkg, c["x"], c["q"], c["s"], c["out_dtype"], "serving "))
        out += self.compaction_rows()
        self.attn, self.prefill, self.gemm, self.compact = {}, {}, {}, {}
        return out

    def compaction_rows(self) -> list:
        """K4's compaction on serving's own tables over fresh random arenas
        of each kind's shapes (the contents do not steer the kernel): one
        row a kind at the widest call (of the widest, the one that moves the
        most rows), each one CUDA kernel a call; the e4m3 kinds held against
        the JAX package's route (``compaction_vs_jax``) on the call that
        moves the most rows (of those, the widest)."""
        import torch

        ku = self.pkg["kv_update"]
        for kind in ("bf16", "fp8", "fp8_tok"):
            if kind not in self.compact:
                fail(f"serving made no kv_compact_tail call in the {kind} arena")
        ps = self.compact["bf16"]["shapes"][0][0][2]

        def moved(call):
            pt, ctx, path, ne, act, q = call
            return sum(map(len, ku.compaction_moves(pt.cpu(), ctx.cpu(), path.cpu(), ne.cpu(),
                                                    q, ps, None if act is None else act.cpu())))
        calls = [(c, moved(c)) for k in self.compact.values() for c in k["calls"]]
        widest = max(calls, key=lambda cm: (cm[0][2].shape[0], cm[1]))[0]
        moving = max(calls, key=lambda cm: (cm[1], cm[0][2].shape[0]))[0]
        pt, ctx, path, ne, act, q = widest
        n_pages = max(k["shapes"][0][0][1] for k in self.compact.values())
        g = torch.Generator(device="cuda").manual_seed(SEED)
        out = []
        for kind, c in self.compact.items():
            L, _, ps, lanes = c["shapes"][0][0]
            arenas = kv_arenas(g, kind, (L, n_pages, ps, lanes), c["shapes"][-1][0][3])
            row = kv_compact_row(self.pkg, arenas, pt, ctx, path, ne, q, act,
                                 f"serving {kind} ")
            if row["kernels_per_call"] != 1:
                fail(f"a verify step's compaction in the {kind} arena is "
                     f"{row['kernels_per_call']} CUDA kernels, not 1")
            out.append(row)
            if kind != "bf16":
                self.check_launches += compaction_vs_jax(self.pkg, arenas, moving)
            del arenas
        bf16 = next(r for r in out if "bf16" in r["case"])
        for r in out:
            r["device_vs_bf16"] = r["device_ms"] / bf16["device_ms"]
        return out


def compaction_vs_jax(pkg, arenas, call) -> int:
    """K4's one-launch compaction of e4m3 (and scale) arenas held against
    the JAX package's route for them on copies (``compact_kv_tail``'s jnp
    route: ``tail_window``, a gather of each window's rows from their
    sources, then K6's whole-page write-back, ``kv_write_pages``): the
    bytes must be equal outside the null page 0, which an inactive row's
    window names (the JAX route copies the row's own window there, K4
    permutes page 0 itself). Returns K6's launches (one an arena)."""
    import torch

    ku = pkg["kv_update"]
    pt, ctx, path, ne, act, q = call
    got = ku.kv_compact_tail(tuple(a.clone() for a in arenas), pt, ctx, path, ne, q, act)
    ps, P = arenas[0].shape[2], pt.shape[1]
    page_ids, src_of, _ = ku.tail_window(pt, ctx, path, ne, q, ps, act)
    g_page = torch.gather(pt.long(), 1, (src_of // ps).clamp(0, P - 1)).reshape(-1)
    g_row = (src_of % ps).reshape(-1)
    B, W = src_of.shape
    before = ku.kv_write_pages.launches
    for a, k in zip(arenas, got):
        raw = a.clone().view(torch.uint8)
        rows = raw[:, g_page, g_row]  # [L, B*W, row bytes]
        windows = rows.reshape(raw.shape[0], B * (W // ps), ps, raw.shape[-1])
        ku.kv_write_pages(raw, windows, page_ids.reshape(-1))
        if not torch.equal(raw[:, 1:], k.view(torch.uint8)[:, 1:]):
            fail(f"kv_compact_tail ({len(arenas)} arenas, {a.dtype}) differs from the JAX "
                 "route (tail_window, gather, kv_write_pages) outside page 0")
        del raw, rows, windows
    n = ku.kv_write_pages.launches - before
    print(f"phase serving compaction vs JAX route: {len(arenas)} arenas "
          f"({'+'.join(str(a.dtype).split('.')[-1] for a in arenas)}) equal outside page 0, "
          f"{n} kv_write_pages launches")
    return n


def phase_serving(pkg, cfg, params) -> dict:
    import torch

    cfg, params = first_layers(cfg, params, SERVE_LAYERS)
    launches = Launches(pkg)
    prompts = serving_prompts(cfg.vocab_size)
    capture = ServingCapture(pkg)
    capture.install()
    row_writes = RowWriteCapture(pkg)
    row_writes.install()
    launches.reset()
    runs, tables, tcfg = [], None, None
    arenas = ("none", "fp8", "fp8_tok")
    for kv_quant in arenas:
        res_ar, ar_out, _ = serve_once(pkg, cfg, params, prompts, kv_quant, False)
        res_la, la_out, tables = serve_once(pkg, cfg, params, prompts, kv_quant, True)
        diff = [i for i, (a, b) in enumerate(zip(ar_out, la_out)) if a != b]
        res_la["identical_to_ar"] = not diff
        for r in (res_ar, res_la):
            print("phase serving run: " + json.dumps(r))
            runs.append(r)
        if diff:
            i = diff[0]
            j = next(k for k, (a, b) in enumerate(zip(ar_out[i], la_out[i])) if a != b)
            fail(f"serving {kv_quant}: lookahead differs from AR on requests {diff} "
                 f"(request {i} from token {j})")
        if res_la["spec_steps"] <= 0:
            fail(f"serving {kv_quant}: the lookahead run made no spec step")
        if res_ar["prefix_hit_tokens"] <= 0:
            fail(f"serving {kv_quant}: no prefix-cache hit")
        capture.trim()
    counts = launches.read()
    capture.remove()
    row_writes.remove()
    if counts["kv_write_pages"]:
        fail(f"serving launched kv_write_pages {counts['kv_write_pages']} times (K6 has no "
             "caller on any path)")
    tcfg = pkg["device_tables"].DraftTableConfig(buckets=16384, ways=8, branch_length=16,
                                                 retrieve_count=1)
    res = dict(runs=runs, launches=counts,
               drain_table_ms=drain_table_cost(pkg, tables, tcfg, prompts))
    print("phase serving: " + json.dumps(dict(launches=counts,
                                              drain_table_ms=res["drain_table_ms"])))
    # every kernel and arena mode against its plain version on the inputs
    # of real serving calls (B up to 8, ragged ctx, prefix-resumed prefill)
    res["kernels"] = capture.rows(["bf16" if a == "none" else a for a in arenas])
    res["check_launches"] = dict({k: 0 for k in counts},
                                 kv_write_pages=capture.check_launches)
    res["kernels"] += row_writes.rows("serving")
    for r in res["kernels"]:
        print("phase serving kernel: " + json.dumps(r))
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the host-trie generator: LookaheadGenerator at Llama-2-7B int4
# ---------------------------------------------------------------------------

GEN_TOKENS = 256
GEN_MODE_TOKENS = 64  # par and one modes, batch_generate
GEN_DECODING_LENGTH = 63  # verify width Q = 64
GEN_BRANCH_LENGTH = 12
GEN_BATCH = 4
# kernels with no caller on any path, launched by the checks: K17 and K4's
# and K16's general entries (the generator's), K6 (serving's, against the
# JAX route)
CHECK_ONLY = ("kv_move_rows", "kv_permute_pages", "kv_write_rows", "kv_write_pages")


class RowWriteCheck(LaunchHooks):
    """K16's step entry held against its general entry (``kv_write_rows``,
    the JAX contract) on a generator run's real writes: at every layer-0
    ``kv_write_step`` call, a copy of the layer's arenas taken before the
    call gets the step's rows by the eager route (``kv_step_rows``) and the
    general entry; after the call the layer must hold the same bytes
    outside the null page 0. The general entry has no caller on any path:
    its launches here are the check's."""

    def __init__(self, pkg):
        super().__init__(pkg)
        self.calls = 0

    def install(self):
        self._wrap([(self.pkg["kv_update"], "_kv_write_step_cuda", self._hook)])

    def _hook(self, orig):
        import torch

        ku = self.pkg["kv_update"]

        def hook(arenas, new_k, new_v, page_tables, start_lens, valid, layer, k_scale,
                 v_scale):
            if layer != 0:
                return orig(arenas, new_k, new_v, page_tables, start_lens, valid, layer,
                            k_scale, v_scale)
            before = tuple(a[:1].clone() for a in arenas)
            rows, fp, fr = ku.kv_step_rows(before, new_k, new_v, page_tables, start_lens,
                                           valid, k_scale, v_scale)
            ku.kv_write_rows(before, rows, fp, fr, 0)
            out = orig(arenas, new_k, new_v, page_tables, start_lens, valid, layer, k_scale,
                       v_scale)
            for a, b in zip(arenas, before):
                if not torch.equal(a[0, 1:].view(torch.uint8), b[0, 1:].view(torch.uint8)):
                    fail("kv_write_rows (K16's general entry) differs from kv_write_step "
                         "on a generator step")
            self.calls += 1
            return out
        return hook


class CompactionCheck(LaunchHooks):
    """K4's compaction entry held against K17 and against K4's general entry
    on a generator run's real compactions: at every ``compact_kv_tail`` call
    on the bf16 K and V arenas (one per verify step, both arenas in one
    launch), clones of the arenas taken before the call get the step's
    accepted path by ``move_kv_rows`` (K17), and the step's window by the
    composed route (``tail_window``, then ``kv_permute_pages``, K4's general
    entry, the JAX package's contract); each active request's live slots
    [0, ctx + 1 + n_edges) must then hold, over all layers, the bits that
    the compaction entry left (K17), and the whole arenas must equal them
    (K4's general entry). Neither K17 nor the general entry has a caller on
    any path: their launches here are the check's."""

    def __init__(self, pkg):
        super().__init__(pkg)
        self.calls = self.moves = 0

    def install(self):
        self._wrap([(self.pkg["step"], "compact_kv_tail", self._hook)])

    def _hook(self, orig):
        import torch

        move_kv_rows = self.pkg["cache"].move_kv_rows
        ku = self.pkg["kv_update"]

        def hook(pages, page_tables, ctx_lens, path, n_edges, q_width, active=None):
            arenas = pages if isinstance(pages, tuple) else (pages,)
            if arenas[0].dtype == torch.float8_e4m3fn:
                return orig(pages, page_tables, ctx_lens, path, n_edges, q_width, active)
            before = [a.clone() for a in arenas]
            out = orig(pages, page_tables, ctx_lens, path, n_edges, q_width, active)
            B, M = path.shape
            i = torch.arange(M, device=path.device)[None]
            ctx = ctx_lens.long()[:, None]
            valid = i < n_edges.long()[:, None]
            if active is not None:
                valid &= active[:, None]
            ps = arenas[0].shape[2]
            page_ids, src_of, base = ku.tail_window(page_tables, ctx_lens, path, n_edges,
                                                    q_width, ps, active)
            src_rel = (src_of - base[:, None]).clamp(0, src_of.shape[1] - 1)
            for a, b4 in zip(arenas, before):
                general = ku.kv_permute_pages(b4.clone(), page_ids, src_rel)
                if not torch.equal(general.view(torch.uint8), a.view(torch.uint8)):
                    fail("kv_permute_pages (K4's general entry) differs from kv_compact_tail "
                         "on a generator step")
                del general
                move_kv_rows(b4, page_tables, ctx + path.long(), ctx + 1 + i, valid)
                L, row = a.shape[0], a.shape[-1]
                for b in range(B):
                    if active is not None and not bool(active[b]):
                        continue
                    n = int(ctx_lens[b]) + 1 + int(n_edges[b])
                    pt = page_tables[b].long()
                    got = a[:, pt].reshape(L, -1, row)[:, :n]
                    k17 = b4[:, pt].reshape(L, -1, row)[:, :n]
                    if not torch.equal(got.view(torch.uint8), k17.view(torch.uint8)):
                        fail(f"move_kv_rows (K17) differs from kv_compact_tail (K4) on a "
                             f"generator step (ctx {n - 1 - int(n_edges[b])}, "
                             f"{int(n_edges[b])} moves)")
            self.calls += 1
            self.moves += int(n_edges.sum())
            del before
            return out
        return hook


def _median_ms(xs) -> float:
    import numpy as np

    return float(np.median(xs)) * 1e3 if len(xs) else None


def phase_generator(pkg, cfg, spec, params, ar_stream) -> dict:
    """The host-trie ``LookaheadGenerator`` on phase 3's Llama-2-7B int4
    weights and 512-token prompt, native trie: hier lookahead (decoding
    length 63, branch 12, 256 tokens) and the same call without lookahead,
    strictly equal to each other and, over 128 tokens, to phase 3's AR
    stream; stream_generate (a fresh trie: the hier run's drafts again)
    yields the same tokens with K4's compaction entry held against K17 and
    K4's general entry on every verify step; par and one modes equal to AR
    over 64 tokens; batch_generate over 4 prompts, every row equal to its
    solo AR stream; in the stream run K16's step entry is held against its
    general entry at every layer-0 write (``RowWriteCheck``). K17's and the
    general entries' launches are these checks', counted apart from the
    path's."""
    import numpy as np
    import torch

    gen_mod, config = pkg["generate"], pkg["config"]
    launches = Launches(pkg)
    prompt = np.random.default_rng(SEED).integers(10, cfg.vocab_size - 10,
                                                  PROMPT_LEN).tolist()

    def generator(conc=1):
        ecfg = config.EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=conc,
                                   prefill_chunk=512, eos_token_id=-2,
                                   decoding_length=GEN_DECODING_LENGTH,
                                   branch_length=GEN_BRANCH_LENGTH, decoding_mode="hier")
        gen = gen_mod.LookaheadGenerator(params, cfg, ecfg, quant=spec)
        if not isinstance(gen.trie, pkg["native"].NativeDraftCache):
            fail(f"the generator drafts from {type(gen.trie).__name__}, not the native trie")
        return gen

    def timed(gen, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(prompt, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    la, la_s = timed(generator(), max_new_tokens=GEN_TOKENS, use_lookahead=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ar, ar_s = timed(generator(), max_new_tokens=GEN_TOKENS, use_lookahead=False)
    path_counts = launches.read()

    def stats(out, wall):
        return dict(tokens=len(out.sequences), wall_s=wall, tok_s=len(out.sequences) / wall,
                    steps=len(out.edls) - 1, mean_edls=float(np.mean(out.edls[1:])),
                    mean_dls=float(np.mean(out.dls[1:])), max_edls=max(out.edls),
                    prefill_ms=out.fts[0] * 1e3, median_fts_ms=_median_ms(out.fts[1:]),
                    median_qts_ms=_median_ms(out.qts[1:]))

    res = dict(hier=stats(la, la_s), ar=stats(ar, ar_s), peak_mem_gb=peak_gb,
               decoding_length=GEN_DECODING_LENGTH, branch_length=GEN_BRANCH_LENGTH)
    n_ar = min(len(ar_stream), 128)
    res["lookahead_equals_ar"] = la.sequences == ar.sequences
    res["equals_phase3_ar_128"] = (la.sequences[:n_ar] == ar_stream[:n_ar]
                                   and ar.sequences[:n_ar] == ar_stream[:n_ar])

    # stream_generate on a fresh trie, K4's compaction entry held against K17
    # and K4's general entry at every verify step
    check, write_check = CompactionCheck(pkg), RowWriteCheck(pkg)
    check.install()
    write_check.install()
    launches.reset()
    try:
        pieces = list(generator().stream_generate(prompt, max_new_tokens=GEN_TOKENS,
                                                  use_lookahead=True))
    finally:
        write_check.remove()
        check.remove()
    check_counts = launches.read()
    res["stream_equals_generate"] = pieces == la.sequences
    res["compaction_check"] = dict(compactions=check.calls, moves=check.moves)
    res["row_write_check"] = dict(layer0_writes=write_check.calls)

    # par and one modes, and the batch
    gen = generator(GEN_BATCH)
    launches.reset()
    for mode in ("par", "one"):
        out, wall = timed(gen, max_new_tokens=GEN_MODE_TOKENS, use_lookahead=True,
                          decoding_mode=mode)
        res[mode] = dict(stats(out, wall),
                         equals_ar=out.sequences == ar.sequences[:GEN_MODE_TOKENS])
    rng = np.random.default_rng(SEED + 2)
    prompts = [prompt] + [rng.integers(10, cfg.vocab_size - 10, n).tolist()
                          for n in (384, 256, 128)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = gen.batch_generate(prompts, max_new_tokens=GEN_MODE_TOKENS)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    more = launches.read()
    path_counts = {k: v + more[k] for k, v in path_counts.items()}
    solo = [gen.generate(p, max_new_tokens=GEN_MODE_TOKENS, use_lookahead=False).sequences
            for p in prompts]
    res["batch"] = dict(rows=GEN_BATCH, wall_s=batch_s,
                        tok_s=sum(len(o.sequences) for o in batch) / batch_s,
                        mean_edls=float(np.mean([e for o in batch for e in o.edls[1:]])),
                        rows_equal_solo=[o.sequences == s_ for o, s_ in zip(batch, solo)])
    # the stream run's launches are the path's, but for K17's and K4's and
    # K16's general entries' (the checks')
    checked = {k: check_counts.pop(k) for k in CHECK_ONLY}
    res["launches"] = {k: v + check_counts.get(k, 0) for k, v in path_counts.items()}
    res["launches"].update({k: 0 for k in CHECK_ONLY})
    res["check_launches"] = dict({k: 0 for k in path_counts}, **checked)
    print("phase generator: " + json.dumps(res))
    if not (res["lookahead_equals_ar"] and res["equals_phase3_ar_128"]):
        fail("generator: hier lookahead, the generator's AR and phase 3's AR stream differ")
    if not res["stream_equals_generate"]:
        fail("generator: stream_generate yielded other tokens than generate")
    if not (res["par"]["equals_ar"] and res["one"]["equals_ar"]):
        fail("generator: par or one mode differs from AR")
    if not all(res["batch"]["rows_equal_solo"]):
        fail(f"generator: batch rows differ from their solo streams "
             f"{res['batch']['rows_equal_solo']}")
    if check.calls <= 0 or check.moves <= 0:
        fail("generator: the compaction check saw no compaction that moved a row")
    if write_check.calls <= 0:
        fail("generator: the row write check saw no write")
    need = ("kv_write_step", "kv_compact_tail", "int4_gemm", "paged_attention[verify]",
            "paged_attention[decode]", "paged_attention_prefill")
    if any(res["launches"][k] <= 0 for k in need):
        fail(f"generator: launches {res['launches']} (needed {need})")
    return res


# ---------------------------------------------------------------------------
# sampling: the sampler on the card, sampled lookahead against sampled AR at
# Llama-2-7B int4, scoring, the schedulers and the HTTP server
# ---------------------------------------------------------------------------

SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.95, min_p=0.0)
SAMPLE_SEED = 1234
SAMPLE_TOKENS = 128
# (temperature, top_k, top_p, min_p) of the row-invariance check
SAMPLER_SETTINGS = ((0.8, 50, 0.95, 0.0), (1.0, 0, 1.0, 0.0), (0.7, 0, 0.9, 0.05),
                    (1.3, 1, 1.0, 0.0), (1.0, 0, 0.5, 0.0), (0.0, 0, 1.0, 0.0))
SCORE_TARGETS = 64


def _samp_args(B) -> dict:
    """The decode loops' sampling keyword arrays (SAMPLE), on the card."""
    import torch

    return dict(temperature=torch.full((B,), SAMPLE["temperature"], device="cuda"),
                top_k=torch.full((B,), SAMPLE["top_k"], dtype=torch.int32, device="cuda"),
                top_p=torch.full((B,), SAMPLE["top_p"], device="cuda"),
                min_p=torch.full((B,), SAMPLE["min_p"], device="cuda"),
                seeds=torch.full((B,), SAMPLE_SEED, dtype=torch.int32, device="cuda"))


def verify_logits(pkg, cfg, spec, params, B=8, prompt_len=64, R=2, L=8):
    """The LM head's fp32 logits of one verify step at Q = 1 + R*L over B
    requests of ``prompt_len`` random prompt tokens and random drafts, as
    [B * Q, V] rows."""
    import numpy as np
    import torch

    step, base, dt = pkg["step"], pkg["base"], pkg["device_tables"]
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=prompt_len + 128,
                                      max_concurrency=B)
    kv = pkg["cache"].init_kv_cache(cfg, ecfg)
    P = ecfg.pages_per_req
    pt = torch.arange(1, 1 + B * P, dtype=torch.int32, device="cuda").reshape(B, P)
    rng = np.random.default_rng(SEED + 2)
    toks = torch.tensor(rng.integers(10, cfg.vocab_size - 10, (B, prompt_len)),
                        dtype=torch.int32, device="cuda")
    ctx = torch.full((B,), prompt_len, dtype=torch.int32, device="cuda")
    kv, nxt, _ = step.prefill_step(params, kv, cfg, toks, torch.zeros_like(ctx), ctx, pt, spec)
    branches = torch.tensor(rng.integers(10, cfg.vocab_size - 10, (B, R, L)),
                            dtype=torch.int32, device="cuda")
    tokens, parents, qmask, depth = dt.build_tree_inputs(nxt, branches)
    h, kv = base.transformer_hidden(params, cfg, kv, tokens, ctx[:, None] + depth, pt, ctx,
                                    qmask, parents > -2, spec)
    return base.logits_from_hidden(params, cfg, h, spec).reshape(B * (1 + R * L), -1)


def sampler_invariance(pkg, logits) -> dict:
    """Each row's filtered logits and drawn token, bit for bit, alone,
    inside 17 rows and inside all rows, at every setting of
    SAMPLER_SETTINGS; draws inside the filter; temperature 0 the argmax."""
    import torch

    sm = pkg["sample"]
    n = logits.shape[0]
    seeds = torch.arange(n, dtype=torch.int32, device="cuda") * 7919 + 11
    pos = torch.arange(n, dtype=torch.int32, device="cuda") + PROMPT_LEN
    out = {}
    for t, k, p, m in SAMPLER_SETTINGS:
        arrs = (torch.full((n,), t, device="cuda"),
                torch.full((n,), k, dtype=torch.int32, device="cuda"),
                torch.full((n,), p, device="cuda"), torch.full((n,), m, device="cuda"))
        x_all = sm.filtered_logits(logits, *arrs)
        s_all = sm.sample_tokens_at(logits, seeds, pos, *arrs)
        bad = []
        for lo, width in [(r, 1) for r in range(n)] + [(r, 17) for r in range(0, n, 17)]:
            sl = slice(lo, lo + width)
            x = sm.filtered_logits(logits[sl], *(a[sl] for a in arrs))
            s = sm.sample_tokens_at(logits[sl], seeds[sl], pos[sl], *(a[sl] for a in arrs))
            if not (torch.equal(x, x_all[sl]) and torch.equal(s, s_all[sl])):
                bad.append((lo, width))
        if bad:
            fail(f"sampling: rows {bad[:8]} differ from the {n}-row call at setting "
                 f"{(t, k, p, m)}")
        if not bool((torch.gather(x_all, 1, s_all.long()[:, None]) > -1e29).all()):
            fail(f"sampling: a draw outside the filter at setting {(t, k, p, m)}")
        if t <= 0 and not torch.equal(s_all, torch.argmax(logits, dim=1).to(torch.int32)):
            fail("sampling: a temperature-0 row did not take the argmax")
        kept = (x_all > -1e29).sum(dim=1)
        out[f"t{t}_k{k}_p{p}_m{m}"] = dict(kept_median=int(kept.median()),
                                          distinct_tokens=int(torch.unique(s_all).numel()))
    return out


def root_row_check(pkg, cfg, spec, params, prompt, R=1, L=16) -> None:
    """The verify root's fp32 logits row at Q = 1 + R*L equals the AR
    step's row on the same arena contents, bit for bit (B = 1)."""
    import numpy as np
    import torch

    step, base, dt = pkg["step"], pkg["base"], pkg["device_tables"]
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=1)
    kv = pkg["cache"].init_kv_cache(cfg, ecfg)
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    ctx = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    kv, nxt, _ = step.prefill_step(params, kv, cfg, toks, torch.zeros_like(ctx), ctx, pt, spec)
    kv2 = {k: v.clone() for k, v in kv.items()}
    one = torch.ones((1, 1), dtype=torch.bool, device="cuda")
    h, _ = base.transformer_hidden(params, cfg, kv, nxt[:, None], ctx[:, None], pt, ctx,
                                   one[:, :, None], one, spec)
    ar_row = base.logits_from_hidden(params, cfg, h, spec)[0, 0]
    rng = np.random.default_rng(SEED + 3)
    branches = torch.tensor(rng.integers(10, cfg.vocab_size - 10, (1, R, L)),
                            dtype=torch.int32, device="cuda")
    tokens, parents, qmask, depth = dt.build_tree_inputs(nxt, branches)
    h, _ = base.transformer_hidden(params, cfg, kv2, tokens, ctx[:, None] + depth, pt, ctx,
                                   qmask, parents > -2, spec)
    root = base.logits_from_hidden(params, cfg, h, spec)[0, 0]
    if not torch.equal(root, ar_row):
        d = (root - ar_row).abs()
        fail(f"sampling: the verify root's logits row differs from the AR step's in "
             f"{int((d > 0).sum())} of {d.numel()} entries (max {float(d.max()):.3g})")


def sampled_main_path(pkg, cfg, spec, params) -> dict:
    """Sampled AR over SAMPLE_TOKENS tokens at B = 1, then sampled lookahead
    (Q = 17) from a fresh prefill with the tables seeded with the AR stream:
    the streams must be equal, with drafts accepted."""
    import numpy as np
    import torch

    step, ms_mod, dt, sm = pkg["step"], pkg["multistep"], pkg["device_tables"], pkg["sample"]
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=1)
    tcfg = dt.DraftTableConfig(buckets=16384, ways=8, branch_length=16, retrieve_count=1)
    TAIL = tcfg.branch_length + 2
    prompt = np.random.default_rng(SEED).integers(10, cfg.vocab_size - 10, PROMPT_LEN)
    prompt_t = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    ctx0 = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    samp = _samp_args(1)

    def prefill():
        kv = pkg["cache"].init_kv_cache(cfg, ecfg)
        kv, _, logits = step.prefill_step(params, kv, cfg, prompt_t, torch.zeros_like(ctx0),
                                          ctx0, pt, spec)
        first = sm.sample_tokens_at(logits, samp["seeds"], ctx0, samp["temperature"],
                                    samp["top_k"], samp["top_p"], samp["min_p"])
        return kv, first, logits

    kv, first, logits1 = prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv, toks, _, _, _, _ = ms_mod.multistep_decode(params, kv, cfg, first, ctx0, one, pt,
                                                   n_steps=SAMPLE_TOKENS - 1, spec=spec,
                                                   **samp)
    ar = [int(first[0])] + toks[0].tolist()
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    del kv
    kv, first2, _ = prefill()
    if int(first2[0]) != ar[0]:
        fail("sampling: the first sampled token differs between two prefills")
    tables = dt.init_draft_tables(tcfg)
    seq = prompt.tolist() + ar
    dt.update_tables_seq(tables, tcfg, torch.tensor(seq, dtype=torch.int32, device="cuda"),
                         len(seq))
    tail_seed = torch.tensor([seq[PROMPT_LEN + 1 - TAIL: PROMPT_LEN + 1]], dtype=torch.int32,
                             device="cuda")
    tail = tail_seed.clone()
    stream, steps, accs = [ar[0]], 0, []
    last, ctx, act = first2, ctx0, one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(stream) < SAMPLE_TOKENS and steps < 4 * SAMPLE_TOKENS:
        budget = torch.tensor([SAMPLE_TOKENS - len(stream)], dtype=torch.int32, device="cuda")
        kv, tables, out, acc, last, ctx, act, tail, _ = ms_mod.multistep_spec_decode(
            params, kv, tables, cfg, tcfg, last, ctx, act, tail, pt, n_steps=SPEC_CHUNK,
            spec=spec, budget=budget, **samp)
        out, acc = out[0].tolist(), acc[0].tolist()
        for si in range(SPEC_CHUNK):
            stream.extend(out[si][: acc[si]])
            if acc[si]:
                accs.append(acc[si])
        steps += SPEC_CHUNK
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    n = min(len(ar), len(stream))
    div = next((i for i in range(n) if ar[i] != stream[i]), n)
    res = dict(ar_tok_s=(SAMPLE_TOKENS - 1) / ar_s, spec_tok_s=(len(stream) - 1) / spec_s,
               accepted_per_step=(len(stream) - 1) / max(len(accs), 1),
               verify_steps=len(accs), steps_with_a_draft_accepted=sum(a > 1 for a in accs),
               max_accepted=max(accs, default=0), tokens=len(stream), first_divergence=div,
               first_token_is_argmax=int(torch.argmax(logits1[0])) == ar[0])
    if div != SAMPLE_TOKENS or len(stream) != SAMPLE_TOKENS:
        fail(f"sampling: sampled lookahead differs from sampled AR at token {div} "
             f"(lookahead {len(stream)} tokens)")
    if res["steps_with_a_draft_accepted"] == 0:
        fail("sampling: no verify step accepted a draft token: the check is empty")
    # a step's wall, greedy against sampled, in turns (g, s, s, g), each
    # from a fresh prefill: 32 AR steps, and 16 lookahead steps on the same
    # frozen tables (drafts land only on the sampled stream)
    def step_ms(kind, sampled):
        kv, f, _ = prefill()
        kw = samp if sampled else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "ar":
            ms_mod.multistep_decode(params, kv, cfg, f, ctx0, one, pt, n_steps=32, spec=spec,
                                    **kw)
            n = 32
        else:
            ms_mod.multistep_spec_decode(params, kv, tables, cfg, tcfg, f, ctx0, one,
                                         tail_seed.clone(), pt, n_steps=16, spec=spec,
                                         update_tables=False, **kw)
            n = 16
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    for kind in ("ar", "spec"):
        turns = [step_ms(kind, s) for s in (False, True, True, False)]
        res[f"{kind}_step_ms_greedy"] = [turns[0], turns[3]]
        res[f"{kind}_step_ms_sampled"] = [turns[1], turns[2]]
    # the sampler's wall a call (host clock over calls ending in a sync)
    rows17 = verify_logits(pkg, cfg, spec, params, B=1, prompt_len=PROMPT_LEN)
    for n_rows, lg in ((1, logits1), (17, rows17)):
        a = _samp_args(n_rows)
        pos = torch.arange(n_rows, dtype=torch.int32, device="cuda") + PROMPT_LEN
        res[f"sampler_ms_{n_rows}_rows"] = _host_ms(lambda: sm.sample_tokens_at(
            lg, a["seeds"], pos, a["temperature"], a["top_k"], a["top_p"], a["min_p"]),
            reps=20)
    return res


def sampling_requests(pkg, vocab: int) -> list:
    """serving_prompts' 16 requests as (prompt, SamplingParams or None,
    target_ids or None): the odd ones sampled with their own seeds, 0 and 3
    under a repetition penalty of 1.2, 4 and 6 scoring 64 target tokens;
    24-48 new tokens, so requests finish apart and later ones are admitted
    beside decoding rows (which the mix policy carries in its prefill
    batches)."""
    import numpy as np

    SP = pkg["request"].SamplingParams
    rng = np.random.default_rng(SEED + 4)
    out = []
    for i, p in enumerate(serving_prompts(vocab)):
        if i in (4, 6):
            out.append((p, None, rng.integers(10, vocab - 10, SCORE_TARGETS).tolist()))
            continue
        kw = dict(max_new_tokens=SERVE_NEW_TOKENS - 8 * (i % 4))
        if i % 2:
            kw.update(temperature=SAMPLE["temperature"], top_k=SAMPLE["top_k"],
                      top_p=SAMPLE["top_p"], seed=1000 + i)
        if i in (0, 3):
            kw.update(repetition_penalty=1.2)
        out.append((p, SP(**kw), None))
    return out


def sampling_llm(pkg, cfg, params, policy: str, lookahead: bool):
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=8, prefill_chunk=512,
              quant="int4", eos_token_id=-2, prefix_cache=True, decode_burst=8,
              decode_burst_idle=32, schedule_policy=policy)
    if lookahead:
        kw.update(use_lookahead=True, decoding_length=16, branch_length=16,
                  use_spec_min_batch_size=8)
    return pkg["llm"].LLM(cfg=cfg, params=params, ecfg=pkg["config"].EngineConfig(**kw))


def direct_scores(pkg, cfg, params, reqs) -> list:
    """Each scoring request's target logprobs from one score_step call on a
    fresh arena (its prompt + targets in one 512-token chunk)."""
    import numpy as np
    import torch

    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=1)
    spec = pkg["linear"].QuantSpec(bits=4, group=128)
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = []
    for p, sp, tg in reqs:
        if sp is not None:
            continue
        full = p + tg
        buf = np.zeros((1, 512), np.int32)
        buf[0, : len(full)] = full
        _, lp = pkg["step"].score_step(
            params, pkg["cache"].init_kv_cache(cfg, ecfg), cfg,
            torch.tensor(buf, device="cuda"), zero,
            torch.tensor([len(full)], dtype=torch.int32, device="cuda"), pt, spec, zero)
        lp = lp[0].cpu().tolist()
        out.append([lp[len(p) - 1 + i] for i in range(len(tg))])
    return out


def sampled_serving(pkg, cfg, params) -> dict:
    """The 16 requests under pingpong, mix and timely, each with AR and
    with lookahead: every generated stream the same in all six runs, every
    score bit-equal to a direct score_step call."""
    import torch

    reqs = sampling_requests(pkg, cfg.vocab_size)
    runs, streams, scores = [], [], []
    for policy in ("pingpong", "mix", "timely"):
        for lookahead in (False, True):
            torch.cuda.synchronize()
            llm = sampling_llm(pkg, cfg, params, policy, lookahead)
            t0 = time.perf_counter()
            # eight at once, then one more after each scheduler step: later
            # requests arrive while earlier ones decode
            handles = [llm.add_request(p, sp, target_ids=tg) for p, sp, tg in reqs[:8]]
            while any(r.state != "finished" for r in handles) or len(handles) < len(reqs):
                llm.step()
                if len(handles) < len(reqs):
                    p, sp, tg = reqs[len(handles)]
                    handles.append(llm.add_request(p, sp, target_ids=tg))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = llm.metrics
            pairs = list(zip(handles, reqs))
            gen = [r.output_ids for r, (_, sp, _) in pairs if sp is not None]
            sc = [(r.finish_reason, r.target_logprobs) for r, (_, sp, _) in pairs if sp is None]
            what = f"sampling serving {policy} lookahead={lookahead}"
            if any(len(r.output_ids) != sp.max_new_tokens for r, (_, sp, _) in pairs
                   if sp is not None):
                fail(f"{what}: a request stopped early")
            if any(f != "score" or len(lp) != SCORE_TARGETS for f, lp in sc):
                fail(f"{what}: a scoring request finished as {[f for f, _ in sc]}")
            run = dict(policy=policy, lookahead=lookahead, wall_s=wall,
                       tok_s=m.generated_tokens / wall, p50_ttft_s=m.p50_ttft,
                       spec_steps=m.spec_steps, spec_accepted=m.spec_accepted,
                       decode_steps=m.decode_steps, mixed_rows=m.mixed_rows,
                       prefix_hit_tokens=m.prefix_hit_tokens)
            print("phase sampling serving run: " + json.dumps(run))
            if lookahead and m.spec_steps <= 0:
                fail(f"{what}: no spec step")
            if (policy == "mix") != (m.mixed_rows > 0):
                fail(f"{what}: {m.mixed_rows} decode rows rode in prefill batches")
            runs.append(run)
            streams.append(gen)
            scores.append([lp for _, lp in sc])
            del llm, handles, pairs
    for k in range(1, len(streams)):
        if streams[k] != streams[0]:
            i = next(j for j, (a, b) in enumerate(zip(streams[0], streams[k])) if a != b)
            fail(f"sampling serving: {runs[k]['policy']} lookahead={runs[k]['lookahead']} "
                 f"differs from pingpong AR on generated request {i}")
    if any(s != scores[0] for s in scores):
        fail("sampling serving: the scores differ between runs")
    direct = direct_scores(pkg, cfg, params, reqs)
    if direct != scores[0]:
        fail("sampling serving: the engine's scores differ from direct score_step calls")
    sampled = sum(1 for _, sp, _ in reqs if sp is not None and sp.temperature > 0)
    return dict(runs=runs, streams=streams[0], requests=len(reqs), sampled=sampled,
                scored=len(direct), score_sums=[float(sum(s)) for s in direct])


def server_check(pkg, cfg, params, streams) -> dict:
    """StdlibServer on an ephemeral port over an LLM: four concurrent
    streaming clients, two greedy and two sampled, get the tokens of the
    same requests in the serving runs and of llm.generate."""
    import threading

    reqs = sampling_requests(pkg, cfg.vocab_size)
    gen_idx = [i for i, (_, sp, _) in enumerate(reqs) if sp is not None]
    pick = [2, 8, 1, 5]  # greedy, greedy, sampled, sampled
    llm = sampling_llm(pkg, cfg, params, "pingpong", False)
    srv = pkg["server"].StdlibServer(llm, host="127.0.0.1", port=0)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    got, errors = {}, {}

    def go(i):
        p, sp, _ = reqs[i]
        body = dict(temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
                    min_p=sp.min_p, seed=sp.seed, repetition_penalty=sp.repetition_penalty)
        try:
            got[i] = [c["token"] for c in pkg["client"].stream_generate(
                url, input_ids=p, max_new_tokens=sp.max_new_tokens, timeout=120, **body)]
        except Exception as e:  # noqa: BLE001 - reported below, fails the run
            errors[i] = repr(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(i,)) for i in pick]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    srv.stop()
    if errors or any(t.is_alive() for t in threads):
        fail(f"sampling server: client errors {errors}")
    direct = {i: llm.generate([reqs[i][0]], reqs[i][1])[0].output_ids for i in pick}
    for i in pick:
        if got.get(i) != direct[i] or got[i] != streams[gen_idx.index(i)]:
            fail(f"sampling server: request {i}'s stream differs from llm.generate's or the "
                 "serving runs'")
    return dict(clients=len(pick), wall_s=wall, tokens=sum(len(v) for v in got.values()))


def phase_sampling(pkg, cfg, spec, params) -> dict:
    """The sampler's row invariance on the card's own logits, the verify
    root row against the AR row, sampled lookahead == sampled AR at full
    width and depth, the 16 serving requests (sampled, penalized, scored)
    under every policy with and without lookahead, and the HTTP server;
    the kernels' launches counted from 0."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    launches = Launches(pkg)
    launches.reset()
    logits = verify_logits(pkg, cfg, spec, params)
    inv = sampler_invariance(pkg, logits)
    print("phase sampling rows: " + json.dumps(dict(rows=int(logits.shape[0]), settings=inv)))
    del logits
    prompt = np.random.default_rng(SEED).integers(10, cfg.vocab_size - 10, PROMPT_LEN)
    root_row_check(pkg, cfg, spec, params, prompt.tolist())
    print(f"phase sampling root row: the verify root's logits row equals the AR step's "
          f"({cfg.num_hidden_layers} layers, Q = 17)")
    main = sampled_main_path(pkg, cfg, spec, params)
    print("phase sampling main path: " + json.dumps(main))
    cfg8, params8 = first_layers(cfg, params, SERVE_LAYERS)
    serve = sampled_serving(pkg, cfg8, params8)
    srv = server_check(pkg, cfg8, params8, serve.pop("streams"))
    print("phase sampling server: " + json.dumps(srv))
    res = dict(rows=inv, main_path=main, serving=serve, server=srv, launches=launches.read(),
               wall_s=time.perf_counter() - t_phase)
    print(f"phase sampling: wall {res['wall_s']:.1f} s, " + json.dumps(
        dict(requests=serve["requests"], sampled=serve["sampled"], scored=serve["scored"],
             score_sums=serve["score_sums"])))
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase hf: local HF checkpoints through LLM(model_path=...), text prompts
# ---------------------------------------------------------------------------

HF_LAYERS = 2  # depth cut; every width is the published one
HF_SHARDS = 2
HF_NEW_TOKENS = 48
HF_CHECK_TOKENS = 16  # the ALiBi check pass: 4 requests of this many tokens


def _normal(rng, shape, std=0.02, mean=0.0):
    """bf16 tensor of N(mean, std) on the host: drawn with numpy (fp32, in
    place) from a numpy Generator, or on the card from a torch.Generator
    there."""
    import numpy as np
    import torch

    if isinstance(rng, torch.Generator):
        a = torch.randn(shape, generator=rng, device=rng.device) * std
        if mean:
            a += mean
        return a.to(torch.bfloat16).cpu()
    a = rng.standard_normal(shape, dtype=np.float32)
    a *= std
    if mean:
        a += mean
    return torch.from_numpy(a).to(torch.bfloat16)


def hf_llama_checkpoint(rng) -> tuple:
    """(config.json, tensors) of a LlamaForCausalLM at Llama-2-7B's widths
    (meta-llama/Llama-2-7b-hf's config.json: hidden 4096, 32 heads,
    intermediate 11008, vocab 32000) and HF_LAYERS layers, bf16."""
    E, I, V, H = 4096, 11008, 32000, 32
    conf = dict(architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=V,
                hidden_size=E, intermediate_size=I, num_hidden_layers=HF_LAYERS,
                num_attention_heads=H, num_key_value_heads=H, rms_norm_eps=1e-5,
                rope_theta=10000.0, max_position_embeddings=4096,
                tie_word_embeddings=False, torch_dtype="bfloat16")
    t = {"model.embed_tokens.weight": _normal(rng, (V, E))}
    for i in range(HF_LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = _normal(rng, (E,), 0.05, 1.0)
        for n in "qkvo":
            t[p + f"self_attn.{n}_proj.weight"] = _normal(rng, (E, E))
        t[p + "post_attention_layernorm.weight"] = _normal(rng, (E,), 0.05, 1.0)
        t[p + "mlp.gate_proj.weight"] = _normal(rng, (I, E))
        t[p + "mlp.up_proj.weight"] = _normal(rng, (I, E))
        t[p + "mlp.down_proj.weight"] = _normal(rng, (E, I))
    t["model.norm.weight"] = _normal(rng, (E,), 0.05, 1.0)
    t["lm_head.weight"] = _normal(rng, (V, E))
    return conf, t


def hf_bloom_checkpoint(rng, E=4096, H=32) -> tuple:
    """(config.json, tensors) of a BloomForCausalLM at bigscience/bloom-7b1's
    widths (its config.json: hidden 4096, n_head 32, vocab 250880, layer
    norm eps 1e-5; ALiBi, the embedding LayerNorm, biases everywhere, a
    4 x hidden gelu MLP and the head tied to the embedding), or at hidden
    ``E`` over ``H`` heads (bigscience/bloom-1b1: 1536 over 16 heads of 96
    lanes), and HF_LAYERS layers, bf16."""
    V = 250880
    conf = dict(architectures=["BloomForCausalLM"], model_type="bloom", vocab_size=V,
                hidden_size=E, n_layer=HF_LAYERS, n_head=H, layer_norm_epsilon=1e-5,
                apply_residual_connection_post_layernorm=False, hidden_dropout=0.0,
                attention_dropout=0.0, offset_alibi=100, pretraining_tp=1,
                torch_dtype="bfloat16")
    t = {"transformer.word_embeddings.weight": _normal(rng, (V, E))}

    def norm(name):
        t[name + ".weight"] = _normal(rng, (E,), 0.05, 1.0)
        t[name + ".bias"] = _normal(rng, (E,), 0.02)

    def lin(name, dout, din):
        t[name + ".weight"] = _normal(rng, (dout, din))
        t[name + ".bias"] = _normal(rng, (dout,), 0.02)

    norm("transformer.word_embeddings_layernorm")
    for i in range(HF_LAYERS):
        p = f"transformer.h.{i}."
        norm(p + "input_layernorm")
        lin(p + "self_attention.query_key_value", 3 * E, E)
        lin(p + "self_attention.dense", E, E)
        norm(p + "post_attention_layernorm")
        lin(p + "mlp.dense_h_to_4h", 4 * E, E)
        lin(p + "mlp.dense_4h_to_h", E, 4 * E)
    norm("transformer.ln_f")
    return conf, t


def load_bpe():
    """The repository's BPE tokenizer (benchmarks/bpe.py, trained on
    benchmarks/corpus.txt); it imports neither JAX nor the JAX package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bpe", HERE / "benchmarks" / "bpe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_default()


def hf_prompts() -> list:
    """16 text prompts cut from benchmarks/corpus.txt at word boundaries,
    300-1500 characters each (seeded)."""
    import numpy as np

    text = (HERE / "benchmarks" / "corpus.txt").read_text()
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(SERVE_REQUESTS):
        n = int(rng.integers(300, 1501))
        start = int(rng.integers(0, len(text) - n))
        start = text.find(" ", start) + 1
        out.append(text[start: start + n].rsplit(" ", 1)[0])
    return out


def _same_bytes(a, b) -> bool:
    import torch

    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.view(torch.uint8), b.to(a.device).view(torch.uint8))


def check_loaded(pkg, name, params, t, quant) -> int:
    """The loaded leaves against the arrays written, byte for byte: native
    leaves as written (transposed, q|k|v regrouped), int4 leaves equal to
    ``quantize`` of the written weight on the card. Returns the leaves
    checked; fails the run on a difference."""
    import torch

    lin = pkg["linear"]
    spec = lin.QuantSpec.from_mode(quant)

    def want_lin(w_out_in):
        w = w_out_in.cuda().t().contiguous()
        return w if spec is None else lin.quantize(w, spec)

    def same(got, want, what):
        pairs = [(got[k], want[k]) for k in want] if isinstance(want, dict) else [(got, want)]
        if not all(_same_bytes(g, w) for g, w in pairs):
            fail(f"phase hf {name}: loaded {what} differs from the checkpoint's")

    L = params["layers"]
    n = 0
    if name.startswith("llama"):
        same(params["embed"], t["model.embed_tokens.weight"], "embed")
        same(params["final_ln"], t["model.norm.weight"], "final_ln")
        same(params["lm_head"], want_lin(t["lm_head.weight"]), "lm_head")
        n += 3
        for i in range(HF_LAYERS):
            p = f"model.layers.{i}."
            qkv = torch.cat([t[p + f"self_attn.{c}_proj.weight"] for c in "qkv"])
            for key, want in (("input_ln", t[p + "input_layernorm.weight"]),
                              ("post_ln", t[p + "post_attention_layernorm.weight"]),
                              ("wqkv", want_lin(qkv)),
                              ("wo", want_lin(t[p + "self_attn.o_proj.weight"])),
                              ("wgu", want_lin(torch.cat([t[p + "mlp.gate_proj.weight"],
                                                          t[p + "mlp.up_proj.weight"]]))),
                              ("wdown", want_lin(t[p + "mlp.down_proj.weight"]))):
                leaf = L[key]
                got = {k: v[i] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[i]
                same(got, want, f"layer {i} {key}")
                n += 1
        return n
    pre = "transformer."
    for key, src in (("embed", "word_embeddings.weight"),
                     ("embed_ln", "word_embeddings_layernorm.weight"),
                     ("embed_ln_b", "word_embeddings_layernorm.bias"),
                     ("final_ln", "ln_f.weight"), ("final_ln_b", "ln_f.bias")):
        same(params[key], t[pre + src], key)
        n += 1
    E, H = 4096, 32
    D = E // H
    for i in range(HF_LAYERS):
        p = pre + f"h.{i}."
        w = t[p + "self_attention.query_key_value.weight"].reshape(H, 3, D, E)
        b = t[p + "self_attention.query_key_value.bias"].reshape(H, 3, D)
        for key, want in (
                ("wqkv", want_lin(torch.cat([w[:, c].reshape(H * D, E) for c in range(3)]))),
                ("bqkv", torch.cat([b[:, c].reshape(-1) for c in range(3)])),
                ("wo", want_lin(t[p + "self_attention.dense.weight"])),
                ("bo", t[p + "self_attention.dense.bias"]),
                ("wgu", want_lin(t[p + "mlp.dense_h_to_4h.weight"])),
                ("bgu", t[p + "mlp.dense_h_to_4h.bias"]),
                ("wdown", want_lin(t[p + "mlp.dense_4h_to_h.weight"])),
                ("bdown", t[p + "mlp.dense_4h_to_h.bias"]),
                ("input_ln", t[p + "input_layernorm.weight"]),
                ("input_ln_b", t[p + "input_layernorm.bias"]),
                ("post_ln", t[p + "post_attention_layernorm.weight"]),
                ("post_ln_b", t[p + "post_attention_layernorm.bias"])):
            same(L[key][i], want, f"layer {i} {key}")
            n += 1
    return n


class AlibiCheck(LaunchHooks):
    """While installed, every paged-attention launch with ALiBi slopes is
    held, right after it, against the plain version on the same inputs (the
    model's own q, arena layer, page tables, masks and slopes); fails the
    run beyond rel 2e-2. The launches are the run's own, with the
    positions the model gives the step's keys (a tree's node at ctx + its
    depth)."""

    def __init__(self, pkg):
        super().__init__(pkg)
        self.n, self.max_rel, self.kinds = 0, 0.0, {}

    def install(self):
        self._wrap([(self.pkg["paged_attention"], "_launch", self._hook)])

    def _hook(self, orig):
        ref_mod = self.pkg["attention"]

        def hook(wrapper, q, k, v, pt, ctx, qmask, scale, causal, arena, ks=None, vs=None,
                 alibi=None, alibi_pos=None, page_range=None, return_lse=False, window=None):
            out = orig(wrapper, q, k, v, pt, ctx, qmask, scale, causal, arena, ks, vs, alibi,
                       alibi_pos, page_range, return_lse, window)
            if alibi is not None:
                B, Q = q.shape[:2]
                qm = (self.pkg["paged_attention"].window_qmask(B, Q, ctx, window, "cuda")
                      if causal else qmask)
                _, rel = _errs(out, ref_mod.paged_attention_ref(
                    q, k, v, pt, ctx, qm, scale, ks, vs, alibi=alibi, alibi_pos=alibi_pos))
                kind = "decode" if Q == 1 else ("prefill" if causal else "verify")
                if not rel <= 2e-2:
                    fail(f"phase hf: an ALiBi {kind} launch (B={B}, Q={Q}) differs from its "
                         f"plain version: rel err {rel}")
                self.n += 1
                self.max_rel = max(self.max_rel, rel)
                self.kinds[kind] = self.kinds.get(kind, 0) + 1
            return out
        return hook


def check_later_branch(pkg, llm, ids, L=8) -> dict:
    """A tree verify of two branches of L over the prompt ``ids`` at the
    served model's width, a wrong draft on branch 0 and the AR continuation
    on branch 1, whose nodes sit at slots ctx + 1 + L + l but at positions
    ctx + 1 + l. Fails the run unless the root's and each branch-1 node's
    logits row carries the bits of the AR decode row at the same prefix
    (the keys sit at other slots; every op of the row is row-count
    invariant); reports the rel errors and the rows whose argmax is the AR
    token. With ALiBi (positions act nowhere
    else) the same verify with its keys at their slots' positions shows the
    bias that the positions repair (``slot_rule_max_rel_err``)."""
    import torch

    step, dt = pkg["step"], pkg["device_tables"]
    cfg, params, spec = llm.cfg, llm.params, llm.quant
    pt = torch.arange(1, 1 + llm.ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    toks = torch.tensor([ids], dtype=torch.int32, device="cuda")
    ctx = torch.full((1,), len(ids), dtype=torch.int32, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    kv, root, _ = step.prefill_step(params, llm.kv, cfg, toks, zero, ctx, pt, spec)
    rows, fed, last, c = [], [], root, ctx.clone()
    for _ in range(L + 1):  # AR: the root, then the L tokens it picks
        t, p, qm, par = step.decode_inputs(last, c)
        kv, logits, _ = step._verify_forward(params, kv, cfg, t, p, qm, par, pt, c, active,
                                             spec, None)
        rows.append(logits[0, 0])
        last = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        fed.append(last)
        c = c + 1
    ar = torch.stack(fed[:L], dim=1)
    tokens, parents, qmask, depth = dt.build_tree_inputs(
        root, torch.stack([(ar + 1) % cfg.vocab_size, ar], dim=1))
    kv, _, _ = step.prefill_step(params, kv, cfg, toks, zero, ctx, pt, spec)
    _, vl, _ = step._verify_forward(params, kv, cfg, tokens, ctx[:, None] + depth, qmask,
                                    parents, pt, ctx, active, spec, None)

    def rels(v):
        got = [v[0, 0]] + [v[0, 1 + L + i] for i in range(L)]
        return [_errs(a, b)[1] for a, b in zip(got, rows)], got

    rel, got = rels(vl)
    same = sum(int(torch.argmax(a)) == int(f[0]) for a, f in zip(got, fed))
    bits = [bool(torch.equal(a, b)) for a, b in zip(got, rows)]
    if not all(bits):
        fail(f"phase hf: a branch-1 node's verify logits are not the AR row's bits: "
             f"equal {bits}, rel err {rel}")
    out = dict(R=2, L=L, ctx=len(ids), rows=L + 1, max_rel_err=max(rel), rel_err_by_row=rel,
               argmax_equal=same, bit_equal=sum(bits))
    if cfg.position_embedding_type == "alibi":
        slots = ctx[:, None] + torch.arange(tokens.shape[1], device="cuda", dtype=torch.int32)
        kv, _, _ = step.prefill_step(params, kv, cfg, toks, zero, ctx, pt, spec)
        _, vs, _ = step._verify_forward(params, kv, cfg, tokens, slots, qmask, parents, pt,
                                        ctx, active, spec, None)
        out["slot_rule_max_rel_err"] = max(rels(vs)[0])
    return out


def serve_hf(pkg, path, quant, lookahead, prompts, tok, new_tokens=HF_NEW_TOKENS,
             **extra) -> tuple:
    """LLM(model_path=path) (its load timed; ``extra`` EngineConfig fields;
    with kv_quant "fp8" the static scales calibrated on the prompts) and one
    generate over the text prompts. Returns (llm, numbers, outputs)."""
    import torch

    config, llm_mod = pkg["config"], pkg["llm"]
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=8, prefill_chunk=512,
              quant=quant, eos_token_id=-2, decode_burst=8, decode_burst_idle=32, **extra)
    if lookahead:  # the default tree: 5 branches of 12 (Q = 61), unless extra says
        look = dict(use_lookahead=True, decoding_length=GEN_DECODING_LENGTH,
                    branch_length=GEN_BRANCH_LENGTH, use_spec_min_batch_size=8)
        kw.update({k: v for k, v in look.items() if k not in extra})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llm = llm_mod.LLM(model_path=path, ecfg=config.EngineConfig(**kw), tokenizer=tok)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if kw.get("kv_quant") == "fp8":
        llm.calibrate_kv_scales([llm.encode(p) for p in prompts])
    t0 = time.perf_counter()
    reqs = llm.generate(prompts, pkg["request"].SamplingParams(max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = llm.metrics
    outs = [r.output_ids for r in reqs]
    if any(len(o) != new_tokens for o in outs):
        fail(f"phase hf {path}: a request stopped early")
    return llm, dict(load_s=load_s, wall_s=wall, tok_s=m.generated_tokens / wall,
                     p50_ttft_s=m.p50_ttft, prefill_s=m.prefill_time,
                     spec_steps=m.spec_steps, spec_accepted=m.spec_accepted,
                     prompt_tokens=sum(len(llm.encode(p)) for p in prompts)), outs


def phase_hf(pkg) -> dict:
    """Two checkpoints at published widths and HF_LAYERS layers, written
    with the port's own write_safetensors in HF_SHARDS shards and an index
    (random bf16 weights from SEED, drawn on the card), loaded by LLM(model_path=...)
    and served with 16 text prompts (the repository's BPE tokenizer), AR
    and lookahead over the default tree (5 branches of 12): Llama-2-7B's
    LlamaForCausalLM keys in int4 (K1, K2 / K3 / K5, K15, K16, K4) and
    bigscience/bloom-7b1's BloomForCausalLM keys in bf16 (K10 for the
    linears and the tied head, K2 / K3 / K5 with ALiBi, K16, K4). Holds the
    reader's tensors and the loaded leaves byte-equal to the arrays
    written, the lookahead outputs equal to the AR outputs token for token
    (lossless_strict), a branch-1 tree node's logits against the AR step's
    (``check_later_branch``), and for BLOOM every ALiBi launch of an AR and
    a lookahead pass over 4 requests (fresh engines, no spec cooldown)
    against its plain version. Prints the load time and GB/s (a warm read:
    the files were just written), a B = 1 512-token prefill's ms and the AR
    and lookahead rates (random weights); the kernels' launches counted
    from 0."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    launches = Launches(pkg)
    launches.reset()
    tok = load_bpe()
    prompts = hf_prompts()
    st = pkg["safetensors"]
    res = {}
    for name, make, quant in (("llama2_7b_int4", hf_llama_checkpoint, "int4"),
                              ("bloom_7b1_bf16", hf_bloom_checkpoint, "none")):
        t0 = time.perf_counter()
        conf, tensors = make(torch.Generator(device="cuda").manual_seed(SEED))
        draw_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory(prefix="pia_hf_") as d:
            t0 = time.perf_counter()
            nbytes = st.write_checkpoint(d, tensors, conf, n_shards=HF_SHARDS)
            write_s = time.perf_counter() - t0
            got = st.read_safetensors(d)
            if set(got) != set(tensors) or not all(_same_bytes(got[k], tensors[k])
                                                   for k in tensors):
                fail(f"phase hf {name}: the reader's tensors differ from the arrays written")
            del got
            llm, ar, outs_ar = serve_hf(pkg, d, quant, False, prompts, tok)
            n_checked = check_loaded(pkg, name, llm.params, tensors, quant)
            ids = tok.encode((HERE / "benchmarks" / "corpus.txt").read_text())[:PROMPT_LEN]
            toks = torch.tensor([ids], dtype=torch.int32, device="cuda")
            pt = torch.arange(1, 1 + llm.ecfg.pages_per_req, dtype=torch.int32,
                              device="cuda")[None]
            zero = torch.zeros(1, dtype=torch.int32, device="cuda")
            full = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device="cuda")
            prefill_ms = time_ms(lambda: pkg["step"].prefill_step(
                llm.params, llm.kv, llm.cfg, toks, zero, full, pt, llm.quant), reps=5,
                warmup=1)
            branch = check_later_branch(pkg, llm, ids)
            del llm
            llm, la, outs_la = serve_hf(pkg, d, quant, True, prompts, tok)
            if outs_la != outs_ar:
                bad = [i for i, (a, b) in enumerate(zip(outs_ar, outs_la)) if a != b]
                fail(f"phase hf {name}: lookahead outputs differ from AR on requests {bad}")
            del llm
            alibi = None
            if name.startswith("bloom"):
                # a fresh engine without the spec gate's cooldown, so that
                # the pass verifies drafts whatever they accept
                check = AlibiCheck(pkg)
                check.install()
                try:
                    for spec in (False, True):  # AR bursts decode, lookahead verifies
                        llm, _, _ = serve_hf(pkg, d, quant, spec, prompts[:4], tok,
                                             HF_CHECK_TOKENS, spec_cooldown_bursts=0)
                        del llm
                finally:
                    check.remove()
                if set(check.kinds) != {"decode", "verify", "prefill"}:
                    fail(f"phase hf {name}: the ALiBi check saw launches {check.kinds}")
                alibi = dict(launches_held=check.n, by_kind=check.kinds,
                             max_rel_err=check.max_rel)
        res[name] = dict(
            checkpoint_gb=nbytes / 1e9, shards=HF_SHARDS, draw_s=draw_s, write_s=write_s,
            load_s=ar["load_s"], load_gb_s=nbytes / 1e9 / ar["load_s"],
            load_s_lookahead=la["load_s"], leaves_checked=n_checked,
            prefill_ms=prefill_ms, prompt_tokens=ar["prompt_tokens"],
            ar=ar, lookahead=la, lossless_strict=True, alibi_check=alibi,
            later_branch=branch)
        print(f"phase hf {name} (random weights, {HF_LAYERS} layers): " + json.dumps(res[name]))
        del tensors
        torch.cuda.empty_cache()
    res["launches"] = launches.read()
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"phase hf: wall {res['wall_s']:.1f} s on {smi_line()}")
    return res


# ---------------------------------------------------------------------------
# phase families: every family the port loads, served on the card
# ---------------------------------------------------------------------------

FAMILY_PROMPTS = 4  # text prompts a family serves
FAMILY_NEW_TOKENS = 16
FAMILY_MIN_PROMPT = 160  # BPE tokens a prompt has at least (GLM's window past 128 rows)


def hf_gptj_checkpoint(g) -> tuple:
    """(config.json, tensors) of a GPTJForCausalLM at EleutherAI/gpt-j-6b's
    widths (its config.json: n_embd 4096, n_head 16 of 256 lanes, rotary_dim
    64, n_inner null (4 x 4096), vocab 50400, the head with a bias) and
    HF_LAYERS layers, bf16."""
    E, V = 4096, 50400
    conf = dict(architectures=["GPTJForCausalLM"], model_type="gptj", vocab_size=V,
                n_embd=E, n_head=16, n_layer=HF_LAYERS, rotary_dim=64, n_inner=None,
                n_positions=2048, layer_norm_epsilon=1e-5, activation_function="gelu_new",
                tie_word_embeddings=False, torch_dtype="bfloat16")
    t = {"transformer.wte.weight": _normal(g, (V, E))}
    for i in range(HF_LAYERS):
        p = f"transformer.h.{i}."
        t[p + "ln_1.weight"] = _normal(g, (E,), 0.05, 1.0)
        t[p + "ln_1.bias"] = _normal(g, (E,))
        for n in "qkv":
            t[p + f"attn.{n}_proj.weight"] = _normal(g, (E, E))
        t[p + "attn.out_proj.weight"] = _normal(g, (E, E))
        t[p + "mlp.fc_in.weight"] = _normal(g, (4 * E, E))
        t[p + "mlp.fc_in.bias"] = _normal(g, (4 * E,))
        t[p + "mlp.fc_out.weight"] = _normal(g, (E, 4 * E))
        t[p + "mlp.fc_out.bias"] = _normal(g, (E,))
    t["transformer.ln_f.weight"] = _normal(g, (E,), 0.05, 1.0)
    t["transformer.ln_f.bias"] = _normal(g, (E,))
    t["lm_head.weight"] = _normal(g, (V, E))
    t["lm_head.bias"] = _normal(g, (V,))
    return conf, t


def hf_deepseek_checkpoint(g) -> tuple:
    """(config.json, tensors) of deepseek-ai/DeepSeek-V2-Lite at its widths
    (hidden 2048, 16 heads, kv_lora_rank 512, qk_nope 128 + qk_rope 64, v
    128, layer 0 dense (intermediate 10944), then 64 routed experts of 1408
    (top 6, softmax scores) and 2 shared, YaRN rope, vocab 102400) and
    HF_LAYERS layers, bf16; ``from_hf`` leaves it in expanded MLA mode."""
    E, V, H, I, MI, X, r = 2048, 102400, 16, 10944, 1408, 64, 512
    nope, rope_d, v_d = 128, 64, 128
    conf = dict(architectures=["DeepseekV2ForCausalLM"], model_type="deepseek_v2",
                vocab_size=V, hidden_size=E, intermediate_size=I, moe_intermediate_size=MI,
                num_hidden_layers=HF_LAYERS, num_attention_heads=H, num_key_value_heads=H,
                n_shared_experts=2, n_routed_experts=X, num_experts_per_tok=6,
                first_k_dense_replace=1, kv_lora_rank=r, q_lora_rank=None,
                qk_nope_head_dim=nope, qk_rope_head_dim=rope_d, v_head_dim=v_d,
                rope_theta=10000.0, max_position_embeddings=163840,
                rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                              "mscale_all_dim": 0.707,
                              "original_max_position_embeddings": 4096, "type": "yarn"},
                rms_norm_eps=1e-6, norm_topk_prob=False, routed_scaling_factor=1.0,
                scoring_func="softmax", topk_method="greedy", n_group=1, topk_group=1,
                tie_word_embeddings=False, torch_dtype="bfloat16")
    t = {"model.embed_tokens.weight": _normal(g, (V, E))}
    for i in range(HF_LAYERS):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        t[p + "input_layernorm.weight"] = _normal(g, (E,), 0.05, 1.0)
        t[p + "post_attention_layernorm.weight"] = _normal(g, (E,), 0.05, 1.0)
        t[a + "q_proj.weight"] = _normal(g, (H * (nope + rope_d), E))
        t[a + "kv_a_proj_with_mqa.weight"] = _normal(g, (r + rope_d, E))
        t[a + "kv_a_layernorm.weight"] = _normal(g, (r,), 0.05, 1.0)
        t[a + "kv_b_proj.weight"] = _normal(g, (H * (nope + v_d), r))
        t[a + "o_proj.weight"] = _normal(g, (E, H * v_d))
        if i == 0:
            t[p + "mlp.gate_proj.weight"] = _normal(g, (I, E))
            t[p + "mlp.up_proj.weight"] = _normal(g, (I, E))
            t[p + "mlp.down_proj.weight"] = _normal(g, (E, I))
            continue
        t[p + "mlp.gate.weight"] = _normal(g, (X, E))
        for x in range(X):
            e = p + f"mlp.experts.{x}."
            t[e + "gate_proj.weight"] = _normal(g, (MI, E))
            t[e + "up_proj.weight"] = _normal(g, (MI, E))
            t[e + "down_proj.weight"] = _normal(g, (E, MI))
        sh = p + "mlp.shared_experts."
        t[sh + "gate_proj.weight"] = _normal(g, (2 * MI, E))
        t[sh + "up_proj.weight"] = _normal(g, (2 * MI, E))
        t[sh + "down_proj.weight"] = _normal(g, (E, 2 * MI))
    t["model.norm.weight"] = _normal(g, (E,), 0.05, 1.0)
    t["lm_head.weight"] = _normal(g, (V, E))
    return conf, t


def hf_glm_checkpoint(g) -> tuple:
    """(config.json, tensors) of THUDM/glm-10b at its widths (hidden 4096,
    64 heads of 64 lanes, max_sequence_length 1024, block position tables,
    vocab 50048, the head tied) and HF_LAYERS layers, bf16, under the
    checkpoint's own key names (``glm.`` / ``glm.transformer.``)."""
    E, V, L = 4096, 50048, 1024
    conf = dict(architectures=["GLMModel"], model_type="glm", vocab_size=V, hidden_size=E,
                num_layers=HF_LAYERS, num_attention_heads=64, max_sequence_length=L,
                block_position_encoding=True, torch_dtype="bfloat16")
    t = {"glm.word_embeddings.weight": _normal(g, (V, E)),
         "glm.transformer.position_embeddings.weight": _normal(g, (L + 1, E)),
         "glm.transformer.block_position_embeddings.weight": _normal(g, (L + 1, E))}

    def lin(name, dout, din):
        t[name + ".weight"] = _normal(g, (dout, din))
        t[name + ".bias"] = _normal(g, (dout,))

    def norm(name):
        t[name + ".weight"] = _normal(g, (E,), 0.05, 1.0)
        t[name + ".bias"] = _normal(g, (E,))

    for i in range(HF_LAYERS):
        p = f"glm.transformer.layers.{i}."
        norm(p + "input_layernorm")
        lin(p + "attention.query_key_value", 3 * E, E)
        lin(p + "attention.dense", E, E)
        norm(p + "post_attention_layernorm")
        lin(p + "mlp.dense_h_to_4h", 4 * E, E)
        lin(p + "mlp.dense_4h_to_h", E, 4 * E)
    norm("glm.transformer.final_layernorm")
    return conf, t


def hf_gpt2_checkpoint(g) -> tuple:
    """(config.json, tensors) of openai-community/gpt2-xl at its widths
    (n_embd 1600, 25 heads of 64 lanes, n_positions 1024, vocab 50257, the
    head tied; Conv1D weights [in, out]) and HF_LAYERS layers, bf16."""
    E, V, P = 1600, 50257, 1024
    conf = dict(architectures=["GPT2LMHeadModel"], model_type="gpt2", vocab_size=V,
                n_embd=E, n_head=25, n_layer=HF_LAYERS, n_positions=P, n_inner=None,
                activation_function="gelu_new", layer_norm_epsilon=1e-5,
                torch_dtype="bfloat16")
    t = {"transformer.wte.weight": _normal(g, (V, E)),
         "transformer.wpe.weight": _normal(g, (P, E))}

    def norm(name):
        t[name + ".weight"] = _normal(g, (E,), 0.05, 1.0)
        t[name + ".bias"] = _normal(g, (E,))

    def conv(name, din, dout):
        t[name + ".weight"] = _normal(g, (din, dout))
        t[name + ".bias"] = _normal(g, (dout,))

    for i in range(HF_LAYERS):
        p = f"transformer.h.{i}."
        norm(p + "ln_1")
        conv(p + "attn.c_attn", E, 3 * E)
        conv(p + "attn.c_proj", E, E)
        norm(p + "ln_2")
        conv(p + "mlp.c_fc", E, 4 * E)
        conv(p + "mlp.c_proj", 4 * E, E)
    norm("transformer.ln_f")
    return conf, t


def hf_qwen_checkpoint(g, qwen3: bool) -> tuple:
    """(config.json, tensors) of Qwen/Qwen2.5-7B (its published config.json
    unchanged but for the depth: hidden 3584, 28 query heads over 4 kv heads
    of 128 lanes, G = 7, intermediate 18944, vocab 152064, rope theta 1e6,
    the head untied, and no ``attention_bias`` key: the q / k / v biases
    that Qwen2 always has are written and must be read) or, with ``qwen3``,
    Qwen/Qwen3-14B (hidden 5120, 40 over 8 heads of 128, G = 5, intermediate
    17408, vocab 151936, per-head q / k RMSNorm, no biases, untied), at
    HF_LAYERS layers, bf16."""
    if qwen3:
        E, I, V, H, Hk, D = 5120, 17408, 151936, 40, 8, 128
        conf = dict(architectures=["Qwen3ForCausalLM"], attention_bias=False,
                    attention_dropout=0.0, bos_token_id=151643, eos_token_id=151645,
                    head_dim=D, hidden_act="silu", hidden_size=E, initializer_range=0.02,
                    intermediate_size=I, max_position_embeddings=40960, max_window_layers=40,
                    model_type="qwen3", num_attention_heads=H, num_hidden_layers=40,
                    num_key_value_heads=Hk, rms_norm_eps=1e-6, rope_scaling=None,
                    rope_theta=1e6, sliding_window=None, tie_word_embeddings=False,
                    torch_dtype="bfloat16", use_cache=True, use_sliding_window=False,
                    vocab_size=V)
    else:
        E, I, V, H, Hk, D = 3584, 18944, 152064, 28, 4, 128
        conf = dict(architectures=["Qwen2ForCausalLM"], attention_dropout=0.0,
                    bos_token_id=151643, eos_token_id=151643, hidden_act="silu",
                    hidden_size=E, initializer_range=0.02, intermediate_size=I,
                    max_position_embeddings=131072, max_window_layers=28, model_type="qwen2",
                    num_attention_heads=H, num_hidden_layers=28, num_key_value_heads=Hk,
                    rms_norm_eps=1e-6, rope_theta=1e6, sliding_window=131072,
                    tie_word_embeddings=False, torch_dtype="bfloat16", use_cache=True,
                    use_mrope=False, use_sliding_window=False, vocab_size=V)
    conf["num_hidden_layers"] = HF_LAYERS
    t = {"model.embed_tokens.weight": _normal(g, (V, E))}
    for i in range(HF_LAYERS):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        t[p + "input_layernorm.weight"] = _normal(g, (E,), 0.05, 1.0)
        t[p + "post_attention_layernorm.weight"] = _normal(g, (E,), 0.05, 1.0)
        for n, rows in (("q", H * D), ("k", Hk * D), ("v", Hk * D)):
            t[a + f"{n}_proj.weight"] = _normal(g, (rows, E))
            if not qwen3:
                t[a + f"{n}_proj.bias"] = _normal(g, (rows,))
        t[a + "o_proj.weight"] = _normal(g, (E, H * D))
        if qwen3:
            t[a + "q_norm.weight"] = _normal(g, (D,), 0.05, 1.0)
            t[a + "k_norm.weight"] = _normal(g, (D,), 0.05, 1.0)
        t[p + "mlp.gate_proj.weight"] = _normal(g, (I, E))
        t[p + "mlp.up_proj.weight"] = _normal(g, (I, E))
        t[p + "mlp.down_proj.weight"] = _normal(g, (E, I))
    t["model.norm.weight"] = _normal(g, (E,), 0.05, 1.0)
    t["lm_head.weight"] = _normal(g, (V, E))
    return conf, t


def hf_opt_checkpoint(g) -> tuple:
    """(config.json, tensors) of facebook/opt-2.7b (its config.json: hidden
    2560, 32 heads of 80 lanes, ffn_dim 10240, vocab 50272, 2048 learned
    positions behind HF's offset of 2, relu, layer norm before each block,
    biases everywhere, the head tied) at HF_LAYERS layers, bf16."""
    E, I, V, H, P = 2560, 10240, 50272, 32, 2048
    conf = dict(architectures=["OPTForCausalLM"], model_type="opt", vocab_size=V,
                hidden_size=E, ffn_dim=I, num_hidden_layers=HF_LAYERS, num_attention_heads=H,
                max_position_embeddings=P, activation_function="relu",
                do_layer_norm_before=True, word_embed_proj_dim=E, tie_word_embeddings=True,
                torch_dtype="bfloat16")
    d = "model.decoder."
    t = {d + "embed_tokens.weight": _normal(g, (V, E)),
         d + "embed_positions.weight": _normal(g, (P + 2, E))}

    def lin(name, dout, din):
        t[name + ".weight"] = _normal(g, (dout, din))
        t[name + ".bias"] = _normal(g, (dout,))

    def norm(name):
        t[name + ".weight"] = _normal(g, (E,), 0.05, 1.0)
        t[name + ".bias"] = _normal(g, (E,))

    for i in range(HF_LAYERS):
        p = d + f"layers.{i}."
        norm(p + "self_attn_layer_norm")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(p + "self_attn." + n, E, E)
        norm(p + "final_layer_norm")
        lin(p + "fc1", I, E)
        lin(p + "fc2", E, I)
    norm(d + "final_layer_norm")
    return conf, t


def fp8_head_row(pkg, g, M, V, E, case):
    """The e4m3 tied head (``fp8_head_matmul``) against its plain version at
    [M, E] x [V, E] e4m3 with per-row scales, timed; the yardstick is
    torch.matmul on the table widened to bf16 (outside the timing) times s."""
    import torch

    qm = pkg["quant_matmul"]
    table = torch.randn(V, E, generator=g, device="cuda") * 0.02
    emb = pkg["embedding"].make_embedding(table, pkg["linear"].QuantSpec.from_mode("w8a8_fp8"))
    del table
    q8, s = emb["q"], emb["s"]
    h = torch.randn(M, E, generator=g, device="cuda").to(torch.bfloat16)

    def run():
        return qm.fp8_head_matmul(h, q8, s)

    def plain():
        return qm.fp8_head_matmul_plain(h, q8, s)
    got = run()
    err, rel = _errs(got, plain())
    if not rel <= 1e-4:
        fail(f"fp8_head_gemm {case}: rel err {rel}")
    one = qm.fp8_head_matmul(h[:1].contiguous(), q8, s)
    if not torch.equal(one, got[:1]):
        fail(f"fp8_head_gemm {case}: row 0 alone differs from row 0 of M = {M}")
    ms = time_ms(run, reps=10)
    dev_ms = graph_ms(run, reps=5)
    plain_ms = time_ms(plain, reps=2, warmup=1)
    wide = q8.to(torch.bfloat16).T
    lib_ms = time_ms(lambda: torch.matmul(h, wide) * s, reps=10)
    del wide
    nbytes = V * E + V * 4 + M * E * 2 + M * V * 4
    row = _case("fp8_head_gemm", "fp8_head_gemm.cu",
                "painlessinferenceacceleration_tpu/layers/embedding.py:50 embed_logits "
                "(XLA, no Pallas body)", err, rel, ms, plain_ms,
                bound_ms(nbytes, 2.0 * M * E * V), lib_ms, f"{case}M={M} V={V} E={E}")
    row["device_ms"] = dev_ms
    return row


# the geometries the families phase serves (G, head dim, ALiBi, Hkv, the
# checkpoint, its arena) and the ones it holds against the plain version
# only: G = 5, 6, 7 at head dim 128, heads of 80 and 96 lanes with and
# without ALiBi, in the three arenas
SERVED_GEOMETRIES = {"G7": (7, 128, False, 4, "Qwen2.5-7B ", "bf16"),
                     "G5": (5, 128, False, 8, "Qwen3-14B ", "fp8_tok"),
                     "80x80": (1, 80, False, 32, "OPT-2.7B ", "bf16"),
                     "96x96": (1, 96, True, 16, "BLOOM-1b1 ", "bf16")}
CHECKED_GEOMETRIES = ((5, 128, False), (6, 128, False), (7, 128, False), (1, 80, False),
                      (1, 80, True), (1, 96, False), (1, 96, True))


def _trees(pkg, g):
    """The tree masks and depths of a 17-row (2 branches of 8) and a
    129-row (8 branches of 16) verify, [1, Q, Q] and [1, Q]."""
    import torch

    out = {}
    for R, L in ((2, 8), (8, 16)):
        branches = torch.randint(3, 1000, (R, L), generator=g, device="cuda")
        _, _, tree, depth = pkg["device_tables"].build_tree_inputs(
            torch.tensor(1, device="cuda"), branches)
        out[1 + R * L] = (tree[None], depth[None])
    return out


def geometry_walks(pkg, g) -> tuple:
    """(kind, ctx, Q, qmask, the step's key positions) of decode at ctx 640,
    verify at Q = 17 and 129 (tree masks) at ctx 768 and prefill at Q = 512
    from ctx 0."""
    import torch

    trees = _trees(pkg, g)
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    zero = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    return (("decode", 640, 1, one, zero + 640),
            ("verify", 768, 17, trees[17][0], (trees[17][1] + 768).to(torch.int32)),
            ("verify", 768, 129, trees[129][0], (trees[129][1] + 768).to(torch.int32)),
            ("prefill", 0, 512, None, None))


def geometry_check(pkg, g, kind, ctx, Q, qmask, pos, Hq, Hkv, D, arena, alibi) -> float:
    """One call of the wrapper that serves the arena against the plain
    version on the same inputs (rel <= 2e-2, fails otherwise), untimed."""
    import torch

    pa, ref = pkg["paged_attention"], pkg["attention"]
    k, v, pt, ks, vs = _arena(g, 1, ctx, Q, Hkv, D, 64, arena)
    ctx_t = torch.full((1,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(1, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    al = ref.alibi_slopes(Hq, "cuda") if alibi else None
    pos = pos.contiguous() if alibi and kind != "prefill" else None
    qm = pa.window_qmask(1, Q, ctx_t, None, "cuda") if kind == "prefill" else qmask
    sc, scales = D ** -0.5, None if arena == "bf16" else (ks, vs)
    if arena == "fp8_tok":
        got = pa.paged_attention_tok(q, k, v, ks, vs, pt, ctx_t, sc,
                                     None if kind == "prefill" else qm, al, pos)
    elif kind == "prefill":
        got = pa.paged_attention_prefill(q, k, v, pt, ctx_t, sc, scales, al)
    else:
        got = pa.paged_attention(q, k, v, pt, ctx_t, qm, sc, scales, al, pos)
    _, rel = _errs(got, ref.paged_attention_ref(q, k, v, pt, ctx_t, qm, sc, ks, vs,
                                                alibi=al, alibi_pos=pos))
    if not rel <= 2e-2:
        fail(f"paged attention {kind} Q={Q} {arena} G={Hq // Hkv} D={D} alibi={alibi}: "
             f"rel err {rel}")
    return rel


def geometry_rows(pkg, g) -> tuple:
    """The new geometries: the served ones' rows against their plain
    versions, timed, with bound and SDPA (``SERVED_GEOMETRIES``: decode ctx
    640, verify Q = 17 and 129 at ctx 768, prefill Q = 512), and every
    checked geometry in every arena and walk against its plain version
    (``CHECKED_GEOMETRIES``). Returns (rows, checks)."""
    import torch

    walks = geometry_walks(pkg, g)
    rows = []
    for dims, (G, D, alibi, Hkv, model, arena) in SERVED_GEOMETRIES.items():
        Hq = G * Hkv
        al = pkg["attention"].alibi_slopes(Hq, "cuda") if alibi else None
        for kind, ctx, Q, qm, pos in walks:
            k, v, pt, ks, vs = _arena(g, 1, ctx, Q, Hkv, D, 64, arena)
            ctx_t = torch.full((1,), ctx, dtype=torch.int32, device="cuda")
            q = torch.randn(1, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
            rows.append(attention_row(
                pkg, kind, arena, q, k, v, pt, ctx_t, qm, ks, vs, D ** -0.5,
                f"{model}G={G} ctx={ctx} ", alibi=al,
                alibi_pos=pos.contiguous() if alibi and kind != "prefill" else None,
                name=_pair_name(kind, arena, dims)))
    checks = {}
    for G, D, alibi in CHECKED_GEOMETRIES:
        for arena in ("bf16", "fp8", "fp8_tok"):
            for kind, ctx, Q, qm, pos in walks:
                key = f"G={G} D={D}{' alibi' if alibi else ''} {arena} {kind} Q={Q}"
                checks[key] = geometry_check(pkg, g, kind, ctx, Q, qm, pos, G * 2, 2, D,
                                             arena, alibi)
    torch.cuda.empty_cache()
    return rows, checks


def family_rows(pkg) -> list:
    """The new builds against their plain versions at the shapes the
    families serve: GPT-J's (256, 256) with Hq = Hkv = 16 in every arena
    and route (decode ctx 640, verify Q = 17 ctx 768, prefill Q = 512),
    DeepSeek-V2-Lite's expanded (192, 128) with 16 heads (bf16, its arena),
    K3's window at GLM-10B's 64 heads of 64 lanes (Q = 512, a window of 300
    keys), the e4m3 head at BLOOM-7b1's 250880 x 4096, M = 1 / 17 / 512,
    then the new geometries (``geometry_rows``: Qwen2.5-7B's G = 7, Qwen3-14B's
    G = 5, OPT-2.7B's heads of 80, BLOOM-1b1's of 96 with ALiBi; G = 5, 6, 7
    and heads of 80 / 96 in every arena checked). Returns (rows, checks)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    branches = torch.randint(3, 1000, (2, 8), generator=g, device="cuda")
    tree = pkg["device_tables"].build_tree_inputs(torch.tensor(1, device="cuda"),
                                                  branches)[2][None]  # R=2 L=8
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    walks = (("decode", 640, 1, one), ("verify", 768, 17, tree), ("prefill", 0, 512, None))
    rows = []
    for arena in ("bf16", "fp8", "fp8_tok"):
        for kind, ctx, Q, qm in walks:
            rows.append(check_attention(pkg, g, kind, 1, Q, 16, 16, ctx, qm, arena, D=256,
                                        name=_pair_name(kind, arena, "256x256"),
                                        case="GPT-J "))
    for kind, ctx, Q, qm in walks:
        rows.append(check_attention(pkg, g, kind, 1, Q, 16, 16, ctx, qm, D=192, Dv=128,
                                    name=_pair_name(kind, "bf16", "192x128"),
                                    case="DeepSeek-V2-Lite expanded "))
    rows.append(check_attention(pkg, g, "prefill", 1, 512, 64, 64, 0, None, D=64, window=300,
                                name="paged_attention_prefill[window]", case="GLM-10B "))
    for M in (1, 17, 512):
        rows.append(fp8_head_row(pkg, g, M, 250880, 4096, "BLOOM-7b1 "))
        torch.cuda.empty_cache()
    new_rows, checks = geometry_rows(pkg, g)
    rows += new_rows
    for r in rows:
        print("phase families kernel: " + json.dumps(r))
    print(f"phase families geometries: {len(checks)} calls (G = 5, 6, 7 at D = 128; D = 80 "
          "and 96 with and without ALiBi; three arenas; decode, verify Q = 17 / 129, prefill "
          "Q = 512) within rel 2e-2 of the plain version, the largest "
          f"{max(checks.values()):.3e}")
    return rows, checks


def family_prompts(tok) -> list:
    """FAMILY_PROMPTS corpus prompts of at least FAMILY_MIN_PROMPT BPE
    tokens each (GLM's prefix window then reaches past 128 rows)."""
    long = [p for p in hf_prompts() if len(tok.encode(p)) >= FAMILY_MIN_PROMPT]
    if len(long) < FAMILY_PROMPTS:
        fail(f"phase families: {len(long)} corpus prompts of {FAMILY_MIN_PROMPT} tokens")
    return long[:FAMILY_PROMPTS]


def serve_family(pkg, path, prompts, tok, **extra) -> dict:
    """AR and lookahead (``serve_hf``: the default tree, drafts verified at
    up to 61 rows, or ``extra``'s decoding and branch lengths) through
    LLM(model_path=path): lookahead must equal AR token for token, and
    verify steps must have run (at the tree's width, ``verify_width``).
    ``extra``: EngineConfig fields of both runs."""
    outs, res = [], {}
    for la in (False, True):
        llm, run, out = serve_hf(pkg, path, "none", la, prompts, tok, FAMILY_NEW_TOKENS,
                                 spec_cooldown_bursts=0, **extra)
        if la:
            run["verify_width"] = llm.tcfg.verify_width
            if run["spec_steps"] <= 0:
                fail(f"phase families {path}: no verify step ran")
        res["lookahead" if la else "ar"] = run
        outs.append(out)
        del llm
    if outs[0] != outs[1]:
        bad = [i for i, (a, b) in enumerate(zip(*outs)) if a != b]
        fail(f"phase families {path}: lookahead differs from AR on requests {bad}")
    res["lossless_strict"] = True
    return res


def phase_families(pkg) -> dict:
    """Every family the port loads, at published widths and HF_LAYERS
    layers, written as local safetensors checkpoints (random bf16 weights
    from a seeded torch.Generator on the card) and served by
    LLM(model_path=...) on FAMILY_PROMPTS text prompts, AR and lookahead
    equal token for token: EleutherAI/gpt-j-6b (K2 / K3 / K5 at (256, 256)
    over the bf16, static e4m3 and per-token e4m3 arenas), DeepSeek-V2-Lite
    in expanded MLA mode (K2 / K3 at (192, 128)), THUDM/glm-10b at
    prefill_chunk 512 over prompts past 128 tokens (K3's prefix-LM window),
    openai-community/gpt2-xl (the 50257-column tied head padded to 50264
    rows for K10), and bigscience/bloom-7b1 under ``quant_embed`` (the e4m3
    tied head kernel), Qwen/Qwen2.5-7B (G = 7, K2 / K3 at the default width
    and with a 129-row tree verify), Qwen/Qwen3-14B over the per-token e4m3
    arena (G = 5), facebook/opt-2.7b (heads of 80 lanes) and
    bigscience/bloom-1b1 (heads of 96, ALiBi). Then the new builds' rows
    (``family_rows``). The kernels' launches counted from 0 over the
    serving runs."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    launches = Launches(pkg)
    launches.reset()
    tok = load_bpe()
    prompts = family_prompts(tok)
    st = pkg["safetensors"]
    runs = (("gptj_6b", hf_gptj_checkpoint, ({}, {"kv_quant": "fp8"},
                                             {"kv_quant": "fp8_tok"})),
            ("deepseek_v2_lite_expanded", hf_deepseek_checkpoint, ({},)),
            ("glm_10b_chunk512", hf_glm_checkpoint, ({},)),
            ("gpt2_xl", hf_gpt2_checkpoint, ({},)),
            ("bloom_7b1_fp8_head", hf_bloom_checkpoint, ({"quant_embed": True},)),
            ("qwen2_5_7b", lambda g: hf_qwen_checkpoint(g, False),
             ({}, {"decoding_length": 128, "branch_length": 16})),
            ("qwen3_14b", lambda g: hf_qwen_checkpoint(g, True), ({"kv_quant": "fp8_tok"},)),
            ("opt_2_7b", hf_opt_checkpoint, ({},)),
            ("bloom_1b1", lambda g: hf_bloom_checkpoint(g, 1536, 16), ({},)))
    res = {}
    for name, make, settings in runs:
        t0 = time.perf_counter()
        conf, tensors = make(torch.Generator(device="cuda").manual_seed(SEED + 22))
        draw_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory(prefix="pia_family_") as d:
            t0 = time.perf_counter()
            nbytes = st.write_checkpoint(d, tensors, conf, n_shards=HF_SHARDS)
            write_s = time.perf_counter() - t0
            del tensors
            out = dict(checkpoint_gb=nbytes / 1e9, draw_s=draw_s, write_s=write_s)
            for extra in settings:
                key = extra.get("kv_quant", "bf16_arena")
                if "decoding_length" in extra:  # the wider tree verify
                    key += f"_q{1 + extra['decoding_length']}"
                out[key] = serve_family(pkg, d, prompts, tok, **extra)
        res[name] = out
        print(f"phase families {name} (random weights, {HF_LAYERS} layers): "
              + json.dumps(out))
        torch.cuda.empty_cache()
    res["launches"] = launches.read()
    need = [_pair_name(k, a, "256x256") for k in ("decode", "verify", "prefill")
            for a in ("bf16", "fp8", "fp8_tok")]
    need += [_pair_name(k, "bf16", "192x128") for k in ("decode", "verify", "prefill")]
    need += ["paged_attention_prefill[window]", "fp8_head_gemm"]
    need += [_pair_name(k, a, dims) for dims, (*_, a) in SERVED_GEOMETRIES.items()
             for k in ("decode", "verify", "prefill")]
    idle = [k for k in need if res["launches"].get(k, 0) <= 0]
    if idle:
        fail(f"phase families: the families' serving launched none of {idle}")
    res["kernels"], res["geometry_checks"] = family_rows(pkg)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"phase families: wall {res['wall_s']:.1f} s on {smi_line()}")
    return res


# ---------------------------------------------------------------------------
# the quant modes: every 8-bit linear format on the main path and in serving
# ---------------------------------------------------------------------------

QUANT_AR_TOKENS = 32
QUANT_SPEC_TOKENS = 64
QUANT_REDUCED_LAYERS = 8
# (quant mode, fp8 embedding, full depth, also served through LLM)
QUANT_RUNS = (("int8", False, True, True), ("w8a8_int8", False, True, False),
              ("w8a8_fp8", False, True, True), ("fp8_block", False, True, True),
              ("w8a8_int8_static", False, False, False),
              ("w8a8_fp8_static", False, False, False), ("fp8_tb", False, False, False),
              ("w8a8_fp8", True, False, False))


def phase_quant_modes(pkg, cfg, quant_runs=QUANT_RUNS) -> dict:
    """Each 8-bit linear format through prefill, AR decode and lookahead
    decode at B = 1 (strictly lossless or the run fails); three of them
    through the serving engine, AR and lookahead; the launches of each run
    counted from 0; the 8-bit GEMMs held against their plain versions on
    the inputs of those runs. One mode's parameters are freed before the
    next are drawn."""
    import dataclasses

    import torch

    linear, base = pkg["linear"], pkg["base"]
    prompts = serving_prompts(cfg.vocab_size)
    capture = ServingCapture(pkg)
    capture.install(gemm8_only=True)
    runs, rows, totals = [], [], {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    for mode, quant_embed, full, served in quant_runs:
        mcfg = cfg if full else dataclasses.replace(
            cfg, num_hidden_layers=QUANT_REDUCED_LAYERS)
        spec = linear.QuantSpec.from_mode(mode)
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = base.init_params_quantized(mcfg, spec, gen)
        if quant_embed:  # as LLM does for EngineConfig.quant_embed
            params["embed"] = pkg["embedding"].make_embedding(
                params["embed"], linear.QuantSpec.from_mode("w8a8_fp8"))
        label = (f"phase quant {mode}" + (" +fp8 embedding" if quant_embed else "")
                 + f" ({mcfg.num_hidden_layers} layers)")
        res = phase_main_path(pkg, mcfg, spec, params, QUANT_AR_TOKENS, QUANT_SPEC_TOKENS,
                              label, extras=False)
        res.update(mode=mode, quant_embed=quant_embed, layers=mcfg.num_hidden_layers)
        add(res["launches"])
        kernel = MODE_KERNEL[mode]
        others = [k for k in GEMM8 if k != kernel and res["launches"][k]]
        if res["launches"][kernel] <= 0 or res["launches"]["int4_gemm"] or others:
            fail(f"{label}: the linears did not all go through {kernel}: {res['launches']}")
        if served:
            launches = Launches(pkg)
            launches.reset()
            scfg, sparams = first_layers(mcfg, params, SERVE_LAYERS)
            res_ar, ar_out, _ = serve_once(pkg, scfg, sparams, prompts, "none", False, mode)
            res_la, la_out, _ = serve_once(pkg, scfg, sparams, prompts, "none", True, mode)
            del sparams
            res_la["launches"] = launches.read()
            add(res_la["launches"])
            diff = [i for i, (a, b) in enumerate(zip(ar_out, la_out)) if a != b]
            res_la["identical_to_ar"] = not diff
            for r in (res_ar, res_la):
                print("phase quant serving run: " + json.dumps(r))
            if diff:
                fail(f"serving quant={mode}: lookahead differs from AR on requests {diff}")
            if res_la["spec_steps"] <= 0 or res_ar["prefix_hit_tokens"] <= 0:
                fail(f"serving quant={mode}: no spec step or no prefix-cache hit")
            res["serving"] = [res_ar, res_la]
        if full:  # the kept calls of this mode, before its weights go
            rows += capture.gemm8_rows(f"captured {mode} ")
        else:
            capture.gemm8 = {}
        runs.append(res)
        del params
    capture.remove()
    for name in {MODE_KERNEL[run[0]] for run in quant_runs if run[2]}:
        if not any(r["name"] == name and r["case"].startswith("captured") for r in rows):
            fail(f"no captured call of {name}")
    for r in rows:
        print("phase quant kernel: " + json.dumps(r))
    torch.cuda.empty_cache()
    return dict(runs=runs, kernels=rows, launches=totals,
                quant_act=quant_act_costs(pkg))


# ---------------------------------------------------------------------------
# Mixture-of-Experts: the grouped GEMMs, the three routes, serving
# ---------------------------------------------------------------------------

MOE = "painlessinferenceacceleration_tpu/ops/moe_matmul.py"
MOE_PROMPT_LEN = 2048  # 2048 * 2 >= 2 * 128 * 8: prefill takes the grouped route
MOE_AR_TOKENS = 32
MOE_SPEC_TOKENS = 64
MOE_BF16_LAYERS = 8  # 23.5 GB of the 93 GB a bf16 Mixtral-8x7B weighs
MOE_INT8_LAYERS = 8
# the int4 experts' run in shards was at all 32 layers until the hybrid phases
# came; 8 layers keep the shards' route and its kernel at a quarter of the time
MOE_INT4_LAYERS = 8
MOE_SERVE_LAYERS = 4
MOE_SHARDS = 2
# (family, experts, top-k, expert GEMM shapes (K, N): gate/up then down, token counts)
MOE_FAMILIES = (("mixtral-8x7b", 8, 2, ((4096, 28672), (14336, 4096)), (1, 17, 512, 4096)),
                ("qwen3-30b-a3b", 128, 8, ((2048, 1536), (768, 2048)), (1, 17, 128, 1024)))
GROUPED = {"grouped_gemm": ("grouped_gemm.cu", f"{MOE}:77 _gmm_kernel"),
           "grouped_int4_gemm": ("grouped_int4_gemm.cu", f"{MOE}:130 _gqmm4_kernel"),
           "grouped_int8_gemm": ("grouped_int8_gemm.cu", f"{MOE}:148 _gqmm8_kernel")}


def seeded_routing(g, T, k, X, drop):
    """k distinct experts per token from the generator, a share ``drop`` of
    the pairs carrying the dropped-expert sentinel X, and their weights."""
    import torch

    topi = torch.rand(T, X, generator=g, device="cuda").argsort(dim=1)[:, :k]
    topi = torch.where(torch.rand(T, k, generator=g, device="cuda") < drop,
                       torch.full_like(topi, X), topi)
    return topi.to(torch.int32), torch.rand(T, k, generator=g, device="cuda")


def expert_weights(g, name, X, K, N):
    """Random experts of the kernel's format: bf16 values of spread 0.02,
    or weight-only leaves as init_params_quantized draws them."""
    import torch

    if name == "grouped_gemm":
        w = torch.empty(X, K, N, dtype=torch.bfloat16, device="cuda")
        for e in range(X):
            w[e] = torch.randn(K, N, generator=g, device="cuda") * 0.02
        return w
    if name == "grouped_int4_gemm":
        q = torch.randint(0, 256, (X, K // 2, N), generator=g, device="cuda",
                          dtype=torch.uint8)
        s = torch.rand(X, K // 128, N, generator=g, device="cuda") * 0.004 + 0.001
    else:
        q = torch.randint(-127, 128, (X, K, N), generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand(X, K // 128, N, generator=g, device="cuda") * 2e-4 + 5e-5
    return {"q": q, "s": s.to(torch.bfloat16)}


def grouped_call(pkg, name, xg, be, nu, w, n_pairs, rows=None):
    """One grouped GEMM; ``n_pairs`` (the routing's pair count) bounds the
    kernel's grid as routed_expert_mlp does."""
    mm = pkg["moe_matmul"]
    if name == "grouped_gemm":
        return mm.grouped_matmul(xg, be, nu, w, rows, n_pairs=n_pairs)
    return mm.grouped_quant_matmul(xg, be, nu, w, 4 if "int4" in name else 8, rows,
                                   n_pairs=n_pairs)


def dense_expert(pkg, name, x, w, e):
    """The dense kernel of the same format on expert e's weights."""
    if name == "grouped_gemm":
        return pkg["moe_matmul"].dense_matmul(x, w[e])
    fn = pkg["quant_matmul"].int4_matmul if "int4" in name else pkg["quant_matmul"].int8_matmul
    return fn(x, w["q"][e], w["s"][e])


def grouped_row(pkg, g, name, family, X, k, K, N, T, w, w_bf16):
    """One grouped GEMM over a seeded routing of T tokens (a fifth of the
    pairs dropped) against its plain version, timed; the rows past n_used
    must be exactly zero. Tolerance 2e-2 of the largest value (bf16 out,
    fp32 sums in another order). The bound counts what this routing needs:
    the routed rows in, the weights of the experts they touch, all of the
    output out."""
    import torch

    mm = pkg["moe_matmul"]
    topi, topv = seeded_routing(g, T, k, X, 0.2)
    dest_tok, _, be, nu, _ = mm._align(topi, topv, X, T)
    rows = mm._block_rows(dest_tok, T)
    x = torch.randn(T, K, generator=g, device="cuda").to(torch.bfloat16)
    xg = torch.cat([x, torch.zeros(1, K, dtype=x.dtype, device="cuda")])[dest_tok.long()]
    plain = mm.grouped_matmul_plain if name == "grouped_gemm" else (
        lambda a, b, c, p: mm.grouped_quant_matmul_plain(a, b, c, p, 4 if "int4" in name else 8))
    got, ref = grouped_call(pkg, name, xg, be, nu, w, T * k, rows), plain(xg, be, nu, w)
    err, rel = _errs(got, ref)
    case = f"{family} routed_rows={T * k} X={X} K={K} N={N}"
    if name == "grouped_gemm":
        plan = mm.grouped_bf16_plan(xg.shape[0], K, N, X, T * k)
    else:
        plan_of = mm.grouped_int4_plan if "int4" in name else mm.grouped_int8_plan
        plan = plan_of(xg.shape[0], K, N, 128, X, T * k)
    case += f" row_blocks_launched={plan.grid[1]} of {be.numel()}"
    if not rel <= 2e-2:
        fail(f"{name} {case}: rel err {rel}")
    n_used = int(nu[0])
    if got[n_used * 128:].any():
        fail(f"{name} {case}: rows past n_used are not zero")
    if not torch.equal(got, grouped_call(pkg, name, xg, be, nu, w, T * k)):
        fail(f"{name} {case}: the row counts change the result")
    big = T * k >= 1024
    ms = time_ms(lambda: grouped_call(pkg, name, xg, be, nu, w, T * k, rows),
                 reps=5 if big else 20)
    dev_ms = graph_ms(lambda: grouped_call(pkg, name, xg, be, nu, w, T * k, rows),
                      reps=3 if big else 10)
    plain_ms = time_ms(lambda: plain(xg, be, nu, w), reps=2 if big else 5, warmup=1)
    # yardstick: torch._grouped_mm over the padded expert runs of bf16 experts
    offs = (torch.searchsorted(be[:n_used].contiguous(),
                               torch.arange(X, device="cuda", dtype=torch.int32),
                               right=True) * 128).to(torch.int32)
    used = xg[: n_used * 128]
    lib_ms = library_ms(lambda: torch._grouped_mm(used, w_bf16, offs=offs)) \
        if n_used else None
    real = int((rows[:n_used]).sum().item())
    touched = int(torch.unique(be[:n_used]).numel())
    wbytes = {"grouped_gemm": 2.0, "grouped_int4_gemm": 0.5 + 2 / 128,
              "grouped_int8_gemm": 1.0 + 2 / 128}[name] * K * N
    nbytes = real * K * 2 + touched * wbytes + got.numel() * 2 + be.numel() * 8 + 4
    source, replaces = GROUPED[name]
    row = _case(name, source, replaces, err, rel, ms, plain_ms,
                bound_ms(nbytes, 2.0 * real * K * N), lib_ms,
                f"{case} real_rows={real} experts_touched={touched} blocks_used={n_used}")
    row["device_ms"] = dev_ms  # the kernels alone (a CUDA graph)
    return row


def dense_row(pkg, g, M, K, N, out_dtype, what):
    """The dense entry of the bf16 GEMM source against its plain version
    (2e-2 in bf16, 1e-4 in fp32), timed; torch.matmul as the yardstick."""
    import torch

    mm = pkg["moe_matmul"]
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    got, ref = mm.dense_matmul(x, w, out_dtype), mm.dense_matmul_plain(x, w, out_dtype)
    err, rel = _errs(got, ref)
    if not rel <= (2e-2 if out_dtype == torch.bfloat16 else 1e-4):
        fail(f"bf16_gemm {what} M={M} K={K} N={N}: rel err {rel}")
    ms = time_ms(lambda: mm.dense_matmul(x, w, out_dtype))
    dev_ms = graph_ms(lambda: mm.dense_matmul(x, w, out_dtype))
    plain_ms = time_ms(lambda: mm.dense_matmul_plain(x, w, out_dtype), reps=5)
    lib_ms = time_ms(lambda: torch.matmul(x, w))
    nbytes = (M * K + K * N) * 2 + M * N * got.element_size()
    row = _case("dense_bf16_gemm", "grouped_gemm.cu",
                f"{MOE}:77 _gmm_kernel (one expert: the native linears)", err, rel, ms,
                plain_ms, bound_ms(nbytes, 2.0 * M * K * N), lib_ms,
                f"{what} M={M} K={K} N={N} out={str(out_dtype).split('.')[-1]}")
    row["device_ms"] = dev_ms  # the kernel alone (a CUDA graph)
    return row


def check_moe_invariance(pkg, g, name, X, k, K, N, w) -> None:
    """A routed row's bits: the same at T = 1, 8, 17, 136 as among 4096
    tokens, and equal to the dense kernel of that format on the expert's
    weights. Fails the run otherwise."""
    import torch

    mm = pkg["moe_matmul"]
    T = 4096
    topi, topv = seeded_routing(g, T, k, X, 0.2)
    x = torch.randn(T, K, generator=g, device="cuda").to(torch.bfloat16)
    zero = torch.zeros(1, K, dtype=x.dtype, device="cuda")

    def run(m):
        dest_tok, _, be, nu, tok_rows = mm._align(topi[:m], topv[:m], X, m)
        xg = torch.cat([x[:m], zero])[dest_tok.long()]
        out = grouped_call(pkg, name, xg, be, nu, w, m * k, mm._block_rows(dest_tok, m))
        return out[tok_rows]  # [m, k, N]: each token's rows by ascending expert

    full = run(T)
    for m in (1, 8, 17, 136):
        if not torch.equal(run(m), full[:m]):
            fail(f"{name} K={K} N={N}: a routed row changes with the token count (T={m})")
    m = 136
    ex = torch.sort(topi[:m].long(), dim=1).values  # ascending, dropped (= X) last
    for e in range(X):
        dense = dense_expert(pkg, name, x[:m], w, e)  # [m, N]
        t, j = (ex == e).nonzero(as_tuple=True)
        if not torch.equal(full[t, j], dense[t]):
            fail(f"{name} K={K} N={N}: routed rows differ from the dense kernel on "
                 f"expert {e}'s weights")
    if full[:m][ex == X].any():
        fail(f"{name} K={K} N={N}: dropped pairs are not zero")


def phase_moe_kernels(pkg, mcfg, names=tuple(GROUPED)) -> list:
    """The grouped GEMMs ``names`` at Mixtral-8x7B / Qwen3-30B-A3B shapes
    against their plain versions, with their bit identities; with all three,
    also the dense bf16 GEMM's rows and its identities."""
    import torch

    mm, lin = pkg["moe_matmul"], pkg["linear"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for family, X, k, shapes, tokens in MOE_FAMILIES:
        for K, N in shapes:
            for name in names:
                w = expert_weights(g, name, X, K, N)
                if name == "grouped_gemm":
                    w_bf16 = w
                else:
                    w_bf16 = torch.stack([lin.dequantize(
                        {"q": w["q"][e], "s": w["s"][e]}, None, torch.bfloat16)
                        for e in range(X)])
                for T in tokens:
                    rows.append(grouped_row(pkg, g, name, family, X, k, K, N, T, w, w_bf16))
                del w_bf16
                check_moe_invariance(pkg, g, name, X, k, K, N, w)
                del w
                torch.cuda.empty_cache()
    if tuple(names) != tuple(GROUPED):
        for r in rows:
            print("phase moe kernel: " + json.dumps(r))
        print(f"phase moe invariance: {', '.join(names)} rows bit-identical at T = 1, 8, "
              "17, 136 and 4096 and bit-equal to the dense kernel on the expert's weights")
        return rows
    E, V = mcfg.hidden_size, mcfg.vocab_size
    qkv = (mcfg.num_attention_heads + 2 * mcfg.num_key_value_heads) * mcfg.head_dim
    for M in (1, 17, 512):
        rows.append(dense_row(pkg, g, M, E, qkv, torch.bfloat16, "wqkv"))
        rows.append(dense_row(pkg, g, M, E, E, torch.bfloat16, "wo"))
        rows.append(dense_row(pkg, g, M, E, mcfg.num_experts, torch.float32, "router"))
        rows.append(dense_row(pkg, g, M, E, V, torch.float32, "lm_head"))
    # the router logits and a native linear: bit-identical at every width
    x = torch.randn(4096, E, generator=g, device="cuda").to(torch.bfloat16)
    for N, out in ((mcfg.num_experts, torch.float32), (qkv, torch.bfloat16)):
        w = (torch.randn(E, N, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
        full = mm.dense_matmul(x, w, out)
        for m in (1, 8, 17, 136):
            if not torch.equal(mm.dense_matmul(x[:m], w, out), full[:m]):
                fail(f"bf16_gemm N={N}: rows change with the batch width (M={m})")
    torch.cuda.synchronize()
    for r in rows:
        print("phase moe kernel: " + json.dumps(r))
    print("phase moe invariance: grouped_gemm, grouped_int4_gemm and grouped_int8_gemm "
          "rows bit-identical at T = 1, 8, 17, 136 and 4096 and bit-equal to bf16_gemm / "
          "int4_gemm / int8_gemm on the expert's weights; the router logits and a native "
          "bf16 linear bit-identical at M = 1, 8, 17, 136 and 4096")
    return rows


class MoeInputCapture:
    """Keeps the input of the first MoE layer's block on the widest call
    (the prefill), for holding the grouped route against the scan route."""

    def __init__(self, pkg):
        self.base, self.h, self.lp = pkg["base"], None, None
        self.orig = self.base.moe_block

    def __enter__(self):
        def hook(lp, cfg, spec, h, par=None):
            if self.h is None or h.shape[1] > self.h.shape[1]:
                self.h, self.lp = h.clone(), lp
            return self.orig(lp, cfg, spec, h, par)
        self.base.moe_block = hook
        return self

    def __exit__(self, *exc):
        self.base.moe_block = self.orig


def moe_routes(pkg, cfg, lp, h) -> dict:
    """One bf16 MoE layer on its captured prefill input: the grouped route
    must equal the scan route bit for bit; then both routes' times at
    T = 1, 17, 512, 4096 (rows of the captured input, tiled up to 4096)."""
    import torch

    moe = pkg["moe"]
    rule = moe.use_grouped_moe

    def run(x, grouped):
        moe.use_grouped_moe = lambda *a: grouped
        try:
            return moe.moe_block(lp, cfg, None, x)
        finally:
            moe.use_grouped_moe = rule

    got, ref = run(h, True), run(h, False)
    if not torch.equal(got, ref):
        d = (got.float() - ref.float()).abs().max().item()
        fail(f"moe_block: the grouped route differs from the scan route (max {d})")
    res = dict(grouped_equals_scan=True, tokens=h.shape[1], times_ms={})
    for T in (1, 17, 512, 4096):
        x = h.repeat(1, -(-T // h.shape[1]), 1)[:, :T].contiguous()
        reps = 2 if T >= 512 else 10
        res["times_ms"][f"T={T}"] = dict(
            grouped=time_ms(lambda: run(x, True), reps=reps, warmup=1),
            scan=time_ms(lambda: run(x, False), reps=reps, warmup=1))
    return res


def phase_moe(pkg) -> dict:
    """Mixtral-8x7B at full width by the three routes, each strictly
    lossless at B = 1 with its kernels' launches counted from 0, and the
    bf16 model through the serving engine. One model is freed before the
    next is drawn."""
    import dataclasses

    import torch

    base = pkg["base"]
    full = pkg["config"].ModelConfig.mixtral_8x7b()
    runs, totals = [], {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    def main_path(cfg, spec, params, label, need, forbid=(), k10_steps=False):
        res = phase_main_path(pkg, cfg, spec, params, MOE_AR_TOKENS, MOE_SPEC_TOKENS,
                              label, extras=False, prompt_len=MOE_PROMPT_LEN,
                              k10_steps=k10_steps)
        res.update(layers=cfg.num_hidden_layers, prompt_len=MOE_PROMPT_LEN)
        add(res["launches"])
        if any(res["launches"][k] <= 0 for k in need) or any(
                res["launches"][k] for k in forbid):
            fail(f"{label}: launches {res['launches']} (needed {need}, none of {forbid})")
        runs.append(res)
        return res

    # bf16 experts: grouped route at prefill, scan route at decode and verify
    cfg = dataclasses.replace(full, num_hidden_layers=MOE_BF16_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = base.init_params(cfg, gen, dtype=torch.bfloat16)
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    label = f"phase moe bf16 ({cfg.num_hidden_layers} of 32 layers, {weights_gb:.1f} GB of weights)"
    with MoeInputCapture(pkg) as cap:
        main_path(cfg, None, params, label, ("grouped_gemm", "dense_bf16_gemm"),
                  ("grouped_int4_gemm", "grouped_int8_gemm", "int4_gemm"), k10_steps=True)
    routes = moe_routes(pkg, cfg, cap.lp, cap.h)
    print("phase moe routes: " + json.dumps(routes))
    del params, cap
    torch.cuda.empty_cache()

    # the bf16 model through the serving engine
    scfg = dataclasses.replace(full, num_hidden_layers=MOE_SERVE_LAYERS)
    params = base.init_params(scfg, torch.Generator(device="cuda").manual_seed(SEED),
                              dtype=torch.bfloat16)
    prompts = serving_prompts(scfg.vocab_size)
    launches = Launches(pkg)
    capture = MlaCapture(pkg, widest=True)
    capture.install()
    launches.reset()
    try:
        res_ar, ar_out, _ = serve_once(pkg, scfg, params, prompts, "none", False, "none")
        res_la, la_out, _ = serve_once(pkg, scfg, params, prompts, "none", True, "none")
    finally:
        capture.remove()
    serve_counts = launches.read()
    add(serve_counts)
    diff = [i for i, (a, b) in enumerate(zip(ar_out, la_out)) if a != b]
    res_la["identical_to_ar"] = not diff
    for r in (res_ar, res_la):
        print("phase moe serving run: " + json.dumps(r))
    print("phase moe serving launches: " + json.dumps(serve_counts))
    if diff:
        fail(f"moe serving: lookahead differs from AR on requests {diff}")
    if res_la["spec_steps"] <= 0 or res_ar["prefix_hit_tokens"] <= 0:
        fail("moe serving: no spec step or no prefix-cache hit")
    if serve_counts["grouped_gemm"] <= 0 or serve_counts["dense_bf16_gemm"] <= 0:
        fail(f"moe serving: the grouped and the scan route did not both run: {serve_counts}")
    del params
    torch.cuda.empty_cache()

    for bits in (4, 8):
        res = moe_weight_only_run(pkg, bits)
        add(res["launches"])
        runs.append(res)
    return dict(runs=runs, routes=routes, serving=[res_ar, res_la], launches=totals)


def moe_weight_only_run(pkg, bits: int) -> dict:
    """Mixtral-8x7B with weight-only int4 or int8 experts in expert shards
    (the grouped kernels carry the experts), int4 at MOE_INT4_LAYERS and
    int8 at MOE_INT8_LAYERS layers, strictly lossless at B = 1, its kernels'
    launches counted from 0."""
    import dataclasses

    import torch

    base, lin, moe = pkg["base"], pkg["linear"], pkg["moe"]
    layers = MOE_INT4_LAYERS if bits == 4 else MOE_INT8_LAYERS
    cfg = dataclasses.replace(pkg["config"].ModelConfig.mixtral_8x7b(),
                              num_hidden_layers=layers, expert_parallel=True)
    spec = lin.QuantSpec(bits=bits, group=128)
    params = base.init_params_quantized(cfg, spec,
                                        torch.Generator(device="cuda").manual_seed(SEED))
    label = f"phase moe int{bits} experts, {MOE_SHARDS} expert shards ({layers} layers)"
    kernel, other = (("grouped_int4_gemm", "grouped_int8_gemm") if bits == 4
                     else ("grouped_int8_gemm", "grouped_int4_gemm"))
    with moe.expert_shards(MOE_SHARDS):
        res = phase_main_path(pkg, cfg, spec, params, MOE_AR_TOKENS, MOE_SPEC_TOKENS,
                              label, extras=False, prompt_len=MOE_PROMPT_LEN)
    res.update(layers=layers, prompt_len=MOE_PROMPT_LEN, expert_shards=MOE_SHARDS,
               expert_bits=bits)
    if res["launches"][kernel] <= 0 or res["launches"][other] \
            or res["launches"]["grouped_gemm"]:
        fail(f"{label}: launches {res['launches']} (needed {kernel}, none of {other}, "
             "grouped_gemm)")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Multi-head Latent Attention: K13, the absorption products, DeepSeek-V2-Lite
# ---------------------------------------------------------------------------

MLA_SRC = "painlessinferenceacceleration_tpu/ops/mla_attention.py"
MLA_MODEL = "painlessinferenceacceleration_tpu/models/mla.py"
MLA_PROMPT_LEN = 4096  # 4096 * 6 >= 2 * 128 * 64: prefill takes the grouped route
MLA_AR_TOKENS = 32
MLA_SPEC_TOKENS = 64
MLA_SERVE_LAYERS = 4  # 1 dense + 3 MoE layers
MLA_DK, MLA_DV = 576, 512  # kv_lora_rank + qk_rope_head_dim, kv_lora_rank


def mla_arena(g, B, ctx_max, Q, ps=64):
    """Unit-normal latent pages [n_pages, ps, 576] for B requests (permuted
    page tables)."""
    import torch

    P = -(-(ctx_max + Q) // ps) + 1
    n_pages = B * P + 1
    k = torch.randn(n_pages, ps, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")[: B * P] + 1
    return k, perm.reshape(B, P).to(torch.int32)


def mla_row(pkg, kind, q, k, pt, ctx_t, qmask, scale, case):
    """K13 on these inputs ('decode' / 'verify' under the mask rule,
    'prefill' under the causal flag) against mla_paged_attention_plain,
    timed. Tolerance 2e-2 of the largest value (bf16 out, fp32 sums in
    another order). The bound counts the K rows each request reads (its
    window), q and the output; the multiply-adds of the visible (row, key)
    pairs, Dk for the score and Dv for P @ V. Yardstick: SDPA over the
    pre-gathered latent K and V = its first 512 lanes (the math backend
    takes Dk != Dv; None where no backend takes the call). ``device_ms`` is
    a CUDA graph of the calls (the kernel and its combine without the
    wrapper's host time); ``workspace_bytes`` the fp32 partials or scratch
    the call allocates (``mla_plan``)."""
    import torch
    import torch.nn.functional as F

    ma, ref_mod = pkg["mla_attention"], pkg["attention"]
    B, Q, H, Dk = q.shape
    ps = k.shape[1]
    causal = kind == "prefill"
    if causal:
        qmask = ref_mod.causal_qmask(Q, "cuda")[None].expand(B, Q, Q)

    def run():
        return ma.mla_paged_attention(q, k, pt, ctx_t, qmask, scale, MLA_DV, causal=causal)

    def plain():
        return ma.mla_paged_attention_plain(q, k, pt, ctx_t, qmask, scale, MLA_DV)
    got = run()
    err, rel = _errs(got, plain())
    if not rel <= 2e-2:
        fail(f"mla_attention {kind} {case}: rel err {rel}")
    big = B * Q * H >= 4096
    ms = time_ms(run, reps=5 if big else 20)
    plain_ms = time_ms(plain, reps=2 if big else 5, warmup=1)
    gk = pkg["cache"].gather_kv_pages(k, pt, Dk, None, torch.bfloat16)  # [B, 1, L, Dk]
    mask = ref_mod.attention_mask(ctx_t, qmask, gk.shape[2])
    qt = q.transpose(1, 2)
    kx, vx = gk.expand(B, H, -1, Dk), gk[..., :MLA_DV].expand(B, H, -1, MLA_DV)
    lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
        qt, kx, vx, attn_mask=mask[:, None], scale=scale))
    del gk, kx, vx
    vis = int(mask.sum().item()) * H  # visible (row, key) pairs
    keys = int((ctx_t.long() + Q).clamp(max=pt.shape[1] * ps).sum().item())
    nbytes = keys * Dk * 2 + q.numel() * 2 + got.numel() * 2 + pt.numel() * 4
    row = _case(f"mla_attention[{kind}]", "mla_attention.cu", f"{MLA_SRC}:33 _mla_kernel",
                err, rel, ms, plain_ms, bound_ms(nbytes, 2.0 * vis * (Dk + MLA_DV)),
                lib_ms, f"{case}B={B} Q={Q} H={H} ps={ps} ctx={ctx_t.tolist()}")
    row["device_ms"] = graph_ms(run, reps=5 if big else 10)
    plan = ma.mla_plan(B, Q, H, pt.shape[1], causal)
    row["workspace_bytes"] = 4 * (plan.workspace_floats + plan.scratch_floats)
    return row


def check_mla(pkg, g, kind, H, ctx, Q, qmask=None):
    import torch

    B = len(ctx)
    k, pt = mla_arena(g, B, max(ctx), Q)
    q = torch.randn(B, Q, H, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    if qmask is None:
        qmask = torch.ones(B, Q, Q, dtype=torch.bool, device="cuda")
    scale = (128 + 64) ** -0.5  # (nope + rope)^-0.5; the yarn factor does not steer the kernel
    return mla_row(pkg, kind, q, k, pt, ctx_t, qmask.expand(B, Q, Q), scale, "")


class MlaCapture(LaunchHooks):
    """K13's inputs at layer 0 in real runs of the MLA model, for holding K13
    against its plain version at the shapes the model gives it. With
    ``widest`` (serving) it keeps the widest decode and verify batch and
    every prefill batch of B >= 2 (``rows`` takes the one with the most rows
    resumed from the prefix cache, then the widest); without (the B = 1
    main path) the first call of each kind. Kept inputs are cloned at the
    call, in stream order (the arena moves on afterwards); choosing reads
    shapes and pointers only. The wrapped launches are the runs' own;
    ``rows`` launches afresh on the kept inputs."""

    def __init__(self, pkg, widest: bool):
        super().__init__(pkg)
        self.widest = widest
        self.kept, self.prefill = {}, []

    def install(self):
        self._wrap([(self.pkg["mla_attention"], "_launch", self._hook)])

    def _hook(self, orig):
        def hook(q, k_pages, pt, ctx, qmask, scale, v_dim, causal, **kw):
            if self._first_layer(k_pages) and kw.get("page_range") is None:
                B, Q = q.shape[:2]
                kind = "decode" if Q == 1 else ("prefill" if causal else "verify")
                old = self.kept.get(kind)
                if self.widest and kind == "prefill":
                    keep = B >= 2 and len(self.prefill) < 8
                else:
                    keep = old is None or (self.widest and B > old["q"].shape[0])
                if keep:
                    c = dict(q=q.clone(), k=k_pages.clone(), pt=pt.clone(), ctx=ctx.clone(),
                             scale=scale, qmask=self._clone(qmask))
                    if self.widest and kind == "prefill":
                        self.prefill.append(c)
                    else:
                        self.kept[kind] = c
            return orig(q, k_pages, pt, ctx, qmask, scale, v_dim, causal, **kw)
        return hook

    def rows(self, case: str) -> list:
        """The kept calls against mla_paged_attention_plain (mla_row); forgets
        them afterwards."""
        import torch

        if self.prefill:
            self.kept["prefill"] = max(self.prefill, key=lambda c: (
                int((c["ctx"] > 0).sum().item()), c["q"].shape[0]))
        out = []
        for kind in ("decode", "verify", "prefill"):
            c = self.kept.get(kind)
            if c is None:
                fail(f"{case}: K13 made no {kind} call"
                     + (" of B >= 2" if self.widest and kind == "prefill" else ""))
            B, Q = c["q"].shape[:2]
            qmask = c["qmask"]
            if qmask is None:
                qmask = torch.ones(B, Q, Q, dtype=torch.bool, device="cuda")
            ctx = c["ctx"]
            label = f"{case} ctx={int(ctx.min())}-{int(ctx.max())} "
            if kind == "prefill":
                label += f"resumed_rows={int((ctx > 0).sum())} "
            out.append(mla_row(self.pkg, kind, c["q"], c["k"], c["pt"], ctx, qmask,
                               c["scale"], label))
        self.kept, self.prefill = {}, []
        return out


def absorption_row(pkg, g, M, K, N, what):
    """The head-batched bf16 GEMM (16 heads) against its plain version, timed;
    torch.bmm as the yardstick."""
    import torch

    mm = pkg["moe_matmul"]
    x = torch.randn(16, M, K, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(16, K, N, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
    got, ref = mm.dense_matmul_batched(x, w), mm.dense_matmul_batched_plain(x, w)
    err, rel = _errs(got, ref)
    if not rel <= 2e-2:
        fail(f"bf16_gemm_batched {what} M={M}: rel err {rel}")
    ms = time_ms(lambda: mm.dense_matmul_batched(x, w))
    dev_ms = graph_ms(lambda: mm.dense_matmul_batched(x, w))
    plain_ms = time_ms(lambda: mm.dense_matmul_batched_plain(x, w), reps=5)
    lib_ms = time_ms(lambda: torch.bmm(x, w))
    nbytes = (x.numel() + w.numel() + got.numel()) * 2
    row = _case("batched_bf16_gemm", "grouped_gemm.cu",
                f"{MOE}:77 _gmm_kernel (one weight per head: the MLA absorption, "
                f"XLA in {MLA_MODEL}:142, :187)", err, rel, ms, plain_ms,
                bound_ms(nbytes, 2.0 * 16 * M * K * N), lib_ms,
                f"{what} heads=16 M={M} K={K} N={N}")
    row["device_ms"] = dev_ms  # the kernel alone (a CUDA graph)
    return row


def check_mla_invariance(pkg, g) -> None:
    """A K13 row at Q = 1 equals the same row inside a 17-wide verify (the
    causal mask; windows ending inside a chunk and on both sides of a chunk
    edge), a 17-wide prefill (the causal flag), a 4096-row prefill (65 536
    rows at 16 heads; rows on both sides of the chunk edges C and 2C) and a
    prefill resumed at a ctx that crosses an edge, for DeepSeek-V2-Lite's 16
    heads and V3's 128; an absorption product's rows are the same at M = 1,
    17 and 4096. Fails the run otherwise."""
    import torch

    ma, mm = pkg["mla_attention"], pkg["moe_matmul"]
    mpa = ma.mla_paged_attention
    C = ma.CHUNK_KEYS
    one = torch.ones(1, 1, 1, dtype=torch.bool, device="cuda")
    k, pt = mla_arena(g, 1, 4096, 17)
    causal = torch.ones(17, 17, dtype=torch.bool, device="cuda").tril()[None]
    for H in (16, 128):
        for c0 in (4000, 2 * C - 17, 2 * C - 16):  # last key 4016, 2C - 1, 2C
            ctx0 = torch.tensor([c0], dtype=torch.int32, device="cuda")
            q = torch.randn(1, 17, H, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
            wide = mpa(q, k, pt, ctx0, causal, 0.07, MLA_DV)
            if not torch.equal(wide, mpa(q, k, pt, ctx0, None, 0.07, MLA_DV, causal=True)):
                fail(f"mla_attention H={H} ctx={c0}: the causal flag differs from the mask")
            for t in (0, 7, 15, 16):
                row = mpa(q[:, t:t + 1].contiguous(), k, pt, ctx0 + t, one, 0.07, MLA_DV)
                if not torch.equal(row, wide[:, t:t + 1]):
                    fail(f"mla_attention H={H} ctx={c0}: row {t} changes with the verify "
                         "width")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    qp = torch.randn(1, 4096, 16, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    full = mpa(qp, k, pt, zero, None, 0.07, MLA_DV, causal=True)
    for t in (0, 63, 64, C - 1, C, C + 1, 2 * C, 2047, 4095):
        row = mpa(qp[:, t:t + 1].contiguous(), k, pt, zero + t, one, 0.07, MLA_DV)
        if not torch.equal(row, full[:, t:t + 1]):
            fail(f"mla_attention: row {t} of a 4096-token prefill differs from decode")
    c0 = C - 100  # a prefill chunk resumed across the edge at C
    part = mpa(qp[:, c0:c0 + 300].contiguous(), k, pt, zero + c0, None, 0.07, MLA_DV,
               causal=True)
    if not torch.equal(part, full[:, c0:c0 + 300]):
        fail(f"mla_attention: a prefill resumed at ctx {c0} differs from the whole prefill")
    for K, N in ((128, 512), (512, 128)):
        x = torch.randn(16, 4096, K, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(16, K, N, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
        whole = mm.dense_matmul_batched(x, w)
        for m in (1, 17):
            if not torch.equal(mm.dense_matmul_batched(x[:, :m].contiguous(), w),
                               whole[:, :m]):
                fail(f"bf16_gemm_batched K={K} N={N}: rows change with M (M={m})")
    print("phase mla invariance: mla_attention rows bit-identical at Q = 1, inside a "
          "17-wide verify and prefill (H = 16, 128; windows ending on a chunk edge), inside "
          "a 4096-token prefill (rows at the chunk edges) and a prefill resumed across an "
          "edge; the absorption products' rows bit-identical at M = 1, 17 and 4096")


def phase_mla_kernels(pkg) -> list:
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = pkg["device_tables"]
    branches = torch.randint(3, 1000, (2, 8), generator=g, device="cuda")
    _, _, tree, _ = dt.build_tree_inputs(torch.tensor(1, device="cuda"), branches)
    tree = tree[None]  # [1, 17, 17], R=2 L=8 tree mask
    rows = []
    for H in (16, 128):  # DeepSeek-V2-Lite, DeepSeek-V3
        for ctx in ((640, 4096) if H == 16 else (4096,)):
            rows.append(check_mla(pkg, g, "decode", H, [ctx], 1))
        rows.append(check_mla(pkg, g, "verify", H, [4096], 17, tree))
    # a tree verify of 129 rows (8 branches of 16) by the mask rule
    wide = _trees(pkg, g)[129][0]
    rows.append(check_mla(pkg, g, "verify", 16, [4096], 129, wide))
    rows.append(check_mla(pkg, g, "decode", 16, [63, 64, 65, 4095], 1))  # ragged B = 4
    for ctx in (0, 512):
        rows.append(check_mla(pkg, g, "prefill", 16, [ctx], 512))
    rows.append(check_mla(pkg, g, "prefill", 16, [0], MLA_PROMPT_LEN))  # the main path's
    for M in (1, 17, 4096):
        rows.append(absorption_row(pkg, g, M, 128, 512, "q_nope.W_uk^T"))
        rows.append(absorption_row(pkg, g, M, 512, 128, "out.W_uv"))
    check_mla_invariance(pkg, g)
    torch.cuda.synchronize()
    for r in rows:
        print("phase mla kernel: " + json.dumps(r))
    return rows


def phase_mla(pkg) -> dict:
    """DeepSeek-V2-Lite at full width and depth in bf16 (random weights): a
    4096-token prefill (grouped MoE route, K13's prefill mode), greedy AR
    and lookahead decode strictly lossless; then the 4-layer model serving
    the 16 requests, lookahead equal to AR. K13 is held against its plain
    version on the layer-0 inputs of both (MlaCapture); those rows are in
    ``kernels``."""
    import dataclasses

    import torch

    base = pkg["base"]
    full = pkg["config"].ModelConfig.deepseek_v2_lite()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    torch.cuda.empty_cache()
    params = base.init_params(full, torch.Generator(device="cuda").manual_seed(SEED),
                              dtype=torch.bfloat16)
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    label = (f"phase mla main path (DeepSeek-V2-Lite bf16, all {full.num_hidden_layers} "
             f"layers, {weights_gb:.1f} GB of weights)")
    row_writes = RowWriteCapture(pkg)
    row_writes.install()
    capture = MlaCapture(pkg, widest=False)
    capture.install()
    try:
        res = phase_main_path(pkg, full, None, params, MLA_AR_TOKENS, MLA_SPEC_TOKENS,
                              label, extras=False, prompt_len=MLA_PROMPT_LEN,
                              max_seq_len=MLA_PROMPT_LEN + 512, k10_steps=True)
    finally:
        capture.remove()
    res.update(layers=full.num_hidden_layers, prompt_len=MLA_PROMPT_LEN,
               weights_gb=weights_gb)
    add(res["launches"])
    need = ("mla_attention[decode]", "mla_attention[verify]", "mla_attention[prefill]",
            "batched_bf16_gemm", "grouped_gemm", "dense_bf16_gemm", "kv_compact_tail")
    if any(res["launches"][k] <= 0 for k in need) or any(
            v for k, v in res["launches"].items() if k.startswith("paged_attention")):
        fail(f"{label}: launches {res['launches']} (needed {need}, no paged_attention)")
    del params
    torch.cuda.empty_cache()
    # K13 against its plain version on the main path's own inputs (layer 0)
    kernels = capture.rows("main path")

    scfg = dataclasses.replace(full, num_hidden_layers=MLA_SERVE_LAYERS)
    params = base.init_params(scfg, torch.Generator(device="cuda").manual_seed(SEED),
                              dtype=torch.bfloat16)
    prompts = serving_prompts(scfg.vocab_size)
    launches = Launches(pkg)
    capture = MlaCapture(pkg, widest=True)
    capture.install()
    launches.reset()
    try:
        res_ar, ar_out, _ = serve_once(pkg, scfg, params, prompts, "none", False, "none")
        res_la, la_out, _ = serve_once(pkg, scfg, params, prompts, "none", True, "none")
    finally:
        capture.remove()
        row_writes.remove()
    serve_counts = launches.read()
    add(serve_counts)
    diff = [i for i, (a, b) in enumerate(zip(ar_out, la_out)) if a != b]
    res_la["identical_to_ar"] = not diff
    for r in (res_ar, res_la):
        print("phase mla serving run: " + json.dumps(r))
    print("phase mla serving launches: " + json.dumps(serve_counts))
    if diff:
        fail(f"mla serving: lookahead differs from AR on requests {diff}")
    if res_la["spec_steps"] <= 0 or res_ar["prefix_hit_tokens"] <= 0:
        fail("mla serving: no spec step or no prefix-cache hit")
    if any(serve_counts[f"mla_attention[{k}]"] <= 0 for k in ("decode", "verify", "prefill")):
        fail(f"mla serving: K13 did not run in every mode: {serve_counts}")
    del params
    torch.cuda.empty_cache()
    # K13 against its plain version on serving's inputs: B up to 8, ragged
    # ctx, tree verify, prefill resumed from the prefix cache
    kernels += capture.rows("serving")
    # K16 on the MLA writes (576-lane latent K and 512-lane V rows) of both
    kernels += row_writes.rows("mla main path and serving")
    for r in kernels:
        print("phase mla kernel: " + json.dumps(r))
    torch.cuda.empty_cache()
    return dict(main_path=res, serving=[res_ar, res_la], launches=totals, kernels=kernels)


# ---------------------------------------------------------------------------
# linear-attention hybrids: K14, K15, Ring-mini-linear-2.0
# ---------------------------------------------------------------------------

LA_SRC = "painlessinferenceacceleration_tpu/ops/linear_attention.py"
LA_MODEL = "painlessinferenceacceleration_tpu/models/linear_attn.py"
NORM_SRC = "painlessinferenceacceleration_tpu/ops/rmsnorm.py"
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM data sheet, dense TF32 tensor cores
LA_KERNELS = dict(chunk=3, decode=1, tree=1, commit=1)  # CUDA kernels a K14 call
LIN_PROMPT_LEN = 4096
LIN_AR_TOKENS = 32
LIN_SPEC_TOKENS = 64
LIN_SHARDS = 2  # expert shards: the routed grouped route (the scan sweeps 256 experts)
LIN_SERVE_LAYERS = 5  # one layer group: linear 0-3 (0 with the dense MLP), full 4
LIN_TEACHER_PROMPT = 512
LIN_H, LIN_D = 16, 128
LA_REPLACES = {
    "chunk": f"{LA_SRC}:29 _la_kernel",
    "tree": f"{LA_SRC}:105 _la_tree_kernel",
    "decode": f"{LA_SRC}:29 _la_kernel at C = 1 (the JAX package decodes C = 1 in jnp, "
              f"{LA_MODEL}:148)",
    "commit": f"{LA_MODEL}:370 commit_linear_states (jnp in the JAX package: no Pallas "
              f"body)",
}


def la_features(g, B, H, C, D):
    """silu'd q, k and raw v [B, H, C, D] fp32, as the block feeds K14."""
    import torch

    f = torch.nn.functional.silu
    q, k, v = (torch.randn(B, H, C, D, generator=g, device="cuda") * 0.5 for _ in range(3))
    return f(q), f(k), v


def la_loglam(pkg, H):
    la_model = pkg["linear_attn"]
    return la_model.loglam_of(la_model.default_decays(H, "cuda"))


def la_row(pkg, mode, args, case):
    """K14 in ``mode`` on these inputs against its plain version, timed.
    Chunk mode: 1e-5 of the largest value (the same sub-tiles, products in
    3xTF32 and summed in another order); decode, tree and commit repeat the
    plain version's operations one for one: equal bits. The bound counts q,
    k, v of the live tokens, the output, and the states each live row reads
    (and writes); the operations of the chunk form (scores, their products
    with v, q S and the state update per token) at the rate of the
    instructions the kernel issues for them, three TF32 products for each
    fp32 product on the tensor cores, or of the per-token step (3 D^2) and
    readout (2 D^2) at the card's fp32 rate. Beside the wall ``ms``: the
    device time with the L2 cold (``cold_ms``) and the CUDA kernels a call
    (``graph_kernels``). No single PyTorch call computes any of the four:
    library_ms is null."""
    import torch

    la = pkg["linear_attention"]
    if mode != "commit":
        B, H, Q, D = args[0].shape
    if mode == "chunk":
        q, k, v, arena, lens, ll, sid = args

        def run(st):
            return la.linear_attention_chunk(q, k, v, st, lens, ll, sid)[0]

        def plain(st):
            return la.linear_attention_chunk_plain(q, k, v, st, lens, ll, sid)[0]
        n = lens.tolist()
        live = sum(n)
        flops = 0.0
        for t in n:
            for t0 in range(0, t, 64):
                m = min(64, t - t0)
                flops += H * (m * 4.0 * D * D + 2.0 * D * m * (m + 1))
        nbytes = (3 * live * H * D + B * H * Q * D + 2 * sum(1 for t in n if t) * H * D * D) * 4
    elif mode in ("decode", "tree"):
        q, k, v, arena, parents, valid, ll, sid = args
        if mode == "decode":
            def run(st):
                return la.linear_attention_decode(q, k, v, st, valid, ll, sid)[0]

            def plain(st):
                return la.linear_attention_decode_plain(q, k, v, st, valid, ll, sid)[0]
        else:
            def run(st):
                return la.linear_attention_tree(q, k, v, st, parents, valid, ll, sid)

            def plain(st):
                return la.linear_attention_tree_plain(q, k, v, st, parents, valid, ll, sid)
        rows = int(valid[:, 0].sum().item())
        live = int((valid & valid[:, :1]).sum().item())
        flops = 5.0 * live * H * D * D
        nbytes = (3 * live * H * D + B * H * Q * D
                  + (2 if mode == "decode" else 1) * rows * H * D * D) * 4
    else:  # commit
        arena, wk, wv, chain, ncommit, ll, sid = args
        n_lin = arena.shape[0]
        _, B, H, Q, D = wk.shape

        def run(st):
            return la.linear_attention_commit(st, wk, wv, chain, ncommit, ll, sid)

        def plain(st):
            return la.linear_attention_commit_plain(st, wk, wv, chain, ncommit, ll, sid)
        nodes = int(ncommit.clamp(max=chain.shape[1]).sum().item())
        rows = int((ncommit > 0).sum().item())
        flops = 3.0 * n_lin * nodes * H * D * D
        nbytes = (2 * n_lin * nodes * H * D + 2 * n_lin * rows * H * D * D) * 4
    st_k, st_p = arena.clone(), arena.clone()
    got, ref = run(st_k), plain(st_p)
    torch.cuda.synchronize()
    err, rel = _errs(got, ref)
    serr, srel = _errs(st_k, st_p)
    if mode == "chunk":
        if not (rel <= 1e-5 and srel <= 1e-5):
            fail(f"linear_attention[chunk] {case}: rel err {rel} (state {srel}) > 1e-5")
    elif not (torch.equal(got, ref) and torch.equal(st_k, st_p)):
        fail(f"linear_attention[{mode}] {case}: differs from its plain version "
             f"(max {err}, state {serr})")
    big = mode == "chunk" and Q >= 512
    st_t = arena.clone()
    ms = time_ms(lambda: run(st_t), reps=5 if big else 20)
    device = cold_ms(lambda: run(st_t), reps=5 if big else 20)
    kernels = graph_kernels(lambda: run(st_t))
    plain_ms = time_ms(lambda: plain(st_t), reps=2 if big else 3, warmup=1)
    del st_k, st_p, st_t
    shape = (f"B={B} H={H} D={D} " + (f"C={Q} chunk_lens={lens.tolist()}" if mode == "chunk"
                                        else f"n_lin={arena.shape[0]} Q={Q} "
                                             f"n={ncommit.tolist()}" if mode == "commit"
                                        else f"Q={Q}"))
    bnd = (bound_ms(nbytes, 3.0 * flops, TF32_FLOPS) if mode == "chunk"
           else bound_ms(nbytes, flops, FP32_FLOPS))
    return dict(_case(f"linear_attention[{mode}]", "linear_attention.cu", LA_REPLACES[mode],
                      max(err, serr), max(rel, srel), ms, plain_ms, bnd, None, case + shape),
                device_ms=device, kernels_per_call=kernels)


def check_la(pkg, g, mode, B, Q, R=1, L=16, n=None):
    """K14 on seeded inputs at the model's heads (16) and head dim (128)."""
    import torch

    H, D = LIN_H, LIN_D
    ll = la_loglam(pkg, H)
    if mode == "commit":
        n_lin = 16  # Ring-mini-linear-2.0's linear layers
        arena = torch.randn(n_lin, B, H, D, D, generator=g, device="cuda") * 0.1
        _, wk, wv = la_features(g, n_lin * B, H, Q, D)
        wk, wv = (t.reshape(n_lin, B, H, Q, D) for t in (wk, wv))
        chain = torch.cat([torch.zeros(B, 1, dtype=torch.int32, device="cuda"),
                           1 + torch.arange(Q - 1, device="cuda", dtype=torch.int32)
                           .repeat(B, 1)], dim=1)
        ncommit = torch.tensor(n, dtype=torch.int32, device="cuda")
        sid = torch.arange(B, dtype=torch.int32, device="cuda")
        return la_row(pkg, mode, (arena, wk, wv, chain, ncommit, ll.repeat(n_lin, 1), sid),
                      "")
    q, k, v = la_features(g, B, H, Q, D)
    arena = torch.randn(B, H, D, D, generator=g, device="cuda") * 0.1  # a carried state
    sid = torch.arange(B, dtype=torch.int32, device="cuda")
    if mode == "chunk":
        lens = torch.tensor([Q] + [max(Q // 2, 0 if Q == 1 else 1)] * (B - 1),
                            dtype=torch.int32, device="cuda")
        return la_row(pkg, mode, (q, k, v, arena, lens, ll, sid), "")
    if mode == "decode":
        valid = torch.ones(B, 1, dtype=torch.bool, device="cuda")
        return la_row(pkg, mode, (q, k, v, arena, None, valid, ll, sid), "")
    branches = torch.randint(3, 1000, (B, R, L), generator=g, device="cuda")
    _, parents, _, _ = pkg["device_tables"].build_tree_inputs(
        torch.ones(B, dtype=torch.int32, device="cuda"), branches)
    return la_row(pkg, mode, (q, k, v, arena, parents, parents > -2, ll, sid),
                  f"R={R} L={L} ")


def norm_row(pkg, kind, x, w, gate, groups, case):
    """K15 on these rows against its fp64-summed plain version, timed: bf16
    within one bf16 ulp of the largest value (2^-7 relative; a value next
    to a rounding boundary may round the other way after the fp32 sum in
    another order), fp32 within 5e-7. Wall ms by ``paired_ms``, in turns
    with the yardstick, torch's rms_norm, for the plain kind where the
    installed torch has it (none for the grouped and gated kinds: no one
    call computes them); device ms with the L2 cold (``cold_ms``)."""
    import torch
    import torch.nn.functional as F

    rn = pkg["rmsnorm"]
    eps = 1e-6
    width = x.shape[-1]
    library = None
    if kind == "plain":
        def run():
            return rn.rms_norm(x, w, eps)

        def plain():
            return rn.rms_norm_plain(x, w, eps)
        if hasattr(F, "rms_norm"):
            def library():
                return F.rms_norm(x, (width,), w, eps)
    elif kind == "grouped":
        def run():
            return rn.rms_group_norm(x, w, eps, groups)

        def plain():
            return rn.rms_group_norm_plain(x, w, eps, groups)
    else:
        def run():
            return rn.rms_group_norm_sigmoid(x, gate, w, eps, groups)

        def plain():
            return rn.rms_group_norm_sigmoid_plain(x, gate, w, eps, groups)
    got = run()
    err, rel = _errs(got, plain())
    tol = 2 ** -7 if x.dtype == torch.bfloat16 else 5e-7
    if not rel <= tol:
        fail(f"rms_norm[{kind}] {case}: rel err {rel} > {tol}")
    # the wall in turns with the yardstick (both are the host's at small rows)
    ms, lib = paired_ms(run, library) if library else (paired_ms(run)[0], None)
    plain_ms = time_ms(plain, reps=5)
    n = x.numel()
    nbytes = (2 + (gate is not None)) * n * x.element_size() + w.numel() * w.element_size()
    rows = n // width
    row = _case(f"rms_norm[{kind}]", "rmsnorm.cu", f"{NORM_SRC}:85 _rmsnorm_kernel", err,
                rel, ms, plain_ms, bound_ms(nbytes, 4.0 * n, FP32_FLOPS), lib,
                f"{case}rows={rows} width={width} groups={groups} "
                f"dtype={str(x.dtype).split('.')[-1]}")
    row["device_ms"] = cold_ms(run)  # the kernel without the wrapper's host time
    return row


def check_norm(pkg, g, kind, rows, width, groups, case="", stride=None):
    """K15 on seeded bf16 rows; with ``stride``, the first ``width`` of each
    ``stride``-wide row (a view, as MLA's kv_a norm reads its latent)."""
    import torch

    x = (torch.randn(rows, stride or width, generator=g, device="cuda") * 2).to(torch.bfloat16)
    x = x[:, :width]
    w = (1 + 0.2 * torch.randn(width, generator=g, device="cuda")).to(torch.bfloat16)
    gate = torch.randn(rows, width, generator=g, device="cuda").to(torch.bfloat16)
    if stride:
        case += f"row stride={stride} "
    return norm_row(pkg, kind, x, w, gate if kind == "gated" else None, groups, case)


def check_linear_identities(pkg, g) -> None:
    """On the card: a node's verify row equals the AR decode row at its
    position; the state after committing n accepted nodes equals n AR
    steps (n = 1, 5, 17); K15 rows are identical at B.Q = 1, 17, 512 and
    4096 (hidden width, a per-head width and the gated group norm). Fails
    the run otherwise."""
    import torch

    la, rn = pkg["linear_attention"], pkg["rmsnorm"]
    H, D, R, L = LIN_H, LIN_D, 1, 16
    q, k, v = la_features(g, 1, H, 1 + R * L, D)
    s0 = torch.randn(1, H, D, D, generator=g, device="cuda") * 0.1
    ll = la_loglam(pkg, H)
    branches = torch.randint(3, 1000, (1, R, L), generator=g, device="cuda")
    _, parents, _, _ = pkg["device_tables"].build_tree_inputs(
        torch.ones(1, dtype=torch.int32, device="cuda"), branches)
    valid = parents > -2
    tree = la.linear_attention_tree(q, k, v, s0, parents, valid, ll)
    s_ar, states = s0.clone(), []
    for c in range(1 + R * L):
        o, _ = la.linear_attention_decode(*(t[:, :, c:c + 1].contiguous() for t in (q, k, v)),
                                          s_ar, valid[:, :1], ll)
        if not torch.equal(o[:, :, 0], tree[:, :, c]):
            fail(f"linear_attention: verify row {c} differs from the AR row")
        states.append(s_ar.clone())
    for n in (1, 5, 17):
        arena = s0[None].clone()
        la.linear_attention_commit(arena, k[None], v[None],
                                   torch.arange(17, device="cuda")[None],
                                   torch.tensor([n], device="cuda"), ll[None],
                                   torch.zeros(1, dtype=torch.int32, device="cuda"))
        if not torch.equal(arena[0], states[n - 1]):
            fail(f"linear_attention: the commit of {n} nodes differs from {n} AR steps")
    for width, groups, gated in ((2048, 1, False), (128, 1, False), (2048, 16, True)):
        x = torch.randn(4096, width, generator=g, device="cuda").to(torch.bfloat16)
        gate = torch.randn(4096, width, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.ones(width, dtype=torch.bfloat16, device="cuda")

        def norm(m):
            if gated:
                return rn.rms_group_norm_sigmoid(x[:m], gate[:m], w, 1e-6, groups)
            return rn.rms_group_norm(x[:m], w, 1e-6, groups)
        full = norm(4096)
        for m in (1, 17, 512):
            if not torch.equal(norm(m), full[:m]):
                fail(f"rms_norm width={width} groups={groups}: rows change with the "
                     f"batch (M={m})")
    print("phase linear identities: verify rows equal AR rows, the commit of 1 / 5 / 17 "
          "nodes equals as many AR steps, K15 rows bit-identical at 1, 17, 512 and 4096 "
          "rows (widths 2048 and 128, the gated group norm)")


def la_rows(pkg, g) -> list:
    """K14's rows at Ring-mini-linear-2.0's shapes (PERF.md rows 22-23):
    chunk mode at B = 2 (row 1 half padded) and C = 1 / 17 / 512 / 4096,
    and at the prefill's own B = 1, C = 4096; decode at B = 1 / 8, tree at
    Q = 17 (R = 1 L = 16, R = 2 L = 8), the commit of 1 / 5 / 17 nodes over
    16 layers. ``tools/la_rows.py --root`` takes them for another tree."""
    rows = []
    for C in (1, 17, 512, LIN_PROMPT_LEN):
        rows.append(check_la(pkg, g, "chunk", 2, C))
    rows.append(check_la(pkg, g, "chunk", 1, LIN_PROMPT_LEN))
    for B in (1, 8):
        rows.append(check_la(pkg, g, "decode", B, 1))
    for R, L in ((1, 16), (2, 8)):
        rows.append(check_la(pkg, g, "tree", 1, 1 + R * L, R=R, L=L))
    for n in (1, 5, 17):
        rows.append(check_la(pkg, g, "commit", 1, 17, n=[n]))
    return rows


def check_linear_invariance(pkg, g) -> None:
    """On the card, K14's chunk mode: a row's output and state bits depend
    on its own tokens only. The same 700 tokens alone (C = 700) and as row
    1 of a batch of 3 with 300 and 1000 tokens at a wider padded C (1000,
    strided views); a 1024-token chunk and the same tokens as two 512-token
    chunks (a prefill resumed at a multiple of the 64-token tile). Fails the
    run otherwise."""
    import torch

    la = pkg["linear_attention"]
    H, D, n = LIN_H, LIN_D, 700
    ll = la_loglam(pkg, H)
    q, k, v = la_features(g, 3, H, 1000, D)
    s0 = torch.randn(3, H, D, D, generator=g, device="cuda") * 0.1
    lens = torch.tensor([300, n, 1000], dtype=torch.int32, device="cuda")
    st_b = s0.clone()
    out_b, _ = la.linear_attention_chunk(q, k, v, st_b, lens, ll)
    st_1 = s0[1:2].clone()
    out_1, _ = la.linear_attention_chunk(*(t[1:2, :, :n].contiguous() for t in (q, k, v)),
                                         st_1, lens[1:2], ll)
    if not (torch.equal(out_b[1, :, :n], out_1[0]) and torch.equal(st_b[1], st_1[0])):
        fail("linear_attention[chunk]: a row's bits change with the batch and the padded "
             "width")
    q, k, v = la_features(g, 1, H, 1024, D)
    s0 = torch.randn(1, H, D, D, generator=g, device="cuda") * 0.1
    whole, parts = s0.clone(), s0.clone()
    full = torch.tensor([1024], dtype=torch.int32, device="cuda")
    half = torch.tensor([512], dtype=torch.int32, device="cuda")
    out_w, _ = la.linear_attention_chunk(q, k, v, whole, full, ll)
    outs = [la.linear_attention_chunk(*(t[:, :, c:c + 512] for t in (q, k, v)), parts, half,
                                      ll)[0] for c in (0, 512)]
    if not (torch.equal(out_w, torch.cat(outs, dim=2)) and torch.equal(whole, parts)):
        fail("linear_attention[chunk]: two 512-token chunks differ from one of 1024")
    print("phase linear invariance: chunk rows bit-identical alone (C = 700) and in a batch "
          "of 3 at C = 1000; a 1024-token chunk equals two of 512, output and state")


def phase_linear_kernels(pkg) -> list:
    """K14's four modes and K15 against their plain versions at
    Ring-mini-linear-2.0's shapes, K15 also at the earlier models' (every
    model's norms launch it), K14's CUDA kernels a call (LA_KERNELS), and
    the bit identities. Returns the kernels-line rows; the ungated group
    norm, which the model never runs, is checked and printed but kept out
    of the line."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = la_rows(pkg, g)
    for r in rows:
        mode = r["name"].split("[")[1].rstrip("]")
        if r["kernels_per_call"] != LA_KERNELS[mode]:
            fail(f"{r['name']} {r['case']}: {r['kernels_per_call']} CUDA kernels a call, not "
                 f"{LA_KERNELS[mode]}")
    check_linear_invariance(pkg, g)
    for r in (1, 17, 4096):
        rows.append(check_norm(pkg, g, "plain", r, 2048, 1))  # the hidden norms
        rows.append(check_norm(pkg, g, "plain", 16 * r, 128, 1, "per-head q/k "))
        rows.append(check_norm(pkg, g, "gated", r, 2048, 16, "output gate "))
    for r in (1, 512, 2048):  # Llama-2-7B's and Mixtral's hidden norms
        rows.append(check_norm(pkg, g, "plain", r, 4096, 1, "hidden 4096 "))
    for r in (1, 4096):  # DeepSeek-V2-Lite's kv_a norm: 512 of the 576-wide latent rows
        rows.append(check_norm(pkg, g, "plain", r, 512, 1, "MLA kv_a ", stride=576))
    extra = [check_norm(pkg, g, "grouped", r, 2048, 16) for r in (1, 4096)]
    check_linear_identities(pkg, g)
    torch.cuda.synchronize()
    for r in rows:
        print("phase linear kernel: " + json.dumps(r))
    for r in extra:
        print("phase linear kernel (not on the model's path): " + json.dumps(r))
    return rows


class LinearCapture(LaunchHooks):
    """K14's and K15's inputs in real serving calls, for holding them against
    their plain versions at the shapes serving gives them: K14 at the first
    linear layer (its state is the arena's first layer), the widest decode,
    tree and commit calls and up to 8 chunk calls of B >= 2 (``rows`` takes
    the one with the most live rows); K15 the call with the most rows of
    each kind and width. Inputs are cloned at the call, in stream order;
    choosing reads shapes and pointers only."""

    def __init__(self, pkg):
        super().__init__(pkg)
        self.kept, self.chunks, self.norms = {}, [], {}

    def install(self):
        la, rn = self.pkg["linear_attention"], self.pkg["rmsnorm"]
        self._wrap([(la, "_decode_cuda", self._decode),
                    (la, "_tree_cuda", self._tree),
                    (la, "_chunk_cuda", self._chunk),
                    (la, "_commit_cuda", self._commit),
                    (rn, "_launch", self._norm)])

    def _keep(self, mode, xq, xk, xv, state, parents, valid, loglam, slot_ids):
        old = self.kept.get(mode)
        if self._first_layer(state) and (old is None or xq.shape[0] > old[0].shape[0]):
            self.kept[mode] = tuple(self._clone(t) for t in (
                xq, xk, xv, state, parents, valid, loglam, slot_ids))

    def _decode(self, orig):
        def hook(xq, xk, xv, state, valid, loglam, slot_ids):
            self._keep("decode", xq, xk, xv, state, None, valid, loglam, slot_ids)
            return orig(xq, xk, xv, state, valid, loglam, slot_ids)
        return hook

    def _tree(self, orig):
        def hook(xq, xk, xv, state, parents, valid, loglam, slot_ids):
            self._keep("tree", xq, xk, xv, state, parents, valid, loglam, slot_ids)
            return orig(xq, xk, xv, state, parents, valid, loglam, slot_ids)
        return hook

    def _chunk(self, orig):
        def hook(xq, xk, xv, state, lens, loglam, slot_ids):
            if (self._first_layer(state) and xq.shape[0] >= 2
                    and len(self.chunks) < 8):
                self.chunks.append(tuple(self._clone(t) for t in (
                    xq, xk, xv, state, lens, loglam, slot_ids)))
            return orig(xq, xk, xv, state, lens, loglam, slot_ids)
        return hook

    def _commit(self, orig):
        def hook(state, wk, wv, chain, n, loglam, slot_ids):
            old = self.kept.get("commit")
            if old is None or wk.shape[1] > old[1].shape[1]:
                self.kept["commit"] = tuple(self._clone(t) for t in (
                    state, wk, wv, chain, n, loglam, slot_ids))
            return orig(state, wk, wv, chain, n, loglam, slot_ids)
        return hook

    def _norm(self, orig):
        def hook(x, weight, gate, eps, groups, wrapper):
            kind = {"rms_norm": "plain", "rms_group_norm": "grouped",
                    "rms_group_norm_sigmoid": "gated"}[wrapper.__name__]
            key = (kind, x.shape[-1])
            old = self.norms.get(key)
            if old is None or x.numel() > old[0].numel():
                self.norms[key] = (x.clone(), weight, self._clone(gate), groups)
            return orig(x, weight, gate, eps, groups, wrapper)
        return hook

    def rows(self, case: str) -> list:
        out = []
        if self.chunks:
            self.kept["chunk"] = max(self.chunks, key=lambda c: int((c[4] > 0).sum().item()))
        for mode in ("chunk", "decode", "tree", "commit"):
            c = self.kept.get(mode)
            if c is None:
                fail(f"{case}: K14 made no {mode} call")
            out.append(la_row(self.pkg, mode, c, f"{case} "))
        for (kind, width), (x, w, gate, groups) in sorted(self.norms.items()):
            x2 = x.reshape(-1, width)
            out.append(norm_row(self.pkg, kind, x2, w, None if gate is None
                                else gate.reshape(-1, width), groups, f"{case} "))
        self.kept, self.chunks, self.norms = {}, [], {}
        return out


def first_hybrid_layers(cfg, params, n: int):
    """A hybrid cut to its first n layers: the same per-layer weights."""
    import dataclasses

    return (dataclasses.replace(cfg, num_hidden_layers=n),
            dict(params, hybrid_layers=params["hybrid_layers"][:n]))


def teacher_forced_pair(pkg, cfg, params) -> dict:
    """Teacher-forced lookahead and teacher-forced AR over one stream (a
    64-token cycle, which the tables learn from the prompt, so drafts land
    and chains of up to 17 nodes are committed), from the same 512-token
    prefill: after the same tokens, every linear layer's state and the full
    layers' KV rows must be bit-equal."""
    import numpy as np
    import torch

    step, ms_mod, dt = pkg["step"], pkg["multistep"], pkg["device_tables"]
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=1)
    cycle = np.random.default_rng(SEED + 1).integers(10, cfg.vocab_size - 10, 64)
    teacher = torch.tensor(np.tile(cycle, 16)[None], dtype=torch.int32, device="cuda")
    P0 = LIN_TEACHER_PROMPT
    pt = torch.arange(1, 1 + ecfg.pages_per_req, dtype=torch.int32, device="cuda")[None]
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    ctx0 = torch.tensor([P0], dtype=torch.int32, device="cuda")

    def prefill():
        kv = pkg["cache"].init_kv_cache(cfg, ecfg)
        kv, _, _ = step.prefill_step(params, kv, cfg, teacher[:, :P0],
                                     torch.zeros(1, dtype=torch.int32, device="cuda"),
                                     ctx0, pt)
        return kv

    tcfg = dt.DraftTableConfig(buckets=16384, ways=8, branch_length=16, retrieve_count=1)
    tables = dt.init_draft_tables(tcfg)
    dt.update_tables_seq(tables, tcfg, teacher[0, :P0], P0)
    kv_la = prefill()
    t0 = time.perf_counter()
    out = ms_mod.multistep_spec_decode(params, kv_la, tables, cfg, tcfg, teacher[:, P0], ctx0,
                                       one, teacher[:, P0 - 17: P0 + 1], pt, n_steps=8,
                                       teacher=teacher, update_tables=False)
    n_tok = int(out[5][0]) - P0
    spec_s = time.perf_counter() - t0
    del tables
    kv_ar = prefill()
    t0 = time.perf_counter()
    ms_mod.multistep_decode(params, kv_ar, cfg, teacher[:, P0], ctx0, one, pt,
                            n_steps=n_tok, teacher=teacher)
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    ctx = P0 + n_tok
    pages = pt[0, : -(-ctx // 64)].long()
    same_kv = all(torch.equal(
        kv_la[n][:, pages].reshape(kv_la[n].shape[0], -1, kv_la[n].shape[-1])[:, :ctx],
        kv_ar[n][:, pages].reshape(kv_ar[n].shape[0], -1, kv_ar[n].shape[-1])[:, :ctx])
        for n in ("k", "v"))
    res = dict(tokens=n_tok, verify_steps=8, accepted_per_step=n_tok / 8,
               states_bit_equal=bool(torch.equal(kv_la["s"], kv_ar["s"])),
               kv_rows_bit_equal=bool(same_kv), spec_tok_s=n_tok / spec_s,
               ar_tok_s=n_tok / ar_s)
    print("phase linear teacher-forced pair: " + json.dumps(res))
    if n_tok <= 8 * 4:
        fail(f"teacher-forced pair: {n_tok} tokens in 8 verify steps (drafts never landed)")
    if not (res["states_bit_equal"] and res["kv_rows_bit_equal"]):
        fail("teacher-forced pair: lookahead and AR left different states or KV rows")
    del kv_la, kv_ar
    return res


def hybrid_generator_check(pkg, cfg, params) -> tuple:
    """The host-trie generator on the hybrid: 64 tokens of hier lookahead
    (decoding length 63: trie-shaped trees, whose parents K14's tree mode
    derives from the mask) equal the AR stream from the same 512-token
    prompt. Returns the result and the launches of both runs."""
    import numpy as np

    prompt = np.random.default_rng(SEED + 3).integers(10, cfg.vocab_size - 10,
                                                      LIN_TEACHER_PROMPT).tolist()
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=1,
                                      prefill_chunk=512, eos_token_id=-2,
                                      decoding_length=GEN_DECODING_LENGTH,
                                      branch_length=GEN_BRANCH_LENGTH)
    gen = pkg["generate"].LookaheadGenerator(params, cfg, ecfg)
    if not isinstance(gen.trie, pkg["native"].NativeDraftCache):
        fail(f"the hybrid's generator drafts from {type(gen.trie).__name__}")
    launches = Launches(pkg)
    launches.reset()
    out = {}
    for la in (True, False):
        t0 = time.perf_counter()
        out[la] = gen.generate(prompt, max_new_tokens=LIN_SPEC_TOKENS, use_lookahead=la)
        out[la] = (out[la], time.perf_counter() - t0)
    counts = launches.read()
    (la_out, la_s), (ar_out, ar_s) = out[True], out[False]
    res = dict(tokens=len(la_out.sequences), lookahead_tok_s=len(la_out.sequences) / la_s,
               ar_tok_s=len(ar_out.sequences) / ar_s, mean_edls=float(np.mean(la_out.edls[1:])),
               mean_dls=float(np.mean(la_out.dls[1:])),
               lookahead_equals_ar=la_out.sequences == ar_out.sequences)
    print("phase linear generator: " + json.dumps(res))
    if not res["lookahead_equals_ar"]:
        fail("hybrid generator: lookahead differs from AR")
    if counts["linear_attention[tree]"] <= 0 or res["mean_dls"] <= 1:
        fail(f"hybrid generator: no trie tree was verified ({counts})")
    return res, counts


def moe_route_costs(pkg, cfg, params) -> dict:
    """One MoE layer at T = 1 by the scan route (every one of the 256
    experts swept, ~10 eager launches each) and by the routed route in
    LIN_SHARDS expert shards, on one random bf16 input: why the phase runs
    the experts in shards."""
    import dataclasses

    import torch

    moe = pkg["moe"]
    lp = params["hybrid_layers"][1]
    x = (torch.randn(1, 1, cfg.hidden_size, generator=torch.Generator(device="cuda")
                     .manual_seed(SEED), device="cuda") * 0.5).to(torch.bfloat16)
    scan_cfg = dataclasses.replace(cfg, expert_parallel=False)
    scan = time_ms(lambda: moe.moe_block(lp, scan_cfg, None, x), reps=3, warmup=1)
    with moe.expert_shards(LIN_SHARDS):
        routed = time_ms(lambda: moe.moe_block(lp, cfg, None, x), reps=10, warmup=2)
    res = dict(T=1, scan_ms=scan, routed_shards_ms=routed, shards=LIN_SHARDS)
    print("phase linear moe routes: " + json.dumps(res))
    return res


def phase_linear(pkg) -> dict:
    """Ring-mini-linear-2.0 at full width and all 20 layers in bf16 (random
    weights from seed 0), its experts in LIN_SHARDS expert shards: a
    4096-token prefill, greedy AR and lookahead decode strictly lossless,
    the lookahead stream equal to the AR stream, and the teacher-forced
    pair; then its first 5 layers serving the 16 requests, lookahead equal
    to AR, no prefix hits, two requests equal when served alone. K14 and
    K15 are held against their plain versions on serving's inputs
    (LinearCapture); those rows are in ``kernels``."""
    import dataclasses

    import torch

    base, moe = pkg["base"], pkg["moe"]
    full = dataclasses.replace(pkg["config"].ModelConfig.ring_mini_linear_2(),
                               expert_parallel=True)
    totals = {}
    t_phase = time.perf_counter()

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    torch.cuda.empty_cache()
    params = base.init_params(full, torch.Generator(device="cuda").manual_seed(SEED),
                              dtype=torch.bfloat16)
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    label = (f"phase linear main path (Ring-mini-linear-2.0 bf16, all "
             f"{full.num_hidden_layers} layers, {weights_gb:.1f} GB of weights, "
             f"{LIN_SHARDS} expert shards)")
    with moe.expert_shards(LIN_SHARDS):
        res = phase_main_path(pkg, full, None, params, LIN_AR_TOKENS, LIN_SPEC_TOKENS,
                              label, extras=False, prompt_len=LIN_PROMPT_LEN,
                              max_seq_len=LIN_PROMPT_LEN + 512, k10_steps=True)
    res.update(layers=full.num_hidden_layers, prompt_len=LIN_PROMPT_LEN,
               weights_gb=weights_gb, expert_shards=LIN_SHARDS)
    add(res["launches"])
    lc = res["launches"]
    steps = dict(prefills=2, ar_steps=LIN_AR_TOKENS - 1, verify_steps=res["spec_steps"])
    res["k14_k15_launches"] = dict(steps, **{k: v for k, v in lc.items()
                                             if k.startswith(("linear_attention", "rms_norm"))})
    print("phase linear launches per run: " + json.dumps(res["k14_k15_launches"]))
    need = ("linear_attention[chunk]", "linear_attention[decode]", "linear_attention[tree]",
            "linear_attention[commit]", "rms_norm[plain]", "rms_norm[gated]",
            "paged_attention[decode]", "paged_attention[verify]", "paged_attention_prefill",
            "grouped_gemm", "kv_compact_tail")
    if any(lc[k] <= 0 for k in need):
        fail(f"{label}: launches {lc} (needed {need})")
    if res["spec_vs_ar_first_divergence"] != res["spec_vs_ar_compared"]:
        fail(f"{label}: the lookahead stream differs from the AR stream at token "
             f"{res['spec_vs_ar_first_divergence']}")
    with moe.expert_shards(LIN_SHARDS):
        res["teacher_forced"] = teacher_forced_pair(pkg, full, params)
        res["generator"], gen_counts = hybrid_generator_check(pkg, full, params)
    add(gen_counts)
    res["moe_routes"] = moe_route_costs(pkg, full, params)
    res["main_wall_s"] = time.perf_counter() - t_phase

    # serving: the first layer group (4 linear + 1 full layer)
    t_serve = time.perf_counter()
    scfg, sparams = first_hybrid_layers(full, params, LIN_SERVE_LAYERS)
    prompts = serving_prompts(scfg.vocab_size)
    launches = Launches(pkg)
    capture = LinearCapture(pkg)
    capture.install()
    launches.reset()
    try:
        with moe.expert_shards(LIN_SHARDS):
            res_ar, ar_out, _ = serve_once(pkg, scfg, sparams, prompts, "none", False, "none")
            res_la, la_out, _ = serve_once(pkg, scfg, sparams, prompts, "none", True, "none")
    finally:
        capture.remove()
    serve_counts = launches.read()
    add(serve_counts)
    diff = [i for i, (a, b) in enumerate(zip(ar_out, la_out)) if a != b]
    res_la["identical_to_ar"] = not diff
    solo = {}
    with moe.expert_shards(LIN_SHARDS):
        for i in (1, 2):
            one, one_out, _ = serve_once(pkg, scfg, sparams, [prompts[i]], "none", False,
                                         "none")
            solo[i] = one_out[0] == ar_out[i]
    res_ar["solo_equals_batch"] = solo
    for r in (res_ar, res_la):
        print("phase linear serving run: " + json.dumps(r))
    print("phase linear serving launches: " + json.dumps(serve_counts))
    if diff:
        fail(f"linear serving: lookahead differs from AR on requests {diff}")
    if res_la["spec_steps"] <= 0:
        fail("linear serving: no spec step")
    if res_ar["prefix_hit_tokens"] or res_la["prefix_hit_tokens"]:
        fail("linear serving: a hybrid matched a shared prefix")
    if not all(solo.values()):
        fail(f"linear serving: a request served alone differs from its batched self {solo}")
    modes = ("chunk", "decode", "tree", "commit")
    if any(serve_counts[f"linear_attention[{m}]"] <= 0 for m in modes):
        fail(f"linear serving: K14 did not run in every mode: {serve_counts}")
    del params, sparams
    torch.cuda.empty_cache()
    # K14 and K15 against their plain versions on serving's inputs
    kernels = capture.rows("serving")
    for r in kernels:
        print("phase linear kernel: " + json.dumps(r))
    res["serve_wall_s"] = time.perf_counter() - t_serve
    print(f"phase linear walls: main path {res['main_wall_s']:.1f} s, serving "
          f"{res['serve_wall_s']:.1f} s")
    torch.cuda.empty_cache()
    return dict(main_path=res, serving=[res_ar, res_la], launches=totals, kernels=kernels)


# ---------------------------------------------------------------------------
# IPAD: prune and distill at Llama-2-7B widths, then serve the pruned model
# ---------------------------------------------------------------------------

IPAD_LAYERS = 4  # of 32: an fp32 student with Adam holds ~16 bytes a parameter
IPAD_BATCH = (4, 512)  # B x T tokens a step
IPAD_STEPS = 4  # a stage
IPAD_PRUNE_STEPS = 2  # a pruning stage reaches its target at its second step
IPAD_LR = 1e-4
# every pruned width a multiple of 128: I 11008 -> 5504, 32 -> 24 kv groups,
# 4 -> 3 layers, E 4096 -> 3072
IPAD_STAGES = (("mlp", 0.5), ("head", 0.25), ("depth", 0.25), ("dim", 0.25),
               ("finetune", 0.0))
IPAD_FINETUNE = ("upper", (1, 2, 3))  # the embedding and layer 0 stay frozen
IPAD_MASKED_TOL = 2e-4  # the JAX package's own bound (tests/test_ipad.py)
# the served prefill logits against forward_logits on the same bf16 weights,
# of the largest |logit|: bf16 activations on both sides; int4 also
# rounds each dequantized weight q * s to bf16 in forward_logits, which K1
# keeps exact in fp32
IPAD_LOGIT_REL = {"none": 2e-2, "int4": 4e-2}


class MethodTimer:
    """Device-synchronised wall ms of every call of the wrapped methods
    (class attributes, restored by ``remove``)."""

    def __init__(self, targets):
        self.targets = targets  # (class, attribute, label)
        self.ms = {label: [] for _, _, label in targets}
        self._orig = []

    def install(self):
        import torch

        for owner, attr, label in self.targets:
            orig = getattr(owner, attr)
            self._orig.append((owner, attr, orig))

            def timed(*a, _orig=orig, _label=label, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_label].append(1e3 * (time.perf_counter() - t0))
                return out

            setattr(owner, attr, timed)

    def remove(self):
        for owner, attr, orig in reversed(self._orig):
            setattr(owner, attr, orig)
        self._orig.clear()


def _stacked_leaves(params, fn):
    """``params`` with every linear leaf (the stacked layer weights a layer
    at a time, and the LM head) replaced by ``fn(leaf)``."""
    import torch

    def stacked(w):  # a tensor, or a quantized leaf's dict of tensors
        n = len(next(iter(w.values()))) if isinstance(w, dict) else len(w)
        per = [fn({k: v[li] for k, v in w.items()} if isinstance(w, dict) else w[li])
               for li in range(n)]
        if isinstance(per[0], dict):
            return {k: torch.stack([p[k] for p in per]) for k in per[0]}
        return torch.stack(per)

    out = dict(params, layers=dict(params["layers"]))
    for k in ("wqkv", "wo", "wgu", "wdown"):
        out["layers"][k] = stacked(params["layers"][k])
    if "lm_head" in params:
        out["lm_head"] = fn(params["lm_head"])
    return out


def served_logits(pkg, cfg, params, quant, toks):
    """The serving forward's logits [B, T, V] of a causal prefill of
    ``toks`` from an empty bf16 arena (every row, through the kernels)."""
    import torch

    B, T = toks.shape
    ecfg = pkg["config"].EngineConfig(page_size=64, max_seq_len=1024, max_concurrency=B)
    kv = pkg["cache"].init_kv_cache(cfg, ecfg, dtype=torch.bfloat16, device="cuda")
    P = ecfg.pages_per_req
    pt = torch.arange(1, 1 + B * P, dtype=torch.int32, device="cuda").reshape(B, P)
    pos = torch.arange(T, device="cuda")[None].expand(B, T)
    qmask = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()[None].expand(B, T, T)
    spec = pkg["linear"].QuantSpec.from_mode(quant)
    with torch.no_grad():
        h, _ = pkg["base"].transformer_hidden(
            params, cfg, kv, toks, pos, pt, torch.zeros(B, dtype=torch.int32, device="cuda"),
            qmask, torch.ones(B, T, dtype=torch.bool, device="cuda"), spec,
            causal_window=True)
        return pkg["base"].logits_from_hidden(params, cfg, h, spec)


def grads_deterministic(pkg, d, toks) -> dict:
    """The student's gradients of one loss twice on the same inputs: which
    leaves' bits differ (torch's CUDA embedding backward among them)."""
    import torch

    optim = pkg["optim"]
    tl, th = d._teacher_logits(toks)
    runs = []
    for _ in range(2):
        live = optim.tree_map(lambda p: p.detach().requires_grad_(True), d.student)
        with torch.enable_grad():
            loss = d._loss(live, toks, tl, th.float())[0]
            runs.append(torch.autograd.grad(loss, optim.tree_leaves(live)))
        del live
    names = []
    for k, v in d.student.items():
        names += [f"layers/{kk}" for kk in v] if isinstance(v, dict) else [k]
    differ = [n for n, a, b in zip(names, *runs) if not torch.equal(a, b)]
    return dict(deterministic=not differ, leaves_differing=differ)


def phase_ipad(pkg) -> dict:
    """IPAD on the card: a ``DistillPipe`` of five stages (mlp 0.5, head
    0.25, depth 0.25, dim 0.25, an ``upper`` finetune of layers 1-3) trains
    an fp32 student of Llama-2-7B's widths at IPAD_LAYERS layers (random bf16
    teacher from ``init_params``, seed SEED) on numpy tokens (B x T =
    IPAD_BATCH, seed SEED), fp32 products (TF32 left off, torch's default).
    Fails unless the reparam'd model's ``forward_logits`` are within
    IPAD_MASKED_TOL of the masked student's, the leaves outside the
    finetune's trainable set are bit-unchanged, and the pruned model, cast to
    bf16 and served by ``LLM`` at page 64 in bf16 (K10) and in int4 group 128
    (K1), completes the 16 requests with lookahead equal to AR and its
    prefill logits within IPAD_LOGIT_REL of ``forward_logits`` on the same
    bf16 weights (the dequantized ones for int4); also whether two
    gradients of one loss are bit-equal (the embedding backward among
    them). Prints the train step's,
    the teacher forward's and AdamW's median ms, training tokens/s, the peak
    memory, the reparam's s, and the pruned and unpruned models' AR and
    lookahead tok/s served the same way; the kernels' launches counted from
    0 over the serving runs."""
    import dataclasses

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    distill, tf, optim, lin = pkg["ipad"], pkg["train_forward"], pkg["optim"], pkg["linear"]
    cfg = dataclasses.replace(pkg["config"].ModelConfig.llama2_7b(),
                              num_hidden_layers=IPAD_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    teacher = pkg["base"].init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                      dtype=torch.bfloat16, device="cuda")
    B, T = IPAD_BATCH

    def batches(seed):
        rng = np.random.default_rng(seed)
        while True:
            yield rng.integers(1, cfg.vocab_size - 1, size=(B, T)).astype(np.int32)

    stages = [distill.DistillStage(mode=m, sparsity=s, steps=IPAD_STEPS,
                                   prune_steps=IPAD_PRUNE_STEPS, lr=IPAD_LR)
              for m, s in IPAD_STAGES[:-1]]
    stages.append(distill.DistillStage(mode="finetune", steps=IPAD_STEPS, lr=IPAD_LR,
                                       finetune_mode=IPAD_FINETUNE[0],
                                       layer_indices=IPAD_FINETUNE[1]))
    frozen = {}  # the finetune's frozen leaves as it starts: embed, layer 0
    set_finetune = distill.Distiller.set_finetune

    def snapshot(self, mode="full", layer_indices=None):
        if mode == IPAD_FINETUNE[0]:
            frozen["embed"] = self.student["embed"].clone()
            frozen["layers"] = {k: v[0].clone() for k, v in self.student["layers"].items()}
        return set_finetune(self, mode, layer_indices)

    timer = MethodTimer([(distill.Distiller, "_train_step", "train_step"),
                         (distill.Distiller, "_teacher_logits", "teacher"),
                         (optim.AdamW, "update", "adamw"),
                         (distill.Distiller, "reparam", "reparam")])
    distill.Distiller.set_finetune = snapshot
    timer.install()
    try:
        t0 = time.perf_counter()
        pipe = distill.DistillPipe(cfg, teacher, stages)
        new_cfg, new_params, hist = pipe.run(batches(SEED))
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
    finally:
        timer.remove()
        distill.Distiller.set_finetune = set_finetune
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    d = pipe.distiller
    frac = dict(IPAD_STAGES)
    kv = cfg.num_key_value_heads - int(frac["head"] * cfg.num_key_value_heads)
    want = (IPAD_LAYERS - int(frac["depth"] * IPAD_LAYERS),
            kv * (cfg.num_attention_heads // cfg.num_key_value_heads), kv,
            cfg.intermediate_size - int(frac["mlp"] * cfg.intermediate_size),
            cfg.hidden_size - int(frac["dim"] * cfg.hidden_size))
    got = (new_cfg.num_hidden_layers, new_cfg.num_attention_heads,
           new_cfg.num_key_value_heads, new_cfg.intermediate_size, new_cfg.hidden_size)
    if got != want:
        fail(f"phase ipad: the pruned model is (layers, heads, kv heads, I, E) = {got}, "
             f"not {want}")
    changed = [] if torch.equal(frozen["embed"], d.student["embed"]) else ["embed"]
    changed += [f"layers/{k}[0]" for k, v in frozen["layers"].items()
                if not torch.equal(v, d.student["layers"][k][0])]
    if changed:
        fail(f"phase ipad: leaves outside the finetune's trainable set changed: {changed}")
    eval_toks = torch.as_tensor(next(batches(SEED + 1)), device="cuda")
    with torch.no_grad():
        masked = tf.forward_logits(d.student, cfg, eval_toks, d.masks)
        sliced = tf.forward_logits(new_params, new_cfg, eval_toks)
    masked_err = float((masked - sliced).abs().max())
    if not torch.allclose(sliced, masked, rtol=IPAD_MASKED_TOL, atol=IPAD_MASKED_TOL):
        fail(f"phase ipad: the reparam'd model's logits differ from the masked student's "
             f"by {masked_err} (max |logit| {float(masked.abs().max())})")
    del masked, sliced
    determinism = grads_deterministic(pkg, d, eval_toks)
    med = {k: float(np.median(v)) for k, v in timer.ms.items()}
    train = dict(
        layers=IPAD_LAYERS, batch=[B, T], stages=[s for s, _ in IPAD_STAGES],
        steps=len(hist), train_step_ms=med["train_step"],
        train_tokens_s=B * T / (med["train_step"] / 1e3),
        pipe_tokens_s=len(hist) * B * T / pipe_s, pipe_s=pipe_s,
        teacher_forward_ms=med["teacher"], adamw_ms=med["adamw"],
        reparam_s=timer.ms["reparam"][0] / 1e3, peak_mem_gb=peak_gb,
        first_loss=hist[0]["loss"], last_loss=hist[-1]["loss"],
        masked_vs_sliced_max_abs_err=masked_err,
        frozen_leaves_unchanged=1 + len(frozen["layers"]),
        grads=determinism, allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        pruned=dict(layers=got[0], heads=got[1], kv_heads=got[2],
                    intermediate=got[3], hidden=got[4]))
    print("phase ipad train: " + json.dumps(train))
    del pipe, d, frozen
    torch.cuda.empty_cache()

    # serving: the pruned model beside the unpruned 4-layer teacher
    pruned16 = optim.tree_map(lambda x: x.to(torch.bfloat16), new_params)
    del new_params
    spec4 = lin.QuantSpec(bits=4, group=128)
    prompts = serving_prompts(cfg.vocab_size)
    launches = Launches(pkg)
    launches.reset()
    served, checks = {}, {}
    for name, mcfg, p16 in (("pruned", new_cfg, pruned16), ("unpruned", cfg, teacher)):
        for quant in ("none", "int4"):
            params = p16 if quant == "none" else _stacked_leaves(
                p16, lambda w: lin.quantize(w, spec4))
            ar, outs_ar, _ = serve_once(pkg, mcfg, params, prompts, "none", False, quant)
            la, outs_la, _ = serve_once(pkg, mcfg, params, prompts, "none", True, quant)
            if outs_la != outs_ar:
                bad = [i for i, (a, b) in enumerate(zip(outs_ar, outs_la)) if a != b]
                fail(f"phase ipad {name} {quant}: lookahead differs from AR on requests {bad}")
            served[f"{name}_{'bf16' if quant == 'none' else quant}"] = dict(
                layers=mcfg.num_hidden_layers, ar_tok_s=ar["tok_s"],
                lookahead_tok_s=la["tok_s"], spec_steps=la["spec_steps"],
                spec_accepted=la["spec_accepted"], requests=len(outs_ar),
                lossless_strict=True, ar=ar, lookahead=la)
            if name == "pruned":
                checks[quant] = params
    counts = launches.read()
    logit_check = {}
    for quant, params in checks.items():
        ref = pruned16 if quant == "none" else _stacked_leaves(
            params, lambda p: lin.dequantize(p, spec4, torch.bfloat16))
        toks = eval_toks[:2]
        got_l = served_logits(pkg, new_cfg, params, quant, toks)
        with torch.no_grad():
            want_l = tf.forward_logits(ref, new_cfg, toks)
        rel = float((got_l - want_l).abs().max() / want_l.abs().max())
        agree = float((got_l.argmax(-1) == want_l.argmax(-1)).double().mean())
        logit_check["bf16" if quant == "none" else quant] = dict(max_rel_err=rel,
                                                                   argmax_agreement=agree)
        if rel > IPAD_LOGIT_REL[quant]:
            fail(f"phase ipad pruned {quant}: the served prefill logits differ from "
                 f"forward_logits by rel {rel} (> {IPAD_LOGIT_REL[quant]})")
    print(f"phase ipad serve ({len(prompts)} requests, B <= 8, page 64; the pruned model "
          f"{got} beside the unpruned {IPAD_LAYERS} layers): "
          + json.dumps(dict(served={k: {kk: vv for kk, vv in v.items()
                                        if kk not in ("ar", "lookahead")}
                                    for k, v in served.items()},
                            prefill_logits=logit_check)))
    res = dict(train=train, served=served, prefill_logits=logit_check, launches=counts,
               wall_s=time.perf_counter() - t_phase)
    print(f"phase ipad: wall {res['wall_s']:.1f} s on {smi_line()}")
    del teacher, pruned16, checks
    torch.cuda.empty_cache()
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase dist: the parallel modules over torch.distributed, two ranks sharing
# the card over gloo
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_TIMEOUT_S = 600
DIST_TOKENS = 64  # AR and lookahead tokens of the TP run (Q = 17)
DIST_CP_PROMPT = 4096
DIST_CP_TOKENS = 32
DIST_CP_PAGES = 96  # 48 a rank: a 4096-token request's 66 pages straddle both


def dist_prompt(vocab: int, n: int, seed: int) -> list:
    """n prompt tokens: a seeded numpy draw of 32-token phrases repeated,
    so that lookahead's tables hold n-grams of the stream early."""
    import numpy as np

    rng = np.random.default_rng(seed)
    phrases = rng.integers(3, vocab - 1, (8, 32))
    return [int(t) for t in phrases[rng.integers(0, 8, -(-n // 32))].reshape(-1)[:n]]


def cp_attention_row(pkg, g, kind: str, ctx: int, Q: int, H: int = 32, D: int = 128,
                     Dv: int = 128, timed: bool = True, G: int = 1, tree=None) -> dict:
    """K2 (decode, verify) or K3 (prefill) with a page range and the
    log-sum-exp, at Llama-2-7B's attention shape (or H heads of (D, Dv)
    lanes, G of them a kv head: DeepSeek's expanded MLA at (192, 128),
    Qwen2.5-7B's G = 7, OPT-2.7B's 80 lanes), against their plain twin
    (``paged_attention_ref`` with the same range): the range holds half of
    the request's pages (a context-parallel rank's share). ``tree``: a
    [1, Q, Q] verify mask, the call then made as a context-parallel rank
    makes it (``ops/cp_attention.py cp_partial``: K2 under the mask at any
    width, past 128 rows too). The same call over the full range must give
    the bits of the call without one. Timed beside the present call (no
    range), with the bound of the range's keys and SDPA over the range's
    keys gathered as the yardstick; with ``timed`` False only the checks,
    and their errors returned."""
    import torch
    import torch.nn.functional as F

    pa, ref_mod, cache = pkg["paged_attention"], pkg["attention"], pkg["cache"]
    B, Hq, Hkv, ps = 1, H, H // G, 64
    P = -(-(ctx + Q) // ps)
    n_pages = 2 * P + 2
    k = torch.randn(n_pages, ps, Hkv * D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(n_pages, ps, Hkv * Dv, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda")[:P] + 1)[None].to(torch.int32)
    ctx_t = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(B, Q, Hq, D, generator=g, device="cuda").to(torch.bfloat16)
    qm = (ref_mod.causal_qmask(Q, "cuda")[None].expand(B, Q, Q) if tree is None
          else tree).contiguous()
    rng = (1, n_pages // 2)
    scale = D ** -0.5

    def call(**kw):
        if kind == "prefill":
            return pa.paged_attention_prefill(q, k, v, pt, ctx_t, scale, **kw)
        return pa.paged_attention(q, k, v, pt, ctx_t, qm, scale, **kw)

    def run():
        if tree is not None:
            return pkg["cp_attention"].cp_partial(q, k, v, pt, ctx_t, qm, scale, False, rng)
        return call(page_range=rng, return_lse=True)

    def plain():
        return ref_mod.paged_attention_ref(q, k, v, pt, ctx_t, qm, scale, page_range=rng,
                                           return_lse=True)
    (out, lse), (ref, ref_lse) = run(), plain()
    empty = torch.isinf(ref_lse)
    if not torch.equal(torch.isinf(lse), empty) or not (out[empty[..., None].expand_as(out)]
                                                         == 0).all():
        fail(f"cp attention {kind}: rows with no key in the range are not 0 with lse -inf")
    err, rel = _errs(out, ref)
    lse_err = (lse[~empty] - ref_lse[~empty]).abs().max().item() if (~empty).any() else 0.0
    if not (rel <= 2e-2 and lse_err <= 2e-3):
        fail(f"cp attention {kind}: rel err {rel}, lse err {lse_err}")
    full = call(page_range=(0, n_pages), return_lse=True)[0]
    if not torch.equal(full, call()):
        fail(f"cp attention {kind}: the full page range differs from the call without one")
    if not timed:
        return dict(kind=kind, heads=H, G=G, dims=[D, Dv], ctx=ctx, Q=Q,
                    mask="tree" if tree is not None else "causal", max_rel_err=rel,
                    lse_max_abs_err=lse_err, full_range_bit_equal=True)
    big = Q >= 256
    ms = time_ms(run, reps=10 if big else 20)
    dev_ms = graph_ms(run)
    whole_ms, whole_dev_ms = time_ms(call, reps=10 if big else 20), graph_ms(call)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    # the range's keys: those of its pages that the request reads
    ok = ((pt >= rng[0]) & (pt < rng[1])).repeat_interleave(ps, dim=1)[:, :ctx + Q]
    mask = ref_mod.attention_mask(ctx_t, qm, P * ps)[:, :, :ctx + Q] & ok[:, None, :]
    vis = int(mask.sum().item()) * Hq
    keys = int(ok.sum().item())
    nbytes = 2 * keys * Hkv * D * 2 + 2 * q.numel() * 2 + B * Q * Hq * 4
    sel = ok[0].nonzero()[:, 0]
    gk = cache.gather_kv_pages(k, pt, D, None, torch.bfloat16)[:, :, sel]
    gv = cache.gather_kv_pages(v, pt, D, None, torch.bfloat16)[:, :, sel]
    lib_mask = mask[:, None][..., sel]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), gk, gv, attn_mask=lib_mask, scale=scale), reps=10)
    name = "paged_attention_prefill[range]" if kind == "prefill" else \
        f"paged_attention[{kind},range]"
    row = _case(name, "paged_attention.cu", _attn_replaces(kind, "bf16"), err, rel, ms,
                plain_ms, bound_ms(nbytes, 4.0 * vis * D), lib_ms,
                f"ctx={ctx} B={B} Q={Q} Hq={Hq} Hkv={Hkv} ps={ps} pages {rng} of the "
                f"request's {P} (keys in range {keys} of {ctx + Q}) + lse")
    row.update(device_ms=dev_ms, lse_max_abs_err=lse_err, no_range_ms=whole_ms,
               no_range_device_ms=whole_dev_ms)
    return row


def mla_cp_row(pkg, g, kind: str, ctx: int, Q: int) -> dict:
    """K13 with a page range and the rows' log-sum-exp at DeepSeek-V2-Lite's
    latent shape (16 heads over one shared 576-lane row a token, the value
    its first 512 lanes), against its plain twin (``mla_paged_attention_plain``
    with the same range): the range holds half of the request's pages (a
    context-parallel rank's share), in the route of the width (decode and
    verify: a block a 512-key chunk and the combine; prefill: the walk).
    The full range must give the bits of the call without one. Timed beside
    the call without a range; the bound counts the range's keys (their K
    rows read once, q, the output and lse written once; 2 (576 + 512) FLOP
    a visible (row, key) pair), SDPA over the range's keys gathered (the
    latent expanded to the heads, V its first 512 lanes) the yardstick."""
    import torch
    import torch.nn.functional as F

    ma, ref_mod, cache = pkg["mla_attention"], pkg["attention"], pkg["cache"]
    B, H, ps = 1, 16, 64
    P = -(-(ctx + Q) // ps)
    n_pages = 2 * P + 2
    k = torch.randn(n_pages, ps, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    pt = (torch.randperm(n_pages - 1, generator=g, device="cuda")[:P] + 1)[None].to(torch.int32)
    ctx_t = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    q = torch.randn(B, Q, H, MLA_DK, generator=g, device="cuda").to(torch.bfloat16)
    qm = ref_mod.causal_qmask(Q, "cuda")[None].expand(B, Q, Q).contiguous()
    causal = kind == "prefill"
    rng = (1, n_pages // 2)
    scale = (128 + 64) ** -0.5

    def call(**kw):
        return ma.mla_paged_attention(q, k, pt, ctx_t, None if causal else qm, scale, MLA_DV,
                                      causal=causal, **kw)

    def run():
        return call(page_range=rng, return_lse=True)

    def plain():
        return ma.mla_paged_attention_plain(q, k, pt, ctx_t, qm, scale, MLA_DV,
                                            page_range=rng, return_lse=True)
    (out, lse), (ref, ref_lse) = run(), plain()
    empty = torch.isinf(ref_lse)
    if not torch.equal(torch.isinf(lse), empty) or not (out[empty] == 0).all():
        fail(f"mla cp attention {kind}: rows with no key in the range are not 0 with lse -inf")
    err, rel = _errs(out, ref)
    lse_err = (lse[~empty] - ref_lse[~empty]).abs().max().item() if (~empty).any() else 0.0
    if not (rel <= 2e-2 and lse_err <= 2e-3):
        fail(f"mla cp attention {kind}: rel err {rel}, lse err {lse_err}")
    full, full_lse = call(page_range=(0, n_pages), return_lse=True)
    if not torch.equal(full, call()) or not torch.isfinite(full_lse).all():
        fail(f"mla cp attention {kind}: the full page range differs from the call without one")
    big = Q >= 256
    ms = time_ms(run, reps=10 if big else 20)
    dev_ms = graph_ms(run)
    whole_ms, whole_dev_ms = time_ms(call, reps=10 if big else 20), graph_ms(call)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    ok = ((pt >= rng[0]) & (pt < rng[1])).repeat_interleave(ps, dim=1)[:, :ctx + Q]
    mask = ref_mod.attention_mask(ctx_t, qm, P * ps)[:, :, :ctx + Q] & ok[:, None, :]
    vis = int(mask.sum().item()) * H
    keys = int(ok.sum().item())
    nbytes = keys * MLA_DK * 2 + q.numel() * 2 + out.numel() * 2 + lse.numel() * 4
    sel = ok[0].nonzero()[:, 0]
    gk = cache.gather_kv_pages(k, pt, MLA_DK, None, torch.bfloat16)[:, :, sel]
    gk = gk.expand(B, H, -1, MLA_DK)
    gv = gk[..., :MLA_DV]
    lib_mask = mask[:, None][..., sel]
    lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), gk, gv, attn_mask=lib_mask, scale=scale))
    row = _case(f"mla_attention[{kind},range]", "mla_attention.cu",
                f"{MLA_SRC}:33 _mla_kernel", err, rel, ms, plain_ms,
                bound_ms(nbytes, 2.0 * vis * (MLA_DK + MLA_DV)), lib_ms,
                f"ctx={ctx} B={B} Q={Q} H={H} ps={ps} pages {rng} of the request's {P} "
                f"(keys in range {keys} of {ctx + Q}) + lse")
    row.update(device_ms=dev_ms, lse_max_abs_err=lse_err, no_range_ms=whole_ms,
               no_range_device_ms=whole_dev_ms)
    return row


def _dist_first_logits(pkg, eng, prompt) -> "torch.Tensor":
    """The fp32 logits of one prefill of ``prompt`` in the engine's arena
    (pages from 1), under the engine's rank state when it has one."""
    import torch

    comm = pkg["comm"]
    n, ps = len(prompt), eng.ecfg.page_size
    pt = torch.zeros((1, eng.ecfg.pages_per_req), dtype=torch.int32)
    pt[0, :-(-n // ps)] = torch.arange(1, 1 + -(-n // ps), dtype=torch.int32)
    st = getattr(eng, "rank_state", None)
    with comm.using(st) if st is not None else contextlib.nullcontext():
        _, _, logits = pkg["step"].prefill_step(
            eng.params, eng.kv, eng.cfg, torch.tensor([prompt], dtype=torch.int32,
                                                      device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.tensor([n], dtype=torch.int32, device="cuda"), pt.cuda(), eng.quant)
    return logits[0].float()


class _DistCounts:
    """The launch counts of the DistLLM serving runs alone (``_dist_serve``:
    reset just before each ``generate``, read just after, summed). The
    checks beside them (first-step logits, the merged attention, the MoE
    block) run outside ``run``, so their launches are dropped at the next
    reset."""

    def __init__(self, pkg):
        self.launches, self.total = Launches(pkg), {}

    def run(self, fn):
        import torch

        self.launches.reset()
        out = fn()
        torch.cuda.synchronize()
        for k, v in self.launches.read().items():
            self.total[k] = self.total.get(k, 0) + v
        return out


def _dist_serve(pkg, counts, dl, prompt, n_new) -> tuple:
    """One DistLLM.generate of one request: (tokens, numbers)."""
    import torch

    st = dl.rank_state
    st.comm_s, st.comm_n = 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    req = counts.run(lambda: dl.generate([prompt], pkg["request"].SamplingParams(
        max_new_tokens=n_new))[0])
    wall = time.perf_counter() - t0
    m = dl.metrics
    steps = m.spec_steps + m.decode_steps
    if len(req.output_ids) != n_new:
        fail(f"phase dist: a request stopped early ({len(req.output_ids)} of {n_new})")
    # a decode or verify step's ms: the decode phase's time (the draft tables'
    # updates included) over its steps; the collectives' share of the wall
    return req.output_ids, dict(wall_s=wall, prefill_s=m.prefill_time,
                                decode_s=m.decode_time, steps=steps,
                                step_ms=1e3 * m.decode_time / max(steps, 1),
                                collective_s=st.comm_s, collective_share=st.comm_s / wall,
                                collectives=st.comm_n, spec_steps=m.spec_steps,
                                spec_accepted=m.spec_accepted)


def _first_divergence(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def dist_tp_case(pkg, counts, rank, params, cfg) -> dict:
    """TP = 2: Llama-2-7B int4 at full width, 32 layers; each rank 16 heads,
    16 KV heads, I 5504 and 16000 vocabulary columns. A 512-token prefill,
    AR and lookahead (Q = 17) over DIST_TOKENS tokens: lookahead == AR bit for
    bit; on rank 0 the one-process LLM's first-step logits and tokens."""
    import torch

    config, dist_llm, llm_mod = pkg["config"], pkg["dist_llm"], pkg["llm"]
    prompt = dist_prompt(cfg.vocab_size, PROMPT_LEN, SEED + 21)
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=1, prefill_chunk=512,
              quant="int4", eos_token_id=-2, prefix_cache=False, decode_burst=8,
              decode_burst_idle=32)
    look = dict(use_lookahead=True, decoding_length=16, branch_length=16,
                use_spec_min_batch_size=1)
    out = {}
    if rank == 0:  # the one-process run on the same weights
        one = llm_mod.LLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw))
        ref_logits = _dist_first_logits(pkg, one, prompt)
        ref_tokens = one.generate([prompt], pkg["request"].SamplingParams(
            max_new_tokens=DIST_TOKENS))[0].output_ids
        del one
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw),
                          mesh_shape=(1, DIST_WORLD))
    c = dl.cfg
    out["rank_shard"] = dict(heads=c.num_attention_heads, kv_heads=c.num_key_value_heads,
                             intermediate=c.intermediate_size,
                             head_columns=list(dl.rank_state.head_widths or ()))
    if (c.num_attention_heads, c.num_key_value_heads, c.intermediate_size) != (16, 16, 5504):
        fail(f"phase dist tp: rank {rank}'s shard is {out['rank_shard']}")
    logits = _dist_first_logits(pkg, dl, prompt)
    ar, out["ar"] = _dist_serve(pkg, counts, dl, prompt, DIST_TOKENS)
    del dl
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw, **look),
                          mesh_shape=(1, DIST_WORLD))
    la, out["lookahead"] = _dist_serve(pkg, counts, dl, prompt, DIST_TOKENS)
    del dl
    torch.cuda.empty_cache()
    if la != ar:
        fail(f"phase dist tp: lookahead differs from AR at token {_first_divergence(la, ar)}")
    out["lossless"] = True
    out["tokens"] = ar
    if rank == 0:
        out["vs_one_process"] = dict(
            first_logits_max_rel_err=_errs(logits, ref_logits)[1],
            argmax_equal=int(logits.argmax()) == int(ref_logits.argmax()),
            tokens_equal=ar == ref_tokens, first_divergence=_first_divergence(ar, ref_tokens))
        if not out["vs_one_process"]["first_logits_max_rel_err"] <= 2e-2:
            fail(f"phase dist tp: first-step logits against one process: "
                 f"{out['vs_one_process']}")
    return out


def dist_ep_case(pkg, counts, rank, mode: str = "int4") -> dict:
    """EP = 2: a Mixtral-8x7B-shaped stack at full width, 2 layers, int4
    experts (or ``mode`` "w8a8_fp8": activation-quantized e4m3 experts,
    which take the scan over a rank's experts, K8), 4 experts a rank.
    Layer 0's MoE block on one input is bit-equal to the one-process
    ``expert_shards(2)``; the stack serves lookahead == AR."""
    import dataclasses

    import torch

    config, dist_llm, base, moe = pkg["config"], pkg["dist_llm"], pkg["base"], pkg["moe"]
    cfg = dataclasses.replace(config.ModelConfig.mixtral_8x7b(), num_hidden_layers=2,
                              expert_parallel=True)
    spec = (pkg["linear"].QuantSpec(bits=4, group=128) if mode == "int4"
            else pkg["linear"].QuantSpec.from_mode(mode))
    params = base.init_params_quantized(cfg, spec,
                                        torch.Generator(device="cuda").manual_seed(SEED + 22))
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=1, prefill_chunk=512,
              quant=mode, eos_token_id=-2, prefix_cache=False)
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw),
                          mesh_shape=(1, DIST_WORLD))
    if dl.params["moe_layers"]["moe_wgu"]["q"].shape[1] != cfg.num_experts // DIST_WORLD:
        fail(f"phase dist ep ({mode}): a rank does not hold its 4 experts")
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    h = (torch.randn(1, 17, cfg.hidden_size, generator=g, device="cuda") * 0.5).to(
        torch.bfloat16)
    got = moe.moe_block(base._layer_of(dl.params["moe_layers"], 0), dl.cfg, dl.quant, h,
                        dl.rank_state)
    with moe.expert_shards(DIST_WORLD):
        want = moe.moe_block(base._layer_of(params["moe_layers"], 0), cfg, spec, h)
    if not torch.equal(got, want):
        fail(f"phase dist ep ({mode}): the rank-parallel MoE block differs from "
             f"expert_shards(2): rel err {_errs(got, want)[1]}")
    prompt = dist_prompt(cfg.vocab_size, 256, SEED + 24)
    ar, ar_res = _dist_serve(pkg, counts, dl, prompt, 32)
    del dl
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(
        **kw, use_lookahead=True, decoding_length=16, branch_length=16,
        use_spec_min_batch_size=1), mesh_shape=(1, DIST_WORLD))
    la, la_res = _dist_serve(pkg, counts, dl, prompt, 32)
    del dl, params
    torch.cuda.empty_cache()
    if la != ar:
        fail(f"phase dist ep ({mode}): lookahead differs from AR at token "
             f"{_first_divergence(la, ar)}")
    return dict(experts=mode, block_bit_equal=True, layers=2,
                experts_a_rank=cfg.num_experts // DIST_WORLD, ar=ar_res, lookahead=la_res,
                lossless=True, tokens=ar)


@contextlib.contextmanager
def _quantized(pkg, K: int):
    """Every (rows, int8 / e4m3 values, per-token scales) that the W8A8
    activation quantization (``ops/w8a8.py quant_act``, which every W8A8
    GEMM call goes through) makes of rows of K lanes while open, in call
    order: what the serving path hands its W8A8 kernel."""
    w8a8 = pkg["w8a8"]
    got, plain = [], w8a8.quant_act

    def record(x2, *args, **kw):
        xq, xs = plain(x2, *args, **kw)
        if x2.shape[-1] == K:
            got.append((x2, xq, xs))
        return xq, xs

    w8a8.quant_act = record
    try:
        yield got
    finally:
        w8a8.quant_act = plain


def tp_quant_check(pkg, dl, params, cfg, spec, h) -> dict:
    """Layer 0's MoE block on ``h`` under tensor parallelism (the rank state
    of ``dl``) and in one process over the whole weights, the activations
    of its expert down products taken from the serving path (``_quantized``:
    rows of the rank's and of the whole intermediate width, neither the
    hidden width): how many experts' int8 values and per-token scales on
    this rank equal its columns of one process's bit for bit, the largest
    relative gap of the scales and of the rows before quantization, and the
    blocks' rel err."""
    import torch

    base, moe = pkg["base"], pkg["moe"]
    st = dl.rank_state
    lo, hi = pkg["mesh"].plan_shards(cfg, st.model_size, params).moe[st.model_rank]
    with _quantized(pkg, hi - lo) as mine:
        got = moe.moe_block(base._layer_of(dl.params["moe_layers"], 0), dl.cfg, dl.quant, h,
                            st)
    with _quantized(pkg, cfg.moe_intermediate_size or cfg.intermediate_size) as one:
        want = moe.moe_block(base._layer_of(params["moe_layers"], 0), cfg, spec, h)
    n = cfg.num_experts
    if not len(mine) == len(one) == n:
        fail(f"phase dist moe_tp_w8a8: {len(mine)} / {len(one)} down-product quantizations "
             f"seen on rank {st.model_rank} / in one process, not one an expert ({n})")
    same = sum(bool(torch.equal(q_r, q_1[:, lo:hi]) and torch.equal(s_r, s_1))
               for (_, q_r, s_r), (_, q_1, s_1) in zip(mine, one))
    scale_gap = max(((s_r - s_1).abs() / s_1).max().item()
                    for (_, _, s_r), (_, _, s_1) in zip(mine, one))
    rows_gap = max(_errs(x_r, x_1[:, lo:hi])[1] for (x_r, _, _), (x_1, _, _) in zip(mine, one))
    return dict(columns=[lo, hi], experts=n, tokens=h.shape[1],
                bit_equal=same == n, experts_bit_equal=same,
                scales_max_rel_gap=scale_gap, rows_max_rel_err=rows_gap,
                block_max_rel_err=_errs(got, want)[1])


def dist_moe_tp_case(pkg, counts, rank) -> dict:
    """TP = 2 over a Mixtral-8x7B-shaped stack at full width, 2 layers, with
    dynamic W8A8 int8 experts (K8 on a rank's 7168 of every expert's 14336
    intermediate columns; the down products' activations quantized with the
    whole rows' amax, one gather a layer). Checked: each rank's quantized
    activations, taken from the serving path, are one process's columns
    bit for bit (``tp_quant_check``), layer 0's MoE block lies within rel
    2e-2 of one process's, the first-step logits pick one process's token,
    and lookahead == AR bit for bit. Recorded, not bounded: the first-step
    logits' error and the tokens against one process (bf16: each rank
    rounds its partials to bf16 before the fp32 sum over ranks, where one
    process rounds whole products). All checks run before a failure is
    reported, with every number."""
    import dataclasses

    import torch

    config, dist_llm, llm_mod, base = (pkg["config"], pkg["dist_llm"], pkg["llm"],
                                       pkg["base"])
    cfg = dataclasses.replace(config.ModelConfig.mixtral_8x7b(), num_hidden_layers=2)
    spec = pkg["linear"].QuantSpec.from_mode("w8a8_int8")
    params = base.init_params_quantized(cfg, spec,
                                        torch.Generator(device="cuda").manual_seed(SEED + 25))
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=1, prefill_chunk=512,
              quant="w8a8_int8", eos_token_id=-2, prefix_cache=False)
    prompt = dist_prompt(cfg.vocab_size, 256, SEED + 26)
    one = llm_mod.LLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw))
    ref_logits = _dist_first_logits(pkg, one, prompt)
    ref_tokens = one.generate([prompt], pkg["request"].SamplingParams(
        max_new_tokens=32))[0].output_ids
    del one
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw),
                          mesh_shape=(1, DIST_WORLD))
    if dl.rank_state.mode != "tp" or dl.cfg.moe_intermediate_size != 14336 // DIST_WORLD:
        fail(f"phase dist moe_tp_w8a8: rank {rank} is {dl.rank_state.mode} with "
             f"{dl.cfg.moe_intermediate_size} intermediate columns an expert")
    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    h = (torch.randn(1, 17, cfg.hidden_size, generator=g, device="cuda") * 0.5).to(
        torch.bfloat16)
    quant = tp_quant_check(pkg, dl, params, cfg, spec, h)
    logits = _dist_first_logits(pkg, dl, prompt)
    ar, ar_res = _dist_serve(pkg, counts, dl, prompt, 32)
    del dl
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(
        **kw, use_lookahead=True, decoding_length=16, branch_length=16,
        use_spec_min_batch_size=1), mesh_shape=(1, DIST_WORLD))
    la, la_res = _dist_serve(pkg, counts, dl, prompt, 32)
    del dl, params
    torch.cuda.empty_cache()
    err, rel = _errs(logits, ref_logits)
    vs_one = dict(first_logits_max_abs_err=err, first_logits_max_rel_err=rel,
                  argmax_equal=int(logits.argmax()) == int(ref_logits.argmax()),
                  tokens_equal=ar == ref_tokens,
                  first_divergence=_first_divergence(ar, ref_tokens))
    out = dict(experts="w8a8_int8", layers=2, quant=quant, vs_one_process=vs_one,
               ar=ar_res, lookahead=la_res, lossless=la == ar, tokens=ar)
    faults = []
    if not quant["bit_equal"]:
        faults.append(f"{quant['experts_bit_equal']} of {quant['experts']} experts' int8 "
                      f"activations equal one process's columns")
    if not quant["block_max_rel_err"] <= 2e-2:
        faults.append(f"layer 0's MoE block at rel err {quant['block_max_rel_err']}")
    if la != ar:
        faults.append(f"lookahead differs from AR at token {_first_divergence(la, ar)}")
    if not vs_one["argmax_equal"]:
        faults.append("the first-step logits pick another token than one process's")
    if faults:
        fail(f"phase dist moe_tp_w8a8 rank {rank}: " + "; ".join(faults) + ": "
             + json.dumps({k: v for k, v in out.items() if k != "tokens"}))
    return out


def moe_tp_rank(pkg, rank: int, port: int, out_path: Path) -> None:
    """One rank of ``--moe-tp-only``: phase dist's moe_tp_w8a8 case alone."""
    import torch

    pkg["multihost"].initialize_multihost(f"localhost:{port}", DIST_WORLD, rank,
                                          device="cuda")
    counts = _DistCounts(pkg)
    t0 = time.perf_counter()
    res = dict(moe_tp_w8a8=dist_moe_tp_case(pkg, counts, rank))
    res.update(launches=counts.total, wall_s=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    out_path.write_text(json.dumps(res))
    print(f"DIST_OK rank={rank}", flush=True)


@contextlib.contextmanager
def cp_oracle_attention(pkg, n: int):
    """For the body, the one-process forward's attention (``models/base.py
    _attention``, and MLA's ``models/mla.py _mla_attention``) is the
    context-parallel oracle: each of the ``n`` ranks' partials over the one
    arena, with that rank's global page range, merged in rank order
    (``cp_attention_oracle``)."""
    base, mla, cpa = pkg["base"], pkg["mla"], pkg["cp_attention"]

    def attend(xq, kv, li, page_tables, start_lens, qmask, causal, scale, alibi=None):
        return cpa.cp_attention_oracle(xq, kv["k"][li], kv["v"][li], page_tables,
                                       start_lens, qmask, causal, scale, n)

    def attend_mla(q, kv, li, page_tables, start_lens, qmask, causal, scale, latent_v_dim):
        return cpa.cp_attention_oracle(q, kv["k"][li], kv["v"][li], page_tables, start_lens,
                                       qmask, causal, scale, n, latent_v_dim)

    plain, base._attention = base._attention, attend
    plain_mla, mla._mla_attention = mla._mla_attention, attend_mla
    try:
        yield
    finally:
        base._attention, mla._mla_attention = plain, plain_mla


def _cp_merged_check(pkg, dl, one, cfg, n_tot: int, n_req: int, n: int, label: str) -> dict:
    """The merged attention of KV layer 0 at decode (Q = 1) and prefill (Q =
    512) widths over the keys the run wrote: the ranks' merge equals the
    oracle's bit for bit and lies within rel 2e-2 of one K2 / K3 call over
    the whole context (MLA's latent arena: K13 over the range, one K13 call
    unranged)."""
    import torch

    cpa, pa, ma = pkg["cp_attention"], pkg["paged_attention"], pkg["mla_attention"]
    latent = cfg.is_mla and cfg.mla_latent_cache
    H = cfg.num_attention_heads
    D = MLA_DK if latent else cfg.head_dim
    lv = MLA_DV if latent else None
    sc = (128 + 64) ** -0.5 if latent else cfg.head_dim ** -0.5
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    pt = torch.arange(1, 1 + n_req, dtype=torch.int32, device="cuda")[None]
    merged = {}
    for Q, ctx in ((1, n_tot - 2), (512, n_tot - 513)):
        q = torch.randn(1, Q, H, D, generator=g, device="cuda").to(torch.bfloat16)
        qm = pkg["attention"].causal_qmask(Q, "cuda")[None].contiguous()
        ctx_t = torch.full((1,), ctx, dtype=torch.int32, device="cuda")
        causal = Q > 128
        got = cpa.cp_attention(q, dl.kv, 0, pt, ctx_t, qm, causal, sc, dl.rank_state, lv)
        orc = cpa.cp_attention_oracle(q, one.kv["k"][0], one.kv["v"][0], pt, ctx_t, qm,
                                      causal, sc, n, lv)
        if latent:
            whole = ma.mla_paged_attention(q, one.kv["k"][0], pt, ctx_t, qm, sc, MLA_DV,
                                           causal=causal)
        elif causal:
            whole = pa.paged_attention_prefill(q, one.kv["k"][0], one.kv["v"][0], pt, ctx_t,
                                               sc)
        else:
            whole = pa.paged_attention(q, one.kv["k"][0], one.kv["v"][0], pt, ctx_t, qm, sc)
        rel = _errs(got, whole)[1]
        if not torch.equal(got, orc) or not rel <= 2e-2:
            fail(f"phase dist {label}: merged attention at Q={Q}: oracle equal "
                 f"{torch.equal(got, orc)}, rel err {rel} against one call")
        merged[f"Q={Q}"] = dict(oracle_bit_equal=True, max_rel_err_vs_one_call=rel)
    return merged


def dist_cp_case(pkg, counts, rank, params, cfg, label: str = "cp", quant: str = "int4",
                 n_new: int = DIST_CP_TOKENS) -> dict:
    """CP = 2, parameters replicated, a 4096-token prompt whose pages
    straddle both ranks (48 pages a rank): Llama-2-7B int4 (``cp``),
    DeepSeek-V2-Lite's latent MLA (``mla_cp``: K13 over each rank's pages)
    or Ring-mini-linear-2.0 (``hybrid_cp``: its full layers' pages split,
    its linear layers whole on every rank over the replicated states). CP
    AR == CP lookahead bit for bit; the one-process oracle
    (``cp_oracle_attention``, run on each rank) serves the same tokens and
    its arena equals this rank's pages bit for bit (a hybrid's states too);
    the merged attention equals the oracle's and is within rel 2e-2 of one
    unranged call (``_cp_merged_check``)."""
    import torch

    config, dist_llm, llm_mod = pkg["config"], pkg["dist_llm"], pkg["llm"]
    prompt = dist_prompt(cfg.vocab_size, DIST_CP_PROMPT, SEED + 25)
    n_tot = DIST_CP_PROMPT + n_new
    kw = dict(page_size=64, max_seq_len=n_tot + 128, max_concurrency=1, prefill_chunk=4096,
              quant=quant, eos_token_id=-2, prefix_cache=False, num_pages=DIST_CP_PAGES,
              context_parallel=True)
    per = DIST_CP_PAGES // DIST_WORLD
    lo, hi = rank * per, (rank + 1) * per
    n_req = -(-n_tot // 64)
    mine = [p for p in range(1, 1 + n_req) if lo <= p < hi]
    out = dict(model=cfg.model_type, layers=cfg.num_hidden_layers, pages_a_rank=per,
               request_pages=n_req, this_rank_pages=len(mine),
               visible_key_share=len(mine) * 64 / (n_req * 64))
    if not mine or len(mine) == n_req:
        fail(f"phase dist {label}: the request's pages do not straddle the ranks")
    with cp_oracle_attention(pkg, DIST_WORLD):  # the oracle: one process, the whole arena
        one = llm_mod.LLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw))
        ref = one.generate([prompt], pkg["request"].SamplingParams(
            max_new_tokens=n_new))[0].output_ids
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw),
                          mesh_shape=(1, DIST_WORLD))
    ar, out["ar"] = _dist_serve(pkg, counts, dl, prompt, n_new)
    if ar != ref:
        fail(f"phase dist {label}: the oracle's tokens differ at {_first_divergence(ar, ref)}")
    idx = torch.tensor(mine, device="cuda")
    for name in ("k", "v"):
        a, b = dl.kv[name][:, idx - lo + 1], one.kv[name][:, idx]
        if not torch.equal(a, b):
            fail(f"phase dist {label}: rank {rank}'s {name} pages differ from the oracle's "
                 f"arena (rel err {_errs(a, b)[1]})")
    if "s" in one.kv:
        if not torch.equal(dl.kv["s"], one.kv["s"]):
            fail(f"phase dist {label}: rank {rank}'s recurrent states differ from the "
                 "oracle's")
        out["states_bit_equal"] = True
    out["arena_equal_pages"] = len(mine)
    out["merged_attention"] = _cp_merged_check(pkg, dl, one, cfg, n_tot, n_req, DIST_WORLD,
                                               label)
    del dl, one
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(
        **kw, use_lookahead=True, decoding_length=16, branch_length=16,
        use_spec_min_batch_size=1), mesh_shape=(1, DIST_WORLD))
    la, out["lookahead"] = _dist_serve(pkg, counts, dl, prompt, n_new)
    del dl
    torch.cuda.empty_cache()
    if la != ar:
        fail(f"phase dist {label}: lookahead differs from AR at token "
             f"{_first_divergence(la, ar)}")
    out.update(lossless=True, tokens=ar)
    return out


def _dist_requests(pkg, counts, eng, prompts, mm, n_new):
    """Serve ``prompts`` (with ``mm``'s multimodal embeddings and their
    positions where given) through ``add_request`` and ``step``, under the
    launch counts when ``counts`` is given: (tokens, wall s, steps)."""
    import torch

    sp = pkg["request"].SamplingParams(max_new_tokens=n_new)

    def serve():
        reqs = [eng.add_request(p, sp, mm_embeds=None if m is None else m[0],
                                mm_positions=None if m is None else m[1])
                for p, m in zip(prompts, mm)]
        steps = 0
        while any(r.state != "finished" for r in reqs):
            eng.step()
            steps += 1
        return reqs, steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, steps = serve() if counts is None else counts.run(serve)
    wall = time.perf_counter() - t0
    toks = [r.output_ids for r in reqs]
    if any(len(t) != n_new for t in toks):
        fail(f"phase dist: a request stopped early ({[len(t) for t in toks]} of {n_new})")
    return toks, wall, steps


DIST_DP_TOKENS = 16


def dist_dp_case(pkg, counts, rank, params, cfg, label: str, quant: str, mm: bool) -> dict:
    """DP = 2 (mesh (2, 1)): each rank serves its block of the batch's rows
    with the whole model, and the ranks' K / V rows are replayed into every
    arena. Two requests (one a data group), lookahead on: Llama-2-7B int4
    with one request's prompt carrying multimodal embeddings over 8 of its
    positions (``mm_dp``), or Ring-mini-linear-2.0 (``hybrid_dp``: each
    group's linear layers over its slots' states, the changed slots shared
    after each step; the states ``s`` bit-equal on both ranks after every
    step). Both end on the tokens of the one-process ``LLM`` (AR) over the
    same requests."""
    import numpy as np
    import torch

    config, dist_llm, llm_mod, comm = pkg["config"], pkg["dist_llm"], pkg["llm"], pkg["comm"]
    prompts = [dist_prompt(cfg.vocab_size, 256, SEED + 31),
               dist_prompt(cfg.vocab_size, 192, SEED + 32)]
    extra = [None, None]
    if mm:
        emb = (np.random.default_rng(SEED + 33).normal(size=(8, cfg.hidden_size))
               * 0.02).astype(np.float32)
        extra[0] = (emb, list(range(40, 48)))
    # bursts of 4 steps, each a verify (no AR cooldown): a scheduler step is
    # 4 verify steps and their commits, and the states are checked after it
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=2, prefill_chunk=512,
              quant=quant, eos_token_id=-2, prefix_cache=False, decode_burst=4,
              decode_burst_idle=4)
    one = llm_mod.LLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw))
    ref, _, _ = _dist_requests(pkg, None, one, prompts, extra, DIST_DP_TOKENS)
    del one
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(
        **kw, use_lookahead=True, decoding_length=16, branch_length=16,
        use_spec_min_batch_size=2, spec_cooldown_bursts=0), mesh_shape=(DIST_WORLD, 1))
    out = dict(model=cfg.model_type, layers=cfg.num_hidden_layers, mesh=[DIST_WORLD, 1],
               multimodal_positions=8 if mm else 0)
    checked = [0]
    if "s" in dl.kv:  # the hybrid's states: the same bits on both ranks after every step
        step = dl.step

        def step_and_check():
            worked = step()
            comm.check_same(dl.kv["s"], None, rank, DIST_WORLD, "the recurrent states")
            checked[0] += 1
            return worked

        dl.step = step_and_check
    st = dl.rank_state
    st.comm_s, st.comm_n = 0.0, 0
    toks, wall, steps = _dist_requests(pkg, counts, dl, prompts, extra, DIST_DP_TOKENS)
    m = dl.metrics
    out.update(wall_s=wall, scheduler_steps=steps, spec_steps=m.spec_steps,
               spec_accepted=m.spec_accepted, collective_s=st.comm_s,
               collective_share=st.comm_s / wall, collectives=st.comm_n)
    if "s" in dl.kv:
        out["states_checked_steps"] = checked[0]
    del dl
    torch.cuda.empty_cache()
    if m.spec_steps <= 0:
        fail(f"phase dist {label}: no verify step ran under data parallelism")
    if toks != ref:
        fail(f"phase dist {label}: DP tokens differ from the one-process LLM's "
             f"({[_first_divergence(a, b) for a, b in zip(toks, ref)]})")
    out.update(equal_to_one_process=True, tokens=toks)
    return out


DIST_LAUNCH_TOKENS = 16


def dist_launch_case(pkg, counts, rank, params, cfg) -> dict:
    """``DistLLM.launch`` under TP = 2 (Llama-2-7B int4, 32 layers): rank 0
    binds the stdlib HTTP server on an ephemeral local port (rank 0 only)
    and serves one request over ``async_stream_generate`` and one over
    HTTP, sent while the first streams; rank 1 runs its follower loop
    (``launch_server``) until rank 0 stops. After the shutdown both ranks
    run ``DistLLM.generate`` over the same prompts: rank 0's streamed and
    HTTP tokens must equal it."""
    import asyncio
    import threading
    import urllib.request

    import torch

    config, dist_llm, server = pkg["config"], pkg["dist_llm"], pkg["server"]
    prompts = [dist_prompt(cfg.vocab_size, 200, SEED + 23),
               dist_prompt(cfg.vocab_size, 300, SEED + 24)]
    kw = dict(page_size=64, max_seq_len=1024, max_concurrency=2, prefill_chunk=512,
              quant="int4", eos_token_id=-2, decode_burst=8, decode_burst_idle=32)
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw),
                          mesh_shape=(1, DIST_WORLD))
    sp = pkg["request"].SamplingParams(max_new_tokens=DIST_LAUNCH_TOKENS)

    def launched():
        if rank != 0:
            server.launch_server(dl, prefer_fastapi=False)  # the follower loop
            return None
        srv = server.StdlibServer(dl, "127.0.0.1", 0)
        srv.start()
        got = [None, None]

        async def drain():
            return [t async for t in dl.async_stream_generate(prompts[0], sp)]

        th = threading.Thread(target=lambda: got.__setitem__(0, asyncio.run(drain())))
        th.start()
        time.sleep(0.05)
        body = json.dumps({"input_ids": prompts[1], "max_new_tokens": DIST_LAUNCH_TOKENS,
                           "stream": False}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=DIST_TIMEOUT_S) as r:
            got[1] = json.loads(r.read())["output_ids"]
        th.join()
        srv.stop()
        return got

    t0 = time.perf_counter()
    streams = counts.run(launched)
    wall = time.perf_counter() - t0
    gen = [r.output_ids for r in counts.run(lambda: dl.generate(prompts, sp))]
    del dl
    torch.cuda.empty_cache()
    out = dict(tokens=gen, launched_wall_s=wall, requests=len(prompts),
               new_tokens=DIST_LAUNCH_TOKENS)
    if rank == 0:
        if streams != gen:
            fail(f"phase dist launch: streamed / HTTP tokens {streams} differ from "
                 f"DistLLM.generate's {gen}")
        out["streams_equal_generate"] = True
    return out


DIST_MLA_LAYERS = 2  # DeepSeek-V2-Lite: its dense layer 0 and one of its 26 MoE layers
DIST_HYBRID_LAYERS = 5  # Ring-mini-linear-2.0: one layer group (linear 0-3, full 4)
DIST_NEW_TOKENS = 16  # the new and lookahead tokens of the MLA and hybrid CP runs


def dist_rank(pkg, rank: int, port: int, out_path: Path) -> None:
    """One rank of phase dist's two-rank group (a child process of the
    script)."""
    import dataclasses

    import torch

    pkg["multihost"].initialize_multihost(f"localhost:{port}", DIST_WORLD, rank,
                                          device="cuda")
    counts = _DistCounts(pkg)
    t0 = time.perf_counter()
    config, base, la = pkg["config"], pkg["base"], pkg["linear_attn"]
    cfg = config.ModelConfig.llama2_7b()
    spec = pkg["linear"].QuantSpec(bits=4, group=128)
    params = base.init_params_quantized(
        cfg, spec, torch.Generator(device="cuda").manual_seed(SEED))
    res = dict(tp=dist_tp_case(pkg, counts, rank, params, cfg))
    res["launch"] = dist_launch_case(pkg, counts, rank, params, cfg)
    res["cp"] = dist_cp_case(pkg, counts, rank, params, cfg)
    res["mm_dp"] = dist_dp_case(pkg, counts, rank, params, cfg, "mm_dp", "int4", mm=True)
    del params
    torch.cuda.empty_cache()
    res["ep"] = dist_ep_case(pkg, counts, rank)
    res["ep_w8a8"] = dist_ep_case(pkg, counts, rank, "w8a8_fp8")
    res["moe_tp_w8a8"] = dist_moe_tp_case(pkg, counts, rank)
    mla_cfg = dataclasses.replace(config.ModelConfig.deepseek_v2_lite(),
                                  num_hidden_layers=DIST_MLA_LAYERS)
    params = base.init_params(mla_cfg, torch.Generator(device="cuda").manual_seed(SEED + 30),
                              dtype=torch.bfloat16)
    res["mla_cp"] = dist_cp_case(pkg, counts, rank, params, mla_cfg, "mla_cp", "none",
                                 DIST_NEW_TOKENS)
    del params
    torch.cuda.empty_cache()
    # the hybrid's 256 experts in 2 expert shards within each rank (the routed
    # grouped route, as phase linear runs it; the scan sweeps every expert)
    hyb_cfg = dataclasses.replace(config.ModelConfig.ring_mini_linear_2(),
                                  num_hidden_layers=DIST_HYBRID_LAYERS, expert_parallel=True)
    params = la.init_hybrid_params(hyb_cfg,
                                   torch.Generator(device="cuda").manual_seed(SEED + 34),
                                   torch.bfloat16)
    with pkg["moe"].expert_shards(LIN_SHARDS):
        res["hybrid_cp"] = dist_cp_case(pkg, counts, rank, params, hyb_cfg, "hybrid_cp",
                                        "none", DIST_NEW_TOKENS)
        res["hybrid_dp"] = dist_dp_case(pkg, counts, rank, params, hyb_cfg, "hybrid_dp",
                                        "none", mm=False)
    del params
    torch.cuda.empty_cache()
    res.update(launches=counts.total, wall_s=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    out_path.write_text(json.dumps(res))
    print(f"DIST_OK rank={rank}", flush=True)


DIST4_WORLD = 4
DIST4_LAYERS = 8  # Llama-2-7B int4 at 8 of its 32 layers
DIST4_PAGES = 48  # 24 pages a model rank
DIST4_PROMPTS = (1100, 600)  # request 0's 18 pages lie on model rank 0, 1's 10 straddle
DIST4_TOKENS = 16


def dist4_rank(pkg, rank: int, port: int, out_path: Path) -> None:
    """One rank of phase dist's four-rank group: mesh (2, 2), context
    parallelism over the model axis beside a data axis (``cp_dp``). Each
    data group holds the whole arena split over its two model ranks' pages;
    two requests, one a data group, the other group's K / V rows replayed
    onto a rank's own pages. CP + DP AR == lookahead bit for bit; the
    one-process oracle (``cp_oracle_attention(2)``, on each rank) serves the
    same tokens, and this rank's pages of the requests equal its arena's
    bit for bit."""
    import dataclasses

    import torch

    pkg["multihost"].initialize_multihost(f"localhost:{port}", DIST4_WORLD, rank,
                                          device="cuda")
    counts = _DistCounts(pkg)
    t0 = time.perf_counter()
    config, dist_llm, llm_mod = pkg["config"], pkg["dist_llm"], pkg["llm"]
    cfg = dataclasses.replace(config.ModelConfig.llama2_7b(), num_hidden_layers=DIST4_LAYERS)
    params = pkg["base"].init_params_quantized(
        cfg, pkg["linear"].QuantSpec(bits=4, group=128),
        torch.Generator(device="cuda").manual_seed(SEED + 40))
    prompts = [dist_prompt(cfg.vocab_size, n, SEED + 41 + i)
               for i, n in enumerate(DIST4_PROMPTS)]
    kw = dict(page_size=64, max_seq_len=2048, max_concurrency=2, prefill_chunk=512,
              quant="int4", eos_token_id=-2, prefix_cache=False, num_pages=DIST4_PAGES,
              context_parallel=True)
    mesh = (2, 2)
    m_rank = rank % mesh[1]
    per = DIST4_PAGES // mesh[1]
    lo = m_rank * per
    with cp_oracle_attention(pkg, mesh[1]):
        one = llm_mod.LLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw))
        ref, _, _ = _dist_requests(pkg, None, one, prompts, [None, None], DIST4_TOKENS)
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(**kw),
                          mesh_shape=mesh)
    st = dl.rank_state
    if (st.dp, st.cp, dl.kv["k"].shape[1]) != (2, 2, per + 1):
        fail(f"phase dist cp_dp: rank {rank} is dp {st.dp}, cp {st.cp}, "
             f"{dl.kv['k'].shape[1]} local pages")
    st.comm_s, st.comm_n = 0.0, 0
    ar, wall, steps = _dist_requests(pkg, counts, dl, prompts, [None, None], DIST4_TOKENS)
    out = dict(model=cfg.model_type, layers=DIST4_LAYERS, mesh=list(mesh),
               pages_a_rank=per, ar=dict(wall_s=wall, scheduler_steps=steps,
                                         collective_s=st.comm_s, collectives=st.comm_n))
    if ar != ref:
        fail(f"phase dist cp_dp: the oracle's tokens differ "
             f"({[_first_divergence(a, b) for a, b in zip(ar, ref)]})")
    used = sum(-(-(n + DIST4_TOKENS) // 64) for n in DIST4_PROMPTS)
    mine = [p for p in range(1, 1 + used) if lo <= p < lo + per]
    if not mine:
        fail(f"phase dist cp_dp: rank {rank} holds none of the requests' pages")
    idx = torch.tensor(mine, device="cuda")
    for name in ("k", "v"):
        a, b = dl.kv[name][:, idx - lo + 1], one.kv[name][:, idx]
        if not torch.equal(a, b):
            fail(f"phase dist cp_dp: rank {rank}'s {name} pages differ from the oracle's "
                 f"arena (rel err {_errs(a, b)[1]})")
    out.update(arena_equal_pages=len(mine), request_pages=used)
    del dl, one
    torch.cuda.empty_cache()
    dl = dist_llm.DistLLM(cfg=cfg, params=params, ecfg=config.EngineConfig(
        **kw, use_lookahead=True, decoding_length=16, branch_length=16,
        use_spec_min_batch_size=2, spec_cooldown_bursts=0), mesh_shape=mesh)
    la, wall, steps = _dist_requests(pkg, counts, dl, prompts, [None, None], DIST4_TOKENS)
    if dl.metrics.spec_steps <= 0:
        fail("phase dist cp_dp: no verify step ran")
    out["lookahead"] = dict(wall_s=wall, scheduler_steps=steps,
                            spec_steps=dl.metrics.spec_steps,
                            spec_accepted=dl.metrics.spec_accepted)
    del dl, params
    torch.cuda.empty_cache()
    if la != ar:
        fail(f"phase dist cp_dp: lookahead differs from AR "
             f"({[_first_divergence(a, b) for a, b in zip(la, ar)]})")
    out.update(lossless=True, tokens=ar)
    res = dict(cp_dp=out, launches=counts.total, wall_s=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    out_path.write_text(json.dumps(res))
    print(f"DIST_OK rank={rank}", flush=True)


DIST_PATH_KERNELS = ("int4_gemm", "kv_write_step", "paged_attention[decode]",
                     "paged_attention[verify]", "paged_attention_prefill",
                     "paged_attention[decode,range]", "paged_attention[verify,range]",
                     "paged_attention_prefill[range]", "mla_attention[decode,range]",
                     "mla_attention[verify,range]", "mla_attention[prefill,range]",
                     "linear_attention[chunk]", "linear_attention[decode]",
                     "linear_attention[tree]", "linear_attention[commit]",
                     "rms_norm[plain]", "w8a8_gemm[fp8]", "w8a8_gemm[int8]",
                     "dense_bf16_gemm")
DIST_CASES = ("tp", "launch", "cp", "mm_dp", "ep", "ep_w8a8", "moe_tp_w8a8", "mla_cp",
              "hybrid_cp", "hybrid_dp")


def _spawn_ranks(world: int, flag: str, port: int, tmp: Path, tag: str) -> tuple:
    """``world`` child processes of this script, each one rank (``flag``)."""
    outs = [tmp / f"{tag}_rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), flag, str(r),
                               "--dist-port", str(port), "--dist-out", str(outs[r])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, outs


def _free_port() -> int:
    with __import__("socket").socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_dist(pkg) -> dict:
    """The parallel modules on the card: K2 / K3 and K13 with a page range and
    the log-sum-exp against their plain twin (this process; K2 / K3 also at
    DeepSeek's expanded (192, 128)), then two groups of ranks spawned as
    child processes at once, sharing the card over gloo (NCCL refuses two
    ranks on one device): two ranks serve tensor, context, data and expert
    parallelism (``dist_rank``), four ranks context parallelism beside a
    data axis (``dist4_rank``). A rank that fails, times out or does not
    print its OK line fails the run. The gloo times go through the host:
    they are not NCCL times, and the two groups share the host's cores."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = [cp_attention_row(pkg, g, "decode", 4096, 1),
            cp_attention_row(pkg, g, "verify", 4096, 17),
            cp_attention_row(pkg, g, "prefill", 3584, 512),
            mla_cp_row(pkg, g, "decode", 4096, 1),
            mla_cp_row(pkg, g, "verify", 4096, 17),
            mla_cp_row(pkg, g, "prefill", 3584, 512)]
    for r in rows:
        print("phase dist kernel: " + json.dumps(r))
    expanded = [cp_attention_row(pkg, g, kind, ctx, Q, H=16, D=192, Dv=128, timed=False)
                for kind, ctx, Q in (("decode", 4096, 1), ("verify", 4096, 17),
                                     ("prefill", 3584, 512))]
    print("phase dist expanded MLA (K2 / K3 ranged at (192, 128) against their plain "
          "twin): " + json.dumps(expanded))
    trees = _trees(pkg, g)
    geometries = [cp_attention_row(pkg, g, kind, ctx, Q, H=H, D=D, Dv=D, timed=False, G=G,
                                   tree=trees[Q][0] if kind == "verify" else None)
                  for H, G, D in ((28, 7, 128), (32, 1, 80))
                  for kind, ctx, Q in (("verify", 1000, 17), ("verify", 1000, 129),
                                       ("prefill", 700, 300))]
    print("phase dist new geometries (cp_partial's ranged K2 under a tree mask at Q = 17 "
          "and 129, K3 ranged at Q = 300, at G = 7 and at 80 lanes, against their plain "
          "twin): " + json.dumps(geometries))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    groups = [_spawn_ranks(DIST_WORLD, "--dist-rank", _free_port(), tmp, "two"),
              _spawn_ranks(DIST4_WORLD, "--dist4-rank", _free_port(), tmp, "four")]
    procs = [p for ps, _ in groups for p in ps]
    logs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            left = max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0))
            logs[i], _ = p.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    i = 0
    for ps, _ in groups:
        for r, p in enumerate(ps):
            if p.returncode != 0 or f"DIST_OK rank={r}" not in logs[i]:
                print(logs[i][-6000:], file=sys.stderr)
                fail(f"phase dist: rank {r} of {len(ps)} failed (exit {p.returncode})")
            i += 1
    res = [json.loads(o.read_text()) for o in groups[0][1]]
    res4 = [json.loads(o.read_text()) for o in groups[1][1]]
    for case in DIST_CASES:
        if res[1][case]["tokens"] != res[0][case]["tokens"]:
            fail(f"phase dist {case}: the ranks ended on different tokens")
    if any(r["cp_dp"]["tokens"] != res4[0]["cp_dp"]["tokens"] for r in res4):
        fail("phase dist cp_dp: the ranks ended on different tokens")
    launches = {}
    for r in res + res4:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # the serving runs alone: TP's plain K2 / K3, K1 and K16; CP's ranged K2 / K3
    # and K13; the hybrid's K14 modes and K15; the W8A8 experts' K8; MLA's K10
    idle = [k for k in DIST_PATH_KERNELS if launches.get(k, 0) <= 0]
    if idle:
        fail(f"phase dist: the DistLLM runs launched none of {idle} (launches {launches})")
    out = dict(kernels=rows, expanded_mla_range=expanded, geometries_range=geometries,
               launches=launches,
               wall_s=time.perf_counter() - t0,
               cuts=dict(mla_cp=f"DeepSeek-V2-Lite {DIST_MLA_LAYERS} of 27 layers",
                         hybrid=f"Ring-mini-linear-2.0 {DIST_HYBRID_LAYERS} of 20 layers",
                         ep="Mixtral-8x7B 2 of 32 layers",
                         moe_tp_w8a8="Mixtral-8x7B 2 of 32 layers",
                         cp_dp=f"Llama-2-7B {DIST4_LAYERS} of 32 layers"),
               note="ranks share one H100 over gloo: every collective goes through "
                    "the host, so these are not NCCL times")
    print("phase dist depth cuts (widths as published): " + json.dumps(out["cuts"]))
    for case in DIST_CASES:
        out[case] = [{k: v for k, v in r[case].items() if k != "tokens"} for r in res]
        print(f"phase dist {case} (rank 0, rank 1): " + json.dumps(out[case]))
    out["cp_dp"] = [{k: v for k, v in r["cp_dp"].items() if k != "tokens"} for r in res4]
    print("phase dist cp_dp (ranks 0-3): " + json.dumps(out["cp_dp"]))
    out["ranks"] = [dict(wall_s=r["wall_s"], peak_mem_gb=r["peak_mem_gb"])
                    for r in res + res4]
    print(f"phase dist: wall {out['wall_s']:.1f} s (gloo through the host, not NCCL)")
    return out


def phase_moe_tp(pkg) -> dict:
    """Phase dist's moe_tp_w8a8 case alone: two ranks (``moe_tp_rank``)
    sharing the card over gloo. Each rank's output is printed whole, so
    the numbers of a failing case show."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_tp_"))
    procs, outs = _spawn_ranks(DIST_WORLD, "--moe-tp-rank", _free_port(), tmp, "moe_tp")
    logs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            logs[i], _ = p.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        print(f"phase moe_tp_w8a8 rank {r} (exit {p.returncode}):\n{logs[r][-6000:]}")
    if any(p.returncode != 0 or f"DIST_OK rank={r}" not in logs[r] for r, p in enumerate(procs)):
        fail("phase moe_tp_w8a8: a rank failed")
    res = [json.loads(o.read_text()) for o in outs]
    if res[1]["moe_tp_w8a8"]["tokens"] != res[0]["moe_tp_w8a8"]["tokens"]:
        fail("phase moe_tp_w8a8: the ranks ended on different tokens")
    out = [{k: v for k, v in r["moe_tp_w8a8"].items() if k != "tokens"} for r in res]
    print("phase moe_tp_w8a8 (rank 0, rank 1): " + json.dumps(out))
    return dict(moe_tp_w8a8=out, launches=[r["launches"] for r in res])


def load_port():
    if not (HERE / "painlessinferenceacceleration_tpu_torch" / "__init__.py").exists():
        fail("the port package is not beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    import importlib

    base = "painlessinferenceacceleration_tpu_torch."
    names = dict(_build="_build", config="config", linear="layers.linear",
                 generate="lookahead.generate", native="lookahead.native",
                 embedding="layers.embedding", w8a8="ops.w8a8",
                 quant_matmul="ops.quant_matmul", moe_matmul="ops.moe_matmul",
                 moe="models.moe", paged_attention="ops.paged_attention",
                 mla_attention="ops.mla_attention",
                 linear_attention="ops.linear_attention", linear_attn="models.linear_attn",
                 attention="ops.attention", kv_update="ops.kv_update",
                 rmsnorm="ops.rmsnorm", cache="engine.cache", step="engine.step",
                 multistep="engine.multistep", llm="engine.llm",
                 request="engine.request", device_tables="lookahead.device_tables",
                 base="models.base", sample="ops.sample", server="service.server",
                 client="service.client", safetensors="utils.safetensors",
                 ipad="ipad.distill", train_forward="ipad.train_forward", optim="ipad.optim",
                 dist_llm="engine.dist_llm", comm="parallel.comm", mesh="parallel.mesh",
                 multihost="parallel.multihost", cp_attention="ops.cp_attention",
                 mla="models.mla")
    return {k: importlib.import_module(base + v) for k, v in names.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None, help="also write all numbers here")
    ap.add_argument("--moe-only", action="store_true",
                    help="run only the Mixture-of-Experts phases (a partial run: "
                         "prints no kernels line and no result line)")
    ap.add_argument("--mla-only", action="store_true",
                    help="run only the Multi-head Latent Attention phases (a partial "
                         "run: prints no kernels line and no result line)")
    ap.add_argument("--generator-only", action="store_true",
                    help="run only the KV row kernels (K4, K16, K17) against their plain "
                         "versions, phase 3 and the host-trie generator phase (a partial "
                         "run: prints no kernels line and no result line)")
    ap.add_argument("--w8a8-only", action="store_true",
                    help="run only K8 and K9 (the W8A8 and block-fp8 GEMMs) against "
                         "their plain versions, their tile-edge checks and the quant "
                         "modes that run them (a partial run: prints no kernels line "
                         "and no result line)")
    ap.add_argument("--int8-only", action="store_true",
                    help="run only K7 and K12 (the int8 weight-only GEMMs) against their "
                         "plain versions, K7's tile-edge checks, K12's bit identities, "
                         "the int8 quant mode and Mixtral-8x7B with int8 experts (a "
                         "partial run: prints no kernels line and no result line)")
    ap.add_argument("--attention-only", action="store_true",
                    help="run only the paged attention kernel's rows against its plain "
                         "version, its width, route and tile-edge checks, and the "
                         "Llama-2-7B main path (a partial run: prints no kernels line "
                         "and no result line)")
    ap.add_argument("--linear-only", action="store_true",
                    help="run only the linear-attention hybrid phases (a partial run: "
                         "prints no kernels line and no result line)")
    ap.add_argument("--sampling-only", action="store_true",
                    help="run only the sampling phase at Llama-2-7B int4 (a partial run: "
                         "prints no kernels line and no result line)")
    ap.add_argument("--ipad-only", action="store_true",
                    help="run only the ipad phase (prune and distill at Llama-2-7B widths, "
                         "then serve the pruned model; a partial run: prints no kernels "
                         "line and no result line)")
    ap.add_argument("--hf-only", action="store_true",
                    help="run only the ALiBi attention rows and the hf phase (local "
                         "checkpoints through LLM(model_path=...); a partial run: prints "
                         "no kernels line and no result line)")
    ap.add_argument("--families-only", action="store_true",
                    help="run only phase families (GPT-J, DeepSeek-V2-Lite expanded, GLM-10B, "
                         "GPT-2 XL and BLOOM-7b1 with the e4m3 head through "
                         "LLM(model_path=...), and the new builds' rows; a partial run: "
                         "prints no kernels line and no result line)")
    ap.add_argument("--dist-only", action="store_true",
                    help="run only phase dist: K2 / K3 and K13 with a page range, then "
                         "two and four ranks sharing the card over gloo under tensor, "
                         "context, data and expert parallelism (a partial run: prints no "
                         "kernels line and no result line)")
    ap.add_argument("--moe-tp-only", action="store_true",
                    help="run only phase dist's moe_tp_w8a8 case: two ranks serve a "
                         "Mixtral-shaped stack with W8A8 experts under tensor parallelism "
                         "(a partial run: prints no kernels line and no result line)")
    ap.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--moe-tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist4-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-out", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda is not available")
    pkg = load_port()
    if args.dist_rank is not None:  # a rank of phase dist, started by it
        dist_rank(pkg, args.dist_rank, args.dist_port, args.dist_out)
        return
    if args.dist4_rank is not None:  # a rank of phase dist's four-rank group
        dist4_rank(pkg, args.dist4_rank, args.dist_port, args.dist_out)
        return
    if args.moe_tp_rank is not None:  # a rank of --moe-tp-only
        moe_tp_rank(pkg, args.moe_tp_rank, args.dist_port, args.dist_out)
        return
    env = phase_environment(pkg)
    if args.families_only:
        fam_res = phase_families(pkg)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (families only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, families=fam_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.dist_only:
        dist_res = phase_dist(pkg)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (dist only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, dist=dist_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.moe_tp_only:
        tp_res = phase_moe_tp(pkg)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (moe_tp_w8a8 only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, moe_tp=tp_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.moe_only:
        rows = phase_moe_kernels(pkg, pkg["config"].ModelConfig.mixtral_8x7b())
        moe_res = phase_moe(pkg)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (MoE phases only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows, moe=moe_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.mla_only:
        rows = phase_mla_kernels(pkg)
        mla_res = phase_mla(pkg)
        rows += mla_res["kernels"]
        wall_s = time.perf_counter() - T_START
        print(f"partial run (MLA phases only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows, mla=mla_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.linear_only:
        rows = phase_linear_kernels(pkg)
        lin_res = phase_linear(pkg)
        rows += lin_res["kernels"]
        wall_s = time.perf_counter() - T_START
        print(f"partial run (linear-attention phases only), wall {wall_s:.1f} s on "
              f"{env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                                 linear=lin_res, wall_s=wall_s), indent=1))
        return
    if args.ipad_only:
        ipad_res = phase_ipad(pkg)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (ipad only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, ipad=ipad_res,
                                                 wall_s=wall_s), indent=1))
        return
    cfg = pkg["config"].ModelConfig.llama2_7b()
    spec = pkg["linear"].QuantSpec(bits=4, group=128)
    if args.hf_only:
        rows = alibi_attention_rows(pkg, torch.Generator(device="cuda").manual_seed(SEED + 19))
        for r in rows:
            print("phase 2 kernel: " + json.dumps(r))
        hf_res = phase_hf(pkg)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (hf only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows, hf=hf_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.w8a8_only:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        rows = w8a8_rows(pkg, g, cfg) + k9_rows(pkg, g, cfg)
        for r in rows:
            print("phase 2 kernel: " + json.dumps(r))
        check_w8a8_tile_edges(pkg, g, cfg.hidden_size)
        print("phase 2 w8a8 tile edges: rows alone equal to themselves in a 4096-row call")
        quant_res = phase_quant_modes(pkg, cfg, tuple(
            r for r in QUANT_RUNS if MODE_KERNEL[r[0]] != "int8_gemm"))
        rows += quant_res["kernels"]
        wall_s = time.perf_counter() - T_START
        print(f"partial run (W8A8 only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                                 quant_modes=quant_res, wall_s=wall_s),
                                            indent=1))
        return
    if args.int8_only:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        rows = int8_rows(pkg, g, cfg)
        for r in rows:
            print("phase 2 kernel: " + json.dumps(r))
        check_int8_tile_edges(pkg, g, cfg.hidden_size)
        print("phase 2 int8 tile edges: rows alone equal to themselves in a 4096-row call")
        rows += phase_moe_kernels(pkg, None, ("grouped_int8_gemm",))
        quant_res = phase_quant_modes(pkg, cfg, tuple(
            r for r in QUANT_RUNS if MODE_KERNEL[r[0]] == "int8_gemm"))
        rows += quant_res["kernels"]
        moe_res = moe_weight_only_run(pkg, 8)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (int8 only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                                 quant_modes=quant_res, moe=moe_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.attention_only:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        rows = attention_rows(pkg, g, cfg)
        for r in rows:
            print("phase 2 kernel: " + json.dumps(r))
        check_attention_width(pkg, g, cfg)
        print("phase 2 attention width: row 0 of a verify equals its decode in every arena")
        check_attention_routes(pkg, g)
        check_attention_tile_edges(pkg, g)
        params = pkg["base"].init_params_quantized(
            cfg, spec, torch.Generator(device="cuda").manual_seed(SEED))
        main_res = phase_main_path(pkg, cfg, spec, params, extras=False)
        main_res.pop("ar_stream")
        wall_s = time.perf_counter() - T_START
        print(f"partial run (attention only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                                 main_path=main_res, wall_s=wall_s),
                                            indent=1))
        return
    if args.sampling_only:
        params = pkg["base"].init_params_quantized(
            cfg, spec, torch.Generator(device="cuda").manual_seed(SEED))
        samp_res = phase_sampling(pkg, cfg, spec, params)
        wall_s = time.perf_counter() - T_START
        print(f"partial run (sampling only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, sampling=samp_res,
                                                 wall_s=wall_s), indent=1))
        return
    if args.generator_only:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        rows = k4_rows(pkg, g, cfg) + row_kernel_rows(pkg, g, cfg)
        for r in rows:
            print("phase 2 kernel: " + json.dumps(r))
        params = pkg["base"].init_params_quantized(
            cfg, spec, torch.Generator(device="cuda").manual_seed(SEED))
        main_res = phase_main_path(pkg, cfg, spec, params, extras=False)
        gen_res = phase_generator(pkg, cfg, spec, params, main_res["ar_stream"])
        wall_s = time.perf_counter() - T_START
        print(f"partial run (generator phases only), wall {wall_s:.1f} s on {env['card']}")
        if args.json:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                                 main_path=main_res, generator=gen_res,
                                                 wall_s=wall_s), indent=1))
        return
    rows = phase_kernels(pkg, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pkg["base"].init_params_quantized(cfg, spec, gen)
    row_writes = RowWriteCapture(pkg)
    row_writes.install()
    main_res = phase_main_path(pkg, cfg, spec, params)
    row_writes.remove()
    rows += row_writes.rows("main path")
    serve_res = phase_serving(pkg, cfg, params)
    rows += serve_res["kernels"]
    gen_res = phase_generator(pkg, cfg, spec, params, main_res["ar_stream"])
    samp_res = phase_sampling(pkg, cfg, spec, params)
    del params
    hf_res = phase_hf(pkg)
    fam_res = phase_families(pkg)
    rows += fam_res["kernels"]
    ipad_res = phase_ipad(pkg)
    quant_res = phase_quant_modes(pkg, cfg)
    rows += quant_res["kernels"]
    print("phase quant act: " + json.dumps(quant_res["quant_act"]))
    rows += phase_moe_kernels(pkg, pkg["config"].ModelConfig.mixtral_8x7b())
    moe_res = phase_moe(pkg)
    rows += phase_mla_kernels(pkg)
    mla_res = phase_mla(pkg)
    rows += mla_res["kernels"]
    t_lin = time.perf_counter()
    rows += phase_linear_kernels(pkg)
    lin_res = phase_linear(pkg)
    rows += lin_res["kernels"]
    print(f"linear-attention phases' wall: {time.perf_counter() - t_lin:.1f} s")
    dist_res = phase_dist(pkg)
    rows += dist_res["kernels"]
    by_phase = dict(main_path=main_res["launches"], serving=serve_res["launches"],
                    serving_compaction_check=serve_res["check_launches"],
                    generator=gen_res["launches"],
                    generator_compaction_check=gen_res["check_launches"],
                    sampling=samp_res["launches"], hf=hf_res["launches"],
                    families=fam_res["launches"], ipad=ipad_res["launches"],
                    quant_modes=quant_res["launches"], moe=moe_res["launches"],
                    mla=mla_res["launches"], linear=lin_res["launches"],
                    dist=dist_res["launches"])
    launches = {k: sum(p[k] for p in by_phase.values()) for k in main_res["launches"]}
    checks = ("serving_compaction_check", "generator_compaction_check")
    no_write = [k for k, p in by_phase.items() if k not in checks and p["kv_write_step"] <= 0]
    if no_write:
        fail(f"K16's step entry wrote no KV rows in {no_write}")
    k6_on_path = {k: p["kv_write_pages"] for k, p in by_phase.items()
                  if k not in checks and p["kv_write_pages"]}
    if k6_on_path:
        fail(f"kv_write_pages (K6) was launched on a path: {k6_on_path}")
    for r in rows:
        key = r["name"] if r["name"] in launches else r["name"].split("[")[0]
        r["launches"] = launches[key]
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched on the main path, in serving or its "
                 "compaction check, in the generator phase or its compaction check, in the "
                 "sampling phase, in the hf and families phases, in the ipad phase, in the "
                 "quant modes, in "
                 "the MoE phases, in "
                 "the MLA phases, in the linear-attention phases or in phase dist "
                 "(launches by phase: "
                 f"{ {k: v.get(key, 0) for k, v in by_phase.items()} })")
    print("phase 4 launches (each phase counted from 0): " + json.dumps(by_phase))
    print("phase 4 launches (sum): " + json.dumps(launches))
    wall_s = time.perf_counter() - T_START
    print(f"wall time of the whole script: {wall_s:.1f} s")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(environment=env, kernels=rows,
                                             main_path=main_res, serving=serve_res,
                                             generator=gen_res, sampling=samp_res,
                                             hf=hf_res, families=fam_res, ipad=ipad_res,
                                             quant_modes=quant_res, moe=moe_res,
                                             mla=mla_res, linear=lin_res,
                                             dist=dist_res, launches=by_phase,
                                             wall_s=wall_s), indent=1))
    print(json.dumps({"kernels": rows}))
    print(env["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
