"""One rank of the port's parallel tests (``tests/test_torch_parallel.py``,
``tests/test_torch_gpu.py``): joins a gloo group, runs every case of a case
file through ``DistLLM`` and writes what it saw as JSON.

    python tests/torch_dist_worker.py RANK WORLD PORT CASES.pt OUT.json

A case is a dict: ``name``, ``world`` (cases of another world size are
skipped), ``cfg`` (ModelConfig fields), ``params`` (the whole model's
tensors, the same on every rank), ``ecfg`` (EngineConfig fields),
``mesh`` (data, model), ``prompts``, ``max_new``, ``device``, ``dtype``
and optionally ``logits_prompt`` (prefill a batch and report its last
logits), ``ep_block`` (the MoE block of layer 0 against one process's
``expert_shards``), ``stagger`` (serve the prompts through
``DistLLM.launch`` first: rank 0 streams each from a thread of its own,
``stagger`` seconds apart, the last through ``async_stream_generate``),
``mm`` (a prompt's multimodal embeddings and their positions, or None:
the prompts are queued with ``add_request`` and served by ``step``),
``state_hashes`` (a digest of a hybrid's recurrent states after every
step) and ``tp_quant`` (under TP-mode MoE with dynamic W8A8 experts, this
rank's quantized down-product activations of layer 0 against the columns
of one process's). Imports torch and the port only.
"""

import contextlib
import hashlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig  # noqa: E402
from painlessinferenceacceleration_tpu_torch.engine.dist_llm import DistLLM  # noqa: E402
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams  # noqa: E402
from painlessinferenceacceleration_tpu_torch.parallel import comm  # noqa: E402
from painlessinferenceacceleration_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_multihost,
)


def _prefill_logits(dl, prompts):
    """The last logits of one prefill of ``prompts`` (right-padded) over a
    fresh page range of the engine's arena, under the rank state."""
    from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step

    B = len(prompts)
    n = max(len(p) for p in prompts)
    toks = torch.zeros((B, n), dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p)
    P, ps = dl.ecfg.pages_per_req, dl.ecfg.page_size
    need = -(-n // ps)  # each row's pages, from page 1 on (the rest of a table: page 0)
    pt = torch.zeros((B, P), dtype=torch.int32)
    pt[:, :need] = torch.arange(1, 1 + B * need, dtype=torch.int32).reshape(B, need)
    dev = dl.device
    with comm.using(dl.rank_state):
        _, _, logits = prefill_step(dl.params, dl.kv, dl.cfg, toks.to(dev),
                                    torch.zeros(B, dtype=torch.int32, device=dev),
                                    torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                                 device=dev), pt.to(dev), dl.quant)
    return logits.float().cpu().tolist()


def _ep_block(dl, case):
    """Layer 0's MoE block on one input through this rank's experts (the
    rank state) and through the whole model in one process with
    ``expert_shards(n)``: bit for bit."""
    from painlessinferenceacceleration_tpu_torch.models.base import _layer_of
    from painlessinferenceacceleration_tpu_torch.models.moe import expert_shards, moe_block

    g = torch.Generator().manual_seed(5)
    E = dl.cfg.hidden_size
    h = (torch.randn(2, 3, E, generator=g) * 0.5).to(dl.dtype).to(dl.device)
    full = {k: (v.to(dl.device) if isinstance(v, torch.Tensor) else v)
            for k, v in _layer_of(case["params"]["moe_layers"], 0).items()}
    cfg_full = ModelConfig(**case["cfg"])
    got = moe_block(_layer_of(dl.params["moe_layers"], 0), dl.cfg, dl.quant, h,
                    dl.rank_state)
    with expert_shards(dl.mesh.tp):
        want = moe_block(full, cfg_full, dl.quant, h)
    return bool(torch.equal(got, want))


@contextlib.contextmanager
def _quantized(K):
    """Every (rows, int8 / e4m3 values, per-token scales) that the W8A8
    activation quantization (``ops.w8a8.quant_act``, which each W8A8 GEMM
    call goes through) makes of rows of K lanes while open, in call order."""
    from painlessinferenceacceleration_tpu_torch.ops import w8a8

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


def _tp_quant(dl, case):
    """Layer 0's MoE block on one input under tensor parallelism and in one
    process, the activations of its expert down products taken from the
    serving path (``_quantized``: rows of the rank's and of the whole
    intermediate width, which differ from the hidden width): this rank's
    int8 values and per-token scales equal, bit for bit, its columns of one
    process's (``tp_quant_equal``)."""
    from painlessinferenceacceleration_tpu_torch.models.base import _layer_of
    from painlessinferenceacceleration_tpu_torch.models.moe import moe_block
    from painlessinferenceacceleration_tpu_torch.parallel.mesh import plan_shards

    g = torch.Generator().manual_seed(6)
    h = (torch.randn(1, 7, dl.cfg.hidden_size, generator=g) * 0.5).to(dl.dtype).to(dl.device)
    full = _layer_of(_to(case["params"]["moe_layers"], dl.device), 0)
    cfg = ModelConfig(**case["cfg"])
    st = dl.rank_state
    lo, hi = plan_shards(cfg, dl.mesh.tp, case["params"]).moe[st.model_rank]
    with _quantized(hi - lo) as mine:
        moe_block(_layer_of(dl.params["moe_layers"], 0), dl.cfg, dl.quant, h, st)
    I = cfg.moe_intermediate_size or cfg.intermediate_size
    with _quantized(I) as one:
        moe_block(full, cfg, dl.quant, h)
    same = len(mine) == len(one) == cfg.num_experts and hi - lo < I
    for (_, q_r, s_r), (_, q_1, s_1) in zip(mine, one):
        same &= bool(torch.equal(q_r, q_1[:, lo:hi]) and torch.equal(s_r, s_1))
    return same


def _pages_on_ranks(dl, case):
    """How many of the pages the requests will hold (the allocator hands
    out the lowest ids first) each context-parallel rank owns."""
    ps, per = dl.ecfg.page_size, dl.kv["k"].shape[1] - 1
    n = sum(-(-(len(p) + case["max_new"]) // ps) for p in case["prompts"])
    ids = range(1, 1 + min(n, dl.ecfg.num_pages - 1))
    return [sum(1 for i in ids if d * per <= i < (d + 1) * per) for d in range(dl.mesh.tp)]


@contextlib.contextmanager
def cp_oracle_attention(n: int):
    """For the body, the one-process forward's attention (``models/base.py
    _attention``, and MLA's ``models/mla.py _mla_attention``) is the
    context-parallel oracle: each of the ``n`` ranks' partials over the one
    arena, with that rank's global page range, merged in rank order
    (``cp_attention_oracle``)."""
    from painlessinferenceacceleration_tpu_torch.models import base, mla
    from painlessinferenceacceleration_tpu_torch.ops.cp_attention import cp_attention_oracle

    def attend(xq, kv, li, page_tables, start_lens, qmask, causal, scale, alibi=None):
        return cp_attention_oracle(xq, kv["k"][li], kv["v"][li], page_tables, start_lens,
                                   qmask, causal, scale, n)

    def attend_mla(q, kv, li, page_tables, start_lens, qmask, causal, scale, latent_v_dim):
        return cp_attention_oracle(q, kv["k"][li], kv["v"][li], page_tables, start_lens,
                                   qmask, causal, scale, n, latent_v_dim)

    plain, base._attention = base._attention, attend
    plain_mla, mla._mla_attention = mla._mla_attention, attend_mla
    try:
        yield
    finally:
        base._attention, mla._mla_attention = plain, plain_mla


def _cp_oracle(dl, case, params, dtype, tokens):
    """A one-process engine whose attention is the context-parallel oracle
    (``cp_oracle_attention``: the whole arena, each rank's page range, the
    same merge) serves the same prompts; its tokens, and its arena against
    the ranks' arenas put together (every page but the null page), bit for
    bit; a hybrid's recurrent states (whole on every rank) too."""
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM

    st, n = dl.rank_state, dl.mesh.tp
    whole = {}
    for name in ("k", "v"):
        parts = comm.gather_ordered(dl.kv[name][:, 1:].contiguous(), st.model_group,
                                    st.model_rank, n)
        whole[name] = torch.cat(list(parts), dim=1)
    with cp_oracle_attention(n):
        one = LLM(cfg=ModelConfig(**case["cfg"]), params=params,
                  ecfg=EngineConfig(**case["ecfg"]), dtype=dtype, device=dl.device)
        got = [r.output_ids for r in one.generate(
            case["prompts"], SamplingParams(max_new_tokens=case["max_new"]))]
    same = all(torch.equal(whole[k][:, 1:], one.kv[k][:, 1:]) for k in ("k", "v"))
    if "s" in one.kv:
        same = same and torch.equal(dl.kv["s"], one.kv["s"])
    err = max((whole[k][:, 1:] - one.kv[k][:, 1:]).abs().max().item() for k in ("k", "v"))
    digest = hashlib.sha256(b"".join(whole[k].numpy().tobytes() for k in ("k", "v")))
    return {"cp_oracle_tokens_equal": got == tokens, "cp_arena_equal": same,
            "cp_arena_max_err": err, "cp_arena_digest": digest.hexdigest()}


def _serve(dl, case):
    """The case's prompts through ``generate``, or, with ``mm``, queued one
    by one with their multimodal embeddings and served by ``step``."""
    sp = SamplingParams(max_new_tokens=case["max_new"])
    if not case.get("mm"):
        return dl.generate(case["prompts"], sp)
    reqs = []
    for p, mm in zip(case["prompts"], case["mm"]):
        emb, pos = mm if mm is not None else (None, None)
        reqs.append(dl.add_request(p, sp, mm_embeds=emb, mm_positions=pos))
    while any(r.state != "finished" for r in reqs):
        dl.step()
    return reqs


def _hash_states_each_step(dl) -> list:
    """Wrap ``dl.step``: a digest of the recurrent states ``kv["s"]`` after
    every scheduler step, in the returned list."""
    digests, step = [], dl.step

    def step_and_hash():
        worked = step()
        digests.append(hashlib.sha256(dl.kv["s"].cpu().numpy().tobytes()).hexdigest())
        return worked

    dl.step = step_and_hash
    return digests


def _launched(dl, case):
    """The case's prompts through the launched scheduler: rank 0 streams
    each from its own thread, started ``case["stagger"]`` seconds apart (the
    last through ``async_stream_generate``), then shuts down; every other
    rank runs its follower loop until that shutdown. Rank 0's streams (None
    on the others)."""
    import asyncio
    import threading

    if dl.rank != 0:
        dl.launch()  # the follower loop, until rank 0 stops
        return None
    prompts, sp = case["prompts"], SamplingParams(max_new_tokens=case["max_new"])
    outs = [None] * len(prompts)

    async def drain(p):
        return [t async for t in dl.async_stream_generate(p, sp)]

    def serve(i):
        time.sleep(case["stagger"] * i)
        if i == len(prompts) - 1:
            outs[i] = asyncio.run(drain(prompts[i]))
        else:
            outs[i] = list(dl.stream_generate(prompts[i], sp))

    dl.launch()
    threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dl.shutdown()
    return outs


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cases = torch.load(sys.argv[4], weights_only=False)
    out_path = sys.argv[5]
    torch.set_num_threads(1)
    device = next(c["device"] for c in cases)
    initialize_multihost(f"localhost:{port}", world, rank,
                         device="cpu" if device == "cpu" else "cuda")
    results = {}
    for case in cases:
        if case.get("world", world) != world:
            continue
        t0 = time.perf_counter()
        cfg = ModelConfig(**case["cfg"])
        dtype = getattr(torch, case.get("dtype", "float32"))
        params = case["params"]
        if device != "cpu":
            params = _to(params, device)
        dl = DistLLM(cfg=cfg, params=params, ecfg=EngineConfig(**case["ecfg"]), dtype=dtype,
                     device=device, mesh_shape=tuple(case["mesh"]))
        res = {}
        if case.get("logits_prompt"):
            res["logits"] = _prefill_logits(dl, case["logits_prompt"])
        if case.get("ep_block"):
            res["ep_block_equal"] = _ep_block(dl, case)
        if case.get("tp_quant"):
            res["tp_quant_equal"] = _tp_quant(dl, case)
        if case.get("cp_oracle"):
            res["pages_on_ranks"] = _pages_on_ranks(dl, case)
        if case.get("stagger") is not None:
            res["streams"] = _launched(dl, case)
        if case.get("state_hashes"):
            res["state_hashes"] = _hash_states_each_step(dl)
        res["tokens"] = [r.output_ids for r in _serve(dl, case)]
        if case.get("cp_oracle"):
            res.update(_cp_oracle(dl, case, params, dtype, res["tokens"]))
        res["spec_steps"] = dl.metrics.spec_steps
        res["comm_n"] = dl.rank_state.comm_n
        res["kv_pages"] = int(dl.kv["k"].shape[1])
        res["seconds"] = time.perf_counter() - t0
        results[case["name"]] = res
    with open(out_path, "w") as f:
        json.dump(results, f)
    print(f"WORKER_OK rank={rank}", flush=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
