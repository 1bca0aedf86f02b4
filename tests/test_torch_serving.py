"""The port's serving engine (``LLM``) against the JAX package's, on the CPU.

One tiny fp32 llama (JAX init, carried over by ``params_from_jax``) serves
the same requests in both packages: more requests than slots, a shared
prefix (prefix-cache hits), an oversubscribed arena that preempts, eos and
stop sequences, streaming and the background loop, for every KV arena kind
(``none``, ``fp8``, ``fp8_tok``) with lookahead off and on. Tokens, finish
reasons and the scheduler's counters must be identical. The engine steps
underneath (ragged batched prefill with a resumed prefix) compare logits
within 1e-4 (fp32 on both sides, sums in other orders); the host page
allocator and prefix cache must follow the same scripted sequence exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu.config import EngineConfig as JEngineConfig
from painlessinferenceacceleration_tpu.config import ModelConfig as JModelConfig
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.pages import PageAllocator as JPages
from painlessinferenceacceleration_tpu.engine.prefix_cache import PrefixCache as JPrefix
from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params

from painlessinferenceacceleration_tpu_torch.config import EngineConfig as TEngineConfig
from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.pages import PageAllocator as TPages
from painlessinferenceacceleration_tpu_torch.engine.prefix_cache import PrefixCache as TPrefix
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.models.convert import (
    kv_from_jax,
    params_from_jax,
)


@pytest.fixture(scope="module")
def model():
    jc, tc = JModelConfig.tiny(), TModelConfig.tiny()
    jp = j_init_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


BASE = dict(page_size=16, max_seq_len=256, max_concurrency=4, prefill_chunk=32,
            eos_token_id=-2, decode_buckets=(1, 2, 4, 8), decode_burst=4,
            decode_burst_idle=8)
LOOKAHEAD = dict(use_lookahead=True, decoding_length=8, branch_length=4,
                 use_spec_min_batch_size=4)


def engines(model, **over):
    jc, jp, tc, tp = model
    kw = dict(BASE, **over)
    j = JLLM(cfg=jc, params=jp, ecfg=JEngineConfig(**kw), dtype=jnp.float32)
    t = TLLM(cfg=tc, params=tp, ecfg=TEngineConfig(**kw), dtype=torch.float32,
             device="cpu")
    return j, t


def _prompts():
    """Six requests on a small alphabet (2-gram repeats make drafts land);
    three start with one shared 40-token prefix (two full 16-token pages)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(10, 30, 40).tolist()
    out = []
    for i in range(6):
        own = rng.integers(10, 30, int(rng.integers(5, 30))).tolist()
        out.append(shared + own if i % 2 == 0 else own)
    return out


PROMPTS = _prompts()


def _serve(j, t, prompts, max_new, **sp):
    jo = j.generate(prompts, JSP(max_new_tokens=max_new, **sp))
    to = t.generate(prompts, TSP(max_new_tokens=max_new, **sp))
    assert [r.output_ids for r in to] == [r.output_ids for r in jo]
    assert [r.finish_reason for r in to] == [r.finish_reason for r in jo]
    return jo, to


COUNTERS = ("finished", "generated_tokens", "prefix_hit_tokens", "preempted",
            "spec_steps", "spec_accepted", "chained_bursts", "decode_steps")


def _same_counters(j, t):
    for name in COUNTERS:
        assert getattr(t.metrics, name) == getattr(j.metrics, name), name


@pytest.mark.parametrize("lookahead", [False, True], ids=["ar", "lookahead"])
@pytest.mark.parametrize("kv_quant", ["none", "fp8", "fp8_tok"])
def test_llm_generate_matches_jax(model, kv_quant, lookahead):
    j, t = engines(model, kv_quant=kv_quant, **(LOOKAHEAD if lookahead else {}))
    if kv_quant == "fp8":
        j.calibrate_kv_scales(PROMPTS[:2])
        t.calibrate_kv_scales(PROMPTS[:2])
        np.testing.assert_allclose(t.kv["k_scale"].numpy(), np.asarray(j.kv["k_scale"]),
                                   rtol=1e-6)
    _serve(j, t, PROMPTS, 48)
    _same_counters(j, t)
    assert t.metrics.prefix_hit_tokens > 0
    if lookahead:
        assert t.metrics.spec_steps > 0
    assert t.allocator.free_pages + len(t.prefix_cache) >= t.ecfg.num_pages - 1
    assert t.page_stats() == j.page_stats()


def test_llm_oversubscribed_arena_preempts_like_jax(model):
    # 9 usable pages; each request needs ~5 at full length -> preemption
    j, t = engines(model, max_concurrency=8, num_pages=10)
    _serve(j, t, [[7, 8, 9, 10, 11], [100, 200, 300], [42, 43, 44, 45]], 60)
    assert t.metrics.preempted == j.metrics.preempted > 0
    assert t.allocator.free_pages == t.ecfg.num_pages - 1


def _serve_bounded(llm, prompts, max_new, max_steps=200):
    """Step the engine by hand, at most ``max_steps`` scheduler iterations,
    so that an engine that never finishes fails instead of hanging."""
    reqs = [llm.add_request(p, TSP(max_new_tokens=max_new)) for p in prompts]
    for _ in range(max_steps):
        if all(r.finish_reason for r in reqs):
            break
        llm.step()
    assert all(r.finish_reason for r in reqs), f"unfinished after {max_steps} steps"
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("lookahead", [False, True], ids=["ar", "lookahead"])
def test_tiny_arena_finishes(model, lookahead):
    """4 usable pages of 8 rows for three requests, verify width 13: no
    request's verify window fits the free pages. The JAX engine (and the
    port before the repair) preempts the youngest request, re-admits it into
    the same state and preempts it again without end; the port decodes such
    a burst by AR, which gives the same tokens. Every request gets the
    tokens it gets with room, within a bound on scheduler iterations."""
    _, _, tc, tp = model
    spec = dict(use_lookahead=True, decoding_length=12, branch_length=6,
                use_spec_min_batch_size=4) if lookahead else {}
    prompts = [[7, 8, 9, 10, 11], [100, 200, 250], [42, 43, 44, 45]]
    outs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: a thread pool beside other workers only waits
    try:
        for pages in (64, 5):
            ecfg = TEngineConfig(page_size=8, max_seq_len=256, max_concurrency=4,
                                 decode_buckets=(4,), num_pages=pages, prefill_chunk=8,
                                 eos_token_id=-2, **spec)
            llm = TLLM(cfg=tc, params=tp, ecfg=ecfg, dtype=torch.float32, device="cpu")
            outs.append(_serve_bounded(llm, prompts, 16))
    finally:
        torch.set_num_threads(threads)
    assert outs[1] == outs[0]
    assert all(len(o) == 16 for o in outs[1])


def test_llm_eos_and_stop_sequences_match_jax(model):
    j, t = engines(model)
    probe = t.generate(PROMPTS[:2], TSP(max_new_tokens=12))
    eos = probe[0].output_ids[5]
    stop = probe[1].output_ids[3:5]
    for sp in (dict(eos_token_id=eos), dict(stop_sequences=[stop])):
        j, t = engines(model)
        jo, to = _serve(j, t, PROMPTS[:2], 12, **sp)
        assert "length" != to[0 if "eos_token_id" in sp else 1].finish_reason


def test_llm_stream_and_background_loop_match_jax(model):
    j, t = engines(model, **LOOKAHEAD)
    ref = j.generate([PROMPTS[0]], JSP(max_new_tokens=16))[0].output_ids
    assert list(t.stream_generate(PROMPTS[0], TSP(max_new_tokens=16))) == ref
    _, t = engines(model)
    t.launch()
    try:
        assert t.generate([PROMPTS[0]], TSP(max_new_tokens=16))[0].output_ids == ref
        assert list(t.stream_generate(PROMPTS[0], TSP(max_new_tokens=16))) == ref
    finally:
        t.shutdown()


def test_llm_background_loop_with_many_caller_threads(model):
    """More caller threads than cores submit to one launched engine with a
    tiny switch interval: every request completes once, with the tokens the
    inline scheduler gives it, and every page comes back."""
    import os
    import sys
    import threading

    _, t = engines(model)
    ref = [r.output_ids for r in t.generate(PROMPTS, TSP(max_new_tokens=12))]
    _, t = engines(model, prefix_cache=False)
    results = {}
    n_threads = max(8, 2 * (os.cpu_count() or 1))

    def call(i):
        p = PROMPTS[i % len(PROMPTS)]
        results[i] = t.generate([p], TSP(max_new_tokens=12))[0]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t.launch()
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        t.shutdown()
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(n_threads))
    for i, r in results.items():
        assert r.state == "finished" and r.output_ids == ref[i % len(PROMPTS)]
    assert t.metrics.finished == n_threads
    assert t.allocator.free_pages == t.ecfg.num_pages - 1


def test_llm_rejects_what_is_not_ported(model):
    _, t = engines(model)
    # sampling, the repetition penalty, scoring, the mix / timely policies
    # and the engine's sampling defaults are ported: accepted and queued
    for sp in (TSP(temperature=0.7), TSP(repetition_penalty=1.2)):
        assert t.add_request([1, 2, 3], sp).state == "queued"
    assert t.add_request([1, 2, 3], target_ids=[4, 5]).state == "queued"
    assert TEngineConfig(schedule_policy="mix").schedule_policy == "mix"
    assert TEngineConfig(temperature=0.5).temperature == 0.5
    # text needs a tokenizer; model_path loads a local checkpoint directory
    with pytest.raises(ValueError):
        t.encode("text")
    with pytest.raises(FileNotFoundError):
        TLLM(model_path="/nonexistent", device="cpu")
    # device meshes are ported (DistLLM reads them; LLM serves one rank)
    assert TEngineConfig(mesh_shape=(1, 2)).mesh_shape == (1, 2)
    # read by the ported LookaheadGenerator, so no longer refused
    assert TEngineConfig(max_new_tokens=64).max_new_tokens == 64
    with pytest.raises(ValueError):  # no such mode in either package
        TQuantSpec.from_mode("fp8")
    assert TQuantSpec.from_mode("none") is None
    assert TQuantSpec.from_mode("int4", 64) == TQuantSpec(bits=4, group=64)
    too_long = t.add_request(list(range(300)))
    assert too_long.state == "finished" and too_long.finish_reason.startswith("error")
    jc, jp, tc, tp = model
    with pytest.raises(ValueError):  # params on the CPU, engine asked for another device
        TLLM(cfg=tc, params=tp, ecfg=TEngineConfig(**BASE), device="meta")


@pytest.mark.parametrize("kv_quant", ["none", "fp8", "fp8_tok"])
def test_prefill_step_ragged_batch_with_resumed_prefix_matches_jax(model, kv_quant):
    """B = 3 (one padding row), ragged chunk lengths, start_lens > 0."""
    jc, jp, tc, tp = model
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=4, kv_quant=kv_quant)
    je, te = JEngineConfig(**kw), TEngineConfig(**kw)
    jkv = j_init_kv(jc, je, dtype=jnp.float32)
    if kv_quant == "fp8":
        rng = np.random.default_rng(1)
        for name in ("k_scale", "v_scale"):
            jkv[name] = jnp.asarray(rng.uniform(0.002, 0.02, jkv[name].shape), jnp.float32)
    tkv = kv_from_jax(jax.tree.map(np.asarray, jkv), tc.num_key_value_heads, "cpu")
    P = je.pages_per_req
    pt = np.arange(1, 1 + 4 * P, dtype=np.int32).reshape(4, P)[[2, 0, 1]]
    pt[2] = pt[0]  # the padding row borrows another row's table, as LLM does
    rng = np.random.default_rng(2)
    C = 24
    first = rng.integers(0, 512, size=(3, C)).astype(np.int32)
    second = rng.integers(0, 512, size=(3, C)).astype(np.int32)
    for toks, starts, lens in ((first, [0, 0, 0], [24, 17, 0]),
                               (second, [24, 17, 0], [9, 24, 0])):
        starts, lens = np.array(starts, np.int32), np.array(lens, np.int32)
        jkv, jn, jl = j_prefill(jp, jkv, jc, jnp.asarray(toks), jnp.asarray(starts),
                                jnp.asarray(lens), jnp.asarray(pt))
        tkv, tn, tl = t_prefill(tp, tkv, tc, torch.from_numpy(toks),
                                torch.from_numpy(starts), torch.from_numpy(lens),
                                torch.from_numpy(pt))
        assert (tn[:2].numpy() == np.asarray(jn)[:2]).all()
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=1e-4, rtol=0)


def test_page_allocator_and_prefix_cache_follow_jax():
    """One scripted sequence of allocations, shares, registrations, matches
    and evictions in both packages: every return value and the free list."""
    ja, ta = JPages(12, 4), TPages(12, 4)
    jc, tc = JPrefix(ja, 4), TPrefix(ta, 4)
    a = list(range(1, 14))
    b = a[:8] + [99, 98, 97, 96, 95]
    log = []
    for alloc, cache in ((ja, jc), (ta, tc)):
        out = []
        pa = alloc.allocate(4)
        out.append(pa)
        out.append(cache.register(a, pa))
        shared, n = cache.match(b)
        cache.retain_matched(shared)
        out.append((shared, n))
        pb = shared + alloc.allocate(2)
        out.append(cache.register(b, pb))
        out.append(alloc.allocate(20))
        grow = list(pb)
        out.append((alloc.ensure_capacity(grow, 30), grow))
        alloc.free(pa)
        out.append(cache.evict(3))
        out.append(cache.match(a))
        alloc.free(grow)
        out.append((alloc.free_pages, alloc.page_stats(), list(alloc.refs), len(cache)))
        log.append(out)
    assert log[0] == log[1]
