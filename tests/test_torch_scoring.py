"""The port's scoring step and the scheduler policies of its ``LLM`` against
the JAX package, on the CPU.

One tiny fp32 llama (JAX init, carried over by ``params_from_jax``).
``score_step`` logprobs within 1e-4 of JAX's (fp32 on both sides, sums in
other orders), chunked or not; ``LLM`` scoring and option ranking within
1e-4 of JAX's ``LLM``. The mix and timely schedulers give JAX's greedy
streams under the same policy and the port's own pingpong streams, with
arrivals staggered so prefill and decode overlap; sampled streams are the
same under every policy and with lookahead; a request under a repetition
penalty never takes the lookahead path.
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
from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
from painlessinferenceacceleration_tpu.engine.step import score_step as j_score
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params

from painlessinferenceacceleration_tpu_torch.config import EngineConfig as TEngineConfig
from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP
from painlessinferenceacceleration_tpu_torch.engine.step import score_step as t_score
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax

BASE = dict(page_size=16, max_seq_len=256, max_concurrency=8, prefill_chunk=32,
            eos_token_id=-2, decode_buckets=(1, 2, 4, 8))
LOOKAHEAD = dict(use_lookahead=True, decoding_length=8, branch_length=4,
                 use_spec_min_batch_size=8)
PROMPTS = [[7, 8, 9, 10, 11], [100, 200, 300], [42, 43], [5, 6, 7]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs. Its engine runs are
    thousands of tiny ops; beside a parallel run's other workers, a pool of
    threads per op spends most of their time waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc, tc = JModelConfig.tiny(), TModelConfig.tiny()
    jp = j_init_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def jax_llm(model, **over):
    jc, jp, _, _ = model
    return JLLM(cfg=jc, params=jp, ecfg=JEngineConfig(**dict(BASE, **over)),
                dtype=jnp.float32)


def port_llm(model, **over):
    _, _, tc, tp = model
    return TLLM(cfg=tc, params=tp, ecfg=TEngineConfig(**dict(BASE, **over)),
                dtype=torch.float32, device="cpu")


def _run(llm, reqs):
    while any(r.state != "finished" for r in reqs):
        llm.step()
    return reqs


@pytest.mark.parametrize("chunks", [1, 3])
def test_score_step_equals_jax(model, chunks):
    """Prompt + targets in one chunk, or in three with the boundary token
    carried over: the same logprobs."""
    jc, jp, tc, tp = model
    full = np.random.default_rng(0).integers(3, 500, 40).astype(np.int32)
    C = -(-len(full) // chunks)
    ecfg_kw = dict(page_size=16, max_seq_len=128, max_concurrency=1)
    jkv = j_init_kv(jc, JEngineConfig(**ecfg_kw), dtype=jnp.float32)
    tkv = t_init_kv(tc, TEngineConfig(**ecfg_kw), dtype=torch.float32, device="cpu")
    pt = np.arange(1, 9, dtype=np.int32)[None]
    got, want = [], []
    for off in range(0, len(full), C):
        chunk = full[off: off + C]
        buf = np.zeros((1, C), np.int32)
        buf[0, : len(chunk)] = chunk
        bnd = np.array([full[off + len(chunk)] if off + len(chunk) < len(full) else 0],
                       np.int32)
        args = (buf, np.array([off], np.int32), np.array([len(chunk)], np.int32), pt)
        jkv, jl = j_score(jp, jkv, jc, *map(jnp.asarray, args), None, jnp.asarray(bnd))
        tkv, tl = t_score(tp, tkv, tc, *map(torch.from_numpy, args), None,
                          torch.from_numpy(bnd))
        want.append(np.asarray(jl)[0, : len(chunk)])
        got.append(tl[0, : len(chunk)].numpy())
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=1e-4, rtol=0)


def test_llm_scoring_and_option_ranking_equal_jax(model):
    """Two option requests scored beside a generating one, in a prefill
    chunk smaller than the prompt + targets (chunked scoring)."""
    outs = []
    for make, SP in ((jax_llm, JSP), (port_llm, TSP)):
        llm = make(model, prefill_chunk=16)
        gen = llm.add_request([5, 6, 7], SP(max_new_tokens=6))
        greedy = _run(llm, [gen])[0].output_ids
        prompt = list(range(20, 40))
        r1 = llm.add_request(prompt, target_ids=greedy)
        r2 = llm.add_request(prompt, target_ids=[1, 2, 3, 4, 5, 6])
        other = llm.add_request([9, 10, 11], SP(max_new_tokens=4))
        _run(llm, [r1, r2, other])
        assert r1.finish_reason == r2.finish_reason == "score"
        assert len(r1.target_logprobs) == len(greedy)
        outs.append((r1.target_logprobs, r2.target_logprobs, other.output_ids))
    (j1, j2, jo), (t1, t2, to) = outs
    np.testing.assert_allclose(t1, j1, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t2, j2, atol=1e-4, rtol=0)
    assert to == jo


def test_scoring_that_can_never_fit_finishes_with_an_error(model):
    llm = port_llm(model, max_seq_len=64, max_concurrency=1, num_pages=3)
    r = llm.add_request(list(range(10, 40)), target_ids=list(range(40, 60)))
    _run(llm, [r])
    assert r.finish_reason.startswith("error: scoring needs") and not r.target_logprobs
    too_long = llm.add_request(list(range(10, 40)), target_ids=list(range(40, 80)))
    assert too_long.finish_reason.startswith("error: prompt length 70")


def _staggered(llm, SP, prompts, sp_of):
    """Two requests, three scheduler steps, then the rest."""
    reqs = [llm.add_request(p, sp_of(SP, i)) for i, p in enumerate(prompts[:2])]
    for _ in range(3):
        llm.step()
    reqs += [llm.add_request(p, sp_of(SP, i + 2)) for i, p in enumerate(prompts[2:])]
    return [r.output_ids for r in _run(llm, reqs)]


def _greedy(SP, i):
    return SP(max_new_tokens=16)


@pytest.mark.parametrize("policy", ["mix", "timely"])
def test_policies_equal_jax_and_pingpong(model, policy):
    ref = _staggered(port_llm(model), TSP, PROMPTS, _greedy)
    port = _staggered(port_llm(model, schedule_policy=policy), TSP, PROMPTS, _greedy)
    jx = _staggered(jax_llm(model, schedule_policy=policy), JSP, PROMPTS, _greedy)
    assert port == jx == ref


def _mixed(SP, i):
    """Every other request sampled (its own seed), one under a repetition
    penalty."""
    if i == 3:
        return SP(max_new_tokens=16, repetition_penalty=1.3)
    if i % 2:
        return SP(max_new_tokens=16, temperature=0.8, top_k=50, top_p=0.95, seed=10 + i)
    return SP(max_new_tokens=16)


def test_sampled_streams_are_the_same_under_every_policy(model):
    prompts = PROMPTS + [[3, 4, 5, 3, 4, 5, 3, 4], [60, 61, 62, 63]]
    runs = {}
    for policy in ("pingpong", "mix", "timely"):
        for la in (False, True):
            kw = dict(schedule_policy=policy, max_concurrency=4)
            if la:
                kw.update(LOOKAHEAD)
            llm = port_llm(model, **kw)
            runs[policy, la] = _staggered(llm, TSP, prompts, _mixed)
            assert (llm.metrics.spec_steps > 0) == la
    ref = runs["pingpong", False]
    assert all(v == ref for v in runs.values())
    greedy = _staggered(port_llm(model, max_concurrency=4), TSP, prompts, _greedy)
    assert ref[1] != greedy[1] and ref[3] != greedy[3] and ref[0] == greedy[0]


def test_repetition_penalty_keeps_the_batch_off_lookahead(model):
    llm = port_llm(model, **LOOKAHEAD)
    r = llm.add_request([3, 4, 5] * 4, TSP(max_new_tokens=24, repetition_penalty=1.5))
    _run(llm, [r])
    assert llm.metrics.spec_steps == 0 and llm.metrics.decode_steps > 0
    greedy = port_llm(model, **LOOKAHEAD)
    g = greedy.add_request([3, 4, 5] * 4, TSP(max_new_tokens=24))
    _run(greedy, [g])
    assert greedy.metrics.spec_steps > 0 and g.output_ids != r.output_ids


@pytest.mark.parametrize("slots", [1, 2])
def test_hybrid_scoring_borrows_a_free_slot(slots):
    """A linear-attention hybrid keeps recurrent states in the engine's
    slots: a scoring request runs in a free slot's zeroed state (waiting
    for one when every slot decodes), so it scores as a fresh model does and
    leaves the decoding request's stream as it is served alone."""
    import dataclasses

    from painlessinferenceacceleration_tpu_torch.models.base import init_params

    cfg = dataclasses.replace(
        TModelConfig.tiny(), model_type="ring_linear", vocab_size=256, hidden_size=32,
        intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=4, linear_attention=True, layer_group_size=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=slots, prefill_chunk=8,
              eos_token_id=-2, decode_burst=2, decode_burst_idle=4)

    def llm():
        return TLLM(cfg=cfg, params=params, ecfg=TEngineConfig(**kw), dtype=torch.float32,
                    device="cpu")

    prompt, targets = [3, 4, 5, 6, 7] * 3, [9, 10, 11, 12, 13, 14]
    solo = llm().generate([[7, 8, 9, 10]], TSP(max_new_tokens=12))[0].output_ids
    alone = llm()
    ref = _run(alone, [alone.add_request(prompt, target_ids=targets)])[0].target_logprobs
    eng = llm()
    gen = eng.add_request([7, 8, 9, 10], TSP(max_new_tokens=12))
    eng.step()
    eng.step()
    sc = eng.add_request(prompt, target_ids=targets)
    _run(eng, [gen, sc])
    assert gen.output_ids == solo
    assert sc.finish_reason == "score"
    np.testing.assert_allclose(sc.target_logprobs, ref, atol=1e-6, rtol=0)
