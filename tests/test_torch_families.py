"""The families the port now serves on the card, held against the JAX
package on the CPU: GPT-J's head dim 256, DeepSeek in expanded MLA (K rows
of 192 lanes beside V rows of 128), AntGLM's prefix-LM prefill past 128
rows (K3's window), Qwen2's 7 and Qwen3's 5 query heads a kv head, OPT's
heads of 80 lanes and BLOOM's of 96, a tree verify of 129 rows, GPT-2's
50257-column tied head (the table padded to a multiple of 8 rows, the
logits cut back), the e4m3 tied head, and ``DistLLM.launch`` over two
gloo ranks.

Tolerances: the window's plain attention against JAX's masked reference
within 1e-5 (fp32, sums in another order); greedy and lookahead tokens
identical to the JAX engine's; the padded head's logits equal to the
unpadded head's on all 50257 columns within 1e-6, and scores (PPL) within
1e-4 of JAX's; the e4m3 head within 1e-5 relative of JAX's
``embed_logits`` (the same widened table, fp32 sums in another order).
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jcfg
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
from painlessinferenceacceleration_tpu.layers import embedding as jemb
from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec
from painlessinferenceacceleration_tpu.models import base as jbase
from painlessinferenceacceleration_tpu.ops.attention import (
    paged_attention_ref as j_attention_ref,
)

from painlessinferenceacceleration_tpu_torch import config as tcfg
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP
from painlessinferenceacceleration_tpu_torch.layers import embedding as temb
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.models import base as tbase
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    key_blocks,
    paged_attention_prefill,
    paged_attention_tok,
    window_qmask,
)

import _parallel_cases as pc
from _torch_dist import Ranks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (many small ops beside
    the other workers of the parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K3's prefix-LM window: the plain version against JAX's masked reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx,window", [([0, 0], [150, 40]), ([20, 70], [190, 71]),
                                        ([16, 0], [10, 300])])
def test_prefix_window_plain_matches_jax_mask(ctx, window):
    """``paged_attention_prefill(..., window=)`` (and the per-token e4m3
    entry) on the CPU against JAX's ``paged_attention_ref`` with the prefill
    step's mask (``engine/step.py:75-78``: key s visible iff s <= t or ctx +
    s < window[b]) over the same pages, 160 rows a chunk."""
    rng = np.random.default_rng(sum(window))
    B, Q, H, D, ps, P = 2, 160, 2, 32, 16, 20
    k = rng.standard_normal((B * P + 1, ps, H * D)).astype(np.float32)
    v = rng.standard_normal((B * P + 1, ps, H * D)).astype(np.float32)
    pt = (1 + np.arange(B * P, dtype=np.int32)).reshape(B, P)
    q = rng.standard_normal((B, Q, H, D)).astype(np.float32)
    start = np.array(ctx, np.int32)
    w = np.array(window, np.int32)
    pos = start[:, None] + np.arange(Q)[None]
    i = np.arange(Q)
    jmask = (i[:, None] >= i[None, :])[None] | (pos[:, None, :] < w[:, None, None])
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pt), jnp.asarray(start),
                                      jnp.asarray(jmask), D ** -0.5))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pt), torch.from_numpy(start))
    got = paged_attention_prefill(*args, D ** -0.5, window=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    tmask = window_qmask(B, Q, args[-1], torch.from_numpy(w), "cpu")
    assert np.array_equal(tmask.numpy(), jmask)
    # the per-token arena's entry takes the same window (scales of 1)
    one = torch.ones(B * P + 1, ps, H)
    tok = paged_attention_tok(args[0], args[1], args[2], one, one, args[3], args[4],
                              D ** -0.5, window=torch.from_numpy(w))
    np.testing.assert_allclose(tok.numpy(), want, atol=1e-5, rtol=0)
    # the walk reaches the window's last key inside the chunk
    for b in range(B):
        last = max(ctx[b] + Q - 1, min(window[b], ctx[b] + Q) - 1)
        assert key_blocks(ctx[b], Q, 0, Q, True, 99, window[b]) == last // 64 + 1


# ---------------------------------------------------------------------------
# the families, served by the engine against the JAX engine
# ---------------------------------------------------------------------------

MASK_ID = 9
LEGACY = dict(norm_type="layernorm", gated_mlp=False, attention_bias=True,
              attention_out_bias=True, mlp_bias=True)
FAMILIES = {
    # GPT-J's head dim 256 (2 heads of 256 lanes), its partial interleaved rope
    "gptj_d256": dict(model_type="gptj", vocab_size=256, hidden_size=512,
                      intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=2, norm_type="layernorm", gated_mlp=False,
                      hidden_act="gelu_new", parallel_residual=True, rope_interleaved=True,
                      partial_rotary_factor=0.25, mlp_bias=True),
    # DeepSeek-V2-Lite's head geometry (nope 128 + rope 64 beside v 128) in
    # expanded mode, with its experts
    "deepseek_expanded": dict(model_type="deepseek_v2", vocab_size=256, hidden_size=128,
                              intermediate_size=192, moe_intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=2,
                              num_key_value_heads=2, kv_lora_rank=64, qk_nope_head_dim=128,
                              qk_rope_head_dim=64, v_head_dim=128, moe_layer_start=1,
                              num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
                              norm_topk_prob=False, mla_latent_cache=False),
    # AntGLM at the JAX default prefill_chunk of 512, prompts past 128 tokens
    "glm_chunk512": dict(model_type="glm", vocab_size=256, hidden_size=64,
                         intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=4, max_position_embeddings=512,
                         position_embedding_type="glm_2d", hidden_act="gelu",
                         prefix_lm=True, tie_word_embeddings=True,
                         mask_token_ids=(MASK_ID,), **LEGACY),
}


# the attention geometries of published sizes, at two layers and narrow
# MLPs, as HF config.json keys that both packages' ``from_hf`` read:
# Qwen2-0.5B's 14 query heads over 2 kv heads of 64 lanes (G = 7, qkv
# biases), a Qwen3 of 10 over 2 heads of 64 (G = 5, qk-norm), OPT-2.7B's
# heads of 80 lanes, BLOOM-1b1's heads of 96 (ALiBi)
HF_FAMILIES = {
    "qwen2_g7": dict(model_type="qwen2", vocab_size=256, hidden_size=896,
                     intermediate_size=128, num_hidden_layers=2, num_attention_heads=14,
                     num_key_value_heads=2, rope_theta=1e6, attention_bias=True,
                     tie_word_embeddings=False),
    "qwen3_g5": dict(model_type="qwen3", vocab_size=256, hidden_size=256,
                     intermediate_size=128, num_hidden_layers=2, num_attention_heads=10,
                     num_key_value_heads=2, head_dim=64, rope_theta=1e6,
                     tie_word_embeddings=False),
    "opt_d80": dict(model_type="opt", vocab_size=256, hidden_size=320, ffn_dim=256,
                    num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=512,
                    activation_function="relu"),
    "bloom_d96": dict(model_type="bloom", vocab_size=256, hidden_size=384, n_layer=2,
                      n_head=4),
}
WIDE_VERIFY = dict(decoding_length=128, branch_length=16, max_seq_len=512)  # Q = 1 + 8 * 16


def _pair(kw, seed=3):
    if kw in HF_FAMILIES.values():
        jc, tc = jcfg.ModelConfig.from_hf(kw), tcfg.ModelConfig.from_hf(kw)
    else:
        jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jbase.init_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES) + sorted(HF_FAMILIES))
def test_family_serving_matches_jax(family):
    """The engine serves the family with the JAX engine's greedy tokens,
    with lookahead and without, at ``prefill_chunk`` 512 over prompts of 150
    and 140 tokens (AntGLM's window: the second prompt's mask token at 100,
    so the window ends inside the one chunk). The published geometries
    (``HF_FAMILIES``) pass ``check_model_on_card``; Qwen2's also serves a
    lookahead run whose tree verify is 129 rows wide (``decoding_length``
    128 in branches of 16), with the JAX engine's tokens."""
    jc, tc, jp, tp = _pair({**FAMILIES, **HF_FAMILIES}[family])
    if family in HF_FAMILIES:
        tbase.check_model_on_card(tc, tp, 64)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(10, 250, 150))),
               list(map(int, rng.integers(10, 250, 140)))]
    prompts[1][100] = MASK_ID
    kw = dict(page_size=16, max_seq_len=256, max_concurrency=2, eos_token_id=-2,
              prefill_chunk=512, decoding_length=8, branch_length=4)
    want = [r.output_ids for r in JLLM(cfg=jc, params=jp, ecfg=jcfg.EngineConfig(**kw),
                                       dtype=jnp.float32).generate(prompts,
                                                                   JSP(max_new_tokens=10))]
    runs = [dict(use_lookahead=False), dict(use_lookahead=True)]
    if family == "qwen2_g7":
        runs.append(dict(use_lookahead=True, **WIDE_VERIFY))
    for run in runs:
        tl = TLLM(cfg=tc, params=tp, dtype=torch.float32, device="cpu",
                  ecfg=tcfg.EngineConfig(**{**kw, **run}))
        got = [r.output_ids for r in tl.generate(prompts, TSP(max_new_tokens=10))]
        assert got == want, (family, run)
        if run.get("decoding_length") == 128:
            assert tl.tcfg.verify_width == 129 and tl.metrics.spec_steps > 0


# the published config.json sizes whose attention geometry the card took
# last: G = 7 / 6 / 5, heads of 80 and 96 lanes
PUBLISHED = {
    "Qwen2.5-7B": dict(model_type="qwen2", hidden_size=3584, num_attention_heads=28,
                       num_key_value_heads=4, intermediate_size=18944, vocab_size=152064),
    "Qwen2.5-1.5B": dict(model_type="qwen2", hidden_size=1536, num_attention_heads=12,
                         num_key_value_heads=2, intermediate_size=8960, vocab_size=151936),
    "Qwen2.5-14B": dict(model_type="qwen2", hidden_size=5120, num_attention_heads=40,
                        num_key_value_heads=8, intermediate_size=13824, vocab_size=152064),
    "Qwen3-14B": dict(model_type="qwen3", hidden_size=5120, num_attention_heads=40,
                      num_key_value_heads=8, head_dim=128, intermediate_size=17408,
                      vocab_size=151936),
    "OPT-2.7B": dict(model_type="opt", hidden_size=2560, num_attention_heads=32,
                     ffn_dim=10240, vocab_size=50272, max_position_embeddings=2048),
    "BLOOM-3b": dict(model_type="bloom", hidden_size=2560, n_head=32, vocab_size=250880),
    "BLOOM-1b1": dict(model_type="bloom", hidden_size=1536, n_head=16, vocab_size=250880),
}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_check_model_on_card_takes_the_published_geometries(name):
    """``check_model_on_card`` (the attention geometry; no weights given)
    accepts each published size, as both packages' ``from_hf`` read it, and
    still raises, with the reason, for pages other than 64 keys, more than
    128 query heads a kv head and a head dim off the kernel's pairs."""
    import dataclasses

    tc = tcfg.ModelConfig.from_hf(PUBLISHED[name])
    jc = jcfg.ModelConfig.from_hf(PUBLISHED[name])
    assert (tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim) == (
        jc.num_attention_heads, jc.num_key_value_heads, jc.head_dim)
    tbase.check_model_on_card(tc, {}, 64)
    with pytest.raises(ValueError, match="pages of 64"):
        tbase.check_model_on_card(tc, {}, 32)
    wide = dataclasses.replace(tc, num_attention_heads=256 * tc.num_key_value_heads)
    with pytest.raises(ValueError, match="query heads a kv head"):
        tbase.check_model_on_card(wide, {}, 64)
    with pytest.raises(ValueError, match="head dims"):
        tbase.check_model_on_card(dataclasses.replace(tc, head_dim=112), {}, 64)


# ---------------------------------------------------------------------------
# GPT-2's 50257-column tied head and the e4m3 tied head
# ---------------------------------------------------------------------------

GPT2 = dict(vocab_size=50257, hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=4, intermediate_size=128)


@pytest.fixture(scope="module")
def gpt2():
    jc = jcfg.ModelConfig.tiny_gpt2(**GPT2)
    tc = tcfg.ModelConfig.tiny_gpt2(**GPT2)
    jp = jbase.init_params(jc, jax.random.PRNGKey(4), dtype=jnp.float32)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_gpt2_padded_head_logits_and_scores(gpt2):
    """The engine pads GPT-2's tied table to 50264 rows (zeros); the head's
    logits, cut back in ``logits_from_hidden``, equal the unpadded head's on
    all 50257 columns; a scoring request (PPL) gives the JAX engine's
    logprobs, and greedy tokens equal JAX's."""
    jc, tc, jp, tp = gpt2
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=2, eos_token_id=-2)
    tl = TLLM(cfg=tc, params=tp, dtype=torch.float32, device="cpu",
              ecfg=tcfg.EngineConfig(**kw))
    assert tl.params["embed"].shape == (50264, 64) and tp["embed"].shape == (50257, 64)
    assert not tl.params["embed"][50257:].any()
    h = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(0))
    padded = tbase.logits_from_hidden(tl.params, tc, h)
    plain = tbase.logits_from_hidden(tp, tc, h)
    assert padded.shape == plain.shape == (3, 5, 50257)
    torch.testing.assert_close(padded, plain, atol=1e-6, rtol=0)
    prompt, target = [11, 500, 40000, 7] * 3, [50256, 3, 1234, 50000]
    jl = JLLM(cfg=jc, params=jp, ecfg=jcfg.EngineConfig(**kw), dtype=jnp.float32)
    jr = jl.add_request(prompt, JSP(max_new_tokens=1), target_ids=target)
    jg = jl.add_request(prompt, JSP(max_new_tokens=8))
    while jr.state != "finished" or jg.state != "finished":
        jl.step()
    tr = tl.add_request(prompt, TSP(max_new_tokens=1), target_ids=target)
    tg = tl.add_request(prompt, TSP(max_new_tokens=8))
    while tr.state != "finished" or tg.state != "finished":
        tl.step()
    np.testing.assert_allclose(tr.target_logprobs, jr.target_logprobs, atol=1e-4, rtol=0)
    assert tg.output_ids == jg.output_ids


def test_fp8_tied_head_matches_jax(gpt2):
    """The e4m3 table (``quant_embed``): the port's quantization gives JAX's
    bytes and scales, its tied head (the plain version here) JAX's
    ``embed_logits`` within 1e-5 relative, and the padded e4m3 table (zero
    rows, scales of 1) the same logits on every real column."""
    jc, tc, jp, tp = gpt2
    jt = jemb.make_embedding(jp["embed"], JQuantSpec.from_mode("w8a8_fp8"))
    tt = temb.make_embedding(tp["embed"], TQuantSpec.from_mode("w8a8_fp8"))
    assert np.array_equal(np.asarray(jt["q"]).view(np.uint8), tt["q"].view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(jt["s"]), tt["s"].numpy())
    h = np.random.default_rng(1).standard_normal((2, 3, 64)).astype(np.float32)
    want = np.asarray(jemb.embed_logits(jt, jnp.asarray(h)))
    got = temb.embed_logits(tt, torch.from_numpy(h)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    padded = temb.pad_vocab_rows({"embed": tt})["embed"]
    assert padded["q"].shape[0] == 50264 and bool((padded["s"][50257:] == 1).all())
    np.testing.assert_array_equal(temb.embed_logits(padded, torch.from_numpy(h))[..., :50257]
                                  .numpy(), got)


def test_fp8_tied_head_serves_like_jax(gpt2):
    """GPT-2 under ``quant_embed`` (the e4m3 table, padded): the engine's
    greedy tokens equal the JAX engine's, with lookahead and without."""
    jc, tc, jp, tp = gpt2
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=2, eos_token_id=-2,
              quant_embed=True, decoding_length=8, branch_length=4)
    prompts = [[11, 500, 40000, 7] * 4, [50256, 3, 3, 3, 9]]
    want = [r.output_ids for r in JLLM(cfg=jc, params=jp, ecfg=jcfg.EngineConfig(**kw),
                                       dtype=jnp.float32).generate(prompts,
                                                                   JSP(max_new_tokens=8))]
    for la in (False, True):
        tl = TLLM(cfg=tc, params=tp, dtype=torch.float32, device="cpu",
                  ecfg=tcfg.EngineConfig(use_lookahead=la, **kw))
        assert tl.params["embed"]["q"].shape[0] == 50264
        got = [r.output_ids for r in tl.generate(prompts, TSP(max_new_tokens=8))]
        assert got == want, la


# ---------------------------------------------------------------------------
# DistLLM.launch over two gloo ranks
# ---------------------------------------------------------------------------


def test_dist_llm_launch_streams_generate_tokens(tmp_path):
    """Two gloo ranks under tensor parallelism: rank 0 launches the
    scheduler and streams four requests sent at staggered times (the last
    through ``async_stream_generate``) while rank 1 runs its follower loop;
    the streams equal the one-process ``LLM.generate``, the JAX engine's
    tokens and, after the shutdown, ``DistLLM.generate`` on both ranks."""
    tp, jp = pc.port_params("dense")
    ranks = Ranks(2, [pc.case("launch", "dense", tp, (1, 2), 2, pc.LOOK, stagger=0.05)],
                  str(tmp_path))
    want_jax = pc.jax_reference("dense", jp)[0]
    one = TLLM(cfg=pc.cfgs("dense")[1], params=tp, dtype=torch.float32, device="cpu",
               ecfg=tcfg.EngineConfig(**dict(pc.BASE, **pc.LOOK)))
    want = [r.output_ids for r in one.generate(pc.PROMPTS, TSP(max_new_tokens=pc.NEW))]
    assert want == want_jax
    res = ranks.results()
    assert res[0]["launch"]["streams"] == want
    assert res[1]["launch"]["streams"] is None
    for r in res:
        assert r["launch"]["tokens"] == want
