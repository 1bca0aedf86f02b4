"""The port's legacy dense families against the JAX package, on the CPU.

gpt2, opt, gptj, bloom, glm (AntGLM: 2D positions and prefix-LM), chatglm,
baichuan (the 7B rope and the 13B ALiBi layouts) and qwen1, at tiny fp32
sizes: the same weights (JAX init, carried over by ``params_from_jax``) and
the same seeded prompts through both packages' ``transformer_hidden`` /
``logits_from_hidden`` (logits within atol 1e-4, sums taken in different
orders), both packages' greedy ``multistep_decode`` (tokens identical), and
the port's lookahead ``multistep_spec_decode`` against its own AR stream
(bit for bit). A multimodal prefill (``mm_embeds``) against JAX's, and the
engine serving AntGLM and bloom against the JAX engine. (gpt2, opt, gptj and
bloom against HF's torch models: ``tests/test_torch_legacy_hf.py``.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jcfg_mod
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.multistep import multistep_decode as j_decode
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.models import base as jbase

from painlessinferenceacceleration_tpu_torch import config as tcfg_mod
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.multistep import (
    multistep_decode as t_decode,
    multistep_spec_decode as t_spec,
)
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as tdt
from painlessinferenceacceleration_tpu_torch.models import base as tbase
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax

PAGE, MAX_SEQ = 16, 128
PROMPT = 20
AR_STEPS = 16
MASK_ID, SOP_ID = 9, 8
SMALL = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=256)
LEGACY = dict(norm_type="layernorm", gated_mlp=False, attention_bias=True,
              attention_out_bias=True, mlp_bias=True)
FAMILIES = {
    "gpt2": ("tiny_gpt2", dict(num_hidden_layers=2)),
    "bloom": ("tiny_bloom", dict(num_hidden_layers=2)),
    "chatglm": ("tiny_chatglm", dict(num_hidden_layers=2)),
    "opt": (None, dict(SMALL, model_type="opt", intermediate_size=128,
                       position_embedding_type="learned", hidden_act="relu",
                       tie_word_embeddings=True, **LEGACY)),
    "gptj": (None, dict(SMALL, model_type="gptj", intermediate_size=256,
                        norm_type="layernorm", gated_mlp=False, hidden_act="gelu_new",
                        parallel_residual=True, rope_interleaved=True,
                        partial_rotary_factor=0.5, mlp_bias=True)),
    "baichuan": (None, dict(SMALL, model_type="baichuan", intermediate_size=128)),
    "baichuan_alibi": (None, dict(SMALL, model_type="baichuan", intermediate_size=128,
                                  position_embedding_type="alibi")),
    "qwen": (None, dict(SMALL, model_type="qwen", intermediate_size=64,
                        attention_bias=True, rms_norm_eps=1e-6)),
    "glm": (None, dict(SMALL, model_type="glm", intermediate_size=256,
                       position_embedding_type="glm_2d", hidden_act="gelu",
                       prefix_lm=True, tie_word_embeddings=True,
                       mask_token_ids=(MASK_ID,), **LEGACY)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (thousands of tiny ops;
    a thread pool per op beside the other workers mostly waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name):
    preset, kw = FAMILIES[name]
    if preset:
        return getattr(jcfg_mod.ModelConfig, preset)(**kw), getattr(
            tcfg_mod.ModelConfig, preset)(**kw)
    return jcfg_mod.ModelConfig(**kw), tcfg_mod.ModelConfig(**kw)


def _perturb(tree, rng):
    """Norm gains, norm biases and biases are ones / zeros at init; random
    values make the test see every leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k.endswith("_ln") or k.endswith("_norm"):
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("_b") or k in ("bqkv", "bo", "bgu", "bdown"):
            out[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


class Pair:
    def __init__(self, name):
        self.name = name
        self.jc, self.tc = configs(name)
        jp = jbase.init_params(self.jc, jax.random.PRNGKey(5), dtype=jnp.float32)
        rng = np.random.default_rng(11)
        np_params = _perturb(jax.tree.map(np.asarray, jp), rng)
        if name == "gptj":  # gptj's head carries a bias
            np_params["lm_head_b"] = (0.05 * rng.standard_normal(
                self.jc.vocab_size)).astype(np.float32)
        self.jp = jax.tree.map(jnp.asarray, np_params)
        self.tp = params_from_jax(np_params, "cpu")
        self.je = jcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=2)
        self.te = tcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=2)
        toks = rng.integers(10, 40, size=(2, PROMPT)).astype(np.int32)
        self.lens = np.array([PROMPT, PROMPT - 5], np.int32)
        self.glm = None
        if self.jc.position_embedding_type == "glm_2d":
            # each prompt: text, [gMASK], text, <sop> (its 2D positions and
            # prefix window follow from where they sit)
            toks[:, 4] = MASK_ID
            for b in range(2):
                toks[b, self.lens[b] - 1] = SOP_ID
            self.glm = np.stack([self.lens - 1, np.full(2, 4)], 1).astype(np.int32)
        self.toks = toks
        P = self.je.pages_per_req
        self.pt = np.arange(1, 1 + 2 * P, dtype=np.int32).reshape(2, P)

    def jglm(self):
        return None if self.glm is None else jnp.asarray(self.glm)

    def tglm(self):
        return None if self.glm is None else torch.from_numpy(self.glm)


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request):
    return Pair(request.param)


def _qmask(pair):
    C = PROMPT
    i = np.arange(C)
    qm = np.broadcast_to(i[:, None] >= i[None, :], (2, C, C)).copy()
    if pair.jc.prefix_lm:  # the prompt's keys are visible to every query
        qm |= i[None, None, :] < pair.glm[:, :1, None]
    return qm


def test_full_logits_match_jax(pair):
    qm = _qmask(pair)
    pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (2, PROMPT)).copy()
    valid = np.arange(PROMPT)[None] < pair.lens[:, None]
    causal = not pair.jc.prefix_lm
    jkv = j_init_kv(pair.jc, pair.je, dtype=jnp.float32)
    jh, _ = jbase.transformer_hidden(
        pair.jp, pair.jc, jkv, jnp.asarray(pair.toks), jnp.asarray(pos), jnp.asarray(pair.pt),
        jnp.zeros(2, jnp.int32), jnp.asarray(qm), jnp.asarray(valid),
        causal_window=causal, glm_ids=pair.jglm())
    jl = np.asarray(jbase.logits_from_hidden(pair.jp, pair.jc, jh))
    tkv = t_init_kv(pair.tc, pair.te, dtype=torch.float32, device="cpu")
    th, _ = tbase.transformer_hidden(
        pair.tp, pair.tc, tkv, torch.from_numpy(pair.toks), torch.from_numpy(pos),
        torch.from_numpy(pair.pt), torch.zeros(2, dtype=torch.int32), torch.from_numpy(qm),
        torch.from_numpy(valid), causal_window=causal, glm_ids=pair.tglm())
    tl = tbase.logits_from_hidden(pair.tp, pair.tc, th).numpy()
    for b in range(2):
        n = pair.lens[b]
        np.testing.assert_allclose(tl[b, :n], jl[b, :n], atol=1e-4, rtol=0)


def test_greedy_streams_match_jax_and_lookahead_equals_ar(pair):
    jkv = j_init_kv(pair.jc, pair.je, dtype=jnp.float32)
    jkv, jn, _ = j_prefill(pair.jp, jkv, pair.jc, jnp.asarray(pair.toks),
                           jnp.zeros(2, jnp.int32), jnp.asarray(pair.lens),
                           jnp.asarray(pair.pt), glm_ids=pair.jglm())
    active = np.array([True, True])
    jr = j_decode(pair.jp, jkv, pair.jc, jn, jnp.asarray(pair.lens), jnp.asarray(active),
                  jnp.asarray(pair.pt), n_steps=AR_STEPS, glm_ids=pair.jglm())

    def prefill():
        kv = t_init_kv(pair.tc, pair.te, dtype=torch.float32, device="cpu")
        return t_prefill(pair.tp, kv, pair.tc, torch.from_numpy(pair.toks),
                         torch.zeros(2, dtype=torch.int32), torch.from_numpy(pair.lens),
                         torch.from_numpy(pair.pt), glm_ids=pair.tglm())

    tkv, tn, _ = prefill()
    assert (tn.numpy() == np.asarray(jn)).all()
    tr = t_decode(pair.tp, tkv, pair.tc, tn, torch.from_numpy(pair.lens),
                  torch.from_numpy(active), torch.from_numpy(pair.pt), n_steps=AR_STEPS,
                  glm_ids=pair.tglm())
    ar = tr[1].numpy()
    assert (ar == np.asarray(jr[1])).all()
    # lookahead over tables seeded with the AR stream itself, so drafts land
    tcfg = tdt.DraftTableConfig(buckets=64, ways=4, branch_length=4, retrieve_count=2)
    tables = tdt.init_draft_tables(tcfg, "cpu")
    TAIL = tcfg.branch_length + 2
    tails = np.zeros((2, TAIL), np.int32)
    for b in range(2):
        seq = list(pair.toks[b, : pair.lens[b]]) + [int(tn[b])] + list(ar[b])
        tdt.update_tables_seq(tables, tcfg, torch.tensor(seq, dtype=torch.int32), len(seq))
        tails[b] = seq[pair.lens[b] + 1 - TAIL: pair.lens[b] + 1]
    tkv, tn, _ = prefill()
    sr = t_spec(pair.tp, tkv, tables, pair.tc, tcfg, tn, torch.from_numpy(pair.lens),
                torch.from_numpy(active), torch.from_numpy(tails), torch.from_numpy(pair.pt),
                n_steps=8, update_tables=False, glm_ids=pair.tglm())
    out, acc = sr[2].numpy(), sr[3].numpy()
    assert acc.sum() > 12  # drafts were accepted
    for b in range(2):
        stream = np.concatenate([out[b, s, : acc[b, s]] for s in range(out.shape[1])])
        n = min(len(stream), AR_STEPS)
        assert (stream[:n] == ar[b, :n]).all()


def test_a_later_branch_sees_the_ar_logits(pair):
    """A tree verify of two branches of four (Q = 9), a wrong draft on
    branch 0 and the AR continuation on branch 1: each branch-1 node's
    logits row equals the AR decode row at the same prefix (atol 1e-4, the
    keys sit at other arena slots, so sums run in other orders). Node l of
    branch 1 sits at slot ctx + 1 + L + l but at position ctx + 1 + l, so
    ALiBi (bloom, baichuan-13b) must bias each key by its position."""
    from painlessinferenceacceleration_tpu_torch.engine.step import (
        _verify_forward,
        decode_inputs,
    )

    R, L = 2, 4
    lens, pt = torch.from_numpy(pair.lens), torch.from_numpy(pair.pt)
    active = torch.ones(2, dtype=torch.bool)

    def prefill():
        kv = t_init_kv(pair.tc, pair.te, dtype=torch.float32, device="cpu")
        return t_prefill(pair.tp, kv, pair.tc, torch.from_numpy(pair.toks),
                         torch.zeros(2, dtype=torch.int32), lens, pt, glm_ids=pair.tglm())

    kv, root, _ = prefill()
    rows, fed, last, ctx = [], [], root, lens.clone()
    for _ in range(L + 1):  # AR: root, then the L tokens it picks
        t, p, qm, par = decode_inputs(last, ctx)
        kv, logits, _ = _verify_forward(pair.tp, kv, pair.tc, t, p, qm, par, pt, ctx, active,
                                        None, None, pair.tglm())
        rows.append(logits[:, 0])
        last = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        fed.append(last)
        ctx = ctx + 1
    ar = torch.stack(fed[:L], dim=1)  # [B, L]
    wrong = (ar + 1) % pair.tc.vocab_size
    tokens, parents, qmask, depth = tdt.build_tree_inputs(root, torch.stack([wrong, ar], 1))
    kv, _, _ = prefill()
    _, vl, _ = _verify_forward(pair.tp, kv, pair.tc, tokens, lens[:, None] + depth, qmask,
                               parents, pt, lens, active, None, None, pair.tglm())
    np.testing.assert_allclose(vl[:, 0].numpy(), rows[0].numpy(), atol=1e-4, rtol=0)
    for i in range(L):
        np.testing.assert_allclose(vl[:, 1 + L + i].numpy(), rows[1 + i].numpy(), atol=1e-4,
                                   rtol=0, err_msg=f"branch 1 node {i}")


def test_multimodal_prefill_matches_jax():
    """Embeddings spliced over prompt positions 3..6 of row 0 and 0..1 of
    row 1 (the rest padding), in two chunks, against JAX's prefill."""
    jc, tc = jcfg_mod.ModelConfig.tiny(), tcfg_mod.ModelConfig.tiny()
    jp = jbase.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    je = jcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=2)
    te = tcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=2)
    rng = np.random.default_rng(4)
    toks = rng.integers(10, 200, size=(2, 24)).astype(np.int32)
    me = (rng.standard_normal((2, 4, jc.hidden_size)) * 0.5).astype(np.float32)
    mp = np.array([[3, 4, 5, 6], [0, 13, -1, -1]], np.int32)
    P = je.pages_per_req
    pt = np.arange(1, 1 + 2 * P, dtype=np.int32).reshape(2, P)
    jkv = j_init_kv(jc, je, dtype=jnp.float32)
    tkv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    for start in (0, 12):  # two chunks of 12: the splice lands where each reaches
        chunk = toks[:, start: start + 12]
        lens = np.array([12, 12], np.int32)
        jkv, jn, jl = j_prefill(jp, jkv, jc, jnp.asarray(chunk), jnp.full(2, start, jnp.int32),
                                jnp.asarray(lens), jnp.asarray(pt),
                                mm_embeds=jnp.asarray(me), mm_pos=jnp.asarray(mp))
        tkv, tn, tl = t_prefill(tp, tkv, tc, torch.from_numpy(chunk),
                                torch.full((2,), start, dtype=torch.int32),
                                torch.from_numpy(lens), torch.from_numpy(pt),
                                mm_embeds=torch.from_numpy(me), mm_pos=torch.from_numpy(mp))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        assert (tn.numpy() == np.asarray(jn)).all()
    # the splice changed the logits: a prefill without it differs
    tkv2 = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    _, _, plain = t_prefill(tp, tkv2, tc, torch.from_numpy(toks[:, :12]),
                            torch.zeros(2, dtype=torch.int32),
                            torch.tensor([12, 12], dtype=torch.int32), torch.from_numpy(pt))
    assert not np.allclose(plain.numpy(), np.asarray(
        j_prefill(jp, j_init_kv(jc, je, dtype=jnp.float32), jc, jnp.asarray(toks[:, :12]),
                  jnp.zeros(2, jnp.int32), jnp.asarray([12, 12], jnp.int32), jnp.asarray(pt),
                  mm_embeds=jnp.asarray(me), mm_pos=jnp.asarray(mp))[2]), atol=1e-3)


@pytest.mark.parametrize("family", ["glm", "bloom"])
def test_llm_serving_matches_jax(family):
    """The engine serves the family (AntGLM's 2D positions and prefix-LM
    window from each prompt's mask token, on every route): greedy outputs
    equal to the JAX engine's, with lookahead and without."""
    from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
    from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP

    pair = Pair(family)
    prompts = [list(pair.toks[b, : pair.lens[b]]) for b in range(2)]
    prompts.append(prompts[0][:6] + ([SOP_ID] if family == "glm" else []))
    kw = dict(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=4, eos_token_id=-2,
              decoding_length=8, branch_length=4)
    jl = JLLM(cfg=pair.jc, params=pair.jp, ecfg=jcfg_mod.EngineConfig(**kw),
              dtype=jnp.float32)
    want = [r.output_ids for r in jl.generate(prompts, JSP(max_new_tokens=16))]
    for la in (False, True):
        tl = TLLM(cfg=pair.tc, params=pair.tp, dtype=torch.float32, device="cpu",
                  ecfg=tcfg_mod.EngineConfig(use_lookahead=la, **kw))
        got = [r.output_ids for r in tl.generate(prompts, TSP(max_new_tokens=16))]
        assert got == want, la


def test_llm_multimodal_request_matches_jax():
    """A request with embeddings over prompt positions 2..4 (no prefix-cache
    match for it) beside a plain one: outputs equal to the JAX engine's."""
    from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
    from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
    from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
    from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP

    jc, tc = jcfg_mod.ModelConfig.tiny(), tcfg_mod.ModelConfig.tiny()
    jp = jbase.init_params(jc, jax.random.PRNGKey(8), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    me = (rng.standard_normal((3, jc.hidden_size)) * 0.5).astype(np.float32)
    prompt = list(range(30, 50))
    kw = dict(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=4, eos_token_id=-2)
    outs = []
    for llm, sp in ((JLLM(cfg=jc, params=jp, ecfg=jcfg_mod.EngineConfig(**kw),
                          dtype=jnp.float32), JSP),
                    (TLLM(cfg=tc, params=tp, ecfg=tcfg_mod.EngineConfig(**kw),
                          dtype=torch.float32, device="cpu"), TSP)):
        plain = llm.add_request(prompt, sp(max_new_tokens=10))
        mm = llm.add_request(prompt, sp(max_new_tokens=10), mm_embeds=me,
                             mm_positions=[2, 3, 4])
        while plain.state != "finished" or mm.state != "finished":
            llm.step()
        outs.append((plain.output_ids, mm.output_ids))
    assert outs[1] == outs[0]
    assert outs[1][0] != outs[1][1]  # the embeddings changed the stream


def test_generator_refuses_glm_positions():
    """LookaheadGenerator passes no GLM positions (as in the JAX package):
    an AntGLM model is refused when it is built, not mid-stream."""
    from painlessinferenceacceleration_tpu_torch.lookahead.generate import LookaheadGenerator

    pair = Pair("glm")
    with pytest.raises(NotImplementedError, match="LLM"):
        LookaheadGenerator(pair.tp, pair.tc, pair.te, dtype=torch.float32, device="cpu")
