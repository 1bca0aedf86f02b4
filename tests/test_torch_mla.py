"""The PyTorch port's Multi-head Latent Attention path against the JAX
package, on the CPU, at tiny widths.

Weights are drawn by the JAX package and carried over with
``params_from_jax``; inputs come from numpy seeds. The Pallas MLA kernel runs
in interpret mode, as the JAX package's own tests run it. Tolerances (fp32
on both sides, sums in other orders): attention 2e-5, the attention block
1e-5, rope 1e-6, model logits 1e-4; tokens, accepted counts and arenas'
integer layouts are equal. The JAX latent arena pads its K row to a multiple
of 128 lanes; the port's does not, so arenas are compared over the real
lanes and the JAX pad lanes are held to zero.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jconfig
from painlessinferenceacceleration_tpu.engine.cache import (
    init_kv_cache as j_init_kv,
    write_kv_pages as j_write_kv,
)
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.multistep import (
    multistep_decode as j_decode,
    multistep_spec_decode as j_spec,
)
from painlessinferenceacceleration_tpu.engine.request import (
    SamplingParams as JSamplingParams,
)
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec
from painlessinferenceacceleration_tpu.lookahead import device_tables as jdt
from painlessinferenceacceleration_tpu.models import mla as jmla
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params
from painlessinferenceacceleration_tpu.ops import rope as jrope
from painlessinferenceacceleration_tpu.ops.attention import (
    paged_attention_ref as j_attn_ref,
)
from painlessinferenceacceleration_tpu.ops.mla_attention import (
    mla_paged_attention as j_mla_attn,
)

from painlessinferenceacceleration_tpu_torch import config as tconfig
from painlessinferenceacceleration_tpu_torch.engine.cache import (
    init_kv_cache as t_init_kv,
    kv_bytes_per_page,
)
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.multistep import (
    multistep_decode as t_decode,
    multistep_spec_decode as t_spec,
)
from painlessinferenceacceleration_tpu_torch.engine.request import (
    SamplingParams as TSamplingParams,
)
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as tdt
from painlessinferenceacceleration_tpu_torch.models import mla as tmla
from painlessinferenceacceleration_tpu_torch.models.base import (
    init_params as t_init_params,
    init_params_quantized as t_init_params_quantized,
)
from painlessinferenceacceleration_tpu_torch.models.convert import (
    kv_from_jax,
    params_from_jax,
)
from painlessinferenceacceleration_tpu_torch.ops import rope as trope
from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
    mla_paged_attention,
    mla_paged_attention_plain,
)

# deepseek-ai/DeepSeek-V2-Lite's config.json
V2_LITE_HF = {
    "architectures": ["DeepseekV2ForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "aux_loss_alpha": 0.001, "bos_token_id": 100000,
    "eos_token_id": 100001, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "initializer_range": 0.02, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "pretraining_tp": 1, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "greedy", "torch_dtype": "bfloat16", "use_cache": True,
    "v_head_dim": 128, "vocab_size": 102400,
}
PORT_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]
YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
# tiny deepseek_v2 (softmax routing, no renormalisation, 2 shared experts,
# first layer dense, yarn) and deepseek_v3 (sigmoid + group routing, q_lora)
MODELS = {
    "v2": dict(model_type="deepseek_v2", vocab_size=256, hidden_size=64,
               intermediate_size=96, moe_intermediate_size=48, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               moe_layer_start=1, num_experts=4, num_experts_per_tok=2,
               num_shared_experts=2, norm_topk_prob=False, rms_norm_eps=1e-6,
               rope_scaling=YARN),
    "v3": dict(model_type="deepseek_v3", vocab_size=256, hidden_size=64,
               intermediate_size=96, moe_intermediate_size=48, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=4, q_lora_rank=24,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, moe_layer_start=1, num_experts=8, num_experts_per_tok=2,
               num_shared_experts=1, scoring_func="sigmoid", n_group=4, topk_group=2,
               routed_scaling_factor=2.5),
}


def both(latent=True, **kw):
    kw = dict(kw, mla_latent_cache=latent)
    return jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)


def to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def t2n(t):
    return t.detach().to(torch.float32).numpy()


def close(got, ref, tol):
    np.testing.assert_allclose(t2n(got) if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", PORT_FIELDS)
def test_deepseek_v2_lite_is_the_hf_config(field):
    ref = dataclasses.replace(jconfig.ModelConfig.from_hf(V2_LITE_HF), mla_latent_cache=True)
    assert getattr(tconfig.ModelConfig.deepseek_v2_lite(), field) == getattr(ref, field)


@pytest.mark.parametrize("field", PORT_FIELDS)
def test_mla_3b_matches_jax(field):
    assert getattr(tconfig.ModelConfig.mla_3b(), field) == getattr(
        jconfig.ModelConfig.mla_3b(), field)


def test_mla_fields_default_off():
    c = tconfig.ModelConfig()
    assert not c.is_mla and tconfig.ModelConfig.deepseek_v2_lite().is_mla
    assert (c.q_lora_rank, c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim,
            c.v_head_dim, c.mla_latent_cache) == (0, 0, 0, 0, 0, False)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

ROPE_CASES = {
    "default": dict(),
    "linear": dict(rope_scaling={"rope_type": "linear", "factor": 4.0}),
    "llama3": dict(rope_theta=500000.0, head_dim=128, hidden_size=4096,
                   rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                 "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 8192}),
    "yarn": dict(qk_rope_head_dim=64, kv_lora_rank=512,
                 rope_scaling=V2_LITE_HF["rope_scaling"]),
    "yarn_v3": dict(qk_rope_head_dim=64, kv_lora_rank=512, rope_theta=10000.0,
                    rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                                  "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 1.0,
                                  "original_max_position_embeddings": 4096}),
}


@pytest.mark.parametrize("case", ROPE_CASES)
def test_rope_inv_freq_and_mscale_match_jax(case):
    jc, tc = jconfig.ModelConfig(**ROPE_CASES[case]), tconfig.ModelConfig(**ROPE_CASES[case])
    close(trope.rope_inv_freq(tc), jrope.rope_inv_freq(jc), 1e-6)
    assert trope.yarn_mscale(tc) == pytest.approx(jrope.yarn_mscale(jc), abs=1e-12)
    pos = np.arange(0, 5000, 37, dtype=np.int32).reshape(8, -1)
    tcs = trope.dense_cos_sin(tc, torch.from_numpy(pos))
    jcs = jrope.dense_cos_sin(jc, jnp.asarray(pos))
    for t, j in zip(tcs, jcs):
        close(t, j, 1e-5)  # fp32 angles up to ~5000 rad: a few ulp of the angle


@pytest.mark.parametrize("interleaved", [False, True], ids=["rotate_half", "interleaved"])
@pytest.mark.parametrize("mscale", [1.0, 1.3])
def test_apply_rope_matches_jax(interleaved, mscale):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    inv = (1.0 / 10000 ** (np.arange(0, 16, 2) / 16)).astype(np.float32)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(inv), torch.from_numpy(pos), mscale)
    jc, js = jrope.rope_cos_sin(jnp.asarray(inv), jnp.asarray(pos), mscale)
    close(tc, jc, 1e-6)
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, interleaved=interleaved)
    close(got, jrope.apply_rope(jnp.asarray(x), jc, js, interleaved=interleaved), 1e-6)


def test_unknown_rope_type_raises():
    tc = tconfig.ModelConfig(rope_scaling={"rope_type": "dynamic", "factor": 2.0})
    with pytest.raises(ValueError):
        trope.rope_inv_freq(tc)


# ---------------------------------------------------------------------------
# MLA attention: the plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------


J_REF = jax.jit(j_attn_ref, static_argnames=("scale", "v_dim"))  # eager: ~5x slower
J_WRITE = jax.jit(j_write_kv)


def _attn_case(B, Q, ctx_lens, qmask, H=4, r=32, rope_d=16, ps=16, seed=0, max_seq=128):
    """A one-"head" [latent | k_pe] arena written by the JAX package (V = the
    latent), the same q, both packages' answers."""
    rng = np.random.default_rng(seed)
    Dk = r + rope_d
    P = max_seq // ps
    n_pages = B * P + 1
    kp = jnp.zeros((n_pages, ps, Dk), jnp.float32)
    vp = jnp.zeros((n_pages, ps, r), jnp.float32)
    pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    maxc = max(ctx_lens)
    k_ctx = jnp.asarray(rng.normal(size=(B, maxc, 1, Dk)).astype(np.float32))
    valid = jnp.asarray(np.arange(maxc)[None, :] < np.array(ctx_lens)[:, None])
    kp, vp = J_WRITE(kp, vp, k_ctx, k_ctx[..., :r], jnp.asarray(pt),
                     jnp.zeros((B,), jnp.int32), valid)
    ctx = np.array(ctx_lens, np.int32)
    k_q = jnp.asarray(rng.normal(size=(B, Q, 1, Dk)).astype(np.float32))
    kp, vp = J_WRITE(kp, vp, k_q, k_q[..., :r], jnp.asarray(pt), jnp.asarray(ctx))
    q = rng.normal(size=(B, Q, H, Dk)).astype(np.float32)
    qm = np.asarray(qmask)
    scale = Dk ** -0.5
    args = (jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qm))
    ref = J_REF(jnp.asarray(q), kp, vp, *args, scale=scale, v_dim=r)
    pallas = j_mla_attn(jnp.asarray(q), kp, *args, scale, v_dim=r, interpret=True)
    got = mla_paged_attention_plain(torch.from_numpy(q), torch.from_numpy(np.array(kp)),
                                    torch.from_numpy(pt), torch.from_numpy(ctx),
                                    torch.from_numpy(qm), scale, r)
    return got, ref, pallas, (q, kp, pt, ctx, qm, scale, r)


def _causal(B, Q):
    return np.tile(np.tril(np.ones((Q, Q), bool))[None], (B, 1, 1))


def _tree(B):
    branches = jnp.array([[5, 6, 7], [9, 10, -1]], jnp.int32)
    _, _, qm, _ = jdt.build_tree_inputs(jnp.int32(3), branches)
    return np.tile(np.asarray(qm)[None], (B, 1, 1))


ATTN_CASES = {
    "decode": lambda: _attn_case(3, 1, [5, 17, 32], np.ones((3, 1, 1), bool)),
    "ragged_page_boundaries": lambda: _attn_case(4, 1, [15, 16, 17, 1],
                                                 np.ones((4, 1, 1), bool)),
    "tree_mask": lambda: _attn_case(2, 7, [11, 30], _tree(2)),
    "row_tiling_h64": lambda: _attn_case(2, 8, [9, 21], _causal(2, 8), H=64),
    "causal_q160": lambda: _attn_case(2, 160, [7, 31], _causal(2, 160), max_seq=256),
}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_mla_attention_plain_matches_jax(case):
    got, ref, pallas, _ = ATTN_CASES[case]()
    close(got, ref, 2e-5)
    close(got, pallas, 2e-5)


def test_mla_attention_causal_flag_is_the_causal_mask():
    _, _, _, (q, kp, pt, ctx, qm, scale, r) = ATTN_CASES["causal_q160"]()
    args = (torch.from_numpy(q), torch.from_numpy(np.array(kp)), torch.from_numpy(pt),
            torch.from_numpy(ctx))
    masked = mla_paged_attention(*args, torch.from_numpy(qm), scale, r)
    causal = mla_paged_attention(*args, None, scale, r, causal=True)
    assert torch.equal(masked, causal) and mla_paged_attention.launches == 0


# ---------------------------------------------------------------------------
# the attention block, both cache modes, with and without q_lora
# ---------------------------------------------------------------------------


def _block_params(jc, seed):
    """One JAX MLA layer with random norm weights, and the port's stack of 1."""
    lp = jax.jit(jmla.init_mla_attn, static_argnums=(0, 2, 3))(
        jc, jax.random.PRNGKey(seed), jnp.float32, None)
    rng = np.random.default_rng(seed)
    for name in ("kv_a_ln", "q_a_ln"):
        if name in lp:
            lp[name] = jnp.asarray(1.0 + 0.2 * rng.normal(size=lp[name].shape)
                                   .astype(np.float32))
    stacked = {k: v[None] for k, v in to_torch(lp).items()}
    return lp, stacked


J_BLOCK = jax.jit(jmla.mla_attn_block, static_argnums=(1, 2))  # eager: ~10x slower


@pytest.mark.parametrize("latent", [True, False], ids=["latent", "expanded"])
@pytest.mark.parametrize("q_lora", [0, 24], ids=["wq", "q_lora"])
def test_mla_attn_block_matches_jax(latent, q_lora):
    kw = dict(MODELS["v2"], q_lora_rank=q_lora, num_hidden_layers=1)
    jc, tc = both(latent, **kw)
    lp, stacked = _block_params(jc, 1)
    je = jconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=2)
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=2)
    jkv = j_init_kv(jc, je, dtype=jnp.float32)
    tkv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    kk, vv = jkv["k"], jkv["v"]
    rng = np.random.default_rng(2)
    B, P = 2, je.pages_per_req
    pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    start = np.zeros(B, np.int32)
    # a 9-token prefill (the second row has 6 valid tokens), then a 7-wide
    # tree verify over it
    for Q, qmask in ((9, _causal(B, 9)), (7, _tree(B))):
        h = rng.normal(size=(B, Q, jc.hidden_size)).astype(np.float32)
        pos = start[:, None] + np.arange(Q, dtype=np.int32)[None]
        valid = np.arange(Q)[None] < np.array([Q, Q - 3])[:, None]
        jcs = jmla.mla_rope_cos_sin(jc, jnp.asarray(pos))
        tcs = tmla.mla_rope_cos_sin(tc, torch.from_numpy(pos))
        for t, j in zip(tcs, jcs):
            close(t, j, 1e-6)
        jout, kk, vv = J_BLOCK(
            lp, jc, None, jnp.asarray(h), *jcs, kk, vv, 0, jnp.asarray(pt),
            jnp.asarray(start), jnp.asarray(qmask), jnp.asarray(valid))
        tout = tmla.mla_attn_block(
            stacked, 0, 0, tc, None, torch.from_numpy(h), *tcs, tkv, torch.from_numpy(pt),
            torch.from_numpy(start), torch.from_numpy(qmask), torch.from_numpy(valid),
            Q == 9)
        close(tout, jout, 1e-5)
        start = start + np.array([Q, Q - 3], np.int32)
    k_row = tmla.mla_head_dims(tc)[0] * tmla.mla_cache_heads(tc)
    jk = np.asarray(kk)
    assert tkv["k"].shape[-1] == k_row and tkv["v"].shape == vv.shape
    close(tkv["k"], jk[..., :k_row], 1e-5)
    assert not jk[..., k_row:].any()  # the TPU's lane padding holds zeros
    close(tkv["v"], vv, 1e-5)


def test_expanded_mode_raises_on_a_card(monkeypatch):
    """Expanded MLA no longer raises on a card: its attention is the paged
    attention kernel (K2 / K3) at head dims (192, 128). DeepSeek-V2-Lite's
    expanded geometry passes the card's model check (K3's causal rule above
    128 rows), and the block hands the wrappers q rows of nope + rope lanes
    over K arena rows of H of them beside V rows of H * v_head_dim (recorded
    here through the plain versions, which equal JAX's block above)."""
    from painlessinferenceacceleration_tpu_torch.models.base import check_model_on_card

    lite = dataclasses.replace(tconfig.ModelConfig.deepseek_v2_lite(), mla_latent_cache=False)
    check_model_on_card(lite, {}, 64)
    seen = []

    def spy(real):
        def call(q, k, v, *a, **kw):
            seen.append((real.__name__, q.shape[1], q.shape[-1], k.shape[-1], v.shape[-1]))
            return real(q, k, v, *a, **kw)
        return call

    monkeypatch.setattr(tmla, "paged_attention", spy(tmla.paged_attention))
    monkeypatch.setattr(tmla, "paged_attention_prefill", spy(tmla.paged_attention_prefill))
    _, tc = both(False, **dict(MODELS["v2"], num_hidden_layers=1))
    _, stacked = _block_params(both(False, **dict(MODELS["v2"], num_hidden_layers=1))[0], 1)
    te = tconfig.EngineConfig(page_size=16, max_seq_len=512, max_concurrency=1)
    tkv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    pt = torch.arange(1, 1 + te.pages_per_req, dtype=torch.int32)[None]
    H, dk, dv = tc.num_attention_heads, *tmla.mla_head_dims(tc)
    for Q, causal in ((130, True), (3, False)):
        h = torch.randn(1, Q, tc.hidden_size, generator=torch.Generator().manual_seed(Q))
        pos = torch.arange(Q)[None]
        i = torch.arange(Q)
        out = tmla.mla_attn_block(stacked, 0, 0, tc, None, h, *tmla.mla_rope_cos_sin(tc, pos),
                                  tkv, pt, torch.zeros(1, dtype=torch.int32),
                                  (i[:, None] >= i[None, :])[None], None, causal)
        assert out.shape == (1, Q, tc.hidden_size) and torch.isfinite(out).all()
    assert seen == [("paged_attention_prefill", 130, dk, H * dk, H * dv),
                    ("paged_attention", 3, dk, H * dk, H * dv)], seen


# ---------------------------------------------------------------------------
# whole models: logits, greedy and lookahead tokens, LLM serving
# ---------------------------------------------------------------------------

B, C, PAGE, MAX_SEQ = 2, 24, 16, 256
BR, BL = 2, 8  # draft branches, branch length: verify width Q = 1 + BR * BL = 17
ACTIVE = np.array([True, False])


def _jax_params(jc, seed=0):
    jp = jax.jit(lambda key: j_init_params(jc, key, dtype=jnp.float32))(  # eager: ~1.6x
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for stack in ("layers", "moe_layers"):
        for name in ("input_ln", "post_ln", "kv_a_ln", "q_a_ln"):
            if name in jp.get(stack, {}):
                shape = jp[stack][name].shape
                jp[stack][name] = jnp.asarray(
                    1.0 + 0.2 * rng.normal(size=shape).astype(np.float32))
    return jp


class Pair:
    """One tiny MLA model in both packages (and the port's other cache
    mode), with shared prompts; prompts of a small alphabet, and a teacher
    stream that repeats them, so drafts land and verify compacts the
    arenas."""

    def __init__(self, name, latent=True):
        self.jc, self.tc = both(latent, **MODELS[name])
        self.jp = _jax_params(self.jc)
        self.tp = to_torch(self.jp)
        self.je = jconfig.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=B)
        self.te = tconfig.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=B)
        rng = np.random.default_rng(7)
        self.toks = rng.integers(10, 22, size=(B, C)).astype(np.int32)
        self.lens = np.array([C, 17], np.int32)
        P = self.je.pages_per_req
        self.pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
        self.teacher = np.stack([np.tile(self.toks[b, : self.lens[b]], 15)[:240]
                                 for b in range(B)])

    def prefill_jax(self):
        kv = j_init_kv(self.jc, self.je, dtype=jnp.float32)
        return j_prefill(self.jp, kv, self.jc, jnp.asarray(self.toks),
                         jnp.zeros(B, jnp.int32), jnp.asarray(self.lens),
                         jnp.asarray(self.pt))

    def prefill_torch(self, tc=None):
        tc = tc or self.tc
        kv = t_init_kv(tc, self.te, dtype=torch.float32, device="cpu")
        return t_prefill(self.tp, kv, tc, torch.from_numpy(self.toks),
                         torch.zeros(B, dtype=torch.int32), torch.from_numpy(self.lens),
                         torch.from_numpy(self.pt))

    def spec_torch(self, tc, n_steps):
        tcfg = tdt.DraftTableConfig(buckets=16, ways=4, branch_length=BL, retrieve_count=BR)
        kv, _, _ = self.prefill_torch(tc)
        nxt = torch.from_numpy(self.teacher[np.arange(B), self.lens])
        seed = list(self.toks[0, : self.lens[0]]) + [int(nxt[0])]
        tables = tdt.update_tables_seq(tdt.init_draft_tables(tcfg, "cpu"), tcfg,
                                       torch.tensor(seed, dtype=torch.int32), len(seed))
        tail = np.tile(np.array(seed[-(BL + 2):], np.int32), (B, 1))
        return t_spec(self.tp, kv, tables, tc, tcfg, nxt, torch.from_numpy(self.lens),
                      torch.from_numpy(ACTIVE), torch.from_numpy(tail),
                      torch.from_numpy(self.pt), n_steps=n_steps,
                      teacher=torch.from_numpy(self.teacher)), seed, tail


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return Pair(request.param)


def test_prefill_logits_match_jax(pair):
    _, jn, jl = pair.prefill_jax()
    _, tn, tl = pair.prefill_torch()
    close(tl, jl, 1e-4)
    assert (tn.numpy() == np.asarray(jn)).all()


def test_greedy_tokens_match_jax(pair):
    jkv, jn, _ = pair.prefill_jax()
    tkv, tn, _ = pair.prefill_torch()
    jr = j_decode(pair.jp, jkv, pair.jc, jn, jnp.asarray(pair.lens), jnp.asarray(ACTIVE),
                  jnp.asarray(pair.pt), n_steps=16)
    tr = t_decode(pair.tp, tkv, pair.tc, tn, torch.from_numpy(pair.lens),
                  torch.from_numpy(ACTIVE), torch.from_numpy(pair.pt), n_steps=16)
    assert (tr[1].numpy() == np.asarray(jr[1])).all()
    assert (tr[3].numpy() == np.asarray(jr[3])).all()  # ctx


def test_lookahead_matches_jax_and_compacts_both_arenas(pair):
    (tr, seed, tail) = pair.spec_torch(pair.tc, 12)
    jtc = jdt.DraftTableConfig(buckets=16, ways=4, branch_length=BL, retrieve_count=BR)
    jkv, _, _ = pair.prefill_jax()
    jt = jdt.update_tables_seq(jdt.init_draft_tables(jtc), jtc, jnp.asarray(seed, jnp.int32),
                               jnp.int32(len(seed)))
    jn = jnp.asarray(pair.teacher[np.arange(B), pair.lens])
    jr = j_spec(pair.jp, jkv, jt, pair.jc, jtc, jn, jnp.asarray(pair.lens),
                jnp.asarray(ACTIVE), jnp.asarray(tail), jnp.asarray(pair.pt), n_steps=12,
                teacher=jnp.asarray(pair.teacher))
    assert (tr[2].numpy() == np.asarray(jr[2])).all()  # out_toks
    assert (tr[3].numpy() == np.asarray(jr[3])).all()  # n_acc
    assert tr[3].max() > 1, "drafts never landed: no compaction was exercised"
    k_row = tr[0]["k"].shape[-1]  # the null page 0 holds whatever padding rows wrote
    close(tr[0]["k"][:, 1:], np.asarray(jr[0]["k"])[:, 1:, ..., :k_row], 1e-4)
    close(tr[0]["v"][:, 1:], np.asarray(jr[0]["v"])[:, 1:], 1e-4)


def test_latent_tokens_equal_expanded_tokens(pair):
    exp_tc = dataclasses.replace(pair.tc, mla_latent_cache=False)
    lat, _, _ = pair.spec_torch(pair.tc, 12)
    exp, _, _ = pair.spec_torch(exp_tc, 12)
    assert torch.equal(lat[2], exp[2]) and torch.equal(lat[3], exp[3])
    te = pair.te
    assert (kv_bytes_per_page(pair.tc, te, torch.float32)
            < kv_bytes_per_page(exp_tc, te, torch.float32))


def test_llm_serving_matches_jax_and_lookahead_is_lossless(pair):
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=4, eos_token_id=-2)
    prompts = [[5, 6, 7], [9, 10], [20, 21, 22, 23] * 4]
    ref = [o.output_ids for o in JLLM(
        cfg=pair.jc, params=pair.jp, ecfg=jconfig.EngineConfig(**kw), dtype=jnp.float32
    ).generate(prompts, JSamplingParams(max_new_tokens=10))]
    outs = []
    for la in (False, True):
        ecfg = tconfig.EngineConfig(**kw, use_lookahead=la, decoding_length=8,
                                    branch_length=4)
        llm = TLLM(cfg=pair.tc, params=pair.tp, ecfg=ecfg, dtype=torch.float32,
                   device="cpu")
        outs.append([r.output_ids for r in llm.generate(
            prompts, TSamplingParams(max_new_tokens=10))])
    assert outs[0] == ref
    assert outs[1] == outs[0]
    exp = TLLM(cfg=dataclasses.replace(pair.tc, mla_latent_cache=False), params=pair.tp,
               ecfg=tconfig.EngineConfig(**kw), dtype=torch.float32, device="cpu")
    assert [r.output_ids for r in exp.generate(
        prompts, TSamplingParams(max_new_tokens=10))] == ref


# ---------------------------------------------------------------------------
# parameters, arenas, conversion
# ---------------------------------------------------------------------------


def _tree_shapes(tree):
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name,quant", [("v2", None), ("v3", None), ("v3", 8)])
def test_init_params_tree_matches_jax(name, quant):
    jc, tc = both(**MODELS[name])
    jq = None if quant is None else JQuantSpec(bits=quant, group=16)
    tq = None if quant is None else TQuantSpec(bits=quant, group=16)
    jp = jax.eval_shape(lambda key: j_init_params(jc, key, dtype=jnp.float32, quant=jq),
                        jax.random.PRNGKey(0))
    tp = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu", quant=tq)
    assert _tree_shapes(jp) == _tree_shapes(tp)


def test_init_params_quantized_serves_mla():
    _, tc = both(**MODELS["v3"])
    spec = TQuantSpec(bits=8, group=16)
    tp = t_init_params_quantized(tc, spec, torch.Generator().manual_seed(0), device="cpu")
    ref = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu", quant=spec)
    assert set(_tree_shapes(tp)) == set(_tree_shapes(ref))
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=1)
    kv = t_init_kv(tc, te, dtype=torch.bfloat16, device="cpu")
    _, nxt, logits = t_prefill(tp, kv, tc, torch.tensor([[5, 6, 7, 8]]),
                               torch.zeros(1, dtype=torch.int32), torch.tensor([4]),
                               torch.arange(1, 1 + te.pages_per_req,
                                            dtype=torch.int32)[None], spec)
    assert torch.isfinite(logits).all() and 0 <= int(nxt[0]) < tc.vocab_size


def test_arena_layout_and_kv_from_jax_round_trip():
    jc, tc = both(**MODELS["v2"])
    je = jconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=1)
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=1)
    jkv = j_init_kv(jc, je, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    r, rope = jc.kv_lora_rank, jc.qk_rope_head_dim
    k = jnp.asarray(rng.normal(size=(1, 20, 1, r + rope)).astype(np.float32))
    pad = jnp.zeros((1, 20, 1, jkv["k"].shape[-1] - r - rope), jnp.float32)
    kk, vv = j_write_kv(jkv["k"], jkv["v"], jnp.concatenate([k, pad], -1), k[..., :r],
                        jnp.arange(1, 1 + je.pages_per_req, dtype=jnp.int32)[None],
                        jnp.zeros((1,), jnp.int32), layer=1)
    k_row, v_row = tmla.mla_head_dims(tc)
    tkv = kv_from_jax({"k": np.asarray(kk), "v": np.asarray(vv)}, 1, "cpu", k_row=k_row)
    port = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    assert {n: t.shape for n, t in tkv.items()} == {n: t.shape for n, t in port.items()}
    assert (k_row, v_row) == (r + rope, r) and jkv["k"].shape[-1] == 128
    assert np.array_equal(tkv["k"].numpy(), np.asarray(kk)[..., :k_row])
    assert np.array_equal(tkv["v"].numpy(), np.asarray(vv))
    assert kv_bytes_per_page(tc, te, torch.bfloat16) == (
        tc.num_hidden_layers * 16 * (k_row + v_row) * 2)


@pytest.mark.parametrize("kv_quant", ["fp8", "fp8_tok"])
def test_mla_arena_under_kv_quant(kv_quant):
    """fp8: the JAX package allocates an MLA arena in the model's dtype, with
    no scales, and so does the port; fp8_tok raises."""
    jc, tc = both(**MODELS["v2"])
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=1,
                              kv_quant=kv_quant)
    if kv_quant == "fp8_tok":
        with pytest.raises(ValueError, match="fp8_tok"):
            t_init_kv(tc, te, dtype=torch.float32, device="cpu")
        return
    je = jconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=1,
                              kv_quant=kv_quant)
    jkv = j_init_kv(jc, je, dtype=jnp.float32)
    tkv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    assert set(tkv) == set(jkv) == {"k", "v"} and tkv["k"].dtype == torch.float32
    llm = TLLM(cfg=tc, params=t_init_params(tc, torch.Generator().manual_seed(0),
                                            device="cpu"),
               ecfg=te, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        llm.calibrate_kv_scales([[5, 6, 7]])
