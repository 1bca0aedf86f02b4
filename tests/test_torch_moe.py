"""The PyTorch port's Mixture-of-Experts path against the JAX package, on
the CPU, at tiny widths.

Inputs come from numpy seeds; weights are drawn by the JAX package and
carried over with ``params_from_jax``. Where the JAX function reaches a
Pallas kernel it runs in interpret mode, as the JAX package's own tests run
it. Tolerances: fp32 on both sides with sums in different orders, 1e-5
(2e-4 on logits that went through the sharded JAX program, as the JAX
sharding tests hold it); the JAX int4 grouped body always writes bf16, so
that comparison is held to 1e-2; integer outputs (the alignment tables, the
routing pattern, tokens) are equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jconfig
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.request import (
    SamplingParams as JSamplingParams,
)
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec
from painlessinferenceacceleration_tpu.models import moe as jmoe
from painlessinferenceacceleration_tpu.models.base import (
    init_params as j_init_params,
    logits_from_hidden as j_logits,
    transformer_hidden as j_hidden,
)
from painlessinferenceacceleration_tpu.ops import moe_matmul as jmm
from painlessinferenceacceleration_tpu.ops.attention import causal_qmask as j_causal
from painlessinferenceacceleration_tpu.parallel.mesh import (
    make_mesh,
    shard_kv,
    shard_params,
)

from painlessinferenceacceleration_tpu_torch import config as tconfig
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.request import (
    SamplingParams as TSamplingParams,
)
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.layers.embedding import embed_logits
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.models import moe as tmoe
from painlessinferenceacceleration_tpu_torch.models.base import (
    init_params as t_init_params,
    logits_from_hidden as t_logits,
    transformer_hidden as t_hidden,
)
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.ops import moe_matmul as tmm
from painlessinferenceacceleration_tpu_torch.ops.attention import causal_qmask as t_causal

MOE_KW = dict(model_type="qwen3_moe", vocab_size=64, hidden_size=32,
              intermediate_size=64, moe_intermediate_size=32, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=2, num_experts=8,
              num_experts_per_tok=2, moe_layer_start=0)


def both(**kw):
    return jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)


def to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def t2n(t):
    return t.detach().to(torch.float32).numpy()


def close(got, ref, tol):
    np.testing.assert_allclose(t2n(got) if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# config, alignment, routing
# ---------------------------------------------------------------------------

MOE_FIELDS = ("num_experts", "num_experts_per_tok", "moe_intermediate_size",
              "num_shared_experts", "moe_layer_start", "norm_topk_prob",
              "routed_scaling_factor", "scoring_func", "n_group", "topk_group",
              "expert_parallel", "qk_norm")


@pytest.mark.parametrize("field", MOE_FIELDS)
def test_config_field_defaults_match(field):
    jc, tc = both()
    assert getattr(jc, field) == getattr(tc, field)
    assert not tc.is_moe and both(**MOE_KW)[1].is_moe


def test_mixtral_preset_widths():
    c = tconfig.ModelConfig.mixtral_8x7b()
    assert (c.hidden_size, c.intermediate_size, c.num_attention_heads,
            c.num_key_value_heads, c.head_dim, c.num_hidden_layers, c.vocab_size,
            c.num_experts, c.num_experts_per_tok, c.rope_theta, c.rms_norm_eps) == (
        4096, 14336, 32, 8, 128, 32, 32000, 8, 2, 1e6, 1e-5)


def _routing(seed, T, k, X, sentinel):
    rng = np.random.default_rng(seed)
    topi = np.stack([rng.permutation(X)[:k] for _ in range(T)]).astype(np.int32)
    if sentinel:  # about a third of the pairs are dropped
        topi = np.where(rng.random((T, k)) < 0.35, X, topi).astype(np.int32)
    topv = rng.random((T, k)).astype(np.float32)
    return topi, topv


@pytest.mark.parametrize("T,k,X,sentinel", [(8, 2, 4, False), (8, 2, 4, True),
                                            (150, 2, 8, True), (37, 4, 16, False),
                                            (1, 2, 8, False), (1, 8, 128, True)])
def test_moe_align_equals_jax(T, k, X, sentinel):
    topi, topv = _routing(T + X, T, k, X, sentinel)
    ref = jmm.moe_align(jnp.asarray(topi), jnp.asarray(topv), X, T)
    got = tmm.moe_align(torch.from_numpy(topi), torch.from_numpy(topv), X, T)
    for name, g, r in zip(("dest_tok", "row_w", "block_expert", "n_used"), got, ref):
        assert g.dtype == (torch.float32 if name == "row_w" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def test_align_rows_ascend_with_the_expert():
    T, k, X = 40, 4, 16
    topi, topv = _routing(5, T, k, X, True)
    dest_tok, row_w, be, n_used, tok_rows = tmm._align(
        torch.from_numpy(topi), torch.from_numpy(topv), X, T)
    assert (dest_tok[tok_rows] == torch.arange(T)[:, None]).all()
    blocks = tok_rows // tmm.BLOCK_M
    used = blocks < n_used[0]
    experts = torch.where(used, be[blocks.clamp(max=be.numel() - 1)].long(),
                          torch.full_like(blocks, X))
    assert (experts == torch.from_numpy(np.sort(topi, axis=1)).long()).all()
    rows = tmm._block_rows(dest_tok, T)
    assert int(rows.sum()) == T * k


ROUTE_CASES = {
    "softmax": dict(),
    "softmax_raw_scaled": dict(norm_topk_prob=False, routed_scaling_factor=2.5),
    "sigmoid_bias": dict(scoring_func="sigmoid"),
    "group_max_v2": dict(n_group=4, topk_group=2),
    "group_top2_v3": dict(scoring_func="sigmoid", n_group=4, topk_group=2,
                          routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_topk_matches_jax(case):
    kw = dict(MOE_KW, num_experts=16, num_experts_per_tok=4, **ROUTE_CASES[case])
    jc, tc = both(**kw)
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(33, 16)).astype(np.float32)
    bias = (rng.normal(size=16) * 0.3).astype(np.float32) \
        if kw.get("scoring_func") == "sigmoid" else None
    ref = np.asarray(jmoe.route_topk(jc, jnp.asarray(logits),
                                     None if bias is None else jnp.asarray(bias)))
    got = tmoe.route_topk(tc, torch.from_numpy(logits),
                          None if bias is None else torch.from_numpy(bias)).numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert ((got != 0).sum(1) == 4).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_stable_topk_takes_the_lowest_index_on_a_tie():
    x = np.array([[0.5, 0.0, 0.5, 0.5, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 2)
    gv, gi = tmm.stable_topk(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    # the routing of one token is the same alone and among other tokens
    tc = both(**MOE_KW)[1]
    logits = torch.from_numpy(np.random.default_rng(2).normal(size=(17, 8))
                              .astype(np.float32).round(1))  # rounded: ties happen
    full = tmoe.route_topk(tc, logits)
    for t in range(17):
        assert torch.equal(tmoe.route_topk(tc, logits[t: t + 1]), full[t: t + 1])


# ---------------------------------------------------------------------------
# the grouped GEMMs' plain versions against the Pallas bodies
# ---------------------------------------------------------------------------


def _grouped_inputs(T, k, X, K, sentinel=True, seed=0):
    topi, topv = _routing(seed, T, k, X, sentinel)
    dest_tok, row_w, be, nu = tmm.moe_align(torch.from_numpy(topi),
                                            torch.from_numpy(topv), X, T)
    rng = np.random.default_rng(seed + 1)
    x = np.concatenate([rng.normal(size=(T, K)).astype(np.float32),
                        np.zeros((1, K), np.float32)])[dest_tok.numpy()]
    return x, be.numpy(), nu.numpy()


def test_grouped_matmul_plain_matches_pallas():
    X, K, N = 4, 32, 48
    x, be, nu = _grouped_inputs(70, 2, X, K)
    w = np.random.default_rng(3).normal(size=(X, K, N)).astype(np.float32)
    ref = jmm.grouped_matmul(jnp.asarray(x), jnp.asarray(be), jnp.asarray(nu),
                             jnp.asarray(w), interpret=True)
    got = tmm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(be),
                             torch.from_numpy(nu), torch.from_numpy(w), n_pairs=70 * 2)
    close(got, ref, 1e-5)
    assert (t2n(got)[int(nu[0]) * tmm.BLOCK_M:] == 0).all()
    assert tmm.grouped_matmul.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("bits,group,tol", [(4, 32, 1e-2), (8, 32, 1e-5), (8, 64, 1e-5)])
def test_grouped_quant_matmul_plain_matches_pallas(bits, group, tol):
    X, K, N = 4, 64, 128
    x, be, nu = _grouped_inputs(40, 2, X, K, seed=bits)
    w = jnp.asarray(np.random.default_rng(4).normal(size=(X, K, N)).astype(np.float32) * 0.05)
    jp = jmoe._make_expert(w, JQuantSpec(bits=bits, group=group))
    tp = to_torch(jp)
    ref = jmm.grouped_quant_matmul(jnp.asarray(x), jnp.asarray(be), jnp.asarray(nu),
                                   jp, bits, interpret=True)
    got = tmm.grouped_quant_matmul(torch.from_numpy(x), torch.from_numpy(be),
                                   torch.from_numpy(nu), tp, bits, n_pairs=40 * 2)
    scale = float(np.abs(np.asarray(ref, dtype=np.float32)).max())
    close(got / scale, np.asarray(ref, dtype=np.float32) / scale, tol)
    # the port's expert quantization gives the JAX bytes
    mine = tmoe._make_expert(torch.from_numpy(np.array(w)), TQuantSpec(bits=bits, group=group))
    for key in ("q", "s"):
        assert torch.equal(mine[key].view(torch.uint8), tp[key].view(torch.uint8)), key


@pytest.mark.parametrize("quant", [None, 8, 4])
def test_routed_expert_mlp_matches_jax(quant):
    T, k, X, E, I = 50, 2, 4, 64, 64
    topi, topv = _routing(9, T, k, X, True)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(T, E)).astype(np.float32)
    wgu = jnp.asarray(rng.normal(size=(X, E, 2 * I)).astype(np.float32) * 0.1)
    wdn = jnp.asarray(rng.normal(size=(X, I, E)).astype(np.float32) * 0.1)
    jspec = tspec = None
    if quant:
        jspec, tspec = JQuantSpec(bits=quant, group=32), TQuantSpec(bits=quant, group=32)
        wgu, wdn = jmoe._make_expert(wgu, jspec), jmoe._make_expert(wdn, jspec)
    ref = jmm.routed_expert_mlp(jnp.asarray(x), jnp.asarray(topi), jnp.asarray(topv),
                                wgu, wdn, X, I, jspec, interpret=True)
    got = tmm.routed_expert_mlp(torch.from_numpy(x), torch.from_numpy(topi),
                                torch.from_numpy(topv), to_torch(wgu), to_torch(wdn),
                                X, I, tspec)
    assert got.dtype == torch.float32
    close(got, ref, 2e-2 if quant == 4 else 1e-5)  # int4: the JAX body's bf16 outputs


# ---------------------------------------------------------------------------
# moe_block by every route
# ---------------------------------------------------------------------------


def _layer(kw, seed=0, spec=None):
    jc, tc = both(**kw)
    jlp = jmoe.init_moe_layer(jc, jax.random.PRNGKey(seed), jnp.float32, spec)
    h = np.random.default_rng(seed).normal(size=(2, 96, kw["hidden_size"])).astype(np.float32)
    return jc, tc, jlp, to_torch(jlp), h


@pytest.mark.parametrize("case", ["scan", "shared", "sigmoid_groups"])
def test_moe_block_scan_matches_jax(case):
    kw = dict(MOE_KW)
    if case == "shared":
        kw.update(num_shared_experts=2)
    if case == "sigmoid_groups":
        kw.update(scoring_func="sigmoid", n_group=4, topk_group=2, num_shared_experts=1)
    jc, tc, jlp, tlp, h = _layer(kw)
    ref = jmoe.moe_block(jlp, jc, None, jnp.asarray(h))
    got = tmoe.moe_block(tlp, tc, None, torch.from_numpy(h))
    close(got, ref, 1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_moe_block_scan_quantized_matches_jax(bits):
    kw = dict(MOE_KW, num_shared_experts=1)
    jspec, tspec = JQuantSpec(bits=bits, group=32), TQuantSpec(bits=bits, group=32)
    jc, tc, jlp, tlp, h = _layer(kw, spec=jspec)
    ref = jmoe.moe_block(jlp, jc, jspec, jnp.asarray(h))
    got = tmoe.moe_block(tlp, tc, tspec, torch.from_numpy(h))
    close(got, ref, 1e-4)


def test_moe_block_grouped_matches_jax_and_the_scan():
    jc, tc, jlp, tlp, h = _layer(MOE_KW)
    x = jnp.asarray(h).reshape(-1, 32)
    jrw = jmoe.route_topk(jc, jnp.matmul(x, jlp["router"]), None)
    ref = jmm.moe_block_grouped(jlp, jc, jnp.asarray(h), jrw, interpret=True)
    ht = torch.from_numpy(h)
    trw = tmoe.route_topk(tc, tmoe.router_logits(tlp, ht.reshape(-1, 32)))
    np.testing.assert_array_equal(t2n(trw) != 0, np.asarray(jrw) != 0)
    got = tmm.moe_block_grouped(tlp, tc, ht, trw)
    close(got, ref, 1e-5)
    # the port's grouped route against the port's scan route
    close(got, t2n(tmoe.moe_block(tlp, tc, None, ht)), 1e-5)
    assert not tmm.use_grouped_moe(tc, None, tlp, 10 ** 6)  # never on the CPU


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_expert_shards_match_the_scan(shards):
    """The expert-shard route adds up to the scan route, for any shard
    count that divides the experts; other counts fall back as in JAX."""
    _, tc, _, tlp, h = _layer(dict(MOE_KW, num_shared_experts=1))
    ht = torch.from_numpy(h)
    ref = tmoe.moe_block(tlp, tc, None, ht)
    ep = dataclasses.replace(tc, expert_parallel=True)
    with tmoe.expert_shards(shards):
        close(tmoe.moe_block(tlp, ep, None, ht), t2n(ref), 1e-5)
    close(tmoe.moe_block(tlp, ep, None, ht), t2n(ref), 1e-5)  # one shard: dense fallback


def test_expert_parallel_fallbacks_follow_jax():
    jc, tc, jlp, tlp, h = _layer(dict(MOE_KW, expert_parallel=True))
    # no ambient mesh / one shard: native experts take the dense all-experts product
    ref = jmoe.moe_block(jlp, jc, None, jnp.asarray(h))
    close(tmoe.moe_block(tlp, tc, None, torch.from_numpy(h)), ref, 1e-5)
    with tmoe.expert_shards(3):  # 8 experts do not split three ways
        close(tmoe.moe_block(tlp, tc, None, torch.from_numpy(h)), ref, 1e-5)
    # quantized experts with one shard: the scan
    x, rw = torch.from_numpy(h[0]), torch.zeros(96, 8)
    qlp = dict(tlp, moe_wgu=tmoe._make_expert(tlp["moe_wgu"], TQuantSpec(bits=8, group=32)))
    assert tmoe._moe_expert_parallel(qlp, tc, TQuantSpec(bits=8, group=32), x, rw) is None
    # activation-quantized experts (W8A8, block fp8) over shards: each shard
    # scans its own experts (JAX: the scan over expert-sharded weights), the
    # shards' fp32 parts added in order: within 1e-5 of the scan over all
    rw = tmoe.route_topk(tc, tmoe.router_logits(tlp, x))
    for mode in ("w8a8_int8", "fp8_block"):
        w8 = TQuantSpec.from_mode(mode)
        wlp = dict(tlp, moe_wgu=tmoe._make_expert(tlp["moe_wgu"], w8),
                   moe_wdown=tmoe._make_expert(tlp["moe_wdown"], w8))
        with tmoe.expert_shards(2):
            got = tmoe._moe_expert_parallel(wlp, tc, w8, x, rw)
        assert got is not None, mode
        close(got, t2n(tmoe._moe_local(wlp, tc, w8, x, rw)), 1e-5)
    with pytest.raises(ValueError):
        with tmoe.expert_shards(0):
            pass


def _prefill_pair(jc, tc, jp, tp, jspec=None, tspec=None, B=2):
    je = jconfig.EngineConfig(page_size=16, max_seq_len=128, max_concurrency=8)
    te = tconfig.EngineConfig(page_size=16, max_seq_len=128, max_concurrency=8)
    P = je.pages_per_req
    pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    toks = np.tile(np.arange(5, 11, dtype=np.int32)[None], (B, 1))

    def run_jax(params, kv):
        _, nxt, logits = j_prefill(params, kv, jc, jnp.asarray(toks),
                                   jnp.zeros((B,), jnp.int32),
                                   jnp.full((B,), 6, jnp.int32), jnp.asarray(pt), jspec)
        return np.asarray(nxt), np.asarray(logits)

    def run_torch():
        kv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
        _, nxt, logits = t_prefill(tp, kv, tc, torch.from_numpy(toks),
                                   torch.zeros(B, dtype=torch.int32),
                                   torch.full((B,), 6, dtype=torch.int32),
                                   torch.from_numpy(pt), tspec)
        return nxt.numpy(), logits.numpy()

    return je, run_jax, run_torch


@pytest.mark.parametrize("quant", [False, True])
def test_expert_shards_match_jax_under_a_mesh(quant):
    """4 expert shards against the JAX package under an ambient (2, 4) mesh:
    fp32 experts, and weight-only int8 group-32 experts."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    kw = dict(model_type="qwen3_moe", vocab_size=128, hidden_size=64,
              intermediate_size=96, moe_intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=4, num_experts=16,
              num_experts_per_tok=2, moe_layer_start=0, expert_parallel=True)
    jc, tc = both(**kw)
    jp = j_init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    jspec = tspec = None
    if quant:  # quantize only the stacked expert leaves, layer by layer
        jspec, tspec = JQuantSpec(bits=8, group=32), TQuantSpec(bits=8, group=32)
        ml = dict(jp["moe_layers"])
        for name in ("moe_wgu", "moe_wdown"):
            ml[name] = jax.vmap(lambda w: jmoe._make_expert(w, jspec))(ml[name])
        jp = {**jp, "moe_layers": ml}
    tp = to_torch(jp)
    je, run_jax, run_torch = _prefill_pair(jc, tc, jp, tp, jspec, tspec)
    mesh = make_mesh((2, 4))
    sp = shard_params(jp, jc, mesh)
    skv = shard_kv(j_init_kv(jc, je, dtype=jnp.float32), jc, mesh)
    with jax.set_mesh(mesh):
        ref_nxt, ref_logits = run_jax(sp, skv)
    before = tmm.grouped_matmul.launches + tmm.grouped_quant_matmul.launches
    with tmoe.expert_shards(4):
        got_nxt, got_logits = run_torch()
    np.testing.assert_allclose(got_logits, ref_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got_nxt, ref_nxt)
    assert tmm.grouped_matmul.launches + tmm.grouped_quant_matmul.launches == before


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

MODELS = {
    "mixtral": dict(model_type="mixtral", vocab_size=128, hidden_size=32,
                    intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
                    rms_norm_eps=1e-5, rope_theta=1e6),
    "qwen3_moe": dict(model_type="qwen3_moe", vocab_size=256, hidden_size=32,
                      intermediate_size=64, moe_intermediate_size=32,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, qk_norm=True, num_experts=4,
                      num_experts_per_tok=2, moe_layer_start=1, num_shared_experts=1),
    "qwen3": dict(model_type="qwen3", vocab_size=128, hidden_size=32,
                  intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, qk_norm=True),
}


def _jax_params(jc, seed=0):
    """JAX init with the norm weights (ones there) drawn at random, so that
    the per-head q/k norms and the layer norms are really compared."""
    jp = j_init_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    for stack in ("layers", "moe_layers"):
        if stack in jp:
            for name in ("input_ln", "post_ln", "q_norm", "k_norm"):
                if name in jp[stack]:
                    shape = jp[stack][name].shape
                    jp[stack][name] = jnp.asarray(
                        1.0 + 0.2 * rng.normal(size=shape).astype(np.float32))
    return jp


@pytest.mark.parametrize("name", MODELS)
def test_model_logits_match_jax(name):
    jc, tc = both(**MODELS[name])
    jp = _jax_params(jc)
    tp = to_torch(jp)
    ids = np.random.default_rng(1).integers(3, jc.vocab_size, size=(1, 21)).astype(np.int32)
    T = ids.shape[1]
    je = jconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=2)
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=2)
    pt = np.arange(1, 1 + je.pages_per_req, dtype=np.int32)[None]
    jh, _ = j_hidden(jp, jc, j_init_kv(jc, je, dtype=jnp.float32), jnp.asarray(ids),
                     jnp.arange(T, dtype=jnp.int32)[None], jnp.asarray(pt),
                     jnp.zeros((1,), jnp.int32), j_causal(T)[None])
    th, _ = t_hidden(tp, tc, t_init_kv(tc, te, dtype=torch.float32, device="cpu"),
                     torch.from_numpy(ids), torch.arange(T)[None], torch.from_numpy(pt),
                     torch.zeros(1, dtype=torch.int32), t_causal(T, "cpu")[None])
    close(th, jh, 1e-5)
    close(t_logits(tp, tc, th), j_logits(jp, jc, jh), 1e-5)


@pytest.mark.parametrize("name,quant", [("mixtral", None), ("qwen3_moe", None),
                                        ("qwen3_moe", 4)])
def test_init_params_tree_matches_jax(name, quant):
    jc, tc = both(**MODELS[name])
    jq = None if quant is None else JQuantSpec(bits=quant, group=32)
    tq = None if quant is None else TQuantSpec(bits=quant, group=32)
    jp = j_init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32, quant=jq)
    tp = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu", quant=tq)
    jl = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
          for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    tl = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert jl == tl


@pytest.mark.parametrize("quant", [None, 4, 8])
def test_moe_tree_crosses_byte_for_byte(quant):
    jc, _ = both(**MODELS["qwen3_moe"])
    spec = None if quant is None else JQuantSpec(bits=quant, group=32)
    jp = j_init_params(jc, jax.random.PRNGKey(1), dtype=jnp.bfloat16, quant=spec)
    tp = to_torch(jp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        a = np.asarray(leaf)
        t = flat_t[path]
        assert tuple(t.shape) == a.shape, path
        assert t.contiguous().view(torch.uint8).numpy().tobytes() == a.tobytes(), path
    experts = tp["moe_layers"]["moe_wgu"]
    if quant is None:
        assert experts.dtype == torch.bfloat16 and experts.shape[:2] == (1, 4)
    else:
        assert experts["q"].dtype == (torch.uint8 if quant == 4 else torch.int8)
        assert experts["s"].dtype == torch.bfloat16 and experts["q"].shape[:2] == (1, 4)


def test_llm_generate_matches_jax_and_lookahead_is_lossless():
    jc, tc = both(**MODELS["qwen3_moe"])
    jp = j_init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    assert "layers" in jp and "moe_layers" in jp
    tp = to_torch(jp)
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=4, eos_token_id=-2)
    prompts = [[5, 6, 7], [9, 10], [20, 21, 22, 23] * 4]
    ref = [o.output_ids for o in JLLM(
        cfg=jc, params=jp, ecfg=jconfig.EngineConfig(**kw), dtype=jnp.float32
    ).generate(prompts, JSamplingParams(max_new_tokens=12))]
    outs = []
    for la in (False, True):
        ecfg = tconfig.EngineConfig(**kw, use_lookahead=la, decoding_length=8,
                                    branch_length=4)
        llm = TLLM(cfg=tc, params=tp, ecfg=ecfg, dtype=torch.float32, device="cpu")
        outs.append([r.output_ids for r in llm.generate(
            prompts, TSamplingParams(max_new_tokens=12))])
    assert outs[0] == ref
    assert outs[1] == outs[0]


def test_llm_serves_expert_shards_losslessly():
    _, tc = both(**dict(MODELS["mixtral"], expert_parallel=True))
    spec = TQuantSpec(bits=4, group=32)
    tp = t_init_params(tc, torch.Generator().manual_seed(3), device="cpu", quant=spec)
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=4, eos_token_id=-2,
              quant="int4", quant_group=32)
    prompts = [[5, 6, 7, 8] * 3, [9, 10]]
    outs = []
    with tmoe.expert_shards(2):
        for la in (False, True):
            ecfg = tconfig.EngineConfig(**kw, use_lookahead=la, decoding_length=8,
                                        branch_length=4)
            llm = TLLM(cfg=tc, params=tp, ecfg=ecfg, dtype=torch.float32, device="cpu")
            outs.append([r.output_ids for r in llm.generate(
                prompts, TSamplingParams(max_new_tokens=10))])
    assert outs[0] == outs[1] and all(len(o) == 10 for o in outs[0])


def test_per_token_fp8_arena_refuses_moe_layers():
    _, tc = both(**MODELS["mixtral"])
    tp = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=1,
                              kv_quant="fp8_tok")
    kv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="fp8_tok"):
        t_hidden(tp, tc, kv, torch.tensor([[3, 4]]), torch.arange(2)[None],
                 torch.arange(1, 1 + te.pages_per_req, dtype=torch.int32)[None],
                 torch.zeros(1, dtype=torch.int32), t_causal(2, "cpu")[None])


def test_unported_model_type_raises():
    with pytest.raises(NotImplementedError):
        t_init_params(tconfig.ModelConfig.tiny(model_type="phi"),
                      torch.Generator().manual_seed(0), device="cpu")


# ---------------------------------------------------------------------------
# the native linears and the tied head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transposed", [False, True])
def test_dense_matmul_plain(transposed):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 40)).astype(np.float32)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    wt = torch.from_numpy(w.T.copy() if transposed else w)
    got = tmm.dense_matmul(torch.from_numpy(x), wt, torch.float32, transposed)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    assert got.shape == (3, 5, 24) and tmm.dense_matmul.launches == 0


def test_tied_head_matches_jax():
    from painlessinferenceacceleration_tpu.layers.embedding import (
        embed_logits as j_embed_logits,
    )

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    h = rng.normal(size=(2, 3, 16)).astype(np.float32)
    close(embed_logits(torch.from_numpy(emb), torch.from_numpy(h)),
          j_embed_logits(jnp.asarray(emb), jnp.asarray(h)), 1e-5)
