"""The port's 8-bit linears and fp8 embedding against the JAX package, on the CPU.

The same numpy-seeded weights and activations go through both packages:
``quantize`` / ``dequantize`` / ``quant_act`` must give the same bytes and
scales in every mode; the plain GEMMs must agree with the JAX oracles in
fp32 (rtol 1e-5: the same products, summed in another order) and with the
Pallas kernels run in interpret mode as ``tests/test_quant.py`` runs them
(relative 0.02-0.03: those round to bf16); a tiny model quantized by JAX
and carried over by ``params_from_jax`` must give the same logits (1e-4)
and greedy tokens; and the port's ``LLM`` must serve token for token what
the JAX ``LLM`` serves, AR and lookahead.

One known difference of the reference: XLA's CPU ``exp2`` is a few ulp off
for some whole arguments, so the JAX token-block scales (``fp8_tb``) are not
exact powers of two; the port's are. The test holds the exponents equal and
the bytes equal wherever the two scales agree.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu.config import EngineConfig as JEngineConfig
from painlessinferenceacceleration_tpu.config import ModelConfig as JModelConfig
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.multistep import multistep_decode as j_decode
from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.layers import embedding as jemb
from painlessinferenceacceleration_tpu.layers import linear as jlin
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params
from painlessinferenceacceleration_tpu.models.base import (
    init_params_quantized as j_init_q,
)
from painlessinferenceacceleration_tpu.ops import quant_matmul as jqm
from painlessinferenceacceleration_tpu.ops import w8a8 as jw8

from painlessinferenceacceleration_tpu_torch.config import QUANT_MODES
from painlessinferenceacceleration_tpu_torch.config import EngineConfig as TEngineConfig
from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.multistep import (
    multistep_decode as t_decode,
)
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.layers import embedding as temb
from painlessinferenceacceleration_tpu_torch.layers import linear as tlin
from painlessinferenceacceleration_tpu_torch.models.base import init_params as t_init_params
from painlessinferenceacceleration_tpu_torch.models.base import (
    init_params_quantized as t_init_q,
)
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.ops import quant_matmul as tqm
from painlessinferenceacceleration_tpu_torch.ops import w8a8 as tw8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs. Its engine runs are
    thousands of tiny ops; beside a parallel run's other workers, a pool of
    threads per op spends most of their time waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

W8A8_MODES = ["w8a8_int8", "w8a8_int8_static", "w8a8_fp8", "w8a8_fp8_static",
              "fp8_block", "fp8_tb"]
MODES_8BIT = ["int8"] + W8A8_MODES


def _bytes(a) -> np.ndarray:
    """The raw bytes of a numpy / jax / torch array of any 1- or 2-byte type."""
    if isinstance(a, torch.Tensor):
        return a.reshape(-1).contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _same_leaf(tp: dict, jp: dict) -> None:
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
        assert (_bytes(tp[k]) == _bytes(jp[k])).all(), k


def _weights(seed, K, N, scale=0.05):
    return (np.random.default_rng(seed).normal(size=(K, N)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# QuantSpec, quantize, dequantize
# ---------------------------------------------------------------------------


def test_from_mode_takes_exactly_the_jax_modes():
    for mode in QUANT_MODES:
        js, ts = jlin.QuantSpec.from_mode(mode, 64), tlin.QuantSpec.from_mode(mode, 64)
        assert (js is None) == (ts is None)
        if js is not None:
            assert dataclasses.asdict(ts) == dataclasses.asdict(js), mode
    assert dataclasses.asdict(tlin.QuantSpec()) == dataclasses.asdict(jlin.QuantSpec())
    for mode in ("fp8", "int2", "w8a8"):
        with pytest.raises(ValueError):
            jlin.QuantSpec.from_mode(mode)
        with pytest.raises(ValueError):
            tlin.QuantSpec.from_mode(mode)
        with pytest.raises(ValueError):
            TEngineConfig(quant=mode)
    assert tlin.FP8_MAX == jlin.FP8_MAX
    assert TEngineConfig(quant_embed=True, quant="fp8_tb").quant_embed


@pytest.mark.parametrize("K,N", [(256, 384), (200, 132)], ids=["even", "ragged"])
@pytest.mark.parametrize("mode", MODES_8BIT)
def test_quantize_and_dequantize_match_jax(mode, K, N):
    w = _weights(1, K, N)
    js, ts = jlin.QuantSpec.from_mode(mode, 64), tlin.QuantSpec.from_mode(mode, 64)
    act_scale = 0.037 if "static" in mode else None
    jp = jlin.quantize(jnp.asarray(w), js, act_scale=act_scale)
    tp = tlin.quantize(torch.from_numpy(w), ts, act_scale=act_scale)
    _same_leaf(tp, jp)
    if mode in ("fp8_block", "fp8_tb"):
        assert tuple(tp["s"].shape) == (-(-K // 128), -(-N // 128))
    jd = np.asarray(jlin.dequantize(jp, js, jnp.float32))
    td = tlin.dequantize(tp, ts, torch.float32).numpy()
    assert (td == jd).all()
    # the carried-over JAX leaf dequantizes to the same weight
    carried = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    _same_leaf(carried, jp)
    assert (tlin.dequantize(carried, ts, torch.float32).numpy() == jd).all()
    assert np.abs(td - w).max() < (0.02 if "fp8" in mode else 0.005)
    assert tlin.make_linear(torch.from_numpy(w), None).dtype == torch.float32
    _same_leaf(tlin.make_linear(torch.from_numpy(w), ts), jlin.make_linear(jnp.asarray(w), js))


def test_stacked_leaf_is_sliced_by_every_key():
    ts = tlin.QuantSpec.from_mode("w8a8_int8_static")
    leaves = [tlin.quantize(torch.from_numpy(_weights(i, 64, 32)), ts, act_scale=0.01 * (i + 1))
              for i in range(3)]
    stacked = {k: torch.stack([p[k] for p in leaves]) for k in leaves[0]}
    assert tuple(stacked["xs"].shape) == (3,)
    x = torch.from_numpy(_weights(9, 5, 64, 1.0))
    for li in range(3):
        got = tlin.linear_at(stacked, li, x, ts)
        assert torch.equal(got, tlin.linear(leaves[li], x, ts))


# ---------------------------------------------------------------------------
# quant_act, calibrate_act_scale
# ---------------------------------------------------------------------------


def _activations(seed, M, K):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[0] *= 30.0  # one loud token
    x[1, :7] = 0.0
    return x


@pytest.mark.parametrize("K", [256, 200], ids=["even", "ragged"])
@pytest.mark.parametrize("mode", W8A8_MODES)
def test_quant_act_matches_jax(mode, K):
    x = _activations(2, 9, K)
    js, ts = jlin.QuantSpec.from_mode(mode), tlin.QuantSpec.from_mode(mode)
    static = 0.043 if "static" in mode else None
    jq, jxs = jw8.quant_act(jnp.asarray(x), js, static)
    tq, txs = tw8.quant_act(torch.from_numpy(x), ts,
                            None if static is None else torch.tensor(static))
    assert tuple(tq.shape) == tuple(jq.shape) == (9, K)
    assert tuple(txs.shape) == tuple(jxs.shape)
    jxs = np.asarray(jxs)
    if mode != "fp8_tb":
        assert (txs.numpy() == jxs).all()
        assert (_bytes(tq) == _bytes(jq)).all()
        return
    # token-block: the port's scales are exact powers of two with the JAX
    # exponents (XLA's exp2 is a few ulp off for some of them)
    exps = np.log2(txs.numpy().astype(np.float64))
    assert (exps == np.round(exps)).all()
    assert (exps == np.round(np.log2(jxs.astype(np.float64)))).all()
    np.testing.assert_allclose(txs.numpy(), jxs, rtol=2e-6)
    same = np.repeat(txs.numpy() == jxs, 128, axis=1)[:, :K]
    assert same.mean() > 0.5
    tb, jb = _bytes(tq).reshape(9, K), _bytes(jq).reshape(9, K)
    assert (tb[same] == jb[same]).all()
    assert (tb != jb).mean() < 1e-3
    # a snapped-down scale puts values past 448: they saturate, no NaN
    tf = tq.to(torch.float32)
    assert torch.isfinite(tf).all() and tf.abs().max() == 448.0


def test_pow2_snap_saturates_like_jax():
    """Rows whose amax/448 sits just below a half-way exponent snap DOWN, so
    the largest values land past 448 and must clip to it in both packages."""
    x = np.zeros((4, 128), np.float32)
    x[:, 0] = [448.0 * 1.40, 448.0 * 1.42, 448.0 * 2.80, 448.0 * 0.705]
    x[:, 1] = 1.0
    js, ts = jlin.QuantSpec.from_mode("fp8_tb"), tlin.QuantSpec.from_mode("fp8_tb")
    jq, jxs = jw8.quant_act(jnp.asarray(x), js)
    tq, txs = tw8.quant_act(torch.from_numpy(x), ts)
    assert (txs.numpy()[:, 0] == np.array([1.0, 2.0, 2.0, 0.5], np.float32)).all()
    np.testing.assert_allclose(np.asarray(jxs), txs.numpy(), rtol=2e-6)
    assert (_bytes(tq) == _bytes(jq)).all()
    assert tq.to(torch.float32)[0, 0] == 448.0


@pytest.mark.parametrize("mode", ["w8a8_int8_static", "w8a8_fp8_static"])
def test_calibrate_act_scale_matches_jax(mode):
    x = _activations(3, 6, 64).reshape(2, 3, 64)
    js, ts = jlin.QuantSpec.from_mode(mode), tlin.QuantSpec.from_mode(mode)
    j = np.asarray(jw8.calibrate_act_scale(jnp.asarray(x), js))
    t = tw8.calibrate_act_scale(torch.from_numpy(x), ts)
    assert t.shape == () and t.numpy() == j
    assert tw8.calibrate_act_scale(torch.zeros(3, 4), ts) == np.float32(1e-8)


# ---------------------------------------------------------------------------
# the plain GEMMs against the JAX oracles and the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))


def _pallas(x_bf, jp, js):
    """The JAX package's Pallas kernel for this leaf in interpret mode."""
    if js.block:
        xq, xs = jw8.quant_act(x_bf, js)
        s_exp = jw8._expand_block_scales(jp["s"], js.block)
        return jw8._block_fp8_pallas(xq, xs, jp["q"], s_exp, js.block, interpret=True)
    if js.act is not None:
        xq, xs = jw8.quant_act(x_bf, js, jp.get("xs"))
        return jw8._w8a8_pallas(xq, jp["s"], jp["q"], interpret=True) * xs[:, None]
    return jqm.quant_matmul_pallas(x_bf, jp["q"], jp["s"], 8, interpret=True)


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("mode", MODES_8BIT)
def test_plain_gemm_matches_jax_oracle_and_pallas_interpret(mode, M):
    K, N = 256, 384
    w = _weights(4, K, N)
    x = np.random.default_rng(5).normal(size=(M, K)).astype(np.float32)
    js, ts = jlin.QuantSpec.from_mode(mode, 64), tlin.QuantSpec.from_mode(mode, 64)
    act_scale = float(np.abs(x).max()) / 127.0 if "static" in mode else None
    jp = jlin.quantize(jnp.asarray(w), js, act_scale=act_scale)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    # fp32 in, fp32 out: the jnp oracle (the JAX package's own CPU path)
    jref = jqm.quant_matmul(jnp.asarray(x), jp, js, use_pallas=False)
    got = tqm.quant_matmul(torch.from_numpy(x), tp, ts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5, atol=1e-5)
    assert _rel(got.numpy(), x @ w) < 0.08
    # bf16 activations: the Pallas kernel in interpret mode, and fp32 logits
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)
    tx_bf = torch.from_numpy(x).to(torch.bfloat16)
    got_bf = tqm.quant_matmul(tx_bf, tp, ts)
    assert got_bf.dtype == torch.bfloat16
    assert _rel(got_bf.float().numpy(), _pallas(x_bf, jp, js)) < 0.03
    got_f32 = tlin.linear(tp, tx_bf, ts, out_dtype=torch.float32)
    jf32 = jlin.linear(jp, x_bf, js, out_dtype=jnp.float32)
    assert got_f32.dtype == torch.float32
    if mode == "int8":
        # with bf16 activations the jnp path rounds the dequantized weight to
        # bf16 before the product; the port's plain version and kernel keep
        # q * s in fp32
        assert _rel(got_f32.numpy(), jf32) < 0.01
    else:
        np.testing.assert_allclose(got_f32.numpy(), np.asarray(jf32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "w8a8_int8", "w8a8_fp8", "fp8_block"])
def test_stacked_gemm_matches_pallas_stacked_interpret(mode):
    L, M, K, N = 3, 8, 256, 384
    js, ts = jlin.QuantSpec.from_mode(mode, 64), tlin.QuantSpec.from_mode(mode, 64)
    leaves = [jlin.quantize(jnp.asarray(_weights(10 + i, K, N)), js) for i in range(L)]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *leaves)
    tst = params_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    x = np.random.default_rng(6).normal(size=(M, K)).astype(np.float32)
    x_bf, tx_bf = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for li in range(L):
        got = tlin.linear_at(tst, li, tx_bf, ts).float().numpy()
        if js.block:
            xq, xs = jw8.quant_act(x_bf, js)
            s_exp = jw8._expand_block_scales(jst["s"], js.block)
            ref = jw8._block_fp8_pallas_stacked(xq, xs, jst["q"], s_exp, jnp.int32(li),
                                                js.block, interpret=True)
        elif js.act is not None:
            xq, xs = jw8.quant_act(x_bf, js)
            ref = jw8._w8a8_pallas_stacked(xq, jst["s"], jst["q"], jnp.int32(li),
                                           interpret=True) * xs[:, None]
        else:
            ref = jqm.quant_matmul_pallas_stacked(x_bf, jst["q"], jst["s"], 8,
                                                  jnp.int32(li), interpret=True)
        assert _rel(got, ref) < 0.03, li
        # and the JAX package's own stacked CPU path, in fp32
        jref = jlin.linear_at(jst, li, jnp.asarray(x), js)
        tgot = tlin.linear_at(tst, li, torch.from_numpy(x), ts)
        np.testing.assert_allclose(tgot.numpy(), np.asarray(jref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,N", [(200, 132), (333, 260)])
def test_block_gemm_ragged_edges_match_jax(K, N):
    w, x = _weights(7, K, N), _activations(8, 5, K)
    for mode in ("fp8_block", "fp8_tb"):
        js, ts = jlin.QuantSpec.from_mode(mode), tlin.QuantSpec.from_mode(mode)
        jp = jlin.quantize(jnp.asarray(w), js)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        jref = jw8.w8a8_matmul_ref(jnp.asarray(x), jp, js)
        got = tw8.w8a8_matmul_ref(torch.from_numpy(x), tp, ts)
        # fp8_tb: the reference's scales are a few ulp off exact powers of two
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5,
                                   atol=1e-5 if mode == "fp8_block" else 2e-2)


def test_int8_w8a8_plain_gemm_is_the_exact_integer_product():
    rng = np.random.default_rng(9)
    xq = rng.integers(-127, 128, size=(6, 700)).astype(np.int8)
    q = rng.integers(-127, 128, size=(700, 36)).astype(np.int8)
    ones_m, ones_n = torch.ones(6), torch.ones(36)
    got = tw8.w8a8_gemm_plain(torch.from_numpy(xq), ones_m, torch.from_numpy(q), ones_n,
                              torch.float32)
    assert (got.numpy() == (xq.astype(np.int64) @ q.astype(np.int64)).astype(np.float32)).all()


# ---------------------------------------------------------------------------
# wrappers: the CPU takes the plain version and counts nothing; no other
# device is served
# ---------------------------------------------------------------------------


def test_8bit_wrappers_on_cpu_use_plain_versions_and_count_nothing():
    counters = (tqm.int8_matmul, tw8.w8a8_gemm, tw8.block_fp8_gemm)
    before = [f.launches for f in counters]
    x = torch.from_numpy(_activations(1, 5, 256))
    for mode in MODES_8BIT:
        ts = tlin.QuantSpec.from_mode(mode)
        tp = tlin.quantize(torch.from_numpy(_weights(2, 256, 64)), ts)
        got = tqm.quant_matmul(x, tp, ts)
        if ts.act is None:
            ref = tqm.int8_matmul_plain(x, tp["q"], tp["s"])
        else:
            ref = tw8.w8a8_matmul_ref(x, tp, ts)
        assert torch.equal(got, ref)
    assert [f.launches for f in counters] == before
    assert not tw8.w8a8_gemm.modes


@pytest.mark.parametrize("mode", MODES_8BIT)
def test_8bit_wrappers_raise_on_a_device_without_a_kernel(mode):
    ts = tlin.QuantSpec.from_mode(mode)
    tp = tlin.quantize(torch.from_numpy(_weights(2, 256, 64)), ts)
    meta = {k: v.to("meta") for k, v in tp.items()}
    with pytest.raises(NotImplementedError):
        tqm.quant_matmul(torch.empty(3, 256, device="meta"), meta, ts)


# ---------------------------------------------------------------------------
# the fp8 embedding
# ---------------------------------------------------------------------------


def test_fp8_embedding_matches_jax():
    table = _weights(11, 96, 64, 0.02)
    table[5] = 0.0  # an all-zero row takes the 1e-8 scale floor
    js, ts = jlin.QuantSpec.from_mode("w8a8_fp8"), tlin.QuantSpec.from_mode("w8a8_fp8")
    je = jemb.make_embedding(jnp.asarray(table), js)
    te = temb.make_embedding(torch.from_numpy(table), ts)
    _same_leaf(te, je)
    for spec in (None, tlin.QuantSpec.from_mode("w8a8_int8"), tlin.QuantSpec(bits=4)):
        assert temb.make_embedding(torch.from_numpy(table), spec).dtype == torch.float32
    assert temb.make_embedding(te, ts) is te
    toks = np.random.default_rng(12).integers(0, 96, size=(2, 7)).astype(np.int32)
    jl = jemb.embed_lookup(je, jnp.asarray(toks), jnp.float32)
    tl = temb.embed_lookup(te, torch.from_numpy(toks), torch.float32)
    assert tuple(tl.shape) == (2, 7, 64) and (tl.numpy() == np.asarray(jl)).all()
    assert np.abs(tl.numpy() - table[toks]).max() < 0.005
    h = np.random.default_rng(13).normal(size=(2, 3, 64)).astype(np.float32)
    jg = jemb.embed_logits(je, jnp.asarray(h))
    tg = temb.embed_logits(te, torch.from_numpy(h))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# a tiny model in every mode: carried over from JAX, and drawn by the port
# ---------------------------------------------------------------------------

ECFG = dict(page_size=16, max_seq_len=128, max_concurrency=2)


def _tiny_prompt():
    rng = np.random.default_rng(21)
    toks = rng.integers(10, 40, size=(2, 20)).astype(np.int32)
    lens = np.array([20, 13], np.int32)
    pt = np.arange(1, 1 + 2 * 8, dtype=np.int32).reshape(2, 8)
    return toks, lens, pt


@pytest.mark.parametrize("mode", MODES_8BIT)
def test_model_quantized_by_jax_gives_the_same_logits_and_tokens(mode):
    jc, tc = JModelConfig.tiny(), TModelConfig.tiny()
    js, ts = jlin.QuantSpec.from_mode(mode, 64), tlin.QuantSpec.from_mode(mode, 64)
    jp = j_init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32, quant=js)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks, lens, pt = _tiny_prompt()
    jkv = j_init_kv(jc, JEngineConfig(**ECFG), dtype=jnp.float32)
    tkv = t_init_kv(tc, TEngineConfig(**ECFG), dtype=torch.float32, device="cpu")
    jkv, jn, jl = j_prefill(jp, jkv, jc, jnp.asarray(toks), jnp.zeros(2, jnp.int32),
                            jnp.asarray(lens), jnp.asarray(pt), js)
    tkv, tn, tl = t_prefill(tp, tkv, tc, torch.from_numpy(toks),
                            torch.zeros(2, dtype=torch.int32), torch.from_numpy(lens),
                            torch.from_numpy(pt), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert (tn.numpy() == np.asarray(jn)).all()
    active = np.array([True, True])
    jr = j_decode(jp, jkv, jc, jn, jnp.asarray(lens), jnp.asarray(active),
                  jnp.asarray(pt), n_steps=16, spec=js)
    tr = t_decode(tp, tkv, tc, tn, torch.from_numpy(lens), torch.from_numpy(active),
                  torch.from_numpy(pt), n_steps=16, spec=ts)
    assert (tr[1].numpy() == np.asarray(jr[1])).all()


@pytest.mark.parametrize("mode", ["int4"] + MODES_8BIT)
def test_quantized_init_has_the_jax_layout_and_runs(mode):
    # every width a multiple of 128: the JAX sampler sizes block scales by
    # floor(K/128), floor(N/128)
    wide = dict(hidden_size=128, intermediate_size=256)
    jc, tc = JModelConfig.tiny(**wide), TModelConfig.tiny(**wide)
    js, ts = jlin.QuantSpec.from_mode(mode, 64), tlin.QuantSpec.from_mode(mode, 64)
    jp = j_init_q(jc, jax.random.PRNGKey(0), js)
    tp = t_init_q(tc, ts, torch.Generator().manual_seed(0), device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in sorted(tree.items())}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]
    assert layout(tp) == layout(jp)
    q = tp["layers"]["wqkv"]["q"]
    if q.dtype == torch.int8:
        assert q.min() == -127 and q.max() == 127
    elif q.dtype == torch.float8_e4m3fn:
        assert torch.isfinite(q.to(torch.float32)).all()
    if "static" in mode:
        assert (tp["layers"]["wo"]["xs"] == 1.0).all() and tp["lm_head"]["xs"].shape == ()
    toks, lens, pt = _tiny_prompt()
    kv = t_init_kv(tc, TEngineConfig(**ECFG), dtype=torch.bfloat16, device="cpu")
    _, nxt, logits = t_prefill(tp, kv, tc, torch.from_numpy(toks),
                               torch.zeros(2, dtype=torch.int32), torch.from_numpy(lens),
                               torch.from_numpy(pt), ts)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    # drawn by the port's own init_params: quantized layer by layer, stacked
    tq = t_init_params(tc, torch.Generator().manual_seed(1), device="cpu", quant=ts)
    jq = j_init_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32, quant=js)
    assert layout(tq) == layout(jq)


# ---------------------------------------------------------------------------
# the slice as a whole: LLM.generate against the JAX LLM, and lookahead == AR
# ---------------------------------------------------------------------------

SERVE = dict(page_size=16, max_seq_len=256, max_concurrency=4, prefill_chunk=32,
             eos_token_id=-2, decode_buckets=(1, 2, 4, 8), decode_burst=4,
             decode_burst_idle=8)
LOOKAHEAD = dict(use_lookahead=True, decoding_length=8, branch_length=4,
                 use_spec_min_batch_size=4)


def _serve_prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(10, 30, 36).tolist()
    return [shared + rng.integers(10, 30, 9).tolist(), rng.integers(10, 30, 14).tolist(),
            shared + rng.integers(10, 30, 4).tolist()]


@pytest.fixture(scope="module")
def dense_tiny():
    jc, tc = JModelConfig.tiny(), TModelConfig.tiny()
    jp = j_init_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32)
    return jc, jp, tc


@pytest.mark.parametrize("lookahead", [False, True], ids=["ar", "lookahead"])
@pytest.mark.parametrize("mode,quant_embed", [
    ("int8", False), ("w8a8_int8", False), ("w8a8_fp8_static", False),
    ("fp8_block", False), ("w8a8_fp8", True)],
    ids=["int8", "w8a8_int8", "w8a8_fp8_static", "fp8_block", "quant_embed"])
def test_llm_generate_matches_jax_in_quantized_modes(dense_tiny, mode, quant_embed, lookahead):
    jc, dense, tc = dense_tiny
    js = jlin.QuantSpec.from_mode(mode, 64)
    # one dense model, quantized by the JAX package leaf by leaf
    jp = dict(dense, layers=dict(dense["layers"]))
    for name in ("wqkv", "wo", "wgu", "wdown"):
        leaves = [jlin.quantize(w, js) for w in dense["layers"][name]]
        jp["layers"][name] = jax.tree.map(lambda *xs: jnp.stack(xs), *leaves)
    jp["lm_head"] = jlin.quantize(dense["lm_head"], js)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(SERVE, quant=mode, quant_group=64, quant_embed=quant_embed,
              **(LOOKAHEAD if lookahead else {}))
    j = JLLM(cfg=jc, params=jp, ecfg=JEngineConfig(**kw), dtype=jnp.float32)
    t = TLLM(cfg=tc, params=tp, ecfg=TEngineConfig(**kw), dtype=torch.float32, device="cpu")
    if quant_embed:
        _same_leaf(t.params["embed"], j.params["embed"])
        assert isinstance(tp["embed"], torch.Tensor)  # the caller's dict is not touched
    prompts = _serve_prompts()
    jo = j.generate(prompts, JSP(max_new_tokens=24))
    to = t.generate(prompts, TSP(max_new_tokens=24))
    assert [r.output_ids for r in to] == [r.output_ids for r in jo]
    assert t.metrics.prefix_hit_tokens == j.metrics.prefix_hit_tokens
    if lookahead:
        assert t.metrics.spec_steps == j.metrics.spec_steps > 0
        assert t.metrics.spec_accepted == j.metrics.spec_accepted


@pytest.mark.parametrize("quant_embed", [False, True], ids=["", "quant_embed"])
@pytest.mark.parametrize("mode", MODES_8BIT)
def test_port_lookahead_equals_port_ar_in_every_mode(mode, quant_embed):
    tc = TModelConfig.tiny()
    ts = tlin.QuantSpec.from_mode(mode, 64)
    tp = t_init_params(tc, torch.Generator().manual_seed(3), device="cpu", quant=ts)
    outs = []
    for la in (False, True):
        kw = dict(SERVE, quant=mode, quant_group=64, quant_embed=quant_embed,
                  **(LOOKAHEAD if la else {}))
        llm = TLLM(cfg=tc, params=tp, ecfg=TEngineConfig(**kw), dtype=torch.float32,
                   device="cpu")
        outs.append([r.output_ids for r in llm.generate(_serve_prompts(),
                                                        TSP(max_new_tokens=24))])
        if la:
            assert llm.metrics.spec_steps > 0
    assert outs[0] == outs[1]
    assert all(len(o) == 24 for o in outs[0])
