"""The port's kernel modules (plain versions) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
Pallas functions run in interpret mode, as the JAX package's own tests run
them. Tolerances: int4 packing, e4m3 arena writes and KV compaction must
match exactly; fp32 plain paths within 1e-5 (same arithmetic, other
summation order); bf16 against the Pallas kernels within 2e-2 relative
(bf16 rounding of the kernel's operands and output), and the e4m3-arena
Pallas kernels within 3e-2 (they compute in bf16 throughout, with q folded
by the K scale and rounded to bf16 first).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _kv_cases import CASES, compact_case

from painlessinferenceacceleration_tpu.engine import cache as jcache
from painlessinferenceacceleration_tpu.layers import linear as jlin
from painlessinferenceacceleration_tpu.lookahead.device_tables import (
    build_tree_inputs as j_build_tree_inputs,
)
from painlessinferenceacceleration_tpu.ops import attention as jatt
from painlessinferenceacceleration_tpu.ops import quant_matmul as jqmm
from painlessinferenceacceleration_tpu.ops import rmsnorm as jrms
from painlessinferenceacceleration_tpu.ops import rope as jrope
from painlessinferenceacceleration_tpu.ops.kv_update import kv_permute_pages_pallas
from painlessinferenceacceleration_tpu.ops.paged_attention import (
    paged_attention as j_paged_attention,
    paged_attention_prefill as j_paged_attention_prefill,
    paged_attention_tok as j_paged_attention_tok,
)
from painlessinferenceacceleration_tpu import config as jconfig

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch import config as tconfig
from painlessinferenceacceleration_tpu_torch.engine import cache as tcache
from painlessinferenceacceleration_tpu_torch.layers import linear as tlin
from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as trms
from painlessinferenceacceleration_tpu_torch.ops import rope as trope
from painlessinferenceacceleration_tpu_torch.models.convert import kv_from_jax
from painlessinferenceacceleration_tpu_torch.ops import attention as tatt
from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
    kv_compact_tail,
    kv_permute_pages,
    kv_write_pages,
    kv_write_pages_plain,
    tail_window,
)
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
    paged_attention_tok,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    int4_matmul,
    int4_matmul_plain,
    int4_split,
)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


# ---------------------------------------------------------------------------
# int4 weights and the int4 GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N,group", [(256, 384, 64), (512, 96, 128), (384, 64, 128)])
def test_int4_quantize_bytes_match_jax(K, N, group):
    w = np.random.default_rng(K + N).normal(size=(K, N)).astype(np.float32) * 0.05
    jp = jlin.quantize(jnp.asarray(w), jlin.QuantSpec(bits=4, group=group))
    tp = tlin.quantize(t(w), tlin.QuantSpec(bits=4, group=group))
    assert (tp["q"].numpy() == np.asarray(jp["q"])).all()
    assert (tp["s"].view(torch.int16).numpy()
            == np.asarray(jp["s"]).view(np.int16)).all()
    assert (tlin.unpack_int4(tp["q"], group).numpy()
            == np.asarray(jlin.unpack_int4(jp["q"], group))).all()
    assert (tlin.dequantize(tp, dtype=torch.float32).numpy()
            == np.asarray(jlin.dequantize(jp, jlin.QuantSpec(bits=4, group=group),
                                          jnp.float32))).all()


def _int4_case(M, K, N, group, seed, L=None):
    rng = np.random.default_rng(seed)
    spec = jlin.QuantSpec(bits=4, group=group)
    ws = [rng.normal(size=(K, N)).astype(np.float32) * 0.05 for _ in range(L or 1)]
    ps = [jlin.quantize(jnp.asarray(w), spec) for w in ws]
    x = rng.normal(size=(M, K)).astype(np.float32)
    return spec, ps, x


@pytest.mark.parametrize("M", [1, 17])
def test_int4_plain_matches_jax_fp32(M):
    spec, (jp,), x = _int4_case(M, 256, 384, 64, 1)
    ref = jqmm.quant_matmul(jnp.asarray(x), jp, spec, use_pallas=False)
    got = int4_matmul(t(x), t(jp["q"]), _scales(jp["s"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _scales(s):
    return torch.from_numpy(np.asarray(s).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("M", [1, 17])
@pytest.mark.parametrize("out_f32", [False, True])
def test_int4_plain_matches_pallas_interpret(M, out_f32):
    spec, (jp,), x = _int4_case(M, 256, 384, 128, 2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    od = jnp.float32 if out_f32 else jnp.bfloat16
    ref = jqmm.quant_matmul_pallas(xb, jp["q"], jp["s"], 4, interpret=True, out_dtype=od)
    got = int4_matmul(_bf16(np.asarray(xb.astype(jnp.float32))), t(jp["q"]), _scales(jp["s"]),
                      torch.float32 if out_f32 else torch.bfloat16)
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    assert rel_err(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) < 2e-2


def test_int4_plain_matches_stacked_pallas_interpret():
    spec, ps, x = _int4_case(8, 256, 384, 128, 3, L=3)
    q = np.stack([np.asarray(p["q"]) for p in ps])
    s = jnp.stack([p["s"] for p in ps])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tq, ts = t(q), _scales(s)
    for li in range(3):
        ref = jqmm.quant_matmul_pallas_stacked(xb, jnp.asarray(q), s, 4, jnp.int32(li),
                                               interpret=True)
        got = tlin.linear_at({"q": tq, "s": ts}, li, _bf16(np.asarray(xb.astype(jnp.float32))),
                             tlin.QuantSpec(bits=4, group=128))
        assert rel_err(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) < 2e-2


def test_int4_wrapper_on_cpu_uses_plain_version_and_counts_nothing():
    _, (jp,), x = _int4_case(3, 256, 64, 128, 4)
    before = int4_matmul.launches
    got = int4_matmul(t(x), t(jp["q"]), _scales(jp["s"]))
    ref = int4_matmul_plain(t(x), t(jp["q"]), _scales(jp["s"]))
    assert torch.equal(got, ref) and int4_matmul.launches == before


@pytest.mark.parametrize("K,N,want", [(4096, 4096, 4), (11008, 4096, 4), (4096, 32000, 1),
                                      (4096, 22016, 2), (256, 384, 1)])
def test_int4_ksplit_depends_on_shape_only(K, N, want):
    assert int4_split(K, N, 128)[0] == want


# ---------------------------------------------------------------------------
# norm and rope
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(trms.rms_norm(t(x), t(w)).numpy(),
                               np.asarray(jrms.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-6, rtol=0)
    jc, tc = jconfig.ModelConfig.tiny(), tconfig.ModelConfig.tiny()
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    jcos, jsin = jrope.rope_cos_sin(jrope.rope_inv_freq(jc), jnp.asarray(pos))
    tcos, tsin = trope.rope_cos_sin(trope.rope_inv_freq(tc), t(pos))
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        trope.apply_rope(t(x), tcos, tsin).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-5, rtol=0)
    # the scaled rope types are ported too (tests/test_torch_mla.py holds
    # each against the JAX package); an unknown type raises in both
    scaled = dict(rope_scaling={"rope_type": "yarn", "factor": 2.0})
    np.testing.assert_allclose(
        trope.rope_inv_freq(tconfig.ModelConfig.tiny(**scaled)).numpy(),
        np.asarray(jrope.rope_inv_freq(jconfig.ModelConfig.tiny(**scaled))),
        atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        trope.rope_inv_freq(tconfig.ModelConfig.tiny(rope_scaling={"rope_type": "dynamic"}))


# ---------------------------------------------------------------------------
# paged attention (decode, verify, prefill) on a stacked arena
# ---------------------------------------------------------------------------

PS, P_PER_REQ, LAYERS = 16, 6, 2


def _arena(B, ctx_lens, Q, Hkv, D, seed):
    """A stacked [L, n_pages, ps, Hkv*D] arena with ctx + Q written rows per
    request (permuted page tables), as numpy."""
    rng = np.random.default_rng(seed)
    n_pages = B * P_PER_REQ + 1
    k = np.zeros((LAYERS, n_pages, PS, Hkv * D), np.float32)
    v = np.zeros_like(k)
    pt = (rng.permutation(n_pages - 1)[: B * P_PER_REQ] + 1).reshape(B, P_PER_REQ)
    for b, c in enumerate(ctx_lens):
        for j in range(c + Q):
            k[:, pt[b, j // PS], j % PS] = rng.normal(size=(LAYERS, Hkv * D))
            v[:, pt[b, j // PS], j % PS] = rng.normal(size=(LAYERS, Hkv * D))
    return k, v, pt.astype(np.int32)


def _tree_qmask(B, R, Lb):
    rng = np.random.default_rng(11)
    branches = jnp.asarray(rng.integers(0, 50, size=(R, Lb)).astype(np.int32))
    _, _, qm, _ = j_build_tree_inputs(jnp.int32(3), branches)
    return np.broadcast_to(np.asarray(qm), (B,) + qm.shape).copy()


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_attention_plain_matches_jax(G, kind):
    B, Hkv, D = 2, 2, 16
    ctx = [21, 37]  # not page-aligned
    qmask = np.ones((B, 1, 1), bool) if kind == "decode" else _tree_qmask(B, 2, 4)
    Q = qmask.shape[1]
    k, v, pt = _arena(B, ctx, Q, Hkv, D, seed=G)
    q = np.random.default_rng(9).normal(size=(B, Q, G * Hkv, D)).astype(np.float32)
    ctx_np, scale, li = np.array(ctx, np.int32), D ** -0.5, 1
    got = paged_attention(t(q), t(k)[li], t(v)[li], t(pt), t(ctx_np), t(qmask), scale).numpy()
    ref = jatt.paged_attention_ref(jnp.asarray(q), jnp.asarray(k[li]), jnp.asarray(v[li]),
                                   jnp.asarray(pt), jnp.asarray(ctx_np), jnp.asarray(qmask),
                                   scale)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    pallas = j_paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
                               jnp.asarray(ctx_np), jnp.asarray(qmask), scale,
                               interpret=True, layer=jnp.int32(li))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4, rtol=0)


@pytest.mark.parametrize("ctx", [[0, 0], [19, 5]])
@pytest.mark.parametrize("G", [1, 2])
def test_paged_attention_prefill_plain_matches_jax(ctx, G):
    B, Hkv, D, Q = 2, 2, 16, 40
    k, v, pt = _arena(B, ctx, Q, Hkv, D, seed=3 + G)
    q = np.random.default_rng(4).normal(size=(B, Q, G * Hkv, D)).astype(np.float32)
    ctx_np, scale, li = np.array(ctx, np.int32), D ** -0.5, 0
    got = paged_attention_prefill(t(q), t(k)[li], t(v)[li], t(pt), t(ctx_np), scale).numpy()
    causal = np.broadcast_to(np.tril(np.ones((Q, Q), bool)), (B, Q, Q))
    ref = jatt.paged_attention_ref(jnp.asarray(q), jnp.asarray(k[li]), jnp.asarray(v[li]),
                                   jnp.asarray(pt), jnp.asarray(ctx_np), jnp.asarray(causal),
                                   scale)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    pallas = j_paged_attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pt), jnp.asarray(ctx_np), scale,
                                       interpret=True, layer=jnp.int32(li), qt=16)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the KV arena: writes, gathers and tail compaction
# ---------------------------------------------------------------------------


def test_write_and_gather_kv_pages_match_jax():
    rng = np.random.default_rng(6)
    B, Q, H, D, li = 2, 5, 2, 8, 1
    k, v, pt = _arena(B, [10, 3], 0, H, D, seed=6)
    nk = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    nv = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    start = np.array([10, 3], np.int32)
    valid = np.array([[True] * Q, [True, True, False, True, False]])
    jk, jv = jcache.write_kv_pages(jnp.asarray(k), jnp.asarray(v), jnp.asarray(nk),
                                   jnp.asarray(nv), jnp.asarray(pt), jnp.asarray(start),
                                   jnp.asarray(valid), layer=jnp.int32(li))
    tk, tv = tcache.write_kv_pages(t(k), t(v), t(nk), t(nv), t(pt), t(start), t(valid), li)
    # the null page's contents are unspecified (colliding invalid rows)
    assert (tk.numpy()[:, 1:] == np.asarray(jk)[:, 1:]).all()
    assert (tv.numpy()[:, 1:] == np.asarray(jv)[:, 1:]).all()
    assert (tcache.gather_kv_pages(tk[li], t(pt), D).numpy()
            == np.asarray(jcache.gather_kv_pages(jk[li], jnp.asarray(pt), D, None,
                                                 jnp.float32))).all()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compact_kv_tail_matches_jax_with_real_moves(dtype):
    """R=2 tree windows where the second branch is accepted: rows really
    move (an R=1 compaction is always the identity)."""
    rng = np.random.default_rng(8)
    B, R, Lb = 3, 2, 8
    Q = 1 + R * Lb
    ctx = np.array([5, 30, 47], np.int32)  # windows straddle page edges
    pages, _, pt = _arena(B, list(ctx), Q, 2, 8, seed=8)
    best = np.array([1, 1, 0])
    n_edges = np.array([3, 8, 2], np.int32)
    path = (1 + best[:, None] * Lb + np.arange(Lb)[None]).astype(np.int32)
    jp = jnp.asarray(pages)
    tp = torch.from_numpy(pages.copy())
    if dtype == "bfloat16":
        jp = jp.astype(jnp.bfloat16)
        tp = tp.to(torch.bfloat16)
    ref = jcache.compact_kv_tail(jp, jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(path),
                                 jnp.asarray(n_edges), Q, jnp.ones(B, bool))
    got = tcache.compact_kv_tail(tp, t(pt), t(ctx), t(path), t(n_edges), Q,
                                 torch.ones(B, dtype=torch.bool))
    ref_np = np.asarray(ref.astype(jnp.float32))
    assert (got.float().numpy() == ref_np).all()
    assert not (ref_np == np.asarray(jp.astype(jnp.float32))).all()  # something moved


def test_kv_permute_plain_matches_pallas_interpret():
    rng = np.random.default_rng(10)
    L, n_pages, ps, HD, B, TPP = 2, 9, 8, 16, 2, 2
    pages = rng.normal(size=(L, n_pages, ps, HD)).astype(np.float32)
    ids = np.array([[1, 2], [5, 3]], np.int32)
    src = np.stack([rng.permutation(TPP * ps) for _ in range(B)]).astype(np.int32)
    ref = kv_permute_pages_pallas(jnp.asarray(pages), jnp.asarray(ids), jnp.asarray(src),
                                  interpret=True)
    before = kv_permute_pages.launches
    got = kv_permute_pages(t(pages), t(ids), t(src))
    assert (got.numpy() == np.asarray(ref)).all()
    assert kv_permute_pages.launches == before


def test_kv_permute_aliased_window_pages_keep_the_later_slot():
    pages = torch.arange(2 * 4 * 2 * 1, dtype=torch.float32).reshape(2, 4, 2, 1)
    ids = torch.tensor([[3, 3]])  # both window pages name page 3
    src = torch.tensor([[1, 0, 3, 2]])
    out = kv_permute_pages(pages.clone(), ids, src)
    # slot 1 (the later) wins: page 3 rows = win[3], win[2] = old page 3 swapped
    assert out[:, 3, :, 0].tolist() == [[7.0, 6.0], [15.0, 14.0]]


# ---------------------------------------------------------------------------
# the e4m3 arenas: writes, attention and compaction
# ---------------------------------------------------------------------------


def _bytes_of(t_tensor):
    return t_tensor.view(torch.uint8).numpy()


def _jax_bytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("mode", ["fp8", "fp8_tok"])
def test_fp8_write_kv_pages_bytes_match_jax(mode):
    """Static clip-then-cast and per-token amax/448 writes: identical e4m3
    bytes and scales (through kv_from_jax, which drops the JAX lane pad)."""
    jc = jconfig.ModelConfig.tiny()
    je = jconfig.EngineConfig(page_size=16, max_seq_len=96, max_concurrency=2, kv_quant=mode)
    jkv = jcache.init_kv_cache(jc, je)
    rng = np.random.default_rng(12)
    H, D, li = jc.num_key_value_heads, jc.head_dim, 1
    if mode == "fp8":  # small scales: some values clip at +-448
        for name in ("k_scale", "v_scale"):
            jkv[name] = jnp.asarray(rng.uniform(0.004, 0.02, jkv[name].shape), jnp.float32)
    tkv = kv_from_jax(jax.tree.map(np.asarray, jkv), H, "cpu")
    B, Q = 2, 7
    nk = (rng.normal(size=(B, Q, H, D)) * 3).astype(np.float32)
    nv = (rng.normal(size=(B, Q, H, D)) * 3).astype(np.float32)
    nk[0, 0, 0, :4] = 0.0  # a partly zero row
    nv[1, 2, 1] = 0.0  # an all-zero (token, head): scale floor 1e-8/448
    pt = np.array([[1, 2, 3, 0, 0, 0], [4, 5, 6, 0, 0, 0]], np.int32)
    start = np.array([13, 2], np.int32)
    valid = np.ones((B, Q), bool)
    valid[1, 5:] = False
    args = (jnp.asarray(pt), jnp.asarray(start), jnp.asarray(valid))
    if mode == "fp8":
        jk, jv = jcache.write_kv_pages(
            jkv["k"], jkv["v"], jnp.asarray(nk), jnp.asarray(nv), *args,
            k_scale=jkv["k_scale"][li], v_scale=jkv["v_scale"][li], layer=jnp.int32(li))
        tcache.write_kv_pages(tkv["k"], tkv["v"], t(nk), t(nv), t(pt), t(start), t(valid),
                              li, tkv["k_scale"][li], tkv["v_scale"][li])
        assert np.abs(nk / np.asarray(jkv["k_scale"][li])[None, None, :, None]).max() > 448
    else:
        jk, jv, jks, jvs = jcache.write_kv_pages(
            jkv["k"], jkv["v"], jnp.asarray(nk), jnp.asarray(nv), *args,
            layer=jnp.int32(li), k_tok_scale=jkv["k_tok_scale"],
            v_tok_scale=jkv["v_tok_scale"])
        tcache.write_kv_pages(tkv["k"], tkv["v"], t(nk), t(nv), t(pt), t(start), t(valid),
                              li, k_tok_scale=tkv["k_tok_scale"],
                              v_tok_scale=tkv["v_tok_scale"])
        for got, ref in ((tkv["k_tok_scale"], jks), (tkv["v_tok_scale"], jvs)):
            assert (got.numpy()[:, 1:] == np.asarray(ref)[:, 1:, :, :H]).all()
    # page 0 takes the invalid rows; its contents are unspecified
    assert (_bytes_of(tkv["k"])[:, 1:] == _jax_bytes(jk)[:, 1:]).all()
    assert (_bytes_of(tkv["v"])[:, 1:] == _jax_bytes(jv)[:, 1:]).all()
    assert _jax_bytes(jk)[li, 1:].any()


def _fp8_arena(B, ctx, Q, Hkv, D, seed, tok: bool):
    """An e4m3 arena (numpy e4m3) with static [L, Hkv] or per-token
    [L, n_pages, PS, 128] (JAX lane-padded) f32 scales."""
    k, v, pt = _arena(B, ctx, Q, Hkv, D, seed)
    rng = np.random.default_rng(seed + 100)
    k8 = np.asarray(jnp.asarray(k * 4).astype(jnp.float8_e4m3fn))
    v8 = np.asarray(jnp.asarray(v * 4).astype(jnp.float8_e4m3fn))
    if tok:
        ks = np.zeros(k.shape[:3] + (128,), np.float32)
        vs = np.zeros_like(ks)
        ks[..., :Hkv] = rng.uniform(0.01, 0.1, ks[..., :Hkv].shape)
        vs[..., :Hkv] = rng.uniform(0.01, 0.1, vs[..., :Hkv].shape)
    else:
        ks = rng.uniform(0.01, 0.1, (LAYERS, Hkv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (LAYERS, Hkv)).astype(np.float32)
    return k8, v8, ks, vs, pt


def _t8(a):
    return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_fp8_static_attention_plain_matches_jax(G, kind):
    B, Hkv, D, li = 2, 2, 16, 1
    ctx = [21, 37]
    if kind == "prefill":
        Q = 40
        qmask = np.broadcast_to(np.tril(np.ones((Q, Q), bool)), (B, Q, Q)).copy()
    else:
        qmask = np.ones((B, 1, 1), bool) if kind == "decode" else _tree_qmask(B, 2, 4)
        Q = qmask.shape[1]
    k8, v8, ks, vs, pt = _fp8_arena(B, ctx, Q, Hkv, D, seed=20 + G, tok=False)
    q = np.random.default_rng(9).normal(size=(B, Q, G * Hkv, D)).astype(np.float32)
    ctx_np, scale = np.array(ctx, np.int32), D ** -0.5
    scales = (t(ks)[li], t(vs)[li])
    if kind == "prefill":
        got = paged_attention_prefill(t(q), _t8(k8)[li], _t8(v8)[li], t(pt), t(ctx_np),
                                      scale, scales).numpy()
    else:
        got = paged_attention(t(q), _t8(k8)[li], _t8(v8)[li], t(pt), t(ctx_np), t(qmask),
                              scale, scales).numpy()
    ref = jatt.paged_attention_ref(jnp.asarray(q), jnp.asarray(k8[li]), jnp.asarray(v8[li]),
                                   jnp.asarray(pt), jnp.asarray(ctx_np), jnp.asarray(qmask),
                                   scale, jnp.asarray(ks[li]), jnp.asarray(vs[li]))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    if kind != "prefill":  # the Pallas prefill kernel has no e4m3 mode
        pallas = j_paged_attention(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                                   jnp.asarray(pt), jnp.asarray(ctx_np), jnp.asarray(qmask),
                                   scale, interpret=True, layer=jnp.int32(li),
                                   kv_scales=(jnp.asarray(ks[li]), jnp.asarray(vs[li])))
        assert rel_err(got, np.asarray(pallas.astype(jnp.float32))) < 3e-2


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_fp8_tok_attention_plain_matches_jax(G, kind):
    B, Hkv, D, li = 2, 2, 16, 0
    ctx = [21, 37]
    qmask = None
    if kind == "prefill":
        Q = 40
        jmask = np.broadcast_to(np.tril(np.ones((Q, Q), bool)), (B, Q, Q)).copy()
    else:
        qmask = np.ones((B, 1, 1), bool) if kind == "decode" else _tree_qmask(B, 2, 4)
        jmask, Q = qmask, qmask.shape[1]
    k8, v8, ks, vs, pt = _fp8_arena(B, ctx, Q, Hkv, D, seed=30 + G, tok=True)
    q = np.random.default_rng(10).normal(size=(B, Q, G * Hkv, D)).astype(np.float32)
    ctx_np, scale = np.array(ctx, np.int32), D ** -0.5
    got = paged_attention_tok(t(q), _t8(k8)[li], _t8(v8)[li],
                              t(ks[li, ..., :Hkv]), t(vs[li, ..., :Hkv]), t(pt),
                              t(ctx_np), scale, None if qmask is None else t(qmask)).numpy()
    ref = jatt.paged_attention_ref(jnp.asarray(q), jnp.asarray(k8[li]), jnp.asarray(v8[li]),
                                   jnp.asarray(pt), jnp.asarray(ctx_np), jnp.asarray(jmask),
                                   scale, jnp.asarray(ks[li]), jnp.asarray(vs[li]))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    if kind == "decode":  # the Pallas kernel serves Q = 1 only
        pallas = j_paged_attention_tok(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                                       jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt),
                                       jnp.asarray(ctx_np), scale, interpret=True,
                                       layer=jnp.int32(li))
        assert rel_err(got, np.asarray(pallas.astype(jnp.float32))) < 3e-2


@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("kind", CASES)
def test_compact_kv_tail_fp8_matches_jax_byte_for_byte(kind, heads):
    """An fp8_tok arena set, e4m3 K / V rows and f32 per-token scale rows of
    ``heads`` heads (16 bytes, or 8: the kernel's 4-byte route), compacted
    in one four-arena call, against the JAX package's ``compact_kv_tail``
    on each arena (its jnp route: gather the window, write its pages back
    whole; ``force_jnp`` for the scales), byte for byte, with real moves.
    Where a row is inactive the JAX jnp route copies that row's own window
    into the null page, where the port (and the JAX Pallas route) permutes
    page 0 itself: there page 0 is held against ``kv_permute_pages_pallas``
    in interpret mode on the byte values."""
    c = compact_case(kind, seed=3, widths=(32, 32))
    rng = np.random.default_rng(4)
    k8, v8 = (np.asarray(jnp.asarray(c[n] * 64).astype(jnp.float8_e4m3fn)) for n in "kv")
    ks, vs = (rng.uniform(0.01, 0.1, c["k"].shape[:3] + (heads,)).astype(np.float32)
              for _ in range(2))
    targs = (t(c["pt"]), t(c["ctx"]), t(c["path"]), t(c["ne"]), c["Q"], t(c["active"]))
    jargs = (jnp.asarray(c["pt"]), jnp.asarray(c["ctx"]), jnp.asarray(c["path"]),
             jnp.asarray(c["ne"]), c["Q"], jnp.asarray(c["active"]))
    arenas = (_t8(k8), _t8(v8), t(ks), t(vs))
    before = kv_compact_tail.launches
    out = tcache.compact_kv_tail(arenas, *targs)
    assert out is arenas and kv_compact_tail.launches == before  # CPU: the plain version
    first = 0 if c["active"].all() else 1
    page_ids, src_of, base = tail_window(*targs[:5], k8.shape[2], targs[5])
    src_rel = (src_of - base[:, None]).clamp(0, src_of.shape[1] - 1)
    moved = False
    for got, a in zip(arenas, (k8, v8, ks, vs)):
        ref = jcache.compact_kv_tail(jnp.asarray(a), *jargs, force_jnp=a.dtype == np.float32)
        want, have = _jax_bytes(ref), _bytes_of(got)
        assert (have[:, first:] == want[:, first:]).all()
        moved |= not (want == _jax_bytes(a)).all()
        if first:
            as_f32 = jnp.asarray(_jax_bytes(a).astype(np.float32))
            pallas = kv_permute_pages_pallas(as_f32, jnp.asarray(page_ids.int().numpy()),
                                             jnp.asarray(src_rel.int().numpy()), interpret=True)
            assert (have == np.asarray(pallas).astype(np.uint8)).all()
    assert moved or kind in ("identity", "no_edges")


@pytest.mark.parametrize("kv_quant", ["none", "fp8", "fp8_tok"])
def test_kv_bytes_per_page_and_auto_sizing_match_jax(kv_quant):
    """Same page cost as the JAX package, less its 128-lane scale padding;
    off the card both size the arena by max_concurrency."""
    jc, tc = jconfig.ModelConfig.tiny(), tconfig.ModelConfig.tiny()
    kw = dict(page_size=16, max_seq_len=128, max_concurrency=4, kv_quant=kv_quant,
              cache_memory_fraction=0.5)
    je, te = jconfig.EngineConfig(**kw), tconfig.EngineConfig(**kw)
    pad = 0
    if kv_quant == "fp8_tok":
        pad = jc.num_hidden_layers * 16 * (128 - jc.num_key_value_heads) * 4 * 2
    assert (tcache.kv_bytes_per_page(tc, te, torch.float32)
            == jcache.kv_bytes_per_page(jc, je, jnp.float32) - pad)
    assert (tcache.auto_size_pages(tc, te, torch.float32, "cpu")
            == jcache.auto_size_pages(jc, je, jnp.float32)
            == te.max_concurrency * te.pages_per_req + 1)


def test_kv_write_pages_aliased_destination_keeps_the_later_window():
    pages = torch.zeros(2, 6, 2, 3, dtype=torch.float32)
    windows = torch.arange(2 * 4 * 2 * 3, dtype=torch.float32).reshape(2, 4, 2, 3)
    ids = torch.tensor([3, 0, 3, 0])  # 3 twice, and the null page twice
    before = kv_write_pages.launches
    out = kv_write_pages(pages.clone(), windows, ids)
    assert kv_write_pages.launches == before  # CPU: the plain version
    assert torch.equal(out[:, 3], windows[:, 2]) and torch.equal(out[:, 0], windows[:, 3])
    assert torch.equal(out, kv_write_pages_plain(pages.clone(), windows, ids))
    assert not out[:, [1, 2, 4, 5]].any()


def test_cuda_entry_points_never_fall_back():
    if torch.cuda.is_available():
        assert _build.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            _build.resolve_device(None)
        for kv_quant in ("none", "fp8", "fp8_tok"):
            with pytest.raises(RuntimeError):
                tcache.init_kv_cache(tconfig.ModelConfig.tiny(),
                                     tconfig.EngineConfig(kv_quant=kv_quant))
    assert _build.resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_off_the_cpu_raise_instead_of_running_plain():
    """A tensor that is not on the CPU never reaches a plain version: on
    CUDA it launches the kernel, anywhere else (here: meta) it raises."""
    q = torch.empty(1, 1, 2, 16, device="meta")
    arena = torch.empty(3, 16, 32, device="meta")
    arena8 = torch.empty(3, 16, 32, device="meta", dtype=torch.float8_e4m3fn)
    s_tok = torch.empty(3, 16, 2, device="meta")
    pt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    ctx = torch.zeros(1, dtype=torch.int32, device="meta")
    qm = torch.ones(1, 1, 1, dtype=torch.bool, device="meta")
    calls = [
        lambda: paged_attention(q, arena, arena, pt, ctx, qm, 0.25),
        lambda: paged_attention_prefill(q, arena, arena, pt, ctx, 0.25),
        lambda: paged_attention_tok(q, arena8, arena8, s_tok, s_tok, pt, ctx, 0.25, qm),
        lambda: kv_write_pages(torch.empty(2, 4, 16, 32, device="meta"),
                               torch.empty(2, 1, 16, 32, device="meta"),
                               torch.zeros(1, dtype=torch.int32, device="meta")),
        lambda: kv_permute_pages(torch.empty(2, 4, 16, 32, device="meta"),
                                 torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                                 torch.zeros(1, 16, dtype=torch.int32, device="meta")),
        lambda: int4_matmul(torch.empty(1, 256, device="meta"),
                            torch.empty(128, 64, dtype=torch.uint8, device="meta"),
                            torch.empty(2, 64, dtype=torch.bfloat16, device="meta")),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError):
            call()
