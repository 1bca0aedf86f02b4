"""The port's host-trie lookahead generator against the JAX package, on the CPU.

Covered: the trie (``DraftCache`` against the JAX one on random streams in
every retrieval mode, the native C++ trie against the port's Python one),
the batched greedy acceptance walk over general trees, ``verify_step`` on
tiny fp32 models of four families, ``LookaheadGenerator`` in its three
draft modes and its batched form, and the plain versions of the KV row
kernels (K16 ``kv_write_rows``, K17 ``kv_move_rows``) against the JAX
package's jnp counterparts of the Pallas bodies (the TPU's DMA bodies do
not run on the CPU).

Tokens, ``n_acc``, draft sizes and emitted counts must be identical; KV rows
and states within 1e-5 of the largest reference value (fp32 on both sides,
sums in other orders; a hybrid's commit is JAX's closed form against the
port's per-token step, as in tests/test_torch_linear.py); the row kernels'
plain versions byte for byte.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jconfig
from painlessinferenceacceleration_tpu.engine import cache as jcache
from painlessinferenceacceleration_tpu.engine import step as jstep
from painlessinferenceacceleration_tpu.lookahead import trie as jtrie
from painlessinferenceacceleration_tpu.lookahead.generate import (
    LookaheadGenerator as JGenerator,
)

from painlessinferenceacceleration_tpu_torch import config as tconfig
from painlessinferenceacceleration_tpu_torch.engine import cache as tcache
from painlessinferenceacceleration_tpu_torch.engine import step as tstep
from painlessinferenceacceleration_tpu_torch.lookahead import native as tnative
from painlessinferenceacceleration_tpu_torch.lookahead import trie as ttrie
from painlessinferenceacceleration_tpu_torch.lookahead.generate import (
    LookaheadGenerator as TGenerator,
    make_draft_cache,
)
from painlessinferenceacceleration_tpu_torch.models.base import init_params as t_init_params
from painlessinferenceacceleration_tpu_torch.models.convert import kv_from_jax
from painlessinferenceacceleration_tpu_torch.ops import kv_update as tku

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: thousands of tiny ops beside the parallel run's
    other workers (as in tests/test_torch_linear.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= tol * scale


# ---------------------------------------------------------------------------
# the trie
# ---------------------------------------------------------------------------


def _same_draft(a, b):
    """ids, mask, parents and the first size (one_get's sizes list is
    [depth] in the Python trie and [depth, 0] in the native one)."""
    assert a[0] == b[0] and list(a[2]) == list(b[2]) and a[3][0] == b[3][0]
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def _feed(caches, rng, n_docs=25, vocab=30, eos=0):
    """The same random prompts (input mode, several request ids), streamed
    outputs with eos inside, and final flushes into every cache."""
    for d in range(n_docs):
        idx = d % 3
        doc = rng.integers(0, vocab, int(rng.integers(3, 40))).tolist()
        out = rng.integers(0, vocab, int(rng.integers(2, 20))).tolist()
        cut = [int(c) for c in np.sort(rng.integers(0, len(out) + 1, 2))]
        for c in caches:
            c.put(doc, branch_length=6, mode="input" if d % 2 else "output", idx=idx)
            c.stream_put(out[: cut[0]], branch_length=6, idx=idx)
            c.stream_put(out[cut[0]: cut[1]], branch_length=6, idx=idx)
            c.stream_put(out[cut[1]:] + [eos], branch_length=6, idx=idx,
                         final=bool(d % 4 == 0))


def _queries(rng, n=60, vocab=30):
    return [rng.integers(0, vocab, 2).tolist() for _ in range(n)]


def test_draft_cache_matches_jax_on_random_streams(tmp_path):
    rng = np.random.default_rng(0)
    kw = dict(eos_ids=(0,), max_node=64, max_output_node=24, squeeze_every=8)
    j, t = jtrie.DraftCache(**kw), ttrie.DraftCache(**kw)
    _feed((j, t), rng)
    for q in _queries(rng):
        for mode in ("mix", "input", "output"):
            for getter in ("hier_get", "par_get", "one_get"):
                args = dict(decoding_length=16, branch_length=6, mode=mode, idx=1)
                a, b = getattr(j, getter)(q, **args), getattr(t, getter)(q, **args)
                _same_draft(a, b)
                assert a[3] == b[3]
    qs = _queries(rng, 4)
    for dm in ("hier", "one"):
        for a, b in zip(j.bat_get(qs, 24, 6, indices=[0, 1, 2, 0], decoding_mode=dm),
                        t.bat_get(qs, 24, 6, indices=[0, 1, 2, 0], decoding_mode=dm)):
            _same_draft(a, b)
    # eos truncation: nothing after the eos id enters the trie
    assert t._truncate_eos([3, 4, 0, 5]) == j._truncate_eos([3, 4, 0, 5]) == [3, 4]
    # squeeze evicted in both, to the same node counts
    assert {k: v.n_node for k, v in t.mem.items()} == {k: v.n_node for k, v in j.mem.items()}
    # save / load round trips (each package its own pickle of its classes)
    t.save_mem(str(tmp_path / "t.json"))
    t2 = ttrie.DraftCache(**kw)
    t2.load_mem(str(tmp_path / "t.json"))
    for q in _queries(rng, 20):
        _same_draft(t2.hier_get(q, 16, 6), j.hier_get(q, 16, 6))


@pytest.fixture(scope="module")
def native_cls():
    assert tnative.load_native() is not None, "g++ is present: the native trie must build"
    return tnative.NativeDraftCache


def test_native_trie_matches_python_trie(native_cls, tmp_path):
    rng = np.random.default_rng(1)
    kw = dict(eos_ids=(0,), max_node=64, max_output_node=24, squeeze_every=8)
    py, cc = ttrie.DraftCache(**kw), native_cls(**kw)
    _feed((py, cc), rng)
    for q in _queries(rng):
        for mode in ("mix", "input", "output"):
            for getter in ("hier_get", "par_get", "one_get"):
                args = dict(decoding_length=16, branch_length=6, mode=mode, idx=2)
                _same_draft(getattr(py, getter)(q, **args), getattr(cc, getter)(q, **args))
    qs = _queries(rng, 3)
    for a, b in zip(py.bat_get(qs, 24, 6), cc.bat_get(qs, 24, 6)):
        _same_draft(a, b)
    cc.save_mem(str(tmp_path / "n.bin"))
    cc2 = native_cls(**kw)
    cc2.load_mem(str(tmp_path / "n.bin"))
    for q in _queries(rng, 20):
        _same_draft(cc2.hier_get(q, 16, 6), py.hier_get(q, 16, 6))
    cc2.fresh()
    assert cc2.hier_get([5, 6], 16, 6)[0] == [6]


def test_native_trie_builds_from_the_ports_source_into_build():
    lib = tnative.lib_path()
    assert lib.parent == tnative.BUILD_DIR and lib.parent.parent.name == "build"
    assert tnative.SRC.parent.parent.name == "painlessinferenceacceleration_tpu_torch"
    assert tnative.build_native() == lib and lib.exists()
    assert isinstance(make_draft_cache(), tnative.NativeDraftCache)


def test_make_draft_cache_falls_back_to_python_without_the_native_trie(monkeypatch):
    monkeypatch.setattr(tnative, "load_native", lambda: None)
    cache = make_draft_cache(eos_ids=(2,))
    assert isinstance(cache, ttrie.DraftCache)
    assert not isinstance(cache, tnative.NativeDraftCache)


# ---------------------------------------------------------------------------
# the acceptance walk and verify_step
# ---------------------------------------------------------------------------


def _dfs_tree(rng, Q, n, vocab):
    """A random tree of n <= Q nodes in DFS order (a node's parent precedes
    it and every node between them is in the parent's subtree), padded to
    Q: (tokens, parents, ancestor mask)."""
    parents, stack = [-1], [0]
    for s in range(1, n):
        stack = stack[: int(rng.integers(1, len(stack) + 1))]
        parents.append(stack[-1])
        stack.append(s)
    parents += [-2] * (Q - n)
    tokens = rng.integers(0, vocab, Q).astype(np.int32)
    tokens[n:] = 0
    qm = np.zeros((Q, Q), bool)
    for s in range(n):
        a = s
        while a >= 0:
            qm[s, a] = True
            a = parents[a]
    return tokens, np.array(parents, np.int32), qm


def test_accept_walk_matches_jax_on_random_dfs_trees():
    rng = np.random.default_rng(2)
    B, Q, V = 16, 12, 3  # a small vocabulary: many matches, sibling ties
    trees = [_dfs_tree(rng, Q, int(rng.integers(1, Q + 1)), V) for _ in range(B)]
    toks = np.stack([t[0] for t in trees])
    pars = np.stack([t[1] for t in trees])
    greedy = rng.integers(0, V, (B, Q)).astype(np.int32)
    jo, jn, jp = jax.vmap(jstep._accept_walk)(jnp.asarray(greedy), jnp.asarray(toks),
                                             jnp.asarray(pars))
    to, tn, tp = tstep._accept_walk(torch.from_numpy(greedy), torch.from_numpy(toks),
                                    torch.from_numpy(pars))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert int(tn.max()) >= 3


FAMILIES = {
    "llama": dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
    "moe": dict(model_type="qwen3_moe", vocab_size=256, hidden_size=32,
                intermediate_size=64, moe_intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, qk_norm=True,
                num_experts=4, num_experts_per_tok=2, moe_layer_start=1,
                num_shared_experts=1),
    "mla": dict(model_type="deepseek_v2", vocab_size=256, hidden_size=64,
                intermediate_size=96, moe_intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                moe_layer_start=1, num_experts=4, num_experts_per_tok=2,
                num_shared_experts=2, norm_topk_prob=False, mla_latent_cache=True),
    "hybrid": dict(model_type="ring_linear", vocab_size=256, hidden_size=32,
                   intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
                   num_key_value_heads=4, linear_attention=True, layer_group_size=2),
}


def _params(tc):
    """The port's random fp32 weights (its init is fast on the CPU) and the
    same weights as a JAX tree (the two packages' trees have one shape:
    tests/test_torch_moe.py, tests/test_torch_linear.py)."""
    tp = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    return tp, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def _arena_rows(kv, k_row, pt, n):
    """Each arena's first n slots of the request (page table pt) [L, n, row],
    the JAX MLA pad lanes cut to the port's K row."""
    out = {}
    for name in ("k", "v"):
        a = np.asarray(kv[name]) if not isinstance(kv[name], torch.Tensor) else kv[name].numpy()
        L, _, ps, _ = a.shape
        rows = a[:, pt].reshape(L, -1, a.shape[-1])[:, :n]
        out[name] = rows[..., :k_row] if name == "k" else rows
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_verify_step_matches_jax(family):
    """A prefill, then one verify of a general tree whose accepted branch
    is the model's greedy continuation placed after a decoy branch (so the
    compaction really moves rows): tokens, n_acc, every live K/V row and a
    hybrid's states against JAX."""
    kw = FAMILIES[family]
    jc, tc = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
    tp, jp = _params(tc)
    je = jconfig.EngineConfig(page_size=8, max_seq_len=64, max_concurrency=1)
    te = tconfig.EngineConfig(page_size=8, max_seq_len=64, max_concurrency=1)
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 250, 11).astype(np.int32)
    P = te.pages_per_req
    pt = np.arange(1, 1 + P, dtype=np.int32)[None]
    jkv = jcache.init_kv_cache(jc, je, dtype=jnp.float32)
    jkv, jnxt, _ = jstep.prefill_step(jp, jkv, jc, jnp.asarray(prompt[None]),
                                      jnp.zeros((1,), jnp.int32), jnp.array([11], jnp.int32),
                                      jnp.asarray(pt))
    k_row = tcache.init_kv_cache(tc, te, dtype=torch.float32, device="cpu")["k"].shape[-1]
    tkv = kv_from_jax(jax.tree.map(np.asarray, jkv), tc.num_key_value_heads, "cpu",
                      k_row=k_row)
    # the greedy continuation (AR on a copy of the port's arena)
    ar_kv = {k: v.clone() for k, v in tkv.items()}
    last, ctx, chain = int(jnxt[0]), 11, []
    for _ in range(3):
        tok, pos, qm, par = tstep.decode_inputs(torch.tensor([last], dtype=torch.int32),
                                                torch.tensor([ctx], dtype=torch.int32))
        ar_kv, ot, _ = tstep.verify_step(tp, ar_kv, tc, tok, pos, qm, par,
                                         torch.from_numpy(pt), torch.tensor([ctx]),
                                         torch.ones(1, dtype=torch.bool))
        last, ctx = int(ot[0, 0]), ctx + 1
        chain.append(last)
    # nodes: 0 root, 1-2 a decoy branch, 3-5 the greedy chain, 6 a decoy
    # child of 3, 7 padding
    Q = 8
    toks = np.array([int(jnxt[0]), 1, 2, chain[0], chain[1], chain[2], 2, 0], np.int32)
    pars = np.array([-1, 0, 1, 0, 3, 4, 3, -2], np.int32)
    qm = np.zeros((Q, Q), bool)
    for s in range(7):
        a = s
        while a >= 0:
            qm[s, a] = True
            a = pars[a]
    pos = 11 + np.clip(qm.sum(-1) - 1, 0, None).astype(np.int32)
    args = [toks[None], pos[None], qm[None], pars[None], pt, np.array([11], np.int32),
            np.ones((1,), bool)]
    jkv, jot, jna = jstep.verify_step(jp, jkv, jc, *(jnp.asarray(a) for a in args))
    tkv, tot, tna = tstep.verify_step(tp, tkv, tc, *(torch.from_numpy(a) for a in args))
    assert int(tna[0]) == int(jna[0]) == 4
    n_live = 11 + int(tna[0])
    assert np.array_equal(tot[0, :4].numpy(), np.asarray(jot)[0, :4])
    assert tot[0, :3].tolist() == chain
    j_rows, t_rows = _arena_rows(jkv, k_row, pt[0], n_live), _arena_rows(tkv, k_row, pt[0],
                                                                         n_live)
    for name in ("k", "v"):
        close(t_rows[name], j_rows[name])
        # the accepted rows moved: slots 12-14 hold what AR wrote there
        close(t_rows[name][:, 12:14], _arena_rows(ar_kv, k_row, pt[0], 14)[name][:, 12:14])
    if jc.linear_attention:
        close(tkv["s"], np.asarray(jkv["s"]))


# ---------------------------------------------------------------------------
# LookaheadGenerator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jconfig.ModelConfig.tiny(), tconfig.ModelConfig.tiny()
    tp, jp = _params(tc)
    return jc, jp, tc, tp


GEN = dict(page_size=16, max_seq_len=256, max_concurrency=4, eos_token_id=-2,
           decoding_length=12, branch_length=4)
PROMPT = [7, 8, 9, 10, 11] * 4


def _generators(tiny, **over):
    jc, jp, tc, tp = tiny
    kw = dict(GEN, **over)
    return (JGenerator(jp, jc, jconfig.EngineConfig(**kw), dtype=jnp.float32),
            TGenerator(tp, tc, tconfig.EngineConfig(**kw), dtype=torch.float32, device="cpu"))


def test_generator_matches_jax_in_every_mode(tiny):
    j, t = _generators(tiny)
    assert isinstance(t.trie, tnative.NativeDraftCache)  # g++ is present here
    ar = t.generate(PROMPT, max_new_tokens=40, use_lookahead=False)
    assert ar.dls == [1] * len(ar.dls)
    for mode in ("hier", "par", "one"):  # the trie carries over between requests
        a = j.generate(PROMPT, max_new_tokens=40, use_lookahead=True, decoding_mode=mode)
        b = t.generate(PROMPT, max_new_tokens=40, use_lookahead=True, decoding_mode=mode)
        assert (b.sequences, b.dls, b.edls) == (a.sequences, a.dls, a.edls), mode
        assert b.sequences == ar.sequences  # lossless
        assert len(b.fts) == len(b.qts) == len(b.edls)
    assert max(b.edls) > 1


def test_generator_stream_eos_and_trie_reuse(tiny):
    j, t = _generators(tiny)
    first = t.generate(PROMPT, max_new_tokens=30, use_lookahead=True)
    # the second request drafts from the first one's outputs
    again = t.generate(PROMPT, max_new_tokens=30, use_lookahead=True)
    assert again.sequences == first.sequences
    assert sum(again.edls) == 30 and len(again.edls) < len(first.edls)
    pieces = list(t.stream_generate(PROMPT, max_new_tokens=30, use_lookahead=True))
    assert pieces == first.sequences
    steps = []
    for tok in t._steps(PROMPT, max_new_tokens=30, use_lookahead=True):
        steps.append(tok)
    assert steps[0] == first.sequences[:1] and len(steps) > 2
    # an eos inside the stream stops it, with the eos emitted
    eos = first.sequences[9]
    cut = first.sequences[: first.sequences.index(eos) + 1]
    for g in (t, j):
        got = g.generate(PROMPT, max_new_tokens=30, use_lookahead=True, eos_token_id=eos)
        assert got.sequences == cut


def test_batch_generate_matches_solo_and_jax(tiny):
    j, t = _generators(tiny)
    prompts = [PROMPT, [100, 101, 102] * 3, [5, 6, 7, 8, 9, 10], [42, 43] * 5]
    tb = t.batch_generate(prompts, max_new_tokens=24)
    jb = j.batch_generate(prompts, max_new_tokens=24)
    assert [o.sequences for o in tb] == [o.sequences for o in jb]
    assert [o.edls for o in tb] == [o.edls for o in jb]
    assert [o.dls for o in tb] == [o.dls for o in jb]
    _, solo = _generators(tiny)
    for p, o in zip(prompts, tb):
        assert solo.generate(p, max_new_tokens=24, use_lookahead=False).sequences == o.sequences


def test_generator_refuses_a_request_past_max_seq_len(tiny):
    _, t = _generators(tiny)
    with pytest.raises(ValueError, match="max_seq_len"):
        t.generate(list(range(240)), max_new_tokens=8, use_lookahead=True)


# ---------------------------------------------------------------------------
# the KV row kernels' plain versions (K16, K17)
# ---------------------------------------------------------------------------


def _pages(rng, L, n_pages, ps, row, dtype=np.float32):
    return rng.normal(size=(L, n_pages, ps, row)).astype(dtype)


@pytest.mark.parametrize("arena", ["fp32", "fp8_tok", "mla"])
def test_write_kv_pages_rows_match_jax(arena):
    """write_kv_pages (layered, through kv_write_rows) against JAX's, with
    padded invalid rows all on the null page 0: the whole arena, page 0
    included (the last invalid row written is kept on both sides)."""
    rng = np.random.default_rng(4)
    L, n_pages, ps, H, D = 3, 9, 4, 2, 8
    Dv = 6 if arena == "mla" else D
    B, Q = 2, 5
    kp, vp = _pages(rng, L, n_pages, ps, H * D), _pages(rng, L, n_pages, ps, H * Dv)
    nk = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    nv = rng.normal(size=(B, Q, H, Dv)).astype(np.float32)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    start = np.array([3, 6], np.int32)
    valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], bool)
    t = torch.from_numpy
    if arena == "fp8_tok":
        ks = np.zeros((L, n_pages, ps, 128), np.float32)
        jout = jcache.write_kv_pages(
            jnp.asarray(kp).astype(jnp.float8_e4m3fn), jnp.asarray(vp).astype(jnp.float8_e4m3fn),
            jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(pt), jnp.asarray(start),
            jnp.asarray(valid), layer=1, k_tok_scale=jnp.asarray(ks),
            v_tok_scale=jnp.asarray(ks))
        tk, tv = (t(kp).to(torch.float8_e4m3fn), t(vp).to(torch.float8_e4m3fn))
        tks, tvs = torch.zeros(L, n_pages, ps, H), torch.zeros(L, n_pages, ps, H)
        tout = tcache.write_kv_pages(tk, tv, t(nk), t(nv), t(pt), t(start), t(valid), 1,
                                     k_tok_scale=tks, v_tok_scale=tvs)
        for a, b in zip(tout[:2], jout[:2]):
            assert np.array_equal(a.view(torch.uint8).numpy(),
                                  np.asarray(b).view(np.uint8))
        for a, b in zip(tout[2:], jout[2:]):
            assert np.array_equal(a.numpy(), np.asarray(b)[..., :H])
        return
    jout = jcache.write_kv_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(nk),
                                 jnp.asarray(nv), jnp.asarray(pt), jnp.asarray(start),
                                 jnp.asarray(valid), layer=jnp.int32(1))
    tout = tcache.write_kv_pages(t(kp), t(vp), t(nk), t(nv), t(pt), t(start), t(valid), 1)
    for a, b in zip(tout, jout):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_kv_write_rows_later_row_wins_and_any_type():
    rng = np.random.default_rng(5)
    pages = torch.from_numpy(_pages(rng, 2, 4, 4, 6)).to(torch.bfloat16)
    scale = torch.from_numpy(_pages(rng, 2, 4, 4, 3))
    rows = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32)).to(torch.bfloat16)
    srows = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    pi = torch.tensor([0, 2, 0, 3, 0], dtype=torch.int32)  # three rows on the null page
    ri = torch.tensor([1, 3, 1, 0, 1], dtype=torch.int32)
    ref_p, ref_s = pages.clone(), scale.clone()
    for i in range(5):  # in order: the later row is the one kept
        ref_p[1, pi[i], ri[i]] = rows[i]
        ref_s[1, pi[i], ri[i]] = srows[i]
    tku.kv_write_rows((pages, scale), (rows, srows), pi, ri, 1)
    assert torch.equal(pages, ref_p) and torch.equal(scale, ref_s)
    e4 = pages.to(torch.float8_e4m3fn)
    tku.kv_write_rows(e4, rows.to(torch.float8_e4m3fn), pi, ri, 0)
    assert torch.equal(e4[0, 2, 3].view(torch.uint8), rows[1].to(torch.float8_e4m3fn)
                       .view(torch.uint8))


def _slots_case(rng, B, P, ps, M):
    ctx = rng.integers(ps, (P - 2) * ps, B)
    src = ctx[:, None] + rng.integers(0, 2 * ps, (B, M))
    dst = ctx[:, None] + 1 + np.arange(M)[None]
    valid = rng.random((B, M)) < 0.7
    return src.astype(np.int32), dst.astype(np.int32), valid


def test_move_kv_rows_matches_jax_with_chains_and_null_page():
    """JAX's move_kv_rows (gather, then set) against the port's, whose
    moves chain (a destination that a later move reads, a source that an
    earlier move wrote) and whose masked moves all land on the null page:
    the whole arena, byte for byte, page 0 included (the last masked move
    kept on both sides)."""
    rng = np.random.default_rng(6)
    L, P, ps, row, B, M = 3, 6, 4, 5, 2, 9
    n_pages = 1 + B * P
    pages = _pages(rng, L, n_pages, ps, row)
    pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    src, dst, valid = _slots_case(rng, B, P, ps, M)
    assert np.isin(dst, src).any()  # chains
    ref = jcache.move_kv_rows(jnp.asarray(pages), jnp.asarray(pt), jnp.asarray(src),
                              jnp.asarray(dst), jnp.asarray(valid))
    t = torch.from_numpy
    got = tcache.move_kv_rows(t(pages.copy()), t(pt), t(src), t(dst), t(valid))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    # the plain kernel on e4m3 pages through its byte view
    e4 = t(pages.copy()).to(torch.float8_e4m3fn)
    ref8 = e4.clone().view(torch.uint8)
    sp, sr = t(pt[0][src[0] // ps]), t(src[0] % ps)
    dp, dr = t(pt[0][dst[0] // ps]), t(dst[0] % ps)
    rows = ref8[:, sp.long(), sr.long()].clone()
    for i in range(M):
        ref8[:, dp[i], dr[i]] = rows[:, i]
    tku.kv_move_rows(e4, sp, sr, dp, dr)
    assert torch.equal(e4.view(torch.uint8), ref8)


def test_move_kv_rows_equals_compact_kv_tail_on_live_slots():
    """The accepted path's moves (node ctx + path[i] to ctx + 1 + i) by
    move_kv_rows leave each request's live slots [0, ctx + 1 + n_edges) as
    compact_kv_tail leaves them."""
    rng = np.random.default_rng(7)
    L, P, ps, row, B, Q = 2, 8, 4, 6, 3, 9
    pages = _pages(rng, L, 1 + B * P, ps, row)
    pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    ctx = np.array([5, 9, 14], np.int32)
    path = np.zeros((B, Q - 1), np.int32)
    n_edges = np.array([3, 0, 5], np.int32)
    for b in range(B):  # an increasing path of accepted nodes in the window
        nodes = np.sort(rng.choice(np.arange(1, Q), n_edges[b], replace=False))
        path[b, : n_edges[b]] = nodes
    t = torch.from_numpy
    active = torch.ones(B, dtype=torch.bool)
    a = tcache.compact_kv_tail(t(pages.copy()), t(pt), t(ctx), t(path), t(n_edges), Q, active)
    i = np.arange(Q - 1)[None]
    b = tcache.move_kv_rows(t(pages.copy()), t(pt), t(ctx[:, None] + path),
                            t(ctx[:, None] + 1 + i), t(i < n_edges[:, None]))
    for r in range(B):
        n = int(ctx[r] + 1 + n_edges[r])
        live = lambda x: x.numpy()[:, pt[r]].reshape(L, -1, row)[:, :n]  # noqa: E731
        assert np.array_equal(live(a), live(b))
