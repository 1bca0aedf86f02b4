"""The PyTorch port's linear-attention hybrids (Ring / Bailing-linear) against
the JAX package, on the CPU, at tiny widths.

Weights are drawn by the JAX package and carried over with
``params_from_jax``; inputs come from numpy seeds. The Pallas linear-attention
kernels run in interpret mode, as the JAX package's own tests run them.

The port decodes, verifies and commits with one per-token recurrence
(``S <- lam S + k (x) v``, ``out = q S``), where the JAX package uses
closed forms that agree with it in exact arithmetic only, and its prefill
walks 64-token sub-tiles where JAX takes a chunk whole. So the packages
agree within fp32 tolerances, each stated as a bound on the largest error
relative to the largest reference value: 1e-5 for the attention ops, the
commit and the norms in fp32, 1e-4 for blocks and logits (several GEMMs and
norms deep), one bf16 ulp for bf16 norms; tokens are equal. Within the
port the lookahead stream equals the AR stream bit for bit, and a
teacher-forced lookahead run leaves the same state and KV bits as AR.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jconfig
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.multistep import (
    multistep_decode as j_decode,
    multistep_spec_decode as j_spec,
)
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.lookahead import device_tables as jdt
from painlessinferenceacceleration_tpu.models import linear_attn as jla
from painlessinferenceacceleration_tpu.ops import linear_attention as jops
from painlessinferenceacceleration_tpu.ops import rmsnorm as jrms
from painlessinferenceacceleration_tpu.ops import rope as jrope

from painlessinferenceacceleration_tpu_torch import config as tconfig
from painlessinferenceacceleration_tpu_torch.engine.cache import (
    init_kv_cache as t_init_kv,
    kv_bytes_per_page,
    reset_linear_states,
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
from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as tdt
from painlessinferenceacceleration_tpu_torch.models import linear_attn as tla
from painlessinferenceacceleration_tpu_torch.models.base import (
    init_params as t_init_params,
    transformer_hidden as t_hidden,
)
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.ops import linear_attention as tops
from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as trms
from painlessinferenceacceleration_tpu_torch.ops import rope as trope


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs. Its engine runs are
    thousands of tiny ops; beside a parallel run's other workers, a pool of
    threads per op spends most of their time waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# inclusionAI/Ring-mini-linear-2.0's config.json, the keys the port reads
RING_MINI_LINEAR_2_HF = {
    "model_type": "bailing_moe_linear_v2", "vocab_size": 157184, "hidden_size": 2048,
    "intermediate_size": 5120, "moe_intermediate_size": 512, "num_hidden_layers": 20,
    "num_attention_heads": 16, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 256, "num_experts_per_tok": 8, "num_shared_experts": 1,
    "first_k_dense_replace": 1, "n_group": 8, "topk_group": 4,
    "routed_scaling_factor": 2.5, "norm_topk_prob": True, "use_qk_norm": True,
    "layer_group_size": 5, "rms_norm_eps": 1e-06, "rope_theta": 600000.0,
    "tie_word_embeddings": False, "use_qkv_bias": False, "use_bias": False,
    "hidden_act": "silu",
}
PORT_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]

# the JAX package's test hybrid (tests/test_linear_attn.py lin_cfg), and a
# bailing-shaped one: per-head q/k norm and rope in the linear layers, qk
# norm in the full ones, a dense first layer, then sigmoid-routed experts
MODELS = {
    "ring": dict(model_type="ring_linear", vocab_size=256, hidden_size=32,
                 intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
                 num_key_value_heads=4, linear_attention=True, layer_group_size=2),
    "bailing": dict(model_type="bailing_moe_linear_v2", vocab_size=256, hidden_size=64,
                    intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                    rms_norm_eps=1e-6, rope_theta=600000.0, qk_norm=True,
                    linear_attention=True, layer_group_size=3, linear_qk_norm=True,
                    linear_rope=True, num_experts=8, num_experts_per_tok=2,
                    num_shared_experts=1, moe_layer_start=1, scoring_func="sigmoid",
                    n_group=4, topk_group=2, routed_scaling_factor=2.5),
}


def both(name, **over):
    kw = dict(MODELS[name], **over)
    return jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)


def to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def t2n(t):
    return t.detach().to(torch.float32).numpy()


def close(got, ref, tol):
    """max |got - ref| <= tol * max |ref| (fp32 sums in other orders)."""
    got = t2n(got) if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"max err {err} > {tol} x {np.abs(ref).max()}"


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _loglam(H):
    return np.log(np.clip(np.asarray(jla.default_decays(H)), 1e-4, 1 - 1e-6)).astype(np.float32)


_jit_init = {}


def _jax_params(jc, seed=0):
    """The JAX hybrid's weights (jitted once per config), the norms
    perturbed so that they are not all ones."""
    if jc not in _jit_init:
        _jit_init[jc] = jax.jit(lambda key: jla.init_hybrid_params(jc, key, jnp.float32))
    jp = _jit_init[jc](jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    layers = []
    for lp in jp["hybrid_layers"]:
        lp = dict(lp)
        for name in ("input_ln", "post_ln", "out_norm", "q_norm", "k_norm"):
            if name in lp:
                lp[name] = jnp.asarray(1.0 + 0.2 * _rand(rng, *lp[name].shape))
        layers.append(lp)
    return dict(jp, hybrid_layers=tuple(layers))


# ---------------------------------------------------------------------------
# config and layer pattern
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", PORT_FIELDS)
def test_ring_mini_linear_2_is_the_hf_config(field):
    ref = jconfig.ModelConfig.from_hf(RING_MINI_LINEAR_2_HF)
    assert getattr(tconfig.ModelConfig.ring_mini_linear_2(), field) == getattr(ref, field)


def test_layer_pattern_matches_jax():
    for name in MODELS:
        jc, tc = both(name)
        assert [tla.is_full_layer(tc, i) for i in range(9)] == [
            jla.is_full_layer(jc, i) for i in range(9)]
        assert tla.n_linear_layers(tc) == jla.n_linear_layers(jc)
    ring = tconfig.ModelConfig.ring_mini_linear_2()
    assert [i for i in range(20) if tla.is_full_layer(ring, i)] == [4, 9, 14, 19]
    assert tla.n_linear_layers(ring) == 16
    close(tla.default_decays(16), jla.default_decays(16), 1e-7)


# ---------------------------------------------------------------------------
# norms (K15's plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms_norm_per_head", "group", "group_sigmoid"])
def test_norms_match_jax(kind, dtype):
    rng = np.random.default_rng(3)
    x, gate = _rand(rng, 5, 3, 64, scale=2.0), _rand(rng, 5, 3, 64)
    w = 1.0 + 0.3 * _rand(rng, 64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jg, jw = (jnp.asarray(a).astype(jd) for a in (x, gate, w))
    tx, tg, tw = (torch.from_numpy(a).to(td) for a in (x, gate, w))
    if kind == "rms_norm_per_head":  # a q/k norm: [.., H, D] rows of D
        got = trms.rms_norm(tx.reshape(5, 3, 4, 16), tw[:16], 1e-6)
        ref = jrms.rms_norm(jx.reshape(5, 3, 4, 16), jw[:16], 1e-6)
    elif kind == "group":
        got, ref = trms.rms_group_norm(tx, tw, 1e-6, 4), jrms.rms_group_norm(jx, jw, 1e-6, 4)
    else:
        got = trms.rms_group_norm_sigmoid(tx, tg, tw, 1e-6, 4)
        ref = jrms.rms_group_norm_sigmoid(jx, jg, jw, 1e-6, 4)
    assert got.dtype == td
    # fp32: the fp64-summed variance against JAX's fp32 one; bf16: one ulp
    close(got, np.asarray(ref.astype(jnp.float32)), 1e-6 if dtype == "float32" else 2 ** -7)


# ---------------------------------------------------------------------------
# the linear-attention ops (K14's plain versions) against the Pallas bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [16, 136])  # one sub-tile; three, the last ragged
def test_chunk_plain_matches_jax(C):
    B, H, D = 3, 3, 8
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, B, H, C, D, scale=0.5) for _ in range(3))
    s0 = _rand(rng, B, H, D, D)
    lens = np.array([C, C - 5, 0], np.int32)  # full, padded, a padding row
    ll = _loglam(H)
    jo, js = jops.linear_attention_chunk(*(jnp.asarray(a) for a in (q, k, v, s0, lens, ll)),
                                         interpret=True)
    state = torch.from_numpy(s0.copy())
    to, ts = tops.linear_attention_chunk(*(torch.from_numpy(a) for a in (q, k, v)), state,
                                         torch.from_numpy(lens), torch.from_numpy(ll))
    assert ts is state
    m = (np.arange(C)[None] < lens[:, None])[:, None, :, None]
    close(to, np.asarray(jo) * m, 1e-5)  # padded rows: 0 in the port, don't-care in JAX
    close(ts[:2], np.asarray(js)[:2], 1e-5)
    assert torch.equal(ts[2], torch.from_numpy(s0[2]))  # chunk_lens 0: state untouched


def _branch_tree(B, R, L, dead):
    """The parallel-branch layout (lookahead/device_tables.py): the root,
    then R branches of L nodes; ``dead[b]`` nodes at the end of row b's last
    branch are dead. Returns (parents [B, Q], valid, depth, vis)."""
    Q = 1 + R * L
    par = np.full((B, Q), -1, np.int32)
    depth = np.zeros((B, Q), np.float32)
    for i in range(1, Q):
        par[:, i] = 0 if (i - 1) % L == 0 else i - 1
        depth[:, i] = (i - 1) % L + 1
    valid = np.ones((B, Q), bool)
    for b in range(B):
        if dead[b]:
            valid[b, Q - dead[b]:] = False
            par[b, Q - dead[b]:] = -2
    vis = np.zeros((B, Q, Q), bool)
    for b in range(B):
        for i in range(Q):
            a = i
            while a >= 0 and valid[b, i]:
                vis[b, i, a] = True
                a = par[b, a] if a > 0 else -1
    return par, valid, depth, vis


def test_tree_plain_matches_jax():
    """Tree verify on the parallel-branch layout (R = 2, L = 4) with dead
    nodes and a root at depth 3 (JAX's tree kernel folds lam^depth_0 into
    the state; the port walks from the committed state, so it is given that
    state decayed)."""
    B, H, D, R, L = 2, 3, 8, 2, 4
    Q = 1 + R * L
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, B, H, Q, D, scale=0.5) for _ in range(3))
    s0 = _rand(rng, B, H, D, D)
    par, valid, depth, vis = _branch_tree(B, R, L, dead=[0, 2])
    ll = _loglam(H)
    root = 3.0
    colmask = vis.any(axis=1)[:, None, :, None]
    jo = jops.linear_attention_tree(*(jnp.asarray(a) for a in (
        q, k * colmask, v * colmask, s0, depth + root, vis, ll)), interpret=True)
    s_root = s0 * np.exp(ll * root)[None, :, None, None]
    to = tops.linear_attention_tree(*(torch.from_numpy(a) for a in (
        q, k, v, s_root.astype(np.float32), par, valid, ll)))
    close(to, np.asarray(jo) * valid[:, None, :, None], 1e-5)


def test_commit_matches_jax():
    n_lin, slots, B, H, D, R, L = 2, 3, 3, 2, 8, 2, 4
    Q = 1 + R * L
    rng = np.random.default_rng(2)
    s = _rand(rng, n_lin, slots, H, D, D)
    wk, wv = _rand(rng, n_lin, B, H, Q, D, scale=0.5), _rand(rng, n_lin, B, H, Q, D)
    decay = np.stack([np.asarray(jla.default_decays(H)), np.linspace(0.5, 0.9, H)])
    decay = decay.astype(np.float32)
    slot_ids = np.array([2, 0, 0], np.int32)  # row 2 pads, aliasing row 1's slot
    n_commit = np.array([3, 5, 0], np.int32)
    best = np.array([1, 0, 0])
    chain = np.stack([np.concatenate([[0], 1 + best[b] * L + np.arange(L)]) for b in range(B)])
    _, _, depth, _ = _branch_tree(B, R, L, dead=[0, 0, 0])
    accept = np.zeros((B, Q), np.float32)
    for b in range(B):
        accept[b, chain[b, : n_commit[b]]] = 1.0
    jkv = {"s": jnp.asarray(s), "_win": {"k": jnp.asarray(wk), "v": jnp.asarray(wv),
                                          "lam": jnp.asarray(decay),
                                          "depth": jnp.asarray(depth)}}
    ref = jla.commit_linear_states(jkv, jnp.asarray(accept), jnp.asarray(n_commit),
                                   jnp.asarray(slot_ids))["s"]
    tkv = {"s": torch.from_numpy(s.copy()),
           "_win": {"k": torch.from_numpy(wk), "v": torch.from_numpy(wv),
                    "loglam": tla.loglam_of(torch.from_numpy(decay))}}
    out = tla.commit_linear_states(tkv, torch.from_numpy(chain), torch.from_numpy(n_commit),
                                   torch.from_numpy(slot_ids))
    assert "_win" not in out
    close(out["s"], np.asarray(ref), 1e-5)
    assert torch.equal(out["s"][:, 1], torch.from_numpy(s[:, 1]))  # no row's slot


def test_recurrent_modes_share_one_step():
    """AR decode steps, a tree walk and the commit of the walked chain give
    the same bits: a verified row is the AR row, the committed state the
    AR state."""
    B, H, D, R, L = 1, 2, 8, 2, 4
    Q = 1 + R * L
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, B, H, Q, D, scale=0.5)) for _ in range(3))
    s0 = torch.from_numpy(_rand(rng, B, H, D, D))
    ll = torch.from_numpy(_loglam(H))
    par, valid, _, _ = _branch_tree(B, R, L, dead=[0])
    tree = tops.linear_attention_tree(q, k, v, s0, torch.from_numpy(par),
                                      torch.from_numpy(valid), ll)
    chain = [0] + list(range(1 + L, 1 + 2 * L))  # the root, then branch 1
    s_ar, outs = s0.clone(), []
    for c in chain:
        o, _ = tops.linear_attention_decode(q[:, :, c:c + 1], k[:, :, c:c + 1],
                                            v[:, :, c:c + 1], s_ar,
                                            torch.ones(B, 1, dtype=torch.bool), ll)
        outs.append(o)
    assert torch.equal(torch.cat(outs, dim=2), tree[:, :, chain])
    arena = s0[None].clone()
    tops.linear_attention_commit(arena, k[None], v[None], torch.tensor([chain]),
                                 torch.tensor([len(chain)]), ll[None],
                                 torch.zeros(1, dtype=torch.int32))
    assert torch.equal(arena[0], s_ar)


# ---------------------------------------------------------------------------
# the block and the model against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    jc, tc = both(request.param)
    jp = _jax_params(jc)
    return jc, tc, jp, to_torch(jp)


def _cos_sin(jc, tc, pos):
    return (jrope.dense_cos_sin(jc, jnp.asarray(pos)),
            trope.dense_cos_sin(tc, torch.from_numpy(pos)))


@pytest.mark.parametrize("mode", ["prefill", "decode", "tree"])
def test_linear_attn_block_matches_jax(pair, mode):
    jc, tc, jp, tp = pair
    B, H, D, E = 2, tc.num_attention_heads, tc.head_dim, tc.hidden_size
    C = {"prefill": 12, "decode": 1, "tree": 9}[mode]
    rng = np.random.default_rng(5)
    h = _rand(rng, B, C, E)
    s0 = _rand(rng, B, H, D, D, scale=0.3)
    pos = (np.arange(C)[None] + np.array([[0], [7]])).astype(np.int32)
    (jcs, tcs) = _cos_sin(jc, tc, pos)
    lens = np.array([C, max(C - 3, 1)], np.int32)
    kw_j, kw_t = {}, {}
    if mode == "tree":
        par, valid, depth, vis = _branch_tree(B, 2, 4, dead=[0, 3])
        kw_j = dict(depth=jnp.asarray(depth), vis=jnp.asarray(vis))
        kw_t = dict(parents=torch.from_numpy(par), valid=torch.from_numpy(valid))
    block = jax.jit(lambda lp, h, s, n, cos, sin, **kw: jla.linear_attn_block(
        lp, jc, None, h, s, n, **kw, cos=cos, sin=sin))
    jo, js, _ = block(jp["hybrid_layers"][0], jnp.asarray(h), jnp.asarray(s0),
                      jnp.asarray(lens), *jcs, **kw_j)
    state = torch.from_numpy(s0.copy())
    to, feats = tla.linear_attn_block(tp["hybrid_layers"][0], tc, None, torch.from_numpy(h),
                                      state, torch.from_numpy(lens), **kw_t,
                                      cos=tcs[0], sin=tcs[1])
    rows = (np.arange(C)[None] < lens[:, None]) if mode != "tree" else valid
    close(to * torch.from_numpy(rows)[..., None], np.asarray(jo) * rows[..., None], 1e-4)
    close(state, np.asarray(js), 1e-5)  # the tree writes no state
    assert (feats is None) == (mode != "tree")


B, PAGE, MAX_SEQ = 2, 16, 256
BR, BL = 2, 4  # verify width Q = 9


class Run:
    """Prefill, decode and lookahead of one hybrid in both packages, over
    slots 1 and 0 of a 3-slot arena (row b of the batch is slot
    SLOTS[b]), with a teacher stream that repeats each prompt, so drafts
    land and multi-token chains are committed."""

    SLOTS = np.array([1, 0], np.int32)

    def __init__(self, jc, tc, jp, tp):
        self.jc, self.tc, self.jp, self.tp = jc, tc, jp, tp
        self.je = jconfig.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=3)
        self.te = tconfig.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=3)
        rng = np.random.default_rng(7)
        self.toks = rng.integers(10, 30, size=(B, 20)).astype(np.int32)
        self.lens = np.array([20, 13], np.int32)
        P = self.je.pages_per_req
        self.pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
        self.teacher = np.stack([np.tile(self.toks[b, :6], 40)[:240] for b in range(B)])
        self.toks[:, :20] = self.teacher[:, :20]

    def prefill(self, jax_side):
        if jax_side:
            kv = j_init_kv(self.jc, self.je, dtype=jnp.float32)
            return j_prefill(self.jp, kv, self.jc, jnp.asarray(self.toks),
                             jnp.zeros(B, jnp.int32), jnp.asarray(self.lens),
                             jnp.asarray(self.pt), slot_ids=jnp.asarray(self.SLOTS))
        kv = t_init_kv(self.tc, self.te, dtype=torch.float32, device="cpu")
        return t_prefill(self.tp, kv, self.tc, torch.from_numpy(self.toks),
                         torch.zeros(B, dtype=torch.int32), torch.from_numpy(self.lens),
                         torch.from_numpy(self.pt), slot_ids=torch.from_numpy(self.SLOTS))

    def spec(self, jax_side, n_steps, active=(True, True)):
        kv, _, _ = self.prefill(jax_side)
        nxt = self.teacher[np.arange(B), self.lens]
        tail = np.stack([self.teacher[b, self.lens[b] - BL - 1: self.lens[b] + 1]
                         for b in range(B)]).astype(np.int32)
        act = np.array(active)
        if jax_side:
            tcfg = jdt.DraftTableConfig(buckets=64, ways=4, branch_length=BL,
                                        retrieve_count=BR)
            tables = jdt.init_draft_tables(tcfg)
            for b in range(B):
                s = self.teacher[b, :40]
                tables = jdt.update_tables_seq(tables, tcfg, jnp.asarray(s), jnp.int32(len(s)))
            return j_spec(self.jp, kv, tables, self.jc, tcfg, jnp.asarray(nxt),
                          jnp.asarray(self.lens), jnp.asarray(act), jnp.asarray(tail),
                          jnp.asarray(self.pt), n_steps=n_steps,
                          slot_ids=jnp.asarray(self.SLOTS),
                          teacher=jnp.asarray(self.teacher))
        tcfg = tdt.DraftTableConfig(buckets=64, ways=4, branch_length=BL, retrieve_count=BR)
        tables = tdt.init_draft_tables(tcfg, "cpu")
        for b in range(B):
            s = torch.from_numpy(self.teacher[b, :40])
            tdt.update_tables_seq(tables, tcfg, s, len(s))
        return t_spec(self.tp, kv, tables, self.tc, tcfg, torch.from_numpy(nxt),
                      torch.from_numpy(self.lens), torch.from_numpy(act),
                      torch.from_numpy(tail), torch.from_numpy(self.pt), n_steps=n_steps,
                      teacher=torch.from_numpy(self.teacher),
                      slot_ids=torch.from_numpy(self.SLOTS))


@pytest.fixture(scope="module")
def run(pair):
    return Run(*pair)


def test_prefill_matches_jax(run):
    jkv, jn, jl = run.prefill(True)
    tkv, tn, tl = run.prefill(False)
    close(tl, jl, 1e-4)
    assert (tn.numpy() == np.asarray(jn)).all()
    close(tkv["s"], np.asarray(jkv["s"]), 1e-4)
    assert not tkv["s"][:, 2].any()  # slot 2 holds no request


def test_greedy_decode_matches_jax(run):
    jkv, jn, _ = run.prefill(True)
    tkv, tn, _ = run.prefill(False)
    act = np.array([True, False])
    jr = j_decode(run.jp, jkv, run.jc, jn, jnp.asarray(run.lens), jnp.asarray(act),
                  jnp.asarray(run.pt), n_steps=10, slot_ids=jnp.asarray(run.SLOTS))
    s_before = tkv["s"][:, 0].clone()
    tr = t_decode(run.tp, tkv, run.tc, tn, torch.from_numpy(run.lens), torch.from_numpy(act),
                  torch.from_numpy(run.pt), n_steps=10, slot_ids=torch.from_numpy(run.SLOTS))
    assert (tr[1].numpy() == np.asarray(jr[1])).all()
    close(tr[0]["s"][:, 1], np.asarray(jr[0]["s"])[:, 1], 1e-4)
    assert torch.equal(tr[0]["s"][:, 0], s_before)  # the inactive row's slot


def test_lookahead_matches_jax(run):
    """Verify + commit over the window: the same tokens and accepted counts
    as the JAX package, states within tolerance; row 1 inactive."""
    jr = run.spec(True, 6, (True, False))
    tr = run.spec(False, 6, (True, False))
    assert (tr[2].numpy() == np.asarray(jr[2])).all()  # out tokens
    assert (tr[3].numpy() == np.asarray(jr[3])).all()  # accepted counts
    assert tr[3].max() > 2, "drafts never landed: no multi-token commit"
    close(tr[0]["s"][:, 1], np.asarray(jr[0]["s"])[:, 1], 1e-4)


def _teacher_forced_pair(run):
    """(teacher-forced lookahead kv, teacher-forced AR kv, tokens per row)
    over the same stream, each row's AR run as long as its lookahead run."""
    tr = run.spec(False, 6)
    n_tok = (tr[5] - torch.from_numpy(run.lens)).tolist()
    assert min(n_tok) > 6, "the lookahead run committed no multi-token chain"
    kv, _, _ = run.prefill(False)
    for b in range(B):  # AR row by row, each for its own count
        act = torch.tensor([i == b for i in range(B)])
        kv, *_ = t_decode(
            run.tp, kv, run.tc, torch.from_numpy(run.teacher[np.arange(B), run.lens]),
            torch.from_numpy(run.lens), act, torch.from_numpy(run.pt), n_steps=n_tok[b],
            teacher=torch.from_numpy(run.teacher), slot_ids=torch.from_numpy(run.SLOTS))
    return tr[0], kv, n_tok


def test_lookahead_state_equals_ar_bit_for_bit(pair):
    """Teacher-forced lookahead and teacher-forced AR over the same stream
    leave every linear layer's state with the same bits. Two plain CPU
    paths that the linear layers do not own give a row other bits in
    another batch: the attention oracle's einsum (a matrix-vector product
    at Q = 1) and torch's CPU sigmoid in the MoE router (its vectorised and
    scalar loops round differently). On the card K2, K10 and the router's
    elementwise ops give a row the same bits at every width, and
    tests/test_torch_gpu.py holds the whole hybrid (states and KV rows) to
    bit equality. Here the bit check runs on the model's linear layers with
    dense MLPs (``layer_group_size`` 0, no experts), and the hybrid as it
    is is held to 1e-6."""
    jc, tc, _, _ = pair
    lin = dataclasses.replace(tc, layer_group_size=0, num_experts=0, moe_layer_start=0)
    tp = t_init_params(lin, torch.Generator().manual_seed(1), device="cpu")
    la, ar, _ = _teacher_forced_pair(Run(jc, lin, None, tp))
    assert torch.equal(la["s"], ar["s"])
    la, ar, n_tok = _teacher_forced_pair(Run(*pair))
    close(la["s"], t2n(ar["s"]), 1e-6)
    run = Run(*pair)
    for b in range(B):
        ctx = int(run.lens[b]) + n_tok[b]
        pages = torch.from_numpy(run.pt[b, : -(-ctx // PAGE)]).long()
        for name in ("k", "v"):
            rows_ar = ar[name][:, pages].reshape(ar[name].shape[0], -1, ar[name].shape[-1])
            rows_la = la[name][:, pages].reshape(rows_ar.shape)
            close(rows_la[:, :ctx], t2n(rows_ar[:, :ctx]), 1e-6)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _serve(tc, tp, prompts, n=8, **kw):
    ecfg = tconfig.EngineConfig(**dict(dict(page_size=16, max_seq_len=256, max_concurrency=4,
                                            prefill_chunk=8, eos_token_id=-2), **kw))
    llm = TLLM(cfg=tc, params=tp, ecfg=ecfg, dtype=torch.float32, device="cpu")
    return [r.output_ids for r in llm.generate(prompts, TSamplingParams(max_new_tokens=n))], llm


def test_chunked_prefill_equals_tokenwise(pair):
    """(JAX test_chunked_recurrence_matches_tokenwise) one 8-token chunk
    against 8 decode steps, within the JAX test's 2e-4; and the engine's
    tokens with prefill chunks of 8 and of 2."""
    _, tc, _, tp = pair
    lp = tp["hybrid_layers"][0]
    H, D = tc.num_attention_heads, tc.head_dim
    h = torch.from_numpy(_rand(np.random.default_rng(0), 1, 8, tc.hidden_size))
    s_chunk = torch.zeros(1, H, D, D)
    out_chunk, _ = tla.linear_attn_block(lp, tc, None, h, s_chunk, torch.tensor([8]))
    s_tok = torch.zeros(1, H, D, D)
    outs = [tla.linear_attn_block(lp, tc, None, h[:, t:t + 1], s_tok, torch.tensor([1]))[0]
            for t in range(8)]
    close(out_chunk, t2n(torch.cat(outs, dim=1)), 2e-4)
    close(s_chunk, t2n(s_tok), 2e-4)
    a, _ = _serve(tc, tp, [[5, 6, 7, 8, 9, 10]], 10, prefill_chunk=8)
    b, _ = _serve(tc, tp, [[5, 6, 7, 8, 9, 10]], 10, prefill_chunk=2)
    assert a == b


def test_padded_chunk_state_invariant(pair):
    """(JAX test_padded_chunk_state_invariant) padding does not touch the
    state: here bit for bit, the padded tokens are never read."""
    _, tc, _, tp = pair
    lp = tp["hybrid_layers"][0]
    H, D = tc.num_attention_heads, tc.head_dim
    h5 = torch.from_numpy(_rand(np.random.default_rng(1), 1, 5, tc.hidden_size))
    h8 = torch.cat([h5, torch.ones(1, 3, tc.hidden_size)], dim=1)
    sa, sb = torch.zeros(1, H, D, D), torch.zeros(1, H, D, D)
    oa, _ = tla.linear_attn_block(lp, tc, None, h5, sa, torch.tensor([5]))
    ob, _ = tla.linear_attn_block(lp, tc, None, h8, sb, torch.tensor([5]))
    assert torch.equal(sa, sb) and torch.equal(oa, ob[:, :5])


def test_batch_slots_isolated(pair):
    """(JAX test_hybrid_batch_slots_isolated) two concurrent requests equal
    each served alone."""
    _, tc, _, tp = pair
    outs, _ = _serve(tc, tp, [[5, 6, 7], [100, 101, 102]])
    assert outs[0] == _serve(tc, tp, [[5, 6, 7]])[0][0]
    assert outs[1] == _serve(tc, tp, [[100, 101, 102]])[0][0]


def test_spec_decode_lossless(pair):
    """(JAX test_hybrid_spec_decode_lossless) lookahead emits the greedy
    stream bit for bit, with spec steps taken."""
    _, tc, _, tp = pair
    prompt = [3, 4, 5, 3, 4, 5, 3, 4, 5]
    ref, _ = _serve(tc, tp, [prompt], 64)
    out, llm = _serve(tc, tp, [prompt], 64, use_lookahead=True,
                      decoding_length=12, branch_length=6, use_spec_min_batch_size=4)
    assert out == ref
    assert llm.metrics.spec_steps > 0


def test_reused_slot_starts_from_an_empty_state(pair):
    """A request that takes a slot another request used is served as if
    alone. (The JAX LLM never resets a slot's state, so there the second
    request starts from the first one's; the port does not copy that.)"""
    _, tc, _, tp = pair
    seq, _ = _serve(tc, tp, [[5, 6, 7], [100, 101, 102]], max_concurrency=1)
    assert seq[1] == _serve(tc, tp, [[100, 101, 102]], max_concurrency=1)[0][0]


def test_shared_prefix_is_not_skipped(pair):
    """A prompt sharing a 32-token prefix with an earlier one is served as
    if alone, with 0 prefix hit tokens: the states hold no prefix. (The JAX
    LLM matches the prefix and prefills only the rest, so there the states
    miss the prefix's tokens.)"""
    _, tc, _, tp = pair
    prefix = list(range(20, 52))
    prompts = [prefix + [60, 61], prefix + [70, 71, 72]]
    outs, llm = _serve(tc, tp, prompts, max_concurrency=1, prefill_chunk=16)
    assert llm.metrics.prefix_hit_tokens == 0 and llm.prefix_cache is None
    assert outs[1] == _serve(tc, tp, [prompts[1]], max_concurrency=1, prefill_chunk=16)[0][0]


@pytest.mark.parametrize("lookahead", [False, True], ids=["ar", "lookahead"])
def test_preempted_request_replays_by_decode(pair, lookahead):
    """On an arena of 4 pages for three requests the youngest is preempted,
    re-prefills its prompt alone and regenerates its outputs by decode (which
    raises if they differ): every request gets the tokens it gets with room.
    Under AR each also finishes with the same state bits. Replaying the
    outputs through chunked prefill, as the JAX LLM does, sums them in the
    chunk form's order instead of the per-token step's, and the states
    differ. Every batch is padded to 4 rows, so that no CPU matmul changes
    its blocking between the runs. (Lookahead commits past a request's last
    token, so its final states are not compared. Its verify width is 5: a
    width whose windows fit no row's pages decodes by AR instead of
    preempting, test_tiny_arena_lookahead_finishes; at 5 the run has verify
    steps and a preemption.)"""
    _, tc, _, tp = pair
    prompts = [[7, 8, 9, 10, 11], [100, 200, 250], [42, 43, 44, 45]]
    spec = dict(use_lookahead=True, decoding_length=4, branch_length=6,
                use_spec_min_batch_size=4) if lookahead else {}
    runs = []
    for pages in (64, 5):
        ecfg = tconfig.EngineConfig(page_size=8, max_seq_len=256,
                                    max_concurrency=4, decode_buckets=(4,), num_pages=pages,
                                    prefill_chunk=8, eos_token_id=-2, **spec)
        llm = TLLM(cfg=tc, params=tp, ecfg=ecfg, dtype=torch.float32, device="cpu")
        states, finish = {}, llm._finish

        def keep(req, reason, llm=llm, states=states, finish=finish):
            states[req.rid] = llm.kv["s"][:, req.slot].clone()
            finish(req, reason)
        llm._finish = keep
        outs = [r.output_ids for r in llm.generate(prompts, TSamplingParams(max_new_tokens=16))]
        runs.append((outs, states, llm.metrics.preempted))
        assert llm.metrics.spec_steps > 0 or not lookahead
    (ref, ref_s, n0), (outs, got_s, n1) = runs
    assert n0 == 0 and n1 > 0
    assert outs == ref
    if not lookahead:
        assert all(torch.equal(got_s[r], ref_s[r]) for r in ref_s)


def test_tiny_arena_lookahead_finishes(pair):
    """Lookahead on 4 usable pages of 8 rows for three requests (verify
    width 13) preempted forever, as the JAX engine does (ROADMAP §C); the
    port now decodes a burst whose verify windows fit no row by AR. Tokens
    equal the run with room, within a bound on scheduler iterations."""
    _, tc, _, tp = pair
    prompts = [[7, 8, 9, 10, 11], [100, 200, 250], [42, 43, 44, 45]]
    outs = []
    for pages in (64, 5):
        ecfg = tconfig.EngineConfig(page_size=8, max_seq_len=256, max_concurrency=4,
                                    decode_buckets=(4,), num_pages=pages, prefill_chunk=8,
                                    eos_token_id=-2, use_lookahead=True, decoding_length=12,
                                    branch_length=6, use_spec_min_batch_size=4)
        llm = TLLM(cfg=tc, params=tp, ecfg=ecfg, dtype=torch.float32, device="cpu")
        reqs = [llm.add_request(p, TSamplingParams(max_new_tokens=16)) for p in prompts]
        for _ in range(200):
            if all(r.finish_reason for r in reqs):
                break
            llm.step()
        assert all(r.finish_reason for r in reqs), "unfinished after 200 scheduler steps"
        outs.append([r.output_ids for r in reqs])
    assert outs[1] == outs[0]


def test_reset_linear_states_and_arena_layout(pair):
    jc, tc, _, _ = pair
    te = tconfig.EngineConfig(page_size=16, max_seq_len=64, max_concurrency=3)
    kv = t_init_kv(tc, te, dtype=torch.float32, device="cpu")
    jkv = j_init_kv(jc, jconfig.EngineConfig(page_size=16, max_seq_len=64,
                                             max_concurrency=3), dtype=jnp.float32)
    assert {k: tuple(v.shape) for k, v in kv.items()} == {
        k: tuple(v.shape) for k, v in jkv.items()}
    assert kv["s"].dtype == torch.float32
    assert kv_bytes_per_page(tc, te, torch.bfloat16) == (
        (tc.num_hidden_layers - tla.n_linear_layers(tc)) * 16 * tc.num_key_value_heads
        * tc.head_dim * 2 * 2)
    kv["s"].fill_(1.0)
    reset_linear_states(kv, [2, 0])
    assert not kv["s"][:, [0, 2]].any() and kv["s"][:, 1].eq(1.0).all()
    with pytest.raises(ValueError, match="e4m3"):
        t_init_kv(tc, dataclasses.replace(te, kv_quant="fp8"), device="cpu")


def test_init_hybrid_params_tree_matches_jax(pair):
    jc, tc, jp, _ = pair
    tp = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert len(tp["hybrid_layers"]) == len(jp["hybrid_layers"])
    for jl, tl in zip(jp["hybrid_layers"], tp["hybrid_layers"]):
        assert {k: tuple(np.shape(v)) for k, v in jax.tree.map(np.asarray, jl).items()
                if not isinstance(v, dict)} == {
            k: tuple(v.shape) for k, v in tl.items() if not isinstance(v, dict)}
    assert set(tp) == set(jp)


def test_hybrid_params_need_the_flag(pair):
    _, tc, _, tp = pair
    plain = dataclasses.replace(tc, linear_attention=False, model_type="llama")
    with pytest.raises(ValueError, match="hybrid_layers"):
        t_hidden(tp, plain, {}, torch.zeros(1, 1, dtype=torch.int32),
                 torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), torch.ones(1, 1, 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="linear_attention"):
        t_init_params(dataclasses.replace(tc, linear_attention=False),
                      torch.Generator().manual_seed(0), device="cpu")
