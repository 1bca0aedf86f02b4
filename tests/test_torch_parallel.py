"""The port's parallel modules against the JAX package, on the CPU.

- Placement: every leaf of every family (dense, MoE, MLA-latent, hybrid)
  and of the quantized modes gets the class of the JAX package's
  ``param_shardings`` / ``kv_shardings`` (col, row, expert, heads, pages,
  replicated), but for the differences on purpose (a replicated embedding;
  a linear layer's ``out_norm`` / ``decay`` and the per-token scales follow
  their heads).
- Round trip: the ranks' shards put back together give every leaf bit for
  bit, the uneven group split included (11 int4 groups over 4 ranks).
- Serving: real processes over gloo (``tests/torch_dist_worker.py``), a
  group of 2 ranks started once for the module (4 ranks:
  ``tests/test_torch_parallel4.py``), serve tiny fp32 models through
  ``DistLLM`` under TP (1, 2), DP (2, 1) with mix and timely, EP, CP (pages that straddle the
  ranks), the MoE, MLA-latent and hybrid families and the three schedule
  policies (lockstep: every rank checks the others' tokens after each
  step): greedy and lookahead tokens equal the JAX single-device ``LLM``'s,
  first-step logits within 1e-4 of the JAX prefill's, and EP's MoE block
  bit-equal to the one-process ``expert_shards(2)``. Also the layouts the
  JAX package serves beyond those: CP for MLA (latent and expanded) and
  for a hybrid, DP for a hybrid (its recurrent states bit-equal on both
  ranks after every step) and for multimodal requests, EP for W8A8
  experts, TP-mode MoE with W8A8 experts (each rank's quantized expert
  activations bit-equal to one process's columns: the whole row's amax).
- Context-parallel attention: the ranks' partials merged against JAX's
  ``cp_paged_attention`` within 1e-5 in fp32, with GQA and with a row that
  has no local key; MLA's latent partials (K13's plain twin over each
  rank's pages) merged against the JAX package's MLA attention.
- ``lcm(16, axis)`` page rounding at an axis of 3.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu.config import EngineConfig as JEngineConfig
from painlessinferenceacceleration_tpu.config import ModelConfig as JModelConfig
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.parallel import mesh as jmesh

import _parallel_cases as pc
from _parallel_cases import DENSE
from _torch_dist import Ranks
from painlessinferenceacceleration_tpu_torch.config import EngineConfig as TEngineConfig
from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.models.base import init_params as t_init_params
from painlessinferenceacceleration_tpu_torch.parallel import mesh as tmesh
from painlessinferenceacceleration_tpu_torch.parallel.multihost import choose_backend

_cfgs, _jparams, _tparams = pc.cfgs, pc.jparams, pc.tparams


# ---------------------------------------------------------------------------
# placement and round trip
# ---------------------------------------------------------------------------


def _jclass(spec) -> str:
    """A JAX PartitionSpec's placement class: where 'model' stands, counted
    from the end."""
    spec = tuple(spec)
    if "model" not in spec:
        return "replicated"
    return {1: "col", 2: "row", 3: "expert"}[len(spec) - spec.index("model")]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


ON_PURPOSE = ("/embed", "/out_norm", "/decay")

QUANT_MODES = ("int4", "int8", "w8a8_int8", "fp8_block")


@pytest.mark.parametrize("kind", ["dense", "moe", "mla", "hybrid", "ep"] +
                         [f"dense:{m}" for m in QUANT_MODES])
def test_placement_classes_match_jax(kind):
    fam, _, mode = kind.partition(":")
    jc, tc = _cfgs(fam)
    if mode:  # widths of whole 128-blocks (4 of them in I and V) for block fp8
        over = dict(DENSE, hidden_size=256, intermediate_size=512, vocab_size=512)
        jc, tc = JModelConfig.tiny(**over), TModelConfig.tiny(**over)
    from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec

    jq = JQuantSpec.from_mode(mode, 32) if mode else None
    # the placements read the leaves' shapes only: JAX's tree by eval_shape,
    # the port's from its own init (the same tree)
    jp = jax.eval_shape(lambda: _jparams(jc, quant=jq))
    tq = TQuantSpec.from_mode(mode, 32) if mode else None
    if fam == "hybrid":
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            init_hybrid_params,
        )

        tp = init_hybrid_params(tc, torch.Generator().manual_seed(0), torch.float32, "cpu")
    else:
        tp = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu", quant=tq)
    jm = jmesh.make_mesh((1, 4), devices=jax.devices()[:4])
    tm = tmesh.Mesh((1, 4), ("data", "model"), 0)
    want = dict(_flat(jmesh.param_shardings(jc, jm, jp),))
    got = dict(_flat(tmesh.param_shardings(tc, tm, tp)))
    assert set(want) == set(got)
    differ = {k for k in want if _jclass(want[k]) != got[k]}
    assert all(k.endswith(ON_PURPOSE) or "/embed/" in k for k in differ), sorted(differ)
    assert all(got[k] == "replicated" for k in got if k.startswith("/embed"))
    jkv = j_init_kv(jc, JEngineConfig(page_size=16, max_seq_len=64, max_concurrency=2),
                    dtype=jnp.float32)
    tkv = t_init_kv(tc, TEngineConfig(page_size=16, max_seq_len=64, max_concurrency=2),
                    dtype=torch.float32, device="cpu")
    jk, tk = jmesh.kv_shardings(jc, jm, jkv), tmesh.kv_shardings(tc, tm, tkv)
    for name in tk:
        assert {"col": "heads", "expert": "heads"}.get(_jclass(jk[name]),
                                                       _jclass(jk[name])) == tk[name], name


def _unshard(shards, leaf_name, whole, plan, cfg, unit=1):
    """Put the ranks' shards of one leaf back together (the inverse of
    ``shard_params``) for the check; ``unit``: columns a scale column covers
    (128 for block-fp8 scales)."""
    if isinstance(whole, dict):
        block = whole["s"].dim() == whole["q"].dim() and whole["s"].shape[-1] != \
            whole["q"].shape[-1]
        return {k: (_unshard([s[k] for s in shards], leaf_name, v, plan, cfg,
                             128 if k == "s" and block else 1)
                    if k in ("q", "s") else shards[0][k]) for k, v in whole.items()}
    if all(torch.equal(s, whole) for s in shards) and all(s.shape == whole.shape
                                                          for s in shards):
        return shards[0]
    if leaf_name in ("moe_wgu", "moe_wdown") and plan.experts is not None:
        return torch.cat(shards, dim=-3)
    if leaf_name in ("wdown", "moe_wdown", "shared_wdown", "wo"):
        return torch.cat(shards, dim=-2)
    if leaf_name in ("wgu", "bgu", "moe_wgu", "shared_wgu"):  # [gate | up] a rank
        halves = [s.chunk(2, dim=-1) for s in shards]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=-1)
    if leaf_name in ("wqkv", "bqkv") and cfg.num_key_value_heads != cfg.num_attention_heads:
        D = cfg.head_dim // unit
        parts = []
        for r, s in enumerate(shards):
            (h0, h1), (k0, k1) = plan.q_heads[r], plan.kv_heads[r]
            parts.append(s.split([(h1 - h0) * D, (k1 - k0) * D, (k1 - k0) * D], dim=-1))
        return torch.cat([p[i] for i in range(3) for p in parts], dim=-1)
    if leaf_name in ("wqkv",):  # a linear layer's [q | k | v], H heads each
        parts = [s.chunk(3, dim=-1) for s in shards]
        return torch.cat([p[i] for i in range(3) for p in parts], dim=-1)
    return torch.cat(shards, dim=-1)


@pytest.mark.parametrize("kind,mode,tp", [
    ("dense", "", 2), ("dense", "int4", 4), ("dense", "int8", 2), ("dense", "w8a8_int8", 2),
    ("dense", "fp8_block", 2), ("moe", "", 2), ("mla", "", 4), ("hybrid", "", 2),
    ("ep", "", 4)])
def test_shards_round_trip(kind, mode, tp):
    """Every leaf, put back together from the ranks' shards, has its bits;
    dense int4 at tp = 4 splits 11 groups of 32 as 3, 3, 3, 2 (rows 96, 96,
    96, 64)."""
    jc, tc = _cfgs(kind)
    if kind == "dense":
        over = dict(DENSE, hidden_size=256, intermediate_size=352 if mode == "int4" else 256,
                    vocab_size=256)
        if mode == "fp8_block":  # head dim 128: a rank's heads are whole 128-blocks
            over = dict(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                        intermediate_size=512, vocab_size=256)
        tc = TModelConfig.tiny(**over)
    spec = TQuantSpec.from_mode(mode, 32) if mode else None
    if kind == "hybrid":
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            init_hybrid_params,
        )

        params = init_hybrid_params(tc, torch.Generator().manual_seed(0), torch.float32, "cpu")
    else:
        params = t_init_params(tc, torch.Generator().manual_seed(0), device="cpu", quant=spec)
    plan = tmesh.plan_shards(tc, tp, params)
    assert plan.attn == "split"
    if mode == "int4":
        assert [b - a for a, b in plan.mlp] == [96, 96, 96, 64]
    m = tmesh.Mesh((1, tp), ("data", "model"), 0)
    shards = [tmesh.shard_params(params, tc, m, rank=r) for r in range(tp)]

    def check(whole, parts, name, where):
        got = _unshard(parts, name, whole, plan, tc)
        for k, w in (whole.items() if isinstance(whole, dict) else [("", whole)]):
            g = got[k] if k else got
            assert g.dtype == w.dtype and torch.equal(g, w), (where, name, k)

    for top, sub in params.items():
        if top in ("layers", "moe_layers"):
            for name, leaf in sub.items():
                check(leaf, [sh[top][name] for sh in shards], name, top)
        elif top == "hybrid_layers":
            for i, lp in enumerate(sub):
                for name, leaf in lp.items():
                    check(leaf, [sh[top][i][name] for sh in shards], name, f"{top}[{i}]")
        else:
            check(sub, [sh[top] for sh in shards], top, top)


def test_kv_shards_round_trip():
    """The arena's KV heads (and the static scales') and, under context
    parallelism, its pages behind each rank's local null page."""
    tc = TModelConfig.tiny(**DENSE)
    ecfg = TEngineConfig(page_size=16, max_seq_len=64, max_concurrency=2, num_pages=16,
                         kv_quant="fp8")
    kv = t_init_kv(tc, ecfg, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    kv = {k: (torch.randn(v.shape, generator=g) * 50).to(v.dtype) for k, v in kv.items()}
    m = tmesh.Mesh((1, 4), ("data", "model"), 0)
    parts = [tmesh.shard_kv(kv, tc, m, rank=r) for r in range(4)]
    for k in kv:
        cat = torch.cat([p[k] for p in parts], dim=-1)
        assert torch.equal(cat.view(torch.uint8), kv[k].view(torch.uint8)), k
    cp = dataclasses.replace(tc, context_parallel=True)
    kv2 = {k: kv[k] for k in ("k", "v")}
    parts = [tmesh.shard_kv(kv2, cp, m, rank=r) for r in range(4)]
    for k in ("k", "v"):
        assert all(p[k].shape[1] == 16 // 4 + 1 for p in parts)
        cat = torch.cat([p[k][:, 1:] for p in parts], dim=1)
        assert torch.equal(cat.view(torch.uint8), kv2[k].view(torch.uint8))


def test_cp_pages_round_to_lcm_of_16_and_the_axis():
    """At a model axis of 3 the port rounds the page count once, to a
    multiple of lcm(16, 3) = 48; the JAX package's 16-multiple is not a
    multiple of 3 (its DistLLM rounds a second time)."""
    e = TEngineConfig(page_size=16, max_seq_len=64, max_concurrency=12,
                      context_parallel=True, mesh_shape=(1, 3))
    assert e.num_pages % 48 == 0 and e.num_pages >= 12 * 4 + 1
    assert TEngineConfig(num_pages=50, context_parallel=True, mesh_shape=(1, 3)).num_pages == 96
    assert TEngineConfig(num_pages=50, context_parallel=True).num_pages == 64
    j = JEngineConfig(num_pages=50, context_parallel=True)
    assert j.num_pages == 64 and j.num_pages % 3  # the JAX package's first rounding
    assert [tmesh.cp_pages(96, 3, r) for r in range(3)] == [(0, 32), (32, 64), (64, 96)]


def test_backend_rule_and_rank_grids():
    """gloo on the CPU and where ranks share a card; with no process group
    joined, one rank: make_mesh's (1, 1) grid and make_multihost_mesh's
    (dcn, data, model) grid, with no axis group."""
    from painlessinferenceacceleration_tpu_torch.parallel.multihost import make_multihost_mesh

    assert choose_backend("cpu", 4)[0] == "gloo"
    n = torch.cuda.device_count()
    assert choose_backend("cuda", n + 1)[0] == "gloo"  # ranks would share a card
    m = tmesh.make_mesh()
    assert (m.tp, m.dp, m.model_group, m.data_group) == (1, 1, None, None)
    m3 = make_multihost_mesh()
    assert m3.shape == {"dcn": 1, "data": 1, "model": 1} and m3.tp == 1
    with pytest.raises(ValueError):
        tmesh.make_mesh((1, 2))  # two ranks asked of one


def test_backend_rule_counts_the_cards_of_each_host(monkeypatch):
    """Two hosts of two cards running four ranks: each host's two ranks have
    a card each, so NCCL, and rank 3 (host 1's second) takes cuda:1; the same
    four ranks on one host share its two cards, so gloo."""
    from painlessinferenceacceleration_tpu_torch.parallel.multihost import local_device

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert choose_backend("cuda", 4, num_hosts=2)[0] == "nccl"
    assert choose_backend("cuda", 4, num_hosts=1)[0] == "gloo"
    monkeypatch.setenv("PIA_NUM_HOSTS", "2")
    assert choose_backend("cuda", 4)[0] == "nccl"
    assert [local_device("cuda", r, 4).index for r in range(4)] == [0, 1, 0, 1]
    with pytest.raises(ValueError):
        choose_backend("cuda", 3)  # three ranks do not split over two hosts


# ---------------------------------------------------------------------------
# context-parallel attention against JAX's cp_paged_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,Hq,Hk,Q", [(2, 4, 4, 1), (4, 8, 2, 5), (2, 8, 2, 3)])
def test_cp_attention_matches_jax(n, Hq, Hk, Q):
    """Each rank's partial (the plain twin of K2 over its pages, with the
    log-sum-exp) merged in rank order, against JAX's ``cp_paged_attention``
    over an n-way mesh: within 1e-5 in fp32. Row 1's context lies on rank
    0's pages only, so the other ranks see no local key for its prefix."""
    from painlessinferenceacceleration_tpu.ops.cp_attention import (
        cp_paged_attention,
        shard_kv_pages_cp,
    )

    from painlessinferenceacceleration_tpu_torch.ops.cp_attention import (
        cp_partial,
        local_page_table,
        merge_partials,
    )

    rng = np.random.default_rng(n + Hq + Q)
    D, ps, B, n_pages = 16, 16, 2, 24
    per = n_pages // n
    k = rng.normal(size=(n_pages, ps, Hk * D)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, Hk * D)).astype(np.float32)
    # row 0 straddles every rank; row 1 sits on rank 0's pages 1, 2
    pt = np.zeros((B, 8), np.int32)
    pt[0] = [1, per + 1, n_pages - 1, per - 1, 2 if n == 2 else 2 * per, 3, 0, 0]
    pt[1, :2] = [4, 5]
    ctx = np.array([70, 20], np.int32)
    q = rng.normal(size=(B, Q, Hq, D)).astype(np.float32)
    i = np.arange(Q)
    qm = np.broadcast_to(i[:, None] >= i[None, :], (B, Q, Q)).copy()
    mesh = jmesh.make_mesh((1, n), devices=jax.devices()[:n])
    jkv = shard_kv_pages_cp({"k": jnp.asarray(k), "v": jnp.asarray(v)}, mesh)
    jcp = jax.jit(functools.partial(cp_paged_attention, scale=D ** -0.5, mesh=mesh))
    want = np.asarray(jcp(jnp.asarray(q), jkv["k"], jkv["v"], jnp.asarray(pt),
                          jnp.asarray(ctx), jnp.asarray(qm)))
    outs, lses = [], []
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for r in range(n):
        lo = r * per
        kl = torch.cat([torch.zeros_like(tk[:1]), tk[lo:lo + per]])
        vl = torch.cat([torch.zeros_like(tv[:1]), tv[lo:lo + per]])
        o, lse = cp_partial(torch.from_numpy(q), kl, vl,
                            local_page_table(torch.from_numpy(pt), lo, lo + per),
                            torch.from_numpy(ctx), torch.from_numpy(qm), D ** -0.5, False,
                            (1, per + 1))
        if r > 0:
            assert torch.isneginf(lse[1]).all() and (o[1] == 0).all()
        outs.append(o)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,Q", [(2, 1), (4, 5), (2, 3)])
def test_cp_mla_latent_attention_matches_jax(n, Q):
    """MLA's latent partials: each rank's K13 plain twin over its pages of
    the latent arena (one shared [latent | rope] row a token, the value its
    first lanes), with the log-sum-exp, merged in rank order, against the
    JAX package's single-device MLA attention (its Pallas body in interpret
    mode) on the same pages: within 1e-5 in fp32. Row 1's context lies on
    rank 0's pages only, so the other ranks see no local key for it; the
    one-process oracle (``cp_attention_oracle``) gives the merge's bits."""
    from painlessinferenceacceleration_tpu.ops.mla_attention import (
        mla_paged_attention as j_mla_attn,
    )

    from painlessinferenceacceleration_tpu_torch.ops.cp_attention import (
        cp_attention_oracle,
        cp_partial,
        local_page_table,
        merge_partials,
    )

    rng = np.random.default_rng(10 * n + Q)
    r, rope_d, H, ps, B, n_pages = 32, 16, 4, 16, 2, 24
    Dk, per = r + rope_d, n_pages // n
    k = rng.normal(size=(n_pages, ps, Dk)).astype(np.float32)
    pt = np.zeros((B, 8), np.int32)
    pt[0] = [1, per + 1, n_pages - 1, per - 1, 2 if n == 2 else 2 * per, 3, 0, 0]
    pt[1, :2] = [4, 5]
    ctx = np.array([70, 20], np.int32)
    q = rng.normal(size=(B, Q, H, Dk)).astype(np.float32)
    i = np.arange(Q)
    qm = np.broadcast_to(i[:, None] >= i[None, :], (B, Q, Q)).copy()
    scale = Dk ** -0.5
    want = np.asarray(j_mla_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pt),
                                 jnp.asarray(ctx), jnp.asarray(qm), scale, v_dim=r,
                                 interpret=True))
    tq, tk, tpt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pt)
    tctx, tqm = torch.from_numpy(ctx), torch.from_numpy(qm)
    outs, lses = [], []
    for d in range(n):
        lo = d * per
        kl = torch.cat([torch.zeros_like(tk[:1]), tk[lo:lo + per]])
        o, lse = cp_partial(tq, kl, kl[..., :r], local_page_table(tpt, lo, lo + per), tctx,
                            tqm, scale, False, (1, per + 1), r)
        if d > 0:
            assert torch.isneginf(lse[1]).all() and (o[1] == 0).all()
        outs.append(o)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    orc = cp_attention_oracle(tq, tk, tk[..., :r], tpt, tctx, tqm, False, scale, n, r)
    assert torch.equal(orc, got)


# ---------------------------------------------------------------------------
# serving over real processes (2 ranks; 4 ranks in test_torch_parallel4.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Start the 2-rank group, then compute the JAX references while it
    runs. Returns (each rank's results, JAX tokens and logits by family)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    both = {f: pc.port_params(f) for f in ("dense", "moe", "mla", "mla_x", "hybrid")}
    both["ep_w8a8"] = pc.port_params("ep", quant="w8a8_int8")
    both["moe_w8a8"] = pc.port_params("moe_q", quant="w8a8_int8")
    tps = {f: p[0] for f, p in both.items()}
    tps["ep"] = tps["moe"]  # the same draw: expert_parallel changes no weight
    look, case = pc.LOOK, pc.case
    cp = dict(look, context_parallel=True, num_pages=16, page_size=8)
    mm = pc.mm_requests(pc.cfgs("dense")[1].hidden_size)
    ranks = Ranks(2, [
        case("tp_la", "dense", tps["dense"], (1, 2), 2, look, logits=True),
        case("cp", "dense", tps["dense"], (1, 2), 2,
             dict(look, context_parallel=True, num_pages=16, page_size=8), logits=True,
             cp_oracle=True),
        case("moe_tp", "moe", tps["moe"], (1, 2), 2, look, logits=True),
        case("ep", "ep", tps["ep"], (1, 2), 2, look, ep_block=True),
        case("mla_tp", "mla", tps["mla"], (1, 2), 2, look, logits=True),
        case("hybrid_tp", "hybrid", tps["hybrid"], (1, 2), 2, look, logits=True),
        case("mix", "dense", tps["dense"], (2, 1), 2, dict(look, schedule_policy="mix")),
        case("timely", "dense", tps["dense"], (2, 1), 2, dict(look, schedule_policy="timely")),
        case("mla_cp", "mla", tps["mla"], (1, 2), 2, cp, logits=True, cp_oracle=True),
        case("mla_x_cp", "mla_x", tps["mla_x"], (1, 2), 2, cp, logits=True, cp_oracle=True),
        case("hybrid_cp", "hybrid", tps["hybrid"], (1, 2), 2, cp, logits=True,
             cp_oracle=True, state_hashes=True),
        case("hybrid_dp", "hybrid", tps["hybrid"], (2, 1), 2, look, logits=True,
             state_hashes=True),
        case("mm_dp", "dense", tps["dense"], (2, 1), 2, look, mm=mm),
        case("ep_w8a8", "ep", tps["ep_w8a8"], (1, 2), 2, dict(look, quant="w8a8_int8"),
             logits=True, ep_block=True),
        case("moe_tp_w8a8", "moe_q", tps["moe_w8a8"], (1, 2), 2,
             dict(look, quant="w8a8_int8"), logits=True, tp_quant=True),
    ], tmp)
    refs = {f: pc.jax_reference(f, both[f][1])
            for f in ("dense", "moe", "mla", "mla_x", "hybrid")}
    refs["ep"] = refs["moe"]
    refs["ep_w8a8"] = pc.jax_reference("ep", both["ep_w8a8"][1], quant="w8a8_int8")
    refs["moe_w8a8"] = pc.jax_reference("moe_q", both["moe_w8a8"][1], quant="w8a8_int8")
    refs["mm"] = pc.jax_reference("dense", both["dense"][1], mm=mm)
    return ranks.results(), refs


CASES = [("tp_la", "dense"), ("cp", "dense"), ("moe_tp", "moe"), ("ep", "ep"),
         ("mla_tp", "mla"), ("hybrid_tp", "hybrid"), ("mix", "dense"),
         ("timely", "dense"), ("mla_cp", "mla"), ("mla_x_cp", "mla_x"),
         ("hybrid_cp", "hybrid"), ("hybrid_dp", "hybrid"), ("mm_dp", "mm"),
         ("ep_w8a8", "ep_w8a8"), ("moe_tp_w8a8", "moe_w8a8")]


@pytest.mark.parametrize("name,fam", CASES, ids=[c[0] for c in CASES])
def test_dist_llm_tokens_match_jax(served, name, fam):
    """Two ranks over gloo: every rank's greedy and lookahead tokens equal
    the JAX single-device LLM's (lookahead is lossless in both packages),
    its first-step logits are within 1e-4 of the JAX prefill's, and EP's
    MoE block is bit-equal to the one-process ``expert_shards(2)``. Under
    context parallelism each rank holds its 8 pages behind its null page,
    the requests' pages straddle both ranks, and the ranks' arenas put
    together equal, bit for bit, the arena of the one-process oracle
    ``cp_oracle_attention(2)``, which serves the same tokens (MLA's latent
    and expanded arenas, a hybrid's full layers and its recurrent states
    too). A hybrid's states have the same bits on both ranks after every
    step, under CP and under DP (each data group its own rows' slots)."""
    res, refs = served
    pc.check_case(res, name, *refs[fam])
    if "cp" in name.split("_"):
        assert res[0][name]["kv_pages"] == 16 // 2 + 1
        assert min(res[0][name]["pages_on_ranks"]) > 0  # both ranks hold live pages
        for r in res:  # the one-process oracle (cp_oracle_attention(2)): tokens, arena
            assert r[name]["cp_oracle_tokens_equal"] and r[name]["cp_arena_equal"]
    if "state_hashes" in res[0][name]:
        assert len(res[0][name]["state_hashes"]) > 0
        assert res[0][name]["state_hashes"] == res[1][name]["state_hashes"], name
    assert res[0][name]["spec_steps"] > 0, name
