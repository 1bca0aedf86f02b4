"""The port's sampler and sampled decode loops against the JAX package, on
the CPU.

``filtered_logits`` equals the JAX package's over a grid of (temperature,
top_k, top_p, min_p), bit for bit, except at entries whose place is
decided by rounding: within 1e-6 of the nucleus cutoff (the excluded
cumulative probability against top_p) or of the min-p cutoff (exp(x - max)
against min_p); ``apply_repetition_penalty`` is exact; ``target_logprobs``
within 1e-5 and ``apply_qk_rope`` within 1e-6. JAX's threefry noise cannot
be reproduced in torch, so the draws are held to their own rules: a draw
is a pure function of (seed, position, logits row), the same bits at any
place in any batch, always inside the filter, and distributed as the
softmax of JAX's filtered logits (a chi-square test of 20 000 draws at
p > 1e-3). The loops: greedy with a repetition penalty gives JAX's tokens;
the sampled lookahead stream equals the sampled AR stream with drafts
landing; the per-step adaptive gate gives JAX's stream and ``wide_mask``.
"""

import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu import config as jcfg_mod
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.multistep import (
    multistep_decode as j_decode,
    multistep_spec_decode as j_spec,
)
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.lookahead import device_tables as jdt
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params
from painlessinferenceacceleration_tpu.ops import rope as jrope
from painlessinferenceacceleration_tpu.ops import sample as jsample

from painlessinferenceacceleration_tpu_torch import config as tcfg_mod
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.multistep import (
    multistep_decode as t_decode,
    multistep_spec_decode as t_spec,
)
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as tdt
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.ops import rope as trope
from painlessinferenceacceleration_tpu_torch.ops import sample as tsample

V = 512
NEG_CUT = -1e29


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs. Its engine runs are
    thousands of tiny ops; beside a parallel run's other workers, a pool of
    threads per op spends most of their time waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits(B, seed=0, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(B, V)) * scale).astype(np.float32)


def _arrays(B, t, k, p, m):
    return (np.full(B, t, np.float32), np.full(B, k, np.int32), np.full(B, p, np.float32),
            np.full(B, m, np.float32))


def _undecided(lg, t, k, p, m):
    """Entries whose place in the filter rounding decides: within 1e-6 of
    the nucleus cutoff or of the min-p cutoff (fp64 reference)."""
    x = lg.astype(np.float64) / max(t, 1e-6)
    order = np.argsort(-x, axis=1, kind="stable")
    xs = np.take_along_axis(x, order, 1)
    k_eff = k if k > 0 else V
    kept = np.arange(V)[None] < k_eff
    e = np.where(kept, np.exp(xs - xs[:, :1]), 0.0)
    prob = e / e.sum(1, keepdims=True)
    excl = np.cumsum(prob, 1) - prob
    near = np.zeros_like(x, bool)
    np.put_along_axis(near, order, kept & (np.abs(excl - p) <= 1e-6), 1)
    if m > 0:
        near |= np.abs(np.exp(x - xs[:, :1]) - m) <= 1e-6
    return near


GRID = [(1.0, 0, 1.0, 0.0), (0.8, 50, 0.95, 0.0), (0.5, 0, 0.9, 0.05),
        (1.3, 10, 0.5, 0.1), (1.0, 600, 0.99, 0.0), (0.7, 1, 1.0, 0.0),
        (2.0, 0, 0.3, 0.0), (1.0, 20, 1.0, 0.2), (0.9, 0, 0.0, 0.0)]


@pytest.mark.parametrize("t,k,p,m", GRID)
def test_filtered_logits_equal_jax(t, k, p, m):
    lg = _logits(8, seed=int(1000 * t) + k)
    arrs = _arrays(8, t, k, p, m)
    jx = np.asarray(jsample.filtered_logits(jnp.asarray(lg), *map(jnp.asarray, arrs)))
    tx = tsample.filtered_logits(torch.from_numpy(lg), *map(torch.from_numpy, arrs)).numpy()
    ok = ~_undecided(lg, t, k, p, m)
    assert ok.mean() > 0.95
    assert (tx[ok] == jx[ok]).all()


def test_filtered_logits_rows_take_their_own_parameters():
    lg = _logits(len(GRID), seed=5)
    t, k, p, m = (np.array(c, dt) for c, dt in zip(zip(*GRID), (np.float32, np.int32,
                                                               np.float32, np.float32)))
    jx = np.asarray(jsample.filtered_logits(*map(jnp.asarray, (lg, t, k, p, m))))
    tx = tsample.filtered_logits(*map(torch.from_numpy, (lg, t, k, p, m))).numpy()
    for r, (tr, kr, pr, mr) in enumerate(GRID):
        ok = ~_undecided(lg[r:r + 1], tr, kr, pr, mr)[0]
        assert (tx[r][ok] == jx[r][ok]).all(), r


def test_repetition_penalty_is_exact():
    rng = np.random.default_rng(1)
    lg = _logits(4, seed=1)
    seen = rng.random((4, V)) < 0.3
    pen = np.array([1.0, 1.2, 0.8, 2.5], np.float32)
    j = np.asarray(jsample.apply_repetition_penalty(*map(jnp.asarray, (lg, seen, pen))))
    t = tsample.apply_repetition_penalty(*map(torch.from_numpy, (lg, seen, pen))).numpy()
    assert (t == j).all()


def test_target_logprobs():
    lg = _logits(6, seed=2)
    tgt = np.array([0, 5, 511, 7, 100, 3], np.int32)
    j = np.asarray(jsample.target_logprobs(jnp.asarray(lg), jnp.asarray(tgt)))
    t = tsample.target_logprobs(torch.from_numpy(lg), torch.from_numpy(tgt)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("norms", [False, True])
def test_apply_qk_rope(norms):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    inv = (1.0 / 10000.0 ** (np.arange(0, 16, 2) / 16)).astype(np.float32)
    qn = (1 + 0.1 * rng.normal(size=16)).astype(np.float32) if norms else None
    kn = (1 + 0.1 * rng.normal(size=16)).astype(np.float32) if norms else None
    jq, jk = jrope.apply_qk_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(inv),
                                 jnp.asarray(pos), None if qn is None else jnp.asarray(qn),
                                 None if kn is None else jnp.asarray(kn))
    tq, tk = trope.apply_qk_rope(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(inv), torch.from_numpy(pos),
                                 None if qn is None else torch.from_numpy(qn),
                                 None if kn is None else torch.from_numpy(kn))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)


def _draw(lg, seeds, pos, t, k, p, m):
    return tsample.sample_tokens_at(
        torch.from_numpy(lg), torch.as_tensor(seeds), torch.as_tensor(pos),
        *(torch.as_tensor(a) for a in (t, k, p, m)))


def test_draws_are_a_function_of_seed_and_position():
    lg = _logits(8, seed=4)
    arrs = _arrays(8, 1.0, 0, 1.0, 0.0)
    seeds, pos = np.arange(8, dtype=np.int32), np.arange(100, 108, dtype=np.int32)
    a = _draw(lg, seeds, pos, *arrs)
    assert (a == _draw(lg, seeds, pos, *arrs)).all()
    # another seed, or another position, draws otherwise (some row moves)
    assert (a != _draw(lg, seeds + 1, pos, *arrs)).any()
    assert (a != _draw(lg, seeds, pos + 1, *arrs)).any()
    u = tsample.uniform_at(torch.tensor([3]), torch.tensor([9]), V)
    assert ((u > 0) & (u < 1)).all() and torch.unique(u).numel() == V


def test_rows_do_not_depend_on_their_place_or_the_batch():
    rng = np.random.default_rng(6)
    n = 17
    lg = _logits(n, seed=6)
    t = rng.choice([0.0, 0.7, 1.0, 1.5], n).astype(np.float32)
    k = rng.choice([0, 1, 20, 50], n).astype(np.int32)
    p = rng.choice([1.0, 0.95, 0.8], n).astype(np.float32)
    m = rng.choice([0.0, 0.05], n).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    pos = rng.integers(0, 4096, n).astype(np.int32)
    arrs = (lg, seeds, pos, t, k, p, m)
    full = _draw(*arrs)
    x_full = tsample.filtered_logits(*(torch.from_numpy(a) for a in (lg, t, k, p, m)))
    perm = rng.permutation(n)
    shuffled = _draw(*(a[perm] for a in arrs))
    assert (shuffled == full[perm]).all()
    for r in range(n):
        alone = _draw(*(a[r:r + 1] for a in arrs))
        x = tsample.filtered_logits(*(torch.from_numpy(a[r:r + 1]) for a in (lg, t, k, p, m)))
        assert int(alone[0]) == int(full[r])
        assert torch.equal(x[0], x_full[r])
    greedy = t <= 0
    assert (full.numpy()[greedy] == lg[greedy].argmax(1)).all()


def test_draws_stay_in_the_filter_and_follow_its_softmax():
    """20 000 draws of one row (positions 0..19 999, one seed) against the
    softmax of JAX's filtered logits: inside the support, and a chi-square
    test of the counts (bins of expected count >= 5, the rest merged)."""
    t, k, p, m = 0.9, 40, 0.9, 0.0
    lg = _logits(1, seed=8, scale=1.5)
    jx = np.asarray(jsample.filtered_logits(jnp.asarray(lg), *map(jnp.asarray,
                                                                 _arrays(1, t, k, p, m))))[0]
    support = jx > NEG_CUT
    w = np.where(support, np.exp(jx.astype(np.float64) - jx.max()), 0.0)
    prob = w / w.sum()
    N = 20000
    draws = []
    for lo in range(0, N, 5000):
        n = min(5000, N - lo)
        draws.append(_draw(np.repeat(lg, n, 0), np.full(n, 11, np.int32),
                           np.arange(lo, lo + n, dtype=np.int32), *_arrays(n, t, k, p, m)))
    draws = torch.cat(draws).numpy()
    assert support[draws].all()
    counts = np.bincount(draws, minlength=V)
    big = prob * N >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(prob[big] * N, prob[~big].sum() * N)
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert big.sum() >= 10
    assert stats.chisquare(obs, exp).pvalue > 1e-3


def test_sample_tokens_from_a_generator():
    lg = _logits(4, seed=9)
    t = np.array([0.0, 1.0, 0.0, 1.5], np.float32)
    k = np.array([0, 5, 0, 5], np.int32)
    top5 = np.argsort(-lg, 1)[:, :5]
    for s in range(10):
        out = tsample.sample_tokens(torch.from_numpy(lg), torch.Generator().manual_seed(s),
                                    torch.from_numpy(t), torch.from_numpy(k),
                                    torch.ones(4)).numpy()
        assert out[0] == lg[0].argmax() and out[2] == lg[2].argmax()
        assert out[1] in top5[1] and out[3] in top5[3]


# ---------------------------------------------------------------------------
# the decode loops
# ---------------------------------------------------------------------------

B, C, PAGE, MAX_SEQ = 2, 20, 16, 256
L, R = 4, 2
TAIL = L + 2


class Pair:
    """A tiny fp32 llama in both packages (JAX init), and one prompt a row."""

    def __init__(self):
        self.jc, self.tc = jcfg_mod.ModelConfig.tiny(), tcfg_mod.ModelConfig.tiny()
        self.je = jcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=B)
        self.te = tcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=B)
        self.jp = j_init_params(self.jc, jax.random.PRNGKey(3), dtype=jnp.float32)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        self.toks = np.random.default_rng(7).integers(10, 22, (B, C)).astype(np.int32)
        self.lens = np.array([C, 15], np.int32)
        P = self.je.pages_per_req
        self.pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)

    def prefill_jax(self):
        kv = j_init_kv(self.jc, self.je, dtype=jnp.float32)
        return j_prefill(self.jp, kv, self.jc, jnp.asarray(self.toks),
                         jnp.zeros(B, jnp.int32), jnp.asarray(self.lens), jnp.asarray(self.pt))

    def prefill_torch(self):
        kv = t_init_kv(self.tc, self.te, dtype=torch.float32, device="cpu")
        return t_prefill(self.tp, kv, self.tc, torch.from_numpy(self.toks),
                         torch.zeros(B, dtype=torch.int32), torch.from_numpy(self.lens),
                         torch.from_numpy(self.pt))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_greedy_decode_with_repetition_penalty_equals_jax(pair):
    rp = np.array([1.3, 1.0], np.float32)
    seen = np.zeros((B, V), bool)
    for b in range(B):
        seen[b, pair.toks[b, : pair.lens[b]]] = True
    act = np.array([True, True])
    jkv, jn, _ = pair.prefill_jax()
    tkv, tn, _ = pair.prefill_torch()
    jr = j_decode(pair.jp, jkv, pair.jc, jn, jnp.asarray(pair.lens), jnp.asarray(act),
                  jnp.asarray(pair.pt), n_steps=24, rep_penalty=jnp.asarray(rp),
                  seen_mask=jnp.asarray(seen))
    tr = t_decode(pair.tp, tkv, pair.tc, tn, _t(pair.lens), _t(act), _t(pair.pt), n_steps=24,
                  rep_penalty=_t(rp), seen_mask=_t(seen))
    assert (tr[1].numpy() == np.asarray(jr[1])).all()
    assert not torch.equal(_t(seen), torch.zeros(B, V, dtype=torch.bool))  # not mutated
    # the penalty changes row 0's stream
    tkv, tn, _ = pair.prefill_torch()
    plain = t_decode(pair.tp, tkv, pair.tc, tn, _t(pair.lens), _t(act), _t(pair.pt),
                     n_steps=24)
    assert plain[1][0].tolist() != tr[1][0].tolist()
    assert plain[1][1].tolist() == tr[1][1].tolist()


SAMPLED = dict(temperature=np.array([0.8, 0.0], np.float32), top_k=np.array([50, 0], np.int32),
               top_p=np.array([0.95, 1.0], np.float32), min_p=np.array([0.0, 0.0], np.float32),
               seeds=np.array([1234, 5], np.int32))


def _sampled_first(pair, logits):
    s = {k: _t(v) for k, v in SAMPLED.items()}
    return tsample.sample_tokens_at(logits, s["seeds"], _t(pair.lens), s["temperature"],
                                    s["top_k"], s["top_p"], s["min_p"])


def test_sampled_lookahead_equals_sampled_ar(pair):
    """Sampled AR for 48 tokens, then lookahead from a fresh prefill with
    the tables seeded with that AR stream: drafts land deep in the tree,
    and the streams are equal."""
    act = np.array([True, True])
    s = {k: _t(v) for k, v in SAMPLED.items()}
    tkv, _, logits = pair.prefill_torch()
    first = _sampled_first(pair, logits)
    ar = t_decode(pair.tp, tkv, pair.tc, first, _t(pair.lens), _t(act), _t(pair.pt),
                  n_steps=47, **s)
    ar_rows = [[int(first[b])] + ar[1][b].tolist() for b in range(B)]
    tkv, _, logits = pair.prefill_torch()
    assert torch.equal(_sampled_first(pair, logits), first)
    tcfg = tdt.DraftTableConfig(buckets=64, ways=4, branch_length=L, retrieve_count=R)
    tables = tdt.init_draft_tables(tcfg, "cpu")
    tail = np.full((B, TAIL), -1, np.int32)
    for b in range(B):
        seq = pair.toks[b, : pair.lens[b]].tolist() + ar_rows[b]
        tdt.update_tables_seq(tables, tcfg, torch.tensor(seq, dtype=torch.int32), len(seq))
        tail[b] = (pair.toks[b, : pair.lens[b]].tolist() + ar_rows[b][:1])[-TAIL:]
    out = t_spec(pair.tp, tkv, tables, pair.tc, tcfg, first, _t(pair.lens), _t(act), _t(tail),
                 _t(pair.pt), n_steps=24, update_tables=False, budget=torch.tensor([47, 47]),
                 **s)
    for b in range(B):
        n_acc = out[3][b].tolist()
        stream = [int(first[b])] + [x for st, n in enumerate(n_acc)
                                    for x in out[2][b, st, :n].tolist()]
        assert stream == ar_rows[b][: len(stream)] and len(stream) == 48, b
    assert out[3][0].max() > 2, "no draft landed on the sampled row"
    assert ar_rows[0] != ar_rows[1]


def test_sampled_rows_at_temperature_zero_are_greedy(pair):
    act = np.array([True, True])
    tkv, tn, _ = pair.prefill_torch()
    greedy = t_decode(pair.tp, tkv, pair.tc, tn, _t(pair.lens), _t(act), _t(pair.pt),
                      n_steps=16)
    tkv, tn, _ = pair.prefill_torch()
    sampled = t_decode(pair.tp, tkv, pair.tc, tn, _t(pair.lens), _t(act), _t(pair.pt),
                       n_steps=16, **{k: _t(v) for k, v in SAMPLED.items()})
    assert greedy[1][1].tolist() == sampled[1][1].tolist()
    assert greedy[1][0].tolist() != sampled[1][0].tolist()


def test_adaptive_gate_equals_jax(pair):
    """Per-step width gate: steps with no retrievable draft (top frequency
    at most 1.0) run width-1 AR; tokens, counts and wide_mask as in JAX."""
    kw = dict(buckets=64, ways=4, branch_length=L, retrieve_count=R, adaptive=True,
              gate_min_freq=1.0)
    jtc, ttc = jdt.DraftTableConfig(**kw), tdt.DraftTableConfig(**kw)
    act = np.array([True, True])
    jkv, jn, _ = pair.prefill_jax()
    tkv, tn, _ = pair.prefill_torch()
    seed = list(pair.toks[0, : pair.lens[0]]) + [int(tn[0])]
    jt = jdt.update_tables_seq(jdt.init_draft_tables(jtc), jtc, jnp.asarray(seed, jnp.int32),
                               jnp.int32(len(seed)))
    tt = tdt.update_tables_seq(tdt.init_draft_tables(ttc, "cpu"), ttc,
                               torch.tensor(seed, dtype=torch.int32), len(seed))
    tail = np.tile(np.array(seed[-TAIL:], np.int32), (B, 1))
    jr = j_spec(pair.jp, jkv, jt, pair.jc, jtc, jn, jnp.asarray(pair.lens), jnp.asarray(act),
                jnp.asarray(tail), jnp.asarray(pair.pt), n_steps=16)
    tr = t_spec(pair.tp, tkv, tt, pair.tc, ttc, tn, _t(pair.lens), _t(act), _t(tail),
                _t(pair.pt), n_steps=16)
    wide = tr[8].numpy()
    assert (wide == np.asarray(jr[8])).all()
    assert wide.any() and not wide.all()
    for j, t in zip(jr[2:8], tr[2:8]):
        assert (t.numpy() == np.asarray(j)).all()
