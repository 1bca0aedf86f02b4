"""The PyTorch port's main path against the JAX package, on the CPU.

Same weights (JAX init, carried over by ``params_from_jax``) and the same
inputs (numpy, seeded) go through both packages' prefill, greedy multistep
decode and lookahead multistep decode on ``ModelConfig.tiny()``, in fp32 and
with int4 weights, at B=2 with one inactive row. Tolerances: logits within
1e-4 (fp32 on both sides, sums taken in different orders); tokens, accepted
counts and draft tables identical.
"""

import numpy as np
import pytest

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
from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec
from painlessinferenceacceleration_tpu.lookahead import device_tables as jdt
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params

from painlessinferenceacceleration_tpu_torch import config as tcfg_mod
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache as t_init_kv
from painlessinferenceacceleration_tpu_torch.engine.multistep import (
    multistep_decode as t_decode,
    multistep_spec_decode as t_spec,
)
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step as t_prefill
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec as TQuantSpec
from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as tdt
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax

B, C = 2, 24
PAGE, MAX_SEQ = 16, 256
R, L = 2, 4
TAIL = L + 2
ACTIVE = np.array([True, False])


class Pair:
    """One model in both packages, with shared prompts."""

    def __init__(self, quant: bool):
        self.jc = jcfg_mod.ModelConfig.tiny()
        self.tc = tcfg_mod.ModelConfig.tiny()
        self.je = jcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=B)
        self.te = tcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=B)
        self.jspec = JQuantSpec(bits=4, group=128) if quant else None
        self.tspec = TQuantSpec(bits=4, group=128) if quant else None
        self.jp = j_init_params(self.jc, jax.random.PRNGKey(3), dtype=jnp.float32,
                                quant=self.jspec)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        rng = np.random.default_rng(7)
        # a small alphabet makes 2-gram repeats, bucket collisions and drafts
        self.toks = rng.integers(10, 22, size=(B, C)).astype(np.int32)
        self.lens = np.array([C, 17], np.int32)
        P = self.je.pages_per_req
        self.pt = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
        # teacher stream: each row's prompt, then that prompt over and over,
        # so table drafts land and some 2-grams have two continuations
        self.teacher = np.stack([
            np.tile(self.toks[b, : self.lens[b]], 15)[:240] for b in range(B)])

    def prefill_jax(self):
        kv = j_init_kv(self.jc, self.je, dtype=jnp.float32)
        return j_prefill(self.jp, kv, self.jc, jnp.asarray(self.toks),
                         jnp.zeros(B, jnp.int32), jnp.asarray(self.lens),
                         jnp.asarray(self.pt), self.jspec)

    def prefill_torch(self):
        kv = t_init_kv(self.tc, self.te, dtype=torch.float32, device="cpu")
        return t_prefill(self.tp, kv, self.tc, torch.from_numpy(self.toks),
                         torch.zeros(B, dtype=torch.int32), torch.from_numpy(self.lens),
                         torch.from_numpy(self.pt), self.tspec)


@pytest.fixture(scope="module", params=[False, True], ids=["fp32", "int4"])
def pair(request):
    return Pair(request.param)


def test_prefill_logits_and_tokens(pair):
    _, jn, jl = pair.prefill_jax()
    _, tn, tl = pair.prefill_torch()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert (tn.numpy() == np.asarray(jn)).all()


def test_multistep_decode_tokens(pair):
    jkv, jn, _ = pair.prefill_jax()
    tkv, tn, _ = pair.prefill_torch()
    args = (jnp.asarray(pair.lens), jnp.asarray(ACTIVE), jnp.asarray(pair.pt))
    jr = j_decode(pair.jp, jkv, pair.jc, jn, *args, n_steps=32, spec=pair.jspec)
    tr = t_decode(pair.tp, tkv, pair.tc, tn, torch.from_numpy(pair.lens),
                  torch.from_numpy(ACTIVE), torch.from_numpy(pair.pt), n_steps=32,
                  spec=pair.tspec)
    assert (tr[1].numpy() == np.asarray(jr[1])).all()
    assert (tr[1][1] == -1).all()  # the inactive row emits nothing
    for j, t in zip(jr[2:], tr[2:]):
        assert (t.numpy() == np.asarray(j)).all()


def _seed_tables(pair, nxt, jtc, ttc):
    seed = list(pair.toks[0, : pair.lens[0]]) + [int(nxt[0])]
    jt = jdt.update_tables_seq(jdt.init_draft_tables(jtc), jtc,
                               jnp.asarray(seed, jnp.int32), jnp.int32(len(seed)))
    tt = tdt.update_tables_seq(tdt.init_draft_tables(ttc, "cpu"), ttc,
                               torch.tensor(seed, dtype=torch.int32), len(seed))
    tail = np.full((B, TAIL), -1, np.int32)
    tail[:, :] = np.array(seed[-TAIL:])
    return jt, tt, tail


@pytest.mark.parametrize("mode", ["greedy", "teacher"])
def test_multistep_spec_decode_matches_jax_and_ar(pair, mode):
    jtc = jdt.DraftTableConfig(buckets=16, ways=4, branch_length=L, retrieve_count=R)
    ttc = tdt.DraftTableConfig(buckets=16, ways=4, branch_length=L, retrieve_count=R)
    teacher_np = pair.teacher if mode == "teacher" else None
    jkv, jn, _ = pair.prefill_jax()
    tkv, tn, _ = pair.prefill_torch()
    if teacher_np is not None:  # the stream continues with the teacher's text
        jn = jnp.asarray(teacher_np[np.arange(B), pair.lens])
        tn = torch.from_numpy(teacher_np[np.arange(B), pair.lens])
    jt, tt, tail = _seed_tables(pair, tn, jtc, ttc)
    jr = j_spec(pair.jp, jkv, jt, pair.jc, jtc, jn, jnp.asarray(pair.lens),
                jnp.asarray(ACTIVE), jnp.asarray(tail), jnp.asarray(pair.pt),
                n_steps=24, spec=pair.jspec,
                teacher=None if teacher_np is None else jnp.asarray(teacher_np))
    tr = t_spec(pair.tp, tkv, tt, pair.tc, ttc, tn, torch.from_numpy(pair.lens),
                torch.from_numpy(ACTIVE), torch.from_numpy(tail), torch.from_numpy(pair.pt),
                n_steps=24, spec=pair.tspec,
                teacher=None if teacher_np is None else torch.from_numpy(teacher_np))
    assert (tr[2].numpy() == np.asarray(jr[2])).all()  # out_toks
    assert (tr[3].numpy() == np.asarray(jr[3])).all()  # n_acc
    for k in ("key0", "key1", "freq", "branch"):
        assert (tr[1][k].numpy() == np.asarray(jr[1][k])).all(), k
    for j, t in zip(jr[4:8], tr[4:8]):  # last, ctx, active, tail
        assert (t.numpy() == np.asarray(j)).all()
    assert (tr[8].numpy() == np.asarray(jr[8])).all()  # wide_mask

    # lossless: the lookahead stream equals the port's own AR stream
    n_acc = tr[3][0].tolist()
    stream = [int(tn[0])] + [x for s, n in enumerate(n_acc) for x in tr[2][0, s, :n].tolist()]
    assert max(n_acc) > 1, "drafts never landed: the test would not exercise compaction"
    tkv2, tn2, _ = pair.prefill_torch()
    if teacher_np is not None:
        tn2 = torch.from_numpy(teacher_np[np.arange(B), pair.lens])
    ar = t_decode(pair.tp, tkv2, pair.tc, tn2, torch.from_numpy(pair.lens),
                  torch.from_numpy(ACTIVE), torch.from_numpy(pair.pt),
                  n_steps=len(stream) - 1, spec=pair.tspec,
                  teacher=None if teacher_np is None else torch.from_numpy(teacher_np))
    assert stream == [int(tn2[0])] + ar[1][0].tolist()


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int4"])
def test_port_init_params_mirror_the_jax_tree(quant):
    from painlessinferenceacceleration_tpu.models.base import (
        init_params_quantized as j_init_q,
    )
    from painlessinferenceacceleration_tpu_torch.models.base import (
        init_params as t_init,
        init_params_quantized as t_init_q,
    )

    jc, tc = jcfg_mod.ModelConfig.tiny(), tcfg_mod.ModelConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    if quant:
        jp = j_init_q(jc, jax.random.PRNGKey(0), JQuantSpec(bits=4, group=128))
        tp = t_init_q(tc, TQuantSpec(bits=4, group=128), gen, device="cpu")
    else:
        jp = j_init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
        tp = t_init(tc, gen, device="cpu")
    assert _tree_shapes(tp) == _tree_shapes(jax.tree.map(np.asarray, jp))
    # the port's own weights run the path (the chip smoke's model, tiny)
    te = tcfg_mod.EngineConfig(page_size=PAGE, max_seq_len=MAX_SEQ, max_concurrency=1)
    kv = t_init_kv(tc, te, dtype=tp["final_ln"].dtype, device="cpu")
    pt = torch.arange(1, 1 + te.pages_per_req, dtype=torch.int32)[None]
    _, nxt, logits = t_prefill(tp, kv, tc, torch.tensor([[5, 6, 7, 8]]),
                               torch.zeros(1, dtype=torch.int32), torch.tensor([4]), pt,
                               TQuantSpec(bits=4, group=128) if quant else None)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert logits.shape == (1, tc.vocab_size) and 0 <= int(nxt[0]) < tc.vocab_size


def test_port_init_params_quantized_never_falls_back_to_the_cpu():
    from painlessinferenceacceleration_tpu_torch.models.base import init_params_quantized

    # no device: cuda is asked for; a CPU generator cannot draw there, and a
    # machine without a card raises before that
    with pytest.raises((RuntimeError, ValueError)):
        init_params_quantized(tcfg_mod.ModelConfig.tiny(), TQuantSpec(bits=4, group=128),
                              torch.Generator().manual_seed(0))


def _both_eos_budget(pair):
    eos = np.array([pair.teacher[0, pair.lens[0] + 9], -2], np.int32)
    budget = np.array([13, 4], np.int32)
    return (jnp.asarray(eos), jnp.asarray(budget)), (torch.from_numpy(eos),
                                                     torch.from_numpy(budget))


def test_multistep_decode_eos_budget_teacher(pair):
    (jeos, jbud), (teos, tbud) = _both_eos_budget(pair)
    act = np.array([True, True])
    jkv, _, _ = pair.prefill_jax()
    tkv, _, _ = pair.prefill_torch()
    first = pair.teacher[np.arange(B), pair.lens]
    jr = j_decode(pair.jp, jkv, pair.jc, jnp.asarray(first), jnp.asarray(pair.lens),
                  jnp.asarray(act), jnp.asarray(pair.pt), n_steps=16, eos=jeos,
                  spec=pair.jspec, teacher=jnp.asarray(pair.teacher), budget=jbud)
    tr = t_decode(pair.tp, tkv, pair.tc, torch.from_numpy(first),
                  torch.from_numpy(pair.lens), torch.from_numpy(act),
                  torch.from_numpy(pair.pt), n_steps=16, eos=teos, spec=pair.tspec,
                  teacher=torch.from_numpy(pair.teacher), budget=tbud)
    for j, t in zip(jr[1:], tr[1:]):
        assert (t.numpy() == np.asarray(j)).all()
    assert not tr[4].any()  # both rows stopped: eos on row 0, budget on row 1


@pytest.mark.parametrize("update_tables", [True, False])
def test_multistep_spec_decode_eos_budget_frozen(pair, update_tables):
    jtc = jdt.DraftTableConfig(buckets=16, ways=4, branch_length=L, retrieve_count=R)
    ttc = tdt.DraftTableConfig(buckets=16, ways=4, branch_length=L, retrieve_count=R)
    (jeos, jbud), (teos, tbud) = _both_eos_budget(pair)
    act = np.array([True, True])
    jkv, _, _ = pair.prefill_jax()
    tkv, _, _ = pair.prefill_torch()
    first = pair.teacher[np.arange(B), pair.lens]
    jt, tt, tail = _seed_tables(pair, torch.from_numpy(first), jtc, ttc)
    jr = j_spec(pair.jp, jkv, jt, pair.jc, jtc, jnp.asarray(first), jnp.asarray(pair.lens),
                jnp.asarray(act), jnp.asarray(tail), jnp.asarray(pair.pt), n_steps=8,
                eos=jeos, spec=pair.jspec, teacher=jnp.asarray(pair.teacher),
                update_tables=update_tables, budget=jbud)
    tr = t_spec(pair.tp, tkv, tt, pair.tc, ttc, torch.from_numpy(first),
                torch.from_numpy(pair.lens), torch.from_numpy(act), torch.from_numpy(tail),
                torch.from_numpy(pair.pt), n_steps=8, eos=teos, spec=pair.tspec,
                teacher=torch.from_numpy(pair.teacher), update_tables=update_tables,
                budget=tbud)
    for j, t in zip(jr[2:], tr[2:]):
        assert (t.numpy() == np.asarray(j)).all()
    for k in ("key0", "key1", "freq", "branch"):
        assert (tr[1][k].numpy() == np.asarray(jr[1][k])).all(), k
    assert not tr[6].any()
