"""IPAD (prune and distill) in the port against the JAX package, on the CPU.

Tiny fp32 llamas (GQA with G = 2, and a qk-norm case), weights from the
JAX init carried over by ``params_from_jax``, inputs from numpy seeds. The
training state crosses over by ``distill_state_from_jax``, so both
packages step from one state.

Tolerances (fp32 on both sides; the port's sums run in other orders):

- ``forward_logits``: logits and hidden within 1e-5 absolute (|logits| <
  1), the gradients within 1e-5 of the largest gradient of their leaf;
- AdamW against ``optax.adamw`` over 3 steps: updates, moments and
  parameters within rel 1e-6 of each leaf's largest value;
- one train step: loss and CE within rel 1e-5, KL and the hidden-state
  MSE within rel 1e-3 (each measures the gap between two near-equal
  distributions or states, which each sum order moves by ~1e-7); the first
  and second moments within rel 1e-4 of their leaf's largest value; the
  step's saliency within rel 1e-4; the student within 1e-2 lr (Adam's
  ratio m / sqrt(v) amplifies the order-of-sum differences of the few
  near-zero gradients);
- ``_update_masks`` on one injected saliency, ``reparam`` of one student
  and masks, ``finetune_mask`` and the teacher cache's reads: exact;
- a fit of a few steps with pruning, and a 2-stage ``DistillPipe``: loss
  and CE within rel 1e-4 (KL and hidden-MSE 1e-3), masks equal;
- ``evaluate``: perplexities within rel 1e-5, agreement equal;
- the pruned model served by ``LLM``: the same greedy tokens as JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from painlessinferenceacceleration_tpu.config import EngineConfig as JEngineConfig
from painlessinferenceacceleration_tpu.config import ModelConfig as JModelConfig
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
from painlessinferenceacceleration_tpu.ipad import distill as jdistill
from painlessinferenceacceleration_tpu.ipad.train_forward import forward_logits as j_forward
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params

from painlessinferenceacceleration_tpu_torch.config import EngineConfig as TEngineConfig
from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams as TSP
from painlessinferenceacceleration_tpu_torch.ipad import distill as tdistill
from painlessinferenceacceleration_tpu_torch.ipad.optim import AdamW, tree_map
from painlessinferenceacceleration_tpu_torch.ipad.train_forward import (
    forward_logits as t_forward,
)
from painlessinferenceacceleration_tpu_torch.models.convert import (
    distill_state_from_jax,
    params_from_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (many small ops beside
    the parallel run's other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    return JModelConfig.tiny(**kw), TModelConfig.tiny(**kw)


def models(seed, **kw):
    jc, tc = configs(**kw)
    jp = j_init_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def small():
    """2 layers, 4 heads over 2 kv heads (G = 2), I = 64."""
    return models(0, num_hidden_layers=2, intermediate_size=64)


def batches(vocab, seed, B=4, T=16):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(1, vocab - 1, size=(B, T)).astype(np.int32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_np(tree):
    return tree_map(lambda x: x.detach().numpy(), tree)


def jax_state(jd) -> dict:
    adam = jd.opt_state[0]
    return dict(student=np_tree(jd.student), mu=np_tree(adam.mu), nu=np_tree(adam.nu),
                count=int(adam.count), masks=np_tree(jd.masks),
                saliency=np_tree(jd._saliency), step_idx=jd.step_idx)


def pairs(a, b, path=""):
    """(path, numpy a, numpy b) over two trees of the same keys."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b.detach() if torch.is_tensor(b) else b)


def assert_close_rel(a, b, rel, what):
    for path, x, y in pairs(a, b):
        assert x.shape == y.shape, (what, path)
        scale = max(float(np.abs(x).max()), 1e-30)
        err = float(np.abs(x - y).max())
        assert err <= rel * scale, (what, path, err, scale)


def random_masks(cfg, seed, kinds):
    """0/1 masks of ``init_masks``'s layout; heads by kv group."""
    rng = np.random.default_rng(seed)
    L, I, H, Hk, E = (cfg.num_hidden_layers, cfg.intermediate_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.hidden_size)
    m = {"mlp": np.ones((L, I), np.float32), "head": np.ones((L, H), np.float32),
         "layer": np.ones((L,), np.float32), "dim": np.ones((E,), np.float32)}
    if "mlp" in kinds:
        m["mlp"] = (rng.random((L, I)) > 0.4).astype(np.float32)
    if "head" in kinds:
        g = np.ones((L, Hk), np.float32)
        g[np.arange(L), rng.integers(0, Hk, L)] = 0.0
        m["head"] = np.repeat(g, H // Hk, axis=1)
    if "layer" in kinds:
        m["layer"][rng.integers(0, L)] = 0.0
    if "dim" in kinds:
        m["dim"] = (rng.random(E) > 0.25).astype(np.float32)
    return m


# ---------------------------------------------------------------------------
# forward_logits and its gradients
# ---------------------------------------------------------------------------

MASK_CASES = {"none": None, "mlp": ("mlp",), "head": ("head",), "layer": ("layer",),
              "dim": ("dim",), "all": ("mlp", "head", "layer", "dim")}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_forward_logits_matches_jax(small, case):
    jc, jp, tc, tp = small
    toks = next(batches(tc.vocab_size, 1))
    kinds = MASK_CASES[case]
    m = None if kinds is None else random_masks(tc, 2, kinds)
    jl, jh = j_forward(jp, jc, jnp.asarray(toks), None if m is None else
                       jax.tree.map(jnp.asarray, m), return_hidden=True)
    tl, th = t_forward(tp, tc, torch.as_tensor(toks), None if m is None else
                       tree_map(torch.as_tensor, m), return_hidden=True)
    assert tl.dtype == torch.float32 and tl.shape == (4, 16, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)


def test_forward_logits_qk_norm_and_tied_head_match_jax():
    jc, jp, tc, tp = models(4, num_hidden_layers=2, intermediate_size=64, qk_norm=True,
                            tie_word_embeddings=True)
    assert "lm_head" not in tp
    tp["layers"]["q_norm"] = tp["layers"]["q_norm"] * 1.5  # away from ones
    jp["layers"]["q_norm"] = jnp.asarray(tp["layers"]["q_norm"].numpy())
    toks = next(batches(tc.vocab_size, 5))
    m = random_masks(tc, 6, MASK_CASES["all"])
    jl = j_forward(jp, jc, jnp.asarray(toks), jax.tree.map(jnp.asarray, m))
    tl = t_forward(tp, tc, torch.as_tensor(toks), tree_map(torch.as_tensor, m))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["none", "all"])
def test_forward_gradients_match_jax(small, case):
    jc, jp, tc, tp = small
    toks = next(batches(tc.vocab_size, 7))
    w = np.random.default_rng(8).standard_normal((4, 16, tc.vocab_size)).astype(np.float32)
    kinds = MASK_CASES[case]
    m = None if kinds is None else random_masks(tc, 9, kinds)
    jm = None if m is None else jax.tree.map(jnp.asarray, m)

    def jloss(p):
        return jnp.sum(j_forward(p, jc, jnp.asarray(toks), jm) * w)

    jg = np_tree(jax.grad(jloss)(jp))
    live = tree_map(lambda x: x.clone().requires_grad_(True), tp)
    tm = None if m is None else tree_map(torch.as_tensor, m)
    loss = torch.sum(t_forward(live, tc, torch.as_tensor(toks), tm) * torch.as_tensor(w))
    loss.backward()
    tg = tree_map(lambda x: x.grad, live)
    assert_close_rel(jg, tg, 1e-5, "grad")


# ---------------------------------------------------------------------------
# AdamW against optax
# ---------------------------------------------------------------------------

def test_adamw_matches_optax_with_a_trainable_mask():
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((8, 5)).astype(np.float32),
              "layers": {"w": rng.standard_normal((3, 4, 6)).astype(np.float32)}}
    tmask = {"a": np.ones((1, 1), np.float32),
             "layers": {"w": np.array([1, 0, 1], np.float32).reshape(3, 1, 1)}}
    opt = optax.adamw(3e-3, weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    tadam = AdamW(3e-3, weight_decay=0.05)
    tp = tree_map(torch.as_tensor, params)
    ts = tadam.init(tp)
    tm = tree_map(torch.as_tensor, tmask)
    for step in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        jg = jax.tree.map(lambda a, m: jnp.asarray(a) * m, g, tmask)
        ju, js = opt.update(jg, js, jp)
        ju = jax.tree.map(lambda u, m: u * m, ju, tmask)
        jp = optax.apply_updates(jp, ju)
        tg = tree_map(lambda a, m: torch.as_tensor(a) * m, g, tm)
        tu, ts = tadam.update(tg, ts, tp)
        tu = tree_map(lambda u, m: u * m, tu, tm)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        assert_close_rel(np_tree(ju), tu, 1e-6, f"updates {step}")
        assert_close_rel(np_tree(js[0].mu), ts.mu, 1e-6, f"mu {step}")
        assert_close_rel(np_tree(js[0].nu), ts.nu, 1e-6, f"nu {step}")
        assert_close_rel(np_tree(jp), tp, 1e-6, f"params {step}")
        assert int(js[0].count) == ts.count == step + 1
    frozen = np.asarray(tp["layers"]["w"][1])
    np.testing.assert_array_equal(frozen, params["layers"]["w"][1])  # bit-unchanged


# ---------------------------------------------------------------------------
# the train step, from one carried-over state
# ---------------------------------------------------------------------------

STEP_CFG = dict(lr=1e-3, hidden_weight=0.5, target_mlp_sparsity=0.25, prune_steps=4,
                total_steps=8)


@pytest.fixture(scope="module")
def stepped(small):
    """A JAX distiller two steps in (moments, saliency and mlp masks set),
    and a port distiller set to its state."""
    jc, jp, tc, tp = small
    jd = jdistill.Distiller(jc, jp, jdistill.DistillConfig(**STEP_CFG))
    jd.fit(batches(jc.vocab_size, 13), steps=2)
    return jd, jax_state(jd)


def port_at(small, state, **dcfg):
    jc, jp, tc, tp = small
    td = tdistill.Distiller(tc, tp, tdistill.DistillConfig(**dict(STEP_CFG, **dcfg)))
    distill_state_from_jax(td, state)
    return td


@pytest.mark.parametrize("mode", ["full", "upper"])
def test_train_step_matches_jax(small, stepped, mode):
    jd, state = stepped
    td = port_at(small, state)
    jd_tmask = jd.finetune_mask(mode, layer_indices=(0,) if mode == "upper" else None)
    td.set_finetune(mode, layer_indices=(0,) if mode == "upper" else None)
    toks = next(batches(td.cfg.vocab_size, 17))
    tl, th = jd._teacher_logits(jd.teacher, jnp.asarray(toks))
    out = jd._train_step(jax.tree.map(jnp.asarray, state["student"]),
                         jax.tree.map(jnp.asarray, jd.opt_state), jd.masks, jnp.asarray(toks),
                         tl, th.astype(jnp.float32), jd_tmask)
    j_student, j_opt, j_loss, j_kl, j_ce, j_hid, j_sal = out
    t_loss, t_kl, t_ce, t_hid, t_sal = td._train_step(
        torch.as_tensor(toks), torch.tensor(np.asarray(tl)),
        torch.tensor(np.asarray(th, np.float32)))
    for j, t, rel in ((j_loss, t_loss, 1e-5), (j_kl, t_kl, 1e-3), (j_ce, t_ce, 1e-5),
                      (j_hid, t_hid, 1e-3)):
        assert abs(float(t) - float(j)) <= rel * abs(float(j)), (float(j), float(t))
    assert_close_rel(np_tree(j_opt[0].mu), td.opt_state.mu, 1e-4, "mu")
    assert_close_rel(np_tree(j_opt[0].nu), td.opt_state.nu, 1e-4, "nu")
    assert int(j_opt[0].count) == td.opt_state.count == 3
    assert_close_rel(np_tree(j_sal), t_sal, 1e-4, "saliency")
    lr = STEP_CFG["lr"]
    for path, a, b in pairs(np_tree(j_student), td.student):
        assert float(np.abs(a - b).max()) <= 1e-2 * lr, path
    if mode == "upper":  # the embedding and layer 1 frozen: bit-unchanged
        for path, before, after in pairs(state["student"], td.student):
            if path == "/embed":
                np.testing.assert_array_equal(before, after)
            elif path.startswith("/layers/"):
                np.testing.assert_array_equal(before[1], after[1], err_msg=path)
                assert not np.array_equal(before[0], after[0]), path


def test_update_masks_equal_on_injected_saliency(small):
    jc, jp, tc, tp = small
    kw = dict(target_mlp_sparsity=0.4, target_head_sparsity=0.5, target_depth_sparsity=0.5,
              target_dim_sparsity=0.3, prune_steps=4)
    jd = jdistill.Distiller(jc, jp, jdistill.DistillConfig(**kw))
    td = tdistill.Distiller(tc, tp, tdistill.DistillConfig(**kw))
    rng = np.random.default_rng(19)
    for step in (1, 3, 4, 6):
        sal = {k: rng.random(np.shape(v)).astype(np.float32) for k, v in jd.masks.items()}
        jd._saliency = jax.tree.map(jnp.asarray, sal)
        td._saliency = tree_map(torch.as_tensor, sal)
        jd.step_idx = td.step_idx = step
        jd._update_masks()
        td._update_masks()
        for path, a, b in pairs(np_tree(jd.masks), td.masks):
            np.testing.assert_array_equal(a, b, err_msg=f"{path} at step {step}")
    # every kind pruned by the end
    m = td.masks
    assert int(m["mlp"].sum(1)[0]) == 64 - int(0.4 * 64)
    assert int(m["head"].sum(1)[0]) == 2 and int(m["layer"].sum()) == 1
    assert int(m["dim"].sum()) == 64 - int(0.3 * 64)


# KL and the hidden-state MSE measure the gap between two near-equal
# distributions or states: an order-of-sum error of ~1e-7 in each is a
# larger share of that gap
LOSS_REL = {"loss": 1e-4, "ce": 1e-4, "kl": 1e-3, "hidden": 1e-3}


def test_fit_with_pruning_matches_jax():
    jc, jp, tc, tp = models(21, num_hidden_layers=2, intermediate_size=64,
                            num_attention_heads=8, num_key_value_heads=4)
    kw = dict(lr=1e-3, hidden_weight=0.5, target_mlp_sparsity=0.25,
              target_head_sparsity=0.5, target_depth_sparsity=0.5, target_dim_sparsity=0.25,
              prune_steps=3, total_steps=5)
    jd = jdistill.Distiller(jc, jp, jdistill.DistillConfig(**kw))
    td = tdistill.Distiller(tc, tp, tdistill.DistillConfig(**kw))
    jh = jd.fit(batches(jc.vocab_size, 23), steps=5)
    th = td.fit(batches(tc.vocab_size, 23), steps=5)
    assert len(jh) == len(th) == 5
    for a, b in zip(jh, th):
        assert a["step"] == b["step"] and a["sparsity"] == b["sparsity"]
        for k, rel in LOSS_REL.items():
            assert abs(a[k] - b[k]) <= rel * abs(a[k]), (k, a, b)
    for path, a, b in pairs(np_tree(jd.masks), td.masks):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert int(td.masks["layer"].sum()) == 1 and int(td.masks["dim"].sum()) == 48


# ---------------------------------------------------------------------------
# reparam, trainable sets, the pipe
# ---------------------------------------------------------------------------

def reparam_masks(cfg) -> dict:
    """Masks whose layers keep different counts, so reparam pads with dead
    units: layer 0 keeps 40 mlp channels and 2 of 4 kv groups, layer 2 48
    and 3; layer 1 is dropped; a quarter of the hidden dims go."""
    rng = np.random.default_rng(29)
    L, I, H, Hk, E = 3, 64, 8, 4, cfg.hidden_size
    mlp = np.zeros((L, I), np.float32)
    for li, n in enumerate((40, 44, 48)):
        mlp[li, rng.permutation(I)[:n]] = 1.0
    g = np.zeros((L, Hk), np.float32)
    for li, n in enumerate((2, 4, 3)):
        g[li, rng.permutation(Hk)[:n]] = 1.0
    dim = np.ones((E,), np.float32)
    dim[rng.permutation(E)[: E // 4]] = 0.0
    return {"mlp": mlp, "head": np.repeat(g, H // Hk, axis=1),
            "layer": np.array([1, 0, 1], np.float32), "dim": dim}


@pytest.mark.parametrize("extra", [{}, {"qk_norm": True, "tie_word_embeddings": True}],
                         ids=["plain", "qk_norm_tied"])
def test_reparam_exactly_equal_to_jax(extra):
    jc, jp, tc, tp = models(31, num_hidden_layers=3, intermediate_size=64,
                            num_attention_heads=8, num_key_value_heads=4, **extra)
    jd = jdistill.Distiller(jc, jp)
    td = tdistill.Distiller(tc, tp)
    rng = np.random.default_rng(37)
    student = jax.tree.map(lambda x: (np.asarray(x) + 0.01 * rng.standard_normal(
        np.shape(x))).astype(np.float32), jp)
    masks = reparam_masks(tc)
    jd.student = jax.tree.map(jnp.asarray, student)
    jd.masks = jax.tree.map(jnp.asarray, masks)
    state = jax_state(jd)
    distill_state_from_jax(td, state)
    j_cfg, j_params = jd.reparam()
    t_cfg, t_params = td.reparam()
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.num_hidden_layers, t_cfg.num_key_value_heads, t_cfg.intermediate_size,
            t_cfg.hidden_size) == (2, 3, 48, 48)
    for path, a, b in pairs(np_tree(j_params), t_params):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    # the sliced model computes what the masked student does
    toks = torch.as_tensor(next(batches(tc.vocab_size, 41)))
    masked = t_forward(td.student, tc, toks, td.masks)
    dense = t_forward(t_params, t_cfg, toks)
    np.testing.assert_allclose(dense.numpy(), masked.numpy(), rtol=2e-4, atol=2e-4)
    # the returned weights are copies: the student trains on without them
    for leaf in td.student["layers"].values():
        leaf.add_(1.0)
    np.testing.assert_array_equal(t_params["layers"]["input_ln"].numpy(),
                                  np.asarray(j_params["layers"]["input_ln"]))


@pytest.mark.parametrize("mode", ["full", "block", "upper", "lower"])
@pytest.mark.parametrize("layers", [None, (1,)], ids=["all", "layer1"])
def test_finetune_mask_matches_jax(small, mode, layers):
    jc, jp, tc, tp = small
    jd = jdistill.Distiller(jc, jp)
    td = tdistill.Distiller(tc, tp)
    for path, a, b in pairs(np_tree(jd.finetune_mask(mode, layers)),
                            td.finetune_mask(mode, layers)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_finetune_mask_refuses_an_unknown_mode(small):
    with pytest.raises(ValueError, match="finetune mode"):
        tdistill.Distiller(small[2], small[3]).set_finetune("embeddings")


def test_distill_pipe_two_stages_matches_jax():
    jc, jp, tc, tp = models(43, num_hidden_layers=2, intermediate_size=64,
                            num_attention_heads=8, num_key_value_heads=4)
    stages = [dict(mode="mlp", sparsity=0.5, steps=3, prune_steps=2, lr=1e-3),
              dict(mode="head", sparsity=0.5, steps=3, prune_steps=2, lr=1e-3)]
    j_cfg, j_params, jh = jdistill.DistillPipe(
        jc, jp, [jdistill.DistillStage(**s) for s in stages]).run(batches(jc.vocab_size, 47))
    pipe = tdistill.DistillPipe(tc, tp, [tdistill.DistillStage(**s) for s in stages])
    t_cfg, t_params, th = pipe.run(batches(tc.vocab_size, 47))
    assert len(jh) == len(th) == 6
    for a, b in zip(jh, th):
        for k, rel in LOSS_REL.items():
            assert abs(a[k] - b[k]) <= rel * abs(a[k]), (k, a, b)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.intermediate_size, t_cfg.num_key_value_heads) == (32, 2)
    for path, a, b in pairs(np_tree(j_params), t_params):
        assert a.shape == b.shape, path


# ---------------------------------------------------------------------------
# the teacher cache, evaluate
# ---------------------------------------------------------------------------

def test_teacher_cache_shares_the_jax_key_and_files(small, stepped, tmp_path):
    jc, jp, tc, tp = small
    jd, state = stepped
    td = port_at(small, state)
    toks = next(batches(tc.vocab_size, 53))
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    jl, jh = jd._teacher_cached(jnp.asarray(toks), str(j_dir))
    tl, th = td._teacher_cached(torch.as_tensor(toks), str(t_dir))
    assert os.listdir(j_dir) == os.listdir(t_dir)  # one file, the same name
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    # the port reads the file JAX wrote, as it is, without a teacher forward
    td.teacher = None
    rl, rh = td._teacher_cached(torch.as_tensor(toks), str(j_dir))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(rh.numpy(), np.asarray(jh))
    assert len(os.listdir(j_dir)) == 1


def test_evaluate_matches_jax(small, stepped):
    jd, state = stepped
    td = port_at(small, state)
    je = jd.evaluate(batches(td.cfg.vocab_size, 59), batches=2)
    te = td.evaluate(batches(td.cfg.vocab_size, 59), batches=2)
    for k in ("teacher_ppl", "student_ppl"):
        assert abs(te[k] - je[k]) <= 1e-5 * je[k], (k, je, te)
    assert te["top1_agreement"] == je["top1_agreement"]


# ---------------------------------------------------------------------------
# port only: resume, serving the pruned model, refusals
# ---------------------------------------------------------------------------

def test_save_load_resumes_bit_for_bit(small, tmp_path):
    jc, jp, tc, tp = small
    kw = dict(lr=1e-3, hidden_weight=0.5, target_mlp_sparsity=0.25, prune_steps=4,
              total_steps=8)
    d = tdistill.Distiller(tc, tp, tdistill.DistillConfig(**kw))
    d.fit(batches(tc.vocab_size, 61), steps=3)
    path = str(tmp_path / "distill.pt")
    d.save(path)
    d2 = tdistill.Distiller(tc, tp, tdistill.DistillConfig(**kw))
    d2.load(path)
    assert d2.step_idx == 3 and d2.history == d.history
    d.fit(batches(tc.vocab_size, 67), steps=2)
    d2.fit(batches(tc.vocab_size, 67), steps=2)
    for tree in ("student", "masks", "_saliency"):
        for path_, a, b in pairs(t_np(getattr(d, tree)), getattr(d2, tree)):
            np.testing.assert_array_equal(a, b, err_msg=path_)
    for path_, a, b in pairs(t_np(d.opt_state.mu), d2.opt_state.mu):
        np.testing.assert_array_equal(a, b, err_msg=path_)
    assert d.history == d2.history


def test_pruned_model_serves_the_tokens_of_jax(small):
    jc, jp, tc, tp = models(71, num_hidden_layers=3, intermediate_size=64,
                            num_attention_heads=8, num_key_value_heads=4)
    jd = jdistill.Distiller(jc, jp)
    td = tdistill.Distiller(tc, tp)
    jd.masks = jax.tree.map(jnp.asarray, reparam_masks(tc))
    distill_state_from_jax(td, jax_state(jd))
    j_cfg, j_params = jd.reparam()
    t_cfg, t_params = td.reparam()
    ecfg = dict(page_size=16, max_seq_len=128, max_concurrency=2, eos_token_id=-2)
    prompts = [[5, 6, 7, 8] * 3, [300, 301, 302]]
    j_out = JLLM(cfg=j_cfg, params=j_params, ecfg=JEngineConfig(**ecfg),
                 dtype=jnp.float32).generate(prompts, JSP(max_new_tokens=8))
    t_out = TLLM(cfg=t_cfg, params=t_params, ecfg=TEngineConfig(**ecfg), dtype=torch.float32,
                 device="cpu").generate(prompts, TSP(max_new_tokens=8))
    assert [r.output_ids for r in t_out] == [r.output_ids for r in j_out]
    assert all(len(r.output_ids) == 8 for r in t_out)


REFUSED = {
    "qkv biases": dict(attention_bias=True),
    "output-projection biases": dict(attention_out_bias=True),
    "layer norm": dict(norm_type="layernorm"),
    "alibi positions": dict(position_embedding_type="alibi"),
    "an un-gated MLP": dict(gated_mlp=False),
    "gelu_new activation": dict(hidden_act="gelu_new"),
    "parallel residual": dict(parallel_residual=True),
    "partial rope": dict(partial_rotary_factor=0.5),
    "interleaved rope": dict(rope_interleaved=True),
    "Mixture-of-Experts layers": dict(model_type="mixtral", num_experts=4,
                                      num_experts_per_tok=2),
    "Multi-head Latent Attention": dict(model_type="deepseek_v2", kv_lora_rank=32,
                                        qk_nope_head_dim=16, qk_rope_head_dim=8,
                                        v_head_dim=16),
    "linear-attention layers": dict(model_type="ring_linear", linear_attention=True,
                                    layer_group_size=2),
    "YaRN's attention factor": dict(rope_scaling={"type": "yarn", "factor": 4.0,
                                                  "original_max_position_embeddings": 64}),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_unmodelled_configs_are_refused(small, what):
    """The JAX training forward trains a plain llama whatever the config
    says; the port refuses, naming what it does not model."""
    tc = TModelConfig.tiny(num_hidden_layers=2, intermediate_size=64, **REFUSED[what])
    toks = torch.as_tensor(next(batches(tc.vocab_size, 73)))
    with pytest.raises(NotImplementedError, match=what):
        t_forward(small[3], tc, toks)
    with pytest.raises(NotImplementedError, match=what):
        tdistill.Distiller(tc, small[3])
