"""Shared pieces of the port's parallel serving tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel4.py``): the
tiny model families (MLA in latent and, ``mla_x``, expanded mode), the case
dicts that ``tests/torch_dist_worker.py`` runs (quantized parameters and
multimodal requests too), and the JAX single-device references they are
held against."""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from painlessinferenceacceleration_tpu.config import EngineConfig as JEngineConfig
from painlessinferenceacceleration_tpu.config import ModelConfig as JModelConfig
from painlessinferenceacceleration_tpu.engine.cache import init_kv_cache as j_init_kv
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.engine.request import SamplingParams as JSP
from painlessinferenceacceleration_tpu.engine.step import prefill_step as j_prefill
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params

from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax

MOE = dict(model_type="qwen3_moe", vocab_size=128, hidden_size=64, intermediate_size=96,
           moe_intermediate_size=64, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4, num_experts=4, num_experts_per_tok=2, moe_layer_start=0)
MLA = dict(model_type="deepseek_v3", vocab_size=128, hidden_size=64, intermediate_size=96,
           moe_intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, moe_layer_start=1, num_experts=4,
           num_experts_per_tok=2, num_shared_experts=1, scoring_func="sigmoid",
           mla_latent_cache=True)
HYBRID = dict(model_type="bailing_moe_linear", vocab_size=128, hidden_size=64,
              intermediate_size=96, num_hidden_layers=4, num_attention_heads=8,
              num_key_value_heads=8, layer_group_size=4, linear_attention=True)
DENSE = dict(num_key_value_heads=4, num_attention_heads=8)

MLA_X = dict(MLA, mla_latent_cache=False)

PROMPTS = [[11, 22, 33, 44, 55] * 3, [7, 8, 9] * 4, [5, 6] * 5, [3, 1, 4, 1, 5, 9, 2, 6]]
NEW = 12
BASE = dict(page_size=16, max_seq_len=128, max_concurrency=4, eos_token_id=-2,
            decode_buckets=(1, 2, 4), prefill_chunk=32)
LOOK = dict(use_lookahead=True, decoding_length=8, branch_length=4,
            use_spec_min_batch_size=4)


def cfgs(kind):
    """(JAX, port) ModelConfig of a family: dense, moe, mla, mla_x, hybrid,
    ep, moe_q (moe with an intermediate width other than the hidden one,
    so that the down products' activations are told apart by their
    width)."""
    if kind == "dense":
        return JModelConfig.tiny(**DENSE), TModelConfig.tiny(**DENSE)
    over = {"moe": MOE, "mla": MLA, "mla_x": MLA_X, "hybrid": HYBRID,
            "ep": dict(MOE, expert_parallel=True),
            "moe_q": dict(MOE, moe_intermediate_size=96)}
    return JModelConfig(**over[kind]), TModelConfig(**over[kind])


def jparams(jc, seed=0, quant=None):
    if jc.linear_attention:
        from painlessinferenceacceleration_tpu.models.linear_attn import init_hybrid_params

        return init_hybrid_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return j_init_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32, quant=quant)


def tparams(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def port_params(kind, seed=1, quant=None):
    """A family's fp32 parameters drawn by the port (fast: the worker
    processes can start at once), quantized by the port to the mode
    ``quant`` where given, and the same tensors as a JAX tree."""
    import torch

    tc = cfgs(kind)[1]
    g = torch.Generator().manual_seed(seed)
    if tc.linear_attention:
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            init_hybrid_params,
        )

        tp = init_hybrid_params(tc, g, torch.float32, "cpu")
    else:
        from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
        from painlessinferenceacceleration_tpu_torch.models.base import init_params

        tp = init_params(tc, g, device="cpu",
                         quant=QuantSpec.from_mode(quant) if quant else None)

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return tuple(to_jax(v) for v in t)
        return jnp.asarray(t.numpy())

    return tp, to_jax(tp)


def case(name, kind, params, mesh, world, ecfg, logits=False, **extra):
    """One case for the worker: the family's port config, the whole model's
    tensors, the mesh and the engine settings over ``BASE``."""
    c = dict(name=name, world=world, cfg=dataclasses.asdict(cfgs(kind)[1]), params=params,
             mesh=mesh, ecfg=dict(BASE, **ecfg), prompts=PROMPTS, max_new=NEW, device="cpu",
             dtype="float32", **extra)
    if logits:
        c["logits_prompt"] = PROMPTS[:2]
    return c


def mm_requests(E, seed=7):
    """Multimodal embeddings for ``PROMPTS``: prompts 0 and 2 carry a few
    [M, E] rows (numpy, fp32) at prompt positions, the others none."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(3, E)).astype(np.float32), [1, 2, 9]), None,
            (rng.normal(size=(2, E)).astype(np.float32), [0, 4]), None]


def jax_reference(kind, jp, quant=None, mm=None):
    """The JAX single-device LLM's greedy tokens over ``PROMPTS`` and its
    prefill logits of the first two prompts; ``quant`` the engine's quant
    mode, ``mm`` each prompt's multimodal embeddings (``mm_requests``)."""
    from painlessinferenceacceleration_tpu.layers.linear import QuantSpec as JQuantSpec

    jc = dataclasses.replace(cfgs(kind)[0], expert_parallel=False)  # one device
    ecfg = JEngineConfig(**BASE, **({"quant": quant} if quant else {}))
    llm = JLLM(cfg=jc, params=jp, ecfg=ecfg, dtype=jnp.float32)
    sp = JSP(max_new_tokens=NEW)
    if mm is None:
        reqs = llm.generate(PROMPTS, sp)
    else:
        reqs = [llm.add_request(p, sp, mm_embeds=None if m is None else m[0],
                                mm_positions=None if m is None else m[1])
                for p, m in zip(PROMPTS, mm)]
        while any(r.state != "finished" for r in reqs):
            llm.step()
    toks = [r.output_ids for r in reqs]
    B, n = 2, max(len(p) for p in PROMPTS[:2])
    ids = np.zeros((B, n), np.int32)
    for b, p in enumerate(PROMPTS[:2]):
        ids[b, :len(p)] = p
    P = ecfg.pages_per_req
    pt = jnp.arange(1, 1 + B * P, dtype=jnp.int32).reshape(B, P)
    kv = j_init_kv(jc, ecfg, dtype=jnp.float32)
    _, _, lg = j_prefill(jp, kv, jc, jnp.asarray(ids), jnp.zeros(B, jnp.int32),
                         jnp.asarray([len(p) for p in PROMPTS[:2]], jnp.int32), pt,
                         JQuantSpec.from_mode(quant) if quant else None)
    return toks, np.asarray(lg)


def check_case(results, name, want, logits):
    """Every rank's tokens equal the JAX tokens, its logits are within 1e-4
    of JAX's, EP's block is bit-equal to the one-process expert_shards(n),
    TP's quantized expert activations to one process's columns, and it ran
    collectives."""
    for r, out in enumerate(results):
        got = out[name]
        assert got["tokens"] == want, (name, r)
        if "logits" in got:
            np.testing.assert_allclose(np.asarray(got["logits"]), logits, atol=1e-4, rtol=0,
                                       err_msg=f"{name} rank {r}")
        if "ep_block_equal" in got:
            assert got["ep_block_equal"], (name, r)
        if "tp_quant_equal" in got:
            assert got["tp_quant_equal"] is True, (name, r)
        assert got["comm_n"] > 0, name
