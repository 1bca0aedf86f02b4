"""HF checkpoints -> the port's stacked parameters.

Port of ``painlessinferenceacceleration_tpu/models/hf_loader.py``: the
safetensors shards of a model directory are read with the port's own reader
(``utils/safetensors.py``: memory-mapped, no ``safetensors`` or
``transformers`` package), each family's keys are mapped onto the stacked
tree the models run (q|k|v and gate|up merged along the output axis, weights
transposed to ``[in, out]``), and the linears are quantized leaf by leaf on
the target device with ``layers/linear.py`` ``make_linear``. A leaf is
read from the mapped file, widened to fp32 on the device, rounded to
``dtype`` and quantized there; the stack is written one layer at a time, so
neither a bf16 model nor a list of its layers sits beside its quantized copy.
Every leaf is a fresh tensor (``models/mla.py`` caches a ``kv_b``'s
absorption layout by tensor identity).

The key schemes are the JAX loader's: llama / mistral / qwen2 / qwen3 /
internlm (biases, QK norm), MoE (mixtral's ``block_sparse_moe`` or the
qwen3_moe / deepseek ``mlp.experts`` naming, shared experts, the router's
score-correction bias) and MLA, with DeepSeek-V3's pre-quantized 128x128
fp8 blocks loaded as they are (``weight_scale_inv``); opt, gptj, baichuan
(W_pack, Baichuan2's normalised head), qwen1, the Ring / Bailing linear
hybrids (with their decay law), gpt2, AntGLM, bloom and chatglm. Leaf for
leaf the tree equals ``models/convert.py`` ``params_from_jax`` of the JAX
loader's on the same state dict, quantized leaves included.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device
from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec, make_linear
from painlessinferenceacceleration_tpu_torch.models.base import _stack_leaves
from painlessinferenceacceleration_tpu_torch.utils.safetensors import read_safetensors


def quant_from_hf_config(conf: dict) -> Optional[QuantSpec]:
    """The spec of a pre-quantized checkpoint's ``quantization_config``: fp8
    with 128x128 weight blocks is the DeepSeek-V3 block format; None when
    the checkpoint is unquantized or of another format."""
    qc = conf.get("quantization_config") or {}
    if qc.get("quant_method") == "fp8":
        bs = qc.get("weight_block_size") or [128, 128]
        if list(bs) == [128, 128]:
            return QuantSpec.from_mode("fp8_block")
    return None


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF model directory's safetensors shards (through
    ``model.safetensors.index.json`` when there is one), viewing the mapped
    files."""
    return read_safetensors(path)


class _Reader:
    """Leaves of a state dict on the target device: ``get`` a key widened
    to fp32, ``j`` a tensor rounded to the parameter dtype."""

    def __init__(self, sd, dtype, dev, prefixes=("",)):
        self.sd, self.dtype, self.dev, self.prefixes = sd, dtype, dev, prefixes

    def key(self, k: str) -> str:
        for p in self.prefixes:
            if p + k in self.sd:
                return p + k
        raise KeyError(k)

    def get(self, k: str) -> torch.Tensor:
        return self.sd[self.key(k)].to(self.dev).to(torch.float32)

    def j(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype).contiguous()

    def lin(self, w_in_out: torch.Tensor, quant) -> object:
        """A linear leaf from an fp32 [in, out] weight: rounded to the dtype,
        then quantized (the JAX loader's ``make_linear(j(w), quant)``)."""
        return make_linear(self.j(w_in_out), quant)


def _prequant_leaf(r: _Reader, key: str) -> dict:
    """A pre-quantized fp8-block leaf as stored: weight [N, K] e4m3 and
    weight_scale_inv [N/128, K/128] f32 transposed to [K, N] / [kb, nb],
    the original scales kept (no requantization)."""
    q = r.sd[key + ".weight"].to(r.dev).view(torch.uint8).t().contiguous()
    s = r.sd[key + ".weight_scale_inv"].to(r.dev).to(torch.float32).t().contiguous()
    return {"q": q.view(torch.float8_e4m3fn), "s": s}


def _stacked(make_layer, n: int) -> dict:
    """``n`` layers of ``make_layer(i)`` stacked [n, ...], one layer at a
    time into the stacked storage."""
    counter = iter(range(n))
    return _stack_leaves(lambda: make_layer(next(counter)), n)


def _expert_stack(r: _Reader, ws, quant) -> object:
    """[X, in, out] experts: quantized expert by expert from fp32 (the JAX
    loader's vmap of make_linear over the fp32 stack), or rounded to the
    dtype."""
    if quant is None:
        return r.j(torch.stack(ws))
    leaves = [make_linear(w, quant) for w in ws]
    return {k: torch.stack([p[k] for p in leaves]) for k in leaves[0]}


def params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig,
                           dtype=torch.bfloat16, quant: Optional[QuantSpec] = None,
                           device=None) -> dict:
    """Map an HF state dict to the port's parameter tree on ``device``
    (``cuda`` unless asked otherwise); the family follows ``cfg``."""
    dev = resolve_device(device)
    families = {"gpt2": _params_gpt2, "bloom": _params_bloom, "opt": _params_opt,
                "gptj": _params_gptj, "baichuan": _params_baichuan, "qwen": _params_qwen1}
    if cfg.model_type in families:
        return families[cfg.model_type](sd, cfg, dtype, quant, dev)
    if cfg.model_type in ("chatglm", "glm"):
        fn = _params_glm if cfg.position_embedding_type == "glm_2d" else _params_chatglm
        return fn(sd, cfg, dtype, quant, dev)
    if cfg.linear_attention:
        return _params_bailing_linear(sd, cfg, dtype, quant, dev)
    return _params_llama(sd, cfg, dtype, quant, dev)


def _params_llama(sd, cfg, dtype, quant, dev):
    """llama / mistral / qwen2 (qkv bias) / qwen3 (QK norm) / internlm
    (output bias), their MoE forms and MLA."""
    r = _Reader(sd, dtype, dev)
    # pre-quantized fp8-block checkpoints (DeepSeek-V3 format) carry
    # weight_scale_inv tensors: those leaves load with their own scales;
    # leaves without (norms, embedding, the bf16 head) stay plain
    has_scale_inv = any(k.endswith(".weight_scale_inv") for k in sd)
    prequant = (has_scale_inv and quant is not None and quant.wfmt == "fp8"
                and quant.block == 128)
    if has_scale_inv and not prequant:
        raise ValueError(
            "checkpoint is pre-quantized fp8-block (weight_scale_inv tensors present); "
            "pass quant=None (auto-detect) or quant='fp8_block' — re-quantizing fp8 "
            f"payloads to {quant!r} is not supported")

    def lin(key):  # key without the ".weight" suffix
        if prequant and key + ".weight_scale_inv" in sd:
            return _prequant_leaf(r, key)
        return r.lin(r.get(key + ".weight").t(), quant)

    def lin_fused(keys):  # concatenated along the output axis
        if prequant and all(k + ".weight_scale_inv" in sd for k in keys):
            leaves = [_prequant_leaf(r, k) for k in keys]
            return {"q": torch.cat([p["q"] for p in leaves], dim=1),
                    "s": torch.cat([p["s"] for p in leaves], dim=1)}
        return r.lin(torch.cat([r.get(k + ".weight").t() for k in keys], dim=1), quant)

    def moe_leaves(p: str) -> dict:
        X = cfg.num_experts
        if p + "block_sparse_moe.gate.weight" in sd:  # mixtral
            gate_key = p + "block_sparse_moe.gate.weight"
            e = p + "block_sparse_moe.experts.{x}."
            names = ("w1", "w3", "w2")  # gate, up, down
        else:  # qwen3_moe / deepseek routed experts
            gate_key = p + "mlp.gate.weight"
            e = p + "mlp.experts.{x}."
            names = ("gate_proj", "up_proj", "down_proj")
        out = {"router": r.j(r.get(gate_key).t())}
        bias_key = gate_key.replace(".weight", ".e_score_correction_bias")
        if bias_key in sd:
            out["router_bias"] = r.get(bias_key).contiguous()
        if prequant and e.format(x=0) + names[0] + ".weight_scale_inv" in sd:
            def stk(fused):
                qs, ss = [], []
                for x in range(X):
                    leaves = [_prequant_leaf(r, e.format(x=x) + n) for n in fused]
                    qs.append(torch.cat([p["q"] for p in leaves], dim=1))
                    ss.append(torch.cat([p["s"] for p in leaves], dim=1))
                return {"q": torch.stack(qs), "s": torch.stack(ss)}
            out["moe_wgu"] = stk(names[:2])
            out["moe_wdown"] = stk(names[2:])
        else:
            out["moe_wgu"] = _expert_stack(r, [torch.cat(
                [r.get(e.format(x=x) + names[0] + ".weight").t(),
                 r.get(e.format(x=x) + names[1] + ".weight").t()], dim=1)
                for x in range(X)], quant)
            out["moe_wdown"] = _expert_stack(
                r, [r.get(e.format(x=x) + names[2] + ".weight").t() for x in range(X)], quant)
        if cfg.num_shared_experts:
            sh = p + "mlp.shared_experts."
            out["shared_wgu"] = lin_fused([sh + "gate_proj", sh + "up_proj"])
            out["shared_wdown"] = lin(sh + "down_proj")
        return out

    def layer(i: int, moe: bool) -> dict:
        p = f"model.layers.{i}."
        lp = {"input_ln": r.j(r.get(p + "input_layernorm.weight")),
              "post_ln": r.j(r.get(p + "post_attention_layernorm.weight"))}
        a = p + "self_attn."
        if cfg.is_mla:  # deepseek v2 / v3 latent attention projections
            lp["kv_a"] = lin(a + "kv_a_proj_with_mqa")
            lp["kv_a_ln"] = r.j(r.get(a + "kv_a_layernorm.weight"))
            lp["kv_b"] = lin(a + "kv_b_proj")
            lp["wo"] = lin(a + "o_proj")
            if cfg.q_lora_rank:
                lp["q_a"] = lin(a + "q_a_proj")
                lp["q_a_ln"] = r.j(r.get(a + "q_a_layernorm.weight"))
                lp["q_b"] = lin(a + "q_b_proj")
            else:
                lp["wq"] = lin(a + "q_proj")
        else:
            lp["wqkv"] = lin_fused([a + "q_proj", a + "k_proj", a + "v_proj"])
            lp["wo"] = lin(a + "o_proj")
            if cfg.attention_bias:
                lp["bqkv"] = r.j(torch.cat([r.get(a + f"{n}_proj.bias") for n in "qkv"]))
            elif a + "q_proj.bias" in sd:
                raise ValueError(f"{a}q_proj.bias: the checkpoint has q / k / v biases "
                                 f"that its config does not declare (attention_bias)")
            if cfg.attention_out_bias and a + "o_proj.bias" in sd:
                lp["bo"] = r.j(r.get(a + "o_proj.bias"))  # internlm
            if cfg.qk_norm:
                lp["q_norm"] = r.j(r.get(a + "q_norm.weight"))
                lp["k_norm"] = r.j(r.get(a + "k_norm.weight"))
        if moe:
            lp.update(moe_leaves(p))
        else:
            lp["wgu"] = lin_fused([p + "mlp.gate_proj", p + "mlp.up_proj"])
            lp["wdown"] = lin(p + "mlp.down_proj")
        return lp

    n = cfg.num_hidden_layers
    n_dense = min(cfg.moe_layer_start, n) if cfg.is_moe else n
    params = {"embed": r.j(r.get("model.embed_tokens.weight")),
              "final_ln": r.j(r.get("model.norm.weight"))}
    if n_dense:
        params["layers"] = _stacked(lambda i: layer(i, False), n_dense)
    if n > n_dense:
        params["moe_layers"] = _stacked(lambda i: layer(n_dense + i, True), n - n_dense)
    if not cfg.tie_word_embeddings:
        # pre-quantized checkpoints ship the head in bf16 on purpose: it is
        # not quantized again
        params["lm_head"] = r.lin(r.get("lm_head.weight").t(), None if prequant else quant)
    return params


def _params_opt(sd, cfg, dtype, quant, dev):
    """OPTForCausalLM. The learned position table carries a +2 offset (HF
    OPTLearnedPositionalEmbedding): its first two rows are dropped so that
    plain positions index it. Assumes do_layer_norm_before and
    word_embed_proj_dim == hidden_size (the 125m..13b family)."""
    r = _Reader(sd, dtype, dev, ("model.decoder.", ""))

    def layer(i):
        p = f"layers.{i}."
        a = p + "self_attn."
        return {
            "input_ln": r.j(r.get(p + "self_attn_layer_norm.weight")),
            "input_ln_b": r.j(r.get(p + "self_attn_layer_norm.bias")),
            "post_ln": r.j(r.get(p + "final_layer_norm.weight")),
            "post_ln_b": r.j(r.get(p + "final_layer_norm.bias")),
            "wqkv": r.lin(torch.cat([r.get(a + f"{n}_proj.weight").t() for n in "qkv"],
                                    dim=1), quant),
            "bqkv": r.j(torch.cat([r.get(a + f"{n}_proj.bias") for n in "qkv"])),
            "wo": r.lin(r.get(a + "out_proj.weight").t(), quant),
            "bo": r.j(r.get(a + "out_proj.bias")),
            "wgu": r.lin(r.get(p + "fc1.weight").t(), quant),
            "bgu": r.j(r.get(p + "fc1.bias")),
            "wdown": r.lin(r.get(p + "fc2.weight").t(), quant),
            "bdown": r.j(r.get(p + "fc2.bias")),
        }

    return {"embed": r.j(r.get("embed_tokens.weight")),
            "pos_embed": r.j(r.get("embed_positions.weight")[2:]),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("final_layer_norm.weight")),
            "final_ln_b": r.j(r.get("final_layer_norm.bias"))}


def _params_gptj(sd, cfg, dtype, quant, dev):
    """GPTJForCausalLM: ln_1 feeds attention and the MLP (parallel
    residual, no post norm); rope is interleaved over the first rotary_dim
    lanes; the head carries a bias."""
    r = _Reader(sd, dtype, dev, ("transformer.", ""))

    def layer(i):
        p = f"h.{i}."
        return {
            "input_ln": r.j(r.get(p + "ln_1.weight")),
            "input_ln_b": r.j(r.get(p + "ln_1.bias")),
            "wqkv": r.lin(torch.cat([r.get(p + f"attn.{n}_proj.weight").t() for n in "qkv"],
                                    dim=1), quant),
            "wo": r.lin(r.get(p + "attn.out_proj.weight").t(), quant),
            "wgu": r.lin(r.get(p + "mlp.fc_in.weight").t(), quant),
            "bgu": r.j(r.get(p + "mlp.fc_in.bias")),
            "wdown": r.lin(r.get(p + "mlp.fc_out.weight").t(), quant),
            "bdown": r.j(r.get(p + "mlp.fc_out.bias")),
        }

    params = {"embed": r.j(r.get("wte.weight")),
              "layers": _stacked(layer, cfg.num_hidden_layers),
              "final_ln": r.j(r.get("ln_f.weight")),
              "final_ln_b": r.j(r.get("ln_f.bias")),
              "lm_head": r.lin(r.get("lm_head.weight").t(), quant)}
    if "lm_head.bias" in sd:
        params["lm_head_b"] = r.j(r.get("lm_head.bias"))
    return params


def _params_baichuan(sd, cfg, dtype, quant, dev):
    """BaichuanForCausalLM: W_pack fuses q|k|v along the output axis ([3E,
    E]); 13B checkpoints (40 heads) use ALiBi (``from_hf`` sets it).
    Baichuan2 (vocab 125696) L2-normalises each head row at inference, baked
    into the weights here; Baichuan1 (vocab 64000) passes unchanged."""
    r = _Reader(sd, dtype, dev)
    E = cfg.hidden_size

    def layer(i):
        p = f"model.layers.{i}."
        wpack = r.get(p + "self_attn.W_pack.weight")  # [3E, E]
        return {
            "input_ln": r.j(r.get(p + "input_layernorm.weight")),
            "post_ln": r.j(r.get(p + "post_attention_layernorm.weight")),
            "wqkv": r.lin(torch.cat([wpack[:E].t(), wpack[E:2 * E].t(), wpack[2 * E:].t()],
                                    dim=1), quant),
            "wo": r.lin(r.get(p + "self_attn.o_proj.weight").t(), quant),
            "wgu": r.lin(torch.cat([r.get(p + "mlp.gate_proj.weight").t(),
                                    r.get(p + "mlp.up_proj.weight").t()], dim=1), quant),
            "wdown": r.lin(r.get(p + "mlp.down_proj.weight").t(), quant),
        }

    head = r.get("lm_head.weight")  # [V, E]
    if cfg.vocab_size >= 125696:  # Baichuan2's NormHead
        head = head / torch.linalg.vector_norm(head, dim=1, keepdim=True).clamp(min=1e-7)
    return {"embed": r.j(r.get("model.embed_tokens.weight")),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("model.norm.weight")),
            "lm_head": r.lin(head.t(), quant)}


def _params_qwen1(sd, cfg, dtype, quant, dev):
    """QWenLMHeadModel (qwen1): c_attn fuses q|k|v with a bias; the MLP is a
    half-width swiglu whose w2 is the gate and w1 the up projection
    (``cfg.intermediate_size`` is already the half width)."""
    r = _Reader(sd, dtype, dev, ("transformer.", ""))

    def layer(i):
        p = f"h.{i}."
        return {
            "input_ln": r.j(r.get(p + "ln_1.weight")),
            "post_ln": r.j(r.get(p + "ln_2.weight")),
            "wqkv": r.lin(r.get(p + "attn.c_attn.weight").t(), quant),
            "bqkv": r.j(r.get(p + "attn.c_attn.bias")),
            "wo": r.lin(r.get(p + "attn.c_proj.weight").t(), quant),
            "wgu": r.lin(torch.cat([r.get(p + "mlp.w2.weight").t(),
                                    r.get(p + "mlp.w1.weight").t()], dim=1), quant),
            "wdown": r.lin(r.get(p + "mlp.c_proj.weight").t(), quant),
        }

    return {"embed": r.j(r.get("wte.weight")),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("ln_f.weight")),
            "lm_head": r.lin(r.get("lm_head.weight").t(), quant)}


def _params_bailing_linear(sd, cfg, dtype, quant, dev):
    """BailingMoeLinearV2ForCausalLM: ``model.layers.{i}.attention.*`` with
    g_proj / g_norm on the linear layers, ``model.word_embeddings``, each
    linear layer's decay law computed from its index, and the MoE MLP
    (``mlp.gate`` with ``gate.expert_bias``, ``mlp.experts.{x}``,
    ``mlp.shared_experts``) or a dense one. ``hybrid_layers`` is a list, one
    dict a layer."""
    from painlessinferenceacceleration_tpu_torch.models.linear_attn import is_full_layer

    r = _Reader(sd, dtype, dev)
    H, L = cfg.num_attention_heads, cfg.num_hidden_layers

    def decay_scales(li: int) -> torch.Tensor:
        # per query head (no GQA), computed in float32 numpy as the JAX loader does
        start = 2.0 ** (-(2.0 ** -(math.log2(H) - 3.0)))
        exps = np.arange(1, H + 1, dtype=np.float32)
        d = np.power(start, exps) * (1.0 - li / max(L - 1, 1) + 1e-5)
        return torch.from_numpy(np.asarray(d, np.float32)).to(dev)

    def mlp(p: str, lp: dict) -> None:
        if cfg.is_moe and p + "mlp.gate.weight" in sd:
            X = cfg.num_experts
            e = p + "mlp.experts.{x}."
            lp["router"] = r.j(r.get(p + "mlp.gate.weight").t())
            if p + "mlp.gate.expert_bias" in sd:
                lp["router_bias"] = r.get(p + "mlp.gate.expert_bias").contiguous()
            lp["moe_wgu"] = _expert_stack(r, [torch.cat(
                [r.get(e.format(x=x) + "gate_proj.weight").t(),
                 r.get(e.format(x=x) + "up_proj.weight").t()], dim=1) for x in range(X)],
                quant)
            lp["moe_wdown"] = _expert_stack(
                r, [r.get(e.format(x=x) + "down_proj.weight").t() for x in range(X)], quant)
            if cfg.num_shared_experts:
                sh = p + "mlp.shared_experts."
                lp["shared_wgu"] = r.lin(torch.cat([r.get(sh + "gate_proj.weight").t(),
                                                    r.get(sh + "up_proj.weight").t()],
                                                   dim=1), quant)
                lp["shared_wdown"] = r.lin(r.get(sh + "down_proj.weight").t(), quant)
        else:
            lp["wgu"] = r.lin(torch.cat([r.get(p + "mlp.gate_proj.weight").t(),
                                         r.get(p + "mlp.up_proj.weight").t()], dim=1), quant)
            lp["wdown"] = r.lin(r.get(p + "mlp.down_proj.weight").t(), quant)

    layers = []
    for i in range(L):
        p = f"model.layers.{i}."
        a = p + "attention."
        lp = {"input_ln": r.j(r.get(p + "input_layernorm.weight")),
              "post_ln": r.j(r.get(p + "post_attention_layernorm.weight")),
              "wqkv": r.lin(r.get(a + "query_key_value.weight").t(), quant),
              "wo": r.lin(r.get(a + "dense.weight").t(), quant)}
        if cfg.attention_bias and a + "query_key_value.bias" in sd:
            lp["bqkv"] = r.j(r.get(a + "query_key_value.bias"))
        if cfg.attention_out_bias and a + "dense.bias" in sd:
            lp["bo"] = r.j(r.get(a + "dense.bias"))
        if is_full_layer(cfg, i):
            if cfg.qk_norm:
                lp["q_norm"] = r.j(r.get(a + "query_layernorm.weight"))
                lp["k_norm"] = r.j(r.get(a + "key_layernorm.weight"))
        else:
            lp["w_gate"] = r.lin(r.get(a + "g_proj.weight").t(), quant)
            lp["out_norm"] = r.j(r.get(a + "g_norm.weight"))
            lp["decay"] = decay_scales(i)
            if cfg.linear_qk_norm:
                lp["q_norm"] = r.j(r.get(a + "query_layernorm.weight"))
                lp["k_norm"] = r.j(r.get(a + "key_layernorm.weight"))
        mlp(p, lp)
        layers.append(lp)
    params = {"embed": r.j(r.get("model.word_embeddings.weight")), "hybrid_layers": layers,
              "final_ln": r.j(r.get("model.norm.weight"))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = r.lin(r.get("lm_head.weight").t(), quant)
    return params


def _params_gpt2(sd, cfg, dtype, quant, dev):
    """GPT2LMHeadModel: Conv1D weights are already [in, out]; c_attn is
    q|k|v along the output axis; the head is tied."""
    r = _Reader(sd, dtype, dev, ("", "transformer."))

    def layer(i):
        p = f"h.{i}."
        return {
            "input_ln": r.j(r.get(p + "ln_1.weight")),
            "input_ln_b": r.j(r.get(p + "ln_1.bias")),
            "post_ln": r.j(r.get(p + "ln_2.weight")),
            "post_ln_b": r.j(r.get(p + "ln_2.bias")),
            "wqkv": r.lin(r.get(p + "attn.c_attn.weight"), quant),
            "bqkv": r.j(r.get(p + "attn.c_attn.bias")),
            "wo": r.lin(r.get(p + "attn.c_proj.weight"), quant),
            "bo": r.j(r.get(p + "attn.c_proj.bias")),
            "wgu": r.lin(r.get(p + "mlp.c_fc.weight"), quant),
            "bgu": r.j(r.get(p + "mlp.c_fc.bias")),
            "wdown": r.lin(r.get(p + "mlp.c_proj.weight"), quant),
            "bdown": r.j(r.get(p + "mlp.c_proj.bias")),
        }

    return {"embed": r.j(r.get("wte.weight")), "pos_embed": r.j(r.get("wpe.weight")),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("ln_f.weight")), "final_ln_b": r.j(r.get("ln_f.bias"))}


def _params_glm(sd, cfg, dtype, quant, dev):
    """GLMForConditionalGeneration (AntGLM): two learned position tables,
    LayerNorm blocks, fused query_key_value ordered q|k|v, a GELU MLP
    (dense_h_to_4h / dense_4h_to_h) and a tied head."""
    r = _Reader(sd, dtype, dev, ("", "glm.", "glm.transformer.", "transformer."))

    def layer(i):
        p = f"layers.{i}."
        return {
            "input_ln": r.j(r.get(p + "input_layernorm.weight")),
            "input_ln_b": r.j(r.get(p + "input_layernorm.bias")),
            "post_ln": r.j(r.get(p + "post_attention_layernorm.weight")),
            "post_ln_b": r.j(r.get(p + "post_attention_layernorm.bias")),
            "wqkv": r.lin(r.get(p + "attention.query_key_value.weight").t(), quant),
            "bqkv": r.j(r.get(p + "attention.query_key_value.bias")),
            "wo": r.lin(r.get(p + "attention.dense.weight").t(), quant),
            "bo": r.j(r.get(p + "attention.dense.bias")),
            "wgu": r.lin(r.get(p + "mlp.dense_h_to_4h.weight").t(), quant),
            "bgu": r.j(r.get(p + "mlp.dense_h_to_4h.bias")),
            "wdown": r.lin(r.get(p + "mlp.dense_4h_to_h.weight").t(), quant),
            "bdown": r.j(r.get(p + "mlp.dense_4h_to_h.bias")),
        }

    return {"embed": r.j(r.get("word_embeddings.weight")),
            "pos_embed": r.j(r.get("position_embeddings.weight")),
            "block_pos_embed": r.j(r.get("block_position_embeddings.weight")),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("final_layernorm.weight")),
            "final_ln_b": r.j(r.get("final_layernorm.bias"))}


def _params_bloom(sd, cfg, dtype, quant, dev):
    """BloomForCausalLM: qkv is fused per head, [H * 3 * D, E] viewed as
    [H, 3, D, E], and is regrouped into the q|k|v blocks; the head is tied."""
    r = _Reader(sd, dtype, dev, ("", "transformer."))
    H, D = cfg.num_attention_heads, cfg.head_dim

    def layer(i):
        p = f"h.{i}."
        a = p + "self_attention."
        w = r.get(a + "query_key_value.weight").reshape(H, 3, D, -1)
        b = r.get(a + "query_key_value.bias").reshape(H, 3, D)
        wqkv = torch.cat([w[:, c].reshape(H * D, -1) for c in range(3)]).t()  # [E, 3HD]
        return {
            "input_ln": r.j(r.get(p + "input_layernorm.weight")),
            "input_ln_b": r.j(r.get(p + "input_layernorm.bias")),
            "post_ln": r.j(r.get(p + "post_attention_layernorm.weight")),
            "post_ln_b": r.j(r.get(p + "post_attention_layernorm.bias")),
            "wqkv": r.lin(wqkv, quant),
            "bqkv": r.j(torch.cat([b[:, c].reshape(-1) for c in range(3)])),
            "wo": r.lin(r.get(a + "dense.weight").t(), quant),
            "bo": r.j(r.get(a + "dense.bias")),
            "wgu": r.lin(r.get(p + "mlp.dense_h_to_4h.weight").t(), quant),
            "bgu": r.j(r.get(p + "mlp.dense_h_to_4h.bias")),
            "wdown": r.lin(r.get(p + "mlp.dense_4h_to_h.weight").t(), quant),
            "bdown": r.j(r.get(p + "mlp.dense_4h_to_h.bias")),
        }

    return {"embed": r.j(r.get("word_embeddings.weight")),
            "embed_ln": r.j(r.get("word_embeddings_layernorm.weight")),
            "embed_ln_b": r.j(r.get("word_embeddings_layernorm.bias")),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("ln_f.weight")), "final_ln_b": r.j(r.get("ln_f.bias"))}


def _params_chatglm(sd, cfg, dtype, quant, dev):
    """ChatGLM2 / 3: query_key_value fused q|k|v block-wise (MQA: k and v
    have Hk * D rows); dense_h_to_4h is gate|up (swiglu)."""
    r = _Reader(sd, dtype, dev, ("", "transformer.", "transformer.encoder."))

    def layer(i):
        p = f"layers.{i}."
        a = p + "self_attention."
        lp = {"input_ln": r.j(r.get(p + "input_layernorm.weight")),
              "post_ln": r.j(r.get(p + "post_attention_layernorm.weight")),
              "wqkv": r.lin(r.get(a + "query_key_value.weight").t(), quant),
              "wo": r.lin(r.get(a + "dense.weight").t(), quant),
              "wgu": r.lin(r.get(p + "mlp.dense_h_to_4h.weight").t(), quant),
              "wdown": r.lin(r.get(p + "mlp.dense_4h_to_h.weight").t(), quant)}
        if cfg.attention_bias:
            lp["bqkv"] = r.j(r.get(a + "query_key_value.bias"))
        return lp

    return {"embed": r.j(r.get("embedding.word_embeddings.weight")),
            "layers": _stacked(layer, cfg.num_hidden_layers),
            "final_ln": r.j(r.get("final_layernorm.weight")),
            "lm_head": r.lin(r.get("output_layer.weight").t(), quant)}


def read_config(path: str) -> dict:
    """The ``config.json`` of a model directory (or the file itself)."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        return json.load(f)


def load_model(path: str, dtype=torch.bfloat16, quant: Optional[QuantSpec] = None,
               device=None):
    """(ModelConfig, params, QuantSpec) from an HF model directory, the
    parameters on ``device`` (``cuda`` unless asked otherwise). A checkpoint
    whose ``quantization_config`` is the 128x128-block fp8 format adopts
    that spec when none is forced, and its fp8 weights load with their own
    scales."""
    conf = read_config(path)
    cfg = ModelConfig.from_hf(conf)
    auto = quant_from_hf_config(conf)
    if quant is None and auto is not None:
        quant = auto
    sd = load_hf_state_dict(path)
    return cfg, params_from_state_dict(sd, cfg, dtype, quant, device), quant


def params_from_torch_model(model, cfg: ModelConfig, dtype=torch.float32,
                            quant: Optional[QuantSpec] = None, device=None) -> dict:
    """The parameters of an in-memory HF torch model (``state_dict()``)."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    if cfg.tie_word_embeddings:
        sd.pop("lm_head.weight", None)
    return params_from_state_dict(sd, cfg, dtype, quant, device)
