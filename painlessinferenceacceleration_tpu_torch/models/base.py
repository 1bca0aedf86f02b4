"""Llama-family decoder, dense or Mixture-of-Experts, with grouped-query or
Multi-head Latent Attention, and the legacy dense families, functional, over
stacked per-layer weights.

Port of ``painlessinferenceacceleration_tpu/models/base.py``: llama /
mistral / qwen2 / qwen3 / internlm / mixtral / qwen3_moe / deepseek_v2 /
deepseek_v3, and the legacy dense families gpt2, opt, gptj, bloom, glm
(AntGLM: 2D positions and prefix-LM), chatglm, baichuan and qwen1, with
their layer norms, gelu / relu MLPs (gated or not), qkv / output / MLP
biases, learned, GLM 2D, ALiBi and partial or interleaved rope positions,
bloom's embedding LayerNorm and gptj's parallel residual (the
linear-attention hybrids dispatch to ``models/linear_attn.py``). Parameters are a dict
shaped like the JAX pytree: ``layers`` holds each weight of the dense stack
stacked ``[L, ...]`` and a layer is a view ``w[li]``; qkv and gate/up are
merged GEMMs. An MoE model's layers from ``cfg.moe_layer_start`` on form a
second stack, ``moe_layers``, whose MLP is the routed-expert block of
``models/moe.py``; it runs after the dense stack and its KV layers follow
the dense ones. A Python loop over layers takes the place of ``lax.scan``,
and the KV arena is written in place. The linears take any
``QuantSpec`` (``layers/linear.py``); the embedding table may be the fp8
``{"q", "s"}`` form (``layers/embedding.py``). An MLA model
(``cfg.is_mla``) replaces ``wqkv`` by the low-rank weights of
``models/mla.py`` in both stacks, and its attention is ``mla_attn_block``.

``transformer_hidden`` also takes precomputed multimodal embeddings spliced
over the token embeddings (``embed_override``) and AntGLM's per-row
(prompt length, mask position) pair (``glm_ids``).

Attention dispatch follows the JAX ``_attn_block_at`` over the three arena
kinds (ALiBi slopes ride along in every one, where JAX sends ALiBi to its
jnp path): Q > 128 with a causal window goes to the prefill rule
(AntGLM's prefix-LM prefill too, with its window ``glm_ids[:, 0]``, where
JAX has no prefill kernel), every other width to the decode/verify rule
with its mask (a tree verify past 128 rows too, which JAX leaves to XLA),
``paged_attention_tok`` for a per-token-scale e4m3 arena. Where JAX
serves the e4m3 prefill and per-token verify widths with jnp, the port
uses the kernel's e4m3 modes, so no arena/width pair reaches a plain
version on the card.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from painlessinferenceacceleration_tpu_torch._build import resolve_device
from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import write_kv_pages
from painlessinferenceacceleration_tpu_torch.layers.embedding import (
    embed_logits,
    embed_lookup,
)
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    effective_group,
    linear,
    linear_at,
    make_linear,
)
from painlessinferenceacceleration_tpu_torch.models.mla import (
    init_mla_attn,
    mla_attn_block,
    mla_rope_cos_sin,
)
from painlessinferenceacceleration_tpu_torch.models.moe import (
    init_moe_layer,
    moe_block,
)
from painlessinferenceacceleration_tpu_torch.ops.attention import alibi_slopes
from painlessinferenceacceleration_tpu_torch.ops.cp_attention import cp_attention, cp_write_kv
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
    paged_attention_tok,
)
from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import layer_norm, rms_norm
from painlessinferenceacceleration_tpu_torch.ops.rope import apply_rope, dense_cos_sin
from painlessinferenceacceleration_tpu_torch.parallel import comm


# the linear-attention hybrids (models/linear_attn.py); "ring_linear" is the
# JAX package's tests' name for a hybrid without the bailing extras
HYBRID_MODEL_TYPES = ("bailing_moe_linear", "bailing_moe_linear_v2", "ring_linear")
# the dense families ModelConfig.from_hf maps besides llama
LEGACY_MODEL_TYPES = ("mistral", "qwen2", "internlm", "baichuan", "qwen", "opt", "gptj",
                      "gpt2", "bloom", "glm", "chatglm")
PORTED_MODEL_TYPES = ("llama", "mixtral", "qwen3", "qwen3_moe", "deepseek_v2",
                      "deepseek_v3") + LEGACY_MODEL_TYPES + HYBRID_MODEL_TYPES
ACTIVATIONS = ("gelu_new", "gelu_pytorch_tanh", "gelu_fast", "gelu", "silu", "swish",
               "relu")
POSITIONS = ("rope", "learned", "alibi", "glm_2d")


def _legacy_knobs(cfg: ModelConfig) -> list:
    """The legacy-family features a config turns on (the dense stack alone
    takes them)."""
    return [name for name, on in (
        ("layer norm", cfg.norm_type != "rmsnorm"),
        (f"{cfg.position_embedding_type} positions", cfg.position_embedding_type != "rope"),
        ("an un-gated MLP", not cfg.gated_mlp),
        (f"{cfg.hidden_act} activation", cfg.hidden_act not in ("silu", "swish")),
        ("MLP biases", cfg.mlp_bias), ("parallel residual", cfg.parallel_residual),
        ("embedding LayerNorm", cfg.embed_layernorm), ("prefix-LM", cfg.prefix_lm)) if on]


def _check_model(cfg: ModelConfig) -> None:
    if cfg.model_type not in PORTED_MODEL_TYPES or cfg.hidden_act not in ACTIVATIONS:
        raise NotImplementedError(
            f"ported model types are {PORTED_MODEL_TYPES} with a {ACTIVATIONS} MLP "
            f"({cfg.model_type}, {cfg.hidden_act})"
        )
    if cfg.position_embedding_type not in POSITIONS or cfg.norm_type not in (
            "rmsnorm", "layernorm"):
        raise ValueError(f"positions {cfg.position_embedding_type!r} (one of {POSITIONS}), "
                         f"norm {cfg.norm_type!r} (rmsnorm or layernorm)")
    if (cfg.model_type in HYBRID_MODEL_TYPES) != cfg.linear_attention or (
            cfg.linear_attention and cfg.is_mla):
        raise ValueError(f"model type {cfg.model_type} with linear_attention="
                         f"{cfg.linear_attention} (hybrids are {HYBRID_MODEL_TYPES}, "
                         "without MLA)")
    if cfg.is_moe and not 0 < cfg.num_experts_per_tok <= cfg.num_experts:
        raise ValueError(f"top-{cfg.num_experts_per_tok} of {cfg.num_experts} experts")
    legacy = _legacy_knobs(cfg)
    if legacy and (cfg.is_moe or cfg.is_mla or cfg.linear_attention):
        raise NotImplementedError(f"{', '.join(legacy)}: the dense stack alone takes them, "
                                  "not MoE, MLA or linear-attention models")
    if (cfg.attention_bias or cfg.attention_out_bias) and (cfg.is_mla or cfg.linear_attention):
        raise NotImplementedError("attention biases on MLA or linear-attention models")


def check_model_on_card(cfg: ModelConfig, params: dict, page_size: int) -> None:
    """Raise, before serving starts, where a kernel on the card refuses the
    model's shapes. What is still refused: paged attention's geometry
    (``attention_check``: the (K, V) head dims of ``HEAD_DIMS``, which hold
    every family's, OPT's 80, BLOOM's 96, GPT-J's 256 and DeepSeek's
    expanded (192, 128) among them; pages of 64 keys; 1 to 128 query heads
    a kv head, any whole number: Qwen2's 7, Qwen2.5's 6 and 5), the bf16
    GEMM's K and N (``bf16_check``: K % 8, N % 8) on the native linears and
    the tied head over a bf16 table (the engine pads a table's rows to a
    multiple of 8 first, ``pad_vocab_rows``), and the e4m3 tied head's K
    (``fp8_head_check``: the hidden size a multiple of 64). MLA's latent
    mode is K13's (its own check at the first call)."""
    from painlessinferenceacceleration_tpu_torch.models.mla import (
        mla_cache_heads,
        mla_head_dims,
    )
    from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import bf16_check
    from painlessinferenceacceleration_tpu_torch.ops.paged_attention import attention_check
    from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import fp8_head_check

    if not cfg.is_mla:
        attention_check(cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                        page_size)
    elif not cfg.mla_latent_cache:  # expanded: per-head K and V rows of their own widths
        dk, dv = mla_head_dims(cfg)
        attention_check(cfg.num_attention_heads, mla_cache_heads(cfg), dk, page_size, dv)
    for name in ("layers", "moe_layers"):
        for key in ("wqkv", "wo", "wgu", "wdown"):
            w = params.get(name, {}).get(key)
            if isinstance(w, torch.Tensor):
                bf16_check(w.shape[-2], w.shape[-1])
    head = params.get("lm_head")
    emb = params.get("embed")
    if isinstance(head, torch.Tensor):
        bf16_check(head.shape[-2], head.shape[-1])
    elif head is None and isinstance(emb, torch.Tensor):
        V, E = emb.shape  # the tied head: K = E, N = V
        bf16_check(E, V)
    elif head is None and isinstance(emb, dict):  # the e4m3 table's tied head
        fp8_head_check(*emb["q"].shape)


def _stack_leaves(make, n: int):
    """``n`` leaves from ``make()`` (a tensor, or nested dicts of tensors)
    stacked ``[n, ...]``, written one at a time into the stacked storage: a
    list of all the layers beside their stack would not fit for a large
    model."""

    def alloc(leaf):
        if isinstance(leaf, dict):
            return {k: alloc(v) for k, v in leaf.items()}
        return torch.empty((n,) + tuple(leaf.shape), dtype=leaf.dtype, device=leaf.device)

    def put(out, leaf, i):
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                put(out[k], v, i)
        else:
            out[i] = leaf

    first = make()
    out = alloc(first)
    put(out, first, 0)
    for i in range(1, n):
        put(out, make(), i)
    return out


def _layer_split(cfg: ModelConfig):
    """(dense layers, MoE layers) of the model's depth."""
    n = cfg.num_hidden_layers
    n_dense = min(cfg.moe_layer_start, n) if cfg.is_moe else n
    return n_dense, n - n_dense


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                quant: Optional[QuantSpec] = None) -> dict:
    """Random (std 0.02) parameters with stacked layers; with ``quant`` every
    linear is quantized from its dense weight (``make_linear``), layer by
    layer. An MoE config splits the layers into the dense stack ``layers``
    (those below ``moe_layer_start``) and the stack ``moe_layers``, whose
    layers carry the router and the experts instead of ``wgu`` / ``wdown``.
    A linear-attention hybrid's come from ``init_hybrid_params``."""
    if cfg.linear_attention:
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            init_hybrid_params,
        )

        return init_hybrid_params(cfg, generator, dtype, device, quant)
    _check_model(cfg)
    dev = resolve_device(device)
    E, H, Hk, D, I = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size)
    n_dense, n_moe = _layer_split(cfg)

    def w(*shape):
        return (torch.randn(*shape, generator=generator, device=generator.device)
                * 0.02).to(device=dev, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    def attn_stack(n):
        stack = {
            "input_ln": torch.ones(n, E, dtype=dtype, device=dev),
            "post_ln": torch.ones(n, E, dtype=dtype, device=dev),
        }
        if cfg.norm_type == "layernorm":
            stack["input_ln_b"] = zeros(n, E)
            stack["post_ln_b"] = zeros(n, E)
        if cfg.attention_out_bias:
            stack["bo"] = zeros(n, E)
        if cfg.is_mla:
            stack.update(init_mla_attn(
                cfg, lambda din, dout: _stack_leaves(
                    lambda: make_linear(w(din, dout), quant), n),
                lambda width: torch.ones(n, width, dtype=dtype, device=dev)))
            return stack
        stack["wqkv"] = _stack_leaves(lambda: make_linear(w(E, (H + 2 * Hk) * D), quant), n)
        stack["wo"] = _stack_leaves(lambda: make_linear(w(H * D, E), quant), n)
        if cfg.attention_bias:
            stack["bqkv"] = zeros(n, (H + 2 * Hk) * D)
        if cfg.qk_norm:
            stack["q_norm"] = torch.ones(n, D, dtype=dtype, device=dev)
            stack["k_norm"] = torch.ones(n, D, dtype=dtype, device=dev)
        return stack

    params = {
        "embed": w(cfg.vocab_size, E),
        "final_ln": torch.ones(E, dtype=dtype, device=dev),
    }
    if cfg.norm_type == "layernorm":
        params["final_ln_b"] = zeros(E)
    if cfg.position_embedding_type in ("learned", "glm_2d"):
        params["pos_embed"] = w(cfg.max_position_embeddings, E)
    if cfg.position_embedding_type == "glm_2d":
        params["block_pos_embed"] = w(cfg.max_position_embeddings, E)
    if cfg.embed_layernorm:
        params["embed_ln"] = torch.ones(E, dtype=dtype, device=dev)
        params["embed_ln_b"] = zeros(E)
    up = 2 * I if cfg.gated_mlp else I
    if n_dense:
        params["layers"] = attn_stack(n_dense)
        params["layers"]["wgu"] = _stack_leaves(
            lambda: make_linear(w(E, up), quant), n_dense)
        params["layers"]["wdown"] = _stack_leaves(
            lambda: make_linear(w(I, E), quant), n_dense)
        if cfg.mlp_bias:
            params["layers"]["bgu"] = zeros(n_dense, up)
            params["layers"]["bdown"] = zeros(n_dense, E)
    if n_moe:
        params["moe_layers"] = attn_stack(n_moe)
        params["moe_layers"].update(_stack_leaves(
            lambda: init_moe_layer(cfg, generator, dtype, quant, dev), n_moe))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = make_linear(w(E, cfg.vocab_size), quant)
    return params


def _rand_e4m3(gen: torch.Generator, shape, dev) -> torch.Tensor:
    """Unit-normal values cast to e4m3, drawn a layer at a time (the fp32
    draw of a whole stacked 7B weight would not fit beside the model)."""
    if len(shape) == 2:
        return torch.randn(shape, generator=gen, device=dev).to(torch.float8_e4m3fn)
    out = torch.empty(shape, dtype=torch.float8_e4m3fn, device=dev)
    for li in range(shape[0]):
        out[li] = _rand_e4m3(gen, shape[1:], dev)
    return out


def _rand_quant_leaf(gen: torch.Generator, n, din: int, dout: int,
                     spec: QuantSpec, dev, std: float = 0.02) -> dict:
    """Random quantized leaf of ``spec``'s format, stacked [n, ...] (n = 0:
    unstacked; a tuple: those lead axes, as (layers, experts)), built on the
    device: int8 values uniform in [-127, 127], e4m3 values from a unit
    normal, any byte for int4's biased nibbles, and constant scales that
    give the weights a spread of about ``std``."""
    lead = tuple(n) if isinstance(n, tuple) else ((n,) if n else ())

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    if spec.block:
        B = spec.block
        return {"q": _rand_e4m3(gen, lead + (din, dout), dev),
                "s": full((-(-din // B), -(-dout // B)), std / 448.0, torch.float32)}
    if spec.act is not None:
        if spec.wfmt == "fp8":
            p = {"q": _rand_e4m3(gen, lead + (din, dout), dev),
                 "s": full((dout,), std / 448.0, torch.float32)}
        else:
            p = {"q": torch.randint(-127, 128, lead + (din, dout), generator=gen,
                                    device=dev, dtype=torch.int8),
                 "s": full((dout,), std / 127.0, torch.float32)}
        if spec.act == "static":
            p["xs"] = full((), 1.0, torch.float32)
        return p
    groups = din // effective_group(din, spec.group)
    if spec.bits == 8:
        q = torch.randint(-127, 128, lead + (din, dout), generator=gen, device=dev,
                          dtype=torch.int8)
        return {"q": q, "s": full((groups, dout), std / 127.0, torch.bfloat16)}
    q = torch.randint(0, 256, lead + (din // 2, dout), generator=gen, device=dev,
                      dtype=torch.uint8)
    return {"q": q, "s": full((groups, dout), std / 7.0, torch.bfloat16)}


def init_params_quantized(cfg: ModelConfig, spec: QuantSpec,
                          generator: torch.Generator, device=None) -> dict:
    """Random parameters with every big GEMM weight directly in ``spec``'s
    quantized form, drawn on ``device`` (``cuda`` unless asked otherwise): a
    random fp32 7B model would not fit the card just to be quantized and
    thrown away. The generator must live on that device. An MoE config gets
    its two stacks as ``init_params`` lays them out, the experts (and shared
    experts) quantized, the router in bf16. The legacy families' extra
    leaves are ``init_params``'s only."""
    _check_model(cfg)
    if _legacy_knobs(cfg) or cfg.attention_bias or cfg.attention_out_bias:
        raise NotImplementedError("init_params_quantized draws llama-class models; "
                                  f"{cfg.model_type} comes from init_params or a checkpoint")
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters asked on {dev}")
    E, H, Hk, D, I = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size)
    n_dense, n_moe = _layer_split(cfg)
    bf16 = torch.bfloat16

    def leaf(n, din, dout):
        return _rand_quant_leaf(generator, n, din, dout, spec, dev)

    def attn_stack(n):
        stack = {
            "input_ln": torch.ones(n, E, dtype=bf16, device=dev),
            "post_ln": torch.ones(n, E, dtype=bf16, device=dev),
        }
        if cfg.is_mla:
            stack.update(init_mla_attn(
                cfg, lambda din, dout: leaf(n, din, dout),
                lambda width: torch.ones(n, width, dtype=bf16, device=dev)))
            return stack
        stack["wqkv"] = leaf(n, E, (H + 2 * Hk) * D)
        stack["wo"] = leaf(n, H * D, E)
        if cfg.qk_norm:
            stack["q_norm"] = torch.ones(n, D, dtype=bf16, device=dev)
            stack["k_norm"] = torch.ones(n, D, dtype=bf16, device=dev)
        return stack

    params = {}
    if n_dense:
        params["layers"] = attn_stack(n_dense)
        params["layers"]["wgu"] = leaf(n_dense, E, 2 * I)
        params["layers"]["wdown"] = leaf(n_dense, I, E)
    if n_moe:
        X, Im = cfg.num_experts, cfg.moe_intermediate_size or I
        moe = attn_stack(n_moe)
        router = torch.randn(n_moe, E, X, generator=generator, device=dev)
        moe["router"] = (router * 0.02).to(bf16)
        moe["moe_wgu"] = leaf((n_moe, X), E, 2 * Im)
        moe["moe_wdown"] = leaf((n_moe, X), Im, E)
        if cfg.scoring_func == "sigmoid":
            moe["router_bias"] = torch.zeros(n_moe, X, dtype=torch.float32, device=dev)
        if cfg.num_shared_experts:
            Ish = Im * cfg.num_shared_experts
            moe["shared_wgu"] = leaf(n_moe, E, 2 * Ish)
            moe["shared_wdown"] = leaf(n_moe, Ish, E)
        params["moe_layers"] = moe
    embed = torch.randn(cfg.vocab_size, E, generator=generator, device=dev)
    params.update(embed=(embed * 0.02).to(bf16),
                  final_ln=torch.ones(E, dtype=bf16, device=dev))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _rand_quant_leaf(generator, 0, E, cfg.vocab_size, spec, dev)
    return params


def _attention(xq, kv, li, page_tables, start_lens, qmask, causal_window, scale,
               alibi=None, window=None):
    """Dispatch on the arena (bf16 / static e4m3 / per-token e4m3) and the
    rule: Q > 128 with a causal window to the prefill rule, and so a
    prefix-LM prefill chunk past 128 rows with its ``window`` [B] int32
    (AntGLM's prompt lengths: the causal rule plus the keys before the
    window); every other width, a tree verify past 128 rows among them, to
    the decode/verify rule with its mask. ``alibi`` = (slopes [Hq], the
    step's positions [B, Q] int32) rides along (the causal rule puts key s
    at ctx + s). On CUDA every case is a kernel; the CPU runs the plain
    gather path."""
    slopes, pos = alibi if alibi is not None else (None, None)
    kk, vv = kv["k"][li], kv["v"][li]
    Q = xq.shape[1]
    tok = "k_tok_scale" in kv
    k_s = v_s = None
    if tok:
        k_s, v_s = kv["k_tok_scale"][li], kv["v_tok_scale"][li]
    elif "k_scale" in kv:
        k_s, v_s = kv["k_scale"][li], kv["v_scale"][li]
    wide = Q > 128 and (causal_window or window is not None)
    if tok:
        return paged_attention_tok(xq, kk, vv, k_s, v_s, page_tables, start_lens,
                                   scale, None if wide else qmask, slopes,
                                   None if wide else pos, window if wide else None)
    kv_scales = None if k_s is None else (k_s, v_s)
    if not wide:
        return paged_attention(xq, kk, vv, page_tables, start_lens, qmask, scale,
                               kv_scales, slopes, pos)
    return paged_attention_prefill(xq, kk, vv, page_tables, start_lens, scale,
                                   kv_scales, slopes, window=window)


def _norm(cfg: ModelConfig, x, w, b=None):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, w, b, cfg.rms_norm_eps)
    return rms_norm(x, w, cfg.rms_norm_eps)


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP's activation in fp32, rounded back to ``x.dtype``."""
    xf = x.to(torch.float32)
    if act in ("gelu_new", "gelu_pytorch_tanh", "gelu_fast"):
        y = F.gelu(xf, approximate="tanh")
    elif act == "gelu":
        y = F.gelu(xf)
    elif act in ("silu", "swish"):
        y = F.silu(xf)
    elif act == "relu":
        y = F.relu(xf)
    else:
        raise ValueError(f"unsupported hidden_act {act!r}")
    return y.to(x.dtype)


def _apply_positional(cfg: ModelConfig, xq, xk, cos, sin):
    """Rope (full, partial or interleaved), or nothing (learned, GLM 2D and
    ALiBi positions act elsewhere). A partial rope rotates the first 2 *
    cos.shape[-1] lanes and passes the rest."""
    if cfg.position_embedding_type != "rope":
        return xq, xk
    il = cfg.rope_interleaved
    rot = cos.shape[-1] * 2
    if rot < xq.shape[-1]:
        q_r = apply_rope(xq[..., :rot], cos, sin, il)
        k_r = apply_rope(xk[..., :rot], cos, sin, il)
        return (torch.cat([q_r, xq[..., rot:].to(q_r.dtype)], dim=-1),
                torch.cat([k_r, xk[..., rot:].to(k_r.dtype)], dim=-1))
    return apply_rope(xq, cos, sin, il), apply_rope(xk, cos, sin, il)


def _biased(out: torch.Tensor, stack: dict, key: str, li: int) -> torch.Tensor:
    """``out`` plus layer ``li`` of the stacked bias ``key`` (when the stack
    has one), in ``out``'s dtype as the JAX package adds it."""
    b = stack.get(key)
    return out if b is None else out + b[li].to(out.dtype)


def _attn_block_at(layers, li, kv_li, cfg, spec, h, cos, sin, kv, page_tables,
                   start_lens, qmask, valid, causal_window, alibi=None, par=None,
                   record=None, window=None):
    """Attention of layer ``li`` of the stack ``layers``, over KV layer
    ``kv_li`` of the arena. ``par`` is the rank's ``parallel.comm.RankState``
    (None: one process); ``record``, when a list, gets (kv_li, K rows, V
    rows) of the step; ``window`` the prefix-LM window of a prefill."""
    B, Q, _ = h.shape
    H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = _biased(linear_at(layers["wqkv"], li, h, spec), layers, "bqkv", li)
    xq = qkv[..., : H * D].reshape(B, Q, H, D)
    xk = qkv[..., H * D: (H + Hk) * D].reshape(B, Q, Hk, D)
    xv = qkv[..., (H + Hk) * D:].reshape(B, Q, Hk, D)
    if cfg.qk_norm:  # qwen3: per-head RMSNorm before rope
        xq = rms_norm(xq, layers["q_norm"][li], cfg.rms_norm_eps)
        xk = rms_norm(xk, layers["k_norm"][li], cfg.rms_norm_eps)
    xq, xk = _apply_positional(cfg, xq, xk, cos, sin)
    if record is not None:
        record.append((kv_li, xk, xv))
    if par is not None and par.cp > 1:  # this rank's pages; the ranks' parts merged
        cp_write_kv(kv, kv_li, xk, xv, page_tables, start_lens, valid, par.model_rank)
        out = cp_attention(xq, kv, kv_li, page_tables, start_lens, qmask, causal_window,
                           D ** -0.5, par)
    else:
        write_kv_pages(kv["k"], kv["v"], xk, xv, page_tables, start_lens, valid, kv_li,
                       kv["k_scale"][kv_li] if "k_scale" in kv else None,
                       kv["v_scale"][kv_li] if "v_scale" in kv else None,
                       kv.get("k_tok_scale"), kv.get("v_tok_scale"))
        args = (xq, kv, kv_li, page_tables, start_lens, qmask, causal_window, D ** -0.5,
                alibi)
        out = _attention(*args) if window is None else _attention(*args, window=window)
    # row-parallel under tensor parallelism: the bias is added once, after the sum
    return _biased(comm.linear_rows_at(layers["wo"], li, out.reshape(B, Q, H * D), spec,
                                       par, par is None or par.attn_split), layers, "bo", li)


def _mlp_block_at(layers, li, cfg, spec, h, par=None):
    gu = _biased(linear_at(layers["wgu"], li, h, spec), layers, "bgu", li)
    if cfg.gated_mlp:
        I = cfg.intermediate_size
        act = _activate(gu[..., :I], cfg.hidden_act) * gu[..., I:]
    else:  # gpt2 / bloom: up, activation, down
        act = _activate(gu, cfg.hidden_act)
    return _biased(comm.linear_rows_at(layers["wdown"], li, act, spec, par,
                                       par is None or par.mlp_split), layers, "bdown", li)


def _embed(params: dict, cfg: ModelConfig, tokens, positions, embed_override, glm_ids):
    """Token embeddings with the multimodal splice, the learned or GLM 2D
    position tables and bloom's embedding LayerNorm."""
    h = embed_lookup(params["embed"], tokens, params["final_ln"].dtype)
    if embed_override is not None:  # rows (b, local[b, m]) take embeds[b, m]
        local, embeds = embed_override
        Q = h.shape[1]
        ok = (local >= 0) & (local < Q)
        b = torch.arange(h.shape[0], device=h.device)[:, None].expand_as(local)
        h = h.clone()
        h[b[ok], local[ok].long()] = embeds[ok].to(h.dtype)
    pe = cfg.position_embedding_type
    if pe in ("learned", "glm_2d"):
        cap = params["pos_embed"].shape[0] - 1
        pos = positions.long()
        if pe == "glm_2d":
            # AntGLM 2D positions: a prompt token is (item p, block 0); the
            # <sop> and every generated token (item mask_pos, block
            # p - prompt_len_eff + 1). Both tables add to the embedding
            if glm_ids is None:
                raise ValueError("glm_2d positions need glm_ids [B, 2]")
            p_eff, mpos = glm_ids[:, :1].long(), glm_ids[:, 1:].long()
            in_prompt = pos < p_eff
            block = torch.where(in_prompt, 0, pos - p_eff + 1).clamp(0, cap)
            pos = torch.where(in_prompt, pos, mpos)
            h = h + params["pos_embed"][pos.clamp(0, cap)].to(h.dtype)
            h = h + params["block_pos_embed"][block].to(h.dtype)
        else:  # rows past the table are padding; their index is clamped
            h = h + params["pos_embed"][pos.clamp(0, cap)].to(h.dtype)
    if cfg.embed_layernorm:
        h = layer_norm(h, params["embed_ln"], params["embed_ln_b"], cfg.rms_norm_eps)
    return h


def _hidden_local(
    params: dict,
    cfg: ModelConfig,
    kv: dict,
    tokens: torch.Tensor,  # [B, Q]
    positions: torch.Tensor,  # [B, Q]
    page_tables: torch.Tensor,  # [B, P]
    start_lens: torch.Tensor,  # [B] committed lengths (in-step writes begin here)
    qmask: torch.Tensor,  # [B, Q, Q] bool in-step visibility
    valid: Optional[torch.Tensor] = None,  # [B, Q] bool
    spec: Optional[QuantSpec] = None,
    causal_window: bool = False,  # prefill: qmask is purely lower-triangular
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
    defer_state: bool = False,  # linear-attn verify: stash the window's k, v
    embed_override=None,  # (local_pos [B, M], embeds [B, M, E]) multimodal splice
    glm_ids: Optional[torch.Tensor] = None,  # [B, 2] (prompt_len_eff, mask_pos)
    par=None,  # the rank's parallel.comm.RankState (None: one process)
    record: Optional[list] = None,  # gets (KV layer, K rows, V rows) of each write
    prefix_window: Optional[torch.Tensor] = None,  # [B] a prefix-LM prefill's window
):
    """Run all decoder layers; returns (hidden [B, Q, E], kv updated in place).

    One function serves prefill (causal qmask), decode (Q = 1) and lookahead
    verify (tree qmask). The dense stack runs first, then the MoE stack,
    whose layer i uses KV layer ``n_dense + i``. A linear-attention hybrid
    (``cfg.linear_attention``) runs ``hybrid_forward`` instead, over the
    states of the slots ``slot_ids`` (default: row b is slot b).

    ``embed_override`` writes embeds[b, m] over row b's embedding at
    in-chunk position local[b, m] (positions outside the chunk are
    dropped); ``glm_ids`` carries each row's AntGLM (prompt_len_eff,
    mask_pos) for the 2D positions, ``prefix_window`` a prefix-LM prefill's
    window (``glm_ids[:, 0]``) for the attention of a chunk past 128 rows."""
    if cfg.linear_attention:
        if embed_override is not None:
            raise NotImplementedError("multimodal embeddings on a linear-attention hybrid")
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            hybrid_forward,
        )

        return hybrid_forward(params, cfg, kv, tokens, positions, page_tables, start_lens,
                              qmask, valid, spec, slot_ids, defer_state, causal_window, par,
                              record)
    # misconfiguration guard: hybrid params with cfg.linear_attention unset
    if "hybrid_layers" in params:
        raise ValueError("params contain hybrid_layers but cfg.linear_attention is False")
    if "k_tok_scale" in kv and ("moe_layers" in params or cfg.is_mla):
        raise ValueError("kv_quant='fp8_tok' supports the dense stacked-layer "
                         "family only")
    h = _embed(params, cfg, tokens, positions, embed_override, glm_ids)
    # the YaRN factor rides on cos/sin for grouped-query attention; MLA takes
    # it squared in its softmax scale instead
    cos = sin = None
    if cfg.position_embedding_type == "rope":
        cos, sin = (mla_rope_cos_sin if cfg.is_mla else dense_cos_sin)(cfg, positions)
    attn_block = mla_attn_block if cfg.is_mla else _attn_block_at
    extra = dict(par=par, record=record)
    if prefix_window is not None:
        extra["window"] = prefix_window.to(device=h.device, dtype=torch.int32).contiguous()
    if cfg.position_embedding_type == "alibi":  # each key biased by its position
        extra["alibi"] = (_slopes_on(cfg.num_attention_heads, h.device),
                          positions.to(device=h.device, dtype=torch.int32).contiguous())
    n_dense = 0
    for name in ("layers", "moe_layers"):
        stack = params.get(name)
        if stack is None:
            continue
        n_layers = stack["input_ln"].shape[0]
        for li in range(n_layers):
            hn = _norm(cfg, h, stack["input_ln"][li], _at(stack, "input_ln_b", li))
            attn = attn_block(stack, li, n_dense + li, cfg, spec, hn, cos, sin, kv,
                              page_tables, start_lens, qmask, valid, causal_window, **extra)
            if cfg.parallel_residual:  # gptj: one norm feeds attention and the MLP
                h = h + attn + _mlp_block_at(stack, li, cfg, spec, hn, par)
                continue
            h = h + attn
            hn = _norm(cfg, h, stack["post_ln"][li], _at(stack, "post_ln_b", li))
            if name == "moe_layers":
                h = h + moe_block(_layer_of(stack, li), cfg, spec, hn, par)
            else:
                h = h + _mlp_block_at(stack, li, cfg, spec, hn, par)
        n_dense = n_layers  # the MoE stack's KV layers follow the dense ones
    return h, kv


def transformer_hidden(params: dict, cfg: ModelConfig, kv: dict, tokens: torch.Tensor,
                       positions: torch.Tensor, page_tables: torch.Tensor,
                       start_lens: torch.Tensor, qmask: torch.Tensor,
                       valid: Optional[torch.Tensor] = None, spec: Optional[QuantSpec] = None,
                       causal_window: bool = False, slot_ids: Optional[torch.Tensor] = None,
                       defer_state: bool = False, embed_override=None,
                       glm_ids: Optional[torch.Tensor] = None,
                       record: Optional[list] = None,
                       prefix_window: Optional[torch.Tensor] = None):
    """Run all decoder layers; returns (hidden [B, Q, E], kv updated in
    place). The arguments are ``_hidden_local``'s; ``record``, when a list,
    gets (KV layer, K rows [B, Q, Hkv, D], V rows) of every layer's write.

    The rank state that ``DistLLM`` sets (``parallel.comm.current()``) is
    read here, once a forward, and handed to the blocks. Under data
    parallelism (a rank state with ``dp`` > 1) the batch's rows are split in
    contiguous blocks over the data groups (``parallel.comm.data_block``;
    each block padded to the largest with rows that write nothing), and
    with them the multimodal rows of ``embed_override``. Each group runs the
    layers over its own rows; then the groups' hidden rows and the K / V rows
    their layers wrote are gathered in group order, and every rank writes the
    other groups' rows into its arena (under context parallelism beside the
    data axis, onto its own pages: ``cp_write_kv``), so the arena stays the
    same on every data group (the JAX package's replicated arena). A
    linear-attention hybrid's rows run over their own slots' states, and the
    changed slots are shared after the forward (``share_slot_states``; a
    verify's, after its commit, ``commit_linear_states``). Every rank then
    holds the whole batch's hidden state."""
    args = (positions, page_tables, start_lens, qmask, valid)
    st = comm.current()
    if st is None or st.dp == 1:
        return _hidden_local(params, cfg, kv, tokens, *args, spec, causal_window, slot_ids,
                             defer_state, embed_override, glm_ids, st, record, prefix_window)
    B, Q = tokens.shape
    dev = tokens.device
    if valid is None:
        valid = torch.ones((B, Q), dtype=torch.bool, device=dev)
    if cfg.linear_attention and slot_ids is None:  # row b is slot b, as in one process
        slot_ids = torch.arange(B, dtype=torch.int32, device=dev)
    a, n, bmax, sizes = comm.data_block(B, st)

    def rows(t, pad="first"):
        return comm.block_rows(t, a, n, bmax, pad)

    override = None
    if embed_override is not None:  # the multimodal rows follow their batch rows
        override = tuple(rows(t) for t in embed_override)
    rec = []
    h_l, kv = _hidden_local(params, cfg, kv, rows(tokens), rows(positions),
                            rows(page_tables), rows(start_lens), rows(qmask),
                            rows(valid, "zeros"), spec, causal_window, rows(slot_ids),
                            defer_state, override, rows(glm_ids), st, rec,
                            rows(prefix_window))
    hs = comm.data_gather(h_l.contiguous(), st)
    h = torch.cat([hs[g, :sizes[g]] for g in range(st.dp)], dim=0)
    if cfg.linear_attention and not defer_state:
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            share_slot_states,
        )

        share_slot_states(kv, slot_ids, valid.any(dim=1), st)
    # the other groups' K / V rows, written here: one write per layer over all
    # rows, this group's own rows and the padding invalid
    mine = torch.zeros(B, dtype=torch.bool, device=dev)
    mine[a:a + n] = True
    if not rec:
        return h, kv
    # every layer's rows in one gather (the same sizes on every group)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for _, nk, nv in rec for t in (nk, nv)])
    flats = comm.data_gather(flat, st)
    off = 0
    for layer, nk, nv in rec:
        kv_rows = []
        for t in (nk, nv):
            n_b = t.numel() * t.element_size()
            part = flats[:, off:off + n_b].contiguous().view(t.dtype).reshape(
                (st.dp,) + tuple(t.shape))
            kv_rows.append(torch.cat([part[g, :sizes[g]] for g in range(st.dp)], dim=0))
            off += n_b
        k_all, v_all = kv_rows
        if record is not None:
            record.append((layer, k_all, v_all))
        others = valid & ~mine[:, None]
        if st.cp > 1:
            cp_write_kv(kv, layer, k_all, v_all, page_tables, start_lens, others,
                        st.model_rank)
            continue
        write_kv_pages(kv["k"], kv["v"], k_all, v_all, page_tables, start_lens, others, layer,
                       kv["k_scale"][layer] if "k_scale" in kv else None,
                       kv["v_scale"][layer] if "v_scale" in kv else None,
                       kv.get("k_tok_scale"), kv.get("v_tok_scale"))
    return h, kv


@functools.lru_cache(maxsize=None)
def _slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """ALiBi slopes, built once for each (heads, device): built at every
    forward, their host-to-device copy would wait for the stream."""
    return alibi_slopes(n_heads, device)


def _at(stack: dict, key: str, li: int):
    v = stack.get(key)
    return None if v is None else v[li]


_MOE_KEYS = ("router", "router_bias", "moe_wgu", "moe_wdown", "shared_wgu",
             "shared_wdown")


def _layer_of(stack: dict, li: int) -> dict:
    """The MoE leaves of layer ``li`` of a stack: views, no copy."""
    out = {}
    for k in _MOE_KEYS:
        v = stack.get(k)
        if v is not None:
            out[k] = {kk: vv[li] for kk, vv in v.items()} if isinstance(v, dict) else v[li]
    return out


def logits_from_hidden(params: dict, cfg: ModelConfig, h: torch.Tensor,
                       spec: Optional[QuantSpec] = None) -> torch.Tensor:
    """Final norm + LM head with fp32 logits straight from the accumulator
    (bf16-rounded logits would make greedy argmax ties width-dependent);
    gptj's head bias is added to the fp32 logits."""
    h = _norm(cfg, h, params["final_ln"], params.get("final_ln_b"))
    head = params.get("lm_head")
    if head is None:  # a padded table's padding columns cut off before any reader
        out = embed_logits(params["embed"], h)
        return out if out.shape[-1] == cfg.vocab_size else out[..., :cfg.vocab_size]
    out = linear(head, h, spec, out_dtype=torch.float32).to(torch.float32)
    st = comm.current()
    if st is not None and st.tp > 1 and st.head_widths is not None:
        # column-parallel over the vocabulary: every rank takes the whole row,
        # so every rank makes the same argmax and the same acceptance
        out = comm.gather_columns(out, st)
    b = params.get("lm_head_b")
    return out if b is None else out + b.to(torch.float32)
