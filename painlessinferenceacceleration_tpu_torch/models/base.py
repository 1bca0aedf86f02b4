"""Llama-family decoder, dense or Mixture-of-Experts, with grouped-query or
Multi-head Latent Attention, functional, over stacked per-layer weights.

Port of the llama / qwen3 / mixtral / qwen3_moe / deepseek_v2 / deepseek_v3
path of ``painlessinferenceacceleration_tpu/models/base.py`` (the linear-attention
hybrids dispatch to ``models/linear_attn.py``). Parameters are a dict
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

Attention dispatch follows the JAX ``_attn_block_at`` over the three arena
kinds: Q <= 128 goes to the decode/verify rule, Q > 128 with a causal
window to the prefill rule, ``paged_attention_tok`` for a per-token-scale
e4m3 arena; any other case runs the plain gather path on the CPU and raises
on CUDA. Where JAX serves the e4m3 prefill and per-token verify widths with
jnp, the port uses the kernel's e4m3 modes, so no arena/width pair reaches a
plain version on the card.
"""

from __future__ import annotations

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
from painlessinferenceacceleration_tpu_torch.ops.attention import paged_attention_ref
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
    paged_attention_tok,
)
from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_norm
from painlessinferenceacceleration_tpu_torch.ops.rope import apply_rope, dense_cos_sin


# the linear-attention hybrids (models/linear_attn.py); "ring_linear" is the
# JAX package's tests' name for a hybrid without the bailing extras
HYBRID_MODEL_TYPES = ("bailing_moe_linear", "bailing_moe_linear_v2", "ring_linear")
PORTED_MODEL_TYPES = ("llama", "mixtral", "qwen3", "qwen3_moe", "deepseek_v2",
                      "deepseek_v3") + HYBRID_MODEL_TYPES


def _check_model(cfg: ModelConfig) -> None:
    if cfg.model_type not in PORTED_MODEL_TYPES or cfg.hidden_act not in ("silu", "swish"):
        raise NotImplementedError(
            f"ported model types are {PORTED_MODEL_TYPES} with a silu MLP "
            f"({cfg.model_type}, {cfg.hidden_act})"
        )
    if (cfg.model_type in HYBRID_MODEL_TYPES) != cfg.linear_attention or (
            cfg.linear_attention and cfg.is_mla):
        raise ValueError(f"model type {cfg.model_type} with linear_attention="
                         f"{cfg.linear_attention} (hybrids are {HYBRID_MODEL_TYPES}, "
                         "without MLA)")
    if cfg.is_moe and not 0 < cfg.num_experts_per_tok <= cfg.num_experts:
        raise ValueError(f"top-{cfg.num_experts_per_tok} of {cfg.num_experts} experts")


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

    def attn_stack(n):
        stack = {
            "input_ln": torch.ones(n, E, dtype=dtype, device=dev),
            "post_ln": torch.ones(n, E, dtype=dtype, device=dev),
        }
        if cfg.is_mla:
            stack.update(init_mla_attn(
                cfg, lambda din, dout: _stack_leaves(
                    lambda: make_linear(w(din, dout), quant), n),
                lambda width: torch.ones(n, width, dtype=dtype, device=dev)))
            return stack
        stack["wqkv"] = _stack_leaves(lambda: make_linear(w(E, (H + 2 * Hk) * D), quant), n)
        stack["wo"] = _stack_leaves(lambda: make_linear(w(H * D, E), quant), n)
        if cfg.qk_norm:
            stack["q_norm"] = torch.ones(n, D, dtype=dtype, device=dev)
            stack["k_norm"] = torch.ones(n, D, dtype=dtype, device=dev)
        return stack

    params = {
        "embed": w(cfg.vocab_size, E),
        "final_ln": torch.ones(E, dtype=dtype, device=dev),
    }
    if n_dense:
        params["layers"] = attn_stack(n_dense)
        params["layers"]["wgu"] = _stack_leaves(
            lambda: make_linear(w(E, 2 * I), quant), n_dense)
        params["layers"]["wdown"] = _stack_leaves(
            lambda: make_linear(w(I, E), quant), n_dense)
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
    experts) quantized, the router in bf16."""
    _check_model(cfg)
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


def _attention(xq, kv, li, page_tables, start_lens, qmask, causal_window, scale):
    """Dispatch on the arena (bf16 / static e4m3 / per-token e4m3) and the
    width: Q <= 128 to the decode/verify rule, Q > 128 with a causal window
    to the prefill rule. On CUDA every case is a kernel; any other case
    raises there and runs the plain gather path on the CPU."""
    kk, vv = kv["k"][li], kv["v"][li]
    Q = xq.shape[1]
    tok = "k_tok_scale" in kv
    k_s = v_s = None
    if tok:
        k_s, v_s = kv["k_tok_scale"][li], kv["v_tok_scale"][li]
    elif "k_scale" in kv:
        k_s, v_s = kv["k_scale"][li], kv["v_scale"][li]
    if Q > 128 and not causal_window:
        if xq.is_cuda:
            raise NotImplementedError("non-causal attention with Q > 128 has no kernel")
        return paged_attention_ref(xq, kk, vv, page_tables, start_lens, qmask,
                                   scale, k_s, v_s)
    if tok:
        return paged_attention_tok(xq, kk, vv, k_s, v_s, page_tables, start_lens,
                                   scale, None if Q > 128 else qmask)
    kv_scales = None if k_s is None else (k_s, v_s)
    if Q <= 128:
        return paged_attention(xq, kk, vv, page_tables, start_lens, qmask, scale,
                               kv_scales)
    return paged_attention_prefill(xq, kk, vv, page_tables, start_lens, scale,
                                   kv_scales)


def _attn_block_at(layers, li, kv_li, cfg, spec, h, cos, sin, kv, page_tables,
                   start_lens, qmask, valid, causal_window):
    """Attention of layer ``li`` of the stack ``layers``, over KV layer
    ``kv_li`` of the arena."""
    B, Q, _ = h.shape
    H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = linear_at(layers["wqkv"], li, h, spec)
    xq = qkv[..., : H * D].reshape(B, Q, H, D)
    xk = qkv[..., H * D: (H + Hk) * D].reshape(B, Q, Hk, D)
    xv = qkv[..., (H + Hk) * D:].reshape(B, Q, Hk, D)
    if cfg.qk_norm:  # qwen3: per-head RMSNorm before rope
        xq = rms_norm(xq, layers["q_norm"][li], cfg.rms_norm_eps)
        xk = rms_norm(xk, layers["k_norm"][li], cfg.rms_norm_eps)
    xq, xk = apply_rope(xq, cos, sin), apply_rope(xk, cos, sin)
    write_kv_pages(kv["k"], kv["v"], xk, xv, page_tables, start_lens, valid, kv_li,
                   kv["k_scale"][kv_li] if "k_scale" in kv else None,
                   kv["v_scale"][kv_li] if "v_scale" in kv else None,
                   kv.get("k_tok_scale"), kv.get("v_tok_scale"))
    out = _attention(xq, kv, kv_li, page_tables, start_lens, qmask, causal_window,
                     D ** -0.5)
    return linear_at(layers["wo"], li, out.reshape(B, Q, H * D), spec)


def _mlp_block_at(layers, li, cfg, spec, h):
    gu = linear_at(layers["wgu"], li, h, spec)
    I = cfg.intermediate_size
    act = F.silu(gu[..., :I].to(torch.float32)).to(gu.dtype) * gu[..., I:]
    return linear_at(layers["wdown"], li, act, spec)


def transformer_hidden(
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
):
    """Run all decoder layers; returns (hidden [B, Q, E], kv updated in place).

    One function serves prefill (causal qmask), decode (Q = 1) and lookahead
    verify (tree qmask). The dense stack runs first, then the MoE stack,
    whose layer i uses KV layer ``n_dense + i``. A linear-attention hybrid
    (``cfg.linear_attention``) runs ``hybrid_forward`` instead, over the
    states of the slots ``slot_ids`` (default: row b is slot b)."""
    if cfg.linear_attention:
        from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
            hybrid_forward,
        )

        return hybrid_forward(params, cfg, kv, tokens, positions, page_tables, start_lens,
                              qmask, valid, spec, slot_ids, defer_state, causal_window)
    # misconfiguration guard: hybrid params with cfg.linear_attention unset
    if "hybrid_layers" in params:
        raise ValueError("params contain hybrid_layers but cfg.linear_attention is False")
    if "k_tok_scale" in kv and ("moe_layers" in params or cfg.is_mla):
        raise ValueError("kv_quant='fp8_tok' supports the dense stacked-layer "
                         "family only")
    h = embed_lookup(params["embed"], tokens, params["final_ln"].dtype)
    # the YaRN factor rides on cos/sin for grouped-query attention; MLA takes
    # it squared in its softmax scale instead
    cos, sin = (mla_rope_cos_sin if cfg.is_mla else dense_cos_sin)(cfg, positions)
    attn_block = mla_attn_block if cfg.is_mla else _attn_block_at
    n_dense = 0
    for name in ("layers", "moe_layers"):
        stack = params.get(name)
        if stack is None:
            continue
        n_layers = stack["input_ln"].shape[0]
        for li in range(n_layers):
            hn = rms_norm(h, stack["input_ln"][li], cfg.rms_norm_eps)
            h = h + attn_block(stack, li, n_dense + li, cfg, spec, hn, cos, sin, kv,
                               page_tables, start_lens, qmask, valid, causal_window)
            hn = rms_norm(h, stack["post_ln"][li], cfg.rms_norm_eps)
            if name == "moe_layers":
                h = h + moe_block(_layer_of(stack, li), cfg, spec, hn)
            else:
                h = h + _mlp_block_at(stack, li, cfg, spec, hn)
        n_dense = n_layers  # the MoE stack's KV layers follow the dense ones
    return h, kv


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
    (bf16-rounded logits would make greedy argmax ties width-dependent)."""
    h = rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        return embed_logits(params["embed"], h)
    return linear(head, h, spec, out_dtype=torch.float32).to(torch.float32)
