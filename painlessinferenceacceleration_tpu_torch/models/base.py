"""Dense llama-family decoder, functional, over stacked per-layer weights.

Port of the llama path of ``painlessinferenceacceleration_tpu/models/base.py``.
Parameters are a dict shaped like the JAX pytree: ``layers`` holds each
weight stacked ``[L, ...]`` and a layer is a view ``w[li]``; qkv and
gate/up are merged GEMMs. A Python loop over layers takes the place of
``lax.scan``, and the KV arena is written in place. The linears take any
``QuantSpec`` (``layers/linear.py``); the embedding table may be the fp8
``{"q", "s"}`` form (``layers/embedding.py``).

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
from painlessinferenceacceleration_tpu_torch.ops.attention import paged_attention_ref
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
    paged_attention_tok,
)
from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_norm
from painlessinferenceacceleration_tpu_torch.ops.rope import (
    apply_rope,
    rope_cos_sin,
    rope_inv_freq,
)


def _check_llama(cfg: ModelConfig) -> None:
    if cfg.model_type != "llama" or cfg.hidden_act not in ("silu", "swish"):
        raise NotImplementedError(
            f"only the dense llama family is ported ({cfg.model_type}, {cfg.hidden_act})"
        )


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None,
                quant: Optional[QuantSpec] = None) -> dict:
    """Random (std 0.02) parameters with stacked layers, for tests; with
    ``quant`` every linear is quantized from its dense weight
    (``make_linear``), layer by layer."""
    _check_llama(cfg)
    dev = resolve_device(device)
    E, H, Hk, D, I = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size)
    n = cfg.num_hidden_layers

    def w(*shape):
        return (torch.randn(*shape, generator=generator, device=generator.device)
                * 0.02).to(device=dev, dtype=dtype)

    def stacked(din, dout):
        leaves = [make_linear(w(din, dout), quant) for _ in range(n)]
        if quant is None:
            return torch.stack(leaves)
        return {k: torch.stack([p[k] for p in leaves]) for k in leaves[0]}

    params = {
        "embed": w(cfg.vocab_size, E),
        "final_ln": torch.ones(E, dtype=dtype, device=dev),
        "layers": {
            "input_ln": torch.ones(n, E, dtype=dtype, device=dev),
            "post_ln": torch.ones(n, E, dtype=dtype, device=dev),
            "wqkv": stacked(E, (H + 2 * Hk) * D),
            "wo": stacked(H * D, E),
            "wgu": stacked(E, 2 * I),
            "wdown": stacked(I, E),
        },
    }
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
        out[li] = torch.randn(shape[1:], generator=gen, device=dev).to(torch.float8_e4m3fn)
    return out


def _rand_quant_leaf(gen: torch.Generator, n: int, din: int, dout: int,
                     spec: QuantSpec, dev, std: float = 0.02) -> dict:
    """Random quantized leaf of ``spec``'s format, stacked [n, ...] (n = 0:
    unstacked), built on the device: int8 values uniform in [-127, 127],
    e4m3 values from a unit normal, any byte for int4's biased nibbles, and
    constant scales that give the weights a spread of about ``std``."""
    lead = (n,) if n else ()

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
    thrown away. The generator must live on that device."""
    _check_llama(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters asked on {dev}")
    E, H, Hk, D, I = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size)
    n = cfg.num_hidden_layers
    layers = {
        "input_ln": torch.ones(n, E, dtype=torch.bfloat16, device=dev),
        "post_ln": torch.ones(n, E, dtype=torch.bfloat16, device=dev),
        "wqkv": _rand_quant_leaf(generator, n, E, (H + 2 * Hk) * D, spec, dev),
        "wo": _rand_quant_leaf(generator, n, H * D, E, spec, dev),
        "wgu": _rand_quant_leaf(generator, n, E, 2 * I, spec, dev),
        "wdown": _rand_quant_leaf(generator, n, I, E, spec, dev),
    }
    embed = torch.randn(cfg.vocab_size, E, generator=generator, device=dev)
    params = {
        "embed": (embed * 0.02).to(torch.bfloat16),
        "layers": layers,
        "final_ln": torch.ones(E, dtype=torch.bfloat16, device=dev),
    }
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


def _attn_block_at(layers, li, cfg, spec, h, cos, sin, kv, page_tables,
                   start_lens, qmask, valid, causal_window):
    B, Q, _ = h.shape
    H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = linear_at(layers["wqkv"], li, h, spec)
    xq = qkv[..., : H * D].reshape(B, Q, H, D)
    xk = qkv[..., H * D: (H + Hk) * D].reshape(B, Q, Hk, D)
    xv = qkv[..., (H + Hk) * D:].reshape(B, Q, Hk, D)
    xq, xk = apply_rope(xq, cos, sin), apply_rope(xk, cos, sin)
    write_kv_pages(kv["k"], kv["v"], xk, xv, page_tables, start_lens, valid, li,
                   kv["k_scale"][li] if "k_scale" in kv else None,
                   kv["v_scale"][li] if "v_scale" in kv else None,
                   kv.get("k_tok_scale"), kv.get("v_tok_scale"))
    out = _attention(xq, kv, li, page_tables, start_lens, qmask, causal_window,
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
):
    """Run all decoder layers; returns (hidden [B, Q, E], kv updated in place).

    One function serves prefill (causal qmask), decode (Q = 1) and lookahead
    verify (tree qmask)."""
    layers = params["layers"]
    h = embed_lookup(params["embed"], tokens, params["final_ln"].dtype)
    cos, sin = rope_cos_sin(rope_inv_freq(cfg, h.device), positions)
    n_layers = layers["input_ln"].shape[0]
    for li in range(n_layers):
        hn = rms_norm(h, layers["input_ln"][li], cfg.rms_norm_eps)
        h = h + _attn_block_at(layers, li, cfg, spec, hn, cos, sin, kv,
                               page_tables, start_lens, qmask, valid,
                               causal_window)
        hn = rms_norm(h, layers["post_ln"][li], cfg.rms_norm_eps)
        h = h + _mlp_block_at(layers, li, cfg, spec, hn)
    return h, kv


def logits_from_hidden(params: dict, cfg: ModelConfig, h: torch.Tensor,
                       spec: Optional[QuantSpec] = None) -> torch.Tensor:
    """Final norm + LM head with fp32 logits straight from the accumulator
    (bf16-rounded logits would make greedy argmax ties width-dependent)."""
    h = rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        return embed_logits(params["embed"], h)
    return linear(head, h, spec, out_dtype=torch.float32).to(torch.float32)
