"""Training-time forward pass: full-sequence causal logits, no KV cache,
differentiable by autograd.

Port of ``painlessinferenceacceleration_tpu/ipad/train_forward.py``
(``_linear``, ``_masked_rms_norm``, ``forward_logits``), op for op. The
JAX package computes these products by XLA outside any Pallas body, so
the port computes them with ``torch.matmul`` (no kernel of ``csrc/``: none
of them has autograd). Products run on operands in the activation dtype
widened to fp32, which gives the fp32 results of the JAX
``preferred_element_type=float32`` products (a bf16 x bf16 product is exact
in fp32), and are cast back to the activation dtype. Leave TF32 off
(torch's default) for fp32 products.

The norms are the JAX package's jnp forms, fp32 ``mean(x * x)``, not
``ops/rmsnorm.py``'s ``rms_norm``, which launches K15 on the card (no
autograd) and sums in fp64 on the CPU.

The JAX forward trains a plain llama whatever the config says: it ignores
qkv and output biases, the legacy-family knobs, YaRN's attention factor,
partial or interleaved rope, and MoE, MLA and hybrid stacks.
``check_trainable`` refuses such configs here, naming what is not modelled.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.ops.rope import (
    apply_rope,
    rope_cos_sin,
    rope_inv_freq,
    yarn_mscale,
)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming it, on what of ``cfg`` the
    training forward does not model."""
    missing = [name for name, on in (
        ("Mixture-of-Experts layers", cfg.is_moe), ("Multi-head Latent Attention", cfg.is_mla),
        ("linear-attention layers", cfg.linear_attention),
        ("qkv biases", cfg.attention_bias), ("output-projection biases", cfg.attention_out_bias),
        ("MLP biases", cfg.mlp_bias), ("layer norm", cfg.norm_type != "rmsnorm"),
        (f"{cfg.position_embedding_type} positions", cfg.position_embedding_type != "rope"),
        ("an un-gated MLP", not cfg.gated_mlp),
        (f"{cfg.hidden_act} activation", cfg.hidden_act not in ("silu", "swish")),
        ("parallel residual", cfg.parallel_residual),
        ("embedding LayerNorm", cfg.embed_layernorm), ("prefix-LM", cfg.prefix_lm),
        ("partial rope", cfg.partial_rotary_factor < 1.0),
        ("interleaved rope", cfg.rope_interleaved),
        ("YaRN's attention factor", yarn_mscale(cfg) != 1.0)) if on]
    if missing:
        raise NotImplementedError(
            f"the IPAD training forward models a plain llama (rmsnorm, rope, gated silu "
            f"MLP, no biases); not {', '.join(missing)} ({cfg.model_type})")


def _linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.to(x.dtype).float()).to(x.dtype)


def rms_norm_fp32(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX package's jnp ``rms_norm``: fp32 ``mean(x * x)``, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _masked_rms_norm(x, w, eps, dim_mask=None):
    """RMSNorm whose mean runs over the kept dims only when a hidden-dim
    mask is given, so the masked model computes what the dim-sliced model
    does (``Distiller.reparam``)."""
    if dim_mask is None:
        return rms_norm_fp32(x, w, eps)
    xf = x.float() * dim_mask
    n = torch.clamp(dim_mask.sum(), min=1.0)
    var = torch.sum(xf * xf, dim=-1, keepdim=True) / n
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   masks: Optional[dict] = None, return_hidden: bool = False):
    """Full-sequence causal logits [B, T, V] (fp32) of ``tokens`` [B, T].

    ``masks`` (``ipad.distill.init_masks``'s layout) multiplies gates into
    the MLP channels (``mlp`` [L, I]), the heads' outputs (``head`` [L, H],
    applied per kv group of G query heads), whole layers' residual updates
    (``layer`` [L]) and the hidden width (``dim`` [E], with the kept-dims
    norm). With ``return_hidden`` also returns the final normed hidden
    state [B, T, E]."""
    check_trainable(cfg)
    B, T = tokens.shape
    dev = tokens.device
    H, Hk, D, I = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                   cfg.intermediate_size)
    G = H // Hk
    eps = cfg.rms_norm_eps
    dim_mask = None
    if masks is not None and "dim" in masks:
        dim_mask = masks["dim"].float()
    h = F.embedding(tokens.long(), params["embed"])
    if dim_mask is not None:
        h = h * dim_mask.to(h.dtype)
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    cos, sin = rope_cos_sin(rope_inv_freq(cfg, dev), pos)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()

    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        lp = {k: v[li] for k, v in layers.items()}
        hn = _masked_rms_norm(h, lp["input_ln"], eps, dim_mask)
        qkv = _linear(lp["wqkv"], hn)
        xq = qkv[..., : H * D].reshape(B, T, H, D)
        xk = qkv[..., H * D: (H + Hk) * D].reshape(B, T, Hk, D)
        xv = qkv[..., (H + Hk) * D:].reshape(B, T, Hk, D)
        if cfg.qk_norm:
            xq = rms_norm_fp32(xq, lp["q_norm"], eps)
            xk = rms_norm_fp32(xk, lp["k_norm"], eps)
        xq = apply_rope(xq, cos, sin)
        xk = apply_rope(xk, cos, sin)
        qg = xq.transpose(1, 2).reshape(B, Hk, G * T, D)
        kc = xk.transpose(1, 2)
        scores = torch.matmul(qg.float(), kc.float().transpose(-1, -2)) * (D ** -0.5)
        scores = scores.reshape(B, Hk, G, T, T).masked_fill(~causal, -1e30)
        p = torch.softmax(scores, dim=-1).to(h.dtype)
        vc = xv.transpose(1, 2)
        att = torch.matmul(p.float(), vc.float()[:, :, None]).to(h.dtype)  # [B, Hk, G, T, D]
        att = att.permute(0, 3, 1, 2, 4)  # [B, T, Hk, G, D]
        if masks is not None and "head" in masks:
            # the head's output is masked: a zeroed q would leave a uniform
            # softmax mix of V, not a pruned head
            att = att * masks["head"][li].reshape(Hk, G)[None, None, :, :, None]
        att = att.reshape(B, T, H * D)
        lm = masks["layer"][li] if masks is not None and "layer" in masks else 1.0
        dout = _linear(lp["wo"], att)
        if dim_mask is not None:
            dout = dout * dim_mask.to(h.dtype)
        h = h + lm * dout
        hn = _masked_rms_norm(h, lp["post_ln"], eps, dim_mask)
        gu = _linear(lp["wgu"], hn)
        gate, up = gu[..., :I], gu[..., I:]
        act = F.silu(gate.float()).to(h.dtype) * up
        if masks is not None and "mlp" in masks:
            act = act * masks["mlp"][li][None, None, :]
        mout = _linear(lp["wdown"], act)
        if dim_mask is not None:
            mout = mout * dim_mask.to(h.dtype)
        h = h + lm * mout

    h = _masked_rms_norm(h, params["final_ln"], eps, dim_mask)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = torch.matmul(h.float(), head.to(h.dtype).float())
    if return_hidden:
        return logits, h
    return logits
