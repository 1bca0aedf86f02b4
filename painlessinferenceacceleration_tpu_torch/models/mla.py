"""Multi-head Latent Attention (the DeepSeek V2 / V3 family).

Port of ``painlessinferenceacceleration_tpu/models/mla.py``. K and V come
from a low-rank latent: ``kv_a`` maps the hidden state to the latent (rank
``kv_lora_rank``, rms-normed) and one shared rope key ``k_pe``; ``kv_b``
expands the latent to each head's ``k_nope`` and ``v``. Two cache modes
(``ModelConfig.mla_latent_cache``):

- expanded: ``kv_b`` is applied at write time and per-head K rows (nope +
  rope lanes) and V rows (``v_head_dim`` lanes) are cached, and attention
  runs over them as grouped-query attention with one kv head a head: the
  paged attention kernel (K2 / K3) at its (K, V) head dims (192, 128) on
  the card, the plain version on the CPU (JAX: ``paged_attention_ref(...,
  v_dim=v_d)``, ``models/mla.py:191-204``);
- latent: one row per token, K = ``[latent | roped k_pe]`` and V = the latent
  (the JAX package's data contract; only K is read), and weight-absorbed
  MQA in latent space: ``q_abs = q_nope . W_uk^T``, attention over the
  shared rows (``ops/mla_attention.py``, K13 on the card), then
  ``out . W_uv``. The two absorption products go through the dense bf16
  GEMM's body per head (``dense_matmul_batched``), whose rows do not depend
  on M, so a row has the same bits at decode, verify and prefill width.

Layer weights are stacked ``[L, ...]`` as in ``models/base.py``; a block
takes its stack and the layer index. The KV arena is written in place.

Under context parallelism (a rank state whose ``cp`` > 1) a block writes
the step's rows onto this rank's pages only and attends through
``ops/cp_attention.py``: in latent mode K13 over the rank's page range, in
expanded mode K2 / K3 over it, each with the rows' log-sum-exp, and the
ranks' partials merged in rank order (JAX gathers the page-sharded arena
instead, GSPMD).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import write_kv_pages
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    dequantize,
    linear_at,
)
from painlessinferenceacceleration_tpu_torch.ops.cp_attention import cp_attention, cp_write_kv
from painlessinferenceacceleration_tpu_torch.ops.mla_attention import mla_paged_attention
from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import dense_matmul_batched
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
)
from painlessinferenceacceleration_tpu_torch.ops.rmsnorm import rms_norm
from painlessinferenceacceleration_tpu_torch.parallel.comm import linear_rows_at
from painlessinferenceacceleration_tpu_torch.ops.rope import (
    apply_rope,
    rope_cos_sin,
    rope_inv_freq,
    yarn_mscale,
)


def mla_head_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(K head dim, V head dim) of the MLA arena: per head in expanded mode,
    the one shared latent row in latent mode (``kv_lora_rank +
    qk_rope_head_dim`` lanes, not padded to 128 as on the TPU)."""
    if cfg.mla_latent_cache:
        return cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.kv_lora_rank
    return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim


def mla_cache_heads(cfg: ModelConfig) -> int:
    """KV heads held in the arena (1 in latent mode: MQA over the latent)."""
    return 1 if cfg.mla_latent_cache else cfg.num_attention_heads


def init_mla_attn(cfg: ModelConfig, linear_leaf: Callable[[int, int], object],
                  norm: Callable[[int], torch.Tensor]) -> dict:
    """The attention weights of a stack of MLA layers: ``linear_leaf(din,
    dout)`` gives one stacked linear leaf, ``norm(width)`` the stacked norm
    weights. With ``q_lora_rank`` the query is low-rank too (``q_a``,
    ``q_a_ln``, ``q_b``), else one ``wq``."""
    E, H = cfg.hidden_size, cfg.num_attention_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, v_d = cfg.kv_lora_rank, cfg.v_head_dim
    p = {
        "kv_a": linear_leaf(E, r + rope_d),
        "kv_a_ln": norm(r),
        "kv_b": linear_leaf(r, H * (nope + v_d)),
        "wo": linear_leaf(H * v_d, E),
    }
    if cfg.q_lora_rank:
        p["q_a"] = linear_leaf(E, cfg.q_lora_rank)
        p["q_a_ln"] = norm(cfg.q_lora_rank)
        p["q_b"] = linear_leaf(cfg.q_lora_rank, H * (nope + rope_d))
    else:
        p["wq"] = linear_leaf(E, H * (nope + rope_d))
    return p


def _per_head(x: torch.Tensor) -> torch.Tensor:
    """[B, Q, H, D] -> [H, B*Q, D]."""
    B, Q, H, D = x.shape
    return x.permute(2, 0, 1, 3).reshape(H, B * Q, D)


def _from_heads(x: torch.Tensor, B: int, Q: int) -> torch.Tensor:
    """[H, B*Q, D] -> [B, Q, H, D]."""
    H, _, D = x.shape
    return x.reshape(H, B, Q, D).permute(1, 2, 0, 3)


# a stacked plain kv_b -> its absorption weights, laid out once per stack
_ABSORB = WeakIdKeyDictionary()


def _absorption_weights(kv_b, li: int, cfg: ModelConfig, spec: Optional[QuantSpec],
                        dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``li``'s W_uk^T [H, nope, r] and W_uv [H, r, v_d] from ``kv_b``
    [r, H * (nope + v_d)]. A quantized kv_b is dequantized per call (as in
    the JAX package); a plain one is laid out for the whole stack, contiguous
    per head, on its first call and kept while the stack lives."""
    H, nope, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    v_d = cfg.v_head_dim
    if isinstance(kv_b, dict):
        wkv = dequantize({k: v[li] for k, v in kv_b.items()}, spec, dtype)
        wkv = wkv.reshape(r, H, nope + v_d)
        return wkv[..., :nope].permute(1, 2, 0), wkv[..., nope:].permute(1, 0, 2)
    hit = _ABSORB.get(kv_b)
    if hit is None or hit[0].dtype != dtype:
        wkv = kv_b.to(dtype).reshape(kv_b.shape[0], r, H, nope + v_d)
        hit = (wkv[..., :nope].permute(0, 2, 3, 1).contiguous(),
               wkv[..., nope:].permute(0, 2, 1, 3).contiguous())
        _ABSORB[kv_b] = hit
    return hit[0][li], hit[1][li]


def _mla_attention(q: torch.Tensor, kv: dict, li: int, page_tables: torch.Tensor,
                   start_lens: torch.Tensor, qmask: torch.Tensor, causal: bool,
                   scale: float, latent_v_dim: Optional[int]) -> torch.Tensor:
    """One process's attention of KV layer ``li`` over the whole arena:
    K13 over the latent arena (``latent_v_dim`` set, any Q), else K2 / K3
    over the expanded one: K3 for a causal chunk past 128 rows, K2 with the
    mask for every other width (a tree verify past 128 rows too)."""
    kk = kv["k"][li]
    if latent_v_dim is not None:
        return mla_paged_attention(q, kk, page_tables, start_lens, qmask, scale,
                                   v_dim=latent_v_dim, causal=causal)
    vv = kv["v"][li]  # [n_pages, ps, H * 192] / [.., H * 128]
    if q.shape[1] > 128 and causal:
        return paged_attention_prefill(q, kk, vv, page_tables, start_lens, scale)
    return paged_attention(q, kk, vv, page_tables, start_lens, qmask, scale)


def mla_attn_block(layers: dict, li: int, kv_li: int, cfg: ModelConfig,
                   spec: Optional[QuantSpec], h: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, kv: dict, page_tables: torch.Tensor,
                   start_lens: torch.Tensor, qmask: torch.Tensor,
                   valid: Optional[torch.Tensor], causal_window: bool, par=None,
                   record: Optional[list] = None) -> torch.Tensor:
    """MLA of layer ``li`` of the stack ``layers`` over KV layer ``kv_li``;
    h [B, Q, E], cos/sin [B, Q, rope/2] (no YaRN factor: it enters the
    softmax scale squared). Returns [B, Q, E]. ``par`` is the rank's
    ``parallel.comm.RankState`` (None: one process); ``record``, when a
    list, gets (kv_li, K rows, V rows) of the arena write."""
    B, Q, _ = h.shape
    H = cfg.num_attention_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, v_d = cfg.kv_lora_rank, cfg.v_head_dim
    eps = cfg.rms_norm_eps

    if "q_a" in layers:
        qa = rms_norm(linear_at(layers["q_a"], li, h, spec), layers["q_a_ln"][li], eps)
        q = linear_at(layers["q_b"], li, qa, spec)
    else:
        q = linear_at(layers["wq"], li, h, spec)
    q = q.reshape(B, Q, H, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    kva = linear_at(layers["kv_a"], li, h, spec)  # [B, Q, r + rope_d]
    c_kv = rms_norm(kva[..., :r], layers["kv_a_ln"][li], eps)
    k_pe = kva[..., r:][:, :, None, :]  # one rope key shared by every head

    # DeepSeek pairs rope dims interleaved (HF rope_interleave=True)
    q_pe = apply_rope(q_pe, cos, sin, interleaved=True)
    k_pe = apply_rope(k_pe, cos, sin, interleaved=True)
    scale = (nope + rope_d) ** -0.5 * yarn_mscale(cfg) ** 2

    latent_v = r if cfg.mla_latent_cache else None
    if cfg.mla_latent_cache:
        w_uk_t, w_uv = _absorption_weights(layers["kv_b"], li, cfg, spec, h.dtype)
        q_abs = _from_heads(dense_matmul_batched(_per_head(q_nope), w_uk_t, h.dtype), B, Q)
        q_full = torch.cat([q_abs, q_pe], dim=-1)  # [B, Q, H, r + rope_d]
        k_lat = torch.cat([c_kv[:, :, None, :], k_pe], dim=-1)  # [B, Q, 1, r + rope_d]
        new_k, new_v = k_lat, c_kv[:, :, None, :]
    else:
        kvb = linear_at(layers["kv_b"], li, c_kv, spec).reshape(B, Q, H, nope + v_d)
        k = torch.cat([kvb[..., :nope], k_pe.expand(B, Q, H, rope_d)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        new_k, new_v = k, kvb[..., nope:]
    if par is not None and par.cp > 1:  # this rank's pages; the ranks' parts merged
        cp_write_kv(kv, kv_li, new_k, new_v, page_tables, start_lens, valid, par.model_rank)
        out = cp_attention(q_full, kv, kv_li, page_tables, start_lens, qmask, causal_window,
                           scale, par, latent_v)
    else:
        write_kv_pages(kv["k"], kv["v"], new_k, new_v, page_tables, start_lens, valid, kv_li)
        out = _mla_attention(q_full, kv, kv_li, page_tables, start_lens, qmask,
                             causal_window, scale, latent_v)
    if cfg.mla_latent_cache:  # [B, Q, H, r] back through W_uv
        out = _from_heads(dense_matmul_batched(_per_head(out), w_uv, h.dtype), B, Q)
    if record is not None:
        record.append((kv_li, new_k, new_v))
    return linear_rows_at(layers["wo"], li, out.reshape(B, Q, H * v_d), spec, par,
                          par is None or par.attn_split)


def mla_rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin over ``qk_rope_head_dim`` without the YaRN factor."""
    return rope_cos_sin(rope_inv_freq(cfg, positions.device), positions)
