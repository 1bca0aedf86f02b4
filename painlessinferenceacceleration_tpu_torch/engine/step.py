"""Engine steps: chunked prefill and the parallel-branch verify.

Port of ``prefill_step``, ``verify_parallel_core`` and ``decode_inputs``
from ``painlessinferenceacceleration_tpu/engine/step.py``. Where JAX jits
the step and donates the KV arena, these run eagerly and update the arena
in place (the returned ``kv`` is the same dict).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import compact_kv_tail
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.models.base import (
    logits_from_hidden,
    transformer_hidden,
)
from painlessinferenceacceleration_tpu_torch.models.linear_attn import commit_linear_states


def prefill_step(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, C] padded chunk
    start_lens: torch.Tensor,  # [B] committed length before this chunk
    chunk_lens: torch.Tensor,  # [B] valid tokens in this chunk
    page_tables: torch.Tensor,  # [B, P]
    spec: Optional[QuantSpec] = None,
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """One prompt chunk per request; returns (kv, next_tokens [B],
    last_logits [B, V]). next_tokens is meaningful on the final chunk."""
    B, C = tokens.shape
    dev = tokens.device
    i = torch.arange(C, device=dev)
    pos = start_lens.long()[:, None] + i[None, :]
    qmask = (i[:, None] >= i[None, :])[None].expand(B, C, C)
    valid = i[None, :] < chunk_lens[:, None]
    h, kv = transformer_hidden(params, cfg, kv, tokens, pos, page_tables,
                               start_lens, qmask, valid, spec, causal_window=True,
                               slot_ids=slot_ids)
    last = (chunk_lens.long() - 1).clamp(0, C - 1)
    h_last = h[torch.arange(B, device=dev), last][:, None]  # [B, 1, E]
    logits = logits_from_hidden(params, cfg, h_last, spec)[:, 0]
    return kv, torch.argmax(logits, dim=-1).to(torch.int32), logits


def verify_parallel_core(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, Q] (Q = 1 + R*L, block layout of device tables)
    positions: torch.Tensor,
    qmask: torch.Tensor,
    parents: torch.Tensor,
    page_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    active: torch.Tensor,
    R: int,
    L: int,
    spec: Optional[QuantSpec] = None,
    teacher: Optional[torch.Tensor] = None,  # [B, W] teacher-forced stream
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Tree-verify forward, greedy (or teacher-forced) acceptance along the
    best branch, and KV compaction of the accepted rows. Returns (kv,
    out_tokens [B, Q], n_accepted [B]). A linear-attention hybrid verifies
    without writing its states and then commits the accepted chain (root
    first) into the states of ``slot_ids``; inactive rows commit nothing."""
    B, Q = tokens.shape
    assert Q == 1 + R * L, (Q, R, L)
    dev = tokens.device
    node_valid = parents > -2
    valid = node_valid & active[:, None]
    h, kv = transformer_hidden(params, cfg, kv, tokens, positions, page_tables,
                               ctx_lens, qmask, valid, spec, slot_ids=slot_ids,
                               defer_state=cfg.linear_attention)
    logits = logits_from_hidden(params, cfg, h, spec)
    if teacher is not None:
        # the target of the node at stream position p is the teacher's p+1
        W = teacher.shape[1]
        tgt = (positions.long() + 1).clamp(0, W - 1)
        greedy = torch.gather(teacher.long(), 1, tgt).to(torch.int32)
    else:
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    par = parents.long().clamp(0, Q - 1)
    g_par = torch.gather(greedy, 1, par)
    match = (tokens == g_par) & node_valid
    mb = match[:, 1:].reshape(B, R, L).to(torch.int32)
    edges_per_branch = torch.cumprod(mb, dim=2).sum(dim=2)  # [B, R]
    best = torch.argmax(edges_per_branch, dim=1)  # first max, as jnp.argmax
    n_edges = torch.gather(edges_per_branch, 1, best[:, None])[:, 0]
    n_acc = (n_edges + 1).to(torch.int32)

    ar = torch.arange(L, device=dev)[None, :]
    node_ids = 1 + best[:, None] * L + ar  # [B, L]
    if cfg.linear_attention:
        # the committed chain's window columns: the root, then the branch
        chain = torch.cat([torch.zeros_like(node_ids[:, :1]), node_ids], dim=1)
        n_eff = torch.where(active, n_acc, torch.zeros_like(n_acc))
        if slot_ids is None:
            slot_ids = torch.arange(B, dtype=torch.int32, device=dev)
        kv = commit_linear_states(kv, chain, n_eff, slot_ids)
    out_tokens = torch.cat([greedy[:, :1], torch.gather(greedy, 1, node_ids)], dim=1)
    if out_tokens.shape[1] < Q:
        out_tokens = torch.nn.functional.pad(out_tokens, (0, Q - out_tokens.shape[1]))

    # accepted node(best, i) at slot ctx+1+best*L+i moves to ctx+1+i
    eff_edges = torch.where(active & (best > 0), n_edges, torch.zeros_like(n_edges))
    for name in ("k", "v"):
        compact_kv_tail(kv[name], page_tables, ctx_lens, node_ids, eff_edges, Q, active)
    for name in ("k_tok_scale", "v_tok_scale"):  # per-token scales move too
        if name in kv:
            compact_kv_tail(kv[name], page_tables, ctx_lens, node_ids, eff_edges, Q,
                            active, whole_pages=True)
    n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc))
    return kv, out_tokens, n_acc


def decode_inputs(last_tokens: torch.Tensor, ctx_lens: torch.Tensor):
    """Trivial verify inputs for plain decode (Q = 1)."""
    B = last_tokens.shape[0]
    dev = last_tokens.device
    tokens = last_tokens[:, None]
    positions = ctx_lens[:, None]
    qmask = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
    parents = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
    return tokens, positions, qmask, parents
