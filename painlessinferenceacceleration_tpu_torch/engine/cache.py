"""Paged KV arena (bf16 or fp32), updated in place.

Port of ``painlessinferenceacceleration_tpu/engine/cache.py`` for the
unquantized arena. The layout is the JAX package's data contract:
``[n_layers, n_pages, page_size, n_kv_heads * head_dim]``, token-major with
the heads folded into the last axis, and page 0 reserved as the null page
that padded page-table entries and invalid tokens point at.

JAX donates the arena and gets an updated copy back; here every writer
updates the tensor in place and also returns it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device
from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
from painlessinferenceacceleration_tpu_torch.ops.kv_update import kv_permute_pages


def kv_cache_shape(mcfg: ModelConfig, ecfg: EngineConfig) -> Tuple[int, ...]:
    return (
        mcfg.num_hidden_layers,
        ecfg.num_pages,
        ecfg.page_size,
        mcfg.num_key_value_heads * mcfg.head_dim,
    )


def init_kv_cache(mcfg: ModelConfig, ecfg: EngineConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Allocate the zeroed K and V arenas on ``device`` (default cuda)."""
    dev = resolve_device(device)
    shape = kv_cache_shape(mcfg, ecfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def write_kv_pages(
    k_pages: torch.Tensor,  # [L, n_pages, ps, H*D]
    v_pages: torch.Tensor,
    new_k: torch.Tensor,  # [B, Q, H, D]
    new_v: torch.Tensor,
    page_tables: torch.Tensor,  # [B, P]
    start_lens: torch.Tensor,  # [B]
    valid: Optional[torch.Tensor] = None,  # [B, Q]; invalid -> null page
    layer: int = 0,
):
    """Scatter the step's K/V rows of layer ``layer`` into the arena, in place.

    Token q of request b lands at slot ``start_lens[b] + q``."""
    B, Q, H, D = new_k.shape
    ps = k_pages.shape[2]
    P = page_tables.shape[1]
    slots = start_lens.long()[:, None] + torch.arange(Q, device=new_k.device)[None, :]
    page_of = torch.gather(page_tables.long(), 1, (slots // ps).clamp(max=P - 1))
    if valid is not None:
        page_of = torch.where(valid, page_of, torch.zeros_like(page_of))
    fp, fr = page_of.reshape(-1), (slots % ps).reshape(-1)
    k_pages[layer, fp, fr] = new_k.reshape(B * Q, H * D).to(k_pages.dtype)
    v_pages[layer, fp, fr] = new_v.reshape(B * Q, H * D).to(v_pages.dtype)
    return k_pages, v_pages


def gather_kv_pages(pages: torch.Tensor, page_tables: torch.Tensor,
                    head_dim: int) -> torch.Tensor:
    """One layer's pages [n_pages, ps, H*D] -> dense [B, H, P*ps, D]."""
    g = pages[page_tables.long()]  # [B, P, ps, H*D]
    B, P, S, HD = g.shape
    H = HD // head_dim
    g = g.reshape(B, P, S, H, head_dim).permute(0, 3, 1, 2, 4)
    return g.reshape(B, H, P * S, head_dim)


def compact_kv_tail(
    pages: torch.Tensor,  # [L, n_pages, ps, H*D]
    page_tables: torch.Tensor,  # [B, P]
    ctx_lens: torch.Tensor,  # [B]
    path: torch.Tensor,  # [B, M] accepted in-step node offsets
    n_edges: torch.Tensor,  # [B] accepted edges (moves)
    q_width: int,  # verify width Q (tail window = [ctx, ctx+Q))
    active: Optional[torch.Tensor] = None,  # [B]; inactive rows -> null page
) -> torch.Tensor:
    """Lookahead KV compaction as a permute of each request's tail window:
    node (ctx + path[i]) moves to slot (ctx + 1 + i) for i < n_edges, in
    place over all layers (``kv_permute_pages``)."""
    B, M = path.shape
    ps = pages.shape[2]
    P = page_tables.shape[1]
    dev = pages.device
    TPP = (q_width + ps - 1) // ps + 1  # pages overlapping the tail window
    ctx = ctx_lens.long()
    p0 = ctx // ps
    page_pos = (p0[:, None] + torch.arange(TPP, device=dev)[None, :]).clamp(0, P - 1)
    page_ids = torch.gather(page_tables.long(), 1, page_pos)
    if active is not None:
        page_ids = torch.where(active[:, None], page_ids, torch.zeros_like(page_ids))

    # slot-source table over the window, with a sink column W for the moves
    # that do not happen (JAX drops them with mode="drop")
    W = TPP * ps
    win_base = p0 * ps
    src_of = win_base[:, None] + torch.arange(W + 1, device=dev)[None, :]
    i = torch.arange(M, device=dev)[None, :]
    mv = i < n_edges.long()[:, None]
    w_idx = torch.where(mv, ctx[:, None] + 1 + i - win_base[:, None],
                        torch.full_like(i, W).expand(B, M))
    src_of.scatter_(1, w_idx, torch.where(mv, ctx[:, None] + path.long(), 0))
    src_rel = (src_of[:, :W] - win_base[:, None]).clamp(0, W - 1)
    return kv_permute_pages(pages, page_ids, src_rel)
