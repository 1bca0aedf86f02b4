"""Context-parallel paged attention: each rank owns a slice of the KV pages.

Port of ``painlessinferenceacceleration_tpu/ops/cp_attention.py``. Under
context parallelism the arena's page axis is split over the ranks of the
model axis: rank d owns the global pages ``[d * per, (d + 1) * per)`` and
holds them as its local pages ``1 .. per`` behind a local null page 0
(``parallel/mesh.py shard_kv``). The parameters are replicated, so every
rank computes every row of a step.

- ``local_page_table`` rebases a page table onto the rank's arena: a
  local page's id becomes its local index, any other page (and the null
  page 0) the local null page.
- ``cp_partial`` is the rank's attention over its own keys: K3 (Q > 128,
  causal) or K2 (every other width, a tree verify past 128 rows too, under
  its mask) with the page range ``[1, per + 1)`` of its
  local pages and the rows' log-sum-exp; on the CPU their plain twin
  (``paged_attention_ref`` with the same range). MLA's expanded arena
  takes the same kernels at its (192, 128) head dims; its latent arena
  (``latent_v_dim`` set: one shared 576-lane K row a token, the value its
  first 512 lanes) takes K13 with the range (``mla_paged_attention``). A
  row that sees no local key comes out 0 with log-sum-exp -inf, and
  weighs exactly 0 in the merge. JAX's ``_local_attention_stats`` returns
  (acc, m, l) and merges with a pmax and two psums; here a rank returns
  its normalised output and log-sum-exp, which carry the same information.
- ``merge_partials`` is the plain merge out = sum_d exp(lse_d - LSE) out_d,
  LSE = log sum_d exp(lse_d), the parts taken in rank order after the
  ordered gather of ``parallel/comm.py``: O(B Q H D), elementwise per row,
  so a row's bits do not depend on the step's width.
- ``cp_attention_oracle`` is the one-process oracle: one process holds
  the whole arena and takes each of the n ranks' partials over it with
  that rank's global page range, then merges them in rank order. Its rows
  have the bits of the ranks' (the same keys in the same blocks). The
  tests and ``chip_smoke.py`` serve a one-process engine whose attention
  is this oracle: its arena, written and compacted as always, is what the
  ranks' arenas, gathered, must equal.
- ``cp_write_kv`` writes the step's K / V rows whose page is local (K16
  writes no invalid token; any row widths: a dense model's heads, MLA's
  576 / 512-lane latent rows or its expanded heads); ``cp_compact_tail``
  replaces the verify step's window compaction: every rank computed every
  row of the step, so the accepted rows are written again to their final
  slots from the step's own K / V rows (``engine/step.py`` asks the
  forward to record them), local pages only, and no collective is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch.engine.cache import write_kv_pages
from painlessinferenceacceleration_tpu_torch.ops.mla_attention import mla_paged_attention
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_prefill,
)
from painlessinferenceacceleration_tpu_torch.parallel.comm import model_gather


def cp_attention_oracle(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        page_tables: torch.Tensor, ctx_lens: torch.Tensor,
                        qmask: torch.Tensor, causal: bool, scale: float,
                        n: int, latent_v_dim: Optional[int] = None) -> torch.Tensor:
    """One process's context-parallel attention over the whole arena
    [n_pages, ps, Hk * D] (MLA's latent arena with ``latent_v_dim``): rank
    d's partial over its global pages [d * per, (d + 1) * per), merged in
    rank order."""
    per = k_pages.shape[0] // n
    parts = [cp_partial(q, k_pages, v_pages, page_tables, ctx_lens, qmask, scale, causal,
                        (d * per, (d + 1) * per), latent_v_dim) for d in range(n)]
    return merge_partials(torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts]), q.dtype)


def local_page_table(page_tables: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """[B, P] global page ids -> this rank's local ids: ``id - lo + 1`` for
    a page in [lo, hi) other than the null page 0, else 0."""
    pt = page_tables.to(torch.int32)
    ok = (pt >= lo) & (pt < hi) & (pt > 0)
    return torch.where(ok, pt - lo + 1, torch.zeros_like(pt))


def cp_partial(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               page_tables: torch.Tensor, ctx_lens: torch.Tensor, qmask: torch.Tensor,
               scale: float, causal: bool, page_range: Tuple[int, int],
               latent_v_dim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Q, H, Dv], lse [B, Q, H] fp32) over the keys whose page id
    lies in ``page_range``: K3 (Q > 128, causal) or K2 (any other width, its
    mask) on the card, their plain twin on the CPU; with ``latent_v_dim``, MLA's latent
    MQA over the K pages alone (K13, the causal flag as the prefill's, its
    plain twin on the CPU). A rank passes its local arena and rebased table
    with the range [1, per + 1)."""
    if latent_v_dim is not None:
        return mla_paged_attention(q, k_pages, page_tables, ctx_lens, qmask, scale,
                                   latent_v_dim, causal=causal, page_range=page_range,
                                   return_lse=True)
    if q.shape[1] > 128 and causal:
        return paged_attention_prefill(q, k_pages, v_pages, page_tables, ctx_lens, scale,
                                       page_range=page_range, return_lse=True)
    return paged_attention(q, k_pages, v_pages, page_tables, ctx_lens, qmask, scale,
                           page_range=page_range, return_lse=True)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """outs [n, B, Q, H, D], lses [n, B, Q, H] (rank order) -> the merged
    attention [B, Q, H, D] in ``dtype`` (default outs'): out = sum_d
    exp(lse_d - LSE) out_d in fp32, the terms in rank order; a part with
    lse -inf weighs 0."""
    n = outs.shape[0]
    m = lses[0]
    for d in range(1, n):
        m = torch.maximum(m, lses[d])
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    tot = torch.exp(lses[0] - m)
    for d in range(1, n):
        tot = tot + torch.exp(lses[d] - m)
    lse = m + torch.log(tot)
    out = torch.exp(lses[0] - lse)[..., None] * outs[0].to(torch.float32)
    for d in range(1, n):
        out = out + torch.exp(lses[d] - lse)[..., None] * outs[d].to(torch.float32)
    out = torch.where(torch.isfinite(lse)[..., None], out, torch.zeros_like(out))
    return out.to(dtype or outs.dtype)


def cp_attention(q: torch.Tensor, kv: dict, li: int, page_tables: torch.Tensor,
                 ctx_lens: torch.Tensor, qmask: torch.Tensor, causal: bool, scale: float,
                 st, latent_v_dim: Optional[int] = None) -> torch.Tensor:
    """Attention of KV layer ``li`` under context parallelism (the rank
    state ``st``): this rank's partial over its pages, gathered with the
    other ranks of its model group in rank order, merged. ``latent_v_dim``:
    MLA's latent arena (``cp_partial``)."""
    per = kv["k"].shape[1] - 1
    lo = st.model_rank * per
    out, lse = cp_partial(q, kv["k"][li], kv["v"][li],
                          local_page_table(page_tables, lo, lo + per), ctx_lens, qmask,
                          scale, causal, (1, per + 1), latent_v_dim)
    return merge_partials(model_gather(out, st), model_gather(lse, st), q.dtype)


def _local_tokens(page_tables: torch.Tensor, start_lens: torch.Tensor, n: int, ps: int,
                  lo: int, hi: int) -> torch.Tensor:
    """[B, n] whether token q of row b (at slot start + q; its page index
    clamped to the table's last, as K16 places it) lands on a local page."""
    P = page_tables.shape[1]
    j = (start_lens.to(torch.int64)[:, None]
         + torch.arange(n, device=page_tables.device)[None]) // ps
    pid = torch.gather(page_tables.to(torch.int64), 1, j.clamp(0, P - 1))
    return (pid >= lo) & (pid < hi) & (pid > 0)


def cp_write_kv(kv: dict, li: int, new_k: torch.Tensor, new_v: torch.Tensor,
                page_tables: torch.Tensor, start_lens: torch.Tensor,
                valid: Optional[torch.Tensor], rank: int) -> None:
    """Write the step's rows of KV layer ``li`` whose page this rank owns
    (the others are invalid for this rank's K16 launch)."""
    per, ps = kv["k"].shape[1] - 1, kv["k"].shape[2]
    lo = rank * per
    B, n = new_k.shape[:2]
    local = _local_tokens(page_tables, start_lens, n, ps, lo, lo + per)
    ok = local if valid is None else local & valid
    write_kv_pages(kv["k"], kv["v"], new_k, new_v, local_page_table(page_tables, lo, lo + per),
                   start_lens, ok, li)


def cp_compact_tail(kv: dict, rows: list, page_tables: torch.Tensor,
                    ctx_lens: torch.Tensor, path: torch.Tensor, n_edges: torch.Tensor,
                    active: Optional[torch.Tensor], rank: int) -> None:
    """The verify step's compaction under context parallelism: node
    ``ctx + path[b, i]`` moves to slot ``ctx + 1 + i`` for i < n_edges[b],
    in every KV layer. ``rows`` are the step's recorded writes (layer, K
    rows, V rows): the accepted rows are written from them to their
    final slots, on this rank's pages only. The window's other slots are
    left as they are, as the compaction leaves them."""
    M = path.shape[1]
    idx = path.to(torch.int64).clamp(min=0)
    ok = torch.arange(M, device=path.device)[None] < n_edges.to(torch.int64)[:, None]
    if active is not None:
        ok = ok & active[:, None]
    start = ctx_lens.to(torch.int32) + 1
    for li, new_k, new_v in rows:
        gk = torch.gather(new_k, 1, idx[:, :, None, None].expand(-1, -1, *new_k.shape[2:]))
        gv = torch.gather(new_v, 1, idx[:, :, None, None].expand(-1, -1, *new_v.shape[2:]))
        cp_write_kv(kv, li, gk, gv, page_tables, start, ok, rank)
