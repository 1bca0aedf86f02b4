"""Paged attention with prefix + in-step tree masks: the plain torch path.

Port of ``painlessinferenceacceleration_tpu/ops/attention.py``. One
visibility rule covers prefill, decode and lookahead verify::

    key j is visible to query (b, t)  iff
        j < start_lens[b]                                  (committed prefix)
     or s = j - start_lens[b] in [0, Q) and qmask[b, t, s]  (in-step)

The in-step tokens are written into the arena before attention. These
functions are the plain versions that the kernels in ``ops/paged_attention.py``
are held against.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: all-masked rows stay finite


def attention_mask(start_lens: torch.Tensor, qmask: torch.Tensor,
                   kv_len_total: int) -> torch.Tensor:
    """[B, Q, L] bool visibility mask (L = padded arena view length)."""
    B, Q, _ = qmask.shape
    j = torch.arange(kv_len_total, dtype=torch.int64, device=qmask.device)[None, None, :]
    start = start_lens.to(torch.int64)[:, None, None]
    s = j - start
    s_clip = s.clamp(0, Q - 1).expand(B, Q, kv_len_total)
    instep = torch.gather(qmask, 2, s_clip)
    return (j < start) | ((s >= 0) & (s < Q) & instep)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [n_heads] fp32 (HF bloom's
    ``build_alibi_tensor`` rule, as the JAX package computes it)."""
    cp2 = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** i for i in range(1, cp2 + 1)]
    if cp2 != n_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra ** i for i in range(1, 2 * (n_heads - cp2) + 1, 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, scale: float,
                  alibi: Optional[torch.Tensor] = None,
                  key_pos: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """Masked GQA attention with fp32 softmax and accumulation.

    q [B, Q, Hq, D]; k [B, Hkv, L, D]; v [B, Hkv, L, Dv]; mask [B, Q, L];
    ``alibi`` [Hq] slopes: each score gains slope[h] * (the key's position),
    ``key_pos`` [B, L] (default: key slot j is at position j). HF's relative
    form differs by a per-row constant, which the softmax cancels. Returns
    [B, Q, Hq, Dv]; with ``return_lse`` also each row's fp32 log-sum-exp
    [B, Q, Hq] of its scores (bias included), where a row that sees no key
    gives -inf and an output of 0."""
    B, Qn, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G * Qn, D).to(torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", qg, k.to(torch.float32)) * scale
    scores = scores.reshape(B, Hkv, G, Qn, -1)
    if alibi is not None:
        if key_pos is None:
            key_pos = torch.arange(scores.shape[-1], device=scores.device)[None]
        j = key_pos.to(torch.float32)[:, None, None, None, :]
        scores = scores + alibi.to(torch.float32).reshape(1, Hkv, G, 1, 1) * j
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Qn, Hq, v.shape[-1])
    if not return_lse:
        return out.to(q.dtype)
    seen = mask.any(dim=-1)[:, :, None]  # [B, Q, 1]
    lse = torch.logsumexp(scores, dim=-1).permute(0, 3, 1, 2).reshape(B, Qn, Hq)
    lse = torch.where(seen, lse, torch.full_like(lse, float("-inf")))
    out = torch.where(seen[..., None], out, torch.zeros_like(out))
    return out.to(q.dtype), lse


def alibi_key_positions(start_lens: torch.Tensor, alibi_pos: torch.Tensor,
                        kv_len_total: int) -> torch.Tensor:
    """[B, L] the position of each key slot: slot j < start is at j (the
    committed keys), slot start + s at alibi_pos[b, s] (the step's own keys;
    a tree verify's node sits at ctx + its depth, not at its slot)."""
    B, Q = alibi_pos.shape
    j = torch.arange(kv_len_total, device=alibi_pos.device)[None].expand(B, kv_len_total)
    s = j - start_lens.to(torch.int64)[:, None]
    inq = (s >= 0) & (s < Q)
    return torch.where(inq, torch.gather(alibi_pos.to(torch.int64), 1, s.clamp(0, Q - 1)), j)


def paged_attention_ref(q, k_pages, v_pages, page_tables, start_lens, qmask,
                        scale: float, k_scale=None, v_scale=None,
                        v_dim: Optional[int] = None,
                        alibi: Optional[torch.Tensor] = None,
                        alibi_pos: Optional[torch.Tensor] = None,
                        page_range=None, return_lse: bool = False):
    """Gather-then-attend reference over one layer's pages [n_pages, ps, H*D]
    (V pages [n_pages, ps, H*v_dim] where the V head dim differs, as in
    MLA; ``v_dim`` defaults to the V arena's width over the K arena's
    heads).

    An e4m3 arena is dequantized as it is gathered: ``k_scale``/``v_scale``
    are the layer's static per-head scales [H] or its per-token scale
    arenas [n_pages, ps, H]; ``alibi`` the [Hq] ALiBi slopes and
    ``alibi_pos`` [B, Q] the positions of the step's own keys (default:
    their slots, as in prefill and decode). ``page_range`` (lo, hi) keeps
    only the keys whose page id lies in [lo, hi); ``return_lse`` also gives
    each row's log-sum-exp (``mha_reference``): the plain twin of the
    kernels' context-parallel mode."""
    from painlessinferenceacceleration_tpu_torch.engine.cache import gather_kv_pages

    D = q.shape[-1]
    if v_dim is None:  # the V arena holds as many heads as the K arena
        v_dim = v_pages.shape[-1] // (k_pages.shape[-1] // D)
    kc = gather_kv_pages(k_pages, page_tables, D, k_scale, q.dtype)
    vc = gather_kv_pages(v_pages, page_tables, v_dim, v_scale, q.dtype)
    mask = attention_mask(start_lens, qmask, kc.shape[2])
    if page_range is not None:
        lo, hi = page_range
        pt = page_tables.to(torch.int64)
        ok = (pt >= lo) & (pt < hi)  # [B, P]
        mask = mask & ok.repeat_interleave(k_pages.shape[1], dim=1)[:, None, :]
    key_pos = None
    if alibi is not None and alibi_pos is not None:
        key_pos = alibi_key_positions(start_lens, alibi_pos, kc.shape[2])
    return mha_reference(q, kc, vc, mask, scale, alibi, key_pos, return_lse)


def causal_qmask(q_len: int, device=None) -> torch.Tensor:
    """Lower-triangular in-step mask (prefill chunks)."""
    i = torch.arange(q_len, device=device)
    return i[:, None] >= i[None, :]
