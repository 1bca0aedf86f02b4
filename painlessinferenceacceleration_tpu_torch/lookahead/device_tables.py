"""Device-resident draft tables: hash-bucketed 2-gram -> branch store.

Port of ``painlessinferenceacceleration_tpu/lookahead/device_tables.py``.
The tables stay on the card, as set-associative tensors::

    key0/key1 : int32[buckets, ways]      exact 2-gram tags (-1 = empty)
    freq      : float32[buckets, ways]    branch hit frequency
    branch    : int32[buckets, ways, L]   continuation tokens (-1 = pad)

Semantics are the JAX package's, bit for bit: the uint32 2-gram hash, way
choice (first hit, else first least-frequent way), lower-index-first order
on frequency ties, and the streaming exactly-once insertion rule. Updates
are in place and are eager torch ops (one position after another, since
in-window bucket collisions are read-modify-write dependent); retrieval and
tree building are batched over requests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device


@dataclasses.dataclass(frozen=True)
class DraftTableConfig:
    buckets: int = 8192  # power of two
    ways: int = 8  # stored branches per 2-gram bucket
    branch_length: int = 12  # tokens per branch
    retrieve_count: int = 4  # branches offered per draft (<= ways)
    # Per-step adaptive width (engine/multistep.py): on a step where no
    # active row retrieves a draft above gate_min_freq, run a plain width-1
    # AR step instead of the Q = 1 + R*L verify. Off by default, as in the
    # JAX package, where a per-step lax.cond over the donated KV arena
    # copies the whole arena in and out (the conditional aliases its
    # buffers to one branch only); the production gate there and here is
    # chunk-level: every spec burst reports the per-step probe (wide_mask)
    # and LLM switches between spec and AR bursts on it (spec cooldown).
    # The port's per-step gate is a host branch on the probe.
    adaptive: bool = False
    gate_min_freq: float = 0.0  # a draft is retrievable iff top freq > this

    @property
    def verify_width(self) -> int:
        """Q of the verify step this table feeds: root + R*L draft nodes."""
        return 1 + self.retrieve_count * self.branch_length


def init_draft_tables(tcfg: DraftTableConfig, device=None) -> dict:
    dev = resolve_device(device)
    B, W, L = tcfg.buckets, tcfg.ways, tcfg.branch_length
    return {
        "key0": torch.full((B, W), -1, dtype=torch.int32, device=dev),
        "key1": torch.full((B, W), -1, dtype=torch.int32, device=dev),
        "freq": torch.zeros((B, W), dtype=torch.float32, device=dev),
        "branch": torch.full((B, W, L), -1, dtype=torch.int32, device=dev),
    }


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32), in int64 without overflow."""
    lo, hi = a & 0xFFFF, (a >> 16) & 0xFFFF
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _bucket_of(p0: torch.Tensor, p1: torch.Tensor, buckets: int) -> torch.Tensor:
    """The JAX package's 2-gram hash with uint32 wraparound (a -1 pad wraps
    to 0xFFFFFFFF), computed in int64."""
    a = p0.to(torch.int64) & 0xFFFFFFFF
    b = p1.to(torch.int64) & 0xFFFFFFFF
    h = (_mul_u32(a, 2654435761) + _mul_u32(b, 40503)) & 0xFFFFFFFF
    return h % buckets


def update_tables_seq(
    tables: dict,
    tcfg: DraftTableConfig,
    tokens: torch.Tensor,  # [T] int
    n_valid,
    win_lo: Optional[int] = None,
    win_hi: Optional[int] = None,
) -> dict:
    """Insert the windows of ``tokens[:n_valid]`` in place.

    A window at position i is prefix (t[i], t[i+1]) and branch
    t[i+2 : i+2+L] (cut at n_valid -> -1 pads). Streaming mode
    (``win_lo``/``win_hi`` given, the span of new positions): a window whose
    first branch token is new is inserted with a freq bump; one whose
    branch only grows into the new span extends its existing way (pads
    filled, no bump, never evicts); positions the rule cannot touch are
    skipped."""
    T = tokens.shape[0]
    L = tcfg.branch_length
    if T < 3:
        return tables
    dev = tokens.device
    tok = tokens.to(torch.int64)
    nv = torch.as_tensor(n_valid, device=dev)
    pos = torch.arange(T - 2, device=dev)
    idx = torch.arange(T, device=dev)[:, None] + 2 + torch.arange(L, device=dev)[None, :]
    branches = torch.where(idx < nv, tok[idx.clamp(max=T - 1)], -1)  # [T, L]
    p0s, p1s = tok[:-2], tok[1:-1]
    valid = (pos + 2 < nv) & (p0s >= 0) & (p1s >= 0)
    lo, hi = 0, T - 2
    if win_lo is None:
        is_new = torch.ones_like(valid)
    else:
        first = pos + 2
        is_new = (first >= win_lo) & (first < win_hi)
        is_ext = (first < win_lo) & (first + L > win_lo)
        valid = valid & (is_new | is_ext)
        lo, hi = max(0, win_lo - L - 1), min(T - 2, win_hi - 2)
    buckets = _bucket_of(p0s, p1s, tcfg.buckets)
    bump = is_new.to(torch.float32)
    k0t, k1t, frt, brt = (tables["key0"], tables["key1"], tables["freq"],
                          tables["branch"])
    for i in range(lo, hi):
        b = buckets[i]
        nb = branches[i]
        k0, k1, fr, br = k0t[b], k1t[b], frt[b], brt[b]
        hit = (k0 == p0s[i]) & (k1 == p1s[i]) & (br[:, 0] == nb[0])
        any_hit = hit.any()
        ok = valid[i] & (is_new[i] | any_hit)
        way = torch.where(any_hit, torch.argmax(hit.to(torch.int32)), torch.argmin(fr))
        new_freq = torch.where(any_hit, fr[way] + bump[i], bump[i])
        old_br = br[way]
        merged = torch.where(any_hit & (old_br >= 0), old_br, nb.to(old_br.dtype))
        k0t[b, way] = torch.where(ok, p0s[i].to(k0.dtype), k0[way])
        k1t[b, way] = torch.where(ok, p1s[i].to(k1.dtype), k1[way])
        frt[b, way] = torch.where(ok, new_freq, fr[way])
        brt[b, way] = torch.where(ok, merged, old_br)
    return tables


def update_tables_batch(tables: dict, tcfg: DraftTableConfig, bufs: torch.Tensor,
                        n_valid, win_lo, win_hi) -> dict:
    """Streamed update from B row buffers [B, W] (-1 padded), one row after
    another as the JAX package's fori over rows does. ``n_valid``/``win_lo``/
    ``win_hi`` are host integers per row; a row with fewer than 3 valid
    tokens holds no window and is skipped."""
    for b in range(bufs.shape[0]):
        n = int(n_valid[b])
        if n >= 3:
            update_tables_seq(tables, tcfg, bufs[b], n, win_lo=int(win_lo[b]),
                              win_hi=int(win_hi[b]))
    return tables


def decay_tables(tables: dict, factor: float = 0.5) -> dict:
    """The frequency decay (the reference's squeeze law): a new tables dict
    whose ``freq`` is the old one times ``factor`` (halved by default); the
    other leaves are the same tensors."""
    out = dict(tables)
    out["freq"] = tables["freq"] * factor
    return out


def retrieve_drafts(tables: dict, tcfg: DraftTableConfig, p0: torch.Tensor,
                    p1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top retrieve_count branches for 2-grams (p0, p1) [...].

    Returns (branches [..., R, L] with -1 pads, freqs [..., R]; freq 0 =>
    no branch). Frequency ties keep the lower way first, as lax.top_k does."""
    b = _bucket_of(p0, p1, tcfg.buckets)
    hit = (tables["key0"][b] == p0[..., None]) & (tables["key1"][b] == p1[..., None])
    score = torch.where(hit, tables["freq"][b], torch.zeros_like(tables["freq"][b]))
    R = tcfg.retrieve_count
    top_scores, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :R], top_idx[..., :R]
    rows = tables["branch"][b]  # [..., W, L]
    branches = torch.gather(
        rows, -2, top_idx[..., None].expand(*top_idx.shape, rows.shape[-1]))
    branches = torch.where((top_scores > 0.0)[..., None], branches,
                           torch.full_like(branches, -1))
    return branches, top_scores


def build_tree_inputs(root_token: torch.Tensor, branches: torch.Tensor):
    """Lay parallel branches out as verify inputs of static width Q = 1 + R*L.

    root_token [...]; branches [..., R, L]. Returns (tokens [..., Q],
    parents [..., Q], qmask [..., Q, Q], depth [..., Q]). A -1 token
    invalidates its node and the rest of its branch (parents -2)."""
    *lead, R, L = branches.shape
    Q = 1 + R * L
    dev = branches.device
    vb = torch.cumprod((branches >= 0).to(torch.int32), dim=-1).to(torch.bool)
    node_valid = vb.reshape(*lead, R * L)
    flat = branches.reshape(*lead, R * L)
    tokens = torch.cat([root_token[..., None].to(torch.int32),
                        torch.where(node_valid, flat, 0).to(torch.int32)], dim=-1)
    j = torch.arange(R * L, device=dev)
    parents_draft = torch.where(j % L == 0, 0, j).expand(*lead, R * L)
    parents_draft = torch.where(node_valid, parents_draft, -2)
    parents = torch.cat([torch.full((*lead, 1), -1, device=dev, dtype=torch.int64),
                         parents_draft], dim=-1).to(torch.int32)

    qi = torch.arange(Q, device=dev)
    row_branch = torch.div(qi - 1, L, rounding_mode="floor")
    row_pos = torch.remainder(qi - 1, L)
    qmask = (row_branch[:, None] == row_branch[None, :]) & (row_pos[None, :] <= row_pos[:, None])
    qmask[:, 0] = True  # root column visible to all
    qmask[0, :] = False
    qmask[0, 0] = True
    valid_full = torch.cat([torch.ones((*lead, 1), dtype=torch.bool, device=dev),
                            node_valid], dim=-1)
    qmask = qmask & valid_full[..., None, :] & valid_full[..., :, None]
    qmask[..., 0, 0] = True
    depth = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), row_pos[1:] + 1])
    depth = torch.where(valid_full, depth, 0).to(torch.int32)
    return tokens, parents, qmask, depth
