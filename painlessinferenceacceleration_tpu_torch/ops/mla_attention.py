"""MLA attention over the fused ``[latent | roped k_pe]`` page arena: the
kernel wrapper, its launch plan and its plain version.

``mla_paged_attention`` replaces the Pallas ``_mla_kernel``
(``painlessinferenceacceleration_tpu/ops/mla_attention.py``): weight-absorbed
MQA in latent space, where every q head attends the one shared K "head" of
the latent arena and a key's value is the first ``v_dim`` lanes of its K row,
so only the K arena is read. On a CUDA tensor it launches
``csrc/mla_attention.cu`` (K13, one tensor-core body) or raises; on a CPU
tensor it takes ``mla_paged_attention_plain``, which is ``paged_attention_ref``
with V = K's first ``v_dim`` lanes. The scale multiplies the fp32 scores in
both (the Pallas wrapper rounds ``q * scale`` to q's dtype first).

The kernel takes tiles of ``TILE_ROWS`` query rows (row r = t * H + h) and
cuts each request's keys into chunks of ``CHUNK_KEYS`` at absolute positions.
A row's result is the fold of its chunks' partials in ascending order, in
every route: decode and verify run one block a (chunk, request, tile) and a
combine kernel over fp32 partials; prefill (the causal flag) runs one block
a tile that folds at each chunk edge. So a row's bits do not depend on Q,
B, H, the route or its place in the tile. ``mla_plan`` is the launch the
kernel makes (grid, chunks, workspace), from shapes the host knows: the
window ``page_tables.shape[1] * 64`` bounds the chunks, and ``ctx`` is read
only on the card. ``mla_check`` is the geometry the card takes.

Context parallelism: ``page_range`` (lo, hi) keeps only the keys whose page
id lies in [lo, hi) (on the card the RANGED build, whose skipped key blocks
are neither loaded nor multiplied, in the same absolute chunks, so the full
range gives the bits of the call without one), and ``return_lse`` also
gives each row's log-sum-exp of its scaled scores (fp32, natural log; a row
that sees no key comes out 0 with -inf), in every route: the one-chunk
case, the combine of decode and verify, and the walk's fold.

``launches`` counts the kernel's launches and ``modes`` counts them by width
kind (decode Q = 1, verify with a mask, prefill with the causal rule; a
ranged launch also under "decode,range", "verify,range" or
"prefill,range").
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.ops.attention import (
    causal_qmask,
    paged_attention_ref,
)

TILE_ROWS = 64  # csrc/mla_attention.cu kRows: query rows of a tile
KEY_BLOCK = 64  # kKeys: keys of a block, one page
K_DIM, V_DIM = 576, 512  # kDk, kDv: a latent row (512 + 64 rope lanes), its value lanes
CHUNK_KEYS = 512  # keys of a context chunk: the fixed partition of every route
LOG2E = 1.4426950408889634
_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6 + (
    ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
_ALL_PAGES = (0, 2 ** 31 - 1)  # the C entry's "no range": every key block

MlaPlan = collections.namedtuple(
    "MlaPlan", "n_tiles n_chunks walk grid combine_grid workspace_floats scratch_floats")


def mla_check(H: int, Dk: int, Dv: int, ps: int) -> None:
    """Raise ValueError unless the kernel takes this geometry: rows of
    K_DIM lanes of which the first V_DIM are the value (nine 64-lane TMA
    boxes; two warpgroups of 256 value lanes), pages of KEY_BLOCK keys (a
    key block is one page) and at least one head."""
    if Dk != K_DIM or Dv != V_DIM:
        raise ValueError(f"MLA attention on the card takes {K_DIM}-lane rows with "
                         f"{V_DIM} value lanes, not Dk={Dk} v_dim={Dv}")
    if ps != KEY_BLOCK:
        raise ValueError(f"MLA attention on the card takes pages of {KEY_BLOCK} keys, "
                         f"not {ps}")
    if H < 1:
        raise ValueError(f"MLA attention needs at least one head, not {H}")


def mla_plan(B: int, Q: int, H: int, P: int, causal: bool,
             chunk: int = CHUNK_KEYS, walk: Optional[bool] = None) -> MlaPlan:
    """The launch for B requests of Q positions and H heads over page tables
    of P pages: tiles of TILE_ROWS rows, chunks of ``chunk`` keys over the
    window of P * KEY_BLOCK keys. The prefill route (``walk``, the default
    under the causal flag) is one block a (request, tile), grid (1, B,
    n_tiles), with an fp32 scratch of a tile's rows when the window holds
    more than one chunk; decode and verify take grid (n_chunks, B, n_tiles)
    and, with more than one chunk, the partials' workspace (O and the (m, l)
    pairs) and a combine grid (Q H, B)."""
    if B < 1 or Q < 1 or H < 1 or P < 1:
        raise ValueError(f"MLA attention needs B, Q, H, P >= 1 (B={B} Q={Q} H={H} P={P})")
    if chunk < KEY_BLOCK or chunk % KEY_BLOCK:
        raise ValueError(f"chunks are whole key blocks of {KEY_BLOCK}, not {chunk}")
    if B > 65535:
        raise ValueError(f"MLA attention takes at most 65535 requests, not {B}")
    walk = causal if walk is None else walk
    n_tiles = -(-Q * H // TILE_ROWS)
    if n_tiles > 65535:
        raise ValueError(f"MLA attention takes at most 65535 row tiles, not {n_tiles}")
    n_chunks = -(-P * KEY_BLOCK // chunk)
    tile_floats = TILE_ROWS * V_DIM
    ws = scratch = 0
    if n_chunks > 1:
        if walk:
            scratch = B * n_tiles * tile_floats
        else:
            ws = B * n_tiles * n_chunks * (tile_floats + 2 * TILE_ROWS)
    grid = (1 if walk else n_chunks, B, n_tiles)
    combine = None if walk or n_chunks == 1 else (Q * H, B)
    return MlaPlan(n_tiles, n_chunks, walk, grid, combine, ws, scratch)


def tile_of(z: int, n_tiles: int, causal: bool) -> int:
    """The row tile block z of the grid takes: under the causal rule the
    heaviest (last) first."""
    return n_tiles - 1 - z if causal else z


def tile_last_key(ctx: int, Q: int, H: int, tile: int, P: int, causal: bool) -> int:
    """The last key a tile's rows can see, within the window of P pages."""
    r0 = tile * TILE_ROWS
    nr = min(TILE_ROWS, Q * H - r0)
    last = ctx + (r0 + nr - 1) // H if causal else ctx + Q - 1
    return min(last, P * KEY_BLOCK - 1)


def tile_chunks(ctx: int, Q: int, H: int, tile: int, P: int, causal: bool,
                chunk: int = CHUNK_KEYS) -> int:
    """Chunks a tile sees: the blocks of chunks c >= this exit at once."""
    return tile_last_key(ctx, Q, H, tile, P, causal) // chunk + 1


def mla_paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                              page_tables: torch.Tensor, ctx_lens: torch.Tensor,
                              qmask: torch.Tensor, scale: float, v_dim: int,
                              page_range: Optional[Tuple[int, int]] = None,
                              return_lse: bool = False):
    """Gather-then-attend over one layer's latent pages [n_pages, ps, Dk],
    V = each K row's first ``v_dim`` lanes. Returns [B, Q, H, v_dim]; with
    ``return_lse`` also the rows' log-sum-exp [B, Q, H] fp32 (``page_range``
    as in ``paged_attention_ref``)."""
    return paged_attention_ref(q, k_pages, k_pages[..., :v_dim], page_tables, ctx_lens,
                               qmask, scale, v_dim=v_dim, page_range=page_range,
                               return_lse=return_lse)


def _launch(q, k_pages, page_tables, ctx_lens, qmask, scale, v_dim, causal,
            chunk: int = CHUNK_KEYS, walk: Optional[bool] = None,
            page_range: Optional[Tuple[int, int]] = None, return_lse: bool = False):
    B, Q, H, Dk = q.shape
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16:
        raise TypeError(f"mla_paged_attention takes bf16 q and pages, not "
                        f"{q.dtype}/{k_pages.dtype}")
    if k_pages.dim() != 3 or k_pages.shape[2] != Dk:
        raise ValueError(f"pages {tuple(k_pages.shape)} are not one layer's "
                         f"[n_pages, ps, {Dk}]")
    n_pages, ps = k_pages.shape[:2]
    mla_check(H, Dk, v_dim, ps)
    if not k_pages.is_contiguous() or k_pages.data_ptr() % 16:
        raise ValueError("the page view must be contiguous, on a 16-byte boundary")
    dev = q.device
    for t in (k_pages, page_tables, ctx_lens):
        if t.device != dev:
            raise ValueError("mla_paged_attention operands must be on one device")
    if page_tables.dim() != 2 or page_tables.shape[0] != B or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"page_tables {tuple(page_tables.shape)} and ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not hold {B} requests")
    if not causal and Q > 1 and (qmask is None or tuple(qmask.shape) != (B, Q, Q)):
        raise ValueError(f"a {Q}-wide step needs qmask [B, Q, Q] = {(B, Q, Q)}")
    P = page_tables.shape[1]
    plan = mla_plan(B, Q, H, P, causal, chunk, walk)
    q = q.contiguous()
    pt = page_tables.to(torch.int32).contiguous()
    cl = ctx_lens.to(torch.int32).contiguous()
    qm = None if causal or Q == 1 else qmask.to(torch.uint8).contiguous()
    out = torch.empty((B, Q, H, v_dim), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Q, H), dtype=torch.float32, device=dev) if return_lse else None
    lo, hi = _ALL_PAGES if page_range is None else (int(page_range[0]), int(page_range[1]))
    if page_range is not None and not 0 <= lo <= hi:
        raise ValueError(f"page_range {page_range} is not 0 <= lo <= hi")
    ws_o = ws_ml = scratch = None
    if plan.workspace_floats:
        n_ml = B * plan.n_tiles * plan.n_chunks * TILE_ROWS * 2
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
        ws_o, ws_ml = ws[n_ml:], ws[:n_ml]
    if plan.scratch_floats:
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev)
    lib, fn = _build.function("mla_attention", "mla_attention", _ARGS)
    err = fn(q.data_ptr(), k_pages.data_ptr(), pt.data_ptr(), cl.data_ptr(), _build.ptr(qm),
             out.data_ptr(), _build.ptr(ws_o), _build.ptr(ws_ml), _build.ptr(scratch),
             _build.ptr(lse), B, Q, H, n_pages, P, chunk, float(scale) * LOG2E, int(causal),
             int(plan.walk), lo, hi, _build.stream_of(q))
    _build.check(lib, err, "mla_attention")
    mla_paged_attention.launches += 1
    kind = "decode" if Q == 1 else ("prefill" if causal else "verify")
    mla_paged_attention.modes[kind] += 1
    if page_range is not None:
        mla_paged_attention.modes[kind + ",range"] += 1
    return (out, lse) if return_lse else out


def mla_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                        page_tables: torch.Tensor, ctx_lens: torch.Tensor,
                        qmask: Optional[torch.Tensor], scale: float, v_dim: int,
                        causal: bool = False, page_range: Optional[Tuple[int, int]] = None,
                        return_lse: bool = False):
    """Latent MQA: q [B, Q, H, Dk] (absorbed q_nope | roped q_pe) over one
    layer's pages [n_pages, ps, Dk], whose in-step rows must already be
    written at ctx..ctx+Q-1. ``qmask`` [B, Q, Q] is the in-step visibility;
    ``causal`` takes the causal rule instead (prefill; qmask may be None).
    ``page_range`` (lo, hi) keeps only the keys whose page id lies in [lo,
    hi). Returns [B, Q, H, v_dim]; with ``return_lse`` also the rows'
    log-sum-exp [B, Q, H] fp32 (-inf, with an output of 0, for a row that
    sees no key)."""
    if q.is_cuda:
        return _launch(q, k_pages, page_tables, ctx_lens, qmask, scale, v_dim, causal,
                       page_range=page_range, return_lse=return_lse)
    if q.device.type != "cpu":
        raise NotImplementedError(f"mla_paged_attention on {q.device}")
    if causal:
        B, Q = q.shape[:2]
        qmask = causal_qmask(Q, q.device)[None].expand(B, Q, Q)
    return mla_paged_attention_plain(q, k_pages, page_tables, ctx_lens, qmask, scale,
                                     v_dim, page_range, return_lse)


mla_paged_attention.launches = 0
mla_paged_attention.modes = collections.Counter()
