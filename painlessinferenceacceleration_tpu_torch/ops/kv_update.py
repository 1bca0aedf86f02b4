"""KV arena kernels: their wrappers and plain versions.

K4 (``csrc/kv_permute.cu``) has two entries over one device body.
``kv_permute_pages`` replaces the Pallas ``_permute_kernel`` /
``kv_permute_pages_pallas`` (``painlessinferenceacceleration_tpu/ops/
kv_update.py``), an in-place tail-window row permute::

    pages[l, page_ids[b, w // ps], w % ps] = win[b, l][src_rel[b, w]]

for every layer l, where ``win`` is the window before the call. The arena
is updated in place (JAX donates it instead). When two window slots name the
same page (the page-table clip near the end of a table), the later slot's
rows are the ones kept. ``kv_compact_tail`` is the verify step's
compaction, the route by which ``compact_kv_tail`` (``engine/cache.py``)
reaches that body: it takes the K and V arenas together, with the step's
page tables, context lengths, accepted path and edge counts as they come,
and each block derives its request's window and moves from them, so the
compaction is one launch and no other kernel (its plain version,
``kv_compact_tail_plain``, builds the window with eager torch ops,
``tail_window``, and permutes each arena with ``kv_permute_pages_plain``).
It takes up to four arenas of one ``[L, n_pages, ps]`` geometry, rows of
any element type whose width is a multiple of 4 bytes: K and V in the
bf16, fp32 and e4m3 arenas, and fp8_tok's two per-token scale arenas
beside them, so a verify step's compaction is one CUDA kernel in every
arena kind. ``permute_plan`` is the launch's column chunk, grid and shared
memory. A CPU tensor takes the plain versions; a CUDA tensor launches the
kernel or raises.

``kv_write_pages`` replaces the Pallas ``_page_write_kernel`` /
``kv_write_pages_pallas``, the whole-page write-back
``pages[:, page_ids[w]] = windows[:, w]`` over all layers, for any element
type; an aliased destination keeps the later window page. It launches
``csrc/kv_page_write.cu`` (bulk asynchronous copies through shared memory)
on a CUDA tensor. It is the JAX contract: no path calls it, since the
compaction of an e4m3 or scale arena (the JAX package's gather and
whole-page write-back) is ``kv_compact_tail``'s in-place permute, which
leaves the same bytes.

K16 (``csrc/kv_rows.cu``) replaces the Pallas ``_write_kernel`` /
``kv_write_rows``, the row scatter that ends ``write_kv_pages`` (every layer
of every forward), with two entries. ``kv_write_step`` is the one every
path takes: it reads the step's own K/V, page tables, start lengths and
valid mask as ``write_kv_pages`` is given them, converts the rows to the
arena's kind (a cast, static e4m3 or per-token e4m3 with its scale rows)
and writes K and V (and the scales) in one launch; its plain version,
``kv_write_step_plain``, is the eager route the CPU takes (``kv_step_rows``,
then ``kv_write_rows_plain``), and ``step_writes`` replays which rows its
kernel writes. ``kv_write_rows`` is the JAX contract, ``pages[layer,
page_idx[i], row_idx[i]] = rows[i]`` for up to four arenas sharing the
indices; no path calls it.

``kv_move_rows`` replaces the Pallas ``_move_kernel`` /
``kv_move_rows_pallas``: ``pages[:, dst] = pages[:, src]`` over all layers,
every source read before any destination is written (the gather-then-set
semantics of the JAX package's ``move_kv_rows``, which the Pallas body's
ordered DMAs only approach), in one launch of ``csrc/kv_rows.cu``;
``move_plan`` is its column slice, grid and shared memory.

``kv_write_rows`` and ``kv_move_rows`` take any element type through byte
views, and when two rows or two moves name one destination the later one is kept (inactive rows and masked
moves all go to the null page 0).

Each wrapper's ``launches`` counts its kernel launches. Every wrapper reaches
its C entry through ``_build.function``, which sets its argument types once;
each builds a ctypes struct of a launch's fixed fields once a shape
(``_STATICS``), so a call converts its pointers only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from painlessinferenceacceleration_tpu_torch import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_WIDE = {torch.int32: 0, torch.int64: 1}  # index tensors K4 reads as they come

# K4's staging: the moving rows' chunks of one unit a block holds in shared
# memory, and the blocks launched over all requests (a block walks several
# units when a request has more). tools/row_kernel_variants.py --variants
# times the alternatives.
STAGE_BYTES = 32 * 1024
GRID_BLOCKS = 528
MAX_ARENAS = 4  # arenas one compaction takes (csrc/kv_permute.cu kMaxArenas)


class PermutePlan(NamedTuple):
    cb: int  # column chunk of a unit, bytes (a multiple of 16)
    units: int  # (arena, layer, chunk) units a request
    grid: tuple  # (blocks a request, requests)
    smem: int  # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=256)
def permute_plan(row_bytes: tuple, L: int, max_moves: int, B: int, P: int = 0) -> PermutePlan:
    """K4's launch for arenas of these row widths (bytes; one to four, each a
    multiple of 4), L layers, at most ``max_moves`` moving rows a request
    and page tables of P columns (0 for ``kv_permute_pages``, which takes
    the window's pages): the widest power-of-two chunk (16 bytes at least,
    no wider than the widest row needs) whose ``max_moves`` staged rows fit
    ``STAGE_BYTES``; one unit per (arena, layer, chunk); ``GRID_BLOCKS``
    blocks in all, shared by the B requests, no more than a request has
    units; shared memory for the two move lists, the page-table row and the
    stage. Raises on other rows, or where 16-byte chunks of ``max_moves``
    rows do not fit."""
    if not 0 < len(row_bytes) <= MAX_ARENAS or any(rb <= 0 or rb % 4 for rb in row_bytes):
        raise ValueError(f"kv_permute: 1-{MAX_ARENAS} arenas with rows of a multiple of 4 "
                         f"bytes, got {row_bytes}")
    n = max(max_moves, 1)
    if 16 * n > STAGE_BYTES:
        raise ValueError(f"kv_permute: {max_moves} moving rows do not fit the "
                         f"{STAGE_BYTES}-byte stage")
    cb = 16
    while cb < max(row_bytes) and 2 * cb * n <= STAGE_BYTES:
        cb *= 2
    units = sum(L * -(-rb // cb) for rb in row_bytes)
    blocks = max(1, min(units, -(-GRID_BLOCKS // B)))
    smem = (2 * max_moves * 4 + 15) // 16 * 16 + (P * 4 + 15) // 16 * 16 + max_moves * cb
    return PermutePlan(cb, units, (blocks, B), smem)


def compaction_moves(page_tables, ctx_lens, path, n_edges, q_width: int, ps: int,
                     active=None) -> list:
    """The rows ``kv_compact_tail``'s kernel moves, in plain Python (steps
    1-3 of ``csrc/kv_permute.cu``; host lists or CPU tensors in): for each
    request, its (source, destination) arena rows (page * ps + row), empty
    where no move moves a row. The window's pages from ctx // ps, clipped
    to the table (the null page for an inactive row); a slot whose page a
    later window slot also names is not written; each source is clamped to
    the window. The test oracle of the kernel's move lists, and the count
    of moved bytes in its bound."""
    pt, ctx, path, ne = (t.tolist() if hasattr(t, "tolist") else t
                         for t in (page_tables, ctx_lens, path, n_edges))
    act = [True] * len(ctx) if active is None else [bool(a) for a in active]
    TPP = window_pages(ps, q_width)
    W = TPP * ps
    out = []
    for b, c in enumerate(ctx):
        n_e = min(max(ne[b], 0), len(path[b]))
        if all(path[b][i] == i + 1 for i in range(n_e)):
            out.append([])  # the block exits before it reads the page table
            continue
        base = c // ps * ps
        ids = [pt[b][min(max(c // ps + t, 0), len(pt[b]) - 1)] if act[b] else 0
               for t in range(TPP)]
        keep = [all(ids[u] != ids[t] for u in range(t + 1, TPP)) for t in range(TPP)]
        moves = []
        for i in range(n_e):
            wd = c + 1 + i - base
            src = min(max(c + path[b][i] - base, 0), W - 1)
            if wd < W and src != wd and keep[wd // ps]:
                moves.append((ids[src // ps] * ps + src % ps, ids[wd // ps] * ps + wd % ps))
        out.append(moves)
    return out


def kv_permute_pages_plain(pages: torch.Tensor, page_ids: torch.Tensor,
                           src_rel: torch.Tensor) -> torch.Tensor:
    """The plain version: the window copied, then each slot's row written
    from its source, a later aliasing slot last. An e4m3 arena is permuted
    through its ``uint8`` view (index ops need not take an fp8 type)."""
    if pages.dtype == FP8:
        kv_permute_pages_plain(_bytes(pages), page_ids, src_rel)
        return pages
    L, _, ps, HD = pages.shape
    B, TPP = page_ids.shape
    ids = page_ids.long()
    win = pages[:, ids].reshape(L, B, TPP * ps, HD)  # a copy: read before write
    bidx = torch.arange(B, device=pages.device)[:, None]
    new = win[:, bidx, src_rel.long()].reshape(L, B, TPP, ps, HD)
    for t in range(TPP):  # in slot order: a later aliasing slot wins
        pages[:, ids[:, t]] = new[:, :, t]
    return pages


class _Static(ctypes.Structure):
    """What a K4 launch fixes for a shape of its operands
    (``KvPermuteStatic`` of ``csrc/kv_permute.cu``, field for field): built
    and checked once a shape, so a call converts its pointers only."""
    _fields_ = [("row_bytes", _LL * MAX_ARENAS), ("idx_stride", _LL), ("src_stride", _LL),
                ("idx_wide", _I), ("src_wide", _I), ("ctx_wide", _I), ("ne_wide", _I),
                ("L", _I), ("B", _I), ("n_pages", _I), ("ps", _I), ("TPP", _I), ("P", _I),
                ("M", _I), ("cb", _I), ("grid_x", _I)]


# operands' shapes, types, strides and devices -> (_Static, its address)
_STATICS = {}


def _arena_rows(pages: torch.Tensor, what: str, unit: int = 16) -> int:
    """Row bytes of a contiguous arena on the card, a multiple of ``unit``."""
    row_bytes = pages.shape[-1] * pages.element_size()
    if pages.dim() != 4 or not pages.is_contiguous() or row_bytes % unit:
        raise ValueError(f"{what} needs contiguous [L, n_pages, ps, row] arenas with "
                         f"{unit}-byte-multiple rows, got {tuple(pages.shape)} {pages.dtype}")
    return row_bytes


def _index(t: torch.Tensor, dev: torch.device, what: str) -> int:
    """K4's element-width flag of an index tensor on ``dev`` whose last axis
    is contiguous."""
    wide = _WIDE.get(t.dtype)
    if wide is None or t.device != dev or (t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1):
        raise ValueError(f"{what}: int32 / int64 indices on {dev} with a contiguous last "
                         f"axis, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return wide


def _aligned(*ptrs: int) -> None:
    if any(p % 4 for p in ptrs):
        raise ValueError("kv_permute: arenas must start on a 4-byte boundary")


def _permute_static(pages, page_ids, src_rel):
    L, n_pages, ps = pages.shape[:3]
    B, TPP = page_ids.shape
    row_bytes = _arena_rows(pages, "kv_permute_pages", 4)
    if src_rel.shape != (B, TPP * ps):
        raise ValueError(f"src_rel {tuple(src_rel.shape)} != {(B, TPP * ps)}")
    dev = pages.device
    plan = permute_plan((row_bytes,), L, TPP * ps, B)
    st = _Static((row_bytes, 0, 0, 0), page_ids.stride(0), src_rel.stride(0),
                 _index(page_ids, dev, "kv_permute_pages page_ids"),
                 _index(src_rel, dev, "kv_permute_pages src_rel"), 0, 0, L, B, n_pages, ps,
                 TPP, 0, TPP * ps, plan.cb, plan.grid[0])
    return st, ctypes.addressof(st)


def _kv_permute_cuda(pages, page_ids, src_rel):
    key = (pages.shape, pages.stride(), pages.dtype, pages.device, page_ids.shape,
           page_ids.stride(), page_ids.dtype, page_ids.device, src_rel.shape, src_rel.stride(),
           src_rel.dtype, src_rel.device)
    st = _STATICS.get(key)
    if st is None:
        st = _STATICS[key] = _permute_static(pages, page_ids, src_rel)
    ptr = pages.data_ptr()
    _aligned(ptr)
    lib, fn = _build.function("kv_permute", "kv_permute_pages", (_P,) * 5)
    err = fn(st[1], ptr, page_ids.data_ptr(), src_rel.data_ptr(),
             _build.stream_of(pages))
    if err:
        _build.check(lib, err, "kv_permute_pages")
    kv_permute_pages.launches += 1
    return pages


def kv_permute_pages(pages: torch.Tensor, page_ids: torch.Tensor,
                     src_rel: torch.Tensor) -> torch.Tensor:
    """Permute each request's window rows in place over all layers.

    pages [L, n_pages, ps, HD]; page_ids [B, TPP] (0 = null page);
    src_rel [B, TPP*ps] source row of each window slot (int32 or int64).
    Returns ``pages``."""
    if pages.is_cuda:
        return _kv_permute_cuda(pages, page_ids, src_rel)
    if pages.device.type != "cpu":
        raise NotImplementedError(f"kv_permute_pages on {pages.device}")
    return kv_permute_pages_plain(pages, page_ids, src_rel)


kv_permute_pages.launches = 0


def window_pages(ps: int, q_width: int) -> int:
    """Pages of a verify window of ``q_width`` slots starting anywhere in a
    page (TPP)."""
    return (q_width + ps - 1) // ps + 1


def tail_window(page_tables: torch.Tensor, ctx_lens: torch.Tensor, path: torch.Tensor,
                n_edges: torch.Tensor, q_width: int, ps: int,
                active: Optional[torch.Tensor] = None):
    """The compaction's window, in eager torch ops (the JAX package's
    ``compact_kv_tail`` preparation): (page_ids [B, TPP], the pages from
    ctx // ps on, clipped to the table, inactive rows on the null page;
    src_of [B, W], each window slot's source slot, node ctx + path[i] at
    slot ctx + 1 + i for i < n_edges; win_base [B], the window's first
    slot)."""
    B, M = path.shape
    P = page_tables.shape[1]
    dev = page_tables.device
    TPP = window_pages(ps, q_width)
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
                        torch.full_like(i, W).expand(B, M)).clamp(max=W)
    src_of.scatter_(1, w_idx, torch.where(mv, ctx[:, None] + path.long(), 0))
    return page_ids, src_of[:, :W], win_base


def kv_compact_tail_plain(arenas, page_tables, ctx_lens, path, n_edges, q_width: int,
                          active=None):
    """The composed route: ``tail_window``, then ``kv_permute_pages_plain``
    on each arena (e4m3 ones through their ``uint8`` views)."""
    arenas = _as_tuple(arenas)
    ps = arenas[0].shape[2]
    page_ids, src_of, win_base = tail_window(page_tables, ctx_lens, path, n_edges, q_width,
                                             ps, active)
    src_rel = (src_of - win_base[:, None]).clamp(0, src_of.shape[1] - 1)
    for pages in arenas:
        kv_permute_pages_plain(pages, page_ids, src_rel)
    return arenas


def compact_static(arenas, page_tables, ctx_lens, path, n_edges, q_width, active=None):
    """``kv_compact_tail``'s fixed fields for these operands, checked: (the
    ctypes struct, its address). Raises on what the kernel does not take:
    other than 1-4 contiguous arenas of one [L, n_pages, ps] on one device
    with rows of a multiple of 4 bytes (any element type); index tensors
    other than int32 / int64 with a contiguous last axis, or whose shapes do
    not fit a path of B rows; ``active`` other than bool [B]; more moving
    rows than the stage holds (``permute_plan``). Builds on any device (the
    CPU tests build it)."""
    k = arenas[0]
    L, n_pages, ps = k.shape[:3]
    B, M = path.shape
    P = page_tables.shape[1]
    dev = k.device
    if not 0 < len(arenas) <= MAX_ARENAS or any(a.shape[:3] != k.shape[:3] or a.device != dev
                                                 for a in arenas):
        raise ValueError(f"kv_compact_tail takes 1-{MAX_ARENAS} arenas of one "
                         "[L, n_pages, ps] on one device")
    rbs = tuple(_arena_rows(a, "kv_compact_tail", 4) for a in arenas)
    if (page_tables.shape[0] != B or ctx_lens.shape != (B,) or n_edges.shape != (B,)
            or (active is not None and (active.shape != (B,) or active.dtype != torch.bool
                                        or active.device != dev or active.stride(0) != 1))):
        raise ValueError(f"kv_compact_tail: page_tables {tuple(page_tables.shape)}, ctx_lens "
                         f"{tuple(ctx_lens.shape)}, n_edges {tuple(n_edges.shape)} and active "
                         f"for a path of {B} rows")
    wides = [_index(t, dev, "kv_compact_tail") for t in (page_tables, path, ctx_lens, n_edges)]
    plan = permute_plan(rbs, L, M, B, P)
    st = _Static(rbs + (0,) * (MAX_ARENAS - len(rbs)), page_tables.stride(0),
                 path.stride(0), *wides, L, B, n_pages, ps, window_pages(ps, q_width), P, M,
                 plan.cb, plan.grid[0])
    return st, ctypes.addressof(st)


_COMPACT_ARGS = (_P,) * 5 + (_I,) + (_P,) * 6


def _kv_compact_cuda(arenas, page_tables, ctx_lens, path, n_edges, q_width, active):
    key = ("compact", tuple(map(_desc, arenas)), _desc(page_tables), _desc(ctx_lens),
           _desc(path), _desc(n_edges), _desc(active), q_width)
    st = _STATICS.get(key)
    if st is None:
        st = _STATICS[key] = compact_static(arenas, page_tables, ctx_lens, path, n_edges,
                                            q_width, active)
    ptrs = [a.data_ptr() for a in arenas]
    _aligned(*ptrs)
    lib, fn = _build.function("kv_permute", "kv_compact_tail", _COMPACT_ARGS)
    err = fn(st[1], *ptrs, *(None,) * (MAX_ARENAS - len(ptrs)), len(ptrs),
             page_tables.data_ptr(), ctx_lens.data_ptr(), path.data_ptr(), n_edges.data_ptr(),
             None if active is None else active.data_ptr(), _build.stream_of(arenas[0]))
    if err:
        _build.check(lib, err, "kv_compact_tail")
    kv_compact_tail.launches += 1
    return arenas


def kv_compact_tail(arenas, page_tables: torch.Tensor, ctx_lens: torch.Tensor,
                    path: torch.Tensor, n_edges: torch.Tensor, q_width: int,
                    active: Optional[torch.Tensor] = None):
    """The verify step's tail compaction of one to four arenas (K, V, and
    fp8_tok's K and V scale arenas), in place over all layers, in one
    launch: node ctx + path[i] moves to slot ctx + 1 + i for i < n_edges,
    in each request's window of ``window_pages`` pages from ctx // ps
    (clipped to its page table; an inactive row's on the null page).
    arenas: [L, n_pages, ps, row] each, any element type, rows of a
    multiple of 4 bytes that may differ in width; page_tables [B, P],
    ctx_lens [B], path [B, M], n_edges [B] int32 / int64; active bool [B]
    or None. Returns the arenas as a tuple."""
    arenas = _as_tuple(arenas)
    if arenas[0].is_cuda:
        return _kv_compact_cuda(arenas, page_tables, ctx_lens, path, n_edges, q_width, active)
    if arenas[0].device.type != "cpu":
        raise NotImplementedError(f"kv_compact_tail on {arenas[0].device}")
    return kv_compact_tail_plain(arenas, page_tables, ctx_lens, path, n_edges, q_width,
                                 active)


kv_compact_tail.launches = 0


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A uint8 view, the element bytes along the last axis (e4m3 and f32
    pages alike; index_put_ need not take an fp8 type)."""
    return t.view(torch.uint8)


def _last_of_each(keys: torch.Tensor) -> torch.Tensor:
    """[N] bool: True where no later entry has the same key (later wins)."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    keep = torch.zeros_like(last)
    keep[order[last]] = True
    return keep


def kv_write_pages_plain(pages: torch.Tensor, windows: torch.Tensor,
                         page_ids: torch.Tensor) -> torch.Tensor:
    ids = page_ids.long()
    keep = _last_of_each(ids)  # the last window page of each destination
    _bytes(pages)[:, ids[keep]] = _bytes(windows)[:, keep]
    return pages


# K6's bulk route: pieces of a page one bulk copy moves, and the persistent
# grid's blocks an SM (csrc/kv_page_write.cu: one warp, a 64 KB ring each)
PAGE_PIECE = 16384
PAGE_BLOCKS_PER_SM = 3


def page_write_plan(page_bytes: int, W: int, L: int, sms: int) -> tuple:
    """(pieces a page, blocks) of K6's bulk route: the page cut into
    ``PAGE_PIECE``-byte pieces (the last may be shorter), and a persistent
    grid of ``PAGE_BLOCKS_PER_SM`` blocks an SM of the card's ``sms``, no
    more than there are pieces."""
    pieces = -(-page_bytes // PAGE_PIECE)
    return pieces, max(1, min(W * L * pieces, PAGE_BLOCKS_PER_SM * sms))


_SMS = {}  # device -> its streaming multiprocessors (asked once)


def _sms(dev: torch.device) -> int:
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


class _PageWriteStatic(ctypes.Structure):
    """What a K6 launch fixes for a shape of its operands
    (``KvPageWriteStatic`` of ``csrc/kv_page_write.cu``, field for field)."""
    _fields_ = [("page_bytes", _LL), ("L", _I), ("W", _I), ("n_pages", _I),
                ("ids_wide", _I), ("pieces", _I), ("grid", _I)]


def _page_write_static(pages, windows, page_ids):
    L, n_pages = pages.shape[:2]
    W = windows.shape[1]
    if windows.dtype != pages.dtype or windows.shape[0] != L \
            or windows.shape[2:] != pages.shape[2:]:
        raise ValueError(f"windows {tuple(windows.shape)} {windows.dtype} do not "
                         f"match pages {tuple(pages.shape)} {pages.dtype}")
    if not pages.is_contiguous():
        raise ValueError("kv_write_pages needs a contiguous arena")
    if page_ids.shape != (W,) or not (page_ids.device == windows.device == pages.device):
        raise ValueError("kv_write_pages: page_ids must be [W] on the arena's device")
    page_bytes = pages[0, 0].numel() * pages.element_size()
    pieces, grid = page_write_plan(page_bytes, W, L, _sms(pages.device))
    st = _PageWriteStatic(page_bytes, L, W, n_pages, _index(page_ids, pages.device,
                                                           "kv_write_pages"), pieces, grid)
    return (st, ctypes.addressof(st)) + _build.function("kv_page_write", "kv_page_write",
                                                        (_P,) * 5)


def _kv_write_pages_cuda(pages, windows, page_ids):
    if page_ids.dtype not in _WIDE or not page_ids.is_contiguous():
        page_ids = page_ids.to(torch.int32).contiguous()
    if not windows.is_contiguous():
        windows = windows.contiguous()
    key = ("pages", _desc(pages), _desc(windows), _desc(page_ids))
    st = _STATICS.get(key)
    if st is None:
        st = _STATICS[key] = _page_write_static(pages, windows, page_ids)
    err = st[3](st[1], pages.data_ptr(), windows.data_ptr(), page_ids.data_ptr(),
                _build.stream_of(pages))
    if err:
        _build.check(st[2], err, "kv_write_pages")
    kv_write_pages.launches += 1
    return pages


def kv_write_pages(pages: torch.Tensor, windows: torch.Tensor,
                   page_ids: torch.Tensor) -> torch.Tensor:
    """Write whole pages in place: pages [L, n_pages, ps, ...] gets
    windows [L, W, ps, ...] at page_ids [W] (int32 / int64; 0 = null page),
    the later window page kept where two name one page. Returns
    ``pages``."""
    if pages.is_cuda:
        return _kv_write_pages_cuda(pages, windows, page_ids)
    if pages.device.type != "cpu":
        raise NotImplementedError(f"kv_write_pages on {pages.device}")
    return kv_write_pages_plain(pages, windows, page_ids)


kv_write_pages.launches = 0


def _as_tuple(t):
    return tuple(t) if isinstance(t, (tuple, list)) else (t,)


def kv_write_rows_plain(pages, rows, page_idx: torch.Tensor, row_idx: torch.Tensor,
                        layer: int):
    ps = _as_tuple(pages)[0].shape[2]
    keep = _last_of_each(page_idx.long() * ps + row_idx.long())
    p, r = page_idx.long()[keep], row_idx.long()[keep]
    for pg, rw in zip(_as_tuple(pages), _as_tuple(rows)):
        _bytes(pg)[layer, p, r] = _bytes(rw)[keep]
    return pages


def _desc(t):
    """A tensor's part of a ``_STATICS`` key."""
    return None if t is None else (t.shape, t.stride(), t.dtype, t.device)


class _RowsStatic(ctypes.Structure):
    """What a ``kv_write_rows`` launch fixes for a shape of its operands
    (``KvRowsStatic`` of ``csrc/kv_rows.cu``, field for field)."""
    _fields_ = [("row_bytes", _LL * 4), ("rows_stride", _LL * 4), ("n_arenas", _I),
                ("pi_wide", _I), ("ri_wide", _I), ("N", _I), ("L", _I), ("n_pages", _I),
                ("ps", _I)]


def _rows_static(arenas, news, page_idx, row_idx):
    if not 0 < len(arenas) == len(news) <= 4:
        raise ValueError(f"kv_write_rows takes 1-4 arenas with their rows, got "
                         f"{len(arenas)} and {len(news)}")
    L, n_pages, ps = arenas[0].shape[:3]
    N = page_idx.shape[0]
    dev = arenas[0].device
    if page_idx.shape != (N,) or row_idx.shape != (N,):
        raise ValueError(f"kv_write_rows: page_idx {tuple(page_idx.shape)} and row_idx "
                         f"{tuple(row_idx.shape)} must be [N]")
    wides = [_index(t, dev, "kv_write_rows") for t in (page_idx, row_idx)]
    for pg, rw in zip(arenas, news):
        if (pg.dim() != 4 or pg.shape[:3] != (L, n_pages, ps) or not pg.is_contiguous()
                or rw.dtype != pg.dtype or rw.dim() != 2 or rw.shape[0] != N
                or rw.shape[1] != pg.shape[3] or (rw.shape[1] > 1 and rw.stride(1) != 1)
                or not rw.device == pg.device == dev):
            raise ValueError(f"kv_write_rows: rows {tuple(rw.shape)} {rw.dtype} "
                             f"(strides {rw.stride()}) do not fit the contiguous arena "
                             f"{tuple(pg.shape)} {pg.dtype} on {pg.device}")
    pad = [0] * (4 - len(arenas))
    st = _RowsStatic((_LL * 4)(*[rw.shape[1] * rw.element_size() for rw in news], *pad),
                     (_LL * 4)(*[rw.stride(0) * rw.element_size() for rw in news], *pad),
                     len(arenas), *wides, N, L, n_pages, ps)
    return st, ctypes.addressof(st), L


_WRITE_ROWS_ARGS = (_P,) * 11 + (_I, _P)


def _kv_write_rows_cuda(pages, rows, page_idx, row_idx, layer):
    arenas, news = _as_tuple(pages), _as_tuple(rows)
    key = ("rows", tuple(map(_desc, arenas)), tuple(map(_desc, news)), _desc(page_idx),
           _desc(row_idx))
    st = _STATICS.get(key)
    if st is None:
        st = _STATICS[key] = _rows_static(arenas, news, page_idx, row_idx)
    if not 0 <= layer < st[2]:
        raise ValueError(f"kv_write_rows: layer {layer} of {st[2]}")
    pad = (None,) * (4 - len(arenas))
    lib, fn = _build.function("kv_rows", "kv_write_rows", _WRITE_ROWS_ARGS)
    err = fn(st[1], *(a.data_ptr() for a in arenas), *pad, *(r.data_ptr() for r in news),
             *pad, page_idx.data_ptr(), row_idx.data_ptr(), layer,
             _build.stream_of(arenas[0]))
    if err:
        _build.check(lib, err, "kv_write_rows")
    kv_write_rows.launches += 1
    return pages


def kv_write_rows(pages, rows, page_idx: torch.Tensor, row_idx: torch.Tensor,
                  layer: int):
    """Write rows[i] to pages[layer, page_idx[i], row_idx[i]] in place.

    pages [L, n_pages, ps, row] and rows [N, row] of the same type, or
    tuples of up to four such pairs sharing the [N] indices (int32 or int64;
    0 = null page for dropped rows); a later row wins over an earlier one
    with the same destination. The JAX package's contract; ``write_kv_pages``
    takes ``kv_write_step``. Returns ``pages``."""
    first = _as_tuple(pages)[0]
    if first.is_cuda:
        return _kv_write_rows_cuda(pages, rows, page_idx, row_idx, layer)
    if first.device.type != "cpu":
        raise NotImplementedError(f"kv_write_rows on {first.device}")
    return kv_write_rows_plain(pages, rows, page_idx, row_idx, layer)


kv_write_rows.launches = 0

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0  # largest finite e4m3 value
STEP_MAX_HEADS = 256  # kv_write_step's heads (csrc/kv_rows.cu kMaxHeads)
# kv_write_step's conversions (KvStepStatic.mode): a cast to a bf16 or fp32
# arena, static e4m3, per-token e4m3
STEP_MODES = ("bf16", "fp32", "fp8", "fp8_tok")


def kv_step_rows(arenas, new_k: torch.Tensor, new_v: torch.Tensor,
                 page_tables: torch.Tensor, start_lens: torch.Tensor,
                 valid: Optional[torch.Tensor] = None, k_scale=None, v_scale=None):
    """The step's rows and destinations in eager torch ops (the JAX
    package's ``write_kv_pages`` preparation): (rows, page_idx, row_idx)
    for ``kv_write_rows`` on ``arenas`` (K, V, and with four arenas the
    fp8_tok scale arenas). Token q of request b goes to slot
    ``start_lens[b] + q``, its page clamped to the table's last; an invalid
    token to the null page 0. An e4m3 arena gets ``clamp(x / scale[h],
    +-448)`` (static scales) or ``x / s`` with ``s = max(amax |x|, 1e-8) /
    448`` a (token, head), and the scale rows ``s``."""
    k_pages = arenas[0]
    B, Q, H, D = new_k.shape
    ps = k_pages.shape[2]
    P = page_tables.shape[1]
    slots = start_lens.long()[:, None] + torch.arange(Q, device=new_k.device)[None, :]
    page_of = torch.gather(page_tables.long(), 1, (slots // ps).clamp(max=P - 1))
    if valid is not None:
        page_of = torch.where(valid, page_of, torch.zeros_like(page_of))
    fp, fr = page_of.reshape(-1), (slots % ps).reshape(-1)
    Dv = new_v.shape[-1]  # may differ from D (MLA)
    nk = new_k.reshape(B * Q, H, D)
    nv = new_v.reshape(B * Q, H, Dv)
    tok = len(arenas) == 4
    if tok:
        kf, vf = nk.to(torch.float32), nv.to(torch.float32)
        sk = kf.abs().amax(dim=-1).clamp(min=1e-8) / FP8_MAX  # [BQ, H]
        sv = vf.abs().amax(dim=-1).clamp(min=1e-8) / FP8_MAX
        nk, nv = (kf / sk[..., None]).to(FP8), (vf / sv[..., None]).to(FP8)
    elif k_pages.dtype == FP8:
        nk = (nk.to(torch.float32) / k_scale[None, :, None]).clamp(-FP8_MAX, FP8_MAX).to(FP8)
        nv = (nv.to(torch.float32) / v_scale[None, :, None]).clamp(-FP8_MAX, FP8_MAX).to(FP8)
    else:
        nk, nv = nk.to(k_pages.dtype), nv.to(arenas[1].dtype)
    rows = (nk.reshape(B * Q, H * D), nv.reshape(B * Q, H * Dv))
    if tok:
        rows += (sk, sv)
    return rows, fp, fr


def kv_write_step_plain(arenas, new_k, new_v, page_tables, start_lens, valid=None,
                        layer: int = 0, k_scale=None, v_scale=None):
    """The composed route: ``kv_step_rows``, then ``kv_write_rows_plain``."""
    arenas = _as_tuple(arenas)
    rows, fp, fr = kv_step_rows(arenas, new_k, new_v, page_tables, start_lens, valid,
                                k_scale, v_scale)
    kv_write_rows_plain(arenas, rows, fp, fr, layer)
    return arenas


def step_writes(page_tables, start_lens, valid, Q: int, ps: int) -> list:
    """The rows ``kv_write_step``'s kernel writes, in plain Python (host
    lists or CPU tensors in): (b, q, page, row) for each valid token whose
    row no later valid token of its request names. Only past the end of a
    page table (its page index clamped to the last) can a later token, q +
    k ps, name the same row. The test oracle of the kernel's rule, and the
    count of written rows in its bound."""
    pt, start = (t.tolist() if hasattr(t, "tolist") else t for t in (page_tables, start_lens))
    ok = (valid.tolist() if hasattr(valid, "tolist") else valid) if valid is not None else None
    out = []
    for b, s0 in enumerate(start):
        P = len(pt[b])
        for q in range(Q):
            if ok is not None and not ok[b][q]:
                continue
            slot = s0 + q
            if slot // ps >= P - 1 and any(ok is None or ok[b][q2]
                                           for q2 in range(q + ps, Q, ps)):
                continue
            out.append((b, q, pt[b][min(slot // ps, P - 1)], slot % ps))
    return out


class _StepStatic(ctypes.Structure):
    """What a ``kv_write_step`` launch fixes for a shape of its operands
    (``KvStepStatic`` of ``csrc/kv_rows.cu``, field for field): built and
    checked once a shape, so a call converts its pointers only."""
    _fields_ = [("k_stride", _LL * 3), ("v_stride", _LL * 3), ("pt_stride", _LL),
                ("valid_stride", _LL), ("pt_wide", _I), ("start_wide", _I), ("B", _I),
                ("Q", _I), ("H", _I), ("D", _I), ("Dv", _I), ("P", _I), ("ps", _I),
                ("n_pages", _I), ("L", _I), ("in_f32", _I), ("mode", _I)]


def step_static(arenas, new_k, new_v, page_tables, start_lens, valid=None, k_scale=None,
                v_scale=None):
    """``kv_write_step``'s fixed fields for these operands, checked: (the
    ctypes struct, its address, the arenas' layers). Raises on what the
    kernel does not take: arenas that are not contiguous [L, n_pages, ps,
    H * D] (K) and [.., H * Dv] (V) rows on one device, with 16-byte-multiple
    rows; new_k [B, Q, H, D] and new_v [B, Q, H, Dv] of one type, bf16 or
    fp32, whose last axis is not contiguous or whose D or Dv is not a
    multiple of 8; more than 256 heads; an e4m3 arena without its scales
    (static [H] fp32, or the fp8_tok arenas [L, n_pages, ps, H] fp32);
    index tensors other than int32 / int64 with a contiguous last axis;
    ``valid`` other than bool [B, Q] with a contiguous last axis. Builds on
    any device (the CPU tests build it)."""
    arenas = _as_tuple(arenas)
    if len(arenas) not in (2, 4):
        raise ValueError(f"kv_write_step takes (K, V) or (K, V, K scales, V scales) "
                         f"arenas, got {len(arenas)}")
    k, v = arenas[:2]
    dev = k.device
    if new_k.dim() != 4 or new_v.dim() != 4:
        raise ValueError(f"kv_write_step: new_k {tuple(new_k.shape)} and new_v "
                         f"{tuple(new_v.shape)} must be [B, Q, H, D]")
    B, Q, H, D = new_k.shape
    Dv = new_v.shape[-1]
    L, n_pages, ps = k.shape[:3]
    if new_v.shape[:3] != (B, Q, H) or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or k.shape[3] != H * D or v.shape[3] != H * Dv:
        raise ValueError(f"kv_write_step: new_k {tuple(new_k.shape)}, new_v "
                         f"{tuple(new_v.shape)} do not fit arenas {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    for a in (k, v):
        _arena_rows(a, "kv_write_step")
    if new_k.dtype not in (torch.bfloat16, torch.float32) or new_v.dtype != new_k.dtype:
        raise ValueError(f"kv_write_step takes bf16 or fp32 K / V of one type, not "
                         f"{new_k.dtype} / {new_v.dtype}")
    if D % 8 or Dv % 8 or new_k.stride(-1) != 1 or new_v.stride(-1) != 1:
        raise ValueError(f"kv_write_step reads 8-lane groups of contiguous head rows: D "
                         f"{D} and Dv {Dv} multiples of 8, last axes contiguous (strides "
                         f"{new_k.stride()} / {new_v.stride()})")
    if H > STEP_MAX_HEADS:
        raise ValueError(f"kv_write_step takes {STEP_MAX_HEADS} heads at most, not {H}")
    if any(t.device != dev for t in (v, new_k, new_v)):
        raise ValueError("kv_write_step: arenas and rows on one device")
    if k.dtype == FP8:
        if v.dtype != FP8:
            raise ValueError("kv_write_step: K and V arenas of one type")
        if len(arenas) == 4:
            mode = 3
            for t in arenas[2:]:
                if (t.shape != (L, n_pages, ps, H) or t.dtype != torch.float32
                        or not t.is_contiguous() or t.device != dev):
                    raise ValueError(f"kv_write_step: fp8_tok scale arenas must be fp32 "
                                     f"{(L, n_pages, ps, H)} contiguous, got "
                                     f"{tuple(t.shape)} {t.dtype}")
            if k_scale is not None or v_scale is not None:
                raise ValueError("kv_write_step: fp8_tok arenas take no static scales")
        else:
            mode = 2
            for t in (k_scale, v_scale):
                if (t is None or t.shape != (H,) or t.dtype != torch.float32
                        or (H > 1 and t.stride(0) != 1) or t.device != dev):
                    raise ValueError("kv_write_step: a static e4m3 arena needs fp32 [H] "
                                     "k_scale and v_scale on its device")
    else:
        if len(arenas) != 2 or k_scale is not None or v_scale is not None:
            raise ValueError(f"kv_write_step: a {k.dtype} arena takes no scales")
        if k.dtype not in (torch.bfloat16, torch.float32) or v.dtype != k.dtype:
            raise ValueError(f"kv_write_step writes bf16, fp32 or e4m3 arenas, not "
                             f"{k.dtype} / {v.dtype}")
        mode = 0 if k.dtype == torch.bfloat16 else 1
    if page_tables.dim() != 2 or page_tables.shape[0] != B or start_lens.shape != (B,):
        raise ValueError(f"kv_write_step: page_tables {tuple(page_tables.shape)} and "
                         f"start_lens {tuple(start_lens.shape)} for {B} requests")
    wides = [_index(t, dev, "kv_write_step") for t in (page_tables, start_lens)]
    if valid is not None and (valid.shape != (B, Q) or valid.dtype != torch.bool
                              or valid.device != dev or (Q > 1 and valid.stride(1) != 1)):
        raise ValueError(f"kv_write_step: valid must be bool [B, Q] = {(B, Q)} with a "
                         f"contiguous last axis, got {valid.dtype} {tuple(valid.shape)}")
    st = _StepStatic((_LL * 3)(*new_k.stride()[:3]), (_LL * 3)(*new_v.stride()[:3]),
                     page_tables.stride(0), 0 if valid is None else valid.stride(0),
                     *wides, B, Q, H, D, Dv, page_tables.shape[1], ps, n_pages, L,
                     int(new_k.dtype == torch.float32), mode)
    return st, ctypes.addressof(st), L


_WRITE_STEP_ARGS = (_P,) * 12 + (_I, _P)


def _kv_write_step_cuda(arenas, new_k, new_v, page_tables, start_lens, valid, layer,
                        k_scale, v_scale):
    key = ("step", tuple(map(_desc, arenas)), _desc(new_k),
           _desc(new_v), _desc(page_tables), _desc(start_lens), _desc(valid),
           _desc(k_scale), _desc(v_scale))
    st = _STATICS.get(key)
    if st is None:
        st = _STATICS[key] = step_static(arenas, new_k, new_v, page_tables, start_lens,
                                         valid, k_scale, v_scale)
    if not 0 <= layer < st[2]:
        raise ValueError(f"kv_write_step: layer {layer} of {st[2]}")
    tok = len(arenas) == 4
    lib, fn = _build.function("kv_rows", "kv_write_step", _WRITE_STEP_ARGS)
    err = fn(st[1], arenas[0].data_ptr(), arenas[1].data_ptr(), new_k.data_ptr(),
             new_v.data_ptr(), page_tables.data_ptr(), start_lens.data_ptr(),
             None if valid is None else valid.data_ptr(),
             None if k_scale is None else k_scale.data_ptr(),
             None if v_scale is None else v_scale.data_ptr(),
             arenas[2].data_ptr() if tok else None, arenas[3].data_ptr() if tok else None,
             layer, _build.stream_of(new_k))
    if err:
        _build.check(lib, err, "kv_write_step")
    kv_write_step.launches += 1
    return arenas


def kv_write_step(arenas, new_k: torch.Tensor, new_v: torch.Tensor,
                  page_tables: torch.Tensor, start_lens: torch.Tensor,
                  valid: Optional[torch.Tensor] = None, layer: int = 0,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None):
    """Write a step's K/V rows of layer ``layer`` into the arenas in place,
    converted to each arena's kind, in one launch (``csrc/kv_rows.cu``
    ``kv_write_step``) on a CUDA tensor; ``kv_write_step_plain`` on a CPU
    tensor. arenas: (K, V) [L, n_pages, ps, H * D] / [.., H * Dv] (bf16,
    fp32 or e4m3), or (K, V, K scales, V scales) for fp8_tok; new_k [B, Q,
    H, D], new_v [B, Q, H, Dv] as the models pass them (views with a
    contiguous last axis, bf16 or fp32); page_tables [B, P], start_lens [B]
    int32 / int64; valid bool [B, Q] or None; k_scale / v_scale fp32 [H] for
    a static e4m3 arena. On the card an invalid token writes nothing (the
    plain version writes it to the null page 0). Returns the arenas as a
    tuple."""
    arenas = _as_tuple(arenas)
    if arenas[0].is_cuda:
        return _kv_write_step_cuda(arenas, new_k, new_v, page_tables, start_lens, valid,
                                   layer, k_scale, v_scale)
    if arenas[0].device.type != "cpu":
        raise NotImplementedError(f"kv_write_step on {arenas[0].device}")
    return kv_write_step_plain(arenas, new_k, new_v, page_tables, start_lens, valid, layer,
                               k_scale, v_scale)


kv_write_step.launches = 0

MAX_MOVES = 1024  # K17's moves per launch (csrc/kv_rows.cu kMaxMoves)


def kv_move_rows_plain(pages: torch.Tensor, src_page: torch.Tensor,
                       src_row: torch.Tensor, dst_page: torch.Tensor,
                       dst_row: torch.Tensor) -> torch.Tensor:
    ps = pages.shape[2]
    raw = _bytes(pages)
    got = raw[:, src_page.long(), src_row.long()]  # a copy: every read first
    keep = _last_of_each(dst_page.long() * ps + dst_row.long())
    raw[:, dst_page.long()[keep], dst_row.long()[keep]] = got[:, keep]
    return pages


# K17's plan: one stage's N slices stay within MOVE_STAGE_BYTES, and the
# rows' (slice, layer) units number MOVE_MIN_UNITS or more where they can;
# 16-byte rows go through a ring of MOVE_STAGES stages on a persistent grid
# of at most MOVE_BLOCKS_PER_SM blocks an SM (tools/row_kernel_variants.py
# --variants k17 times the alternatives)
MOVE_STAGE_BYTES = 32 * 1024
MOVE_MIN_UNITS = 264
MOVE_STAGES = 2
MOVE_BLOCKS_PER_SM = 8  # 256 threads a block
SM_SMEM = 233472  # shared memory of an H100 SM, of which a block reserves 1 KB


class MovePlan(NamedTuple):
    slice: int  # column slice of a unit, bytes (a power of two, a multiple of unit)
    grid_x: int  # slices a row
    table: int  # slots of the block's later-destination table
    stages: int  # the ring's stages (16-byte rows), else 1
    blocks: int  # blocks of the launch
    smem: int  # dynamic shared memory a block, bytes


def move_smem(N: int, table: int, slice_: int, stages: int = 1) -> int:
    """A K17 block's shared memory (``move_smem_bytes`` of
    ``csrc/kv_rows.cu``): the 2N row numbers (to 16 bytes), the table's
    keys and move indices, the stages of N slices."""
    return (N * 8 + 15) // 16 * 16 + table * 8 + stages * N * slice_


@functools.lru_cache(maxsize=256)
def move_plan(N: int, row_bytes: int, L: int, unit: int, limit: int, sms: int) -> MovePlan:
    """K17's launch for N moves of rows of ``row_bytes`` (a multiple of
    ``unit``, 16, 4 or 1) over L layers, under a shared-memory limit of
    ``limit`` bytes a block, on a card of ``sms`` SMs: the table has the
    power of two >= 2N slots; the slice is a power of two, a multiple of
    ``unit``, no wider than the row needs, whose block fits ``limit``; of
    those whose N slices fit ``MOVE_STAGE_BYTES`` (or the narrowest, if
    none), the widest that cuts the rows into ``MOVE_MIN_UNITS`` units, else
    the narrowest. 16-byte rows: ``MOVE_STAGES`` stages (fewer if the block
    would not fit), as many blocks as fit an SM (at most
    ``MOVE_BLOCKS_PER_SM``) on every SM, no more than the units; other rows:
    one stage, a block a unit. Raises where N is outside 1-1024 or the row
    is not a multiple of unit, or no block fits."""
    if not 1 <= N <= MAX_MOVES or unit not in (16, 4, 1) or row_bytes <= 0 or row_bytes % unit:
        raise ValueError(f"kv_move_rows: {N} moves (1-{MAX_MOVES}) of {row_bytes}-byte rows "
                         f"in units of {unit}")
    table = 2
    while table < 2 * N:
        table *= 2
    widest = max(1 << (row_bytes - 1).bit_length(), unit)
    fits = [s_ for s_ in (1 << k for k in range(widest.bit_length() - 1, -1, -1))
            if s_ >= unit and move_smem(N, table, s_) <= limit]
    if not fits:
        raise ValueError(f"kv_move_rows: {N} moves of {row_bytes}-byte rows do not fit "
                         f"one block's {limit} bytes of shared memory")
    budget = [s_ for s_ in fits if N * s_ <= MOVE_STAGE_BYTES] or fits[-1:]
    full = [s_ for s_ in budget if L * -(-row_bytes // s_) >= MOVE_MIN_UNITS]
    slice_ = full[0] if full else budget[-1]
    grid_x = -(-row_bytes // slice_)
    units = grid_x * L
    if unit != 16:
        return MovePlan(slice_, grid_x, table, 1, units, move_smem(N, table, slice_))
    stages = MOVE_STAGES
    while stages > 1 and move_smem(N, table, slice_, stages) > limit:
        stages -= 1
    smem = move_smem(N, table, slice_, stages)
    per_sm = max(1, min(MOVE_BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    return MovePlan(slice_, grid_x, table, stages, min(units, per_sm * sms), smem)


class _MoveStatic(ctypes.Structure):
    """What a K17 launch fixes for a shape of its operands (``KvMoveStatic``
    of ``csrc/kv_rows.cu``, field for field)."""
    _fields_ = [("row_bytes", _LL), ("N", _I), ("L", _I), ("n_pages", _I), ("ps", _I),
                ("slice", _I), ("unit", _I), ("grid_x", _I), ("table", _I), ("stages", _I),
                ("blocks", _I), ("smem", _I)]


_SMEM_LIMIT = {}  # device -> the shared memory a block may take (asked once)


def _move_static(pages, idx):
    L, n_pages, ps = pages.shape[:3]
    N = idx[0].shape[0]
    if pages.dim() != 4 or not pages.is_contiguous() or any(
            t.shape != (N,) or t.device != pages.device for t in idx):
        raise ValueError("kv_move_rows needs a contiguous arena and four [N] index "
                         "arrays on its device")
    if N > MAX_MOVES:
        raise ValueError(f"kv_move_rows: {N} moves, more than one launch takes "
                         f"({MAX_MOVES})")
    row_bytes = pages.shape[-1] * pages.element_size()
    unit = next(u for u in (16, 4, 1) if row_bytes % u == 0 and pages.data_ptr() % u == 0)
    limit = _SMEM_LIMIT.get(pages.device)
    if limit is None:
        limit = _SMEM_LIMIT[pages.device] = _build.function(
            "kv_rows", "kv_move_rows_smem_limit", ())[1]()
    plan = move_plan(N, row_bytes, L, unit, limit, _sms(pages.device))
    st = _MoveStatic(row_bytes, N, L, n_pages, ps, plan.slice, unit, plan.grid_x, plan.table,
                     plan.stages, plan.blocks, plan.smem)
    return (st, ctypes.addressof(st)) + _build.function("kv_rows", "kv_move_rows", (_P,) * 7)


def _kv_move_rows_cuda(pages, src_page, src_row, dst_page, dst_row):
    idx = (src_page, src_row, dst_page, dst_row)
    if not all(t.dtype is torch.int32 and t.is_contiguous() for t in idx):
        idx = tuple(t.to(torch.int32).contiguous() for t in idx)
    if idx[0].shape[0] == 0:
        return pages
    key = ("move", _desc(pages), pages.data_ptr() % 16, *map(_desc, idx))
    st = _STATICS.get(key)
    if st is None:
        st = _STATICS[key] = _move_static(pages, idx)
    err = st[3](st[1], pages.data_ptr(), *(t.data_ptr() for t in idx), _build.stream_of(pages))
    if err:
        _build.check(st[2], err, "kv_move_rows")
    kv_move_rows.launches += 1
    return pages


def kv_move_rows(pages: torch.Tensor, src_page: torch.Tensor, src_row: torch.Tensor,
                 dst_page: torch.Tensor, dst_row: torch.Tensor) -> torch.Tensor:
    """pages[:, dst_page[i], dst_row[i]] = pages[:, src_page[i], src_row[i]]
    in place over all layers, every source read before any destination is
    written; a later move wins over an earlier one with the same
    destination. pages [L, n_pages, ps, row]; [N] indices (N <= 1024 on the
    card, read as they come when int32 and contiguous, converted
    otherwise). Returns ``pages``."""
    if pages.is_cuda:
        return _kv_move_rows_cuda(pages, src_page, src_row, dst_page, dst_row)
    if pages.device.type != "cpu":
        raise NotImplementedError(f"kv_move_rows on {pages.device}")
    return kv_move_rows_plain(pages, src_page, src_row, dst_page, dst_row)


kv_move_rows.launches = 0
