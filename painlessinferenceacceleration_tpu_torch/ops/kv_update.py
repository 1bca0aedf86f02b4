"""KV arena kernels: their wrappers and plain versions.

``kv_permute_pages`` replaces the Pallas ``_permute_kernel`` /
``kv_permute_pages_pallas`` (``painlessinferenceacceleration_tpu/ops/
kv_update.py``), an in-place tail-window row permute::

    pages[l, page_ids[b, w // ps], w % ps] = win[b, l][src_rel[b, w]]

for every layer l, where ``win`` is the window before the call. The arena
is updated in place (JAX donates it instead). When two window slots name the
same page (the page-table clip near the end of a table), the later slot's
rows are the ones kept. A CPU tensor takes the plain version; a CUDA tensor
launches ``csrc/kv_permute.cu`` or raises.

``kv_write_pages`` replaces the Pallas ``_page_write_kernel`` /
``kv_write_pages_pallas``, the whole-page write-back
``pages[:, page_ids[w]] = windows[:, w]`` over all layers, for any element
type (e4m3 K/V pages and f32 scale pages); an aliased destination keeps the
later window page. It launches ``csrc/kv_page_write.cu`` on a CUDA tensor.

``kv_write_rows`` replaces the Pallas ``_write_kernel`` / ``kv_write_rows``,
the row scatter ``pages[layer, page_idx[i], row_idx[i]] = rows[i]`` that
ends ``write_kv_pages`` (every layer of every forward). One call writes up
to four arenas that share the indices (K, V and the fp8_tok scale arenas),
in one launch of ``csrc/kv_rows.cu`` on a CUDA tensor.

``kv_move_rows`` replaces the Pallas ``_move_kernel`` /
``kv_move_rows_pallas``: ``pages[:, dst] = pages[:, src]`` over all layers,
every source read before any destination is written (the gather-then-set
semantics of the JAX package's ``move_kv_rows``, which the Pallas body's
ordered DMAs only approach), in one launch of ``csrc/kv_rows.cu``.

Both take any element type through byte views, and when two rows or two
moves name one destination the later one is kept (inactive rows and masked
moves all go to the null page 0).

Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from painlessinferenceacceleration_tpu_torch import _build


def kv_permute_pages_plain(pages: torch.Tensor, page_ids: torch.Tensor,
                           src_rel: torch.Tensor) -> torch.Tensor:
    L, _, ps, HD = pages.shape
    B, TPP = page_ids.shape
    ids = page_ids.long()
    win = pages[:, ids].reshape(L, B, TPP * ps, HD)  # a copy: read before write
    bidx = torch.arange(B, device=pages.device)[:, None]
    new = win[:, bidx, src_rel.long()].reshape(L, B, TPP, ps, HD)
    for t in range(TPP):  # in slot order: a later aliasing slot wins
        pages[:, ids[:, t]] = new[:, :, t]
    return pages


def _kv_permute_cuda(pages, page_ids, src_rel):
    L, n_pages, ps, HD = pages.shape
    B, TPP = page_ids.shape
    row_bytes = HD * pages.element_size()
    if not pages.is_contiguous() or row_bytes % 16:
        raise ValueError("kv_permute_pages needs a contiguous arena with "
                         "16-byte-multiple rows")
    if src_rel.shape != (B, TPP * ps):
        raise ValueError(f"src_rel {tuple(src_rel.shape)} != {(B, TPP * ps)}")
    if TPP * ps * 256 > 227 * 1024:
        raise ValueError(f"window of {TPP * ps} rows exceeds shared memory")
    ids = page_ids.to(torch.int32).contiguous()
    src = src_rel.to(torch.int32).contiguous()
    if not (ids.device == src.device == pages.device):
        raise ValueError("kv_permute_pages operands must be on one device")
    lib = _build.library("kv_permute")
    fn = lib.kv_permute_pages
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(pages.data_ptr(), ids.data_ptr(), src.data_ptr(), L, B, n_pages,
             ps, row_bytes, TPP, _build.stream_of(pages))
    _build.check(lib, err, "kv_permute_pages")
    kv_permute_pages.launches += 1
    return pages


def kv_permute_pages(pages: torch.Tensor, page_ids: torch.Tensor,
                     src_rel: torch.Tensor) -> torch.Tensor:
    """Permute each request's window rows in place over all layers.

    pages [L, n_pages, ps, HD]; page_ids [B, TPP] (0 = null page);
    src_rel [B, TPP*ps] source row of each window slot. Returns ``pages``."""
    if pages.is_cuda:
        return _kv_permute_cuda(pages, page_ids, src_rel)
    if pages.device.type != "cpu":
        raise NotImplementedError(f"kv_permute_pages on {pages.device}")
    return kv_permute_pages_plain(pages, page_ids, src_rel)


kv_permute_pages.launches = 0


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


def _kv_write_pages_cuda(pages, windows, page_ids):
    L, n_pages = pages.shape[:2]
    W = windows.shape[1]
    if windows.dtype != pages.dtype or windows.shape[0] != L \
            or windows.shape[2:] != pages.shape[2:]:
        raise ValueError(f"windows {tuple(windows.shape)} {windows.dtype} do not "
                         f"match pages {tuple(pages.shape)} {pages.dtype}")
    if not pages.is_contiguous():
        raise ValueError("kv_write_pages needs a contiguous arena")
    ids = page_ids.to(torch.int32).contiguous()
    if ids.shape != (W,) or not (ids.device == windows.device == pages.device):
        raise ValueError("kv_write_pages: page_ids must be [W] on the arena's device")
    windows = windows.contiguous()
    page_bytes = pages[0, 0].numel() * pages.element_size()
    lib = _build.library("kv_page_write")
    fn = lib.kv_page_write
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong,
                                                                ctypes.c_void_p]
    err = fn(pages.data_ptr(), windows.data_ptr(), ids.data_ptr(), L, W, n_pages,
             page_bytes, _build.stream_of(pages))
    _build.check(lib, err, "kv_write_pages")
    kv_write_pages.launches += 1
    return pages


def kv_write_pages(pages: torch.Tensor, windows: torch.Tensor,
                   page_ids: torch.Tensor) -> torch.Tensor:
    """Write whole pages in place: pages [L, n_pages, ps, ...] gets
    windows [L, W, ps, ...] at page_ids [W] (0 = null page). Returns
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


def _kv_write_rows_cuda(pages, rows, page_idx, row_idx, layer):
    arenas, news = _as_tuple(pages), _as_tuple(rows)
    if not 0 < len(arenas) == len(news) <= 4:
        raise ValueError(f"kv_write_rows takes 1-4 arenas with their rows, got "
                         f"{len(arenas)} and {len(news)}")
    L, n_pages, ps = arenas[0].shape[:3]
    N = page_idx.shape[0]
    pi = page_idx.to(torch.int32).contiguous()
    ri = row_idx.to(torch.int32).contiguous()
    if ri.shape != (N,) or not 0 <= layer < L:
        raise ValueError(f"kv_write_rows: row_idx {tuple(ri.shape)} for {N} rows, "
                         f"layer {layer} of {L}")
    for pg, rw in zip(arenas, news):
        if (pg.dim() != 4 or pg.shape[:3] != (L, n_pages, ps) or not pg.is_contiguous()
                or rw.dtype != pg.dtype or rw.dim() != 2 or rw.shape[0] != N
                or rw.shape[1] * rw.element_size() != pg[0, 0, 0].numel() * pg.element_size()
                or rw.stride(1) != 1 or not (rw.device == pg.device == pi.device == ri.device)):
            raise ValueError(f"kv_write_rows: rows {tuple(rw.shape)} {rw.dtype} "
                             f"(strides {rw.stride()}) do not fit the contiguous arena "
                             f"{tuple(pg.shape)} {pg.dtype} on {pg.device}")
    n = len(arenas)
    lib = _build.library("kv_rows")
    fn = lib.kv_write_rows
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * n)(*(pg.data_ptr() for pg in arenas))
    srcs = (ctypes.c_void_p * n)(*(rw.data_ptr() for rw in news))
    row_bytes = (ctypes.c_longlong * n)(*(rw.shape[1] * rw.element_size() for rw in news))
    strides = (ctypes.c_longlong * n)(*(rw.stride(0) * rw.element_size() for rw in news))
    err = fn(n, ptrs, srcs, row_bytes, strides, pi.data_ptr(), ri.data_ptr(), N, layer,
             n_pages, ps, _build.stream_of(arenas[0]))
    _build.check(lib, err, "kv_write_rows")
    kv_write_rows.launches += 1
    return pages


def kv_write_rows(pages, rows, page_idx: torch.Tensor, row_idx: torch.Tensor,
                  layer: int):
    """Write rows[i] to pages[layer, page_idx[i], row_idx[i]] in place.

    pages [L, n_pages, ps, row] and rows [N, row] of the same type, or
    tuples of up to four such pairs sharing the int32 [N] indices (0 = null
    page for dropped rows); a later row wins over an earlier one with the
    same destination. Returns ``pages``."""
    first = _as_tuple(pages)[0]
    if first.is_cuda:
        return _kv_write_rows_cuda(pages, rows, page_idx, row_idx, layer)
    if first.device.type != "cpu":
        raise NotImplementedError(f"kv_write_rows on {first.device}")
    return kv_write_rows_plain(pages, rows, page_idx, row_idx, layer)


kv_write_rows.launches = 0

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


def _move_slice(N: int, row_bytes: int, unit: int, limit: int) -> int:
    """The widest column slice (bytes) whose N staged rows fit ``limit``."""
    index_bytes = (N * 8 + 15) // 16 * 16
    for sl in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if sl % unit or (sl > row_bytes and sl // 2 >= max(row_bytes, unit)):
            continue
        if index_bytes + N * sl <= limit:
            return sl
    raise ValueError(f"kv_move_rows: {N} moves of {row_bytes}-byte rows do not fit "
                     f"one block's {limit} bytes of shared memory")


def _kv_move_rows_cuda(pages, src_page, src_row, dst_page, dst_row):
    L, n_pages, ps = pages.shape[:3]
    N = src_page.shape[0]
    idx = [t.to(torch.int32).contiguous() for t in (src_page, src_row, dst_page, dst_row)]
    if not pages.is_contiguous() or any(t.shape != (N,) or t.device != pages.device
                                        for t in idx):
        raise ValueError("kv_move_rows needs a contiguous arena and four [N] index "
                         "arrays on its device")
    if N > MAX_MOVES:
        raise ValueError(f"kv_move_rows: {N} moves, more than one launch takes "
                         f"({MAX_MOVES})")
    row_bytes = pages[0, 0, 0].numel() * pages.element_size()
    unit = next(u for u in (16, 4, 1) if row_bytes % u == 0 and pages.data_ptr() % u == 0)
    lib = _build.library("kv_rows")
    lib.kv_move_rows_smem_limit.restype = ctypes.c_int
    sl = _move_slice(N, row_bytes, unit, lib.kv_move_rows_smem_limit())
    fn = lib.kv_move_rows
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(pages.data_ptr(), *(t.data_ptr() for t in idx), N, L, n_pages, ps, row_bytes,
             sl, unit, _build.stream_of(pages))
    _build.check(lib, err, "kv_move_rows")
    kv_move_rows.launches += 1
    return pages


def kv_move_rows(pages: torch.Tensor, src_page: torch.Tensor, src_row: torch.Tensor,
                 dst_page: torch.Tensor, dst_row: torch.Tensor) -> torch.Tensor:
    """pages[:, dst_page[i], dst_row[i]] = pages[:, src_page[i], src_row[i]]
    in place over all layers, every source read before any destination is
    written; a later move wins over an earlier one with the same
    destination. pages [L, n_pages, ps, row]; int32 [N] indices (N <= 1024
    on the card). Returns ``pages``."""
    if pages.is_cuda:
        return _kv_move_rows_cuda(pages, src_page, src_row, dst_page, dst_row)
    if pages.device.type != "cpu":
        raise NotImplementedError(f"kv_move_rows on {pages.device}")
    return kv_move_rows_plain(pages, src_page, src_row, dst_page, dst_row)


kv_move_rows.launches = 0
