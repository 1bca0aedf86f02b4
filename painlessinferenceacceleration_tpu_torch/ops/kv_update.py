"""KV compaction kernels: their wrappers and plain versions.

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


def kv_write_pages_plain(pages: torch.Tensor, windows: torch.Tensor,
                         page_ids: torch.Tensor) -> torch.Tensor:
    ids = page_ids.long()
    W = ids.shape[0]
    w = torch.arange(W, device=ids.device)
    later_same = (ids[None, :] == ids[:, None]) & (w[None, :] > w[:, None])
    keep = ~later_same.any(dim=1)  # the last window page of each destination
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
