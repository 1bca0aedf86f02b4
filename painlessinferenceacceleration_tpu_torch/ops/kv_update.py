"""In-place tail-window KV permute: the CUDA kernel's wrapper and plain version.

Replaces the Pallas ``_permute_kernel`` / ``kv_permute_pages_pallas``
(``painlessinferenceacceleration_tpu/ops/kv_update.py``)::

    pages[l, page_ids[b, w // ps], w % ps] = win[b, l][src_rel[b, w]]

for every layer l, where ``win`` is the window before the call. The arena
is updated in place (JAX donates it instead). When two window slots name the
same page (the page-table clip near the end of a table), the later slot's
rows are the ones kept. A CPU tensor takes the plain version; a CUDA tensor
launches ``csrc/kv_permute.cu`` or raises. ``kv_permute_pages.launches``
counts kernel launches.
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
