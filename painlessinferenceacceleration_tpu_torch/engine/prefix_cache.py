"""Page-granular shared-prefix KV cache (content-addressed, copy-free).

Port (a copy) of ``painlessinferenceacceleration_tpu/engine/prefix_cache.py``.
Requests whose prompts share a prefix share that prefix's full KV pages:
a request's page table simply points at another request's immutable,
fully written prompt pages, so no copy is made. Page i's key is
``sha1(key_{i-1} | tokens of page i)``, so a hit means the whole chain of
preceding tokens matches. Eviction is LRU over entries; the cache holds one
reference per cached page.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Sequence, Tuple

from painlessinferenceacceleration_tpu_torch.engine.pages import PageAllocator


def _chain_key(prev: bytes, block: Sequence[int]) -> bytes:
    h = hashlib.sha1(prev)
    h.update(b"|")
    h.update(" ".join(map(str, block)).encode())
    return h.digest()


class PrefixCache:
    def __init__(self, allocator: PageAllocator, page_size: int):
        self.alloc = allocator
        self.ps = page_size
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # key -> page

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page chain covering a prefix of ``tokens``:
        (pages, n_matched_tokens). At least one token is left to prefill,
        which gives the next-token logits."""
        ps = self.ps
        limit = (len(tokens) - 1) // ps
        pages: List[int] = []
        key = b"root"
        for i in range(limit):
            key = _chain_key(key, tokens[i * ps: (i + 1) * ps])
            page = self._entries.get(key)
            if page is None:
                break
            self._entries.move_to_end(key)  # LRU touch
            pages.append(page)
        return pages, len(pages) * ps

    def retain_matched(self, pages: List[int]) -> None:
        self.alloc.retain(pages)

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Insert the full pages of a freshly prefilled sequence (each new
        entry takes one reference). Returns the number of pages added."""
        ps = self.ps
        added = 0
        key = b"root"
        for i in range(len(tokens) // ps):
            key = _chain_key(key, tokens[i * ps: (i + 1) * ps])
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            if i >= len(pages):
                break
            self._entries[key] = pages[i]
            self.alloc.retain([pages[i]])
            added += 1
        return added

    def evict(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` LRU entries, releasing the cache's
        reference on each. Returns the number of entries dropped."""
        dropped = 0
        while dropped < n_pages and self._entries:
            _, page = self._entries.popitem(last=False)
            self.alloc.free([page])
            dropped += 1
        return dropped
