"""Host-side page allocator for the paged KV arena.

Port (a copy) of ``painlessinferenceacceleration_tpu/engine/pages.py``. A
page is free or owned; a request's segment is its list of pages, grown by
appending pages. Page 0 is the reserved null page. ``refs`` counts the
owners of each page, so the prefix cache can share full prompt pages
between requests.
"""

from __future__ import annotations

from typing import List, Optional


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.num_pages = num_pages
        # page 0 reserved (null page); pop() hands out the lowest id first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.refs = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def page_stats(self) -> dict:
        """Free / active / shared page counts and utilization over the
        usable arena (page 0 is the null page)."""
        usable = self.num_pages - 1
        free = len(self._free)
        shared = sum(1 for r in self.refs[1:] if r > 1)
        active = usable - free
        return {
            "total_pages": usable,
            "free": free,
            "active": active,
            "shared": shared,
            "utilization": round(active / usable, 4) if usable else 0.0,
        }

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, n: int) -> Optional[List[int]]:
        """Take n pages, or None if fewer are free (the caller requeues)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def retain(self, pages: List[int]) -> None:
        for p in pages:
            self.refs[p] += 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)

    def ensure_capacity(self, pages: List[int], n_tokens: int) -> bool:
        """Grow ``pages`` in place to cover n_tokens; False if exhausted."""
        need = self.pages_for_tokens(n_tokens) - len(pages)
        if need <= 0:
            return True
        got = self.allocate(need)
        if got is None:
            return False
        pages.extend(got)
        return True
