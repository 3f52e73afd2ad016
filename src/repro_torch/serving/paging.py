"""Page-quantized HBM accounting for admission control.

Device caches are slot-contiguous; *accounting* is paged (a copy of
``repro/serving/paging.py``). Admission of a syscall
reserves ceil(ctx_len / page_size) pages against the device budget -- replacing
the paper's GPU trial-and-error loading with an explicit reservation that can
never OOM. Preemption releases a sequence's pages (its state moves to the host
pool managed by the memory manager).
"""
from __future__ import annotations

import threading
from typing import Dict


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int, bytes_per_token: int = 0):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self.bytes_per_token = bytes_per_token
        self._free = num_pages
        self._held: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.peak_used = 0
        self.failed_reservations = 0

    # -- queries ---------------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return max(1, -(-tokens // self.page_size))

    @property
    def free_pages(self) -> int:
        return self._free

    @property
    def used_pages(self) -> int:
        return self.num_pages - self._free

    def utilization(self) -> float:
        return self.used_pages / self.num_pages

    def used_bytes(self) -> int:
        """Byte view of the reservation state -- the pool telemetry gauge
        behind the rebalancer's cost model. ``bytes_per_token`` is set by
        the owning ServingEngine once its cache leaf dtypes are known
        (zero until then, and for pagers that track counts only)."""
        return self.used_pages * self.page_size * self.bytes_per_token

    # -- reserve / grow / release -----------------------------------------------
    def can_admit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self._free

    def reserve(self, owner: str, tokens: int) -> bool:
        need = self.pages_for(tokens)
        with self._lock:
            if need > self._free:
                self.failed_reservations += 1
                return False
            self._free -= need
            self._held[owner] = self._held.get(owner, 0) + need
            self.peak_used = max(self.peak_used, self.used_pages)
            return True

    def grow(self, owner: str, new_tokens: int) -> bool:
        """Ensure owner holds enough pages for new_tokens total tokens."""
        need = self.pages_for(new_tokens)
        with self._lock:
            have = self._held.get(owner, 0)
            if need <= have:
                return True
            extra = need - have
            if extra > self._free:
                self.failed_reservations += 1
                return False
            self._free -= extra
            self._held[owner] = need
            self.peak_used = max(self.peak_used, self.used_pages)
            return True

    def release(self, owner: str) -> int:
        with self._lock:
            pages = self._held.pop(owner, 0)
            self._free += pages
            return pages

    def held(self, owner: str) -> int:
        return self._held.get(owner, 0)
