"""Context manager (paper §3.4, Appendix A.4): snapshot/restore of in-flight
LLM generations, enabling the scheduler's preemptive time slicing. The port
of ``repro/core/context.py`` for the host tier alone.

Modes: "logits" (exact decode-state snapshot -- the slot's live K/V +
pending token) and "text" (decoded-token prefix; restore re-prefills).

Snapshots live in a byte-budgeted host-RAM pool. Spilling to disk (and the
LRU-K victim order that picks what to spill) waits for the storage manager
(ROADMAP.md Queue 1): a save that would exceed the budget raises -- a
context is never dropped.
"""
from __future__ import annotations

import threading
from typing import Dict

from repro_torch.serving.engine import ContextSnapshot


class ContextManager:
    """Host pool of suspended contexts. ``budget_bytes`` defaults to 4 GiB:
    a yi-6b context holds 64 KiB of K/V per token."""

    def __init__(self, *, mode: str = "logits", budget_bytes: int = 4 << 30):
        if mode not in ("logits", "text"):
            raise ValueError(f"context mode must be logits or text, got {mode!r}")
        self.mode = mode
        self.budget = budget_bytes
        self.used = 0
        self._items: Dict[str, ContextSnapshot] = {}
        self._sizes: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.stats = {"saves": 0, "loads": 0}

    def save(self, ctx_id: str, snap: ContextSnapshot):
        nbytes = snap.nbytes()
        with self._lock:
            old = self._sizes.get(ctx_id, 0)
            if self.used - old + nbytes > self.budget:
                raise MemoryError(
                    f"host context pool over budget: {self.used - old} + "
                    f"{nbytes} > {self.budget} bytes (spill to disk is not "
                    f"ported yet; raise budget_bytes)")
            self.used += nbytes - old
            self._items[ctx_id] = snap
            self._sizes[ctx_id] = nbytes
            self.stats["saves"] += 1

    def load(self, ctx_id: str) -> ContextSnapshot:
        with self._lock:
            snap = self._items.get(ctx_id)
            if snap is None:
                raise KeyError(f"context {ctx_id} not found")
            self.stats["loads"] += 1
            return snap

    def clear(self, ctx_id: str):
        with self._lock:
            if self._items.pop(ctx_id, None) is not None:
                self.used -= self._sizes.pop(ctx_id)
