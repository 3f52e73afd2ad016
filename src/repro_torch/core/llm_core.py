"""LLM core abstraction (paper §3.2, Appendix A.2): each core wraps one model
replica (a ServingEngine) behind a unified syscall interface; the pool
routes syscalls across cores. The port of ``repro/core/llm_core.py``
(without the prefix-cache harvest and the unmanaged-load baseline).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.syscall import LLMSyscall, SyscallCancelled
from repro_torch.serving.engine import ServingEngine


class LLMCore:
    """One LLM instance. execute_llm_syscall implements the paper's
    generate_response_with_interruption: run at most `quantum` decode steps,
    snapshot + suspend if unfinished."""

    def __init__(self, engine: ServingEngine, context_manager, core_id: int = 0):
        self.engine = engine
        self.ctx = context_manager
        self.core_id = core_id
        self._lock = threading.Lock()   # exclusive-mode serialization
        self.busy_time = 0.0
        self.executed = 0

    def free_capacity(self) -> Tuple[int, int]:
        """(free decode slots, free KV pages). Bigger is less loaded."""
        return (self.engine.free_slot_count(), self.engine.pager.free_pages)

    # -- admission ------------------------------------------------------------------
    def admit(self, sc: LLMSyscall, eager: bool = True) -> int:
        """Place a syscall into a decode slot (restore if it was suspended).
        With ``eager=False`` a fresh prompt only joins the engine's
        chunked-prefill queue."""
        rd = sc.request_data
        # streamed syscalls re-wire their token channel on every (re)admit
        sink = sc.token_sink() if isinstance(sc, LLMSyscall) else None
        if sc.context_id is not None:
            snap = self.ctx.load(sc.context_id)
            slot = self.engine.restore(snap, seq_id=sc.pid, eager=eager,
                                       sink=sink)
            self.ctx.clear(sc.context_id)
            sc.context_id = None
        else:
            slot = self.engine.add_sequence(
                np.asarray(rd["prompt"], np.int32), seq_id=sc.pid,
                max_new=rd.get("max_new_tokens", 32),
                eos_id=rd.get("eos_id", -1),
                image_embeds=rd.get("image_embeds"),
                eager=eager, sink=sink)
            sc._prefill_tokens = int(self.engine.slots[slot].prefilled)
        return slot

    def _finish(self, sc: LLMSyscall, slot: int) -> Dict[str, Any]:
        tokens = self.engine.result(slot)
        prompt_tokens = getattr(sc, "_prefill_tokens", None)
        if prompt_tokens is None:
            prompt_tokens = len(self.engine.slots[slot].prompt)
        self.engine.free(slot)
        return {"tokens": tokens, "finished": True,
                "usage": {"new_tokens": len(tokens),
                          "prompt_tokens": int(prompt_tokens)}}

    def _suspend(self, sc: LLMSyscall, slot: int) -> str:
        """Snapshot `slot` into the shared ContextManager."""
        snap = self.engine.snapshot(slot, kind=self.ctx.mode)
        ctx_id = f"ctx-{sc.pid}"
        self.ctx.save(ctx_id, snap)
        return ctx_id

    # -- exclusive (paper-faithful: one prompt at a time) -----------------------------
    def execute_llm_syscall(self, sc: LLMSyscall,
                            quantum: Optional[int] = None
                            ) -> Tuple[bool, Any]:
        t0 = time.monotonic()
        with self._lock:
            slot = self.admit(sc)
            try:
                steps = 0
                while not self.engine.is_done(slot):
                    if sc.cancelled:
                        raise SyscallCancelled(f"pid={sc.pid}")
                    if quantum is not None and steps >= quantum:
                        ctx_id = self._suspend(sc, slot)
                        self.busy_time += time.monotonic() - t0
                        return False, ctx_id
                    self.engine.step()
                    steps += 1
                resp = self._finish(sc, slot)
            except Exception:
                # fault (or cancel) mid-decode: free the slot and its pages
                # (free() is idempotent after a suspend's snapshot)
                try:
                    self.engine.free(slot)
                except Exception:  # noqa: BLE001
                    pass
                self.busy_time += time.monotonic() - t0
                raise
        self.busy_time += time.monotonic() - t0
        self.executed += 1
        return True, resp


class LLMCorePool:
    def __init__(self, cores: List[LLMCore], strategy: str = "round_robin"):
        if not cores:
            raise ValueError("an LLM core pool needs at least one core")
        self.cores = cores
        self.strategy = strategy
        self._rr = itertools.cycle(range(len(cores)))

    @property
    def num_cores(self) -> int:
        return len(self.cores)

    def route(self) -> LLMCore:
        if self.strategy == "sequential":
            return self.cores[0]
        if self.strategy == "least_loaded":
            return max(self.cores, key=lambda c: c.free_capacity())
        return self.cores[next(self._rr)]
