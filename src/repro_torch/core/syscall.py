"""AIOS system calls (paper §3.1, Appendix A.1). A copy of
``repro/core/syscall.py``.

Each syscall is thread-bound: the issuing agent thread blocks on
``syscall.event.wait()`` while the scheduler dispatches the call to the
owning module's worker. Categories: llm / memory / storage / tool / access.

Every syscall carries a ``tenant_id`` (paper §3.8): the access manager keys
quotas, privilege groups, and SLO targets by tenant, and the scheduler
enforces them at admission. LLM syscalls may additionally open a streaming
token channel (``stream()``) fed by the serving engine per decode tick.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

_pid_counter = itertools.count(1)

DEFAULT_TENANT = "default"

# sentinel closing a streaming token channel
_STREAM_END = object()

# default bound on a streaming channel: tokens queue ahead of the consumer
# up to this depth, then backpressure escalates to cooperative cancel
DEFAULT_STREAM_BUFFER = 256


class SyscallCancelled(Exception):
    """Raised inside workers when a syscall's cancel flag is observed."""


class Syscall:
    category = "generic"

    def __init__(self, agent_name: str, request_data: Dict[str, Any],
                 priority: int = 0, tenant_id: str = DEFAULT_TENANT):
        self.agent_name = agent_name
        self.request_data = request_data
        self.priority = priority
        self.tenant_id = tenant_id
        self.event = threading.Event()
        self.pid = next(_pid_counter)
        self.status = "created"      # created|queued|running|suspended|done|error
        self.response: Any = None
        self.error: Optional[str] = None
        self.time_limit: Optional[float] = None
        self.created_time = time.monotonic()
        self.queued_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        # scheduling bookkeeping
        self.quanta_used = 0
        self.context_id: Optional[str] = None   # set when suspended
        self.cancelled = False                  # cooperative cancel flag
        self.trace = None                       # SyscallTrace when the kernel
                                                # traces; None = off
        self.on_cancel = None                   # workload-recorder hook: called
                                                # once per accepted cancel()
        self._done_callbacks: List[Callable[["Syscall"], None]] = []
        self._settle_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------------
    def mark_queued(self):
        self.status = "queued"
        self.queued_time = time.monotonic()
        if self.trace is not None:
            self.trace.phase("queue")

    def mark_running(self):
        if self.start_time is None:
            self.start_time = time.monotonic()
        self.status = "running"
        if self.trace is not None:
            self.trace.phase("run", core=getattr(self, "_core_idx", None))

    def suspend(self, context_id: str):
        self.status = "suspended"
        self.context_id = context_id
        self.quanta_used += 1
        if self.trace is not None:
            self.trace.event("suspend", context=context_id,
                             quanta=self.quanta_used)
            self.trace.phase("requeue")

    def add_done_callback(self, fn: Callable[["Syscall"], None]):
        """Run ``fn(self)`` exactly once when the syscall settles (complete or
        fail). Resource release (quota slots, reservations) hangs off this so
        every completion path — normal, shed, retry-exhausted, cancelled —
        releases without each call site remembering to."""
        run_now = False
        with self._settle_lock:
            if self.event.is_set():
                run_now = True
            else:
                self._done_callbacks.append(fn)
        if run_now:
            fn(self)

    def _settle(self):
        with self._settle_lock:
            cbs, self._done_callbacks = self._done_callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:   # noqa: BLE001 -- callbacks never break settling
                pass

    def complete(self, response: Any):
        if self.event.is_set():
            return
        self.response = response
        self.status = "done"
        self.end_time = time.monotonic()
        self._settle()
        self.event.set()

    def fail(self, error: str):
        if self.event.is_set():
            return
        self.error = error
        self.status = "error"
        self.end_time = time.monotonic()
        self._settle()
        self.event.set()

    def cancel(self) -> bool:
        """Request cooperative cancellation. The scheduler observes the flag
        at every queue hop and decode tick, frees the slot/context, and fails
        the syscall with "cancelled". Returns False if already settled."""
        if self.event.is_set():
            return False
        self.cancelled = True
        if self.trace is not None:
            self.trace.event("cancel_requested")
        if self.on_cancel is not None:
            try:
                self.on_cancel(self)
            except Exception:  # noqa: BLE001 -- recording never blocks cancel
                pass
        return True

    def join(self, timeout: Optional[float] = None) -> Any:
        """Block the issuing agent thread until the kernel responds. A timed
        out join cancels the syscall so it stops holding slots/pages."""
        if not self.event.wait(timeout):
            self.cancel()
            raise TimeoutError(
                f"syscall pid={self.pid} timed out (cancellation requested)")
        if self.status == "error":
            raise RuntimeError(f"syscall pid={self.pid} failed: {self.error}")
        return self.response

    # -- metrics ------------------------------------------------------------------
    @property
    def waiting_time(self) -> float:
        """Queue-entry to completion (the paper's agent waiting time basis)."""
        if self.end_time is None or self.queued_time is None:
            return 0.0
        return self.end_time - self.queued_time

    @property
    def turnaround(self) -> float:
        if self.end_time is None:
            return 0.0
        return self.end_time - self.created_time

    def __repr__(self):
        return (f"<{type(self).__name__} pid={self.pid} agent={self.agent_name} "
                f"tenant={self.tenant_id} status={self.status}>")


class LLMSyscall(Syscall):
    """request_data: {prompt: list[int] | str, max_new_tokens, temperature,
    eos_id, tools?, action_type?, stream?, stream_buffer?}

    With ``stream=True`` the engine pushes each decoded token into a channel
    the issuing thread drains via ``stream()`` while the syscall is still
    running; the final token sequence is bit-equal to the blocking
    ``join()["tokens"]`` because both read the same per-tick emissions.

    The channel is BOUNDED (``stream_buffer`` tokens, default
    ``DEFAULT_STREAM_BUFFER``): a consumer that stops draining -- crashed,
    disconnected, or garbage-collected mid-iteration -- cannot grow the
    queue without limit while the engine decodes to an audience of zero.
    Overflow (and generator abandonment, via ``stream()``'s finally block)
    escalates to cooperative ``cancel()``, so the scheduler frees the slot,
    KV pages and tenant quota charge on its next tick."""
    category = "llm"

    def __init__(self, agent_name: str, request_data: Dict[str, Any],
                 priority: int = 0, tenant_id: str = DEFAULT_TENANT):
        super().__init__(agent_name, request_data, priority, tenant_id)
        self._stream_q: Optional[queue.Queue] = None
        self.first_token_time: Optional[float] = None
        self.stream_overflows = 0
        if request_data.get("stream"):
            cap = int(request_data.get("stream_buffer",
                                       DEFAULT_STREAM_BUFFER))
            self._stream_q = queue.Queue(maxsize=max(1, cap))
            self.add_done_callback(lambda _sc: self._push_end())

    def token_sink(self) -> Optional[Callable[[int], None]]:
        """Engine-facing per-token callback, or None for blocking calls."""
        return self.push_token if self._stream_q is not None else None

    def push_token(self, token: int):
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
            if self.trace is not None:     # once per stream, not per token
                self.trace.event("first_token")
        if self._stream_q is None:
            return
        try:
            self._stream_q.put_nowait(token)
        except queue.Full:
            # the consumer is gone or stalled past the buffer: stop the
            # producer instead of decoding into the void. Never blocks the
            # engine tick.
            self.stream_overflows += 1
            self.cancel()

    def _push_end(self):
        """Settle marker: END must always land even when the channel is
        full (the consumer re-reads the final status; queued-but-undrained
        tokens of a settled syscall are droppable)."""
        while True:
            try:
                self._stream_q.put_nowait(_STREAM_END)
                return
            except queue.Full:
                try:
                    self._stream_q.get_nowait()
                except queue.Empty:
                    pass

    def stream(self, timeout: Optional[float] = 600.0) -> Iterator[int]:
        """Yield tokens as the engine decodes them; returns when the syscall
        settles. Raises if it failed. Requires ``stream=True`` at submit.
        Abandoning the iterator (break / exception / GC) before the END
        marker cancels the syscall -- the slot, pages and quota charge are
        released instead of riding a stream nobody reads."""
        if self._stream_q is None:
            raise RuntimeError(
                f"syscall pid={self.pid} was not submitted with stream=True")
        finished = False
        try:
            while True:
                item = self._stream_q.get(timeout=timeout)
                if item is _STREAM_END:
                    finished = True
                    if self.status == "error":
                        raise RuntimeError(
                            f"syscall pid={self.pid} failed: {self.error}")
                    return
                yield item
        finally:
            if not finished:
                self.cancel()


class MemorySyscall(Syscall):
    """request_data: {operation: add|get|update|remove|retrieve, params,
    target_agent?, target_tenant?}"""
    category = "memory"


class StorageSyscall(Syscall):
    """request_data: {operation: sto_* , params, target_agent?,
    target_tenant?}"""
    category = "storage"


class ToolSyscall(Syscall):
    """request_data: {tool_name, params}"""
    category = "tool"


class AccessSyscall(Syscall):
    """request_data: {operation: add_privilege|check_access|ask_permission|
    get_audit_log, params}. Not dispatched by the scheduler (paper Fig. 3):
    executed inline."""
    category = "access"
