"""AIOS scheduler (paper §3.3, Appendix A.3): the port of
``repro/core/scheduler.py`` for LLM syscalls.

A central LLM queue and worker threads per LLM core; FIFO / Round-Robin
(time-sliced via the context-interrupt mechanism) / priority strategies and
the pool-wide continuous-batching ``BatchedScheduler``. The RR quantum is
measured in decode steps. Memory, storage and tool syscalls need managers
that are not ported yet: they fail at submission with an error naming the
missing manager. The control plane, tenant quotas, tracing and workload
recording are not ported either (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import heapq
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.syscall import Syscall, SyscallCancelled

# syscall category -> the manager it needs (none of them is ported yet)
MISSING_MANAGERS = {"memory": "memory manager", "storage": "storage manager",
                    "tool": "tool manager", "access": "access manager"}


def not_ported_error(sc: Syscall) -> str:
    manager = MISSING_MANAGERS.get(sc.category, f"{sc.category!r} handler")
    return (f"{sc.category} syscalls are not supported by repro_torch yet: "
            f"the {manager} is not ported (ROADMAP.md Queue 1)")


class _PriorityQueue:
    """heapq wrapper with the same interface subset as queue.Queue."""

    def __init__(self):
        self._h: List = []
        self._cv = threading.Condition()
        self._count = 0

    def put(self, item):
        with self._cv:
            self._count += 1
            heapq.heappush(self._h, (-item.priority, self._count, item))
            self._cv.notify()

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._h and not self._cv.wait_for(lambda: bool(self._h),
                                                     timeout):
                raise queue.Empty
            return heapq.heappop(self._h)[2]

    def get_nowait(self):
        return self.get(timeout=0)

    def qsize(self):
        with self._cv:
            return len(self._h)


class BaseScheduler:
    """Owns the LLM queue and the worker threads that drain it. Subclasses
    set the LLM strategy knobs."""

    name = "base"
    llm_quantum: Optional[int] = None   # decode steps per slice; None = to completion

    def __init__(self, llm_core_pool, *,
                 log: Optional[Callable[[str], None]] = None):
        self.pool = llm_core_pool
        self.log = log or (lambda m: None)
        self.llm_queue = self._make_queue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.completed: List[Syscall] = []
        self._completed_lock = threading.Lock()

    def _make_queue(self):
        return queue.Queue()

    # -- submission -----------------------------------------------------------------
    def _front_door_admit(self, sc: Syscall) -> bool:
        """Only LLM syscalls have a handler in the port: anything else fails
        fast with a structured reason instead of waiting on a queue no
        worker drains."""
        if sc.category == "llm":
            return True
        sc.mark_queued()
        sc.fail(not_ported_error(sc))
        self._record(sc)
        return False

    def _enqueue(self, syscall: Syscall):
        syscall.mark_queued()
        self.llm_queue.put(syscall)

    def submit(self, syscall: Syscall):
        if self._front_door_admit(syscall):
            self._enqueue(syscall)

    # -- lifecycle -------------------------------------------------------------------
    def start(self):
        self._stop.clear()
        for i in range(self.pool.num_cores):
            t = threading.Thread(target=self._llm_worker, args=(i,),
                                 name=f"aios-{self.name}-llm{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _record(self, sc: Syscall):
        with self._completed_lock:
            self.completed.append(sc)

    def _finish_cancelled(self, sc: Syscall):
        """Settle a cancelled syscall observed at a queue hop: release its
        suspended context if it holds one, then fail it."""
        if sc.context_id is not None:
            self.pool.cores[0].ctx.clear(sc.context_id)
            sc.context_id = None
        sc.fail("cancelled")
        self._record(sc)

    def _fail_final(self, sc: Syscall, reason: str):
        """Terminal failure: settle the syscall AND release any suspended
        context it still holds."""
        if sc.context_id is not None:
            self.pool.cores[0].ctx.clear(sc.context_id)
            sc.context_id = None
        sc.fail(reason)
        self._record(sc)

    llm_retries = 2   # fault tolerance: failed cores lose at most one quantum

    def _retry_or_fail(self, sc: Syscall, err: Exception, core_idx: int):
        """Core fault: requeue so another core (or a recovered one) picks it
        up; fail only after llm_retries."""
        if isinstance(err, SyscallCancelled) or sc.cancelled:
            self._finish_cancelled(sc)
            return
        retries = getattr(sc, "_retries", 0)
        if retries < self.llm_retries:
            sc._retries = retries + 1
            self.log(f"llm syscall pid={sc.pid} retry {sc._retries} after "
                     f"core{core_idx} fault: {err}")
            self.llm_queue.put(sc)
        else:
            self._fail_final(sc, str(err))

    def _llm_worker(self, core_idx: int):
        core = self.pool.cores[core_idx]
        while not self._stop.is_set():
            try:
                sc = self.llm_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if sc.cancelled:
                self._finish_cancelled(sc)
                continue
            sc.mark_running()
            try:
                finished, resp = core.execute_llm_syscall(
                    sc, quantum=self.llm_quantum)
            except Exception as e:  # noqa: BLE001
                self._retry_or_fail(sc, e, core_idx)
                continue
            if finished:
                sc.complete(resp)
                self._record(sc)
            else:
                # context interrupt: requeue at the tail (RR)
                sc.suspend(resp)          # resp = context id
                self.llm_queue.put(sc)

    # -- metrics -----------------------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        with self._completed_lock:
            done = [s for s in self.completed if s.status == "done"]
        waits = sorted(s.waiting_time for s in done)
        n = len(waits)
        return {
            "completed": n,
            "avg_wait": sum(waits) / n if n else 0.0,
            "p50_wait": waits[int(0.5 * (n - 1))] if n else 0.0,
            "p90_wait": waits[int(0.9 * (n - 1))] if n else 0.0,
        }


class FIFOScheduler(BaseScheduler):
    name = "fifo"
    llm_quantum = None          # run to completion in arrival order


class RRScheduler(BaseScheduler):
    name = "rr"

    def __init__(self, *args, quantum: int = 16, **kw):
        super().__init__(*args, **kw)
        self.llm_quantum = quantum


class PriorityScheduler(BaseScheduler):
    """Priority-ordered LLM queue (preemptive at quantum boundaries when a
    quantum is set)."""
    name = "priority"

    def __init__(self, *args, quantum: Optional[int] = None, **kw):
        super().__init__(*args, **kw)
        self.llm_quantum = quantum

    def _make_queue(self):
        return _PriorityQueue()


class BatchedScheduler(BaseScheduler):
    """Pool-wide token-level continuous batching. A central dispatcher
    thread pops the shared LLM queue and routes syscalls to the least-loaded
    core by real occupancy (free decode slots, then free KV pages), applying
    backpressure when every core is saturated. A burst is routed as a group,
    so the core's engine prefills it through shared chunked-prefill
    dispatches; each core's worker tick is ONE unified engine dispatch
    (``serve_step``) carrying prefill chunk rows and every running slot's
    decode token together.

    A quantum-expired syscall is suspended and requeued on the CENTRAL
    queue, so it resumes on whichever core has capacity; a core fault
    requeues its in-flight syscalls centrally (up to ``llm_retries``)."""
    name = "batched"

    def __init__(self, *args, quantum: Optional[int] = 64, **kw):
        super().__init__(*args, **kw)
        self.llm_quantum = quantum
        self._core_queues: List["queue.Queue"] = []
        self._inflight: List[int] = []        # dispatched-not-finished per core
        self._inflight_lock = threading.Lock()
        self._dispatcher_held = 0             # 1 while the dispatcher holds a
                                              # syscall it cannot yet place

    # -- lifecycle ------------------------------------------------------------------
    def start(self):
        n = self.pool.num_cores
        self._core_queues = [queue.Queue() for _ in range(n)]
        self._inflight = [0] * n
        self._dispatcher_held = 0
        super().start()
        t = threading.Thread(target=self._dispatcher,
                             name=f"aios-{self.name}-dispatch", daemon=True)
        t.start()
        self._threads.append(t)

    # -- central dispatcher -------------------------------------------------------------
    def _required_tokens(self, sc: Syscall) -> int:
        rd = sc.request_data
        return len(rd["prompt"]) + rd.get("max_new_tokens", 32)

    def _pick_core(self, sc: Syscall) -> Optional[int]:
        """Least-loaded core that can hold `sc`: most free decode slots (net
        of syscalls already dispatched there), pages as the tie-break. None
        when the pool is saturated. Cores `sc` already faulted on are
        avoided while a healthy one exists."""
        need = self._required_tokens(sc)
        best, best_key = None, None
        with self._inflight_lock:
            inflight = list(self._inflight)
        avoid = getattr(sc, "_faulted_cores", None)
        candidates = list(range(self.pool.num_cores))
        if avoid:
            healthy = [i for i in candidates if i not in avoid]
            candidates = healthy or candidates
        for idx in candidates:
            engine = self.pool.cores[idx].engine
            free_slots = engine.max_slots - inflight[idx]
            if free_slots <= 0 or not engine.pager.can_admit(need):
                continue
            key = (free_slots, engine.pager.free_pages)
            if best_key is None or key > best_key:
                best, best_key = idx, key
        return best

    def _dispatch(self, core_idx: int, sc: Syscall):
        with self._inflight_lock:
            self._inflight[core_idx] += 1
        sc._core_idx = core_idx
        self._core_queues[core_idx].put(sc)

    def _undispatch(self, core_idx: int, sc: Syscall):
        """Hand a syscall back to the central queue (capacity race or
        quantum expiry): any core may pick it up next."""
        with self._inflight_lock:
            self._inflight[core_idx] -= 1
        self.llm_queue.put(sc)

    def _backlog(self) -> int:
        return self.llm_queue.qsize() + self._dispatcher_held

    def _infeasible_reason(self, sc: Syscall) -> Optional[str]:
        """Non-None when NO core could ever admit `sc`: such a syscall must
        fail fast. The message names the limiting resource."""
        need = self._required_tokens(sc)
        slots_fit = pages_fit = False
        for core in self.pool.cores:
            eng = core.engine
            s_ok = need <= eng.max_len
            p_ok = eng.pager.pages_for(need) <= eng.pager.num_pages
            if s_ok and p_ok:
                return None
            slots_fit |= s_ok
            pages_fit |= p_ok
        if not slots_fit:
            biggest = max(c.engine.max_len for c in self.pool.cores)
            return (f"context {need} tokens exceeds every core's capacity: "
                    f"longest decode slot holds {biggest} tokens "
                    f"(limiting resource: slots)")
        if not pages_fit:
            worst = max((c.engine.pager.num_pages * c.engine.pager.page_size)
                        for c in self.pool.cores)
            return (f"context {need} tokens exceeds every core's capacity: "
                    f"largest KV page budget holds {worst} tokens "
                    f"(limiting resource: pages)")
        return (f"context {need} tokens exceeds every core's capacity "
                f"(limiting resource: slots on some cores, pages on others)")

    def _take(self, sc: Syscall) -> bool:
        """Settle `sc` here if it is cancelled or can never fit; True when
        it is still to be placed."""
        if sc.cancelled:
            self._finish_cancelled(sc)
            return False
        reason = self._infeasible_reason(sc)
        if reason is not None:
            self._fail_final(sc, reason)
            return False
        return True

    def _dispatcher(self):
        pending: Optional[Syscall] = None
        while not self._stop.is_set():
            if pending is None:
                try:
                    pending = self.llm_queue.get(timeout=0.05)
                    self._dispatcher_held = 1
                except queue.Empty:
                    continue
                if not self._take(pending):
                    pending = None
                    self._dispatcher_held = 0
                    continue
                # burst admission: wait one batching window so the rest of
                # a burst lands on the queue, then place it in one cycle
                if pending.context_id is None and self.llm_queue.qsize() == 0:
                    time.sleep(0.001)
            idx = self._pick_core(pending)
            if idx is None:            # pool saturated: hold + backoff
                time.sleep(0.001)
                continue
            self._dispatch(idx, pending)
            pending = None
            self._dispatcher_held = 0
            while True:                # drain the rest of the burst
                try:
                    sc = self.llm_queue.get_nowait()
                except queue.Empty:
                    break
                if not self._take(sc):
                    continue
                idx = self._pick_core(sc)
                if idx is None:
                    pending = sc
                    self._dispatcher_held = 1
                    break
                self._dispatch(idx, sc)
        if pending is not None:        # stop(): don't strand the held syscall
            self.llm_queue.put(pending)
            self._dispatcher_held = 0

    # -- per-core fault path ------------------------------------------------------------
    def _retry_or_fail(self, sc: Syscall, err: Exception, core_idx: int):
        with self._inflight_lock:
            self._inflight[core_idx] -= 1
        faulted = getattr(sc, "_faulted_cores", None) or set()
        faulted.add(core_idx)
        sc._faulted_cores = faulted
        super()._retry_or_fail(sc, err, core_idx)

    def _fault_slot(self, core_idx: int, core, slot: int, sc: Syscall,
                    err: Exception, running: Dict[int, Syscall],
                    used: Dict[int, int]):
        """Settle a slot whose finish/suspend hand-off raised: free the slot
        and requeue the syscall through the retry path (the worker thread
        must survive it)."""
        try:
            core.engine.free(slot)
        except Exception:  # noqa: BLE001
            pass
        self._retry_or_fail(sc, err, core_idx)
        running.pop(slot, None)
        used.pop(slot, None)

    # -- per-core worker (data plane) ----------------------------------------------------
    def _llm_worker(self, core_idx: int):
        """Keeps the decode batch full AND advances prefill with decode in
        ONE engine tick (`serve_step`)."""
        core = self.pool.cores[core_idx]
        engine = core.engine
        myq = self._core_queues[core_idx]
        running: Dict[int, Syscall] = {}      # slot -> syscall
        used: Dict[int, int] = {}             # slot -> decode steps this quantum
        while not self._stop.is_set():
            # admit everything the dispatcher routed here; fresh prompts only
            # JOIN the chunked-prefill queue (eager=False)
            while engine.free_slot_count() > 0:
                busy = bool(running) or engine.prefill_pending() > 0
                try:
                    sc = myq.get(timeout=0.0 if busy else 0.05)
                except queue.Empty:
                    break
                if sc.cancelled:
                    with self._inflight_lock:
                        self._inflight[core_idx] -= 1
                    self._finish_cancelled(sc)
                    continue
                sc.mark_running()
                try:
                    slot = core.admit(sc, eager=False)
                except RuntimeError:
                    # lost the capacity race; hand back for re-dispatch
                    self._undispatch(core_idx, sc)
                    break
                except Exception as e:  # noqa: BLE001
                    self._retry_or_fail(sc, e, core_idx)
                    continue
                running[slot] = sc
                used[slot] = 0
            # cancellation sweep: free the slot + pages now
            for slot, sc in list(running.items()):
                if not sc.cancelled:
                    continue
                try:
                    engine.free(slot)
                except Exception:  # noqa: BLE001
                    pass
                with self._inflight_lock:
                    self._inflight[core_idx] -= 1
                self._finish_cancelled(sc)
                del running[slot], used[slot]
            if not running:
                time.sleep(0.001)
                continue
            try:
                emitted = engine.serve_step()
            except Exception as e:  # noqa: BLE001
                # core fault mid-tick: every in-flight syscall loses at most
                # this quantum; requeue centrally
                for slot, sc in list(running.items()):
                    try:
                        engine.free(slot)
                    except Exception:  # noqa: BLE001
                        pass
                    self._retry_or_fail(sc, e, core_idx)
                running.clear()
                used.clear()
                continue
            for slot in list(running):
                sc = running[slot]
                if slot in emitted:
                    used[slot] += 1
                if engine.is_done(slot):
                    try:
                        resp = core._finish(sc, slot)
                    except Exception as e:  # noqa: BLE001
                        self._fault_slot(core_idx, core, slot, sc, e,
                                         running, used)
                        continue
                    sc.complete(resp)
                    self._record(sc)
                    with self._inflight_lock:
                        self._inflight[core_idx] -= 1
                    del running[slot], used[slot]
                elif self.llm_quantum and used[slot] >= self.llm_quantum and \
                        not engine.is_prefilling(slot) and \
                        (self._backlog() > 0 or myq.qsize() > 0):
                    # quantum expired AND someone is waiting: yield the slot
                    try:
                        ctx_id = core._suspend(sc, slot)
                    except Exception as e:  # noqa: BLE001
                        self._fault_slot(core_idx, core, slot, sc, e,
                                         running, used)
                        continue
                    sc.suspend(ctx_id)
                    self._undispatch(core_idx, sc)
                    del running[slot], used[slot]
        # drain on stop: finish whatever is still running
        for slot, sc in running.items():
            try:
                resp = core._finish(sc, slot)
                sc.complete(resp)
            except Exception as e:  # noqa: BLE001
                sc.fail(str(e))
            self._record(sc)
