"""AIOS kernel facade (paper §2/§3) of the port: boots the context manager,
the scheduler and the LLM core pool, and exposes the syscall submission
surface. The port of ``repro/core/kernel.py`` for LLM syscalls.

Not ported yet (ROADMAP.md Queue 1), and refused rather than imitated: the
paged KV hierarchy (``paged_kv``), the control plane (``control``), tracing
(``trace``) and workload recording (``record``); the memory, storage, tool
and access managers (their syscalls fail with an error naming the missing
manager).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.context import ContextManager
from repro_torch.core.llm_core import LLMCore, LLMCorePool
from repro_torch.core.scheduler import (BaseScheduler, BatchedScheduler,
                                        FIFOScheduler, PriorityScheduler,
                                        RRScheduler)
from repro_torch.core.syscall import Syscall
from repro_torch.models import build_model
from repro_torch.obs import TickProfiler
from repro_torch.serving.engine import ServingEngine

SCHEDULERS = {"fifo": FIFOScheduler, "rr": RRScheduler,
              "priority": PriorityScheduler, "batched": BatchedScheduler}

_NOT_PORTED = {"paged_kv": "paged KV hierarchy and prefix cache",
               "control": "control/obs/replay (control plane)",
               "trace": "control/obs/replay (tracing)",
               "record": "control/obs/replay (record/replay)"}


def useLLM(cfg, context_manager, core_id: int = 0, **engine_kw) -> LLMCore:
    engine_kw.setdefault("engine_id", core_id)
    return LLMCore(ServingEngine(cfg, **engine_kw), context_manager, core_id)


class AIOSKernel:
    def __init__(self, *,
                 arch="tiny",
                 scheduler: str = "rr",
                 quantum: int = 16,
                 num_cores: int = 1,
                 context_mode: str = "logits",
                 engine_kw: Optional[Dict[str, Any]] = None,
                 context_kw: Optional[Dict[str, Any]] = None,
                 paged_kv: bool = False,
                 control: bool = False,
                 trace: bool = False,
                 record: bool = False,
                 profile: bool = True,
                 shared_params=None,
                 device=None):
        for name, on in (("paged_kv", paged_kv), ("control", control),
                         ("trace", trace), ("record", record)):
            if on:
                raise NotImplementedError(
                    f"AIOSKernel({name}=True) is not ported to repro_torch "
                    f"yet (ROADMAP.md Queue 1: {_NOT_PORTED[name]})")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {sorted(SCHEDULERS)}")
        self.device = resolve_device(device)
        self.context = ContextManager(mode=context_mode, **(context_kw or {}))
        cfg = get_config(arch) if isinstance(arch, str) else arch
        ekw = dict(engine_kw or {})
        ekw["device"] = self.device
        if shared_params is None:
            # the cores are replicas of one model: draw its weights once
            shared_params = build_model(cfg).init_params(
                ekw.get("rng_seed", 0), self.device)
        ekw["params"] = shared_params
        cores = [useLLM(cfg, self.context, core_id=i, **ekw)
                 for i in range(num_cores)]
        if profile:
            for c in cores:
                c.engine.profiler = TickProfiler()
        self.pool = LLMCorePool(cores)
        skw: Dict[str, Any] = {}
        if scheduler in ("rr", "batched"):
            skw["quantum"] = quantum
        self.scheduler: BaseScheduler = SCHEDULERS[scheduler](self.pool, **skw)
        self._started = False

    # -- lifecycle ----------------------------------------------------------------
    def start(self):
        if not self._started:
            self.scheduler.start()
            self._started = True
        return self

    def stop(self):
        if self._started:
            self.scheduler.stop()
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- syscall surface -------------------------------------------------------------
    def submit(self, sc: Syscall) -> Syscall:
        """Dispatch a syscall through the scheduler (a syscall the port has
        no manager for fails there, at once, naming it)."""
        if not self._started:
            raise RuntimeError("kernel not started")
        self.scheduler.submit(sc)
        return sc

    def send_request(self, agent_name: str, query,
                     tenant_id: str = "default") -> Dict[str, Any]:
        """SDK transport: Query -> syscall -> dispatch -> blocking response."""
        sc = query.to_syscall(agent_name, tenant_id=tenant_id)
        self.submit(sc)
        return sc.join()

    # -- metrics ------------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.scheduler.metrics())
        out["context"] = dict(self.context.stats)
        out["engine"] = [dict(c.engine.stats) for c in self.pool.cores]
        out["profiler"] = self.profiler_summary()
        return out

    def profiler_summary(self) -> List[Dict[str, Any]]:
        return [c.engine.profiler.summary()
                if c.engine.profiler is not None else {}
                for c in self.pool.cores]
