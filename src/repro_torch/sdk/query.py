"""AIOS SDK query/response structures (paper Appendix B.1) and their mapping
onto kernel syscalls. send_request lives on the kernel; queries know how to
become syscalls. Every ``to_syscall`` accepts the issuing ``tenant_id``
(threaded from kernel.send_request), as in the JAX package; the
tenant-scoped ``AgentSession`` and its quotas are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core.syscall import (DEFAULT_TENANT, AccessSyscall,
                                      LLMSyscall, MemorySyscall,
                                      StorageSyscall, ToolSyscall)


@dataclasses.dataclass
class LLMQuery:
    prompt: List[int]                       # token ids (ToyTokenizer encodes)
    action_type: str = "chat"               # chat | chat_with_json_output | call_tool
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int = -1
    priority: int = 0
    # SLO latency class consumed by the pool control plane:
    # interactive | batch | best_effort. None = derived from priority.
    slo_class: Optional[str] = None
    # stream=True opens the syscall's incremental token channel: iterate
    # LLMSyscall.stream() while it decodes; join() still returns the full
    # (bit-equal) response afterwards. stream_buffer bounds the channel --
    # a consumer lagging past it (or gone) cancels the producer instead of
    # queueing unboundedly (None = DEFAULT_STREAM_BUFFER).
    stream: bool = False
    stream_buffer: Optional[int] = None
    query_class: str = "llm"

    def to_syscall(self, agent_name: str,
                   tenant_id: str = DEFAULT_TENANT) -> LLMSyscall:
        rd = {
            "prompt": self.prompt, "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature, "eos_id": self.eos_id,
            "action_type": self.action_type, "slo_class": self.slo_class,
            "stream": self.stream}
        if self.stream_buffer is not None:
            rd["stream_buffer"] = self.stream_buffer
        return LLMSyscall(agent_name, rd,
                          priority=self.priority, tenant_id=tenant_id)


@dataclasses.dataclass
class MemoryQuery:
    operation_type: str                     # add|get|update|remove|retrieve (_memory)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # cross-agent access (ACL-gated by the scheduler via the access
    # manager's privilege groups; cross-tenant is always denied)
    target_agent: Optional[str] = None
    target_tenant: Optional[str] = None
    query_class: str = "memory"

    def to_syscall(self, agent_name: str,
                   tenant_id: str = DEFAULT_TENANT) -> MemorySyscall:
        rd: Dict[str, Any] = {"operation": self.operation_type,
                              "params": self.params}
        if self.target_agent is not None:
            rd["target_agent"] = self.target_agent
        if self.target_tenant is not None:
            rd["target_tenant"] = self.target_tenant
        return MemorySyscall(agent_name, rd, tenant_id=tenant_id)


@dataclasses.dataclass
class StorageQuery:
    operation_type: str                     # sto_*
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    target_agent: Optional[str] = None
    target_tenant: Optional[str] = None
    query_class: str = "storage"

    def to_syscall(self, agent_name: str,
                   tenant_id: str = DEFAULT_TENANT) -> StorageSyscall:
        rd: Dict[str, Any] = {"operation": self.operation_type,
                              "params": self.params}
        if self.target_agent is not None:
            rd["target_agent"] = self.target_agent
        if self.target_tenant is not None:
            rd["target_tenant"] = self.target_tenant
        return StorageSyscall(agent_name, rd, tenant_id=tenant_id)


@dataclasses.dataclass
class ToolQuery:
    tool_name: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    query_class: str = "tool"

    def to_syscall(self, agent_name: str,
                   tenant_id: str = DEFAULT_TENANT) -> ToolSyscall:
        return ToolSyscall(agent_name, {
            "tool_name": self.tool_name, "params": self.params},
            tenant_id=tenant_id)


@dataclasses.dataclass
class AccessQuery:
    operation_type: str      # add_privilege|revoke_privilege|check_access|
                             # ask_permission|get_audit_log
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    query_class: str = "access"

    def to_syscall(self, agent_name: str,
                   tenant_id: str = DEFAULT_TENANT) -> AccessSyscall:
        return AccessSyscall(agent_name, {
            "operation": self.operation_type, "params": self.params},
            tenant_id=tenant_id)


# -- response wrappers (paper B.1) -- kernels return dicts; these add typing --
@dataclasses.dataclass
class LLMResponse:
    response_message: Optional[str] = None
    tokens: Optional[List[int]] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    finished: bool = False
    error: Optional[str] = None
    status_code: int = 200


@dataclasses.dataclass
class MemoryResponse:
    memory_id: Optional[str] = None
    content: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None
    search_results: Optional[List[Dict[str, Any]]] = None
    success: bool = False
    error: Optional[str] = None


@dataclasses.dataclass
class StorageResponse:
    response_message: Optional[str] = None
    finished: bool = False
    error: Optional[str] = None
    status_code: int = 200


@dataclasses.dataclass
class ToolResponse:
    response_message: Optional[str] = None
    finished: bool = False
    error: Optional[str] = None
    status_code: int = 200
