from repro_torch.core.kernel import AIOSKernel  # noqa: F401
from repro_torch.core.syscall import (  # noqa: F401
    AccessSyscall, LLMSyscall, MemorySyscall, StorageSyscall, Syscall,
    ToolSyscall)
