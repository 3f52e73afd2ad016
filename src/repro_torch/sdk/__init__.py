from repro_torch.sdk.query import (  # noqa: F401
    LLMQuery, MemoryQuery, StorageQuery, ToolQuery, AccessQuery,
    LLMResponse, MemoryResponse, StorageResponse, ToolResponse)
