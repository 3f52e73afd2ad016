from repro_torch.serving.engine import ServingEngine, ContextSnapshot  # noqa: F401
from repro_torch.serving.paging import PageAllocator  # noqa: F401
