"""Engine observability of the port: the per-tick ``TickProfiler``. The
kernel-wide tracer and metrics registry are still to be ported (ROADMAP.md
Queue 1, control/obs/replay)."""
from repro_torch.obs.profiler import TickProfiler

__all__ = ["TickProfiler"]
