"""Hand-written CUDA flash attention (prefill): the port of
``repro/kernels/flash_attention.py``. The kernel is
``csrc/flash_attention.cu``; this module checks the inputs, allocates the
output and launches it on the current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0     # kernel launches in this process (ops.reset_launch_counts)


def flash_attention(q, k, v, *, q_offset: int = 0, window: int = 0,
                    q_offsets=None, kv_lens=None):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd] -> [B, Sq, H, hd].

    q_offset: offset shared by the batch; q_offsets: [B] int32 per-sequence
    offsets (override q_offset); kv_lens: [B] int32 valid KV lengths
    (default Skv). Keys at or past kv_lens[b] are masked and dead tiles
    skipped."""
    global launches
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if q_offsets is None:
        q_offsets = torch.full((B,), q_offset, dtype=torch.int32,
                               device=q.device)
    if kv_lens is None:
        kv_lens = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    _build.launch_attention(
        "flash_attention", "aios_flash_attention", q, k, v, out,
        (q_offsets, kv_lens), B=B, Sq=Sq, window=window)
    launches += 1
    return out
