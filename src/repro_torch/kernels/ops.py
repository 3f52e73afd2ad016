"""Device dispatch over the port's attention kernels: mirrors
``repro/kernels/ops.py``.

The tensor's device decides: a CPU tensor runs the plain PyTorch version
(``ref``), a CUDA tensor launches the hand-written CUDA kernel -- or raises;
nothing falls back. ``backend="torch"`` asks for the plain version on any
device (``chip_smoke.py`` uses it to hold each kernel against its plain
version on the card); nothing on the serving path passes it.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

BACKENDS = (None, "torch")


def _plain(t, backend: Optional[str]) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend == "torch" or t.device.type == "cpu"


def ensure_built() -> None:
    """Build (or load) every CUDA kernel now, on the caller's thread."""
    _build.ensure_built()


def launch_counts() -> Dict[str, int]:
    """Kernel launches in this process, by kernel."""
    return {"flash_attention": _fa.launches,
            "chunk_attention": _da.chunk_launches,
            "packed_chunk_attention": _da.packed_launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _da.chunk_launches = 0
    _da.packed_launches = 0


def flash_attention(q, k, v, *, q_offset=0, window=0, q_offsets=None,
                    kv_lens=None, backend=None):
    if _plain(q, backend):
        return _ref.flash_attention_ref(q, k, v, q_offset=q_offset,
                                        window=window, q_offsets=q_offsets,
                                        kv_lens=kv_lens)
    return _fa.flash_attention(q, k, v, q_offset=q_offset, window=window,
                               q_offsets=q_offsets, kv_lens=kv_lens)


def chunk_attention(q, k_cache, v_cache, q_offsets, q_lens=None, *, window=0,
                    backend=None):
    """Chunked-prefill attention: q [B, C, H, hd] at per-sequence offsets
    against a contiguous KV cache. Per-row ``q_lens`` admits mixed batches --
    prefill (q_len == C), decode (q_len == 1) and inactive (q_len == 0) rows
    in one dispatch."""
    if _plain(q, backend):
        return _ref.chunk_attention_ref(q, k_cache, v_cache, q_offsets,
                                        q_lens, window=window)
    return _da.chunk_attention(q, k_cache, v_cache, q_offsets, q_lens,
                               window=window)


def packed_chunk_attention(q, k_cache, v_cache, row_starts, q_offsets,
                           q_lens, *, window=0, backend=None):
    """Token-packed ragged chunk attention: q [Np, H, hd] concatenates all
    rows' chunk tokens on one axis (row b at packed positions
    ``row_starts[b] .. row_starts[b] + q_lens[b] - 1``)."""
    if _plain(q, backend):
        return _ref.packed_chunk_attention_ref(q, k_cache, v_cache,
                                               row_starts, q_offsets, q_lens,
                                               window=window)
    return _da.packed_chunk_attention(q, k_cache, v_cache, row_starts,
                                      q_offsets, q_lens, window=window)


def decode_attention(q, k_cache, v_cache, seq_lens, *, window=0,
                     backend=None):
    if _plain(q, backend):
        return _ref.decode_attention_ref(q, k_cache, v_cache, seq_lens,
                                         window=window)
    return _da.decode_attention(q, k_cache, v_cache, seq_lens, window=window)
