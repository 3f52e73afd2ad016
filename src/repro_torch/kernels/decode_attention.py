"""Hand-written CUDA attention over a contiguous KV cache: the port of
``repro/kernels/decode_attention.py`` (chunk, token-packed chunk and decode
attention). The kernels are ``csrc/chunk_attention.cu``; this module checks
the inputs, allocates the outputs and launches them on the current stream.

The caches are passed by stride, so the engine's ``cache[..., :kv_width]``
views are read in place (no ``.contiguous()`` copy of the live cache).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

chunk_launches = 0     # launches of the chunk kernel (decode included)
packed_launches = 0    # launches of the packed-chunk kernel


def chunk_attention(q, k_cache, v_cache, q_offsets, q_lens=None, *,
                    window: int = 0):
    """q: [B, C, H, hd], row i of sequence b at absolute position
    ``q_offsets[b] + i``; caches [B, S, K, hd] with the chunk's K/V already
    written; q_lens [B] the valid rows per chunk (default C). Rows at or
    past q_lens[b] are zeros. Returns [B, C, H, hd]."""
    global chunk_launches
    B, C, H, hd = q.shape
    if q_lens is None:
        q_lens = torch.full((B,), C, dtype=torch.int32, device=q.device)
    out = torch.empty((B, C, H, hd), dtype=q.dtype, device=q.device)
    _build.launch_attention(
        "chunk_attention", "aios_chunk_attention", q, k_cache, v_cache, out,
        (q_offsets, q_lens), B=B, Sq=C, window=window)
    chunk_launches += 1
    return out


def packed_chunk_attention(q, k_cache, v_cache, row_starts, q_offsets,
                           q_lens, *, window: int = 0):
    """Token-packed ragged chunk attention: q [Np, H, hd] holds every row's
    chunk tokens on one axis (row b at packed positions ``row_starts[b] ..
    row_starts[b] + q_lens[b] - 1``, row_starts non-decreasing from 0);
    caches [B, S, K, hd]. The kernel finds each position's row itself, so
    row starts need no alignment. Positions outside every row's q_len are
    zeros. Returns [Np, H, hd]."""
    global packed_launches
    Np, H, hd = q.shape
    B = k_cache.shape[0]
    out = torch.empty((Np, H, hd), dtype=q.dtype, device=q.device)
    _build.launch_attention(
        "chunk_attention", "aios_packed_chunk_attention", q, k_cache, v_cache,
        out, (row_starts, q_offsets, q_lens), B=B, Sq=Np, window=window,
        packed=True)
    packed_launches += 1
    return out


def decode_attention(q, k_cache, v_cache, seq_lens, *, window: int = 0):
    """q: [B, H, hd]; caches [B, S, K, hd]; seq_lens [B] (valid prefix length
    including this step's token) -> [B, H, hd]. The C == 1 case of
    chunk_attention: one query at position seq_lens - 1."""
    out = chunk_attention(q[:, None], k_cache, v_cache,
                          (seq_lens - 1).to(torch.int32), window=window)
    return out[:, 0]
