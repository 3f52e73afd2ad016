"""Plain PyTorch versions of the attention kernels: full materialization in
fp32, deliberately naive. They are what a CPU tensor runs, the oracle the
CPU tests compare against ``repro.kernels.ref``, and what ``chip_smoke.py``
holds each CUDA kernel against on the card (``backend="torch"``).
Mirrors ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _broadcast_kv(k, n_heads: int):
    K = k.shape[-2]
    if K == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // K, dim=-2)


def _masked_softmax(s, mask):
    return torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)),
                         dim=-1)


def flash_attention_ref(q, k, v, *, q_offset=0, window=0, q_offsets=None,
                        kv_lens=None):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd]. Causal (optionally
    sliding-window) attention; q_offsets/kv_lens [B] give per-sequence query
    offsets and valid KV lengths."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    kf = _broadcast_kv(k, H).float()
    vf = _broadcast_kv(v, H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if q_offsets is None:
        q_offsets = torch.full((B,), q_offset, dtype=torch.int32, device=dev)
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    kpos = torch.arange(Skv, device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]                               # [B, Sq, Skv]
    if kv_lens is not None:
        mask = mask & (kpos < kv_lens.long()[:, None, None])
    if window:
        mask = mask & (kpos > (qpos[:, :, None] - window))
    p = _masked_softmax(s, mask[:, None])
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def chunk_attention_ref(q, k_cache, v_cache, q_offsets, q_lens=None, *,
                        window=0):
    """q: [B, C, H, hd], row i of sequence b at absolute position
    ``q_offsets[b] + i``; caches [B, S, K, hd] with the chunk's K/V already
    written. Prefix+chunk causal mask. Rows at or past ``q_lens[b]`` are
    zeros."""
    B, C, H, hd = q.shape
    S = k_cache.shape[1]
    dev = q.device
    kf = _broadcast_kv(k_cache, H).float()
    vf = _broadcast_kv(v_cache, H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    qpos = q_offsets.long()[:, None] + torch.arange(C, device=dev)[None, :]
    kpos = torch.arange(S, device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if window:
        mask = mask & (kpos > (qpos[:, :, None] - window))
    p = _masked_softmax(s, mask[:, None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if q_lens is not None:
        valid = torch.arange(C, device=dev)[None, :] < q_lens.long()[:, None]
        out = torch.where(valid[:, :, None, None], out, torch.zeros_like(out))
    return out


def packed_row_index(row_starts, q_lens, n_packed: int):
    """Row membership of each packed token position: ``row[p]`` is the row
    whose segment contains packed position p (``row_starts`` non-decreasing,
    ``row_starts[0] == 0``), ``valid[p]`` marks positions inside a row's
    q_len, and ``off[p]`` is the position's offset within its row."""
    p_idx = torch.arange(n_packed, device=row_starts.device)
    starts = row_starts.long()
    row = torch.searchsorted(starts, p_idx, right=True) - 1
    off = p_idx - starts[row]
    valid = off < q_lens.long()[row]
    return row, off, valid


def packed_chunk_attention_ref(q, k_cache, v_cache, row_starts, q_offsets,
                               q_lens, *, window=0):
    """Token-packed ragged chunk attention: q [Np, H, hd] holds every row's
    chunk tokens on one axis (row b at packed positions ``row_starts[b] ..
    row_starts[b] + q_lens[b] - 1``); caches [B, S, K, hd]. Packed positions
    past a row's q_len (gaps, tail padding) are zeros. Returns [Np, H, hd].

    Computed as a re-indexing of ``chunk_attention_ref``: each row's tokens
    are unpacked into a padded [B, Np] chunk, so a packed row equals the
    padded row bit for bit."""
    Np, H, hd = q.shape
    B = k_cache.shape[0]
    row, off, valid = packed_row_index(row_starts, q_lens, Np)
    q_pad = q.new_zeros((B, Np, H, hd))
    q_pad[row, off] = q                  # (row, off) pairs are distinct
    out = chunk_attention_ref(q_pad, k_cache, v_cache, q_offsets, q_lens,
                              window=window)[row, off]
    return torch.where(valid[:, None, None], out, torch.zeros_like(out))


def decode_attention_ref(q, k_cache, v_cache, seq_lens, *, window=0):
    """q: [B, H, hd]; caches [B, S, K, hd]; seq_lens [B] (valid prefix length
    including this step's token). The C == 1 case of chunk attention (one
    query at position seq_lens - 1), as in the JAX kernel, so a decode step
    and a length-1 chunk row compute the same bits."""
    return chunk_attention_ref(q[:, None], k_cache, v_cache, seq_lens - 1,
                               window=window)[:, 0]
