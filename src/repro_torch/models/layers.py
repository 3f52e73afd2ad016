"""Shared neural-net substrate: norms, RoPE, attention entry points, MLPs,
cache writes. Mirrors ``repro/models/layers.py``.

Parameters are plain nested dicts of tensors in the JAX package's layouts
(weights ``[in, out]`` used as ``x @ W``). Caches are ``[B, S, K, hd]``
tensors updated IN PLACE: a row with length 0 is never written.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import packed_row_index  # noqa: F401 -- one decoder of the packed layout

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers (the JAX package's scales; equal distributions, not values)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def norm_init(d: int, device):
    return torch.ones((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(dt)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split (not interleaved). x: [..., S, H, hd];
    positions: [..., S] (int)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs            # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """tanh-approximate GeLU, as ``jax.nn.gelu`` defaults to."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) *
                                       (x + 0.044715 * x * x * x)))


# ---------------------------------------------------------------------------
# attention entry points (routed through kernels/ops: device decides)
# ---------------------------------------------------------------------------

def causal_attention(q, k, v, *, q_offset=0, window: int = 0):
    """Causal (optionally sliding-window) attention. q: [B, Sq, H, hd];
    k, v: [B, Skv, K, hd]; q_offset: position of q[0] relative to k[0]."""
    return kops.flash_attention(q, k, v, q_offset=q_offset, window=window)


def chunk_attention(q, k_cache, v_cache, q_offsets, *, q_lens=None,
                    window: int = 0):
    """Prefix+chunk causal attention: row i of sequence b at absolute
    position ``q_offsets[b] + i`` attends to cache positions ``0 ..
    q_offsets[b] + i``; the chunk's own K/V must already be in the cache.
    q: [B, C, H, hd]; caches: [B, S, K, hd]; q_offsets, q_lens: [B] int32."""
    return kops.chunk_attention(q, k_cache, v_cache, q_offsets, q_lens,
                                window=window)


def packed_chunk_attention(q, k_cache, v_cache, row_starts, q_offsets,
                           q_lens, *, window: int = 0):
    """Token-packed ragged variant of ``chunk_attention``: q [Np, H, hd]
    holds every row's chunk tokens on one axis (row b at ``row_starts[b] ..
    row_starts[b] + q_lens[b] - 1``). Returns [Np, H, hd]."""
    return kops.packed_chunk_attention(q, k_cache, v_cache, row_starts,
                                       q_offsets, q_lens, window=window)


def decode_attention(q, k_cache, v_cache, seq_lens, *, window: int = 0):
    """One-token attention against a contiguous KV cache. q: [B, H, hd];
    seq_lens: [B] valid prefix length including this step's token."""
    return kops.decode_attention(q, k_cache, v_cache, seq_lens,
                                 window=window)


# ---------------------------------------------------------------------------
# attention block (QKV + rope + out-proj)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg, device) -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {"wq": dense_init(gen, d, H * hd, dt, device),
            "wk": dense_init(gen, d, K * hd, dt, device),
            "wv": dense_init(gen, d, K * hd, dt, device),
            "wo": dense_init(gen, H * hd, d, dt, device)}


def attn_qkv(p, x, cfg, positions, rotary: bool = True):
    """x: [B, S, d] -> q [B,S,H,hd], k/v [B,S,K,hd] with RoPE applied."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if rotary:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# cache writes (in place)
#
# A write plan is computed once per dispatch and reused by every layer's K
# and V write. Every (row, position) a plan touches is either a valid token
# or a harmless duplicate: a dead chunk slot of a live row re-writes the
# row's last valid token (same value, so the order of duplicates does not
# matter), and every slot of a length-0 row re-writes the cache's current
# value. No host sync, no write past a row's valid tokens.
# ---------------------------------------------------------------------------

def _writable(offsets, lengths, S: int):
    """Tokens of each row that land inside the cache: a position at or past
    the cache edge writes nothing (as the JAX package's masked writes)."""
    return torch.minimum(lengths.long(), S - offsets.long()).clamp(min=0)


def chunk_write_plan(offsets, lengths, C: int, S: int):
    """Plan for ``cache_write_chunk``: ``new[b, :lengths[b]]`` lands at
    ``cache[b, offsets[b] : offsets[b] + lengths[b]]``."""
    dev = offsets.device
    ar = torch.arange(C, device=dev)[None, :]                    # [1, C]
    ln = _writable(offsets, lengths, S)[:, None]
    src = torch.where(ar < ln, ar, (ln - 1).clamp(min=0))       # [B, C]
    pos = (offsets.long()[:, None] + src).clamp(0, S - 1)
    rows = torch.arange(offsets.shape[0], device=dev)[:, None].expand_as(pos)
    return rows, pos, (rows, src), (ln > 0).expand_as(pos)


def packed_write_plan(row_starts, q_offsets, lengths, Np: int, S: int):
    """Plan for ``cache_write_packed``: packed token p of row r lands at
    ``cache[r, q_offsets[r] + p - row_starts[r]]``; gaps and tail padding
    re-write their row's last valid token (or nothing, for length-0 rows)."""
    row, off, _ = packed_row_index(row_starts, lengths, Np)
    ln = _writable(q_offsets, lengths, S)[row]
    src_off = torch.where(off < ln, off, (ln - 1).clamp(min=0))
    src = (row_starts.long()[row] + src_off).clamp(0, Np - 1)
    pos = (q_offsets.long()[row] + src_off).clamp(0, S - 1)
    return row, pos, (src,), ln > 0


def cache_write(cache, new, plan):
    """Apply a write plan: cache [B, S, K, hd]; new [B, C, K, hd] (chunk
    plan) or [Np, K, hd] (packed plan). In place; returns ``cache``."""
    rows, pos, src, use_new = plan
    vals = new[src].to(cache.dtype)
    cur = cache[rows, pos]
    cache.index_put_((rows, pos),
                     torch.where(use_new[..., None, None], vals, cur))
    return cache


def cache_write_chunk(cache, new, offsets, lengths):
    """Write a chunk of tokens per sequence into a [B, S, K, hd] cache in
    place: ``new[b, :lengths[b]]`` lands at ``cache[b, offsets[b] :
    offsets[b] + lengths[b]]``; rows with ``lengths[b] == 0`` are untouched.
    new: [B, C, K, hd]; offsets, lengths: [B] int32."""
    return cache_write(cache, new, chunk_write_plan(
        offsets, lengths, new.shape[1], cache.shape[1]))


def cache_write_packed(cache, new, row_starts, q_offsets, lengths):
    """Scatter packed tokens [Np, K, hd] into a [B, S, K, hd] cache in place
    (gaps, tail padding and length-0 rows write nothing)."""
    return cache_write(cache, new, packed_write_plan(
        row_starts, q_offsets, lengths, new.shape[0], cache.shape[1]))


def token_write_plan(seq_lens, S: int):
    """Plan for ``cache_write_token``: one token per sequence at position
    ``seq_lens[b]``."""
    return chunk_write_plan(seq_lens, torch.ones_like(seq_lens), 1, S)


def cache_write_token(cache, new, seq_lens):
    """Write one token per sequence into a [B, S, K, hd] cache in place at
    positions ``seq_lens``. new: [B, K, hd]; seq_lens: [B]."""
    return cache_write(cache, new[:, None],
                       token_write_plan(seq_lens, cache.shape[1]))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, device, d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if cfg.activation in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d, ff, dt, device),
                "wg": dense_init(gen, d, ff, dt, device),
                "wo": dense_init(gen, ff, d, dt, device)}
    return {"wi": dense_init(gen, d, ff, dt, device),
            "wo": dense_init(gen, ff, d, dt, device)}


def mlp_apply(p, x, activation: str):
    if activation == "swiglu":
        return (silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    if activation == "geglu":
        return (gelu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    h = torch.relu(x @ p["wi"])
    return (h * h) @ p["wo"]
