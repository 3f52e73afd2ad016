"""Deterministic batched sampler: mirrors ``repro/serving/sampler.py``.

Each sequence has its own integer seed, and draw #n of a sequence uses a
``torch.Generator`` seeded from (seed, n) alone, so sampling is independent
of slot placement and batch composition: a resumed sequence draws exactly
the stream it would have drawn uninterrupted. Greedy decoding is exact
argmax (first index on ties, as ``jnp.argmax``). Temperature draws are the
Gumbel-max trick on the generator's uniforms; they are NOT the JAX
package's threefry bits, so temperature streams differ between the two
packages (equal in distribution only).
"""
from __future__ import annotations

from typing import Sequence

import torch

_MASK63 = (1 << 63) - 1


def draw_seed(seq_seed: int, counter: int) -> int:
    """Generator seed of draw #counter of a sequence (splitmix64 mix)."""
    z = (int(seq_seed) * 0x9E3779B97F4A7C15 + int(counter)) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def mask_padded_vocab(logits, vocab: int):
    """Embedding/head tables are padded to a 256 multiple; padded columns
    must never be sampled."""
    if logits.shape[-1] == vocab:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < vocab, logits, torch.full_like(logits, -1e30))


def sample(logits, seq_seeds: Sequence[int], counters: Sequence[int],
           temperature: float = 0.0):
    """logits: [B, V]; seq_seeds, counters: per-row ints (the sequence's seed
    and the absolute index of this draw). Returns [B] int32 token ids."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    V = logits.shape[-1]
    out = []
    for row, seed, n in zip(logits, seq_seeds, counters):
        g = torch.Generator(device=logits.device).manual_seed(draw_seed(seed, n))
        u = torch.rand((V,), generator=g, dtype=torch.float32,
                       device=logits.device).clamp(1e-20, 1.0 - 1e-7)
        gumbel = -torch.log(-torch.log(u))
        out.append(torch.argmax(row.float() / temperature + gumbel))
    return torch.stack(out).to(torch.int32)
