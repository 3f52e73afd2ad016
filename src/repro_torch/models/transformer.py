"""Dense decoder-only transformer (llama/granite/yi family): the port of
``repro/models/transformer.py`` without the VLM cross-attention branches.

Layers are stacked on a leading layer axis in the parameter dict (as the
JAX package's ``lax.scan`` wants them) and run by a Python loop. The KV
cache ``{"k", "v": [L, B, S, K, hd], "seq_lens": [B] int32}`` is updated IN
PLACE by every entry point; each also returns it, as the JAX functions
return their new cache.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import layers as L


def tree_map(fn: Callable, tree, *rest):
    """Map over nested dicts of tensors (the parameter / cache trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def layer(blocks: Dict[str, Any], l: int):
    """Layer ``l`` of a stacked block tree (views, no copies)."""
    return tree_map(lambda t: t[l], blocks)


class DenseTransformer:
    """family in {dense, audio}."""

    def __init__(self, cfg):
        if cfg.family == "vlm" and cfg.cross_attn_every > 0:
            raise NotImplementedError(
                "VLM cross-attention is not ported yet (ROADMAP.md Queue 1, "
                "VLM)")
        self.cfg = cfg
        self.n_super = cfg.num_layers

    # -- init ---------------------------------------------------------------
    def _block_init(self, gen, device):
        cfg = self.cfg
        return {"ln1": L.norm_init(cfg.d_model, device),
                "attn": L.attn_init(gen, cfg, device),
                "ln2": L.norm_init(cfg.d_model, device),
                "mlp": L.mlp_init(gen, cfg, device)}

    def init_params(self, seed: int, device) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        at the JAX package's scales. Layers are drawn one at a time into the
        stacked tensors, so the peak extra memory is one layer in fp32."""
        cfg = self.cfg
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        p = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                   cfg.param_dtype, device)}
        blocks = None
        for l in range(self.n_super):
            blk = self._block_init(gen, device)
            if blocks is None:
                blocks = tree_map(lambda t: torch.empty(
                    (self.n_super,) + tuple(t.shape), dtype=t.dtype,
                    device=device), blk)
            tree_map(lambda dst, src: dst[l].copy_(src), blocks, blk)
        p["blocks"] = blocks
        p["lnf"] = L.norm_init(cfg.d_model, device)
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                 cfg.param_dtype, device)
        return p

    # -- KV cache -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (self.n_super, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "seq_lens": torch.zeros((batch,), dtype=torch.int32,
                                        device=device)}

    # -- shared pieces --------------------------------------------------------
    def _ffn(self, blk, x):
        """Post-attention feed-forward half of a layer (ln2 + MLP)."""
        cfg = self.cfg
        h = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
        return x + L.mlp_apply(blk["mlp"], h, cfg.activation)

    def _head(self, params, x):
        cfg = self.cfg
        logits = L.rms_norm(x, params["lnf"], cfg.norm_eps) @ params["head"]
        if cfg.logits_softcap:
            logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
        return logits

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.cfg.dtype)

    # -- prefill --------------------------------------------------------------
    def prefill(self, params, tokens, cache, *, lengths=None):
        """tokens: [B, S_prompt] right-padded; writes K/V at positions
        ``0 .. S_prompt - 1`` and sets seq_lens; returns (cache,
        last_logits)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        for l in range(self.n_super):
            blk = layer(params["blocks"], l)
            h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(blk["attn"], h, cfg, positions)
            o = L.causal_attention(q, k, v)
            x = self._ffn(blk, x + L.attn_out(blk["attn"], o))
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        idx = (lengths.long() - 1).clamp(min=0)
        last = x[torch.arange(B, device=x.device), idx]
        cache["seq_lens"].copy_(lengths)
        return cache, self._head(params, last)

    # -- chunked prefill / mixed dispatch ------------------------------------
    def prefill_chunk(self, params, tokens, cache, *, q_offset, lengths,
                      kv_width=None):
        """Batched chunked prefill AND decode in one dispatch: row b of
        ``tokens`` [B, C] sits at positions ``q_offset[b] .. q_offset[b] +
        lengths[b] - 1``. A decoding slot is a ``lengths[b] == 1`` row at its
        current position; rows with ``lengths[b] == 0`` are a strict no-op
        (cache and seq_lens untouched). ``kv_width`` bounds every row's
        context after this chunk: writes and attention run on the
        ``[:, :kv_width]`` view of each layer's cache. Returns (cache,
        last_logits); last_logits[b] is garbage when lengths[b] == 0."""
        cfg = self.cfg
        B, C = tokens.shape
        S = cache["k"].shape[2]
        kv = kv_width if kv_width is not None and kv_width < S else S
        x = self._embed(params, tokens)
        positions = q_offset.long()[:, None] + torch.arange(
            C, device=x.device)[None, :]
        plan = L.chunk_write_plan(q_offset, lengths, C, kv)
        for l in range(self.n_super):
            blk = layer(params["blocks"], l)
            h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(blk["attn"], h, cfg, positions)
            kw = cache["k"][l, :, :kv]
            vw = cache["v"][l, :, :kv]
            L.cache_write(kw, k, plan)
            L.cache_write(vw, v, plan)
            o = L.chunk_attention(q, kw, vw, q_offset, q_lens=lengths)
            x = self._ffn(blk, x + L.attn_out(blk["attn"], o))
        idx = (lengths.long() - 1).clamp(min=0)
        last = x[torch.arange(B, device=x.device), idx]
        cache["seq_lens"].copy_(torch.where(lengths > 0, q_offset + lengths,
                                            cache["seq_lens"]))
        return cache, self._head(params, last)

    # -- token-packed ragged prefill ------------------------------------------
    def prefill_packed(self, params, tokens, cache, *, row_starts, q_offset,
                       lengths, chunk=None, kv_width=None):
        """Token-packed variant of ``prefill_chunk``: ``tokens`` [Np] holds
        every row's chunk tokens on one axis, row b at packed positions
        ``row_starts[b] .. row_starts[b] + lengths[b] - 1``, so the
        dispatch pays for the real tokens it carries. Same per-row
        semantics as prefill_chunk; ``chunk`` is interface parity with the
        JAX package (dense attention does not need it)."""
        cfg = self.cfg
        Np = tokens.shape[0]
        S = cache["k"].shape[2]
        kv = kv_width if kv_width is not None and kv_width < S else S
        x = self._embed(params, tokens)[None]                    # [1, Np, d]
        row, off, _ = L.packed_row_index(row_starts, lengths, Np)
        positions = (q_offset.long()[row] + off)[None]           # [1, Np]
        plan = L.packed_write_plan(row_starts, q_offset, lengths, Np, kv)
        for l in range(self.n_super):
            blk = layer(params["blocks"], l)
            h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(blk["attn"], h, cfg, positions)
            kw = cache["k"][l, :, :kv]
            vw = cache["v"][l, :, :kv]
            L.cache_write(kw, k[0], plan)
            L.cache_write(vw, v[0], plan)
            o = L.packed_chunk_attention(q[0], kw, vw, row_starts, q_offset,
                                         lengths)
            x = self._ffn(blk, x + L.attn_out(blk["attn"], o[None]))
        last_idx = (row_starts.long() + (lengths.long() - 1).clamp(min=0)
                    ).clamp(0, Np - 1)
        cache["seq_lens"].copy_(torch.where(lengths > 0, q_offset + lengths,
                                            cache["seq_lens"]))
        return cache, self._head(params, x[0][last_idx])

    # -- decode ---------------------------------------------------------------
    def decode_step(self, params, tokens, cache):
        """tokens: [B] -> (cache, logits [B, V]); every row advances one
        position (seq_lens + 1)."""
        cfg = self.cfg
        x = self._embed(params, tokens)[:, None, :]              # [B, 1, d]
        seq_lens = cache["seq_lens"]
        positions = seq_lens.long()[:, None]
        plan = L.token_write_plan(seq_lens, cache["k"].shape[2])
        for l in range(self.n_super):
            blk = layer(params["blocks"], l)
            h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.attn_qkv(blk["attn"], h, cfg, positions)
            L.cache_write(cache["k"][l], k, plan)
            L.cache_write(cache["v"][l], v, plan)
            o = L.decode_attention(q[:, 0], cache["k"][l], cache["v"][l],
                                   seq_lens + 1)
            x = self._ffn(blk, x + L.attn_out(blk["attn"], o[:, None]))
        cache["seq_lens"].add_(1)
        return cache, self._head(params, x[:, 0, :])
