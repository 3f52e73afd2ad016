"""Unified model API of the port: ``build_model(cfg)``. Mirrors
``repro/models/api.py`` for the families this slice serves.

  model  = build_model(cfg)
  params = model.init_params(seed, device)        (or convert.params_from_numpy)
  cache  = model.init_cache(batch, max_len, device)
  cache, logits = model.prefill / prefill_chunk / prefill_packed / decode_step
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.models.transformer import DenseTransformer

MODEL_REGISTRY: Dict[str, Callable] = {
    "dense": DenseTransformer,
    "audio": DenseTransformer,   # decoder over EnCodec tokens (frontend stub)
}

# families whose model code is still to be ported, with the ROADMAP item
_NOT_PORTED = {"vlm": "VLM", "moe": "MoE", "ssm": "recurrent archs (RWKV-6)",
               "hybrid": "recurrent archs (RecurrentGemma)"}


def build_model(cfg):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
            f"yet: ROADMAP.md Queue 1, {_NOT_PORTED[cfg.family]}")
    return MODEL_REGISTRY[cfg.family](cfg)
