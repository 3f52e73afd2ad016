"""Carry the JAX package's weights into the port.

``params_from_numpy`` takes the JAX model's parameter dict after
``jax.tree.map(np.asarray, params)`` (stacked ``blocks`` leaves on a leading
layer axis, the layout the port also uses) and returns the same tree as
torch tensors on ``device``, so both packages compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, including ``ml_dtypes.bfloat16`` arrays (which
    ``torch.from_numpy`` refuses): viewed as uint16, then as bfloat16."""
    a = np.array(a)             # a writable copy (jax hands out read-only views)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, cfg, device) -> Any:
    """Convert a nested dict of numpy arrays (the JAX parameter tree) into
    the port's parameter tree. ``cfg`` is checked against the embedding
    shape so a tree of another model is refused."""
    emb = tree["embed"]
    if tuple(emb.shape) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embed {tuple(emb.shape)} does not match {cfg.name}: "
                         f"expected ({cfg.padded_vocab}, {cfg.d_model})")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tensor_from_numpy(np.asarray(x), device)

    return conv(tree)
