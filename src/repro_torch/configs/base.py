"""Model configuration dataclass shared by the port's architectures.

The fields and their defaults are those of ``repro.configs.base.ModelConfig``;
dtypes are torch dtypes. Every ported architecture gets a ``<id>.py`` in this
package defining CONFIG (the published configuration) and SMOKE (a reduced
same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    activation: str = "swiglu"  # swiglu | geglu | squared_relu
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False
    infer_dropless: bool = True
    # --- hybrid / ssm ---
    window: int = 0
    lru_width: int = 0
    conv_width: int = 4
    rwkv_head_dim: int = 64
    attn_every: int = 0
    # --- vlm / audio ---
    cross_attn_every: int = 0
    num_frontend_tokens: int = 0
    # --- training defaults ---
    train_accum: int = 4
    # --- kernels ---
    # Kept for parity with the JAX config. In the port the tensor's device
    # decides: CUDA tensors run the hand-written kernels, CPU tensors the
    # plain PyTorch versions (kernels/ops.py).
    use_kernel: bool = False
    # --- numerics / misc ---
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat_policy: str = "nothing"
    fsdp: bool = False
    logits_softcap: float = 0.0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the JAX package (padded
        logits are masked at sampling)."""
        return ((self.vocab + 255) // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameters of a dense config (untied embeddings)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d
        mlp = (3 if self.activation in ("swiglu", "geglu") else 2) * d * ff
        return V * d * 2 + (attn + mlp) * self.num_layers
