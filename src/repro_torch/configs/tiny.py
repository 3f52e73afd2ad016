"""Tiny debug config used by the serving tests (real model, same code paths
as the big archs)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tiny", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, activation="swiglu", remat_policy="none",
)

SMOKE = CONFIG
