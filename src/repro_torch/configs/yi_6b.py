"""yi-6b [dense]: 32L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
[arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, activation="swiglu", rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    name="yi-6b-smoke", num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=96, vocab=256, remat_policy="none")
