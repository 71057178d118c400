"""stablelm-1.6b [dense] — 24L d=2048 32H (kv=32) ff=5632 v=100352.

LayerNorm + qkv bias.  [hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, head_dim=64, norm="ln", qkv_bias=True,
)

SMOKE_CONFIG = ArchConfig(
    name="stablelm-1.6b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, norm="ln", qkv_bias=True,
)
