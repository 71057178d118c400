"""qwen1.5-4b [dense] — 40L d=2560 20H (kv=20) ff=6912 v=151936, QKV bias.

[hf:Qwen/Qwen1.5-4B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151936, head_dim=128, qkv_bias=True,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen1.5-4b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, qkv_bias=True,
)
