"""gemma2-27b [dense] — 46L d=4608 32H (kv=16) ff=36864 v=256000.

Local(4K window)/global alternating attention, logit softcaps (50 attn /
30 final), GeGLU, RMSNorm(1+w) with post-norms, query scale 144^-0.5.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, head_dim=128, norm="rms+1", mlp="geglu",
    pattern=("attn_local", "attn_global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, attn_scale=144.0 ** -0.5,
    post_norm=True, embed_scale=True,
)

SMOKE_CONFIG = ArchConfig(
    name="gemma2-27b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=256, head_dim=16, norm="rms+1", mlp="geglu",
    pattern=("attn_local", "attn_global"), window=8,
    attn_softcap=50.0, final_softcap=30.0, attn_scale=16.0 ** -0.5,
    post_norm=True, embed_scale=True,
)
