"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (kv=8) ff=14336 v=128256.

Cross-attention image layers every 5th position (8 cross layers in 40);
vision frontend is a STUB: input_specs provide precomputed patch embeddings
(n_aux_tokens x d_model).  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    n_aux_tokens=1601, tie_embeddings=True,
)

SMOKE_CONFIG = ArchConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, rope_theta=500000.0,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    n_aux_tokens=17,
)
