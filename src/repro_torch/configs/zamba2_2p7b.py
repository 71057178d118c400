"""zamba2-2.7b [hybrid] — 54L d=2560 32H (kv=32) ff=10240 v=32000, ssm=64.

Mamba2 blocks + a SHARED attention(+MLP) block applied every 6th position
(one weight set reused across all 9 groups).  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, rope_theta=10000.0,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm=SSMCfg(d_state=64, headdim=64, expand=2, d_conv=4, n_groups=1),
)

SMOKE_CONFIG = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16,
    pattern=("mamba", "mamba", "shared_attn"),
    ssm=SSMCfg(d_state=16, headdim=16, expand=2, d_conv=4, n_groups=1, chunk=16),
)
