"""kimi-k2-1t-a32b [moe] — 61L d=7168 64H (kv=8) v=163840, 384e top-8.

Trillion-parameter MoE: 1 dense prologue layer + 60 MoE layers, expert
ff=2048, 1 shared expert.  THE flagship NeoMem expert-tiering target.
[arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128, rope_theta=50000.0,
    pattern=("moe",),
    moe=MoECfg(n_experts=384, top_k=8, expert_ff=2048, shared_ff=2048,
               n_dense_prologue=1, dense_ff=18432, bias_free_balance=True),
)

SMOKE_CONFIG = ArchConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
    pattern=("moe",),
    moe=MoECfg(n_experts=8, top_k=2, expert_ff=64, shared_ff=64,
               n_dense_prologue=1, dense_ff=128, bias_free_balance=True),
)
