"""deepseek-v3-671b [moe] — 61L d=7168 128H MLA v=129280, 256e top-8 + MTP.

MLA (latent KV), 3 dense prologue layers, 1 shared + 256 routed experts
top-8 with aux-loss-free balancing, multi-token-prediction head.
[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, head_dim=128, rope_theta=10000.0,
    pattern=("moe",), mtp=True,
    mla=MLACfg(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoECfg(n_experts=256, top_k=8, expert_ff=2048, shared_ff=2048,
               n_dense_prologue=3, dense_ff=18432, bias_free_balance=True),
)

SMOKE_CONFIG = ArchConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=256, head_dim=16,
    pattern=("moe",), mtp=True,
    mla=MLACfg(q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16),
    moe=MoECfg(n_experts=8, top_k=2, expert_ff=64, shared_ff=64,
               n_dense_prologue=1, dense_ff=128, bias_free_balance=True),
)
