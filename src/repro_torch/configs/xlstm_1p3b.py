"""xlstm-1.3b [ssm] — 48L d=2048 4H v=50304, d_ff=0 (block-internal proj).

sLSTM + mLSTM blocks at 1:7 ratio.  Attention-free: NeoMem applies to
embedding rows only (DESIGN.md §5).  [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=512, mlstm_heads=4,
    pattern=("mlstm",) * 7 + ("slstm",),
)

SMOKE_CONFIG = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=256, head_dim=16, mlstm_heads=4,
    pattern=("mlstm", "slstm"),
)
