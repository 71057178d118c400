"""whisper-base [audio] — 6L enc + 6L dec, d=512 8H ff=2048 v=51865.

Encoder-decoder; the conv audio frontend is a STUB (input_specs provide
1500 precomputed frame embeddings).  Positional scheme: RoPE substituted
for Whisper's learned absolute embeddings (noted in DESIGN.md — systems
behavior is unaffected).  [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=12, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64, norm="ln", mlp="gelu",
    pattern=("dec",), n_aux_tokens=1500,
)

SMOKE_CONFIG = ArchConfig(
    name="whisper-base-smoke", family="audio",
    n_layers=4, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16, norm="ln", mlp="gelu",
    pattern=("dec",), n_aux_tokens=25,
)
