"""repro_torch.ckpt — checkpoints with atomic commits (DESIGN.md §6)."""
