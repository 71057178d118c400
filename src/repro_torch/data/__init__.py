"""repro_torch.data — deterministic token batches for training."""
