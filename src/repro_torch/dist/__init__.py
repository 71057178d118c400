"""repro_torch.dist — the single-device half of the distribution layer:
gradient compression with error feedback."""
