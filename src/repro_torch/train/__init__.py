"""repro_torch.train — the train step."""
