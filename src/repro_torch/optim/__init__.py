"""repro_torch.optim — AdamW, Adafactor and single-device ZeRO-1."""
