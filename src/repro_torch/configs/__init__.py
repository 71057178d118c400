"""Architecture configs the port runs (see :mod:`repro_torch.configs.registry`)."""
