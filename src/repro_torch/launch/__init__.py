"""repro_torch.launch — device meshes over ``torch.distributed``
(:mod:`repro_torch.launch.mesh`)."""
