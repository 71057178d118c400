"""repro_torch.tiering — the NeoMem tiering surface (DESIGN.md §1), synchronous
plane: resources, one multiplexed daemon, the data plane and telemetry."""
