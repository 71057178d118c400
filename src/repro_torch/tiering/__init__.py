"""repro_torch.tiering — the NeoMem tiering surface (DESIGN.md §1):
resources, one multiplexed daemon, the data plane on its synchronous and
asynchronous (DESIGN.md §15) arms, and telemetry."""
