"""repro_torch.dist — the distribution layer on ``torch.distributed``: the
software counterpart of NeoMem's hardware tiers (port of ``repro/dist``).

  sharding.py      placement rules: a spec for every param, cache and
                   batch tensor from its name and shape, the blocks a rank
                   holds (``shard`` / ``gather``) and the group-at-a-time
                   gather of stored blocks (``Layout``).
  compression.py   the bandwidth-limited link: int8 + error-feedback
                   gradient compression, and its compressed sum over the
                   data-parallel ranks (``compress_psum``).
  pipeline.py      GPipe microbatches around a ring of point-to-point
                   sends, overlapping stage compute with activation moves.
  host_offload.py  the DRAM/CXL tier pair: device memory and pinned host
                   memory, a logical split on the CPU.
  collectives.py   the collectives and their autograd rules.

Nothing here initialises a process group or touches a device at import.
"""
from repro_torch.dist import collectives, compression, host_offload, pipeline, sharding

__all__ = ["collectives", "compression", "host_offload", "pipeline", "sharding"]
