"""repro_torch.tiering — the NeoMem tiering surface (DESIGN.md §1).

One API for every consumer of slow memory:

  ResourceSpec / TieredResource / registry ... declare a consumer
  TieredMemory / TieredMemoryState ........... profiling + placement
  NeoMemDaemon (multiplexed) ................. one loop, N resources
  TierStats .................................. one telemetry schema
  migrate / TierBuffers ...................... the data plane on its
                                               synchronous and asynchronous
                                               (DESIGN.md §15) arms
  codec ...................................... slow-store wire formats (§14)

The package re-exports the same names as the reference's ``repro.tiering``.
"""
from repro_torch.tiering.codec import (  # noqa: F401
    CODECS, decode_rows, dequantize_int8, encode_rows, quantize_int8,
    wire_row_bytes,
)
from repro_torch.tiering.daemon import (  # noqa: F401
    NeoMemDaemon, ResourceHandle, split_quota,
)
from repro_torch.tiering.memory import (  # noqa: F401
    DaemonParams, MigrationEvent, TieredMemory, TieredMemoryState, lookup,
    observe,
)
from repro_torch.tiering.migrate import (  # noqa: F401
    TierBuffers, init_buffers, lookup_rows, read_rows, segment_page_ids,
    write_rows,
)
from repro_torch.tiering.resource import (  # noqa: F401
    ResourceSpec, StreamResource, TieredResource, make_resource,
    register_resource, resource_kinds,
)
from repro_torch.tiering.resources import (  # noqa: F401
    EMBED_ROWS_PER_PAGE, EmbedRowsResource, ExpertStreamResource,
    KVPagesResource,
)
from repro_torch.tiering.stats import TierStats, drain_tier_stats, hit_rate  # noqa: F401
