"""NeoMem core: the NeoProf sketch, Algorithm 1 and 2Q placement (PyTorch).

Public API, the names of the reference's ``repro.core``:
  SketchParams/SketchState + sketch_* .... Count-Min hot-page detector
  NeoProfParams/NeoProfState/Commands .... the device-side profiler unit
  PolicyParams/PolicyState/update_threshold ... Algorithm 1
  TierParams/TierState + promote/touch ... two-tier page placement
  run_sim/WORKLOADS ...................... paper-evaluation simulator

The tiering surface (TieredResource / TieredMemory / the multiplexed daemon /
TierStats) lives in :mod:`repro_torch.tiering`; the most-used names are
served here lazily from there.  The reference's ``repro.core.daemon``, a
deprecation shim of a single-resource daemon over ``TieredMemory``, has no
counterpart: nothing of the port calls it, so ``DaemonParams`` and
``NeoMemDaemon`` are the multiplexed daemon's, from
:mod:`repro_torch.tiering`.
"""
from repro_torch.core.sketch import (  # noqa: F401
    SketchParams, SketchState, sketch_init, sketch_update, sketch_query,
    sketch_clear, sketch_histogram, error_bound_from_hist, quantile_from_hist,
    h3_hash, make_seeds,
)
from repro_torch.core.neoprof import (  # noqa: F401
    NeoProfParams, NeoProfState, NeoProfCommands, neoprof_init, neoprof_observe,
)
from repro_torch.core.policy import (  # noqa: F401
    PolicyParams, PolicyState, StaticPolicy, update_threshold,
)
from repro_torch.core.tiering import (  # noqa: F401
    TierParams, TierState, tier_init, touch, promote, migrate_data,
    drain_period_stats, lookup,
)
from repro_torch.core.simulator import (  # noqa: F401
    MemModel, SimResult, WORKLOADS, run_sim, geomean_speedup,
)
_TIERING_EXPORTS = (
    "ResourceSpec", "TierStats", "TieredMemory", "TieredMemoryState",
    "TieredResource", "make_resource", "register_resource", "resource_kinds",
    "DaemonParams", "NeoMemDaemon",
)


def __getattr__(name: str):
    # Lazy so that ``import repro_torch.tiering`` (whose modules import
    # repro_torch.core submodules) doesn't recurse into a partially made
    # package.
    if name in _TIERING_EXPORTS:
        import repro_torch.tiering as _tm
        return getattr(_tm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
