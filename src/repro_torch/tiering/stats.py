"""Unified per-resource tiering telemetry (DESIGN.md §1.4).

Port of ``repro/tiering/stats.py``.  Every consumer of the tiering layer
drains the TieredStore's period counters through the single code path in
:func:`drain_tier_stats`, so hit-rate / promotion / ping-pong arithmetic is
written exactly once.  A :class:`TierStats` accumulates the drained totals
plus the Fig. 14-style policy traces (θ / bandwidth / ping-pong / p).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import tiering
from repro_torch.core.tiering import TierState


@dataclasses.dataclass
class TierStats:
    """Cumulative telemetry for one tiered resource.

    ``fast_reads``/``slow_reads``/... are lifetime totals of the *drained*
    period counters; counts since the last drain still live on the device in
    ``TierState`` (use :func:`hit_rate` to merge both views).
    """

    name: str = ""
    fast_reads: int = 0
    slow_reads: int = 0
    promoted: int = 0
    demoted: int = 0
    ping_pong: int = 0
    # Migration bookkeeping within the current Algorithm-1 period.
    migrated_this_period: int = 0
    pending: int = 0               # overflow queue depth (latest snapshot)
    # Data-plane byte metering (DESIGN.md §8; zero when no buffers bound).
    migration_bytes: int = 0       # lifetime payload bytes moved (both ways)
    last_epoch_bytes: int = 0      # bytes moved by the most recent epoch
    max_epoch_bytes: int = 0       # bytes moved by the LARGEST epoch so far —
    #                                the per-epoch quota must hold across
    #                                EVERY epoch, not just the last one
    quota_bytes: int = 0           # per-epoch byte budget (2 * quota * row)
    migration_epochs: int = 0      # epochs that actually moved payload
    flush_bytes: int = 0           # owner write_rows traffic (e.g. KV flush)
    # Async data plane (DESIGN.md §15; zero in the synchronous mode).
    inflight_bytes: int = 0        # bytes of the issued-but-uncommitted epoch
    # Achieved-overlap metering (DESIGN.md §15).
    stall_s: float = 0.0           # wall time decode spent BLOCKED on a
    #                                migration copy (sync: every epoch's
    #                                fused copy; async: forced commits only)
    decode_s: float = 0.0          # decode wall time (set by the owner —
    #                                the serve engine's step-loop clock)
    # Fig. 14-style traces, appended once per threshold-update period.
    theta_trace: list = dataclasses.field(default_factory=list)
    bw_trace: list = dataclasses.field(default_factory=list)
    pp_trace: list = dataclasses.field(default_factory=list)
    err_trace: list = dataclasses.field(default_factory=list)
    p_trace: list = dataclasses.field(default_factory=list)
    # Raw period counters from the most recent drain (policy inputs).
    last_period: dict = dataclasses.field(default_factory=dict)

    @property
    def total_reads(self) -> int:
        return self.fast_reads + self.slow_reads

    @property
    def drained_hit_rate(self) -> float:
        return self.fast_reads / max(self.total_reads, 1)

    @property
    def overlap_bytes_per_decode_s(self) -> float:
        """Achieved overlap: migration bytes moved per second of decode wall
        time (DESIGN.md §15).  Zero until the owner meters ``decode_s``."""
        if self.decode_s <= 0:
            return 0.0
        return self.migration_bytes / self.decode_s

    def as_row(self) -> dict:
        """Flat schema for benchmark emission (BENCH_serve.json rows —
        documented key-by-key in benchmarks/README.md)."""
        return {
            "name": self.name,
            "fast_reads": self.fast_reads,
            "slow_reads": self.slow_reads,
            "hit_rate": self.drained_hit_rate,
            "promoted": self.promoted,
            "demoted": self.demoted,
            "ping_pong": self.ping_pong,
            "migration_bytes": self.migration_bytes,
            "last_epoch_bytes": self.last_epoch_bytes,
            "max_epoch_bytes": self.max_epoch_bytes,
            "quota_bytes": self.quota_bytes,
            "migration_epochs": self.migration_epochs,
            "flush_bytes": self.flush_bytes,
            "inflight_bytes": self.inflight_bytes,
            "stall_s": self.stall_s,
            "overlap_bytes_per_decode_s": self.overlap_bytes_per_decode_s,
        }


def drain_tier_stats(tier: TierState, stats: TierStats) -> TierState:
    """Drain the TieredStore period counters into ``stats`` (THE code path).

    Returns the tier state with period counters cleared (and reference bits
    aged, per 2Q CLOCK second-chance — see tiering.drain_period_stats).
    """
    tier, period = tiering.drain_period_stats(tier)
    stats.fast_reads += int(period["fast_reads"])
    stats.slow_reads += int(period["slow_reads"])
    stats.promoted += int(period["promoted"])
    stats.demoted += int(period["demoted"])
    stats.ping_pong += int(period["ping_pong"])
    # stash the raw period view for the caller's policy step
    stats.last_period = {k: int(v) for k, v in period.items()}
    return tier


def hit_rate(tier: TierState, stats: TierStats) -> float:
    """Lifetime fast-tier hit rate = drained totals + not-yet-drained counts."""
    f = stats.fast_reads + int(tier.fast_reads)
    s = stats.slow_reads + int(tier.slow_reads)
    return f / max(f + s, 1)


class LegacyDaemonStateView:
    """The old ``DaemonState`` attribute surface, read from a TierStats.

    Shared by the deprecation shims (``core/daemon.py``,
    ``core/adapters/base.py``) so the legacy field mapping exists once.
    """

    def __init__(self, stats: TierStats, tick_fn=None):
        self._stats = stats
        self._tick_fn = tick_fn

    @property
    def tick(self) -> int:
        return self._tick_fn() if self._tick_fn is not None else 0

    total_fast = property(lambda self: self._stats.fast_reads)
    total_slow = property(lambda self: self._stats.slow_reads)
    total_promoted = property(lambda self: self._stats.promoted)
    total_ping_pong = property(lambda self: self._stats.ping_pong)
    migrated_this_period = property(
        lambda self: self._stats.migrated_this_period)
    theta_trace = property(lambda self: self._stats.theta_trace)
    bw_trace = property(lambda self: self._stats.bw_trace)
    pp_trace = property(lambda self: self._stats.pp_trace)
