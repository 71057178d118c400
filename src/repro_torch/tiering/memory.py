"""TieredMemory — profiling + placement for ONE resource.

Port of ``repro/tiering/memory.py`` on the synchronous data plane.  All
device-resident state (NeoProf sketch/buffers, TieredStore placement,
Algorithm-1 scalars) lives in one :class:`TieredMemoryState` threaded
through pure functions:

  * :func:`observe` / :func:`lookup` — run beside the model step (the device
    side: NeoProf snoop + tier hit accounting);
  * the :class:`TieredMemory` verbs — host side, the daemon cadences
    (migration << threshold-update <= clear, paper §V).

The host keeps the overflow queue of hot pages awaiting quota (a numpy
FIFO), the :class:`~repro_torch.tiering.stats.TierStats` accumulator and,
once payload is bound, the :class:`~repro_torch.tiering.migrate.TierBuffers`.
The reference's asynchronous plane (issue/commit epochs) is not yet ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import tiering
from repro_torch.core.neoprof import (NeoProfCommands, NeoProfParams,
                                      NeoProfState, neoprof_init,
                                      neoprof_observe)
from repro_torch.core.policy import PolicyParams, PolicyState
from repro_torch.core.policy import update_threshold as _algorithm1
from repro_torch.core.tiering import TierParams, TierState
from repro_torch.tiering import codec as codec_lib
from repro_torch.tiering import migrate as migrate_lib
from repro_torch.tiering.stats import TierStats, drain_tier_stats
from repro_torch.tiering.stats import hit_rate as _hit_rate

MAX_PENDING = 1 << 14        # overflow queue bound (pages awaiting quota)


@dataclasses.dataclass
class DaemonParams:
    """Cadence hierarchy (DESIGN.md §1.3): migration ticks are the base rate.

    ``quota_pages=None`` resolves context-dependently: a single-resource
    TieredMemory uses its TierParams quota; the multiplexed daemon uses the
    sum of its resources' quotas as the shared budget.
    """

    migration_interval: int = 1        # ticks between promotion batches
    threshold_update_period: int = 8   # ticks between Algorithm-1 runs
    clear_interval: int = 64           # ticks between sketch resets
    quota_pages: int | None = None     # promotion budget per interval


class TieredMemoryState(NamedTuple):
    """Everything the tiering layer knows about one resource."""

    prof: NeoProfState      # NeoProf: sketch + hot buffer + state monitor (+ θ)
    tier: TierState         # TieredStore: placement maps + 2Q bits + counters
    p: torch.Tensor         # () f32 — Algorithm-1 hot-fraction scalar
    tick: torch.Tensor      # () i32 — daemon tick counter


@dataclasses.dataclass
class MigrationEvent:
    """One promotion batch: copy slow[promoted[i]] into fast victims[i],
    after writing the slot's previous occupant ``evicted[i]`` back down."""

    promoted: torch.Tensor   # (k,) int32 page ids, -1 = no-op lane
    victims: torch.Tensor    # (k,) int32 slot ids, -1 = no-op lane
    n_promoted: int
    evicted: torch.Tensor | None = None   # (k,) int32 demoted page ids


def observe(state: TieredMemoryState, pages: torch.Tensor,
            prof_params: NeoProfParams, touch_pages: torch.Tensor | None = None,
            rd_bytes=0.0, wr_bytes=0.0, budget_bytes=0.0) -> TieredMemoryState:
    """Device-side step: NeoProf snoop + tier hit/2Q accounting.
    ``touch_pages`` accounts hits on another (capped) stream than ``pages``."""
    prof = neoprof_observe(state.prof, pages, prof_params, rd_bytes=rd_bytes,
                           wr_bytes=wr_bytes, budget_bytes=budget_bytes)
    tier = tiering.touch(state.tier, pages if touch_pages is None else touch_pages)
    return state._replace(prof=prof, tier=tier)


def lookup(state: TieredMemoryState, page_ids: torch.Tensor):
    """(fast-slot or -1, hit mask) for a batch of page ids."""
    return tiering.lookup(state.tier, page_ids)


class TieredMemory:
    """Facade owning the params + host-side daemon verbs for one resource."""

    def __init__(self, prof_params: NeoProfParams, tier_params: TierParams,
                 daemon_params: DaemonParams | None = None,
                 policy_params: PolicyParams | None = None,
                 fixed_theta: int | None = None, *, device="cuda"):
        self.pp = prof_params
        self.tp = tier_params
        self.dp = daemon_params or DaemonParams()
        self.device = torch.device(device)
        self.quota = (self.dp.quota_pages if self.dp.quota_pages is not None
                      else tier_params.quota_pages)
        # policy quota bound: 4x migration capacity per update period
        self.pol_params = policy_params or PolicyParams(
            m_quota_pages=4 * self.quota * max(
                1, self.dp.threshold_update_period // self.dp.migration_interval))
        self.fixed_theta = fixed_theta
        self.cmd = NeoProfCommands(prof_params)
        self._pending = np.empty((0,), np.int64)
        # migration data plane (DESIGN.md §8) — absent until bind_data
        self.spec = None
        self.buffers: migrate_lib.TierBuffers | None = None
        self.codec = "none"
        self.row_bytes = 0           # WIRE bytes per page once data is bound
        self.quota_bytes = 0
        self.written: np.ndarray | None = None   # per-page write witness

    @classmethod
    def from_spec(cls, spec, daemon_params=None, policy_params=None,
                  fixed_theta=None, *, device="cuda") -> "TieredMemory":
        mem = cls(spec.prof_params(), spec.tier_params(),
                  daemon_params=daemon_params, policy_params=policy_params,
                  fixed_theta=fixed_theta, device=device)
        mem.spec = spec
        mem.codec = codec_lib.check_codec(spec.slow_codec)
        return mem

    # -- data plane (DESIGN.md §8) -------------------------------------------
    def bind_data(self, slow_data: torch.Tensor, initially_valid: bool = True,
                  codec: str | None = None) -> None:
        """Attach payload buffers: ``slow_data`` is (num_pages, *row_shape)
        in the resource's native dtype.  ``initially_valid=False`` starts
        every page un-witnessed (the zero-filled KV scratch store)."""
        if slow_data.shape[0] != self.tp.num_pages:
            raise ValueError(
                f"slow_data has {slow_data.shape[0]} pages, tier declares "
                f"{self.tp.num_pages}")
        if self.spec is not None and self.spec.row_shape is not None:
            want = (tuple(self.spec.row_shape), self.spec.dtype)
            got = (tuple(slow_data.shape[1:]), slow_data.dtype)
            if want != got:
                raise ValueError(
                    f"slow_data rows {got} != ResourceSpec declaration {want}")
        if codec is not None:
            self.codec = codec_lib.check_codec(codec)
        self.buffers = migrate_lib.init_buffers(
            slow_data, self.tp.num_slots, codec=self.codec, device=self.device)
        self.row_bytes = migrate_lib.row_bytes(self.buffers)
        self.quota_bytes = 2 * self.quota * self.row_bytes
        self.written = np.full(self.tp.num_pages, bool(initially_valid))

    def apply_migration(self, event: MigrationEvent | None,
                        stats: TierStats) -> int:
        """Execute one epoch's data movement; returns and meters the wire
        bytes moved (promotions + demotion write-backs)."""
        if self.buffers is None or event is None:
            return 0
        evicted = (event.evicted if event.evicted is not None
                   else torch.full_like(event.victims, -1))
        t0 = time.perf_counter()
        self.buffers, n_up, n_down = migrate_lib.migrate(
            self.buffers, event.promoted, event.victims, evicted,
            codec=self.codec)
        # the synchronous plane stops the world until the copy has landed
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.stall_s += time.perf_counter() - t0
        moved = (n_up + n_down) * self.row_bytes
        stats.migration_bytes += moved
        stats.last_epoch_bytes = moved
        stats.max_epoch_bytes = max(stats.max_epoch_bytes, moved)
        stats.quota_bytes = self.quota_bytes
        if moved:
            stats.migration_epochs += 1
        return moved

    def lookup_slots(self, state: TieredMemoryState, page_ids) -> torch.Tensor:
        """Placement lookup against the live table."""
        ps = state.tier.page_slot
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=ps.device)
        return torch.where(ids >= 0, ps[ids.clamp_min(0)], -1)

    def _require_data(self) -> None:
        if self.buffers is None:
            raise ValueError("no payload bound — call bind_data() first")

    def lookup_rows(self, state: TieredMemoryState, page_ids) -> torch.Tensor:
        """Placement-table gather over the bound buffers, slow fallback."""
        self._require_data()
        return migrate_lib.lookup_rows(self.buffers.fast, self.buffers.slow,
                                       state.tier.page_slot, page_ids)

    def tier_view(self, state: TieredMemoryState) -> dict:
        """``{"fast", "slow", "page_slot", "scale"}`` for in-step readers."""
        self._require_data()
        return {"fast": self.buffers.fast, "slow": self.buffers.slow,
                "page_slot": state.tier.page_slot, "scale": self.buffers.scale}

    def read_rows(self, state: TieredMemoryState, page_ids,
                  slots: torch.Tensor | None = None) -> torch.Tensor:
        """Serve page payloads: fast-tier copy on hit, slow-tier fallback."""
        self._require_data()
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=self.device)
        if slots is None:
            slots = self.lookup_slots(state, ids)
        return migrate_lib.read_rows(self.buffers.fast, self.buffers.slow,
                                     slots, ids)

    def write_rows(self, state: TieredMemoryState, page_ids, rows) -> int:
        """Refresh page payloads in both tiers; returns the rows written."""
        self._require_data()
        slots = self.lookup_slots(state, page_ids)
        self.buffers = migrate_lib.write_rows(self.buffers, page_ids, slots,
                                              rows, codec=self.codec)
        return self._mark_written(page_ids)

    def write_pages(self, state: TieredMemoryState, page_ids, k_pages,
                    v_pages) -> int:
        """Bulk KV ring-page flush: ``k_pages`` / ``v_pages`` are
        (G, L, S, T, hkv, d) ring views, ``page_ids`` the (L*S,) slot map
        (-1 = dropped).  Returns the pages written."""
        self._require_data()
        slots = self.lookup_slots(state, page_ids)
        self.buffers = migrate_lib.write_pages(self.buffers, page_ids, slots,
                                               k_pages, v_pages, codec=self.codec)
        return self._mark_written(page_ids)

    def _mark_written(self, page_ids) -> int:
        ids = np.asarray(torch.as_tensor(page_ids).cpu())
        ids = ids[ids >= 0]
        if self.written is not None and ids.size:
            self.written[ids] = True
        return int(ids.size)

    def pages_written(self, page_ids) -> np.ndarray:
        """Per-page write witness (invalid ids report False)."""
        if self.written is None:
            raise ValueError("no payload bound — call bind_data() first")
        ids = np.asarray(page_ids, np.int64)
        out = np.zeros(ids.shape, bool)
        valid = (ids >= 0) & (ids < self.written.shape[0])
        out[valid] = self.written[ids[valid]]
        return out

    # -- state ---------------------------------------------------------------
    def init(self, seeds: torch.Tensor | None = None) -> TieredMemoryState:
        """Fresh state; ``seeds`` are the sketch's (D, 30) H3 seeds."""
        prof = neoprof_init(self.pp, seeds, device=self.device)
        theta0 = (self.fixed_theta if self.fixed_theta is not None
                  else self.pol_params.theta_min)
        return TieredMemoryState(
            prof=self.cmd.set_threshold(prof, theta0),
            tier=tiering.tier_init(self.tp, device=self.device),
            p=torch.tensor(self.pol_params.p_init, dtype=torch.float32),
            tick=torch.zeros((), dtype=torch.int32),
        )

    def observe(self, state: TieredMemoryState, pages, *, touch_pages=None,
                rd_bytes=0.0, wr_bytes=0.0, budget_bytes=0.0) -> TieredMemoryState:
        return observe(state, pages, self.pp, touch_pages=touch_pages,
                       rd_bytes=rd_bytes, wr_bytes=wr_bytes,
                       budget_bytes=budget_bytes)

    def profile(self, state: TieredMemoryState, pages, *, rd_bytes=0.0,
                wr_bytes=0.0, budget_bytes=0.0) -> TieredMemoryState:
        """NeoProf snoop only (callers that account tier hits separately)."""
        return state._replace(prof=neoprof_observe(
            state.prof, pages, self.pp, rd_bytes=rd_bytes, wr_bytes=wr_bytes,
            budget_bytes=budget_bytes))

    def touch(self, state: TieredMemoryState, pages) -> TieredMemoryState:
        """Tier hit/2Q accounting only."""
        return state._replace(tier=tiering.touch(state.tier, pages))

    def policy_state(self, state: TieredMemoryState,
                     stats: TierStats | None = None) -> PolicyState:
        """Reconstruct the Algorithm-1 view from the state (+ telemetry)."""
        def last(tr, d):
            return tr[-1] if stats is not None and tr else d
        return PolicyState(
            p=float(state.p), theta=int(state.prof.theta),
            last_B=last(stats.bw_trace if stats else [], 0.0),
            last_P=last(stats.pp_trace if stats else [], 0.0),
            last_E=int(last(stats.err_trace if stats else [], 0)),
        )

    def hit_rate(self, state: TieredMemoryState, stats: TierStats) -> float:
        return _hit_rate(state.tier, stats)

    # -- daemon verbs (host side) ---------------------------------------------
    def collect(self, state: TieredMemoryState,
                stats: TierStats) -> tuple[TieredMemoryState, int]:
        """Drain NeoProf's hot buffer into the pending FIFO; return demand."""
        prof, hot = self.cmd.drain_hotpages(state.prof)
        self.enqueue(hot)
        stats.pending = len(self._pending)
        return state._replace(prof=prof), len(self._pending)

    def clear_pending(self) -> None:
        """Drop the host-side overflow queue."""
        self._pending = np.empty((0,), np.int64)

    def enqueue(self, pages) -> None:
        """Queue externally-detected hot pages (baseline profilers, tests)."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(pages, np.int64)])[: 4 * MAX_PENDING]

    def migrate(self, state: TieredMemoryState, stats: TierStats,
                quota: int | None = None,
                ) -> tuple[TieredMemoryState, MigrationEvent | None]:
        """Promote up to ``quota`` pending pages (batch width stays ``quota``)."""
        k = self.quota
        stats.last_epoch_bytes = 0  # an epoch that moves nothing reports 0
        take = min(quota if quota is not None else k, k, len(self._pending))
        if take <= 0:
            stats.pending = len(self._pending)
            return state, None
        batch = np.full((k,), -1, np.int32)
        batch[:take] = self._pending[:take]
        self._pending = self._pending[take:][:MAX_PENDING]
        old_slot_page = state.tier.slot_page
        tier, promoted, victims = tiering.promote(
            state.tier, torch.as_tensor(batch), k)
        # the page each victim slot held BEFORE this batch — the demotion
        # write-back targets for the data plane
        evicted = torch.where(victims >= 0,
                              old_slot_page[victims.clamp_min(0).long()], -1)
        n = int((promoted >= 0).sum())
        stats.migrated_this_period += n
        stats.pending = len(self._pending)
        return state._replace(tier=tier), MigrationEvent(promoted, victims, n,
                                                         evicted=evicted)

    def drain(self, state: TieredMemoryState,
              stats: TierStats) -> TieredMemoryState:
        """Drain tier period counters into stats (the one shared code path)."""
        return state._replace(tier=drain_tier_stats(state.tier, stats))

    def update_threshold(self, state: TieredMemoryState,
                         stats: TierStats) -> TieredMemoryState:
        """One Algorithm-1 period: read NeoProf, drain stats, retune θ."""
        hist = self.cmd.get_hist(state.prof)
        bw = self.cmd.bandwidth_util(state.prof)
        err = self.cmd.get_error_bound(state.prof, hist)
        state = self.drain(state, stats)
        period = stats.last_period
        # Laplace-damped: a single bounce at low volume must not crash p
        pp_ratio = float(period["ping_pong"]) / max(
            int(period["promoted"]), self.quota // 2, 1)
        if self.fixed_theta is None:
            # M = migration DEMAND (migrated + still-queued)
            demand = stats.migrated_this_period + len(self._pending)
            pol = _algorithm1(
                PolicyState(p=float(state.p), theta=int(state.prof.theta)),
                self.pol_params, hist, bandwidth_util=bw,
                ping_pong_ratio=pp_ratio, migrated_pages=demand,
                error_bound=err)
            state = state._replace(
                prof=self.cmd.set_threshold(state.prof, pol.theta),
                p=torch.tensor(pol.p, dtype=torch.float32))
        stats.migrated_this_period = 0
        stats.theta_trace.append(int(state.prof.theta))
        stats.bw_trace.append(float(bw))
        stats.pp_trace.append(pp_ratio)
        stats.err_trace.append(int(err))
        stats.p_trace.append(float(state.p))
        return state

    def clear(self, state: TieredMemoryState) -> TieredMemoryState:
        return state._replace(prof=self.cmd.reset(state.prof))

    def tick(self, state: TieredMemoryState, stats: TierStats,
             ) -> tuple[TieredMemoryState, MigrationEvent | None]:
        """Single-resource cadence driver (the multiplexed daemon drives the
        verbs itself so it can split the quota budget across resources)."""
        state = state._replace(tick=state.tick + 1)
        t, dp, event = int(state.tick), self.dp, None
        if t % dp.migration_interval == 0:
            state, _ = self.collect(state, stats)
            state, event = self.migrate(state, stats)
            self.apply_migration(event, stats)
        if t % dp.threshold_update_period == 0:
            state = self.update_threshold(state, stats)
        if t % dp.clear_interval == 0:
            state = self.clear(state)
        return state, event
