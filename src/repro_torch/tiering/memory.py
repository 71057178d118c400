"""TieredMemory — profiling + placement for ONE resource.

Port of ``repro/tiering/memory.py``.  All device-resident state (NeoProf
sketch/buffers, TieredStore placement, Algorithm-1 scalars) lives in one
:class:`TieredMemoryState` threaded through pure functions:

  * :func:`observe` / :func:`lookup` — run beside the model step (the device
    side: NeoProf snoop + tier hit accounting);
  * the :class:`TieredMemory` verbs — host side, the daemon cadences
    (migration << threshold-update <= clear, paper §V).

The host keeps the overflow queue of hot pages awaiting quota (a numpy
FIFO), the :class:`~repro_torch.tiering.stats.TierStats` accumulator and,
once payload is bound, the :class:`~repro_torch.tiering.migrate.TierBuffers`
in the resource's slow-tier wire format (:mod:`repro_torch.tiering.codec`);
``row_bytes`` and every byte meter count wire bytes.  Under the
asynchronous plane (DESIGN.md §15, ``DaemonParams.async_plane``) an epoch
is issued on a side CUDA stream and committed at a later tick once its
token is ready; reads resolve against the committed placement table until
then (:mod:`repro_torch.tiering.migrate` says how the rows are staged).
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
    # Asynchronous data plane (DESIGN.md §15): epochs are ISSUED on a side
    # stream and COMMITTED at a later tick, once the copy's readiness token
    # is witnessed — decode keeps reading the previous epoch's committed
    # placement in between.
    async_plane: bool = False


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


@dataclasses.dataclass
class InFlightEpoch:
    """One issued-but-uncommitted migration epoch (DESIGN.md §15).

    ``rows`` are the epoch's promoted rows, decoded, staged for the victim
    fast slots ``slots``; ``slot_row`` maps a fast slot to its staging row
    (-1 elsewhere).  ``page_slot`` is the placement table the epoch was
    built against (the control state already points at it — reads resolve
    against the previous committed table until the commit).  ``token`` is
    the CUDA event recorded after the copies (None on the CPU: always
    ready)."""

    rows: torch.Tensor
    slots: np.ndarray
    slot_row: np.ndarray
    page_slot: torch.Tensor
    token: object
    bytes: int


def observe(state: TieredMemoryState, pages: torch.Tensor,
            prof_params: NeoProfParams, touch_pages: torch.Tensor | None = None,
            rd_bytes=0.0, wr_bytes=0.0, budget_bytes=0.0) -> TieredMemoryState:
    """Device-side step: NeoProf snoop + tier hit/2Q accounting.
    ``touch_pages`` accounts hits on another (capped) stream than ``pages``."""
    prof = neoprof_observe(state.prof, pages, prof_params, rd_bytes=rd_bytes,
                           wr_bytes=wr_bytes, budget_bytes=budget_bytes)
    tier = tiering.touch(state.tier, pages if touch_pages is None else touch_pages)
    return state._replace(prof=prof, tier=tier)


def _ids_np(page_ids) -> np.ndarray:
    return np.asarray(torch.as_tensor(page_ids).cpu(), np.int64).reshape(-1)


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
        # async data plane (DESIGN.md §15): the issued-but-uncommitted epoch,
        # the placement table reads resolve against until it commits, and
        # the side stream its copies run on (created at the first issue)
        self._inflight: InFlightEpoch | None = None
        self._committed_slot: torch.Tensor | None = None
        self._stream = None

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

    # -- async data plane (DESIGN.md §15) ------------------------------------
    @property
    def async_on(self) -> bool:
        """Whether this resource runs the asynchronous plane."""
        return self.dp.async_plane and self.buffers is not None

    @property
    def busy(self) -> bool:
        """An epoch is issued but not yet committed — the daemon must not
        issue N+2 (and excludes this resource from the quota split)."""
        return self._inflight is not None

    def _view_slot(self, state: TieredMemoryState) -> torch.Tensor:
        """The placement table reads resolve against: the committed epoch's
        under the async plane, the live control table otherwise."""
        if self.async_on and self._committed_slot is not None:
            return self._committed_slot
        return state.tier.page_slot

    @staticmethod
    def _slots_in(ps: torch.Tensor, page_ids) -> torch.Tensor:
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=ps.device)
        return torch.where(ids >= 0, ps[ids.clamp_min(0)], -1)

    def lookup_slots(self, state: TieredMemoryState, page_ids) -> torch.Tensor:
        """Placement lookup against the committed view (the live table under
        the synchronous plane)."""
        return self._slots_in(self._view_slot(state), page_ids)

    def _side_stream(self):
        if self.buffers.fast.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.buffers.fast.device)
        return self._stream

    def issue_migration(self, state: TieredMemoryState,
                        event: MigrationEvent | None, stats: TierStats) -> int:
        """Issue phase: dispatch the epoch's promotion copy on the side
        stream WITHOUT blocking and record the in-flight epoch.  ``state`` is
        the post-promote control state.  Returns the epoch's wire bytes,
        metered as ``inflight_bytes`` until :meth:`commit_migration` folds
        them into the lifetime counters.  The demotion write-back is elided
        (every fast row already has an identical slow copy) but its bytes
        are still metered."""
        if self.buffers is None or event is None:
            return 0
        if self._inflight is not None:
            raise RuntimeError(
                "migration epoch already in flight — commit (or drop) epoch "
                "N+1 before issuing N+2")
        promoted, victims = _ids_np(event.promoted), _ids_np(event.victims)
        ok = (promoted >= 0) & (victims >= 0)
        n_down = (int(np.sum(ok & (_ids_np(event.evicted) >= 0)))
                  if event.evicted is not None else 0)
        rows, slots, token = migrate_lib.issue_migrate(
            self.buffers, promoted, victims, stream=self._side_stream())
        slot_row = np.full(self.tp.num_slots, -1, np.int64)
        slot_row[slots] = np.arange(slots.size)
        moved = (int(ok.sum()) + n_down) * self.row_bytes
        self._inflight = InFlightEpoch(rows=rows, slots=slots, slot_row=slot_row,
                                       page_slot=state.tier.page_slot,
                                       token=token, bytes=moved)
        stats.inflight_bytes = moved
        stats.quota_bytes = self.quota_bytes
        return moved

    def commit_ready(self) -> bool:
        """Non-blocking probe: has the in-flight epoch's copy landed?"""
        return (self._inflight is not None
                and migrate_lib.token_ready(self._inflight.token))

    def commit_migration(self, stats: TierStats, block: bool = False) -> int:
        """Commit phase: land the in-flight epoch's rows in the fast buffer
        (after its token, on the compute stream), swap its table into the
        committed view and fold its bytes into the lifetime counters.
        Without ``block`` this is a no-op unless the token is already ready
        — it never waits; ``block=True`` forces the commit (checkpoint
        finalize) and meters the wait as ``stall_s``."""
        fl = self._inflight
        if fl is None:
            return 0
        if not migrate_lib.token_ready(fl.token):
            if not block:
                return 0
            t0 = time.perf_counter()
            migrate_lib.wait_token(fl.token)
            stats.stall_s += time.perf_counter() - t0
        migrate_lib.commit_rows(self.buffers.fast, fl.rows, fl.slots, fl.token)
        self._committed_slot = fl.page_slot
        self._inflight = None
        moved = fl.bytes
        stats.inflight_bytes = 0
        stats.migration_bytes += moved
        stats.last_epoch_bytes = moved
        stats.max_epoch_bytes = max(stats.max_epoch_bytes, moved)
        stats.quota_bytes = self.quota_bytes
        if moved:
            stats.migration_epochs += 1
        return moved

    def finalize_epoch(self, stats: TierStats) -> int:
        """Force-commit any in-flight epoch (checkpoint save: the persisted
        placement map is the control table, so the payload must match)."""
        return self.commit_migration(stats, block=True)

    def drop_inflight(self, stats: TierStats | None = None) -> None:
        """Abandon the in-flight epoch (checkpoint restore: the issued copy
        belongs to the pre-restore placement stream).  Its staged rows are
        freed once the side stream is done with them."""
        self._inflight = None
        if stats is not None:
            stats.inflight_bytes = 0

    def reset_committed(self, state: TieredMemoryState) -> None:
        """Align the committed view with the control state (restore path):
        no epoch is in flight and decode reads the live table."""
        self._inflight = None
        self._committed_slot = (state.tier.page_slot if self.async_on
                                else None)

    def dispatch_migration(self, state: TieredMemoryState,
                           event: MigrationEvent | None, stats: TierStats) -> int:
        """Route one epoch's data movement: async issue or sync apply."""
        if self.async_on:
            return self.issue_migration(state, event, stats)
        return self.apply_migration(event, stats)

    def _inflight_slots(self, page_ids) -> torch.Tensor:
        return self._slots_in(self._inflight.page_slot, page_ids)

    def refill_fast(self, state: TieredMemoryState) -> None:
        """Re-read the fast copy of every resident page from the slow store.

        Used after restoring a checkpointed placement map (DESIGN.md §6):
        the restored ``TierState`` says which pages are resident, but the
        fast buffer holds the pre-restore rows — without the refill,
        ``read_rows`` would serve stale rows for pages the map calls hits.
        A no-op when no payload is bound.  A page id past the store reads
        its last row (ROADMAP C4)."""
        if self.buffers is None:
            return
        # a restored store is assumed fully materialized: the write witnesses
        # that produced it did not survive the checkpoint, the payload did
        if self.written is not None:
            self.written[:] = True
        slot_page = _ids_np(state.tier.slot_page)
        occupied = np.flatnonzero(slot_page >= 0)
        if occupied.size == 0:
            return
        migrate_lib.fill_slots(self.buffers, occupied, slot_page[occupied])

    def _require_data(self) -> None:
        if self.buffers is None:
            raise ValueError("no payload bound — call bind_data() first")

    def lookup_rows(self, state: TieredMemoryState, page_ids) -> torch.Tensor:
        """Placement-table gather over the bound buffers, slow fallback."""
        self._require_data()
        return migrate_lib.lookup_rows(self.buffers.fast, self.buffers.slow,
                                       self._view_slot(state), page_ids,
                                       scale=self.buffers.scale)

    def tier_view(self, state: TieredMemoryState) -> dict:
        """``{"fast", "slow", "page_slot", "scale"}`` for in-step readers
        (``scale`` is None except under the ``int8`` codec)."""
        self._require_data()
        return {"fast": self.buffers.fast, "slow": self.buffers.slow,
                "page_slot": self._view_slot(state), "scale": self.buffers.scale}

    def read_rows(self, state: TieredMemoryState, page_ids,
                  slots: torch.Tensor | None = None) -> torch.Tensor:
        """Serve page payloads: fast-tier copy on hit, slow-tier fallback
        (decoded on the device from its wire format)."""
        self._require_data()
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=self.device)
        if slots is None:
            slots = self.lookup_slots(state, ids)
        return migrate_lib.read_rows(self.buffers.fast, self.buffers.slow,
                                     slots, ids, scale=self.buffers.scale)

    def write_rows(self, state: TieredMemoryState, page_ids, rows) -> int:
        """Refresh page payloads in both tiers; returns the rows written."""
        self._require_data()
        slots = self.lookup_slots(state, page_ids)
        self.buffers = migrate_lib.write_rows(self.buffers, page_ids, slots,
                                              rows, codec=self.codec)
        fl = self._inflight
        if fl is not None:
            # replay onto the in-flight epoch under ITS table, so a page it
            # promotes does not keep a stale row past the commit (§15)
            migrate_lib.refresh_rows(fl.rows, fl.slot_row,
                                     self._inflight_slots(page_ids), rows,
                                     self._stream, fl.token)
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
        fl = self._inflight
        if fl is not None:
            migrate_lib.refresh_pages(fl.rows, fl.slot_row,
                                      self._inflight_slots(page_ids), k_pages,
                                      v_pages, self._stream, fl.token)
        return self._mark_written(page_ids)

    def copy_rows(self, state: TieredMemoryState, src_ids, dst_ids) -> int:
        """Duplicate page payloads store to store in their wire format (the
        content-addressed publish verb); returns the pages copied."""
        self._require_data()
        src, dst = _ids_np(src_ids), _ids_np(dst_ids)
        self.buffers = migrate_lib.copy_rows(self.buffers, src, dst,
                                             self.lookup_slots(state, dst))
        fl = self._inflight
        if fl is not None:
            migrate_lib.refresh_copy(fl.rows, fl.slot_row, self.buffers, src,
                                     self._inflight_slots(dst), self._stream,
                                     fl.token)
        valid = (src >= 0) & (dst >= 0)
        if self.written is not None:
            self.written[dst[valid]] = True
        return int(valid.sum())

    def _mark_written(self, page_ids) -> int:
        ids = _ids_np(page_ids)
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
        if self.async_on:
            # first promote under the async plane: the pre-promote table is
            # epoch 0's committed view — from here on the control table runs
            # ahead of what reads resolve against until each commit
            if self._committed_slot is None:
                self._committed_slot = state.tier.page_slot
        else:
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
            if self.async_on:
                self.commit_migration(stats)   # commit FIRST, never blocks
            state, _ = self.collect(state, stats)
            if not self.busy:                  # no N+2 issue before N+1 commit
                state, event = self.migrate(state, stats)
                self.dispatch_migration(state, event, stats)
        if t % dp.threshold_update_period == 0:
            state = self.update_threshold(state, stats)
        if t % dp.clear_interval == 0:
            state = self.clear(state)
        return state, event
