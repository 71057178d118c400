"""Multiplexed NeoMem daemon: one cadence, N tiered resources, one budget.

Port of ``repro/tiering/daemon.py``.  The owner (the serve engine)
registers each resource once, and one host-side loop drives all of them on
the shared cadence hierarchy

    migration  <<  threshold-update  <=  sketch-clear

with ONE migration-quota budget per interval, split across resources in
proportion to their servable queued demand (:func:`split_quota`).
Resources with bound payload buffers get each epoch's promotion batch
applied through the migration data plane, with the moved bytes metered:
at once under the synchronous plane, or issued on a side stream and
committed at a later tick under the asynchronous one (DESIGN.md §15).
:meth:`NeoMemDaemon.state_dict` / :meth:`NeoMemDaemon.load_state`
checkpoint every resource's state (DESIGN.md §6), committing or dropping
an in-flight epoch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ckpt.manager import tree_leaves, tree_structure, tree_unflatten
from repro_torch.tiering.memory import (DaemonParams, MigrationEvent,
                                        TieredMemory, TieredMemoryState, lookup)
from repro_torch.tiering.resource import TieredResource
from repro_torch.tiering.stats import TierStats


def split_quota(budget: int, demands: dict[str, int],
                caps: dict[str, int] | None = None,
                weights: dict[str, float] | None = None) -> dict[str, int]:
    """Largest-remainder proportional split of the shared migration budget.

    ``caps`` bounds each share by what that resource can actually promote in
    one batch (its static quota width) — un-servable backlog must not draw
    budget away from resources that could use it.

    ``weights`` are isolation weights (default 1.0 each, DESIGN.md §9): when
    the budget binds, shares are proportional to ``weight x servable demand``
    and any share that would exceed its own demand is clamped there, with the
    freed budget redistributed among the rest (weighted max-min).  An entry
    with weight <= 0 is isolated out entirely under contention — it only
    receives budget when the total demand fits.  The same split serves two
    layers: the daemon's per-resource migration budget and the request
    scheduler's per-tenant decode-lane allocation (serve/sched.py).
    """
    eff = {n: min(d, caps[n]) if caps else d for n, d in demands.items()}
    total = sum(eff.values())
    if total <= budget:
        return eff
    w = {n: 1.0 if weights is None else float(weights.get(n, 1.0))
         for n in eff}
    shares = {n: 0 for n in eff}
    open_ = [n for n in eff if eff[n] > 0 and w[n] > 0]
    remaining = budget
    while open_ and remaining > 0:
        tot = sum(w[n] * eff[n] for n in open_)
        exact = {n: remaining * w[n] * eff[n] / tot for n in open_}
        clamped = [n for n in open_ if exact[n] >= eff[n]]
        if not clamped:
            for n in open_:
                shares[n] = int(exact[n])
            leftover = remaining - sum(shares[n] for n in open_)
            for n in sorted(open_, key=lambda n: exact[n] - shares[n],
                            reverse=True):
                if leftover <= 0:
                    break
                shares[n] += 1   # stays <= eff[n]: exact < eff, eff integral
                leftover -= 1
            break
        for n in clamped:            # demand-bound: give it all, redistribute
            shares[n] = eff[n]
            remaining -= eff[n]
        open_ = [n for n in open_ if n not in clamped]
    return shares


class ResourceHandle:
    """A registered resource's live view: state + stats + encoder."""

    def __init__(self, name: str, resource: TieredResource, mem: TieredMemory,
                 weight: float = 1.0, seeds: torch.Tensor | None = None):
        self.name = name
        self.resource = resource
        self.mem = mem
        self.weight = weight          # isolation weight in the quota split
        self.state = mem.init(seeds)
        self.stats = TierStats(name=name)

    def observe(self, *observation, **kw) -> None:
        """Encode a model-side observation and feed profiler + tier."""
        stream = self.resource.encode_stream(*observation)
        cap = self.resource.spec.touch_cap
        self.state = self.mem.observe(self.state, stream,
                                      touch_pages=stream[:cap], **kw)

    def observe_pages(self, pages, *, touch_pages=None, **kw) -> None:
        """Feed an already-encoded page-id stream (bypasses the encoder)."""
        self.state = self.mem.observe(self.state, pages,
                                      touch_pages=touch_pages, **kw)

    def lookup(self, page_ids):
        return lookup(self.state, page_ids)

    # -- data plane (DESIGN.md §8) -------------------------------------------
    def bind_data(self, slow_data, initially_valid: bool = True) -> None:
        """Attach the resource's payload; promotions then move real bytes."""
        self.mem.bind_data(slow_data, initially_valid=initially_valid)
        self.stats.quota_bytes = self.mem.quota_bytes

    def pages_written(self, page_ids) -> np.ndarray:
        return self.mem.pages_written(page_ids)

    def tier_view(self) -> dict:
        return self.mem.tier_view(self.state)

    def lookup_rows(self, page_ids) -> torch.Tensor:
        return self.mem.lookup_rows(self.state, page_ids)

    def read_rows(self, page_ids) -> torch.Tensor:
        """Serve payload rows (fast copy on hit, slow fallback), metering the
        served reads into ``stats.fast_reads`` / ``slow_reads``.  The one
        placement lookup is against the committed view, so a read issued
        mid-epoch resolves as its payload gather does."""
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=self.mem.device)
        slots = self.mem.lookup_slots(self.state, ids)
        hits = int((slots >= 0).sum())
        self.stats.fast_reads += hits
        self.stats.slow_reads += int((ids >= 0).sum()) - hits
        return self.mem.read_rows(self.state, ids, slots=slots)

    def write_rows(self, page_ids, rows) -> None:
        """Owner payload refresh, both tiers kept coherent; bytes metered."""
        n = self.mem.write_rows(self.state, page_ids, rows)
        self.stats.flush_bytes += n * self.mem.row_bytes

    def write_pages(self, page_ids, k_pages, v_pages) -> None:
        """Bulk KV ring-page flush; bytes metered."""
        n = self.mem.write_pages(self.state, page_ids, k_pages, v_pages)
        self.stats.flush_bytes += n * self.mem.row_bytes

    def copy_rows(self, src_ids, dst_ids) -> None:
        """Store-to-store page copy in the wire format (the content-addressed
        publish verb); bytes metered as flush traffic."""
        n = self.mem.copy_rows(self.state, src_ids, dst_ids)
        self.stats.flush_bytes += n * self.mem.row_bytes

    def hit_rate(self) -> float:
        return self.mem.hit_rate(self.state, self.stats)

    def snapshot(self) -> dict:
        row = self.stats.as_row()
        # merge the not-yet-drained period counters, as hit_rate() does
        row["fast_reads"] += int(self.state.tier.fast_reads)
        row["slow_reads"] += int(self.state.tier.slow_reads)
        row["hit_rate"] = self.hit_rate()
        # fold the in-flight epoch the same way: its issued bytes count
        # against the epoch quota the moment they are in flight, so a row
        # taken mid-epoch keeps last <= max <= quota
        if self.stats.inflight_bytes:
            row["max_epoch_bytes"] = max(row["max_epoch_bytes"],
                                         self.stats.inflight_bytes)
        return row


class NeoMemDaemon:
    """One daemon loop multiplexed across every registered tiered resource."""

    def __init__(self, params: DaemonParams | None = None, *, device="cuda"):
        self.dp = params or DaemonParams()
        self.device = torch.device(device)
        self.resources: dict[str, ResourceHandle] = {}
        self._tick = 0

    def register(self, resource: TieredResource, *, policy_params=None,
                 fixed_theta=None, weight: float = 1.0,
                 seeds: torch.Tensor | None = None) -> ResourceHandle:
        """Register a resource; its ResourceSpec is the single sizing source.
        ``seeds`` are its sketch's (D, 30) H3 seeds (default: drawn from a
        generator seeded with 0)."""
        spec = resource.spec
        if spec.name in self.resources:
            raise ValueError(f"resource {spec.name!r} already registered")
        mem = TieredMemory.from_spec(
            spec, daemon_params=DaemonParams(
                migration_interval=self.dp.migration_interval,
                threshold_update_period=self.dp.threshold_update_period,
                clear_interval=self.dp.clear_interval,
                quota_pages=spec.quota_pages,
                async_plane=self.dp.async_plane),
            policy_params=policy_params, fixed_theta=fixed_theta,
            device=self.device)
        handle = ResourceHandle(spec.name, resource, mem, weight=weight,
                                seeds=seeds)
        self.resources[spec.name] = handle
        return handle

    def __getitem__(self, name: str) -> ResourceHandle:
        return self.resources[name]

    def __contains__(self, name: str) -> bool:
        return name in self.resources

    def observe(self, name: str, *observation, **kw) -> None:
        self.resources[name].observe(*observation, **kw)

    @property
    def budget(self) -> int:
        """Shared promotion budget per migration interval."""
        if self.dp.quota_pages is not None:
            return self.dp.quota_pages
        return sum(h.mem.quota for h in self.resources.values())

    def tick(self) -> dict[str, MigrationEvent]:
        """One daemon tick: run whatever cadences are due, for ALL resources."""
        self._tick += 1
        t, dp = self._tick, self.dp
        events: dict[str, MigrationEvent] = {}
        if t % dp.migration_interval == 0:
            # COMMIT (async plane): land every epoch whose token is ready —
            # never blocks; an epoch whose copy has not landed stays in flight
            for h in self.resources.values():
                if h.mem.async_on:
                    h.mem.commit_migration(h.stats)
            # PLAN: drain hot pages, split the shared budget; a busy resource
            # is capped at 0 (no N+2 issue before N+1 commits) and its share
            # flows to the others
            demands: dict[str, int] = {}
            for name, h in self.resources.items():
                h.state, demands[name] = h.mem.collect(h.state, h.stats)
            caps = {n: (0 if h.mem.busy else h.mem.quota)
                    for n, h in self.resources.items()}
            weights = {n: h.weight for n, h in self.resources.items()}
            shares = split_quota(self.budget, demands, caps, weights)
            # ISSUE: promote, then move the bytes (async: issue on the side
            # stream; sync: the blocking copy, metered as stall_s)
            for name, h in self.resources.items():
                if h.mem.busy:
                    continue
                h.state, event = h.mem.migrate(h.state, h.stats,
                                               quota=shares.get(name, 0))
                if event is not None:
                    h.mem.dispatch_migration(h.state, event, h.stats)
                    h.resource.apply_migration(event.promoted, event.victims)
                    events[name] = event
        if t % dp.threshold_update_period == 0:
            for h in self.resources.values():
                h.state = h.mem.update_threshold(h.state, h.stats)
        if t % dp.clear_interval == 0:
            for h in self.resources.values():
                h.state = h.mem.clear(h.state)
        return events

    # -- checkpointing (DESIGN.md §6) ----------------------------------------
    def state_dict(self) -> dict[str, TieredMemoryState]:
        """Every resource's TieredMemoryState, for ``ckpt/manager.py``; a
        restored server resumes with a warm placement map.  The pending
        FIFOs are best-effort and not included.  Any in-flight epoch is
        FINALIZED first: the persisted placement map is the control table,
        so the payload it implies must match it (DESIGN.md §15)."""
        self.finalize()
        return {n: h.state for n, h in self.resources.items()}

    def finalize(self) -> None:
        """Force-commit every in-flight epoch (checkpoint save, end-of-run
        byte accounting, shutdown)."""
        for h in self.resources.values():
            h.mem.finalize_epoch(h.stats)

    def load_state(self, states: dict[str, TieredMemoryState]) -> None:
        """Restore a :meth:`state_dict` into the registered resources.

        Structure and leaf shapes must match the registered geometry.  The
        pending backlog and any in-flight epoch belong to the pre-restore
        stream and are DROPPED (the other half of §15's commit-or-drop),
        and the fast copy of every resident page is re-read from the slow
        store, so the restored map never serves a stale fast row."""
        for name, st in states.items():
            if name not in self.resources:
                raise KeyError(f"state for unregistered resource {name!r}")
            h = self.resources[name]
            if tree_structure(st) != tree_structure(h.state):
                raise ValueError(
                    f"{name}: checkpointed state structure does not match")
            cur, new = tree_leaves(h.state), tree_leaves(st)
            for c, n in zip(cur, new):
                if tuple(np.shape(c)) != tuple(np.shape(n)):
                    raise ValueError(
                        f"{name}: leaf shape {tuple(np.shape(n))} != registered "
                        f"geometry {tuple(np.shape(c))}")
            h.state = tree_unflatten(h.state, [
                (n if isinstance(n, torch.Tensor) else torch.from_numpy(
                    np.array(n))).to(c.device, c.dtype)
                for c, n in zip(cur, new)])
            h.mem.clear_pending()
            h.stats.pending = 0
            h.mem.drop_inflight(h.stats)
            h.mem.refill_fast(h.state)
            h.mem.reset_committed(h.state)

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict[str, TierStats]:
        return {n: h.stats for n, h in self.resources.items()}

    def snapshot(self) -> dict[str, dict]:
        """Per-resource flat telemetry rows (benchmark / logging schema)."""
        return {n: h.snapshot() for n, h in self.resources.items()}
