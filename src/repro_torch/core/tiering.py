"""TieredStore — two-tier page placement with promotion / 2Q demotion.

Port of ``repro/core/tiering.py``: a fixed pool of fast-tier *slots* in
front of a slow-tier *backing store* (pinned host memory on the card, a
logically separate tensor on the CPU — DESIGN.md §7).  Promotion of
NeoProf-reported hot pages under the migration quota, cold-page demotion by
a vectorised 2Q rank (free < inactive-unreferenced < inactive-ref <
active-unref < active-ref, ties by last touch, then by slot index), and the
``PG_demoted`` ping-pong flag.

The reference's out-of-bounds ``mode="drop"`` scatters are masked index
writes here (:func:`repro_torch.core.scatter.scatter_drop`), and its
``lax.top_k(-rank)`` is a stable ascending sort, which picks the same slots
on ties (the lower slot index first).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.scatter import scatter_drop


class TierParams(NamedTuple):
    num_pages: int           # logical pages in the slow tier's address space
    num_slots: int           # fast-tier capacity (pages)
    quota_pages: int = 4096  # max promotions per migration interval


class TierState(NamedTuple):
    page_slot: torch.Tensor    # (num_pages,) int32 -> slot id, -1 if slow-tier
    slot_page: torch.Tensor    # (num_slots,) int32 -> page id, -1 if free
    active: torch.Tensor       # (num_slots,) bool — 2Q list: False=A1in, True=Am
    referenced: torch.Tensor   # (num_slots,) bool — touched since last scan
    last_touch: torch.Tensor   # (num_slots,) int32 — step of last touch
    demoted: torch.Tensor      # (num_pages,) bool — PG_demoted flag
    step: torch.Tensor         # () int32
    # Period statistics (drained by the daemon each policy interval).
    promoted: torch.Tensor     # () int32
    demoted_cnt: torch.Tensor  # () int32
    ping_pong: torch.Tensor    # () int32
    slow_reads: torch.Tensor   # () int32 — page-granular slow-tier read count
    fast_reads: torch.Tensor   # () int32


def tier_init(params: TierParams, *, device="cuda") -> TierState:
    def z():
        return torch.zeros((), dtype=torch.int32, device=device)
    return TierState(
        page_slot=torch.full((params.num_pages,), -1, dtype=torch.int32,
                             device=device),
        slot_page=torch.full((params.num_slots,), -1, dtype=torch.int32,
                             device=device),
        active=torch.zeros((params.num_slots,), dtype=torch.bool, device=device),
        referenced=torch.zeros((params.num_slots,), dtype=torch.bool,
                               device=device),
        last_touch=torch.zeros((params.num_slots,), dtype=torch.int32,
                               device=device),
        demoted=torch.zeros((params.num_pages,), dtype=torch.bool, device=device),
        step=z(), promoted=z(), demoted_cnt=z(), ping_pong=z(),
        slow_reads=z(), fast_reads=z(),
    )


def touch(state: TierState, page_ids: torch.Tensor) -> TierState:
    """Record accesses: hit/miss counts + 2Q reference/A1->Am graduation."""
    page_ids = page_ids.long()
    valid = page_ids >= 0
    slots = state.page_slot[torch.where(valid, page_ids, 0)].long()
    hit = valid & (slots >= 0)
    n_slots = state.slot_page.shape[0]
    # misses write the trash row and are dropped
    idx = torch.where(hit, slots, n_slots)
    safe = torch.where(hit, slots, 0)
    # re-referenced pages graduate to the active list (2Q A1 -> Am)
    new_active = scatter_drop(state.active, idx,
                              state.referenced[safe] | state.active[safe])
    new_ref = scatter_drop(state.referenced, idx, True)
    new_lt = scatter_drop(state.last_touch, idx, state.step)
    return state._replace(
        active=new_active, referenced=new_ref, last_touch=new_lt,
        fast_reads=state.fast_reads + hit.sum(dtype=torch.int32),
        slow_reads=state.slow_reads + (valid & ~hit).sum(dtype=torch.int32),
        step=state.step + 1,
    )


def _victim_rank(state: TierState) -> torch.Tensor:
    """2Q eviction preference as a sortable key (lower = evict first).

    Class order: free(0) < A1-unref(1) < A1-ref(2) < Am-unref(3) < Am-ref(4),
    i.e. occupied slots rank 1 + 2*active + referenced; within a class the
    older last_touch evicts first.
    """
    klass = torch.where(
        state.slot_page < 0, 0,
        1 + 2 * state.active.to(torch.int32) + state.referenced.to(torch.int32))
    return (klass.to(torch.int32) * (1 << 24)
            + (state.last_touch & ((1 << 24) - 1)))


def promote(state: TierState, hot_pages: torch.Tensor, k: int
            ) -> tuple[TierState, torch.Tensor, torch.Tensor]:
    """Promote up to k hot pages (quota already applied by the daemon).

    Returns (state, promoted_page_ids (k,), victim_slots (k,)): entry i says
    "copy slow[promoted[i]] into fast slot victim_slots[i]" (-1 = no-op).
    """
    dev = state.page_slot.device
    hot_pages = hot_pages[:k].to(device=dev, dtype=torch.int32)
    valid = hot_pages >= 0
    safe = torch.where(valid, hot_pages, 0)
    safe_l = safe.long()
    # intra-batch dedup (duplicates can survive across sketch epochs)
    eq = (safe[:, None] == safe[None, :]) & valid[None, :]
    earlier = torch.ones((k, k), dtype=torch.bool, device=dev).tril(-1)
    first = valid & ~(eq & earlier).any(dim=1)
    need = first & (state.page_slot[safe_l] < 0)       # not already resident

    # rank-based 2Q victim selection: cheapest slots first, ties by slot index
    n_slots = state.slot_page.shape[0]
    n_victims = min(k, n_slots)
    victim_slots = torch.sort(_victim_rank(state), stable=True).indices[:n_victims]
    order = torch.cumsum(need.to(torch.int32), 0) - 1
    need = need & (order < n_victims)                  # more hot pages than slots
    slot_for = torch.where(
        need, victim_slots[order.clamp(0, n_victims - 1).long()].to(torch.int32),
        -1)

    evicted = torch.where(slot_for >= 0,
                          state.slot_page[slot_for.clamp_min(0).long()], -1)
    ev_valid = evicted >= 0
    n_pages = state.page_slot.shape[0]
    ev_idx = torch.where(ev_valid, evicted, n_pages)
    pg_idx = torch.where(need, safe, n_pages)
    sl_idx = torch.where(need, slot_for, n_slots)

    # ping-pong: promoting a page whose PG_demoted flag is set
    pp = (need & state.demoted[safe_l]).sum(dtype=torch.int32)

    # demote victims, then install promotions (clearing PG_demoted)
    page_slot = scatter_drop(state.page_slot, ev_idx, -1)
    demoted = scatter_drop(state.demoted, ev_idx, True)
    page_slot = scatter_drop(page_slot, pg_idx, slot_for)
    demoted = scatter_drop(demoted, pg_idx, False)
    slot_page = scatter_drop(state.slot_page, sl_idx, safe)
    active = scatter_drop(state.active, sl_idx, False)        # enter A1in
    referenced = scatter_drop(state.referenced, sl_idx, False)
    last_touch = scatter_drop(state.last_touch, sl_idx, state.step)

    new_state = state._replace(
        page_slot=page_slot, slot_page=slot_page, active=active,
        referenced=referenced, last_touch=last_touch, demoted=demoted,
        promoted=state.promoted + need.sum(dtype=torch.int32),
        demoted_cnt=state.demoted_cnt + ev_valid.sum(dtype=torch.int32),
        ping_pong=state.ping_pong + pp,
    )
    return new_state, torch.where(need, safe, -1), slot_for


def drain_period_stats(state: TierState) -> tuple[TierState, dict]:
    """Read & clear the per-period counters (daemon policy inputs)."""
    stats = {
        "promoted": state.promoted,
        "demoted": state.demoted_cnt,
        "ping_pong": state.ping_pong,
        "slow_reads": state.slow_reads,
        "fast_reads": state.fast_reads,
    }
    z = torch.zeros_like(state.promoted)
    # 2Q aging: clear reference bits each period (CLOCK-style second chance)
    return state._replace(
        promoted=z, demoted_cnt=z, ping_pong=z, slow_reads=z, fast_reads=z,
        referenced=torch.zeros_like(state.referenced),
    ), stats


def lookup(state: TierState, page_ids: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot_or_minus1, hit_mask) for a batch of page ids."""
    page_ids = page_ids.long()
    valid = page_ids >= 0
    slots = torch.where(valid, state.page_slot[torch.where(valid, page_ids, 0)], -1)
    return slots, slots >= 0
