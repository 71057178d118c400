"""Profiling/tiering baselines from the paper's evaluation (§VI-A).

A copy of ``repro/core/baselines.py`` (numpy only, no framework): the same
classes, RNG seeds and outputs, kept here so the port imports nothing of the
reference package.

Each baseline sees the *same* physical access stream as NeoMem but through
its own (limited) profiling lens, and drives the same TieredStore.  The
limitations are modeled exactly as the paper analyzes them (§II-C):

  * first-touch  — allocate-to-fast-until-full, never migrate (paper's
                   First-touch NUMA).
  * pte-scan     — epoch-granular *binary* access bits (one access per page
                   per epoch max — low time resolution), scans cost CPU time
                   proportional to the page count; TLB-level visibility is
                   modeled by collapsing repeat accesses within an epoch.
  * hint-fault   — Bernoulli page-sampled instant notifications (AutoNUMA:
                   promote after 1 fault; TPP: after 2 with hysteresis),
                   per-fault overhead (TLB shootdown + fault).
  * pebs         — Bernoulli *access*-sampled LLC-miss records with
                   per-sample overhead; promote after k sampled hits.

All baselines are intentionally host-side Python/numpy: that is the point —
they burn "CPU" in the cost model, while NeoMem's profiling is on-device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BaselineCosts:
    """Per-event profiling overheads (seconds) for the cost model.

    Defaults are calibrated to the paper's measurements: a PTE scan of a
    ~4M-page table takes ~1 s (§II-C "several seconds" for large systems);
    a hint fault (TLB shootdown + protection fault) ~2.5 us [5], [60]; a
    PEBS sample ~0.2 us amortized (Fig. 4-(c): 10-interval sampling >50%
    slowdown); NeoProf readout ~0 (0.021% measured, §VI-D).
    """

    pte_scan_per_page: float = 250e-9
    hint_fault: float = 2.5e-6
    pebs_sample: float = 0.2e-6
    neoprof_readout: float = 2e-6    # per migration interval: drain <=quota
                                     # addresses over MMIO (~1KB, amortized)


class FirstTouch:
    """No profiling, no migration."""

    name = "first-touch"

    def __init__(self, num_pages: int, num_slots: int, **_):
        self.overhead = 0.0

    def observe(self, pages: np.ndarray) -> np.ndarray:
        return np.empty((0,), np.int64)  # never promotes

    def epoch_end(self) -> None:
        pass


class PteScan:
    """Epoch access-bit scanning (DAMON/AMP-style, paper Obs. #1)."""

    name = "pte-scan"

    def __init__(self, num_pages: int, num_slots: int,
                 costs: BaselineCosts | None = None,
                 hot_after_epochs: int = 2, **_):
        self.num_pages = num_pages
        self.costs = costs or BaselineCosts()
        self.hot_after = hot_after_epochs
        self.access_bit = np.zeros(num_pages, bool)
        self.epoch_hits = np.zeros(num_pages, np.int8)
        self.overhead = 0.0

    def observe(self, pages: np.ndarray) -> np.ndarray:
        # TLB-level visibility: only the access *bit* is set, frequency lost.
        self.access_bit[pages] = True
        return np.empty((0,), np.int64)

    def epoch_end(self) -> np.ndarray:
        """Scan + clear; promote pages hot in >= hot_after consecutive epochs."""
        self.overhead += self.costs.pte_scan_per_page * self.num_pages
        self.epoch_hits = np.where(self.access_bit, self.epoch_hits + 1, 0).astype(np.int8)
        self.access_bit[:] = False
        return np.nonzero(self.epoch_hits >= self.hot_after)[0]


class HintFault:
    """Poisoned-PTE fault monitoring (AutoNUMA k=1 / TPP k=2, Obs. #2)."""

    def __init__(self, num_pages: int, num_slots: int,
                 costs: BaselineCosts | None = None,
                 sample_frac: float = 0.05, promote_after: int = 1,
                 seed: int = 0, **_):
        self.name = "autonuma" if promote_after == 1 else "tpp"
        self.costs = costs or BaselineCosts()
        self.num_pages = num_pages
        self.sample_frac = sample_frac
        self.promote_after = promote_after
        self.rng = np.random.default_rng(seed)
        self.poisoned = np.zeros(num_pages, bool)
        self.faults = np.zeros(num_pages, np.int16)
        self._repoison()
        self.overhead = 0.0

    def _repoison(self):
        self.poisoned[:] = False
        n = max(1, int(self.num_pages * self.sample_frac))
        self.poisoned[self.rng.choice(self.num_pages, n, replace=False)] = True

    def observe(self, pages: np.ndarray) -> np.ndarray:
        # A fault fires on the FIRST touch of a poisoned page; the poison is
        # then cleared (the fault handler unpoisons to make progress).
        faulted = np.unique(pages[self.poisoned[pages]])
        self.overhead += self.costs.hint_fault * len(faulted)
        self.poisoned[faulted] = False
        self.faults[faulted] += 1
        hot = faulted[self.faults[faulted] >= self.promote_after]
        self.faults[hot] = 0
        return hot

    def epoch_end(self) -> np.ndarray:
        self._repoison()
        return np.empty((0,), np.int64)


class PebsSampler:
    """PMU LLC-miss sampling (Obs. #3): rate-limited, per-sample overhead."""

    name = "pebs"

    def __init__(self, num_pages: int, num_slots: int,
                 costs: BaselineCosts | None = None,
                 sample_interval: int = 1000, promote_after: int = 2,
                 seed: int = 0, **_):
        self.costs = costs or BaselineCosts()
        self.interval = sample_interval
        self.promote_after = promote_after
        self.rng = np.random.default_rng(seed)
        self.counts = np.zeros(num_pages, np.int32)
        self.overhead = 0.0

    def observe(self, pages: np.ndarray) -> np.ndarray:
        take = self.rng.random(len(pages)) < (1.0 / self.interval)
        sampled = pages[take]
        self.overhead += self.costs.pebs_sample * len(sampled)
        np.add.at(self.counts, sampled, 1)
        hot = np.unique(sampled[self.counts[sampled] >= self.promote_after])
        self.counts[hot] = 0
        return hot

    def epoch_end(self) -> np.ndarray:
        self.counts[:] = 0
        return np.empty((0,), np.int64)
