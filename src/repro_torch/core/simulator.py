"""Two-tier memory simulator + workload generators (paper §VI evaluation).

Port of ``repro/core/simulator.py``.  Drives the port's NeoMem components
(the sketch, Algorithm 1 and the TieredStore, through
:class:`repro_torch.tiering.memory.TieredMemory`) and the baseline profilers
over page-access streams modeled on the paper's eight benchmarks, and turns
hit/miss/migration/overhead accounting into modeled runtime with the tier
characteristics of paper Fig. 3:

    fast tier  ~120 ns load-to-use,   slow tier ~430 ns  (3.6x),
    page migration at slow-tier bandwidth, profiling overhead per §II-C.

The modeled runtime is arithmetic on integer counts, the same on any
device; what the device changes is the wall time of a block.  On a CUDA
device the sketch runs the update, mark and histogram kernels, on the CPU
their plain versions.  The sketch takes the reference's default H3 seeds
(:func:`repro_torch.core.sketch.key_seeds`), so every count equals the
reference's.

    from repro_torch.core.simulator import WORKLOADS, run_sim
    stream = WORKLOADS["gups"](n_pages=4096, block=2048, n_blocks=240, seed=11)
    res = run_sim("neomem", stream, n_pages=4096, device="cpu")
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import baselines as B
from repro_torch.core import tiering
from repro_torch.core.baselines import BaselineCosts
from repro_torch.core.neoprof import NeoProfParams
from repro_torch.core.policy import PolicyParams
from repro_torch.core.sketch import SketchParams, key_seeds
from repro_torch.core.tiering import TierParams

INIT_CHUNK = 1 << 14     # pages per first-touch chunk of the init sweep


@dataclasses.dataclass
class MemModel:
    """Tier timing model (paper Fig. 3 + Table II)."""

    fast_lat: float = 120e-9
    slow_lat: float = 430e-9
    page_bytes: int = 4096
    slow_bw: float = 12e9          # bytes/s (FPGA DDR4-2666 2ch, derated)
    line_bytes: int = 64

    def access_time(self, fast_hits: int, slow_hits: int) -> float:
        return fast_hits * self.fast_lat + slow_hits * self.slow_lat

    def migration_time(self, pages: int) -> float:
        return pages * self.page_bytes / self.slow_bw


# ---------------------------------------------------------------------------
# Workload stream generators — page-id streams mirroring the paper's suite
# (numpy; the reference's arrays exactly)
# ---------------------------------------------------------------------------

def _zipf_pages(rng, n_pages, s, size):
    # bounded zipf via inverse-CDF on precomputed weights (cheap for n<=1M)
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    w = ranks ** (-s)
    cdf = np.cumsum(w) / np.sum(w)
    u = rng.random(size)
    pages = np.searchsorted(cdf, u)
    perm = rng.permutation(n_pages)  # decorrelate rank from address
    return perm[pages]


def gups(n_pages: int, block: int, n_blocks: int, seed: int = 0,
         hot_frac: float = 0.1, hot_prob: float = 0.9,
         shift_at: int | None = None) -> Iterator[np.ndarray]:
    """HeMem-style skewed GUPS: hot_prob of traffic to a hot_frac region.

    ``shift_at`` relocates the hot set mid-stream (Fig. 16 convergence)."""
    rng = np.random.default_rng(seed)
    hot_n = max(1, int(n_pages * hot_frac))
    # hot region at the END of the address space: the init sweep has already
    # filled the fast tier with low (cold) pages, so the hot set starts
    # slow-resident
    hot_base = n_pages - hot_n
    for b in range(n_blocks):
        if shift_at is not None and b == shift_at:
            hot_base = (hot_base + n_pages // 2) % (n_pages - hot_n)
        is_hot = rng.random(block) < hot_prob
        hot = hot_base + rng.integers(0, hot_n, block)
        uni = rng.integers(0, n_pages, block)
        yield np.where(is_hot, hot, uni).astype(np.int64)


def xsbench(n_pages, block, n_blocks, seed=0):
    """MC neutronics macro-XS lookups: very skewed (paper: 'skewed hot regions')."""
    rng = np.random.default_rng(seed)
    for _ in range(n_blocks):
        yield _zipf_pages(rng, n_pages, 1.2, block).astype(np.int64)


def silo_ycsb(n_pages, block, n_blocks, seed=0):
    """YCSB-C zipf(0.99) point lookups."""
    rng = np.random.default_rng(seed)
    for _ in range(n_blocks):
        yield _zipf_pages(rng, n_pages, 0.99, block).astype(np.int64)


def btree(n_pages, block, n_blocks, seed=0):
    """Index lookups: tiny ultra-hot index levels + zipf leaves."""
    rng = np.random.default_rng(seed)
    idx_n = max(1, n_pages // 100)
    for _ in range(n_blocks):
        to_idx = rng.random(block) < 0.7
        idx = rng.integers(0, idx_n, block)
        leaf = idx_n + _zipf_pages(rng, n_pages - idx_n, 0.8, block)
        yield np.where(to_idx, idx, leaf).astype(np.int64)


def pagerank(n_pages, block, n_blocks, seed=0, n_iters: int = 16):
    """Graph iterations: power-law-hot vertices + per-iteration edge sweep
    (the phase structure drives the Fig. 14 dynamic-threshold study)."""
    rng = np.random.default_rng(seed)
    per_iter = max(1, n_blocks // n_iters)
    for b in range(n_blocks):
        it = b // per_iter
        sweep_frac = 0.5 if it % 4 == 0 else 0.25   # phase change
        n_sweep = int(block * sweep_frac)
        sweep = (np.arange(n_sweep, dtype=np.int64) * 7 + b * block) % n_pages
        hot = _zipf_pages(rng, n_pages, 1.05, block - n_sweep)
        yield np.concatenate([sweep, hot]).astype(np.int64)


def deathstar(n_pages, block, n_blocks, seed=0):
    """Microservice mix: zipf(0.9) with slow working-set drift."""
    rng = np.random.default_rng(seed)
    for b in range(n_blocks):
        drift = (b * 17) % n_pages
        yield ((_zipf_pages(rng, n_pages, 0.9, block) + drift) % n_pages).astype(np.int64)


def stream_stencil(n_pages, block, n_blocks, seed=0):
    """bwaves/roms-like: dominant sequential sweep + small resident hot set."""
    rng = np.random.default_rng(seed)
    hot_n = max(1, n_pages // 50)
    pos = 0
    for _ in range(n_blocks):
        n_seq = int(block * 0.8)
        seq = (pos + np.arange(n_seq, dtype=np.int64)) % n_pages
        pos = (pos + n_seq) % n_pages
        hot = rng.integers(0, hot_n, block - n_seq)
        yield np.concatenate([seq, hot]).astype(np.int64)


WORKLOADS = {
    "deathstar": deathstar,
    "pagerank": pagerank,
    "xsbench": xsbench,
    "gups": gups,
    "silo": silo_ycsb,
    "btree": btree,
    "bwaves": stream_stencil,
    "roms": lambda *a, **k: stream_stencil(*a, **{**k, "seed": k.get("seed", 0) + 1}),
}


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    name: str
    runtime: float                 # modeled seconds
    access_time: float
    migration_time: float
    overhead_time: float
    fast_hits: int
    slow_hits: int
    promoted: int
    ping_pong: int
    trace: list = dataclasses.field(default_factory=list)  # per-block dicts

    @property
    def hit_rate(self) -> float:
        t = self.fast_hits + self.slow_hits
        return self.fast_hits / max(t, 1)


def _first_touch_alloc(first_seen, free_slots, pages, tier):
    """Uniform first-touch allocation: new pages land in fast while it has room."""
    new = pages[~first_seen[pages]]
    if len(new) == 0 or free_slots <= 0:
        return tier, free_slots, np.empty((0,), np.int64)
    new = new[: free_slots]
    uniq = np.unique(new)
    first_seen[uniq] = True
    batch = torch.as_tensor(uniq.astype(np.int32), device=tier.page_slot.device)
    tier, promoted, _ = tiering.promote(tier, batch, len(uniq))
    return tier, free_slots - int((promoted >= 0).sum()), uniq


def _baseline(method, n_pages, num_slots, costs):
    mk = {
        "first-touch": B.FirstTouch,
        "pte-scan": B.PteScan,
        "pebs": B.PebsSampler,
        "autonuma": lambda n, s, **kw: B.HintFault(n, s, promote_after=1, **kw),
        "tpp": lambda n, s, **kw: B.HintFault(n, s, promote_after=2, **kw),
    }[method]
    return mk(n_pages, num_slots, costs=costs)


def run_sim(
    method: str,
    stream: Iterator[np.ndarray],
    n_pages: int,
    fast_ratio: float = 1 / 3,           # fast:(fast+slow); 1:2 -> 1/3
    mem: MemModel | None = None,
    sketch_width: int = 1 << 14,
    sketch_depth: int = 2,
    quota_pages: int = 256,
    migration_interval: int = 1,
    threshold_update_period: int = 8,
    clear_interval: int = 64,
    fixed_theta: int | None = None,
    costs: BaselineCosts | None = None,
    epoch_blocks: int = 8,               # baseline scan epoch, in blocks
    collect_trace: bool = False,
    init_sweep: bool = True,             # sequential allocation pre-phase
    *,
    device="cuda",
) -> SimResult:
    """Run one (method x workload) cell and return modeled accounting.

    methods: neomem | neomem-fixed | pte-scan | pebs | autonuma | tpp |
             first-touch

    Every method drives the shared :class:`TieredMemory` verbs (enqueue /
    migrate / drain), so quota, pending-queue and stats arithmetic is the
    code the serving daemon runs; the neomem methods also use the profile /
    collect / update-threshold / clear verbs.  The sketch takes the
    reference's default H3 seeds (key 0).
    """
    # Imported here: repro_torch.core's package init imports this module,
    # while repro_torch.tiering imports repro_torch.core submodules.
    from repro_torch.tiering.memory import DaemonParams, TieredMemory
    from repro_torch.tiering.stats import TierStats, drain_tier_stats

    dev = torch.device(device)
    mem = mem or MemModel()
    costs = costs or BaselineCosts()
    num_slots = max(1, int(n_pages * fast_ratio))
    is_neomem = method.startswith("neomem")

    tmem = TieredMemory(
        NeoProfParams(sketch=SketchParams(width=sketch_width, depth=sketch_depth)),
        TierParams(n_pages, num_slots, quota_pages),
        daemon_params=DaemonParams(
            migration_interval=migration_interval,
            threshold_update_period=threshold_update_period,
            clear_interval=clear_interval, quota_pages=quota_pages),
        # policy quota bound: 4x the migration CAPACITY (equal to capacity
        # degenerates into a starve/flood oscillation of p)
        policy_params=PolicyParams(
            m_quota_pages=4 * quota_pages * threshold_update_period),
        fixed_theta=fixed_theta, device=dev)
    state = tmem.init(key_seeds(sketch_depth, sketch_width))
    stats = TierStats(name=method)
    first_seen = np.zeros(n_pages, bool)
    free_slots = num_slots
    baseline = None if is_neomem else _baseline(method, n_pages, num_slots, costs)
    res = SimResult(method, 0.0, 0.0, 0.0, 0.0, 0, 0, 0, 0)

    def ids(pages: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(pages.astype(np.int32), device=dev)

    if init_sweep:
        # application init: touch every page once, in order; first-touch
        # allocation fills the fast tier with the LOW pages, for every method
        for lo in range(0, n_pages, INIT_CHUNK):
            blk = np.arange(lo, min(lo + INIT_CHUNK, n_pages), dtype=np.int64)
            tier, free_slots, _ = _first_touch_alloc(
                first_seen, free_slots, blk, state.tier)
            state = tmem.touch(state._replace(tier=tier), ids(blk))
        # init accesses count toward runtime (the final access_time) but
        # not toward promotion/ping-pong stats
        init_stats = TierStats()
        state = state._replace(tier=drain_tier_stats(state.tier, init_stats))
        stats.fast_reads += init_stats.fast_reads
        stats.slow_reads += init_stats.slow_reads

    for b, pages in enumerate(stream):
        # --- allocation (uniform across methods) ---------------------------
        tier, free_slots, _ = _first_touch_alloc(
            first_seen, free_slots, pages, state.tier)
        state = state._replace(tier=tier)
        block_ids = ids(pages)

        # --- profiling ------------------------------------------------------
        if is_neomem:
            # NeoProf sits in the slow tier's controller: it sees only the
            # accesses that miss the fast tier (paper Fig. 2).  The block's
            # placements are gathered on the device and only they cross.
            slot = state.tier.page_slot[block_ids.long()].cpu().numpy()
            slow_pages = pages[slot < 0]
            blk = np.full(len(pages), -1, np.int64)
            blk[: len(slow_pages)] = slow_pages
            state = tmem.profile(
                state, ids(blk),
                rd_bytes=float(len(slow_pages) * mem.line_bytes),
                budget_bytes=float(len(pages) * mem.line_bytes) * 2.0,
            )
            if (b + 1) % migration_interval == 0:
                state, _ = tmem.collect(state, stats)
                res.overhead_time += costs.neoprof_readout
        else:
            hot = baseline.observe(pages)
            if (b + 1) % epoch_blocks == 0:
                hot = np.union1d(hot, baseline.epoch_end())
            if method != "first-touch":
                tmem.enqueue(hot)

        # --- migration (quota-bounded; overflow stays queued) ---------------
        if method != "first-touch":
            state, event = tmem.migrate(state, stats)
            if event is not None:
                res.migration_time += mem.migration_time(event.n_promoted)

        # --- access accounting ----------------------------------------------
        state = tmem.touch(state, block_ids)

        # --- NeoMem policy cadence -------------------------------------------
        if (b + 1) % threshold_update_period == 0:
            if is_neomem:
                state = tmem.update_threshold(state, stats)
                if collect_trace:
                    res.trace.append({
                        "block": b, "theta": stats.theta_trace[-1],
                        "bw": stats.bw_trace[-1], "err": stats.err_trace[-1],
                        "hit_rate": stats.drained_hit_rate,
                    })
            else:
                state = tmem.drain(state, stats)
                if collect_trace:
                    res.trace.append({"block": b,
                                      "hit_rate": stats.drained_hit_rate})

        if is_neomem and (b + 1) % clear_interval == 0:
            state = tmem.clear(state)

    # flush remaining period stats
    state = tmem.drain(state, stats)
    if baseline is not None:
        res.overhead_time += baseline.overhead

    res.fast_hits = stats.fast_reads
    res.slow_hits = stats.slow_reads
    res.promoted = stats.promoted
    res.ping_pong = stats.ping_pong
    res.access_time = mem.access_time(res.fast_hits, res.slow_hits)
    res.runtime = res.access_time + res.migration_time + res.overhead_time
    return res


def geomean_speedup(base: list[float], ours: list[float]) -> float:
    r = np.asarray(base) / np.asarray(ours)
    return float(np.exp(np.mean(np.log(r))))
