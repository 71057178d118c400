"""Continuous-batching request scheduler: many tenants, one tiered engine.

Port of ``repro/serve/sched.py`` in unified mode.  The request lifecycle
(DESIGN.md §9) over the :class:`~repro_torch.serve.engine.ServeEngine` lane
substrate:

    arrive ──> admit ──> prefill ──> decode ──> finish
                 ^                     │
                 └──── preempt <───────┘   (resume is bitwise)

* **arrive/admit** — requests queue; free decode lanes are filled by a
  weighted-fair policy that reuses the daemon's demand-proportional quota
  split (:func:`~repro_torch.tiering.daemon.split_quota`) with per-tenant
  isolation weights.  Admission needs a free lane AND a free KV slow-store
  segment; when either is exhausted arrivals stay queued.
* **prefill** — every lane consumes one token per engine step (a prompt
  token while prefilling, its last sampled token while decoding), or, with
  ``SchedConfig.prefill_chunk > 0`` and a prompt longer than the chunk, one
  chunk of its prompt per step through ``ServeEngine.prefill_lane`` while
  the other lanes decode.
* **decode** — one ``advance_lanes`` call per step serves all lanes; the
  NeoMem daemon observes every tenant's streams and migrates on its own
  cadence between steps.
* **preempt/finish** — the starvation guard: a tenant whose queue head has
  waited ``preempt_patience`` steps while it holds no lane preempts the
  most over-served tenant's youngest request
  (``ServeEngine.preempt_lane``); resuming restores bitwise.

Greedy tokens only, and no disaggregated pools: ``SchedConfig.temperature
> 0`` and ``prefill_lanes > 0`` raise ``NotImplementedError``, as does an
engine with KV reuse (``ServeEngine`` refuses ``reuse_pages``).  The
scheduler is host Python over numpy; its only reads of the card are the
logits each step returns (that read-back is the step's end, so token
time stamps are completion times) and the placement lookups of the
per-tenant metering.

Per-tenant telemetry rides the daemon's ``TierStats`` schema: each step the
lanes' resident pages are looked up in the KV placement map and metered as
fast/slow reads per tenant.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serve.engine import ServeEngine
from repro_torch.tiering.daemon import split_quota
from repro_torch.tiering.stats import TierStats


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One traffic source multiplexed onto the engine."""

    name: str
    weight: float = 1.0        # isolation weight in the lane split


@dataclasses.dataclass
class SchedConfig:
    preempt_patience: int = 16   # steps a lane-less tenant waits before
    #                              its queue head may preempt someone
    max_queue: int = 4096        # hard bound on queued requests
    # Chunked prefill (DESIGN.md §11): a prefilling lane consumes up to
    # `prefill_chunk` prompt tokens per step; 0 = token-at-a-time streaming
    # (prompts no longer than the chunk stream too; bitwise either way).
    prefill_chunk: int = 0
    # reference features that wait for later slices: any value but the
    # default raises in Scheduler
    prefill_lanes: int = 0       # disaggregated prefill pool
    temperature: float = 0.0     # > 0: sampled tokens


_NOT_YET_PORTED = {
    "prefill_lanes": (lambda s: s.prefill_lanes > 0,
                      "disaggregated prefill/decode"),
    "temperature": (lambda s: s.temperature > 0.0, "temperature sampling"),
}


@dataclasses.dataclass
class Request:
    """One request's lifecycle record: queued -> running -> finished, with
    preempted in between on a starvation guard."""

    rid: int
    tenant: str
    prompt: np.ndarray           # (P,) int32 prompt tokens
    max_new: int                 # output tokens to generate
    arrival_step: int = 0
    state: str = "queued"        # queued | running | preempted | finished
    lane: int = -1
    segment: int = -1            # KV slow-store segment (kept while preempted)
    pos: int = 0                 # tokens consumed so far (prompt + generated)
    out: list = dataclasses.field(default_factory=list)
    residual: dict | None = None  # preemption snapshot (engine)
    queued_since: int = 0
    admitted_step: int = -1
    finished_step: int = -1
    preemptions: int = 0
    arrival_time: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)
    # per-token decode-clock stamps and the step each token was emitted on
    token_clock: list = dataclasses.field(default_factory=list)
    token_steps: list = dataclasses.field(default_factory=list)

    @property
    def n_prompt(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefilling(self) -> bool:
        return self.pos < self.n_prompt


class Scheduler:
    """Multiplexes tenants' requests onto one ServeEngine/NeoMemDaemon."""

    def __init__(self, engine: ServeEngine, tenants: list[Tenant],
                 scfg: SchedConfig | None = None):
        if not engine.lane_mode:
            raise ValueError("Scheduler requires an engine with "
                             "ServeConfig.lanes > 0")
        if not tenants:
            raise ValueError("at least one tenant required")
        self.scfg = scfg or SchedConfig()
        for field, (asks, what) in _NOT_YET_PORTED.items():
            if asks(self.scfg):
                raise NotImplementedError(
                    f"SchedConfig.{field}={getattr(self.scfg, field)!r}: "
                    f"{what} is not yet ported to repro_torch")
        self.eng = engine
        self.tenants = {t.name: t for t in tenants}
        self.n_lanes = engine.scfg.lanes
        n_seg = engine.scfg.kv_segments or self.n_lanes
        self.free_segments = list(range(n_seg))
        self.lanes: list[Request | None] = [None] * self.n_lanes
        self.queue: list[Request] = []      # arrival order (incl. preempted)
        self.finished: list[Request] = []
        self.step_count = 0
        self.preemptions = 0
        self.queued_peak = 0
        self._next_rid = 0
        self.tenant_stats = {t: TierStats(name=t) for t in self.tenants}
        # the reference's per-worker virtual clocks; unified mode charges
        # everything to "decode"
        self.clock = {"prefill": 0.0, "handoff": 0.0, "decode": 0.0}
        self._seg_t0: float | None = None
        # prefill_busy[s]: was a lane mid-CHUNKED-prefill during step s?
        self.prefill_busy: list[bool] = []
        if engine.cache is None:
            engine.start_lanes()

    # -- request intake -------------------------------------------------------
    def submit(self, tenant: str, prompt: np.ndarray,
               max_new: int) -> Request:
        """Queue a request (the *arrive* stage).  Raises when the queue is
        at its bound — backpressure belongs to the caller, not silent drop."""
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        if len(self.queue) >= self.scfg.max_queue:
            raise RuntimeError(f"queue full ({self.scfg.max_queue})")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if prompt.size + max_new > self.eng.scfg.max_seq:
            raise ValueError(
                f"request length {prompt.size}+{max_new} exceeds the "
                f"max_seq={self.eng.scfg.max_seq} KV segment")
        req = Request(rid=self._next_rid, tenant=tenant, prompt=prompt,
                      max_new=max_new, arrival_step=self.step_count,
                      queued_since=self.step_count,
                      arrival_time=time.perf_counter())
        self._next_rid += 1
        self.queue.append(req)
        self.queued_peak = max(self.queued_peak, len(self.queue))
        return req

    # -- the decode clock -----------------------------------------------------
    def _enter(self) -> None:
        """Start charging wall time to the decode clock."""
        self._close_seg()
        self._seg_t0 = time.perf_counter()

    def _close_seg(self) -> None:
        if self._seg_t0 is not None:
            self.clock["decode"] += time.perf_counter() - self._seg_t0
            self._seg_t0 = None

    def _now(self) -> float:
        """The decode clock's reading, the open segment included."""
        t = self.clock["decode"]
        if self._seg_t0 is not None:
            t += time.perf_counter() - self._seg_t0
        return t

    # -- admission / preemption ----------------------------------------------
    def _running_by_tenant(self) -> dict[str, int]:
        counts = {t: 0 for t in self.tenants}
        for r in self.lanes:
            if r is not None:
                counts[r.tenant] += 1
        return counts

    def _lane_shares(self) -> dict[str, int]:
        """Target lane allocation per tenant: the daemon's quota split
        applied to lanes — demand = running + waiting, weighted, clamped."""
        demands = self._running_by_tenant()
        for r in self.queue:
            demands[r.tenant] += 1
        caps = {t: self.n_lanes for t in self.tenants}
        weights = {t: self.tenants[t].weight for t in self.tenants}
        return split_quota(self.n_lanes, demands, caps, weights)

    def _admit(self) -> None:
        if self.queue:
            self._maybe_preempt()
        free = [ln for ln, r in enumerate(self.lanes) if r is None]
        while free and self.queue:
            shares = self._lane_shares()
            running = self._running_by_tenant()
            heads: dict[str, Request] = {}
            for r in self.queue:                # service order: arrival
                heads.setdefault(r.tenant, r)
            # the waiting tenant with the largest share deficit wins the
            # lane; deficit <= 0 everywhere falls back to FIFO
            pick = max(heads.values(),
                       key=lambda r: (shares.get(r.tenant, 0)
                                      - running[r.tenant],
                                      -r.queued_since, -r.rid))
            if shares.get(pick.tenant, 0) - running[pick.tenant] <= 0:
                pick = self.queue[0]
            if not self._install(pick, free[0]):
                # no free KV segment for a fresh request — a preempted one
                # (which kept its segment) can still take the lane
                pre = next((r for r in self.queue if r.state == "preempted"),
                           None)
                if pre is None or not self._install(pre, free[0]):
                    break
            free.pop(0)

    def _install(self, req: Request, lane: int) -> bool:
        if req.state == "preempted":
            self.eng.resume_lane(lane, req.residual)
            req.residual = None
        else:
            if not self.free_segments:
                return False
            req.segment = self.free_segments.pop(0)
            req.admitted_step = self.step_count
            self.eng.reset_lane(lane)
        req.state, req.lane = "running", lane
        self.lanes[lane] = req
        self.queue.remove(req)
        return True

    def _maybe_preempt(self) -> None:
        """Starvation guard: one preemption per step, only for a tenant
        that holds NO lane and whose waiting head has out-waited the
        patience."""
        if any(r is None for r in self.lanes):
            return                            # a free lane serves them first
        running = self._running_by_tenant()
        starving = None
        for r in self.queue:                  # service order
            waited = self.step_count - r.queued_since
            if running[r.tenant] == 0 and waited >= self.scfg.preempt_patience:
                starving = r
                break
        if starving is None:
            return
        if starving.state == "queued" and not self.free_segments:
            return                            # nowhere to hold its KV yet
        # victim tenant: most over-served per unit weight; victim request:
        # its youngest admission (least sunk work discarded)
        cands = [t for t, n in running.items()
                 if n > 0 and t != starving.tenant]
        if not cands:
            return
        victim_t = max(cands,
                       key=lambda t: running[t] / max(self.tenants[t].weight,
                                                      1e-9))
        victim = max((r for r in self.lanes
                      if r is not None and r.tenant == victim_t),
                     key=lambda r: r.admitted_step)
        lane = victim.lane
        self._preempt(victim)
        # the freed lane goes to the starving head DIRECTLY — handing it to
        # the weighted-fair pick would return it to the hog and thrash
        self._install(starving, lane)

    def _preempt(self, req: Request) -> None:
        req.residual = self.eng.preempt_lane(req.lane)
        self.lanes[req.lane] = None
        req.state, req.lane = "preempted", -1
        req.queued_since = self.step_count
        req.preemptions += 1
        self.preemptions += 1
        self.queue.append(req)
        self.queued_peak = max(self.queued_peak, len(self.queue))

    def _finish(self, req: Request) -> None:
        self.lanes[req.lane] = None
        self.free_segments.append(req.segment)
        req.state, req.lane = "finished", -1
        req.finished_step = self.step_count
        self.finished.append(req)

    def _emit(self, req: Request, tok: int, now: float, clock_now: float) -> None:
        """Append one output token, stamped with the step's completion."""
        req.out.append(tok)
        req.token_times.append(now)
        req.token_clock.append(clock_now)
        req.token_steps.append(self.step_count)
        if len(req.out) >= req.max_new:
            self._finish(req)

    # -- the serving loop -----------------------------------------------------
    def step(self) -> None:
        """One scheduler iteration: admit, advance every lane (one decode
        token, or one prefill CHUNK for a long-prompt lane), sample and
        finish, meter per-tenant tier stats — all on the decode clock.  A
        chunked request's first output token is emitted the step its LAST
        chunk lands, from the same logits streaming would produce."""
        self._enter()
        try:
            self._step_unified()
        finally:
            self._close_seg()

    def _step_unified(self) -> None:
        self._admit()
        chunk = self.scfg.prefill_chunk
        self.prefill_busy.append(any(
            r is not None and r.prefilling and chunk > 0
            and r.n_prompt > chunk for r in self.lanes))
        tokens = np.zeros(self.n_lanes, np.int32)
        active = np.zeros(self.n_lanes, bool)
        segments = np.full(self.n_lanes, -1, np.int32)
        consumed = np.zeros(self.n_lanes, np.int32)
        chunk_logits: dict[int, np.ndarray] = {}
        for lane, req in enumerate(self.lanes):
            if req is None:
                continue
            segments[lane] = req.segment
            if chunk > 0 and req.prefilling and req.n_prompt > chunk:
                piece = req.prompt[req.pos:req.pos + chunk]
                chunk_logits[lane] = self.eng.prefill_lane(
                    lane, piece, req.segment, chunk=chunk)
                consumed[lane] = piece.size
                continue
            active[lane] = True
            consumed[lane] = 1
            tokens[lane] = (req.prompt[req.pos] if req.prefilling
                            else req.out[-1])
        if not (active.any() or chunk_logits):
            self.step_count += 1                 # nothing ran: no lane emits
            return
        if active.any():
            logits = self.eng.advance_lanes(tokens, active, segments)
        else:
            logits = np.zeros((self.n_lanes, self.eng.cfg.vocab), np.float32)
        for lane, row in chunk_logits.items():
            logits[lane] = row
        # meter BEFORE the finish sweep (each request's final step of
        # resident-page reads must still be charged to its tenant)
        self._meter_tenants()
        now, clock_now = time.perf_counter(), self._now()
        sampled = self._sample(logits)
        for lane, req in enumerate(list(self.lanes)):
            if req is None or consumed[lane] == 0:
                continue
            req.pos += int(consumed[lane])
            if not req.prefilling:           # last prompt token or decoding
                self._emit(req, int(sampled[lane]), now, clock_now)
        self.step_count += 1

    @staticmethod
    def _sample(logits: np.ndarray) -> np.ndarray:
        """Greedy tokens of every lane (L,)."""
        return np.argmax(logits, axis=-1)

    @property
    def active(self) -> bool:
        """Any request still in flight (queued or on a lane)?"""
        return bool(self.queue or any(r is not None for r in self.lanes))

    def run(self, max_steps: int = 10_000) -> None:
        """Drain: run until every submitted request finished (or the bound)."""
        while self.active:
            if self.step_count >= max_steps:
                raise RuntimeError(f"undrained after {max_steps} steps")
            self.step()

    # -- telemetry ------------------------------------------------------------
    def _meter_tenants(self) -> None:
        """Account each lane's resident KV pages against its tenant: a page
        the placement map holds fast is a per-tenant fast read.  Runs before
        the finish sweep over the explicit occupancy mask, so a finishing
        request's final step — and a chunk-prefilling lane the engine's own
        active mask no longer carries — is still charged."""
        occupied = np.array([r is not None for r in self.lanes], bool)
        gids = self.eng._kv_lane_stream(active=occupied)
        _, hit = self.eng.daemon["kv"].lookup(self.eng._ids(gids.reshape(-1)))
        hit = hit.cpu().numpy().reshape(gids.shape)
        valid = gids >= 0
        for lane, req in enumerate(self.lanes):
            if req is None:
                continue
            st = self.tenant_stats[req.tenant]
            f = int(np.sum(hit[lane] & valid[lane]))
            st.fast_reads += f
            st.slow_reads += int(np.sum(valid[lane])) - f

    @staticmethod
    def _pct_row(gaps) -> dict:
        if not len(gaps):
            return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}
        g = np.asarray(gaps) * 1e3
        return {"p50": float(np.percentile(g, 50)),
                "p99": float(np.percentile(g, 99)),
                "mean": float(np.mean(g)), "n": int(g.size)}

    @classmethod
    def _latency_rows(cls, reqs: list[Request]) -> dict:
        """``ttft_ms`` (arrival -> first emitted token) and ``tpot_ms``
        (gaps between a request's consecutive output tokens): two
        distributions, kept apart."""
        ttft, tpot = [], []
        for r in reqs:
            if r.token_times:
                ttft.append(r.token_times[0] - r.arrival_time)
                tpot.extend(np.diff(r.token_times))
        return {"ttft_ms": cls._pct_row(ttft),
                "tpot_ms": cls._pct_row(tpot)}

    def report(self) -> dict:
        """The traffic-bench schema row for this run (BENCH_serve.json);
        the disaggregation fields keep their unified values."""
        done = self.finished
        tenants = {}
        for name, ten in self.tenants.items():
            reqs = [r for r in done if r.tenant == name]
            st = self.tenant_stats[name]
            total = st.fast_reads + st.slow_reads
            tenants[name] = {
                "weight": ten.weight,
                "completed": len(reqs),
                "tokens": sum(len(r.out) for r in reqs),
                "kv_hit_rate": st.fast_reads / max(total, 1),
                **self._latency_rows(reqs),
            }
        return {
            "steps": self.step_count,
            "submitted": self._next_rid,
            "completed": len(done),
            "tokens": sum(len(r.out) for r in done),
            "preemptions": self.preemptions,
            "queued_peak": self.queued_peak,
            "mode": "unified",
            "prefill_lanes": 0,
            "clock": {"prefill_s": self.clock["prefill"],
                      "handoff_s": self.clock["handoff"],
                      "decode_s": self.clock["decode"]},
            "handoff": {"count": 0, "bytes_out": 0, "bytes_in": 0,
                        "depth_peak": 0},
            **self._latency_rows(done),
            "tenants": tenants,
            "resources": self.eng.tier_stats(),
        }
