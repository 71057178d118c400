"""Continuous-batching request scheduler: many tenants, one tiered engine.

Port of ``repro/serve/sched.py``.  The request lifecycle (DESIGN.md §9)
over the :class:`~repro_torch.serve.engine.ServeEngine` lane substrate:

    arrive ──> admit ──> prefill ──> decode ──> finish
                 ^                     │
                 └──── preempt <───────┘   (resume is bitwise)

* **arrive/admit** — requests queue; free decode lanes are filled by a
  weighted-fair policy that reuses the daemon's demand-proportional quota
  split (:func:`~repro_torch.tiering.daemon.split_quota`) with per-tenant
  isolation weights.  Admission needs a free lane AND a free KV slow-store
  segment; when either is exhausted arrivals stay queued.  With a KV reuse
  pool (``ServeConfig.reuse_pages``) admission matches the prompt's full
  pages against it (``SchedConfig.reuse_match``) and the lane installs the
  matched runs instead of computing them (DESIGN.md §12).
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
  (``ServeEngine.preempt_lane``); resuming restores bitwise.  A finishing
  request publishes its pages into the reuse pool and releases its claims.

**Disaggregated prefill/decode** (``SchedConfig.prefill_lanes > 0``,
DESIGN.md §13): a prefill-worker engine attached to the decode engine runs
only chunk scans; a finished prefill hands off through the slow store
(``ServeEngine.handoff_lane``), waits until its segment is write-witnessed
(``segment_resident``) and is installed into a decode lane through the
placement table (``install_handoff``), where its first token is emitted
from the final chunk's logits.  Each pool charges its work to its own
virtual clock (``Scheduler.clock``).

**Sampling**: ``temperature <= 0`` is the exact argmax; otherwise each
token is drawn by ``models/decode.py::sample_tokens`` on the engine's
device with a key folded from (seed, request id, token index), so draws do
not depend on the lane, the admission order or preemptions, and equal the
reference's threefry draws bit for bit.

The scheduler is host Python over numpy; it reads from the card the logits
each step returns (that read-back is the step's end, so token time stamps
are completion times), the sampled tokens and the placement lookups of the
per-tenant metering.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

import torch

from repro_torch.models import decode as dec
from repro_torch.models import prng
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
    # Disaggregation (DESIGN.md §13): > 0 reserves a pool of that many
    # prefill-worker lanes on an attached engine; requires prefill_chunk > 0.
    # Size the KV store for both pools and the hand-offs in flight.
    prefill_lanes: int = 0
    # Sampling: temperature <= 0 is the exact argmax; otherwise keys fold
    # (seed, request id, tokens emitted), with an optional top-p nucleus.
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    # Admission matching against the KV reuse pool (ServeConfig.reuse_pages):
    # "substring" verifies every full prompt page and skips holes, "prefix"
    # stops at the first miss.
    reuse_match: str = "substring"


@dataclasses.dataclass
class Request:
    """One request's lifecycle record: queued -> running -> finished, with
    preempted in between on a starvation guard; the disaggregated scheduler
    inserts prefill (a prefill-pool lane) and handoff (detached, awaiting
    slow-store residency and a decode lane) before running."""

    rid: int
    tenant: str
    prompt: np.ndarray           # (P,) int32 prompt tokens
    max_new: int                 # output tokens to generate
    arrival_step: int = 0
    state: str = "queued"  # queued | prefill | handoff | running | preempted
    #                        | finished
    lane: int = -1               # pool-local lane (state names the pool)
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
    key: torch.Tensor | None = None   # (2,) request key (sampling mode)
    # admission-matched shared pages not yet installed: local page -> pool gid
    matched: dict = dataclasses.field(default_factory=dict)
    # every pool gid this request holds a reference on (released at finish;
    # the claim survives preemption)
    shared_gids: list = dataclasses.field(default_factory=list)

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
        self.eng = engine
        self.tenants = {t.name: t for t in tenants}
        self.scfg = scfg or SchedConfig()
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
        self._sample_master = prng.prng_key(self.scfg.seed, device=engine.device)
        # per-worker virtual clocks: unified mode runs everything on
        # "decode"; disagg charges each pool's work to its own worker
        self.clock = {"prefill": 0.0, "handoff": 0.0, "decode": 0.0}
        self._seg_role: str | None = None
        self._seg_t0 = 0.0
        # prefill_busy[s]: was a prefill in flight during step s?
        self.prefill_busy: list[bool] = []
        # -- disaggregated pools (DESIGN.md §13) --
        self.disagg = self.scfg.prefill_lanes > 0
        self.handoff: list[Request] = []    # detached, awaiting decode admit
        self.handoffs = 0
        self.handoff_bytes_out = 0          # producer flush (prefill -> slow)
        self.handoff_bytes_in = 0           # consumer gather (slow -> decode)
        self.handoff_peak = 0
        self.peng: ServeEngine | None = None
        self.pre_lanes: list[Request | None] = []
        if self.disagg:
            if self.scfg.prefill_chunk <= 0:
                raise ValueError(
                    "disaggregated scheduling (prefill_lanes > 0) requires "
                    "prefill_chunk > 0 — the chunked scan is the prefill "
                    "worker's unit of work (DESIGN.md §13)")
            pcfg = dataclasses.replace(engine.scfg,
                                       lanes=self.scfg.prefill_lanes)
            self.peng = ServeEngine(engine.cfg, engine.params, pcfg,
                                    device=engine.device, ep_axes=engine.ep,
                                    attach_to=engine)
            self.pre_lanes = [None] * self.scfg.prefill_lanes
        if engine.cache is None:
            engine.start_lanes()
        if self.peng is not None and self.peng.cache is None:
            self.peng.start_lanes()

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
        if self.scfg.temperature > 0.0:
            # identity-derived key: (seed, rid) — lane/preemption-invariant
            req.key = prng.fold_in(self._sample_master, req.rid)
        self._next_rid += 1
        self.queue.append(req)
        self.queued_peak = max(self.queued_peak, len(self.queue))
        return req

    # -- worker clocks --------------------------------------------------------
    def _enter(self, role: str) -> None:
        """Start charging wall time to ``role``'s virtual clock."""
        self._close_seg()
        self._seg_role, self._seg_t0 = role, time.perf_counter()

    def _close_seg(self) -> None:
        if self._seg_role is not None:
            self.clock[self._seg_role] += time.perf_counter() - self._seg_t0
            self._seg_role = None

    def _now(self, role: str) -> float:
        """``role``'s virtual clock reading, the open segment included."""
        t = self.clock[role]
        if self._seg_role == role:
            t += time.perf_counter() - self._seg_t0
        return t

    # -- admission / preemption ----------------------------------------------
    def _pool(self, role: str) -> tuple[ServeEngine, list]:
        if role == "prefill":
            return self.peng, self.pre_lanes
        return self.eng, self.lanes

    def _running_by_tenant(self, lanes: list) -> dict[str, int]:
        counts = {t: 0 for t in self.tenants}
        for r in lanes:
            if r is not None:
                counts[r.tenant] += 1
        return counts

    def _candidates(self, role: str) -> list[Request]:
        """Admissible requests for a pool, in service order: the whole queue
        in unified mode; fresh arrivals and mid-prefill preemptions for the
        prefill pool; resident hand-offs and decode-phase preemptions,
        oldest wait first, for the disaggregated decode pool."""
        if not self.disagg:
            return list(self.queue)
        if role == "prefill":
            return [r for r in self.queue
                    if r.state == "queued"
                    or (r.state == "preempted" and r.prefilling)]
        ready = [r for r in self.handoff
                 if self.eng.segment_resident(r.residual)]
        ready += [r for r in self.queue
                  if r.state == "preempted" and not r.prefilling]
        return sorted(ready, key=lambda r: (r.queued_since, r.rid))

    def _lane_shares(self, role: str, cands: list[Request]) -> dict[str, int]:
        """Target lane allocation per tenant for one pool: the daemon's quota
        split applied to lanes — demand = running + waiting, weighted,
        clamped."""
        _, lanes = self._pool(role)
        demands = self._running_by_tenant(lanes)
        for r in cands:
            demands[r.tenant] += 1
        caps = {t: len(lanes) for t in self.tenants}
        weights = {t: self.tenants[t].weight for t in self.tenants}
        return split_quota(len(lanes), demands, caps, weights)

    def _admit_pool(self, role: str) -> None:
        _, lanes = self._pool(role)
        if self._candidates(role):
            self._maybe_preempt(role)
        free = [ln for ln, r in enumerate(lanes) if r is None]
        while free:
            cands = self._candidates(role)
            if not cands:
                break
            shares = self._lane_shares(role, cands)
            running = self._running_by_tenant(lanes)
            heads: dict[str, Request] = {}
            for r in cands:                     # service order: first is head
                heads.setdefault(r.tenant, r)
            # the waiting tenant with the largest share deficit wins the
            # lane; deficit <= 0 everywhere falls back to FIFO
            pick = max(heads.values(),
                       key=lambda r: (shares.get(r.tenant, 0)
                                      - running[r.tenant],
                                      -r.queued_since, -r.rid))
            if shares.get(pick.tenant, 0) - running[pick.tenant] <= 0:
                pick = cands[0]
            if not self._install(pick, free[0], role):
                # no free KV segment for a fresh request — a preempted one
                # (which kept its segment) can still take the lane
                pre = next((r for r in cands if r.state == "preempted"), None)
                if pre is None or not self._install(pre, free[0], role):
                    break
            free.pop(0)

    def _install(self, req: Request, lane: int, role: str = "decode") -> bool:
        eng, lanes = self._pool(role)
        if req.state == "handoff":
            # decode-side hand-off: gather the ring window up through the
            # placement table (charged to the fabric's clock), then emit the
            # first token from the final chunk's logits
            residual = req.residual
            logits_row = residual.pop("logits")
            self._enter("handoff")
            self.handoff_bytes_in += eng.install_handoff(lane, residual)
            self._enter("decode")
            req.residual = None
            self.handoff.remove(req)
            req.state, req.lane = "running", lane
            lanes[lane] = req
            self._emit(req, logits_row)
            return True
        if req.state == "preempted":
            eng.resume_lane(lane, req.residual)
            req.residual = None
        else:
            if not self.free_segments:
                return False
            req.segment = self.free_segments.pop(0)
            req.admitted_step = self.step_count
            eng.reset_lane(lane)
            if eng.reuse is not None:
                # matched pages install as prefill reaches them; the match
                # holds one reference per page until the request ends
                res = eng.reuse.match(req.prompt, mode=self.scfg.reuse_match)
                req.matched = dict(res.pages)
                req.shared_gids = list(res.pages.values())
        req.state = "prefill" if role == "prefill" else "running"
        req.lane = lane
        lanes[lane] = req
        self.queue.remove(req)
        return True

    def _maybe_preempt(self, role: str = "decode") -> None:
        """Per-pool starvation guard: one preemption per step, only for a
        tenant that holds NO lane in this pool and whose waiting head has
        out-waited the patience."""
        _, lanes = self._pool(role)
        if any(r is None for r in lanes):
            return                            # a free lane serves them first
        running = self._running_by_tenant(lanes)
        starving = None
        for r in self._candidates(role):      # service order
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
        victim = max((r for r in lanes
                      if r is not None and r.tenant == victim_t),
                     key=lambda r: r.admitted_step)
        lane = victim.lane
        self._preempt(victim)
        # the freed lane goes to the starving head DIRECTLY — handing it to
        # the weighted-fair pick would return it to the hog and thrash
        self._install(starving, lane, role)

    def _preempt(self, req: Request) -> None:
        eng, lanes = self._pool("prefill" if req.state == "prefill" else "decode")
        lane = req.lane
        req.residual = eng.preempt_lane(lane)
        lanes[lane] = None
        req.state, req.lane = "preempted", -1
        req.queued_since = self.step_count
        req.preemptions += 1
        self.preemptions += 1
        self.queue.append(req)
        self.queued_peak = max(self.queued_peak, len(self.queue))

    def _to_handoff(self, lane: int, req: Request,
                    logits_row: np.ndarray) -> None:
        """Producer-side hand-off: detach a finished prefill from its lane
        and queue it for decode admission, its final-chunk logits riding
        along for the first token."""
        residual = self.peng.handoff_lane(lane)
        self.handoff_bytes_out += residual.pop("handoff_bytes")
        residual["logits"] = logits_row
        self.handoffs += 1
        self.pre_lanes[lane] = None
        req.residual = residual
        req.state, req.lane = "handoff", -1
        req.queued_since = self.step_count   # now waiting on the decode pool
        self.handoff.append(req)
        self.handoff_peak = max(self.handoff_peak, len(self.handoff))

    def _finish(self, req: Request) -> None:
        if self.eng.reuse is not None:
            # publish BEFORE the segment is recycled (the pool copy sources
            # from it), then drop this request's claims on shared pages
            stream = (np.concatenate(
                [req.prompt, np.asarray(req.out[:-1], np.int32)])
                if len(req.out) > 1 else req.prompt)
            self.eng.publish_lane(req.lane, stream)
            if req.shared_gids:
                self.eng.reuse.release(req.shared_gids)
                req.shared_gids = []
        self.lanes[req.lane] = None
        self.free_segments.append(req.segment)
        req.state, req.lane = "finished", -1
        req.finished_step = self.step_count
        self.finished.append(req)

    # -- token emission -------------------------------------------------------
    def _record(self, req: Request, tok: int, now: float,
                clock_now: float) -> None:
        """Append one output token, stamped with the step's completion."""
        req.out.append(tok)
        req.token_times.append(now)
        req.token_clock.append(clock_now)
        req.token_steps.append(self.step_count)
        if len(req.out) >= req.max_new:
            self._finish(req)

    def _emit(self, req: Request, logits_row: np.ndarray) -> None:
        """Emit one token outside the batched sweep (the hand-off's first
        token), with the same key fold as the batched draw."""
        tok = self._sample_one(req, logits_row)
        self._record(req, tok, time.perf_counter(), self._now("decode"))

    def _sample_one(self, req: Request, logits_row: np.ndarray) -> int:
        row = np.asarray(logits_row, np.float32)
        if self.scfg.temperature <= 0.0:
            return int(np.argmax(row))
        folded = dec.fold_lane_keys(req.key[None], len(req.out))
        return int(dec.sample_tokens(
            torch.as_tensor(row[None], device=self.eng.device), folded,
            temperature=self.scfg.temperature, top_p=self.scfg.top_p)[0])

    # -- the serving loop -----------------------------------------------------
    def step(self) -> None:
        """One scheduler iteration.  Unified: admit, advance every lane (one
        decode token, or one prefill chunk or matched-page install), sample
        and finish, meter per-tenant tier stats.  Disaggregated: hand-off
        admission, the prefill worker's turn on the prefill clock, then the
        decode worker's batched step on the decode clock."""
        self._enter("decode")
        try:
            if self.disagg:
                self._step_disagg()
            else:
                self._step_unified()
        finally:
            self._close_seg()

    def _step_disagg(self) -> None:
        self._admit_pool("decode")           # hand-offs may emit first tokens
        self._enter("prefill")
        self._admit_pool("prefill")
        self.prefill_busy.append(any(r is not None for r in self.pre_lanes))
        self._prefill_turn()
        self._enter("decode")
        self._decode_turn()
        self.step_count += 1

    def _install_run(self, eng: ServeEngine, lane: int, req: Request) -> int:
        """Content-addressed fast-forward (DESIGN.md §12): when the page at
        the lane's position is matched, install the whole consecutive run
        from the pool — no forward pass — charging its reads to the
        request's tenant.  Returns the tokens consumed (0: nothing to
        install here)."""
        page_t = eng.scfg.page_t
        j = req.pos // page_t
        if not (req.matched and req.pos % page_t == 0 and j in req.matched):
            return 0
        run: dict[int, int] = {}
        while j in req.matched:
            run[j] = req.matched.pop(j)
            j += 1
        fast_n, slow_n = eng.install_lane_pages(lane, run)
        st = self.tenant_stats[req.tenant]
        st.fast_reads += fast_n
        st.slow_reads += slow_n
        return len(run) * page_t

    def _chunk_piece(self, req: Request) -> np.ndarray:
        """The next prompt chunk, stopped at the next matched page (scanning
        past it would recompute what the pool already holds)."""
        page_t = self.eng.scfg.page_t
        end = req.pos + self.scfg.prefill_chunk
        gap = min((jj * page_t for jj in req.matched
                   if jj * page_t >= req.pos), default=end)
        return req.prompt[req.pos:min(end, gap)]

    def _prefill_turn(self) -> None:
        """The prefill worker's step: each busy prefill lane consumes one
        matched-page install or one chunk scan; a lane whose last chunk
        lands hands its request off (the final page is never matchable,
        so a hand-off always follows a scan)."""
        for lane, req in enumerate(list(self.pre_lanes)):
            if req is None:
                continue
            installed = self._install_run(self.peng, lane, req)
            if installed:
                req.pos += installed
                continue
            piece = self._chunk_piece(req)
            logits = self.peng.prefill_lane(lane, piece, req.segment,
                                            chunk=self.scfg.prefill_chunk)
            req.pos += int(piece.size)
            if not req.prefilling:
                self._to_handoff(lane, req, np.asarray(logits))
        if any(r is not None for r in self.pre_lanes):
            self._meter_pool(self.peng, self.pre_lanes)

    def _decode_turn(self) -> None:
        """The decode worker's step: one batched engine step over the decode
        lanes (every occupant is past its prompt)."""
        tokens = np.zeros(self.n_lanes, np.int32)
        active = np.zeros(self.n_lanes, bool)
        segments = np.full(self.n_lanes, -1, np.int32)
        for lane, req in enumerate(self.lanes):
            if req is None:
                continue
            segments[lane] = req.segment
            active[lane] = True
            tokens[lane] = req.out[-1]
        if not active.any():
            return
        logits = np.asarray(self.eng.advance_lanes(tokens, active, segments),
                            np.float32)
        self._meter_pool(self.eng, self.lanes)
        now, clock_now = time.perf_counter(), self._now("decode")
        sampled = self._sample(logits, active.astype(np.int32))
        for lane, req in enumerate(list(self.lanes)):
            if req is None:
                continue
            req.pos += 1
            self._record(req, self._token(sampled, logits, lane), now,
                         clock_now)

    def _step_unified(self) -> None:
        self._admit_pool("decode")
        chunk = self.scfg.prefill_chunk
        # a step is prefill-busy when a lane is mid-CHUNKED-prefill
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
            if req.prefilling:
                installed = self._install_run(self.eng, lane, req)
                if installed:
                    consumed[lane] = installed
                    continue
            if chunk > 0 and req.prefilling and req.n_prompt > chunk:
                piece = self._chunk_piece(req)
                chunk_logits[lane] = self.eng.prefill_lane(
                    lane, piece, req.segment, chunk=chunk)
                consumed[lane] = piece.size
                continue
            active[lane] = True
            consumed[lane] = 1
            tokens[lane] = (req.prompt[req.pos] if req.prefilling
                            else req.out[-1])
        if not (active.any() or chunk_logits):
            # install-only step (or nothing to do): no engine step ran and
            # no lane can emit — just advance the fast-forwarded positions
            for lane, req in enumerate(self.lanes):
                if req is not None and consumed[lane]:
                    req.pos += int(consumed[lane])
            self.step_count += 1
            return
        if active.any():
            logits = self.eng.advance_lanes(tokens, active, segments)
        else:
            logits = np.zeros((self.n_lanes, self.eng.cfg.vocab), np.float32)
        for lane, row in chunk_logits.items():
            logits[lane] = row
        # meter BEFORE the finish sweep (each request's final step of
        # resident-page reads must still be charged to its tenant)
        self._meter_pool(self.eng, self.lanes)
        now, clock_now = time.perf_counter(), self._now("decode")
        sampled = self._sample(logits, consumed)
        for lane, req in enumerate(list(self.lanes)):
            if req is None or consumed[lane] == 0:
                continue
            req.pos += int(consumed[lane])
            if not req.prefilling:           # last prompt token or decoding
                self._record(req, self._token(sampled, logits, lane), now,
                             clock_now)
        self.step_count += 1

    @staticmethod
    def _token(sampled: np.ndarray | None, logits: np.ndarray, lane: int) -> int:
        return int(sampled[lane]) if sampled is not None \
            else int(np.argmax(logits[lane]))

    def _sample(self, logits: np.ndarray,
                consumed: np.ndarray) -> np.ndarray | None:
        """Batched lane sampling on the engine's device (None in greedy mode:
        the caller takes the argmax).  Each emitting lane's key is its
        request's key folded with the emitted-token index, so the draws are
        a function of (seed, rid, token index) alone."""
        if self.scfg.temperature <= 0.0:
            return None
        dev = self.eng.device
        keys = torch.zeros((self.n_lanes, 2), dtype=torch.int64, device=dev)
        idx = np.zeros(self.n_lanes, np.int64)
        emitting = False
        for lane, req in enumerate(self.lanes):
            if req is None or consumed[lane] == 0 \
                    or req.pos + consumed[lane] < req.n_prompt:
                continue                      # still prefilling this step
            keys[lane] = req.key
            idx[lane] = len(req.out)
            emitting = True
        if not emitting:
            return None
        folded = dec.fold_lane_keys(keys, torch.as_tensor(idx, device=dev))
        return dec.sample_tokens(
            torch.as_tensor(logits, device=dev), folded,
            temperature=self.scfg.temperature, top_p=self.scfg.top_p
        ).cpu().numpy()

    @property
    def active(self) -> bool:
        """Any request still in flight (queued, pooled, or in hand-off)?"""
        return bool(self.queue or self.handoff
                    or any(r is not None for r in self.lanes)
                    or any(r is not None for r in self.pre_lanes))

    def run(self, max_steps: int = 10_000) -> None:
        """Drain: run until every submitted request finished (or the bound)."""
        while self.active:
            if self.step_count >= max_steps:
                raise RuntimeError(f"undrained after {max_steps} steps")
            self.step()

    # -- telemetry ------------------------------------------------------------
    def _meter_pool(self, eng: ServeEngine, lanes: list) -> None:
        """Account each lane's resident KV pages against its tenant: a page
        the placement map holds fast is a per-tenant fast read.  Runs before
        the finish sweep over the explicit occupancy mask, so a finishing
        request's final step — and a chunk-prefilling lane the engine's own
        active mask no longer carries — is still charged."""
        occupied = np.array([r is not None for r in lanes], bool)
        view = eng._kv_lane_stream(active=occupied)
        if view is None:              # no ring: nothing resident to meter
            return
        _, gids = view
        _, hit = eng.daemon["kv"].lookup(eng._ids(gids.reshape(-1)))
        hit = hit.cpu().numpy().reshape(gids.shape)
        valid = gids >= 0
        for lane, req in enumerate(lanes):
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
        """The traffic-bench schema row for this run (BENCH_serve.json)."""
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
            "mode": "disagg" if self.disagg else "unified",
            "prefill_lanes": self.scfg.prefill_lanes,
            "clock": {"prefill_s": self.clock["prefill"],
                      "handoff_s": self.clock["handoff"],
                      "decode_s": self.clock["decode"]},
            "handoff": {"count": self.handoffs,
                        "bytes_out": self.handoff_bytes_out,
                        "bytes_in": self.handoff_bytes_in,
                        "depth_peak": self.handoff_peak},
            **self._latency_rows(done),
            "tenants": tenants,
            "resources": self.eng.tier_stats(),
        }
