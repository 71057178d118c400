"""Trace-driven multi-tenant workloads: the traffic NeoMem's payoff needs.

A copy of ``repro/workloads/traces.py`` (numpy only), kept draw for draw:
the same seed gives the same arrivals — steps, tenants, prompt tokens and
``max_new`` — for every kind and arrival process.

The paper evaluates adaptivity against *shifting* access patterns (dynamic
hotspots, antagonist scans); HybridTier stresses workload drift, and the
CXL-at-scale study shows contention tails are the metric that matters.  This
module generates the request-level analogue: seeded, replayable arrival
traces for the scheduler (`serve/sched.py`), where each tenant draws prompt
CONTENT from a distribution the tiering daemon can (or cannot) exploit:

  * ``zipf-hot``        — every tenant samples tokens from a static Zipf
                          head: a stable hot set the sketch should find and
                          pin (the daemon's best case).
  * ``diurnal-shift``   — the Zipf head rotates through the vocab every
                          ``shift_period`` scheduler steps: the hot set
                          drifts and the placement map must follow
                          (Fig. 16-style convergence, continuously).
  * ``scan-antagonist`` — tenant 0 keeps its Zipf head while tenant 1 sweeps
                          the vocab sequentially: the scan has no reusable
                          hot set, thrashes promotions, and drags the
                          steady-state hit rate below ``zipf-hot`` — the
                          adaptivity gap the traffic benchmark asserts.
  * ``prefill-heavy``   — a prompt-length mixture built for the prefill/
                          decode disaggregation A/B (DESIGN.md §13): a
                          "chat" tenant streams short prompts with LONG
                          outputs (steady decode occupancy) while a "doc"
                          tenant drops long prompts with short outputs
                          (each arrival is a prefill wall).  Under the
                          unified scheduler every doc prompt's chunk scans
                          stall the chat tenant's decode steps; with a
                          dedicated prefill pool the walls move off the
                          decode worker's clock — the TPOT-flatness gate
                          ``benchmarks/traffic_bench.py`` asserts.  Token
                          content is the static Zipf head (as ``zipf-hot``);
                          the SHAPE mixture is the workload.  Defaults to
                          :data:`PREFILL_HEAVY_TENANTS` when no explicit
                          tenant set is passed.
  * ``prod-mixture``    — production prompt-LENGTH mixture: each arrival
                          draws its prompt length from a two-component
                          lognormal — a dominant short conversational mode
                          plus a long-context document tail — the bimodal
                          shape public serving traces show (the Azure LLM
                          inference traces of the Splitwise/DistServe line
                          of work: most requests are short, the byte mass
                          lives in the tail).  Token content is the static
                          Zipf head (as ``zipf-hot``), so against
                          ``zipf-hot`` it isolates what REALISTIC length
                          dispersion — ragged prefill walls, uneven segment
                          occupancy — does to tiering and scheduling.
                          Lengths are clipped to the KV segment budget
                          (``max_total`` minus the output reservation).
  * ``agentic``         — multi-turn tool-agent sessions, the workload the
                          content-addressed KV store (DESIGN.md §12) exists
                          for.  Each tenant owns one fixed system prompt S;
                          each conversation replays its FULL context every
                          turn: ``prompt_t = S + u_1 .. u_t + W_t`` where
                          the user-turn history is append-only and ``W_t``
                          is a fixed-length working block (scratchpad /
                          tool output) that MUTATES between turns.  Because
                          the mutation sits at the END, every history page
                          keeps a stable causal-chain hash turn over turn —
                          so cross-turn KV reuse is exact, and when pool
                          pressure evicts front-of-history pages, substring
                          matching recovers the surviving tail while prefix
                          matching stalls at the first hole (the
                          MemGPT-style gap ``kv_reuse`` asserts).  Turns of
                          one conversation are spaced ``turn_gap`` steps
                          apart so turn ``t`` publishes before ``t+1``
                          arrives; for this kind ``prompt_len`` bounds the
                          per-TURN user block, not the whole prompt.

Arrival PROCESSES are deliberately identical across the three content kinds
for the same (seed, arrival) pair (same per-step draws, same prompt/output
lengths) — only token content differs, so hit-rate deltas between traces
measure the access pattern, not accidental load differences.  ``agentic``
and ``prod-mixture`` are the exceptions: the agentic session structure
(spaced turns, growing prompts) and the lognormal length draws ARE those
workloads, so their structural draw sequences diverge from the shared-load
trio by construction.

Two arrival processes (the CXL-at-scale study's point: tails live in the
bursts, not the means):

  * ``bernoulli`` — independent P(arrival)=rate per tenant per step (the
    original process; the default).
  * ``mmpp``      — a 2-state Markov-modulated Bernoulli process: one
    hidden calm/burst chain (drawn from the shared STRUCTURAL stream, so
    every kind sees the same bursts) scales all tenants' rates by
    ``calm_scale``/``burst_scale``.  The stationary mean rate equals the
    Bernoulli process's, so MMPP changes burstiness — queueing, p99,
    preemption pressure — with the same offered load.  (Mean parity
    requires ``rate * MMPP_BURST_SCALE <= 1``; a hotter tenant saturates
    at probability 1 during bursts and ``make_trace`` warns.)
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

TRACE_KINDS = ("zipf-hot", "diurnal-shift", "scan-antagonist",
               "prefill-heavy", "agentic", "prod-mixture")
ARRIVAL_KINDS = ("bernoulli", "mmpp")

# ``prod-mixture`` length model: (meanlog, sdlog) per lognormal component
# and the short component's mixture share.  exp(meanlog) ~ median length:
# ~7-token conversational prompts ~70% of the time, a ~27-token document
# tail otherwise — the bimodal public-trace shape scaled to the serve
# benches' max_seq=56 segments.
PROD_MIX_SHORT = (1.9, 0.45)
PROD_MIX_LONG = (3.3, 0.25)
PROD_MIX_SHORT_SHARE = 0.7

# MMPP defaults: calm->burst 0.05, burst->calm 0.25 => stationary burst
# share 1/6; burst triples the rate and calm_scale is solved so the
# stationary mean equals the plain Bernoulli rate.
MMPP_P01, MMPP_P10 = 0.05, 0.25
MMPP_BURST_SCALE = 3.0
_PI_B = MMPP_P01 / (MMPP_P01 + MMPP_P10)
MMPP_CALM_SCALE = (1.0 - _PI_B * MMPP_BURST_SCALE) / (1.0 - _PI_B)


@dataclasses.dataclass(frozen=True)
class TenantProfile:
    """One tenant's traffic shape (weights feed the scheduler's fair split)."""

    name: str
    weight: float = 1.0
    rate: float = 0.2              # P(one arrival) per scheduler step
    prompt_len: tuple[int, int] = (8, 17)    # [lo, hi) token range
    out_len: tuple[int, int] = (4, 13)       # [lo, hi) output-token range


@dataclasses.dataclass(frozen=True)
class Arrival:
    step: int                      # scheduler step the request arrives at
    tenant: str
    tokens: np.ndarray             # (P,) int32 prompt
    max_new: int


@dataclasses.dataclass(frozen=True)
class Trace:
    kind: str
    seed: int
    vocab: int
    n_steps: int
    tenants: tuple[TenantProfile, ...]
    arrivals: tuple[Arrival, ...]
    arrival: str = "bernoulli"     # arrival process (see module docstring)

    def by_step(self) -> dict[int, list[Arrival]]:
        out: dict[int, list[Arrival]] = {}
        for a in self.arrivals:
            out.setdefault(a.step, []).append(a)
        return out


DEFAULT_TENANTS = (
    TenantProfile("interactive", weight=2.0, rate=0.22,
                  prompt_len=(6, 13), out_len=(4, 9)),
    TenantProfile("batch", weight=1.0, rate=0.12,
                  prompt_len=(10, 21), out_len=(8, 17)),
)

# The disaggregation A/B's shape mixture (``kind="prefill-heavy"``):
# "chat" keeps decode lanes streaming, "doc" keeps dropping prompt walls.
# Sized for the serve benches' max_seq=56 segments (prompt + out <= 45).
PREFILL_HEAVY_TENANTS = (
    TenantProfile("chat", weight=2.0, rate=0.25,
                  prompt_len=(4, 9), out_len=(14, 21)),
    TenantProfile("doc", weight=1.0, rate=0.09,
                  prompt_len=(28, 41), out_len=(2, 5)),
)


@functools.lru_cache(maxsize=8)
def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** a
    return p / p.sum()


def _zipf_tokens(rng: np.random.Generator, n: int, vocab: int, a: float,
                 phase: int) -> np.ndarray:
    """Zipf-ranked tokens; ``phase`` rotates which ids form the hot head."""
    ranks = rng.choice(vocab, size=n, p=_zipf_probs(vocab, a))
    return ((ranks + phase) % vocab).astype(np.int32)


def _agentic_arrivals(struct: np.random.Generator,
                      content: np.random.Generator,
                      tenants: tuple[TenantProfile, ...], *, n_steps: int,
                      vocab: int, zipf_a: float, turn_gap: int,
                      sys_len: int, n_convs: int, work_len: int,
                      max_total: int) -> list[Arrival]:
    """Multi-turn sessions: ``prompt_t = S + u_1 .. u_t + W_t``.

    The system prompt S is per-TENANT (every conversation of a tenant
    shares it — those pages stay hot in the reuse pool); the user-turn
    history is append-only (stable chain hashes, the reuse substrate); the
    working block W_t re-draws every turn (the mutation that ends prefix
    matching exactly at the history/working boundary).  A conversation
    stops growing when the next turn's prompt + output would exceed
    ``max_total`` (the scheduler rejects requests longer than a KV
    segment), and its turns are ``turn_gap``-spaced with small structural
    jitter so the previous turn has published before the next arrives.
    """
    arrivals: list[Arrival] = []
    for t in tenants:
        sys_p = content.integers(0, vocab, size=sys_len).astype(np.int32)
        for _ in range(n_convs):
            step = int(struct.integers(0, max(1, n_steps // 3)))
            history = [sys_p]
            hist_len = sys_len
            while step < n_steps:
                ulen = int(struct.integers(*t.prompt_len))
                n_out = int(struct.integers(*t.out_len))
                if hist_len + ulen + work_len + n_out > max_total:
                    break                      # context budget exhausted
                history.append(
                    _zipf_tokens(content, ulen, vocab, zipf_a, 0))
                hist_len += ulen
                work = content.integers(0, vocab, size=work_len
                                        ).astype(np.int32)
                arrivals.append(Arrival(
                    step=step, tenant=t.name,
                    tokens=np.concatenate(history + [work]),
                    max_new=n_out))
                step += turn_gap + int(struct.integers(0, 4))
    arrivals.sort(key=lambda a: (a.step, a.tenant))
    return arrivals


def make_trace(kind: str, *, n_steps: int = 200, vocab: int = 256,
               tenants: tuple[TenantProfile, ...] = DEFAULT_TENANTS,
               seed: int = 0, zipf_a: float = 1.4,
               shift_period: int = 64, arrival: str = "bernoulli",
               turn_gap: int = 24, sys_len: int = 12, n_convs: int = 3,
               work_len: int = 4, max_total: int = 56) -> Trace:
    """Build one seeded, replayable arrival trace (see module docstring).

    The structural draws (the MMPP modulation chain, arrival steps,
    prompt/output lengths) come from a dedicated RNG stream shared by every
    kind; token content comes from a second stream — so for a fixed
    (seed, arrival) pair, traces of different kinds carry the SAME load at
    the same steps and differ only in what they touch.  The ``turn_gap`` /
    ``sys_len`` / ``n_convs`` / ``work_len`` knobs apply to
    ``kind="agentic"`` only (see :func:`_agentic_arrivals`); ``max_total``
    also caps ``kind="prod-mixture"``'s lognormal prompt lengths.
    """
    if kind not in TRACE_KINDS:
        raise KeyError(f"unknown trace kind {kind!r}; known: {TRACE_KINDS}")
    if arrival not in ARRIVAL_KINDS:
        raise KeyError(
            f"unknown arrival process {arrival!r}; known: {ARRIVAL_KINDS}")
    if kind == "prefill-heavy" and tenants is DEFAULT_TENANTS:
        tenants = PREFILL_HEAVY_TENANTS   # the mixture IS the workload
    struct = np.random.default_rng(np.random.SeedSequence([seed, 0xA11]))
    content = np.random.default_rng(np.random.SeedSequence([seed, 0xB22]))
    if kind == "agentic":
        arrivals = _agentic_arrivals(
            struct, content, tenants, n_steps=n_steps, vocab=vocab,
            zipf_a=zipf_a, turn_gap=turn_gap, sys_len=sys_len,
            n_convs=n_convs, work_len=work_len, max_total=max_total)
        return Trace(kind=kind, seed=seed, vocab=vocab, n_steps=n_steps,
                     tenants=tuple(tenants), arrivals=tuple(arrivals),
                     arrival=arrival)
    # The MMPP calm/burst chain is drawn FIRST, from the structural stream:
    # identical modulation (and identical subsequent draws) for every kind.
    rate_scale = np.ones(n_steps)
    if arrival == "mmpp":
        hot = [t.name for t in tenants if t.rate * MMPP_BURST_SCALE > 1.0]
        if hot:
            import warnings
            warnings.warn(
                f"MMPP burst rate saturates at 1 for tenants {hot} "
                f"(rate > {1.0 / MMPP_BURST_SCALE:.3f}): the stationary "
                "mean will fall below the Bernoulli process's",
                stacklevel=2)
        state = 0                               # start calm (stationary mode)
        for step in range(n_steps):
            flip = struct.random()
            state = (1 - state) if flip < (MMPP_P01, MMPP_P10)[state] else state
            rate_scale[step] = (MMPP_CALM_SCALE, MMPP_BURST_SCALE)[state]
    scan_cursor = 0
    arrivals: list[Arrival] = []
    for step in range(n_steps):
        for ti, t in enumerate(tenants):
            if struct.random() >= min(1.0, t.rate * rate_scale[step]):
                continue
            if kind == "prod-mixture":
                # two-component lognormal prompt length (struct stream —
                # this kind is exempt from the identical-load invariant),
                # clipped to what fits a KV segment next to the output
                n_out = int(struct.integers(*t.out_len))
                mu, sig = (PROD_MIX_SHORT
                           if struct.random() < PROD_MIX_SHORT_SHARE
                           else PROD_MIX_LONG)
                plen = int(np.clip(int(round(struct.lognormal(mu, sig))),
                                   1, max(1, max_total - n_out - 1)))
            else:
                plen = int(struct.integers(*t.prompt_len))
                n_out = int(struct.integers(*t.out_len))
            if kind == "scan-antagonist" and ti == 1:
                # the antagonist sweeps the vocab with no reuse
                tokens = ((scan_cursor + np.arange(plen)) % vocab
                          ).astype(np.int32)
                scan_cursor = (scan_cursor + plen) % vocab
            else:
                phase = ((step // shift_period) * (vocab // 3)
                         if kind == "diurnal-shift" else 0)
                tokens = _zipf_tokens(content, plen, vocab, zipf_a, phase)
            arrivals.append(Arrival(step=step, tenant=t.name, tokens=tokens,
                                    max_new=n_out))
    return Trace(kind=kind, seed=seed, vocab=vocab, n_steps=n_steps,
                 tenants=tuple(tenants), arrivals=tuple(arrivals),
                 arrival=arrival)


def play(trace: Trace, sched, *, max_steps: int | None = None,
         on_step=None) -> None:
    """Replay a trace into a Scheduler: submit each step's arrivals, step
    the engine, then drain until every request finished.  ``on_step`` (if
    given) is called with the scheduler after every step — benchmark hooks
    such as the steady-state counter snapshot."""
    due = trace.by_step()
    horizon = max_steps or max(2000, 50 * trace.n_steps)
    # drain through Scheduler.active: queued, pooled (decode AND prefill
    # lanes), and hand-offs in flight all keep the loop going
    while sched.step_count < trace.n_steps or sched.active:
        if sched.step_count >= horizon:
            raise RuntimeError(f"trace undrained after {horizon} steps")
        for a in due.get(sched.step_count, []):
            sched.submit(a.tenant, a.tokens, a.max_new)
        sched.step()
        if on_step is not None:
            on_step(sched)
