"""Serving engine: paged prefill + decode with the NeoMem-tiered KV cache.

Port of ``repro/serve/engine.py`` in single-request paged mode, the main
path of DESIGN.md §10:

  * ``prefill(tokens)`` — the prompt streams through the paged ring in
    ring-capacity chunks; each chunk's pages are flushed down to the KV
    slow store before the ring can wrap over them;
  * ``step(token)`` — one decode step for the batch, lockstep;
  * NeoMem — per step the paged-attention kernel's per-page softmax mass
    becomes the "kv" page stream (``KVPagesResource``), NeoProf's sketch
    takes it, and every ``migration_interval`` steps the daemon ticks:
    hot pages are promoted with 2Q and their bytes move between the
    pinned-host slow store and the device fast buffer.

``ServeConfig`` holds the fields this path reads.  Lane mode, the
embeddings and experts resources and in-step tier reads are not yet
ported: a ``ServeConfig`` that asks for one raises, as does
``paged=False``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode as dec
from repro_torch.serve.clock import TickClock
from repro_torch.tiering.daemon import NeoMemDaemon
from repro_torch.tiering.memory import DaemonParams
from repro_torch.tiering.resource import ResourceSpec
from repro_torch.tiering.resources import KVPagesResource


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 4096
    page_t: int = 64
    hot_slots: int = 16
    paged: bool = False
    migration_interval: int = 8     # decode steps between daemon ticks
    kv_quota: int = 64
    kv_mass_threshold: float = 0.02
    # reference features that wait for later slices: any value but the
    # default here raises in ServeEngine
    resources: tuple[str, ...] = ()
    lanes: int = 0
    jit_tier_reads: bool = False


_NOT_YET_PORTED = {
    "paged": (lambda s: not s.paged, "dense (paged=False) serving"),
    "resources": (lambda s: bool(s.resources), "the embeddings/experts resources"),
    "lanes": (lambda s: s.lanes > 0, "lane mode"),
    "jit_tier_reads": (lambda s: s.jit_tier_reads, "in-step tier reads"),
}


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig, *,
                 device="cuda", sketch_seeds: torch.Tensor | None = None):
        """``sketch_seeds`` are the KV sketch's (D, 30) H3 seeds (default:
        drawn from a generator seeded with 0)."""
        for field, (asks, what) in _NOT_YET_PORTED.items():
            if asks(scfg):
                raise NotImplementedError(
                    f"ServeConfig.{field}={getattr(scfg, field)!r}: {what} is "
                    "not yet ported to repro_torch")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = torch.device(device)
        self.daemon = NeoMemDaemon(DaemonParams(), device=self.device)
        self._register_resources(sketch_seeds)
        self.cache = None
        self._clock = TickClock(scfg.migration_interval)
        self._decode_s = 0.0            # decode wall time
        self._last_kv_mass = None       # (B, n_slots) kernel mass, post-step
        # ring slot -> (page id, fill) at its last flush (change tracking)
        self._kv_flushed: dict[tuple[int, int], tuple[int, int]] = {}

    def _register_resources(self, seeds) -> None:
        cfg, scfg = self.cfg, self.scfg
        row_shape = (cfg.n_groups, scfg.page_t, cfg.n_kv_heads, 2 * cfg.head_dim)
        spec = ResourceSpec(
            "kv", n_pages=self.pages_per_seq, hot_slots=scfg.hot_slots,
            quota_pages=scfg.kv_quota, row_shape=row_shape,
            row_dtype="bfloat16")
        handle = self.daemon.register(
            KVPagesResource(spec, mass_threshold=scfg.kv_mass_threshold),
            seeds=seeds)
        # the slow tier starts as zero scratch, in host memory when the
        # engine runs on the card; pages are flushed down as the ring fills
        payload = torch.zeros((spec.n_pages,) + row_shape, dtype=torch.bfloat16,
                              pin_memory=self.device.type == "cuda")
        handle.bind_data(payload, initially_valid=False)

    # -- public API -----------------------------------------------------------
    @property
    def pages_per_seq(self) -> int:
        """Logical KV pages of one max_seq sequence."""
        return self.scfg.max_seq // self.scfg.page_t

    @property
    def _chunk_cap(self) -> int:
        """Ring-wrap safety bound on one prefill chunk: the ring minus the
        slot it may be mid-filling, so no unflushed page is overwritten."""
        return max((self.scfg.hot_slots - 1) * self.scfg.page_t, 1)

    def prefill(self, tokens: np.ndarray) -> np.ndarray:
        b, s = tokens.shape
        self.cache = dec.init_paged_cache(self.cfg, b, self.scfg.hot_slots,
                                          self.scfg.page_t, device=self.device)
        self._kv_flushed.clear()
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        logits = None
        for off in range(0, s, self._chunk_cap):
            logits = self._prefill_chunk(tokens[:, off:off + self._chunk_cap])
        return logits.argmax(-1).cpu().numpy()

    def _prefill_chunk(self, tok: torch.Tensor) -> torch.Tensor:
        """One paged prefill chunk: advance the ring, observe the chunk's
        summed kernel mass once, flush its pages, tick the daemon for the
        chunk's worth of steps.  Returns the (B, V) last logits."""
        n = tok.shape[1]
        logits, self.cache, streams = dec.prefill_paged(
            self.cfg, self.params, self.cache, tok, page_t=self.scfg.page_t,
            collect_mass=True)
        _, ids = self._kv_page_stream()
        # (C, G, n_attn, B, S) averaged over groups, positions and lockstep
        # rows, summed over the chunk (DESIGN.md §10)
        mass = streams["kv_mass"].mean(dim=(1, 2, 3)).sum(dim=0)
        self.daemon.observe("kv", mass, ids)
        self._flush_kv_slow()
        self._maybe_tick(n)
        return logits

    def step(self, token: np.ndarray) -> np.ndarray:
        tok = torch.as_tensor(np.asarray(token), dtype=torch.long,
                              device=self.device)[:, None]
        logits = self._advance(tok)
        return logits[:, -1].argmax(-1).cpu().numpy()

    def generate(self, prompt: np.ndarray, n_tokens: int) -> np.ndarray:
        nxt = self.prefill(prompt)
        out = [nxt]
        for _ in range(n_tokens - 1):
            nxt = self.step(nxt)
            out.append(nxt)
        return np.stack(out, axis=1)

    # -- decode + NeoMem observation/cadence ----------------------------------
    def _advance(self, tok: torch.Tensor) -> torch.Tensor:
        """One decode step: the paged body, the tiering stream, the cadence."""
        t0 = time.perf_counter()
        logits, self.cache, streams = dec.decode_step_paged(
            self.cfg, self.params, self.cache, tok, page_t=self.scfg.page_t,
            return_streams=True)
        self._set_kv_mass(streams)
        self._observe()
        self._maybe_tick()
        self._decode_s += time.perf_counter() - t0
        return logits

    def _set_kv_mass(self, streams: dict) -> None:
        """Hold the step's (B, n_slots) page mass: the (G, n_attn, B, S)
        stream averaged over layer groups and attention positions."""
        km = streams.get("kv_mass")
        self._last_kv_mass = km.mean(dim=(0, 1)) if km is not None else None

    def _observe(self) -> None:
        _, ids = self._kv_page_stream()
        # batch rows advance in lockstep over the same page ids, so the row
        # mean is the device's aggregate view of the step's attention mass
        self.daemon.observe("kv", self._last_kv_mass.mean(dim=0), ids)

    def _paged_entry(self) -> dict:
        """The representative paged-attention cache entry (first in pattern)."""
        return self.cache["blocks"][0]

    def _ring_view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host view of the ring: (page_len (B, S), cur_slot (B,), pos (B,)).
        Group 0 is representative — all groups advance in lockstep."""
        entry = self._paged_entry()
        plen = entry["page_len"][0].cpu().numpy()
        cur = entry["cur_slot"][0].cpu().numpy()
        pos = np.broadcast_to(self.cache["pos"].cpu().numpy(), cur.shape)
        return plen, cur, pos

    @staticmethod
    def _ring_page_ids(plen: np.ndarray, cur: np.ndarray, pos: np.ndarray,
                       page_t: int) -> np.ndarray:
        """Per-row logical page id of every ring slot ((B, S); -1 = empty).

        cur_slot advances eagerly when a page fills, so the page being
        filled at cur is always floor(pos / page_t) — also on boundaries."""
        n_slots = plen.shape[1]
        cur_page = pos // page_t
        slots = np.arange(n_slots)[None]
        ids = cur_page[:, None] - (cur[:, None] - slots) % n_slots
        return np.where((plen > 0) & (ids >= 0), ids, -1)

    def _kv_page_stream(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Resident ring window as (per-page fill, logical page ids), batch
        row 0 representative.  The fill is the flush's change key; the
        observed mass is the kernel's."""
        plen, cur, pos = self._ring_view()
        ids = self._ring_page_ids(plen, cur, pos, self.scfg.page_t)[0]
        return (torch.as_tensor(plen[0], dtype=torch.float32, device=self.device),
                torch.as_tensor(ids, dtype=torch.int32, device=self.device))

    def _flush_kv_slow(self) -> None:
        """Flush the ring's changed pages down to the KV data plane (slow
        store always, fast copies of promoted pages too), batch row 0 as
        the representative payload; the bytes are metered as flush_bytes."""
        h = self.daemon["kv"]
        plen, cur, pos = self._ring_view()
        ids = self._ring_page_ids(plen, cur, pos, self.scfg.page_t)[0]
        fill = plen[0].astype(np.int64)
        changed = np.array([
            self._kv_flushed.get((0, slot)) != (int(ids[slot]), int(fill[slot]))
            for slot in range(ids.shape[0])])
        ids = np.where(changed, ids, -1)             # -1 lanes are dropped
        if not (ids >= 0).any():
            return
        entry = self._paged_entry()
        h.write_pages(ids, entry["k_pages"][:, :1], entry["v_pages"][:, :1])
        for slot in np.flatnonzero(ids >= 0):
            self._kv_flushed[(0, int(slot))] = (int(ids[slot]), int(fill[slot]))

    @property
    def step_count(self) -> int:
        """Engine steps so far (decode steps + prefilled prompt positions)."""
        return self._clock.steps

    def _maybe_tick(self, n: int = 1) -> None:
        """Advance the step counter by ``n`` and run one daemon tick per
        migration-interval boundary crossed, flushing the KV ring first."""
        for _ in range(self._clock.advance(n)):
            self._flush_kv_slow()
            self.daemon.tick()

    # -- telemetry ------------------------------------------------------------
    def tier_stats(self) -> dict[str, dict]:
        """Per-resource telemetry rows (the BENCH_serve.json schema)."""
        for h in self.daemon.resources.values():
            h.stats.decode_s = self._decode_s
        return self.daemon.snapshot()
