"""Serving engine: prefill + decode with NeoMem-tiered resources.

Port of ``repro/serve/engine.py`` (DESIGN.md §9, §10), with two serving
modes over one machinery:

  * single-request (``prefill``/``step``/``generate``) — one batched
    prompt decoded lockstep, scalar position, with ``aux_embeds`` for the
    cross blocks (an image's patches; whisper's frames, encoded once at
    prefill).  Dense (``paged=False``, the
    default): the full cache of ``max_seq`` positions, one pass of
    ``decode.prefill_dense`` over the prompt whose streams are observed as
    one batch, then ``decode.decode_step``; no "kv" resource.  Paged: the
    prompt streams through the paged ring in ring-capacity chunks, each
    chunk's pages flushed down to the KV slow store before the ring can
    wrap over them;
  * continuous-batching lanes (``ServeConfig.lanes > 0``) — the batch
    becomes independent decode lanes with per-lane positions, driven one
    token per lane per ``advance_lanes`` call (or one chunk of one lane's
    prompt per ``prefill_lane`` call) by the request scheduler
    (serve/sched.py); the KV slow store is carved into per-request
    segments, and lanes reset/preempt/resume mid-flight, bitwise.

NeoMem: per paged step the attention kernel's per-page softmax mass becomes
the "kv" page stream (``KVPagesResource``; ``ServeConfig.kv_mass_source=
"fill"`` feeds each page's fill instead, the A/B baseline of the mass
fidelity gate), the token column the "embeddings" stream
(``EmbedRowsResource``) and, on a MoE arch, the router's token->expert ids
the "experts" stream (``ExpertStreamResource``); NeoProf's sketch takes
each, and every ``migration_interval`` steps the daemon ticks for every
resource under one quota budget: hot pages are promoted with 2Q and their
bytes move between the pinned-host slow store and the device fast buffer.
With ``jit_tier_reads`` the step itself reads its embedding rows and its
experts' weight rows through their placement tables
(``tiering/migrate.py::lookup_rows``).

Lane mode also serves, as the reference does:

  * the slow-store codecs (``ServeConfig.slow_codec``, DESIGN.md §14):
    every resource's slow store at rest in its wire format, int8 rows and
    their scales crossing the link as stored and decoded on the device;
  * content-addressed KV reuse (``reuse_pages``, DESIGN.md §12): a shared
    pool of pages above the private segments, admission-matched pages
    installed without a forward pass, finished requests published into
    the pool, and a copy-on-write ring that never writes a shared page
    back;
  * disaggregated prefill/decode (``attach_to``, DESIGN.md §13): a worker
    engine over the owner's daemon, stores and reuse pool, handing
    finished prefills over through the slow store.

Every mode serves on either data plane: the synchronous one, or with
``ServeConfig.async_migration`` the asynchronous one (DESIGN.md §15),
whose epoch copies run on a side CUDA stream while decode reads the last
committed placement.  ``save_tiering`` / ``load_tiering`` checkpoint every
resource's placement and profiling state (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.cache import KVReuseStore
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import decode as dec
from repro_torch.models.transformer import encode
from repro_torch.serve.clock import TickClock
from repro_torch.tiering.daemon import NeoMemDaemon, ResourceHandle
from repro_torch.tiering.memory import DaemonParams
from repro_torch.tiering.migrate import segment_page_ids
from repro_torch.tiering.resource import ResourceSpec
from repro_torch.tiering.resources import (EMBED_ROWS_PER_PAGE,
                                           EmbedRowsResource,
                                           ExpertStreamResource,
                                           KVPagesResource)


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 4096
    page_t: int = 64
    hot_slots: int = 16
    paged: bool = False
    migration_interval: int = 8     # decode steps between daemon ticks
    # tiered resources to register ("kv" is implied by paged=True and
    # requires it)
    resources: tuple[str, ...] = ()
    kv_quota: int = 64
    kv_mass_threshold: float = 0.02
    # "kv" hotness stream source (DESIGN.md §10): "kernel" feeds the
    # attention kernel's per-page softmax mass; "fill" the ring's per-page
    # fill (page_len), the proxy the kernel mass replaced
    kv_mass_source: str = "kernel"
    expert_hot_slots: int = 4       # device-resident experts per layer group
    expert_quota: int = 32
    embed_hot_slots: int = 64       # hot vocab row-blocks kept on the device
    embed_quota: int = 64
    embed_rows_per_page: int = 0    # vocab rows per page (0 -> package default)
    # Continuous-batching lane mode (serve/sched.py, DESIGN.md §9): the
    # batch becomes `lanes` independent decode lanes with per-lane
    # positions; the KV slow store is carved into `kv_segments` per-request
    # address spaces of max_seq // page_t pages each.
    lanes: int = 0                  # decode lanes (0 = single-request mode)
    kv_segments: int = 0            # slow-store KV segments (0 -> lanes)
    kv_tier_slots: int = 0          # kv fast-tier slots (0 -> hot_slots)
    # read embedding rows and expert weights in-step through the tiered
    # store (off = the dense table and expert weights)
    jit_tier_reads: bool = True
    # slow-store wire format of every resource (tiering/codec.py, DESIGN.md
    # §14): "none" native rows, "fp32" full precision, "int8" per-row
    # symmetric quantization decoded on the device
    slow_codec: str = "none"
    # content-addressed KV reuse (repro_torch.cache, DESIGN.md §12): shared
    # pool pages appended to the KV slow store; lane mode only, 0 = off
    reuse_pages: int = 0
    # asynchronous data plane (DESIGN.md §15): epoch copies issued on a
    # side stream and committed at a later tick, overlapped with decode
    async_migration: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig, *,
                 device="cuda", sketch_seeds: torch.Tensor | None = None,
                 ep_axes=None, attach_to: "ServeEngine | None" = None):
        """``sketch_seeds`` are every resource's (D, 30) H3 seeds (default:
        drawn from a generator seeded with 0), as the reference seeds every
        resource's sketch from one key.

        ``attach_to`` builds a WORKER engine over another engine's tiered
        store (DESIGN.md §13): the daemon, every resource handle and the
        reuse pool are shared with ``attach_to``.  Only the lane count may
        differ (preemption residuals move between the two engines' lanes),
        and the worker never ticks the shared daemon.

        ``ep_axes`` (a :class:`repro_torch.models.moe.EPContext`) runs every
        decode and prefill's MoE layers expert-parallel over its mesh
        (``params``' expert stacks then this rank's blocks); the experts
        resource still profiles the router stream, but its tier view is
        withheld, so that the expert-parallel layer serves."""
        if scfg.lanes and not scfg.paged:
            raise ValueError("lane mode (ServeConfig.lanes) requires paged=True")
        if scfg.kv_mass_source not in ("kernel", "fill"):
            raise ValueError(
                f"kv_mass_source must be 'kernel' or 'fill', "
                f"got {scfg.kv_mass_source!r}")
        if scfg.reuse_pages:
            if not scfg.lanes:
                raise ValueError(
                    "reuse_pages requires lane mode (ServeConfig.lanes > 0)")
            if not dec.reuse_eligible(cfg):
                raise ValueError(
                    f"arch {cfg.name!r} is not reuse-eligible: the KV slow "
                    f"store must carry the whole per-position state (single "
                    f"attention pattern position, no recurrent blocks, no "
                    f"dense prologue)")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.ep = ep_axes
        self.device = torch.device(device)
        self._embed_rpp = scfg.embed_rows_per_page or EMBED_ROWS_PER_PAGE
        self._daemon_owner = attach_to is None
        if attach_to is not None:
            self._check_attach_geometry(attach_to)
            self.daemon = attach_to.daemon
            self.reuse = attach_to.reuse
            self.reuse_mass = attach_to.reuse_mass
        else:
            self.daemon = NeoMemDaemon(
                DaemonParams(async_plane=scfg.async_migration), device=self.device)
            self._register_resources(sketch_seeds)
            # the shared pool's page ids sit above every private segment
            self.reuse = None
            self.reuse_mass = {"shared": 0.0, "total": 0.0}
            if scfg.reuse_pages:
                self.reuse = KVReuseStore(
                    scfg.reuse_pages,
                    base_gid=(scfg.kv_segments or scfg.lanes) * self.pages_per_seq,
                    page_t=scfg.page_t)
        self.cache = None
        self.aux = None                 # what the cross blocks attend over
        self._clock = TickClock(scfg.migration_interval)
        self._decode_s = 0.0            # decode wall time
        self._last_kv_mass = None       # (B, n_slots) kernel mass, post-step
        self._kernel_mass = scfg.paged and scfg.kv_mass_source == "kernel"
        # (lane, slot) -> (page id, fill) at its last flush (change
        # tracking; single-request mode uses lane 0)
        self._kv_flushed: dict[tuple[int, int], tuple[int, int]] = {}
        n = max(scfg.lanes, 1)
        self._lane_active = np.zeros(n, bool)
        self._lane_segments = np.full(n, -1, np.int32)
        # per-lane page table (local page -> global store page, -1 = the
        # private affine default segment * pages_per_seq + local) and the
        # locals whose slow row holds a complete page; without KV reuse
        # every table entry stays -1
        self._lane_pages = np.full((n, self.pages_per_seq), -1, np.int64)
        self._lane_full = np.zeros((n, self.pages_per_seq), bool)

    def _check_attach_geometry(self, owner: "ServeEngine") -> None:
        """A worker must agree with its owner on every field that shapes the
        shared store or a lane's cache: only ``lanes`` may differ."""
        if not (self.lane_mode and owner.lane_mode):
            raise ValueError("attach_to requires lane mode on both engines")
        mine = dataclasses.asdict(self.scfg)
        theirs = dataclasses.asdict(owner.scfg)
        mine.pop("lanes"), theirs.pop("lanes")
        diff = [k for k in mine if mine[k] != theirs[k]]
        if diff:
            raise ValueError(
                f"attached engine geometry differs from owner on {diff} — "
                "only ServeConfig.lanes may differ between workers")
        if self.device != owner.device:
            raise ValueError("an attached engine runs on its owner's device")

    def _register_resources(self, seeds) -> None:
        cfg, scfg = self.cfg, self.scfg
        pinned = self.device.type == "cuda"
        for kind in sorted(set(scfg.resources) | ({"kv"} if scfg.paged else set())):
            if kind == "kv":
                if not scfg.paged:
                    raise ValueError("the 'kv' resource requires paged=True")
                # lane mode: the slow store is carved into per-request
                # segments, each a max_seq-worth of logical pages
                n_segments = scfg.kv_segments or scfg.lanes or 1
                row_shape = self._kv_row_shape()
                spec = ResourceSpec(
                    "kv", n_pages=n_segments * self.pages_per_seq
                    + scfg.reuse_pages,
                    hot_slots=scfg.kv_tier_slots or scfg.hot_slots,
                    quota_pages=scfg.kv_quota, row_shape=row_shape,
                    row_dtype="bfloat16", slow_codec=scfg.slow_codec)
                res = KVPagesResource(spec,
                                      mass_threshold=scfg.kv_mass_threshold)
                # the slow tier starts as zero scratch, in host memory when
                # the engine runs on the card; pages are flushed down as
                # the ring fills
                payload = torch.zeros((spec.n_pages,) + row_shape,
                                      dtype=torch.bfloat16, pin_memory=pinned)
            elif kind == "experts":
                if cfg.moe is None or "moe" not in cfg.pattern:
                    raise ValueError(
                        f"arch {cfg.name!r} has no MoE layers to tier")
                payload = self._expert_payload()
                spec = ResourceSpec(
                    "experts", n_pages=payload.shape[0],
                    hot_slots=cfg.n_groups * scfg.expert_hot_slots,
                    quota_pages=scfg.expert_quota,
                    row_shape=tuple(payload.shape[1:]),
                    row_dtype=str(payload.dtype).split(".")[-1],
                    slow_codec=scfg.slow_codec)
                res = ExpertStreamResource(spec, n_experts=cfg.moe.n_experts)
            elif kind == "embeddings":
                payload = self._embed_payload(self._embed_rpp)
                spec = ResourceSpec(
                    "embeddings", n_pages=payload.shape[0],
                    hot_slots=scfg.embed_hot_slots,
                    quota_pages=scfg.embed_quota,
                    row_shape=tuple(payload.shape[1:]),
                    row_dtype=str(payload.dtype).split(".")[-1],
                    slow_codec=scfg.slow_codec)
                res = EmbedRowsResource(spec, rows_per_page=self._embed_rpp)
            else:
                raise KeyError(f"unknown serve resource kind {kind!r}")
            handle = self.daemon.register(res, seeds=seeds)
            # the KV store starts un-witnessed; the embedding and expert
            # rows are valid from step 0
            handle.bind_data(payload, initially_valid=(kind != "kv"))

    def _kv_row_shape(self) -> tuple[int, ...]:
        """One logical KV page across all layer groups: the ring's K and V
        rows concatenated on the last axis (MLA: the latent and rope widths
        beside the latent, 576 + 512 on deepseek-v3; GQA: 2 x head_dim)."""
        hkv, dk, dv = dec.ring_dims(self.cfg)
        return (self.cfg.n_groups, self.scfg.page_t, hkv, dk + dv)

    def _expert_payload(self) -> torch.Tensor:
        """(G*E, 3*d*f) expert weight rows ``[w_gate | w_in | w_out]``, page
        = group * n_experts + expert, of the first MoE position (one
        representative block per expert, as the reference binds).  On the
        card the store is allocated pinned once and filled a few experts at
        a time from the device (kimi-k2's is 33.8 GB: no second copy on the
        card, no pageable staging on the host)."""
        ffn = self.params["blocks"][self.cfg.pattern.index("moe")]["ffn"]
        parts = [ffn[k].flatten(0, 1).flatten(1)
                 for k in ("w_gate", "w_in", "w_out")]      # (G*E, d*f) each
        if self.device.type != "cuda":
            return torch.cat(parts, dim=1)
        n, width = parts[0].shape[0], sum(p.shape[1] for p in parts)
        store = torch.empty((n, width), dtype=parts[0].dtype, pin_memory=True)
        for lo in range(0, n, 8):
            store[lo:lo + 8].copy_(torch.cat([p[lo:lo + 8] for p in parts], dim=1))
        return store

    def _embed_payload(self, rows_per_page: int) -> torch.Tensor:
        """(n_pages, rows_per_page, d) vocab row-blocks of the live table."""
        table = self.params["embed"]["table"]
        v, d = table.shape
        n_pages = -(-v // rows_per_page)
        pad = n_pages * rows_per_page - v
        if pad:
            table = torch.cat([table, table.new_zeros((pad, d))])
        return table.reshape(n_pages, rows_per_page, d)

    def _tier_reads(self) -> dict:
        """Tier views for the in-step read path: ``{"fast", "slow",
        "page_slot", "scale"}`` for the embeddings (with their
        ``rows_per_page``) and the experts, rebuilt each step so migration
        epochs are picked up.  Empty when ``jit_tier_reads`` is off; the KV
        ring needs no view (it IS the fast tier, in-cache)."""
        out: dict = {}
        if not self.scfg.jit_tier_reads:
            return out
        if "embeddings" in self.daemon:
            out["embeddings"] = self.daemon["embeddings"].tier_view()
            out["embeddings"]["rows_per_page"] = self._embed_rpp
        # expert-parallel serving keeps moe_apply_ep's dispatch: the
        # replicated per-token row read is the single-device tiered path
        if "experts" in self.daemon and self.ep is None:
            out["experts"] = self.daemon["experts"].tier_view()
        return out

    # -- single-request mode ----------------------------------------------------
    @property
    def pages_per_seq(self) -> int:
        """Logical KV pages per request segment (= per max_seq sequence)."""
        return self.scfg.max_seq // self.scfg.page_t

    @property
    def lane_mode(self) -> bool:
        return self.scfg.lanes > 0

    @property
    def _chunk_cap(self) -> int:
        """Ring-wrap safety bound on one prefill chunk: the ring minus the
        slot it may be mid-filling, so no unflushed page is overwritten."""
        return max((self.scfg.hot_slots - 1) * self.scfg.page_t, 1)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def prefill(self, tokens: np.ndarray, aux_embeds=None) -> np.ndarray:
        """Start a request: ``tokens`` (B, S).  ``aux_embeds`` (B, S_aux, D),
        numpy or a tensor, is what the cross blocks attend over at every
        dense step: an image's patch embeddings, or an encoder arch's frame
        embeddings, encoded here once.  The paged path has no cross step
        (ROADMAP C6)."""
        if self.lane_mode:
            raise ValueError("lane mode serves through prefill_lane/"
                             "advance_lanes (the request scheduler), not "
                             "prefill/generate")
        b, s = tokens.shape
        tokens = self._tokens(tokens)
        self.aux = None if aux_embeds is None else tensor_from_numpy(
            aux_embeds, self.device)
        if self.cfg.encoder_layers and self.aux is not None:
            self.aux = encode(self.cfg, self.params, self.aux, ep_axes=self.ep)
        if not self.scfg.paged:
            # one pass fills the full cache and gives the last logits; the
            # prompt's streams are observed as one batch each
            self.cache = dec.init_cache(self.cfg, b, self.scfg.max_seq,
                                        device=self.device)
            logits, self.cache, streams = dec.prefill_dense(
                self.cfg, self.params, self.cache, tokens, aux_embeds=self.aux,
                tiered=self._tier_reads(), ep_axes=self.ep)
            self._observe_common(tokens, streams["router"])
            self._maybe_tick(s)
            return logits.argmax(-1).cpu().numpy()
        self.cache = dec.init_paged_cache(self.cfg, b, self.scfg.hot_slots,
                                          self.scfg.page_t, device=self.device)
        self._kv_flushed.clear()
        logits = None
        for off in range(0, s, self._chunk_cap):
            logits = self._prefill_chunk(tokens[:, off:off + self._chunk_cap])
        return logits.argmax(-1).cpu().numpy()

    def _prefill_chunk(self, tok: torch.Tensor) -> torch.Tensor:
        """One paged prefill chunk: advance the ring, observe the chunk's
        streams once, flush its pages, tick the daemon for the chunk's
        worth of steps.  Returns the (B, V) last logits."""
        n = tok.shape[1]
        logits, self.cache, streams = dec.prefill_paged(
            self.cfg, self.params, self.cache, tok, page_t=self.scfg.page_t,
            tiered=self._tier_reads(), collect_mass=self._kernel_mass,
            ep_axes=self.ep)
        self._observe_common(tok, streams["router"])
        view = self._kv_page_stream()
        if view is not None:
            mass, ids = view
            if self._kernel_mass:
                # (C, G, n_attn, B, S) averaged over groups, positions and
                # lockstep rows, summed over the chunk (DESIGN.md §10)
                mass = streams["kv_mass"].mean(dim=(1, 2, 3)).sum(dim=0)
            self.daemon.observe("kv", mass, ids)
        self._flush_kv_slow()
        self._maybe_tick(n)
        return logits

    def step(self, token: np.ndarray) -> np.ndarray:
        logits = self._advance(self._tokens(token)[:, None])
        return logits[:, -1].argmax(-1).cpu().numpy()

    def generate(self, prompt: np.ndarray, n_tokens: int,
                 aux_embeds=None) -> np.ndarray:
        nxt = self.prefill(prompt, aux_embeds)
        out = [nxt]
        for _ in range(n_tokens - 1):
            nxt = self.step(nxt)
            out.append(nxt)
        return np.stack(out, axis=1)

    def _advance(self, tok: torch.Tensor) -> torch.Tensor:
        """One decode step: the paged or dense body, the tiering streams,
        the cadence."""
        t0 = time.perf_counter()
        if self.scfg.paged:
            logits, self.cache, streams = dec.decode_step_paged(
                self.cfg, self.params, self.cache, tok, page_t=self.scfg.page_t,
                return_streams=True, collect_mass=self._kernel_mass,
                tiered=self._tier_reads(), ep_axes=self.ep)
        else:
            logits, self.cache, streams = dec.decode_step(
                self.cfg, self.params, self.cache, tok, aux_embeds=self.aux,
                return_streams=True, tiered=self._tier_reads(), ep_axes=self.ep)
        self._set_kv_mass(streams)
        self._observe(tok, streams["router"])
        self._maybe_tick()
        self._decode_s += time.perf_counter() - t0
        return logits

    def _set_kv_mass(self, streams: dict) -> None:
        """Hold the step's (B, n_slots) page mass: the (G, n_attn, B, S)
        stream averaged over layer groups and attention positions (None
        under ``kv_mass_source="fill"``, where the kernel exports none)."""
        km = streams.get("kv_mass")
        self._last_kv_mass = km.mean(dim=(0, 1)) if km is not None else None

    def _observe_common(self, tok: torch.Tensor, router) -> None:
        """The embeddings and experts streams of single-request mode: every
        token and every router id is live.  A prefill chunk's router stream
        is (C, G, n_moe, B, 1, k), a step's (G, n_moe, B, 1, k)."""
        if "embeddings" in self.daemon:
            self.daemon.observe("embeddings", tok.to(torch.int32))
        if "experts" in self.daemon and router is not None:
            self.daemon.observe("experts", router)

    def _observe(self, tok: torch.Tensor, router) -> None:
        self._observe_common(tok, router)
        view = self._kv_page_stream() if "kv" in self.daemon else None
        if view is None:
            return
        mass, ids = view
        if self._kernel_mass:
            # batch rows advance in lockstep over the same page ids, so the
            # row mean is the device's aggregate view of the step's mass
            mass = self._last_kv_mass.mean(dim=0)
        self.daemon.observe("kv", mass, ids)

    # -- continuous-batching lane mode (serve/sched.py, DESIGN.md §9) ---------
    def start_lanes(self) -> None:
        """Initialise the lane substrate: ``lanes`` independent decode lanes
        over one paged ring with per-lane positions.  No prompt — the
        scheduler feeds prompt tokens through :meth:`advance_lanes` or
        :meth:`prefill_lane`."""
        scfg = self.scfg
        if not self.lane_mode:
            raise ValueError("start_lanes requires ServeConfig.lanes > 0")
        self.cache = dec.init_paged_cache(self.cfg, scfg.lanes, scfg.hot_slots,
                                          scfg.page_t, per_lane_pos=True,
                                          device=self.device)
        # a pristine one-lane cache: reset_lane restores each leaf's initial
        # value, which is not zero for the m/sLSTM stabiliser (-1e30)
        self._lane_init = dec.init_paged_cache(self.cfg, 1, scfg.hot_slots,
                                               scfg.page_t, per_lane_pos=True,
                                               device=self.device)
        self.aux = None
        self._kv_flushed.clear()
        self._lane_active[:] = False
        self._lane_segments[:] = -1
        self._lane_pages[:] = -1
        self._lane_full[:] = False

    def advance_lanes(self, tokens, active, segments) -> np.ndarray:
        """One continuous-batching decode step for ALL lanes at once.

        ``tokens`` (L,) — each lane's next token (a prompt token while it
        prefills, its last sampled token while it decodes, don't-care for
        inactive lanes, whose cache never changes and whose streams are
        masked out).  ``active`` (L,) bool, ``segments`` (L,) int — the
        lane's slow-store KV segment (-1 = none).  Returns the last-position
        logits (L, vocab) f32 on the host: reading them back is the step's
        end, so a card's step is timed to its completion."""
        if not self.lane_mode:
            raise ValueError("advance_lanes requires ServeConfig.lanes > 0")
        if self.cache is None:
            self.start_lanes()
        t0 = time.perf_counter()
        self._lane_active = np.asarray(active, bool).copy()
        self._lane_segments = np.asarray(segments, np.int32).copy()
        tokens = np.asarray(tokens, np.int32)
        logits, self.cache, streams = dec.decode_step_paged(
            self.cfg, self.params, self.cache, self._tokens(tokens)[:, None],
            page_t=self.scfg.page_t, return_streams=True,
            collect_mass=self._kernel_mass, tiered=self._tier_reads(),
            active=torch.as_tensor(self._lane_active, device=self.device),
            ep_axes=self.ep)
        self._set_kv_mass(streams)
        self._observe_lanes(tokens, streams["router"])
        self._maybe_tick()
        out = logits[:, -1].float().cpu().numpy()
        self._decode_s += time.perf_counter() - t0
        return out

    def prefill_lane(self, lane: int, tokens, segment: int,
                     chunk: int | None = None) -> np.ndarray:
        """Chunked prefill of ONE lane's prompt through the paged ring
        (DESIGN.md §11), ``chunk`` tokens at a time, every other lane
        frozen by the lane mask (bitwise equal to token-at-a-time
        streaming).  Per chunk the lane's freshly filled ring pages are
        flushed down to its slow-store ``segment``, the chunk's streams are
        observed once and the daemon cadence advances by the chunk length.
        Returns the last prompt position's logits (vocab,) f32."""
        if not self.lane_mode:
            raise ValueError("prefill_lane requires ServeConfig.lanes > 0")
        if self.cache is None:
            self.start_lanes()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("prefill_lane needs at least one token")
        chunk = min(chunk or tokens.size, self._chunk_cap)
        self._lane_segments[lane] = segment
        active = np.zeros(self.scfg.lanes, bool)
        active[lane] = True
        logits = None
        for off in range(0, tokens.size, chunk):
            logits = self._prefill_lane_chunk(lane, tokens[off:off + chunk],
                                              chunk, active)
        return logits

    def _prefill_lane_chunk(self, lane: int, piece: np.ndarray, chunk: int,
                            active: np.ndarray) -> np.ndarray:
        """One lane chunk: a ragged piece is padded to the chunk width with
        valid=False no-op steps, as the reference pads its scan."""
        n = piece.size
        tok = np.zeros((self.scfg.lanes, chunk), np.int32)
        tok[lane, :n] = piece
        valid = np.zeros((self.scfg.lanes, chunk), bool)
        valid[lane, :n] = True
        logits, self.cache, streams = dec.prefill_paged(
            self.cfg, self.params, self.cache, self._tokens(tok),
            page_t=self.scfg.page_t, valid=valid, active=active,
            tiered=self._tier_reads(), collect_mass=self._kernel_mass,
            ep_axes=self.ep)
        self._lane_active = active.copy()
        self._observe_lane_chunk(tok, valid, streams, active)
        self._flush_kv_lanes(lanes=[lane])
        self._maybe_tick(n)
        return logits[lane].cpu().numpy()

    def _observe_lane_chunk(self, tok: np.ndarray, valid: np.ndarray,
                            streams: dict, active: np.ndarray) -> None:
        """Feed one chunk's streams in ONE observation batch per resource,
        other lanes (and tail padding) masked to -1."""
        if "embeddings" in self.daemon:
            self.daemon.observe("embeddings", self._ids(np.where(valid, tok, -1)))
        if "experts" in self.daemon and streams["router"] is not None:
            # (C, G, n_moe, L, 1, k), padding steps and other lanes -1
            live = torch.as_tensor(valid.T, device=self.device)
            self.daemon.observe("experts", torch.where(
                live[:, None, None, :, None, None], streams["router"], -1))
        view = self._kv_lane_stream(active=active)
        if view is None:
            return
        mass, gids = view
        if self._kernel_mass:
            # per-step (C, G, n_attn, L, S) kernel mass: averaged over
            # groups and positions, summed over the chunk's valid steps —
            # the bulk analogue of the one-step stream advance_lanes feeds
            per_step = streams["kv_mass"].mean(dim=(1, 2))           # (C, L, S)
            w = torch.as_tensor(valid.T, dtype=per_step.dtype, device=self.device)
            mass = (per_step * w[:, :, None]).sum(dim=0)             # (L, S)
        self._observe_kv_lanes(mass, gids)

    def _observe_lanes(self, tokens: np.ndarray, router) -> None:
        """Feed the tiering streams with inactive lanes masked to -1 pads."""
        if "embeddings" in self.daemon:
            self.daemon.observe("embeddings",
                                self._ids(np.where(self._lane_active, tokens, -1)))
        if "experts" in self.daemon and router is not None:
            # (G, n_moe, L, 1, k)
            live = torch.as_tensor(self._lane_active, device=self.device)
            self.daemon.observe("experts", torch.where(
                live[None, None, :, None, None], router, -1))
        view = self._kv_lane_stream()
        if view is None:
            return
        mass, gids = view
        self._observe_kv_lanes(self._last_kv_mass if self._kernel_mass else mass,
                               gids)

    def _observe_kv_lanes(self, mass, gids: np.ndarray) -> None:
        """The (L, S) per-lane mass (the kernel's tensor, or the fill as an
        array), masked to the live lanes' segment-mapped pages (the mask the
        gids carry), as one flat "kv" block."""
        g = self._ids(gids)
        mass = torch.where(
            g >= 0, torch.as_tensor(mass, device=self.device).float(), 0.0)
        self._count_shared_mass(mass, gids)
        self.daemon.observe("kv", mass.reshape(-1), g.reshape(-1))

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), dtype=torch.int32,
                               device=self.device)

    def reset_lane(self, lane: int) -> None:
        """Return a lane to its initial state for a fresh admission: ring
        bookkeeping (the dense prologue's too), O(1) recurrent states and
        position back to their initial values, copied from the pristine
        one-lane cache (page payloads may stay — ``page_len`` masks them)."""
        init = self._lane_init
        for entry, tmpl in zip(self.cache["blocks"], init["blocks"]):
            for k, v in entry.items():
                if k not in ("k_pages", "v_pages"):
                    v[:, lane] = tmpl[k][:, 0]
        for entry, tmpl in zip(self.cache.get("prologue", []),
                               init.get("prologue", [])):
            for k, v in entry.items():
                if k not in ("k_pages", "v_pages"):
                    v[lane] = tmpl[k][0]
        self.cache["pos"][lane] = 0
        self._invalidate_lane_flush(lane)
        self._lane_pages[lane] = -1
        self._lane_full[lane] = False

    def preempt_lane(self, lane: int) -> dict:
        """Evict a lane's request so the lane can serve someone else.

        The lane's resident ring pages are force-flushed down to its KV
        slow-store segment (an exact snapshot of the ring), and what the KV
        payload does not carry — the ring bookkeeping and the position, the
        O(1) recurrent states, the pages of attention positions beyond the
        representative entry and the dense prologue's rings — is
        snapshotted to the host in the returned residual.
        :meth:`resume_lane` restores it bitwise."""
        self._flush_kv_lanes(lanes=[lane], force=True)
        residual = {"pos": int(self.cache["pos"][lane]),
                    "segment": int(self._lane_segments[lane]),
                    "pages": self._lane_pages[lane].copy(),
                    "full": self._lane_full[lane].copy(),
                    "blocks": [],
                    "prologue": [{k: v[lane].to("cpu", copy=True)
                                  for k, v in entry.items()}
                                 for entry in self.cache.get("prologue", [])]}
        rep = self._paged_entry()
        for entry in self.cache["blocks"]:
            skip = ("k_pages", "v_pages") if entry is rep else ()
            residual["blocks"].append(
                {k: v[:, lane].to("cpu", copy=True) for k, v in entry.items()
                 if k not in skip})
        return residual

    def resume_lane(self, lane: int, residual: dict) -> int:
        """Re-install a preempted request into a lane: the residual is
        restored and the representative entry's resident ring pages are
        gathered back through the tiered KV store (fast-tier copy when
        promoted, slow-tier fallback — bitwise either way).  Returns the
        number of ring pages gathered back up."""
        for entry, snap in zip(self.cache["blocks"], residual["blocks"]):
            for k, v in snap.items():
                entry[k][:, lane] = v.to(self.device)
        for entry, snap in zip(self.cache.get("prologue", []),
                               residual["prologue"]):
            for k, v in snap.items():
                entry[k][lane] = v.to(self.device)
        self.cache["pos"][lane] = residual["pos"]
        self._invalidate_lane_flush(lane)
        self._lane_pages[lane] = residual["pages"]
        self._lane_full[lane] = residual["full"]
        segment = residual["segment"]
        self._lane_segments[lane] = segment
        entry = self._paged_entry()
        if entry is None or segment < 0:
            return 0
        plen = entry["page_len"][0, lane].cpu().numpy()[None]        # (1, S)
        cur = entry["cur_slot"][0, lane].cpu().numpy()[None]         # (1,)
        local = self._ring_page_ids(plen, cur, np.asarray([residual["pos"]]),
                                    self.scfg.page_t)[0]
        slots = np.flatnonzero(local >= 0)
        if slots.size == 0:
            return 0
        tabled = self._lane_pages[lane, local[slots]]
        gids = np.where(tabled >= 0, tabled,
                        segment * self.pages_per_seq + local[slots])
        rows = self.daemon["kv"].read_rows(gids).movedim(0, 1)  # (G, n, T, hkv, dk+dv)
        at = torch.as_tensor(slots, device=self.device)
        dk = self._kv_split_width()
        entry["k_pages"][:, lane, at] = rows[..., :dk].to(entry["k_pages"].dtype)
        entry["v_pages"][:, lane, at] = rows[..., dk:].to(entry["v_pages"].dtype)
        for i, s in enumerate(slots):
            self._kv_flushed[(lane, int(s))] = (int(gids[i]), int(plen[0, s]))
        return int(slots.size)

    def _invalidate_lane_flush(self, lane: int) -> None:
        for key in [k for k in self._kv_flushed if k[0] == lane]:
            del self._kv_flushed[key]

    # -- disaggregated prefill/decode hand-off (DESIGN.md §13) ----------------
    def _kv_split_width(self) -> int:
        """Last-axis K width inside a concatenated [K | V] payload row."""
        return dec.ring_dims(self.cfg)[1]

    def handoff_lane(self, lane: int) -> dict:
        """Producer side: detach a finished prefill from its lane.  A
        preemption (the force-flush writes every resident ring page down to
        the request's segment, the residual carries the rest) that also
        meters ``handoff_bytes``: the whole consumed prefix's pages at the
        KV store's wire row size."""
        residual = self.preempt_lane(lane)
        n_pages = -(-residual["pos"] // self.scfg.page_t)
        residual["handoff_bytes"] = n_pages * self.daemon["kv"].mem.row_bytes
        return residual

    def segment_resident(self, residual: dict) -> bool:
        """Consumer-side admission gate: is every page of the hand-off's
        consumed prefix (the final, possibly partial, one included)
        write-witnessed in the slow store?  Shared pool pages count through
        the request's copy-on-write page table."""
        if residual["segment"] < 0:
            return True
        gids = segment_page_ids(residual["segment"], residual["pos"],
                                self.scfg.page_t, self.pages_per_seq,
                                table=residual.get("pages"))
        return bool(self.daemon["kv"].pages_written(gids).all())

    def install_handoff(self, lane: int, residual: dict) -> int:
        """Consumer side: install a prefilled request into a decode lane,
        its ring window gathered back through the placement table (fast
        copy when promoted, slow store otherwise).  Refuses a segment the
        producer has not fully flushed.  Returns the gathered bytes."""
        if not self.segment_resident(residual):
            raise RuntimeError(
                f"segment {residual['segment']} not fully resident — "
                "hand-off installed before the prefill flush completed")
        return self.resume_lane(lane, residual) * self.daemon["kv"].mem.row_bytes

    # -- content-addressed KV reuse (repro_torch.cache, DESIGN.md §12) --------
    def install_lane_pages(self, lane: int, run: dict[int, int]
                           ) -> tuple[int, int]:
        """Fast-forward a lane over one CONSECUTIVE run of admission-matched
        pages: the run's ring-window tail is installed from the shared pool
        (read through the placement table, decoded on the device) and the
        lane's position jumps past the run, no forward pass.  Installed
        slots are marked clean — copy-on-write: the ring never writes a
        shared page back.  Returns the pool reads' (fast, slow) split."""
        if self.reuse is None:
            raise ValueError("install_lane_pages requires reuse_pages > 0")
        locals_ = np.asarray(sorted(run), np.int64)
        if locals_.size == 0:
            return 0, 0
        if not np.all(np.diff(locals_) == 1):
            raise ValueError("install run must be consecutive local pages")
        gids = np.asarray([run[int(j)] for j in locals_], np.int64)
        n_slots, page_t = self.scfg.hot_slots, self.scfg.page_t
        sel, gsel = locals_[-n_slots:], gids[-n_slots:]
        h = self.daemon["kv"]
        _, hit = h.lookup(self._ids(gsel))
        fast_n = int(hit.sum())
        rows = h.read_rows(gsel).movedim(0, 1)      # (G, n, T, hkv, dk+dv)
        new_pos = int(locals_[-1] + 1) * page_t
        dec.install_pages(self.cache, lane, sel % n_slots, rows,
                          dk=self._kv_split_width(), page_t=page_t,
                          new_pos=new_pos)
        self._lane_pages[lane, locals_] = gids
        cur = (new_pos // page_t) % n_slots
        for j, g in zip(sel % n_slots, gsel):
            if int(j) != cur:                        # cur slot was re-zeroed
                self._kv_flushed[(lane, int(j))] = (int(g), page_t)
        self.reuse.note_consumed(locals_.size)
        return fast_n, int(gsel.size - fast_n)

    def publish_lane(self, lane: int, tokens) -> int:
        """Publish a finishing request's complete KV pages into the shared
        pool: force-flush the lane, index every full page of its token
        stream whose slow row is witnessed complete, and copy the NEW
        pages' wire-format rows segment -> pool.  Returns the pages
        newly published."""
        if self.reuse is None:
            return 0
        toks = np.asarray(tokens).ravel()
        pos = int(self.cache["pos"][lane])
        n_pages = min(toks.size, pos) // self.scfg.page_t
        if n_pages <= 0 or self._lane_segments[lane] < 0:
            return 0
        self._flush_kv_lanes(lanes=[lane], force=True)
        witness = self._lane_full[lane] | (self._lane_pages[lane] >= 0)
        new = self.reuse.publish(toks, n_pages, mask=witness)
        if not new:
            return 0
        seg = int(self._lane_segments[lane])
        src = [int(self._lane_pages[lane, j]) if self._lane_pages[lane, j] >= 0
               else seg * self.pages_per_seq + j for j, _ in new]
        self.daemon["kv"].copy_rows(np.asarray(src, np.int64),
                                    np.asarray([g for _, g in new], np.int64))
        return len(new)

    def _count_shared_mass(self, mass: torch.Tensor, gids: np.ndarray) -> None:
        """Accumulate the observed mass landing on shared pool pages against
        that on all resident pages (the shared-page mass share)."""
        if self.reuse is None:
            return
        m = mass.cpu().numpy().astype(np.float64)
        self.reuse_mass["total"] += float(m[gids >= 0].sum())
        self.reuse_mass["shared"] += float(m[gids >= self.reuse.base_gid].sum())

    def reuse_stats(self) -> dict | None:
        """The reuse store's counters and the shared-page mass share."""
        if self.reuse is None:
            return None
        row = self.reuse.stats()
        total = self.reuse_mass["total"]
        row["shared_mass_share"] = (self.reuse_mass["shared"] / total
                                    if total > 0 else 0.0)
        return row

    # -- tiering-state checkpoint (DESIGN.md §6) ------------------------------
    def save_tiering(self, mgr, step: int) -> None:
        """Checkpoint every resource's placement and profiling state through
        ``ckpt/manager.py`` (an in-flight epoch is committed first)."""
        mgr.save(step, self.daemon.state_dict())

    def load_tiering(self, mgr, step: int) -> None:
        """Warm-restore the placement maps from a checkpoint; resident fast
        rows are refilled from the bound slow stores (``load_state``)."""
        self.daemon.load_state(mgr.restore(step, self.daemon.state_dict()))

    def read_rows(self, name: str, page_ids) -> torch.Tensor:
        """Serve a resource's payload rows: the fast copy when the page is
        resident, the slow row otherwise (bitwise either way)."""
        return self.daemon[name].read_rows(page_ids)

    # -- the ring and the KV data plane ---------------------------------------
    def _paged_entry(self) -> dict | None:
        """The representative paged-attention cache entry: the first ring in
        the pattern (None when the pattern has no attention).  Its pages are
        the KV payload rows; sibling rings, recurrent states and the dense
        prologue travel in preemption residuals."""
        return next((c for c in self.cache["blocks"] if "page_len" in c), None)

    def _ring_view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Host view of the ring: (page_len (B, S), cur_slot (B,), pos (B,)),
        or None without a ring.  Group 0 is representative — all groups
        advance in lockstep."""
        entry = self._paged_entry()
        if entry is None:
            return None
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

    def _kv_page_stream(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Resident ring window as (per-page fill, logical page ids), batch
        row 0 representative; None without a ring.  The fill is the flush's
        change key and, under ``kv_mass_source="fill"``, the observed mass."""
        view = self._ring_view()
        if view is None:
            return None
        plen, cur, pos = view
        ids = self._ring_page_ids(plen, cur, pos, self.scfg.page_t)[0]
        return (torch.as_tensor(plen[0], dtype=torch.float32, device=self.device),
                self._ids(ids))

    def _kv_lane_stream(self, active: np.ndarray | None = None,
                        ) -> tuple[np.ndarray, np.ndarray] | None:
        """Lane mode: the (L, S) per-page fill and global page ids of the
        "kv" stream — each lane's resident ring pages mapped into its
        slow-store segment's address space; lanes outside ``active``
        (default: the live mask) are -1; None without a ring.  The fill is
        the observed mass under ``kv_mass_source="fill"``."""
        view = self._ring_view()
        if view is None:
            return None
        plen, cur, pos = view
        local = self._ring_page_ids(plen, cur, pos, self.scfg.page_t)
        act = self._lane_active if active is None else np.asarray(active, bool)
        return plen, self._map_gids(local, act)

    def _map_gids(self, local: np.ndarray, act: np.ndarray) -> np.ndarray:
        """Resolve (L, S) local page ids to global store page ids through
        the per-lane page table (entries win; the rest map to the private
        ``segment * pages_per_seq + local``); invalid lanes/slots are -1."""
        seg = self._lane_segments[:, None].astype(np.int64)
        affine = seg * self.pages_per_seq + local
        lanes = np.arange(local.shape[0])[:, None]
        tabled = self._lane_pages[lanes, np.maximum(local, 0)]
        gids = np.where(tabled >= 0, tabled, affine)
        return np.where((local >= 0) & act[:, None] & (seg >= 0), gids, -1)

    def _flush_kv_slow(self) -> None:
        """Flush the ring's changed pages down to the KV data plane (slow
        store always, fast copies of promoted pages too), batch row 0 as
        the representative payload; the bytes are metered as flush_bytes.
        Nothing to flush without a ring."""
        h = self.daemon["kv"]
        view = self._ring_view()
        if view is None:
            return
        plen, cur, pos = view
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

    def _flush_kv_lanes(self, lanes=None, force: bool = False) -> None:
        """Lane-mode KV flush: each flushed lane's resident ring pages go
        down to its slow-store segment (real per-lane payloads).  ``lanes``
        defaults to the live mask; pages unchanged since their last flush
        are skipped unless ``force`` — preemption forces a full flush so
        the segment is an exact snapshot of the ring.

        Copy-on-write over shared pool pages (DESIGN.md §12): a slot holding
        a CLEAN shared page (installed, fill unchanged) is never written
        back, even under ``force``.  A slot whose shared mapping went stale
        (the ring wrote into it) forks: its page-table entry reverts to the
        lane's private segment page and the payload flushes there.
        Nothing to flush without a ring."""
        view = self._ring_view()
        if view is None:
            return
        plen, cur, pos = view
        local = self._ring_page_ids(plen, cur, pos, self.scfg.page_t)
        if lanes is None:
            act = self._lane_active
        else:
            act = np.zeros(self.scfg.lanes, bool)
            act[np.asarray(lanes, int)] = True
        gids = self._map_gids(local, act)            # (L, S)
        fill = np.where(gids >= 0, plen, 0).astype(np.int64)
        base = self.reuse.base_gid if self.reuse is not None else None
        ids = gids.copy()
        for lane, slot in np.argwhere(ids >= 0):
            key = (int(lane), int(slot))
            state = (int(gids[lane, slot]), int(fill[lane, slot]))
            if base is not None and gids[lane, slot] >= base:
                if self._kv_flushed.get(key) == state:
                    ids[lane, slot] = -1             # clean shared page: CoW
                    continue
                lp = int(local[lane, slot])          # dirty: private fork
                self._lane_pages[lane, lp] = -1
                priv = int(self._lane_segments[lane]) * self.pages_per_seq + lp
                ids[lane, slot] = gids[lane, slot] = priv
                state = (priv, int(fill[lane, slot]))
            if not force and self._kv_flushed.get(key) == state:
                ids[lane, slot] = -1
        if not (ids >= 0).any():
            return
        entry = self._paged_entry()
        self.daemon["kv"].write_pages(ids.reshape(-1), entry["k_pages"],
                                      entry["v_pages"])
        for lane, slot in np.argwhere(ids >= 0):
            self._kv_flushed[(int(lane), int(slot))] = (
                int(gids[lane, slot]), int(fill[lane, slot]))
            if fill[lane, slot] >= self.scfg.page_t:
                # witness: this local's slow row holds the complete page
                self._lane_full[lane, local[lane, slot]] = True

    @property
    def step_count(self) -> int:
        """Engine steps so far (decode steps + prefilled prompt positions)."""
        return self._clock.steps

    def _maybe_tick(self, n: int = 1) -> None:
        """Advance the step counter by ``n`` and run one daemon tick per
        migration-interval boundary crossed, flushing the KV ring first.
        An attached worker never ticks the shared daemon: the cadence is
        the owner's, and the worker's pages flush per chunk and at
        hand-off."""
        ticks = self._clock.advance(n)
        if not (self._daemon_owner and self.daemon.resources):
            return
        for _ in range(ticks):
            if self.lane_mode:
                self._flush_kv_lanes()
            elif "kv" in self.daemon:
                self._flush_kv_slow()
            self.daemon.tick()

    # -- telemetry ------------------------------------------------------------
    def tier_stats(self) -> dict[str, dict]:
        """Per-resource telemetry rows (the BENCH_serve.json schema)."""
        for h in self.daemon.resources.values():
            h.stats.decode_s = self._decode_s
        return self.daemon.snapshot()

    @property
    def kv_tier(self) -> ResourceHandle | None:
        """Deprecated: the KV resource handle (None when not paged)."""
        return self.daemon["kv"] if "kv" in self.daemon else None
