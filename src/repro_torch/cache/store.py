"""Content-addressed KV page store — cross-request paged-cache reuse.

A copy of ``repro/cache/store.py`` (numpy only; the port keeps its own).

The serve engine's paged ring flushes completed KV pages into per-request
slow-store segments (DESIGN.md §9).  This module adds a *shared pool* of
slow-store pages behind a content-addressed index so identical prompt
spans — system prompts, RAG documents, multi-turn conversation history —
are prefilled once and re-admitted pre-resident (DESIGN.md §12).

Hash scheme (two hashes per completed page):

* ``content[j]`` — FNV-1a over page ``j``'s own token ids.  Position- and
  context-independent: the *index key*.  Identical token spans anywhere
  in any prompt map to the same bucket.
* ``chain[j]`` — ``content[j]`` folded over every preceding page's
  content hash.  A transformer KV page's bytes depend on the FULL causal
  prefix (every earlier token attends into it) and on the page's absolute
  position (RoPE is applied to K at append time), so byte-exact reuse
  requires prefix identity at the same offset.  ``chain`` witnesses the
  prefix; the per-page position offset stored with each entry guards the
  absolute position.  A lookup hits only when content, chain AND offset
  all agree — which makes every hit bit-exact by construction.

Matching modes (`KVReuseStore.match`):

* ``prefix`` — walk pages from offset 0, stop at the first miss
  (vLLM-style prefix caching).
* ``substring`` — verify every full page of the prompt independently and
  skip holes: a miss at page j does not forfeit a verified run at j+1.
  Strictly a superset of ``prefix``.  The gap is what agentic workloads
  measure (SNIPPETS.md Snippet 1: MemGPT substring 93.4% vs prefix
  43.9%): capacity churn evicts the LRU *front* of a sleeping
  conversation's history while its interior stays indexed, and a
  mutating working-context block invalidates the tail — stop-at-first-
  miss recovers nothing, hole-skipping recovers the surviving interior.

Refcount lifecycle: ``match`` acquires one reference per matched page for
the admitted request; the scheduler releases them when the request
finishes (references survive preempt/resume — the lane changes, the
request's claim does not).  ``publish`` indexes a finished request's
pages into pool pages, evicting refcount-zero entries in LRU order when
the pool is full; pages still referenced by a live lane are never
reclaimed.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def hash_pages(tokens, page_t: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-page content hashes and rolling chain hashes.

    tokens: 1-D int token ids; only complete pages are hashed.
    Returns ``(content, chain)`` uint64 arrays of length ``len(tokens)
    // page_t``: ``content[j]`` covers page j's tokens alone, ``chain[j]``
    folds ``content[0..j]`` in order (the causal-prefix witness).
    """
    toks = np.asarray(tokens).astype(np.int64, copy=False).ravel()
    n_full = toks.size // page_t
    content = np.empty(n_full, np.uint64)
    chain = np.empty(n_full, np.uint64)
    h_chain = _FNV_OFFSET
    for j in range(n_full):
        h = _FNV_OFFSET
        for t in toks[j * page_t:(j + 1) * page_t]:
            h = ((h ^ (int(t) & _MASK64)) * _FNV_PRIME) & _MASK64
        content[j] = h
        h_chain = ((h_chain ^ h) * _FNV_PRIME) & _MASK64
        chain[j] = h_chain
    return content, chain


@dataclasses.dataclass
class MatchResult:
    """Admission-time match: ``pages`` maps local page index -> pool gid."""

    pages: dict[int, int]
    n_matchable: int


class KVReuseStore:
    """Refcounted content-addressed index over a pool of slow-store pages.

    The pool is ``n_pages`` extra pages appended to the KV slow store,
    global ids ``[base_gid, base_gid + n_pages)`` — segment pages below
    ``base_gid`` stay private to their request.  The store only does
    bookkeeping (index, refcounts, LRU, free list); payload movement is
    the engine's job (`ServeEngine.publish_lane` / `install_lane_pages`).
    """

    def __init__(self, n_pages: int, base_gid: int, page_t: int):
        if n_pages <= 0:
            raise ValueError("reuse pool needs n_pages > 0")
        self.n_pages = int(n_pages)
        self.base_gid = int(base_gid)
        self.page_t = int(page_t)
        self.free: list[int] = list(range(self.base_gid + self.n_pages - 1,
                                          self.base_gid - 1, -1))
        # content hash -> {(chain hash, page offset): pool gid}
        self.index: dict[int, dict[tuple[int, int], int]] = {}
        self.ref: dict[int, int] = {}
        self.key_of: dict[int, tuple[int, int, int]] = {}
        self.lru: OrderedDict[int, None] = OrderedDict()  # oldest first
        # counters (lifetime; benches diff them per arm/window)
        self.lookups = 0
        self.matchable = 0
        self.page_hits = 0
        self.tokens_saved = 0
        self.published = 0
        self.evicted = 0
        self.rejected = 0

    # ------------------------------------------------------------- match
    def is_shared(self, gid: int) -> bool:
        return gid >= self.base_gid

    def lookup_page(self, content: int, chain: int, offset: int):
        return self.index.get(int(content), {}).get((int(chain), int(offset)))

    def match(self, tokens, mode: str = "substring") -> MatchResult:
        """Match a prompt's full pages against the index.

        Only pages whose last token is strictly before the prompt's final
        token are matchable — the final token's forward pass produces the
        first-token logits, so its page must be scanned, never installed.
        Acquires one reference per matched page (release on finish).

        ``lookups``/``matchable``/``page_hits`` are LOOKUP stats, counted
        here; ``tokens_saved`` is counted only when the engine actually
        consumes an install run (`note_consumed`) — a match abandoned
        before installation saves nothing.
        """
        if mode not in ("prefix", "substring"):
            raise ValueError(f"unknown match mode {mode!r}")
        toks = np.asarray(tokens).ravel()
        content, chain = hash_pages(toks, self.page_t)
        n_match = max(0, (toks.size - 1) // self.page_t)
        matched: dict[int, int] = {}
        for j in range(n_match):
            gid = self.lookup_page(content[j], chain[j], j)
            if gid is None:
                if mode == "prefix":
                    break
                continue
            matched[j] = gid
        self.lookups += 1
        self.matchable += n_match
        self.page_hits += len(matched)
        for gid in matched.values():
            self.ref[gid] = self.ref.get(gid, 0) + 1
            self.lru.move_to_end(gid)
        return MatchResult(pages=matched, n_matchable=n_match)

    def note_consumed(self, n_pages: int) -> None:
        """Record ``n_pages`` matched pages actually installed into a lane
        (prefill work truly skipped) — the engine calls this from
        `install_lane_pages`, so ``tokens_saved`` never counts a match
        that was preempted and abandoned before consumption."""
        self.tokens_saved += int(n_pages) * self.page_t

    def release(self, gids) -> None:
        """Drop one reference per gid (request finished / match abandoned)."""
        for gid in gids:
            r = self.ref.get(int(gid), 0)
            if r <= 0:
                raise ValueError(f"release of unreferenced pool page {gid}")
            self.ref[int(gid)] = r - 1

    # ----------------------------------------------------------- publish
    def publish(self, tokens, n_pages: int,
                mask=None) -> list[tuple[int, int]]:
        """Index the first ``n_pages`` full pages of a finished stream.

        Returns ``[(local page idx, pool gid)]`` for pages that are NEW —
        the caller must copy their payload into the pool before the next
        match can hand them out.  Already-indexed pages are deduplicated
        (and LRU-touched); pages that don't fit once every refcount-zero
        entry is evicted are dropped and counted in ``rejected``.
        ``mask[j]=False`` skips page j (the caller couldn't witness a
        valid slow-store payload for it — e.g. it wrapped off the ring
        between flushes).
        """
        toks = np.asarray(tokens).ravel()
        content, chain = hash_pages(toks, self.page_t)
        out: list[tuple[int, int]] = []
        for j in range(min(int(n_pages), content.size)):
            if mask is not None and not mask[j]:
                continue
            key = (int(chain[j]), j)
            c = int(content[j])
            dup = self.index.get(c, {}).get(key)
            if dup is not None:
                self.lru.move_to_end(dup)
                continue
            gid = self._alloc()
            if gid is None:
                self.rejected += 1
                continue
            # _alloc's eviction may have mutated (or deleted) this content
            # bucket — bind it only now, after allocation succeeded.
            self.index.setdefault(c, {})[key] = gid
            self.key_of[gid] = (c,) + key
            self.ref.setdefault(gid, 0)
            self.lru[gid] = None
            self.published += 1
            out.append((j, gid))
        return out

    def _alloc(self) -> int | None:
        if self.free:
            return self.free.pop()
        for gid in self.lru:  # oldest first; only refcount-zero reclaimable
            if self.ref.get(gid, 0) == 0:
                self._evict(gid)
                return gid
        return None

    def _evict(self, gid: int) -> None:
        c, ch, off = self.key_of.pop(gid)
        bucket = self.index[c]
        del bucket[(ch, off)]
        if not bucket:
            del self.index[c]
        del self.lru[gid]
        self.ref.pop(gid, None)
        self.evicted += 1

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "pool_pages": self.n_pages,
            "indexed": len(self.key_of),
            "free": len(self.free),
            "shared_refs": int(sum(self.ref.values())),
            "lookups": self.lookups,
            "matchable": self.matchable,
            "page_hits": self.page_hits,
            "hit_rate": self.page_hits / max(1, self.matchable),
            "tokens_saved": self.tokens_saved,
            "published": self.published,
            "evicted": self.evicted,
            "rejected": self.rejected,
        }
