"""Count-Min Sketch hot-page detector — the NeoProf core (paper §IV-B).

Port of ``repro/core/sketch.py`` to PyTorch, with the same semantics:

  * D hash lanes x W counters, H3 hash functions (paper Eq. 5),
  * an 8-bit *epoch tag* per entry for O(1) logical reset (``uint8``, so it
    wraps at 256 exactly as the reference's tag does),
  * hot bits for in-sketch hot-page filtering (paper Fig. 7 (2)/(6)),
  * the error bound read off the counter histogram (paper Fig. 9).

Everything here is plain torch on whatever device the state lives on; it is
the reference semantics the Hopper kernels in
:mod:`repro_torch.kernels.neoprof_update` and :mod:`repro_torch.kernels.cms_hist`
are held to.  The seeds of the H3 hashes are an input: the reference draws
them from ``jax.random``, so a port that must match it bit for bit takes
them from the reference state (:func:`repro_torch.convert.sketch_seeds_from_jax`).

Block-synchronous semantics: a page is "newly hot" for a block iff (a) its
post-block estimate exceeds theta, (b) its hot bits were not all set
*before* the block, and (c) it is the first occurrence of that page within
the block.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PAGE_ID_BITS = 30
HIST_BINS = 64


class SketchParams(NamedTuple):
    """Static sketch geometry (paper Table III defaults: W=512K, D=2)."""

    width: int = 1 << 14  # W counters per lane
    depth: int = 2        # D lanes
    counter_bits: int = 16  # saturate like the paper's 16-bit counters

    @property
    def counter_max(self) -> int:
        return (1 << self.counter_bits) - 1


class SketchState(NamedTuple):
    """Device-resident sketch state."""

    counts: torch.Tensor     # (D, W) int32, saturating at counter_max
    epochs: torch.Tensor     # (D, W) uint8 epoch tags
    hot: torch.Tensor        # (D, W) bool hot bits
    cur_epoch: torch.Tensor  # () uint8 current epoch
    n_seen: torch.Tensor     # () int32 items streamed this epoch
    seeds: torch.Tensor      # (D, PAGE_ID_BITS) int32 H3 seeds


def make_seeds(depth: int, width: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """H3 seed matrix (CPU int32): one m-bit row seed per input bit per lane."""
    m_bits = int(np.log2(width))
    if 1 << m_bits != width:
        raise ValueError("sketch width must be a power of two")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randint(0, 1 << m_bits, (depth, PAGE_ID_BITS),
                         generator=generator, dtype=torch.int32)


def sketch_init(params: SketchParams, seeds: torch.Tensor | None = None, *,
                device="cuda") -> SketchState:
    """Zeroed sketch on ``device``; ``seeds`` default to :func:`make_seeds`
    from a generator seeded with 0."""
    d, w = params.depth, params.width
    if seeds is None:
        seeds = make_seeds(d, w)
    if tuple(seeds.shape) != (d, PAGE_ID_BITS):
        raise ValueError(f"seeds shape {tuple(seeds.shape)} != {(d, PAGE_ID_BITS)}")
    return SketchState(
        counts=torch.zeros((d, w), dtype=torch.int32, device=device),
        epochs=torch.zeros((d, w), dtype=torch.uint8, device=device),
        hot=torch.zeros((d, w), dtype=torch.bool, device=device),
        cur_epoch=torch.zeros((), dtype=torch.uint8, device=device),
        n_seen=torch.zeros((), dtype=torch.int32, device=device),
        seeds=seeds.to(device=device, dtype=torch.int32),
    )


def h3_hash(page_ids: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """H3 hash (paper Eq. 5): XOR of seeds at set input bits.

    page_ids: (...,) int32; seeds: (D, PAGE_ID_BITS) int32 -> (D, ...) int32.
    """
    d = seeds.shape[0]
    h = torch.zeros((d,) + tuple(page_ids.shape), dtype=torch.int32,
                    device=page_ids.device)
    lane = (d,) + (1,) * page_ids.dim()
    for bit in range(PAGE_ID_BITS):
        mask = ((page_ids >> bit) & 1).bool()
        h = torch.where(mask[None], h ^ seeds[:, bit].reshape(lane), h)
    return h


def sketch_clear(state: SketchState) -> SketchState:
    """O(1) logical reset: bump the (wrapping, uint8) epoch tag; hot bits
    are cleared for real."""
    return state._replace(
        cur_epoch=state.cur_epoch + 1,
        hot=torch.zeros_like(state.hot),
        n_seen=torch.zeros_like(state.n_seen),
    )


def _live_counts(state: SketchState) -> torch.Tensor:
    """Counters, with stale-epoch entries reading as zero."""
    return torch.where(state.epochs == state.cur_epoch, state.counts, 0)


def _first_occurrence(page_ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mask of first occurrence of each id within the block (O(S^2) compare)."""
    s = page_ids.shape[0]
    eq = (page_ids[:, None] == page_ids[None, :]) & valid[None, :]
    earlier = torch.ones((s, s), dtype=torch.bool,
                         device=page_ids.device).tril(-1)
    return valid & ~(eq & earlier).any(dim=1)


def sketch_update(state: SketchState, page_ids: torch.Tensor,
                  theta: torch.Tensor, params: SketchParams,
                  ) -> tuple[SketchState, torch.Tensor]:
    """Stream a block of page ids into the sketch; return the newly-hot mask.

    page_ids: (S,) int32, negative entries are padding; theta: () int32.
    """
    valid = page_ids >= 0
    safe_ids = torch.where(valid, page_ids, 0)
    idx = h3_hash(safe_ids, state.seeds).long()               # (D, S)

    ones = valid.to(torch.int32).expand_as(idx)
    new_counts = _live_counts(state).scatter_add(1, idx, ones)
    new_counts = new_counts.clamp_max(params.counter_max)

    est = new_counts.gather(1, idx).min(dim=0).values         # Eq. 2
    already_hot = state.hot.gather(1, idx).all(dim=0)
    is_hot = valid & (est > theta)
    newly_hot = is_hot & ~already_hot & _first_occurrence(safe_ids, valid)

    # set hot bits for every detected hot page (re-detections included);
    # a max-reduce, so duplicate ids in the block cannot undo each other
    new_hot = state.hot.to(torch.int32).scatter_reduce(
        1, idx, is_hot.to(torch.int32).expand_as(idx), reduce="amax").bool()

    new_state = state._replace(
        counts=new_counts,
        epochs=state.cur_epoch.expand_as(state.epochs).clone(),
        hot=new_hot,
        n_seen=state.n_seen + valid.sum(dtype=torch.int32),
    )
    return new_state, newly_hot


def sketch_query(state: SketchState, page_ids: torch.Tensor,
                 params: SketchParams) -> torch.Tensor:
    """Point-query estimated access counts (Eq. 2)."""
    idx = h3_hash(page_ids, state.seeds).long()
    return _live_counts(state).gather(1, idx).min(dim=0).values


# ---------------------------------------------------------------------------
# Histogram unit + error bound (paper Fig. 9)
# ---------------------------------------------------------------------------

def hist_edges(counter_bits: int = 16, bins: int = HIST_BINS) -> np.ndarray:
    """Static geometric-ish bin edges over [0, counter_max].

    bin k covers [edges[k], edges[k+1]).  First bins are exact small counts
    (0,1,2,...) — where hot-threshold decisions live — then geometric growth.
    """
    max_v = (1 << counter_bits) - 1
    exact = list(range(17))  # 0..16 exact
    geo = np.unique(
        np.round(np.geomspace(17, max_v + 1, bins + 1 - len(exact))).astype(np.int64)
    )
    edges = np.unique(np.concatenate([np.array(exact, np.int64), geo]))
    while len(edges) < bins + 1:
        edges = np.append(edges, edges[-1] + 1)
    return edges[: bins + 1].astype(np.int32)


def sketch_histogram(state: SketchState, params: SketchParams) -> torch.Tensor:
    """64-bin histogram of row-0 live counters (the NeoProf histogram unit)."""
    edges = torch.as_tensor(hist_edges(params.counter_bits),
                            device=state.counts.device)
    row0 = _live_counts(state)[0]
    bin_idx = (torch.searchsorted(edges, row0, right=True) - 1).clamp(0, HIST_BINS - 1)
    return torch.bincount(bin_idx, minlength=HIST_BINS).to(torch.int32)


def error_bound_from_hist(hist, params: SketchParams, delta: float = 0.25) -> int:
    """Tight error bound e (paper §IV-B): the value at rank W * delta^(1/D)
    counting from the LARGEST counter, read off the histogram."""
    edges = hist_edges(params.counter_bits)
    hist = np.asarray(torch.as_tensor(hist).cpu())
    # compared in float32, as the reference's jnp promotion does
    rank = np.float32(params.width * (delta ** (1.0 / params.depth)))
    crossed = np.cumsum(hist[::-1])[::-1].astype(np.float32) >= rank
    bin_id = int(np.max(np.where(crossed, np.arange(HIST_BINS), -1)))
    return 0 if bin_id < 0 else int(edges[min(bin_id + 1, HIST_BINS)])


def quantile_from_hist(hist, q: float) -> int:
    """Q_F(q): counter value such that a fraction q of counters lie below."""
    edges = hist_edges()
    hist = np.asarray(torch.as_tensor(hist).cpu())
    total = max(int(hist.sum()), 1)
    target = np.float32(q) * np.float32(total)     # float32, as the reference
    bin_id = int(np.argmax(np.cumsum(hist).astype(np.float32) >= target))
    return int(edges[min(bin_id + 1, HIST_BINS)])
